"""The float64 forward of the port's models, the reference that the zoo's
float32 forward is held to (tests/test_torch_port_zoo.py on the CPU,
chip_smoke.py's phase zoo on the card): the model in float64 with each norm
computed by torch's float64 functional norm (the port's float32 BatchNorm
in training is F.batch_norm itself).  Imports no JAX."""
import contextlib
import copy
from typing import Tuple

import torch
import torch.nn.functional as F

from ramdsir_tpu_torch.models import norm


@contextlib.contextmanager
def float64_norms():
    """Within it, the port's BatchNorm, GroupNorm and InstanceNorm compute
    in their input's dtype through torch's functional norms."""
    saved = {cls: cls.forward for cls in (norm.BatchNorm, norm.GroupNorm, norm.InstanceNorm)}
    norm.BatchNorm.forward = lambda self, x, **kw: F.batch_norm(
        x, self.running_mean.double(), self.running_var.double(), self.weight.double(), self.bias.double(),
        self.training, 0.1, self.eps)
    norm.GroupNorm.forward = lambda self, x, **kw: F.group_norm(x, 1, self.weight.double(), self.bias.double(), self.eps)
    norm.InstanceNorm.forward = lambda self, x, **kw: F.instance_norm(x, eps=self.eps)
    try:
        yield
    finally:
        for cls, fwd in saved.items():
            cls.forward = fwd


def float64_forward(model: torch.nn.Module, x: torch.Tensor, **kw) -> Tuple[torch.Tensor, ...]:
    """Every head of a float64 copy of `model` (in its train or eval mode)
    on x in float64; `model` itself is left as it was."""
    m64 = copy.deepcopy(model).double()
    with torch.no_grad(), float64_norms():
        y = m64(x.double(), **kw)
    return tuple(y) if isinstance(y, (tuple, list)) else (y,)

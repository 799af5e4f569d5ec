"""The RAM-DSIR U-Net and the reference's model zoo, NCHW (PyTorch port of
`ramdsir_tpu/models/unet.py`).

  ConvD      down-stage: [maxpool unless first] -> conv3x3+norm ->
             conv3x3+norm+act -> conv3x3+norm+act
  ConvU      up-stage: [conv3x3+norm+act unless first] -> bilinear x2 ->
             conv1x1(planes//2)+norm+act -> concat(skip, .) -> conv3x3+norm+act
  ConvURec   skip-free up-stage with domain-specific BN
  Encoder    5 ConvD stages, c -> n, 2n, 4n, 8n, 16n; returns all 5 maps
  Decoder    4 ConvU stages + conv3x3 head
  RecDecoder 4 ConvURec stages from the bottleneck + conv3x3 head

The zoo, which no entry point trains (in either package): `Unet2D`
(encoder + decoder), `Unet2DMT` (one trunk, a seg head `seg1` or a
restoration head `rec1`), `Unet2DDS` (deep supervision: side heads
`seg2`..`seg5` upsampled x2..x16, bilinear, align_corners=False),
`Unet2DMS` (the side heads at their own scales) and the PatchGAN
`Discriminator`; `count_params` in millions.  Their attribute names are the
JAX modules' names, so `utils/torch_compat.py` carries their trees both ways.
Under torch's deterministic mode only the x2 upsample has a deterministic
CUDA backward (kernel K2): `Unet2DDS(deep_sup=True)`'s x4..x16 heads cannot
be differentiated on the card there.

Module and attribute names equal the reference's torch modules, so its state
dicts (`convd1.conv1.weight`, `convu4.bn1.bns.0.weight`, ...) load with
strict=True.  `init_weights` gives convs Kaiming-normal fan-out weights (gain
sqrt(2)) and torch's default uniform(+-1/sqrt(fan_in)) biases from an
explicit Generator; norms start at weight 1, bias 0.

Mixed precision, as the JAX package's `dtype=x.dtype` convs
(`ramdsir_tpu/models/unet.py:112-124`): every op runs in its input's dtype
(a bfloat16 input gives bfloat16 activations throughout), while the
parameters stay float32 master weights for Adam; a conv casts its weight and
bias to the input's dtype at the call.  Below float32 the conv's bias add
and the norms' four steps (models/norm.py) round where the JAX package's
do: with one rounding each, the port's bfloat16 forward lay further from
JAX's than JAX's lies from float32 (tests/test_torch_port_bf16.py).

Norms (`norm`, as the JAX package's `Norm` switch, `ramdsir_tpu/models/norm.py:585-624`):
'bn' BatchNorm, 'gn' GroupNorm with one group, 'in' InstanceNorm, in the
encoder and the seg decoder; `dual=True` (per-half statistics) is BN's only.
The restoration decoder is domain-specific BN whatever `--norm` says, as in
the JAX package (`ramdsir_tpu/train/state.py:665-672`).

`s2d_levels` is accepted for configuration parity only: in the JAX package
it moves the top stages into a 2x2 space-to-depth layout for the TPU's
lanes, with numerics pinned equal to s2d_levels=0, and is forced to 0 for
the non-BN norms (`ramdsir_tpu/train/state.py:655`).  This port always runs
the plain topology, which computes the same function.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ramdsir_tpu_torch.models.norm import BatchNorm, DomainSpecificBatchNorm, GroupNorm, InstanceNorm
from ramdsir_tpu_torch.ops.upsample import Upsample2x, kernels_take

Domain = Union[int, Sequence[int], np.ndarray]


def init_weights(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Kaiming-normal fan-out conv weights and torch-default conv biases,
    drawn from `generator` (torch's default one if None) in module order."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=generator)
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2, align_corners=False.  On a tensor that kernels K3
    (forward) and K2 (backward) take as it lies (`ops/upsample.kernels_take`:
    NCHW-contiguous float32 or bfloat16 on the card, the train step's
    activations), and on every tensor while torch's deterministic mode is on
    (`fit` under cfg.deterministic), it is `ops/upsample.Upsample2x`;
    otherwise torch's own: aten's kernels on CPU tensors and on the card's
    channels-last ones (eval's), which its NHWC kernel reads as they lie."""
    if torch.are_deterministic_algorithms_enabled() or kernels_take(x):
        return Upsample2x.apply(x)
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose float32 parameters are cast to the input's dtype at
    the call (torch refuses a bfloat16 input with float32 weights).  Below
    float32 the bias is added after the convolution, rounded, as flax does
    (PyTorch's cuDNN path adds it as a separate op in any case)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        return y + self.bias.to(x.dtype)[None, :, None, None]


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return Conv2d(cin, cout, k, padding=k // 2)


def _act(name: str):
    if name == "relu":
        return F.relu
    return lambda x: F.leaky_relu(x, 0.01)


_NORMS = {"bn": BatchNorm, "gn": GroupNorm, "in": InstanceNorm}


def _norm(norm: str, features: int) -> nn.Module:
    if norm not in _NORMS:
        raise ValueError(f"Normalization type {norm} is not supported (use one of {sorted(_NORMS)})")
    return _NORMS[norm](features)


class ConvD(nn.Module):
    def __init__(self, cin: int, planes: int, norm: str = "bn", first: bool = False, activation: str = "relu"):
        super().__init__()
        self.first = first
        self.act = _act(activation)
        self.conv1, self.bn1 = _conv(cin, planes, 3), _norm(norm, planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), _norm(norm, planes)
        self.conv3, self.bn3 = _conv(planes, planes, 3), _norm(norm, planes)

    def forward(self, x: torch.Tensor, *, dual: bool = False, n_valid: Optional[int] = None) -> torch.Tensor:
        kw = dict(dual=dual, n_valid=n_valid)
        if not self.first:
            x = F.max_pool2d(x, 2)
        x = self.bn1(self.conv1(x), **kw)  # no activation after the first conv
        y = self.act(self.bn2(self.conv2(x), **kw))
        return self.act(self.bn3(self.conv3(y), **kw))


class ConvU(nn.Module):
    def __init__(self, planes: int, norm: str = "bn", first: bool = False, activation: str = "relu"):
        super().__init__()
        self.first = first
        self.act = _act(activation)
        if not first:
            self.conv1, self.bn1 = _conv(2 * planes, planes, 3), _norm(norm, planes)
        self.conv2, self.bn2 = _conv(planes, planes // 2, 1), _norm(norm, planes // 2)
        self.conv3, self.bn3 = _conv(planes, planes, 3), _norm(norm, planes)

    def forward(
        self, x: torch.Tensor, prev: torch.Tensor, *, dual: bool = False, n_valid: Optional[int] = None
    ) -> torch.Tensor:
        kw = dict(dual=dual, n_valid=n_valid)
        if not self.first:
            x = self.act(self.bn1(self.conv1(x), **kw))
        y = self.act(self.bn2(self.conv2(upsample2x(x)), **kw))
        y = torch.cat([prev, y], dim=1)  # skip first, as the reference
        return self.act(self.bn3(self.conv3(y), **kw))


class ConvURec(nn.Module):
    def __init__(self, planes: int, norm: str = "dsbn", activation: str = "relu", num_domains: int = 3):
        super().__init__()
        if norm != "dsbn":
            raise ValueError(f"the restoration decoder's norm is 'dsbn', not {norm!r}")
        half = planes // 2
        self.act = _act(activation)
        self.conv1, self.bn1 = _conv(planes, half, 3), DomainSpecificBatchNorm(half, num_domains)
        self.conv2, self.bn2 = _conv(half, half, 1), DomainSpecificBatchNorm(half, num_domains)
        self.conv3, self.bn3 = _conv(half, half, 3), DomainSpecificBatchNorm(half, num_domains)

    def forward(self, x: torch.Tensor, *, domain: Domain, n_valid: Optional[int] = None) -> torch.Tensor:
        kw = dict(n_valid=n_valid)
        x = self.act(self.bn1(self.conv1(x), domain, **kw))
        y = self.act(self.bn2(self.conv2(upsample2x(x)), domain, **kw))
        return self.act(self.bn3(self.conv3(y), domain, **kw))


class Encoder(nn.Module):
    def __init__(self, c: int = 3, n: int = 16, norm: str = "bn", activation: str = "relu", s2d_levels: int = 0):
        super().__init__()
        self.s2d_levels = s2d_levels
        self.convd1 = ConvD(c, n, norm, first=True, activation=activation)
        self.convd2 = ConvD(n, 2 * n, norm, activation=activation)
        self.convd3 = ConvD(2 * n, 4 * n, norm, activation=activation)
        self.convd4 = ConvD(4 * n, 8 * n, norm, activation=activation)
        self.convd5 = ConvD(8 * n, 16 * n, norm, activation=activation)

    def forward(self, x: torch.Tensor, *, dual: bool = False, n_valid: Optional[int] = None) -> List[torch.Tensor]:
        feats = [self.convd1(x, dual=dual, n_valid=n_valid)]
        for stage in (self.convd2, self.convd3, self.convd4, self.convd5):
            feats.append(stage(feats[-1], dual=dual, n_valid=n_valid))
        return feats


class Decoder(nn.Module):
    def __init__(self, n: int = 16, num_classes: int = 2, norm: str = "bn", activation: str = "relu", s2d_levels: int = 0):
        super().__init__()
        self.s2d_levels = s2d_levels
        self.convu4 = ConvU(16 * n, norm, first=True, activation=activation)
        self.convu3 = ConvU(8 * n, norm, activation=activation)
        self.convu2 = ConvU(4 * n, norm, activation=activation)
        self.convu1 = ConvU(2 * n, norm, activation=activation)
        self.out1 = _conv(2 * n, num_classes, 3)

    def forward(
        self, feats: Sequence[torch.Tensor], *, dual: bool = False, n_valid: Optional[int] = None
    ) -> torch.Tensor:
        kw = dict(dual=dual, n_valid=n_valid)
        y = self.convu4(feats[-1], feats[-2], **kw)
        y = self.convu3(y, feats[-3], **kw)
        y = self.convu2(y, feats[-4], **kw)
        y = self.convu1(y, feats[-5], **kw)
        return self.out1(y)


class RecDecoder(nn.Module):
    def __init__(
        self,
        n: int = 16,
        num_classes: int = 3,
        norm: str = "dsbn",
        activation: str = "relu",
        num_domains: int = 3,
        s2d_levels: int = 0,
    ):
        super().__init__()
        self.s2d_levels = s2d_levels
        self.convu4 = ConvURec(16 * n, norm, activation, num_domains)
        self.convu3 = ConvURec(8 * n, norm, activation, num_domains)
        self.convu2 = ConvURec(4 * n, norm, activation, num_domains)
        self.convu1 = ConvURec(2 * n, norm, activation, num_domains)
        self.out1 = _conv(n, num_classes, 3)

    def forward(self, x: torch.Tensor, *, domain: Domain, n_valid: Optional[int] = None) -> torch.Tensor:
        for stage in (self.convu4, self.convu3, self.convu2, self.convu1):
            x = stage(x, domain=domain, n_valid=n_valid)
        return self.out1(x)


# --- the model zoo ------------------------------------------------------------


def count_params(module: nn.Module) -> float:
    """Parameter count in millions (buffers not counted)."""
    return sum(p.numel() for p in module.parameters()) / 1e6


class _ZooTrunk(nn.Module):
    """Encoder and the four seg up-stages, named as the JAX zoo names them
    (`encoder`, `convu4`..`convu1`); the heads belong to the variants."""

    def __init__(self, c: int, n: int, norm: str, activation: str):
        super().__init__()
        self.encoder = Encoder(c, n, norm, activation)
        self.convu4 = ConvU(16 * n, norm, first=True, activation=activation)
        self.convu3 = ConvU(8 * n, norm, activation=activation)
        self.convu2 = ConvU(4 * n, norm, activation=activation)
        self.convu1 = ConvU(2 * n, norm, activation=activation)

    def trunk(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[y1, y2, y3, y4, x5]: the up-stages' outputs and the bottleneck."""
        feats = self.encoder(x)
        y4 = self.convu4(feats[-1], feats[-2])
        y3 = self.convu3(y4, feats[-3])
        y2 = self.convu2(y3, feats[-4])
        y1 = self.convu1(y2, feats[-5])
        return [y1, y2, y3, y4, feats[-1]]


class Unet2D(nn.Module):
    """Encoder + seg decoder (`ramdsir_tpu/models/unet.py:408-420`)."""

    def __init__(self, c: int = 3, n: int = 16, norm: str = "bn", num_classes: int = 2, activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = Encoder(c, n, norm, activation)
        self.decoder = Decoder(n, num_classes, norm, activation)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))


class Unet2DMT(_ZooTrunk):
    """One trunk with a seg head and a restoration head
    (`ramdsir_tpu/models/unet.py:423-444`)."""

    def __init__(self, c: int = 3, n: int = 16, norm: str = "bn", num_classes: int = 2, activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__(c, n, norm, activation)
        self.seg1 = _conv(2 * n, num_classes, 3)
        self.rec1 = _conv(2 * n, c, 3)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor, *, is_rec: bool = False) -> torch.Tensor:
        y1 = self.trunk(x)[0]
        return self.rec1(y1) if is_rec else self.seg1(y1)


class _SideHeads(_ZooTrunk):
    """The trunk with a seg head on y1, y2, y3, y4 and the bottleneck
    (`seg1`..`seg5`)."""

    def __init__(self, c: int, n: int, norm: str, num_classes: int, activation: str,
                 generator: Optional[torch.Generator]):
        super().__init__(c, n, norm, activation)
        for i, width in enumerate((2 * n, 4 * n, 8 * n, 16 * n, 16 * n), start=1):
            setattr(self, f"seg{i}", _conv(width, num_classes, 3))
        init_weights(self, generator)

    def heads(self, x: torch.Tensor, side: bool) -> List[torch.Tensor]:
        maps = self.trunk(x)
        heads = (self.seg1, self.seg2, self.seg3, self.seg4, self.seg5)
        return [head(m) for head, m in zip(heads, maps if side else maps[:1])]


def _upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear x`scale`, align_corners=False, as jax.image.resize upsamples."""
    if scale == 2:
        return upsample2x(x)
    return F.interpolate(x, scale_factor=scale, mode="bilinear", align_corners=False)


class Unet2DDS(_SideHeads):
    """Deep supervision (`ramdsir_tpu/models/unet.py:447-481`): with
    deep_sup, the side heads come back upsampled to the input's size,
    (y1, y2 x2, y3 x4, y4 x8, x5 x16)."""

    def __init__(self, c: int = 3, n: int = 16, norm: str = "bn", num_classes: int = 2, activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__(c, n, norm, num_classes, activation, generator)

    def forward(self, x: torch.Tensor, *, deep_sup: bool = False):
        preds = self.heads(x, deep_sup)
        if not deep_sup:
            return preds[0]
        return tuple([preds[0]] + [_upsample(p, 2 ** i) for i, p in enumerate(preds[1:], start=1)])


class Unet2DMS(_SideHeads):
    """Multi-scale output (`ramdsir_tpu/models/unet.py:484-513`): with
    multi_scale_output, the five heads at their own scales."""

    def __init__(self, c: int = 3, n: int = 16, norm: str = "bn", num_classes: int = 2, activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__(c, n, norm, num_classes, activation, generator)

    def forward(self, x: torch.Tensor, *, multi_scale_output: bool = False):
        preds = self.heads(x, multi_scale_output)
        return tuple(preds) if multi_scale_output else preds[0]


class Discriminator(nn.Module):
    """PatchGAN discriminator (`ramdsir_tpu/models/unet.py:516-535`): 4x4
    convs at strides 2, 2, 2, 1, 1 with padding 1, leaky ReLU 0.2,
    InstanceNorm (no affine) after conv2..conv4, then the spatial mean,
    (B, 1).  Its fresh weights are nn.Conv2d's default init, the reference
    torch module's."""

    def __init__(self, input_nc: int = 3, n: int = 16):
        super().__init__()
        widths = (input_nc, n, 2 * n, 4 * n, 8 * n, 1)
        for i, stride in enumerate((2, 2, 2, 1, 1), start=1):
            setattr(self, f"conv{i}", nn.Conv2d(widths[i - 1], widths[i], 4, stride=stride, padding=1))
        self.norm2, self.norm3, self.norm4 = InstanceNorm(2 * n), InstanceNorm(4 * n), InstanceNorm(8 * n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv1(x), 0.2)
        x = F.leaky_relu(self.norm2(self.conv2(x)), 0.2)
        x = F.leaky_relu(self.norm3(self.conv3(x)), 0.2)
        x = F.leaky_relu(self.norm4(self.conv4(x)), 0.2)
        return torch.mean(self.conv5(x), dim=(2, 3))

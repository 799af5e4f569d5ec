"""The RAM-DSIR U-Net, NCHW (PyTorch port of `ramdsir_tpu/models/unet.py:154-405`).

  ConvD      down-stage: [maxpool unless first] -> conv3x3+norm ->
             conv3x3+norm+act -> conv3x3+norm+act
  ConvU      up-stage: [conv3x3+norm+act unless first] -> bilinear x2 ->
             conv1x1(planes//2)+norm+act -> concat(skip, .) -> conv3x3+norm+act
  ConvURec   skip-free up-stage with domain-specific BN
  Encoder    5 ConvD stages, c -> n, 2n, 4n, 8n, 16n; returns all 5 maps
  Decoder    4 ConvU stages + conv3x3 head
  RecDecoder 4 ConvURec stages from the bottleneck + conv3x3 head

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

`s2d_levels` is accepted for configuration parity only: in the JAX package
it moves the top stages into a 2x2 space-to-depth layout for the TPU's
lanes, with numerics pinned equal to s2d_levels=0.  This port always runs
the plain topology, which computes the same function.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ramdsir_tpu_torch.models.norm import BatchNorm, DomainSpecificBatchNorm
from ramdsir_tpu_torch.ops.upsample import Upsample2x

Domain = Union[int, Sequence[int], np.ndarray]


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Kaiming-normal fan-out conv weights and torch-default conv biases,
    drawn from `generator` in module order."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=generator)
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2, align_corners=False.  While torch's deterministic mode
    is on (`fit` under cfg.deterministic), its backward is kernel K2
    (`ops/upsample.py`); otherwise it is torch's own."""
    if torch.are_deterministic_algorithms_enabled():
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


def _check_norm(norm: str, allowed: str) -> None:
    if norm != allowed:
        raise NotImplementedError(
            f"norm {norm!r} is not ported yet (ROADMAP.md, off-path variants); use {allowed!r}"
        )


class ConvD(nn.Module):
    def __init__(self, cin: int, planes: int, norm: str = "bn", first: bool = False, activation: str = "relu"):
        super().__init__()
        _check_norm(norm, "bn")
        self.first = first
        self.act = _act(activation)
        self.conv1, self.bn1 = _conv(cin, planes, 3), BatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), BatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, planes, 3), BatchNorm(planes)

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
        _check_norm(norm, "bn")
        self.first = first
        self.act = _act(activation)
        if not first:
            self.conv1, self.bn1 = _conv(2 * planes, planes, 3), BatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes // 2, 1), BatchNorm(planes // 2)
        self.conv3, self.bn3 = _conv(planes, planes, 3), BatchNorm(planes)

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
        _check_norm(norm, "dsbn")
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

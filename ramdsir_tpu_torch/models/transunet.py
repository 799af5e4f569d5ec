"""TransUNet, R50-ViT-B/16 (Chen et al., arXiv 2102.04306; the authors' code,
github.com/Beckschen/TransUNet: `networks/vit_seg_configs.py::get_r50_b16_config`,
`vit_seg_modeling.py`, `vit_seg_modeling_resnet_skip.py`), as the network of
the RAM-DSIR step: `TransUNetEncoder` in the encoder's place,
`TransUNetDecoder` (the CUP and the seg head) in the seg decoder's, and
RAM-DSIR's own `models.unet.RecDecoder` at n = hidden / 16 on the token map.

  encoder   ResNetV2 stem (`embeddings.hybrid_model`): StdConv 7x7/2 -> GN(32)
            -> ReLU, max pool 3/2 (no padding), bottleneck units in three
            blocks (1x1 -> 3x3 carrying the stride -> 1x1, each a StdConv and
            a GN(32, eps 1e-6); the projection shortcut a StdConv and a
            per-channel GN; ReLU after the residual add); a 1x1 patch
            embedding to `hidden` channels, a learned position table, dropout;
            pre-LN transformer blocks (LN eps 1e-6, multi-head self-attention
            with biased q / k / v / out, a residual; LN, MLP with exact GELU
            and dropout after each linear, a residual); a final LN.  Returns
            [root (H/2), block 1 (H/4, zero-padded at the bottom and right to
            H/4 where the pool leaves it one short), block 2 (H/8), the tokens
            as a (B, hidden, H/16, W/16) map].
  decoder   `conv_more` 3x3 to head_channels, then four blocks: bilinear x2
            with align_corners=True, concat [upsampled, skip] (the deepest
            skip first; the last block has none), two 3x3 conv-BN-ReLU
            (convs without bias); the 3x3 seg head (with bias).

Submodules carry TransUNet's names (`embeddings.hybrid_model.body.block1.
unit1.conv1.weight`, `encoder.layer.0.attn.query.weight`, `conv_more.0.weight`,
`blocks.0.conv1.1.running_mean`, `segmentation_head.0.weight`); the
encoder module holds the published `transformer`'s two children.

Norms.  GroupNorm and LayerNorm are per sample, so `dual` (the fused
[clean; RAM] forward) changes nothing in the encoder; the decoder's batch
norms are the port's `models.norm.BatchNorm` (per-half statistics under
`dual`, `n_valid`), on the card the hand-written grouped kernels.

Attention is `F.scaled_dot_product_attention` pinned to the memory-efficient
backend on a CUDA tensor (flash takes no float32): under the port's
no-fallback rule an input that backend refuses raises, it never drops to the
math backend.  On CPU tensors it is the plain softmax(q k^T / sqrt(d)) v.

Dropout (rate 0.1: the embedding and both MLP linears of every block, 1 +
2 x layers sites; attention dropout 0) runs only in training and only when
the forward is given `dropout_seed`, one int64 seed in [0, 2^31) a row of
the batch (the step's host draws, `train.steps.sample_step_draws`).  The
masks come from a counter-based hash on the device (`keep_mask`): each row's
key from its seed and its half of the [clean; RAM] batch, each site's key
from the row's key, and each pair of elements a 32-bit hash of its index
within the row, whose two 16-bit halves keep their elements when >=
DROP_THRESHOLD.  Plain int64 torch ops whose values stay below 2^63, so the
masks are bit-equal on the CPU and the card, under recomputation
(`remat`) and under graph replay, and a plain reference can write them
again.  Without a seed (prediction, the eval CLIs) nothing is dropped.

`remat=True` recomputes each transformer block and each bottleneck unit in
the backward (`torch.utils.checkpoint`); they hold no running statistic and
draw nothing from a generator, so the recompute is the forward again.

Initialisation (`init_weights`, from an explicit generator, as TransUNet's
`Mlp._init_weights` and PyTorch's defaults): xavier-uniform MLP weights,
N(0, 1e-6) MLP biases, a zero position table, norms at weight 1 and bias 0,
every other conv and linear PyTorch's default (kaiming-uniform a = sqrt(5),
biases uniform +-1/sqrt(fan in)).

Precision: float32 only (`train.steps.check_supported` refuses bfloat16).
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ramdsir_tpu_torch.models.norm import BatchNorm
from ramdsir_tpu_torch.utils.profiler import span


@dataclasses.dataclass(frozen=True)
class TransUNetConfig:
    """A TransUNet's sizes (`get_r50_b16_config`'s names where it has them)."""

    hidden_size: int = 768
    mlp_dim: int = 3072
    num_heads: int = 12
    num_layers: int = 12
    resnet_units: Tuple[int, int, int] = (3, 4, 9)
    resnet_width: int = 64
    head_channels: int = 512
    decoder_channels: Tuple[int, int, int, int] = (256, 128, 64, 16)
    n_skip: int = 3
    dropout_rate: float = 0.1
    gn_groups: int = 32

    @property
    def skip_channels(self) -> Tuple[int, int, int, int]:
        """Channels of the skip each decoder block takes (0: none): block 2's,
        block 1's and the root's, as many as n_skip."""
        w = self.resnet_width
        return tuple(c if i < self.n_skip else 0 for i, c in enumerate((8 * w, 4 * w, w, 0)))

    @property
    def rec_width(self) -> int:
        """The restoration decoder's n: 16 n channels meet the token map."""
        return self.hidden_size // 16


# the models TrainConfig.model names, besides the U-Net
CONFIGS = {"transunet_r50_b16": TransUNetConfig()}

GN_EPS, LN_EPS, STD_EPS = 1e-6, 1e-6, 1e-5
PATCH = 16  # the stem's stride: a token a 16 x 16 patch of the input

# --- the dropout masks ----------------------------------------------------------

M32 = 0xFFFFFFFF
MIX_A, MIX_B = 0x7FEB352D, 0x2C1B3C6D  # odd, below 2^31: a product of a 32-bit value stays below 2^63
SITE_STEP = 0x9E3779B9
DROP_THRESHOLD = 6554  # of 2^16: a 16-bit value below it drops its element (p = 0.10001)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 values in [0, 2^32), in int64 ops that
    never overflow: xor-shift, multiply, mask, twice."""
    x = x ^ (x >> 16)
    x = (x * MIX_A) & M32
    x = x ^ (x >> 15)
    x = (x * MIX_B) & M32
    return x ^ (x >> 16)


def row_keys(seeds: torch.Tensor, halves: int) -> torch.Tensor:
    """(halves * rows,) keys of a batch of `halves` halves whose rows share
    the (rows,) seeds: row r of half h gets mix32(mix32(seed_r) + h)."""
    base = mix32(seeds.long() & M32)
    return torch.cat([mix32((base + h) & M32) for h in range(halves)])


def keep_mask(keys: torch.Tensor, site: int, shape: Sequence[int]) -> torch.Tensor:
    """The bool keep mask of a tensor of `shape` (rows first) at dropout
    site `site`: elements 2j and 2j + 1 of a row from the low and high 16
    bits of mix32(j ^ mix32(key_row + site * SITE_STEP))."""
    rows, n = shape[0], math.prod(shape[1:])
    pairs = (n + 1) // 2
    site_key = mix32((keys + site * SITE_STEP) & M32)
    h = mix32(torch.arange(pairs, dtype=torch.int64, device=keys.device)[None, :] ^ site_key[:, None])
    keep = torch.stack([(h & 0xFFFF) >= DROP_THRESHOLD, (h >> 16) >= DROP_THRESHOLD], dim=-1)
    return keep.reshape(rows, 2 * pairs)[:, :n].reshape(shape)


def dropout(x: torch.Tensor, keys: Optional[torch.Tensor], site: int, rate: float) -> torch.Tensor:
    """x with the site's dropped elements zero and the kept ones scaled by
    1 / (1 - rate); x itself without keys."""
    if keys is None or rate == 0.0:
        return x
    return torch.where(keep_mask(keys, site, x.shape), x * (1.0 / (1.0 - rate)), 0.0)


# --- attention ----------------------------------------------------------------


_last_backend = ["none"]  # the path of the last attention call that returned


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v of (B, heads, S, d) tensors: SDPA's
    memory-efficient backend alone on a CUDA tensor (raises where it cannot
    run), the plain product on the CPU."""
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            out = F.scaled_dot_product_attention(q, k, v)
        _last_backend[0] = "efficient"  # no other backend may run under the pin
        return out
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    out = torch.matmul(torch.softmax(scores, dim=-1), v)
    _last_backend[0] = "math"
    return out


def counters(encoder: nn.Module) -> Dict[str, object]:
    """What the last training step's forward of a `TransUNetEncoder` ran, as
    its host saw it (an eager step or a graph's capture; a replay runs what
    its capture ran): vit_tokens, the tokens it sent through the transformer
    (both halves under RAM), and attn_backend, the attention path that
    returned them; {} before any such forward."""
    return dict(getattr(encoder, "ran", {}))


# --- the stem (ResNetV2) ------------------------------------------------------------


class StdConv2d(nn.Conv2d):
    """A convolution whose every output filter is standardised at each call:
    (w - mean) / sqrt(var + 1e-5), the biased variance over (cin, kh, kw)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True, correction=0)
        w = (self.weight - mean) / torch.sqrt(var + STD_EPS)
        return F.conv2d(x, w, self.bias, self.stride, self.padding, self.dilation, self.groups)


def _std_conv(cin: int, cout: int, k: int, stride: int = 1) -> StdConv2d:
    return StdConv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class PreActBottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1, each StdConv + GN(groups, 1e-6), ReLU
    after the first two; a projection shortcut (StdConv 1x1 + GN(cout,
    cout)) where the shape changes; ReLU after the residual add."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1, groups: int = 32):
        super().__init__()
        self.gn1 = nn.GroupNorm(groups, cmid, eps=GN_EPS)
        self.conv1 = _std_conv(cin, cmid, 1)
        self.gn2 = nn.GroupNorm(groups, cmid, eps=GN_EPS)
        self.conv2 = _std_conv(cmid, cmid, 3, stride)
        self.gn3 = nn.GroupNorm(groups, cout, eps=GN_EPS)
        self.conv3 = _std_conv(cmid, cout, 1)
        if stride != 1 or cin != cout:
            self.downsample = _std_conv(cin, cout, 1, stride)
            self.gn_proj = nn.GroupNorm(cout, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = self.gn_proj(self.downsample(x)) if hasattr(self, "downsample") else x
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        return F.relu(residual + y)


class ResNetV2(nn.Module):
    """The hybrid stem: `root` then three blocks of units; returns the last
    block's map and the skips [block 2, block 1 (zero-padded), root]."""

    def __init__(self, cfg: TransUNetConfig):
        super().__init__()
        w, g = cfg.resnet_width, cfg.gn_groups
        self.root = nn.Sequential(OrderedDict([
            ("conv", StdConv2d(3, w, 7, stride=2, padding=3, bias=False)),
            ("gn", nn.GroupNorm(g, w, eps=GN_EPS)),
            ("relu", nn.ReLU()),
        ]))
        blocks = []
        cin = w
        for i, (units, mult) in enumerate(zip(cfg.resnet_units, (1, 2, 4))):
            cout, cmid, stride = 4 * w * mult, w * mult, 1 if i == 0 else 2
            layers = [(f"unit{j}", PreActBottleneck(cin if j == 1 else cout, cout, cmid, stride if j == 1 else 1, g))
                      for j in range(1, units + 1)]
            blocks.append((f"block{i + 1}", nn.Sequential(OrderedDict(layers))))
            cin = cout
        self.body = nn.Sequential(OrderedDict(blocks))
        self.remat = False

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        in_size = x.shape[-1]
        x = self.root(x)
        features = [x]
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=0)
        for i, block in enumerate(self.body):
            for unit in block:
                x = checkpoint(unit, x, use_reentrant=False) if self.remat and torch.is_grad_enabled() else unit(x)
            if i == len(self.body) - 1:
                break
            right = in_size // 4 // (i + 1)
            pad = right - x.shape[-1]
            if not 0 <= pad < 3:
                raise ValueError(f"block {i + 1} gives {x.shape[-1]}^2 where {right}^2 is wanted")
            features.append(F.pad(x, (0, pad, 0, pad)) if pad else x)
        return x, features[::-1]


# --- the transformer -----------------------------------------------------------------


class Embeddings(nn.Module):
    """The stem, the 1x1 patch embedding, the position table and dropout
    (site 0)."""

    def __init__(self, cfg: TransUNetConfig, img_size: int):
        super().__init__()
        grid = img_size // PATCH
        self.hybrid_model = ResNetV2(cfg)
        self.patch_embeddings = nn.Conv2d(16 * cfg.resnet_width, cfg.hidden_size, 1)
        self.position_embeddings = nn.Parameter(torch.zeros(1, grid * grid, cfg.hidden_size))
        self.rate = cfg.dropout_rate

    def forward(self, x: torch.Tensor, keys: Optional[torch.Tensor]):
        with span("ramdsir.transunet.resnet"):
            x, features = self.hybrid_model(x)
        with span("ramdsir.transunet.embed"):
            x = self.patch_embeddings(x).flatten(2).transpose(1, 2)
            x = dropout(x + self.position_embeddings, keys, 0, self.rate)
        return x, features


class Attention(nn.Module):
    def __init__(self, cfg: TransUNetConfig):
        super().__init__()
        self.heads = cfg.num_heads
        h = cfg.hidden_size
        self.query, self.key, self.value, self.out = (nn.Linear(h, h) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        split = lambda t: t.view(b, s, self.heads, h // self.heads).transpose(1, 2)
        ctx = attention(split(self.query(x)), split(self.key(x)), split(self.value(x)))
        return self.out(ctx.transpose(1, 2).reshape(b, s, h))


class Mlp(nn.Module):
    def __init__(self, cfg: TransUNetConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.hidden_size)
        self.rate = cfg.dropout_rate

    def forward(self, x: torch.Tensor, keys: Optional[torch.Tensor], site: int) -> torch.Tensor:
        x = dropout(F.gelu(self.fc1(x)), keys, site, self.rate)
        return dropout(self.fc2(x), keys, site + 1, self.rate)


class Block(nn.Module):
    """Pre-LN: x + attn(LN(x)), then x + mlp(LN(x)); block i's MLP drops at
    sites 1 + 2i and 2 + 2i."""

    def __init__(self, cfg: TransUNetConfig, index: int):
        super().__init__()
        self.attention_norm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.ffn_norm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.ffn = Mlp(cfg)
        self.attn = Attention(cfg)
        self.site = 1 + 2 * index

    def forward(self, x: torch.Tensor, keys: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x), keys, self.site)


class Transformer(nn.Module):
    """TransUNet's `Encoder`: the blocks and the final LN."""

    def __init__(self, cfg: TransUNetConfig):
        super().__init__()
        self.layer = nn.ModuleList(Block(cfg, i) for i in range(cfg.num_layers))
        self.encoder_norm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)
        self.remat = False

    def forward(self, x: torch.Tensor, keys: Optional[torch.Tensor]) -> torch.Tensor:
        for block in self.layer:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, keys, use_reentrant=False)
            else:
                x = block(x, keys)
        return self.encoder_norm(x)


class TransUNetEncoder(nn.Module):
    """The published `transformer` (embeddings, encoder) in the port's
    encoder slot: forward(x, dual=, n_valid=, dropout_seed=) -> [root,
    block 1, block 2, token map]."""

    def __init__(self, cfg: TransUNetConfig, img_size: int, remat: bool = False):
        super().__init__()
        if img_size % PATCH:
            raise ValueError(f"TransUNet takes sides that are multiples of {PATCH}, not {img_size}")
        self.cfg = cfg
        self.grid = img_size // PATCH
        self.embeddings = Embeddings(cfg, img_size)
        self.encoder = Transformer(cfg)
        self.embeddings.hybrid_model.remat = self.encoder.remat = remat

    def forward(self, x: torch.Tensor, *, dual: bool = False, n_valid: Optional[int] = None,
                dropout_seed: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        keys = None
        if self.training and dropout_seed is not None and self.cfg.dropout_rate > 0:
            keys = row_keys(dropout_seed, 2 if dual else 1)
            if keys.shape[0] != x.shape[0]:
                raise ValueError(f"{dropout_seed.shape[0]} dropout seeds for a batch of {x.shape[0]} rows")
        tokens, features = self.embeddings(x, keys)
        with span("ramdsir.transunet.transformer"):
            tokens = self.encoder(tokens, keys)
        b, s, h = tokens.shape
        if self.training and torch.is_grad_enabled():
            self.ran = {"vit_tokens": b * s, "attn_backend": _last_backend[0]}
        fmap = tokens.transpose(1, 2).reshape(b, h, self.grid, self.grid)
        return features[::-1] + [fmap]


# --- the CUP decoder ---------------------------------------------------------------


class Conv2dReLU(nn.Module):
    """conv (no bias) -> the port's BatchNorm -> ReLU, children "0" and "1"
    as in TransUNet's nn.Sequential."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.add_module("0", nn.Conv2d(cin, cout, 3, padding=1, bias=False))
        self.add_module("1", BatchNorm(cout))

    def forward(self, x: torch.Tensor, dual: bool, n_valid: Optional[int]) -> torch.Tensor:
        conv, bn = self._modules["0"], self._modules["1"]
        return F.relu(bn(conv(x), dual=dual, n_valid=n_valid))


def upsample2x_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 with align_corners=True (nn.UpsamplingBilinear2d)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, skip: int):
        super().__init__()
        self.conv1 = Conv2dReLU(cin + skip, cout)
        self.conv2 = Conv2dReLU(cout, cout)

    def forward(self, x, skip, dual: bool, n_valid: Optional[int]) -> torch.Tensor:
        x = upsample2x_corners(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)  # upsampled first, as TransUNet
        return self.conv2(self.conv1(x, dual, n_valid), dual, n_valid)


class TransUNetDecoder(nn.Module):
    """TransUNet's DecoderCup and segmentation head in the port's seg-decoder
    slot: forward(feats, dual=, n_valid=) -> logits at the input's size."""

    def __init__(self, cfg: TransUNetConfig, num_classes: int):
        super().__init__()
        self.conv_more = Conv2dReLU(cfg.hidden_size, cfg.head_channels)
        ins = (cfg.head_channels,) + tuple(cfg.decoder_channels[:-1])
        self.blocks = nn.ModuleList(DecoderBlock(i, o, s)
                                    for i, o, s in zip(ins, cfg.decoder_channels, cfg.skip_channels))
        self.segmentation_head = nn.Sequential(nn.Conv2d(cfg.decoder_channels[-1], num_classes, 3, padding=1))
        self.skip_channels = cfg.skip_channels

    def forward(self, feats: Sequence[torch.Tensor], *, dual: bool = False,
                n_valid: Optional[int] = None) -> torch.Tensor:
        with span("ramdsir.transunet.cup"):
            skips = [feats[2], feats[1], feats[0], None]
            x = self.conv_more(feats[-1], dual, n_valid)
            for block, skip, width in zip(self.blocks, skips, self.skip_channels):
                x = block(x, skip if width else None, dual, n_valid)
            return self.segmentation_head(x)


# --- initialisation ------------------------------------------------------------------


def _default_init(m: nn.Module, generator: Optional[torch.Generator]) -> None:
    """PyTorch's reset_parameters of a conv or linear, from `generator`."""
    nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
    if m.bias is not None:
        fan_in = m.weight[0].numel()
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        nn.init.uniform_(m.bias, -bound, bound, generator=generator)


def init_weights(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """TransUNet's initialisation (the module docstring), drawn from
    `generator` in module order."""
    mlp = {id(fc) for m in module.modules() if isinstance(m, Mlp) for fc in (m.fc1, m.fc2)}
    for m in module.modules():
        if id(m) in mlp:
            nn.init.xavier_uniform_(m.weight, generator=generator)
            nn.init.normal_(m.bias, std=1e-6, generator=generator)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            _default_init(m, generator)
        elif isinstance(m, Embeddings):
            nn.init.zeros_(m.position_embeddings)


def build(name: str, img_size: int, num_classes: int, remat: bool = False):
    """(encoder, seg decoder, TransUNetConfig) of the model `name` (CONFIGS)."""
    cfg = CONFIGS[name]
    return TransUNetEncoder(cfg, img_size, remat), TransUNetDecoder(cfg, num_classes), cfg

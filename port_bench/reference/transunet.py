"""Plain reference of RAM-DSIR training with TransUNet R50-ViT-B/16 as its
network, in plain PyTorch, written from the published description (Chen et
al., arXiv 2102.04306; the authors' code, github.com/Beckschen/TransUNet:
`networks/vit_seg_configs.py::get_r50_b16_config`, `vit_seg_modeling.py`,
`vit_seg_modeling_resnet_skip.py`) and RAM-DSIR's (arXiv 2208.03901), not
from the program under test: it imports nothing of the PyTorch port nor of
the JAX package.  The data side of the step (scale-crop, RAM), the losses,
Adam and the restoration decoder are `reference/ramdsir.py`'s.

The network, functional over a dict of named tensors (the port's
state-dict keys, `make_weights`), sizes from the configuration file
(`sizes`):
  stem     StdConv 7x7/2 (each filter standardised, (w - mean) / sqrt(var +
           1e-5), biased variance) -> GroupNorm(32, eps 1e-6) -> ReLU ->
           max pool 3/2, no padding; three blocks of pre-activation
           bottleneck units (1x1, 3x3 with the block's stride on its first
           unit, 1x1; each a StdConv then GN(32, 1e-6); ReLU after the first
           two; a StdConv 1x1 + GroupNorm(C, C, eps 1e-5) shortcut where the
           shape changes; ReLU after the add); skips: the root's output,
           block 1's (zero-padded at the bottom and right to H/4), block 2's;
  embed    1x1 conv to `hidden_size`, flattened to tokens, plus the position
           table, dropout;
  blocks   pre-LN (eps 1e-6): x + out(softmax(q k^T / sqrt(d)) v) over heads,
           then x + fc2(drop(gelu(fc1(LN(x))))) with dropout after fc2; a
           final LN; the tokens as a (B, hidden, H/16, W/16) map;
  CUP      3x3 conv (no bias) -> BN -> ReLU to head_channels; four blocks of
           bilinear x2 with align_corners=True (written as gathers, output i
           from input i (n - 1) / (2n - 1)), concat [upsampled, skip], two
           3x3 conv (no bias) -> BN -> ReLU; the 3x3 seg head with bias.
  Batch norm is nn.BatchNorm2d's in training: each half of the step ([clean]
  then [RAM]) its own batch statistics, the running statistics moved by the
  clean pass, then by the RAM pass.

Dropout (rate 0.1 at the embedding and after each MLP linear; attention
dropout 0): each row r of half h (0 clean, 1 RAM) has the key k =
mix32((mix32(seed_r) + h) mod 2^32), each site s the key mix32((k + s *
0x9E3779B9) mod 2^32), and the elements 2j, 2j + 1 of the row (flattened)
are kept when the low and the high 16 bits of mix32(j xor site key) are >=
6554; kept elements are scaled by 1 / 0.9.  mix32: x ^= x >> 16; x = x *
0x7FEB352D mod 2^32; x ^= x >> 15; x = x * 0x2C1B3C6D mod 2^32; x ^= x >>
16.  Sites: the embedding 0, block i's fc1 1 + 2i and fc2 2 + 2i.

The step (`ReferenceTrainer.step`): `reference/ramdsir.py`'s, with this
network in the U-Net's place: its encoder (stem, embedding, blocks) and
CUP on the clean batch and on the RAM batch; the restoration decoder
(RAM-DSIR's, n = hidden / 16, one batch norm per source domain) on the RAM
batch's token map; the same losses and Adam.  Each transformer block and
each bottleneck unit is recomputed in the backward (`torch.utils.checkpoint`),
which changes no arithmetic, so that the full-size step fits one card; no
batch norm's statistics are split.

Departures from the published TransUNet:
  - the restoration decoder at n = 48 and the RAM / KD / restoration losses
    are RAM-DSIR's, not TransUNet's;
  - Adam with RAM-DSIR's learning rates (the encoder at half the rate) and
    poly schedule, where TransUNet trains with SGD (lr 0.01, momentum 0.9,
    weight decay 1e-4);
  - random weights from the seed, where TransUNet starts from ImageNet-21k
    ViT and ResNet weights;
  - dropout masks from the hash above, not from torch's generator;
  - the stem takes the 3 RGB channels as given (TransUNet repeats a gray
    channel).

Precision: float32 with TF32 off for convolutions and matrix products
(`ramdsir.no_tf32`); dtype=torch.bfloat16 computes the network in bfloat16
(the control), norms and softmax in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference import ramdsir
from port_bench.reference.ramdsir import CONSISTENCY_WEIGHT, kd, no_tf32, ram

GN_EPS, LN_EPS, STD_EPS, GN_PROJ_EPS = 1e-6, 1e-6, 1e-5, 1e-5
M32 = 0xFFFFFFFF
THRESHOLD = 6554


def sizes(cfg: Mapping) -> Dict:
    """The network's sizes from the configuration file's keys, named as in
    `get_r50_b16_config` (hidden_size; transformer: mlp_dim, num_heads,
    num_layers, dropout_rate; resnet: num_layers, width_factor;
    decoder_channels, n_skip), with head_channels (512 in TransUNet's
    DecoderCup) and gn_groups (32 in its ResNetV2)."""
    t, r = cfg["transformer"], cfg["resnet"]
    width = int(64 * r["width_factor"])
    n_skip = cfg["n_skip"]
    return dict(hidden=cfg["hidden_size"], mlp=t["mlp_dim"], heads=t["num_heads"], layers=t["num_layers"],
                rate=t["dropout_rate"], units=list(r["num_layers"]), width=width, head=cfg["head_channels"],
                dec=list(cfg["decoder_channels"]), groups=cfg["gn_groups"],
                skips=[c if i < n_skip else 0 for i, c in enumerate((8 * width, 4 * width, width, 0))])


def units(s: Mapping) -> List[Tuple[str, int, int, int, int]]:
    """(name, cin, cout, cmid, stride) of every bottleneck unit."""
    out, cin, w = [], s["width"], s["width"]
    for b, (n, mult) in enumerate(zip(s["units"], (1, 2, 4))):
        cout, cmid = 4 * w * mult, w * mult
        for j in range(1, n + 1):
            out.append((f"encoder.embeddings.hybrid_model.body.block{b + 1}.unit{j}", cin if j == 1 else cout,
                        cout, cmid, (1 if b == 0 else 2) if j == 1 else 1))
        cin = cout
    return out


def rec_cfg(cfg: Mapping) -> Dict:
    """The configuration as `reference/ramdsir.py` reads it for the
    restoration decoder: width n = hidden / 16."""
    return dict(cfg, width=cfg["hidden_size"] // 16)


def shapes(cfg: Mapping) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """(shape, init) of every tensor under the port's state-dict names, in a
    fixed order; init: "uniform" (+-1/sqrt(fan in)), "xavier", "tiny" (N(0,
    1e-6)), "one", "zero"."""
    s = sizes(cfg)
    h, w = s["hidden"], s["width"]
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def conv(name, cin, cout, k, bias=False):
        out[f"{name}.weight"] = ((cout, cin, k, k), "uniform")
        if bias:
            out[f"{name}.bias"] = ((cout,), "uniform")

    def norm(name, c, running=False):
        out[f"{name}.weight"], out[f"{name}.bias"] = ((c,), "one"), ((c,), "zero")
        if running:
            out[f"{name}.running_mean"], out[f"{name}.running_var"] = ((c,), "zero"), ((c,), "one")

    root = "encoder.embeddings.hybrid_model.root"
    conv(f"{root}.conv", cfg["in_channels"], w, 7)
    norm(f"{root}.gn", w)
    for name, cin, cout, cmid, stride in units(s):
        conv(f"{name}.conv1", cin, cmid, 1), norm(f"{name}.gn1", cmid)
        conv(f"{name}.conv2", cmid, cmid, 3), norm(f"{name}.gn2", cmid)
        conv(f"{name}.conv3", cmid, cout, 1), norm(f"{name}.gn3", cout)
        if stride != 1 or cin != cout:
            conv(f"{name}.downsample", cin, cout, 1), norm(f"{name}.gn_proj", cout)
    conv("encoder.embeddings.patch_embeddings", 16 * w, h, 1, bias=True)
    grid = cfg["image_size"] // 16
    out["encoder.embeddings.position_embeddings"] = ((1, grid * grid, h), "zero")
    for i in range(s["layers"]):
        p = f"encoder.encoder.layer.{i}"
        norm(f"{p}.attention_norm", h), norm(f"{p}.ffn_norm", h)
        for lin in ("query", "key", "value", "out"):
            out[f"{p}.attn.{lin}.weight"], out[f"{p}.attn.{lin}.bias"] = ((h, h), "uniform"), ((h,), "uniform")
        out[f"{p}.ffn.fc1.weight"], out[f"{p}.ffn.fc1.bias"] = ((s["mlp"], h), "xavier"), ((s["mlp"],), "tiny")
        out[f"{p}.ffn.fc2.weight"], out[f"{p}.ffn.fc2.bias"] = ((h, s["mlp"]), "xavier"), ((h,), "tiny")
    norm("encoder.encoder.encoder_norm", h)
    conv("seg_decoder.conv_more.0", h, s["head"], 3), norm("seg_decoder.conv_more.1", s["head"], True)
    for i, (cin, cout, sk) in enumerate(zip([s["head"]] + s["dec"][:-1], s["dec"], s["skips"])):
        p = f"seg_decoder.blocks.{i}"
        conv(f"{p}.conv1.0", cin + sk, cout, 3), norm(f"{p}.conv1.1", cout, True)
        conv(f"{p}.conv2.0", cout, cout, 3), norm(f"{p}.conv2.1", cout, True)
    conv("seg_decoder.segmentation_head.0", s["dec"][-1], cfg["num_classes"], 3, bias=True)
    return out


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial weights from `seed`, on `device`: TransUNet's scheme
    (PyTorch's default uniform +-1/sqrt(fan in) for convs, linears and
    their biases, xavier-uniform MLP weights, N(0, 1e-6) MLP biases, a zero
    position table, norms at weight 1 and bias 0) in two draws, a uniform
    and a normal one; the restoration decoder `reference/ramdsir.py`'s at n
    = hidden / 16, from seed + 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    table = shapes(cfg)
    n_u = sum(math.prod(sh) for sh, init in table.values() if init in ("uniform", "xavier"))
    n_n = sum(math.prod(sh) for sh, init in table.values() if init == "tiny")
    unif = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(n_n, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    iu = inn = 0
    for name, (shape, init) in table.items():
        n = math.prod(shape)
        if init in ("uniform", "xavier"):
            weight = table[name[: -len("bias")] + "weight"][0] if name.endswith(".bias") else shape
            if init == "xavier":
                bound = math.sqrt(6.0 / (weight[0] + weight[1]))
            else:
                bound = 1.0 / math.sqrt(math.prod(weight[1:]))
            out[name] = unif[iu : iu + n].view(shape) * bound
            iu += n
        elif init == "tiny":
            out[name] = normal[inn : inn + n].view(shape) * 1e-6
            inn += n
        else:
            out[name] = (torch.ones if init == "one" else torch.zeros)(shape, device=device)
    rec = ramdsir.make_weights(rec_cfg(cfg), seed + 1, device)
    out.update({k: v for k, v in rec.items() if k.startswith("rec_decoder.")})
    return out


# --- the dropout masks -------------------------------------------------------------


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = torch.bitwise_xor(x, torch.bitwise_right_shift(x, 16))
    x = torch.remainder(x * 0x7FEB352D, 2**32)
    x = torch.bitwise_xor(x, torch.bitwise_right_shift(x, 15))
    x = torch.remainder(x * 0x2C1B3C6D, 2**32)
    return torch.bitwise_xor(x, torch.bitwise_right_shift(x, 16))


def drop(x: torch.Tensor, seeds: Optional[torch.Tensor], half: int, site: int, rate: float) -> torch.Tensor:
    """Dropout of x (rows first) at `site` for the rows of `half` whose seeds
    are `seeds` (the module docstring)."""
    if seeds is None or rate == 0.0:
        return x
    rows = x.shape[0]
    n = x[0].numel()
    key = mix32(torch.remainder(mix32(torch.remainder(seeds.long(), 2**32)) + half, 2**32))
    key = mix32(torch.remainder(key + site * 0x9E3779B9, 2**32))
    j = torch.arange((n + 1) // 2, dtype=torch.int64, device=x.device)
    h = mix32(torch.bitwise_xor(j[None, :], key[:, None]))
    lo, hi = torch.remainder(h, 2**16), torch.div(h, 2**16, rounding_mode="floor")
    keep = torch.empty((rows, 2 * j.numel()), dtype=torch.bool, device=x.device)
    keep[:, 0::2], keep[:, 1::2] = lo >= THRESHOLD, hi >= THRESHOLD
    return torch.where(keep[:, :n].reshape(x.shape), x * (1.0 / (1.0 - rate)), 0.0)


# --- the network ----------------------------------------------------------------------


def up2_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 with align_corners=True: output i of an axis of n from
    input i (n - 1) / (2n - 1), the two neighbours weighed by the fraction."""
    for dim in (2, 3):
        n = x.shape[dim]
        src = torch.arange(2 * n, dtype=torch.float32, device=x.device) * ((n - 1) / (2 * n - 1))
        lo = src.floor().long().clamp(max=n - 1)
        hi = (lo + 1).clamp(max=n - 1)
        frac = (src - lo.float()).to(x.dtype)
        shape = [1] * x.ndim
        shape[dim] = 2 * n
        frac = frac.view(shape)
        x = (1.0 - frac) * x.index_select(dim, lo) + frac * x.index_select(dim, hi)
    return x


class TransUNet:
    """The network over a dict of named tensors; `train` chooses batch or
    running statistics for the batch norms (running statistics moved in
    training)."""

    def __init__(self, cfg: Mapping, tensors: Mapping[str, torch.Tensor], dtype=torch.float32):
        self.s = sizes(cfg)
        self.t = tensors
        self.dtype = dtype

    def w(self, name):
        return self.t[name].to(self.dtype)

    def std_conv(self, x, name, stride=1):
        w = self.t[f"{name}.weight"]
        k = w.shape[-1]
        var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, correction=0)
        w = (w - mean) / torch.sqrt(var + STD_EPS)
        return F.conv2d(x, w.to(self.dtype), None, stride, k // 2)

    def gn(self, x, name, groups, eps=GN_EPS):
        return F.group_norm(x.float(), groups, self.t[f"{name}.weight"], self.t[f"{name}.bias"], eps).to(self.dtype)

    def ln(self, x, name):
        return F.layer_norm(x.float(), x.shape[-1:], self.t[f"{name}.weight"], self.t[f"{name}.bias"],
                            LN_EPS).to(self.dtype)

    def linear(self, x, name):
        return F.linear(x, self.w(f"{name}.weight"), self.w(f"{name}.bias"))

    def bn(self, x, name, train):
        t = self.t
        return F.batch_norm(x.float(), t[f"{name}.running_mean"], t[f"{name}.running_var"], t[f"{name}.weight"],
                            t[f"{name}.bias"], train, ramdsir.BN_MOMENTUM, ramdsir.BN_EPS).to(self.dtype)

    def unit(self, x, name, cin, cout, stride):
        g = self.s["groups"]
        if stride != 1 or cin != cout:
            residual = self.gn(self.std_conv(x, f"{name}.downsample", stride), f"{name}.gn_proj", cout, GN_PROJ_EPS)
        else:
            residual = x
        y = F.relu(self.gn(self.std_conv(x, f"{name}.conv1"), f"{name}.gn1", g))
        y = F.relu(self.gn(self.std_conv(y, f"{name}.conv2", stride), f"{name}.gn2", g))
        y = self.gn(self.std_conv(y, f"{name}.conv3"), f"{name}.gn3", g)
        return F.relu(residual + y)

    def stem(self, x):
        """(the last block's map, [root, block 1 padded, block 2])."""
        size = x.shape[-1]
        root = "encoder.embeddings.hybrid_model.root"
        x = F.relu(self.gn(self.std_conv(x, f"{root}.conv", 2), f"{root}.gn", self.s["groups"]))
        skips = [x]
        x = F.max_pool2d(x, 3, 2, 0)
        table = units(self.s)
        for b in range(3):
            for name, cin, cout, _, stride in [u for u in table if f".block{b + 1}." in u[0]]:
                x = checkpoint(self.unit, x, name, cin, cout, stride, use_reentrant=False)
            if b < 2:
                want = size // 4 // (b + 1)
                feat = torch.zeros(x.shape[:2] + (want, want), dtype=x.dtype, device=x.device)
                feat[:, :, : x.shape[2], : x.shape[3]] = x
                skips.append(feat)
        return x, skips

    def block(self, x, i, seeds, half):
        p, s = f"encoder.encoder.layer.{i}", self.s
        b, n, h = x.shape
        d = h // s["heads"]
        y = self.ln(x, f"{p}.attention_norm")
        q, k, v = (self.linear(y, f"{p}.attn.{lin}").view(b, n, s["heads"], d).transpose(1, 2)
                   for lin in ("query", "key", "value"))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        probs = torch.softmax(scores.float(), dim=-1).to(self.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, h)
        x = x + self.linear(ctx, f"{p}.attn.out")
        y = self.ln(x, f"{p}.ffn_norm")
        y = drop(F.gelu(self.linear(y, f"{p}.ffn.fc1")), seeds, half, 1 + 2 * i, s["rate"])
        return x + drop(self.linear(y, f"{p}.ffn.fc2"), seeds, half, 2 + 2 * i, s["rate"])

    def encoder(self, x, seeds, half):
        """[root, block 1, block 2, token map]; seeds None: no dropout."""
        x, skips = self.stem(x.to(self.dtype))
        e = "encoder.embeddings"
        x = F.conv2d(x, self.w(f"{e}.patch_embeddings.weight"), self.w(f"{e}.patch_embeddings.bias"))
        b, h, gh, gw = x.shape
        x = drop(x.flatten(2).transpose(1, 2) + self.w(f"{e}.position_embeddings"), seeds, half, 0, self.s["rate"])
        for i in range(self.s["layers"]):
            x = checkpoint(self.block, x, i, seeds, half, use_reentrant=False)
        x = self.ln(x, "encoder.encoder.encoder_norm")
        return skips + [x.transpose(1, 2).reshape(b, h, gh, gw)]

    def conv_bn_relu(self, x, name, train):
        return F.relu(self.bn(F.conv2d(x, self.w(f"{name}.0.weight"), None, 1, 1), f"{name}.1", train))

    def cup(self, feats, train):
        x = self.conv_bn_relu(feats[3], "seg_decoder.conv_more", train)
        skips = [feats[2], feats[1], feats[0], None]
        for i, (skip, width) in enumerate(zip(skips, self.s["skips"])):
            x = up2_corners(x)
            if width:
                x = torch.cat([x, skip], 1)
            x = self.conv_bn_relu(x, f"seg_decoder.blocks.{i}.conv1", train)
            x = self.conv_bn_relu(x, f"seg_decoder.blocks.{i}.conv2", train)
        head = "seg_decoder.segmentation_head.0"
        return F.conv2d(x, self.w(f"{head}.weight"), self.w(f"{head}.bias"), 1, 1)

    def segment(self, x, train, seeds=None, half=0):
        """(token map, logits in float32)."""
        feats = self.encoder(x, seeds, half)
        return feats[3], self.cup(feats, train).float()


class ReferenceTrainer(ramdsir.ReferenceTrainer):
    """`reference/ramdsir.py`'s trainer (data, heads, Adam, snapshots) with
    TransUNet as its network; draws["dropout_seed"] holds a seed a row."""

    def loss(self, img_idx, donor_idx, draws):
        img, donor, mask = self.batch(img_idx, donor_idx, draws)
        ratio = torch.as_tensor(draws["ratio"]).to(img.device).float()
        seeds = torch.as_tensor(draws["dropout_seed"]).to(img.device).long()
        freq = ram(img, donor, ratio)
        if self.fundus:
            clean, freq = img / 127.5 - 1.0, freq.clamp(0.0, 255.0) / 127.5 - 1.0
        else:
            clean, freq = img, freq.clamp(-1.0, 1.0)
        net = TransUNet(self.cfg, self.tensors, self.dtype)
        with no_tf32(self.tf32_convs):
            _, logits1 = net.segment(clean, True, seeds, 0)
            bottleneck, logits2 = net.segment(freq, True, seeds, 1)
            p1, sup1, dice1 = self.head(logits1, mask)
            p2, sup2, dice2 = self.head(logits2, mask)
            loss = sup1 + dice1 + sup2 + dice2 + CONSISTENCY_WEIGHT * kd(p2, p1)
            if self.cfg.get("rec", True):
                unet = ramdsir.UNet(self.tensors, self.dtype)
                rec = torch.tanh(unet.rec_decoder(bottleneck, self.domains, True).float())
                per_row = torch.sum((rec - clean) ** 2, dim=(1, 2, 3)) / float(np.prod(clean.shape[1:]))
                start = 0
                for bs in self.bsl:
                    loss = loss + self.cfg["lambda_rec"] * per_row[start : start + bs].sum() / bs
                    start += bs
        return loss


def predict(cfg: Mapping, weights: Mapping[str, torch.Tensor], x: torch.Tensor, fundus: bool,
            dtype=torch.float32) -> torch.Tensor:
    """Probabilities (B, K, H, W) of a normalised NCHW batch, running
    statistics, no dropout."""
    with torch.no_grad(), no_tf32():
        _, logits = TransUNet(cfg, weights, dtype).segment(x, False)
    return torch.sigmoid(logits) if fundus else torch.softmax(logits, 1)

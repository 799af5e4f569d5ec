"""Plain reference of RAM-DSIR training and target-domain evaluation, in plain
PyTorch, NumPy and SciPy, written from the method's description (arXiv
2208.03901; the reference code's train.py and test scripts), not from the
program under test: it imports nothing of the PyTorch port nor of the JAX
package.

Training step (one call of `ReferenceTrainer.step`):
  1. gather the batch's rows from the train stack; fundus: the random
     scale-crop (with probability 1/2 upscale by floor(u * S) / S per axis,
     u ~ U(1, 1.5), bilinear with half-pixel centres for the image, the
     nearest (rounded) source pixel for the mask, then an S x S crop);
  2. RAM: per sample and channel the 2-D FFT, the amplitude in the centred
     square of half-width b = floor(0.1 * S) set to r * |z| + (1 - r) * |donor|
     (phase kept), the inverse FFT's real part; fundus clips to [0, 255] and
     maps to [-1, 1], prostate clips to [-1, 1];
  3. encoder + seg decoder on the clean batch and on the RAM batch, each
     half's batch norm with its own statistics, the running statistics
     moved by the clean pass, then by the RAM pass;
  4. the restoration decoder on the RAM bottleneck with one batch norm per
     source domain (each domain's rows its own statistics);
  5. loss = sup(clean) + dice(clean) + sup(RAM) + dice(RAM) + 0.5 * KD
     + lambda_rec * sum over domains of the domain's restoration MSE;
     fundus: BCE on logits and the squared-sum soft dice of both sigmoid
     channels; prostate: 2-class softmax cross-entropy and the dice of the
     class-1 probability; KD: symmetric KL of the probabilities clipped to
     [1e-8, 1];
  6. Adam (0.9, 0.999, 1e-8), the poly LR (power 0.9, the step before the
     counter moves, so step i runs at lr(max(i - 1, 0))), the encoder at
     half the LR.

Evaluation: fundus images resized to the train size with PIL's BILINEAR
(`pil_bilinear`, the fixed-point filter of Pillow's Resample.c), the
sigmoid probabilities resized back to the mask's size (bilinear, half-pixel
centres), thresholded at 0.75, the largest 8-connected component with its
holes filled, Dice with smooth 1; prostate volumes min-max scaled to
[-1, 1], 3-slice windows in batches, softmax argmax labels (frames with an
empty mask left 0), the largest 6-connected component of the volume, Dice.

Precision: float32 with TF32 off for convolutions and matrix products
(`no_tf32`); `dtype=torch.bfloat16` computes the model in bfloat16 (the
control).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BN_MOMENTUM, BN_EPS = 0.1, 1e-5
KD_EPS = 1e-8
CONSISTENCY_WEIGHT = 0.5
POLY_POWER = 0.9
RAM_L = 0.1


# --- the architecture -------------------------------------------------------


def conv_layers(cfg: Mapping) -> List[Tuple[str, int, int, int]]:
    """(name, cin, cout, kernel) of every convolution, in the models' order."""
    n, c, k = cfg["width"], cfg["in_channels"], cfg["num_classes"]
    out = []
    cin = c
    for i in range(5):
        cout = n * 2**i
        pre = f"encoder.convd{i + 1}"
        out += [(f"{pre}.conv1", cin, cout, 3), (f"{pre}.conv2", cout, cout, 3), (f"{pre}.conv3", cout, cout, 3)]
        cin = cout
    for i, planes in zip((4, 3, 2, 1), (16 * n, 8 * n, 4 * n, 2 * n)):
        pre = f"seg_decoder.convu{i}"
        if i != 4:
            out.append((f"{pre}.conv1", 2 * planes, planes, 3))
        out += [(f"{pre}.conv2", planes, planes // 2, 1), (f"{pre}.conv3", planes, planes, 3)]
    out.append(("seg_decoder.out1", 2 * n, k, 3))
    if cfg.get("rec", True):
        for i, planes in zip((4, 3, 2, 1), (16 * n, 8 * n, 4 * n, 2 * n)):
            pre, half = f"rec_decoder.convu{i}", planes // 2
            out += [(f"{pre}.conv1", planes, half, 3), (f"{pre}.conv2", half, half, 1), (f"{pre}.conv3", half, half, 3)]
        out.append(("rec_decoder.out1", n, c, 3))
    return out


def norm_layers(cfg: Mapping) -> List[Tuple[str, int]]:
    """(name, channels) of every batch norm; the restoration decoder's per
    domain (`...bn1.bns.{d}`)."""
    out = []
    for name, _, cout, _ in conv_layers(cfg):
        if name.endswith("out1"):
            continue
        pre, leaf = name.rsplit(".", 1)
        bn = f"{pre}.{leaf.replace('conv', 'bn')}"
        if name.startswith("rec_decoder"):
            out += [(f"{bn}.bns.{d}", cout) for d in range(len(cfg["domain_idxs"]))]
        else:
            out.append((bn, cout))
    return out


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial weights from `seed`, on `device`, in two draws: Kaiming
    normal (fan out, gain sqrt 2) conv weights, uniform +-1/sqrt(fan in)
    conv biases; norms at weight 1, bias 0, running mean 0, variance 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    convs = conv_layers(cfg)
    n_w = sum(ci * co * k * k for _, ci, co, k in convs)
    n_b = sum(co for _, _, co, _ in convs)
    normal = torch.randn(n_w, generator=gen, device=device)
    unif = torch.rand(n_b, generator=gen, device=device) * 2.0 - 1.0
    out: Dict[str, torch.Tensor] = {}
    iw = ib = 0
    for name, ci, co, k in convs:
        w = normal[iw : iw + ci * co * k * k].view(co, ci, k, k)
        out[f"{name}.weight"] = w * math.sqrt(2.0 / (co * k * k))
        out[f"{name}.bias"] = unif[ib : ib + co] / math.sqrt(ci * k * k)
        iw, ib = iw + w.numel(), ib + co
    for name, ch in norm_layers(cfg):
        out[f"{name}.weight"] = torch.ones(ch, device=device)
        out[f"{name}.bias"] = torch.zeros(ch, device=device)
        out[f"{name}.running_mean"] = torch.zeros(ch, device=device)
        out[f"{name}.running_var"] = torch.ones(ch, device=device)
    return out


def is_buffer(name: str) -> bool:
    return name.endswith("running_mean") or name.endswith("running_var")


@contextlib.contextmanager
def no_tf32(tf32_convs: bool = False):
    """Full float32 matrix products for the duration, and convolutions in
    full float32 or, with tf32_convs (a witness, not the reference), in
    TF32 as cuDNN runs them by default."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = bool(tf32_convs), False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class UNet:
    """The functional encoder, seg decoder and restoration decoder over a
    dict of named tensors.  mode: "train" (batch statistics, running
    statistics moved) or "eval" (running statistics)."""

    def __init__(self, tensors: Mapping[str, torch.Tensor], dtype=torch.float32):
        self.t = tensors
        self.dtype = dtype

    def conv(self, x, name, k):
        w, b = self.t[f"{name}.weight"], self.t[f"{name}.bias"]
        return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), padding=k // 2)

    def norm(self, x, name, train):
        t = self.t
        y = F.batch_norm(x.float(), t[f"{name}.running_mean"], t[f"{name}.running_var"], t[f"{name}.weight"],
                         t[f"{name}.bias"], train, BN_MOMENTUM, BN_EPS)
        return y.to(x.dtype)

    @staticmethod
    def up2(x):
        """Bilinear x2 with half-pixel centres (align_corners=False): output
        2i is 3/4 of input i and 1/4 of input i - 1, output 2i + 1 3/4 of i
        and 1/4 of i + 1, the edges clamped; slices, so its backward is
        deterministic."""
        for dim in (2, 3):
            n = x.shape[dim]
            prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
            nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
            x = torch.stack([0.75 * x + 0.25 * prev, 0.75 * x + 0.25 * nxt], dim + 1).flatten(dim, dim + 1)
        return x

    def encoder(self, x, train):
        feats = []
        for i in range(5):
            p = f"encoder.convd{i + 1}"
            if i:
                x = F.max_pool2d(x, 2)
            x = self.norm(self.conv(x, f"{p}.conv1", 3), f"{p}.bn1", train)
            x = F.relu(self.norm(self.conv(x, f"{p}.conv2", 3), f"{p}.bn2", train))
            x = F.relu(self.norm(self.conv(x, f"{p}.conv3", 3), f"{p}.bn3", train))
            feats.append(x)
        return feats

    def seg_decoder(self, feats, train):
        y = feats[4]
        for i, skip in zip((4, 3, 2, 1), (feats[3], feats[2], feats[1], feats[0])):
            p = f"seg_decoder.convu{i}"
            if i != 4:
                y = F.relu(self.norm(self.conv(y, f"{p}.conv1", 3), f"{p}.bn1", train))
            z = F.relu(self.norm(self.conv(self.up2(y), f"{p}.conv2", 1), f"{p}.bn2", train))
            y = F.relu(self.norm(self.conv(torch.cat([skip, z], 1), f"{p}.conv3", 3), f"{p}.bn3", train))
        return self.conv(y, "seg_decoder.out1", 3)

    def rec_decoder(self, x, domains: Sequence[int], train):
        """domains: each row's domain, in contiguous blocks."""
        d_arr = np.asarray(domains)
        for i in (4, 3, 2, 1):
            p = f"rec_decoder.convu{i}"

            def dsbn(h, name):
                parts = [self.norm(h[np.flatnonzero(d_arr == d)[0] : np.flatnonzero(d_arr == d)[-1] + 1],
                                   f"{name}.bns.{d}", train) for d in np.unique(d_arr)]
                return torch.cat(parts)

            x = F.relu(dsbn(self.conv(x, f"{p}.conv1", 3), f"{p}.bn1"))
            x = F.relu(dsbn(self.conv(self.up2(x), f"{p}.conv2", 1), f"{p}.bn2"))
            x = F.relu(dsbn(self.conv(x, f"{p}.conv3", 3), f"{p}.bn3"))
        return self.conv(x, "rec_decoder.out1", 3)

    def segment(self, x, train):
        """(bottleneck, logits)."""
        feats = self.encoder(x.to(self.dtype), train)
        return feats[4], self.seg_decoder(feats, train).float()


# --- data-side operations of a step ---------------------------------------------


def scale_crop(img: torch.Tensor, mask: torch.Tensor, apply, u, off, size: int):
    """One sample's random scale-crop.  img (C, S, S) float, mask (K, S, S);
    apply bool, u (2,) in [1, 1.5), off (2,) in [0, 1)."""
    if not bool(apply):
        return img, mask
    u32, off32 = torch.as_tensor(u, dtype=torch.float32), torch.as_tensor(off, dtype=torch.float32)
    t = torch.floor(u32 * size)  # the upscaled sides, float32 arithmetic as drawn
    y0, x0 = (torch.floor(off32 * (t - size + 1))).tolist()
    th, tw = t.tolist()

    def src(o, t):  # source coordinates of output pixels o..o+S-1 in an upscale to t
        d = torch.arange(size, dtype=torch.float32, device=img.device) + o
        return ((d + 0.5) / torch.tensor(t / size, dtype=torch.float32) - 0.5).clamp(0.0, size - 1.0)

    sy, sx = src(y0, th), src(x0, tw)
    fy, fx = sy.floor(), sx.floor()
    ay, ax = sy - fy, sx - fx
    y_lo, x_lo = fy.long(), fx.long()
    y_hi, x_hi = (y_lo + 1).clamp(max=size - 1), (x_lo + 1).clamp(max=size - 1)
    rows = img[:, y_lo] * (1 - ay)[:, None] + img[:, y_hi] * ay[:, None]
    out = rows[:, :, x_lo] * (1 - ax) + rows[:, :, x_hi] * ax
    my, mx = torch.round(sy).long(), torch.round(sx).long()  # half to even
    return out, mask[:, my][:, :, mx]


def ram(src: torch.Tensor, donor: torch.Tensor, ratio: torch.Tensor, L: float = RAM_L) -> torch.Tensor:
    """Random amplitude mixup of (B, C, H, W) images with donors of the same
    shape, per-sample ratio (B,); the real part of the inverse transform."""
    h, w = src.shape[-2:]
    b = int(math.floor(min(h, w) * L))
    z = torch.fft.fftshift(torch.fft.fft2(src.float()), dim=(-2, -1))
    amp_d = torch.fft.fftshift(torch.fft.fft2(donor.float()), dim=(-2, -1)).abs()
    amp, pha = z.abs(), torch.angle(z)
    r = ratio.view(-1, 1, 1, 1).float()
    ch, cw = h // 2, w // 2
    sl = (slice(None), slice(None), slice(ch - b, ch + b + 1), slice(cw - b, cw + b + 1))
    amp = amp.clone()
    amp[sl] = r * amp[sl] + (1 - r) * amp_d[sl]
    z = torch.polar(amp, pha)
    return torch.fft.ifft2(torch.fft.ifftshift(z, dim=(-2, -1))).real


def kd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Symmetric KL of two probability maps, each clipped to [1e-8, 1];
    KLDivLoss(mean) each way."""
    p, q = p.clamp(KD_EPS, 1.0), q.clamp(KD_EPS, 1.0)
    return torch.mean(q * (q.log() - p.log())) + torch.mean(p * (p.log() - q.log()))


def soft_dice(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    smooth = 1e-5
    return 1 - (2 * torch.sum(p * t) + smooth) / (torch.sum(p * p) + torch.sum(t * t) + smooth)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of (B, K, H, W) logits against (B, H, W)
    labels, through a one-hot mask (deterministic on the card both ways)."""
    onehot = F.one_hot(labels.long(), logits.shape[1]).permute(0, 3, 1, 2).to(logits.dtype)
    return -torch.mean(torch.sum(onehot * torch.log_softmax(logits, 1), 1))


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the duration (cuDNN's, and torch raising
    on any operation without one), so that the eval weights are the same on
    every card of a kind."""
    cudnn = torch.backends.cudnn
    saved = torch.are_deterministic_algorithms_enabled(), cudnn.deterministic, cudnn.benchmark
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        cudnn.deterministic, cudnn.benchmark = saved[1], saved[2]


def poly_lr(base: float, step: int, total: int) -> float:
    return base * (1.0 - max(step - 1, 0) / total) ** POLY_POWER


# --- the training step ---------------------------------------------------------


class ReferenceTrainer:
    """Plain RAM-DSIR training from given weights.

    data: the train stack as given to the program: fundus {"images" (N, S,
    S, 3) uint8, "masks" (N, S, S) uint8 gray, "donors" (M, S, S, 3) uint8};
    prostate {"images" (N, S, S, 3) float32 in [-1, 1], "masks" (N, S, S)
    int}; on the trainer's device.  `step(img_idx, donor_idx, draws)` runs
    one step and returns its loss; after it `grads` holds the gradients.
    The stack may stay on the host: a step moves its rows to `device`.
    tf32_convs: the convolutions in TF32 (a witness, not the reference).
    moments, steps: Adam's (exp_avg, exp_avg_sq) by parameter name and the
    steps already taken, to go on from a state after `steps` steps (default
    zeros and 0, the start)."""

    def __init__(self, cfg: Mapping, weights: Mapping[str, torch.Tensor], data: Mapping[str, torch.Tensor],
                 total_iters: int, dtype=torch.float32, device=None, tf32_convs: bool = False,
                 moments=None, steps: int = 0):
        self.cfg = cfg
        self.tf32_convs = tf32_convs
        self.device = torch.device(device) if device is not None else next(iter(weights.values())).device
        self.fundus = cfg["dataset"] == "fundus"
        self.dtype = dtype
        self.tensors = {k: v.detach().to(self.device, torch.float32, copy=True) for k, v in weights.items()}
        self.params = {k: v for k, v in self.tensors.items() if not is_buffer(k)}
        for v in self.params.values():
            v.requires_grad_(True)
        if moments is None:
            self.exp_avg = {k: torch.zeros_like(v) for k, v in self.params.items()}
            self.exp_avg_sq = {k: torch.zeros_like(v) for k, v in self.params.items()}
        else:
            self.exp_avg, self.exp_avg_sq = ({k: m[k].detach().to(self.device, torch.float32, copy=True)
                                              for k in self.params} for m in moments)
        self.data = data
        self.total_iters = total_iters
        self.steps = steps
        self.grads: Dict[str, torch.Tensor] = {}
        bsl = list(cfg["batch_size_list"])
        self.domains = np.repeat(np.arange(len(bsl)), bsl)
        self.bsl = bsl

    def snapshot(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The state on the host: tensors (parameters and running
        statistics), exp_avg and exp_avg_sq by name."""
        host = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}
        return {"tensors": host(self.tensors), "exp_avg": host(self.exp_avg), "exp_avg_sq": host(self.exp_avg_sq)}

    def batch(self, img_idx, donor_idx, draws):
        """(img, donor) NCHW float and the mask: fundus (B, 2, S, S) [cup,
        disc], prostate (B, S, S) labels."""
        d, dev = self.data, self.device
        ii = torch.as_tensor(np.asarray(img_idx), device=d["images"].device).long()
        di = torch.as_tensor(np.asarray(donor_idx), device=d["images"].device).long()
        rows = lambda t, i: t[i].to(dev)
        if not self.fundus:
            img = rows(d["images"], ii).permute(0, 3, 1, 2).float()
            donor = rows(d["images"], di).permute(0, 3, 1, 2).float()
            return img, donor, rows(d["masks"], ii).long()
        gray = rows(d["masks"], ii).long()
        mask = torch.stack([gray <= 50, gray <= 200], 1).float()  # cup: gray <= 50; disc: cup or 51..200
        img = rows(d["images"], ii).permute(0, 3, 1, 2).float()
        size = img.shape[-1]
        pairs = [scale_crop(img[j], mask[j], draws["crop_apply"][j], draws["crop_u"][j], draws["crop_off"][j], size)
                 for j in range(img.shape[0])]
        img = torch.stack([p[0] for p in pairs])
        mask = torch.stack([p[1] for p in pairs])
        donor = rows(d["donors"], di).permute(0, 3, 1, 2).float()
        return img, donor, mask

    def head(self, logits, mask):
        """(probabilities for KD, supervised loss, dice loss)."""
        if self.fundus:
            p = torch.sigmoid(logits)
            return p, F.binary_cross_entropy_with_logits(logits, mask), soft_dice(p, mask)
        p = torch.softmax(logits, 1)
        return p, cross_entropy(logits, mask), soft_dice(p[:, 1], (mask == 1).float())

    def loss(self, img_idx, donor_idx, draws):
        img, donor, mask = self.batch(img_idx, donor_idx, draws)
        ratio = torch.as_tensor(draws["ratio"]).to(img.device).float()
        freq = ram(img, donor, ratio)
        if self.fundus:
            clean, freq = img / 127.5 - 1.0, freq.clamp(0.0, 255.0) / 127.5 - 1.0
        else:
            clean, freq = img, freq.clamp(-1.0, 1.0)
        net = UNet(self.tensors, self.dtype)
        with no_tf32(self.tf32_convs):
            _, logits1 = net.segment(clean, True)
            bottleneck, logits2 = net.segment(freq, True)
            p1, sup1, dice1 = self.head(logits1, mask)
            p2, sup2, dice2 = self.head(logits2, mask)
            loss = sup1 + dice1 + sup2 + dice2 + CONSISTENCY_WEIGHT * kd(p2, p1)
            if self.cfg.get("rec", True):
                rec = torch.tanh(net.rec_decoder(bottleneck, self.domains, True).float())
                per_row = torch.sum((rec - clean) ** 2, dim=(1, 2, 3)) / float(np.prod(clean.shape[1:]))
                start = 0
                for bs in self.bsl:
                    loss = loss + self.cfg["lambda_rec"] * per_row[start : start + bs].sum() / bs
                    start += bs
        return loss

    def step(self, img_idx, donor_idx, draws) -> float:
        loss = self.loss(img_idx, donor_idx, draws)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        self.grads = dict(zip(names, grads))
        lr = poly_lr(self.cfg["lr"], self.steps, self.total_iters)
        self.steps += 1
        t = self.steps
        with torch.no_grad():
            for k in names:
                g = self.grads[k]
                m, v = self.exp_avg[k], self.exp_avg_sq[k]
                m.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                v.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                group_lr = lr * (0.5 if k.startswith("encoder.") and self.cfg.get("rec", True) else 1.0)
                denom = (v.sqrt() / math.sqrt(1 - ADAM_B2**t)).add_(ADAM_EPS)
                self.params[k].addcdiv_(m, denom, value=-group_lr / (1 - ADAM_B1**t))
        return float(loss.detach())


# --- evaluation ----------------------------------------------------------------------------


def pil_bilinear(a: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Pillow's Image.resize((out_w, out_h), BILINEAR) of a uint8 (H, W[, C])
    array: per axis the triangle filter widened by the downscale factor,
    weights normalised and rounded to 22 fractional bits, the horizontal
    pass first (rounded and clipped to uint8), then the vertical one."""
    bits = 22

    def coeffs(n_in, n_out):
        scale = n_in / n_out
        fscale = max(scale, 1.0)
        support, ss = fscale, 1.0 / fscale
        ksize = int(math.ceil(support)) * 2 + 1
        lo = np.zeros(n_out, np.int64)
        ws = np.zeros((n_out, ksize))
        for i in range(n_out):
            center = (i + 0.5) * scale
            xmin = max(int(center - support + 0.5), 0)
            xmax = min(int(center + support + 0.5), n_in) - xmin
            total = 0.0
            for x in range(xmax):
                t = abs((x + xmin - center + 0.5) * ss)
                v = 1.0 - t if t < 1.0 else 0.0
                ws[i, x] = v
                total += v
            ws[i] /= total
            lo[i] = xmin
        return lo, np.trunc(np.where(ws < 0, -0.5, 0.5) + ws * (1 << bits)).astype(np.int64)

    def one_axis(x, axis, n_out):
        n_in = x.shape[axis]
        if n_in == n_out:
            return x
        lo, ws = coeffs(n_in, n_out)
        acc = np.full(x.shape[:axis] + (n_out,) + x.shape[axis + 1 :], 1 << (bits - 1), np.int64)
        shape = [1] * x.ndim
        shape[axis] = n_out
        for k in range(ws.shape[1]):
            idx = np.minimum(lo + k, n_in - 1)
            acc += np.take(x, idx, axis=axis).astype(np.int64) * ws[:, k].reshape(shape)
        return np.clip(acc >> bits, 0, 255).astype(np.uint8)

    return one_axis(one_axis(np.asarray(a), 1, out_w), 0, out_h)


def largest_fillhole(binary: np.ndarray) -> np.ndarray:
    """Largest 8-connected component, holes filled."""
    from scipy import ndimage

    binary = binary.astype(bool)
    if not binary.any():
        return np.zeros(binary.shape, np.uint8)
    labels, n = ndimage.label(binary, structure=np.ones((3, 3), bool))
    sizes = np.bincount(labels.ravel())[1:]
    return ndimage.binary_fill_holes(labels == 1 + int(np.argmax(sizes))).astype(np.uint8)


def largest_component_3d(mask: np.ndarray) -> np.ndarray:
    """Largest 6-connected component of a volume (all zeros if empty)."""
    from scipy import ndimage

    labels, n = ndimage.label(mask != 0)
    if n == 0:
        return np.zeros(mask.shape, np.uint8)
    sizes = np.bincount(labels.ravel())[1:]
    return (labels == 1 + int(np.argmax(sizes))).astype(np.uint8)


def fundus_targets(gray: np.ndarray) -> np.ndarray:
    """(H, W) gray mask -> (2, H, W) [cup, disc]: cup <= 50, disc <= 200."""
    return np.stack([gray <= 50, gray <= 200]).astype(np.uint8)


def dice_smooth(p: np.ndarray, t: np.ndarray) -> float:
    p, t = p.astype(bool), t.astype(bool)
    return (2.0 * float(np.logical_and(p, t).sum()) + 1.0) / (1.0 + float(p.sum()) + float(t.sum()))


def dice_plain(p: np.ndarray, t: np.ndarray) -> float:
    p, t = p.astype(bool), t.astype(bool)
    denom = float(p.sum() + t.sum())
    return 0.0 if denom == 0 else 2.0 * float(np.logical_and(p, t).sum()) / denom


def predict(weights: Mapping[str, torch.Tensor], x: torch.Tensor, fundus: bool, dtype=torch.float32) -> torch.Tensor:
    """Probabilities (B, K, H, W) of a normalised NCHW batch, running statistics."""
    with torch.no_grad(), no_tf32():
        _, logits = UNet(weights, dtype).segment(x, False)
    return torch.sigmoid(logits) if fundus else torch.softmax(logits, 1)


def fundus_post(probs: np.ndarray, masks: Sequence[np.ndarray], q16: bool = False):
    """(per-image post-processed labels (2, H, W) uint8, per-image (cup,
    disc) Dice, (predicted, true) disc areas summed) of (N, 2, S, S)
    probabilities and the original-size gray masks: each map resized to its
    mask's size, thresholded at 0.75, the largest component with its holes
    filled.  q16: the probabilities first rounded to 1/65535, as an eval
    that reads them back as uint16 codes holds them."""
    probs = np.asarray(probs, np.float32)
    if q16:
        probs = np.round(probs * np.float32(65535.0)).astype(np.float32) / np.float32(65535.0)
    dices, areas, posts = [], [0, 0], []
    for p, gray in zip(probs, masks):
        h, w = gray.shape
        full = F.interpolate(torch.from_numpy(p)[None], size=(h, w), mode="bilinear", align_corners=False)[0].numpy()
        post = np.stack([largest_fillhole(full[c] > 0.75) for c in range(2)])
        tgt = fundus_targets(gray)
        dices.append((dice_smooth(post[0], tgt[0]), dice_smooth(post[1], tgt[1])))
        areas[0] += int(post[1].sum())
        areas[1] += int(tgt[1].sum())
        posts.append(post)
    return posts, dices, tuple(areas)


def eval_fundus(weights, images: Sequence[np.ndarray], masks: Sequence[np.ndarray], size: int, batch: int,
                device, dtype=torch.float32):
    """(probabilities (N, 2, S, S) float32 numpy, then `fundus_post`'s
    labels, Dice and areas) of the original-size RGB images and gray masks."""
    small = np.stack([pil_bilinear(im, size, size) for im in images])
    probs = []
    for s in range(0, len(small), batch):
        x = torch.from_numpy(small[s : s + batch]).to(device).permute(0, 3, 1, 2).float() / 127.5 - 1.0
        probs.append(predict(weights, x, True, dtype).cpu())
    probs = torch.cat(probs).numpy()
    return (probs,) + fundus_post(probs, masks)


def prostate_post(probs: np.ndarray, mask: np.ndarray):
    """(the post-processed labels (D, H, W) uint8, Dice, (predicted, true)
    areas) of a volume's frames' (F, 2, H, W) probabilities (frame f + 1
    of the volume at row f) and its label mask (label 2 counts as 1):
    argmax labels in the frames whose mask is not empty, the largest
    6-connected component of the volume."""
    mask = np.where(mask == 2, 1, mask)
    pred = np.zeros(mask.shape, np.uint8)
    labels = np.argmax(np.asarray(probs), axis=1).astype(np.uint8)
    for j, lab in enumerate(labels):
        if mask[j + 1].sum() > 0:
            pred[j + 1] = lab
    post = largest_component_3d(pred)
    return post, dice_plain(post, mask), (int(post.sum()), int((mask != 0).sum()))


def eval_prostate_volume(weights, image: np.ndarray, mask: np.ndarray, batch: int, device, dtype=torch.float32):
    """(softmax probabilities of the frames' windows (F, 2, H, W), then
    `prostate_post`'s labels, Dice and areas) of one (D, H, W) volume:
    min-max to [-1, 1], 3-slice windows in batches, the frames 1..D-2 that
    fill whole batches."""
    image = image.astype(np.float64)
    lo, hi = image.min(), image.max()
    image = (2.0 * (image - lo) / max(hi - lo, 1e-12) - 1.0).astype(np.float32)
    depth = image.shape[0]
    frames = list(range(1, depth - 1))[: (depth // batch) * batch]
    probs = []
    for s in range(0, len(frames), batch):
        fr = frames[s : s + batch]
        win = np.zeros((batch,) + image.shape[1:] + (3,), np.float32)
        for j, f in enumerate(fr):
            win[j] = image[f - 1 : f + 2].transpose(1, 2, 0)
        x = torch.from_numpy(win).to(device).permute(0, 3, 1, 2)
        probs.append(predict(weights, x, False, dtype)[: len(fr)].cpu())
    probs = torch.cat(probs).numpy() if probs else np.zeros((0, 2) + image.shape[1:], np.float32)
    return (probs,) + prostate_post(probs, mask)


def supervised_weights(cfg: Mapping, weights: Mapping[str, torch.Tensor], images: torch.Tensor,
                       masks: torch.Tensor, steps: int, seed: int) -> Dict[str, torch.Tensor]:
    """`steps` plain supervised Adam steps of the encoder and seg decoder
    from `weights` (batch statistics, the running statistics moved): fundus
    images (N, S, S, 3) uint8 with gray masks, prostate slices (N, S, S, 3)
    in [-1, 1] with labels; batches of the configuration's batch drawn with
    replacement from `seed`; the configuration's LR, no schedule.  Returns
    the encoder's and seg decoder's tensors, the same on every card of a
    kind (`deterministic`)."""
    with deterministic():
        return _supervised(cfg, weights, images, masks, steps, seed)


def _supervised(cfg, weights, images, masks, steps, seed):
    fundus = cfg["dataset"] == "fundus"
    tensors = {k: v.detach().clone().float() for k, v in weights.items() if not k.startswith("rec_decoder.")}
    params = {k: v.requires_grad_(True) for k, v in tensors.items() if not is_buffer(k)}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = torch.Generator(device=images.device).manual_seed(seed)
    b = sum(cfg["batch_size_list"])
    net = UNet(tensors)
    for t in range(1, steps + 1):
        idx = torch.randint(0, images.shape[0], (b,), generator=gen, device=images.device)
        if fundus:
            x = images[idx].permute(0, 3, 1, 2).float() / 127.5 - 1.0
            gray = masks[idx].long()
            y = torch.stack([gray <= 50, gray <= 200], 1).float()
        else:
            x, y = images[idx].permute(0, 3, 1, 2).float(), masks[idx].long()
        _, logits = net.segment(x, True)
        if fundus:
            p = torch.sigmoid(logits)
            loss = F.binary_cross_entropy_with_logits(logits, y) + soft_dice(p, y)
        else:
            loss = cross_entropy(logits, y) + soft_dice(torch.softmax(logits, 1)[:, 1], (y == 1).float())
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                v2[k].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                denom = (v2[k].sqrt() / math.sqrt(1 - ADAM_B2**t)).add_(ADAM_EPS)
                params[k].addcdiv_(m[k], denom, value=-cfg["lr"] / (1 - ADAM_B1**t))
    return {k: v.detach() for k, v in tensors.items()}

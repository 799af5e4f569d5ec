"""The work of one training step of the RAM-DSIR family
(`families/ramdsir.step_counts` returns `step_counts`), counted from the
configuration's shapes (the yardstick's own arithmetic; nothing is read
from the program): `flops`, the family's model FLOPs (for ramdsir every
convolution, forward and backward), and the least bytes that the
normalisations, the x2 bilinear upsamples and the RAM amplitude mix (K1)
must move.

Rows: the encoder and the seg decoder run on the clean and the RAM half
(2B rows), the restoration decoder on the RAM half's bottleneck (B rows).
Convolution FLOPs are 2 x MACs forward, twice that backward (input and
weight gradients), but no input gradient for the first convolution, whose
input needs none.  Nothing is recomputed."""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

FLOAT32 = 4


def _stages(cfg: Mapping) -> List[Tuple[str, int, int, int, int, int]]:
    """(name, rows, cin, cout, kernel, output side) of every convolution of a
    step."""
    s, n = cfg["image_size"], cfg["width"]
    b = sum(cfg["batch_size_list"])
    c, k = cfg["in_channels"], cfg["num_classes"]
    out = []
    cin = c
    for i in range(5):
        cout, side = n * 2**i, s // 2**i
        p = f"encoder.convd{i + 1}"
        out += [(f"{p}.conv1", 2 * b, cin, cout, 3, side), (f"{p}.conv2", 2 * b, cout, cout, 3, side),
                (f"{p}.conv3", 2 * b, cout, cout, 3, side)]
        cin = cout
    for i, planes in zip((4, 3, 2, 1), (16 * n, 8 * n, 4 * n, 2 * n)):
        side_in = s // 2**i
        p = f"seg_decoder.convu{i}"
        if i != 4:
            out.append((f"{p}.conv1", 2 * b, 2 * planes, planes, 3, side_in))
        out += [(f"{p}.conv2", 2 * b, planes, planes // 2, 1, 2 * side_in),
                (f"{p}.conv3", 2 * b, planes, planes, 3, 2 * side_in)]
    out.append(("seg_decoder.out1", 2 * b, 2 * n, k, 3, s))
    if cfg.get("rec", True):
        for i, planes in zip((4, 3, 2, 1), (16 * n, 8 * n, 4 * n, 2 * n)):
            side_in, half = s // 2**i, planes // 2
            p = f"rec_decoder.convu{i}"
            out += [(f"{p}.conv1", b, planes, half, 3, side_in), (f"{p}.conv2", b, half, half, 1, 2 * side_in),
                    (f"{p}.conv3", b, half, half, 3, 2 * side_in)]
        out.append(("rec_decoder.out1", b, n, c, 3, s))
    return out


def conv_flops(rows: int, cin: int, cout: int, k: int, side: int) -> float:
    """Forward FLOPs of a same-padded k x k convolution."""
    return 2.0 * rows * cin * cout * k * k * side * side


def step_flops(cfg: Mapping) -> float:
    """Model FLOPs of one training step: every convolution forward and
    backward."""
    total = 0.0
    for name, rows, cin, cout, k, side in _stages(cfg):
        fwd = conv_flops(rows, cin, cout, k, side)
        total += fwd * (2.0 if name == "encoder.convd1.conv1" else 3.0)
    return total


def norm_bytes(cfg: Mapping) -> float:
    """Least bytes of every batch norm of a step, float32: forward reads x
    and writes y, backward reads x and dy and writes dx (5 passes over the
    activation)."""
    total = 0.0
    for name, rows, _, cout, _, side in _stages(cfg):
        if name.endswith("out1"):
            continue
        total += 5 * FLOAT32 * rows * cout * side * side
    return total


def upsample_shapes(cfg: Mapping) -> List[Tuple[int, int, int, int]]:
    """(N, C, H, W) inputs of the step's x2 upsamples."""
    s, n = cfg["image_size"], cfg["width"]
    b = sum(cfg["batch_size_list"])
    out = [(2 * b, planes, s // 2**i, s // 2**i) for i, planes in zip((4, 3, 2, 1), (16 * n, 8 * n, 4 * n, 2 * n))]
    if cfg.get("rec", True):
        out += [(b, planes // 2, s // 2**i, s // 2**i) for i, planes in zip((4, 3, 2, 1), (16 * n, 8 * n, 4 * n, 2 * n))]
    return out


def k2_bytes(shape, itemsize: int) -> float:
    """The least bytes of a x2 upsample's backward for an (N, C, H, W)
    input (copied from the port's smoke test): the (N, C, 2H, 2W) output
    gradient read once, the input gradient written once."""
    n, c, h, w = shape
    return itemsize * (4 * n * c * h * w + n * c * h * w)


def upsample_bytes(cfg: Mapping) -> float:
    """Forward (input read, x4 output written) and backward bytes of every
    upsample of a step, float32."""
    return sum(2 * k2_bytes(shape, FLOAT32) for shape in upsample_shapes(cfg))


def k1_min_bytes(n, c, h, wh, band, mode) -> float:
    """The least bytes K1 must move (copied from the port's smoke test):
    full mode reads the whole (h, wh) complex spectrum and writes the band;
    band and delta modes read and write the band; the donor amplitude of
    the band read once; one 4-byte ratio a sample."""
    band_elems = n * c * (2 * band + 1) * (band + 1)
    if mode == "full":
        return 8 * n * c * h * wh + (8 + 4) * band_elems + 4 * n
    return (8 + 8 + 4) * band_elems + 4 * n


def ram_mix_bytes(cfg: Mapping) -> float:
    """K1's least bytes a step in the configuration's mode: the banded-DFT
    path's delta mode on the B clean images."""
    s = cfg["image_size"]
    band = int(math.floor(min(s, s) * 0.1))
    return k1_min_bytes(sum(cfg["batch_size_list"]), cfg["in_channels"], s, s // 2 + 1, band, "delta")


def step_counts(cfg: Mapping) -> Dict[str, float]:
    return {
        "flops": step_flops(cfg),
        "norm_bytes": norm_bytes(cfg),
        "upsample_bytes": upsample_bytes(cfg),
        "ram_mix_bytes": ram_mix_bytes(cfg),
    }

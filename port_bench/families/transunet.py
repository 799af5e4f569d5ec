"""The TransUNet family: RAM-DSIR's fundus step with TransUNet R50-ViT-B/16
as its network (`reference/transunet.py`), for configurations whose
`reference` is "transunet".  What a family holds: `families/ramdsir.py`.

The port's TrainConfig, the train stack and the reference's view of it are
RAM-DSIR's; the file's `program` names the port's model, whose sizes must
equal the file's.  Each step draws RAM-DSIR's draws and then one dropout
seed a row.  The counts are the network's own (`step_counts`)."""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from port_bench.families import ramdsir
from port_bench.lib import counts
from port_bench.lib.spec import RunFailed
from port_bench.reference.transunet import sizes, units

make_data = ramdsir.make_data
reference_data = ramdsir.reference_data

FLOAT32 = counts.FLOAT32


def program_config(c: Mapping, device: str, save_path: str, data_root: str = "unused"):
    """RAM-DSIR's TrainConfig with the file's `program` options; the run
    fails where the port's model (`models/transunet.CONFIGS`) has other
    sizes than the file states."""
    cfg = ramdsir.program_config(c, device, save_path, data_root)
    from ramdsir_tpu_torch.models.transunet import CONFIGS

    if cfg.model not in CONFIGS:
        raise RunFailed(f"the port has no TransUNet named {cfg.model!r}")
    m, s = CONFIGS[cfg.model], sizes(c)
    port = dict(hidden=m.hidden_size, mlp=m.mlp_dim, heads=m.num_heads, layers=m.num_layers, rate=m.dropout_rate,
                units=list(m.resnet_units), width=m.resnet_width, head=m.head_channels, dec=list(m.decoder_channels),
                groups=m.gn_groups, skips=list(m.skip_channels))
    wrong = sorted(k for k in s if s[k] != port[k])
    if wrong:
        raise RunFailed(f"the port's {cfg.model} differs from the configuration file in {wrong}")
    return cfg


def step_draws(c: Mapping, gen: torch.Generator, b: int) -> Dict[str, torch.Tensor]:
    """One step's draws in the program's order (a frozen copy of
    `train.steps.sample_step_draws` with dropout): RAM-DSIR's, then a
    dropout seed in [0, 2^31) a row."""
    d = ramdsir.step_draws(c, gen, b)
    d["dropout_seed"] = torch.randint(0, 2**31, (b,), generator=gen)
    return d


# --- a step's work ------------------------------------------------------------------


def _out(side: int, k: int, stride: int, pad: int) -> int:
    return (side + 2 * pad - k) // stride + 1


def stem_layers(c: Mapping) -> List[Tuple[int, int, int, int, int]]:
    """(cin, cout, kernel, input side, output side) of the stem's
    convolutions, in order, each followed by a GroupNorm of its output."""
    s, size = sizes(c), c["image_size"]
    out = [(c["in_channels"], s["width"], 7, size, _out(size, 7, 2, 3))]
    side = _out(out[0][4], 3, 2, 0)  # the max pool
    for name, cin, cout, cmid, stride in units(s):
        down = _out(side, 3, stride, 1)
        out += [(cin, cmid, 1, side, side), (cmid, cmid, 3, side, down), (cmid, cout, 1, down, down)]
        if stride != 1 or cin != cout:
            out.append((cin, cout, 1, side, _out(side, 1, stride, 0)))
        side = down
    return out


def cup_layers(c: Mapping) -> List[Tuple[int, int, int, int]]:
    """(cin, cout, kernel, side) of the CUP's convolutions (conv_more, two a
    block) and the seg head; every one but the head followed by a batch
    norm."""
    s, grid = sizes(c), c["image_size"] // 16
    out = [(s["hidden"], s["head"], 3, grid)]
    side = grid
    for cin, cout, skip in zip([s["head"]] + s["dec"][:-1], s["dec"], s["skips"]):
        side *= 2
        out += [(cin + skip, cout, 3, side), (cout, cout, 3, side)]
    out.append((s["dec"][-1], c["num_classes"], 3, side))
    return out


def _rows(c: Mapping) -> Tuple[int, int]:
    """(rows through the encoder and the CUP: both halves under RAM, rows
    through the restoration decoder)."""
    b = sum(c["batch_size_list"])
    return (2 * b if c.get("ram", True) else b), b


def _rec_stages(c: Mapping):
    return [st for st in counts._stages(dict(c, width=sizes(c)["hidden"] // 16)) if st[0].startswith("rec_decoder")]


def forward_flops(c: Mapping) -> Dict[str, float]:
    """Forward FLOPs of a step by part: stem, embed, transformer (its
    linears and, apart, attention's two products), cup, rec."""
    s = sizes(c)
    r, _ = _rows(c)
    n, h = (c["image_size"] // 16) ** 2, s["hidden"]
    stem = sum(2.0 * cin * cout * k * k * o * o for cin, cout, k, _, o in stem_layers(c))
    return {
        "stem": r * stem,
        "embed": r * 2.0 * 16 * s["width"] * h * n,
        "linears": r * s["layers"] * 2.0 * n * (4 * h * h + 2 * h * s["mlp"]),
        "attention": r * s["layers"] * 4.0 * n * n * h,
        "cup": r * sum(2.0 * cin * cout * k * k * side * side for cin, cout, k, side in cup_layers(c)),
        "rec": sum(counts.conv_flops(rows, cin, cout, k, side) for _, rows, cin, cout, k, side in _rec_stages(c)),
    }


def upsample_shapes(c: Mapping) -> List[Tuple[int, int, int, int]]:
    """(N, C, H, W) inputs of the step's x2 upsamples: the CUP's four
    (align_corners=True) and the restoration decoder's."""
    r, _ = _rows(c)
    layers = cup_layers(c)
    out = [(r, cout, side, side) for (_, cout, _, side) in [layers[0]] + layers[2:-2:2]]
    out += counts.upsample_shapes(dict(c, width=sizes(c)["hidden"] // 16))[4:]
    return out


def step_counts(c: Mapping) -> Dict[str, float]:
    """A step's work from the configuration's shapes: `flops`, every
    convolution, linear and attention product, the backward counted as
    twice the forward (step_mfu.train); `attn_flops`, attention's two
    products, 4 S^2 d a layer a row forward, both ways (attn_roofline.train);
    and the least bytes, float32, of the batch norms (CUP and restoration
    decoder, 5 passes: norm_roofline.train), the GroupNorms (5 passes:
    group_norm_roofline.train), the x2 upsamples (upsample_roofline.train)
    and K1 (ram_mix_roofline.train)."""
    r, _ = _rows(c)
    fwd = forward_flops(c)
    bn = sum(r * cout * side * side for _, cout, _, side in cup_layers(c)[:-1])
    bn += sum(rows * cout * side * side for name, rows, _, cout, _, side in _rec_stages(c) if not name.endswith("out1"))
    gn = sum(r * cout * o * o for _, cout, _, _, o in stem_layers(c))
    return {
        "flops": 3.0 * sum(fwd.values()),
        "attn_flops": 3.0 * fwd["attention"],
        "norm_bytes": 5.0 * FLOAT32 * bn,
        "group_norm_bytes": 5.0 * FLOAT32 * gn,
        "upsample_bytes": float(sum(2 * counts.k2_bytes(shape, FLOAT32) for shape in upsample_shapes(c))),
        "ram_mix_bytes": counts.ram_mix_bytes(c),
    }

"""The transunet family (`families/transunet.py`) and its cell: the cell runs
`correct` on the CPU at a tiny size through `harness.run_cell` (64^2, a
TransUNet of hidden 64, 2 blocks, one bottleneck unit a block, registered in
the port under the name the file's `program` gives); a step's counts
against sums written out by hand at that size; the draws in the program's
order; a file whose sizes differ from the port's model fails the run; and
the two per-layer readers it adds."""
import importlib
import time

import pytest
import torch

from port_bench.lib import harness, spec
from port_bench.lib.trace import Trace
from _tiny import judged

TINY_KEYS = dict(
    image_size=64, train_per_domain=[6, 36, 14], test_images=3, original_size=80, hidden_size=64,
    transformer=dict(mlp_dim=128, num_heads=4, num_layers=2, attention_dropout_rate=0.0, dropout_rate=0.1),
    resnet=dict(num_layers=[1, 1, 1], width_factor=0.5), decoder_channels=[32, 16, 16, 8],
    skip_channels=[256, 128, 32, 0], head_channels=64,
)
CELL = "transunet_fundus.train"


@pytest.fixture
def tiny_model(monkeypatch):
    from ramdsir_tpu_torch.models import transunet

    monkeypatch.setitem(transunet.CONFIGS, "transunet_tiny", transunet.TransUNetConfig(
        hidden_size=64, mlp_dim=128, num_heads=4, num_layers=2, resnet_units=(1, 1, 1), resnet_width=32,
        head_channels=64, decoder_channels=(32, 16, 16, 8)))
    return "transunet_tiny"


def tiny_cfg(model="transunet_tiny"):
    cfg = dict(spec.config(spec.benchmark(), "transunet_fundus"), **TINY_KEYS)
    cfg["program"] = dict(cfg["program"], model=model)
    return cfg


def tiny_context(workdir, seed=123, trace=False):
    torch.set_num_threads(2)
    w = spec.workload(spec.benchmark(), CELL)
    traffic = dict(spec.traffic(w["traffic"]), warmup_steps=2, trace_seconds=0.3)
    ref = importlib.import_module("port_bench.reference.transunet")
    return harness.Context(CELL, tiny_cfg(), traffic, seed, 0.3, trace, torch.device("cpu"), time.perf_counter(),
                           workdir, ref, harness.family_module("transunet"))


def test_the_cell_runs_correct_on_the_cpu(tiny_model, tmp_path):
    ctx = tiny_context(str(tmp_path), seed=3000000019)
    out = harness.run_cell(ctx)
    correct, got = judged(CELL, out["check"])
    assert correct, got
    assert out["check"]["loss_gap"] < 1e-5 and out["check"]["grad_gap"] < 0.05
    assert out["host"]["images"] >= 16 and out["counts"] == ctx.family.step_counts(ctx.cfg)


def test_a_planted_fault_reads_above_the_limits(tiny_model, tmp_path):
    from port_bench.lib import plants

    with plants.planted("train", "stale_rows", "cpu"):
        out = harness.run_cell(tiny_context(str(tmp_path), seed=5))
    correct, got = judged(CELL, out["check"])
    assert not correct, got


def test_the_counts_equal_sums_written_out_by_hand():
    from port_bench.families import transunet as fam

    rows, rec_rows = 32, 16  # [clean; RAM] through the encoder and the CUP, the RAM half through DSIR
    root = [2 * 3 * 32 * 49 * 32 * 32]
    block1 = [2 * 32 * 32 * 225, 2 * 32 * 32 * 9 * 225, 2 * 32 * 128 * 225, 2 * 32 * 128 * 225]
    block2 = [2 * 128 * 64 * 225, 2 * 64 * 64 * 9 * 64, 2 * 64 * 256 * 64, 2 * 128 * 256 * 64]
    block3 = [2 * 256 * 128 * 64, 2 * 128 * 128 * 9 * 16, 2 * 128 * 512 * 16, 2 * 256 * 512 * 16]
    embed = [2 * 512 * 64 * 16]
    linears = [2 * (2 * 16 * (4 * 64 * 64 + 2 * 64 * 128))]
    attention = [2 * 4 * 16 * 16 * 64]
    cup = [2 * 64 * 64 * 9 * 16, 2 * 320 * 32 * 9 * 64, 2 * 32 * 32 * 9 * 64, 2 * 160 * 16 * 9 * 256,
           2 * 16 * 16 * 9 * 256, 2 * 48 * 16 * 9 * 1024, 2 * 16 * 16 * 9 * 1024, 2 * 16 * 8 * 9 * 4096,
           2 * 8 * 8 * 9 * 4096, 2 * 8 * 2 * 9 * 4096]
    rec = [2 * 64 * 32 * 9 * 16, 2 * 32 * 32 * 64, 2 * 32 * 32 * 9 * 64, 2 * 32 * 16 * 9 * 64, 2 * 16 * 16 * 256,
           2 * 16 * 16 * 9 * 256, 2 * 16 * 8 * 9 * 256, 2 * 8 * 8 * 1024, 2 * 8 * 8 * 9 * 1024, 2 * 8 * 4 * 9 * 1024,
           2 * 4 * 4 * 4096, 2 * 4 * 4 * 9 * 4096, 2 * 4 * 3 * 9 * 4096]
    fwd = rows * sum(root + block1 + block2 + block3 + embed + linears + attention + cup) + rec_rows * sum(rec)
    gn = [32 * 1024, 32 * 225, 32 * 225, 128 * 225, 128 * 225, 64 * 225, 64 * 64, 256 * 64, 256 * 64,
          128 * 64, 128 * 16, 512 * 16, 512 * 16]
    bn = [64 * 16, 32 * 64, 32 * 64, 16 * 256, 16 * 256, 16 * 1024, 16 * 1024, 8 * 4096, 8 * 4096]
    dsbn = [32 * 16, 32 * 64, 32 * 64, 16 * 64, 16 * 256, 16 * 256, 8 * 256, 8 * 1024, 8 * 1024, 4 * 1024,
            4 * 4096, 4 * 4096]
    ups = [rows * 64 * 16, rows * 32 * 64, rows * 16 * 256, rows * 16 * 1024,
           rec_rows * 32 * 16, rec_rows * 16 * 64, rec_rows * 8 * 256, rec_rows * 4 * 1024]
    got = fam.step_counts(tiny_cfg())
    assert got["flops"] == 3 * fwd
    assert got["attn_flops"] == 3 * rows * sum(attention)
    assert got["group_norm_bytes"] == 20 * rows * sum(gn)
    assert got["norm_bytes"] == 20 * (rows * sum(bn) + rec_rows * sum(dsbn))
    assert got["upsample_bytes"] == 2 * 4 * 5 * sum(ups)
    band = 6  # floor(0.1 * 64): K1's delta mode on the 16 clean images, 3 channels
    assert got["ram_mix_bytes"] == 20 * 16 * 3 * (2 * band + 1) * (band + 1) + 4 * 16


def test_the_draws_are_the_programs_in_its_order():
    from ramdsir_tpu_torch.train.steps import sample_step_draws

    fam = harness.family_module("transunet")
    for seed in (7, 3000000019):
        g, w = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        for _ in range(3):
            got, want = fam.step_draws(tiny_cfg(), g, 16), sample_step_draws(w, 16, torch.device("cpu"), dropout=True)
            assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_a_file_whose_sizes_differ_from_the_ports_model_fails_the_run(tiny_model, tmp_path):
    fam = harness.family_module("transunet")
    cfg = dict(tiny_cfg(), hidden_size=96)
    with pytest.raises(SystemExit) as e:
        fam.program_config(cfg, "cpu", str(tmp_path))
    assert e.value.code == 2
    with pytest.raises(SystemExit):
        fam.program_config(tiny_cfg(model="transunet_none"), "cpu", str(tmp_path))


def test_the_readers_of_attention_and_group_norm():
    counts = {"flops": 1e12, "attn_flops": 4.95e11, "group_norm_bytes": 3.35e9}
    trace = Trace([("fmha_cutlassF_f32_aligned_64x64_rf_sm80", 0.0, 2000.0), ("fmha_cutlassB_f32_x", 2000.0, 4000.0),
                   ("void at::native::RowwiseMomentsCUDAKernel", 4000.0, 8000.0)], [], (0.0, 10000.0), "w")
    rec = spec.Record(kind="train", cfg={"compute_dtype": "float32"}, traffic={}, device_name="H100", host={},
                      counts=counts, trace=trace, traced_steps=2, peaks={"tf32_flops": 495e12, "hbm_bytes_per_s": 3.35e12})
    # 2 steps of 0.495 TFLOP at 495 TFLOP/s: 2 ms of bound over 4 ms of fmha kernels
    assert spec.reader("attn_roofline.train")(rec) == pytest.approx(50.0)
    # 2 steps of 3.35 GB at 3.35 TB/s: 2 ms of bound over 4 ms of RowwiseMoments
    assert spec.reader("group_norm_roofline.train")(rec) == pytest.approx(50.0)
    plain = spec.Record(kind="train", cfg={"compute_dtype": "float32"}, traffic={}, device_name="H100", host={},
                        counts={"flops": 1e12, "norm_bytes": 1.0}, trace=trace, traced_steps=2,
                        peaks={"tf32_flops": 495e12, "hbm_bytes_per_s": 3.35e12})
    assert spec.reader("attn_roofline.train")(plain) is None
    assert spec.reader("group_norm_roofline.train")(plain) is None

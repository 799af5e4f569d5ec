"""The port's train CLI on the CPU, its import hygiene, and its refusals."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ramdsir_tpu_torch.cli.train import main as cli_main
from ramdsir_tpu_torch.config import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_drive_on_cpu(tmp_path):
    """The verify drive with the module swapped: a tiny synthetic tree, two
    steps; metrics.jsonl, run_config.json and a reference-format .pth that
    the JAX package's import_torch_checkpoint loads."""
    from ramdsir_tpu_torch.data.synthetic import make_fundus_tree

    make_fundus_tree(str(tmp_path / "data"), per_domain_train=8, per_domain_test=1, size=32)
    run = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "ramdsir_tpu_torch.cli.train", "--device", "cpu",
         "--data_root", str(tmp_path / "data"), "--dataset", "fundus",
         "--domain_idxs", "1,2,3", "--test_domain_idx", "0", "--ram", "--rec",
         "--is_out_domain", "--consistency", "--consistency_type", "kd",
         "--save_path", str(run), "--image_size", "32", "--epochs", "1", "--max_steps", "2"],
        capture_output=True, text=True, env=_env(), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "eval is not ported yet" in proc.stdout
    assert "'eval': 'not_ported'" in proc.stdout

    rows = [json.loads(line) for line in (run / "log" / "metrics.jsonl").read_text().splitlines()]
    losses = [r for r in rows if "loss/loss" in r]
    assert [r["step"] for r in losses] == [0, 1]
    for key in ("loss_bce_1", "loss_dice_1", "loss_bce_2", "loss_dice_2", "loss_consistency", "loss_rec"):
        assert all(np.isfinite(r[f"loss/{key}"]) for r in losses), key
    assert [r["step"] for r in rows if "lr" in r] == [0, 1]

    cfg = json.loads((run / "run_config.json").read_text())
    assert cfg["config"]["device"] == "cpu" and cfg["config"]["image_size"] == 32
    assert set(cfg["tf32"]) == {"cudnn_allow_tf32", "matmul_allow_tf32"}

    from ramdsir_tpu.config import TrainConfig as JConfig
    from ramdsir_tpu.train.state import init_state as jinit_state
    from ramdsir_tpu.utils.torch_compat import import_torch_checkpoint

    jcfg = JConfig(image_size=32, domain_idxs=(1, 2, 3), test_domain_idx=0).resolve()
    jstate, _ = jinit_state(jcfg, jax.random.PRNGKey(0))
    loaded = import_torch_checkpoint(str(run / "final_model.pth"), jstate)
    payload = torch.load(run / "final_model.pth", map_location="cpu")
    assert set(payload) == {"encoder_state_dict", "seg_decoder_state_dict", "rec_decoder_state_dict"}
    np.testing.assert_array_equal(
        np.asarray(loaded.params["encoder"]["convd1"]["conv1"]["kernel"]),
        payload["encoder_state_dict"]["convd1.conv1.weight"].numpy().transpose(2, 3, 1, 0),
    )
    np.testing.assert_array_equal(
        np.asarray(loaded.batch_stats["rec_decoder"]["convu4"]["bn1"]["DomainSpecificBatchNorm_0"]["mean"][2]),
        payload["rec_decoder_state_dict"]["convu4.bn1.bns.2.running_mean"].numpy(),
    )


def test_port_imports_no_jax_and_no_reference_package():
    """Import every module of ramdsir_tpu_torch in a fresh interpreter (the
    test process has JAX loaded already) and list what came in."""
    code = r"""
import importlib, pkgutil, sys
import ramdsir_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ramdsir_tpu_torch.__path__, "ramdsir_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ramdsir_tpu"))
print(len(names), bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 20, proc.stdout
    assert bad == "[]", bad


def test_cuda_request_without_cuda_raises(monkeypatch):
    """Asking for the card where there is none raises; nothing runs on the
    CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays
    from ramdsir_tpu_torch.train.state import init_state

    cfg = TrainConfig(image_size=32).resolve()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceFundusPipeline.from_arrays(fundus_arrays(per_domain_train=8, size=16), (0, 1, 2), [2, 2, 2], 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--save_path", "unused", "--ram"])


@pytest.mark.parametrize(
    "flags",
    [
        ["--dataset", "prostate"],
        ["--compute_dtype", "bfloat16"],
        ["--num_devices", "2"],
        ["--remat"],
        ["--resume", "ckpt.pth"],
        ["--trace_dir", "trace"],
        ["--norm", "gn"],
        ["--global_batch", "18"],
    ],
    ids=lambda f: f[0].lstrip("-"),
)
def test_unported_flags_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli_main(["--device", "cpu", "--save_path", str(tmp_path / "run"), "--ram", *flags])
    assert not (tmp_path / "run").exists()

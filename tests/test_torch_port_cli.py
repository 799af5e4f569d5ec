"""The port's train and eval CLIs on the CPU (fundus and prostate), each
variant flag of the train CLI (--num_devices 2 as two gloo ranks), its
import hygiene, and its refusal of more CUDA ranks than visible GPUs."""
import ast
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ramdsir_tpu_torch.cli.train import main as cli_main
from ramdsir_tpu_torch.config import TrainConfig
from tests._torch_threads import torch_threads, worker_threads  # noqa: F401 (module-scoped autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = str(worker_threads())  # this worker's share of the cores
    return env


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """The verify drive with the module swapped: a tiny synthetic tree, two
    steps, then the end-of-training eval on target domain 0."""
    from ramdsir_tpu_torch.data.synthetic import make_fundus_tree

    tmp_path = tmp_path_factory.mktemp("drive")
    make_fundus_tree(str(tmp_path / "data"), per_domain_train=8, per_domain_test=3, size=40)
    run = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "ramdsir_tpu_torch.cli.train", "--device", "cpu",
         "--data_root", str(tmp_path / "data"), "--dataset", "fundus",
         "--domain_idxs", "1,2,3", "--test_domain_idx", "0", "--ram", "--rec",
         "--is_out_domain", "--consistency", "--consistency_type", "kd",
         "--save_path", str(run), "--image_size", "32", "--epochs", "1", "--max_steps", "2",
         "--test_batch_size", "2"],
        capture_output=True, text=True, env=_env(), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tmp_path, proc


def test_cli_drive_on_cpu(trained_run):
    """metrics.jsonl, run_config.json, the eval's line, CSV row and keep-best
    file, and reference-format .pth files that the port and the JAX
    package's import_torch_checkpoint load."""
    tmp_path, proc = trained_run
    run = tmp_path / "run"
    assert re.search(r"epoch 0: eval avg dice [0-9.]+ \| best [0-9.]+", proc.stdout), proc.stdout
    summary = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert {"cup_dice", "disc_dice", "best"} <= set(summary) and "eval" not in summary
    assert 0.0 <= summary["cup_dice"] <= 1.0 and 0.0 <= summary["disc_dice"] <= 1.0
    assert summary["best"] == pytest.approx((summary["cup_dice"] + summary["disc_dice"]) * 50.0)

    rows = [json.loads(line) for line in (run / "log" / "metrics.jsonl").read_text().splitlines()]
    losses = [r for r in rows if "loss/loss" in r]
    assert [r["step"] for r in losses] == [0, 1]
    for key in ("loss_bce_1", "loss_dice_1", "loss_bce_2", "loss_dice_2", "loss_consistency", "loss_rec"):
        assert all(np.isfinite(r[f"loss/{key}"]) for r in losses), key
    assert [r["step"] for r in rows if "lr" in r] == [0, 1]
    assert [(r["step"], r["eval/avg_dice"]) for r in rows if "eval/avg_dice" in r] == [(2, summary["best"])]

    csv_rows = (run / "0_val_log.csv").read_text().splitlines()
    assert len(csv_rows) == 1
    assert csv_rows[0].startswith("batch-size: ,2,0,cup dice coefficence: ,")
    best = [f for f in os.listdir(run) if f.startswith("model_")]
    assert best == ["model_%.2f.pth" % summary["best"]]

    cfg = json.loads((run / "run_config.json").read_text())
    assert cfg["config"]["device"] == "cpu" and cfg["config"]["image_size"] == 32
    assert set(cfg["tf32"]) == {"cudnn_allow_tf32", "matmul_allow_tf32"}

    from ramdsir_tpu.config import TrainConfig as JConfig
    from ramdsir_tpu.train.state import init_state as jinit_state
    from ramdsir_tpu.utils.torch_compat import import_torch_checkpoint
    from ramdsir_tpu_torch.train.checkpoint import load_torch_checkpoint
    from ramdsir_tpu_torch.train.state import build_models

    jcfg = JConfig(image_size=32, domain_idxs=(1, 2, 3), test_domain_idx=0).resolve()
    jstate, _ = jinit_state(jcfg, jax.random.PRNGKey(0))
    for name in ("final_model.pth", best[0]):
        loaded = import_torch_checkpoint(str(run / name), jstate)
        payload = torch.load(run / name, map_location="cpu")
        assert set(payload) == {"encoder_state_dict", "seg_decoder_state_dict", "rec_decoder_state_dict"}
        np.testing.assert_array_equal(
            np.asarray(loaded.params["encoder"]["convd1"]["conv1"]["kernel"]),
            payload["encoder_state_dict"]["convd1.conv1.weight"].numpy().transpose(2, 3, 1, 0),
        )
        np.testing.assert_array_equal(
            np.asarray(loaded.batch_stats["rec_decoder"]["convu4"]["bn1"]["DomainSpecificBatchNorm_0"]["mean"][2]),
            payload["rec_decoder_state_dict"]["convu4.bn1.bns.2.running_mean"].numpy(),
        )
        models = build_models(TrainConfig(image_size=32, domain_idxs=(1, 2, 3), test_domain_idx=0).resolve())
        load_torch_checkpoint(str(run / name), models)  # strict per module
        for mname, m in models.items():
            for k, v in m.state_dict().items():
                assert torch.equal(v, payload[f"{mname}_state_dict"][k]), f"{mname}.{k}"


@pytest.fixture(scope="module")
def prostate_run(tmp_path_factory):
    """The prostate drive: a synthetic slice tree at 32^2 and two test
    volumes of 12 slices, two steps at batch 10 = 2 x 5, then the eval of
    the volumes of target domain 5 at test batch 4."""
    from ramdsir_tpu_torch.data.synthetic import make_prostate_tree, make_prostate_volumes

    tmp_path = tmp_path_factory.mktemp("prostate_drive")
    make_prostate_tree(str(tmp_path / "data"), per_domain=4, size=32)
    make_prostate_volumes(str(tmp_path / "data"), per_domain=2, depth=12, size=32)
    run = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "ramdsir_tpu_torch.cli.train", "--device", "cpu",
         "--data_root", str(tmp_path / "data"), "--dataset", "prostate",
         "--domain_idxs", "0,1,2,3,4", "--test_domain_idx", "5", "--ram", "--rec",
         "--consistency", "--consistency_type", "kd", "--save_path", str(run),
         "--epochs", "1", "--max_steps", "2", "--test_batch_size", "4"],
        capture_output=True, text=True, env=_env(), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tmp_path, proc


def test_prostate_cli_drive_on_cpu(prostate_run):
    """The prostate metrics keys, the eval's line and CSV row, the keep-best
    file, and a .pth with five DSBN domains that the port loads strictly."""
    tmp_path, proc = prostate_run
    run = tmp_path / "run"
    assert re.search(r"epoch 0: eval avg dice [0-9.]+ \| best [0-9.]+", proc.stdout), proc.stdout
    summary = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert 0.0 <= summary["dice"] <= 1.0 and summary["best"] == pytest.approx(100.0 * summary["dice"])
    assert summary["eval_timing"]["volumes"] == 2 and summary["eval_timing"]["batches"] == 6
    rows = [json.loads(line) for line in (run / "log" / "metrics.jsonl").read_text().splitlines()]
    losses = [r for r in rows if "loss/loss" in r]
    assert [r["step"] for r in losses] == [0, 1]
    keys = {"loss_ce_1", "loss_dice_1", "loss_ce_2", "loss_dice_2", "loss_consistency", "loss_rec", "loss"}
    assert all({k[5:] for k in r if k.startswith("loss/")} == keys for r in losses)
    assert all(np.isfinite(r[f"loss/{k}"]) for r in losses for k in keys)
    csv_rows = (run / "5_val_log.csv").read_text().splitlines()
    assert csv_rows == [f"batch-size: ,4,0,dice coefficence: ,{summary['dice']}"]
    assert [f for f in os.listdir(run) if f.startswith("model_")] == ["model_%.2f.pth" % summary["best"]]
    from ramdsir_tpu_torch.train.checkpoint import load_torch_checkpoint
    from ramdsir_tpu_torch.train.state import build_models

    cfg = TrainConfig(dataset="prostate", domain_idxs=(0, 1, 2, 3, 4), test_domain_idx=5).resolve()
    models = build_models(cfg)
    load_torch_checkpoint(str(run / "final_model.pth"), models)  # strict per module
    assert len(models["rec_decoder"].convu4.bn1.bns) == 5


def _prostate_metrics(stdout):
    return [float(v) for v in re.findall(r"==>(?:val_dice|average_hd|average_asd) : ([0-9.]+)", stdout)]


def test_prostate_eval_cli_matches_jax_cli(prostate_run, tmp_path, capsys):
    """The port's volume eval CLI on the CPU against the JAX package's on the
    same .pth and volumes: the printed Dice, HD95 and ASD, the CSV log within
    1e-3, and the overlays."""
    from ramdsir_tpu.cli.test_prostate_volume import main as jax_eval_main

    data, run = prostate_run[0] / "data", prostate_run[0] / "run"
    args = ["--model_file", str(run / "final_model.pth"), "--data_dir", str(data), "--datasetTest", "5",
            "--batch_size", "4", "--save_result"]
    proc = subprocess.run(
        [sys.executable, "-m", "ramdsir_tpu_torch.cli.test_prostate_volume", "--device", "cpu",
         "--test_prediction_save_path", str(tmp_path / "port"), *args],
        capture_output=True, text=True, env=_env(), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    printed = _prostate_metrics(proc.stdout)
    assert len(printed) == 3, proc.stdout
    want = jax_eval_main(["--test_prediction_save_path", str(tmp_path / "jax"), *args])
    assert _prostate_metrics(capsys.readouterr().out) == printed
    fields = (tmp_path / "port" / "test5_log.csv").read_text().splitlines()[0].split(",")
    assert fields[2] == str(run / "final_model.pth")
    for i, name in ((4, "dice"), (6, "hd"), (8, "asd")):
        assert abs(float(fields[i]) - getattr(want, name)) <= 1e-3, name
    overlays = sorted(os.listdir(tmp_path / "port" / "test5"))
    assert overlays == sorted(os.listdir(tmp_path / "jax" / "test5")) and len(overlays) == 12


def _six_metrics(stdout):
    return [float(v) for v in re.findall(r"==>(?:val_cup_dice|val_disc_dice|average_hd_OC|average_hd_OD|"
                                         r"average_asd_OC|average_asd_OD) : ([0-9.]+)", stdout)]


def test_eval_cli_matches_jax_cli(trained_run, tmp_path, capsys):
    """The port's eval CLI on the CPU against the JAX package's on the same
    .pth and tree: the six metrics within 1e-6, the overlays, the CSV log."""
    from ramdsir_tpu.cli.test_fundus_slice import main as jax_eval_main

    data, run = trained_run[0] / "data", trained_run[0] / "run"
    args = ["--model_file", str(run / "final_model.pth"), "--data_dir", str(data), "--datasetTest", "0",
            "--batch_size", "2", "--image_size", "32", "--save_result"]
    proc = subprocess.run(
        [sys.executable, "-m", "ramdsir_tpu_torch.cli.test_fundus_slice", "--device", "cpu",
         "--test_prediction_save_path", str(tmp_path / "port"), *args],
        capture_output=True, text=True, env=_env(), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    printed = _six_metrics(proc.stdout)
    assert len(printed) == 6, proc.stdout
    want = jax_eval_main(["--test_prediction_save_path", str(tmp_path / "jax"), *args])
    assert _six_metrics(capsys.readouterr().out) == printed  # the same printed lines
    log = (tmp_path / "port" / "test0_log.csv").read_text().splitlines()
    assert len(log) == 1
    fields = log[0].split(",")
    got = [float(fields[i]) for i in (4, 6, 8, 10, 12, 14)]
    names = ("cup_dice", "disc_dice", "hd_oc", "hd_od", "asd_oc", "asd_od")
    for name, g in zip(names, got):
        assert abs(g - getattr(want, name)) <= 1e-6, name
    assert sorted(os.listdir(tmp_path / "port" / "test0")) == sorted(os.listdir(tmp_path / "jax" / "test0"))
    assert len(os.listdir(tmp_path / "port" / "test0")) == 3


@pytest.mark.parametrize("dataset", ["fundus", "prostate"])
def test_eval_clis_score_ckpt_as_pth(trained_run, prostate_run, tmp_path, capsys, dataset):
    """Each eval CLI scores the run's final_model.ckpt (the port's full
    state) and a weights-only .ckpt that the JAX package writes from
    final_model.pth exactly as it scores final_model.pth."""
    from ramdsir_tpu.config import TrainConfig as JConfig
    from ramdsir_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
    from ramdsir_tpu.train.state import init_state as jinit_state
    from ramdsir_tpu.utils.torch_compat import import_torch_checkpoint

    if dataset == "fundus":
        from ramdsir_tpu_torch.cli.test_fundus_slice import main

        root, fields = trained_run[0], ("cup_dice", "disc_dice", "hd_oc", "hd_od", "asd_oc", "asd_od")
        args = ["--datasetTest", "0", "--batch_size", "2", "--image_size", "32"]
        jcfg = JConfig(image_size=32, domain_idxs=(1, 2, 3), test_domain_idx=0, ram=True, rec=True)
    else:
        from ramdsir_tpu_torch.cli.test_prostate_volume import main

        root, fields = prostate_run[0], ("dice", "hd", "asd")
        args = ["--datasetTest", "5", "--batch_size", "4"]
        jcfg = JConfig(dataset="prostate", domain_idxs=(0, 1, 2, 3, 4), test_domain_idx=5, ram=True, rec=True)
    run = root / "run"
    jstate, _ = jinit_state(jcfg.resolve(), jax.random.PRNGKey(0))
    jax_weights = str(tmp_path / "jax_weights.ckpt")
    jax_save_checkpoint(jax_weights, import_torch_checkpoint(str(run / "final_model.pth"), jstate), weights_only=True)
    scores = {}
    for name in (str(run / "final_model.pth"), str(run / "final_model.ckpt"), jax_weights):
        res = main(["--device", "cpu", "--model_file", name, "--data_dir", str(root / "data"),
                    "--test_prediction_save_path", str(tmp_path / ("out_" + os.path.basename(name))), *args])
        scores[name] = [getattr(res, f) for f in fields]
    capsys.readouterr()
    first, *others = scores.values()
    assert all(other == first for other in others), scores


def test_cli_bf16_resume_drive(trained_run, tmp_path, capsys):
    """--compute_dtype bfloat16 --resume <final_model.ckpt>: the run goes on
    from the checkpoint's step 2 to --max_steps 3 in bfloat16 (--epochs 2:
    one epoch is the checkpoint's 2 steps, where a resumed run stops), logs
    that step's finite losses, and writes both final files."""
    data, run = trained_run[0] / "data", trained_run[0] / "run"
    resumed = tmp_path / "resumed"
    cli_main(["--device", "cpu", "--data_root", str(data), "--dataset", "fundus", "--domain_idxs", "1,2,3",
              "--test_domain_idx", "0", "--ram", "--rec", "--is_out_domain", "--consistency",
              "--consistency_type", "kd", "--save_path", str(resumed), "--image_size", "32", "--epochs", "2",
              "--max_steps", "3", "--test_batch_size", "2", "--compute_dtype", "bfloat16",
              "--resume", str(run / "final_model.ckpt")])
    out = capsys.readouterr().out
    assert f"resumed from {run / 'final_model.ckpt'} at step 2" in out
    summary = ast.literal_eval(out.strip().splitlines()[-1])
    assert summary["steps"] == 3 and summary["resume_checkpoint"] == str(resumed / "final_model.ckpt")
    rows = [json.loads(line) for line in (resumed / "log" / "metrics.jsonl").read_text().splitlines()]
    losses = [r for r in rows if "loss/loss" in r]
    assert [r["step"] for r in losses] == [2] and all(np.isfinite(v) for v in losses[0].values())
    assert os.path.exists(resumed / "final_model.pth")
    cfg = json.loads((resumed / "run_config.json").read_text())["config"]
    assert cfg["compute_dtype"] == "bfloat16" and cfg["checkpoint_resume"] == str(run / "final_model.ckpt")


NO_PIL_DRIVE = r"""
import os, sys
sys.modules["PIL"] = None  # the card has neither: any import of them raises
sys.modules["cv2"] = None
from ramdsir_tpu_torch.cli.test_fundus_slice import main as eval_main
from ramdsir_tpu_torch.cli.train import main as train_main
from ramdsir_tpu_torch.data.synthetic import make_fundus_tree

root = sys.argv[1]
make_fundus_tree(os.path.join(root, "data"), per_domain_train=8, per_domain_test=3, size=40,
                 filter_types=(0, 1, 2, 3, 4, "adaptive"), palette_mask_domains=("Domain1", "Domain2"))
train_main(["--device", "cpu", "--data_root", os.path.join(root, "data"), "--dataset", "fundus",
            "--domain_idxs", "1,2,3", "--test_domain_idx", "0", "--ram", "--rec", "--is_out_domain",
            "--consistency", "--consistency_type", "kd", "--save_path", os.path.join(root, "run"),
            "--image_size", "32", "--epochs", "1", "--max_steps", "2", "--test_batch_size", "2",
            "--deterministic"])
eval_main(["--device", "cpu", "--model_file", os.path.join(root, "run", "final_model.pth"),
           "--data_dir", os.path.join(root, "data"), "--datasetTest", "0", "--batch_size", "2",
           "--image_size", "32", "--test_prediction_save_path", os.path.join(root, "eval"), "--save_result"])
print(sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2") and sys.modules[m] is not None))
"""


def test_fundus_drive_without_pil_or_cv2(tmp_path):
    """With PIL and cv2 blocked, as on the card: make_fundus_tree writes the
    tree (every row filter, palette masks), cli.train trains from it under
    --deterministic and evaluates, cli.test_fundus_slice scores it with
    --save_result, and every overlay is a PNG that PIL and the port read
    back equal."""
    from PIL import Image

    from ramdsir_tpu_torch.data import png

    proc = subprocess.run([sys.executable, "-c", NO_PIL_DRIVE, str(tmp_path)], capture_output=True, text=True,
                          env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert re.search(r"epoch 0: eval avg dice [0-9.]+ \| best [0-9.]+", proc.stdout), proc.stdout
    assert len(_six_metrics(proc.stdout)) == 6, proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    overlays = sorted(os.listdir(tmp_path / "eval" / "test0"))
    assert overlays == ["000.png", "001.png", "002.png"]
    for name in overlays:
        path = str(tmp_path / "eval" / "test0" / name)
        ours = png.decode(path)
        assert ours.mode == "RGB" and ours.array.shape == (40, 40, 3)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), ours.array)
    cfg = json.loads((tmp_path / "run" / "run_config.json").read_text())
    assert cfg["config"]["deterministic"] is True


def test_port_imports_no_jax_and_no_reference_package():
    """Import every module of ramdsir_tpu_torch, and every name its packages
    re-export, in a fresh interpreter (the test process has JAX loaded
    already) with PIL and cv2 blocked, as on the card, and list what came
    in."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["PIL"] = None  # the card has neither: any import of them raises
sys.modules["cv2"] = None
import ramdsir_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ramdsir_tpu_torch.__path__, "ramdsir_tpu_torch.")]
for n in names:
    mod = importlib.import_module(n)
    for export in getattr(mod, "_EXPORTS", ()):
        getattr(mod, export)
bad = sorted(m for m in sys.modules if sys.modules[m] is not None and
             m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "ramdsir_tpu", "PIL", "cv2",
                                 "tensorboard", "tensorboardX"))
print(names)
print(bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names, bad = (ast.literal_eval(line) for line in proc.stdout.strip().splitlines()[-2:])
    assert len(names) >= 30, names
    for new in ("native", "native.build", "ops.metrics", "ops.postprocess", "ops.resize", "data.loaders", "train.evaluate",
                "train.checkpoint", "utils.viz", "cli.test_fundus_slice", "data.nifti", "data.prostate",
                "cli.test_prostate_volume", "utils.msgpack", "data.png", "ops.image", "ops.upsample",
                "ops.cuda_build", "utils.profiler", "models.norm", "data.transforms", "utils.logging",
                "parallel.mesh", "parallel.distributed", "utils.nn_utils", "utils.data_utils", "utils.od_coords",
                "models.unet", "ops.losses", "utils.torch_compat"):
        assert f"ramdsir_tpu_torch.{new}" in names, new
    assert bad == [], bad


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
    from ramdsir_tpu_torch.cli.test_fundus_slice import main as eval_main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_main(["--model_file", "unused.pth", "--test_prediction_save_path", "unused"])
    from ramdsir_tpu_torch.cli.test_prostate_volume import main as prostate_eval_main
    from ramdsir_tpu_torch.data.device_pipeline import DeviceProstatePipeline
    from ramdsir_tpu_torch.data.synthetic import prostate_arrays

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--save_path", "unused", "--ram", "--dataset", "prostate", "--domain_idxs", "0,1,2,3,4",
                  "--test_domain_idx", "5"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceProstatePipeline.from_arrays(prostate_arrays(per_domain=2, size=16), (0, 1, 2, 3, 4), [2] * 5, 5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prostate_eval_main(["--model_file", "unused.pth", "--test_prediction_save_path", "unused"])


def test_failing_compiler_raises(monkeypatch):
    """A host library that does not build raises; nothing takes scipy in its
    place."""
    from ramdsir_tpu_torch import native
    from ramdsir_tpu_torch.ops import metrics, postprocess

    bad_flags = lambda lib: dataclasses.replace(lib, flags=lib.flags + ("-fno-such-flag-here",))
    monkeypatch.setattr(native, "POSTPROC", bad_flags(native.POSTPROC))
    m = np.zeros((8, 8), bool)
    m[2:5, 2:5] = True
    with pytest.raises(RuntimeError, match="failed on"):
        postprocess.get_largest_fillhole(m)
    with pytest.raises(RuntimeError, match="failed on"):
        postprocess.postprocessing(np.stack([m, m]).astype(np.float32), threshold=0.75)
    with pytest.raises(RuntimeError, match="failed on"):
        metrics.hd95(m, m)
    from ramdsir_tpu_torch.data import png

    monkeypatch.setattr(native, "PNG", bad_flags(native.PNG))
    with pytest.raises(RuntimeError, match="failed on"):
        png.decode(png.encode(np.zeros((2, 3), np.uint8)))
    monkeypatch.setattr(native, "POSTPROC", dataclasses.replace(native.POSTPROC, compiler="no-such-compiler-here"))
    with pytest.raises(RuntimeError, match="cannot run"):
        postprocess.connectivity_region_analysis(m)


def test_builder_keys_on_flags_and_reuses_its_build(monkeypatch, tmp_path):
    """The builder names a library by the hash of its source, compiler and
    flags: a changed flag builds a new file, and a second build of the same
    source and flags finds the file and runs no compiler."""
    from ramdsir_tpu_torch.native import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int tiny_answer() { return 42; }\n')
    flags = ("-O1", "-shared", "-fPIC")
    lib = build.Library(str(src), "g++", flags, {"tiny_answer": (ctypes.c_int, [])})
    path = lib.path()
    assert os.path.dirname(path) == str(tmp_path) and lib.load().tiny_answer() == 42
    other = build.build_library(str(src), "g++", flags + ("-DTINY",))
    assert other != path and os.path.exists(other)
    runs = []
    monkeypatch.setattr(build.subprocess, "run", lambda *a, **k: runs.append(a))
    assert build.build_library(str(src), "g++", flags) == path and runs == []
    assert sorted(os.listdir(tmp_path)) == sorted(["tiny.cpp", os.path.basename(path), os.path.basename(other)])


@pytest.mark.parametrize("flags", [["--num_devices", "2"]], ids=lambda f: f[0].lstrip("-"))
def test_unported_flags_raise(tmp_path, flags):
    """More NCCL ranks than visible GPUs raise before anything runs: no rank
    is started and nothing shares a card quietly (on the CPU, --device cpu
    runs them as gloo ranks: test_num_devices_two_on_cpu)."""
    visible = torch.cuda.device_count()
    flags = [str(max(2, visible + 1)) if f == "2" else f for f in flags]
    with pytest.raises(ValueError, match="visible GPU"):
        cli_main(["--device", "cuda", "--save_path", str(tmp_path / "run"), "--ram", *flags])
    assert not (tmp_path / "run").exists()


def test_num_devices_two_on_cpu(trained_run, tmp_path, capfd, monkeypatch):
    """cli.train --device cpu --num_devices 2: two gloo ranks train the
    global batch (3+6+7 rows, 8 a rank), rank 0 evaluates once and writes
    one set of files (each step logged once), and the CLI prints rank 0's
    summary."""
    data, run = trained_run[0] / "data", tmp_path / "ddp"
    monkeypatch.setenv("OMP_NUM_THREADS", str(max(1, worker_threads() // 2)))  # the ranks' share of the cores
    summary = cli_main(["--device", "cpu", "--num_devices", "2", "--data_root", str(data), "--dataset", "fundus",
                        "--domain_idxs", "1,2,3", "--test_domain_idx", "0", "--ram", "--rec", "--is_out_domain",
                        "--consistency", "--consistency_type", "kd", "--save_path", str(run), "--image_size", "32",
                        "--epochs", "1", "--max_steps", "2", "--test_batch_size", "2"])
    out = capfd.readouterr().out  # the ranks print to the file descriptors
    assert len(re.findall(r"epoch 0: eval avg dice [0-9.]+ \| best", out)) == 1, out
    assert summary["steps"] == 2 and {"cup_dice", "disc_dice", "best", "resume_checkpoint"} <= set(summary)
    rows = [json.loads(line) for line in (run / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "loss/loss" in r] == [0, 1]
    assert all(np.isfinite(r["loss/loss"]) for r in rows if "loss/loss" in r)
    assert len((run / "0_val_log.csv").read_text().splitlines()) == 1
    assert json.loads((run / "run_config.json").read_text())["config"]["num_devices"] == 2
    for f in ("final_model.pth", "final_model.ckpt"):
        assert (run / f).is_file(), f


@pytest.fixture(scope="module")
def variant_trees(tmp_path_factory):
    """A fundus tree at 48^2 (8 train pairs a domain, 2 test pairs) and a
    prostate tree of 48^2 slices with two 8-slice test volumes."""
    from ramdsir_tpu_torch.data.synthetic import make_fundus_tree, make_prostate_tree, make_prostate_volumes

    root = tmp_path_factory.mktemp("variant_trees")
    make_fundus_tree(str(root / "f"), per_domain_train=8, per_domain_test=2, size=48)
    make_prostate_tree(str(root / "p"), per_domain=4, size=48)
    make_prostate_volumes(str(root / "p"), per_domain=2, depth=8, size=48)
    return root


VARIANT_FLAGS = {
    "num_classes": ["--dataset", "prostate", "--num_classes", "3"],
    "remat": ["--remat"],
    "trace_dir": ["--trace_dir", "TRACE", "--epochs", "2", "--max_steps", "3"],
    "norm_gn": ["--norm", "gn"],
    "norm_in": ["--norm", "in"],
    "global_batch": ["--global_batch", "18"],
    "scan_window": ["--scan_window", "4"],
}


@pytest.mark.parametrize("name", list(VARIANT_FLAGS))
def test_variant_flags_run(variant_trees, tmp_path, capsys, name):
    """cli.train --device cpu with each variant flag: one short epoch (the
    trace's window needs a third step, so two epochs there), finite losses
    every step, the eval's CSV row, the final .pth / .ckpt and the run
    config; and what the flag changes shows."""
    flags = [str(tmp_path / "trace") if f == "TRACE" else f for f in VARIANT_FLAGS[name]]
    prostate = "prostate" in flags
    data = ["--data_root", str(variant_trees / ("p" if prostate else "f"))]
    data += (["--domain_idxs", "0,1,2,3,4", "--test_domain_idx", "5"] if prostate
             else ["--domain_idxs", "1,2,3", "--test_domain_idx", "0", "--image_size", "48", "--is_out_domain"])
    run = tmp_path / "run"
    summary = cli_main(["--device", "cpu", "--ram", "--rec", "--consistency", "--consistency_type", "kd",
                        "--save_path", str(run), "--epochs", "1", "--max_steps", "2", "--test_batch_size", "2",
                        *data, *flags])
    rows = [json.loads(line) for line in (run / "log" / "metrics.jsonl").read_text().splitlines()]
    losses = [r for r in rows if "loss/loss" in r]
    steps = 3 if name == "trace_dir" else 1 if name == "global_batch" else 2  # 8 images a domain, 6 a batch
    assert [r["step"] for r in losses] == list(range(steps)) and summary["steps"] == steps
    sup = "loss_ce" if prostate else "loss_bce"
    keys = {f"{sup}_1", "loss_dice_1", f"{sup}_2", "loss_dice_2", "loss_consistency", "loss_rec", "loss"}
    assert all({k[5:] for k in r if k.startswith("loss/")} == keys for r in losses)
    assert all(np.isfinite(r[f"loss/{k}"]) for r in losses for k in keys)
    target = 5 if prostate else 0
    assert len((run / f"{target}_val_log.csv").read_text().splitlines()) == (2 if name == "trace_dir" else 1)
    for f in ("final_model.pth", "final_model.ckpt", "run_config.json"):
        assert (run / f).is_file(), f
    cfg = json.loads((run / "run_config.json").read_text())["config"]
    weights = torch.load(run / "final_model.pth", map_location="cpu")["encoder_state_dict"]
    if name == "num_classes":
        head = torch.load(run / "final_model.pth", map_location="cpu")["seg_decoder_state_dict"]["out1.weight"]
        assert cfg["num_classes"] == 3 and head.shape[0] == 3
    elif name.startswith("norm"):
        assert cfg["norm"] == name[-2:]
        assert ("convd1.bn1.weight" in weights) == (name == "norm_gn")
        assert not any("running" in k for k in weights)
    elif name == "global_batch":
        assert cfg["global_batch"] == 18 and cfg["lr"] == pytest.approx(2e-3 * 18 / 16)
    elif name == "trace_dir":
        assert summary["trace"] == str(tmp_path / "trace" / "trace_steps_2-2.json")
        assert os.path.isfile(summary["trace"])
        assert f"profiler trace (steps 2-2) written to {summary['trace']}" in capsys.readouterr().out
    else:
        assert cfg[name] == (True if name == "remat" else 4)

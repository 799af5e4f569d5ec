"""The port's fundus train step against the JAX package's, on the CPU.

Both sides start from the same weights (the JAX `init_state`, carried over
by the port's `jax_params_to_torch`), take the same numpy batches, and the
port is handed the RAM ratios the JAX step drew from its key.  One step is
compared in the default configuration (banded-DFT RAM with precomputed
donor bands), with `ram_use_pallas` (full-spectrum RAM; the JAX side runs
the Pallas kernel in interpret mode) and with donor images and no Pallas
(the host loaders' batch: the JAX side mixes with its plain `_mix_spectrum`,
the port with K1 in full mode); a 3-step trajectory in the default one.  The device pipeline is in tests/test_torch_port_pipeline.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ramdsir_tpu.config import TrainConfig as JConfig
from ramdsir_tpu.ops.ram import banded_amplitude_spectrum, sample_ram_ratios
from ramdsir_tpu.train.state import init_state as jinit_state
from ramdsir_tpu.train.steps import make_train_step as jmake_train_step
from ramdsir_tpu.utils.torch_compat import flax_module_to_torch_sd
from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.train.state import init_state
from ramdsir_tpu_torch.train.steps import make_train_step
from ramdsir_tpu_torch.utils.torch_compat import jax_params_to_torch
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

BSL = [2, 2, 2]
B = sum(BSL)
HW = 32
NAMES = ("encoder", "seg_decoder", "rec_decoder")
CFG = dict(
    dataset="fundus", ram=True, rec=True, consistency=True, consistency_type="kd",
    image_size=HW, domain_idxs=(0, 1, 2), test_domain_idx=0, log_images_every=0,
)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


MODES = ("banded_dft", "ram_use_pallas", "donor_plain")  # donor bands, donor images with / without Pallas


def _batch(seed, donor_images):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32)
    donor = rng.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32)
    mask = (rng.uniform(size=(B, HW, HW, 2)) > 0.5).astype(np.float32)
    batch = {"img": img, "mask": mask}
    if donor_images:
        batch["donor"] = donor
    else:
        batch["donor_amp"] = np.array(banded_amplitude_spectrum(jnp.asarray(donor)))
    return batch


def _port_state(cfg, jstate):
    state = init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    sds = jax_params_to_torch(_np(jstate.params), _np(jstate.batch_stats))
    for name in NAMES:
        state.models[name].load_state_dict(sds[name], strict=True)
    return state


def _torch_layout(params, stats=None):
    """A JAX tree in the port's state-dict layout, per module."""
    return {n: flax_module_to_torch_sd(_np(params[n]), _np(stats[n]) if stats else {}) for n in NAMES if n in params}


@pytest.fixture(scope="module")
def jax_init():
    cfg = JConfig(**CFG, device_data=False).resolve()
    state, models = jinit_state(cfg, jax.random.PRNGKey(0))
    return state, models


def _snapshot(jstate, tstate):
    return (
        _torch_layout(jstate.params, jstate.batch_stats),
        {n: {k: v.detach().numpy().copy() for k, v in tstate.models[n].state_dict().items()}
         for n in NAMES if n in tstate.models},
    )


def _run_both(jax_init, mode, steps, total_iters=10):
    """`steps` steps on both sides; metrics per step, parameters and
    running statistics after the first and the last step."""
    jstate, models = jax_init
    pallas = mode == "ram_use_pallas"
    jcfg = JConfig(**CFG, device_data=False, ram_use_pallas=pallas).resolve()
    tcfg = TrainConfig(**CFG, ram_use_pallas=pallas, device="cpu").resolve()
    jstep = jmake_train_step(jcfg, models, total_iters=total_iters, batch_size_list=BSL, debug_grads=True)
    tstep = make_train_step(tcfg, total_iters=total_iters, batch_size_list=BSL, debug_grads=True)
    tstate = _port_state(tcfg, jstate)
    out = {"jax": [], "port": [], "params": [], "cfg": tcfg, "state0": _torch_layout(jstate.params), "mode": mode}
    for i in range(steps):
        batch = _batch(100 + i, mode != "banded_dft")
        key = jax.random.PRNGKey(11 + i)
        jstate, jm, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        ratio = torch.from_numpy(np.asarray(sample_ram_ratios(key, B)))
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, draws={"ratio": ratio})
        out["jax"].append(jm)
        out["port"].append(tm)
        if i in (0, steps - 1):
            out["params"].append(_snapshot(jstate, tstate))
    out["steps_taken"] = tstate.step
    return out


@pytest.fixture(scope="module")
def runs(jax_init):
    """Lazily run each configuration once: the default one for 3 steps (its
    first step is the one-step comparison), the others for 1."""
    done = {}

    def get(mode):
        if mode not in done:
            done[mode] = _run_both(jax_init, mode, steps=3 if mode == "banded_dft" else 1)
        return done[mode]

    return get


@pytest.fixture(scope="module", params=MODES)
def one_step(request, runs):
    return runs(request.param)


@pytest.fixture(scope="module")
def trajectory(runs):
    return runs("banded_dft")


METRICS = ("loss_bce_1", "loss_dice_1", "loss_bce_2", "loss_dice_2", "loss_consistency", "loss_rec", "loss", "lr")


def check_step_metrics(jm, tm, keys=METRICS):
    """One step's metrics: the same keys, each value within the bound of
    tests/test_torch_step_parity.py:172."""
    assert set(keys) <= set(tm) and set(tm) - {"_grads"} == set(jm) - {"_grads"}
    for k in keys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4, atol=2e-5, err_msg=k)


def check_step_gradients(jax_grads, tg):
    """Every gradient, with the rule of tests/test_torch_step_parity.py:175-217:
    conv biases ahead of a BN have mathematically zero gradients (fp noise
    only), and the first stages' BN affine gradients are ill-conditioned in
    float32, hence the absolute floor, the 2% relative term and the
    tolerated 1e-4 fraction of stray elements; a wrong loss term, slice or
    statistic moves whole tensors and fails."""
    jg = _torch_layout(jax_grads)
    assert set(jg) == set(tg)
    dots = norm_a = norm_b = 0.0
    for name in jg:
        assert set(jg[name]) == set(tg[name]), name
        for k, want in jg[name].items():
            got = tg[name][k].numpy()
            tol = 3e-4 + 2e-2 * np.abs(want).max()
            err = np.abs(got - want)
            assert float(np.mean(err > tol)) <= 1e-4, f"{name}.{k}"
            assert float(err.max()) <= 5 * tol, f"{name}.{k}: max err {err.max():.2e} vs tol {tol:.2e}"
            dots += float(np.sum(got.astype(np.float64) * want))
            norm_a += float(np.sum(got.astype(np.float64) ** 2))
            norm_b += float(np.sum(want.astype(np.float64) ** 2))
    assert dots / np.sqrt(norm_a * norm_b) > 0.9999


def check_params_and_running_stats(jax_params, port_params, lr):
    """Params within 2.5*lr (the first Adam step is ~lr*sign(g), so a
    near-zero gradient may flip; tests/test_torch_step_parity.py:232) and BN
    / DSBN running statistics at rtol 1e-4, atol 1e-5 (:248)."""
    assert set(jax_params) == set(port_params)
    for name in jax_params:
        want, got = jax_params[name], port_params[name]
        assert set(want) == set(got), name
        for k, w in want.items():
            tol = dict(rtol=1e-4, atol=1e-5) if "running" in k else dict(atol=2.5 * lr)
            np.testing.assert_allclose(got[k], w, err_msg=f"{name}.{k}", **tol)


def test_step_metrics(one_step):
    check_step_metrics(one_step["jax"][0], one_step["port"][0])
    assert one_step["steps_taken"] == len(one_step["port"])


def check_gradients_within_jax_spread(jax_grads, port_grads, jax_pallas_grads):
    """check_step_gradients' rule for a step with donor images that JAX
    mixes with its plain `_mix_spectrum` (|z| by jnp.abs).  A tensor past
    the rule passes only where JAX's own Pallas mix of the same batch and
    key (|z| as sqrt(re^2 + im^2), which K1 computes too; the callable
    `jax_pallas_grads` gives its gradients) parts from the plain one past
    it as well, and the port's stray share and largest error lie within
    twice that spread; the cosine of the rule holds unrelaxed."""
    try:
        check_step_gradients(jax_grads, port_grads)
        return
    except AssertionError as e:
        broken = str(e)
    jg, jpallas = _torch_layout(jax_grads), _torch_layout(jax_pallas_grads())
    dots = norm_a = norm_b = 0.0
    for name in jg:
        for k, want in jg[name].items():
            got = port_grads[name][k].numpy()
            tol = 3e-4 + 2e-2 * np.abs(want).max()
            err, spread = np.abs(got - want), np.abs(jpallas[name][k] - want)
            frac, worst = float(np.mean(err > tol)), float(err.max() / tol)
            sfrac, sworst = float(np.mean(spread > tol)), float(spread.max() / tol)
            assert (frac <= 1e-4 and worst <= 5) or (frac <= 2 * sfrac and worst <= 2 * sworst), (
                f"{name}.{k}: stray share {frac:.2e}, max {worst:.2f} tol; JAX's own spread {sfrac:.2e}, "
                f"{sworst:.2f} tol ({broken})")
            dots += float(np.sum(got.astype(np.float64) * want))
            norm_a += float(np.sum(got.astype(np.float64) ** 2))
            norm_b += float(np.sum(want.astype(np.float64) ** 2))
    assert dots / np.sqrt(norm_a * norm_b) > 0.9999


def test_step_gradients(one_step, runs):
    """check_step_gradients' rule; with donor images and JAX's plain mix,
    check_gradients_within_jax_spread (on this batch the 1x1 conv
    rec_decoder.convu3.conv2.weight, 4096 elements, has one element past
    the rule between JAX's two mixes)."""
    jax_grads, port_grads = one_step["jax"][0]["_grads"], one_step["port"][0]["_grads"]
    if one_step["mode"] == "donor_plain":
        check_gradients_within_jax_spread(jax_grads, port_grads, lambda: runs("ram_use_pallas")["jax"][0]["_grads"])
    else:
        check_step_gradients(jax_grads, port_grads)


def test_step_params_and_running_stats(one_step):
    check_params_and_running_stats(*one_step["params"][0], one_step["cfg"].lr)


def test_trajectory(trajectory):
    """Three steps with the poly schedule moving (total_iters=10).

    After the first update two float32 runs part by Adam's sign noise: its
    step is about lr*sign(g) whatever |g|, so an element whose tiny gradient
    changes sign moves the other way, and BN carries that on.  The bounds
    come from that envelope, measured as the JAX step against itself from
    weights perturbed by 1e-6 relative: after 3 steps the losses part by up
    to 3.5e-3 (total) and 1e-2 (components), each module's running
    statistics by 2-6% (relative L2), and its parameter change turns by a
    cosine of 0.89-0.97.  The port sits inside it (2.5e-4, 4.4e-3, 2-5%,
    0.90-0.98).  The size of each module's change must agree within 5%: a
    wrong group factor or schedule doubles or halves it.  Step 0 starts from
    equal weights and keeps the one-step bound; the lr matches exactly."""
    lr0 = trajectory["cfg"].lr
    for i, (jm, tm) in enumerate(zip(trajectory["jax"], trajectory["port"])):
        for k in METRICS:
            rtol = 2e-4 if i == 0 else (1e-2 if k == "loss" else 3e-2)
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, atol=3e-5, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(float(tm["lr"]), lr0 * (1 - max(i - 1, 0) / 10) ** 0.9, rtol=1e-6)
    jax_params, port_params = trajectory["params"][-1]
    flat = lambda sd, keys: np.concatenate([sd[k].ravel() for k in keys]).astype(np.float64)
    for name in NAMES:
        p0 = trajectory["state0"][name]
        want, got = jax_params[name], port_params[name]
        da = flat(got, p0) - flat(p0, p0)
        db = flat(want, p0) - flat(p0, p0)
        assert da @ db / np.sqrt((da @ da) * (db @ db)) > 0.8, name
        assert abs(np.log(np.linalg.norm(da) / np.linalg.norm(db))) < np.log(1.05), name
        for suffix in ("running_mean", "running_var"):
            keys = [k for k in want if k.endswith(suffix)]
            a, b = flat(got, keys), flat(want, keys)
            assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.15, f"{name} {suffix}"

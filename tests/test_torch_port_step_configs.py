"""The port's train step against the JAX package's in the step configurations
the other files do not hold, on the CPU (TF32 off: there is none there).

The harness is tests/test_torch_port_variants.py's: a U-Net of width 8 on
both sides, fundus batch 6 = 2 x 3 at 64^2, weights across through
`jax_params_to_torch`, numpy batches from seeds, and the port handed the
RAM ratios the JAX step drew.  The batches carry donor images, which the
JAX step mixes with its plain `_mix_spectrum`.  The gradients are held by
`check_config_gradients`: check_step_gradients' strict rule, or, tensor by
tensor where it trips, within twice a float32 spread of JAX's own measured
on the same batch: JAX's plain mix against its Pallas mix
(check_gradients_within_jax_spread's) or JAX against itself from weights
moved by 1e-6 relative (as tests/test_torch_port_scan.py measures it for
the window); the cosine of the rule holds unrelaxed.  The code under test
never sets its own bound.  The metrics and the parameters and
running statistics are held to check_step_metrics' and
check_params_and_running_stats' bounds.

Configurations (one JAX compile each, shared by the batch seeds; the
Pallas step is compiled only where the strict rule trips): the default CLI
consistency `--consistency_type mse`, `--consistency` off, `--rec` off and
no RAM (`--ram --rec --consistency` all off) here; `--lambda_rec 0.3`,
`--is_out_domain` and `--activation leaky_relu` in
tests/test_torch_port_step_configs_more.py.  Neither step reads
`is_out_domain`: it chooses the donors, which the device pipeline's epoch
plan (tests/test_torch_port_pipeline.py) and the scan windows against
JAX's (tests/test_torch_port_scan.py) hold under it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ramdsir_tpu.ops.ram import sample_ram_ratios
from ramdsir_tpu.train.steps import make_train_step as jmake_train_step
from ramdsir_tpu_torch.train.steps import make_train_step
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)
from tests.test_torch_port_step import (
    _snapshot,
    _torch_layout,
    check_params_and_running_stats,
    check_step_gradients,
    check_step_metrics,
)
from tests.test_torch_port_variants import PERTURBATIONS, DATASETS, _stray, configs, jax_state, port_state

HW = 64
BSL = DATASETS["fundus"]["bsl"]
SEEDS = (100, 101)  # batch seeds, each configuration on every one

CONFIGS = {
    "mse": dict(consistency_type="mse"),
    "no_consistency": dict(consistency=False),
    "no_rec": dict(rec=False),
    "no_ram": dict(ram=False, rec=False, consistency=False),
}
MORE_CONFIGS = {  # tests/test_torch_port_step_configs_more.py
    "lambda_rec_0.3": dict(lambda_rec=0.3),
    "is_out_domain": dict(is_out_domain=True),
    "leaky_relu": dict(activation="leaky_relu"),
}


def donor_batch(seed):
    """A fundus host batch with donor images, as the host loaders give it."""
    rng = np.random.default_rng(seed)
    b = sum(BSL)
    return {
        "img": rng.uniform(0, 255, (b, HW, HW, 3)).astype(np.float32),
        "donor": rng.uniform(0, 255, (b, HW, HW, 3)).astype(np.float32),
        "mask": (rng.uniform(size=(b, HW, HW, 2)) > 0.5).astype(np.float32),
    }


def metric_keys(cfg):
    keys = ["loss_bce_1", "loss_dice_1", "loss", "lr"]
    if cfg.ram:
        keys += ["loss_bce_2", "loss_dice_2", "loss_consistency", "loss_rec"]
    return keys


def run_config(variant, seeds=SEEDS):
    """One step of the configuration on both sides from the same weights,
    batch and ratios, for each batch seed, with functions giving JAX's
    gradients through its Pallas mix and from moved weights on that seed's
    batch."""
    jcfg, tcfg = configs("fundus", HW, **variant)
    jstate, models = jax_state(jcfg)
    jstep = jmake_train_step(jcfg, models, total_iters=10, batch_size_list=BSL, debug_grads=True)
    tstep = make_train_step(tcfg, total_iters=10, batch_size_list=BSL, debug_grads=True)
    pallas = {}

    def pallas_grads(batch, key):
        if "step" not in pallas:
            pcfg, _ = configs("fundus", HW, ram_use_pallas=True, **variant)
            pallas["step"] = jmake_train_step(pcfg, models, total_iters=10, batch_size_list=BSL, debug_grads=True)
        return pallas["step"](jstate, batch, key)[1]["_grads"]

    out = {}
    key = jax.random.PRNGKey(11)
    for seed in seeds:
        batch = {k: jnp.asarray(v) for k, v in donor_batch(seed).items()}
        tstate = port_state(tcfg, jstate)
        jstate2, jm, _ = jstep(jstate, batch, key)
        ratio = torch.from_numpy(np.asarray(sample_ram_ratios(key, sum(BSL))))
        port_batch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        tm = tstep(tstate, port_batch, draws={"ratio": ratio})

        def moved(i, batch=batch):
            rng = np.random.default_rng(i)
            params = jax.tree.map(lambda p: (np.asarray(p) * (1 + 1e-6 * rng.standard_normal(p.shape))).astype(np.float32),
                                  jstate.params)
            return jstep(jstate.replace(params=params), batch, key)[1]["_grads"]

        out[seed] = dict(jax=jm, port=tm, params=_snapshot(jstate2, tstate),
                         pallas=lambda batch=batch: pallas_grads(batch, key), moved=moved)
    return dict(cfg=tcfg, seeds=out)


def check_config_gradients(jax_grads, port_grads, jax_pallas_grads, jax_moved):
    """The module docstring's rule: check_step_gradients', or, for each
    tensor that breaks it, a stray share and a largest error within twice
    those of JAX's Pallas mix against its plain one (`jax_pallas_grads()`)
    or of JAX from moved weights (`jax_moved(i)`, the largest difference
    per element over PERTURBATIONS draws); the cosine holds."""
    try:
        check_step_gradients(jax_grads, port_grads)
        return
    except AssertionError as e:
        broken = str(e)
    jg, jpallas = _torch_layout(jax_grads), _torch_layout(jax_pallas_grads())
    moved = [_torch_layout(jax_moved(i)) for i in range(PERTURBATIONS)]
    dots = norm_a = norm_b = 0.0
    for name in jg:
        for k, want in jg[name].items():
            got = port_grads[name][k].numpy()
            tol = 3e-4 + 2e-2 * np.abs(want).max()
            frac, worst = _stray(np.abs(got - want), tol)
            spreads = {"JAX's two mixes": _stray(np.abs(jpallas[name][k] - want), tol),
                       "JAX from moved weights": _stray(np.max([np.abs(m[name][k] - want) for m in moved], 0), tol)}
            assert (frac <= 1e-4 and worst <= 5) or any(
                frac <= max(1e-4, 2 * f) and worst <= max(5, 2 * w) for f, w in spreads.values()), (
                f"{name}.{k}: stray share {frac:.2e}, max {worst:.2f} tol; spreads {spreads} ({broken})")
            dots += float(np.sum(got.astype(np.float64) * want))
            norm_a += float(np.sum(got.astype(np.float64) ** 2))
            norm_b += float(np.sum(want.astype(np.float64) ** 2))
    assert dots / np.sqrt(norm_a * norm_b) > 0.9999


def config_runs_fixture(table):
    """A module-scoped fixture running each configuration of `table` once, lazily."""

    @pytest.fixture(scope="module")
    def config_runs():
        done = {}

        def get(name):
            if name not in done:
                done[name] = run_config(table[name])
            return done[name]

        return get

    return config_runs


config_runs = config_runs_fixture(CONFIGS)


def for_each_seed(run, check):
    for seed, one in run["seeds"].items():
        try:
            check(one)
        except AssertionError as e:
            raise AssertionError(f"batch seed {seed}: {e}") from None


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_step_metrics(config_runs, name):
    run = config_runs(name)
    for_each_seed(run, lambda one: check_step_metrics(one["jax"], one["port"], metric_keys(run["cfg"])))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_step_gradients(config_runs, name):
    run = config_runs(name)
    for_each_seed(run, lambda one: check_config_gradients(one["jax"]["_grads"], one["port"]["_grads"], one["pallas"],
                                                          one["moved"]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_step_params_and_running_stats(config_runs, name):
    run = config_runs(name)
    for_each_seed(run, lambda one: check_params_and_running_stats(*one["params"], run["cfg"].lr))

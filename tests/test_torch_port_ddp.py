"""The port's data-parallel training (`--num_devices` > 1) on the CPU,
against the JAX package's single-device and padded steps.

Ranks are gloo processes started by `parallel.distributed.launch`; their
side is tests/_ddp_ranks.py (it imports no JAX).  Each world size is
launched once for the module: every case of that size runs in the one
launch, the launches one after another in the background while this
process compiles the JAX steps.
At 32^2, U-Net n=16, float32 on the CPU (no TF32 here):

- `pad_batch`, `rank_rows` and `local_batch_slice` against the JAX
  package's arithmetic;
- a 2-rank fundus step (batch 3+6+7 -> 8 + 8; domain 1 straddles the
  ranks) against JAX's single-device `make_train_step` on the same batch
  and ratios, with tests/test_torch_port_step.py's bounds; the same step
  against the port's own single-process step; three steps with the
  replicas bit-equal after each;
- a 3-rank step on the padded batch (16 -> 18: 6 + 6 + 4 real rows and 2
  padding rows) against JAX's `make_train_step(pad_to_multiple=3)` on
  `pad_batch(batch, 3)`, JAX's n_valid path;
- BatchNorm and DSBN across ranks against one process on the concatenated
  rows: outputs, input and affine gradients, running statistics; a DSBN
  domain that one rank lacks and one that no rank holds;
- one step each of prostate with padding (10 -> 12 over 3 ranks), --norm gn,
  bfloat16 and --remat;
- `fit` over 2 ranks from the host loaders against a 1-process `fit`
  (tests/test_multihost.py:86's counterpart);
- a rank that raises fails the launch within its timeout.
"""
import json
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._ddp_ranks as ranks
from ramdsir_tpu.config import TrainConfig as JConfig
from ramdsir_tpu.ops.ram import banded_amplitude_spectrum, sample_ram_ratios
from ramdsir_tpu.parallel import distributed as jdistributed
from ramdsir_tpu.parallel.mesh import pad_batch as jpad_batch
from ramdsir_tpu.train.state import init_state as jinit_state
from ramdsir_tpu.train.steps import make_train_step as jmake_train_step
from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.parallel import distributed, mesh
from ramdsir_tpu_torch.train.steps import check_supported
from ramdsir_tpu_torch.utils.torch_compat import jax_params_to_torch
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)
from tests.test_torch_port_step import (
    METRICS,
    NAMES,
    _np,
    _torch_layout,
    check_params_and_running_stats,
    check_step_gradients,
    check_step_metrics,
)

HW = 32
BSL = [3, 6, 7]  # the reference fundus batch of target domain 3
B = sum(BSL)
STEPS = 3
CFG = dict(
    dataset="fundus", ram=True, rec=True, consistency=True, consistency_type="kd",
    image_size=HW, domain_idxs=(0, 1, 2), test_domain_idx=3, log_images_every=0,
)
P_BSL = [2] * 5
P_CFG = dict(
    dataset="prostate", ram=True, rec=True, consistency=True, consistency_type="kd",
    image_size=HW, domain_idxs=(0, 1, 2, 3, 4), test_domain_idx=5, log_images_every=0,
)
LAUNCH_TIMEOUT_S = 300.0


def _fundus_batch(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32)
    donor = rng.uniform(0, 255, (B, HW, HW, 3)).astype(np.float32)
    mask = (rng.uniform(size=(B, HW, HW, 2)) > 0.5).astype(np.float32)
    return {"img": img, "mask": mask, "donor_amp": np.array(banded_amplitude_spectrum(jnp.asarray(donor)))}


def _prostate_batch(seed):
    rng = np.random.default_rng(seed)
    b = sum(P_BSL)
    img = rng.uniform(-1, 1, (b, HW, HW, 3)).astype(np.float32)
    donor = rng.uniform(-1, 1, (b, HW, HW, 3)).astype(np.float32)
    mask = (rng.uniform(size=(b, HW, HW)) > 0.6).astype(np.int32)
    return {"img": img, "mask": mask, "donor_amp": np.array(banded_amplitude_spectrum(jnp.asarray(donor)))}


X_NORM = np.random.default_rng(3).normal(1.0, 2.0, (18, 4, 5, 5)).astype(np.float32)
COT_NORM = np.random.default_rng(4).normal(size=X_NORM.shape).astype(np.float32)
# 9 real rows over 2 ranks (5 + 4 and a padding row): rank 0 holds no row of
# domain 2, rank 1 none of domain 0, and no rank holds domain 3
LABELS = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2])
# world 2 for the first three; the zero_rank cases run 5 real rows over 4
# ranks (2 + 2 + 1 and 3 padding rows): rank 3 holds no real row at all
NORM_CASES = {
    "bn_dual": dict(kind="bn", x=X_NORM, cot=COT_NORM, n_real=9, dual=True),
    "bn_padded": dict(kind="bn", x=X_NORM[:9], cot=COT_NORM[:9], n_real=9),
    "dsbn": dict(kind="dsbn", x=X_NORM[:9], cot=COT_NORM[:9], n_real=9, labels=LABELS),
    "bn_zero_rank": dict(kind="bn", x=X_NORM[:5], cot=COT_NORM[:5], n_real=5),
    "dsbn_zero_rank": dict(kind="dsbn", x=X_NORM[:5], cot=COT_NORM[:5], n_real=5, labels=np.array([0, 0, 1, 2, 2])),
}


@pytest.fixture(scope="module")
def data():
    """The batches, JAX keys and ratios: the 16-row batch's, and those JAX's
    padded step draws (for its 18 rows, the real rows' first)."""
    keys = [jax.random.PRNGKey(11 + i) for i in range(STEPS)]
    return dict(
        keys=keys, batches=[_fundus_batch(100 + i) for i in range(STEPS)],
        ratios=[np.array(sample_ram_ratios(k, B)) for k in keys],
        ratios_pad=[np.array(sample_ram_ratios(k, B + 2))[:B] for k in keys],
        prostate=_prostate_batch(5), p_ratio=np.random.default_rng(7).uniform(0.0, 1.0, sum(P_BSL)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def jax_init():
    cfg = JConfig(**CFG, device_data=False).resolve()
    return jinit_state(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def sds(jax_init):
    """The JAX init state in the port's layout, as numpy (sent to the ranks)."""
    jstate, _ = jax_init
    out = jax_params_to_torch(_np(jstate.params), _np(jstate.batch_stats))
    return {n: {k: v.numpy() for k, v in out[n].items()} for n in NAMES}


@pytest.fixture(scope="module")
def fit_tree(tmp_path_factory):
    from ramdsir_tpu_torch.data.synthetic import make_fundus_tree

    root = tmp_path_factory.mktemp("ddp_fit")
    make_fundus_tree(str(root / "data"), per_domain_train=10, per_domain_test=2, size=40, seed=3)
    return root


def _fit_cfg(root, name):
    return dict(CFG, data_root=str(root / "data"), save_path=str(root / name), epochs=1, device_data=False,
                loader="thread", num_workers=2, is_out_domain=True, test_batch_size=2)


FIT_STEPS = 3


@pytest.fixture(scope="module")
def launches(sds, fit_tree, data):
    """The launches of worlds 2, 3 and 4, one after another in a background
    thread (this process compiles the JAX steps meanwhile), each rank
    running its size's cases in order."""
    BATCHES, RATIOS = data["batches"], data["ratios"]  # noqa: N806
    w2 = [
        ("fundus", "step", dict(cfg_kw=CFG, bsl=BSL, batches=BATCHES, ratios=RATIOS, sds=sds, viz=True)),
        ("fundus_remat", "step", dict(cfg_kw=dict(CFG, remat=True), bsl=BSL, batches=BATCHES[:1],
                                      ratios=RATIOS[:1], sds=sds)),
        ("gn", "step", dict(cfg_kw=dict(CFG, norm="gn"), bsl=BSL, batches=BATCHES[:1], ratios=RATIOS[:1])),
        ("bf16", "step", dict(cfg_kw=dict(CFG, compute_dtype="bfloat16"), bsl=BSL, batches=BATCHES[:1],
                              ratios=RATIOS[:1], sds=sds)),
        *[(name, "norm", kw) for name, kw in NORM_CASES.items() if not name.endswith("zero_rank")],
        ("fit", "fit", dict(cfg_kw=_fit_cfg(fit_tree, "ddp"), max_steps=FIT_STEPS)),
        ("replicate", "replicate", dict(cfg_kw=CFG, bsl=BSL, batch=BATCHES[0], ratio=RATIOS[0])),
    ]
    w3 = [
        ("fundus_pad", "step", dict(cfg_kw=CFG, bsl=BSL, batches=BATCHES[:1], ratios=data["ratios_pad"][:1],
                                    sds=sds)),
        ("prostate_pad", "step", dict(cfg_kw=P_CFG, bsl=P_BSL, batches=[data["prostate"]], ratios=[data["p_ratio"]])),
    ]
    w4 = [(name, "norm", kw) for name, kw in NORM_CASES.items() if name.endswith("zero_rank")]
    pool = ThreadPoolExecutor(1)  # one launch at a time: the other test files share the cores
    futures = {
        n: pool.submit(distributed.launch, ranks.run_cases, n, devices=["cpu"] * n, args=(cases,),
                       timeout_s=LAUNCH_TIMEOUT_S)
        for n, cases in ((2, w2), (3, w3), (4, w4))
    }
    yield lambda n: futures[n].result()
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_runs(jax_init, launches, data):
    """JAX's single-device step over the three batches, and its padded step
    (pad_to_multiple=3) on pad_batch(batch, 3), from the same init."""
    jstate0, models = jax_init
    jcfg = JConfig(**CFG, device_data=False).resolve()
    out = {}
    for name, pad in (("plain", None), ("padded", 3)):
        jstep = jmake_train_step(jcfg, models, total_iters=10, batch_size_list=BSL, debug_grads=True,
                                 pad_to_multiple=pad)
        jstate, ms = jstate0, []
        for i in range(STEPS if pad is None else 1):
            batch = jpad_batch(data["batches"][i], pad) if pad else data["batches"][i]
            jstate, jm, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, data["keys"][i])
            ms.append(jm)
            if i == 0:
                first = _torch_layout(jstate.params, jstate.batch_stats)
        out[name] = dict(metrics=ms, state0=first, state=_torch_layout(jstate.params, jstate.batch_stats))
    out["params0"] = _torch_layout(jstate0.params)
    return out


def _grads(result):
    return {n: {k: torch.from_numpy(v) for k, v in g.items()} for n, g in result["grads"].items()}


def _single(case_kw):
    """A case run in this process, without a process group."""
    return ranks.step_case(**case_kw, device="cpu")


# --- the batch split ----------------------------------------------------------------


@pytest.mark.parametrize("b,multiple", [(16, 2), (16, 3), (10, 3), (10, 4), (7, 8)])
def test_pad_batch_equals_jax(b, multiple):
    rng = np.random.default_rng(b * 10 + multiple)
    batch = {"img": rng.normal(size=(b, 3, 2)).astype(np.float32), "mask": rng.integers(0, 3, (b, 4)).astype(np.int32)}
    want, got = jpad_batch(batch, multiple), mesh.pad_batch(batch, multiple)
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("b,world", [(16, 2), (16, 3), (10, 3), (10, 4), (12, 4), (5, 4)])
def test_rank_rows_split_the_padded_batch(b, world, monkeypatch):
    """The ranks' rows tile JAX's padded batch in order, the padding at the
    end; where B divides, each rank's slice is JAX's local_batch_slice for
    that process, and the port's local_batch_slice gives the same."""
    padded = jpad_batch({"i": np.arange(b) + 1}, world)["i"]
    per = len(padded) // world
    seen, real = [], 0
    for r in range(world):
        rows, n = mesh.rank_rows(b, world, r)
        assert rows.stop - rows.start == per
        part = padded[rows]
        assert np.all(part[:n] > 0) and np.all(part[n:] == 0)  # real rows first, then padding
        seen.extend(part)
        real += n
        if b % world == 0:
            monkeypatch.setattr(jax, "process_count", lambda: world)
            monkeypatch.setattr(jax, "process_index", lambda r=r: r)
            monkeypatch.setattr(distributed, "world", lambda: world)
            monkeypatch.setattr(distributed, "rank", lambda r=r: r)
            assert jdistributed.local_batch_slice(b) == rows == distributed.local_batch_slice(b)
    assert np.array_equal(seen, padded) and real == b


@pytest.mark.parametrize("world", [3, 5])
def test_local_batch_slice_keeps_jax_divisibility_error(world, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(distributed, "world", lambda: world)
    with pytest.raises(ValueError, match="not divisible"):
        jdistributed.local_batch_slice(16)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.local_batch_slice(16)


# --- the 2-rank step against JAX's single-device step ------------------------------------


def test_two_rank_step_metrics(launches, jax_runs):
    for rank_result in launches(2):
        check_step_metrics(jax_runs["plain"]["metrics"][0], rank_result["fundus"]["metrics"][0])


def test_two_rank_step_gradients(launches, jax_runs):
    """The global batch's gradients (after the all-reduce) on every rank,
    against JAX's gradients of the same batch."""
    jm = jax_runs["plain"]["metrics"][0]
    for rank_result in launches(2):
        check_step_gradients(jm["_grads"], _grads(rank_result["fundus"]))


def test_two_rank_step_params_and_running_stats(launches, jax_runs):
    check_params_and_running_stats(jax_runs["plain"]["state0"], launches(2)[0]["fundus"]["state0"], 2e-3)


@pytest.fixture(scope="module")
def single_fundus(sds, data):
    """The port's single-process step from the same state, with its viz."""
    return _single(dict(cfg_kw=CFG, bsl=BSL, batches=data["batches"][:1], ratios=data["ratios"][:1], sds=sds,
                        viz=True))


def test_two_rank_step_equals_the_single_process_step(launches, single_fundus):
    """The port's 2-rank step against its own single-process step from the
    same state: every loss within 1e-6 relative."""
    got = launches(2)[0]["fundus"]["metrics"][0]
    for k, want in single_fundus["metrics"][0].items():
        assert abs(got[k] - want) <= 1e-6 * max(abs(want), 1e-6), (k, got[k], want)


def test_two_rank_viz_is_the_global_batch(launches, single_fundus):
    """The image-grid slices, rows 0:9:4 of the global batch (rows 0 and 4
    on rank 0, row 8 on rank 1) and each domain's first restoration sample
    (rows 0, 3 and 9), assembled by one all-reduce, on every rank: the
    inputs equal the single process's, the predictions and restorations
    within 1e-3 (the statistics' sums are added in another order)."""
    want = single_fundus["viz"]
    for r in launches(2):
        got = r["fundus"]["viz"]
        assert set(got) == set(want) == {"image", "image_freq", "pred", "mask", "image_rec"}
        for k in want:
            assert got[k].shape == want[k].shape, k
            tol = dict(rtol=0, atol=1e-3) if k in ("pred", "image_rec") else dict(rtol=0, atol=0)
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_replicate_state_broadcasts_rank_zero(launches):
    """replicate_state gives every rank rank 0's parameters, statistics,
    Adam moments and step, whatever the others held."""
    r0, r1 = (r["replicate"] for r in launches(2))
    assert r0["before"] == r1["before"] and r1["moved"] != r0["moved"]
    assert r0["after"] == r1["after"] == r0["before"] and r0["step"] == r1["step"] == 1


def test_single_process_padded_step_equals_jax_padded_step(jax_runs, sds, data):
    """pad_to_multiple without a process group: the port's step on
    pad_batch(batch, 3) (18 rows, 16 real) against JAX's padded step, the
    n_valid path of one process."""
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(**CFG, device="cpu").resolve()
    state = init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    for name, sd in sds.items():
        state.models[name].load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    step = make_train_step(cfg, 10, batch_size_list=BSL, debug_grads=True, pad_to_multiple=3)
    batch = {k: torch.from_numpy(v) for k, v in mesh.pad_batch(data["batches"][0], 3).items()}
    tm = step(state, batch, draws={"ratio": torch.from_numpy(data["ratios_pad"][0])})
    jm = jax_runs["padded"]["metrics"][0]
    check_step_metrics(jm, tm)
    check_step_gradients(jm["_grads"], tm["_grads"])
    check_params_and_running_stats(jax_runs["padded"]["state0"], ranks.snapshot(state), cfg.lr)


def test_two_rank_trajectory(launches, jax_runs):
    """Three steps against JAX's, in tests/test_torch_port_step.py's
    trajectory envelope (Adam's sign noise after the first step)."""
    port = launches(2)[0]["fundus"]["metrics"]
    for i, (jm, tm) in enumerate(zip(jax_runs["plain"]["metrics"], port)):
        for k in METRICS:
            rtol = 2e-4 if i == 0 else (1e-2 if k == "loss" else 3e-2)
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=rtol, atol=3e-5, err_msg=f"step {i} {k}")


def test_replicas_bit_equal_after_every_step(launches):
    r0, r1 = (r["fundus"]["digests"] for r in launches(2))
    assert len(r0) == STEPS and r0 == r1
    s0, s1 = (r["fundus"]["state"] for r in launches(2))
    for n in NAMES:
        for k in s0[n]:
            assert np.array_equal(s0[n][k], s1[n][k]), f"{n}.{k}"


# --- the padded 3-rank step against JAX's n_valid path -------------------------------------


def test_padded_three_rank_step_metrics(launches, jax_runs):
    for rank_result in launches(3):
        check_step_metrics(jax_runs["padded"]["metrics"][0], rank_result["fundus_pad"]["metrics"][0])


def test_padded_three_rank_step_gradients(launches, jax_runs):
    jm = jax_runs["padded"]["metrics"][0]
    check_step_gradients(jm["_grads"], _grads(launches(3)[2]["fundus_pad"]))  # the rank with the padding


def test_padded_three_rank_step_params_and_running_stats(launches, jax_runs):
    results = launches(3)
    check_params_and_running_stats(jax_runs["padded"]["state0"], results[2]["fundus_pad"]["state0"], 2e-3)
    assert len({r["fundus_pad"]["digests"][0] for r in results}) == 1


# --- norms across ranks ----------------------------------------------------------------------


@pytest.mark.parametrize("case", list(NORM_CASES))
def test_norm_across_ranks_equals_one_process(launches, case):
    """Outputs, input gradients, running statistics of the ranks' real rows
    equal one process's on the concatenated rows; the affine gradients of the
    per-rank objectives add up to the one process's.  The input gradients
    show the statistics' all-reduce backward: each rank's rows get the
    gradient every rank's rows send through the shared statistics."""
    kw = NORM_CASES[case]
    one = ranks.norm_case(**kw)
    got = [r[case] for r in launches(4 if case.endswith("zero_rank") else 2)]
    halves = 2 if kw.get("dual") else 1
    # the ranks' real rows in the global order, half after half
    cat = lambda key: np.concatenate([np.split(g[key], halves)[h] for h in range(halves) for g in got])
    np.testing.assert_allclose(cat("y"), one["y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cat("grad_x"), one["grad_x"], rtol=1e-4, atol=1e-6)
    for k, want in one["grad_params"].items():
        np.testing.assert_allclose(sum(g["grad_params"][k] for g in got), want, rtol=1e-4, atol=1e-5, err_msg=k)
    for k, want in one["buffers"].items():
        for g in got:
            np.testing.assert_allclose(g["buffers"][k], want, rtol=1e-5, atol=1e-6, err_msg=k)
    if case.startswith("dsbn"):  # domain 3 has no real row anywhere: its statistics stay as they were
        assert np.array_equal(got[0]["buffers"]["bns.3.running_mean"], np.zeros(4, np.float32))
        assert np.array_equal(got[0]["buffers"]["bns.3.running_var"], np.ones(4, np.float32))


# --- the variants ------------------------------------------------------------------------


def _check_against_single(got, want, loss_rtol=1e-5):
    """step_parity's loss bound (chip_smoke.py): each loss within 1e-5 relative."""
    for k, w in want["metrics"][0].items():
        assert abs(got["metrics"][0][k] - w) <= loss_rtol * max(abs(w), 1e-6), (k, got["metrics"][0][k], w)


def test_prostate_padded_step(launches, data):
    """Prostate's binary head over 3 ranks (4 + 4 + 2 real rows, 2 padding
    rows, 5 DSBN domains, domain 2 straddling ranks 0 and 1) against the
    single-process step within step_parity's bounds: losses within 1e-5,
    parameters within 2.5 lr, statistics rtol 1e-4 / atol 1e-5."""
    single = _single(dict(cfg_kw=P_CFG, bsl=P_BSL, batches=[data["prostate"]], ratios=[data["p_ratio"]]))
    got = launches(3)[1]["prostate_pad"]
    _check_against_single(got, single)
    check_params_and_running_stats(single["state0"], got["state0"], 1e-3)


def test_gn_step(launches, data):
    """--norm gn: per-sample norms, only the losses and the DSBN restoration
    decoder reduce over the ranks; step_parity's bounds."""
    single = _single(dict(cfg_kw=dict(CFG, norm="gn"), bsl=BSL, batches=data["batches"][:1],
                          ratios=data["ratios"][:1]))
    got = launches(2)[0]["gn"]
    _check_against_single(got, single)
    check_params_and_running_stats(single["state0"], got["state0"], 2e-3)


def test_bf16_step(launches, sds, data):
    """bfloat16 at world 2 against world 1, within
    tests/test_torch_port_bf16.py's spread: each loss within 3e-2 relative,
    the total within 5e-3, the running statistics within 5% relative L2 and
    each module's change within 5% in size."""
    single = _single(dict(cfg_kw=dict(CFG, compute_dtype="bfloat16"), bsl=BSL, batches=data["batches"][:1],
                          ratios=data["ratios"][:1], sds=sds))
    got = launches(2)[0]["bf16"]
    for k, w in single["metrics"][0].items():
        assert abs(got["metrics"][0][k] - w) <= (5e-3 if k == "loss" else 3e-2) * max(abs(w), 1e-6), k
    flat = lambda sd, keys: np.concatenate([sd[k].ravel() for k in keys]).astype(np.float64)
    for n in NAMES:
        p0 = sds[n]
        params = [k for k in p0 if "running" not in k]
        da = flat(got["state0"][n], params) - flat(p0, params)
        db = flat(single["state0"][n], params) - flat(p0, params)
        assert abs(np.log(np.linalg.norm(da) / np.linalg.norm(db))) < np.log(1.05), n
        for suffix in ("running_mean", "running_var"):
            keys = [k for k in p0 if k.endswith(suffix)]
            a, b = flat(got["state0"][n], keys), flat(single["state0"][n], keys)
            assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.05, f"{n} {suffix}"


def test_remat_bit_equal_at_world_two(launches):
    """--remat re-issues the forward's collectives in the backward on every
    rank and changes no bit of the step."""
    for r in launches(2):
        assert r["fundus_remat"]["metrics"][0] == r["fundus"]["metrics"][0]
        assert r["fundus_remat"]["digests"][0] == r["fundus"]["digests"][0]


def test_fit_from_host_loaders_over_two_ranks(launches, fit_tree):
    """`fit` over 2 ranks from the thread loader (each rank builds its
    local_batch_slice of the rows) against `fit` in one process from the
    same seed: the logged losses, step 0 within the one-step bound and the
    later steps in the trajectory envelope; rank 0 alone wrote the run."""
    from ramdsir_tpu_torch.train.loop import fit

    single = fit(TrainConfig(**_fit_cfg(fit_tree, "single"), device="cpu"), max_steps=FIT_STEPS)
    rows = [json.loads(line) for line in (fit_tree / "single" / "log" / "metrics.jsonl").read_text().splitlines()]
    want = {r["step"]: r["loss/loss"] for r in rows if "loss/loss" in r}
    r0, r1 = (r["fit"] for r in launches(2))
    got = {int(k): v for k, v in r0["losses"].items()}
    assert sorted(got) == sorted(want) == list(range(FIT_STEPS))
    for step, w in want.items():
        assert abs(got[step] - w) <= (2e-4 if step == 0 else 1e-2) * abs(w), (step, got[step], w)
    assert r0["summary"]["steps"] == r1["summary"]["steps"] == single["steps"] == FIT_STEPS
    assert "losses" not in r1 and r1["summary"]["rank"] == 1
    run = fit_tree / "ddp"
    assert len((run / "3_val_log.csv").read_text().splitlines()) == 1
    for f in ("final_model.pth", "final_model.ckpt", "run_config.json"):
        assert (run / f).is_file(), f


# --- refusals --------------------------------------------------------------------------


def test_a_failing_rank_fails_the_launch_within_its_timeout():
    """Rank 1 raises while rank 0 waits in a barrier: the launch raises with
    rank 1's traceback well before the group's timeout, and no rank is left
    running."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed:[\s\S]*raises on purpose"):
        distributed.launch(ranks.raise_on_rank, 2, devices=["cpu"] * 2, args=(1,), timeout_s=60.0)
    assert time.perf_counter() - t0 < 60.0


def test_check_supported_refuses_only_what_cannot_run():
    check_supported(TrainConfig(**CFG, num_devices=2, device="cpu").resolve())
    check_supported(TrainConfig(**CFG, num_devices=16, device="cpu").resolve())
    with pytest.raises(ValueError, match="17 ranks for a global batch of 16"):
        check_supported(TrainConfig(**CFG, num_devices=17, device="cpu").resolve())
    with pytest.raises(ValueError, match="visible GPU"):
        check_supported(TrainConfig(**CFG, num_devices=max(2, torch.cuda.device_count() + 1), device="cuda").resolve())
    with pytest.raises(ValueError, match="one GPU a rank"):
        distributed.check_devices(["cuda:0", "cuda:0"], "nccl")
    with pytest.raises(ValueError, match="CUDA devices"):
        distributed.launch(ranks.raise_on_rank, 2, devices=["cpu"] * 2, backend="nccl", args=(1,))

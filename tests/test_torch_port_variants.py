"""The port's single-card training variants against the JAX package, on the
CPU with TF32 off (there is none on the CPU).

A U-Net of width 8 on both sides (the JAX package's `build_models` and the
port's, narrowed here), fundus batch 6 = 2 x 3, prostate 10 = 2 x 5, at 64^2
and, for the variant steps and the GN / IN forwards, 128^2.  Weights go
across through the port's `jax_params_to_torch`; batches are made with numpy
from seeds; the port is handed the RAM ratios the JAX step drew.  Each
variant's step is held, on each of four batch seeds, to the bounds of
tests/test_torch_port_step.py (metrics, gradients, params within 2.5*lr,
running statistics rtol 1e-4 / atol 1e-5):

- the prostate softmax head at C = 3 (`--num_classes 3`);
- `--norm gn` and `--norm in`, fundus and prostate;
- JAX's non-fused forwards (`fused_dual=False`, `fused_dsbn=False`), which
  the port accepts and runs as its one fused step;
- `--remat` against JAX's `remat=True`, and bit-equal to no remat in the port.

Besides: the GN / IN forwards in float32 and bfloat16, the C = 3 losses and
volume labels, `--global_batch`, GroupNorm weights through every checkpoint
format both ways, and `--trace_dir` / `--scan_window` through `fit`.
"""
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ramdsir_tpu.train.state as jstate_mod
import ramdsir_tpu_torch.train.state as tstate_mod
from ramdsir_tpu.config import TrainConfig as JConfig
from ramdsir_tpu.models import Decoder as JDecoder
from ramdsir_tpu.models import Encoder as JEncoder
from ramdsir_tpu.models import RecDecoder as JRecDecoder
from ramdsir_tpu.ops import losses as jlosses
from ramdsir_tpu.ops.ram import banded_amplitude_spectrum, sample_ram_ratios
from ramdsir_tpu.train import checkpoint as jcheckpoint
from ramdsir_tpu.train import evaluate as jeval
from ramdsir_tpu.train.state import init_state as jinit_state
from ramdsir_tpu.train.steps import make_predict_fn as jmake_predict_fn
from ramdsir_tpu.train.steps import make_train_step as jmake_train_step
from ramdsir_tpu.utils.torch_compat import import_torch_checkpoint
from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.models.norm import GroupNorm, InstanceNorm
from ramdsir_tpu_torch.models.unet import Decoder, Encoder, RecDecoder
from ramdsir_tpu_torch.ops import losses
from ramdsir_tpu_torch.train import checkpoint, evaluate
from ramdsir_tpu_torch.train.state import init_state, state_to_tree
from ramdsir_tpu_torch.train.steps import make_predict_fn, make_train_step
from ramdsir_tpu_torch.utils.torch_compat import export_torch_checkpoint, jax_params_to_torch, torch_to_jax_params
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)
from tests.test_torch_port_models import FEAT_TOL
from tests.test_torch_port_step import (
    NAMES,
    _np,
    _snapshot,
    _torch_layout,
    check_params_and_running_stats,
    check_step_gradients,
    check_step_metrics,
)

HW, N = 64, 8
STEP_HW = 128  # the variant steps and the GN / IN forwards: an 8x8 bottleneck
DATASETS = {
    "fundus": dict(bsl=[2, 2, 2], cfg=dict(dataset="fundus", domain_idxs=(0, 1, 2), test_domain_idx=0)),
    "prostate": dict(bsl=[2] * 5, cfg=dict(dataset="prostate", domain_idxs=(0, 1, 2, 3, 4), test_domain_idx=5)),
}
COMMON = dict(ram=True, rec=True, consistency=True, consistency_type="kd", image_size=HW, log_images_every=0)
SUP = {"fundus": "loss_bce", "prostate": "loss_ce"}


def metric_keys(dataset):
    sup = SUP[dataset]
    return (f"{sup}_1", "loss_dice_1", f"{sup}_2", "loss_dice_2", "loss_consistency", "loss_rec", "loss", "lr")


def jax_models(cfg):
    """The JAX package's `build_models` at width N, plain topology."""
    kw = dict(activation=cfg.activation, s2d_levels=0)
    models = {
        "encoder": JEncoder(c=cfg.in_channels, n=N, norm=cfg.norm, **kw),
        "seg_decoder": JDecoder(n=N, num_classes=cfg.num_classes, norm=cfg.norm, **kw),
    }
    if cfg.rec:
        models["rec_decoder"] = JRecDecoder(n=N, num_classes=cfg.in_channels, norm="dsbn",
                                            num_domains=cfg.num_domains, **kw)
    return models


def port_models(cfg):
    """The port's `build_models` at width N."""
    models = {
        "encoder": Encoder(c=cfg.in_channels, n=N, norm=cfg.norm, activation=cfg.activation),
        "seg_decoder": Decoder(n=N, num_classes=cfg.num_classes, norm=cfg.norm, activation=cfg.activation),
    }
    if cfg.rec:
        models["rec_decoder"] = RecDecoder(n=N, num_classes=cfg.in_channels, activation=cfg.activation,
                                           num_domains=cfg.num_domains)
    return models


def jax_state(jcfg, seed=0):
    with mock.patch.object(jstate_mod, "build_models", jax_models):
        return jinit_state(jcfg, jax.random.PRNGKey(seed))


def port_state(tcfg, jstate=None):
    """The port's state at width N, with `jstate`'s weights if given."""
    with mock.patch.object(tstate_mod, "build_models", port_models):
        state = init_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    if jstate is not None:
        sds = jax_params_to_torch(_np(jstate.params), _np(jstate.batch_stats))
        for name, m in state.models.items():
            m.load_state_dict(sds[name], strict=True)
    return state


def configs(dataset, hw=HW, **variant):
    base = {**DATASETS[dataset]["cfg"], **COMMON, "image_size": hw, **variant}
    return JConfig(**base).resolve(), TrainConfig(**base, device="cpu").resolve()


def host_batch(dataset, seed, num_classes=2, hw=HW):
    """A host batch as the JAX step takes it, donor bands precomputed."""
    rng = np.random.default_rng(seed)
    b = sum(DATASETS[dataset]["bsl"])
    if dataset == "fundus":
        img = rng.uniform(0, 255, (b, hw, hw, 3)).astype(np.float32)
        donor = rng.uniform(0, 255, (b, hw, hw, 3)).astype(np.float32)
        mask = (rng.uniform(size=(b, hw, hw, 2)) > 0.5).astype(np.float32)
    else:
        img = rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
        donor = rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
        mask = rng.integers(0, num_classes, (b, hw, hw)).astype(np.int32)
    return {"img": img, "mask": mask, "donor_amp": np.array(banded_amplitude_spectrum(jnp.asarray(donor)))}


def port_step(tcfg, tstate, batch, key, dataset):
    step = make_train_step(tcfg, total_iters=10, batch_size_list=DATASETS[dataset]["bsl"], debug_grads=True)
    ratio = torch.from_numpy(np.asarray(sample_ram_ratios(key, batch["img"].shape[0])))
    return step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, draws={"ratio": ratio})


# --- one step of each variant against the JAX package's -------------------------------

# (dataset, variant).  A JAX compile costs 10-25 s here, so the seven
# variants share four.  gn_fundus_unfused runs JAX's non-fused forwards
# against the port's one fused step.
VARIANTS = {
    "softmax3_gn": ("prostate", dict(num_classes=3, norm="gn")),
    "in_prostate_remat": ("prostate", dict(norm="in", remat=True)),
    "gn_fundus_unfused": ("fundus", dict(norm="gn", fused_dual=False, fused_dsbn=False)),
    "in_fundus": ("fundus", dict(norm="in")),
}
SEEDS = (100, 101, 102, 103)  # batch seeds, each variant on every one
PERTURBATIONS = 3  # port steps from weights moved by 1e-6 relative, for the float32 spread


@pytest.fixture(scope="module")
def variant_runs():
    """Lazily, one step of each variant on both sides from the same weights,
    batch and draws, for each batch seed; and a function giving the port's
    gradients from perturbed weights on that seed's batch."""
    done = {}

    def get(name):
        if name not in done:
            dataset, variant = VARIANTS[name]
            jcfg, tcfg = configs(dataset, STEP_HW, **variant)
            jstate, models = jax_state(jcfg)
            jstep = jmake_train_step(jcfg, models, total_iters=10, batch_size_list=DATASETS[dataset]["bsl"],
                                     debug_grads=True)
            key = jax.random.PRNGKey(11)
            seeds = {}
            for seed in SEEDS:
                batch = host_batch(dataset, seed, tcfg.num_classes, STEP_HW)
                tstate = port_state(tcfg, jstate)
                jstate2, jm, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
                tm = port_step(tcfg, tstate, batch, key, dataset)

                def perturbed(i, batch=batch):
                    state = port_state(tcfg, jstate)
                    gen = torch.Generator().manual_seed(i)
                    with torch.no_grad():
                        for m in state.models.values():
                            for p in m.parameters():
                                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=gen))
                    return port_step(tcfg, state, batch, key, dataset)["_grads"]

                seeds[seed] = dict(jax=jm, port=tm, params=_snapshot(jstate2, tstate), perturbed=perturbed)
            done[name] = dict(dataset=dataset, cfg=tcfg, seeds=seeds, jstate0=jstate, models=models)
        return done[name]

    return get


def _stray(err, tol):
    """test_step_gradients' two numbers for one tensor: the share of elements
    past `tol` and the largest error in units of `tol`."""
    return float(np.mean(err > tol)), float(err.max() / tol)


def check_variant_gradients(jax_grads, port_grads, perturbed):
    """check_step_gradients' rule.  A tensor that breaks it passes only where
    float32 cannot reproduce the port itself within the rule: the port's
    gradients from weights moved by 1e-6 relative (PERTURBATIONS draws, the
    largest difference per element) break it on that tensor, and the
    port-vs-JAX stray share and largest error lie within twice theirs.
    GN and IN over small maps divide by small per-sample deviations, which
    at 128^2 still puts up to 0.2% of an encoder conv's elements past the
    rule from the perturbation alone; a wrong term moves whole tensors."""
    try:
        check_step_gradients(jax_grads, port_grads)
        return
    except AssertionError as e:
        broken = str(e)
    jg = _torch_layout(jax_grads)
    spread = [{n: {k: v.numpy() for k, v in sd.items()} for n, sd in perturbed(i).items()}
              for i in range(PERTURBATIONS)]
    for name in NAMES:
        for k, want in jg[name].items():
            got = port_grads[name][k].numpy()
            tol = 3e-4 + 2e-2 * np.abs(want).max()
            frac, worst = _stray(np.abs(got - want), tol)
            if frac <= 1e-4 and worst <= 5:
                continue
            noise = np.max([np.abs(p[name][k] - got) for p in spread], axis=0)
            nfrac, nworst = _stray(noise, tol)
            assert frac <= max(1e-4, 2 * nfrac) and worst <= max(5, 2 * nworst), (
                f"{name}.{k}: stray share {frac:.2e}, max {worst:.2f} tol; the port's own spread "
                f"{nfrac:.2e}, {nworst:.2f} tol ({broken})")
    # the cosine of the rule, which no spread relaxes
    dots = norm_a = norm_b = 0.0
    for name in NAMES:
        for k, want in jg[name].items():
            got = port_grads[name][k].numpy().astype(np.float64)
            dots, norm_a, norm_b = dots + np.sum(got * want), norm_a + np.sum(got**2), norm_b + np.sum(want.astype(np.float64) ** 2)
    assert dots / np.sqrt(norm_a * norm_b) > 0.9999


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_step_metrics(variant_runs, name):
    run = variant_runs(name)
    for seed, one in run["seeds"].items():
        try:
            check_step_metrics(one["jax"], one["port"], metric_keys(run["dataset"]))
        except AssertionError as e:
            raise AssertionError(f"batch seed {seed}: {e}") from None


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_step_gradients(variant_runs, name):
    run = variant_runs(name)
    for seed, one in run["seeds"].items():
        try:
            check_variant_gradients(one["jax"]["_grads"], one["port"]["_grads"], one["perturbed"])
        except AssertionError as e:
            raise AssertionError(f"batch seed {seed}: {e}") from None


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_step_params_and_running_stats(variant_runs, name):
    """For GN and IN only the restoration decoder's DSBN has running
    statistics; the JAX package's vmapped dual forward and the port's flat
    one then move the same ones."""
    run = variant_runs(name)
    for seed, one in run["seeds"].items():
        jax_params, port_params = one["params"]
        stats = [k for sd in port_params.values() for k in sd if "running" in k]
        if run["cfg"].norm != "bn":
            assert stats and all(".bns." in k for k in stats)
        try:
            check_params_and_running_stats(jax_params, port_params, run["cfg"].lr)
        except AssertionError as e:
            raise AssertionError(f"batch seed {seed}: {e}") from None


def _state_dicts(state):
    return {f"{n}.{k}": v.detach().clone() for n, m in state.models.items() for k, v in m.state_dict().items()}


@pytest.mark.parametrize("dataset,variant", [("fundus", {}), ("prostate", {}), ("fundus", dict(norm="gn"))],
                         ids=["fundus", "prostate", "fundus_gn"])
def test_remat_bit_equal_to_no_remat(dataset, variant):
    """Two steps with and without --remat: parameters, running statistics
    (the recompute updates none) and Adam moments bit-equal, and the losses."""
    out = {}
    for remat in (False, True):
        _, tcfg = configs(dataset, remat=remat, **variant)
        state = port_state(tcfg)
        step = make_train_step(tcfg, total_iters=10, batch_size_list=DATASETS[dataset]["bsl"])
        metrics = []
        for i in range(2):
            batch = host_batch(dataset, 200 + i)
            ratio = sample_ram_ratios(jax.random.PRNGKey(i), sum(DATASETS[dataset]["bsl"]))
            draws = {"ratio": torch.from_numpy(np.asarray(ratio))}
            metrics.append({k: float(v) for k, v in step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                         draws=draws).items()})
        out[remat] = (metrics, state)
    (ma, a), (mb, b) = out[False], out[True]
    assert ma == mb
    sa, sb = _state_dicts(a), _state_dicts(b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa), [k for k in sa if not torch.equal(sa[k], sb[k])]
    pa = [p for m in a.models.values() for p in m.parameters()]
    pb = [p for m in b.models.values() for p in m.parameters()]
    for p, q in zip(pa, pb):
        x, y = a.optimizer.state[p], b.optimizer.state[q]
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)


# --- GN / IN forwards --------------------------------------------------------------------


FWD_B = 4


@pytest.fixture(scope="module")
def forwards(variant_runs):
    """Lazily, per (norm, dtype): the fundus gn / in variant's JAX encoder +
    seg decoder in train mode (jitted in float32; op by op in bfloat16, as
    the JAX package's own bf16 test runs it) and the port's, from the same
    weights and input: the bottleneck and the logits (NHWC float32 numpy)
    and the dtypes of the first norm's output and of the logits."""
    x = np.random.default_rng(2).normal(size=(FWD_B, STEP_HW, STEP_HW, 3)).astype(np.float32)
    done = {}

    def get(norm, dtype):
        if (norm, dtype) in done:
            return done[norm, dtype]
        run = variant_runs({"gn": "gn_fundus_unfused", "in": "in_fundus"}[norm])
        jenc, jdec = run["models"]["encoder"], run["models"]["seg_decoder"]
        params = run["jstate0"].params

        def jax_forward(xj):
            feats, inter = jenc.apply({"params": params["encoder"]}, xj, train=True, capture_intermediates=True)
            first = inter["intermediates"]["convd1"]["bn1"]["__call__"][0]
            return feats[-1], jdec.apply({"params": params["seg_decoder"]}, feats, train=True), first

        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        fwd = jax_forward if dtype == "bfloat16" else jax.jit(jax_forward)
        jlast, jlogits, jfirst = fwd(jnp.asarray(x).astype(jdt))
        enc, dec = Encoder(c=3, n=N, norm=norm), Decoder(n=N, num_classes=2, norm=norm)
        sds = jax_params_to_torch(_np(params), {})
        enc.load_state_dict(sds["encoder"], strict=True)
        dec.load_state_dict(sds["seg_decoder"], strict=True)
        seen = []
        enc.convd1.bn1.register_forward_hook(lambda mod, args, out: seen.append(out))
        tfeats = enc(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(getattr(torch, dtype)))
        tlogits = dec(tfeats)
        nhwc = lambda t: t.detach().float().numpy().transpose(0, 2, 3, 1)
        done[norm, dtype] = dict(
            jax=(np.asarray(jlast, np.float32), np.asarray(jlogits, np.float32)),
            port=(nhwc(tfeats[-1]), nhwc(tlogits)),
            jax_dtypes=(str(jfirst.dtype), str(jlogits.dtype)),
            port_dtypes=(str(seen[0].dtype).split(".")[-1], str(tlogits.dtype).split(".")[-1]),
        )
        return done[norm, dtype]

    return get


def _dist(a, b):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(d.max()), float(d.mean())


@pytest.mark.parametrize("norm", ["gn", "in"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_forward_matches_jax(forwards, norm, dtype):
    """float32: the bottleneck and the logits within the models' FEAT_TOL
    (torch's GroupNorm sums Welford's way, flax takes E[x^2] - E[x]^2).
    bfloat16: the dtypes match JAX's, GroupNorm returning float32 (so every
    later layer runs in float32), InstanceNorm bfloat16; the port lies
    within the spread of JAX's bfloat16 from its float32, as in
    tests/test_torch_port_bf16.py.  With GN it also lies within that test's
    absolute bounds (max 0.35, mean 0.05, tests/test_models.py:185-186,
    BN's), and so does IN's bottleneck.  IN's logits do not: the port lies
    max 1.45 / mean 0.10 from JAX there, JAX's own bfloat16 max 3.9 / mean
    0.29 from its float32 (the statistics over each sample's small maps
    amplify every one-ulp difference of a conv), so the logits are held to
    the spread only, and the norm itself bit-equal to JAX's in
    test_norm_layers_match_jax."""
    out = forwards(norm, dtype)
    if dtype == "float32":
        for got, want in zip(out["port"], out["jax"]):
            np.testing.assert_allclose(got, want, **FEAT_TOL)
        return
    want_dtypes = ("float32", "float32") if norm == "gn" else ("bfloat16", "bfloat16")
    assert out["jax_dtypes"] == out["port_dtypes"] == want_dtypes
    for got, want, w32 in zip(out["port"], out["jax"], forwards(norm, "float32")["jax"]):
        port, spread = _dist(got, want), _dist(want, w32)
        assert port[0] <= spread[0] and port[1] <= spread[1], (port, spread)
        if norm == "gn" or got is out["port"][0]:
            assert port[0] <= 0.35 and port[1] <= 0.05, (port, spread)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_layers_match_jax(dtype):
    """One norm on the same input: InstanceNorm as JAX's (bit-equal in
    bfloat16: the float32 statistics, then two roundings; within 1e-6 in
    float32), GroupNorm as flax's nn.GroupNorm(1) within 1e-5 and float32
    in both dtypes."""
    from flax import linen as fnn

    from ramdsir_tpu.models.norm import InstanceNorm as JInstanceNorm

    x = (np.random.default_rng(0).normal(size=(4, 8, 8, 16)) * 3 + 1).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(getattr(torch, dtype))
    nchw_to_nhwc = lambda t: t.detach().float().numpy().transpose(0, 2, 3, 1)
    jin = JInstanceNorm(16)
    want = np.asarray(jin.apply(jin.init(jax.random.PRNGKey(0), xj), xj).astype(jnp.float32))
    got = nchw_to_nhwc(InstanceNorm(16)(xt))
    np.testing.assert_allclose(got, want, rtol=0, atol=0 if dtype == "bfloat16" else 1e-6)
    jgn = fnn.GroupNorm(num_groups=1, epsilon=1e-5)
    want = jgn.apply(jgn.init(jax.random.PRNGKey(0), xj), xj)
    got = GroupNorm(16)(xt)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(want), rtol=0, atol=1e-5)


def test_per_sample_norms_refuse_dual_halves():
    for norm in (GroupNorm(4), InstanceNorm(4)):
        with pytest.raises(ValueError, match="per sample"):
            norm(torch.zeros(2, 4, 3, 3), dual=True)
    with pytest.raises(ValueError, match="not supported"):
        Encoder(norm="ln")


# --- the generic head's losses and labels -----------------------------------------------


def test_generic_head_losses_match_jax():
    """C = 3, ignore_index 0, class 2 absent from the target: cross-entropy,
    the per-class dice, KD (eps 1e-8) and MSE on softmax probabilities."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 16, 16, 3)).astype(np.float32) * 3
    other = rng.normal(size=(2, 16, 16, 3)).astype(np.float32) * 3
    target = rng.integers(0, 2, (2, 16, 16)).astype(np.int32)
    jp, jq = jax.nn.softmax(jnp.asarray(logits), -1), jax.nn.softmax(jnp.asarray(other), -1)
    tp, tq = torch.softmax(torch.from_numpy(logits), -1), torch.softmax(torch.from_numpy(other), -1)
    pairs = [
        (losses.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(target)),
         jlosses.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(target))),
        (losses.dice_loss_multi(tp, torch.from_numpy(target), 3, ignore_index=0),
         jlosses.dice_loss_multi(jp, jnp.asarray(target), 3, ignore_index=0)),
        (losses.kd_loss(tp, tq, eps=1e-8), jlosses.kd_loss(jp, jq, eps=1e-8)),
        (losses.mse_loss(tp, tq), jlosses.mse_loss(jp, jq)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


def test_volume_labels_at_three_classes_match_jax(variant_runs):
    """predict_volume's argmax labels of the softmax3_gn variant's C = 3
    head, label 2 among them, as JAX's, in both BN modes."""
    run = variant_runs("softmax3_gn")
    jcfg, tcfg = configs("prostate", **VARIANTS["softmax3_gn"][1])
    jstate, models = run["jstate0"], run["models"]
    tstate = port_state(tcfg, jstate)
    rng = np.random.default_rng(7)
    image = rng.uniform(-1, 1, (10, HW, HW)).astype(np.float32)
    mask = np.ones((10, HW, HW), np.int64)
    for bn_adapt in (False, True):
        got = evaluate.predict_volume(make_predict_fn(tcfg, tstate.models, bn_adapt=bn_adapt), image, mask, 4)
        want = jeval.predict_volume(jmake_predict_fn(jcfg, models, bn_adapt=bn_adapt), jstate, image, mask, 4)
        assert set(np.unique(want)) == {0.0, 1.0, 2.0}
        assert float(np.mean(got != want)) <= 1e-4


# --- --global_batch ------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, global_batch=48),
    dict(dataset="fundus", domain_idxs=(0, 2), test_domain_idx=3, global_batch=20),
    dict(dataset="prostate", domain_idxs=(0, 1, 2, 3, 4), test_domain_idx=5, global_batch=20),
    dict(dataset="fundus", domain_idxs=(0, 1, 2), test_domain_idx=3, global_batch=48, lr=1e-3),
    dict(dataset="prostate", domain_idxs=(0, 1, 2), test_domain_idx=4, global_batch=9),
], ids=["fundus48", "fundus2dom", "prostate20", "fundus_lr_given", "prostate3dom"])
def test_global_batch_matches_jax(case):
    """The even split and the LR scaled by global_batch / the table's batch
    (unless --lr is given), as the JAX TrainConfig; the train step's DSBN
    labels and the device pipeline's rows follow the split."""
    want, got = JConfig(**case).resolve(), TrainConfig(**case, device="cpu").resolve()
    assert got.batch_size_list == want.batch_size_list
    assert got.lr == pytest.approx(want.lr, rel=1e-12)


def test_global_batch_not_divisible_raises():
    for cfg in (JConfig(global_batch=16), TrainConfig(global_batch=16)):
        with pytest.raises(ValueError, match="divide by the 3 source domains"):
            cfg.batch_size_list


def test_global_batch_step_follows_the_split():
    """A --global_batch 12 step on the device pipeline: rows of 4 a domain,
    and the rec loss of each domain's rows under its own DSBN."""
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays

    cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, image_size=32,
                      global_batch=12, log_images_every=0, device="cpu").resolve()
    assert cfg.batch_size_list == [4, 4, 4] and cfg.lr == pytest.approx(2e-3 * 12 / 16)
    pipe = DeviceFundusPipeline.from_arrays(fundus_arrays(per_domain_train=8, size=32), cfg.domain_idxs,
                                            cfg.batch_size_list, cfg.test_domain_idx, seed=0, device="cpu")
    rows = list(pipe)
    assert len(rows) == 2 and all(r["img_idx"].shape == (12,) for r in rows)
    state = port_state(cfg)
    m = make_train_step(cfg, total_iters=10, batch_size_list=pipe.batch_sizes, device_data=pipe.device_data)(
        state, rows[0], torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in m.values())
    for bn in state.models["rec_decoder"].convu4.bn1.bns:  # each domain's bank moved
        assert bool(bn.running_mean.abs().sum() > 0)


# --- GroupNorm weights through the checkpoint formats --------------------------------


@pytest.fixture(scope="module")
def gn_states(variant_runs):
    """The gn_fundus_unfused variant's JAX state (its modules are those of
    every fundus --norm gn run) with weights moved off their init, and the
    port's state from it."""
    run = variant_runs("gn_fundus_unfused")
    jstate0, models = run["jstate0"], run["models"]
    moved = lambda p: jnp.asarray(np.asarray(p) + 0.01 * np.arange(p.size, dtype=np.float32).reshape(p.shape) / p.size)
    params = jax.tree.map(moved, jstate0.params)
    jstate = jstate0.replace(params=params)
    return run["cfg"], jstate0, jstate, models, port_state(run["cfg"], jstate)


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_groupnorm_weights_round_trip(gn_states):
    """jax_params_to_torch -> torch_to_jax_params gives the JAX trees back,
    GroupNorm_0 entries included and no entry for InstanceNorm."""
    _, _, jstate, _, tstate = gn_states
    params, stats = torch_to_jax_params(tstate.models)
    assert "GroupNorm_0" in params["encoder"]["convd1"]["bn1"]
    assert "scale" in params["encoder"]["convd1"]["bn1"]["GroupNorm_0"]
    _assert_tree_equal(params, _np(jstate.params))
    _assert_tree_equal(stats, _np(jstate.batch_stats))
    ins = Encoder(n=N, norm="in")
    p, s = torch_to_jax_params({"encoder": ins})
    assert set(p["encoder"]["convd1"]) == {"conv1", "conv2", "conv3"} and not any(s["encoder"].values())


def test_groupnorm_checkpoints_interchange(gn_states, tmp_path):
    """A JAX --norm gn .ckpt loads into the port; the port's .ckpt and .pth
    load into the JAX package (into a template holding other weights); every
    tensor equal, and the logits."""
    tcfg, template, jstate, models, tstate = gn_states
    jcheckpoint.save_checkpoint(str(tmp_path / "jax.ckpt"), jstate)
    fresh = port_state(tcfg)
    checkpoint.load_checkpoint(str(tmp_path / "jax.ckpt"), fresh)
    _assert_tree_equal(state_to_tree(fresh)["params"], _np(jstate.params))

    checkpoint.save_checkpoint(str(tmp_path / "port.ckpt"), tstate)
    loaded, _ = jcheckpoint.load_checkpoint(str(tmp_path / "port.ckpt"), template)
    _assert_tree_equal(_np(loaded.params), _np(jstate.params))
    export_torch_checkpoint(str(tmp_path / "port.pth"), tstate.models)
    from_pth = import_torch_checkpoint(str(tmp_path / "port.pth"), template)
    _assert_tree_equal(_np(from_pth.params), _np(jstate.params))

    @jax.jit
    def logits(params, x):
        feats = models["encoder"].apply({"params": params["encoder"]}, x, train=True)
        return models["seg_decoder"].apply({"params": params["seg_decoder"]}, feats, train=True)

    x = np.random.default_rng(3).normal(size=(2, HW, HW, 3)).astype(np.float32)
    want = np.asarray(logits(jstate.params, x))
    for state in (loaded, from_pth):
        np.testing.assert_array_equal(np.asarray(logits(state.params, x)), want)
    got = fresh.models["seg_decoder"](fresh.models["encoder"](torch.from_numpy(x.transpose(0, 3, 1, 2).copy())))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), want, **FEAT_TOL)


# --- --trace_dir and --scan_window through fit --------------------------------------------


def test_trace_dir_and_scan_window_leave_the_run_unchanged(tmp_path):
    """fit for 4 steps with --scan_window 1 (a step at a time, the per-step
    reference), as it is (the default window: all 4 steps), with
    --trace_dir (the default window, which holds step 2 and is the run's
    last: the trace is of steps 0-3) and with --scan_window 4: the final
    states and the logged losses bit-equal to the per-step run's; the trace
    is a Chrome trace of the steps' ops and the port's spans."""
    import json

    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.synthetic import fundus_arrays, fundus_test_samples
    from ramdsir_tpu_torch.train.loop import fit

    arrays = fundus_arrays(per_domain_train=8, size=32)
    testset = fundus_test_samples(num=2, size=40, image_size=32, seed=1)
    runs = {}
    for name, extra in (("per_step", dict(scan_window=1)), ("plain", {}), ("trace", dict(trace_dir=str(tmp_path / "trace"))),
                        ("scan", dict(scan_window=4))):
        cfg = TrainConfig(dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, image_size=32, epochs=1,
                          test_batch_size=2, save_path=str(tmp_path / name), device="cpu", **extra)
        pipe = DeviceFundusPipeline.from_arrays(arrays, cfg.domain_idxs, [2, 2, 2], cfg.test_domain_idx,
                                                seed=cfg.seed, device="cpu")
        with mock.patch.object(tstate_mod, "build_models", port_models):
            summary = fit(cfg, max_steps=4, pipeline=pipe, testset=testset)
        rows = [json.loads(ln) for ln in open(tmp_path / name / "log" / "metrics.jsonl")]
        runs[name] = (summary, [r for r in rows if "loss/loss" in r],
                      checkpoint.read_checkpoint(summary["resume_checkpoint"])["state"])
    plain, per_step = runs["plain"], runs["per_step"]
    assert [runs[n][0]["scan_window"] for n in ("per_step", "plain", "trace", "scan")] == [1, 4, 4, 4]
    drop_time = lambda rows: [{k: v for k, v in r.items() if k != "t"} for r in rows]
    for name in ("plain", "trace", "scan"):
        assert drop_time(runs[name][1]) == drop_time(per_step[1]), name
        _assert_tree_equal(runs[name][2], per_step[2])
    path = runs["trace"][0]["trace"]
    assert os.path.dirname(path) == str(tmp_path / "trace") and os.path.basename(path) == "trace_steps_0-3.json"
    events = json.load(open(path))["traceEvents"]
    assert any("convolution" in str(e.get("name", "")) for e in events)
    assert sum(e.get("name") == "ramdsir.train.eager" for e in events) == 4
    assert "trace" not in plain[0]

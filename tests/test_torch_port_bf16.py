"""The port's bfloat16 path (--compute_dtype / predict_dtype bfloat16)
against the JAX package's, on the CPU.

Weights go across through the port's `jax_params_to_torch`; inputs are made
with numpy from seeds; U-Net n=16.  Three comparisons:

- the encoder + seg-decoder forward in train mode at 64^2, batch 8, against
  the JAX modules applied op by op (as `tests/test_models.py:170-186` runs
  them).  The port rounds where JAX rounds (models/unet.py, models/norm.py);
- one RAM-DSIR step on the device pipeline, fundus and prostate, against
  the jitted JAX step, with the JAX draws injected;
- the predictor in both BN modes with a padded tail, against the jitted JAX
  predictor.

Any two bfloat16 runs of this U-Net part by about as much as bfloat16 does
from float32: a one-ulp difference (a conv summed in another order, XLA
fusing an elementwise chain and rounding once) grows through the BN layers.
The jitted JAX forward lies max 0.27 from the op-by-op one at 64^2, about
its distance from float32.  So each bound is the spread of JAX's bfloat16
from JAX's float32, measured here on the same input, or a stated number
derived from it.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ramdsir_tpu.config import TrainConfig as JConfig
from ramdsir_tpu.models import Decoder as JDecoder
from ramdsir_tpu.models import Encoder as JEncoder
from ramdsir_tpu.ops.ram import sample_ram_ratios
from ramdsir_tpu.train.state import init_state as jinit_state
from ramdsir_tpu.train.steps import make_predict_fn as jmake_predict_fn
from ramdsir_tpu.train.steps import make_train_step as jmake_train_step
from ramdsir_tpu.utils.torch_compat import flax_module_to_torch_sd
from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.models.unet import Decoder, Encoder
from ramdsir_tpu_torch.ops import cuda_build
from ramdsir_tpu_torch.train.steps import make_predict_fn, make_train_step
from ramdsir_tpu_torch.utils.torch_compat import jax_params_to_torch
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)
from tests.test_torch_port_step import _np, _port_state, _snapshot, _torch_layout

N = 16


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _dist(a, b):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return float(d.max()), float(d.mean())


# --- the forward ----------------------------------------------------------------

FWD_HW, FWD_B = 64, 8


@pytest.mark.parametrize("s2d", [0, 2], ids=["s2d0", "s2d2"])
def test_forward_bf16_matches_jax(s2d):
    """Measured at s2d_levels=0, 64^2, batch 8: JAX's bfloat16 bottleneck
    lies max 0.332 / mean 0.026 from its float32 one (logits: max 3.86 /
    mean 0.36), the port's lies max 0.122 / mean 0.009 from JAX's bfloat16
    (logits: 2.24 / 0.14); the two libraries sum a conv in different
    orders, and each one-ulp flip grows through the BN layers.  With one
    rounding per norm and per conv (cuDNN's fused BN) the port lay max
    0.363 / mean 0.029 from JAX's bfloat16, past the spread and past the
    JAX package's bound, so it rounds as JAX does (models/norm.py).  The
    port must lie within the spread, and within the JAX package's own
    bounds (max 0.35, mean 0.05).
    At s2d_levels=2 JAX's packed convs sum in another order, so only its
    bounds hold."""
    jenc, jdec = JEncoder(c=3, n=N, s2d_levels=s2d), JDecoder(n=N, num_classes=2, s2d_levels=s2d)
    x0 = jnp.zeros((1, FWD_HW, FWD_HW, 3))
    ev = jenc.init(jax.random.PRNGKey(1), x0, train=False)
    dv = jdec.init(jax.random.PRNGKey(2), jenc.apply(ev, x0, train=False), train=False)
    x = np.random.default_rng(2).normal(size=(FWD_B, FWD_HW, FWD_HW, 3)).astype(np.float32)

    def jax_forward(dtype):  # op by op, as the JAX package's own bf16 test
        feats, es = jenc.apply(ev, jnp.asarray(x).astype(dtype), train=True, mutable=["batch_stats"])
        logits, ds = jdec.apply(dv, feats, train=True, mutable=["batch_stats"])
        return feats[-1], logits, es["batch_stats"], ds["batch_stats"]

    j32, j16 = jax_forward(jnp.float32), jax_forward(jnp.bfloat16)
    assert j16[0].dtype == j16[1].dtype == jnp.bfloat16
    enc, dec = Encoder(c=3, n=N, s2d_levels=s2d), Decoder(n=N, num_classes=2, s2d_levels=s2d)
    for m, v in ((enc, ev), (dec, dv)):
        m.load_state_dict(jax_params_to_torch({"m": _np(v["params"])}, {"m": _np(v["batch_stats"])})["m"])
        m.train()
    feats = enc(_nchw(x).to(torch.bfloat16))
    logits = dec(feats)
    assert all(f.dtype == torch.bfloat16 for f in feats) and logits.dtype == torch.bfloat16
    for m in (enc, dec):
        assert all(p.dtype == torch.float32 for p in m.parameters())
        assert all(b.dtype == torch.float32 for b in m.buffers())
    got = (feats[-1].detach().float().numpy().transpose(0, 2, 3, 1),
           logits.detach().float().numpy().transpose(0, 2, 3, 1))
    spread = _dist(j16[0], j32[0])
    port = _dist(got[0], j16[0])
    assert port[0] <= 0.35 and port[1] <= 0.05, (port, spread)  # tests/test_models.py:185-186
    if s2d:
        return
    assert port[0] <= spread[0] and port[1] <= spread[1], (port, spread)
    lspread, lport = _dist(j16[1], j32[1]), _dist(got[1], j16[1])
    assert lport[0] <= lspread[0] and lport[1] <= lspread[1], (lport, lspread)
    # the running statistics moved as JAX's did, from float32 statistics of
    # activations that part as above: within 5% relative L2 a layer
    for m, stats in ((enc, j16[2]), (dec, j16[3])):
        for k, v in flax_module_to_torch_sd({}, _np(stats)).items():
            got_k = m.state_dict()[k].numpy()
            assert np.linalg.norm(got_k - v) / np.linalg.norm(v) < 0.05, k


# --- one train step -----------------------------------------------------------------

STEP_HW = 32
STEPS = {
    "fundus": dict(bsl=[2, 2, 2], cfg=dict(dataset="fundus", domain_idxs=(0, 1, 2), test_domain_idx=3,
                                           is_out_domain=True)),
    "prostate": dict(bsl=[2] * 5, cfg=dict(dataset="prostate", domain_idxs=(0, 1, 2, 3, 4), test_domain_idx=5)),
}
COMMON = dict(ram=True, rec=True, consistency=True, consistency_type="kd", image_size=STEP_HW, log_images_every=0)
METRIC_KEYS = {
    "fundus": ("loss_bce_1", "loss_dice_1", "loss_bce_2", "loss_dice_2", "loss_consistency", "loss_rec", "loss"),
    "prostate": ("loss_ce_1", "loss_dice_1", "loss_ce_2", "loss_dice_2", "loss_consistency", "loss_rec", "loss"),
}


def _pipelines(root, dataset, bsl, cfg):
    """The JAX and the port's device pipelines over one synthetic tree, the
    port given JAX's donor bands (the two FFTs differ at ~1e-6)."""
    if dataset == "fundus":
        from ramdsir_tpu.data.device_pipeline import DeviceFundusPipeline as JPipeline
        from ramdsir_tpu.data.fundus import FundusMultiDataset as JDataset
        from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
        from ramdsir_tpu_torch.data.fundus import FundusMultiDataset
        from ramdsir_tpu_torch.data.synthetic import make_fundus_tree

        base = make_fundus_tree(root, per_domain_train=4, per_domain_test=1, size=40)
        jds = [JDataset(base, [d], test_domain_idx=3, resize_to=STEP_HW) for d in cfg["domain_idxs"]]
        jp = JPipeline(jds, bsl, base, STEP_HW, 3, is_out_domain=True, seed=7)
        tds = [FundusMultiDataset(base, [d]) for d in cfg["domain_idxs"]]
        tp = DeviceFundusPipeline.from_tree(tds, bsl, base, STEP_HW, 3, is_out_domain=True, seed=7, device="cpu")
    else:
        from ramdsir_tpu.data.device_pipeline import DeviceProstatePipeline as JPipeline
        from ramdsir_tpu.data.prostate import ProstateMultiDataset as JDataset
        from ramdsir_tpu_torch.data.device_pipeline import DeviceProstatePipeline
        from ramdsir_tpu_torch.data.prostate import ProstateMultiDataset
        from ramdsir_tpu_torch.data.synthetic import make_prostate_tree

        make_prostate_tree(root, per_domain=4, size=STEP_HW, seed=3)
        base = os.path.join(root, "prostate")
        jds = [JDataset(base, [d], test_domain_idx=5) for d in cfg["domain_idxs"]]
        jp = JPipeline(jds, bsl, base, 5, is_out_domain=False, seed=7)
        tds = [ProstateMultiDataset(base, [d]) for d in cfg["domain_idxs"]]
        tp = DeviceProstatePipeline.from_tree(tds, bsl, base, 5, is_out_domain=False, seed=7, device="cpu")
    tp.device_data["donor_amp"] = torch.from_numpy(np.array(jp.device_data["donor_amp"]))
    return jp, tp


def _draws(key, dataset, b):
    """The JAX device-data step's draws (`_gather_step`: the key is split
    before the gather; the scale-crop splits the first half three ways, RAM
    draws from the second)."""
    k_aug, k_step = jax.random.split(key)
    draws = {"ratio": torch.from_numpy(np.array(sample_ram_ratios(k_step, b)))}
    if dataset == "fundus":
        k_apply, k_f, k_off = jax.random.split(k_aug, 3)
        draws["crop_apply"] = torch.from_numpy(np.array(jax.random.bernoulli(k_apply, 0.5, (b,))))
        draws["crop_u"] = torch.from_numpy(np.array(jax.random.uniform(k_f, (b, 2), minval=1.0, maxval=1.5)))
        draws["crop_off"] = torch.from_numpy(np.array(jax.random.uniform(k_off, (b, 2))))
    return draws


@pytest.fixture(scope="module", params=["fundus", "prostate"])
def step_run(request, tmp_path_factory):
    """One step from the same JAX init state and index row: JAX in float32
    and in bfloat16, the port in bfloat16."""
    dataset = request.param
    bsl, extra = STEPS[dataset]["bsl"], STEPS[dataset]["cfg"]
    jp, tp = _pipelines(str(tmp_path_factory.mktemp(dataset)), dataset, bsl, extra)
    row = next(iter(tp))
    key = jax.random.PRNGKey(11)
    out = {"dataset": dataset, "jax": {}}
    jstate0 = models = None
    for dtype in ("float32", "bfloat16"):
        jcfg = JConfig(**COMMON, **extra, compute_dtype=dtype).resolve()
        if jstate0 is None:
            jstate0, models = jinit_state(jcfg, jax.random.PRNGKey(0))
        jstep = jmake_train_step(jcfg, models, total_iters=10, batch_size_list=bsl, device_data=jp.device_data)
        jstate, jm, _ = jstep(jstate0, {k: jnp.asarray(v) for k, v in row.items()}, key, jp.device_data)
        out["jax"][dtype] = (jm, jstate)
    tcfg = TrainConfig(**COMMON, **extra, compute_dtype="bfloat16", device="cpu").resolve()
    tstate = _port_state(tcfg, jstate0)
    step = make_train_step(tcfg, total_iters=10, batch_size_list=bsl, device_data=tp.device_data)
    out["port"] = step(tstate, row, draws=_draws(key, dataset, sum(bsl)))
    out["state0"] = _torch_layout(jstate0.params)
    out["params"] = {dtype: _snapshot(js, tstate) for dtype, (_, js) in out["jax"].items()}
    out["tstate"], out["cfg"] = tstate, tcfg
    return out


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)


def test_bf16_step_metrics(step_run):
    """Each loss of the port's bfloat16 step within 3e-2 relative of the JAX
    step's, the total within 5e-3 (measured: JAX's bfloat16 step lies up to
    4.1e-2 from its float32 one by term and 2.4e-3 in total, the port up to
    1.8e-2 and 2.4e-3 from JAX's bfloat16); the lr exact, no K1 launch on
    the CPU."""
    j16, tm = step_run["jax"]["bfloat16"][0], step_run["port"]
    assert set(tm) == set(j16)
    for k in METRIC_KEYS[step_run["dataset"]]:
        assert _rel(tm[k], j16[k]) <= (5e-3 if k == "loss" else 3e-2), (k, float(tm[k]), float(j16[k]))
        assert np.isfinite(float(tm[k])) and tm[k].dtype == torch.float32
    assert float(tm["lr"]) == pytest.approx(float(j16["lr"]), rel=1e-7)
    assert step_run["tstate"].step == 1
    assert not any(cuda_build.launch_counts().values())  # the plain version served the CPU tensors


def test_bf16_step_params_and_running_stats(step_run):
    """After Adam, with the envelope rule of
    tests/test_torch_port_step.py::test_trajectory.  One step from equal
    weights moves each element by about lr*sign(g), and bfloat16's gradient
    noise turns many of those signs: JAX's bfloat16 change has a cosine of
    only 0.53 (encoder), 0.70 (seg decoder) and 0.23 (rec decoder) with its
    float32 change, the port's 0.56, 0.72 and 0.25 with JAX's bfloat16 one.
    So per module the port's cosine with JAX's bfloat16 change must be
    within 0.1 of that spread's, the size of the change within 5% (measured
    0.05%: a wrong group factor or lr doubles or halves it), the running
    statistics within 5% relative L2 (measured up to 2.4%, spread 2.6%);
    every parameter and statistic float32."""
    jax32, _ = step_run["params"]["float32"]
    jax_params, port_params = step_run["params"]["bfloat16"]
    flat = lambda sd, keys: np.concatenate([sd[k].ravel() for k in keys]).astype(np.float64)
    cos = lambda a, b: a @ b / np.sqrt((a @ a) * (b @ b))
    for name in port_params:
        p0 = step_run["state0"][name]
        change = lambda sd: flat(sd, p0) - flat(p0, p0)
        da, db = change(port_params[name]), change(jax_params[name])
        assert cos(da, db) > cos(db, change(jax32[name])) - 0.1, name
        assert abs(np.log(np.linalg.norm(da) / np.linalg.norm(db))) < np.log(1.05), name
        for suffix in ("running_mean", "running_var"):
            keys = [k for k in jax_params[name] if k.endswith(suffix)]
            a, b = flat(port_params[name], keys), flat(jax_params[name], keys)
            assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.05, f"{name} {suffix}"
    for m in step_run["tstate"].models.values():
        assert all(t.dtype == torch.float32 for t in m.state_dict().values())


# --- the predictor ----------------------------------------------------------------

PRED_HW, PRED_B, TAIL = 32, 8, 3


@pytest.fixture(scope="module")
def pred_weights():
    """Per dataset: the JAX state with calibrated running statistics, the
    JAX predictors (float32, bfloat16) of both BN modes, the port's
    modules."""
    from tests.test_torch_port_eval import _calibrated
    from ramdsir_tpu_torch.train.state import build_models

    out = {}
    for dataset in ("fundus", "prostate"):
        jcfg = JConfig(dataset=dataset, image_size=PRED_HW, rec=False, ram=False).resolve()
        state, models = jinit_state(jcfg, jax.random.PRNGKey(0))
        state = _calibrated(jcfg, state, models, np.random.default_rng(10))
        jpred = {(dt, bn): jmake_predict_fn(JConfig(**{**jcfg.__dict__, "predict_dtype": dt}), models, bn_adapt=bn)
                 for dt in ("float32", "bfloat16") for bn in (False, True)}
        tcfg = TrainConfig(dataset=dataset, image_size=PRED_HW, rec=False, ram=False, predict_dtype="bfloat16",
                           device="cpu").resolve()
        tmodels = build_models(tcfg)
        sd = jax_params_to_torch(_np(state.params), _np(state.batch_stats))
        for name, m in tmodels.items():
            m.load_state_dict(sd[name], strict=True)
            m.train()
        out[dataset] = (state, jpred, tcfg, tmodels)
    return out


@pytest.mark.parametrize("bn_adapt", [False, True])
@pytest.mark.parametrize("dataset", ["fundus", "prostate"])
def test_bf16_predict_matches_jax(pred_weights, dataset, bn_adapt):
    """float32 probabilities from the bfloat16 forward, a full batch of 8
    and a tail of 3 (JAX pads it to 8 with n_valid=3): within the JAX
    predictor's own bfloat16-vs-float32 spread in the mean, within 1.25
    times it in the max.  Measured at 32^2: the spread max 0.38-0.68 / mean
    0.026-0.048; the port's distance from JAX's bfloat16 max 0.06-0.23 /
    mean 0.004-0.008 with the running statistics and max 0.33-0.59 / mean
    0.022-0.030 with BN adaptation, whose batch statistics carry each
    one-ulp difference to every pixel (the max one pixel's flip, at 1.003
    times the spread)."""
    state, jpred, tcfg, tmodels = pred_weights[dataset]
    rng = np.random.default_rng(5)
    if dataset == "fundus":
        img = rng.integers(0, 256, (PRED_B, PRED_HW, PRED_HW, 3)).astype(np.float32)
    else:
        img = rng.uniform(-1, 1, (PRED_B, PRED_HW, PRED_HW, 3)).astype(np.float32)
    predict = make_predict_fn(tcfg, tmodels, bn_adapt=bn_adapt)
    padded = np.concatenate([img[:TAIL], np.zeros_like(img[TAIL:])])
    for batch, n_valid, got in ((img, None, predict(img)), (padded, TAIL, predict(img[:TAIL]))):
        assert got.dtype == torch.float32
        got = got.numpy().transpose(0, 2, 3, 1)
        kw = {} if n_valid is None else {"n_valid": n_valid}
        rows = slice(None) if n_valid is None else slice(0, TAIL)
        want16 = np.asarray(jpred[("bfloat16", bn_adapt)](state, batch, **kw))[rows]
        want32 = np.asarray(jpred[("float32", bn_adapt)](state, batch, **kw))[rows]
        assert want16.dtype == np.float32
        spread, port = _dist(want16, want32), _dist(got, want16)
        assert port[0] <= 1.25 * spread[0] and port[1] <= spread[1], (port, spread)

"""The port's norms and U-Net modules against the JAX package on the CPU.

Weights go across through the port's `jax_params_to_torch`; inputs are made
with numpy from a seed.  Modules run at n=8 on 32^2 inputs.  The JAX models
are built with s2d_levels 0 and 2 (the JAX package pins 2 equal to 0; the
port always runs the plain topology).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ramdsir_tpu.models import Decoder as JDecoder
from ramdsir_tpu.models import Encoder as JEncoder
from ramdsir_tpu.models import RecDecoder as JRecDecoder
from ramdsir_tpu.models.norm import BatchNorm as JBatchNorm
from ramdsir_tpu.models.norm import DomainSpecificBatchNorm as JDSBN
from ramdsir_tpu.utils.torch_compat import flax_module_to_torch_sd
from ramdsir_tpu_torch.models.norm import BatchNorm, DomainSpecificBatchNorm
from ramdsir_tpu_torch.models.unet import Decoder, Encoder, RecDecoder
from ramdsir_tpu_torch.utils.torch_compat import jax_params_to_torch
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

N, HW = 8, 32
# float32 convolutions by two libraries (XLA, oneDNN) summed in different
# orders, compounded through 5 BN-normalised stages (tests/test_torch_parity.py)
FEAT_TOL = dict(atol=5e-4, rtol=1e-3)
# running statistics are means of those activations
STAT_TOL = dict(atol=1e-5, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables):
    sd = jax_params_to_torch({"m": _np(variables["params"])}, {"m": _np(variables.get("batch_stats", {}))})["m"]
    module.load_state_dict(sd, strict=True)
    return module


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _assert_nhwc(got_nchw, want_nhwc, **tol):
    np.testing.assert_allclose(got_nchw.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want_nhwc), **tol)


def _assert_stats(module, stats, **tol):
    """The port's running statistics against the JAX batch_stats tree."""
    want = flax_module_to_torch_sd({}, _np(stats))
    got = module.state_dict()
    assert want, "no statistics to compare"
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, err_msg=k, **tol)


# --- norms -------------------------------------------------------------------


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("n_valid", [None, 3])
def test_batchnorm_train_matches_jax(dual, n_valid):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(10, 5, 6, 4)) * 2.0 + 0.5).astype(np.float32)
    jbn = JBatchNorm(4, dual=dual)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=True)
    v = {"params": {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 4), jnp.float32),
                    "bias": jnp.asarray(rng.normal(size=4), jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(rng.normal(size=4), jnp.float32),
                         "var": jnp.asarray(rng.uniform(0.5, 2, 4), jnp.float32)}}
    want, mut = jbn.apply(v, jnp.asarray(x), use_running_average=False, n_valid=n_valid, mutable=["batch_stats"])

    bn = BatchNorm(4)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.array(v["params"]["scale"])))
        bn.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        bn.running_mean.copy_(torch.from_numpy(np.array(v["batch_stats"]["mean"])))
        bn.running_var.copy_(torch.from_numpy(np.array(v["batch_stats"]["var"])))
    got = bn.train()(_nchw(x), dual=dual, n_valid=n_valid)
    _assert_nhwc(got, want, atol=2e-5, rtol=1e-5)  # one normalisation: float32 rounding
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), atol=1e-6, rtol=1e-5)

    # eval normalises with the updated running statistics
    want_eval = jbn.apply({**v, **mut}, jnp.asarray(x), use_running_average=True)
    _assert_nhwc(bn.eval()(_nchw(x)), want_eval, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["scalar", "segment", "segment_shuffled"])
def test_dsbn_matches_jax(mode):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(7, 4, 4, 6)) * 1.5 - 0.3).astype(np.float32)
    domain = {
        "scalar": 2,
        "segment": np.array([0, 0, 1, 1, 1, 2, 2]),
        "segment_shuffled": np.array([2, 0, 1, 0, 2, 1, 1]),
    }[mode]
    jdsbn = JDSBN(6, 3)
    v = jdsbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.int32(0), use_running_average=True)
    v = {"params": {"scale": jnp.asarray(rng.uniform(0.5, 1.5, (3, 6)), jnp.float32),
                    "bias": jnp.asarray(rng.normal(size=(3, 6)), jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(rng.normal(size=(3, 6)), jnp.float32),
                         "var": jnp.asarray(rng.uniform(0.5, 2, (3, 6)), jnp.float32)}}
    jdom = jnp.asarray(domain, jnp.int32)
    want, mut = jdsbn.apply(v, jnp.asarray(x), jdom, use_running_average=False, mutable=["batch_stats"])

    # the converter names a bank by its parent: hold the DSBN as `bn`
    holder = torch.nn.Module()
    holder.bn = DomainSpecificBatchNorm(6, 3)
    _load(holder, _wrap(v))
    got = holder.bn.train()(_nchw(x), domain)
    _assert_nhwc(got, want, atol=2e-5, rtol=1e-5)  # one normalisation: float32 rounding
    _assert_stats(holder, _wrap(mut)["batch_stats"], atol=1e-6, rtol=1e-5)
    want_eval = jdsbn.apply({**v, **mut}, jnp.asarray(x), jdom, use_running_average=True)
    _assert_nhwc(holder.bn.eval()(_nchw(x), domain), want_eval, atol=2e-5, rtol=1e-5)


def _wrap(variables):
    """A bare DSBN's variables as the tree of a module `bn` holding it."""
    return {k: {"bn": {"DomainSpecificBatchNorm_0": v}} for k, v in variables.items()}


# --- U-Net modules -----------------------------------------------------------


@pytest.fixture(scope="module", params=[0, 2], ids=["s2d0", "s2d2"])
def unet(request):
    s2d = request.param
    jenc = JEncoder(c=3, n=N, s2d_levels=s2d)
    jdec = JDecoder(n=N, num_classes=2, s2d_levels=s2d)
    jrec = JRecDecoder(n=N, num_classes=3, num_domains=3, s2d_levels=s2d)
    x0 = jnp.zeros((1, HW, HW, 3))

    @jax.jit
    def init_all():
        ev = jenc.init(jax.random.PRNGKey(1), x0, train=False)
        feats0 = jenc.apply(ev, x0, train=False)
        dv = jdec.init(jax.random.PRNGKey(2), feats0, train=False)
        rv = jrec.init(jax.random.PRNGKey(3), feats0[-1], domain=jnp.int32(0), train=False)
        return ev, dv, rv

    ev, dv, rv = init_all()
    # distinguishable DSBN banks
    rv = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 * jnp.arange(3, dtype=a.dtype)[:, None] if a.ndim == 2 else a, rv
    )
    enc = _load(Encoder(c=3, n=N, s2d_levels=s2d), ev)
    dec = _load(Decoder(n=N, num_classes=2, s2d_levels=s2d), dv)
    rec = _load(RecDecoder(n=N, num_classes=3, num_domains=3, s2d_levels=s2d), rv)
    return dict(jenc=jenc, jdec=jdec, jrec=jrec, ev=ev, dv=dv, rv=rv, enc=enc, dec=dec, rec=rec)


def test_state_dicts_load_strict(unet):
    for name in ("enc", "dec", "rec"):
        m = unet[name]
        sd = {k: v.clone() for k, v in m.state_dict().items()}
        m.load_state_dict(sd, strict=True)
    assert "convd1.bn1.running_mean" in unet["enc"].state_dict()
    assert "convu4.bn1.bns.0.weight" in unet["rec"].state_dict()


def _seg_forward(jenc, jdec, train, dual=False):
    """The JAX encoder + seg decoder as one jitted program (compiles once)."""
    jenc, jdec = jenc.clone(dual=dual), jdec.clone(dual=dual)

    @jax.jit
    def run(ev, dv, x):
        if not train:
            feats = jenc.apply(ev, x, train=False)
            return feats, jdec.apply(dv, feats, train=False), {}, {}
        feats, es = jenc.apply(ev, x, train=True, mutable=["batch_stats"])
        logits, ds = jdec.apply(dv, feats, train=True, mutable=["batch_stats"])
        return feats, logits, es["batch_stats"], ds["batch_stats"]

    return run


def _unpacked(feats, s2d_levels):
    from ramdsir_tpu.models.s2d import unpack

    return [unpack(f) if i < s2d_levels else f for i, f in enumerate(feats)]


@pytest.mark.parametrize("train", [False, True])
def test_encoder_decoder_match_jax(unet, train):
    x = np.random.default_rng(2).normal(size=(4, HW, HW, 3)).astype(np.float32)
    enc, dec = unet["enc"].train(train), unet["dec"].train(train)
    enc_sd = {k: v.clone() for k, v in enc.state_dict().items()}
    dec_sd = {k: v.clone() for k, v in dec.state_dict().items()}
    run = _seg_forward(unet["jenc"], unet["jdec"], train)
    feats, logits, es, ds = run(unet["ev"], unet["dv"], jnp.asarray(x))
    with torch.no_grad():
        tfeats = enc(_nchw(x))
        tlogits = dec(tfeats)
    for g, w in zip(tfeats, _unpacked(feats, unet["jenc"].s2d_levels)):
        _assert_nhwc(g, w, **FEAT_TOL)
    _assert_nhwc(tlogits, logits, **FEAT_TOL)
    if train:
        _assert_stats(enc, es, **STAT_TOL)
        _assert_stats(dec, ds, **STAT_TOL)
    enc.load_state_dict(enc_sd)
    dec.load_state_dict(dec_sd)


def test_dual_forward_matches_jax(unet):
    """[clean; RAM] through one dual forward: per-half statistics and the
    two running-stat updates in order."""
    x = np.random.default_rng(3).normal(size=(6, HW, HW, 3)).astype(np.float32)
    x[3:] = x[3:] * 0.5 + 0.7  # halves with different statistics
    enc, dec = unet["enc"].train(), unet["dec"].train()
    enc_sd = {k: v.clone() for k, v in enc.state_dict().items()}
    dec_sd = {k: v.clone() for k, v in dec.state_dict().items()}
    run = _seg_forward(unet["jenc"], unet["jdec"], True, dual=True)
    _, logits, es, ds = run(unet["ev"], unet["dv"], jnp.asarray(x))
    with torch.no_grad():
        tlogits = dec(enc(_nchw(x), dual=True), dual=True)
    _assert_nhwc(tlogits, logits, **FEAT_TOL)
    _assert_stats(enc, es, **STAT_TOL)
    _assert_stats(dec, ds, **STAT_TOL)
    enc.load_state_dict(enc_sd)
    dec.load_state_dict(dec_sd)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("segment", [False, True])
def test_rec_decoder_matches_jax(unet, train, segment):
    x = np.random.default_rng(4).normal(size=(5, HW // 16, HW // 16, 16 * N)).astype(np.float32)
    domain = np.array([0, 0, 1, 2, 2]) if segment else 1
    rec = unet["rec"].train(train)
    sd = {k: v.clone() for k, v in rec.state_dict().items()}
    jrec = unet["jrec"]

    @jax.jit
    def run(rv, x, dom):
        if train:
            out, rs = jrec.apply(rv, x, domain=dom, train=True, mutable=["batch_stats"])
            return out, rs["batch_stats"]
        return jrec.apply(rv, x, domain=dom, train=False), {}

    want, rs = run(unet["rv"], jnp.asarray(x), jnp.asarray(domain, jnp.int32))
    with torch.no_grad():
        got = rec(_nchw(x), domain=domain)
    _assert_nhwc(got, want, **FEAT_TOL)
    if train:
        _assert_stats(rec, rs, **STAT_TOL)
    rec.load_state_dict(sd)

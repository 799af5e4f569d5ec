"""The port's model zoo (`models/unet.py`: Unet2D, Unet2DMT, Unet2DDS,
Unet2DMS, Discriminator, count_params) against the JAX package's on the CPU.

n=4 at 32^2 (Unet2DDS's bottleneck is 2^2, so its x16 head returns to
32^2), batch 4, float32.  The JAX weights, every one moved off its init by
seeded noise, go across through `utils/torch_compat.py`; inputs come from a
numpy seed.

Outputs are held within 1e-5 of the largest absolute output.  In eval mode
that is against JAX's outputs.  In train mode the batch statistics of the
2^2 bottleneck (16 values a channel) amplify each package's float32
rounding: JAX's own forward lies further than 1e-5 of the largest output
from the float64 forward of the same weights and input, so there the port
is held within 1e-5 of that float64 forward, and JAX within JAX_F32_REL of
it, which places the port within their sum of JAX.  The float64 forward
is the port's modules with each norm computed by torch's float64
functional norm (tests/_float64_forward.py).  The running statistics after
one train forward are held within rtol 1e-4 / atol 1e-5 of JAX's
(step_parity's bounds), and the gradients of a fixed scalar loss within
1e-4 relative L2 of jax.grad's, per parameter.  A conv bias that feeds a
norm has gradient 0 in exact arithmetic (the norm takes out any constant a
channel): both packages give rounding noise there, held below 1e-5 of the
RMS gradient entry of that conv's weight.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ramdsir_tpu.models.unet as junet
import ramdsir_tpu_torch.models.unet as tunet
from ramdsir_tpu.utils.torch_compat import flax_module_to_torch_sd
from ramdsir_tpu_torch.utils.torch_compat import jax_params_to_torch, load_jax_params, torch_to_jax_params
from tests._float64_forward import float64_forward
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

N, HW, BATCH = 4, 32, 4
OUT_REL = 1e-5  # of the largest absolute output
JAX_F32_REL = 3e-5  # JAX's train-mode float32 forward from the float64 one
NOISE_REL = 1e-5  # a zero-gradient bias's noise, of its conv weight's RMS gradient entry
STAT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL_L2 = 1e-4

# name -> (JAX module, port module, call kwargs per head)
ZOO = {
    "Unet2D": (lambda: junet.Unet2D(n=N), lambda: tunet.Unet2D(n=N), [{}]),
    "Unet2D_gn": (lambda: junet.Unet2D(n=N, norm="gn"), lambda: tunet.Unet2D(n=N, norm="gn"), [{}]),
    "Unet2DMT": (lambda: junet.Unet2DMT(n=N), lambda: tunet.Unet2DMT(n=N), [{"is_rec": False}, {"is_rec": True}]),
    "Unet2DDS": (lambda: junet.Unet2DDS(n=N), lambda: tunet.Unet2DDS(n=N), [{"deep_sup": False}, {"deep_sup": True}]),
    "Unet2DMS": (lambda: junet.Unet2DMS(n=N), lambda: tunet.Unet2DMS(n=N),
                 [{"multi_scale_output": False}, {"multi_scale_output": True}]),
    "Discriminator": (lambda: junet.Discriminator(n=N), lambda: tunet.Discriminator(n=N), [{}]),
}


@pytest.fixture(autouse=True)
def exact_float32():
    previous = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = previous


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _input(seed=0, c=3):
    return np.random.default_rng(seed).normal(size=(BATCH, HW, HW, c)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


_VARIABLES = {}


def _jax_variables(name, seed=0):
    """The JAX model's variables over every head, each parameter moved off
    its init by seeded noise (made once a module; no test changes them)."""
    jmodel, _, heads = ZOO[name]
    model = jmodel()
    if (name, seed) not in _VARIABLES:
        x = jnp.asarray(_input())
        params, stats = {}, {}
        for kw in heads:
            kw = kw if name == "Discriminator" else {"train": False, **kw}
            v = model.init(jax.random.PRNGKey(seed), x, **kw)
            params.update(_np(v["params"]))
            stats.update(_np(v.get("batch_stats", {})))
        rng = np.random.default_rng(seed + 1)
        params = jax.tree.map(lambda p: (p + 0.05 * rng.normal(size=p.shape)).astype(np.float32), params)
        _VARIABLES[name, seed] = {"params": params, "batch_stats": stats}
    return model, _VARIABLES[name, seed]


def _port(name, variables):
    module = ZOO[name][1]()
    load_jax_params(module, variables["params"], variables["batch_stats"])
    return module


def _as_tuple(y):
    return tuple(y) if isinstance(y, (tuple, list)) else (y,)


def _jax_apply(model, name, variables, x, train, kw):
    """(heads, batch_stats after the call) of one JAX forward."""
    if name == "Discriminator":
        return _as_tuple(model.apply(variables, x)), variables.get("batch_stats", {})
    if not train:
        return _as_tuple(model.apply(variables, x, train=False, **kw)), variables["batch_stats"]
    y, mut = model.apply(variables, x, train=True, mutable=["batch_stats"], **kw)
    return _as_tuple(y), _np(mut["batch_stats"])


def _nhwc(y):
    """A head as NHWC numpy: a torch head is NCHW, a JAX one NHWC already;
    the Discriminator's (B, 1) as it is."""
    if not isinstance(y, torch.Tensor):
        return np.asarray(y)
    y = y.detach().numpy()
    return y if y.ndim == 2 else y.transpose(0, 2, 3, 1)


def _assert_outputs(ours, want, what, rel=OUT_REL, scale=None):
    """Every head within rel x `scale` (the largest absolute output of
    `want` if None)."""
    assert len(ours) == len(want), what
    ours, want = [_nhwc(o) for o in ours], [_nhwc(w) for w in want]
    if scale is None:
        scale = max(float(np.max(np.abs(w))) for w in want)
    for i, (o, w) in enumerate(zip(ours, want)):
        assert o.shape == w.shape, (what, i, o.shape, w.shape)
        err = float(np.max(np.abs(o - w)))
        assert err <= rel * scale, f"{what} head {i}: {err} > {rel} x {scale}"


def _float64_forward(module, x, kw):
    return tuple(y.float() for y in float64_forward(module, _nchw(x), **kw))


def _assert_stats(module, stats):
    want = flax_module_to_torch_sd({}, stats)
    got = module.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, err_msg=k, **STAT_TOL)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_forward_equals_jax(name):
    """Every head in train mode (outputs, through the float64 forward, and
    running statistics), then in eval mode on the statistics that forward
    left."""
    model, variables = _jax_variables(name)
    x = _input(seed=2)
    for kw in ZOO[name][2]:
        module = _port(name, variables)
        module.train()
        want, stats = _jax_apply(model, name, variables, jnp.asarray(x), True, kw)
        exact = _float64_forward(module, x, kw)
        with torch.no_grad():
            ours = _as_tuple(module(_nchw(x), **kw))
        scale = max(float(np.max(np.abs(np.asarray(w)))) for w in want)
        _assert_outputs(ours, exact, f"{name} {kw} train, port", scale=scale)
        _assert_outputs(want, exact, f"{name} {kw} train, JAX", rel=JAX_F32_REL, scale=scale)
        if name != "Discriminator":
            _assert_stats(module, stats)
        module.eval()
        want, _ = _jax_apply(model, name, {**variables, "batch_stats": stats}, jnp.asarray(x), False, kw)
        with torch.no_grad():
            ours = _as_tuple(module(_nchw(x), **kw))
        _assert_outputs(ours, want, f"{name} {kw} eval")


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _biases_into_norms(module):
    """{bias name: its conv's weight name} for every conv whose output goes
    straight into a norm (convK beside bnK or normK)."""
    out = {}
    for prefix, m in module.named_modules():
        p = f"{prefix}." if prefix else ""
        for k in range(1, 6):
            if hasattr(m, f"conv{k}") and (hasattr(m, f"bn{k}") or hasattr(m, f"norm{k}")):
                out[f"{p}conv{k}.bias"] = f"{p}conv{k}.weight"
    return out


@pytest.mark.parametrize("name,kw", [("Unet2DDS", {"deep_sup": True}), ("Discriminator", {})], ids=["Unet2DDS", "Discriminator"])
def test_zoo_gradients_equal_jax(name, kw):
    """The gradients of one fixed scalar loss (a seeded weighting of every
    output) in train mode."""
    model, variables = _jax_variables(name)
    x = _input(seed=3)
    probe_rng = np.random.default_rng(4)
    want_out, _ = _jax_apply(model, name, variables, jnp.asarray(x), True, kw)
    probes = [probe_rng.normal(size=np.asarray(o).shape).astype(np.float32) for o in want_out]

    def loss(params):
        v = {**variables, "params": params}
        if name == "Discriminator":
            outs = model.apply(v, jnp.asarray(x))
        else:
            outs = model.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"], **kw)[0]
        return sum(jnp.mean(o * p) for o, p in zip(_as_tuple(outs), probes))

    jgrads = _np(jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, variables["params"])))
    want = jax_params_to_torch({"m": jgrads}, {})["m"]

    module = _port(name, variables)
    module.train()
    outs = _as_tuple(module(_nchw(x), **kw))
    total = sum(torch.mean(o * torch.from_numpy(p if o.ndim == 2 else p.transpose(0, 3, 1, 2).copy()))
                for o, p in zip(outs, probes))
    total.backward()
    grads = {k: p.grad.numpy() for k, p in module.named_parameters()}
    assert sorted(grads) == sorted(want)
    zero = _biases_into_norms(module)
    assert zero, "no conv feeds a norm"
    for k, g in want.items():
        if k in zero:
            rms = float(np.sqrt(np.mean(np.square(want[zero[k]].numpy()))))
            for got in (grads[k], g.numpy()):
                assert float(np.max(np.abs(got))) <= NOISE_REL * rms, (k, float(np.max(np.abs(got))), rms)
        else:
            assert _rel_l2(grads[k], g.numpy()) <= GRAD_REL_L2, k


def test_count_params_equals_jax_at_reference_width():
    """n=16, the reference width: the totals JAX counts for each variant
    (its trees' shapes, from jax.eval_shape)."""
    x = jnp.zeros((1, 32, 32, 3))

    def jax_count(model, *heads):
        params = {}
        for kw in heads:
            params.update(jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False, **kw))["params"])
        return junet.count_params({"params": params})

    assert tunet.count_params(tunet.Unet2D()) == jax_count(junet.Unet2D(), {})
    assert tunet.count_params(tunet.Unet2D(norm="gn")) == jax_count(junet.Unet2D(norm="gn"), {})
    # Unet2DMT: JAX creates one head a call, the port holds both
    assert tunet.count_params(tunet.Unet2DMT()) == jax_count(junet.Unet2DMT(), {}, {"is_rec": True})
    assert tunet.count_params(tunet.Unet2DDS()) == jax_count(junet.Unet2DDS(), {"deep_sup": True})
    assert tunet.count_params(tunet.Unet2DMS()) == jax_count(junet.Unet2DMS(), {"multi_scale_output": True})
    dv = jax.eval_shape(lambda: junet.Discriminator().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    assert tunet.count_params(tunet.Discriminator()) == junet.count_params(dv)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_weights_round_trip_bit_equal(name):
    """JAX -> port -> JAX gives back every array bit for bit, and a fresh
    port model's trees go into the JAX model and out again unchanged."""
    model, variables = _jax_variables(name)
    module = _port(name, variables)
    params, stats = torch_to_jax_params(module)
    for want, got in ((variables["params"], params), (variables["batch_stats"], stats)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    fresh = ZOO[name][1]()
    params, stats = torch_to_jax_params(fresh)
    again = ZOO[name][1]()
    load_jax_params(again, params, stats)
    for (k, a), b in zip(fresh.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k


def test_zoo_init_is_seeded_and_the_discriminator_keeps_torch_init():
    a = tunet.Unet2D(n=N, generator=torch.Generator().manual_seed(3))
    b = tunet.Unet2D(n=N, generator=torch.Generator().manual_seed(3))
    for (k, u), v in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(u, v), k
    w = a.encoder.convd1.conv1.weight  # Kaiming normal fan-out: std sqrt(2 / (9 * out))
    assert abs(float(w.detach().std()) - np.sqrt(2.0 / (9 * N))) < 0.3 * np.sqrt(2.0 / (9 * N))
    torch.manual_seed(0)
    d = tunet.Discriminator(n=N)
    torch.manual_seed(0)
    ref = torch.nn.Conv2d(3, N, 4, stride=2, padding=1)
    assert torch.equal(d.conv1.weight, ref.weight) and torch.equal(d.conv1.bias, ref.bias)

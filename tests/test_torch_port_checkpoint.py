"""Full-state `.ckpt` checkpoints between the port and the JAX package, on
the CPU: the port's msgpack codec against flax's, the state trees both ways
(weights, BN statistics, Adam's moments and count, the step), a step after
resuming from a JAX file against JAX's step from the same file, and `fit`
resuming from its own `final_model.ckpt`.

The JAX side trains two float32 steps of the fundus RAM-DSIR configuration
of tests/test_torch_port_step.py (32^2, n=16, batch 6) and writes them with
`ramdsir_tpu.train.checkpoint.save_checkpoint`.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ramdsir_tpu.config import TrainConfig as JConfig
from ramdsir_tpu.ops.ram import sample_ram_ratios
from ramdsir_tpu.train import checkpoint as jckpt
from ramdsir_tpu.train.state import init_state as jinit_state
from ramdsir_tpu.train.steps import make_train_step as jmake_train_step
from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.train.checkpoint import load_checkpoint, read_checkpoint, save_checkpoint
from ramdsir_tpu_torch.train.state import init_state, state_to_tree
from ramdsir_tpu_torch.train.steps import make_train_step, poly_lr
from ramdsir_tpu_torch.utils import msgpack
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)
from tests.test_torch_port_step import B, BSL, CFG, METRICS, _batch, _snapshot, check_params_and_running_stats

TOTAL = 10


def _assert_trees_equal(got, want, path="root"):
    """The same nested dicts; numpy leaves of the same dtype, shape and bits,
    other leaves equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# --- the codec ----------------------------------------------------------------------

TREES = {
    "nested": {"a": {"b": {"c": np.arange(6, dtype=np.float32).reshape(2, 3)}}, "z": np.asarray(3, np.int32)},
    "scalars": {"f": 1.5, "i": -7, "pos": 200, "big": 2**40, "neg": -(2**33), "t": True, "f0": False,
                "n": None, "s": "step", "b": b"\x00\x01"},
    "lengths": {"k" * 40: "x" * 300, "list": list(range(20)), "map": {f"k{i:02d}": i for i in range(20)},
                "bin": bytes(range(256)) * 300, "s16": "y" * 70000},
    "arrays": {"f0": np.asarray(0.25, np.float32), "i0": np.asarray(-3, np.int32),
               "f2": np.random.default_rng(0).normal(size=(64, 33)).astype(np.float32),
               "i2": np.arange(12, dtype=np.int32).reshape(3, 4), "empty": np.zeros((0, 3), np.float32),
               "u8": np.arange(5, dtype=np.uint8), "f64": np.linspace(0, 1, 7)},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_msgpack_matches_flax(name):
    """The port writes flax's bytes for the same tree, reads them back, and
    flax reads what the port writes."""
    tree = TREES[name]
    packed = msgpack.packb(tree)
    assert packed == serialization.msgpack_serialize(tree)
    _assert_trees_equal(msgpack.unpackb(packed), tree)
    _assert_trees_equal(serialization.msgpack_restore(packed), tree)


def test_msgpack_layout_and_numpy_scalars():
    """A 0-d int32 leaf is ext 1 [shape [], "int32", its 4 bytes]; flax's
    numpy scalars (ext 3) read back as numpy scalars; damaged input raises."""
    head = bytes.fromhex("c70e019390a5") + b"int32" + bytes.fromhex("c404")
    assert msgpack.packb(np.asarray(5, np.int32)) == head + np.asarray(5, np.int32).tobytes()
    tree = {"x": np.float32(1.5), "y": np.int32(-2)}
    data = serialization.msgpack_serialize(tree)
    got = msgpack.unpackb(data)
    assert isinstance(got["x"], np.float32) and got["x"] == 1.5
    assert isinstance(got["y"], np.int32) and got["y"] == -2
    assert msgpack.packb(tree) == data
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(data[:-1])
    with pytest.raises(ValueError, match="after the object"):
        msgpack.unpackb(data + b"\x00")
    with pytest.raises(TypeError):
        msgpack.packb({"x": object()})


# --- the state both ways ----------------------------------------------------------------


def _jbatch(seed):
    return {k: jnp.asarray(v) for k, v in _batch(seed, False).items()}


def _tbatch(seed):
    return {k: torch.from_numpy(v) for k, v in _batch(seed, False).items()}


def _draws(key):
    return {"ratio": torch.from_numpy(np.array(sample_ram_ratios(key, B)))}


def _port_state(seed=0):
    return init_state(TrainConfig(**CFG, device="cpu").resolve(), torch.Generator().manual_seed(seed), "cpu")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two JAX steps, written as a full and as a weights-only `.ckpt`."""
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    jcfg = JConfig(**CFG, device_data=False).resolve()
    jstate, models = jinit_state(jcfg, jax.random.PRNGKey(0))
    jstep = jmake_train_step(jcfg, models, total_iters=TOTAL, batch_size_list=BSL)
    for i in range(2):
        jstate, _, _ = jstep(jstate, _jbatch(100 + i), jax.random.PRNGKey(11 + i))
    full, weights = str(tmp / "final_model.ckpt"), str(tmp / "model_1.00.ckpt")
    jckpt.save_checkpoint(full, jstate, meta={"steps": 2})
    jckpt.save_checkpoint(weights, jstate, meta={"dice": 1.0}, weights_only=True)
    template, _ = jinit_state(jcfg, jax.random.PRNGKey(1))
    return dict(state=jstate, step=jstep, full=full, weights=weights, template=template, tmp=tmp)


def test_jax_ckpt_loads_into_port(jax_run):
    """Every array of the JAX file arrives unchanged: params, batch_stats,
    Adam's count, mu and nu, the step; torch's Adam holds the moments."""
    state = _port_state()
    assert load_checkpoint(jax_run["full"], state) == {"steps": 2}
    assert state.step == 2
    want = jax.device_get(serialization.to_state_dict(jax_run["state"]))
    _assert_trees_equal(state_to_tree(state), jax.tree.map(np.asarray, want))
    params = [p for m in state.models.values() for p in m.parameters()]
    assert len(state.optimizer.state) == len(params)
    assert all(int(state.optimizer.state[p]["step"]) == 2 for p in params)
    conv = state.models["encoder"].convd1.conv1.weight
    np.testing.assert_array_equal(
        state.optimizer.state[conv]["exp_avg"].numpy(),
        np.asarray(want["opt_state"]["mu"]["encoder"]["convd1"]["conv1"]["kernel"]).transpose(3, 2, 0, 1),
    )


@pytest.mark.parametrize("s2d", [0, 2], ids=["s2d0", "s2d2"])
def test_state_tree_matches_jax_init_state(s2d):
    """The port's state tree has the key paths, shapes and dtypes of the JAX
    package's `init_state` for the same config (the JAX s2d layout keeps its
    parameter tree)."""
    jstate, _ = jinit_state(JConfig(**CFG, s2d_levels=s2d).resolve(), jax.random.PRNGKey(0))
    want = jax.tree.map(np.asarray, serialization.to_state_dict(jstate))
    got = state_to_tree(init_state(TrainConfig(**CFG, s2d_levels=s2d, device="cpu").resolve(),
                                   torch.Generator().manual_seed(0), "cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, jax.tree_util.keystr(path)


def test_port_ckpt_loads_into_jax(jax_run, tmp_path):
    """A port state one step past the JAX file, written by the port, is
    restored by the JAX package's `load_checkpoint` against `init_state`'s
    template: the same tree structure, dtypes and values."""
    state = _port_state()
    load_checkpoint(jax_run["full"], state)
    step = make_train_step(TrainConfig(**CFG, device="cpu").resolve(), TOTAL, batch_size_list=BSL)
    step(state, _tbatch(102), draws=_draws(jax.random.PRNGKey(13)))
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, state, meta={"steps": 3})
    template = jax_run["template"]
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    assert jax.tree.structure(raw["state"]) == jax.tree.structure(serialization.to_state_dict(template))
    restored, meta = jckpt.load_checkpoint(path, template)
    assert meta == {"steps": 3} and int(restored.step) == 3
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(template)):
        assert got.dtype == want.dtype and got.shape == want.shape
    _assert_trees_equal(jax.tree.map(np.asarray, serialization.to_state_dict(restored)), state_to_tree(state))


def test_weights_only_ckpt_keeps_fresh_adam(jax_run, tmp_path):
    """A weights-only JAX file (the rolling best) loads its weights and step
    and leaves the fresh Adam state; the port's weights-only file loads in
    the JAX package the same way."""
    state = _port_state()
    assert load_checkpoint(jax_run["weights"], state) == {"dice": 1.0}
    assert state.step == 2 and len(state.optimizer.state) == 0
    want = jax.tree.map(np.asarray, jax.device_get(serialization.to_state_dict(jax_run["state"])))
    got = state_to_tree(state)
    _assert_trees_equal(got["params"], want["params"])
    _assert_trees_equal(got["batch_stats"], want["batch_stats"])
    assert int(got["opt_state"]["count"]) == 0
    path = str(tmp_path / "port_weights.ckpt")
    save_checkpoint(path, state, weights_only=True)
    assert "opt_state" not in read_checkpoint(path)["state"]
    template = jax_run["template"]
    restored, _ = jckpt.load_checkpoint(path, template)
    _assert_trees_equal(jax.tree.map(np.asarray, restored.params), want["params"])
    fresh = lambda st: jax.tree.map(np.asarray, serialization.to_state_dict(st.opt_state))
    _assert_trees_equal(fresh(restored), fresh(template))


def test_resumed_step_matches_jax(jax_run):
    """The third step, taken by the port from the JAX file and by JAX from
    the same file with the same batch and RAM draws: losses within 1e-5
    relative, the lr the schedule's at step 2, params and running
    statistics within the one-step bounds of tests/test_torch_port_step.py."""
    jstate, _ = jckpt.load_checkpoint(jax_run["full"], jax_run["template"])
    key = jax.random.PRNGKey(13)
    jstate, jm, _ = jax_run["step"](jstate, _jbatch(102), key)
    tcfg = TrainConfig(**CFG, device="cpu").resolve()
    state = _port_state(seed=5)
    load_checkpoint(jax_run["full"], state)
    tm = make_train_step(tcfg, TOTAL, batch_size_list=BSL)(state, _tbatch(102), draws=_draws(key))
    for k in METRICS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(tm["lr"]) == pytest.approx(poly_lr(tcfg.lr, 2, TOTAL), rel=1e-7)
    assert state.step == 3 and int(jstate.step) == 3
    check_params_and_running_stats(*_snapshot(jstate, state), tcfg.lr)


def test_save_load_step_is_bit_equal(jax_run, tmp_path):
    """The port's save -> load -> step equals the step without the save, bit
    for bit: every parameter, buffer and Adam moment, and the metrics."""
    tcfg = TrainConfig(**CFG, device="cpu").resolve()
    a, b = _port_state(), _port_state(seed=7)
    load_checkpoint(jax_run["full"], a)
    train_step = make_train_step(tcfg, TOTAL, batch_size_list=BSL)
    train_step(a, _tbatch(102), draws=_draws(jax.random.PRNGKey(13)))  # moments of the port's own step
    path = str(tmp_path / "a.ckpt")
    save_checkpoint(path, a)
    load_checkpoint(path, b)
    assert a.step == b.step == 3

    def snapshot(state):
        tensors = {f"{n}.{k}": v.clone() for n, m in state.models.items() for k, v in m.state_dict().items()}
        for i, p in enumerate(p for m in state.models.values() for p in m.parameters()):
            for k, v in state.optimizer.state[p].items():
                tensors[f"adam{i}.{k}"] = v.clone()
        return tensors

    sa, sb = snapshot(a), snapshot(b)
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    key = jax.random.PRNGKey(14)
    ma = train_step(a, _tbatch(103), draws=_draws(key))
    mb = train_step(b, _tbatch(103), draws=_draws(key))
    assert all(torch.equal(ma[k], mb[k]) for k in METRICS)
    sa, sb = snapshot(a), snapshot(b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


# --- fit ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fit_runs(tmp_path_factory):
    """fit for one step, then resumed from its final_model.ckpt up to step
    2, then a whole epoch, then resumed from that finished run."""
    from ramdsir_tpu_torch.data.synthetic import make_fundus_tree
    from ramdsir_tpu_torch.train.loop import fit

    tmp = tmp_path_factory.mktemp("fit")
    make_fundus_tree(str(tmp / "data"), per_domain_train=12, per_domain_test=2, size=40)
    cfg = TrainConfig(
        data_root=str(tmp / "data"), dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0,
        ram=True, rec=True, is_out_domain=True, consistency=True, consistency_type="kd",
        image_size=32, epochs=1, test_batch_size=2, save_path=str(tmp / "one"), device="cpu",
    )
    run = lambda name, max_steps=None, resume=None: fit(
        dataclasses.replace(cfg, save_path=str(tmp / name), checkpoint_resume=resume), max_steps=max_steps
    )
    out = {"one": run("one", 1)}
    out["two"] = run("two", 2, out["one"]["resume_checkpoint"])
    out["full"] = run("full")
    out["again"] = run("again", None, out["full"]["resume_checkpoint"])
    out["tmp"], out["cfg"] = tmp, cfg
    return out


def _logged(run_dir, key):
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "log", "metrics.jsonl"))]
    return [(r["step"], r[key]) for r in rows if key in r]


def test_fit_resumes_from_its_checkpoint(fit_runs):
    """fit(max_steps=1), then fit(checkpoint_resume=..., max_steps=2): one
    more step, logged at global step 1 with the schedule's lr there; the
    resumed run's final_model.ckpt holds step 2 and both files are written
    (as tests/test_cli.py:66-81 holds the JAX package's loop)."""
    one, two = fit_runs["one"], fit_runs["two"]
    assert one["steps"] == 1 and two["steps"] == 2
    assert two["resume_checkpoint"].endswith("final_model.ckpt") and os.path.exists(two["final_checkpoint"])
    assert read_checkpoint(two["resume_checkpoint"])["meta"] == {"steps": 2}
    total = fit_runs["full"]["steps"]
    run_dir = os.path.dirname(two["resume_checkpoint"])
    (step, lr), = _logged(run_dir, "lr")
    assert step == 1 and lr == pytest.approx(poly_lr(fit_runs["cfg"].resolve().lr, 1, total), rel=1e-6)
    assert [s for s, _ in _logged(run_dir, "loss/loss")] == [1]


def test_fit_stops_at_total_iters(fit_runs):
    """A whole run takes total_iters steps; resumed from its end it takes
    none (the JAX package's loop would run another epoch with the lr past
    zero) and writes the same, finite weights."""
    full, again = fit_runs["full"], fit_runs["again"]
    assert full["steps"] > 2 and again["steps"] == full["steps"]
    assert not _logged(os.path.dirname(again["resume_checkpoint"]), "loss/loss")
    a, b = read_checkpoint(full["resume_checkpoint"])["state"], read_checkpoint(again["resume_checkpoint"])["state"]
    _assert_trees_equal(b, a)
    assert all(np.isfinite(x).all() for x in jax.tree.leaves(b["params"]))

"""TransUNet (`models/transunet.py`) as the RAM-DSIR step's network, held on
the CPU to its plain reference, `port_bench/reference/transunet.py` (the
benchmark's own, which imports nothing of the port), at a tiny size
(`tests/_transunet_tiny.py`: 64^2, hidden 256, 2 blocks of 4 heads, one
bottleneck unit a block, so that block 1's 15^2 map is zero-padded to 16^2):

  - the forward, every leaf's gradient and the running statistics, with the
    [clean; RAM] halves' batch norms (dual) and DSBN's segments in the
    restoration decoder, and without the halves;
  - the dropout masks bit for bit, and again under --remat's recomputation;
  - one `make_train_step` step (the window runner, as the benchmark drives
    it) against the reference's step: the loss, the running statistics,
    Adam's moments (the gradient and its square) and each leaf's change;
  - `make_predict_fn` in eval mode (no dropout), a `.ckpt` and a `.pth`
    round trip, the draws, the counters, and each refusal of
    `check_supported`.

Tolerances: the port and the reference run the same float32 operations on
the CPU except the align_corners=True upsample (aten's against the
reference's gathers, ~1 ulp) and the halves' order, so the outputs agree to
1e-5 of their size.  A leaf's gradient gap is taken against the larger of
the leaf's and the median leaf's norm: the median leaf's within 1e-4
(~5e-6 measured here over four seeds and one to eight threads), every leaf
within 5e-2, because a ReLU whose input lies within round-off of zero opens
on one side and not the other now and then, and moves a leaf fed by few
elements (the restoration decoder's norms at the 4 x 4 bottleneck, of one-
and two-row domains) by up to 1.3e-2 here."""
import dataclasses
import statistics

import pytest
import torch

from port_bench.families import transunet as family
from port_bench.lib import common, spec, train_cell
from port_bench.reference import ramdsir as rram
from port_bench.reference import transunet as ref
from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.models import transunet
from ramdsir_tpu_torch.train.state import init_state
from ramdsir_tpu_torch.train.steps import check_supported, make_predict_fn, sample_step_draws
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)
from tests._transunet_tiny import FILE_KEYS, NAME, register

S, B = 64, 4
DOMAINS = [0, 1, 2, 2]


def file_cfg(**kw):
    """The benchmark's configuration file at the tiny sizes."""
    c = dict(spec.config(spec.benchmark(), "transunet_fundus"), image_size=S, train_per_domain=[6, 36, 14], **FILE_KEYS)
    c["program"] = dict(c["program"], model=NAME)
    c.update(kw)
    return c


def port_cfg(**kw):
    return TrainConfig(model=NAME, dataset="fundus", domain_idxs=(1, 2, 3), test_domain_idx=0, image_size=S,
                       s2d_levels=0, device="cpu", **kw)


@pytest.fixture
def tiny(monkeypatch):
    register(monkeypatch)
    state = init_state(port_cfg(), torch.Generator().manual_seed(0), "cpu")
    weights = ref.make_weights(file_cfg(), 5, "cpu")
    common.load_weights(state.models, weights)
    return state, weights


def _loss_weights(shapes, seed=3):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g) for s in shapes]


def _close(a, b, rel):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) <= rel * max(float(b.abs().max()), 1e-30)


def _check_leaves(got, want, names, median=1e-4, worst=5e-2):
    """Each leaf's |got - want| against the larger of its own and the median
    leaf's |want|: the median leaf's gap within `median`, every leaf's within
    `worst`."""
    norms = {k: float(want[k].norm()) for k in names}
    med = statistics.median(norms.values())
    gaps = {k: float((got[k] - want[k]).norm()) / max(norms[k], med, 1e-30) for k in names}
    assert statistics.median(gaps.values()) <= median, sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    assert max(gaps.values()) <= worst, sorted(gaps.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.parametrize("dual", [True, False], ids=["dual_halves", "one_batch"])
def test_forward_gradients_and_statistics_match_the_reference(tiny, dual):
    state, weights = tiny
    enc, dec, rec = (state.models[k] for k in ("encoder", "seg_decoder", "rec_decoder"))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2 * B, 3, S, S, generator=g)
    seeds = torch.randint(0, 2**31, (B if dual else 2 * B,), generator=g)
    feats = enc(x, dual=dual, dropout_seed=seeds)
    logits = dec(feats, dual=dual)
    restored = rec(feats[-1][B:], domain=DOMAINS)
    w1, w2 = _loss_weights([logits.shape, restored.shape])
    ((logits * w1).sum() + (restored * w2).sum()).backward()

    tensors = {k: v.clone().requires_grad_(not rram.is_buffer(k)) for k, v in weights.items()}
    net = ref.TransUNet(file_cfg(), tensors)
    if dual:
        (_, l1), (tok, l2) = net.segment(x[:B], True, seeds, 0), net.segment(x[B:], True, seeds, 1)
        r_logits = torch.cat([l1, l2])
    else:
        tok, r_logits = net.segment(x, True, seeds, 0)
        tok = tok[B:]
    r_rest = rram.UNet(tensors).rec_decoder(tok, DOMAINS, True)
    names = [k for k in tensors if not rram.is_buffer(k)]
    grads = torch.autograd.grad((r_logits * w1).sum() + (r_rest * w2).sum(), [tensors[k] for k in names])

    assert _close(feats[-1][B:], tok, 1e-5) and _close(logits, r_logits, 1e-5) and _close(restored, r_rest, 1e-5)
    port_grads = {f"{m}.{k}": p.grad for m, mod in state.models.items() for k, p in mod.named_parameters()}
    assert sorted(port_grads) == sorted(names)
    _check_leaves(port_grads, dict(zip(names, grads)), names)
    port_state = common.named_state(state.models)
    for k, v in tensors.items():
        if rram.is_buffer(k):
            torch.testing.assert_close(port_state[k], v, rtol=1e-5, atol=1e-6, msg=k)
            assert not torch.equal(v, weights[k]), f"{k} never moved"


def test_dropout_masks_equal_the_reference_bit_for_bit():
    g = torch.Generator().manual_seed(2)
    seeds = torch.randint(0, 2**31, (3,), generator=g)
    seeds[0] = 2**31 - 1
    for half in (0, 1):
        keys = transunet.row_keys(seeds, 2)[3 * half : 3 * (half + 1)]
        for site, shape in [(0, (3, 16, 64)), (7, (3, 15, 7)), (24, (3, 1024, 3))]:
            mask = transunet.keep_mask(keys, site, shape)
            ones = ref.drop(torch.ones(shape), seeds, half, site, 0.1)
            assert torch.equal(mask, ones != 0), (half, site)
            assert torch.equal(mask, transunet.keep_mask(keys, site, shape))  # recomputed
    big = transunet.keep_mask(transunet.row_keys(seeds, 1), 1, (3, 1024, 384))
    assert abs(float(big.float().mean()) - (1 - 6554 / 65536)) < 2e-3
    a, b = big[0].flatten(), big[1].flatten()
    assert 0.79 < float((a & b).float().mean()) < 0.83  # rows independent: 0.9^2


def test_remat_recomputes_the_same_masks(monkeypatch):
    register(monkeypatch)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2 * B, 3, S, S, generator=g)
    seeds = torch.randint(0, 2**31, (B,), generator=g)
    grads = []
    for remat in (False, True):
        state = init_state(port_cfg(remat=remat), torch.Generator().manual_seed(0), "cpu")
        enc = state.models["encoder"]
        assert enc.encoder.remat is remat and enc.embeddings.hybrid_model.remat is remat
        enc(x, dual=True, dropout_seed=seeds)[-1].square().sum().backward()
        grads.append({k: p.grad for k, p in enc.named_parameters()})
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])


def test_one_train_step_matches_the_reference(monkeypatch, tmp_path):
    register(monkeypatch)
    c = file_cfg()
    ctx = type("Ctx", (), dict(cfg=c, family=family, reference=ref, device="cpu"))()
    data = family.make_data(c, 11, "cpu")
    weights = ref.make_weights(c, 11, "cpu")
    host = {k: v.clone() for k, v in weights.items()}
    cfg = family.program_config(c, "cpu", str(tmp_path / "run"))
    loop = train_cell.WindowLoop(c, cfg, 11, "cpu", weights, data)
    draw_state = loop.generator.get_state()
    loop.plan, loop.pos = loop.planner.epoch(), 0
    plan = {k: v[:1].copy() for k, v in loop.plan.items()}
    _, metrics = loop.window(1)
    port = train_cell.host_state(loop)
    losses, states = train_cell.chain(ctx, c, data, host, plan, draw_state, loop.B, loop.total_iters)
    after = states[1]
    assert float(metrics["loss"][0]) == pytest.approx(losses[0], rel=1e-5)
    names = [k for k in after["tensors"] if not rram.is_buffer(k)]
    for k in after["tensors"]:
        if rram.is_buffer(k):
            torch.testing.assert_close(port["tensors"][k], after["tensors"][k], rtol=1e-4, atol=1e-5, msg=k)
    # Adam's moments after its first step are the gradient and its square
    # (times 1 - beta): the median leaf reads 7e-4 here and 0.001-0.004 in
    # either side against float64 (the restoration decoder's norms over one
    # or two rows at the 4 x 4 bottleneck), the worst 6e-3; the encoder's
    # leaves read ~1 with the restoration loss's gradient kept from it
    for key in ("exp_avg", "exp_avg_sq"):
        _check_leaves(port[key], after[key], names, median=3e-3)
    # and its change, about lr x the gradient's sign: the median leaf 8e-5,
    # the worst 0.24 (a norm's bias whose gradient is round-off flips); a
    # step of the wrong sign reads 2, none 1
    change = lambda state: {k: state["tensors"][k] - host[k] for k in names}
    _check_leaves(change(port), change(after), names, median=1e-2, worst=0.5)


def test_predict_runs_eval_mode_without_dropout(tiny):
    state, weights = tiny
    img = torch.rand(3, S, S, 3, generator=torch.Generator().manual_seed(6)) * 255.0
    predict = make_predict_fn(port_cfg(), state.models)
    got = predict(img)
    assert state.models["encoder"].training  # restored after the call
    want = ref.predict(file_cfg(), weights, img.permute(0, 3, 1, 2) / 127.5 - 1.0, True)
    assert _close(got, want, 1e-5)
    assert torch.equal(got, predict(img))
    adapted = make_predict_fn(port_cfg(), state.models, bn_adapt=True)(img)
    assert adapted.shape == got.shape and torch.isfinite(adapted).all()


def test_checkpoints_round_trip(tiny, tmp_path):
    from ramdsir_tpu_torch.train.checkpoint import load_any_checkpoint, load_checkpoint, save_checkpoint
    from ramdsir_tpu_torch.utils.torch_compat import export_torch_checkpoint

    state, _ = tiny
    for p in (p for m in state.models.values() for p in m.parameters()):
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    state.step = 1
    save_checkpoint(str(tmp_path / "s.ckpt"), state)
    export_torch_checkpoint(str(tmp_path / "s.pth"), state.models)
    fresh = init_state(port_cfg(), torch.Generator().manual_seed(9), "cpu")
    load_checkpoint(str(tmp_path / "s.ckpt"), fresh)
    assert fresh.step == 1
    for name, m in state.models.items():
        for k, v in m.state_dict().items():
            assert torch.equal(v, fresh.models[name].state_dict()[k]), f"{name}.{k}"
    for p, q in zip((p for m in state.models.values() for p in m.parameters()),
                    (q for m in fresh.models.values() for q in m.parameters())):
        sp, sq = state.optimizer.state[p], fresh.optimizer.state[q]
        assert all(torch.equal(sp[k], sq[k]) for k in ("exp_avg", "exp_avg_sq"))
    other = init_state(port_cfg(), torch.Generator().manual_seed(8), "cpu")
    load_any_checkpoint(str(tmp_path / "s.pth"), other.models)
    assert all(torch.equal(v, other.models["encoder"].state_dict()[k])
               for k, v in state.models["encoder"].state_dict().items())


def test_draws_keep_the_unet_order_and_add_the_seeds_last():
    plain = sample_step_draws(torch.Generator().manual_seed(3), 5, torch.device("cpu"))
    with_seeds = sample_step_draws(torch.Generator().manual_seed(3), 5, torch.device("cpu"), dropout=True)
    assert list(with_seeds) == list(plain) + ["dropout_seed"]
    assert all(torch.equal(plain[k], with_seeds[k]) for k in plain)
    s = with_seeds["dropout_seed"]
    assert s.dtype == torch.int64 and s.shape == (5,) and int(s.min()) >= 0 and int(s.max()) < 2**31


def test_counters_and_the_cli_flag(tiny):
    from ramdsir_tpu_torch.cli.train import parse_args

    enc = tiny[0].models["encoder"]
    x = torch.randn(2 * B, 3, S, S, generator=torch.Generator().manual_seed(8))
    assert transunet.counters(enc) == {}
    with torch.no_grad():
        enc(x)  # not a training step's forward
    assert transunet.counters(enc) == {}
    enc(x[:B])
    enc(x, dual=True)
    assert transunet.counters(enc) == {"vit_tokens": 2 * B * (S // 16) ** 2, "attn_backend": "math"}
    assert parse_args(["--save_path", "x", "--model", "transunet_r50_b16"]).model == "transunet_r50_b16"
    assert parse_args(["--save_path", "x"]).model == "unet"


@pytest.mark.parametrize("change,words", [
    (dict(norm="gn"), "--norm gn"),
    (dict(norm="in"), "--norm in"),
    (dict(activation="leaky_relu"), "--activation"),
    (dict(deterministic=True), "--deterministic"),
    (dict(compute_dtype="bfloat16"), "bfloat16"),
    (dict(predict_dtype="bfloat16"), "bfloat16"),
    (dict(num_devices=2), "2 ranks"),
    (dict(image_size=72), "--image_size 72"),
    (dict(model="transunet_l16"), "unknown model"),
], ids=["gn", "in", "activation", "deterministic", "bf16", "bf16_predict", "ranks", "size", "unknown"])
def test_check_supported_refuses_what_transunet_does_not_run(monkeypatch, change, words):
    register(monkeypatch)
    check_supported(port_cfg())  # the tiny model's own configuration runs
    with pytest.raises(ValueError, match=words.replace("-", "\\-")):
        check_supported(dataclasses.replace(port_cfg(), **change))


def test_resolve_runs_a_transunet_without_the_unet_layout(monkeypatch):
    register(monkeypatch)
    cfg = dataclasses.replace(port_cfg(), s2d_levels=2).resolve()
    assert cfg.s2d_levels == 0
    check_supported(cfg)
    assert init_state(dataclasses.replace(port_cfg(), s2d_levels=2), torch.Generator().manual_seed(0),
                      "cpu").models["rec_decoder"].s2d_levels == 0
    assert TrainConfig().resolve().s2d_levels == 2  # the U-Net keeps its default

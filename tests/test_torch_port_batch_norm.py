"""The grouped train-mode batch norm's plain version (ops/batch_norm.py), the
CPU side of csrc/batch_norm.cu, against the composition the port ran before
it: F.batch_norm a half joined by torch.cat under dual=True, and DSBN's
per-domain loop; the chunking the kernels take; the layouts and their
refusals; and the routing in models/norm.py.  Imports no JAX.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ramdsir_tpu_torch.models.norm import BatchNorm, DomainSpecificBatchNorm, recomputing
from ramdsir_tpu_torch.ops import batch_norm as bn_ops
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

# float32 sums over the same values in another order than aten's
OUT_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=5e-5, rtol=1e-5)  # sums over every row of a channel
STAT_TOL = dict(atol=1e-6, rtol=1e-6)


def _composed(x, groups, weights, biases, running_means, running_vars, momentum=0.1, eps=1e-5):
    """The port's norm before the grouped kernels: cuDNN's / aten's
    F.batch_norm on a group of real rows only, else the batch statistics of
    its real rows through var_mean, then torch.cat."""
    pieces, start = [], 0
    for rows, stat_rows, slot in groups:
        xg = x[start : start + rows]
        w, b, rm, rv = weights[slot], biases[slot], running_means[slot], running_vars[slot]
        if stat_rows == rows:
            pieces.append(F.batch_norm(xg, rm, rv, w, b, True, momentum, eps))
        else:
            var, mean = torch.var_mean(xg[:stat_rows], dim=(0, 2, 3), correction=0)
            n = stat_rows * xg.shape[2] * xg.shape[3]
            with torch.no_grad():
                rm.mul_(1.0 - momentum).add_(mean, alpha=momentum)
                rv.mul_(1.0 - momentum).add_(var * (n / (n - 1.0)), alpha=momentum)
            scale = w * torch.rsqrt(var + eps)
            pieces.append((xg - mean[:, None, None]) * scale[:, None, None] + b[:, None, None])
        start += rows
    return torch.cat(pieces)


def _params(c, slots, seed):
    g = torch.Generator().manual_seed(seed)
    weights = [(0.5 + torch.rand(c, generator=g)).requires_grad_() for _ in range(slots)]
    biases = [torch.randn(c, generator=g).requires_grad_() for _ in range(slots)]
    rms = [torch.randn(c, generator=g) for _ in range(slots)]
    rvs = [0.5 + torch.rand(c, generator=g) for _ in range(slots)]
    return weights, biases, rms, rvs


def _clone(ts):
    return [t.detach().clone().requires_grad_(t.requires_grad) for t in ts]


def _check_against_composition(groups, c=5, h=6, w=8, seed=0):
    """grouped_batch_norm against the composition on the same inputs: y,
    the gradients of x, every weight and bias, and the running buffers."""
    layout = bn_ops.Layout(tuple(groups))
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((layout.rows, c, h, w), generator=gen) * 2.0 + 0.5).requires_grad_()
    dy = torch.randn((layout.rows, c, h, w), generator=gen)
    weights, biases, rms, rvs = _params(c, layout.slots, seed + 1)
    x2, w2, b2, rm2, rv2 = _clone([x]), _clone(weights), _clone(biases), _clone(rms), _clone(rvs)
    y = bn_ops.grouped_batch_norm(x, layout, weights, biases, rms, rvs, 0.1, 1e-5)
    want = _composed(x2[0], groups, w2, b2, rm2, rv2)
    torch.testing.assert_close(y, want, **OUT_TOL)
    grads = torch.autograd.grad(y, [x, *weights, *biases], dy)
    grads2 = torch.autograd.grad(want, [x2[0], *w2, *b2], dy)
    for got, exp in zip(grads, grads2):
        torch.testing.assert_close(got, exp, **GRAD_TOL)
    for got, exp in zip(rms + rvs, rm2 + rv2):
        torch.testing.assert_close(got, exp, **STAT_TOL)


@pytest.mark.parametrize("groups", [
    [(7, 7, 0)],  # plain BN, G = 1
    [(7, 3, 0)],  # an n_valid prefix
    [(6, 6, 0), (6, 6, 0)],  # dual: two halves, one slot
    [(6, 4, 0), (6, 4, 0)],  # dual with padding rows in each half
], ids=["g1", "g1_prefix", "dual", "dual_prefix"])
def test_halves_match_per_half_composition(groups):
    _check_against_composition(groups)


@pytest.mark.parametrize("groups", [
    [(3, 3, 0), (6, 6, 1), (7, 7, 2)],  # fundus's 3 + 6 + 7
    [(2, 2, 0), (2, 2, 1), (2, 2, 2), (2, 2, 3), (2, 2, 4)],  # prostate's 5 x 2
    [(3, 3, 0), (6, 6, 1), (7, 2, 2)],  # the last domain's rows partly padding
], ids=["fundus_3_6_7", "prostate_5x2", "padded_tail"])
def test_domains_match_per_domain_composition(groups):
    _check_against_composition(groups, seed=3)


def test_float64_backward_is_the_exact_gradient():
    """The plain backward (the kernels' arithmetic) is the gradient of the
    plain forward, statistics and padding rows included (gradcheck in
    float64): the reference the card's kernels are held to."""
    layout = bn_ops.Layout(((3, 2, 0), (3, 3, 0), (2, 1, 1)))
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((8, 3, 2, 4), generator=gen, dtype=torch.float64, requires_grad=True)
    weights = [torch.rand(3, generator=gen, dtype=torch.float64).add(0.5).requires_grad_() for _ in range(2)]
    biases = [torch.randn(3, generator=gen, dtype=torch.float64, requires_grad=True) for _ in range(2)]

    def fn(x, *params):
        return bn_ops.GroupedBatchNorm.apply(x, layout, [None, None], [None, None], 0.1, 1e-5, *params)

    assert torch.autograd.gradcheck(fn, (x, *weights, *biases))


# --- the modules' routing ---------------------------------------------------------------


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("n_valid", [None, 2])
def test_batchnorm_routes_float32_training_through_grouped(dual, n_valid, monkeypatch):
    """BatchNorm in float32 training makes one grouped call, halves of one
    slot under dual (no chunk, no cat), and gives the composition's
    numbers."""
    calls = []
    real = bn_ops.GroupedBatchNorm.apply
    monkeypatch.setattr(bn_ops.GroupedBatchNorm, "apply", lambda *a: calls.append(a[1]) or real(*a))
    bn = BatchNorm(4).train()
    x = torch.randn((8, 4, 4, 4), generator=torch.Generator().manual_seed(2))
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    y = bn(x, dual=dual, n_valid=n_valid)
    rows = 4 if dual else 8
    layout = bn_ops.halves(rows, 2 if dual else 1, n_valid)
    assert calls == [layout]
    want = _composed(x, layout.groups, [bn.weight], [bn.bias], [rm], [rv])
    torch.testing.assert_close(y, want, **OUT_TOL)
    torch.testing.assert_close(bn.running_var, rv, **STAT_TOL)


@pytest.mark.parametrize("labels, n_real, grouped", [
    ([0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2], 16, True),  # the train step's blocks
    ([2, 2, 0, 0, 0, 1], 6, True),  # contiguous, in another order
    ([0, 1, 0, 1], 4, False),  # a domain in two blocks: the loop
    ([0, 0, 1, 1, 2], 3, False),  # domain 2 has no real row: its running statistics
])
def test_dsbn_segments(labels, n_real, grouped, monkeypatch):
    """Segment-mode DSBN with contiguous domains, each with a real row,
    makes one grouped call with a slot a domain; any other labelling keeps
    the per-domain loop; both give the loop's numbers."""
    labels = np.array(labels)
    calls = []
    real = bn_ops.GroupedBatchNorm.apply
    monkeypatch.setattr(bn_ops.GroupedBatchNorm, "apply", lambda *a: calls.append(len(a[1].groups)) or real(*a))
    d = DomainSpecificBatchNorm(3, 3).train()
    with torch.no_grad():
        for i, b in enumerate(d.bns):
            b.weight.fill_(1.0 + 0.25 * i)
            b.bias.fill_(0.1 * i)
    x = torch.randn((len(labels), 3, 4, 4), generator=torch.Generator().manual_seed(4))
    before = [(b.running_mean.clone(), b.running_var.clone()) for b in d.bns]
    y = d(x, labels, n_valid=n_real)
    # the loop of single-domain norms, on copies of the buffers
    want = torch.empty_like(x)
    for dom in np.unique(labels):
        rows = np.flatnonzero(labels == dom)
        b = d.bns[int(dom)]
        rm, rv = before[int(dom)][0].clone(), before[int(dom)][1].clone()
        ns = int(np.sum(rows < n_real))
        xd = x[torch.as_tensor(rows)]
        if ns == 0:
            got = F.batch_norm(xd, rm, rv, b.weight, b.bias, False, 0.0, b.eps)
        else:
            got = _composed(xd, [(len(rows), ns, 0)], [b.weight], [b.bias], [rm], [rv])
        want[torch.as_tensor(rows)] = got
        torch.testing.assert_close(b.running_mean, rm, **STAT_TOL)
    torch.testing.assert_close(y, want, **OUT_TOL)
    assert (calls == [len(np.unique(labels))]) == grouped


def test_recomputing_updates_copies_only():
    """Under `recomputing` the dual BatchNorm and segment DSBN give the
    same output bit for bit and leave their running statistics alone."""
    bn = BatchNorm(3).train()
    dsbn = DomainSpecificBatchNorm(3, 2).train()
    x = torch.randn((6, 3, 4, 4), generator=torch.Generator().manual_seed(6))
    labels = np.array([0, 0, 0, 1, 1, 1])
    with recomputing(bn, dsbn):
        y1, z1 = bn(x, dual=True), dsbn(x, labels)
    assert torch.equal(bn.running_mean, torch.zeros(3)) and torch.equal(bn.running_var, torch.ones(3))
    assert all(torch.equal(b.running_var, torch.ones(3)) for b in dsbn.bns)
    y2, z2 = bn(x, dual=True), dsbn(x, labels)
    assert torch.equal(y1, y2) and torch.equal(z1, z2)
    assert not torch.equal(bn.running_mean, torch.zeros(3))


# --- the kernels' chunking and the layouts ---------------------------------------------


@pytest.mark.parametrize("rows, c, hw, groups", [
    (32, 16, 256 * 256, (16, 16)), (32, 256, 16 * 16, (16, 16)), (16, 128, 16 * 16, (3, 6, 7)),
    (20, 16, 384 * 384, (10, 10)), (20, 32, 384 * 384, (10, 10)), (10, 16, 24 * 24, (2, 2, 2, 2, 2)),
    (7, 5, 30, (7,)),  # H*W % 4 != 0: the 1-float vectors
])
def test_plan_covers_every_vector(rows, c, hw, groups):
    """Every group's vectors fall in its chunks, the last chunk holds at
    least one, a chunk is whole rounds of BLOCK vectors (1 to 16 a thread),
    and a main-path layer gives every SM of an H100 units to run."""
    layout = bn_ops.Layout(tuple((r, r, i) for i, r in enumerate(groups)))
    vec = hw % 4 == 0
    p = bn_ops.plan(layout, c, hw, vec, 132)
    qv = hw // 4 if vec else hw
    assert p.vec == vec and p.unit_vectors % bn_ops.BLOCK == 0
    assert bn_ops.BLOCK <= p.unit_vectors <= bn_ops.MAX_UNIT_VECTORS
    for r, k in zip(groups, p.chunks):
        assert (k - 1) * p.unit_vectors < r * qv <= k * p.unit_vectors
    assert p.stat_chunks == p.chunks
    if rows * c * hw >= 2**20:
        assert c * sum(p.chunks) >= 132


def test_layout_refusals():
    x = torch.zeros((6, 2, 2, 4))
    w, b = [torch.ones(2)], [torch.zeros(2)]
    for groups, match in [
        (((3, 3, 0),), "hold 3 rows"),
        (((3, 0, 0), (3, 3, 0)), "statistics from 0"),
        (((3, 3, 1), (3, 3, 1)), "slots"),
        (((3, 3, 0), (3, 3, 2)), "slots"),
        (((1, 1, 0),) * 6 + ((0, 0, 0),) * 3, "1 to 8 groups"),
    ]:
        with pytest.raises(ValueError, match=match):
            bn_ops.grouped_batch_norm(x, bn_ops.Layout(groups), w, b, [None], [None], 0.1, 1e-5)
    with pytest.raises(ValueError, match="2 slots"):
        bn_ops.grouped_batch_norm(x, bn_ops.Layout(((3, 3, 0), (3, 3, 1))), w, b, [None], [None], 0.1, 1e-5)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        bn_ops._forward_kernels(x, bn_ops.halves(6, 1), w, b, [None], [None], 0.1, 1e-5)

"""The ranks' side of tests/test_torch_port_ddp.py and of the card's ddp
tests: functions that `parallel.distributed.launch` runs in each rank.

Spawned ranks import this module by name, so it imports torch and the port
only (not JAX, not the root conftest).  Each function also runs without a
process group, in the test's own process, as the single-process reference.
"""
import hashlib
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ramdsir_tpu_torch.config import TrainConfig
from ramdsir_tpu_torch.models.norm import BatchNorm, DomainSpecificBatchNorm
from ramdsir_tpu_torch.ops import cuda_build
from ramdsir_tpu_torch.parallel import distributed
from ramdsir_tpu_torch.parallel.mesh import pad_batch, rank_rows, replicate_state
from ramdsir_tpu_torch.train.state import init_state
from ramdsir_tpu_torch.train.steps import make_train_step

NAMES = ("encoder", "seg_decoder", "rec_decoder")


def _world_rank():
    return distributed.world(), distributed.rank()


def state_digest(state) -> str:
    """A hash of every parameter, buffer and Adam moment of `state`, and its
    step: equal digests are bit-equal replicas."""
    h = hashlib.sha256(str(state.step).encode())
    for m in state.models.values():
        for t in m.state_dict().values():
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    for st in state.optimizer.state.values():
        for k in sorted(st):
            h.update(torch.as_tensor(st[k]).detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def local_rows(batch: Dict[str, np.ndarray], b_real: int) -> Dict[str, torch.Tensor]:
    """This process's rows of a global numpy batch: pad_batch to the world
    size, then rank_rows (the whole batch without a group)."""
    world, rank = _world_rank()
    if world == 1 and not distributed.in_group():
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    rows, _ = rank_rows(b_real, world, rank)
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in pad_batch(batch, world).items()}


def step_case(
    cfg_kw: dict,
    bsl: Sequence[int],
    batches: Sequence[Dict[str, np.ndarray]],
    ratios: Sequence[np.ndarray],
    sds: Optional[Dict[str, dict]] = None,
    device: str = "cpu",
    total_iters: int = 10,
    viz: bool = False,
) -> dict:
    """len(batches) train steps from the seed's state (or the state dicts
    `sds`, the JAX init carried over) on this process's rows of each global
    batch, with the ratios given: the metrics of each step, the first step's
    gradients and state (and with viz its image-grid slices), the last
    state, each step's state digest and K1's launches."""
    cfg = TrainConfig(**cfg_kw, device=device).resolve()
    state = init_state(cfg, torch.Generator().manual_seed(0), device)
    if sds:
        for name, sd in sds.items():
            state.models[name].load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    step = make_train_step(cfg, total_iters, batch_size_list=list(bsl), debug_grads=True)
    b_real = sum(bsl)
    out: dict = {"metrics": [], "digests": []}
    launches = k1_launches()
    for i, (batch, ratio) in enumerate(zip(batches, ratios)):
        local = {k: v.to(device) for k, v in local_rows(batch, b_real).items()}
        m = step(state, local, draws={"ratio": torch.from_numpy(np.asarray(ratio, np.float32)).to(device)},
                 viz=viz and i == 0)
        grads = m.pop("_grads")
        if "_viz" in m:
            out["viz"] = {k: v.cpu().numpy() for k, v in m.pop("_viz").items()}
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["digests"].append(state_digest(state))
        if i == 0:
            out["grads"] = {n: {k: g.cpu().numpy() for k, g in gs.items()} for n, gs in grads.items()}
            out["state0"] = snapshot(state)
    out["state"] = snapshot(state)
    out["k1_launches"] = k1_launches() - launches
    return out


def k1_launches() -> int:
    """K1's runs on the card so far, over its paths."""
    return sum(k for name, k in cuda_build.launch_counts().items() if name.startswith("ram_mix."))


def snapshot(state) -> Dict[str, Dict[str, np.ndarray]]:
    return {n: {k: v.detach().cpu().numpy().copy() for k, v in m.state_dict().items()} for n, m in state.models.items()}


def norm_case(kind: str, x: np.ndarray, cot: np.ndarray, n_real: int, labels: Optional[np.ndarray] = None,
              dual: bool = False, device: str = "cpu") -> dict:
    """A BatchNorm (kind 'bn', dual or not) or a 4-domain DSBN (kind 'dsbn',
    per-row labels) in training on this process's rows of the global x
    (B, C, H, W), of which the first n_real rows (of each half under dual)
    are real: the output, the input's and the affine's gradients of the
    objective sum(y * cot) over this process's rows, and the running
    statistics after the update."""
    world, rank = _world_rank()
    grouped = distributed.in_group()
    torch.manual_seed(0)
    c = x.shape[1]
    mod = BatchNorm(c) if kind == "bn" else DomainSpecificBatchNorm(c, 4)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.linspace(0.5, 1.5, p.numel()).reshape(p.shape))
    mod.to(device).train()
    halves = 2 if dual else 1
    b = x.shape[0] // halves
    if grouped:
        rows, n_local = rank_rows(n_real, world, rank)
        per = rows.stop - rows.start

        def take(a):  # this rank's rows of each half, the padding zero
            parts = [pad_batch({"a": h[:n_real]}, world)["a"][rows] for h in np.split(a, halves)]
            return np.concatenate(parts)
    else:
        rows, n_local, per = slice(0, b), n_real, b
        take = lambda a: a
    xl = torch.from_numpy(take(x)).to(device).requires_grad_(True)
    cl = torch.from_numpy(take(cot)).to(device)
    n_valid = None if n_local == per else n_local
    if kind == "bn":
        y = mod(xl, dual=dual, n_valid=n_valid)
    else:
        lab = np.concatenate([labels[:n_real], np.zeros(world * per - n_real, labels.dtype)])[rows]
        y = mod(xl, np.asarray(lab), n_valid=n_valid)
    # the objective counts real rows only, as the step's losses do
    keep = torch.cat([torch.arange(per) < n_local] * halves).to(device)
    (y * cl)[keep].sum().backward()
    return {
        "y": y.detach().cpu().numpy()[keep.cpu().numpy()],
        "grad_x": xl.grad.cpu().numpy()[keep.cpu().numpy()],
        "grad_params": {k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.cpu().numpy()
                        for k, p in mod.named_parameters()},
        "buffers": {k: v.cpu().numpy() for k, v in mod.named_buffers()},
    }


def fit_case(cfg_kw: dict, max_steps: int, device: str = "cpu") -> dict:
    """`fit` (rank 0 writes cfg_kw's save_path): the summary and, on rank 0,
    the logged losses by step."""
    from ramdsir_tpu_torch.train.loop import fit
    import json

    cfg = TrainConfig(**cfg_kw, device=device)
    summary = fit(cfg, max_steps=max_steps)
    out = {"summary": {k: v for k, v in summary.items() if isinstance(v, (int, float, str))}}
    if distributed.rank() == 0:
        with open(os.path.join(cfg.save_path, "log", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        out["losses"] = {r["step"]: r["loss/loss"] for r in rows if "loss/loss" in r}
    return out


def replicate_case(cfg_kw: dict, bsl: Sequence[int], batch: Dict[str, np.ndarray], ratio: np.ndarray,
                   device: str = "cpu") -> dict:
    """One step (so Adam holds moments), then every rank other than 0 moves
    its parameters, buffers, moments and step, and replicate_state
    broadcasts rank 0's: the digests before and after."""
    cfg = TrainConfig(**cfg_kw, device=device).resolve()
    state = init_state(cfg, torch.Generator().manual_seed(0), device)
    step = make_train_step(cfg, 10, batch_size_list=list(bsl))
    step(state, {k: v.to(device) for k, v in local_rows(batch, sum(bsl)).items()},
         draws={"ratio": torch.from_numpy(ratio).to(device)})
    before = state_digest(state)
    if distributed.rank() != 0:
        with torch.no_grad():
            for m in state.models.values():
                for t in m.state_dict().values():
                    t.add_(1.0)
            for st in state.optimizer.state.values():
                for v in st.values():
                    v.add_(1.0)
        state.step += 5
    moved = state_digest(state)
    replicate_state(state)
    return {"before": before, "moved": moved, "after": state_digest(state), "step": state.step}


CASES = {"step": step_case, "norm": norm_case, "fit": fit_case, "replicate": replicate_case}


def exact_float32() -> None:
    """float32 convolutions and products without TF32, deterministic cuDNN:
    the card's settings for a comparison."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False


def run_cases(rank: int, device, cases: List[tuple], threads: int = 1) -> Dict[str, dict]:
    """One launched rank: each (name, kind, kwargs) of `cases` in order (on
    a card with exact_float32)."""
    torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        exact_float32()
    return {name: CASES[kind](**kw, device=str(device)) for name, kind, kw in cases}


def raise_on_rank(rank: int, device, bad: int) -> None:
    """Rank `bad` raises before the barrier the others wait in."""
    if rank == bad:
        raise ValueError(f"rank {rank} raises on purpose")
    torch.distributed.barrier()

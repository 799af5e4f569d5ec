"""The training cells: the port's window runner driven as `fit` drives it.

Everything of the model is the configuration's family's
(`families/<reference>.py`): the port's TrainConfig, with the file's
`program` options, the train stack, each step's draws, the reference's
view of the data and the work a step counts.  As in `fit`, set-up, the
compared steps, the warm-up and the window run inside the program's
`train.loop.deterministic_mode(cfg.deterministic)`.

Set-up builds one training state from the seed (the benchmark's data and
weights), the device pipeline over the data and the window step
`train.steps.make_train_step(cfg, ..., scan=True, window=W)`, W from
`train.loop.scan_window_size` with one-epoch segments.  Its first calls
run the compared steps (below); a short window then times a step for the
window's schedule.  The window runs the epochs' plans in windows of
min(W, left in the epoch, what
fits in the time left) steps, each window's metrics appended to
`utils.logging.DeviceMetricsRing` and, at a window that holds a log step,
its image-grid slices to `DeviceVizRing` (the calls of
`train.loop._train.run_scan_segment`), with no eval; at most two windows
are in flight.  It ends at a synchronise.

The compared steps run through the window's own calls: the first three in
one call (the graph's two eager steps, its capture and a replay), each
later one a call of one replay; the program's state (parameters, running
statistics, Adam's moments) is kept on the host at every step boundary
(`compared_steps`).

The check, once the window has closed and the program's state is freed:
the plain reference (`reference/<config's reference>.py`) takes each
compared step from the program's state before it, with the same data,
rows and draws: step 1 from the seed's weights, each later one from where
the program's previous step left it.  The chain of steps from the seed
alone is not compared: round-off moves it by as much as a fault does (a
float32 reference against itself with another convolution algorithm:
loss gaps of up to 9e-3 and leaf changes of 0.13 within three steps).  Each
step's loss, its gradient as Adam's moments hold it (exp_avg_i - beta1 x
exp_avg_(i-1)) / (1 - beta1) and each leaf's change are held to the cell's
limits."""
from __future__ import annotations

import gc
import os
import statistics
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from port_bench.lib import common, synth
from port_bench.lib.trace import traced

WINDOW_SPAN = "port_bench.window"


def make_pipeline(c: Mapping, cfg, data: Mapping, seed: int, device):
    """The port's device pipeline over the stack: each source domain's rows
    are its training samples and, every train domain being a source, the
    donor pool."""
    from ramdsir_tpu_torch.config import FUNDUS_DOMAINS, PROSTATE_DOMAINS
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline, DeviceProstatePipeline

    names = FUNDUS_DOMAINS if c["dataset"] == "fundus" else PROSTATE_DOMAINS
    doms = [names[d] for d in c["domain_idxs"]]
    starts = np.cumsum([0] + data["sizes"])
    kw = dict(is_out_domain=cfg.is_out_domain, seed=seed, precompute_donor_amp=True, device=device)
    bsl = cfg.batch_size_list[: len(doms)]
    if c["dataset"] == "fundus":
        arrays = {d: {"images": data["images"][starts[i] : starts[i + 1]], "masks": data["masks"][starts[i] : starts[i + 1]]}
                  for i, d in enumerate(doms)}
        return DeviceFundusPipeline.from_arrays(arrays, c["domain_idxs"], bsl, c["test_domain_idx"], **kw)
    offsets = {d: (int(starts[i]), int(data["sizes"][i])) for i, d in enumerate(doms)}
    return DeviceProstatePipeline(data["images"], data["masks"], offsets, doms, doms, bsl, **kw)


class WindowLoop:
    """The window runner and the loop's state around it; cfg: the port's
    TrainConfig (the family's `program_config`)."""

    def __init__(self, c: Mapping, cfg, seed: int, device, weights, data):
        from ramdsir_tpu_torch.train.loop import scan_window_size
        from ramdsir_tpu_torch.train.state import init_state
        from ramdsir_tpu_torch.train.steps import make_train_step
        from ramdsir_tpu_torch.utils.logging import DeviceMetricsRing, DeviceVizRing, MetricsWriter
        from ramdsir_tpu_torch.utils.profiler import StepTimer

        self.device = torch.device(device)
        self.cfg = cfg
        self.pipeline = make_pipeline(c, self.cfg, data, seed, device)
        self.state = init_state(self.cfg, torch.Generator().manual_seed(seed), device)
        common.load_weights(self.state.models, weights)
        self.steps_per_epoch = len(self.pipeline)
        self.total_iters = self.steps_per_epoch * self.cfg.resolve().epochs
        self.W, _ = scan_window_size(self.cfg.resolve(), self.steps_per_epoch, 1, None, True)
        self.runner = make_train_step(self.cfg, self.total_iters, batch_size_list=self.pipeline.batch_sizes,
                                      device_data=self.pipeline.device_data, scan=True, window=self.W)
        self.B = sum(self.pipeline.batch_sizes)
        self.planner = synth.EpochPlanner(data["sizes"], self.pipeline.batch_sizes, self.cfg.is_out_domain, seed)
        self.generator = torch.Generator().manual_seed(seed)
        self.writer = MetricsWriter(os.path.join(cfg.save_path, "log"))
        self.ring = DeviceMetricsRing(self.writer, log_interval=self.cfg.log_interval)
        self.vizring = DeviceVizRing()
        self.timer = StepTimer(device=device)
        self.log_every = self.cfg.log_images_every
        self.plan: Optional[Dict[str, np.ndarray]] = None
        self.pos = 0
        self.step = 0

    def window(self, n: int):
        """One window of min(n, W, left in the epoch) steps; (steps, metrics)."""
        if self.plan is None or self.pos >= len(self.plan["img_idx"]):
            self.plan, self.pos = self.planner.epoch(), 0
        w = min(n, self.W, len(self.plan["img_idx"]) - self.pos)
        want_viz = bool(self.log_every) and any((self.step + i) % self.log_every == 0 for i in range(w))
        rows = {k: v[self.pos : self.pos + w] for k, v in self.plan.items()}
        with torch.profiler.record_function("port_bench.window_call"):
            metrics, viz = self.runner(self.state, rows, self.generator, viz=want_viz, timer=self.timer)
        with torch.profiler.record_function("port_bench.ring_append"):
            self.ring.append(self.step, metrics)
            if want_viz:
                self.vizring.append(self.step + w - 1, viz)
        self.step += w
        self.pos += w
        return w, metrics

    def timed(self, seconds: float, step_s: float):
        """Windows for `seconds`, sized by the predicted device time of what
        is queued; (steps, wall seconds to the final synchronise)."""
        cuda = self.device.type == "cuda"
        common.sync(self.device)
        t0 = time.perf_counter()
        deadline, queued_until = t0 + seconds, t0
        events, steps = [], 0
        with torch.profiler.record_function(WINDOW_SPAN):
            while True:
                start = max(time.perf_counter(), queued_until)
                n = int((deadline - start) / step_s)
                if n < 1:
                    if steps:
                        break
                    n = 1
                w, _ = self.window(n)
                steps += w
                queued_until = start + w * step_s
                if cuda:
                    events.append(torch.cuda.Event())
                    events[-1].record()
                    if len(events) >= 3:
                        events[-3].synchronize()  # at most two windows in flight
            common.sync(self.device)
        return steps, time.perf_counter() - t0

    def free(self) -> None:
        self.writer.close()
        for k in ("runner", "state", "pipeline", "ring", "vizring", "timer"):
            setattr(self, k, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def host_state(loop: WindowLoop) -> Dict[str, Dict[str, torch.Tensor]]:
    """The program's state on the host under the weights' names: tensors
    (parameters and running statistics), exp_avg and exp_avg_sq."""
    state = loop.state
    tensors = {n: t.detach().to("cpu", copy=True) for n, t in common.named_state(state.models).items()}
    names = {p: f"{m}.{k}" for m, mod in state.models.items() for k, p in mod.named_parameters()}
    out = {"tensors": tensors, "exp_avg": {}, "exp_avg_sq": {}}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            st = state.optimizer.state.get(p, {})
            for key in ("exp_avg", "exp_avg_sq"):
                out[key][names[p]] = (st[key] if key in st else torch.zeros_like(p)).detach().to("cpu", copy=True)
    return out


def compared_steps(loop: WindowLoop, k: int):
    """Run the first k steps through the window's calls, the first
    GRAPH_WARMUP_STEPS + 1 in one call (on a card: the eager steps, the
    capture, a replay) and each later step in a call of its own (a
    replay); (the steps' logged losses, {i: the program's state after i
    steps}).  The state is read before the first call, after every call,
    and after every eager step (Adam's step post-hook, which a graph's
    replay does not run)."""
    from ramdsir_tpu_torch.train.steps import GRAPH_WARMUP_STEPS

    cuda = loop.device.type == "cuda"
    states, losses, eager = {0: host_state(loop)}, [], [0]

    def after_step(opt, args, kwargs):
        if cuda and torch.cuda.is_current_stream_capturing():
            return
        eager[0] += 1
        states[eager[0]] = host_state(loop)

    handle = loop.state.optimizer.register_step_post_hook(after_step)
    try:
        first, done = min(k, GRAPH_WARMUP_STEPS + 1), 0
        for n in [first] + [1] * (k - first):
            w, metrics = loop.window(n)
            done += w
            losses += metrics["loss"].detach().cpu().double().tolist()
            states[done] = host_state(loop)
    finally:
        handle.remove()
    return losses, states


def run(ctx) -> Dict:
    """One run of a training cell.  ctx: see `harness.Context`."""
    from ramdsir_tpu_torch.train.loop import deterministic_mode

    c, traffic, seed, device = ctx.cfg, ctx.traffic, ctx.seed, ctx.device
    k = int(traffic["compared_steps"])
    phases = {}
    mark = lambda name: phases.__setitem__(name, time.perf_counter() - ctx.t0)
    mark("start")
    cfg = ctx.family.program_config(c, str(device), os.path.join(ctx.workdir, "run"))
    with deterministic_mode(cfg.deterministic):
        data = ctx.family.make_data(c, seed, device)
        mark("data")
        weights = ctx.reference.make_weights(c, seed, device)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        loop = WindowLoop(c, cfg, seed, device, weights, data)
        del weights
        mark("program")

        draw_state = loop.generator.get_state()
        loop.plan, loop.pos = loop.planner.epoch(), 0
        plan0 = {kk: v[:k].copy() for kk, v in loop.plan.items()}
        prog_losses, prog_states = compared_steps(loop, k)
        mark("compared_steps")

        warm = int(traffic["warmup_steps"])
        common.sync(device)
        t = time.perf_counter()
        w, _ = loop.window(warm)
        common.sync(device)
        step_s = (time.perf_counter() - t) / w
        setup_s = time.perf_counter() - ctx.t0
        mark("warmup")

        trace_out = []
        if ctx.trace:
            with traced(WINDOW_SPAN, trace_out):
                steps, wall = loop.timed(float(traffic["trace_seconds"]), step_s)
        else:
            steps, wall = loop.timed(ctx.seconds, step_s)
        peak = torch.cuda.max_memory_reserved(device) if torch.device(device).type == "cuda" else 0
        host = {"setup_s": setup_s, "window_s": wall, "steps": steps, "images": steps * loop.B}
        total_iters, b, w_size = loop.total_iters, loop.B, loop.W
        loop.free()
        del loop
        gc.collect()
    record_counts = ctx.family.step_counts(c)

    check = compare(ctx, c, data, prog_losses, prog_states, plan0, draw_state, b, total_iters)
    extra = {"setup_phases_s": phases, "W": w_size, **check.pop("record")}
    return dict(host=host, peak=peak, counts=record_counts, trace=trace_out[0] if trace_out else None,
                traced_steps=steps if ctx.trace else 0, check=check, extra=extra)


def compare(ctx, c, data, losses, states, plan0, draw_state, b, total_iters) -> Dict:
    """`numbers` of the program's compared steps.  A state that was never
    read (an optimizer step that ran no post-hook, as a replaced one) leaves
    nothing to compare: every number reads inf."""
    k = len(plan0["img_idx"])
    missing = sorted(set(range(k + 1)) - set(states))
    if missing or len(losses) != k:
        inf = float("inf")
        return {"loss_gap": inf, "grad_gap": inf, "change_gap": inf, "grad_median_gap": inf,
                "change_median_gap": inf, "record": {"states_missing": missing, "losses": len(losses)}}
    ordered = [states[i] for i in range(k + 1)]
    return numbers(losses, ordered, *follow(ctx, c, data, ordered, plan0, draw_state, b, total_iters))


def plan_draws(ctx, plan0: Mapping, draw_state, b: int):
    """Each compared step's (img_idx, donor_idx, draws)."""
    gen = torch.Generator()
    gen.set_state(draw_state)
    k = len(plan0["img_idx"])
    return [(np.asarray(plan0["img_idx"][i]), np.asarray(plan0["donor_idx"][i]),
             ctx.family.step_draws(ctx.cfg, gen, b)) for i in range(k)]


def follow(ctx, c, data, states, plan0, draw_state, b, total_iters):
    """The plain reference's steps, step i from states[i - 1] (the state
    before it): (losses, gradients, tensors after each step)."""
    ref_data = ctx.family.reference_data(c, data)
    losses, grads, after = [], [], []
    for i, (img_idx, donor_idx, draws) in enumerate(plan_draws(ctx, plan0, draw_state, b)):
        st = states[i]
        trainer = ctx.reference.ReferenceTrainer(c, st["tensors"], ref_data, total_iters, device=ctx.device,
                                                 moments=(st["exp_avg"], st["exp_avg_sq"]), steps=i)
        losses.append(trainer.step(img_idx, donor_idx, draws))
        grads.append({n: g.detach().cpu() for n, g in trainer.grads.items()})
        after.append({n: t.detach().cpu() for n, t in trainer.tensors.items()})
    return losses, grads, after


def chain(ctx, c, data, weights, plan0, draw_state, b, total_iters, dtype=torch.float32, half_batch=False,
          tf32_convs=False):
    """The reference put in the program's place: its steps chained from
    the seed's weights, (losses, the state before each step and after the
    last).  dtype bfloat16: the control; half_batch: a fault, the second
    half of every batch replaced by the first half (half the rows left out,
    the means over the rest); tf32_convs: the convolutions in TF32, the
    precision the configuration states for the program (a witness)."""
    trainer = ctx.reference.ReferenceTrainer(c, weights, ctx.family.reference_data(c, data), total_iters,
                                             dtype=dtype, device=ctx.device, tf32_convs=tf32_convs)
    losses, states = [], [trainer.snapshot()]
    for img_idx, donor_idx, draws in plan_draws(ctx, plan0, draw_state, b):
        if half_batch:
            h = b // 2
            img_idx, donor_idx = img_idx.copy(), donor_idx.copy()
            img_idx[b - h :], donor_idx[b - h :] = img_idx[:h], donor_idx[:h]
            draws = {kk: torch.cat([v[:h], v[:h]]) if b == 2 * h else v for kk, v in draws.items()}
        losses.append(trainer.step(img_idx, donor_idx, draws))
        states.append(trainer.snapshot())
    return losses, states


def step_gradients(states, beta1: float = 0.9):
    """Each step's gradient as Adam's moments hold it, (exp_avg_i - beta1
    exp_avg_(i-1)) / (1 - beta1), from the states at the step boundaries."""
    out = []
    for before, after in zip(states[:-1], states[1:]):
        out.append({n: (after["exp_avg"][n].double() - beta1 * before["exp_avg"][n].double()) / (1 - beta1)
                    for n in after["exp_avg"]})
    return out


def numbers(prog_losses, prog_states, ref_losses, ref_grads, ref_after) -> Dict:
    """The compared numbers, each the worst over the compared steps, step i
    of the reference taken from the state before the side's step i:
    loss_gap, the relative gap of the step's loss; grad_gap, the worst
    leaf's gap of the gradient norms (`common.leaf_gaps`); change_gap, the
    worst leaf's gap of the norms of the step's change, over the
    parameters whose reference gradient is at least a thousandth of the
    median leaf's (`common.counted_leaves`) and the running statistics;
    grad_median_gap and change_median_gap, the median leaf's.  Under
    "record", not compared: each step's loss gap, grad gap and change gap,
    and the worst leaves' names."""
    prog_grads = step_gradients(prog_states)
    rec = {"loss_gaps": [], "grad_gaps": [], "change_gaps": [], "grad_worst": [], "change_worst": []}
    med_g, med_d = [], []
    for i, (pl, rl) in enumerate(zip(prog_losses, ref_losses)):
        rec["loss_gaps"].append(abs(pl - rl) / max(abs(rl), 1e-30))
        names = sorted(ref_grads[i])
        g = common.leaf_gaps({n: prog_grads[i].get(n, torch.zeros(1)) for n in names}, ref_grads[i], names)
        before, after = prog_states[i]["tensors"], prog_states[i + 1]["tensors"]
        counted = common.counted_leaves(ref_grads[i]) + [n for n in ref_after[i] if running_statistic(n)]
        d_prog = {n: after[n].double() - before[n].double() for n in counted}
        d_ref = {n: ref_after[i][n].double() - before[n].double() for n in counted}
        d = common.leaf_gaps(d_prog, d_ref, counted)
        rec["grad_gaps"].append(max(g))
        rec["change_gaps"].append(max(d))
        rec["grad_worst"].append(names[int(np.argmax(g))])
        rec["change_worst"].append(counted[int(np.argmax(d))])
        med_g.append(statistics.median(g))
        med_d.append(statistics.median(d))
    out = {"loss_gap": max(rec["loss_gaps"]), "grad_gap": max(rec["grad_gaps"]), "change_gap": max(rec["change_gaps"]),
           "grad_median_gap": max(med_g), "change_median_gap": max(med_d)}
    out = {k: common.finite(v) for k, v in out.items()}
    for key in ("loss_gaps", "grad_gaps", "change_gaps"):
        rec[key] = [common.finite(v) for v in rec[key]]
    out["record"] = rec
    return out


def running_statistic(name: str) -> bool:
    return name.endswith("running_mean") or name.endswith("running_var")


def control(ctx, variant: str) -> Dict:
    """The numbers of the reference put in the program's place (`chain`),
    from the seed's inputs: variant "bf16" (the control: the model in
    bfloat16), "half_batch" (a fault) or "tf32" (a witness)."""
    if variant not in ("bf16", "half_batch", "tf32"):
        raise ValueError(f"unknown control {variant!r}")
    c, seed, device = ctx.cfg, ctx.seed, ctx.device
    k = int(ctx.traffic["compared_steps"])
    data = ctx.family.make_data(c, seed, device)
    weights = ctx.reference.make_weights(c, seed, device)
    bsl = list(c["batch_size_list"])
    planner = synth.EpochPlanner(data["sizes"], bsl, c["is_out_domain"], seed)
    plan0 = {kk: v[:k].copy() for kk, v in planner.epoch().items()}
    draw_state = torch.Generator().manual_seed(seed).get_state()
    b, total_iters = sum(bsl), planner.steps * c["epochs"]
    losses, states = chain(ctx, c, data, weights, plan0, draw_state, b, total_iters,
                           dtype=torch.bfloat16 if variant == "bf16" else torch.float32,
                           half_batch=variant == "half_batch", tf32_convs=variant == "tf32")
    return numbers(losses, states, *follow(ctx, c, data, states, plan0, draw_state, b, total_iters))

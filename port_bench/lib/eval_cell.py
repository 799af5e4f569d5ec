"""The eval cells: the port's in-training target-domain eval,
`train.loop.evaluate_target(cfg, predict, None, epoch, save_dir)` with
`predict` from `train.steps.make_predict_fn(cfg, models, bn_adapt=False)`,
in whole passes back to back.

Set-up writes the target domain's files into a directory under TMPDIR
(removed at exit) with the benchmark's own encoders: fundus a PNG tree of
the test split at the original size, prostate the target site's volumes as
.nii.gz; `cfg.data_root` points there, so each pass reads, decodes and
post-processes them as an epoch's eval does.  The weights are the seed's
initial weights after the traffic's count of the benchmark's own plain
supervised steps (`reference.supervised_weights`), cached in a fixed
directory of the checkout by configuration, seed and count.  One pass warms
up.

The check, once the window has closed: the plain reference evaluates the
same images and masks (the arrays the files were written from) with the
same weights.  Of the window's last pass the probabilities (kept from
`predict`'s returns) are held to the reference's; its post-processed
labels and each case's Dice (kept from the calls `train.evaluate` makes to
the post-processing and Dice functions, `observed`), and every pass's mean
Dice, to the reference's post-processing of those probabilities
(`numbers`).  All against the cell's limits."""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench.lib import common, spec, synth
from port_bench.lib.plants import Patches
from port_bench.lib.trace import traced

WINDOW_SPAN = "port_bench.window"
CACHE_DIR = os.path.join(spec.ROOT, ".port_bench_cache", "weights")


def eval_weights(ctx):
    """(the eval weights on ctx.device, from the cache or trained now; the
    seconds spent training them, 0 from the cache)."""
    c, t = ctx.cfg, ctx.traffic
    wseed, steps = int(t["weights_seed"]), int(t["weights_steps"])
    key = hashlib.sha256(json.dumps([c, t["weights_images"], steps, wseed], sort_keys=True).encode()).hexdigest()[:12]
    path = os.path.join(ctx.cache_dir or CACHE_DIR, f"{c['name']}_s{wseed}_n{steps}_{key}.pt")
    if os.path.exists(path):
        return {k: v.to(ctx.device) for k, v in torch.load(path, map_location="cpu").items()}, 0.0
    t0 = time.perf_counter()
    init = ctx.reference.make_weights(c, wseed, ctx.device)
    n, s = int(t["weights_images"]), c["image_size"]
    if c["dataset"] == "fundus":
        images, masks = synth.fundus_pairs(wseed + 1, n, s, ctx.device)
    else:
        images, masks = synth.prostate_slices(wseed + 1, n, s, ctx.device)
    dev = lambda a: torch.from_numpy(a).to(ctx.device)
    w = ctx.reference.supervised_weights(c, init, dev(images), dev(masks), steps, wseed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({k: v.cpu() for k, v in w.items()}, tmp)
    os.replace(tmp, path)
    return w, time.perf_counter() - t0


@contextlib.contextmanager
def observed(fundus: bool, out: Dict[str, list]):
    """For the duration, the post-processed labels and each case's Dice that
    `train.evaluate` produces are appended, as returned, to out["labels"]
    and out["dice"]: the post-processing and Dice functions that module
    calls, wrapped."""
    import ramdsir_tpu_torch.train.evaluate as evaluate

    def keep(fn, key):
        def kept(*args, **kwargs):
            r = fn(*args, **kwargs)
            out[key].append(r)
            return r
        return kept

    p = Patches()
    try:
        for name, key in ((("postprocessing", "labels"), ("dice_coeff_2label", "dice")) if fundus else
                          (("connectivity_region_analysis", "labels"), ("dice_binary", "dice"))):
            p.set(evaluate, name, keep(getattr(evaluate, name), key))
        yield out
    finally:
        p.undo()


def make_inputs(ctx, root: str):
    """Write the target domain's files under root; returns the arrays they
    hold: fundus (images, gray masks), prostate [(volume, mask), ...]."""
    from ramdsir_tpu_torch.config import FUNDUS_DOMAINS, PROSTATE_VOLUME_DOMAINS

    c = ctx.cfg
    if c["dataset"] == "fundus":
        imgs, masks = synth.fundus_pairs(ctx.seed, int(c["test_images"]), int(c["original_size"]), ctx.device, fixed=True)
        synth.write_fundus_test_tree(root, FUNDUS_DOMAINS[c["test_domain_idx"]], imgs, masks)
        return imgs, masks
    vols = synth.prostate_volumes(ctx.seed, int(c["test_volumes"]), int(c["volume_depth"]), c["image_size"], ctx.device)
    synth.write_prostate_volumes(root, PROSTATE_VOLUME_DOMAINS[c["test_domain_idx"]], vols)
    return vols


def run(ctx) -> Dict:
    c, traffic = ctx.cfg, ctx.traffic
    fundus = c["dataset"] == "fundus"
    phases = {"start": time.perf_counter() - ctx.t0}
    weights, trained_s = eval_weights(ctx)
    phases["weights"] = time.perf_counter() - ctx.t0
    phases["weights_trained_s"] = trained_s
    host_weights = {k: v.detach().cpu() for k, v in weights.items()}
    root = tempfile.mkdtemp(prefix="port_bench_eval_")
    try:
        inputs = make_inputs(ctx, root)
        phases["files"] = time.perf_counter() - ctx.t0
        out = _run(ctx, c, traffic, fundus, weights, host_weights, root, inputs, trained_s)
        out["extra"]["setup_phases_s"] = dict(phases, warmup=out["host"]["setup_s"] + trained_s)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(ctx, c, traffic, fundus, weights, host_weights, root, inputs, trained_s):
    from ramdsir_tpu_torch.train.loop import evaluate_target
    from ramdsir_tpu_torch.train.state import init_state
    from ramdsir_tpu_torch.train.steps import make_predict_fn

    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    cfg = ctx.family.program_config(c, str(ctx.device), os.path.join(root, "run"), data_root=root)
    state = init_state(cfg, torch.Generator().manual_seed(ctx.seed), ctx.device)
    common.load_weights(state.models, weights, strict=False)
    del weights
    predict = make_predict_fn(cfg, state.models, bn_adapt=False)
    kept: List[torch.Tensor] = []

    def kept_predict(img, n_valid=None):
        p = predict(img, n_valid)
        kept.append(p)
        return p

    save_dir = os.path.join(root, "run")
    per_pass = int(c["test_images"]) if fundus else int(c["test_volumes"]) * int(c["volume_depth"])
    evaluate_target(cfg, kept_predict, None, 0, save_dir)  # the warm-up pass
    # the eval weights' training, when the cache was cold, is the reference's
    # work and not the program's set-up
    setup_s = time.perf_counter() - ctx.t0 - trained_s

    answers, timing, seen = [], {}, {"labels": [], "dice": []}

    def passes(seconds: float, at_least: int):
        n = 0
        common.sync(ctx.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW_SPAN), observed(fundus, seen):
            while n < at_least or time.perf_counter() - t0 < seconds:
                kept.clear()
                seen["labels"].clear()
                seen["dice"].clear()
                with torch.profiler.record_function("port_bench.eval_pass"):
                    _, fields = evaluate_target(cfg, kept_predict, None, n + 1, save_dir)
                answers.append({k: fields[k] for k in ("cup_dice", "disc_dice", "dice") if k in fields})
                for k, v in fields["eval_timing"].items():
                    timing[k] = timing.get(k, 0.0) + float(v)
                n += 1
            common.sync(ctx.device)
        return n, time.perf_counter() - t0

    trace_out = []
    if ctx.trace:
        with traced(WINDOW_SPAN, trace_out):
            n, wall = passes(0.0, int(traffic["trace_passes"]))
    else:
        n, wall = passes(ctx.seconds, 1)
    peak = torch.cuda.max_memory_reserved(ctx.device) if torch.device(ctx.device).type == "cuda" else 0
    prog_probs = [p.detach().cpu() for p in kept]
    del kept[:], predict, state
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    host = {"setup_s": setup_s, "window_s": wall, "passes": n, "images": n * per_pass}
    prog = {"probs": program_frames(c, fundus, prog_probs, inputs), "answers": answers,
            "labels": list(seen["labels"]), "dice": list(seen["dice"])}
    del seen
    check, extra = compare(ctx, c, fundus, host_weights, inputs, prog)
    extra["eval_timing_s"] = timing
    return dict(host=host, peak=peak, timing=timing, trace=trace_out[0] if trace_out else None, check=check,
                extra=extra)


def reference_eval(ctx, c, fundus, host_weights, inputs, dtype=torch.float32, q16=False) -> Dict:
    """The plain reference's answers, in the layout `numbers` compares:
    probs (fundus one (N, 2, S, S) array, prostate one per volume), labels
    and dice (each case's post-processed labels and Dice), answers (the
    pass's mean Dice), area ((predicted, true) foreground), channels (the
    labels' first axis is cup and disc, compared apart).  q16: the fundus
    probabilities rounded to 1/65535 before the post-processing, as the
    program reads them back."""
    ref = ctx.reference
    w = {k: v.to(ctx.device) for k, v in host_weights.items()}
    if fundus:
        probs, labels, dices, areas = ref.eval_fundus(w, inputs[0], inputs[1], c["image_size"],
                                                      c["test_batch_size"], ctx.device, dtype)
        if q16:
            labels, dices, areas = ref.fundus_post(probs, inputs[1], q16=True)
        return dict(probs=[probs], **post_layout(True, labels, dices, areas))
    probs, labels, dices, area = [], [], [], (0, 0)
    for vol, mask in inputs:
        p, post, dice, (a, b) = ref.eval_prostate_volume(w, vol, mask, c["test_batch_size"], ctx.device, dtype)
        probs.append(p)
        labels.append(post)
        dices.append(dice)
        area = (area[0] + a, area[1] + b)
    return dict(probs=probs, **post_layout(False, labels, dices, area))


def post_layout(fundus: bool, labels, dices, area) -> Dict:
    answers = ({"cup_dice": float(np.mean([d[0] for d in dices])), "disc_dice": float(np.mean([d[1] for d in dices]))}
               if fundus else {"dice": float(np.mean(dices))})
    return {"labels": labels, "dice": dices, "answers": [answers], "area": area, "channels": fundus}


def reference_post(ctx, c, fundus, probs: List[np.ndarray], inputs) -> Dict:
    """The reference's post-processing of the program's probabilities
    (`program_frames`' layout), as the program reads them back: the
    labels, each case's Dice and the pass's mean that the program's host
    work has to give from them."""
    ref = ctx.reference
    if fundus:
        return post_layout(True, *ref.fundus_post(probs[0], inputs[1], q16=True))
    if len(probs) != len(inputs):
        return {"labels": [], "dice": [], "answers": [], "area": (0, 0), "channels": False}
    labels, dices, area = [], [], (0, 0)
    for p, (_, mask) in zip(probs, inputs):
        post, dice, (a, b) = ref.prostate_post(p, mask)
        labels.append(post)
        dices.append(dice)
        area = (area[0] + a, area[1] + b)
    return post_layout(False, labels, dices, area)


def program_frames(c, fundus: bool, prog_probs: List[torch.Tensor], inputs) -> List[np.ndarray]:
    """The program's kept batches in the reference's layout: fundus one
    (N, 2, S, S) array; prostate per volume its predicted frames (a
    volume's batches: depth // batch, the last padded)."""
    if fundus:
        return [torch.cat(prog_probs).numpy() if prog_probs else np.zeros((0,))]
    out, i, bs = [], 0, c["test_batch_size"]
    for vol, _ in inputs:
        depth = vol.shape[0]
        nb = depth // bs
        frames = min(nb * bs, depth - 2)
        out.append(torch.cat(prog_probs[i : i + nb]).numpy()[:frames] if nb else np.zeros((0,)))
        i += nb
    return out


def compare(ctx, c, fundus, host_weights, inputs, prog: Dict):
    ref = reference_eval(ctx, c, fundus, host_weights, inputs)
    post = reference_post(ctx, c, fundus, prog["probs"], inputs)
    return numbers(prog, ref, post), {"area_ratio": ref["area"][0] / max(ref["area"][1], 1)}


def label_gap(p: np.ndarray, r: np.ndarray, channels: bool) -> float:
    """The share of the foreground of either side that two label maps
    disagree on, |p xor r| / |p or r| (0 where both are empty); with
    channels, of the worst channel of (K, H, W) maps."""
    p, r = np.asarray(p) != 0, np.asarray(r) != 0
    if p.shape != r.shape:
        return float("inf")
    pairs = zip(p, r) if channels else [(p, r)]
    return max(float(np.logical_xor(a, b).sum()) / max(float(np.logical_or(a, b).sum()), 1.0) for a, b in pairs)


def label_and_dice_gaps(prog: Dict, ref: Dict):
    """(the worst case's `label_gap`, the widest gap of a case's Dice or of
    a pass's mean Dice) of the program's answers against `ref`'s; inf
    where the cases do not pair up."""
    n = len(ref["labels"])
    if not n or len(prog["labels"]) != n or len(prog["dice"]) != n or not prog["answers"]:
        return float("inf"), float("inf")
    labels = max(label_gap(p, r, ref["channels"]) for p, r in zip(prog["labels"], ref["labels"]))
    case = [abs(float(a) - float(b)) for p, r in zip(prog["dice"], ref["dice"])
            for a, b in zip(np.atleast_1d(p), np.atleast_1d(r))]
    mean = [abs(a[k] - ref["answers"][0][k]) for a in prog["answers"] for k in ref["answers"][0]]
    return labels, max(case + mean)


def numbers(prog: Dict, ref: Dict, post: Dict) -> Dict[str, float]:
    """The compared numbers: prob_gap, the widest gap between the program's
    and the reference's probabilities over the last pass; label_gap and
    dice_gap (`label_and_dice_gaps`), the program's post-processed labels
    and Dice against the reference's post-processing of the program's own
    probabilities (`post`), which a gap of probabilities cannot move, so
    that they judge the host's resize, threshold, components, fill and
    Dice alone.  ref_label_gap and ref_dice_gap, not compared: the same
    against the reference's own forward, where a probability near the
    threshold moves a label."""
    prob_gap = 0.0 if len(prog["probs"]) == len(ref["probs"]) else float("inf")
    for p, r in zip(prog["probs"], ref["probs"]):
        if p.shape != r.shape:
            prob_gap = float("inf")
            break
        if p.size:
            prob_gap = max(prob_gap, float(np.max(np.abs(p.astype(np.float64) - r))))
    label, dice = label_and_dice_gaps(prog, post)
    ref_label, ref_dice = label_and_dice_gaps(prog, ref)
    out = {"prob_gap": prob_gap, "label_gap": label, "dice_gap": dice, "ref_label_gap": ref_label,
           "ref_dice_gap": ref_dice}
    return {k: common.finite(v) for k, v in out.items()}


def control(ctx, variant: str) -> Dict[str, float]:
    """The numbers of the reference put in the program's place on the
    seed's inputs (no files written): variant "bf16", the model in
    bfloat16."""
    if variant != "bf16":
        raise ValueError(f"unknown control {variant!r}")
    c, fundus = ctx.cfg, ctx.cfg["dataset"] == "fundus"
    host_weights = {k: v.detach().cpu() for k, v in eval_weights(ctx)[0].items()}
    if fundus:
        inputs = synth.fundus_pairs(ctx.seed, int(c["test_images"]), int(c["original_size"]), ctx.device, fixed=True)
    else:
        inputs = synth.prostate_volumes(ctx.seed, int(c["test_volumes"]), int(c["volume_depth"]), c["image_size"],
                                        ctx.device)
    ref = reference_eval(ctx, c, fundus, host_weights, inputs)
    low = reference_eval(ctx, c, fundus, host_weights, inputs, dtype=torch.bfloat16, q16=True)
    return numbers(low, ref, reference_post(ctx, c, fundus, low["probs"], inputs))

"""attn_roofline.train: the traced steps' attention FLOPs (the family's
`step_counts(c)["attn_flops"]`: q k^T and p v, 4 S^2 d a layer a row
forward, twice that backward) at the card's dense peak for the
configuration's precision (the peak step_mfu.train uses) over the device
time of the kernels that attn_roofline.train.kernels/*.txt name, in %;
nothing for a run that is not a traced training run of a family that
counts attention, or when no such kernel ran."""

PEAK_KEY = {"float32": "tf32_flops", "bfloat16": "bf16_flops"}


def read(rec):
    if rec.kind != "train" or rec.trace is None or not rec.peaks or not rec.traced_steps:
        return None
    if "attn_flops" not in rec.counts:
        return None
    us = rec.trace.time_in(rec.kernels("attn_roofline.train"))
    if us <= 0:
        return None
    bound_s = rec.counts["attn_flops"] * rec.traced_steps / rec.peaks[PEAK_KEY[rec.cfg["compute_dtype"]]]
    return 100.0 * bound_s / (us / 1e6)

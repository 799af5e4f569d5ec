"""step_mfu.train: model FLOPs of the traced window's steps (the
configuration's family's `step_counts(c)["flops"]`, `families/<reference>.py`;
for ramdsir every convolution forward and backward, `lib.counts.step_flops`)
over the window's wall time, as a share of the card's dense peak for the
configuration's convolution precision (TF32 for float32)."""

PEAK_KEY = {"float32": "tf32_flops", "bfloat16": "bf16_flops"}


def read(rec):
    if rec.kind != "train" or rec.trace is None or not rec.peaks or not rec.traced_steps:
        return None
    peak = rec.peaks[PEAK_KEY[rec.cfg["compute_dtype"]]]
    return 100.0 * rec.counts["flops"] * rec.traced_steps / (rec.trace.window_us / 1e6) / peak

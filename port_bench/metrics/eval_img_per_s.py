"""eval_img_per_s: images (fundus) or volume slices (prostate) of the
window's whole eval passes over their wall time (host clock)."""


def read(rec):
    if rec.kind != "eval" or not rec.host.get("window_s"):
        return None
    return rec.host["images"] / rec.host["window_s"]

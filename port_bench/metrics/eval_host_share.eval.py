"""eval_host_share.eval: the share of the passes' wall time the program's
own eval timing (`res.timing`) puts outside `forward` and `readback`:
loading, decoding, windows, resizing, post-processing, Dice."""


def read(rec):
    t = rec.timing
    if rec.kind != "eval" or not t.get("wall"):
        return None
    return 100.0 * (t["wall"] - t.get("forward", 0.0) - t.get("readback", 0.0)) / t["wall"]

"""group_norm_roofline.train: the traced steps' GroupNorm bytes (the
family's `step_counts(c)["group_norm_bytes"]`: 5 float32 passes of every
GroupNorm-normalised activation) at the card's HBM bandwidth over the
device time of the kernels that group_norm_roofline.train.kernels/*.txt
name (`lib.readers.roofline`); nothing for a family that counts no
GroupNorm."""
from port_bench.lib.readers import roofline


def read(rec):
    if "group_norm_bytes" not in rec.counts:
        return None
    return roofline(rec, "group_norm_roofline.train", "group_norm_bytes")

"""norm_roofline.train: the traced steps' norm bytes at the card's HBM
bandwidth over the device time of the kernels that
norm_roofline.train.kernels/*.txt name (`lib.readers.roofline`)."""
from port_bench.lib.readers import roofline


def read(rec):
    return roofline(rec, "norm_roofline.train", "norm_bytes")

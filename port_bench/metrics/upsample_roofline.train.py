"""upsample_roofline.train: the traced steps' upsample bytes at the card's HBM
bandwidth over the device time of the kernels that
upsample_roofline.train.kernels/*.txt name (`lib.readers.roofline`)."""
from port_bench.lib.readers import roofline


def read(rec):
    return roofline(rec, "upsample_roofline.train", "upsample_bytes")

"""ram_mix_roofline.train: the traced steps' ram_mix bytes at the card's HBM
bandwidth over the device time of the kernels that
ram_mix_roofline.train.kernels/*.txt name (`lib.readers.roofline`)."""
from port_bench.lib.readers import roofline


def read(rec):
    return roofline(rec, "ram_mix_roofline.train", "ram_mix_bytes")

"""idle_share.train: the share of the traced window in which the card ran
nothing (`lib.readers.idle_share`)."""
from port_bench.lib.readers import idle_share


def read(rec):
    return idle_share(rec, "train")

"""eval_load_share.eval: the share of the traced eval window that the
program's `ramdsir.eval.load` spans cover (`lib.spans.window_share`):
a fundus batch's reads and decodes, a prostate volume's read and min-max."""
from port_bench.lib.spans import window_share


def read(rec):
    return window_share(rec, "eval", "ramdsir.eval.load")

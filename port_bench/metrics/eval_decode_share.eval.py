"""eval_decode_share.eval: the share of the traced eval window that the
program's `ramdsir.data.decode` spans cover (`lib.spans.window_share`):
PNG decodes (fundus) and NIfTI reads with their gunzip (prostate)."""
from port_bench.lib.spans import window_share


def read(rec):
    return window_share(rec, "eval", "ramdsir.data.decode")

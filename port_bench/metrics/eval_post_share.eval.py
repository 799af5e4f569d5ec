"""eval_post_share.eval: the share of the traced eval window that the
program's `ramdsir.eval.post` spans cover (`lib.spans.window_share`):
threshold, largest component and hole fill (fundus), the 3-D largest
component (prostate)."""
from port_bench.lib.spans import window_share


def read(rec):
    return window_share(rec, "eval", "ramdsir.eval.post")

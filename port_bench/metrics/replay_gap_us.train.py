"""replay_gap_us.train: the card's idle time a graph replay, in
microseconds: the idle gaps of the traced window whose midpoints lie
inside the program's `ramdsir.train.replay` spans, summed, over the
replays that start in the window (`lib.spans.idle_under`)."""
from port_bench.lib.spans import idle_under


def read(rec):
    return idle_under(rec, "train", "ramdsir.train.replay")

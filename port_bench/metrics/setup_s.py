"""setup_s: seconds from the process's start to the first timed step or
pass (host clock): imports, inputs, weights, the program's set-up, the
compared steps and the warm-up, kernel builds on a first run."""


def read(rec):
    return rec.host.get("setup_s")

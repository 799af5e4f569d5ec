"""Run one cell of the PyTorch port's benchmark once.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards.  The
cells, metrics and bounds are in BENCHMARK.json; port_bench/lib/harness.py
says what the run prints.  Caches (Python bytecode, Triton, torch
extensions, the eval cells' weights) stay in .port_bench_cache/ inside the
checkout; the port
builds its kernels into ramdsir_tpu_torch/_build/ there."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache = os.path.join(ROOT, ".port_bench_cache")
    # bytecode of every imported module, so that a run after the first one
    # in a checkout compiles no Python source (site-packages may hold none)
    sys.pycache_prefix = os.path.join(cache, "pycache")
    sys.dont_write_bytecode = False
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from port_bench.lib import harness

    return harness.main(args, T0, root=ROOT)


if __name__ == "__main__":
    sys.exit(main())

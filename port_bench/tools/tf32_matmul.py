"""The readings of `readings.py` with the program's float32 matrix products
in TF32 (`torch.backends.cuda.matmul.allow_tf32`): a control for a
configuration that states float32 matmuls, as `transunet_fundus` does for
the ViT's linears. The reference pins TF32 off in its own steps
(`reference.ramdsir.no_tf32`), so its side of every number is unchanged;
the rows labelled "program" are the program with TF32 matrix products.

    python3 port_bench/tools/tf32_matmul.py --workload transunet_fundus.train \
        --first-seed 4300000000 --program 6 --reference ""
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    import torch

    from port_bench.tools import readings

    torch.backends.cuda.matmul.allow_tf32 = True
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())

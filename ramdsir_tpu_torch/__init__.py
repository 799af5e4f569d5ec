"""ramdsir_tpu_torch — the RAM-DSIR trainer in PyTorch for one NVIDIA H100.

A port of `ramdsir_tpu` (JAX/Flax/Pallas for a TPU), which stays beside it
as the reference.  Module names mirror the JAX package's.  The RAM amplitude
band-mix, the JAX package's one Pallas kernel, is a hand-written CUDA kernel
here (`csrc/ram_mix.cu`, bound in `ops/ram_mix.py`).  This package imports
neither JAX nor `ramdsir_tpu`.
"""

__version__ = "0.1.0"

"""escgnn_tpu_torch — the ESC-GNN framework on PyTorch and CUDA.

A second package beside `escgnn_tpu` (JAX, the reference) with the same
module layout: host featurization and batching in numpy, the model and
training loop in PyTorch, and the JAX package's Pallas kernels rewritten
by hand in CUDA C++ for Hopper (`csrc/`, built with nvcc at first use by
`_build.py`). It imports neither JAX nor anything of `escgnn_tpu`.

Entry points run on `device="cuda"` unless the caller names the CPU, and
raise when CUDA is asked for and absent.
"""

__version__ = "0.1.0"

"""Hand-written Hopper kernels of the port, one directory each.

Each `kernels/<name>/` holds `ref.py` (the plain PyTorch version) and
`ops.py` (the wrapper). The CUDA sources live in `kernels/csrc/` and
are built by `kernels/_build.py` at first use.
"""

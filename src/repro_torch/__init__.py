"""PyTorch/CUDA port of the DSML reproduction and of its model stack.

A second package beside the JAX reference `repro`: the same public
functions, argument orders and layouts, running on an NVIDIA H100 through
hand-written CUDA kernels (`repro_torch.kernels`) and on the CPU through
their plain PyTorch versions. It imports `torch` and numpy only.

Types. The DSML path (`core`, and its kernels `rank_update`, `ista_step`,
`logistic_grad`) is float32; `group_threshold` also takes bfloat16. The
model stack (`models`, `serving`) and its flash-attention kernel run in
the configuration's dtype, bfloat16 by default, with float32 configs for
parity.

Matmul precision, set here for every product the port runs:

- TF32 is off for matmuls and convolutions. The reference accumulates
  every f32 product in full f32 (`preferred_element_type=jnp.float32` in
  its Pallas kernels), and the port is held to the reference's 1e-5 f32
  parity bar; TF32 keeps about three decimal digits and cannot meet it.
- Reduced-precision reduction is off for bf16 matmuls. The reference
  accumulates bf16 products in f32; with it on, cuBLAS may sum split-K
  partials in bf16.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

"""PyTorch/CUDA port of the DSML reproduction.

A second package beside the JAX reference `repro`: the same public
functions, argument orders and layouts, running on an NVIDIA H100 through
hand-written CUDA kernels (`repro_torch.kernels`) and on the CPU through
their plain PyTorch versions. It imports `torch` and numpy only.

Float32 only. The reference accumulates every f32 product in full f32
(`preferred_element_type=jnp.float32` in its Pallas kernels), and the
port is held to the reference's 1e-5 f32 parity bar; TF32 keeps about
three decimal digits and cannot meet it. So both TF32 switches are off
for every PyTorch product and convolution the port runs.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

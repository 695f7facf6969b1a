"""PyTorch + CUDA port of the Two-Pass softmax serving stack.

The JAX package ``repro`` stays the reference; this package imports nothing
of it.  Every kernel the reference wrote in Pallas for the TPU is a kernel
written by hand here, in CUDA C++ for Hopper (``sm_90a``).

Float32 matrix products must not run in TF32 on the card: the plain
(m, n) forms and the reference comparisons need full float32.  Both
switches are set here, once, when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

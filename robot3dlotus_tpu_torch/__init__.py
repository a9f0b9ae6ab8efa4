"""robot3dlotus_tpu_torch: the PyTorch/CUDA port of robot3dlotus_tpu.

The JAX package stays beside it as the reference. The port mirrors its
layout (configs/, ops/, models/, eval/) and module names. Every Pallas
kernel on the ported path has a hand-written CUDA kernel for Hopper
(csrc/*.cu, sm_90a) and a plain PyTorch version beside it; a wrapper takes
the plain version only for tensors on the CPU.

The port imports torch, numpy, scipy and yaml, never jax or flax.
"""

__version__ = "0.1.0"

"""PyTorch + CUDA port of tpuslam for one NVIDIA Hopper card.

The JAX package ``tpuslam`` is the reference; every module here mirrors the
``tpuslam`` module at the same path, and each Pallas kernel of the reference
is replaced by a hand-written CUDA kernel under ``kernels/csrc``.  The port
imports nothing of ``tpuslam``: what it needs of a framework-free module
there is copied (``core/config.py``), and the tests hold the copies equal.

Float32 is pinned here, at the package entry: the pyramid is two matmuls
that feed FAST's threshold comparisons, and TF32's ~3 decimal digits move
corners (the JAX package forces float32 for the same reason,
``tpuslam/utils/compcache.py``).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

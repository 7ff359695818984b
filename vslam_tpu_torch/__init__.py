"""vslam_tpu_torch — the PyTorch / CUDA port of vslam_tpu.

Same layout and public names as the JAX package, so each function has an
obvious counterpart:

  ops/       SE(3), pinhole stereo camera, packed-descriptor Hamming
  solve/     closed-form small solves + the analytic stereo-UV pose solver
  frontend/  the fused FAST/BRIEF front-end (hand-written CUDA kernel K1),
             the staged one (FAST pyramid on the kernel fast_cells, dense
             BRIEF-256 and rotated BRIEF-256R on the dense BRIEF kernel
             K2/K3/K4), each kernel with its plain-torch version; stereo /
             projective matching
  mapping/   frame state, landmark table, local maps, world map
  tracking/  the per-frame tracker step and the host-side tracker
  system/    SlamEngine (open-loop slice)
  io/        configuration tree, synthetic sequences, JAX-state converters
  eval/      ATE evaluation and trajectory writers

The port imports torch and numpy only — never jax and never vslam_tpu.
Descriptor words are carried as int32 (the same bits as the JAX uint32
words): torch has no uint32 shifts or compares on the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (SE(3) composition, 6x6 normal equations, projections) needs
# full f32.  Matmuls are already full f32 by default on CUDA; convolutions
# go through cuDNN in TF32 unless told otherwise.  Pin both, as the JAX
# package pins jax_default_matmul_precision="highest".
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

"""bemstokes_tpu_torch: the PyTorch and CUDA port of `bemstokes_tpu`, the
boundary-element framework for the exterior Stokes problem, for an NVIDIA
Hopper GPU.

The JAX package beside it is the reference.  This package keeps its module
paths and public names (`ops/assemble.py`, `StokesBEMProblem`,
`assemble_V_K`, `gmres`, ...) and never imports jax or `bemstokes_tpu`:

- the numpy host layer (meshes, Lagrange elements, quadrature, the assembly
  tables) is a copy of the JAX package's;
- the device code is plain torch on tensors, eager, with the dtype taken
  from `ProblemConfig.dtype` and the device passed explicitly;
- the O(N^2) bulk of the dense V and K operators runs through CUDA kernels
  written for sm_90a (`ops/node_kernel.py`; `csrc/node_sweep.cu` for free
  space, `csrc/node_sweep_image.cu` for the free-surface and no-slip wall
  images), the ports of the Pallas node sweep
  `bemstokes_tpu/ops/pallas_node.py`; the matrix-free matvec
  (`ops/matfree_node.py`, `csrc/sweep_matvec.cu`) and the slot kernel of the
  gather assembly (`ops/slot_kernel.py`, `csrc/tile_slots.cu`) likewise;
- the entry points (`StokesBEMProblem`, `SwimmerSimulation`, the command
  line `python -m bemstokes_tpu_torch`) run on the CUDA card unless the
  caller passes `device="cpu"` (`--device cpu`).

Float32 matrix products stay in full float32: TF32 keeps about three decimal
digits, which BEM conditioning cannot absorb (the JAX package forces
multi-pass matmuls for the same reason).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

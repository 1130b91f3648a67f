"""control_tpu_torch: all-at-once PDE-constrained optimization in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch port of ``control_tpu`` (JAX, with Pallas kernels for the TPU),
which stays beside it as the reference.  Structured-mesh FEM with batched
matrix-free element kernels, Krylov solvers, geometric multigrid and the
reference's block KKT preconditioners, on 2-D and 3-D meshes.  Tensors
live on the device of the mesh they derive from; meshes go to the CUDA
card unless the caller asks for the CPU (``UnitCubeMesh(..., device="cpu")``).

Public surface mirrors the reference:

    from control_tpu_torch import *
    Control.Stationary(...).linear_solve(...)
    Control.Instationary(...).linear_solve(...)
"""

from .config import set_default_dtype, default_dtype
from .fem import *                                  # noqa: F401,F403
from .fem import __all__ as _fem_all
from .solvers.block import (Nullspace, NoneNullspace, ConstantNullspace,
                            DirichletBCNullspace, FullNullspace,
                            MultiBlockSystem)
from .models.control import Control

__all__ = (list(_fem_all)
           + ["Nullspace", "NoneNullspace", "ConstantNullspace",
              "DirichletBCNullspace", "FullNullspace", "MultiBlockSystem",
              "Control", "set_default_dtype", "default_dtype"])

"""Carry state from the JAX package into the port.

Everything arrives as numpy arrays (or anything ``numpy.asarray`` takes)
and leaves as tensors on the device and in the dtype of a target space:
its local matrices, and the preconditioner state of
``Instationary.construct_pc(...).state`` (``solver_0`` / ``fwd`` / ``bwd``
with ``Ws``, ``dinvs``, ``lams``, ``Ainv``, ``wF``, ``wS`` ...; under
backward Euler the edge-row sweeps' ``e_first`` / ``e_last`` hierarchies,
``wS`` and the interior ParaDiag's ``mid`` state), which the port's
``construct_pc(..., prebuilt=state)`` accepts, and that of
``Stationary.construct_pc(...).state`` (``solver_0``, the mass solve's
``w`` / ``diag`` or a hierarchy; ``solver_1`` and ``solver_2``, two
hierarchies; the port folds the node stencils of D_v and M_v it adds,
``wD`` and ``wM``, when they are missing).  Complex leaves may
arrive as complex arrays or as the reference's ``{"__complex__": (re, im)}``
pairs; both become complex tensors.  Fields of any layout pass through
``to_torch`` unchanged in shape: scalar (n, [nz,] ny, nx) and vector
(n, [nz,] ny, nx, dim) stacks alike.  ``carry_state`` starts a port problem from
the JAX package's solution arrays (v, zeta of n_t blocks, Crank-Nicolson
or backward Euler, and, on the incompressible problems, p and mu; on a
stationary problem one field each).

A ParaDiag state built with ``weight_dtype`` holds full-precision planes
(the JAX package rounds them at every smoothing); the port's
``construct_pc(..., prebuilt=to_torch(state))`` stores them narrow once
(``MGConfig.store``), so the pc computes what the JAX package's does.
"""

import numpy as np
import torch

from ..config import as_torch_dtype, complex_dtype
from ..ops.local_op import LocalOp

_CKEY = "__complex__"


def to_tensor(x, device, dtype):
    """One array as a tensor in ``dtype`` (complex arrays in the complex
    dtype of matching precision; integer and bool arrays keep theirs)."""
    a = np.array(x)          # a writable copy: the source may be read-only
    dtype = as_torch_dtype(dtype)
    if np.iscomplexobj(a):
        dt = complex_dtype(dtype)
    elif a.dtype.kind in "fc":
        dt = dtype
    else:
        dt = None
    return torch.as_tensor(a, dtype=dt, device=device)


def to_torch(tree, space):
    """Convert a nested dict / list / tuple of arrays, e.g. the reference's
    ``construct_pc(...).state`` into the port's ``prebuilt=`` state, on the
    device and in the dtype of the target ``space`` (2-D or 3-D)."""
    if isinstance(tree, dict):
        if set(tree) == {_CKEY}:
            re, im = tree[_CKEY]
            return to_tensor(np.asarray(re) + 1j * np.asarray(im),
                             space.device, space.dtype)
        return {k: to_torch(v, space) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, space) for v in tree)
    if tree is None:
        return None
    return to_tensor(tree, space.device, space.dtype)


def local_op(A, space):
    """A LocalOp on ``space`` from reference local matrices (E|1, b, a),
    on the space's device and dtype."""
    return LocalOp(to_tensor(A, space.device, space.dtype), space, space)


def carry_state(ctl, *, v=None, zeta=None, p=None, mu=None):
    """Set the state of the port's problem ``ctl`` from arrays of the JAX
    package: ``v`` and ``zeta`` (n_t, *grid of the velocity space; *grid
    on a stationary problem), and on the incompressible problems ``p`` and
    ``mu`` (n_t - 1 Crank-Nicolson blocks on the pressure space).  Goes
    through the problem's setters, so boundary values are re-imposed and a
    shape that does not fit raises ``ValueError``."""
    from ..fem.space import Function, MixedFunction
    stationary = not isinstance(ctl._v, MixedFunction)
    for value, setter, space in ((v, ctl.set_v, ctl._space_v),
                                 (zeta, ctl.set_zeta, ctl._space_v),
                                 (p, ctl.set_p, ctl._space_p),
                                 (mu, ctl.set_mu, ctl._space_p)):
        if value is None:
            continue
        if space is None:
            raise ValueError("Undefined space_p: unable to assign value")
        data = to_tensor(value, space.device, space.dtype)
        setter(Function(space, data=data) if stationary
               else MixedFunction(space, data.shape[0], data=data))

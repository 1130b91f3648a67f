"""Carry state from the JAX package into the port.

Everything arrives as numpy arrays (or anything ``numpy.asarray`` takes)
and leaves as tensors on the device and in the dtype of a target space:
its local matrices, and the preconditioner state of
``Instationary.construct_pc(...).state`` (``solver_0`` / ``fwd`` / ``bwd``
with ``Ws``, ``dinvs``, ``lams``, ``Ainv``, ``wF``, ``wS`` ...), which the
port's ``construct_pc(..., prebuilt=state)`` accepts.  Complex leaves may
arrive as complex arrays or as the reference's ``{"__complex__": (re, im)}``
pairs; both become complex tensors.
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

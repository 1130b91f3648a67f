"""Global configuration for control_tpu_torch: the default floating dtype.

The framework is dtype-parametric.  Tests run in float64 on the CPU (the
algebraic exact-solution gates need ~1e-13); the H100 solve runs in
float32.  A mesh's ``dtype`` and ``device`` flow to every tensor derived
from it, so nothing here selects a device.
"""

from contextlib import contextmanager

import numpy as np
import torch

_DEFAULT_DTYPE = None


def as_torch_dtype(dtype):
    """torch dtype from a torch dtype, numpy dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    try:
        return getattr(torch, name)
    except AttributeError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None


def set_default_dtype(dtype):
    """Override the default floating point dtype used for new meshes."""
    global _DEFAULT_DTYPE
    _DEFAULT_DTYPE = None if dtype is None else as_torch_dtype(dtype)


def default_dtype():
    """Default floating dtype: the set one, else torch's default."""
    if _DEFAULT_DTYPE is not None:
        return _DEFAULT_DTYPE
    return torch.get_default_dtype()


def complex_dtype(dtype):
    """The complex dtype whose parts have real dtype ``dtype``."""
    return torch.complex64 if dtype == torch.float32 else torch.complex128


@contextmanager
def full_precision():
    """Full-precision float32 products and convolutions on the card.

    cuDNN runs float32 convolutions (the multigrid transfers) in TF32 by
    default, which keeps about three decimal digits; the JAX reference runs
    them, the time-axis DFT and the coarse inverse at
    ``Precision.HIGHEST``.  The solve path enters this context; the previous
    settings come back on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd

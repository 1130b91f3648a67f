"""Matrix-free local operators.

A ``LocalOp`` holds per-cell element matrices ``A`` with shape
``(*batch, E, b, a)`` (``E`` may be 1 for constant-coefficient forms -- the
broadcast saves memory and turns application into one batched matmul).
Operator application is

    y = scatter_add( A @ gather(x) )

the matrix-free replacement for PETSc assembled matrices + multAdd
(reference preconditioner/preconditioner.py:406-432).  Transposition is an
axis swap, and diagonal extraction powers Jacobi/Chebyshev smoothing.
"""

import math

import numpy as np
import torch


def local_matvec(A, xe):
    """re[..., e, b] = sum_a A[..., e, b, a] xe[..., e, a].

    A single shared element matrix (every leading axis of ``A`` of size 1,
    the constant-coefficient case) runs as one matrix product instead of a
    batched product over broadcast copies of ``A``."""
    if math.prod(A.shape[:-2]) == 1:
        out = xe @ A.reshape(A.shape[-2:]).transpose(-1, -2)
        shape = torch.broadcast_shapes(A.shape[:-2], xe.shape[:-1])
        return out.reshape(tuple(shape) + (A.shape[-2],))
    return torch.matmul(A, xe[..., None])[..., 0]


class LocalOp:
    def __init__(self, A, trial_space, test_space):
        self.A = A
        self.trial_space = trial_space
        self.test_space = test_space

    def apply(self, x):
        """x: (*xbatch, *trial_grid) -> (*ybatch, *test_grid)."""
        xe = self.trial_space.gather(x)                     # (*b, E, a)
        re = local_matvec(self.A, xe)                       # (*b, E, bloc)
        return self.test_space.scatter_add(re)

    def __call__(self, x):
        return self.apply(x)

    @property
    def T(self):
        return LocalOp(self.A.transpose(-1, -2),
                       self.test_space, self.trial_space)

    def diag(self):
        """Assembled diagonal (same trial/test space only)."""
        if self.trial_space != self.test_space:
            raise ValueError("diag needs equal trial and test spaces")
        d = torch.diagonal(self.A, dim1=-2, dim2=-1)        # (*batch, E, nloc)
        E = self.trial_space.mesh.n_cells
        d = d.expand(tuple(d.shape[:-2]) + (E, d.shape[-1]))
        return self.test_space.scatter_add(d)

    def __add__(self, other):
        if isinstance(other, LocalOp):
            if (self.trial_space != other.trial_space
                    or self.test_space != other.test_space):
                raise ValueError("space mismatch")
            return LocalOp(self.A + other.A, self.trial_space,
                           self.test_space)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, LocalOp):
            return self + (-1.0) * other
        return NotImplemented

    def __mul__(self, s):
        return LocalOp(self.A * s, self.trial_space, self.test_space)

    __rmul__ = __mul__

    def __neg__(self):
        return self * (-1.0)

    def to_dense(self):
        """Assemble the full dense matrix (small problems / coarse grids /
        tests).  Returns (*batch, n_test_dofs, n_trial_dofs): leading batch
        axes of ``A`` (one operator per batch entry) carry through."""
        tr, te = self.trial_space, self.test_space
        dev = self.A.device
        gi_t = torch.as_tensor(_global_indices(te), device=dev)
        gi_a = torch.as_tensor(_global_indices(tr), device=dev)
        E = tr.mesh.n_cells
        batch = tuple(self.A.shape[:-3])
        A = self.A.expand(batch + (E,) + tuple(self.A.shape[-2:]))
        flat = (gi_t[:, :, None] * tr.n_dofs + gi_a[:, None, :]).reshape(-1)
        out = torch.zeros(batch + (te.n_dofs * tr.n_dofs,),
                          dtype=A.dtype, device=dev)
        out.index_add_(-1, flat, A.reshape(batch + (-1,)))
        return out.reshape(batch + (te.n_dofs, tr.n_dofs))


def _global_indices(space):
    """(E, nloc) int64 array of flattened global dof indices (numpy)."""
    d, m = space.degree, space.mesh
    dim = 1 if space.dim is None else space.dim
    if getattr(space, "ndim", 2) == 3:
        iz = np.arange(m.nz)[:, None, None, None, None, None]
        iy = np.arange(m.ny)[None, :, None, None, None, None]
        ix = np.arange(m.nx)[None, None, :, None, None, None]
        az = np.arange(d + 1)[None, None, None, :, None, None]
        ay = np.arange(d + 1)[None, None, None, None, :, None]
        ax = np.arange(d + 1)[None, None, None, None, None, :]
        node = ((d * iz + az) * space.nodes_y + (d * iy + ay)) \
            * space.nodes_x + (d * ix + ax)
        node = node.reshape(m.n_cells, (d + 1) ** 3)
    else:
        iy = np.arange(m.ny)[:, None, None, None]
        ix = np.arange(m.nx)[None, :, None, None]
        ay = (np.arange(d + 1))[None, None, :, None]
        ax = (np.arange(d + 1))[None, None, None, :]
        gy = d * iy + ay      # (ny, nx, d+1, d+1)
        gx = d * ix + ax
        node = gy * space.nodes_x + gx
        node = node.reshape(m.ny * m.nx, (d + 1) ** 2)
    node = node.astype(np.int64)
    if space.dim is None:
        return node
    full = node[:, :, None] * dim + np.arange(dim)[None, None, :]
    return full.reshape(node.shape[0], node.shape[1] * dim)


class MaskedOp:
    """Dirichlet-eliminated operator: identity on masked rows/cols.

    Equivalent to Firedrake ``assemble(form, bcs=bcs)`` -- bc rows/cols are
    zeroed with 1 on the diagonal (reference control/control.py:359-368).
    """

    def __init__(self, op, mask, alpha=1.0):
        self.op = op
        self.mask = mask      # bool, trial/test grid shape (same space)
        self.alpha = alpha
        self.trial_space = op.trial_space
        self.test_space = op.test_space

    def apply(self, x):
        xi = torch.where(self.mask, 0.0, x)
        y = self.op.apply(xi)
        return torch.where(self.mask, self.alpha * x, y)

    def __call__(self, x):
        return self.apply(x)

    @property
    def T(self):
        return MaskedOp(self.op.T, self.mask, self.alpha)

    def diag(self):
        return torch.where(self.mask, self.alpha, self.op.diag())

    def to_dense(self):
        A = self.op.to_dense()
        m = self.mask.reshape(-1)
        A = torch.where(m[:, None] | m[None, :], 0.0, A)
        d = torch.where(m, self.alpha, 0.0).to(A.dtype)
        return A + torch.diag(d)

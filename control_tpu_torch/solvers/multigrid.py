"""Geometric multigrid on structured meshes.

The stand-in for hypre BoomerAMG, which the reference applies as a black
box to every stiffness-like block (reference control/control.py:356-416,
2056-2067).  Nested uniform refinement gives exact coarse-space embeddings,
so:

* prolongation  P  = per-coarse-cell tabulation of the coarse basis at fine
  node positions (a dilated convolution for Q1),
* restriction   R  = P^T (a strided convolution for Q1),
* coarse operators by Galerkin RAP computed directly on per-cell local
  matrices,
* Chebyshev-Jacobi smoothing (kernels K2/K3 on the card) with Gershgorin
  bounds from the node stencils,
* a dense inverse on the coarsest level.

Hierarchies take leading batch axes on the fine local matrices: one
hierarchy per batch entry (the ParaDiag frequencies), built at once.
"""

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from ..fem import elements
from ..fem.space import FunctionSpace
from ..ops.local_op import LocalOp, MaskedOp
from ..ops.stencil import (node_stencil, stencil_diag, stencil_abs_rowsum,
                           fused_cheb_smooth)


# ---------------------------------------------------------------------------
# static transfer tensors
# ---------------------------------------------------------------------------

def _child_embedding(cell, degree, ndim=2):
    """P_k (2**ndim, nloc, nloc): coarse basis tabulated at the node
    positions of child cell k (children ordered k = [kz*2 +] ky)*2 + kx)."""
    offs = elements.cell_node_offsets(degree, ndim)  # (nloc, ndim), child ref
    Ps = []
    for kk in itertools.product((0, 1), repeat=ndim):
        shift = np.array(kk[::-1], dtype=np.float64)  # (kx, ky[, kz])
        pts = 0.5 * (offs + shift)                   # coarse-ref coords
        N, _ = elements.tabulate_scalar(cell, degree, pts)
        Ps.append(N)                                 # (nloc_fine, nloc_coarse)
    return np.stack(Ps)


def _cell_prolongation(cell, degree, ndim=2):
    """(nfl, nc): coarse basis at the (2d+1)**ndim fine-node positions of a
    coarse cell (major-to-minor ordering, matching a degree-2d virtual
    space)."""
    offs = elements.cell_node_offsets(2 * degree, ndim)
    N, _ = elements.tabulate_scalar(cell, degree, offs)
    return N


class Transfer:
    """Grid transfer between a degree-1 quadrilateral space and its
    coarsened mesh.

    Interpolation is translation-invariant on a uniform mesh, so
    prolongation / restriction are one dilated / strided convolution with
    the separable Q1 hat kernel (zero padding clips at the boundary)."""

    def __init__(self, fine_space):
        if (fine_space.degree != 1 or fine_space.dim is not None
                or fine_space.ndim != 2 or fine_space.mesh.cell != "quad"):
            raise NotImplementedError(
                "only scalar 2-D Q1 transfers are ported yet")
        mesh_c = fine_space.mesh.coarsen()
        self.fine = fine_space
        self.ndim = fine_space.ndim
        self.coarse = FunctionSpace(mesh_c, degree=fine_space.degree,
                                    dim=fine_space.dim)
        dtype, dev = fine_space.mesh.dtype, fine_space.mesh.device
        Pk = _child_embedding(fine_space.mesh.cell, fine_space.degree,
                              self.ndim)
        self._P_child = torch.as_tensor(Pk, dtype=dtype, device=dev)
        # separable Q1 hat kernel: coarse basis at fine-node offsets
        k1 = np.array([0.5, 1.0, 0.5])
        self._kappa = torch.as_tensor(np.multiply.outer(k1, k1),
                                      dtype=dtype, device=dev)
        self._L = 1

    @staticmethod
    def _conv(fn, xb, k, **kw):
        """Real-kernel convolution, applied to the real and imaginary parts
        of complex fields separately (the ParaDiag frequency operators are
        complex; convolutions are real)."""
        if xb.is_complex():
            return torch.complex(fn(xb.real.contiguous(), k, **kw),
                                 fn(xb.imag.contiguous(), k, **kw))
        return fn(xb, k, **kw)

    def _weights(self, x):
        rdt = x.real.dtype if x.is_complex() else x.dtype
        return self._kappa.to(rdt)[None, None]

    def prolong(self, xc):
        cg = self.coarse.grid_shape
        batch = tuple(xc.shape[:xc.dim() - 2])
        xb = xc.reshape((-1, 1) + cg)
        # dilated conv == transposed conv with stride 2 (symmetric kernel)
        out = self._conv(F.conv_transpose2d, xb, self._weights(xc),
                         stride=2, padding=self._L)
        return out.reshape(batch + self.fine.grid_shape)

    def restrict(self, rf):
        fg = self.fine.grid_shape
        batch = tuple(rf.shape[:rf.dim() - 2])
        rb = rf.reshape((-1, 1) + fg)
        out = self._conv(F.conv2d, rb, self._weights(rf), stride=2,
                         padding=self._L)
        return out.reshape(batch + self.coarse.grid_shape)

    def galerkin(self, A):
        """Coarse local matrices from fine local matrices A (*, E_f, b, a)."""
        mc = self.coarse.mesh
        nd = self.ndim
        nch = 2 ** nd
        batch = tuple(A.shape[:-3])
        if A.shape[-3] == 1:
            Af = A[..., None, :, :, :].expand(
                batch + (nch, 1) + tuple(A.shape[-2:]))
        else:
            cells = (mc.ny, mc.nx)
            inter = sum(((c, 2) for c in cells), ())
            A4 = A.reshape(batch + inter + tuple(A.shape[-2:]))
            nb = len(batch)
            # regroup (c0,2,c1,2) -> (coarse cells..., children...)
            perm = (tuple(range(nb))
                    + tuple(nb + 2 * i for i in range(nd))
                    + tuple(nb + 2 * i + 1 for i in range(nd))
                    + (nb + 2 * nd, nb + 2 * nd + 1))
            A4 = A4.permute(perm)
            A4 = A4.reshape(batch + (mc.n_cells, nch) + tuple(A.shape[-2:]))
            Af = A4.movedim(-3, -4)                  # (.., nch, E_c, b, a)
        P = self._P_child.to(A.dtype)
        # RAP per child: P_k^T A P_k summed over children
        return torch.einsum("kfc,...kefg,kgd->...ecd", P, Af, P)


# ---------------------------------------------------------------------------
# multigrid solver
# ---------------------------------------------------------------------------

def _dense_inv(Ad):
    """Dense inverse (real or complex; leading batch axes)."""
    return torch.linalg.inv(Ad)


class MGConfig:
    """Static multigrid structure for one (space, mask) pair.

    Split into a static config and a params dict so that hierarchies can be
    built for a batch of operators at once and consumed by the sweeps."""

    def __init__(self, space, mask=None, *, levels=None, pre=8, post=8,
                 coarse_max_dofs=4500, lam_frac=4.0, lam_safety=1.05,
                 weight_dtype=None):
        # weight_dtype (e.g. "bfloat16"): round the smoothers' weight
        # planes through a narrower dtype (plain version only)
        self.weight_dtype = weight_dtype
        self.pre, self.post = pre, post
        self.lam_frac, self.lam_safety = lam_frac, lam_safety

        self.spaces = [space]
        self.transfers = []
        sp = space
        n_levels = 1
        while levels is None or n_levels < levels:
            m = sp.mesh
            axes = ((m.nx, m.ny, m.nz) if getattr(m, "ndim", 2) == 3
                    else (m.nx, m.ny))
            if any(n % 2 for n in axes) or min(axes) <= 2:
                break
            if levels is None and sp.n_dofs <= coarse_max_dofs:
                break
            tr = Transfer(sp)
            self.transfers.append(tr)
            sp = tr.coarse
            self.spaces.append(sp)
            n_levels += 1

        half = (slice(None, None, 2),) * space.ndim
        self.masks = [mask]
        for _ in self.transfers:
            prev = self.masks[-1]
            self.masks.append(None if prev is None else prev[half])

    def _ops(self, As):
        ops = []
        for A, sp_l, mk in zip(As, self.spaces, self.masks):
            o = LocalOp(A, sp_l, sp_l)
            ops.append(MaskedOp(o, mk) if mk is not None else o)
        return ops

    def build(self, A):
        """Params for fine-level local matrices ``A`` (*batch, E, b, a):
        per level the node stencil ``Ws``, its diagonal ``diags`` and
        inverse ``dinvs``, Gershgorin bounds ``lams`` (*batch, levels), and
        the coarsest dense inverse ``Ainv`` (*batch, m, m)."""
        As = [A]
        for tr in self.transfers:
            As.append(tr.galerkin(As[-1]))
        ops = self._ops(As)
        Ws, diags, dinvs, lams = [], [], [], []
        for A_l, sp_l, mk in zip(As, self.spaces, self.masks):
            w = node_stencil(A_l, sp_l, mask=mk)
            Ws.append(w)
            d = stencil_diag(w, nd=sp_l.ndim)
            d = torch.where(d == 0, 1.0, d)
            diags.append(d)
            dinvs.append(1.0 / d)
            ratio = stencil_abs_rowsum(w, nd=sp_l.ndim) / torch.abs(d)
            lams.append(torch.amax(ratio, dim=(-2, -1)))
        # coarsest solve as a precomputed dense inverse
        Ainv = _dense_inv(ops[-1].to_dense())
        return {"Ws": Ws, "diags": diags, "dinvs": dinvs,
                "lams": torch.stack(lams, dim=-1), "Ainv": Ainv}

    # -- application --------------------------------------------------------
    def _bounds(self, lam):
        lam = lam * self.lam_safety
        lmin = lam / self.lam_frac
        theta = 0.5 * (lam + lmin)
        delta = 0.5 * (lam - lmin)
        return theta, delta

    def _vcycle(self, params, lvl, b, x):
        if lvl == len(self.spaces) - 1:
            gs = self.spaces[-1].grid_shape
            batch = tuple(b.shape[:b.dim() - len(gs)])
            bf = b.reshape(batch + (-1,))
            # Ainv is (m, m) for a single hierarchy or (n, m, m) for
            # batched (per-frequency) hierarchies
            xs = torch.einsum("...ij,...j->...i", params["Ainv"], bf)
            return xs.reshape(b.shape)
        tr = self.transfers[lvl]
        mk = self.masks[lvl + 1]
        w = params["Ws"][lvl]
        dinv = params["dinvs"][lvl]
        theta, delta = self._bounds(params["lams"][..., lvl])
        deg = self.spaces[lvl].degree
        nd = self.spaces[lvl].ndim
        x, r = fused_cheb_smooth(w, dinv, b, x, self.pre, theta, delta,
                                 deg, want_residual=True,
                                 weight_dtype=self.weight_dtype, nd=nd)
        rc = tr.restrict(r)
        if mk is not None:
            rc = torch.where(mk, 0.0, rc)
        ec = self._vcycle(params, lvl + 1, rc, torch.zeros_like(rc))
        if mk is not None:
            ec = torch.where(mk, 0.0, ec)
        x = x + tr.prolong(ec)
        return fused_cheb_smooth(w, dinv, b, x, self.post, theta, delta,
                                 deg, weight_dtype=self.weight_dtype, nd=nd)

    def apply(self, params, b, x0=None, cycles=1):
        x = torch.zeros_like(b) if x0 is None else x0
        for _ in range(cycles):
            x = self._vcycle(params, 0, b, x)
        return x


def index_params(params, i):
    """The hierarchy of batch entry ``i`` of batched params."""
    return {"Ws": [w[i] for w in params["Ws"]],
            "diags": [d[i] for d in params["diags"]],
            "dinvs": [d[i] for d in params["dinvs"]],
            "lams": params["lams"][i], "Ainv": params["Ainv"][i]}


def flip_params(params):
    """Batched params with the batch order reversed."""
    def rev(t):
        return torch.flip(t, dims=(0,))
    return {"Ws": [rev(w) for w in params["Ws"]],
            "diags": [rev(d) for d in params["diags"]],
            "dinvs": [rev(d) for d in params["dinvs"]],
            "lams": rev(params["lams"]), "Ainv": rev(params["Ainv"])}


class Multigrid:
    """Galerkin geometric multigrid V-cycle for a LocalOp (+ optional
    Dirichlet mask).  ``solve(b, cycles=k)`` imitates one application of
    the reference's 'preonly + boomeramg, max_iter k' building block."""

    def __init__(self, op, mask=None, **kw):
        if isinstance(op, MaskedOp):
            mask = op.mask if mask is None else mask
            op = op.op
        if op.trial_space != op.test_space:
            raise ValueError("multigrid needs equal trial and test spaces")
        self.config = MGConfig(op.trial_space, mask, **kw)
        self.params = self.config.build(op.A)

    def solve(self, b, x0=None, cycles=1):
        return self.config.apply(self.params, b, x0=x0, cycles=cycles)

    def __call__(self, b):
        return self.solve(b)

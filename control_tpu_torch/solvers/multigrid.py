"""Geometric multigrid on structured meshes.

The stand-in for hypre BoomerAMG, which the reference applies as a black
box to every stiffness-like block (reference control/control.py:356-416,
2056-2067).  Nested uniform refinement gives exact coarse-space embeddings,
so:

* prolongation  P  = per-coarse-cell tabulation of the coarse basis at fine
  node positions (a dilated 2-D or 3-D convolution for scalar Q1 on
  quadrilaterals and hexahedra; gather, one cell matrix, scatter with
  multiplicity averaging for degree >= 2, P1/P2 triangle pairs and vector
  spaces),
* restriction   R  = P^T (a strided convolution for scalar Q1),
* coarse operators by Galerkin RAP computed directly on per-cell local
  matrices,
* Chebyshev-Jacobi smoothing (kernels K2/K3 on the card, K5 on 3-D grids,
  K4 / K5v on 2-D / 3-D vector spaces) with Gershgorin bounds from the
  node stencils; with a narrower ``weight_dtype`` the scalar smoothers'
  weight planes are stored narrow once per build,
* for the ParaDiag frequency blocks A_k = F + mu_k S, ``build_pair``:
  every level's stencils as one real pair W_F + mu_k W_S for all
  frequencies (``fused_cheb_smooth_pair`` smooths on it),
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
from ..ops.local_op import LocalOp, MaskedOp, _global_indices
from ..ops.stencil import (node_stencil, stencil_diag, stencil_abs_rowsum,
                           fused_cheb_smooth, fused_cheb_smooth_pair,
                           narrow_planes, weight_storage_dtype)


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


def _index_maps(space, device):
    """Index tensors that gather and scatter a whole field of ``space`` in
    one indexing operation each (the strided-slice ``gather`` /
    ``scatter_add`` of the space run one small operation per local node,
    which on a card costs more in launches than in work).

    ``gather`` (E, nloc): positions in the flattened field of every cell's
    local coefficients.  ``scatter`` (n_dofs, m): for every dof the
    positions in the flattened (E * nloc) cell-local array that add up to
    it, padded with E * nloc, the position of an appended zero; m is the
    largest number of cells that share a dof.  Summing the gathered
    positions is deterministic (no atomics)."""
    gi = _global_indices(space)                      # (E, nloc), numpy
    flat = gi.ravel()
    order = np.argsort(flat, kind="stable")
    dofs = flat[order]
    counts = np.bincount(flat, minlength=space.n_dofs)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(flat.size) - starts[dofs]
    scatter = np.full((space.n_dofs, int(counts.max())), flat.size,
                      dtype=np.int64)
    scatter[dofs, rank] = order
    return (torch.as_tensor(gi, device=device),
            torch.as_tensor(scatter, device=device))


def _gather(idx, x, space):
    """(*batch, *grid_shape) -> (*batch, E, nloc), as ``space.gather``."""
    batch = tuple(x.shape[:x.dim() - len(space.grid_shape)])
    return x.reshape(batch + (-1,))[..., idx]


def _scatter_add(sidx, r, space):
    """(*batch, E, nloc) -> (*batch, *grid_shape), as
    ``space.scatter_add``."""
    batch = tuple(r.shape[:-2])
    flat = F.pad(r.reshape(batch + (-1,)), (0, 1))
    return flat[..., sidx].sum(-1).reshape(batch + space.grid_shape)


def _vec_block(P, dim):
    """Blow up (m, n) to (m*dim, n*dim) with interleaved components."""
    m, n = P.shape
    out = np.zeros((m * dim, n * dim))
    for c in range(dim):
        out[c::dim, c::dim] = P
    return out


class Transfer:
    """Grid transfer between a space on a quadrilateral, triangle-pair or
    hexahedral mesh and the same space on the coarsened mesh.

    Scalar degree-1 spaces on quadrilaterals and hexahedra: interpolation
    is translation-invariant on a uniform mesh, so prolongation /
    restriction are one dilated / strided convolution with the separable
    Q1 hat kernel, the outer power of (0.5, 1, 0.5) over the grid axes
    (zero padding clips at the boundary).

    Every other space (degree >= 2, triangle pairs, vector spaces: the
    reference's gather/scatter path): the fine node grid is that of a
    virtual degree-2d space on the coarse mesh (uniform refinement nests
    Q_d and the P_d triangle pairs alike), so prolongation gathers the
    coarse coefficients per coarse cell,
    applies one cell matrix (the coarse basis at the (2d+1)**ndim fine
    nodes of the cell, component by component on vector spaces), scatters
    into the virtual space and divides by the number of cells sharing each
    node; restriction is its transpose.  Gather and scatter are one
    indexing operation each (``_index_maps``)."""

    def __init__(self, fine_space):
        mesh_c = fine_space.mesh.coarsen()
        self.fine = fine_space
        self.ndim = fine_space.ndim
        self.coarse = FunctionSpace(mesh_c, degree=fine_space.degree,
                                    dim=fine_space.dim)
        dtype, dev = fine_space.mesh.dtype, fine_space.mesh.device
        Pk = _child_embedding(fine_space.mesh.cell, fine_space.degree,
                              self.ndim)
        if fine_space.dim is not None:
            Pk = np.stack([_vec_block(p, fine_space.dim) for p in Pk])
        self._P_child = torch.as_tensor(Pk, dtype=dtype, device=dev)
        self.conv = (fine_space.degree == 1 and fine_space.dim is None
                     and fine_space.mesh.cell in ("quad", "hex"))
        if not self.conv:
            # virtual degree-2d space on the coarse mesh: the fine grid
            self.virt = FunctionSpace(mesh_c, degree=2 * fine_space.degree,
                                      dim=fine_space.dim)
            if self.virt.grid_shape != fine_space.grid_shape:
                raise ValueError("the mesh does not coarsen evenly")
            P = _cell_prolongation(fine_space.mesh.cell, fine_space.degree,
                                   self.ndim)
            self._P_cell = torch.as_tensor(P, dtype=dtype, device=dev)
            self._gi_coarse, self._si_coarse = _index_maps(self.coarse, dev)
            self._gi_virt, self._si_virt = _index_maps(self.virt, dev)
            ones = torch.ones((mesh_c.n_cells, self.virt.nloc), dtype=dtype,
                              device=dev)
            # multiplicity grid: the number of coarse cells at each node
            self.mult = _scatter_add(self._si_virt, ones, self.virt)
            return
        # separable Q1 hat kernel: coarse basis at fine-node offsets
        k1 = np.array([0.5, 1.0, 0.5])
        kap = k1
        for _ in range(self.ndim - 1):
            kap = np.multiply.outer(kap, k1)
        self._kappa = torch.as_tensor(kap, dtype=dtype, device=dev)
        self._L = 1
        if self.ndim == 3:
            self._conv_fwd, self._conv_adj = F.conv3d, F.conv_transpose3d
        else:
            self._conv_fwd, self._conv_adj = F.conv2d, F.conv_transpose2d

    @staticmethod
    def _conv(fn, xb, k, **kw):
        """Real-kernel convolution, applied to the real and imaginary parts
        of complex fields separately (the ParaDiag frequency operators are
        complex; convolutions are real).  cuDNN runs it with a
        deterministic algorithm: the one it picks by default for the 3-D
        transposed convolution adds in no fixed order, so repeated stokes3d
        solves on the card parted in their last bits."""
        cudnn = torch.backends.cudnn
        deterministic, cudnn.deterministic = cudnn.deterministic, True
        try:
            if xb.is_complex():
                return torch.complex(fn(xb.real.contiguous(), k, **kw),
                                     fn(xb.imag.contiguous(), k, **kw))
            return fn(xb, k, **kw)
        finally:
            cudnn.deterministic = deterministic

    def _weights(self, x):
        rdt = x.real.dtype if x.is_complex() else x.dtype
        return self._kappa.to(rdt)[None, None]

    # -- gather / scatter path (all but scalar Q1) ----------------------------
    def _cellwise(self, M, xe):
        """Apply the scalar cell matrix M to gathered coefficients
        (component by component on vector spaces)."""
        sp = self.fine
        M = M.to(xe.dtype)
        if sp.dim is None:
            return torch.einsum("fa,...ea->...ef", M, xe)
        xs = xe.reshape(tuple(xe.shape[:-1]) + (-1, sp.dim))
        out = torch.einsum("fa,...eac->...efc", M, xs)
        return out.reshape(tuple(out.shape[:-2]) + (-1,))

    def prolong_slow(self, xc):
        xf = self._cellwise(self._P_cell,
                            _gather(self._gi_coarse, xc, self.coarse))
        return _scatter_add(self._si_virt, xf, self.virt) / self.mult

    def restrict_slow(self, rf):
        re = _gather(self._gi_virt, rf / self.mult, self.virt)
        return _scatter_add(self._si_coarse,
                            self._cellwise(self._P_cell.T, re), self.coarse)

    # -- convolution path (scalar Q1, quadrilaterals and hexahedra) ----------
    def prolong(self, xc):
        if not self.conv:
            return self.prolong_slow(xc)
        cg = self.coarse.grid_shape
        batch = tuple(xc.shape[:xc.dim() - self.ndim])
        xb = xc.reshape((-1, 1) + cg)
        # dilated conv == transposed conv with stride 2 (symmetric kernel)
        out = self._conv(self._conv_adj, xb, self._weights(xc),
                         stride=2, padding=self._L)
        return out.reshape(batch + self.fine.grid_shape)

    def restrict(self, rf):
        if not self.conv:
            return self.restrict_slow(rf)
        fg = self.fine.grid_shape
        batch = tuple(rf.shape[:rf.dim() - self.ndim])
        rb = rf.reshape((-1, 1) + fg)
        out = self._conv(self._conv_fwd, rb, self._weights(rf), stride=2,
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
            cells = (mc.nz, mc.ny, mc.nx) if nd == 3 else (mc.ny, mc.nx)
            inter = sum(((c, 2) for c in cells), ())
            A4 = A.reshape(batch + inter + tuple(A.shape[-2:]))
            nb = len(batch)
            # regroup (c0,2,c1,2[,c2,2]) -> (coarse cells..., children...)
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
    """Dense inverse (real or complex; leading batch axes).  On the CPU
    one matrix at a time: torch's batched CPU LU factors the batch entries
    in parallel threads, and for matrices of a few hundred rows and more
    (a hex Q3 coarse level has 2197) it has returned invalid pivots or
    hung (torch 2.13, MKL)."""
    if Ad.device.type != "cpu" or Ad.dim() == 2:
        return torch.linalg.inv(Ad)
    m = Ad.shape[-1]
    inv = [torch.linalg.inv(a) for a in Ad.reshape(-1, m, m)]
    return torch.stack(inv).reshape(Ad.shape)


class MGConfig:
    """Static multigrid structure for one (space, mask) pair.

    Split into a static config and a params dict so that hierarchies can be
    built for a batch of operators at once and consumed by the sweeps."""

    def __init__(self, space, mask=None, *, levels=None, pre=8, post=8,
                 coarse_max_dofs=4500, lam_frac=4.0, lam_safety=1.05,
                 weight_dtype=None):
        # weight_dtype (e.g. "bfloat16"): store the smoothers' weight and
        # diagonal planes in a narrower dtype (field arithmetic stays in
        # the problem dtype); ``build`` makes the narrow planes once
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

        # coarse masks: every other node (all components on vector spaces)
        half = (slice(None, None, 2),) * space.ndim
        self.masks = [mask]
        for _ in self.transfers:
            prev = self.masks[-1]
            self.masks.append(None if prev is None else prev[half])

    def _smoother_planes(self, w, sp):
        """Diagonal, inverse diagonal and Gershgorin bound (over the grid)
        of node stencil ``w`` on level space ``sp``."""
        vec = sp.dim is not None
        d = stencil_diag(w, vec, nd=sp.ndim)
        d = torch.where(d == 0, 1.0, d)
        ratio = stencil_abs_rowsum(w, vec, nd=sp.ndim) / torch.abs(d)
        lam = torch.amax(ratio, dim=tuple(range(-len(sp.grid_shape), 0)))
        return d, 1.0 / d, lam

    def _coarsest_dense(self, A, alpha=1.0):
        """Dense coarsest-level operator of local matrices ``A`` (masked
        rows: ``alpha`` on the diagonal)."""
        sp, mk = self.spaces[-1], self.masks[-1]
        op = LocalOp(A, sp, sp)
        return (MaskedOp(op, mk, alpha) if mk is not None else op).to_dense()

    def build(self, A):
        """Params for fine-level local matrices ``A`` (*batch, E, b, a):
        per level the node stencil ``Ws``, its diagonal ``diags`` and
        inverse ``dinvs``, Gershgorin bounds ``lams`` (*batch, levels), and
        the coarsest dense inverse ``Ainv`` (*batch, m, m).  The bounds and
        diagonals come from the full-precision stencils; with a narrower
        ``weight_dtype`` the smoothers' ``Ws`` and ``dinvs`` are then
        stored narrow (``store``)."""
        As = [A]
        for tr in self.transfers:
            As.append(tr.galerkin(As[-1]))
        Ws, diags, dinvs, lams = [], [], [], []
        for A_l, sp_l, mk in zip(As, self.spaces, self.masks):
            w = node_stencil(A_l, sp_l, mask=mk)
            Ws.append(w)
            d, dinv, lam = self._smoother_planes(w, sp_l)
            diags.append(d)
            dinvs.append(dinv)
            lams.append(lam)
        # coarsest solve as a precomputed dense inverse
        Ainv = _dense_inv(self._coarsest_dense(As[-1]))
        return self.store({"Ws": Ws, "diags": diags, "dinvs": dinvs,
                           "lams": torch.stack(lams, dim=-1), "Ainv": Ainv})

    def build_pair(self, F, S, mu):
        """Params of the n frequency hierarchies A_k = F + mu_k S (the
        ParaDiag blocks) for real fine-level local matrices ``F`` and
        ``S`` (E|1, b, a) and ``mu`` (n,) complex, with every level's
        stencils stored as one real pair.

        Galerkin coarsening is linear in A, and the masked node fold is
        too with the identity of masked rows on F's stencil and zero on
        S's, so every level's W_k of ``build(F + mu_k S)`` is
        W_F + mu_k W_S.  Stores per level ``WF`` and ``WS`` (K, *grid),
        real, shared by all frequencies; ``mu``; ``diags``, ``dinvs``
        (n, *grid) and ``lams`` (n, levels) as ``build`` makes them of
        each W_k, which is formed one frequency at a time and not kept;
        and ``Ainv`` (n, m, m), the inverses of the dense coarsest
        F_c + mu_k S_c.  Only in full precision: ``store`` forms the
        per-frequency planes for a narrower ``weight_dtype``."""
        Fs, Ss = [F], [S]
        for tr in self.transfers:
            Fs.append(tr.galerkin(Fs[-1]))
            Ss.append(tr.galerkin(Ss[-1]))
        WF, WS, diags, dinvs, lams = [], [], [], [], []
        for F_l, S_l, sp_l, mk in zip(Fs, Ss, self.spaces, self.masks):
            wF = node_stencil(F_l, sp_l, mask=mk)
            wS = node_stencil(S_l, sp_l, mask=mk, alpha=0.0)
            WF.append(wF)
            WS.append(wS)
            planes = [self._smoother_planes(wF + m * wS, sp_l) for m in mu]
            d, dinv, lam = (torch.stack(t) for t in zip(*planes))
            diags.append(d)
            dinvs.append(dinv)
            lams.append(lam)
        dF = self._coarsest_dense(Fs[-1])
        dS = self._coarsest_dense(Ss[-1], alpha=0.0)
        Ainv = torch.stack([_dense_inv(dF + m * dS) for m in mu])
        return self.store({"WF": WF, "WS": WS, "mu": mu, "diags": diags,
                           "dinvs": dinvs, "lams": torch.stack(lams, dim=-1),
                           "Ainv": Ainv})

    def store(self, params):
        """``params`` with every level's weight and inverse-diagonal planes
        in the narrow storage of ``weight_dtype`` (``narrow_planes``:
        complex planes as (re, im) pairs) where it is narrower than the
        problem dtype, so that no smoothing call casts them.  Planes that
        are already narrow (a pc state passed back as ``prebuilt``) pass
        through, as do all planes without a narrower ``weight_dtype``; a
        pair hierarchy (``build_pair``) passes through without one and has
        its per-frequency planes formed (``form_planes``) with one."""
        def narrow(a):
            wdt = weight_storage_dtype(self.weight_dtype, a.dtype)
            return a if wdt is None else narrow_planes(a, wdt)
        if "WF" in params:
            if weight_storage_dtype(self.weight_dtype,
                                    params["dinvs"][0].dtype) is None:
                return params
            params = form_planes(params)
        return dict(params, Ws=[narrow(w) for w in params["Ws"]],
                    dinvs=[narrow(d) for d in params["dinvs"]])

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
        dinv = params["dinvs"][lvl]
        theta, delta = self._bounds(params["lams"][..., lvl])
        deg = self.spaces[lvl].degree
        nd = self.spaces[lvl].ndim

        def smooth(x, steps, want_residual=False):
            if "WF" in params:
                # the pair hierarchy's frequencies (K3 / K5 complex on
                # the pair)
                return fused_cheb_smooth_pair(
                    params["WF"][lvl], params["WS"][lvl], params["mu"],
                    dinv, b, x, steps, theta, delta, deg,
                    want_residual=want_residual, nd=nd)
            # real fields K2 (K5 in 3-D), complex K3, vector fields K4
            # (K5v in 3-D)
            return fused_cheb_smooth(params["Ws"][lvl], dinv, b, x, steps,
                                     theta, delta, deg,
                                     want_residual=want_residual,
                                     weight_dtype=self.weight_dtype, nd=nd)

        x, r = smooth(x, self.pre, want_residual=True)
        rc = tr.restrict(r)
        if mk is not None:
            rc = torch.where(mk, 0.0, rc)
        ec = self._vcycle(params, lvl + 1, rc, torch.zeros_like(rc))
        if mk is not None:
            ec = torch.where(mk, 0.0, ec)
        x = x + tr.prolong(ec)
        return smooth(x, self.post)

    def apply(self, params, b, x0=None, cycles=1):
        x = torch.zeros_like(b) if x0 is None else x0
        for _ in range(cycles):
            x = self._vcycle(params, 0, b, x)
        return x


_PAIR_KEYS = ("WF", "WS")


def index_params(params, i):
    """The hierarchy of batch entry ``i`` of batched params (a pair
    hierarchy's shared ``WF``/``WS`` pass through)."""
    out = {k: [t[i] for t in params[k]]
           for k in ("Ws", "diags", "dinvs") if k in params}
    out.update({k: params[k][i] for k in ("lams", "Ainv", "mu")
                if k in params})
    out.update({k: params[k] for k in _PAIR_KEYS if k in params})
    return out


def flip_params(params):
    """Batched params with the batch order reversed (a pair hierarchy's
    shared ``WF``/``WS`` pass through)."""
    def rev(t):
        return torch.flip(t, dims=(0,))
    out = {k: [rev(t) for t in params[k]]
           for k in ("Ws", "diags", "dinvs") if k in params}
    out.update({k: rev(params[k]) for k in ("lams", "Ainv", "mu")
                if k in params})
    out.update({k: params[k] for k in _PAIR_KEYS if k in params})
    return out


def form_planes(params):
    """The per-frequency params of a pair hierarchy (``build_pair``):
    every level's planes W_F + mu_k W_S formed and stored as ``Ws``, the
    layout ``build`` makes of the blocks A_k (and a pc state carried from
    the JAX package holds).  Other params pass through."""
    if "WF" not in params:
        return params
    mu = params["mu"]
    out = {k: v for k, v in params.items()
           if k not in _PAIR_KEYS + ("mu",)}
    out["Ws"] = [wF[None] + mu.reshape((-1,) + (1,) * wF.dim()) * wS[None]
                 for wF, wS in zip(params["WF"], params["WS"])]
    return out


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

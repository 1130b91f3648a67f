"""Node-stencil (DIA-format) operator application.

A scalar Lagrange operator on a structured mesh is, at node level, a
(2d+1)^2-point stencil with per-node weights.  Folding the per-cell local
matrices (and the Dirichlet row/column elimination) into a weight tensor

    w : (*batch, K, ny, nx),   K = (2d+1)^2

turns operator application into K shifted multiply-adds.  Three hand-written
CUDA kernels (``control_tpu_torch/csrc``) carry the hot operations of the
preconditioner on the card:

* K1 ``apply_stencil``: one operator application;
* K2 ``fused_cheb_smooth`` on real fields: Chebyshev-Jacobi smoothing plus
  the final residual (mass solves, real V-cycles);
* K3 ``fused_cheb_smooth`` on complex fields: the same recurrence for the
  ParaDiag frequency blocks.

Each wrapper dispatches on the device of its tensors: a CPU tensor runs the
plain PyTorch version beside it (``_apply_plain``, ``_cheb_plain``), a CUDA
tensor launches the kernel or raises.  ``launch_counts`` counts the kernel
launches of each wrapper.
"""

import itertools
import math

import torch

from . import kernels

# kernel launches per wrapper (one per call that reaches the card)
launch_counts = {"stencil_apply": 0, "cheb_smooth_real": 0,
                 "cheb_smooth_complex": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def stencil_offsets(degree, nd=2):
    """(2d+1)**nd node offsets, lexicographic major-to-minor
    ([dz,] dy, dx) -- matching the node-grid axis order."""
    rng = range(-degree, degree + 1)
    return list(itertools.product(rng, repeat=nd))


def node_stencil(A, space, mask=None, alpha=1.0):
    """Fold local matrices ``A`` (*batch, E|1, b, a) into node-stencil
    weights (*batch, K, *grid) on scalar spaces (K = (2d+1)**ndim).

    ``mask`` (optional boolean grid) applies symmetric Dirichlet
    elimination: masked rows become alpha*identity, masked columns are
    dropped.
    """
    if space.dim is not None:
        raise NotImplementedError("vector node stencils are not ported yet")
    d = space.degree
    m = space.mesh
    nd = space.ndim
    K = (2 * d + 1) ** nd
    batch = tuple(A.shape[:-3])
    cells = (m.nz, m.ny, m.nx) if nd == 3 else (m.ny, m.nx)
    grid = space.grid_shape
    Af = A.expand(batch + (m.n_cells,) + tuple(A.shape[-2:]))
    Af = Af.reshape(batch + cells + tuple(A.shape[-2:]))

    w = torch.zeros(batch + (K,) + grid, dtype=A.dtype, device=A.device)
    nl = d + 1
    offs = stencil_offsets(d, nd)
    kidx = {off: k for k, off in enumerate(offs)}
    full = (slice(None),) * nd
    for b, bt in enumerate(itertools.product(range(nl), repeat=nd)):
        sb = tuple(slice(bi, bi + d * (nc - 1) + 1, d)
                   for bi, nc in zip(bt, cells))
        for a, at in enumerate(itertools.product(range(nl), repeat=nd)):
            k = kidx[tuple(ai - bi for ai, bi in zip(at, bt))]
            w[(Ellipsis, k) + sb] += Af[..., b, a]
    if mask is not None:
        mk = torch.as_tensor(mask, device=A.device)
        # zero masked rows
        w = torch.where(mk[None], 0.0, w)
        # zero masked columns: weight k at node p reads x[p + off_k]
        for k, off in enumerate(offs):
            src = torch.zeros_like(mk)
            ss = tuple(slice(max(0, -o), g - max(0, o))
                       for o, g in zip(off, grid))
            sd = tuple(slice(max(0, o), g - max(0, -o))
                       for o, g in zip(off, grid))
            src[ss] = mk[sd]
            w[(Ellipsis, k) + full] = torch.where(
                src, 0.0, w[(Ellipsis, k) + full])
        # alpha * identity on masked rows
        kc = K // 2
        w[(Ellipsis, kc) + full] = torch.where(
            mk, alpha, w[(Ellipsis, kc) + full])
    return w


# ---------------------------------------------------------------------------
# application (K1)
# ---------------------------------------------------------------------------

def _is_vector_stencil(w, nd=2):
    """Vector stencils carry a trailing (dim, dim) coupling block."""
    return w.dim() >= nd + 3


def _apply_plain(w, x, degree, nd=2):
    """Plain PyTorch K1: zero-pad x, then K shifted multiply-adds (the
    reference's ``_apply_xla``; dimension-generic, scalar stencils)."""
    d = degree
    grid = x.shape[-nd:]
    full = (slice(None),) * nd
    xp = torch.nn.functional.pad(x, (d, d) * nd)
    out = None
    for k, off in enumerate(stencil_offsets(d, nd)):
        sl = xp[(Ellipsis,) + tuple(slice(d + o, d + o + g)
                                    for o, g in zip(off, grid))]
        term = w[(Ellipsis, k) + full] * sl
        out = term if out is None else out + term
    return out


def _require_cuda_2d(w, nd, what):
    if nd != 2 or _is_vector_stencil(w, nd):
        raise NotImplementedError(
            f"{what}: only 2-D scalar stencils have a CUDA kernel")


def _batch_layout(w, lead, grid):
    """Broadcast batch shape, batch size and weight batch stride (0 for
    shared weights) of leading field axes ``lead`` against weights
    (K, *grid) or (nw, K, *grid)."""
    wlead = tuple(w.shape[:-3])
    bshape = torch.broadcast_shapes(wlead, lead)
    n = math.prod(bshape)
    nw = math.prod(wlead)
    if nw not in (1, n):
        raise ValueError("stencil batch mismatch")
    plane = grid[0] * grid[1]
    K = w.shape[-3]
    return bshape, n, (K * plane if nw == n and n > 1 else 0)


def _apply_cuda(w, x, degree, nd):
    _require_cuda_2d(w, nd, "apply_stencil")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError("apply_stencil: w and x need one dtype and device")
    grid = tuple(x.shape[-2:])
    if tuple(w.shape[-2:]) != grid or w.shape[-3] != (2 * degree + 1) ** 2:
        raise ValueError("apply_stencil: weight shape mismatch")
    bshape, n, w_bs = _batch_layout(w, tuple(x.shape[:-2]), grid)
    wc = w.contiguous()
    xc = x.expand(bshape + grid).contiguous()
    y = torch.empty(bshape + grid, dtype=x.dtype, device=x.device)
    lib = kernels.library()
    code = lib.stencil_apply(
        kernels.DTYPE_CODES[x.dtype], wc.data_ptr(), w_bs, xc.data_ptr(),
        y.data_ptr(), max(n, 1), grid[0], grid[1], degree,
        kernels.stream_ptr(x.device))
    kernels.check(code, "stencil_apply")
    launch_counts["stencil_apply"] += 1
    return y


def apply_stencil(w, x, degree, nd=2):
    """y = stencil(w) @ x.

    w: (K, *grid) or (n, K, *grid); x: (*grid) or (n, *grid) -- the batch
    dims broadcast (shared weights across a time batch are fine).  A CUDA
    tensor runs kernel K1 (2-D scalar stencils); a CPU tensor runs
    ``_apply_plain``.
    """
    if x.is_cuda:
        return _apply_cuda(w, x, degree, nd)
    if _is_vector_stencil(w, nd):
        raise NotImplementedError("vector stencils are not ported yet")
    return _apply_plain(w, x, degree, nd=nd)


# ---------------------------------------------------------------------------
# fused Chebyshev-Jacobi smoothing (K2 real, K3 complex)
# ---------------------------------------------------------------------------

def _expand_bound(s, b):
    """Reshape a scalar or per-batch (n,) Chebyshev bound so it broadcasts
    against fields shaped (n, ny, nx) / (ny, nx)."""
    if not torch.is_tensor(s) or s.dim() == 0:
        return s
    return s.reshape(tuple(s.shape) + (1,) * (b.dim() - s.dim()))


def _round_weights(w, dinv, b, weight_dtype):
    """Round the weight and diagonal planes through ``weight_dtype`` (the
    reference's narrow weight storage), keeping the field dtype."""
    wdt = getattr(torch, str(weight_dtype))

    def rnd(a):
        if a.is_complex():
            rdt = a.real.dtype
            return torch.complex(a.real.to(wdt).to(rdt),
                                 a.imag.to(wdt).to(rdt))
        return a.to(wdt).to(b.dtype)

    return rnd(w), rnd(dinv)


def _cheb_plain(w, dinv, b, x0, steps, theta, delta, degree,
                want_residual=False, weight_dtype=None, nd=2):
    """Plain PyTorch K2/K3: the reference's Chebyshev-Jacobi recurrence
    (``fused_cheb_smooth(use_pallas=False)``), real or complex."""
    d = degree
    if weight_dtype is not None:
        w, dinv = _round_weights(w, dinv, b, weight_dtype)
    rdt = b.real.dtype if b.is_complex() else b.dtype

    def bound(s):
        if torch.is_tensor(s):
            return s.to(device=b.device)
        return s

    theta, delta = bound(theta), bound(delta)
    sigma1 = theta / delta
    theta_b = _expand_bound(theta, b)
    delta_b = _expand_bound(delta, b)
    sigma1_b = _expand_bound(sigma1, b)
    x = x0
    r = b - _apply_plain(w, x, d, nd=nd)
    p = (r * dinv) / theta_b
    x = x + p
    rho = 1.0 / sigma1_b
    if torch.is_tensor(rho):
        rho = rho.to(rdt)
    for _ in range(steps - 1):
        r = b - _apply_plain(w, x, d, nd=nd)
        rho_new = 1.0 / (2.0 * sigma1_b - rho)
        p = rho_new * rho * p + (2.0 * rho_new / delta_b) * (r * dinv)
        x = x + p
        rho = rho_new
    if want_residual:
        r = b - _apply_plain(w, x, d, nd=nd)
        return x, r
    return x


def _bound_vector(s, n, rdt, device):
    """A scalar or (n,) bound as a real device tensor and its stride."""
    if torch.is_tensor(s):
        t = s.to(device=device, dtype=rdt).reshape(-1)
    else:
        t = torch.full((1,), float(s), dtype=rdt, device=device)
    if t.numel() == 1:
        return t.contiguous(), 0
    if t.numel() != n:
        raise ValueError("Chebyshev bounds: need a scalar or one per batch")
    return t.contiguous(), 1


def _cheb_cuda(w, dinv, b, x0, steps, theta, delta, degree, want_residual,
               nd):
    _require_cuda_2d(w, nd, "fused_cheb_smooth")
    dt = b.dtype
    for t in (w, dinv, x0):
        if t.dtype != dt or t.device != b.device:
            raise TypeError("fused_cheb_smooth: w, dinv, b, x0 need one "
                            "dtype and device")
    grid = tuple(b.shape[-2:])
    if tuple(w.shape[-2:]) != grid or w.shape[-3] != (2 * degree + 1) ** 2:
        raise ValueError("fused_cheb_smooth: weight shape mismatch")
    if b.dim() not in (2, 3):
        raise ValueError("fused_cheb_smooth: b must be (ny, nx) or "
                         "(n, ny, nx)")
    lead = tuple(b.shape[:-2])
    bshape, n, w_bs = _batch_layout(w, lead, grid)
    if bshape != lead:
        raise ValueError("fused_cheb_smooth: weights batch exceeds b")
    plane = grid[0] * grid[1]
    # dinv: shared plane (stride 0) or one plane per batch entry
    dlead = tuple(dinv.shape[:-2])
    if math.prod(dlead) == 1:
        dc, d_bs = dinv.reshape(grid).contiguous(), 0
    else:
        dc, d_bs = dinv.expand(lead + grid).contiguous(), plane
    bc = b.contiguous()
    xc = x0.expand(lead + grid).contiguous()
    rdt = b.real.dtype if b.is_complex() else dt
    th, th_s = _bound_vector(theta, n, rdt, b.device)
    de, de_s = _bound_vector(delta, n, rdt, b.device)
    if th_s != de_s:
        th = th.expand(n).contiguous() if th_s == 0 else th
        de = de.expand(n).contiguous() if de_s == 0 else de
        th_s = 1
    x_out = torch.empty_like(bc)
    x_tmp = torch.empty_like(bc)
    p = torch.empty_like(bc)
    r = torch.empty_like(bc) if want_residual else None
    lib = kernels.library()
    code = lib.cheb_smooth(
        kernels.DTYPE_CODES[dt], w.contiguous().data_ptr(), w_bs,
        dc.data_ptr(), d_bs, bc.data_ptr(), xc.data_ptr(), th.data_ptr(),
        de.data_ptr(), th_s, x_out.data_ptr(), x_tmp.data_ptr(),
        p.data_ptr(), None if r is None else r.data_ptr(), max(n, 1),
        grid[0], grid[1], degree, int(steps), kernels.stream_ptr(b.device))
    kernels.check(code, "cheb_smooth")
    launch_counts["cheb_smooth_complex" if b.is_complex()
                  else "cheb_smooth_real"] += 1
    return (x_out, r) if want_residual else x_out


def fused_cheb_smooth(w, dinv, b, x0, steps, theta, delta, degree,
                      want_residual=False, weight_dtype=None, nd=2):
    """``steps`` Chebyshev-Jacobi smoothing iterations (+ optionally the
    final residual).

    w: (K, ny, nx) or (n, K, ny, nx); dinv/b/x0: (ny, nx) or (n, ny, nx)
    (dinv and x0 broadcast to b); theta/delta: scalars or per-batch (n,)
    vectors.  Real fields run kernel K2 on a CUDA tensor, complex fields
    (the ParaDiag frequency blocks) kernel K3; CPU tensors run
    ``_cheb_plain``.  ``weight_dtype`` (e.g. "bfloat16") rounds the weight
    and diagonal planes through a narrower dtype; only the plain version
    implements it.  Returns x (and r = b - A x).
    """
    if b.is_cuda:
        if weight_dtype is not None:
            raise NotImplementedError(
                "weight_dtype has no CUDA kernel yet")
        return _cheb_cuda(w, dinv, b, x0, steps, theta, delta, degree,
                          want_residual, nd)
    if _is_vector_stencil(w, nd):
        raise NotImplementedError("vector stencils are not ported yet")
    return _cheb_plain(w, dinv, b, x0, steps, theta, delta, degree,
                       want_residual=want_residual,
                       weight_dtype=weight_dtype, nd=nd)


# ---------------------------------------------------------------------------
# diagonal / row sums / operator wrapper
# ---------------------------------------------------------------------------

def stencil_diag(w, vector=False, nd=2):
    """Assembled diagonal from scalar stencil weights: (..., *grid)."""
    if vector:
        raise NotImplementedError("vector stencils are not ported yet")
    K = w.shape[-(nd + 1)]
    return w.select(w.dim() - (nd + 1), K // 2)


def stencil_abs_rowsum(w, vector=False, nd=2):
    """Row sums of |weights| (Gershgorin): (..., *grid)."""
    if vector:
        raise NotImplementedError("vector stencils are not ported yet")
    return torch.sum(torch.abs(w), dim=-(nd + 1))


class StencilOp:
    """Matrix-free operator in node-stencil form (scalar spaces).

    Equivalent to (Masked)LocalOp.apply."""

    def __init__(self, space, w, degree=None):
        self.space = space
        self.w = w
        self.degree = space.degree if degree is None else degree
        self.nd = space.ndim

    @classmethod
    def from_local(cls, op, mask=None, alpha=1.0):
        from .local_op import MaskedOp
        if isinstance(op, MaskedOp):
            mask = op.mask if mask is None else mask
            alpha = op.alpha
            op = op.op
        w = node_stencil(op.A, op.trial_space, mask=mask, alpha=alpha)
        return cls(op.trial_space, w)

    def apply(self, x):
        return apply_stencil(self.w, x, self.degree, nd=self.nd)

    def __call__(self, x):
        return self.apply(x)

    def diag(self):
        return stencil_diag(self.w, self.space.dim is not None, nd=self.nd)

    def abs_rowsum(self):
        return stencil_abs_rowsum(self.w, self.space.dim is not None,
                                  nd=self.nd)

"""Node-stencil (DIA-format) operator application.

A scalar Lagrange operator on a structured mesh is, at node level, a
(2d+1)^nd-point stencil with per-node weights.  Folding the per-cell local
matrices (and the Dirichlet row/column elimination) into a weight tensor

    w : (*batch, K, *grid),   K = (2d+1)^nd,  grid = ([nz,] ny, nx)

turns operator application into K shifted multiply-adds.  On a vector space
(fields ``(*batch, *nodes, dim)``, node-major and component-minor) every
offset carries a dim x dim coupling block per node:

    w : (*batch, K, *nodes, dim, dim).

Hand-written CUDA kernels (``control_tpu_torch/csrc``) carry the hot
operations of the preconditioner on the card:

* K1 (2-D) and K6 (3-D) ``apply_stencil``: one operator application;
* K2 (2-D) and K5 (3-D) ``fused_cheb_smooth`` on real fields:
  Chebyshev-Jacobi smoothing plus the final residual (mass solves, real
  V-cycles);
* K3 (2-D) and K5 (3-D) ``fused_cheb_smooth`` on complex fields: the same
  recurrence for the ParaDiag frequency blocks;
* K4 (2-D, dim = 2) and K5v (3-D, dim = 3) ``fused_cheb_smooth`` on real
  vector fields: the velocity mass solves and V-cycles of the
  incompressible problems.

The 3-D kernels take degree 1 (K = 27) and degree 2 (K = 125) stencils.

Each wrapper dispatches on the device of its tensors: a CPU tensor runs the
plain PyTorch version beside it (``_apply_plain``, ``_cheb_plain``), a CUDA
tensor launches the kernel or raises.  ``launch_counts`` counts the kernel
launches of each wrapper, per kernel.  The one exception is the *apply* of
a vector stencil: the JAX package has no TPU kernel for it (its
``apply_stencil`` sends vector stencils to shifted multiply-adds), so there
is none to port, and ``apply_stencil`` runs ``_apply_plain`` for vector
stencils on every device, the card included.
"""

import itertools
import math

import torch

from . import kernels

# kernel launches per wrapper (one per call that reaches the card): K1,
# K2, K3, K4 on 2-D grids; K6 and K5 (real, complex) on 3-D grids, at
# degree 1 and (the ``_q2`` keys) degree 2; K5v on 3-D vector fields
launch_counts = {"stencil_apply": 0, "cheb_smooth_real": 0,
                 "cheb_smooth_complex": 0, "cheb_smooth_vector": 0,
                 "stencil_apply_3d": 0, "cheb_smooth_3d_real": 0,
                 "cheb_smooth_3d_complex": 0, "stencil_apply_3d_q2": 0,
                 "cheb_smooth_3d_real_q2": 0,
                 "cheb_smooth_3d_complex_q2": 0, "cheb_smooth_3d_vector": 0}

# the vector apply forms its products one leading window offset at a time
# when all K of them at once would take more than this (the 3-D Q2 weight
# set times a field is 323 MB per batch entry in float64 at 33^3 nodes)
_APPLY_CHUNK_BYTES = 1 << 30


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
    weights: (*batch, K, *grid) on scalar spaces (K = (2d+1)**ndim), or
    (*batch, K, *nodes, dim, dim) on vector spaces (a dim x dim
    component-coupling block per offset per node).

    ``mask`` (optional boolean grid, with the trailing dim axis on vector
    spaces) applies symmetric Dirichlet elimination: masked rows become
    alpha*identity, masked columns are dropped.
    """
    if space.dim is not None:
        return _node_stencil_vector(A, space, mask, alpha)
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
            ss, sd = _shift_slices(off, grid)
            src[ss] = mk[sd]
            w[(Ellipsis, k) + full] = torch.where(
                src, 0.0, w[(Ellipsis, k) + full])
        # alpha * identity on masked rows
        kc = K // 2
        w[(Ellipsis, kc) + full] = torch.where(
            mk, alpha, w[(Ellipsis, kc) + full])
    return w


def _shift_slices(off, grid):
    """Source and destination slices of a shift by ``off`` clipped to
    ``grid``: ``dst[ss] = src[sd]`` moves the value at p + off to p."""
    ss = tuple(slice(max(0, -o), g - max(0, o)) for o, g in zip(off, grid))
    sd = tuple(slice(max(0, o), g - max(0, -o)) for o, g in zip(off, grid))
    return ss, sd


def _node_stencil_vector(A, space, mask=None, alpha=1.0):
    """The vector fold: weights (*batch, K, *nodes, dim, dim), the shifted
    windows of the scalar fold with a dim x dim coupling block per
    offset."""
    d, dim = space.degree, space.dim
    m = space.mesh
    nd = space.ndim
    K = (2 * d + 1) ** nd
    batch = tuple(A.shape[:-3])
    nl = d + 1
    nloc = nl ** nd
    cells = (m.nz, m.ny, m.nx) if nd == 3 else (m.ny, m.nx)
    nodes = tuple(space.grid_shape[:-1])
    Af = A.expand(batch + (m.n_cells,) + tuple(A.shape[-2:]))
    # (..., *cells, node_b, dim_b, node_a, dim_a)
    Af = Af.reshape(batch + cells + (nloc, dim, nloc, dim))

    w = torch.zeros(batch + (K,) + nodes + (dim, dim), dtype=A.dtype,
                    device=A.device)
    offs = stencil_offsets(d, nd)
    kidx = {off: k for k, off in enumerate(offs)}
    full = (slice(None),) * nd
    dd = (slice(None), slice(None))
    for b, bt in enumerate(itertools.product(range(nl), repeat=nd)):
        sb = tuple(slice(bi, bi + d * (nc - 1) + 1, d)
                   for bi, nc in zip(bt, cells))
        for a, at in enumerate(itertools.product(range(nl), repeat=nd)):
            k = kidx[tuple(ai - bi for ai, bi in zip(at, bt))]
            w[(Ellipsis, k) + sb + dd] += Af[..., b, :, a, :]
    if mask is not None:
        mk = torch.as_tensor(mask, device=A.device)      # (*nodes, dim)
        # zero masked rows (per node and component)
        w = torch.where(mk[(None,) + full + (slice(None), None)], 0.0, w)
        # zero masked columns: weight k at node p reads x[p + off_k]
        for k, off in enumerate(offs):
            src = torch.zeros_like(mk)
            ss, sd = _shift_slices(off, nodes)
            src[ss] = mk[sd]
            idx = (Ellipsis, k) + full + dd
            w[idx] = torch.where(src[..., None, :], 0.0, w[idx])
        # alpha * identity on masked rows
        eye = torch.eye(dim, dtype=A.dtype, device=A.device)
        idxc = (Ellipsis, K // 2) + full + dd
        w[idxc] = torch.where(mk[..., None], alpha * eye, w[idxc])
    return w


# ---------------------------------------------------------------------------
# application (K1, K6)
# ---------------------------------------------------------------------------

def _is_vector_stencil(w, nd=2):
    """Vector stencils carry a trailing (dim, dim) coupling block."""
    return w.dim() >= nd + 3


def _key_3d(base, degree):
    """The launch-count key of a 3-D scalar kernel at ``degree``."""
    return base + ("_q2" if degree == 2 else "")


def _apply_plain(w, x, degree, nd=2):
    """Plain PyTorch K1/K6: zero-pad x, then K shifted multiply-adds (the
    reference's ``_apply_xla``; dimension-generic).  A vector stencil
    (w (..., K, *nodes, dim, dim), x (..., *nodes, dim)) multiplies each
    shifted field by its coupling block and sums over offsets and
    components in one reduction (one per leading window offset where the
    product would exceed ``_APPLY_CHUNK_BYTES``)."""
    d = degree
    if _is_vector_stencil(w, nd):
        dim = x.shape[-1]
        nodes = tuple(x.shape[-(nd + 1):-1])
        lead = x.dim() - (nd + 1)
        # all K shifted windows as one strided view of the padded field:
        # (*lead, *nodes, dim, k_1..k_nd), window offsets major to minor,
        # the order of stencil_offsets()
        xs = torch.nn.functional.pad(x, (0, 0) + (d, d) * nd)
        for ax in range(nd):
            xs = xs.unfold(lead + ax, 2 * d + 1, 1)
        xs = xs.permute(tuple(range(lead))
                        + tuple(range(lead + nd + 1, lead + 2 * nd + 1))
                        + tuple(range(lead, lead + nd + 1)))
        wk = w.reshape(tuple(w.shape[:w.dim() - (nd + 3)])
                       + (2 * d + 1,) * nd + nodes + (dim, dim))
        xs = xs.unsqueeze(-2)

        def terms(wk_, xs_):
            # (..., k_1..k_nd, *nodes, r, c) summed over the offsets and c
            prod = wk_ * xs_
            first = prod.dim() - (2 * nd + 2)
            return prod.sum(dim=tuple(range(first, first + nd)) + (-1,))

        size = (math.prod(torch.broadcast_shapes(wk.shape, xs.shape))
                * x.element_size())
        if size <= _APPLY_CHUNK_BYTES:
            return terms(wk, xs)
        ax = -(2 * nd + 2)                   # the first window axis
        out = None
        for j in range(2 * d + 1):
            part = terms(wk.narrow(ax, j, 1), xs.narrow(ax, j, 1))
            out = part if out is None else out + part
        return out
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


def _cuda_grid(w, x, degree, nd, what):
    """Checks shared by the CUDA wrappers: a scalar stencil of degree 1 or
    2 in 2-D or 3-D (the kernels built), one dtype and device, weights
    (K, *grid) or (nw, K, *grid).  Returns the grid shape."""
    if nd not in (2, 3) or _is_vector_stencil(w, nd):
        raise NotImplementedError(
            f"{what}: only scalar 2-D and 3-D stencils have a CUDA kernel")
    if degree not in (1, 2):
        raise NotImplementedError(
            f"{what}: no CUDA kernel for degree {degree} in {nd}-D")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"{what}: w and the fields need one dtype and "
                        "device")
    grid = tuple(x.shape[-nd:])
    if (tuple(w.shape[-nd:]) != grid
            or w.shape[-(nd + 1)] != (2 * degree + 1) ** nd):
        raise ValueError(f"{what}: weight shape mismatch")
    return grid


def _batch_layout(w, lead, grid):
    """Broadcast batch shape, batch size and weight batch stride (0 for
    shared weights) of leading field axes ``lead`` against weights
    (K, *grid) or (nw, K, *grid)."""
    nd = len(grid)
    wlead = tuple(w.shape[:-(nd + 1)])
    bshape = torch.broadcast_shapes(wlead, lead)
    n = math.prod(bshape)
    nw = math.prod(wlead)
    if nw not in (1, n):
        raise ValueError("stencil batch mismatch")
    K = w.shape[-(nd + 1)]
    return bshape, n, (K * math.prod(grid) if nw == n and n > 1 else 0)


def _zyx(grid):
    """(nz, ny, nx) of a 2-D (nz = 1) or 3-D grid."""
    return (1,) * (3 - len(grid)) + tuple(grid)


def _apply_cuda(w, x, degree, nd):
    grid = _cuda_grid(w, x, degree, nd, "apply_stencil")
    if nd == 3 and x.is_complex():
        raise NotImplementedError(
            "apply_stencil: no path applies a complex 3-D stencil")
    bshape, n, w_bs = _batch_layout(w, tuple(x.shape[:-nd]), grid)
    wc = w.contiguous()
    xc = x.expand(bshape + grid).contiguous()
    y = torch.empty(bshape + grid, dtype=x.dtype, device=x.device)
    lib = kernels.library()
    code = lib.stencil_apply(
        kernels.DTYPE_CODES[x.dtype], wc.data_ptr(), w_bs, xc.data_ptr(),
        y.data_ptr(), max(n, 1), *_zyx(grid), nd, degree,
        kernels.stream_ptr(x.device))
    kernels.check(code, "stencil_apply")
    launch_counts[_key_3d("stencil_apply_3d", degree) if nd == 3
                  else "stencil_apply"] += 1
    return y


def apply_stencil(w, x, degree, nd=2):
    """y = stencil(w) @ x.

    w: (K, *grid) or (n, K, *grid); x: (*grid) or (n, *grid) -- the batch
    dims broadcast (shared weights across a time batch are fine).  A CUDA
    tensor with a scalar stencil runs kernel K1 (2-D) or K6 (3-D, real);
    a CPU tensor runs ``_apply_plain``.  Vector stencils
    (w (..., K, *nodes, dim, dim), x (..., *nodes, dim)) have no TPU kernel
    in the JAX package and so none here: they run ``_apply_plain`` on
    every device.
    """
    if _is_vector_stencil(w, nd):
        return _apply_plain(w, x, degree, nd=nd)
    if x.is_cuda:
        return _apply_cuda(w, x, degree, nd)
    return _apply_plain(w, x, degree, nd=nd)


# ---------------------------------------------------------------------------
# fused Chebyshev-Jacobi smoothing (K2 real, K3 complex; K5 in 3-D)
# ---------------------------------------------------------------------------

def _expand_bound(s, b):
    """Reshape a scalar or per-batch (n,) Chebyshev bound so it broadcasts
    against fields shaped (n, *grid) / (*grid)."""
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
    """Plain PyTorch K2/K3/K4/K5: the reference's Chebyshev-Jacobi
    recurrence (``fused_cheb_smooth(use_pallas=False)``), real or complex,
    scalar or vector stencils, any ``nd``."""
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
    grid = _cuda_grid(w, b, degree, nd, "fused_cheb_smooth")
    dt = b.dtype
    for t in (dinv, x0):
        if t.dtype != dt or t.device != b.device:
            raise TypeError("fused_cheb_smooth: w, dinv, b, x0 need one "
                            "dtype and device")
    if b.dim() not in (nd, nd + 1):
        raise ValueError("fused_cheb_smooth: b must be (*grid) or "
                         "(n, *grid)")
    lead = tuple(b.shape[:-nd])
    bshape, n, w_bs = _batch_layout(w, lead, grid)
    if bshape != lead:
        raise ValueError("fused_cheb_smooth: weights batch exceeds b")
    # dinv: shared volume (stride 0) or one volume per batch entry
    dlead = tuple(dinv.shape[:-nd])
    if math.prod(dlead) == 1:
        dc, d_bs = dinv.reshape(grid).contiguous(), 0
    else:
        dc, d_bs = dinv.expand(lead + grid).contiguous(), math.prod(grid)
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
        *_zyx(grid), nd, degree, int(steps), kernels.stream_ptr(b.device))
    kernels.check(code, "cheb_smooth")
    kind = "complex" if b.is_complex() else "real"
    launch_counts[_key_3d(f"cheb_smooth_3d_{kind}", degree) if nd == 3
                  else f"cheb_smooth_{kind}"] += 1
    return (x_out, r) if want_residual else x_out


def _cheb_vector_cuda(w, dinv, b, x0, steps, theta, delta, degree,
                      want_residual, nd):
    """K4 and K5v: the recurrence on a real vector field, 2-D with dim = 2
    (K4) or 3-D with dim = 3 (K5v).  w: (K, *nodes, dim, dim) or
    (n, K, *nodes, dim, dim); dinv/b/x0: (*nodes, dim) or
    (n, *nodes, dim).  The kernels read a field as ``dim`` consecutive
    reals per node and a coupling block as dim * dim consecutive reals,
    which is the layout of the contiguous tensors.  The C entry point
    picks the kernel's variant from the shape
    (``csrc/cheb_smooth_vector.cu``)."""
    what = "fused_cheb_smooth (vector)"
    if (nd, tuple(w.shape[-2:])) not in ((2, (2, 2)), (3, (3, 3))):
        raise NotImplementedError(
            f"{what}: only 2-D vector stencils with dim = 2 and 3-D ones "
            "with dim = 3 have a CUDA kernel")
    dim = nd
    if b.is_complex() or w.is_complex():
        raise NotImplementedError(
            f"{what}: complex vector fields have no CUDA kernel")
    if b.dim() not in (nd + 1, nd + 2):
        raise NotImplementedError(
            f"{what}: b must be (*nodes, {dim}) or (n, *nodes, {dim})")
    if degree not in (1, 2):
        raise NotImplementedError(
            f"{what}: no CUDA kernel for degree {degree}")
    dt = b.dtype
    for t in (w, dinv, x0):
        if t.dtype != dt or t.device != b.device:
            raise TypeError(f"{what}: w, dinv, b, x0 need one dtype and "
                            "device")
    nodes = tuple(b.shape[-(nd + 1):-1])
    field = nodes + (dim,)
    K = (2 * degree + 1) ** nd
    if (tuple(w.shape[-(nd + 3):-2]) != (K,) + nodes
            or w.dim() not in (nd + 3, nd + 4) or b.shape[-1] != dim):
        raise ValueError(f"{what}: weight shape mismatch")
    lead = tuple(b.shape[:-(nd + 1)])
    n = math.prod(lead)
    nw = math.prod(w.shape[:-(nd + 3)])
    if nw not in (1, n):
        raise ValueError(f"{what}: stencil batch mismatch")
    w_bs = K * math.prod(nodes) * dim * dim if nw == n and n > 1 else 0
    # dinv: one shared field (stride 0) or one per batch entry
    if math.prod(dinv.shape[:-(nd + 1)]) == 1:
        dc, d_bs = dinv.reshape(field).contiguous(), 0
    else:
        dc, d_bs = dinv.expand(lead + field).contiguous(), math.prod(field)
    bc = b.contiguous()
    xc = x0.expand(lead + field).contiguous()
    th, th_s = _bound_vector(theta, n, dt, b.device)
    de, de_s = _bound_vector(delta, n, dt, b.device)
    if th_s != de_s:
        th = th.expand(n).contiguous() if th_s == 0 else th
        de = de.expand(n).contiguous() if de_s == 0 else de
        th_s = 1
    x_out = torch.empty_like(bc)
    x_tmp = torch.empty_like(bc)
    r = torch.empty_like(bc) if want_residual else None
    # scratch: p, then the recurrence's coefficients of steps 1 .. steps - 1
    # per entry with bounds of its own, in one allocation
    ne = max(n, 1) if th_s else 1
    p = torch.empty(bc.numel() + 2 * max(int(steps) - 1, 1) * ne, dtype=dt,
                    device=b.device)
    p_ptr = p.data_ptr()
    lib = kernels.library()
    args = (kernels.DTYPE_CODES[dt], w.contiguous().data_ptr(), w_bs,
            dc.data_ptr(), d_bs, bc.data_ptr(), xc.data_ptr(), th.data_ptr(),
            de.data_ptr(), th_s, p_ptr + bc.numel() * p.element_size(),
            x_out.data_ptr(), x_tmp.data_ptr(), p_ptr,
            None if r is None else r.data_ptr(), max(n, 1), *nodes, degree,
            int(steps), kernels.stream_ptr(b.device))
    if nd == 2:
        kernels.check(lib.cheb_smooth_vector(*args), "cheb_smooth_vector")
        launch_counts["cheb_smooth_vector"] += 1
    else:
        kernels.check(lib.cheb_smooth_vector3d(*args),
                      "cheb_smooth_vector3d")
        launch_counts["cheb_smooth_3d_vector"] += 1
    return (x_out, r) if want_residual else x_out


def fused_cheb_smooth(w, dinv, b, x0, steps, theta, delta, degree,
                      want_residual=False, weight_dtype=None, nd=2):
    """``steps`` Chebyshev-Jacobi smoothing iterations (+ optionally the
    final residual).

    w: (K, *grid) or (n, K, *grid); dinv/b/x0: (*grid) or (n, *grid)
    (dinv and x0 broadcast to b); theta/delta: scalars or per-batch (n,)
    vectors.  Vector stencils take w (K, *nodes, dim, dim) or
    (n, K, *nodes, dim, dim) and fields (*nodes, dim) or (n, *nodes, dim),
    with dinv per component.  On a CUDA tensor, real fields run kernel K2
    (2-D) or K5 (3-D), complex fields (the ParaDiag frequency blocks) K3
    (2-D) or K5 (3-D), real 2-D vector fields with dim = 2 kernel K4 and
    real 3-D ones with dim = 3 kernel K5v (other vector fields raise
    ``NotImplementedError``); CPU tensors run
    ``_cheb_plain``.  ``weight_dtype`` (e.g. "bfloat16") rounds the weight
    and diagonal planes through a narrower dtype; only the plain version
    implements it.  Returns x (and r = b - A x).
    """
    if b.is_cuda:
        if weight_dtype is not None:
            raise NotImplementedError(
                "weight_dtype has no CUDA kernel yet")
        if _is_vector_stencil(w, nd):
            return _cheb_vector_cuda(w, dinv, b, x0, steps, theta, delta,
                                     degree, want_residual, nd)
        return _cheb_cuda(w, dinv, b, x0, steps, theta, delta, degree,
                          want_residual, nd)
    return _cheb_plain(w, dinv, b, x0, steps, theta, delta, degree,
                       want_residual=want_residual,
                       weight_dtype=weight_dtype, nd=nd)


# ---------------------------------------------------------------------------
# diagonal / row sums / operator wrapper
# ---------------------------------------------------------------------------

def stencil_diag(w, vector=False, nd=2):
    """Assembled diagonal from stencil weights: (..., *grid[, dim])."""
    if vector:
        K = w.shape[-(nd + 3)]
        c = w.select(w.dim() - (nd + 3), K // 2)
        return torch.diagonal(c, dim1=-2, dim2=-1)
    K = w.shape[-(nd + 1)]
    return w.select(w.dim() - (nd + 1), K // 2)


def stencil_abs_rowsum(w, vector=False, nd=2):
    """Row sums of |weights| (Gershgorin): (..., *grid[, dim])."""
    if vector:
        return torch.sum(torch.abs(w), dim=(-(nd + 3), -1))
    return torch.sum(torch.abs(w), dim=-(nd + 1))


class StencilOp:
    """Matrix-free operator in node-stencil form, on scalar and vector
    spaces.

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

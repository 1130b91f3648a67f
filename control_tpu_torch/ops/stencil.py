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

* K1 (2-D) and K6 (3-D) ``apply_stencil``: one operator application; a
  batch of real fields sharing its weights runs the plane tile
  (``csrc/stencil_apply_tile.cu``, each weight read once for a chunk of
  fields), any other call the per-entry kernel (``apply_design`` picks
  by shape);
* K2 (2-D) and K5 (3-D) ``fused_cheb_smooth`` on real fields:
  Chebyshev-Jacobi smoothing plus the final residual (mass solves, real
  V-cycles); a batch sharing its weights runs the plane tile (each weight
  read once a step for a chunk of fields) and one field of a stencil of
  16 or more weights the weight ring (``csrc/cheb_tile.cuh``), 2-byte
  planes the per-entry kernel (``cheb_design`` picks by shape);
* K3 (2-D) and K5 (3-D) ``fused_cheb_smooth`` on complex fields: the same
  recurrence for the ParaDiag frequency blocks;
* K4 (2-D, dim = 2) and K5v (3-D, dim = 3) ``fused_cheb_smooth`` on real
  vector fields: the velocity mass solves and V-cycles of the
  incompressible problems;
* ``fused_cheb_smooth_pair``: K3 and K5 complex for a ParaDiag frequency
  hierarchy stored as one real stencil pair, A_k = W_F + mu_k W_S, whose
  weights each step reads once for all frequencies.

The 2-D kernels take degrees 1-4 (K = 9, 25, 49, 81), the scalar 3-D ones
degrees 1-3 (K = 27, 125, 343: hex Q1-Q3) and K5v degrees 1 and 2; other
degrees on a CUDA tensor raise ``NotImplementedError``.
K2, K3 and K5 (real and complex) also read weight and diagonal planes
stored narrower than the fields (``weight_dtype``: bf16 or f16, or f32
under float64 fields; complex planes as (re, im) pairs,
``narrow_planes``), the reference's narrow weight storage; K4 and K5v do
not, and raise.

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


def _key(base, degree, nd):
    """The launch-count key of a scalar kernel (``base`` its 2-D name)
    at ``degree``: ``_3d`` in 3-D, ``_q<degree>`` from degree 2 in 3-D and
    from degree 3 in 2-D."""
    if nd == 3:
        return base.replace("stencil_apply", "stencil_apply_3d").replace(
            "cheb_smooth", "cheb_smooth_3d") + (
                f"_q{degree}" if degree > 1 else "")
    return base + (f"_q{degree}" if degree > 2 else "")


# the degrees with a CUDA kernel, per grid dimension
CUDA_DEGREES = {2: (1, 2, 3, 4), 3: (1, 2, 3)}
# the (nd, degree) at which a batch of real fields with shared weights
# runs the plane-tile apply (csrc/stencil_apply_tile.cu): those at which a
# path calls K1 or K6 on n >= 2 such fields
TILE_APPLY_GEOMETRIES = ((2, 1), (3, 1), (3, 2), (3, 3))
# kernel launches per wrapper (one per call that reaches the card): K1,
# K2, K3 on 2-D grids at degrees 1 and 2 and (the ``_q3``, ``_q4`` keys)
# 3 and 4; K6 and K5 (real, complex) on 3-D grids at degree 1 and (the
# ``_q2``, ``_q3`` keys) 2 and 3; K4 and K5v on 2-D and 3-D vector
# fields; the narrow-weight variants below.  The ``stencil_apply_tile``
# keys (``stencil_apply_3d_tile``, ``_q2``, ``_q3``) count the K1 and K6
# calls that ran the plane tile (``apply_design``), which their K1 / K6
# key counts too: the per-entry kernel ran the difference.
launch_counts = dict.fromkeys(
    [_key(k, d, nd) for nd, degrees in CUDA_DEGREES.items()
     for d in degrees for k in ("stencil_apply", "cheb_smooth_real",
                                "cheb_smooth_complex")]
    + [_key("stencil_apply_tile", d, nd) for nd, d in TILE_APPLY_GEOMETRIES]
    + ["cheb_smooth_vector", "cheb_smooth_3d_vector"], 0)
# narrow weight planes (``weight_dtype``): one key per scalar smoother
# and storage, e.g. "cheb_smooth_3d_complex_q2_bf16"
_WEIGHT_TAGS = {torch.bfloat16: "bf16", torch.float16: "f16",
                torch.float32: "f32"}
launch_counts.update({
    f"{k}_{tag}": 0
    for k in launch_counts if k.startswith("cheb_smooth")
    and not k.endswith("vector")
    for tag in _WEIGHT_TAGS.values()})


def _pair_key(degree, nd):
    """The launch-count key of the pair smoother: ``cheb_smooth_pair_2d``
    or ``_3d``, with ``_q<degree>`` as the scalar kernels' keys have it."""
    return (f"cheb_smooth_pair_{nd}d"
            + (f"_q{degree}" if degree > (1 if nd == 3 else 2) else ""))


launch_counts.update({_pair_key(d, nd): 0
                      for nd, degrees in CUDA_DEGREES.items()
                      for d in degrees})

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


def _cuda_grid(wshape, x, degree, nd, what):
    """Checks shared by the CUDA wrappers: a scalar stencil of a degree
    the kernels are built for (``CUDA_DEGREES``: 1-4 in 2-D, 1-3 in 3-D),
    weights of shape ``wshape`` (K, *grid) or (nw, K, *grid) on the
    grid of x.  Returns the grid shape."""
    if nd not in (2, 3) or len(wshape) >= nd + 3:
        raise NotImplementedError(
            f"{what}: only scalar 2-D and 3-D stencils have a CUDA kernel")
    if degree not in CUDA_DEGREES[nd]:
        raise NotImplementedError(
            f"{what}: no CUDA kernel for degree {degree} in {nd}-D")
    grid = tuple(x.shape[-nd:])
    if (tuple(wshape[-nd:]) != grid
            or wshape[-(nd + 1)] != (2 * degree + 1) ** nd):
        raise ValueError(f"{what}: weight shape mismatch")
    return grid


def _batch_layout(wshape, lead, grid):
    """Broadcast batch shape, batch size and weight batch stride (0 for
    shared weights) of leading field axes ``lead`` against weights of
    shape ``wshape``, (K, *grid) or (nw, K, *grid)."""
    nd = len(grid)
    wlead = tuple(wshape[:-(nd + 1)])
    bshape = torch.broadcast_shapes(wlead, lead)
    n = math.prod(bshape)
    nw = math.prod(wlead)
    if nw not in (1, n):
        raise ValueError("stencil batch mismatch")
    K = wshape[-(nd + 1)]
    return bshape, n, (K * math.prod(grid) if nw == n and n > 1 else 0)


def _zyx(grid):
    """(nz, ny, nx) of a 2-D (nz = 1) or 3-D grid."""
    return (1,) * (3 - len(grid)) + tuple(grid)


def apply_design(dtype, n, shared_weights, nd=2, degree=1):
    """The kernel a CUDA ``apply_stencil`` call of ``n`` fields of
    ``dtype`` on an ``nd``-D grid at ``degree`` runs, from its shape
    alone, and its chunk width:

    * ("tile", NB): n >= 2 real fields with shared weights at the
      geometries of ``TILE_APPLY_GEOMETRIES`` run
      ``csrc/stencil_apply_tile.cu`` (the plane tile of
      ``csrc/cheb_tile.cuh``, one pass) in chunks of NB fields, the
      smoothers' widths (``_tile_width``; a ragged last chunk is
      masked): each weight is read once for the chunk, where the
      per-entry kernel reads the whole set once per field.  On one
      H100, float32 device time against the per-entry kernel (PERF.md,
      ``profile_slice.py apply``): 63 x 257^2 0.024 / 0.032 ms, 15 x
      65^3 at degree 1 0.120 / 0.163, degree 2 0.250 / 0.905, 15 x 73^3
      at degree 3 0.71 / 2.84-2.92; chunks of 8 instead of 16 took
      0.027, 0.283 and 0.79-0.82 ms, and of 16 at 3-D degree 1 0.120 (a
      tie; 8 keeps fewer registers);
    * ("per_entry", 0): complex fields, weights per batch entry, one
      field, and the 2-D degrees 2-4 (no path applies them to a batch)
      run ``csrc/stencil_apply.cu``, one thread per node and field: a
      single field reads each weight once either way, and that kernel
      reached 69-80% of its bound there (1 x 769^2 and 1 x 97^3 f64,
      PERF.md)."""
    if (dtype.is_complex or n <= 1 or not shared_weights
            or (nd, degree) not in TILE_APPLY_GEOMETRIES):
        return "per_entry", 0
    return "tile", _tile_width(dtype, nd, degree)


def _apply_cuda(w, x, degree, nd):
    grid = _cuda_grid(w.shape, x, degree, nd, "apply_stencil")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError("apply_stencil: w and the fields need one dtype "
                        "and device")
    if nd == 3 and x.is_complex():
        raise NotImplementedError(
            "apply_stencil: no path applies a complex 3-D stencil")
    bshape, n, w_bs = _batch_layout(w.shape, tuple(x.shape[:-nd]), grid)
    wc = w.contiguous()
    xc = x.expand(bshape + grid).contiguous()
    y = torch.empty(bshape + grid, dtype=x.dtype, device=x.device)
    lib = kernels.library()
    tail = (y.data_ptr(), max(n, 1), *_zyx(grid), nd, degree,
            kernels.stream_ptr(x.device))
    design, nb = apply_design(x.dtype, n, w_bs == 0, nd, degree)
    if design == "tile":
        code = lib.stencil_apply_tile(kernels.DTYPE_CODES[x.dtype], nb,
                                      wc.data_ptr(), xc.data_ptr(), *tail)
        kernels.check(code, "stencil_apply_tile")
        launch_counts[_key("stencil_apply_tile", degree, nd)] += 1
    else:
        code = lib.stencil_apply(kernels.DTYPE_CODES[x.dtype], wc.data_ptr(),
                                 w_bs, xc.data_ptr(), *tail)
        kernels.check(code, "stencil_apply")
    launch_counts[_key("stencil_apply", degree, nd)] += 1
    return y


def apply_stencil(w, x, degree, nd=2):
    """y = stencil(w) @ x.

    w: (K, *grid) or (n, K, *grid); x: (*grid) or (n, *grid) -- the batch
    dims broadcast (shared weights across a time batch are fine).  A CUDA
    tensor with a scalar stencil runs kernel K1 (2-D) or K6 (3-D, real):
    the plane tile or the per-entry kernel, as ``apply_design`` picks;
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


def _as_dtype(weight_dtype):
    if isinstance(weight_dtype, torch.dtype):
        return weight_dtype
    return getattr(torch, str(weight_dtype))


def weight_storage_dtype(weight_dtype, field_dtype):
    """The dtype in which weight planes are stored under ``weight_dtype``
    for fields (or planes) of ``field_dtype``: ``weight_dtype`` when it is
    narrower than their real dtype, else None -- rounding through an equal
    or wider dtype is the identity (the reference's
    ``w.astype(wdt).astype(b.dtype)``), so the planes stay as they are."""
    if weight_dtype is None:
        return None
    wdt = _as_dtype(weight_dtype)
    rdt = field_dtype.to_real() if field_dtype.is_complex else field_dtype
    return wdt if wdt.itemsize < rdt.itemsize else None


def _to_float32_odd(a):
    """float64 -> float32 rounded to odd (truncate, then set the last bit
    if anything was cut): rounding that float32 on to a format of at most
    22 significand bits rounds as if straight from float64."""
    r = a.to(torch.float32)
    back = r.to(torch.float64)
    inexact = back != a
    bits = r.view(torch.int32)
    # a step toward zero where the cast rounded away from it (the int32
    # view of a float is sign and magnitude: minus one shrinks |r|)
    bits = torch.where(inexact & (back.abs() > a.abs()), bits - 1, bits)
    return torch.where(inexact, bits | 1, bits).view(torch.float32)


def narrow_planes(a, weight_dtype):
    """Weight or diagonal planes stored in ``weight_dtype``, rounded as the
    JAX package's ``astype`` rounds them on the CPU: float64 to bfloat16
    through float32 (torch's cast does the same), float64 to float16
    directly (through float32 rounded to odd; torch's own cast would round
    twice).  Real planes keep their shape, complex planes become (..., 2)
    (re, im) pairs, since torch has no complex bfloat16 -- the interleaved
    layout the narrow kernels read.  Only exact torch operations, so the
    card makes the same bits as the CPU."""
    wdt = _as_dtype(weight_dtype)
    if a.is_complex():
        a = torch.view_as_real(a)
    if wdt == torch.float16 and a.dtype == torch.float64:
        a = _to_float32_odd(a)
    return a.to(wdt).contiguous()


def _is_pairs(a, b):
    """Whether planes ``a`` are narrow (re, im) pairs of complex fields b
    (real storage of another dtype than b's real part)."""
    return b.is_complex() and not a.is_complex() and a.dtype != b.real.dtype


def widen_planes(a, b):
    """Planes in the dtype of the fields ``b``: narrow storage widened
    (exactly), planes in b's dtype unchanged."""
    if _is_pairs(a, b):
        return torch.view_as_complex(a.to(b.real.dtype).contiguous())
    if a.is_complex() or b.is_complex():
        return a
    return a.to(b.dtype)


def _cheb_plain(w, dinv, b, x0, steps, theta, delta, degree,
                want_residual=False, weight_dtype=None, nd=2):
    """Plain PyTorch K2/K3/K4/K5: the reference's Chebyshev-Jacobi
    recurrence (``fused_cheb_smooth(use_pallas=False)``), real or complex,
    scalar or vector stencils, any ``nd``."""
    # the narrow storage, widened: the values the narrow kernels compute
    # with (planes in b's dtype under a narrower ``weight_dtype`` are
    # rounded here, as the reference rounds them in each call)
    wdt = weight_storage_dtype(weight_dtype, b.dtype)
    if wdt is not None and w.dtype == b.dtype:
        w, dinv = narrow_planes(w, wdt), narrow_planes(dinv, wdt)
    w, dinv = widen_planes(w, b), widen_planes(dinv, b)
    return _cheb_recurrence(lambda x: _apply_plain(w, x, degree, nd=nd),
                            dinv, b, x0, steps, theta, delta, want_residual)


def _cheb_pair_plain(wF, wS, mu, dinv, b, x0, steps, theta, delta, degree,
                     want_residual=False, nd=2):
    """Plain PyTorch twin of the pair smoother: the recurrence of
    ``_cheb_plain`` with A_k x = W_F x + mu_k (W_S x), two real stencil
    applications a step; no per-frequency plane is formed."""
    mu = torch.as_tensor(mu).to(device=b.device, dtype=b.dtype)
    mu_b = _expand_bound(mu.reshape(()) if b.dim() == nd else mu, b)

    def apply(x):
        return (_apply_plain(wF, x, degree, nd=nd)
                + mu_b * _apply_plain(wS, x, degree, nd=nd))

    return _cheb_recurrence(apply, dinv, b, x0, steps, theta, delta,
                            want_residual)


def _cheb_recurrence(apply, dinv, b, x0, steps, theta, delta,
                     want_residual):
    """``steps`` Chebyshev-Jacobi iterations with the operator ``apply``
    (and the final residual), in b's dtype."""
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
    r = b - apply(x)
    p = (r * dinv) / theta_b
    x = x + p
    rho = 1.0 / sigma1_b
    if torch.is_tensor(rho):
        rho = rho.to(rdt)
    for _ in range(steps - 1):
        r = b - apply(x)
        rho_new = 1.0 / (2.0 * sigma1_b - rho)
        p = rho_new * rho * p + (2.0 * rho_new / delta_b) * (r * dinv)
        x = x + p
        rho = rho_new
    if want_residual:
        r = b - apply(x)
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


def _bound_vectors(theta, delta, n, rdt, device):
    """theta and delta as real device tensors with one shared stride: 0
    when both are scalars, else 1 (one per batch entry)."""
    th, th_s = _bound_vector(theta, n, rdt, device)
    de, de_s = _bound_vector(delta, n, rdt, device)
    if th_s != de_s:
        th = th.expand(n).contiguous() if th_s == 0 else th
        de = de.expand(n).contiguous() if de_s == 0 else de
    return th, de, max(th_s, de_s)


# the chunk width of the plane-tile kernel (csrc/cheb_tile.cuh) on real
# fields with shared weights: 16 float32 fields or 8 float64 ones (16
# registers of accumulators either way); float32 3-D batches at degree 1
# take 8, where the 16-field kernel keeps its registers unspilled only at
# 2 blocks an SM
TILE_WIDTHS = {torch.float32: 16, torch.float64: 8}
# the stages of the weight ring (csrc/cheb_tile.cuh RING): a stencil of
# fewer weights leaves it part empty
RING_STAGES = 16


def _tile_width(dtype, nd, degree):
    """The plane tile's chunk width for real fields of ``dtype``
    (``TILE_WIDTHS``; 8 for float32 3-D at degree 1)."""
    if dtype == torch.float32 and nd == 3 and degree == 1:
        return 8
    return TILE_WIDTHS[dtype]


def cheb_design(dtype, n, shared_weights, nd=2, degree=1, weight_dtype=None):
    """The kernel a CUDA smoothing call of ``n`` fields of ``dtype`` on an
    ``nd``-D grid at ``degree``, with planes stored in ``weight_dtype``
    (None: ``dtype``), runs, from its shape alone, and its chunk width:

    * ("per_entry", 0): complex fields, weights per batch entry, 2-byte
      planes (bf16, f16), and one field of a stencil with fewer weights
      than the ring has stages (2-D degree 1, K = 9) run
      ``csrc/cheb_smooth.cuh`` (one thread per node and entry): on one
      H100, with 2-byte planes the tile took 1.02-1.10x its time on the
      mass solves' batches and the ring 1.00-1.62x its device time, and
      at 1 x 257^2, degree 1, the ring 1.08-1.19x (PERF.md, PR 13);
    * ("tile", NB): n >= 2 real fields with shared weights run
      ``csrc/cheb_tile.cuh`` in chunks of NB fields (``TILE_WIDTHS``, 8
      for float32 3-D at degree 1; a ragged last chunk is masked), each
      weight read once a step for the chunk;
    * ("ring", 1): one real field runs the same kernel with its weights
      streamed through the asynchronous shared-memory ring."""
    narrow2 = weight_dtype is not None and weight_dtype.itemsize == 2
    if dtype.is_complex or (n > 1 and not shared_weights) or narrow2:
        return "per_entry", 0
    if n <= 1:
        if (2 * degree + 1) ** nd < RING_STAGES:
            return "per_entry", 0
        return "ring", 1
    return "tile", _tile_width(dtype, nd, degree)


def _cheb_cuda(w, dinv, b, x0, steps, theta, delta, degree, want_residual,
               nd, weight_dtype=None):
    """K2, K3 and K5 (real and complex).  w and dinv are planes in b's
    dtype, or narrow planes (``narrow_planes``: bf16, f16 or, under
    float64 fields, f32; complex ones as (re, im) pairs), which run the
    narrow kernels.  Planes in b's dtype with a narrower ``weight_dtype``
    are refused: a cast in every call would read the full planes and
    write the narrow ones each time, so they are stored narrow once, as
    the multigrid hierarchies do at build time."""
    what = "fused_cheb_smooth"
    dt = b.dtype
    rdt = b.real.dtype if b.is_complex() else dt
    narrow = w.dtype != dt
    wdt = weight_storage_dtype(weight_dtype, dt)
    if wdt is not None and not narrow:
        raise TypeError(f"{what}: weight_dtype {weight_dtype} asks for "
                        f"narrow planes, but they come in {dt}: store them "
                        "with narrow_planes first (a multigrid hierarchy "
                        "does so once per build)")
    if narrow and (w.dtype not in kernels.WEIGHT_CODES
                   or weight_storage_dtype(w.dtype, dt) is None
                   or wdt not in (None, w.dtype)
                   or (b.is_complex() and w.shape[-1] != 2)):
        raise TypeError(f"{what}: weight planes stored as {w.dtype} do "
                        f"not fit {dt} fields (weight_dtype "
                        f"{weight_dtype})")
    pair = (2,) if narrow and b.is_complex() else ()
    wshape = tuple(w.shape[:w.dim() - len(pair)])
    grid = _cuda_grid(wshape, b, degree, nd, what)
    if (dinv.dtype != w.dtype or w.device != b.device
            or dinv.device != b.device):
        raise TypeError(f"{what}: w and dinv need one dtype, on the "
                        "device of the fields")
    if x0.dtype != dt or x0.device != b.device:
        raise TypeError(f"{what}: b and x0 need one dtype and device")
    if b.dim() not in (nd, nd + 1):
        raise ValueError(f"{what}: b must be (*grid) or (n, *grid)")
    lead = tuple(b.shape[:-nd])
    bshape, n, w_bs = _batch_layout(wshape, lead, grid)
    if bshape != lead:
        raise ValueError(f"{what}: weights batch exceeds b")
    # dinv: shared volume (stride 0) or one volume per batch entry; strides
    # count stored values (pairs of narrow complex planes)
    dlead = tuple(dinv.shape[:dinv.dim() - nd - len(pair)])
    if math.prod(dlead) == 1:
        dc, d_bs = dinv.reshape(grid + pair).contiguous(), 0
    else:
        dc = dinv.expand(lead + grid + pair).contiguous()
        d_bs = math.prod(grid)
    bc = b.contiguous()
    xc = x0.expand(lead + grid).contiguous()
    th, de, th_s = _bound_vectors(theta, delta, n, rdt, b.device)
    x_out = torch.empty_like(bc)
    x_tmp = torch.empty_like(bc)
    p = torch.empty_like(bc)
    r = torch.empty_like(bc) if want_residual else None
    lib = kernels.library()
    kind = "complex" if b.is_complex() else "real"
    key = _key(f"cheb_smooth_{kind}", degree, nd)
    if narrow:
        key += "_" + _WEIGHT_TAGS[w.dtype]
    tail = (bc.data_ptr(), xc.data_ptr(), th.data_ptr(), de.data_ptr(), th_s,
            x_out.data_ptr(), x_tmp.data_ptr(), p.data_ptr(),
            None if r is None else r.data_ptr(), max(n, 1), *_zyx(grid), nd,
            degree, int(steps), kernels.stream_ptr(b.device))
    design, nb = cheb_design(dt, n, w_bs == 0, nd, degree, w.dtype)
    if design != "per_entry":
        code = lib.cheb_smooth_tile(
            kernels.DTYPE_CODES[dt],
            kernels.WEIGHT_CODES[w.dtype] if narrow else -1, nb,
            w.contiguous().data_ptr(), dc.data_ptr(), d_bs, *tail)
        kernels.check(code, "cheb_smooth_tile")
    elif narrow:
        code = lib.cheb_smooth_narrow(
            kernels.DTYPE_CODES[dt], kernels.WEIGHT_CODES[w.dtype],
            w.contiguous().data_ptr(), w_bs, dc.data_ptr(), d_bs, *tail)
        kernels.check(code, "cheb_smooth_narrow")
    else:
        code = lib.cheb_smooth(kernels.DTYPE_CODES[dt],
                               w.contiguous().data_ptr(), w_bs,
                               dc.data_ptr(), d_bs, *tail)
        kernels.check(code, "cheb_smooth")
    launch_counts[key] += 1
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
    th, de, th_s = _bound_vectors(theta, delta, n, dt, b.device)
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
    ``_cheb_plain``.

    ``weight_dtype`` (e.g. "bfloat16") stores the weight and diagonal
    planes in a narrower dtype while the field arithmetic stays in
    b's dtype.  On the CPU w and dinv may come in b's dtype (rounded in
    the call) or stored narrow (``narrow_planes``); on the card they must
    come stored narrow.  There, scalar stencils with a ``weight_dtype``
    narrower than the fields' real dtype (bf16 or f16; f32 under float64
    fields) run the narrow variants of K2/K3/K5; an
    equal or wider one rounds nothing and runs the kernels above; vector
    stencils (K4, K5v) have no narrow kernel and raise
    ``NotImplementedError``.  Returns x (and r = b - A x).
    """
    if b.is_cuda:
        if _is_vector_stencil(w, nd) and not _is_pairs(w, b):
            if (w.dtype != b.dtype
                    or weight_storage_dtype(weight_dtype, b.dtype)):
                raise NotImplementedError(
                    "fused_cheb_smooth: narrow weight planes (weight_dtype "
                    f"{weight_dtype}) on vector stencils have no CUDA "
                    "kernel (K4, K5v store their weights in the field "
                    "dtype)")
            return _cheb_vector_cuda(w, dinv, b, x0, steps, theta, delta,
                                     degree, want_residual, nd)
        return _cheb_cuda(w, dinv, b, x0, steps, theta, delta, degree,
                          want_residual, nd, weight_dtype)
    return _cheb_plain(w, dinv, b, x0, steps, theta, delta, degree,
                       want_residual=want_residual,
                       weight_dtype=weight_dtype, nd=nd)


def _cheb_pair_cuda(wF, wS, mu, dinv, b, x0, steps, theta, delta, degree,
                    want_residual, nd):
    """The pair smoother on the card (``csrc/cheb_smooth_pair.cu``)."""
    what = "fused_cheb_smooth_pair"
    dt = b.dtype
    if dt not in (torch.complex64, torch.complex128):
        raise TypeError(f"{what}: complex64 or complex128 fields only, "
                        f"not {dt}")
    rdt = b.real.dtype
    if (wF.dtype != rdt or wS.dtype != rdt or wF.device != b.device
            or wS.device != b.device):
        raise TypeError(f"{what}: W_F and W_S need the fields' real dtype "
                        "and their device")
    if wF.shape != wS.shape or wF.dim() != nd + 1:
        raise ValueError(f"{what}: W_F and W_S are one real stencil "
                         "(K, *grid) each, shared by all frequencies")
    grid = _cuda_grid(tuple(wF.shape), b, degree, nd, what)
    for t in (dinv, x0):
        if t.dtype != dt or t.device != b.device:
            raise TypeError(f"{what}: dinv, b and x0 need one dtype and "
                            "device")
    if b.dim() not in (nd, nd + 1):
        raise ValueError(f"{what}: b must be (*grid) or (n, *grid)")
    lead = tuple(b.shape[:-nd])
    n = math.prod(lead)
    muc = torch.as_tensor(mu).to(device=b.device, dtype=dt).reshape(-1)
    if muc.numel() != n:
        raise ValueError(f"{what}: one mu per frequency")
    # dinv: shared plane (stride 0) or one per frequency
    if math.prod(dinv.shape[:dinv.dim() - nd]) == 1:
        dc, d_bs = dinv.reshape(grid).contiguous(), 0
    else:
        dc, d_bs = dinv.expand(lead + grid).contiguous(), math.prod(grid)
    wFc, wSc, muc = wF.contiguous(), wS.contiguous(), muc.contiguous()
    bc = b.contiguous()
    xc = x0.expand(lead + grid).contiguous()
    th, de, th_s = _bound_vectors(theta, delta, n, rdt, b.device)
    x_out = torch.empty_like(bc)
    x_tmp = torch.empty_like(bc)
    p = torch.empty_like(bc)
    r = torch.empty_like(bc) if want_residual else None
    lib = kernels.library()
    code = lib.cheb_smooth_pair(
        kernels.DTYPE_CODES[dt], wFc.data_ptr(), wSc.data_ptr(),
        muc.data_ptr(), dc.data_ptr(), d_bs, bc.data_ptr(), xc.data_ptr(),
        th.data_ptr(), de.data_ptr(), th_s, x_out.data_ptr(),
        x_tmp.data_ptr(), p.data_ptr(), None if r is None else r.data_ptr(),
        max(n, 1), *_zyx(grid), nd, degree, int(steps),
        kernels.stream_ptr(b.device))
    kernels.check(code, "cheb_smooth_pair")
    launch_counts[_pair_key(degree, nd)] += 1
    return (x_out, r) if want_residual else x_out


def fused_cheb_smooth_pair(wF, wS, mu, dinv, b, x0, steps, theta, delta,
                           degree, want_residual=False, nd=2):
    """``steps`` Chebyshev-Jacobi iterations (+ optionally the final
    residual) on the frequency blocks A_k = W_F + mu_k W_S of a ParaDiag
    hierarchy stored as one real stencil pair.

    wF, wS: (K, *grid) real, in b's real dtype, shared by every
    frequency; mu: (n,) complex (a scalar for unbatched b); dinv, b, x0:
    (*grid) or (n, *grid) complex (dinv and x0 broadcast to b);
    theta/delta: scalars or (n,).  The same recurrence as
    ``fused_cheb_smooth`` on the formed planes W_F + mu_k W_S.  A CUDA
    tensor runs the kernel (``csrc/cheb_smooth_pair.cu``) or raises; a
    CPU tensor runs ``_cheb_pair_plain``.  Returns x (and r = b - A x)."""
    if b.is_cuda:
        return _cheb_pair_cuda(wF, wS, mu, dinv, b, x0, steps, theta, delta,
                               degree, want_residual, nd)
    return _cheb_pair_plain(wF, wS, mu, dinv, b, x0, steps, theta, delta,
                            degree, want_residual=want_residual, nd=nd)


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

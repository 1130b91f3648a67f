"""K2 and K5 real on the plane-tile design (``csrc/cheb_tile.cuh``): the
kernel each shape runs, the plain version on shared-weight batches
against the JAX package, and (on the card) the kernels against the plain
version.

* ``cheb_design``: the kernel and chunk width each call runs, from its
  shape alone (per-entry weights, complex fields, 2-byte planes and one
  field of a 2-D degree-1 stencil: ``cheb_smooth.cuh``; a real batch with
  shared weights: the tile in chunks of NB; one other real field: the
  asynchronous weight ring);
* ``_cheb_plain`` on shared-weight batches of n = 1, 7, 8, 9, 15, 17 (the
  chunk widths, one past them and ragged chunks) at 2-D degree 1-4 and
  3-D degree 1-3 against the JAX package's ``fused_cheb_smooth`` through
  its plain reference (``use_pallas=False``), and at degree 1 against its
  Pallas kernels in interpret mode (``fused_cheb_smooth``'s inline K2,
  ``_fused_cheb_nd3``), as the JAX package's own tests run them on the
  CPU; tolerance 1e-12 relative to the largest entry (float64, another
  summation order);
* on the card (marked ``gpu``): the kernels against ``_cheb_plain`` on the
  same CUDA tensors, for the same batches on odd grids, in float64 and
  float32, with planes stored as the fields and narrow (bf16 under
  float32, f32 under float64); shared and per-field dinv and bounds, 1 and
  4 steps, residual on and off.  Tolerance 1e-12 in float64, 1e-4 in
  float32.  The weights at offsets outside the grid are random and
  nonzero, so a kernel that fails to mask a neighbour disagrees.

Inputs are made with numpy from a seed.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from control_tpu.ops import stencil as js
from control_tpu_torch.ops import stencil as ts

TOL = 1e-12
BATCHES = (1, 7, 8, 9, 15, 17)
GEOMETRIES = ((2, 1), (2, 2), (2, 3), (2, 4), (3, 1), (3, 2), (3, 3))


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_cache_writes():
    """The JAX package guards each persistent-cache write by serializing the
    executable in a forked child (``control_tpu.config``).  Here torch's
    thread pool is running, and a forked child can deadlock until the
    guard's 180 s timeout; so this module compiles without writing cache
    entries (reads still hit), and the setting comes back afterwards."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    yield
    jax.config.update(key, old)


def close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b))) / float(np.max(np.abs(a)))
    assert err <= tol, err


def _stencil(rng, grid, degree):
    """A diagonally dominant stencil with random nonzero weights at every
    offset (those outside the grid too), its inverse diagonal and
    Gershgorin Chebyshev bounds (theta, delta)."""
    K = (2 * degree + 1) ** len(grid)
    w = -0.5 * rng.uniform(0.2, 1.0, (K,) + grid) * 9 / K
    w[K // 2] = 4.0 + rng.uniform(0.0, 1.0, grid)
    lam = 1.05 * float((np.abs(w).sum(axis=0) / w[K // 2]).max())
    return w, 1.0 / w[K // 2], 0.625 * lam, 0.375 * lam


# (field dtype, n, shared weights, nd, degree) -> the design cheb_design
# picks
DESIGNS = [
    (torch.complex64, 1, True, 2, 1, ("per_entry", 0)),
    (torch.complex64, 9, True, 3, 2, ("per_entry", 0)),
    (torch.complex128, 8, False, 2, 1, ("per_entry", 0)),
    (torch.float32, 9, False, 3, 3, ("per_entry", 0)),
    (torch.float64, 2, False, 2, 3, ("per_entry", 0)),
    (torch.float32, 1, True, 2, 3, ("ring", 1)),
    (torch.float32, 1, True, 3, 1, ("ring", 1)),
    (torch.float64, 1, True, 3, 3, ("ring", 1)),
    (torch.float64, 1, False, 2, 1, ("per_entry", 0)),
    (torch.float32, 2, True, 2, 1, ("tile", 16)),
    (torch.float32, 7, True, 3, 2, ("tile", 16)),
    (torch.float32, 8, True, 2, 4, ("tile", 16)),
    (torch.float32, 9, True, 3, 3, ("tile", 16)),
    (torch.float32, 15, True, 3, 2, ("tile", 16)),
    (torch.float32, 15, True, 3, 3, ("tile", 16)),
    (torch.float32, 15, True, 3, 1, ("tile", 8)),
    (torch.float32, 9, True, 3, 1, ("tile", 8)),
    (torch.float32, 16, True, 2, 2, ("tile", 16)),
    (torch.float32, 17, True, 2, 1, ("tile", 16)),
    (torch.float32, 63, True, 2, 1, ("tile", 16)),
    (torch.float64, 2, True, 2, 1, ("tile", 8)),
    (torch.float64, 5, True, 3, 1, ("tile", 8)),
    (torch.float64, 7, True, 3, 1, ("tile", 8)),
    (torch.float64, 9, True, 2, 2, ("tile", 8)),
    (torch.float64, 15, True, 3, 3, ("tile", 8)),
    (torch.float64, 17, True, 2, 4, ("tile", 8)),
]


@pytest.mark.parametrize("dtype,n,shared,nd,degree,expected", DESIGNS)
def test_cheb_design_by_shape(dtype, n, shared, nd, degree, expected):
    """The kernel and chunk width follow from dtype, batch, weight sharing,
    grid dimension and degree alone: one width a dtype, and chunks of 8
    for float32 3-D batches at degree 1."""
    assert ts.cheb_design(dtype, n, shared, nd, degree) == expected
    if expected[0] == "tile":
        assert expected[1] == (
            8 if dtype == torch.float32 and (nd, degree) == (3, 1)
            else ts.TILE_WIDTHS[dtype])


@pytest.mark.parametrize("weights,n,nd,degree,expected", [
    (torch.bfloat16, 1, 3, 3, ("per_entry", 0)),
    (torch.float16, 15, 3, 1, ("per_entry", 0)),
    (torch.bfloat16, 63, 2, 1, ("per_entry", 0)),
    (torch.float32, 1, 3, 1, ("ring", 1)),
    (torch.float32, 1, 2, 1, ("per_entry", 0)),
    (torch.float32, 1, 2, 2, ("ring", 1)),
    (torch.float32, 9, 3, 3, ("tile", 8))])
def test_cheb_design_by_weight_storage(weights, n, nd, degree, expected):
    """Under float64 fields: 2-byte planes run the per-entry kernel at
    every shape, float32 planes the tile and the ring as full ones do (a
    single field of a 2-D degree-1 stencil, K = 9 < 16 ring stages, the
    per-entry kernel)."""
    assert ts.cheb_design(torch.float64, n, True, nd, degree,
                          weights) == expected


def _batch(rng, nd, degree, n):
    grid = (9, 11) if nd == 2 else (4, 5, 6)
    w, dinv, th, de = _stencil(rng, grid, degree)
    b = rng.standard_normal((n,) + grid)
    x0 = rng.standard_normal((n,) + grid)
    return w, dinv, b, x0, th, de


@functools.lru_cache(maxsize=None)
def _reference(nd, degree):
    """Inputs of the largest batch and the JAX package's plain reference
    on them, 3 steps + r: the fields of a batch with shared weights and
    scalar bounds are independent, so every smaller batch is its head
    (one JAX run per geometry)."""
    rng = np.random.default_rng(100 + 10 * nd + degree)
    w, dinv, b, x0, th, de = _batch(rng, nd, degree, max(BATCHES))
    ref = js.fused_cheb_smooth(jnp.asarray(w), jnp.asarray(dinv),
                               jnp.asarray(b), jnp.asarray(x0), 3, th, de,
                               degree, want_residual=True, use_pallas=False,
                               nd=nd)
    return (w, dinv, b, x0, th, de), tuple(np.asarray(a) for a in ref)


@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("nd,degree", GEOMETRIES)
def test_plain_shared_batches_match_reference(nd, degree, n):
    """``_cheb_plain`` on n fields sharing one stencil, dinv and scalar
    bounds, 3 steps + r, against the JAX package's plain reference."""
    (w, dinv, b, x0, th, de), ref = _reference(nd, degree)
    t = torch.as_tensor
    got = ts.fused_cheb_smooth(t(w), t(dinv), t(b[:n]), t(x0[:n]), 3, th,
                               de, degree, want_residual=True, nd=nd)
    close(ref[0][:n], got[0])
    close(ref[1][:n], got[1])


@pytest.mark.parametrize("n", (1, 9))
def test_plain_shared_batches_match_tpu_kernel(n):
    """The same in 3-D at degree 1 against the TPU kernel itself,
    ``_fused_cheb_nd3`` with C = 1 in Pallas interpret mode (one program
    per field), as ``tests/test_stencil3d_pallas.py`` runs it (the 2-D
    inline K2 has no interpret mode: its plain reference stands above)."""
    rng = np.random.default_rng(200 + n)
    w, dinv, b, x0, th, de = _batch(rng, 3, 1, n)
    t = torch.as_tensor
    got = ts.fused_cheb_smooth(t(w), t(dinv), t(b), t(x0), 3, th, de, 1,
                               want_residual=True, nd=3)
    ref = js._fused_cheb_nd3(jnp.asarray(w), jnp.asarray(dinv),
                             jnp.asarray(b), jnp.asarray(x0), 3, th, de, 1,
                             want_residual=True, interpret=True)
    close(ref[0], got[0])
    close(ref[1], got[1])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("nd,degree", GEOMETRIES)
@pytest.mark.parametrize("dtype,weights", [
    ("float64", None), ("float32", None), ("float64", "float32"),
    ("float32", "bfloat16")])
def test_tile_kernels_match_plain_on_card(nd, degree, n, dtype, weights):
    """The kernel ``cheb_design`` picks (the tile in chunks, the ring at
    n = 1, the per-entry kernel with bf16 planes or at 2-D degree 1 and
    n = 1) against ``_cheb_plain`` on the same CUDA tensors: odd grids,
    planes stored as the fields or narrow, a shared dinv with scalar
    bounds and a per-field dinv with per-field bounds, 1 and 4 steps,
    residual on and off.  Each call counts one launch of its key and no
    other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    tol = 1e-12 if dt == torch.float64 else 1e-4
    rng = np.random.default_rng(300 + 10 * nd + degree)
    grid = (45, 71) if nd == 2 else (9, 13, 37)
    w, dinv, th, de = _stencil(rng, grid, degree)

    def cu(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device="cuda")

    w, dinv = cu(w), cu(dinv)
    b, x0 = cu(rng.standard_normal((n,) + grid)), cu(
        rng.standard_normal((n,) + grid))
    dinv_n = cu(np.asarray(dinv.cpu())[None] * rng.uniform(
        0.8, 1.0, (n,) + grid))
    th_n = cu(th * rng.uniform(0.9, 1.1, n))
    de_n = cu(de * rng.uniform(0.9, 1.1, n))
    if weights:
        w = ts.narrow_planes(w, weights)
        dinv = ts.narrow_planes(dinv, weights)
        dinv_n = ts.narrow_planes(dinv_n, weights)

    def rel(got, ref):
        return float((got - ref).abs().max() / ref.abs().max())

    key = ts._key("cheb_smooth_real", degree, nd)
    if weights:
        key += "_" + ts._WEIGHT_TAGS[getattr(torch, weights)]
    before = dict(ts.launch_counts)
    calls = 0
    for d, t, e in ((dinv, th, de), (dinv_n, th_n, de_n)):
        for steps in (1, 4):
            got = ts.fused_cheb_smooth(w, d, b, x0, steps, t, e, degree,
                                       want_residual=True,
                                       weight_dtype=weights, nd=nd)
            ref = ts._cheb_plain(w, d, b, x0, steps, t, e, degree,
                                 want_residual=True, weight_dtype=weights,
                                 nd=nd)
            assert rel(got[0], ref[0]) <= tol
            assert rel(got[1], ref[1]) <= tol
            assert rel(ts.fused_cheb_smooth(w, d, b, x0, steps, t, e, degree,
                                            weight_dtype=weights, nd=nd),
                       ref[0]) <= tol
            calls += 2
    torch.cuda.synchronize()
    assert ts.launch_counts[key] == before[key] + calls
    for k, v in ts.launch_counts.items():
        if k != key:
            assert v == before[k], k

"""K1 and K6 on the plane tile (``csrc/stencil_apply_tile.cu``): the kernel
each shape runs, the plain version on shared-weight batches against the
JAX package, and (on the card) the kernels against the plain version.

* ``apply_design``: the kernel and chunk width each call runs, from its
  shape alone (complex fields, per-entry weights, one field and the 2-D
  degrees 2-4: the per-entry kernel of ``csrc/stencil_apply.cu``; a real
  batch with shared weights at 2-D degree 1 and 3-D degree 1-3: the
  tile in chunks of NB);
* ``_apply_plain`` on shared-weight batches of n = 2, 9, 17 (ragged
  against the chunk widths 8 and 16) at 2-D degree 1 against the JAX
  package's ``_apply_xla`` (its 2-D Pallas kernel has no interpret mode)
  and at 3-D degree 1-3 against its TPU kernel ``_apply_3d_pallas`` in
  Pallas interpret mode, on odd grids of 5 to 7 nodes an axis: one JAX
  run per geometry on the largest batch in float64, every smaller batch
  its head (shared weights: the fields are independent).  The port runs
  the same inputs in float64 (tolerance 1e-12 relative to the largest
  entry: another summation order) and rounded to float32 (1e-5);
* the CPU tensors of every tile geometry never reach the library.

The kernels themselves run on the card: ``test_torch_apply_tile_gpu.py``.
Inputs are made with numpy from a seed.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from control_tpu.ops import stencil as js
from control_tpu_torch.ops import kernels
from control_tpu_torch.ops import stencil as ts

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
BATCHES = (2, 9, 17)
# (nd, degree) -> an odd grid of 5-7 nodes an axis
GRIDS = {(2, 1): (7, 5), (3, 1): (5, 6, 7), (3, 2): (5, 7, 7),
         (3, 3): (7, 7, 7)}


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


def rel_err(ref, got):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got))) / float(np.max(np.abs(ref)))


# (field dtype, n, shared weights, nd, degree) -> the design apply_design
# picks
DESIGNS = [
    (torch.complex64, 9, True, 2, 1, ("per_entry", 0)),
    (torch.complex128, 2, True, 2, 1, ("per_entry", 0)),
    (torch.float32, 15, False, 3, 3, ("per_entry", 0)),
    (torch.float64, 63, False, 2, 1, ("per_entry", 0)),
    (torch.float32, 1, True, 2, 1, ("per_entry", 0)),
    (torch.float64, 1, True, 3, 3, ("per_entry", 0)),
    (torch.float32, 1, True, 3, 1, ("per_entry", 0)),
    (torch.float32, 9, True, 2, 3, ("per_entry", 0)),
    (torch.float64, 16, True, 2, 4, ("per_entry", 0)),
    (torch.float32, 2, True, 2, 2, ("per_entry", 0)),
    (torch.float32, 63, True, 2, 1, ("tile", 16)),
    (torch.float32, 2, True, 2, 1, ("tile", 16)),
    (torch.float64, 63, True, 2, 1, ("tile", 8)),
    (torch.float32, 15, True, 3, 1, ("tile", 8)),
    (torch.float64, 15, True, 3, 1, ("tile", 8)),
    (torch.float32, 15, True, 3, 2, ("tile", 16)),
    (torch.float64, 9, True, 3, 2, ("tile", 8)),
    (torch.float32, 15, True, 3, 3, ("tile", 16)),
    (torch.float32, 16, True, 3, 3, ("tile", 16)),
    (torch.float64, 17, True, 3, 3, ("tile", 8)),
]


@pytest.mark.parametrize("dtype,n,shared,nd,degree,expected", DESIGNS)
def test_apply_design_by_shape(dtype, n, shared, nd, degree, expected):
    """The kernel and chunk width follow from dtype, batch, weight sharing,
    grid dimension and degree alone; the tile takes the smoothers' chunk
    widths."""
    assert ts.apply_design(dtype, n, shared, nd, degree) == expected
    if expected[0] == "tile":
        assert expected[1] == ts.cheb_design(dtype, n, True, nd, degree)[1]


@functools.lru_cache(maxsize=None)
def _reference(nd, degree):
    """Weights and the largest batch of one geometry (float64 values that
    float32 holds exactly), and the JAX package's application of them."""
    rng = np.random.default_rng(140 + 10 * nd + degree)
    grid = GRIDS[(nd, degree)]
    K = (2 * degree + 1) ** nd
    w = rng.standard_normal((K,) + grid).astype(np.float32)
    x = rng.standard_normal((max(BATCHES),) + grid).astype(np.float32)
    w, x = w.astype(np.float64), x.astype(np.float64)
    if nd == 2:
        ref = js._apply_xla(jnp.asarray(w), jnp.asarray(x), degree)
    else:
        ref = js._apply_3d_pallas(jnp.asarray(w), jnp.asarray(x), degree,
                                  interpret=True)
    return w, x, np.asarray(ref)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("nd,degree", sorted(GRIDS))
def test_plain_shared_batches_match_reference(nd, degree, n, dtype):
    """``apply_stencil`` on CPU tensors (``_apply_plain``) for n fields
    sharing one stencil against the JAX package's application."""
    w, x, ref = _reference(nd, degree)
    got = ts.apply_stencil(torch.as_tensor(w, dtype=dtype),
                           torch.as_tensor(x[:n], dtype=dtype), degree,
                           nd=nd)
    assert got.dtype == dtype
    assert rel_err(ref[:n], got) <= TOL[dtype]


def test_cpu_batches_never_reach_the_library(monkeypatch):
    """CPU tensors of every tile geometry run the twin: no library, no
    launch counted."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(kernels, "library", no_library)
    before = dict(ts.launch_counts)
    for nd, degree in ts.TILE_APPLY_GEOMETRIES:
        w, x, ref = _reference(nd, degree)
        ts.apply_stencil(torch.as_tensor(w), torch.as_tensor(x), degree,
                         nd=nd)
    assert ts.launch_counts == before

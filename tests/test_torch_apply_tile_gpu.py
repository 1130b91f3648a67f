"""K1 and K6 on the card (marked ``gpu``; they skip without CUDA): the
kernel ``apply_design`` picks (the plane tile of
``csrc/stencil_apply_tile.cu`` on shared-weight batches, else the
per-entry kernel of ``csrc/stencil_apply.cu``) against ``_apply_plain``
on the same CUDA tensors for n = 2, 8, 15, 16, 17, 33 on 257^2, 65^3,
73^3 and 97^3 (none a multiple of the 32 x 8 tile), degree 1 in 2-D and
1-3 in 3-D, in float64 (tolerance 1e-12 relative to the largest entry:
another summation order) and float32 (1e-5), with a broadcast x and
weights with a leading batch axis of one, and the launches each call
counts; the C entry point refuses a chunk width it was not built for.
The weights are random and nonzero at every offset, those outside the
grid too, so a kernel that fails to mask a neighbour or a field past the
batch disagrees.  Inputs come from a seeded torch generator on the card.
This file imports nothing of JAX: the plain version is the yardstick
(``test_torch_apply_tile.py`` holds it against the JAX package).
"""

import functools

import pytest
import torch

from control_tpu_torch.ops import kernels
from control_tpu_torch.ops import stencil as ts

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def rel_err(ref, got):
    return float((ref - got).abs().max() / ref.abs().max())


CARD_BATCHES = (2, 8, 15, 16, 17, 33)
CARD_GEOMETRIES = (((257, 257), 1), ((65,) * 3, 1), ((97,) * 3, 1),
                   ((65,) * 3, 2), ((73,) * 3, 3), ((97,) * 3, 3))


@functools.lru_cache(maxsize=1)
def _card_inputs(grid, degree, dtype):
    """Random weights (every offset nonzero) and the largest batch, one
    field more for the broadcast x, made on the card from a seeded
    generator (the largest sets hold 1.25 G values; numpy would take
    seconds)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1400 + degree)
    K = (2 * degree + 1) ** len(grid)
    w = torch.randn((K,) + grid, generator=gen, dtype=dtype, device="cuda")
    x = torch.randn((max(CARD_BATCHES) + 1,) + grid, generator=gen,
                    dtype=dtype, device="cuda")
    return w, x


@pytest.mark.gpu
@pytest.mark.parametrize("n", CARD_BATCHES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("grid,degree", CARD_GEOMETRIES)
def test_tile_matches_plain_on_card(grid, degree, dtype, n):
    """The kernel ``apply_design`` picks against ``_apply_plain`` on the
    same CUDA tensors; a broadcast x (one field expanded to n) and weights
    with a leading batch axis of one run the same kernel.  Each call
    counts one launch of its K1 / K6 key and, where the tile ran, one of
    its ``_tile`` key, and no other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    nd = len(grid)
    w, xs = _card_inputs(grid, degree, dt)
    x = xs[:n]
    key = ts._key("stencil_apply", degree, nd)
    tile_key = ts._key("stencil_apply_tile", degree, nd)
    design = ts.apply_design(dt, n, True, nd, degree)[0]
    before = dict(ts.launch_counts)
    got = ts.apply_stencil(w, x, degree, nd=nd)
    assert rel_err(ts._apply_plain(w, x, degree, nd=nd), got) <= TOL[dt]
    x1 = xs[n].expand((n,) + grid)
    got = ts.apply_stencil(w[None], x1, degree, nd=nd)
    assert rel_err(ts._apply_plain(w, x1, degree, nd=nd), got) <= TOL[dt]
    torch.cuda.synchronize()
    after = dict(ts.launch_counts)
    assert after[key] == before[key] + 2
    assert after[tile_key] == before[tile_key] + (2 if design == "tile"
                                                  else 0)
    for k, v in after.items():
        if k not in (key, tile_key):
            assert v == before[k], k


@pytest.mark.gpu
def test_tile_refuses_other_widths_on_card():
    """The C entry point takes only the chunk width it was built with for
    each dtype and geometry, and the wrapper's check raises on its
    error code."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = torch.ones((27, 9, 9, 9), dtype=torch.float32, device="cuda")
    x = torch.ones((4, 9, 9, 9), dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    lib = kernels.library()
    for nb in (4, 16):
        code = lib.stencil_apply_tile(
            kernels.DTYPE_CODES[x.dtype], nb, w.data_ptr(), x.data_ptr(),
            y.data_ptr(), 4, 9, 9, 9, 3, 1, kernels.stream_ptr(x.device))
        with pytest.raises(RuntimeError):
            kernels.check(code, "stencil_apply_tile")
    assert ts.apply_design(torch.float32, 4, True, 3, 1) == ("tile", 8)

"""The port's node stencils and the plain versions of its kernels against
the JAX package, in float64 on the CPU.

* ``node_stencil`` (with mask and alpha) against the reference's fold;
* K1's plain version ``_apply_plain`` against the reference's
  ``_apply_xla``;
* K2's plain version ``_cheb_plain`` against
  ``fused_cheb_smooth(use_pallas=False)``: shared and per-batch weights,
  scalar and (n,) bounds, unbatched input, with and without the residual;
* K3's plain version against the TPU kernel ``_fused_cheb_complex`` run in
  Pallas interpret mode.

Inputs are made with numpy from a seed; tolerance 1e-12 relative to the
largest entry (the same float64 recurrence, summed in another order).
The CUDA kernels themselves run only on a card: the test marked ``gpu``
holds them against these plain versions there (and skips elsewhere), as
does ``chip_smoke.py`` at the flagship's shapes.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import control_tpu as J
import control_tpu_torch as T
from control_tpu.ops import stencil as js
from control_tpu_torch.ops import stencil as ts
from control_tpu_torch.ops import kernels

TOL = 1e-12


def close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b))) / float(np.max(np.abs(a)))
    assert err <= tol, err


def random_stencil(rng, shape, cplx=False):
    w = rng.standard_normal(shape)
    if cplx:
        w = w + 1j * rng.standard_normal(shape)
    return w


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("alpha", [1.0, 0.0, 2.5])
@pytest.mark.parametrize("masked", [True, False])
def test_node_stencil(degree, alpha, masked):
    mj = J.UnitSquareMesh(5, 6, quadrilateral=True, dtype="float64")
    mt = T.UnitSquareMesh(5, 6, quadrilateral=True, dtype="float64")
    sj, st = J.FunctionSpace(mj, "Lagrange", degree), \
        T.FunctionSpace(mt, "Lagrange", degree)

    def op(mod, sp):
        u, v = mod.TrialFunction(sp), mod.TestFunction(sp)
        X = mod.SpatialCoordinate(sp.mesh)
        return mod.assemble(mod.inner(mod.grad(u), mod.grad(v)) * mod.dx
                            + (1.0 + X[0] * X[1]) * mod.inner(u, v)
                            * mod.dx)

    Aj, At = op(J, sj), op(T, st)
    mask_j = J.DirichletBC(sj, 0.0).mask if masked else None
    mask_t = T.DirichletBC(st, 0.0).mask if masked else None
    wj = js.node_stencil(Aj.A, sj, mask=mask_j, alpha=alpha)
    wt = ts.node_stencil(At.A, st, mask=mask_t, alpha=alpha)
    close(wj, wt)
    # a batch of operators folds in one call
    Ab = np.stack([np.asarray(Aj.A), 2.0 * np.asarray(Aj.A)])
    close(js.node_stencil(jnp.asarray(Ab), sj, mask=mask_j, alpha=alpha),
          ts.node_stencil(torch.as_tensor(Ab), st, mask=mask_t,
                          alpha=alpha))
    close(js.stencil_diag(wj, False), ts.stencil_diag(wt))
    close(js.stencil_abs_rowsum(wj, False), ts.stencil_abs_rowsum(wt))


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("layout", ["shared", "shared_lead", "per_batch",
                                    "unbatched"])
@pytest.mark.parametrize("cplx", [False, True])
def test_apply_plain_matches_reference(degree, layout, cplx):
    rng = np.random.default_rng(1)
    K, ny, nx, n = (2 * degree + 1) ** 2, 9, 12, 4
    wshape = {"shared": (K, ny, nx), "shared_lead": (1, K, ny, nx),
              "per_batch": (n, K, ny, nx), "unbatched": (K, ny, nx)}[layout]
    xshape = (ny, nx) if layout == "unbatched" else (n, ny, nx)
    w = random_stencil(rng, wshape, cplx)
    x = random_stencil(rng, xshape, cplx)
    ref = js._apply_xla(jnp.asarray(w), jnp.asarray(x), degree)
    got = ts.apply_stencil(torch.as_tensor(w), torch.as_tensor(x), degree)
    close(ref, got)


def _spd_stencil(rng, lead, ny, nx, cplx=False):
    """A diagonally dominant 9-point stencil and its inverse diagonal."""
    w = -0.5 * rng.uniform(0.2, 1.0, lead + (9, ny, nx))
    w[..., 4, :, :] = 4.0 + rng.uniform(0.0, 1.0, lead + (ny, nx))
    if cplx:
        w = w * np.exp(1j * rng.uniform(-0.3, 0.3, w.shape))
    return w, 1.0 / w[..., 4, :, :]


CHEB_CASES = {
    # name: (w lead, field lead, bounds per batch)
    "shared_w_scalar_bounds": ((), (3,), False),
    "shared_lead_w_scalar_bounds": ((1,), (3,), False),
    "per_batch_w_scalar_bounds": ((3,), (3,), False),
    "per_batch_w_vector_bounds": ((3,), (3,), True),
    "shared_w_vector_bounds": ((), (3,), True),
    "unbatched": ((), (), False),
}


@pytest.mark.parametrize("case", sorted(CHEB_CASES))
@pytest.mark.parametrize("want_residual", [True, False])
@pytest.mark.parametrize("steps", [1, 4])
def test_cheb_plain_matches_reference(case, want_residual, steps):
    wlead, blead, vec = CHEB_CASES[case]
    rng = np.random.default_rng(2)
    ny, nx = 10, 11
    w, dinv = _spd_stencil(rng, wlead, ny, nx)
    b = rng.standard_normal(blead + (ny, nx))
    x0 = rng.standard_normal(blead + (ny, nx))
    if vec:
        theta = rng.uniform(1.0, 2.0, blead)
        delta = rng.uniform(0.3, 0.8, blead)
        th_j, de_j = jnp.asarray(theta), jnp.asarray(delta)
        th_t, de_t = torch.as_tensor(theta), torch.as_tensor(delta)
    else:
        th_j = th_t = 1.4
        de_j = de_t = 0.6
    ref = js.fused_cheb_smooth(jnp.asarray(w), jnp.asarray(dinv),
                               jnp.asarray(b), jnp.asarray(x0), steps, th_j,
                               de_j, 1, want_residual=want_residual,
                               use_pallas=False)
    got = ts.fused_cheb_smooth(torch.as_tensor(w), torch.as_tensor(dinv),
                               torch.as_tensor(b), torch.as_tensor(x0),
                               steps, th_t, de_t, 1,
                               want_residual=want_residual)
    if want_residual:
        close(ref[0], got[0])
        close(ref[1], got[1])
    else:
        close(ref, got)


def test_cheb_plain_broadcasts_dinv_and_x0():
    """A shared (ny, nx) inverse diagonal and a shared initial guess
    broadcast to the batch of right-hand sides."""
    rng = np.random.default_rng(3)
    w, dinv = _spd_stencil(rng, (), 8, 9)
    b = rng.standard_normal((4, 8, 9))
    x0 = rng.standard_normal((8, 9))
    ref = js.fused_cheb_smooth(jnp.asarray(w), jnp.asarray(dinv),
                               jnp.asarray(b), jnp.asarray(x0), 3, 1.2, 0.7,
                               1, want_residual=True, use_pallas=False)
    got = ts.fused_cheb_smooth(torch.as_tensor(w), torch.as_tensor(dinv),
                               torch.as_tensor(b), torch.as_tensor(x0), 3,
                               1.2, 0.7, 1, want_residual=True)
    close(ref[0], got[0])
    close(ref[1], got[1])


def test_cheb_plain_weight_dtype():
    """bfloat16 weight planes: the plain version rounds like the
    reference's fallback."""
    rng = np.random.default_rng(4)
    w, dinv = _spd_stencil(rng, (2,), 8, 8)
    b = rng.standard_normal((2, 8, 8))
    ref = js.fused_cheb_smooth(jnp.asarray(w), jnp.asarray(dinv),
                               jnp.asarray(b), jnp.zeros_like(b), 3, 1.2,
                               0.7, 1, use_pallas=False,
                               weight_dtype="bfloat16")
    got = ts.fused_cheb_smooth(torch.as_tensor(w), torch.as_tensor(dinv),
                               torch.as_tensor(b),
                               torch.zeros(2, 8, 8, dtype=torch.float64),
                               3, 1.2, 0.7, 1, weight_dtype="bfloat16")
    close(ref, got)


@pytest.mark.parametrize("shared_w", [False, True])
@pytest.mark.parametrize("steps", [3, 5])
def test_complex_cheb_plain_matches_tpu_kernel(shared_w, steps):
    """K3's plain version against the TPU kernel itself (Pallas interpret
    mode), per-batch (n,) bounds, residual on."""
    rng = np.random.default_rng(7)
    n, ny, nx = 4, 17, 17
    w, dinv = _spd_stencil(rng, (1,) if shared_w else (n,), ny, nx,
                           cplx=True)
    b = (rng.standard_normal((n, ny, nx))
         + 1j * rng.standard_normal((n, ny, nx)))
    x0 = (rng.standard_normal((n, ny, nx))
          + 1j * rng.standard_normal((n, ny, nx)))
    dinv = np.array(np.broadcast_to(dinv, (n, ny, nx)))
    theta = rng.uniform(1.0, 2.0, n)
    delta = rng.uniform(0.3, 0.8, n)
    ref_x, ref_r = js._fused_cheb_complex(
        jnp.asarray(w), jnp.asarray(dinv), jnp.asarray(b), jnp.asarray(x0),
        steps, jnp.asarray(theta), jnp.asarray(delta), 1,
        want_residual=True, interpret=True)
    got_x, got_r = ts.fused_cheb_smooth(
        torch.as_tensor(w), torch.as_tensor(dinv),
        torch.as_tensor(b), torch.as_tensor(x0), steps,
        torch.as_tensor(theta), torch.as_tensor(delta), 1,
        want_residual=True)
    close(ref_x, got_x)
    close(ref_r, got_r)


def test_stencil_op_equals_masked_local_op():
    mt = T.UnitSquareMesh(6, 5, quadrilateral=True, dtype="float64")
    st = T.FunctionSpace(mt, "Lagrange", 1)
    u, v = T.TrialFunction(st), T.TestFunction(st)
    A = T.assemble(T.inner(T.grad(u), T.grad(v)) * T.dx
                   + T.inner(u, v) * T.dx)
    from control_tpu_torch.ops.local_op import MaskedOp
    Am = MaskedOp(A, T.DirichletBC(st, 0.0).mask)
    S = ts.StencilOp.from_local(Am)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (3,) + st.grid_shape))
    close(Am.apply(x), S.apply(x))
    close(Am.diag(), S.diag())


def test_cpu_tensors_never_touch_the_kernels():
    """On CPU tensors the wrappers run their plain versions: no launch is
    counted and no library is needed."""
    before = dict(ts.launch_counts)
    w = torch.ones(9, 5, 5, dtype=torch.float64)
    x = torch.ones(2, 5, 5, dtype=torch.float64)
    ts.apply_stencil(w, x, 1)
    ts.fused_cheb_smooth(w, x[0], x, x, 2, 1.0, 0.5, 1)
    assert ts.launch_counts == before


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without a CUDA compiler the build raises; it never falls back."""
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels._nvcc()


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CHEB_CASES))
@pytest.mark.parametrize("kind", ["float64", "float32", "complex128",
                                  "complex64"])
def test_kernels_match_plain_versions_on_card(case, kind):
    """K1 and K2/K3 on the card against their plain versions on the same
    CUDA tensors, over the layouts the wrappers take: shared and per-batch
    weights, scalar and (n,) bounds, unbatched fields, a shared dinv and
    x0, odd grid widths.  Tolerance: 1e-12 in double precision, 1e-5 (K1)
    and 1e-4 (K2/K3) in single (another summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, kind)
    cplx = dt.is_complex
    rdt = torch.float64 if dt in (torch.float64, torch.complex128) \
        else torch.float32
    tol_apply, tol_cheb = ((1e-12, 1e-12) if rdt == torch.float64
                           else (1e-5, 1e-4))
    wlead, blead, vec = CHEB_CASES[case]
    rng = np.random.default_rng(31)
    ny, nx = 37, 45
    w, dinv = _spd_stencil(rng, wlead, ny, nx, cplx=cplx)
    b = random_stencil(rng, blead + (ny, nx), cplx)
    x0 = random_stencil(rng, (ny, nx), cplx)

    def cu(a, dtype=dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device="cuda")

    if vec:
        th = cu(rng.uniform(1.0, 2.0, blead), rdt)
        de = cu(rng.uniform(0.3, 0.8, blead), rdt)
    else:
        th, de = 1.4, 0.6
    wt, dt_, bt, xt = cu(w), cu(dinv), cu(b), cu(x0)

    def rel(got, ref):
        return float((got - ref).abs().max() / ref.abs().max())

    before = dict(ts.launch_counts)
    assert rel(ts.apply_stencil(wt, bt, 1),
               ts._apply_plain(wt, bt, 1)) <= tol_apply
    for steps in (1, 4):
        got = ts.fused_cheb_smooth(wt, dt_, bt, xt, steps, th, de, 1,
                                   want_residual=True)
        ref = ts._cheb_plain(wt, dt_, bt, xt, steps, th, de, 1,
                             want_residual=True)
        assert rel(got[0], ref[0]) <= tol_cheb
        assert rel(got[1], ref[1]) <= tol_cheb
        assert rel(ts.fused_cheb_smooth(wt, dt_, bt, xt, steps, th, de, 1),
                   ref[0]) <= tol_cheb
    torch.cuda.synchronize()
    key = "cheb_smooth_complex" if cplx else "cheb_smooth_real"
    assert ts.launch_counts["stencil_apply"] == before["stencil_apply"] + 1
    assert ts.launch_counts[key] == before[key] + 4

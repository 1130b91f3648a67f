"""The stationary slice of the port against the JAX package, in float64 on
the CPU: ``Control.Stationary(...).linear_solve`` and the pieces it adds.

* ``minres`` and ``chebyshev`` against ``control_tpu.solvers.krylov``'s
  on one small SPD system (iterations, residual history, solution);
* ``Transfer`` on P1/P2 triangle pairs and on Q3/Q4 quadrilaterals
  (prolongation, restriction, Galerkin coarse matrices) to 1e-12;
* the plain versions of K1, K2 and K3 at degree 3 and 4 to 1e-12: K1's
  ``_apply_plain`` against ``_apply_xla``, K2's ``_cheb_plain`` against
  ``fused_cheb_smooth(use_pallas=False)``, K3's plain version against the
  TPU kernel ``_fused_cheb_complex`` itself in Pallas interpret mode
  (degree 4 in ``-m slow``: 20-30 s of interpretation);
* one application of the stationary preconditioner (two-level
  hierarchies: Q1 72^2, and in ``-m slow`` Q3 24^2 with degree-3
  transfers and smoothing) with the JAX package's pc state carried across
  by ``utils.convert``, to 1e-12;
* whole ``linear_solve`` runs with the JAX package's iteration count,
  residual histories within 1e-10 of the initial residual and v, zeta
  within 1e-10: Q2 quads at 8^2 (``tests/test_stationary.py``'s exact
  solution), P1 triangles at 8^2 (its MMS recipe), Q3 at 4^2
  (``tests/test_degree3.py``'s recipe) and a user ``P=``; in ``-m slow``
  P2 triangles at 8^2, the default pc at 16^2, inhomogeneous Dirichlet
  data, Q3 at 8^2 and the ``poisson`` recipe at 96^2 (a two-level
  hierarchy in the solve);
* what the port refuses: Gauss-Newton, the nonlinear and incompressible
  solves, refinement keys, plots, and a CUDA stencil at a degree without
  a kernel (the wrappers' checks run before any library is loaded).

The tests marked ``gpu`` hold small float64 solves on the card against
the CPU and skip here.  Each JAX solve runs once per module.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import control_tpu as J
import control_tpu_torch as T
from control_tpu.ops import stencil as js
from control_tpu.solvers import krylov as jk
from control_tpu.solvers.multigrid import Transfer as JTransfer
from control_tpu.solvers.multigrid import (
    _cell_prolongation as j_cell_prolongation)
from control_tpu.fem.space import combine_masks as j_combine
from control_tpu_torch.ops import stencil as ts
from control_tpu_torch.solvers import krylov as tk
from control_tpu_torch.solvers.multigrid import Transfer as TTransfer
from control_tpu_torch.solvers.multigrid import (
    _cell_prolongation as t_cell_prolongation)
from control_tpu_torch.fem.space import combine_masks as t_combine
from control_tpu_torch.utils import convert
from control_tpu_torch.utils.spectral import LAMBDA_BOUNDS

TOL = 1e-12
SOLVE_TOL = 1e-10


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


def _mesh(mod, n, quad, device="cpu"):
    kw = {"device": device} if mod is T else {}
    return mod.UnitSquareMesh(n, n, quadrilateral=quad, dtype="float64",
                              **kw)


# ---------------------------------------------------------------------------
# problems, built alike in both packages
# ---------------------------------------------------------------------------

def jacobi_mass_bounds(mod, space):
    """Spectral interval of diag(M)^{-1} M, widened by 0.98 / 1.02
    (``tests/test_degree3.py``'s bounds for degrees without a table
    entry)."""
    u, v = mod.TrialFunction(space), mod.TestFunction(space)
    M = mod.assemble(mod.inner(u, v) * mod.dx).to_dense()
    M = M.cpu().numpy() if torch.is_tensor(M) else np.asarray(M)
    d = np.sqrt(np.diag(M))
    lam = np.linalg.eigvalsh(M / d[:, None] / d[None, :])
    return 0.98 * float(lam[0]), 1.02 * float(lam[-1])


def exact_pair_problem(mod, n, degree, device="cpu"):
    """``tests/test_stationary.py:20-74`` (Q2) and ``tests/test_degree3.py``
    (Q3): -div grad + I, beta 1e-3, no bcs, right-hand sides assembled from
    the exact pair (v = x e^y, zeta = sin(pi x) sin(2 pi y)), FGMRES(10) to
    1e-14.  Returns (ctl, solve kwargs, exact v, exact zeta)."""
    mesh = _mesh(mod, n, True, device)
    X = mod.SpatialCoordinate(mesh)
    space = mod.FunctionSpace(mesh, "Lagrange", degree)
    test = mod.TestFunction(space)
    inner, grad, dx, pi = mod.inner, mod.grad, mod.dx, mod.pi

    def fdo(trial, test, u):
        return inner(grad(trial), grad(test)) * dx + inner(trial, test) * dx

    def desired_state(test):
        v_d = mod.Function(space).interpolate(
            mod.cos(pi * X[0] - 0.5 * pi) * mod.cos(pi * X[1] - 0.5 * pi)
            + 1.0)
        return inner(v_d, test) * dx, v_d

    def force_f(test):
        f = mod.Function(space).interpolate(
            2.0 * pi ** 2 * mod.cos(pi * X[0] - 0.5 * pi)
            * mod.cos(pi * X[1] - 0.5 * pi))
        return inner(f, test) * dx

    beta = 1.0e-3
    ctl = mod.Control.Stationary(space, fdo, desired_state=desired_state,
                                 force_f=force_f, beta=beta, bcs_v=None)
    v_ref = mod.Function(space).interpolate(X[0] * mod.exp(X[1]))
    zeta_ref = mod.Function(space).interpolate(
        mod.sin(pi * X[0]) * mod.sin(2.0 * pi * X[1]))
    b_0 = mod.assemble(inner(v_ref, test) * dx
                       + inner(grad(zeta_ref), grad(test)) * dx
                       + inner(zeta_ref, test) * dx)
    b_1 = mod.assemble(inner(grad(v_ref), grad(test)) * dx
                       + inner(v_ref, test) * dx
                       - 1.0 / beta * inner(zeta_ref, test) * dx)
    bounds = (LAMBDA_BOUNDS[("quad", degree)] if degree <= 2
              else jacobi_mass_bounds(mod, space))
    kw = dict(lambda_v_bounds=bounds, v_d=b_0, f=b_1, solver_parameters={
        "linear_solver": "fgmres", "fgmres_restart": 10,
        "maximum_iterations": 500, "relative_tolerance": 1.0e-14,
        "absolute_tolerance": 1.0e-14, "monitor_convergence": False})
    return ctl, kw, v_ref, zeta_ref


def mms_problem(mod, n, degree, device="cpu"):
    """``tests/test_stationary.py:76-143`` at one size: Poisson control on
    P_degree triangles, beta 1e-3, zero Dirichlet data, FGMRES(30) to
    1e-9."""
    mesh = _mesh(mod, n, False, device)
    X = mod.SpatialCoordinate(mesh)
    space = mod.FunctionSpace(mesh, "Lagrange", degree)
    inner, grad, div, dx, pi = mod.inner, mod.grad, mod.div, mod.dx, mod.pi
    beta = 1.0e-3
    v = mod.sin(pi * X[0]) * mod.sin(pi * X[1]) * mod.exp(X[0] + X[1])
    zeta = mod.sin(2.0 * pi * X[0]) * mod.sin(2.0 * pi * X[1])

    def fdo(trial, test, u):
        return inner(grad(trial), grad(test)) * dx

    def desired_state(test):
        v_d = mod.Function(space).interpolate(-div(grad(zeta)) + v)
        true_v = mod.Function(space).interpolate(v)
        return inner(v_d, test) * dx, true_v

    def force_f(test):
        f = mod.Function(space).interpolate(-div(grad(v))
                                            - 1.0 / beta * zeta)
        return inner(f, test) * dx

    ctl = mod.Control.Stationary(
        space, fdo, desired_state=desired_state, force_f=force_f,
        beta=beta, bcs_v=mod.DirichletBC(space, 0.0, "on_boundary"))
    kw = dict(lambda_v_bounds=LAMBDA_BOUNDS[("tri", degree)],
              solver_parameters={
                  "linear_solver": "fgmres", "fgmres_restart": 30,
                  "maximum_iterations": 500, "relative_tolerance": 1.0e-9,
                  "absolute_tolerance": 1.0e-9,
                  "monitor_convergence": False})
    return ctl, kw


def poisson_problem(mod, n, device="cpu", degree=1, bc_value=0.0):
    """``bench_extra.py``'s ``poisson`` (Q1, beta 1e-4, v_d = sin(pi x)
    sin(pi y), f = 0, zero Dirichlet data, GMRES(10) to 1e-6, budget 50,
    20-step Chebyshev mass solve), on ``degree`` quads and with
    ``bc_value`` (an expression of the coordinates) as Dirichlet data."""
    mesh = _mesh(mod, n, True, device)
    space = mod.FunctionSpace(mesh, "Lagrange", degree)
    X = mod.SpatialCoordinate(mesh)
    inner, grad, dx, pi = mod.inner, mod.grad, mod.dx, mod.pi

    def fdo(trial, test, u):
        return inner(grad(trial), grad(test)) * dx

    def ds_(test):
        v_d = mod.Function(space).interpolate(mod.sin(pi * X[0])
                                              * mod.sin(pi * X[1]))
        return inner(v_d, test) * dx, v_d

    def ff(test):
        return inner(mod.Function(space), test) * dx

    g = bc_value(mod, X) if callable(bc_value) else bc_value
    ctl = mod.Control.Stationary(
        space, fdo, desired_state=ds_, force_f=ff, beta=1e-4,
        bcs_v=mod.DirichletBC(space, g, "on_boundary"))
    kw = dict(lambda_v_bounds=LAMBDA_BOUNDS[("quad", degree)]
              if degree <= 2 else jacobi_mass_bounds(mod, space),
              solver_parameters={
                  "linear_solver": "gmres", "gmres_restart": 10,
                  "maximum_iterations": 50, "relative_tolerance": 1.0e-6,
                  "absolute_tolerance": 0.0, "monitor_convergence": False})
    return ctl, kw


def _boundary_data(mod, X):
    return 1.0 + 0.5 * mod.sin(mod.pi * X[0]) * X[1]


def default_pc_problem(mod, device="cpu"):
    """``tests/test_stationary.py:145-178``: Q2 16^2, Poisson, beta 1e-3,
    zero Dirichlet data, the default GMRES(10) parameters."""
    mesh = _mesh(mod, 16, True, device)
    X = mod.SpatialCoordinate(mesh)
    space = mod.FunctionSpace(mesh, "Lagrange", 2)
    inner, grad, dx, pi = mod.inner, mod.grad, mod.dx, mod.pi

    def fdo(trial, test, u):
        return inner(grad(trial), grad(test)) * dx

    def desired_state(test):
        v_d = mod.Function(space).interpolate(
            mod.sin(pi * X[0]) * mod.sin(pi * X[1]) * mod.exp(X[0] + X[1]))
        return inner(v_d, test) * dx, v_d

    def force_f(test):
        return inner(mod.Function(space), test) * dx

    ctl = mod.Control.Stationary(
        space, fdo, desired_state=desired_state, force_f=force_f,
        beta=1e-3, bcs_v=mod.DirichletBC(space, 0.0, "on_boundary"))
    return ctl, dict(lambda_v_bounds=LAMBDA_BOUNDS[("quad", 2)],
                     solver_parameters=None)


def _scaled_identity_pc(b_0, b_1):
    return 0.5 * b_0, 2.0 * b_1


def user_pc_problem(mod, device="cpu"):
    """``tests/test_user_pc.py:66-105``'s problem at 4^2 with a fixed user
    preconditioner (a scaled identity) and a full-restart GMRES."""
    ctl, _ = poisson_problem(mod, 4, device)
    ctl.set_beta(1e-3)
    dim = 2 * 25
    return ctl, dict(P=_scaled_identity_pc, solver_parameters={
        "linear_solver": "gmres", "gmres_restart": dim + 10,
        "maximum_iterations": dim + 10, "relative_tolerance": 1e-10,
        "absolute_tolerance": 0.0, "monitor_convergence": False})


CASES = {
    "q2_exact_8": lambda mod: exact_pair_problem(mod, 8, 2)[:2],
    "p1_tri_mms_8": lambda mod: mms_problem(mod, 8, 1),
    "q3_exact_4": lambda mod: exact_pair_problem(mod, 4, 3)[:2],
    "user_P_4": user_pc_problem,
    "p2_tri_mms_8": lambda mod: mms_problem(mod, 8, 2),
    "default_pc_16": default_pc_problem,
    "inhomogeneous_8": lambda mod: poisson_problem(
        mod, 8, bc_value=_boundary_data),
    "q3_exact_8": lambda mod: exact_pair_problem(mod, 8, 3)[:2],
    "poisson_96": lambda mod: poisson_problem(mod, 96),
}
DEFAULT_CASES = ("q2_exact_8", "p1_tri_mms_8", "q3_exact_4", "user_P_4")
SLOW_CASES = tuple(c for c in CASES if c not in DEFAULT_CASES)


def _run(mod, case):
    ctl, kw = CASES[case](mod)
    info = ctl.linear_solve(print_error=False, create_output=False,
                            plots=False, **kw)
    info = ctl.last_solve_info if info is None else info
    v, z = ctl._v.data, ctl._zeta.data
    if torch.is_tensor(v):
        v, z = v.cpu().numpy(), z.cpu().numpy()
    return info, np.asarray(v), np.asarray(z)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's solve of each case, run once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run(J, case)
        return cache[case]
    return get


def _compare(jax_run, port_run):
    (ij, vj, zj), (it, vt, zt) = jax_run, port_run
    assert ij.converged and it.converged
    assert it.iterations == ij.iterations, (it.iterations, ij.iterations)
    k = ij.iterations + 1
    gap = np.abs(ij.res_norms[:k] - it.res_norms[:k]) / ij.res_norms[0]
    assert float(gap.max()) <= SOLVE_TOL, gap
    close(vj, vt, SOLVE_TOL)
    close(zj, zt, SOLVE_TOL)


@pytest.mark.parametrize("case", DEFAULT_CASES)
def test_linear_solve_matches_reference(case, jax_runs):
    _compare(jax_runs(case), _run(T, case))


@pytest.mark.slow
@pytest.mark.parametrize("case", SLOW_CASES)
def test_linear_solve_matches_reference_slow(case, jax_runs):
    _compare(jax_runs(case), _run(T, case))


def test_carry_state_sets_stationary_fields(jax_runs):
    """``utils.convert.carry_state`` starts a port problem from the JAX
    package's stationary solution (one field each for v and zeta)."""
    _, vj, zj = jax_runs("q2_exact_8")
    ctl, _ = CASES["q2_exact_8"](T)
    convert.carry_state(ctl, v=vj, zeta=zj)
    np.testing.assert_array_equal(ctl._v.data.numpy(), vj)
    np.testing.assert_array_equal(ctl._zeta.data.numpy(), zj)


def test_exact_pair_recovered():
    """The Q3 solve at 4^2 reproduces the interpolated exact pair (the
    discrete solution of its manufactured right-hand sides) to 1e-12 in
    the L2 norm, as ``tests/test_degree3.py`` asks of the JAX package."""
    ctl, kw, v_ref, zeta_ref = exact_pair_problem(T, 4, 3)
    ctl.linear_solve(print_error=False, **kw)
    for got, ref in ((ctl._v, v_ref), (ctl._zeta, zeta_ref)):
        d = T.Function(got.space, data=got.data - ref.data)
        assert float(T.assemble(T.inner(d, d) * T.dx)) ** 0.5 < 1e-12


def test_repeat_solve_reuses_the_pc_and_writes_output(tmp_path,
                                                      monkeypatch):
    """A repeat solve reuses the cached pc state and repeats the count;
    ``create_output`` writes v.npz and zeta.npz; ``Control`` exposes both
    entry points."""
    assert T.Control.Stationary is not None
    assert T.Control.Instationary is not None
    monkeypatch.chdir(tmp_path)
    ctl, kw = poisson_problem(T, 8)
    first = ctl.linear_solve(print_error=False, **kw)
    (state,) = ctl._pc_state_cache.values()
    second = ctl.linear_solve(print_error=False, create_output=True, **kw)
    (again,) = ctl._pc_state_cache.values()
    assert again is state
    assert second.iterations == first.iterations
    for name, fn in (("v", ctl._v), ("zeta", ctl._zeta)):
        data = np.load(tmp_path / f"{name}.npz")["data"]
        np.testing.assert_array_equal(data, fn.data.numpy())


# ---------------------------------------------------------------------------
# minres, chebyshev
# ---------------------------------------------------------------------------

def _spd_system(n=30, seed=5):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T / n + np.diag(rng.uniform(0.5, 2.0, n))
    d = np.diag(A).copy()
    return A, d, rng.standard_normal(n)


def test_minres_matches_reference():
    A, d, b = _spd_system()
    Aj, dj = jnp.asarray(A), jnp.asarray(d)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    xj, ij = jk.minres(lambda x: Aj @ x, jnp.asarray(b),
                       M=lambda r: r / dj, rtol=1e-12, maxiter=100)
    xt, it = tk.solve_krylov("minres", lambda x: At @ x, torch.as_tensor(b),
                             M=lambda r: r / dt, rtol=1e-12, maxiter=100,
                             restart=30)
    assert it["iterations"] == int(ij["iterations"])
    assert it["converged"] and bool(ij["converged"])
    k = it["iterations"] + 1
    close(np.asarray(ij["res_norms"])[:k], it["res_norms"][:k], 1e-10)
    close(xj, xt, 1e-10)


@pytest.mark.parametrize("iters", [1, 5, 20])
def test_chebyshev_matches_reference(iters):
    A, d, b = _spd_system()
    Dm = 1.0 / np.sqrt(d)
    lam = np.linalg.eigvalsh(A * Dm[:, None] * Dm[None, :])
    bounds = (0.98 * lam[0], 1.02 * lam[-1])
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    xj = jk.chebyshev(lambda x: Aj @ x, jnp.asarray(b), bounds, iters,
                      M=lambda r: jk.jacobi_apply(jnp.asarray(d), r))
    xt = tk.chebyshev(lambda x: At @ x, torch.as_tensor(b), bounds, iters,
                      M=lambda r: tk.jacobi_apply(torch.as_tensor(d), r))
    close(xj, xt)


# ---------------------------------------------------------------------------
# transfers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quad,degree", [(False, 1), (False, 2), (True, 3),
                                         (True, 4)])
def test_transfer_matches_reference(quad, degree):
    """Prolongation, restriction (batched) and Galerkin coarse matrices on
    triangle pairs and Q3/Q4 quadrilaterals; the cell prolongation
    tabulated on the virtual degree-2d space."""
    cell = "quad" if quad else "tri"
    np.testing.assert_allclose(j_cell_prolongation(cell, degree),
                               t_cell_prolongation(cell, degree),
                               rtol=0, atol=TOL)
    sj = J.FunctionSpace(_mesh(J, 8, quad), "Lagrange", degree)
    st = T.FunctionSpace(_mesh(T, 8, quad), "Lagrange", degree)
    tj, tt = JTransfer(sj), TTransfer(st)
    assert tt.virt.grid_shape == st.grid_shape
    rng = np.random.default_rng(degree)
    xc = rng.standard_normal((3,) + tt.coarse.grid_shape)
    rf = rng.standard_normal((3,) + st.grid_shape)
    close(tj.prolong(jnp.asarray(xc)), tt.prolong(torch.as_tensor(xc)))
    close(tj.restrict(jnp.asarray(rf)), tt.restrict(torch.as_tensor(rf)))
    u, v = J.TrialFunction(sj), J.TestFunction(sj)
    X = J.SpatialCoordinate(sj.mesh)
    A = np.asarray(J.assemble(J.inner(J.grad(u), J.grad(v)) * J.dx
                              + (1.0 + X[0]) * J.inner(u, v) * J.dx).A)
    close(tj.galerkin(jnp.asarray(A)), tt.galerkin(torch.as_tensor(A)))


# ---------------------------------------------------------------------------
# the kernels' plain versions at degree 3 and 4
# ---------------------------------------------------------------------------

def _spd_stencil(rng, lead, degree, ny, nx, cplx=False):
    """A diagonally dominant (2 degree + 1)^2-point stencil and its inverse
    diagonal."""
    K = (2 * degree + 1) ** 2
    w = -0.5 * rng.uniform(0.2, 1.0, lead + (K, ny, nx)) / K * 9
    w[..., K // 2, :, :] = 4.0 + rng.uniform(0.0, 1.0, lead + (ny, nx))
    if cplx:
        w = w * np.exp(1j * rng.uniform(-0.3, 0.3, w.shape))
    return w, 1.0 / w[..., K // 2, :, :]


@pytest.mark.parametrize("degree", [3, 4])
@pytest.mark.parametrize("layout", ["shared", "per_batch", "unbatched"])
@pytest.mark.parametrize("cplx", [False, True])
def test_apply_plain_matches_reference(degree, layout, cplx):
    rng = np.random.default_rng(11)
    K, ny, nx, n = (2 * degree + 1) ** 2, 13, 17, 3
    wshape = {"shared": (K, ny, nx), "per_batch": (n, K, ny, nx),
              "unbatched": (K, ny, nx)}[layout]
    xshape = (ny, nx) if layout == "unbatched" else (n, ny, nx)
    w = rng.standard_normal(wshape)
    x = rng.standard_normal(xshape)
    if cplx:
        w = w + 1j * rng.standard_normal(wshape)
        x = x + 1j * rng.standard_normal(xshape)
    close(js._apply_xla(jnp.asarray(w), jnp.asarray(x), degree),
          ts.apply_stencil(torch.as_tensor(w), torch.as_tensor(x), degree))


@pytest.mark.parametrize("degree", [3, 4])
@pytest.mark.parametrize("shared_w", [True, False])
@pytest.mark.parametrize("want_residual", [True, False])
def test_cheb_plain_matches_reference(degree, shared_w, want_residual):
    """K2's plain version: shared or per-batch weights, per-batch bounds."""
    rng = np.random.default_rng(12)
    n, ny, nx, steps = 3, 13, 14, 4
    w, dinv = _spd_stencil(rng, () if shared_w else (n,), degree, ny, nx)
    b = rng.standard_normal((n, ny, nx))
    x0 = rng.standard_normal((n, ny, nx))
    theta = rng.uniform(1.0, 2.0, n)
    delta = rng.uniform(0.3, 0.8, n)
    ref = js.fused_cheb_smooth(jnp.asarray(w), jnp.asarray(dinv),
                               jnp.asarray(b), jnp.asarray(x0), steps,
                               jnp.asarray(theta), jnp.asarray(delta),
                               degree, want_residual=want_residual,
                               use_pallas=False)
    got = ts.fused_cheb_smooth(torch.as_tensor(w), torch.as_tensor(dinv),
                               torch.as_tensor(b), torch.as_tensor(x0),
                               steps, torch.as_tensor(theta),
                               torch.as_tensor(delta), degree,
                               want_residual=want_residual)
    if want_residual:
        close(ref[0], got[0])
        close(ref[1], got[1])
    else:
        close(ref, got)


def _complex_cheb_case(degree):
    """K3's plain version against the TPU kernel in interpret mode: two
    per-frequency complex fields on a 25^2 (degree 3) or 33^2 (degree 4)
    grid, 3 steps, (n,) bounds, residual on."""
    rng = np.random.default_rng(13)
    n, g, steps = 2, 8 * degree + 1, 3
    w, dinv = _spd_stencil(rng, (n,), degree, g, g, cplx=True)
    b = rng.standard_normal((n, g, g)) + 1j * rng.standard_normal((n, g, g))
    x0 = rng.standard_normal((n, g, g)) + 1j * rng.standard_normal((n, g, g))
    theta = rng.uniform(1.0, 2.0, n)
    delta = rng.uniform(0.3, 0.8, n)
    ref_x, ref_r = js._fused_cheb_complex(
        jnp.asarray(w), jnp.asarray(dinv), jnp.asarray(b), jnp.asarray(x0),
        steps, jnp.asarray(theta), jnp.asarray(delta), degree,
        want_residual=True, interpret=True)
    got_x, got_r = ts.fused_cheb_smooth(
        torch.as_tensor(w), torch.as_tensor(dinv), torch.as_tensor(b),
        torch.as_tensor(x0), steps, torch.as_tensor(theta),
        torch.as_tensor(delta), degree, want_residual=True)
    close(ref_x, got_x)
    close(ref_r, got_r)


def test_complex_cheb_plain_matches_tpu_kernel_degree3():
    _complex_cheb_case(3)


@pytest.mark.slow
def test_complex_cheb_plain_matches_tpu_kernel_degree4():
    _complex_cheb_case(4)


# ---------------------------------------------------------------------------
# the preconditioner with the JAX package's state
# ---------------------------------------------------------------------------

def _pc_inputs(mod, ctl, combine):
    space = ctl._space_v
    mask = combine(space, ctl._bcs_v)
    D_v, D_zeta = ctl.construct_D_v(mod.Function(space, data=ctl._v.data))
    return mask, D_v, D_zeta, mod.assemble(ctl._M_v)


def _pc_application_with_carried_state(degree, n):
    """One application of the stationary block preconditioner with
    two-level hierarchies (transfers, K2's plain version, the dense coarse
    inverse), built by the JAX package and carried across by
    ``utils.convert``, agrees to 1e-12."""
    cj, kj = poisson_problem(J, n, degree=degree)
    ct, kt = poisson_problem(T, n, degree=degree)
    bounds = kt["lambda_v_bounds"]
    mj, Dj, DTj, Mj = _pc_inputs(J, cj, j_combine)
    mt, Dt, DTt, Mt = _pc_inputs(T, ct, t_combine)
    pc_j = cj.construct_pc(False, bounds, mj, mj, Dj, DTj, Mj)
    state = convert.to_torch(jax.tree_util.tree_map(np.asarray,
                                                    pc_j.state),
                             ct._space_v)
    assert len(state["solver_1"]["Ws"]) == 2
    pc_t = ct.construct_pc(False, bounds, mt, mt, Dt, DTt, Mt,
                           prebuilt=state)
    rng = np.random.default_rng(23)
    shape = ct._space_v.grid_shape
    mask = np.asarray(mj)
    b0 = np.where(mask, 0.0, rng.standard_normal(shape))
    b1 = np.where(mask, 0.0, rng.standard_normal(shape))
    uj = pc_j(jnp.asarray(b0), jnp.asarray(b1))
    ut = pc_t(torch.as_tensor(b0), torch.as_tensor(b1))
    for a, b in zip(uj, ut):
        close(a, b)
    # the port's own build gives the same pc
    own = ct.construct_pc(False, bounds, mt, mt, Dt, DTt, Mt)
    for a, b in zip(uj, own(torch.as_tensor(b0), torch.as_tensor(b1))):
        close(a, b)


def test_pc_application_with_carried_state():
    """Q1 72^2: the convolution transfers."""
    _pc_application_with_carried_state(1, 72)


@pytest.mark.slow
def test_pc_application_with_carried_state_q3():
    """Q3 24^2: degree-3 transfers and smoothing (the JAX package's eager
    K = 49 V-cycles take about 40 s here)."""
    _pc_application_with_carried_state(3, 24)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["gauss_newton", "non_linear_solve",
                                  "stokes", "refinement", "plots"])
def test_refusals(case):
    ctl, kw = poisson_problem(T, 4)
    if case == "gauss_newton":
        ctl.set_Gauss_Newton(True)
        call = lambda: ctl.linear_solve(print_error=False, **kw)  # noqa
    elif case == "non_linear_solve":
        call = ctl.non_linear_solve
    elif case == "stokes":
        call = lambda: ctl.incompressible_linear_solve(  # noqa: E731
            T.ConstantNullspace())
    elif case == "refinement":
        sp = dict(kw["solver_parameters"], iterative_refinement=2)
        call = lambda: ctl.linear_solve(  # noqa: E731
            print_error=False, lambda_v_bounds=(0.25, 2.25),
            solver_parameters=sp)
    else:
        call = lambda: ctl.linear_solve(print_error=False,  # noqa: E731
                                        plots=True, **kw)
    with pytest.raises(NotImplementedError):
        call()


@pytest.mark.parametrize("nd,degree", [(2, 5), (3, 4)])
def test_cuda_wrappers_refuse_degrees_without_a_kernel(nd, degree):
    """The CUDA wrappers' checks (run before any library is loaded) refuse
    2-D degree 5 and 3-D degree 4: no quiet plain version."""
    grid = (5,) * nd
    K = (2 * degree + 1) ** nd
    w = torch.ones((K,) + grid, dtype=torch.float64)
    x = torch.ones((2,) + grid, dtype=torch.float64)
    assert degree not in ts.CUDA_DEGREES[nd]
    with pytest.raises(NotImplementedError, match="degree"):
        ts._apply_cuda(w, x, degree, nd)
    with pytest.raises(NotImplementedError, match="degree"):
        ts._cheb_cuda(w, x[0], x, x, 2, 1.0, 0.5, degree, True, nd)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

GPU_CASES = {
    "poisson_32": lambda dev: poisson_problem(T, 32, dev),
    "q3_exact_8": lambda dev: exact_pair_problem(T, 8, 3, dev)[:2],
    "p2_tri_mms_16": lambda dev: mms_problem(T, 16, 2, dev),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_small_f64_solve_on_card_matches_cpu(case):
    """The same float64 solve on the card (kernels K1, K2) and on the CPU
    (their plain versions): equal iterations, histories within 1e-8 of
    the initial residual, v and zeta within 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    runs = {}
    for dev in ("cpu", "cuda"):
        ctl, kw = GPU_CASES[case](dev)
        info = ctl.linear_solve(print_error=False, **kw)
        runs[dev] = (info, ctl._v.data.cpu(), ctl._zeta.data.cpu())
    (ic, vc, zc), (ig, vg, zg) = runs["cpu"], runs["cuda"]
    assert ig.iterations == ic.iterations
    k = ic.iterations + 1
    gap = np.abs(ic.res_norms[:k] - ig.res_norms[:k]) / ic.res_norms[0]
    assert float(gap.max()) < 1e-8
    assert float((vc - vg).abs().max() / vc.abs().max()) < 1e-9
    assert float((zc - zg).abs().max() / zc.abs().max()) < 1e-9

"""Hex Q3 (K = 343) in the port against the JAX package, in float64 on the
CPU: the degree-3 3-D variants of K5 and K6 and the two paths that run
them, ``Control.Stationary`` and ``Control.Instationary`` on Q3
hexahedra.

* the plain versions at degree 3 in 3-D to 1e-12: K6's ``_apply_plain``
  against ``_apply_xla`` and K5's ``_cheb_plain`` against
  ``fused_cheb_smooth(use_pallas=False, nd=3)`` (real with shared and
  per-batch weights, complex per frequency, residual on and off), on a
  7^3 grid; in ``-m slow`` against the TPU kernel ``_fused_cheb_nd3``
  itself in Pallas interpret mode;
* ``node_stencil`` on a hex Q3 space (masked and unmasked) and
  ``Transfer`` 4^3 -> 2^3 (prolongation, restriction, Galerkin) against
  the JAX package;
* the Jacobi-scaled hex Q3 mass bounds that ``chip_smoke.py`` computes on
  2^3 cells contain the spectrum at 4^3 (the JAX package's table has hex
  degrees 1 and 2 only);
* the port's own exact-pair stationary solve (``tests/test_solvers3d.py``
  :69) at hex Q1, Q2 and Q3 4^3 to 1e-11; in ``-m slow`` the Q2 and Q3
  solves and the heat3d Q3 ParaDiag solve at 4^3 x 4 with the JAX
  package's iteration counts and histories;
* ``iterative_refinement: 0`` is the plain solve in all three solves,
  bit for bit, and a refinement step still raises;
* CPU tensors at degree 3 in 3-D never reach the kernel library; the CUDA
  wrappers refuse degree 4 in 3-D and the vector K5v at degree 3.

The tests marked ``gpu`` hold the degree-3 CUDA kernels (K6, K5 real,
complex and with narrow planes, and offsets past 2^31 values) against
their plain versions on the card, and a small stationary solve on the
card against the CPU; they skip elsewhere.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import chip_smoke
import control_tpu as J
import control_tpu_torch as T
from control_tpu.ops import stencil as js
from control_tpu.solvers.multigrid import Transfer as JTransfer
from control_tpu_torch.ops import kernels
from control_tpu_torch.ops import stencil as ts
from control_tpu_torch.solvers.multigrid import Transfer as TTransfer

TOL = 1e-12
SOLVE_TOL = 1e-10
K = 343
GRID = (7, 7, 7)


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


def hex_space(mod, n, degree):
    kw = {"device": "cpu"} if mod is T else {}
    return mod.FunctionSpace(mod.UnitCubeMesh(n, n, n, dtype="float64",
                                              **kw), "Lagrange", degree)


# ---------------------------------------------------------------------------
# the plain versions of K6 and K5 at degree 3
# ---------------------------------------------------------------------------

def _spd_stencil(rng, lead, cplx=False):
    """A diagonally dominant 343-point stencil on GRID, its inverse
    diagonal, and nonzero weights at the offsets that leave the grid (a
    version that failed to mask a neighbour would disagree)."""
    w = -0.5 * rng.uniform(0.2, 1.0, lead + (K,) + GRID)
    w[..., K // 2, :, :, :] = 180.0 + rng.uniform(0.0, 1.0, lead + GRID)
    if cplx:
        w = w * np.exp(1j * rng.uniform(-0.3, 0.3, w.shape))
    return w, 1.0 / w[..., K // 2, :, :, :]


@pytest.mark.parametrize("layout", ["shared", "per_batch", "unbatched"])
@pytest.mark.parametrize("cplx", [False, True])
def test_apply_plain_matches_reference(layout, cplx):
    rng = np.random.default_rng(31)
    n = 2
    wshape = (n, K) + GRID if layout == "per_batch" else (K,) + GRID
    xshape = GRID if layout == "unbatched" else (n,) + GRID
    w = rng.standard_normal(wshape)
    x = rng.standard_normal(xshape)
    if cplx:
        w = w + 1j * rng.standard_normal(wshape)
        x = x + 1j * rng.standard_normal(xshape)
    close(js._apply_xla(jnp.asarray(w), jnp.asarray(x), 3, nd=3),
          ts.apply_stencil(torch.as_tensor(w), torch.as_tensor(x), 3, nd=3))


def _cheb_case(kind, seed=32):
    """(w, dinv, b, x0, theta, delta) as numpy arrays: real fields with
    shared or per-batch weights, or complex fields with per-frequency
    weights, two batch entries, per-batch bounds."""
    rng = np.random.default_rng(seed)
    n = 2
    cplx = kind == "complex"
    w, dinv = _spd_stencil(rng, () if kind == "shared" else (n,), cplx)

    def field():
        a = rng.standard_normal((n,) + GRID)
        return a + 1j * rng.standard_normal((n,) + GRID) if cplx else a

    return (w, dinv, field(), field(), rng.uniform(1.0, 2.0, n),
            rng.uniform(0.3, 0.8, n))


# the JAX package's eager K = 343 recurrence takes 3-10 s a case on a CPU:
# three cases in tier 1 cover both weight layouts, complex fields and the
# residual on and off, the other three are ``slow``
CHEB_CASES = [("shared", True), ("per_batch", False), ("complex", True),
              pytest.param("shared", False, marks=pytest.mark.slow),
              pytest.param("per_batch", True, marks=pytest.mark.slow),
              pytest.param("complex", False, marks=pytest.mark.slow)]


@pytest.mark.parametrize("kind,want_residual", CHEB_CASES)
def test_cheb_plain_matches_reference(kind, want_residual):
    """K5's plain version at degree 3: 3 steps."""
    args = _cheb_case(kind)
    ref = js.fused_cheb_smooth(*map(jnp.asarray, args[:4]), 3,
                               *map(jnp.asarray, args[4:]), 3,
                               want_residual=want_residual,
                               use_pallas=False, nd=3)
    got = ts.fused_cheb_smooth(*map(torch.as_tensor, args[:4]), 3,
                               *map(torch.as_tensor, args[4:]), 3,
                               want_residual=want_residual, nd=3)
    if want_residual:
        close(ref[0], got[0])
        close(ref[1], got[1])
    else:
        close(ref, got)


@pytest.mark.slow
def test_cheb_plain_matches_tpu_kernel():
    """K5's plain version against the TPU kernel ``_fused_cheb_nd3`` at
    degree 3 in Pallas interpret mode: real fields, shared weights, 2
    steps and the residual (the complex case's coupled 2 x 2 form ran
    for more than 15 minutes interpreted on a CPU)."""
    args = _cheb_case("shared", seed=33)
    ref = js._fused_cheb_nd3(*map(jnp.asarray, args[:4]), 2,
                             *map(jnp.asarray, args[4:]), 3,
                             want_residual=True, interpret=True)
    got = ts._cheb_plain(*map(torch.as_tensor, args[:4]), 2,
                         *map(torch.as_tensor, args[4:]), 3,
                         want_residual=True, nd=3)
    close(ref[0], got[0])
    close(ref[1], got[1])


# ---------------------------------------------------------------------------
# node stencils, transfers, bounds
# ---------------------------------------------------------------------------

def _stiffness_plus_mass(mod, space):
    u, v = mod.TrialFunction(space), mod.TestFunction(space)
    X = mod.SpatialCoordinate(space.mesh)
    return mod.assemble(mod.inner(mod.grad(u), mod.grad(v)) * mod.dx
                        + (1.0 + X[0]) * mod.inner(u, v) * mod.dx)


@pytest.mark.parametrize("masked", [
    True, pytest.param(False, marks=pytest.mark.slow)])
def test_node_stencil_matches_reference(masked):
    """The hex Q3 fold (K = 343) with and without Dirichlet elimination;
    the JAX package's eager fold takes 7-20 s on a CPU, so the unmasked case,
    whose fold the masked one runs first, is ``slow``."""
    sj, st = hex_space(J, 2, 3), hex_space(T, 2, 3)
    Aj, At = _stiffness_plus_mass(J, sj), _stiffness_plus_mass(T, st)
    mask_j = J.DirichletBC(sj, 0.0).mask if masked else None
    mask_t = T.DirichletBC(st, 0.0).mask if masked else None
    wj = js.node_stencil(Aj.A, sj, mask=mask_j)
    wt = ts.node_stencil(At.A, st, mask=mask_t)
    assert tuple(wt.shape) == (K,) + GRID
    close(wj, wt)
    if not masked:
        # the stencil applies the same operator as the local matrices
        x = torch.as_tensor(np.random.default_rng(34).standard_normal(GRID))
        close(At.apply(x), ts.apply_stencil(wt, x, 3, nd=3))


def test_transfer_matches_reference():
    """Prolongation, restriction (batched) and the Galerkin coarse
    matrices, hex Q3 4^3 -> 2^3 (the virtual degree-6 space)."""
    sj, st = hex_space(J, 4, 3), hex_space(T, 4, 3)
    tj, tt = JTransfer(sj), TTransfer(st)
    assert tt.coarse.grid_shape == GRID
    rng = np.random.default_rng(35)
    xc = rng.standard_normal((2,) + GRID)
    rf = rng.standard_normal((2,) + st.grid_shape)
    close(tj.prolong(jnp.asarray(xc)), tt.prolong(torch.as_tensor(xc)))
    close(tj.restrict(jnp.asarray(rf)), tt.restrict(torch.as_tensor(rf)))
    A = np.array(_stiffness_plus_mass(J, sj).A)
    close(tj.galerkin(jnp.asarray(A)), tt.galerkin(torch.as_tensor(A)))


def test_q3_bounds_contain_mass_spectrum():
    """``chip_smoke.q3_mass_bounds(3)`` (from 2^3 cells) holds the
    spectrum of diag(M)^{-1} M on 4^3 hex Q3 cells (dense eigenvalues,
    2197 nodes)."""
    lo, hi = chip_smoke.q3_mass_bounds(3)
    st = hex_space(T, 4, 3)
    M = T.assemble(T.inner(T.TrialFunction(st), T.TestFunction(st))
                   * T.dx).to_dense().numpy()
    d = np.sqrt(np.diag(M))
    lam = np.linalg.eigvalsh(M / d[:, None] / d[None, :])
    assert lo < lam[0] and lam[-1] < hi, (lo, hi, lam[0], lam[-1])
    # the margins stay within 3% of the interval's ends
    assert lo > 0.97 * lam[0] and hi < 1.03 * lam[-1]


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------

# tests/test_solvers3d.py:69's bounds for Q2; the table's for Q1; Q3's
# from chip_smoke.q3_mass_bounds(3)
BOUNDS = {1: (0.125, 3.375), 2: (0.1, 2.3)}


def stationary_case(mod, degree, n=4):
    """``tests/test_solvers3d.py:69``'s exact pair at ``degree`` (its
    FGMRES(10) to 1e-13): the problem, its solve arguments and the pair."""
    bounds = BOUNDS.get(degree) or chip_smoke.q3_mass_bounds(3)
    if mod is T:
        return chip_smoke.stationary_hex_problem(
            n, degree, torch.float64, "cpu", bounds,
            chip_smoke.HEX_SMALL_PARAMETERS)
    mesh = J.UnitCubeMesh(n, n, n, dtype="float64")
    X = J.SpatialCoordinate(mesh)
    space = J.FunctionSpace(mesh, "Lagrange", degree)
    test = J.TestFunction(space)
    inner, grad, dx, pi = J.inner, J.grad, J.dx, J.pi

    def fdo(trial, test, u):
        return inner(grad(trial), grad(test)) * dx + inner(trial, test) * dx

    ctl = J.Control.Stationary(space, fdo, beta=1e-3, bcs_v=None)
    v_ref = J.Function(space).interpolate(X[0] * J.exp(X[1]) * (1.0 + X[2]))
    zeta_ref = J.Function(space).interpolate(
        J.sin(pi * X[0]) * J.sin(2.0 * pi * X[1]) * J.sin(pi * X[2]))
    b_0 = J.assemble(inner(v_ref, test) * dx
                     + inner(grad(zeta_ref), grad(test)) * dx
                     + inner(zeta_ref, test) * dx)
    b_1 = J.assemble(inner(grad(v_ref), grad(test)) * dx
                     + inner(v_ref, test) * dx
                     - 1.0 / 1e-3 * inner(zeta_ref, test) * dx)
    return ctl, dict(lambda_v_bounds=bounds, v_d=b_0, f=b_1,
                     solver_parameters=chip_smoke.HEX_SMALL_PARAMETERS), \
        (v_ref, zeta_ref)


def _l2(mod, space, a, b):
    d = mod.Function(space, data=a.data - b.data)
    return float(mod.assemble(mod.inner(d, d) * mod.dx)) ** 0.5


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_stationary_exact_pair(degree):
    """The port's own exact-pair solve at hex Q1, Q2, Q3 4^3 meets the
    JAX test's 1e-11 in L2."""
    ctl, kw, (v_ref, zeta_ref) = stationary_case(T, degree)
    info = ctl.linear_solve(print_error=False, **kw)
    assert info.converged
    space = ctl._space_v
    assert _l2(T, space, ctl._v, v_ref) < 1e-11
    assert _l2(T, space, ctl._zeta, zeta_ref) < 1e-11


def _solve(mod, case):
    ctl, kw = case(mod)
    info = ctl.linear_solve(print_error=False, **kw)
    info = ctl.last_solve_info if info is None else info
    v, z = ctl._v.data, ctl._zeta.data
    if torch.is_tensor(v):
        v, z = v.cpu().numpy(), z.cpu().numpy()
    return info, np.asarray(v), np.asarray(z)


def _heat3d_q3(mod):
    """heat3d (``chip_smoke.heat3d_problem``'s recipe) on Q3 hexahedra,
    4^3 x 4, ParaDiag with its defaults, GMRES(10) to 1e-6, float64."""
    if mod is T:
        ctl = chip_smoke.heat3d_q3_problem(4, 4, torch.float64, "cpu",
                                           "paradiag")
    else:
        mesh = J.UnitCubeMesh(4, 4, 4, dtype="float64")
        space = J.FunctionSpace(mesh, "Lagrange", 3)
        X = J.SpatialCoordinate(mesh)

        def fdo(trial, test, u, t):
            return J.inner(J.grad(trial), J.grad(test)) * J.dx

        def ds_(test, t):
            v_d = J.Function(space).interpolate(
                J.sin(J.pi * X[0]) * J.sin(J.pi * X[1]) * J.sin(J.pi * X[2]))
            return J.inner(v_d, test) * J.dx, v_d

        def ff(test, t):
            return J.inner(J.Function(space), test) * J.dx

        def bc_t(s, t):
            return J.DirichletBC(s, 0.0, "on_boundary")

        ctl = J.Control.Instationary(space, fdo, desired_state=ds_,
                                     force_f=ff, beta=1e-4, n_t=4,
                                     time_interval=(0.0, 2.0), CN=True,
                                     bcs_v=bc_t)
        ctl.set_schur_sweep("paradiag")
    return ctl, dict(lambda_v_bounds=chip_smoke.q3_mass_bounds(3),
                     solver_parameters=chip_smoke.SOLVER_PARAMETERS)


SLOW_CASES = {
    "stationary_q2": lambda mod: stationary_case(mod, 2)[:2],
    "stationary_q3": lambda mod: stationary_case(mod, 3)[:2],
    "heat3d_q3_paradiag": _heat3d_q3,
}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(SLOW_CASES))
def test_solve_matches_reference(case):
    """The JAX package's iteration count, the residual history within
    1e-10 of the initial residual, v and zeta within 1e-10 (the JAX
    package's K = 343 programs compile for minutes)."""
    (ij, vj, zj) = _solve(J, SLOW_CASES[case])
    (it, vt, zt) = _solve(T, SLOW_CASES[case])
    assert ij.converged and it.converged
    assert it.iterations == ij.iterations, (it.iterations, ij.iterations)
    k = ij.iterations + 1
    gap = np.abs(ij.res_norms[:k] - it.res_norms[:k]) / ij.res_norms[0]
    assert float(gap.max()) <= SOLVE_TOL, gap
    close(vj, vt, SOLVE_TOL)
    close(zj, zt, SOLVE_TOL)


# ---------------------------------------------------------------------------
# iterative_refinement: 0 is the plain solve
# ---------------------------------------------------------------------------

REFINEMENT_OFF = {"iterative_refinement": 0,
                  "refinement_inner_tolerance": 1e-8}


def _stationary_q1(sp):
    ctl, kw = chip_smoke.poisson_problem(8, torch.float64, "cpu")
    return ctl, dict(kw, solver_parameters=dict(kw["solver_parameters"],
                                                **sp))


def _instationary_q1(sp):
    ctl = chip_smoke.heat_problem(8, 4, torch.float64, "cpu", "paradiag")
    return ctl, dict(lambda_v_bounds=chip_smoke.LAMBDA_2D,
                     solver_parameters=dict(chip_smoke.SOLVER_PARAMETERS,
                                            **sp))


def _stokes(sp):
    ctl = chip_smoke.stokes_problem(2, 2, torch.float64, "cpu")
    params = dict(chip_smoke.STOKES_PARAMETERS, **sp)

    def solve():
        return ctl.incompressible_linear_solve(
            T.ConstantNullspace(), solver_parameters=params,
            print_error=False, **chip_smoke.LAMBDA_STOKES)
    return ctl, solve


def _refinement_run(case, sp):
    if case == "stokes":
        ctl, solve = _stokes(sp)
        info = solve()
    else:
        build = _stationary_q1 if case == "stationary" else _instationary_q1
        ctl, kw = build(sp)
        info = ctl.linear_solve(print_error=False, **kw)
    return info, ctl._v.data.clone(), ctl._zeta.data.clone()


@pytest.mark.parametrize("case", ["stationary", "instationary", "stokes"])
def test_refinement_off_is_the_plain_solve(case):
    """``iterative_refinement: 0`` (with an inner tolerance, which is then
    ignored) gives the plain solve bit for bit, as in the JAX package's
    ``pop_refinement_params``; a refinement step raises (not ported)."""
    plain = _refinement_run(case, {})
    off = _refinement_run(case, REFINEMENT_OFF)
    assert off[0].iterations == plain[0].iterations
    assert np.array_equal(off[0].res_norms, plain[0].res_norms,
                          equal_nan=True)
    assert torch.equal(off[1], plain[1]) and torch.equal(off[2], plain[2])
    with pytest.raises(NotImplementedError, match="refinement"):
        _refinement_run(case, {"iterative_refinement": 1})


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensors_never_reach_the_library(monkeypatch):
    """At degree 3 in 3-D a CPU tensor runs the plain versions and counts
    no launch."""
    def no_library():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(kernels, "library", no_library)
    before = dict(ts.launch_counts)
    for kind in ("shared", "complex"):
        w, dinv, b, x0, th, de = map(torch.as_tensor, _cheb_case(kind))
        ts.apply_stencil(w, b, 3, nd=3)
        ts.fused_cheb_smooth(w, dinv, b, x0, 2, th, de, 3, nd=3)
        ts.fused_cheb_smooth(w, dinv, b, x0, 2, th, de, 3,
                             want_residual=True, nd=3)
    assert ts.launch_counts == before
    assert 3 in ts.CUDA_DEGREES[3]
    assert ts.launch_counts["cheb_smooth_3d_complex_q3_bf16"] == 0


@pytest.mark.parametrize("case", ["apply_degree4", "cheb_degree4",
                                  "vector_degree3"])
def test_cuda_wrappers_refuse_what_no_kernel_covers(case):
    """Degree 4 in 3-D (K = 729) and K5v at degree 3 raise before any
    launch (the wrappers' checks run before the library loads): no plain
    fallback on the card."""
    x = torch.zeros(2, 5, 5, 5, dtype=torch.float64)
    if case == "vector_degree3":
        w = torch.zeros(K, 5, 5, 5, 3, 3, dtype=torch.float64)
        xv = torch.zeros(2, 5, 5, 5, 3, dtype=torch.float64)
        call = lambda: ts._cheb_vector_cuda(  # noqa: E731
            w, xv, xv, xv, 2, 1.0, 0.5, 3, True, 3)
    else:
        w = torch.zeros(729, 5, 5, 5, dtype=torch.float64)
        call = (lambda: ts._apply_cuda(w, x, 4, 3)) \
            if case == "apply_degree4" else \
            (lambda: ts._cheb_cuda(w, x[0], x, x, 2, 1.0, 0.5, 4, True, 3))
    with pytest.raises(NotImplementedError, match="degree"):
        call()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


GPU_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["shared", "per_batch"])
def test_k6_q3_on_card_matches_plain(dtype, kind):
    dev = _card()
    dt = getattr(torch, dtype)
    w, _, b, _, _, _ = _cheb_case(kind, seed=36)
    w = torch.as_tensor(w, dtype=dt, device=dev)
    b = torch.as_tensor(b, dtype=dt, device=dev)
    before = ts.launch_counts["stencil_apply_3d_q3"]
    got = ts.apply_stencil(w, b, 3, nd=3)
    torch.cuda.synchronize()
    assert ts.launch_counts["stencil_apply_3d_q3"] == before + 1
    close(ts._apply_plain(w, b, 3, nd=3).cpu(), got,
          1e-12 if dt == torch.float64 else 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["shared", "per_batch", "complex"])
@pytest.mark.parametrize("weights", ["full", "narrow"])
def test_k5_q3_on_card_matches_plain(dtype, kind, weights):
    """K5 real and complex at degree 3, 4 steps and the residual, with full
    planes and with narrow ones (bf16 under float32 fields, f32 under
    float64: the ``_bf16`` and ``_f32`` launch keys)."""
    dev = _card()
    rdt = getattr(torch, dtype)
    cplx = kind == "complex"
    dt = rdt.to_complex() if cplx else rdt
    w, dinv, b, x0, th, de = _cheb_case(kind, seed=37)
    w, dinv, b, x0 = (torch.as_tensor(a, dtype=dt, device=dev)
                      for a in (w, dinv, b, x0))
    th, de = (torch.as_tensor(a, dtype=rdt, device=dev) for a in (th, de))
    wd = None
    key = "cheb_smooth_3d_" + ("complex" if cplx else "real") + "_q3"
    if weights == "narrow":
        wd = "bfloat16" if rdt == torch.float32 else "float32"
        w, dinv = ts.narrow_planes(w, wd), ts.narrow_planes(dinv, wd)
        key += "_bf16" if wd == "bfloat16" else "_f32"
    before = ts.launch_counts[key]
    got = ts.fused_cheb_smooth(w, dinv, b, x0, 4, th, de, 3,
                               want_residual=True, weight_dtype=wd, nd=3)
    torch.cuda.synchronize()
    assert ts.launch_counts[key] == before + 1
    ref = ts._cheb_plain(w, dinv, b, x0, 4, th, de, 3, want_residual=True,
                         weight_dtype=wd, nd=3)
    close(ref[0].cpu(), got[0], GPU_TOL[rdt])
    close(ref[1].cpu(), got[1], GPU_TOL[rdt])


@pytest.mark.gpu
def test_k5_q3_offsets_past_2_31_values():
    """Per-batch float32 weights of 8 x 343 x 93^3 = 2.21e9 values (8.8
    GB): the last entries' weights lie past 2^31 values, so a 32-bit
    offset would read the wrong planes; one step and the residual on
    the card against the plain version."""
    dev = _card()
    if torch.cuda.get_device_properties(dev).total_memory < 40e9:
        pytest.skip("needs a card with 40 GB")
    g, n = (93, 93, 93), 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(38)
    w = torch.rand((n, K) + g, generator=gen, device=dev).mul_(-0.5)
    assert w.numel() > 2 ** 31
    w[:, K // 2] = 180.0
    dinv = 1.0 / w[:, K // 2]
    b = torch.randn((n,) + g, generator=gen, device=dev)
    x0 = torch.zeros_like(b)
    got = ts.fused_cheb_smooth(w, dinv, b, x0, 1, 1.25, 0.75, 3,
                               want_residual=True, nd=3)
    ref = ts._cheb_plain(w, dinv, b, x0, 1, 1.25, 0.75, 3,
                         want_residual=True, nd=3)
    for a, c in zip(ref, got):
        err = float((a - c).abs().max() / a.abs().max())
        assert err < 1e-5, err


@pytest.mark.gpu
def test_small_stationary_on_card_matches_cpu():
    """The exact-pair solve at hex Q3 2^3 on the card (K6 and K5 real at
    degree 3) and on the CPU: equal iterations, histories within 1e-8 of
    the initial residual, v and zeta within 1e-9."""
    dev = _card()
    runs = {}
    for device in ("cpu", dev):
        ctl, kw, _ = chip_smoke.stationary_hex_problem(
            2, 3, torch.float64, device, chip_smoke.q3_mass_bounds(3),
            chip_smoke.HEX_SMALL_PARAMETERS)
        ts.reset_launch_counts()
        info = ctl.linear_solve(print_error=False, **kw)
        runs[str(device)] = (info, ctl._v.data.cpu(), ctl._zeta.data.cpu())
    assert ts.launch_counts["cheb_smooth_3d_real_q3"] > 0
    assert ts.launch_counts["stencil_apply_3d_q3"] > 0
    (ic, vc, zc), (ig, vg, zg) = runs["cpu"], runs[str(dev)]
    assert ig.iterations == ic.iterations
    k = ic.iterations + 1
    gap = np.abs(ic.res_norms[:k] - ig.res_norms[:k]) / ic.res_norms[0]
    assert float(gap.max()) < 1e-8
    close(vc, vg, 1e-9)
    close(zc, zg, 1e-9)

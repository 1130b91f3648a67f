"""Backward-Euler heat control (``CN=False``): the port against the JAX
package, in float64 on the CPU.

* the sweeps: ``_BEParaDiagSweep`` (two exact edge-row V-cycles around an
  interior ParaDiag), ``_SweepSolver.solve`` and ``solve_jacobi``, forward,
  backward and forward with ``last_sub_scale = eps``, on the backward-Euler
  factor stack (shifts [0, c, ..., c, sqrt(eps) c], sub-diagonal -M): on
  a 6x6 Q1 mesh (one level, exact solves) and, in the slow tier, on a
  32^2 one (the interior ParaDiag hierarchy two levels deep, so the plain
  K3 runs); tolerance 1e-12 relative;
* the BE preconditioner (``construct_pc(..., epsilon=1e-3)``), scan and
  ParaDiag, built by the JAX package and carried across by
  ``utils.convert``: one application on seeded (b_0, b_1) within 1e-11;
* ``MultiBlockSystem.solve_fn(unknown_scale=...)`` called directly on the
  port's BE system and pc with the eps transform: the JAX package's solve
  (which runs the same transform) to the same iterations, residual
  histories within 1e-10; the BE operator's block diagonals run as shared
  products;
* whole BE solves at 16^2 x 8 (the flagship's settings: beta 1e-4,
  GMRES(10), rtol 1e-6), scan, ParaDiag ((3, 3) smoothing, one cycle, 10
  mass steps) and the block-Jacobi sweep: the JAX package's iteration
  counts, histories within 1e-10 (the rounding of two implementations,
  amplified by the pc's 1/eps = 1e3 on the final block), v and zeta
  within 1e-9;
* the port's own versions of the JAX package's BE tests: the exact
  space-time solution at n_t = 5 in 2-D (Q2) and 3-D (hex Q1), to
  1e-13 / 1e-12 in the L2 norm, with every sweep; ParaDiag against scan
  at 16^2 x 8;
* the problem setters: ``set_CN`` and ``set_n_t`` give the problem built
  with those values, bit for bit, as do ``set_beta``,
  ``set_time_interval``, ``set_desired_state``, ``set_force_function``,
  ``set_forward_form`` and ``set_initial_condition``; ``set_epsilon``
  raises as the JAX package does and keys the pc cache.

The ``slow`` tests hold the two-level sweeps, the jacobi whole solve and
the 3-D BE solves (heat3d at 8^3 x 8, ParaDiag and scan) to the JAX
package, whose eager and compiled programs for them take most of the
file's time here.
The tests marked ``gpu`` hold the BE solves on the card to the same solves
on the CPU, and the batch-of-one smoothers of the edge rows (K2, K5 real)
to their plain versions; they skip elsewhere.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import control_tpu as J
import control_tpu_torch as T
from control_tpu.models import instationary as ji
from control_tpu.fem.space import combine_masks as j_combine
from control_tpu_torch.models import instationary as ti
from control_tpu_torch.fem.space import combine_masks as t_combine
from control_tpu_torch.ops import stencil as ts
from control_tpu_torch.solvers.block import finalize_solve_info
from control_tpu_torch.utils import convert

EPS = 1.0e-3
SOLVER_PARAMETERS = {"linear_solver": "gmres", "gmres_restart": 10,
                     "maximum_iterations": 50, "relative_tolerance": 1.0e-6,
                     "absolute_tolerance": 0.0,
                     "monitor_convergence": False}
LAMBDA_V_BOUNDS = (0.25, 2.25)


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


def rel_err(a, b):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def mesh_kw(mod, device="cpu"):
    return {"device": device, "dtype": "float64"} if mod is T else {}


def heat_problem(mod, n, n_t, mode, device="cpu", CN=False):
    """The flagship heat-control problem (Q1 UnitSquareMesh, beta 1e-4,
    zero Dirichlet data) under backward Euler."""
    mesh = mod.UnitSquareMesh(n, n, quadrilateral=True,
                              **mesh_kw(mod, device))
    space = mod.FunctionSpace(mesh, "Lagrange", 1)
    X = mod.SpatialCoordinate(mesh)

    def forw_diff_operator(trial, test, u, t):
        return mod.inner(mod.grad(trial), mod.grad(test)) * mod.dx

    def profile():
        return (mod.cos(0.5 * mod.pi * (X[0] - 1.0))
                * mod.cos(0.5 * mod.pi * (X[1] - 1.0)))

    def desired_state(test, t):
        v_d = mod.Function(space).interpolate(profile())
        return mod.inner(v_d, test) * mod.dx, v_d

    def force_f(test, t):
        f = mod.Function(space).interpolate(profile())
        return mod.inner(f, test) * mod.dx

    def bc_t(space_0, t):
        return mod.DirichletBC(space_0, 0.0, "on_boundary")

    ctl = mod.Control.Instationary(
        space, forw_diff_operator, desired_state=desired_state,
        force_f=force_f, beta=1e-4, n_t=n_t, time_interval=(0.0, 2.0),
        CN=CN, bcs_v=bc_t)
    set_mode(ctl, mode)
    return ctl


def set_mode(ctl, mode):
    if mode == "paradiag":
        ctl.set_schur_sweep("paradiag", paradiag_cycles=1, smooth=(3, 3))
        ctl.set_mass_solver_steps(10)
    elif mode == "jacobi":
        ctl.set_schur_sweep("jacobi", 4)
    else:
        ctl.set_schur_sweep(mode)


def solve(mod, ctl, parameters=SOLVER_PARAMETERS):
    kw = {"create_output": False} if mod is J else {}
    return ctl.linear_solve(lambda_v_bounds=LAMBDA_V_BOUNDS,
                            solver_parameters=parameters,
                            print_error=False, **kw)


def history_rel(ij, it):
    k = ij.iterations + 1
    return float(np.max(np.abs(ij.res_norms[:k] - it.res_norms[:k])
                        / ij.res_norms[:k]))


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------

SWEEPS = ("edge_paradiag", "scan", "jacobi")
DIRECTIONS = {"forward": (False, 1.0), "backward": (True, 1.0),
              "forward_eps": (False, EPS)}


def be_factors(mod, combine, n_mesh, n):
    """The BE Schur factor stack of ``n`` rows, 0.05 K + M plus the shifts
    [0, c, ..., c, sqrt(eps) c] M, and the sub-diagonal -M."""
    mesh = mod.UnitSquareMesh(n_mesh, n_mesh, quadrilateral=True,
                              **mesh_kw(mod))
    space = mod.FunctionSpace(mesh, "Lagrange", 1)
    u, v = mod.TrialFunction(space), mod.TestFunction(space)
    mask = combine(space, (mod.DirichletBC(space, 0.0, "on_boundary"),))
    K = np.asarray(mod.assemble(mod.inner(mod.grad(u), mod.grad(v))
                                * mod.dx).A)
    M = np.asarray(mod.assemble(mod.inner(u, v) * mod.dx).A)
    c = 2.5
    shifts = np.concatenate([[0.0], np.full(n - 2, c), [EPS ** 0.5 * c]])
    F = 0.05 * K[None] + M[None] + shifts[:, None, None, None] * M[None]
    return space, mask, F, (-M)[None]


def sweep_results(n_mesh, n, sweeps):
    """``sweeps`` of both packages in every direction on one seeded rhs:
    {(sweep, direction): [JAX result, port result]}, and the depth of the
    port's interior ParaDiag hierarchy."""
    rng = np.random.default_rng(11)
    out = {}
    for mod, combine, inst, arr in (
            (J, j_combine, ji, jnp.asarray),
            (T, t_combine, ti, torch.as_tensor)):
        space, mask, F, S = be_factors(mod, combine, n_mesh, n)
        if "b" not in out:
            b = rng.standard_normal((n,) + tuple(space.grid_shape))
            out["b"] = np.where(np.asarray(mask)[None], 0.0, b)
        b = arr(out["b"])
        solvers = {
            "edge_paradiag": inst._BEParaDiagSweep(
                space, mask, arr(F), arr(S), n, cycles=1, smooth=(3, 3)),
            "scan": inst._SweepSolver(space, mask, arr(F), arr(S))}
        if mod is T:
            out["levels"] = len(solvers["edge_paradiag"].mid.config.spaces)
        for sweep in sweeps:
            for name, (rev, ls) in DIRECTIONS.items():
                if sweep == "jacobi":
                    u = solvers["scan"].solve_jacobi(
                        b, reverse=rev, steps=3, last_sub_scale=ls)
                else:
                    u = solvers[sweep].solve(b, reverse=rev,
                                             last_sub_scale=ls)
                out.setdefault((sweep, name), []).append(u)
    return out


@pytest.fixture(scope="module")
def sweeps_one_level():
    """The JAX package's own case (``tests/test_paradiag.py``): 6x6 Q1,
    49 dofs, every hierarchy one dense level (exact solves), 9 rows."""
    return sweep_results(6, 9, SWEEPS)


@pytest.fixture(scope="module")
def sweeps_two_levels():
    """32^2 Q1, 6 rows: the interior ParaDiag hierarchy (coarse level up to
    600 dofs) two levels deep, so its smoothing runs the plain K3; the
    scan and jacobi hierarchies (up to 4500 dofs) stay one dense level,
    as at 6x6, so only the edge-row ParaDiag runs here."""
    return sweep_results(32, 6, ("edge_paradiag",))


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
@pytest.mark.parametrize("sweep", SWEEPS)
def test_be_sweeps_match_reference(sweeps_one_level, sweep, direction):
    out = sweeps_one_level
    assert out["levels"] == 1
    uj, ut = out[(sweep, direction)]
    assert rel_err(uj, ut) <= 1e-12


# slow: the JAX package's eager two-level complex hierarchy takes 25-30 s
# to build here, a third of the file's time
@pytest.mark.slow
@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_be_paradiag_sweep_two_levels_matches_reference(sweeps_two_levels,
                                                        direction):
    out = sweeps_two_levels
    assert out["levels"] == 2
    uj, ut = out[("edge_paradiag", direction)]
    assert rel_err(uj, ut) <= 1e-12


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_be_paradiag_sweep_of_three_rows_is_exact(direction):
    """n_t = 3: the interior is one row (the ParaDiag sweep's trivial
    case, one real V-cycle), so on a one-level 6x6 hierarchy (exact
    solves) the edge-row sweep is the exact substitution of the scan."""
    space, mask, F, S = be_factors(T, t_combine, 6, 3)
    F, S = torch.as_tensor(F), torch.as_tensor(S)
    rng = np.random.default_rng(4)
    b = torch.where(mask[None], 0.0, torch.as_tensor(
        rng.standard_normal((3,) + tuple(space.grid_shape))))
    edge = ti._BEParaDiagSweep(space, mask, F, S, 3)
    assert edge.mid.trivial
    rev, ls = DIRECTIONS[direction]
    exact = ti._SweepSolver(space, mask, F, S).solve(b, reverse=rev,
                                                     last_sub_scale=ls)
    got = edge.solve(b, reverse=rev, last_sub_scale=ls)
    assert rel_err(exact, got) <= 1e-12


def test_last_sub_scale_is_forward_only():
    space, mask, F, S = be_factors(T, t_combine, 6, 5)
    b = torch.zeros((5,) + tuple(space.grid_shape), dtype=torch.float64)
    F, S = torch.as_tensor(F), torch.as_tensor(S)
    scan = ti._SweepSolver(space, mask, F, S)
    for fn in (ti._BEParaDiagSweep(space, mask, F, S, 5).solve, scan.solve,
               scan.solve_jacobi):
        with pytest.raises(ValueError):
            fn(b, reverse=True, last_sub_scale=EPS)
    with pytest.raises(ValueError):
        ti._BEParaDiagSweep(space, mask, F[:1], S, 5)


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------

# the block-Jacobi sweep's whole solve is in the slow tier (its sweeps are
# held to the JAX package above, and it solves the exact-solution test)
SOLVES = ("paradiag", "scan", pytest.param("jacobi", marks=pytest.mark.slow))


@pytest.fixture(scope="module", params=SOLVES)
def solved(request):
    """Both packages' BE solves at 16^2 x 8 in one sweep mode."""
    mode = request.param
    cj = heat_problem(J, 16, 8, mode)
    ij = solve(J, cj)
    ct = heat_problem(T, 16, 8, mode)
    it = solve(T, ct)
    return mode, cj, ij, ct, it


def test_be_iterations_match_reference(solved):
    _, _, ij, _, it = solved
    assert it.iterations == ij.iterations
    assert it.converged and it.rnorm / it.rnorm0 < 1e-6


def test_be_residual_history_matches_reference(solved):
    _, _, ij, _, it = solved
    assert history_rel(ij, it) < 1e-10


@pytest.mark.parametrize("field", ["_v", "_zeta"])
def test_be_solution_matches_reference(solved, field):
    _, cj, _, ct, _ = solved
    a, b = getattr(cj, field).data, getattr(ct, field).data
    assert b.shape == (8,) + tuple(ct._space_v.grid_shape)
    assert rel_err(a, b) < 1e-9


def test_be_pc_state(solved):
    """The pc cache holds the BE state: the edge-row ParaDiag's edge
    hierarchies, coupling stencil and interior state in the ParaDiag mode,
    one real hierarchy per time row (row-dependent shifts) otherwise."""
    mode, _, _, ct, _ = solved
    (state,) = ct._pc_state_cache.values()
    fwd = state["fwd"]
    if mode == "paradiag":
        assert set(fwd) == {"e_first", "e_last", "wS", "mid"}
        assert set(fwd["mid"]) == {"params", "wF", "wS"}
        # the interior's frequency hierarchies: one real stencil pair per
        # level, level 0's the defect correction's, per-frequency planes
        # complex
        params = fwd["mid"]["params"]
        assert not params["WF"][0].is_complex()
        assert params["WF"][0] is fwd["mid"]["wF"]
        assert params["mu"].is_complex() and params["dinvs"][0].is_complex()
    else:
        assert set(fwd) == {"params", "sub"}
        assert fwd["params"]["lams"].shape[0] == 8


def test_be_system_groups_are_shared_products(solved):
    """The BE operator's block diagonals, (0,0) and (1,1) with one end row
    missing among them, each run as one product with one shared element
    matrix over the rows that have a block (a time-independent operator):
    no per-row stack of element matrices padded with zero matrices."""
    _, _, _, ct, _ = solved
    M = T.assemble(ct._M_v)
    b00, b01, b10, b11 = ct._blocks(ct._D_stack(ct._v.data), M=M)[:4]
    system = T.MultiBlockSystem(ct._space_v, ct._space_v, b00, b01, b10,
                                b11, n_blocks_00=8, n_blocks_11=8, CN=False)
    spans = {}
    for name, groups in (("00", system.g00), ("01", system.g01),
                         ("10", system.g10), ("11", system.g11)):
        for g in groups:
            assert g.A.shape[0] == 1, (name, g.offset, tuple(g.A.shape))
            spans[(name, g.offset)] = (g.row_start, g.n_active)
    assert spans[("00", 0)] == (0, 7) and spans[("11", 0)] == (1, 7)
    assert spans[("01", 1)] == (0, 7) and spans[("10", -1)] == (1, 7)


@pytest.mark.parametrize("given", [False, True])
def test_be_rhs_with_inhomogeneous_bcs_matches_reference(given):
    """The BE right-hand sides (n_t blocks, no T-transforms) with
    time-dependent inhomogeneous Dirichlet data, an initial condition and
    the bc lifts (row 0 through the initial-state operator), or with given
    v_d and f stacks, against the JAX package's ``_build_rhs``, within
    1e-12."""
    rng = np.random.default_rng(6)
    given_data = rng.standard_normal((2, 5, 9, 9))
    out = []
    for mod, combine in ((J, j_combine), (T, t_combine)):
        ctl = heat_problem(mod, 8, 5, "scan")
        X = mod.SpatialCoordinate(ctl._space_v.mesh)
        ctl.set_initial_condition(lambda test, mod=mod, X=X: mod.Function(
            ctl._space_v).interpolate(1.0 + X[0] * X[1]))
        ctl.set_bcs_v(lambda s, t, mod=mod: mod.DirichletBC(
            s, 1.0 + t, "on_boundary"))
        mask = combine(ctl._space_v, mod.homogenize(ctl._bcs_v[1]))
        Dv = ctl._D_stack(ctl._v.data)
        M = mod.assemble(ctl._M_v)
        v_d = f = None
        if given:
            arr = jnp.asarray if mod is J else torch.as_tensor
            v_d = mod.MixedFunction(ctl._space_v, 5, data=arr(given_data[0]))
            f = mod.MixedFunction(ctl._space_v, 5, data=arr(given_data[1]))
        out.append(ctl._build_rhs(v_d, f, ctl._initial_state(), Dv, M, mask,
                                  True, ctl._bcs_v))
    for a, b in zip(*out):
        assert rel_err(a, b) <= 1e-12


def pc_pair(cj, ct):
    """The JAX package's BE pc and the port's, built from the JAX state
    carried across by ``utils.convert``."""
    out = []
    for mod, ctl, combine in ((J, cj, j_combine), (T, ct, t_combine)):
        mask = combine(ctl._space_v, ctl._bcs_v[1])
        Dv = ctl._D_stack(ctl._v.data)
        M = mod.assemble(ctl._M_v)
        kw = {}
        if mod is T:
            kw["prebuilt"] = convert.to_torch(
                jax.tree_util.tree_map(np.asarray, out[0].state),
                ct._space_v)
        out.append(ctl.construct_pc(False, LAMBDA_V_BOUNDS, mask, Dv, M,
                                    epsilon=EPS, **kw))
    return out, np.asarray(mask)


def test_be_pc_application_with_carried_state(solved):
    """One application of the BE block preconditioner, built by the JAX
    package and carried across by utils.convert, within 1e-11."""
    mode, cj, _, ct, _ = solved
    (pc_j, pc_t), mask = pc_pair(cj, ct)
    rng = np.random.default_rng(21)
    shape = (8,) + mask.shape
    b0 = np.where(mask[None], 0.0, rng.standard_normal(shape))
    b1 = np.where(mask[None], 0.0, rng.standard_normal(shape))
    uj = pc_j(jnp.asarray(b0), jnp.asarray(b1))
    ut = pc_t(torch.as_tensor(b0), torch.as_tensor(b1))
    for a, b in zip(uj, ut):
        assert rel_err(a, b) <= 1e-11


def test_solve_fn_unknown_scale_matches_reference(solved):
    """The port's ``MultiBlockSystem.solve_fn`` called directly on its BE
    system and pc with the eps similarity transform of the final state
    block, ``unknown_scale = (s0, None)`` with s0[n_t - 1] = 1/eps:
    the JAX package's solve (which runs the same transform) to the same
    iterations, residual history within 1e-10."""
    _, _, ij, ct, _ = solved
    mask = t_combine(ct._space_v, ct._bcs_v[1])
    Dv, M = ct._D_stack(ct._v.data), T.assemble(ct._M_v)
    v_0 = ct._initial_state()
    b_0, b_1 = ct._build_rhs(None, None, v_0, Dv, M, mask, False, ct._bcs_v)
    ns = tuple(T.DirichletBCNullspace(ct._bcs_v[1]) for _ in range(8))
    system = T.MultiBlockSystem(
        ct._space_v, ct._space_v, *ct._blocks(Dv, M=M)[:4], n_blocks_00=8,
        n_blocks_11=8, nullspace_0=ns, nullspace_1=ns, CN=False)
    pc = ct.construct_pc(False, LAMBDA_V_BOUNDS, mask, Dv, M, epsilon=EPS)
    s0 = torch.ones(8, dtype=torch.float64)
    s0[-1] = 1.0 / EPS
    fn = system.solve_fn(solver_parameters=SOLVER_PARAMETERS, pc_fn=pc,
                         unknown_scale=(s0, None))
    _, _, info = fn(torch.zeros_like(b_0), torch.zeros_like(b_1), b_0, b_1)
    it = finalize_solve_info(info, SOLVER_PARAMETERS)
    assert it.iterations == ij.iterations
    assert history_rel(ij, it) < 1e-10


# ---------------------------------------------------------------------------
# the JAX package's BE tests, on the port
# ---------------------------------------------------------------------------

def _mixed_l2(space, a_data, b_data):
    err2 = 0.0
    for i in range(a_data.shape[0]):
        d = T.Function(space, data=a_data[i] - b_data[i])
        err2 += float(T.assemble(T.inner(d, d) * T.dx))
    return np.sqrt(abs(err2))


def _exact_be(space, mesh, modes, n_t=5, tau=0.25, beta=1e-3):
    """The manufactured BE space-time solution of the JAX package's
    ``test_instationary_linear_control_BE`` (2-D) and its 3-D analogue,
    and its right-hand sides built by hand from mass and stiffness
    actions: (v_ref, zeta_ref, b_0, b_1)."""
    X = T.SpatialCoordinate(mesh)
    s1, s2, s3 = modes(X)
    v_ref = T.MixedFunction(space, n_t)
    zeta_ref = T.MixedFunction(space, n_t)
    for i, s in ((1, s1), (2, s2), (3, s1), (4, s2)):
        v_ref.sub(i).interpolate(tau ** i * s)
    for i, s in ((0, s3), (1, s1), (2, s3), (3, s1)):
        zeta_ref.sub(i).interpolate(tau ** i * s)
    u, w = T.TrialFunction(space), T.TestFunction(space)
    M = T.assemble(T.inner(u, w) * T.dx)
    K = T.assemble(T.inner(T.grad(u), T.grad(w)) * T.dx)
    vd, zd = v_ref.data, zeta_ref.data
    b_0, b_1 = torch.zeros_like(vd), torch.zeros_like(vd)
    for i in range(n_t):
        r0 = tau * K.apply(zd[i]) + M.apply(zd[i])
        if i < n_t - 1:
            r0 = r0 + tau * M.apply(vd[i]) - M.apply(zd[i + 1])
        b_0[i] = r0
        r1 = tau * K.apply(vd[i]) + M.apply(vd[i])
        if i >= 1:
            r1 = r1 - M.apply(vd[i - 1]) - (tau / beta) * M.apply(zd[i])
        b_1[i] = r1
    return v_ref, zeta_ref, b_0, b_1


def _exact_problem(mesh, degree, bounds, mode, modes, tol):
    space = T.FunctionSpace(mesh, "Lagrange", degree)

    def forw_diff_operator(trial, test, u, t):
        return T.inner(T.grad(trial), T.grad(test)) * T.dx

    def desired_state(test, t):
        v_d = T.Function(space, name="v_d")
        return T.inner(v_d, test) * T.dx, v_d

    def force_f(test, t):
        return T.inner(T.Function(space), test) * T.dx

    def bc_t(space_0, t):
        return T.DirichletBC(space_0, 0.0, "on_boundary")

    ctl = T.Control.Instationary(
        space, forw_diff_operator, desired_state=desired_state,
        force_f=force_f, beta=1e-3, time_interval=(0.0, 1.0), CN=False,
        n_t=5, bcs_v=bc_t)
    ctl.set_schur_sweep(mode)
    v_ref, zeta_ref, b_0, b_1 = _exact_be(space, mesh, modes)
    parameters = {"linear_solver": "fgmres", "fgmres_restart": 10,
                  "maximum_iterations": 500, "relative_tolerance": 1.0e-14,
                  "absolute_tolerance": 1.0e-14,
                  "monitor_convergence": False}
    ctl.linear_solve(lambda_v_bounds=bounds, solver_parameters=parameters,
                     v_d=T.MixedFunction(space, 5, data=b_0),
                     f=T.MixedFunction(space, 5, data=b_1),
                     print_error=False)
    assert _mixed_l2(space, ctl._v.data, v_ref.data) < tol
    assert _mixed_l2(space, ctl._zeta.data, zeta_ref.data) < tol


@pytest.mark.parametrize("mode", ["scan", "paradiag", "jacobi"])
def test_instationary_linear_control_BE(mode):
    """The port's ``tests/test_instationary.py::
    test_instationary_linear_control_BE`` (Q2, 8^2, n_t = 5), with every
    sweep."""
    def modes(X):
        return (T.sin(3 * T.pi * X[0]) * T.sin(4 * T.pi * X[1]),
                X[0] * T.exp(X[1]) * T.sin(T.pi * X[0])
                * T.sin(2 * T.pi * X[1]),
                T.sin(T.pi * X[0]) * T.sin(2 * T.pi * X[1]))

    mesh = T.UnitSquareMesh(8, 8, quadrilateral=True, device="cpu",
                            dtype="float64")
    _exact_problem(mesh, 2, (0.25, 1.5625), mode, modes, 1e-13)


@pytest.mark.parametrize("mode", ["scan", "paradiag"])
def test_instationary_3d_linear_control_BE(mode):
    """The port's ``tests/test_instationary3d.py::
    test_instationary_3d_linear_control_BE`` (hex Q1, 4^3, n_t = 5)."""
    def modes(X):
        s = T.sin(T.pi * X[2])
        return (T.sin(3 * T.pi * X[0]) * T.sin(4 * T.pi * X[1]) * s,
                X[0] * T.exp(X[1]) * T.sin(T.pi * X[0])
                * T.sin(2 * T.pi * X[1]) * s,
                T.sin(T.pi * X[0]) * T.sin(2 * T.pi * X[1]) * s)

    mesh = T.UnitCubeMesh(4, 4, 4, device="cpu", dtype="float64")
    _exact_problem(mesh, 1, (0.1, 3.4), mode, modes, 1e-12)


def test_paradiag_backward_euler_matches_scan():
    """The port's ``tests/test_paradiag.py::
    test_paradiag_backward_euler_matches_scan``: a CN problem switched to
    BE with ``set_CN``/``set_n_t``; the edge-row ParaDiag sweep takes at
    most two iterations more than the exact scan, with the same solution
    to 1e-6."""
    sp = dict(SOLVER_PARAMETERS, relative_tolerance=1e-8)
    results = {}
    for mode in ("scan", "paradiag"):
        ctl = heat_problem(T, 16, 16, "scan", CN=True)
        ctl.set_CN(CN=False)
        ctl.set_n_t(8)
        ctl.set_schur_sweep(mode)
        info = solve(T, ctl, sp)
        results[mode] = (info.iterations, ctl._v.data)
    (it_scan, v_scan), (it_para, v_para) = results["scan"], \
        results["paradiag"]
    assert it_para <= it_scan + 2, (it_para, it_scan)
    assert float(torch.linalg.norm(v_scan - v_para)
                 / torch.linalg.norm(v_scan)) < 1e-6


# ---------------------------------------------------------------------------
# the setters
# ---------------------------------------------------------------------------

def _same_solve(a, b):
    ia, ib = solve(T, a), solve(T, b)
    assert ia.iterations == ib.iterations
    assert np.array_equal(ia.res_norms, ib.res_norms, equal_nan=True)
    assert torch.equal(a._v.data, b._v.data)
    assert torch.equal(a._zeta.data, b._zeta.data)


@pytest.mark.parametrize("mode", ["scan", "paradiag"])
def test_set_cn_and_n_t_match_a_fresh_problem(mode):
    """A CN problem switched by ``set_CN(CN=False)`` and ``set_n_t(8)``
    solves bit for bit as one built with ``CN=False, n_t=8``."""
    switched = heat_problem(T, 8, 5, mode, CN=True)
    switched.set_CN(CN=False)
    switched.set_n_t(8)
    assert switched._v.data.shape[0] == 8
    _same_solve(switched, heat_problem(T, 8, 8, mode))


def test_setters_match_a_fresh_problem():
    """``set_beta``, ``set_time_interval``, ``set_desired_state``,
    ``set_force_function``, ``set_forward_form`` and
    ``set_initial_condition`` on a built problem give the problem built
    with those values."""
    def build(beta=1e-2, interval=(0.0, 1.0), scale=2.0, kappa=0.5):
        mesh = T.UnitSquareMesh(8, 8, quadrilateral=True, device="cpu",
                                dtype="float64")
        space = T.FunctionSpace(mesh, "Lagrange", 1)
        X = T.SpatialCoordinate(mesh)
        prof = T.sin(T.pi * X[0]) * T.sin(T.pi * X[1])

        def fwd(trial, test, u, t):
            return kappa * T.inner(T.grad(trial), T.grad(test)) * T.dx

        def ds(test, t):
            v_d = T.Function(space).interpolate(scale * prof)
            return T.inner(v_d, test) * T.dx, v_d

        def ff(test, t):
            return T.inner(T.Function(space).interpolate(scale * prof),
                           test) * T.dx

        def ic(test):
            return T.Function(space).interpolate(scale * prof)

        def bc_t(s, t):
            return T.DirichletBC(s, 0.0, "on_boundary")

        return T.Control.Instationary(
            space, fwd, desired_state=ds, force_f=ff, beta=beta, n_t=6,
            time_interval=interval, CN=False, bcs_v=bc_t,
            initial_condition=ic), (fwd, ds, ff, ic)

    ctl, _ = build()
    target, (fwd, ds, ff, ic) = build(beta=1e-3, interval=(0.0, 2.0),
                                      scale=3.0, kappa=2.0)
    ctl.set_beta(1e-3)
    ctl.set_time_interval((0.0, 2.0))
    ctl.set_desired_state(ds)
    ctl.set_force_function(ff)
    ctl.set_forward_form(fwd)
    ctl.set_initial_condition(ic)
    # the initial block takes the initial condition, its boundary values
    # the bcs' (sin(pi x) is 1e-16 there)
    assert torch.allclose(ctl._v.data[0], ic(None).data, rtol=0,
                          atol=1e-15)
    _same_solve(ctl, target)


def test_set_epsilon():
    """``set_epsilon`` raises under CN and outside (0, 1], as the JAX
    package does; a new epsilon builds a new pc (the cache is keyed by
    it) and moves the solve; None restores the default 1e-3."""
    cn = heat_problem(T, 8, 5, "scan", CN=True)
    cj = heat_problem(J, 8, 5, "scan", CN=True)
    for ctl in (cn, cj):
        with pytest.raises(ValueError):
            ctl.set_epsilon(1e-2)
        ctl.set_epsilon(None)
        ctl.set_CN(CN=False)
        for bad in (0.0, -1.0, 1.5):
            with pytest.raises(ValueError):
                ctl.set_epsilon(bad)
    ctl = heat_problem(T, 8, 6, "scan")
    default = solve(T, ctl)
    ctl.set_epsilon(1e-2)
    other = solve(T, ctl)
    assert len(ctl._pc_state_cache) == 2
    assert not np.array_equal(default.res_norms[:2], other.res_norms[:2])
    ctl.set_epsilon(None)
    again = solve(T, ctl)
    assert np.array_equal(default.res_norms, again.res_norms, equal_nan=True)


def test_set_space_v_matches_reference():
    """``set_space_v`` onto a refined mesh interpolates the current state
    and adjoint onto the new space (the initial state from the initial
    condition, boundary values re-imposed) as the JAX package does, to
    1e-12."""
    rng = np.random.default_rng(8)
    shape = (4, 9, 9)
    v, zeta = rng.standard_normal(shape), rng.standard_normal(shape)
    out = {}
    for mod in (J, T):
        ctl = heat_problem(mod, 8, 4, "scan")
        if mod is T:
            convert.carry_state(ctl, v=v, zeta=zeta)
        else:
            ctl.set_v(J.MixedFunction(ctl._space_v, 4, data=jnp.asarray(v)))
            ctl.set_zeta(J.MixedFunction(ctl._space_v, 4,
                                         data=jnp.asarray(zeta)))
        fine = mod.UnitSquareMesh(16, 16, quadrilateral=True, **mesh_kw(mod))
        ctl.set_space_v(mod.FunctionSpace(fine, "Lagrange", 1))
        out[mod] = ctl
    for field in ("_v", "_zeta"):
        a, b = getattr(out[J], field).data, getattr(out[T], field).data
        assert b.shape == (4, 17, 17)
        assert rel_err(a, b) <= 1e-12


def test_set_bcs_and_gauss_newton():
    """``set_bcs_v`` re-imposes new boundary values on every time block,
    ``set_Gauss_Newton`` only stores the flag (the linearisation itself
    raises), and backward Euler with a user preconditioner raises."""
    ctl = heat_problem(T, 8, 6, "scan")
    ctl.set_bcs_v(lambda s, t: T.DirichletBC(s, 1.0 + t, "on_boundary"))
    mask = t_combine(ctl._space_v, ctl._bcs_v[0])
    for i, t in enumerate(ctl._times()):
        assert torch.all(ctl._v.data[i][mask] == 1.0 + t)
    ctl.set_Gauss_Newton(True)
    assert ctl._Gauss_Newton
    with pytest.raises(NotImplementedError):
        ctl.construct_D_v(T.Function(ctl._space_v), 0.0)
    ctl.set_Gauss_Newton(False)
    with pytest.raises(NotImplementedError):
        ctl.linear_solve(P=lambda b0, b1: (b0, b1), print_error=False)


# ---------------------------------------------------------------------------
# 3-D against the JAX package (slow: its 3-D programs compile for minutes)
# ---------------------------------------------------------------------------

def heat3d_problem(mod, n, n_t, mode, device="cpu"):
    """``bench_extra.py``'s heat3d problem under backward Euler (hex Q1,
    beta 1e-4, v_d = sin(pi x) sin(pi y) sin(pi z), f = 0), the ParaDiag
    defaults."""
    mesh = mod.UnitCubeMesh(n, n, n, **mesh_kw(mod, device))
    space = mod.FunctionSpace(mesh, "Lagrange", 1)
    X = mod.SpatialCoordinate(mesh)

    def fdo(trial, test, u, t):
        return mod.inner(mod.grad(trial), mod.grad(test)) * mod.dx

    def ds_(test, t):
        v_d = mod.Function(space).interpolate(
            mod.sin(mod.pi * X[0]) * mod.sin(mod.pi * X[1])
            * mod.sin(mod.pi * X[2]))
        return mod.inner(v_d, test) * mod.dx, v_d

    def ff(test, t):
        return mod.inner(mod.Function(space), test) * mod.dx

    def bc_t(s, t):
        return mod.DirichletBC(s, 0.0, "on_boundary")

    ctl = mod.Control.Instationary(space, fdo, desired_state=ds_,
                                   force_f=ff, beta=1e-4, n_t=n_t,
                                   time_interval=(0.0, 2.0), CN=False,
                                   bcs_v=bc_t)
    ctl.set_schur_sweep(mode)
    return ctl


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["paradiag", "scan"])
def test_heat3d_be_matches_reference(mode):
    """heat3d under backward Euler at 8^3 x 8 (two multigrid levels):
    the JAX package's iterations, histories within 1e-10, v and zeta
    within 1e-9."""
    out = {}
    for mod in (J, T):
        ctl = heat3d_problem(mod, 8, 8, mode)
        out[mod] = (solve(mod, ctl, SOLVER_PARAMETERS), ctl)
    (ij, cj), (it, ct) = out[J], out[T]
    assert it.iterations == ij.iterations
    assert history_rel(ij, it) < 1e-10
    assert rel_err(cj._v.data, ct._v.data) < 1e-9
    assert rel_err(cj._zeta.data, ct._zeta.data) < 1e-9


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["scan", "paradiag"])
def test_be_solve_on_card_matches_cpu(mode):
    """The 16^2 x 8 BE solve on the card (kernels K1, K2, K3) against the
    same solve on the CPU (plain versions): the same iterations, histories
    within 1e-10 of the initial residual (the last entries lie six orders
    below it, where the two devices' rounding, amplified by 1/eps, is
    1e-10 of the entry itself), v and zeta within 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    runs = {}
    for device in ("cpu", "cuda"):
        ctl = heat_problem(T, 16, 8, mode, device=device)
        runs[device] = (solve(T, ctl), ctl)
    (ic, cc), (ig, cg) = runs["cpu"], runs["cuda"]
    assert ig.iterations == ic.iterations
    k = ic.iterations + 1
    assert float(np.max(np.abs(ic.res_norms[:k] - ig.res_norms[:k]))
                 / ic.res_norms[0]) < 1e-10
    assert rel_err(cc._v.data.numpy(), cg._v.data) < 1e-9
    assert rel_err(cc._zeta.data.numpy(), cg._zeta.data) < 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("grid", [(257, 257), (65, 65, 65)])
def test_edge_row_smoothers_on_card(grid, dtype):
    """The edge rows' V-cycle smoothing at batch one (one field, no
    leading axis): K2 at 257^2 and K5 real at 65^3, 10 steps and the
    residual, against the plain versions on the same CUDA tensors, as
    ``chip_smoke.py`` holds its kernel rows: the largest difference over
    both outputs relative to their largest value (the residual is a
    difference of O(|b|) terms, so its own size is no scale for its
    rounding); tolerance 1e-12 in double precision, 1e-4 in single."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    nd = len(grid)
    K = 3 ** nd
    rng = np.random.default_rng(3)
    w = -0.5 * rng.uniform(0.2, 1.0, (K,) + grid)
    w[K // 2] = 4.0 + (K - 9) / 2.0 + rng.uniform(0.0, 1.0, grid)

    def cu(a):
        return torch.as_tensor(a, dtype=dt, device="cuda")

    wt, dinv = cu(w), cu(1.0 / w[K // 2])
    b, x0 = cu(rng.standard_normal(grid)), cu(rng.standard_normal(grid))
    key = "cheb_smooth_3d_real" if nd == 3 else "cheb_smooth_real"
    before = ts.launch_counts[key]
    got = ts.fused_cheb_smooth(wt, dinv, b, x0, 10, 1.5, 1.0, 1,
                               want_residual=True, nd=nd)
    ref = ts._cheb_plain(wt, dinv, b, x0, 10, 1.5, 1.0, 1,
                         want_residual=True, nd=nd)
    tol = 1e-12 if dt == torch.float64 else 1e-4
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) / scale <= tol
    assert ts.launch_counts[key] == before + 1

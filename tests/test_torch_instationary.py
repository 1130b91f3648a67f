"""The slice end to end: the Crank-Nicolson heat-control KKT solve of the
port against the JAX package, in float64 on the CPU, with the flagship's
settings (``bench.py``: beta 1e-4, zero Dirichlet data, GMRES(10), rtol
1e-6) at small sizes.

* ParaDiag Schur sweeps ((3, 3) smoothing, one cycle, 10 mass steps) at
  32^2 x 8 -- at 16^2 the ParaDiag hierarchy would be dense-only and the
  complex smoother would not run;
* the default ``scan`` sweeps at 16^2 x 8.

Each must take the JAX package's 9 iterations, with the residual history
within 1e-8 relative and v / zeta within 1e-9 (rounding of two
implementations, amplified by the ParaDiag 1/alpha = 1e3 unscaling).  One
pc application with the JAX pc state carried across by
``utils.convert`` agrees to 1e-12.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import control_tpu as J
import control_tpu_torch as T
from control_tpu.fem.space import combine_masks as j_combine
from control_tpu_torch.fem.space import combine_masks as t_combine
from control_tpu_torch.utils import convert

SOLVER_PARAMETERS = {"linear_solver": "gmres", "gmres_restart": 10,
                     "maximum_iterations": 50, "relative_tolerance": 1.0e-6,
                     "absolute_tolerance": 0.0,
                     "monitor_convergence": False}
LAMBDA_V_BOUNDS = (0.25, 2.25)


def heat_problem(mod, n, n_t, mode, forward=None):
    mesh = mod.UnitSquareMesh(n, n, quadrilateral=True, dtype="float64")
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
        space, forward or forw_diff_operator, desired_state=desired_state,
        force_f=force_f, beta=1e-4, n_t=n_t, time_interval=(0.0, 2.0),
        CN=True, bcs_v=bc_t)
    if mode == "paradiag":
        ctl.set_schur_sweep("paradiag", paradiag_cycles=1, smooth=(3, 3))
        ctl.set_mass_solver_steps(10)
    return ctl


def solve(mod, ctl):
    kw = {"create_output": False} if mod is J else {}
    return ctl.linear_solve(lambda_v_bounds=LAMBDA_V_BOUNDS,
                            solver_parameters=SOLVER_PARAMETERS,
                            print_error=False, **kw)


CASES = {"paradiag": (32, 8), "scan": (16, 8)}


@pytest.fixture(scope="module", params=sorted(CASES))
def solved(request):
    """Both packages' solves of one case (the JAX one compiles once per
    module)."""
    mode = request.param
    n, n_t = CASES[mode]
    cj = heat_problem(J, n, n_t, mode)
    ij = solve(J, cj)
    ct = heat_problem(T, n, n_t, mode)
    it = solve(T, ct)
    return mode, cj, ij, ct, it


def test_iterations_match_reference(solved):
    mode, cj, ij, ct, it = solved
    assert ij.iterations == 9
    assert it.iterations == ij.iterations
    assert it.converged and it.rnorm / it.rnorm0 < 1e-6


def test_residual_history_matches_reference(solved):
    _, _, ij, _, it = solved
    k = ij.iterations + 1
    rel = np.abs(ij.res_norms[:k] - it.res_norms[:k]) / ij.res_norms[:k]
    assert float(rel.max()) < 1e-8, rel


@pytest.mark.parametrize("field", ["_v", "_zeta"])
def test_solution_matches_reference(solved, field):
    _, cj, _, ct, _ = solved
    a = np.asarray(getattr(cj, field).data)
    b = getattr(ct, field).data.numpy()
    assert a.shape == b.shape
    assert float(np.abs(a - b).max() / np.abs(a).max()) < 1e-9


def test_sweep_kind(solved):
    """ParaDiag really runs when asked (the factors are Toeplitz); the
    default stays the exact sequential sweep."""
    from control_tpu_torch.models.instationary import (_ParaDiagSweep,
                                                       _SweepSolver)
    mode, _, _, ct, _ = solved
    state = next(iter(ct._pc_state_cache.values()))
    fwd = state["fwd"]
    if mode == "paradiag":
        assert set(fwd) == {"params", "wF", "wS"}
        assert fwd["params"]["Ws"][0].is_complex()
    else:
        assert set(fwd) == {"params", "sub"}
    assert _ParaDiagSweep and _SweepSolver


def _pc_inputs(mod, ctl, combine):
    mask = combine(ctl._space_v, ctl._bcs_v[1])
    return mask, ctl._D_stack(ctl._v.data), mod.assemble(ctl._M_v)


def test_pc_application_with_carried_state(solved):
    """One application of the CN block preconditioner, built by the JAX
    package and carried across by utils.convert, agrees to 1e-12."""
    mode, cj, _, ct, _ = solved
    mj, Dj, Mj = _pc_inputs(J, cj, j_combine)
    mt, Dt, Mt = _pc_inputs(T, ct, t_combine)
    pc_j = cj.construct_pc(False, LAMBDA_V_BOUNDS, mj, Dj, Mj)
    state = convert.to_torch(jax.tree_util.tree_map(np.asarray,
                                                    pc_j.state))
    pc_t = ct.construct_pc(False, LAMBDA_V_BOUNDS, mt, Dt, Mt,
                           prebuilt=state)
    n, n_t = CASES[mode]
    rng = np.random.default_rng(21)
    shape = (n_t - 1, n + 1, n + 1)
    mask = np.broadcast_to(np.asarray(mj)[None], shape)
    b0 = np.where(mask, 0.0, rng.standard_normal(shape))
    b1 = np.where(mask, 0.0, rng.standard_normal(shape))
    uj = pc_j(jnp.asarray(b0), jnp.asarray(b1))
    ut = pc_t(torch.as_tensor(b0), torch.as_tensor(b1))
    for a, b in zip(uj, ut):
        a = np.asarray(a)
        assert float(np.abs(a - b.numpy()).max() / np.abs(a).max()) < 1e-12


def test_time_dependent_operator_falls_back_to_scan():
    """A time-dependent operator makes the sweep factors row-dependent:
    ParaDiag is asked for, the exact sequential sweep runs (per-row
    hierarchies, built as one batch), as in the reference."""
    results = {}
    for mod in (J, T):
        def forw(trial, test, u, t, mod=mod):
            return ((1.0 + t) * mod.inner(mod.grad(trial), mod.grad(test))
                    * mod.dx)

        ctl = heat_problem(mod, 8, 5, "paradiag", forward=forw)
        info = solve(mod, ctl)
        results[mod] = (info, np.asarray(ctl._v.data) if mod is J
                        else ctl._v.data.numpy())
        if mod is T:
            state = next(iter(ctl._pc_state_cache.values()))
            assert set(state["fwd"]) == {"params", "sub"}
            assert state["fwd"]["params"]["lams"].shape[0] == 4
    (ij, vj), (it, vt) = results[J], results[T]
    assert it.iterations == ij.iterations
    k = ij.iterations + 1
    assert float(np.max(np.abs(ij.res_norms[:k] - it.res_norms[:k])
                        / ij.res_norms[:k])) < 1e-8
    assert float(np.abs(vj - vt).max() / np.abs(vj).max()) < 1e-9


def test_unported_paths_raise():
    ct = heat_problem(T, 4, 4, "scan")
    with pytest.raises(NotImplementedError):
        ct.set_schur_sweep("jacobi")
    be = heat_problem(T, 4, 4, "scan")
    be._CN = False
    with pytest.raises(NotImplementedError):
        be.linear_solve(lambda_v_bounds=LAMBDA_V_BOUNDS, print_error=False)


def test_create_output_writes_npz(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ct = heat_problem(T, 4, 4, "scan")
    ct.linear_solve(lambda_v_bounds=LAMBDA_V_BOUNDS,
                    solver_parameters=SOLVER_PARAMETERS, print_error=False,
                    create_output=True)
    for name in ("v", "zeta"):
        data = np.load(tmp_path / f"{name}.npz")["data"]
        assert data.shape == (4, 5, 5) and np.isfinite(data).all()

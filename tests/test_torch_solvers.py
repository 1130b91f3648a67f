"""The port's solver layer against the JAX package, in float64 on the CPU:
GMRES/FGMRES residual histories, the Q1 grid transfers, multigrid
hierarchies and V-cycles (real and complex), and the block-system
algebra.  Inputs are made with numpy from a seed.  Tolerances: 1e-10 for
the Krylov histories (the rounding of two implementations of one
recurrence, amplified over the iterations), 1e-12 for the rest."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import control_tpu as J
import control_tpu_torch as T
from control_tpu.solvers import krylov as jk, multigrid as jm, block as jb
from control_tpu_torch.solvers import krylov as tk, multigrid as tm, \
    block as tb

TOL = 1e-12


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
    scale = max(float(np.max(np.abs(a))), np.finfo(np.float64).tiny)
    err = float(np.max(np.abs(a - b))) / scale
    assert err <= tol, err


# ---------------------------------------------------------------------------
# Krylov
# ---------------------------------------------------------------------------

def _system(seed, n0=14, n1=9):
    rng = np.random.default_rng(seed)
    n = n0 + n1
    A = 3.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
    P = np.diag(1.0 / np.diag(A)) + 0.05 * rng.standard_normal((n, n))
    b = (rng.standard_normal(n0), rng.standard_normal(n1))
    return A, P, b, n0


def _tuple_op(mat, n0, lib):
    def op(x):
        v = lib.concatenate([x[0], x[1]]) if lib is jnp else \
            torch.cat([x[0], x[1]])
        y = (jnp.asarray(mat) if lib is jnp else torch.as_tensor(mat)) @ v
        return (y[:n0], y[n0:])
    return op


@pytest.mark.parametrize("method", ["gmres", "fgmres"])
@pytest.mark.parametrize("restart", [4, 30])
@pytest.mark.parametrize("precond", [True, False])
def test_gmres_history_matches_reference(method, restart, precond):
    A, P, b, n0 = _system(3)
    kw = dict(restart=restart, rtol=1e-11, atol=0.0, maxiter=60)
    xj, ij = getattr(jk, method)(
        _tuple_op(A, n0, jnp), tuple(jnp.asarray(v) for v in b),
        M=_tuple_op(P, n0, jnp) if precond else None, **kw)
    xt, it = getattr(tk, method)(
        _tuple_op(A, n0, torch), tuple(torch.as_tensor(v) for v in b),
        M=_tuple_op(P, n0, torch) if precond else None, **kw)
    its = int(ij["iterations"])
    assert it["iterations"] == its and its > restart // 2
    assert it["converged"] == bool(ij["converged"])
    close(np.asarray(ij["res_norms"])[:its + 1],
          it["res_norms"][:its + 1], tol=1e-10)
    assert np.isnan(it["res_norms"][its + 1:]).all()
    close(float(ij["rnorm0"]), it["rnorm0"], tol=1e-12)
    for a, c in zip(xj, xt):
        close(a, c, tol=1e-10)


def test_gmres_maxiter_and_solve_krylov_names():
    A, P, b, n0 = _system(4)
    bt = tuple(torch.as_tensor(v) for v in b)
    _, info = tk.solve_krylov("gmres", _tuple_op(A, n0, torch), bt,
                              restart=3, rtol=1e-14, maxiter=5)
    assert info["iterations"] == 5 and not info["converged"]
    with pytest.raises(ValueError):
        tk.solve_krylov("bicg", _tuple_op(A, n0, torch), bt)


# ---------------------------------------------------------------------------
# multigrid
# ---------------------------------------------------------------------------

def _spaces(n):
    mj = J.UnitSquareMesh(n, n, quadrilateral=True, dtype="float64")
    mt = T.UnitSquareMesh(n, n, quadrilateral=True, dtype="float64",
                          device="cpu")
    return J.FunctionSpace(mj, "Lagrange", 1), \
        T.FunctionSpace(mt, "Lagrange", 1)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_transfer_prolong_restrict(cplx, batch):
    sj, st = _spaces(8)
    trj, trt = jm.Transfer(sj), tm.Transfer(st)
    rng = np.random.default_rng(6)

    def field(shape):
        a = rng.standard_normal(shape)
        return a + 1j * rng.standard_normal(shape) if cplx else a

    xc = field(batch + trj.coarse.grid_shape)
    close(trj.prolong(jnp.asarray(xc)), trt.prolong(torch.as_tensor(xc)))
    rf = field(batch + sj.grid_shape)
    close(trj.restrict(jnp.asarray(rf)), trt.restrict(torch.as_tensor(rf)))
    A = rng.standard_normal((sj.mesh.n_cells, 4, 4))
    close(trj.galerkin(jnp.asarray(A)), trt.galerkin(torch.as_tensor(A)))
    close(trj.galerkin(jnp.asarray(A[:1])), trt.galerkin(torch.as_tensor(A[:1])))


def _operators(mod, sp, c):
    u, v = mod.TrialFunction(sp), mod.TestFunction(sp)
    K = mod.assemble(mod.inner(mod.grad(u), mod.grad(v)) * mod.dx).A
    M = mod.assemble(mod.inner(u, v) * mod.dx).A
    return K + c * M, K - 0.4 * M


def _mg_pair(n=16, **kw):
    sj, st = _spaces(n)
    bj, bt = J.DirichletBC(sj, 0.0), T.DirichletBC(st, 0.0)
    cj = jm.MGConfig(sj, bj.mask, **kw)
    ct = tm.MGConfig(st, bt.mask, **kw)
    assert len(cj.spaces) == len(ct.spaces) >= 3
    return sj, st, bj, bt, cj, ct


def _compare_params(pj, pt):
    for key in ("Ws", "diags", "dinvs"):
        for a, b in zip(pj[key], pt[key]):
            close(a, b)
    close(pj["lams"], pt["lams"])
    close(pj["Ainv"], pt["Ainv"], tol=1e-11)


@pytest.mark.parametrize("cycles", [1, 2])
def test_mg_apply_real(cycles):
    sj, st, bj, bt, cj, ct = _mg_pair(coarse_max_dofs=30, pre=3, post=2)
    Fj, _ = _operators(J, sj, 2.5)
    Ft, _ = _operators(T, st, 2.5)
    pj, pt = cj.build(Fj), ct.build(Ft)
    _compare_params(pj, pt)
    rng = np.random.default_rng(8)
    b = rng.standard_normal((3,) + sj.grid_shape)
    b[:, np.asarray(bj.mask)] = 0.0
    close(cj.apply(pj, jnp.asarray(b), cycles=cycles),
          ct.apply(pt, torch.as_tensor(b), cycles=cycles))


def test_mg_apply_complex_batched_hierarchies():
    """Per-frequency complex hierarchies (the ParaDiag blocks F + mu_k S),
    built as one batch, against the reference's vmapped build."""
    sj, st, bj, bt, cj, ct = _mg_pair(coarse_max_dofs=30, pre=3, post=3)
    Fj, Sj = _operators(J, sj, 2.5)
    Ft, St = _operators(T, st, 2.5)
    mu = 0.5 * np.exp(-2j * np.pi * np.arange(3) / 5)
    Akj = (Fj.astype(jnp.complex128)[None]
           + jnp.asarray(mu)[:, None, None, None] * Sj[None])
    Akt = (Ft.to(torch.complex128)[None]
           + torch.as_tensor(mu)[:, None, None, None] * St[None])
    pj = jax.vmap(cj.build)(Akj)
    pt = ct.build(Akt)
    _compare_params(pj, pt)
    rng = np.random.default_rng(9)
    b = (rng.standard_normal((3,) + sj.grid_shape)
         + 1j * rng.standard_normal((3,) + sj.grid_shape))
    b[:, np.asarray(bj.mask)] = 0.0
    close(cj.apply(pj, jnp.asarray(b), cycles=2),
          ct.apply(pt, torch.as_tensor(b), cycles=2))


def test_multigrid_solves_poisson():
    _, st = _spaces(32)
    u, v = T.TrialFunction(st), T.TestFunction(st)
    A = T.assemble(T.inner(T.grad(u), T.grad(v)) * T.dx)
    bc = T.DirichletBC(st, 0.0)
    mg = tm.Multigrid(A, bc.mask, coarse_max_dofs=100)
    from control_tpu_torch.ops.local_op import MaskedOp
    Am = MaskedOp(A, bc.mask)
    rng = np.random.default_rng(10)
    b = torch.as_tensor(rng.standard_normal(st.grid_shape))
    b = torch.where(bc.mask, 0.0, b)
    x = torch.zeros_like(b)
    for _ in range(8):
        x = x + mg.solve(b - Am.apply(x))
    assert float((b - Am.apply(x)).norm() / b.norm()) < 1e-6


# ---------------------------------------------------------------------------
# block algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["apply_T_1", "apply_T_2", "apply_T_1_inv",
                                "apply_T_2_inv"])
def test_time_transforms(fn):
    x = np.random.default_rng(12).standard_normal((7, 4, 5))
    close(getattr(jb, fn)(jnp.asarray(x)), getattr(tb, fn)(torch.as_tensor(x)))


@pytest.mark.parametrize("method", ["correct_soln", "post_mult_correct_lhs",
                                    "pc_post_mult_correct"])
@pytest.mark.parametrize("ns", ["dirichlet", "constant", "none", "full"])
def test_nullspaces(method, ns):
    sj, st = _spaces(4)
    make = {"dirichlet": (lambda: jb.DirichletBCNullspace(
                              J.DirichletBC(sj, 0.0, 1)),
                          lambda: tb.DirichletBCNullspace(
                              T.DirichletBC(st, 0.0, 1))),
            "constant": (jb.ConstantNullspace, tb.ConstantNullspace),
            "none": (jb.NoneNullspace, tb.NoneNullspace),
            "full": (jb.FullNullspace, tb.FullNullspace)}[ns]
    nj, nt = make[0](), make[1]()
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3,) + sj.grid_shape)
    y = rng.standard_normal((3,) + sj.grid_shape)
    extra = () if method == "correct_soln" else (y,)
    ref = jb._apply_per_block((nj,) * 3, method, jnp.asarray(x),
                              *[jnp.asarray(e) for e in extra])
    got = tb._apply_per_block((nt,) * 3, method, torch.as_tensor(x),
                              *[torch.as_tensor(e) for e in extra])
    close(ref, got)


def test_solver_parameters_are_validated():
    sj, st = _spaces(2)
    sys_t = tb.MultiBlockSystem(st, st, {}, {}, {}, {})
    with pytest.raises(ValueError, match="unknown solver_parameters"):
        sys_t.solve_fn({"linear_solver": "gmres", "gmres_restartt": 5})
    with pytest.raises(ValueError):
        sys_t.solve_fn({"linear_solver": "fgmres", "pc_side": "left"})
    with pytest.raises(ValueError):
        sys_t.solve_fn({"linear_solver": "cg"})


def test_multiblock_system_mult_matches_reference():
    """A CN-shaped block operator with Dirichlet nullspaces."""
    sj, st = _spaces(4)
    Fj, Sj = _operators(J, sj, 1.5)
    Ft, St = _operators(T, st, 1.5)
    n = 4

    def blocks(mod, lo, F, S, sp):
        b00 = {(i, i): lo(F, sp, sp) for i in range(n)}
        b01 = {(i, i + 1): lo(S, sp, sp) for i in range(n - 1)}
        b10 = {(i + 1, i): lo(S.swapaxes(-1, -2) if mod is J
                              else S.transpose(-1, -2), sp, sp)
               for i in range(n - 1)}
        b11 = {(i, i): lo(2.0 * F, sp, sp) for i in range(n)}
        return b00, b01, b10, b11

    from control_tpu.ops.local_op import LocalOp as JL
    from control_tpu_torch.ops.local_op import LocalOp as TL
    nsj = (jb.DirichletBCNullspace(J.DirichletBC(sj, 0.0)),) * n
    nst = (tb.DirichletBCNullspace(T.DirichletBC(st, 0.0)),) * n
    mj = jb.MultiBlockSystem(sj, sj, *blocks(J, JL, Fj, Sj, sj),
                             n_blocks_00=n, n_blocks_11=n, nullspace_0=nsj,
                             nullspace_1=nsj, CN=True)
    mt = tb.MultiBlockSystem(st, st, *blocks(T, TL, Ft, St, st),
                             n_blocks_00=n, n_blocks_11=n, nullspace_0=nst,
                             nullspace_1=nst, CN=True)
    rng = np.random.default_rng(14)
    x0 = rng.standard_normal((n,) + sj.grid_shape)
    x1 = rng.standard_normal((n,) + sj.grid_shape)
    yj = mj.mult(jnp.asarray(x0), jnp.asarray(x1))
    yt = mt.mult(torch.as_tensor(x0), torch.as_tensor(x1))
    close(yj[0], yt[0])
    close(yj[1], yt[1])
    b01j, b01t = blocks(J, JL, Fj, Sj, sj)[1], blocks(T, TL, Ft, St, st)[1]
    close(jb.BlockAction(b01j, n, n, sj, sj).apply(jnp.asarray(x1)),
          tb.BlockAction(b01t, n, n, st, st).apply(torch.as_tensor(x1)))

    # the whole solve, unpreconditioned GMRES: same iterations and solution
    sp = {"linear_solver": "gmres", "gmres_restart": 10,
          "maximum_iterations": 200, "relative_tolerance": 1e-9,
          "monitor_convergence": False}
    mask = np.asarray(J.DirichletBC(sj, 0.0).mask)
    b0 = np.where(mask, 0.0, x0)
    b1 = np.where(mask, 0.0, x1)
    ij = mj.solve(np.zeros_like(b0), np.zeros_like(b1), jnp.asarray(b0),
                  jnp.asarray(b1), solver_parameters=sp)
    ut0 = T.MixedFunction(st, n)
    ut1 = T.MixedFunction(st, n)
    it = mt.solve(ut0, ut1, torch.as_tensor(b0), torch.as_tensor(b1),
                  solver_parameters=sp)
    assert it.iterations == ij.iterations and it.converged
    k = ij.iterations + 1
    close(ij.res_norms[:k], it.res_norms[:k], tol=1e-10)

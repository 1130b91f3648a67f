"""Instationary Stokes control (Taylor-Hood Q2-Q1, Crank-Nicolson, the
nested preconditioner with the default ``scan`` sweeps): the port against
the JAX package, in float64 on the CPU.

* K4's plain version (``_cheb_plain`` on vector stencils) against the JAX
  package's shifted-add path (``fused_cheb_smooth(use_pallas=False)``) and
  against the TPU kernel ``_fused_cheb_vector`` in Pallas interpret mode:
  per-batch weights with per-batch bounds, shared weights on a batch (the
  mass solve's layout), unbatched; degree 1 and 2; with and without the
  residual; tolerance 1e-12 relative (one float64 recurrence, summed in
  another order);
* vector node stencils, their application, diagonal and row sums: 1e-13;
* Q2 and vector transfers (the gather/scatter path), Galerkin coarsening
  and a two-level V-cycle with ``levels=2`` forced (at test sizes the
  velocity space is below ``coarse_max_dofs`` and would have no smoothed
  level): 1e-12;
* the vector mass and stiffness operators and the rectangular divergence
  operators B, B^T: 1e-13;
* the incompressible system's ``mult`` and one application of its nested
  ``pc_fn`` on seeded vectors: 1e-10 (the dense inverse of the regularised
  pressure stiffness, condition number ~1e6, differs by 4e-11 between the
  two LAPACK paths);
* the slice as a whole at 4^2 x 4, FGMRES(10), rtol 1e-6: both packages
  take 20 iterations; the residual histories agree within 1e-9 of the
  initial residual (entry by entry the tail drifts to 4e-8 of its own
  size, the amplified difference of the two coarse inverses), v and zeta
  within 1e-9, p and mu (means removed) within 1e-8;
* the Crank-Nicolson exact-solution case of
  ``tests/test_instationary_stokes.py`` in the port alone.

One JAX reference solve serves the whole file (it costs about a minute of
compilation).  The tests marked ``gpu`` hold the CUDA kernel K4 against its
plain version on the card, every variant its C entry point picks by shape
among them, and skip elsewhere.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import control_tpu as J
import control_tpu_torch as T
from control_tpu.models import common as jc
from control_tpu.ops import stencil as js
from control_tpu.solvers import multigrid as jm
from control_tpu_torch.models import common as tc
from control_tpu_torch.ops import stencil as ts
from control_tpu_torch.solvers import multigrid as tm
from control_tpu_torch.utils import convert

TOL = 1e-12
N, N_T = 4, 4
LAMBDA_V, LAMBDA_P = (0.25, 1.5625), (0.25, 2.25)
SOLVER_PARAMETERS = {"linear_solver": "fgmres", "fgmres_restart": 10,
                     "maximum_iterations": 100, "relative_tolerance": 1.0e-6,
                     "absolute_tolerance": 0.0, "monitor_convergence": False}


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


def meshes(n):
    return (J.UnitSquareMesh(n, n, quadrilateral=True, dtype="float64"),
            T.UnitSquareMesh(n, n, quadrilateral=True, dtype="float64",
                             device="cpu"))


def space_pair(n, kind):
    """The same space in both packages: "vector_q2" (the velocity),
    "vector_q1", "scalar_q2", "scalar_q1" (the pressure)."""
    deg = 2 if kind.endswith("q2") else 1
    mj, mt = meshes(n)
    if kind.startswith("vector"):
        return (J.VectorFunctionSpace(mj, "Lagrange", deg),
                T.VectorFunctionSpace(mt, "Lagrange", deg))
    return (J.FunctionSpace(mj, "Lagrange", deg),
            T.FunctionSpace(mt, "Lagrange", deg))


def coupled_form(mod, sp):
    """A form that couples the components on a vector space (grad-div) and
    varies in space, so that no stencil block is trivially diagonal."""
    u, v = mod.TrialFunction(sp), mod.TestFunction(sp)
    X = mod.SpatialCoordinate(sp.mesh)
    form = ((1.0 + X[0] * X[1]) * mod.inner(u, v) * mod.dx
            + mod.inner(mod.grad(u), mod.grad(v)) * mod.dx)
    if sp.dim is not None:
        form = form + mod.inner(mod.div(u), mod.div(v)) * mod.dx
    return form


def bc_mask(mod, sp):
    value = 0.0 if sp.dim is None else (0.0,) * sp.dim
    return mod.DirichletBC(sp, value, "on_boundary").mask


# ---------------------------------------------------------------------------
# fem on the Taylor-Hood pair
# ---------------------------------------------------------------------------

def stokes_forms(mod, sv, sp):
    vt, vs = mod.TrialFunction(sv), mod.TestFunction(sv)
    pt, ps = mod.TrialFunction(sp), mod.TestFunction(sp)
    return {"mass": mod.inner(vt, vs) * mod.dx,
            "stiffness": mod.inner(mod.grad(vt), mod.grad(vs)) * mod.dx,
            "B": -mod.inner(mod.div(vt), ps) * mod.dx,
            "B_T": -mod.inner(pt, mod.div(vs)) * mod.dx}


@pytest.mark.parametrize("form", ["mass", "stiffness", "B", "B_T"])
def test_taylor_hood_local_operators(form):
    """The vector mass and stiffness and the rectangular divergence
    operators (trial and test spaces differ): arrays and actions."""
    svj, svt = space_pair(N, "vector_q2")
    spj, spt = space_pair(N, "scalar_q1")
    Aj = J.assemble(stokes_forms(J, svj, spj)[form])
    At = T.assemble(stokes_forms(T, svt, spt)[form])
    assert tuple(At.A.shape) == {"mass": (1, 18, 18),
                                 "stiffness": (1, 18, 18), "B": (1, 4, 18),
                                 "B_T": (1, 18, 4)}[form]
    close(Aj.A, At.A, 1e-13)
    trial = spj if form == "B_T" else svj
    x = np.random.default_rng(1).standard_normal((3,) + trial.grid_shape)
    yt = At.apply(torch.as_tensor(x))
    test = spt if form == "B" else svt
    assert tuple(yt.shape) == (3,) + test.grid_shape
    close(Aj.apply(jnp.asarray(x)), yt, 1e-13)


def test_vector_gather_scatter():
    sj, st = space_pair(N, "vector_q2")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2,) + sj.grid_shape)
    close(sj.gather(jnp.asarray(x)), st.gather(torch.as_tensor(x)), 0.0)
    r = rng.standard_normal((2, sj.mesh.n_cells, sj.nloc))
    close(sj.scatter_add(jnp.asarray(r)), st.scatter_add(torch.as_tensor(r)),
          1e-13)


def test_vector_interpolate_and_bcs():
    """``interpolate`` of a tuple, the (ny, nx, 2) Dirichlet mask,
    ``combine_masks`` and ``homogenize`` on the vector space."""
    from control_tpu.fem import space as jsp
    from control_tpu_torch.fem import space as tsp
    sj, st = space_pair(N, "vector_q2")

    def profile(mod, sp):
        X = mod.SpatialCoordinate(sp.mesh)
        return (0.2 * mod.sin(mod.pi * X[0]) * mod.sin(mod.pi * X[1]),
                0.1 * mod.sin(2 * mod.pi * X[0]) * mod.sin(mod.pi * X[1]))

    fj = J.Function(sj).interpolate(profile(J, sj))
    ft = T.Function(st).interpolate(profile(T, st))
    assert tuple(ft.data.shape) == (2 * N + 1, 2 * N + 1, 2)
    close(fj.data, ft.data, 1e-13)
    bj = [J.DirichletBC(sj, (1.0, 2.0), 1), J.DirichletBC(sj, (0.0, 0.0), 4)]
    bt = [T.DirichletBC(st, (1.0, 2.0), 1), T.DirichletBC(st, (0.0, 0.0), 4)]
    mj, mt = jsp.combine_masks(sj, bj), tsp.combine_masks(st, bt)
    assert tuple(mt.shape) == st.grid_shape
    assert (np.asarray(mj) == mt.numpy()).all() and mt.any()
    assert all(b.is_homogeneous for b in tsp.homogenize(bt))
    close(bj[0].apply(fj.data), bt[0].apply(ft.data), 0.0)


# ---------------------------------------------------------------------------
# vector node stencils
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["vector_q1", "vector_q2"])
@pytest.mark.parametrize("masked", [True, False])
def test_node_stencil_vector(kind, masked):
    sj, st = space_pair(N, kind)
    Aj = J.assemble(coupled_form(J, sj))
    At = T.assemble(coupled_form(T, st))
    mask_j = bc_mask(J, sj) if masked else None
    mask_t = bc_mask(T, st) if masked else None
    wj = js.node_stencil(Aj.A, sj, mask=mask_j, alpha=2.5)
    wt = ts.node_stencil(At.A, st, mask=mask_t, alpha=2.5)
    K = (2 * st.degree + 1) ** 2
    assert tuple(wt.shape) == (K,) + st.node_grid + (2, 2)
    close(wj, wt, 1e-13)
    close(js.stencil_diag(wj, True), ts.stencil_diag(wt, True), 1e-13)
    close(js.stencil_abs_rowsum(wj, True), ts.stencil_abs_rowsum(wt, True),
          1e-13)
    # the stencil applies the same operator as the local matrices
    x = np.random.default_rng(3).standard_normal((2,) + st.grid_shape)
    if masked:
        x[:, np.asarray(mask_j)] = 0.0
    ref = Aj.apply(jnp.asarray(x))
    if masked:
        ref = jnp.where(mask_j, 2.5 * jnp.asarray(x), ref)
    got = ts.apply_stencil(wt, torch.as_tensor(x), st.degree)
    close(ref, got, 1e-13)
    close(js.apply_stencil(wj, jnp.asarray(x), sj.degree), got, 1e-13)


@pytest.mark.parametrize("nd,degree,grid", [(3, 1, (4, 5, 6)),
                                            (2, 2, (6, 7)),
                                            (3, 2, (5, 5, 6))])
@pytest.mark.parametrize("layout", ["unbatched", "shared_on_batch",
                                    "per_batch", "shared_lead"])
def test_vector_apply_plain_matches_reference(nd, degree, grid, layout):
    """The vector application in 2-D and 3-D over the batch layouts the
    callers use, against the JAX package's shifted multiply-adds."""
    wlead, xlead = {"unbatched": ((), ()), "shared_on_batch": ((), (2,)),
                    "per_batch": ((2,), (2,)),
                    "shared_lead": ((1,), (3,))}[layout]
    rng = np.random.default_rng(21)
    K = (2 * degree + 1) ** nd
    w = rng.standard_normal(wlead + (K,) + grid + (nd, nd))
    x = rng.standard_normal(xlead + grid + (nd,))
    ref = js._apply_xla(jnp.asarray(w), jnp.asarray(x), degree, nd=nd)
    got = ts.apply_stencil(torch.as_tensor(w), torch.as_tensor(x), degree,
                           nd=nd)
    close(ref, got, 1e-13)


def test_stencil_op_on_vector_space():
    from control_tpu_torch.ops.local_op import MaskedOp
    _, st = space_pair(N, "vector_q2")
    At = T.assemble(coupled_form(T, st))
    Am = MaskedOp(At, bc_mask(T, st))
    S = ts.StencilOp.from_local(Am)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (3,) + st.grid_shape))
    close(Am.apply(x), S.apply(x), 1e-13)
    close(Am.diag(), S.diag(), 1e-13)
    assert tuple(S.abs_rowsum().shape) == st.grid_shape


# ---------------------------------------------------------------------------
# K4's plain version against the JAX package
# ---------------------------------------------------------------------------

# layout: (weight lead, field lead, per-batch bounds)
VECTOR_LAYOUTS = {"per_batch": ((3,), (3,), True),
                  "shared_on_batch": ((), (3,), False),
                  "unbatched": ((), (), False)}


def vector_cheb_inputs(rng, layout, degree, ny=7, nx=9):
    wlead, blead, vec = VECTOR_LAYOUTS[layout]
    K = (2 * degree + 1) ** 2
    w = rng.standard_normal(wlead + (K, ny, nx, 2, 2))
    # a shared dinv on the shared layouts (the mass solve's), else per batch
    dinv = 0.1 * rng.standard_normal((blead if wlead else ()) + (ny, nx, 2))
    b = rng.standard_normal(blead + (ny, nx, 2))
    x0 = rng.standard_normal(blead + (ny, nx, 2))
    if vec:
        theta = rng.uniform(1.0, 2.0, blead)
        delta = rng.uniform(0.3, 0.8, blead)
    else:
        theta, delta = 1.3, 0.6
    return w, dinv, b, x0, theta, delta


@pytest.mark.parametrize("layout", sorted(VECTOR_LAYOUTS))
@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("want_residual", [True, False])
def test_cheb_vector_plain_matches_reference(layout, degree, want_residual):
    """The port's plain version against the JAX package's shifted-add path
    and, where the residual is asked for, against the TPU kernel in
    interpret mode (it computes x and r in every call, so those cases hold
    both outputs; tracing its K * steps unrolled offsets is what costs time
    here, hence two steps at degree 2)."""
    rng = np.random.default_rng(13 + degree)
    w, dinv, b, x0, theta, delta = vector_cheb_inputs(rng, layout, degree)
    steps = 4 if degree == 1 else 2

    def to_j(a):
        return jnp.asarray(a)

    def to_t(a):
        return torch.as_tensor(a) if isinstance(a, np.ndarray) else a

    got = ts.fused_cheb_smooth(to_t(w), to_t(dinv), to_t(b), to_t(x0), steps,
                               to_t(theta), to_t(delta), degree,
                               want_residual=want_residual)
    ref = js.fused_cheb_smooth(to_j(w), to_j(dinv), to_j(b), to_j(x0), steps,
                               to_j(theta), to_j(delta), degree,
                               want_residual=want_residual, use_pallas=False)
    if not want_residual:
        close(ref, got)
        return
    for g, r in zip(got, ref):
        close(r, g)
    if layout == "shared_on_batch":
        return      # the TPU kernel broadcasts it to the per-batch layout
    tpu = js._fused_cheb_vector(to_j(w), to_j(dinv), to_j(b), to_j(x0),
                                steps, to_j(theta), to_j(delta), degree,
                                want_residual=True, interpret=True)
    for g, p in zip(got, tpu):
        close(p, g)


def test_cheb_vector_cpu_counts_no_launch():
    """A CPU tensor runs the plain version: no launch is counted."""
    rng = np.random.default_rng(5)
    w, dinv, b, x0, theta, delta = vector_cheb_inputs(rng, "unbatched", 1)
    before = dict(ts.launch_counts)
    assert "cheb_smooth_vector" in before
    ts.fused_cheb_smooth(*map(torch.as_tensor, (w, dinv, b, x0)), 2, theta,
                         delta, 1)
    ts.apply_stencil(torch.as_tensor(w), torch.as_tensor(b), 1)
    assert ts.launch_counts == before


@pytest.mark.parametrize("case", ["complex", "dim3", "grid3d", "two_batch",
                                  "degree3"])
def test_cheb_vector_cuda_wrapper_refuses(case):
    """What K4 does not cover raises before any launch (the JAX package
    has no TPU kernel there either); nothing falls back to the plain
    version on the card."""
    dt = torch.complex128 if case == "complex" else torch.float64
    dim = 3 if case == "dim3" else 2
    lead = (2, 3) if case == "two_batch" else (3,)
    nd = 3 if case == "grid3d" else 2
    grid = (5,) * nd
    degree = 3 if case == "degree3" else 1
    K = (2 * degree + 1) ** nd
    w = torch.zeros((K,) + grid + (dim, dim), dtype=dt)
    b = torch.zeros(lead + grid + (dim,), dtype=dt)
    with pytest.raises(NotImplementedError):
        ts._cheb_vector_cuda(w, b, b, b, 2, 1.0, 0.5, degree, False, nd)


# ---------------------------------------------------------------------------
# Q2 and vector multigrid
# ---------------------------------------------------------------------------

TRANSFER_KINDS = ["vector_q2", "scalar_q2", "vector_q1"]


@pytest.mark.parametrize("kind", TRANSFER_KINDS + ["scalar_q1"])
def test_index_maps_equal_space_gather_scatter(kind):
    """The transfers gather and scatter with one indexing operation each;
    both equal the space's strided-slice ``gather`` / ``scatter_add``."""
    _, st = space_pair(N, kind)
    gi, si = tm._index_maps(st, "cpu")
    assert tuple(gi.shape) == (st.mesh.n_cells, st.nloc)
    assert tuple(si.shape) == (st.n_dofs, 4)
    rng = np.random.default_rng(20)
    x = torch.as_tensor(rng.standard_normal((3,) + st.grid_shape))
    assert torch.equal(tm._gather(gi, x, st), st.gather(x))
    r = torch.as_tensor(rng.standard_normal((3, st.mesh.n_cells, st.nloc)))
    close(st.scatter_add(r), tm._scatter_add(si, r, st), 1e-14)


@pytest.mark.parametrize("kind", TRANSFER_KINDS)
def test_transfer_prolong(kind):
    sj, st = space_pair(N, kind)
    trj, trt = jm.Transfer(sj), tm.Transfer(st)
    xc = np.random.default_rng(6).standard_normal(
        (2,) + trj.coarse.grid_shape)
    got = trt.prolong(torch.as_tensor(xc))
    assert tuple(got.shape) == (2,) + st.grid_shape
    close(trj.prolong(jnp.asarray(xc)), got)


@pytest.mark.parametrize("kind", TRANSFER_KINDS)
def test_transfer_restrict(kind):
    sj, st = space_pair(N, kind)
    trj, trt = jm.Transfer(sj), tm.Transfer(st)
    rf = np.random.default_rng(7).standard_normal((2,) + sj.grid_shape)
    got = trt.restrict(torch.as_tensor(rf))
    assert tuple(got.shape) == (2,) + trt.coarse.grid_shape
    close(trj.restrict(jnp.asarray(rf)), got)
    # restriction is the transpose of prolongation
    xc = torch.as_tensor(np.random.default_rng(8).standard_normal(
        trt.coarse.grid_shape))
    lhs = float((trt.prolong(xc) * torch.as_tensor(rf[0])).sum())
    rhs = float((xc * got[0]).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("kind", TRANSFER_KINDS)
def test_transfer_galerkin(kind):
    sj, st = space_pair(N, kind)
    Aj = J.assemble(coupled_form(J, sj)).A
    At = T.assemble(coupled_form(T, st)).A
    close(jm.Transfer(sj).galerkin(Aj), tm.Transfer(st).galerkin(At))


@pytest.mark.parametrize("masked", [True, False])
def test_vector_q2_two_level_vcycle(masked):
    """``MGConfig(space_v, mask, levels=2)``: the hierarchy (stencils,
    diagonals, Gershgorin bounds, coarse inverse) and one V-cycle, whose
    fine level smooths with K4's plain version."""
    sj, st = space_pair(N, "vector_q2")
    Aj = J.assemble(coupled_form(J, sj)).A
    At = T.assemble(coupled_form(T, st)).A
    mask_j = bc_mask(J, sj) if masked else None
    mask_t = bc_mask(T, st) if masked else None
    cj = jm.MGConfig(sj, mask_j, levels=2)
    ct = tm.MGConfig(st, mask_t, levels=2)
    assert len(ct.spaces) == 2 and ct.spaces[1].grid_shape == (5, 5, 2)
    pj, pt = cj.build(Aj), ct.build(At)
    for key in ("Ws", "diags", "dinvs"):
        for a, b in zip(pj[key], pt[key]):
            close(a, b)
    close(pj["lams"], pt["lams"])
    close(pj["Ainv"], pt["Ainv"], 1e-11)
    b = np.random.default_rng(9).standard_normal(sj.grid_shape)
    if masked:
        b[np.asarray(mask_j)] = 0.0
    got = ct.apply(pt, torch.as_tensor(b))
    close(cj.apply(pj, jnp.asarray(b)), got, 1e-11)
    # a batch of right-hand sides runs as a batch
    bb = np.stack([b, 2.0 * b])
    close(np.stack([got.numpy(), 2.0 * got.numpy()]),
          ct.apply(pt, torch.as_tensor(bb)), 1e-12)


# ---------------------------------------------------------------------------
# per-block solvers
# ---------------------------------------------------------------------------

def test_regularized_stiffness():
    spj, spt = space_pair(N, "scalar_q1")

    def ops(mod, sp):
        u, v = mod.TrialFunction(sp), mod.TestFunction(sp)
        return (mod.assemble(mod.inner(mod.grad(u), mod.grad(v)) * mod.dx),
                mod.assemble(mod.inner(u, v) * mod.dx))

    close(jc.regularized_stiffness(*ops(J, spj)).A,
          tc.regularized_stiffness(*ops(T, spt)).A, 1e-13)


@pytest.mark.parametrize("kind", ["vector_q2", "scalar_q1"])
def test_mass_solver(kind):
    """The Chebyshev mass solve on the velocity space (masked; K4's plain
    version) and on the pressure space (``mask=None``; K2's)."""
    sj, st = space_pair(N, kind)
    masked = kind == "vector_q2"

    def mass(mod, sp):
        return mod.assemble(mod.inner(mod.TrialFunction(sp),
                                      mod.TestFunction(sp)) * mod.dx)

    bounds = LAMBDA_V if masked else LAMBDA_P
    solj = jc.mass_solver(mass(J, sj), bc_mask(J, sj) if masked else None,
                          False, bounds)
    solt = tc.mass_solver(mass(T, st), bc_mask(T, st) if masked else None,
                          False, bounds)
    b = np.random.default_rng(10).standard_normal((3,) + sj.grid_shape)
    close(solj(jnp.asarray(b)), solt(torch.as_tensor(b)))


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def stokes_problem(mod, n=N, n_t=N_T, CN=True, data=True, **kw):
    """The Stokes control problem of ``bench_extra.py`` (Taylor-Hood Q2-Q1,
    beta = 1e-2, zero Dirichlet velocity); ``data=False`` leaves the
    desired state zero (the exact-solution test supplies the rhs)."""
    mesh = mod.UnitSquareMesh(n, n, quadrilateral=True, dtype="float64",
                              **kw)
    space_v = mod.VectorFunctionSpace(mesh, "Lagrange", 2)
    space_p = mod.FunctionSpace(mesh, "Lagrange", 1)
    X = mod.SpatialCoordinate(mesh)

    def fdo(trial, test, u, t):
        return mod.inner(mod.grad(trial), mod.grad(test)) * mod.dx

    def ds_(test, t):
        v_d = mod.Function(space_v)
        if data:
            v_d.interpolate(
                (0.2 * mod.sin(mod.pi * X[0]) * mod.sin(mod.pi * X[1]),
                 0.1 * mod.sin(2 * mod.pi * X[0]) * mod.sin(mod.pi * X[1])))
        return mod.inner(v_d, test) * mod.dx, v_d

    def ff(test, t):
        return mod.inner(mod.Function(space_v), test) * mod.dx

    def bc_t(s, t):
        return mod.DirichletBC(s, (0.0, 0.0), "on_boundary")

    return mod.Control.Instationary(
        space_v, fdo, desired_state=ds_, force_f=ff, beta=1e-2,
        space_p=space_p, n_t=n_t, time_interval=(0.0, 1.0), CN=CN,
        bcs_v=bc_t)


def solve_kw(**extra):
    return dict(lambda_v_bounds=LAMBDA_V, lambda_p_bounds=LAMBDA_P,
                solver_parameters=SOLVER_PARAMETERS, print_error=False,
                create_output=False, **extra)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's solve (its fused path, the CPU default) and the
    pieces of the same problem object."""
    ctl = stokes_problem(J)
    ctl._host_loop = False
    info = ctl.incompressible_linear_solve(J.ConstantNullspace(),
                                           plots=False, **solve_kw())
    state = {k: np.asarray(getattr(ctl, "_" + k).data)
             for k in ("v", "zeta", "p", "mu")}
    pieces = ctl.incompressible_linear_solve(
        J.ConstantNullspace(), plots=False, _return_pieces=True,
        **solve_kw())
    return info, state, pieces


@pytest.fixture(scope="module")
def ported():
    ctl = stokes_problem(T, device="cpu")
    info = ctl.incompressible_linear_solve(T.ConstantNullspace(),
                                           **solve_kw())
    pieces = stokes_problem(T, device="cpu").incompressible_linear_solve(
        T.ConstantNullspace(), _return_pieces=True, **solve_kw())
    return ctl, info, pieces


def seeded(shape, seed):
    return np.random.default_rng(seed).standard_normal(tuple(shape))


def test_stokes_rhs(reference, ported):
    _, _, (_, _, b0j, b1j) = reference
    _, _, (_, _, b0t, b1t) = ported
    n = N_T - 1
    assert tuple(b0t.shape) == (2 * n, 2 * N + 1, 2 * N + 1, 2)
    assert tuple(b1t.shape) == (2 * n, N + 1, N + 1)
    close(b0j, b0t, 1e-13)
    assert float(np.abs(np.asarray(b1j)).max()) == 0.0
    assert float(b1t.abs().max()) == 0.0


def test_stokes_system_mult(reference, ported):
    """The 2n + 2n block operator with the CN T-transforms on each half and
    one ``ConstantNullspace`` per pressure block."""
    _, _, (sysj, _, b0j, b1j) = reference
    _, _, (syst, _, _, _) = ported
    x0, x1 = seeded(b0j.shape, 11), seeded(b1j.shape, 12)
    yj = sysj.mult(jnp.asarray(x0), jnp.asarray(x1))
    yt = syst.mult(torch.as_tensor(x0), torch.as_tensor(x1))
    close(yj[0], yt[0], 1e-10)
    close(yj[1], yt[1], 1e-10)


def test_stokes_pc_application(reference, ported):
    """One application of the nested preconditioner: five inner GMRES
    iterations on the velocity KKT system, the pressure Schur part."""
    _, _, (_, pcj, b0j, b1j) = reference
    _, _, (_, pct, _, _) = ported
    x0, x1 = seeded(b0j.shape, 13), seeded(b1j.shape, 14)
    yj = pcj(jnp.asarray(x0), jnp.asarray(x1))
    yt = pct(torch.as_tensor(x0), torch.as_tensor(x1))
    close(yj[0], yt[0], 1e-10)
    close(yj[1], yt[1], 1e-10)


def test_stokes_pc_state(reference, ported):
    """The preconditioner's derived tensors; the JAX state, carried across
    by ``utils.convert``, has the port's layout."""
    _, _, (_, pcj, _, _) = reference
    ctl, _, (_, pct, _, _) = ported
    sj = convert.to_torch(jax.tree_util.tree_map(np.asarray, pcj.state),
                          ctl._space_v)
    st = pct.state
    assert set(sj) == set(st) == {"inner", "K_p", "M_p"}
    close(sj["inner"]["solver_0"]["w"], st["inner"]["solver_0"]["w"], 1e-13)
    close(sj["M_p"]["w"], st["M_p"]["w"], 1e-13)
    close(sj["K_p"]["Ws"][0], st["K_p"]["Ws"][0], 1e-13)
    # the dense inverse of the regularised pressure stiffness: condition
    # number ~1e6, two LAPACK paths
    close(sj["K_p"]["Ainv"], st["K_p"]["Ainv"], 1e-9)
    for side in ("fwd", "bwd"):
        close(sj["inner"][side]["sub"], st["inner"][side]["sub"], 1e-13)
        close(sj["inner"][side]["params"]["Ainv"],
              st["inner"][side]["params"]["Ainv"], 1e-11)


def test_stokes_iterations_and_history(reference, ported):
    ij, _, _ = reference
    _, it, _ = ported
    assert ij.converged and it.converged
    assert it.iterations == ij.iterations == 20
    k = ij.iterations + 1
    hj, ht = np.asarray(ij.res_norms[:k]), it.res_norms[:k]
    # within 1e-9 of the initial residual (entry by entry the tail, eight
    # orders below it, drifts to ~4e-8 of its own size: the two coarse
    # inverses of the regularised pressure stiffness differ by 4e-11)
    assert float(np.max(np.abs(hj - ht)) / hj[0]) < 1e-9
    assert float(np.max(np.abs(hj - ht) / hj)) < 1e-6
    assert it.rnorm / it.rnorm0 < 1e-6


@pytest.mark.parametrize("name,tol", [("v", 1e-9), ("zeta", 1e-9)])
def test_stokes_velocity_state(reference, ported, name, tol):
    _, state, _ = reference
    ctl, _, _ = ported
    got = getattr(ctl, "_" + name).data
    assert tuple(got.shape) == (N_T, 2 * N + 1, 2 * N + 1, 2)
    close(state[name], got, tol)


@pytest.mark.parametrize("name,tol", [("p", 1e-8), ("mu", 1e-8)])
def test_stokes_pressure_state(reference, ported, name, tol):
    """p and mu, each block with its mean removed (the pressure is fixed up
    to a constant)."""
    _, state, _ = reference
    ctl, _, _ = ported
    got = getattr(ctl, "_" + name).data.numpy()
    assert got.shape == (N_T - 1, N + 1, N + 1)

    def mean_free(a):
        return a - a.mean(axis=(1, 2), keepdims=True)

    close(mean_free(state[name]), mean_free(got), tol)


def test_carry_state(reference):
    """``utils.convert.carry_state`` starts the port from the JAX package's
    arrays: vector (n, ny, nx, 2) stacks, p and mu."""
    _, state, _ = reference
    ctl = stokes_problem(T, device="cpu")
    convert.carry_state(ctl, **state)
    for k, a in state.items():
        got = getattr(ctl, "_" + k).data
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        close(a, got, 0.0)
    with pytest.raises(ValueError):
        convert.carry_state(ctl, p=state["v"])


def test_stokes_with_exact_sol():
    """The Crank-Nicolson case of the JAX package's exact-solution test
    (``tests/test_instationary_stokes.py``), in the port alone: a
    manufactured algebraic space-time Stokes-KKT solution, the four
    right-hand sides built by hand from M/K/B actions and passed as
    ``v_d``/``f``/``div_v``/``div_zeta``, solved to rtol 1e-14 and checked
    to 1e-12 (velocities) and 1e-11 (pressures, means removed)."""
    n_t, beta = 4, 1e-2
    ctl = stokes_problem(T, n=4, n_t=n_t, data=False, device="cpu")
    space_v, space_p = ctl._space_v, ctl._space_p
    X = T.SpatialCoordinate(space_v.mesh)
    tau = 1.0 / (n_t - 1.0)
    n = n_t - 1

    def smooth_v(k):
        return ((0.1 * k) * T.sin(T.pi * X[0]) * T.sin(2 * T.pi * X[1]),
                (0.05 * k) * T.sin(3 * T.pi * X[0]) * T.sin(T.pi * X[1]))

    def smooth_p(k):
        return (0.1 * k) * (T.cos(T.pi * X[0]) * T.sin(T.pi * X[1]) + X[0])

    bcmask = T.DirichletBC(space_v, (0.0, 0.0), "on_boundary").mask
    ud, wd, pd, md = [], [], [], []
    for i in range(n):
        uf = T.Function(space_v).interpolate(smooth_v(i + 1)).data
        ud.append(torch.where(bcmask, 0.0, uf))
        wf = T.Function(space_v).interpolate(smooth_v(2 * i + 1)[::-1]).data
        wd.append(torch.where(bcmask, 0.0, wf))
        pf = T.Function(space_p).interpolate(smooth_p(i + 1)).data
        pd.append(pf - pf.mean())
        mf = T.Function(space_p).interpolate(smooth_p(3 * i + 2)).data
        md.append(mf - mf.mean())

    tr, te = T.TrialFunction(space_v), T.TestFunction(space_v)
    ptr, pte = T.TrialFunction(space_p), T.TestFunction(space_p)
    M = T.assemble(T.inner(tr, te) * T.dx)
    K = T.assemble(T.inner(T.grad(tr), T.grad(te)) * T.dx)
    B = T.assemble(-T.inner(T.div(tr), pte) * T.dx)
    B_T = T.assemble(-T.inner(ptr, T.div(te)) * T.dx)

    r00, r01, r10, r11 = [], [], [], []
    for i in range(n):
        a = (0.5 * tau * M.apply(ud[i]) + 0.5 * tau * K.apply(wd[i])
             + M.apply(wd[i]) + tau * B_T.apply(md[i]))
        if i >= 1:
            a = a + 0.5 * tau * M.apply(ud[i - 1])
        if i < n - 1:
            a = a + 0.5 * tau * K.apply(wd[i + 1]) - M.apply(wd[i + 1])
        r00.append(a)
        s = (0.5 * tau * K.apply(ud[i]) + M.apply(ud[i])
             - 0.5 * (tau / beta) * M.apply(wd[i]) + tau * B_T.apply(pd[i]))
        if i >= 1:
            s = s + 0.5 * tau * K.apply(ud[i - 1]) - M.apply(ud[i - 1])
        if i < n - 1:
            s = s - 0.5 * (tau / beta) * M.apply(wd[i + 1])
        r01.append(s)
        r10.append(tau * B.apply(ud[i]))
        r11.append(tau * B.apply(wd[i]))

    def stack(space, rows):
        return T.MixedFunction(space, n, data=torch.stack(rows), dual=True)

    info = ctl.incompressible_linear_solve(
        T.ConstantNullspace(),
        solver_parameters={"linear_solver": "fgmres", "gmres_restart": 10,
                           "maximum_iterations": 100,
                           "relative_tolerance": 1.0e-14,
                           "absolute_tolerance": 1.0e-14,
                           "monitor_convergence": False},
        lambda_v_bounds=LAMBDA_V, lambda_p_bounds=LAMBDA_P,
        v_d=stack(space_v, r00), f=stack(space_v, r01),
        div_v=stack(space_p, r10), div_zeta=stack(space_p, r11),
        print_error=False)
    assert info.converged

    def mixed_l2(space, a, b):
        err2 = 0.0
        for i in range(a.shape[0]):
            d = T.Function(space, data=a[i] - b[i])
            err2 += float(T.assemble(T.inner(d, d) * T.dx))
        return np.sqrt(abs(err2))

    def mean_shift(stack_):
        return stack_ - stack_.mean(dim=(1, 2), keepdim=True)

    assert mixed_l2(space_v, ctl._v.data[1:], torch.stack(ud)) < 1e-12
    assert mixed_l2(space_v, ctl._zeta.data[:-1], torch.stack(wd)) < 1e-12
    assert mixed_l2(space_p, mean_shift(ctl._p.data),
                    mean_shift(torch.stack(pd))) < 1e-11
    assert mixed_l2(space_p, mean_shift(ctl._mu.data),
                    mean_shift(torch.stack(md))) < 1e-11


def test_stokes_create_output(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ctl = stokes_problem(T, n=2, n_t=3, device="cpu")
    ctl.incompressible_linear_solve(T.ConstantNullspace(),
                                    **{**solve_kw(), "create_output": True})
    shapes = {"v": (3, 5, 5, 2), "zeta": (3, 5, 5, 2), "p": (2, 3, 3),
              "mu": (2, 3, 3)}
    for name, shape in shapes.items():
        assert np.load(tmp_path / f"{name}.npz")["data"].shape == shape


@pytest.mark.parametrize("case", ["backward_euler", "user_pc", "refinement",
                                  "divfree_initial", "inhomogeneous",
                                  "paradiag", "nonlinear", "plots",
                                  "gauss_newton", "no_space_p"])
def test_unported_stokes_paths_raise(case):
    """What this slice leaves out raises with a clear message instead of
    computing something else."""
    ctl = stokes_problem(T, n=2, n_t=3, device="cpu")
    kw = solve_kw()
    error = NotImplementedError
    if case == "backward_euler":
        ctl._CN = False
    elif case == "user_pc":
        kw["P"] = lambda b0, b1: (b0, b1)
    elif case == "refinement":
        kw["solver_parameters"] = dict(SOLVER_PARAMETERS,
                                       iterative_refinement=2)
    elif case == "divfree_initial":
        ctl._divfree_initial = True
    elif case == "inhomogeneous":
        ctl._bcs_v[1] = (T.DirichletBC(ctl._space_v, (1.0, 0.0), 1),)
    elif case == "paradiag":
        ctl.set_schur_sweep("paradiag")
    elif case == "plots":
        kw["plots"] = True
    elif case == "gauss_newton":
        ctl._Gauss_Newton = True
    elif case == "no_space_p":
        ctl._space_p = None
        error = ValueError
    with pytest.raises(error):
        if case == "nonlinear":
            ctl.incompressible_non_linear_solve(T.ConstantNullspace())
        else:
            ctl.incompressible_linear_solve(T.ConstantNullspace(), **kw)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def card_vector_inputs(rng, nd, degree, grid, n, per_batch_w, per_batch_bounds):
    """Seeded inputs of a vector smoothing call (dim = nd) for the card.

    Every weight is random and nonzero, at the offsets that point outside
    the grid too, so a kernel that reads a neighbour it should mask (a dx
    offset wrapping into the next row, say) disagrees with the plain
    version.  The fields are zero outside the grid, so those weights drop
    out of the operator, and the centre balances the in-grid weights of
    each row: A is singular (constant fields span its null space) and the
    smoother leaves a residual of the order of b (b = 1 + noise) however
    many steps it takes, so float32's rounding stays far below the
    tolerance, where a residual that converges to nothing would not.
    Chebyshev bounds cover the upper half of the in-grid Gershgorin
    interval, scalar or one per batch entry.  n = 0 is an unbatched
    field."""
    dim = nd
    K = (2 * degree + 1) ** nd
    lead = (n,) if n else ()
    wlead = lead if per_batch_w else ()
    w = -rng.uniform(0.1, 1.0, wlead + (K,) + grid + (dim, dim)) / K
    # inside[k, node]: offset k of the node lies in the grid
    inside = np.ones((K,) + grid, dtype=bool)
    for k, off in enumerate(ts.stencil_offsets(degree, nd)):
        for ax, o in enumerate(off):
            at = np.arange(grid[ax]) + o
            inside[k] &= ((at >= 0) & (at < grid[ax])).reshape(
                (-1,) + (1,) * (nd - 1 - ax))
    centre = (Ellipsis, K // 2) + (slice(None),) * nd
    for c in range(dim):
        w[centre + (c, c)] = 0.0
    in_grid = np.abs(w) * inside[..., None, None]
    rows = in_grid.sum(axis=(-(nd + 3), -1))
    for c in range(dim):
        w[centre + (c, c)] = rows[..., c]
    diag = np.stack([w[centre + (c, c)] for c in range(dim)], -1)
    in_grid = np.abs(w) * inside[..., None, None]
    lam = 1.05 * float((in_grid.sum(axis=(-(nd + 3), -1)) / diag).max())
    theta, delta = 0.75 * lam, 0.25 * lam
    if per_batch_bounds:
        theta = theta * rng.uniform(1.0, 1.2, max(n, 1))
        delta = delta * rng.uniform(1.0, 1.2, max(n, 1))
    b = 1.0 + 0.5 * rng.standard_normal(lead + grid + (dim,))
    # a nonzero start for odd batches and unbatched fields (the V-cycle's
    # post-smoothing), zero for even batches (the mass solve's)
    x0 = (rng.standard_normal(lead + grid + (dim,)) if n % 2 or not n
          else np.zeros(lead + grid + (dim,)))
    return w, 1.0 / diag, b, x0, theta, delta


# (n, per-batch weights, per-batch bounds).  With shared weights the batch
# loop takes 2, 4 or 8 entries a chunk, the width by shape, so between
# them these batches run every width either kernel has (K4 float32 stops
# at 4) and leave a ragged last chunk at 7, 9 and 31; per-batch weights
# and one field take one entry a thread
VECTOR_CARD_CASES = {
    "unbatched": (0, False, False),
    "n1": (1, False, True),
    "n2": (2, False, False),
    "n4": (4, False, True),
    "n7": (7, False, False),
    "n9": (9, False, True),
    "n31": (31, False, False),
    "n2_per_batch_w": (2, True, True),
    "n9_per_batch_w": (9, True, False),
}


def _on_card(a, dtype):
    if not isinstance(a, np.ndarray):
        return a
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device="cuda")


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def vector_kernel_on_card(nd, degree, kind, case, grids):
    """K4 (nd = 2) or K5v (nd = 3) against ``_cheb_plain`` on the same CUDA
    tensors, through ``fused_cheb_smooth`` (the variant the C entry point
    picks by shape): the batch layout of ``case`` on each grid, 1, 2, 8 and
    20 steps, with and without the residual; two identical calls give
    identical bits.  Tolerance: 1e-12 in double precision, 1e-4 in single
    (another summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, kind)
    tol = 1e-12 if dt == torch.float64 else 1e-4
    n, per_batch_w, per_batch_bounds = VECTOR_CARD_CASES[case]
    key = "cheb_smooth_vector" if nd == 2 else "cheb_smooth_3d_vector"
    rng = np.random.default_rng(40 + 10 * nd + degree)
    before = dict(ts.launch_counts)
    calls = 0
    for grid in grids:
        args = [_on_card(a, dt) for a in card_vector_inputs(
            rng, nd, degree, grid, n, per_batch_w, per_batch_bounds)]
        for steps in (1, 2, 8, 20):
            for want_residual in (True, False):
                got = ts.fused_cheb_smooth(*args[:4], steps, *args[4:],
                                           degree, want_residual, nd=nd)
                ref = ts._cheb_plain(*args[:4], steps, *args[4:], degree,
                                     want_residual, nd=nd)
                calls += 1
                if not want_residual:
                    got, ref = (got,), (ref,)
                for g, r in zip(got, ref):
                    assert _rel(g, r) <= tol, (grid, steps, want_residual)
        first, second = (ts.fused_cheb_smooth(*args[:4], 8, *args[4:],
                                              degree, True, nd=nd)
                         for _ in range(2))
        calls += 2
        assert torch.equal(first[0], second[0])
        assert torch.equal(first[1], second[1])
    torch.cuda.synchronize()
    assert ts.launch_counts[key] == before[key] + calls
    assert all(ts.launch_counts[k] == before[k] for k in before if k != key)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(VECTOR_CARD_CASES))
@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("kind", ["float64", "float32"])
def test_cheb_vector_kernel_matches_plain_on_card(case, degree, kind):
    """K4 against its plain version on the card: batches of 1 to 31 fields
    with shared and per-batch weights, scalar and (n,) bounds, unbatched
    fields, a grid smaller than a block's 32 nodes and an odd one."""
    vector_kernel_on_card(2, degree, kind, case, [(9, 9), (37, 45)])


@pytest.mark.gpu
def test_coarse_assembly_is_deterministic_on_card():
    """``LocalOp.to_dense`` sums each entry in a fixed order, so on the card
    two assemblies of one operator are bit-equal, and two builds of the
    Stokes 8^2 x 4 preconditioner give bit-equal coarse inverses (the
    atomic ``index_add_`` it replaced rounded differently from build to
    build)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from control_tpu_torch.ops.local_op import LocalOp
    from chip_smoke import dense_inverses
    mesh = T.UnitSquareMesh(N, N, quadrilateral=True, dtype="float64",
                            device="cuda")
    sp = T.VectorFunctionSpace(mesh, "Lagrange", 2)
    A = torch.as_tensor(seeded((3, mesh.n_cells, sp.nloc, sp.nloc), 15),
                        device="cuda")
    op = LocalOp(A, sp, sp)
    assert torch.equal(op.to_dense(), op.to_dense())
    states = [stokes_problem(T, device="cuda").incompressible_linear_solve(
        T.ConstantNullspace(), _return_pieces=True, **solve_kw())[1].state
        for _ in range(2)]
    first, second = (dense_inverses(s) for s in states)
    assert set(first) == set(second) and len(first) >= 3
    for k in first:
        assert first[k].is_cuda
        assert torch.equal(first[k], second[k]), k

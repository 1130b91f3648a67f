"""3-D heat control (hexahedral Q1, Crank-Nicolson, ParaDiag and scan Schur
sweeps): the port against the JAX package, in float64 on the CPU.

* fem at 4^3 cells: hex Q1 mass / stiffness local operators and their
  application, gather / scatter, the six boundary faces, interpolation of
  sin(pi x) sin(pi y) sin(pi z); tolerance 1e-13 relative;
* node stencils with nd = 3; K6's plain version against the TPU kernel
  ``_apply_3d_pallas`` and K5's plain version (real and complex, shared and
  per-batch weights, residual on and off) against the TPU kernel
  ``_fused_cheb_nd3``, both in Pallas interpret mode on a (5, 6, 7) grid;
  tolerance 1e-12 (the same float64 recurrence, summed in another order);
* 3-D multigrid: transfers, Galerkin coarsening and V-cycles on a real 9^3
  hierarchy and on a batch of two complex ones; tolerance 1e-12;
* the slice, ``bench_extra.py``'s ``heat3d`` problem at 8^3 x 8 (the
  smallest mesh with two multigrid levels, 9^3 -> 5^3) with its solver
  settings: ParaDiag with the bench defaults, and the default ``scan``
  sweeps.  Both packages take 4 GMRES iterations; the residual histories
  agree within 1e-10 and v / zeta within 1e-10 (the rounding of two
  implementations, amplified by the ParaDiag 1/alpha = 1e3 unscaling); the
  JAX pc state, carried across by ``utils.convert``, equals the port's
  own within 1e-11 and applies as it does within 1e-12;
* the card is the default device, and CPU tensors never reach the kernel
  library.

The tests marked ``gpu`` hold the CUDA kernels K5 and K6 against their
plain versions on the card, and skip elsewhere.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import control_tpu as J
import control_tpu_torch as T
from control_tpu.ops import stencil as js
from control_tpu.solvers import multigrid as jm
from control_tpu_torch.ops import stencil as ts
from control_tpu_torch.ops import kernels
from control_tpu_torch.solvers import multigrid as tm
from control_tpu_torch.fem.space import combine_masks as t_combine
from control_tpu_torch.utils import convert

TOL = 1e-12
GRID = (5, 6, 7)
N, N_T = 8, 8           # the slice's mesh (and the multigrid tests') and steps


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


def spaces(n):
    mj = J.UnitCubeMesh(n, n, n, dtype="float64")
    mt = T.UnitCubeMesh(n, n, n, dtype="float64", device="cpu")
    return J.FunctionSpace(mj, "Lagrange", 1), \
        T.FunctionSpace(mt, "Lagrange", 1)


def forms(mod, sp):
    u, v = mod.TrialFunction(sp), mod.TestFunction(sp)
    X = mod.SpatialCoordinate(sp.mesh)
    return {"mass": mod.inner(u, v) * mod.dx,
            "stiffness": mod.inner(mod.grad(u), mod.grad(v)) * mod.dx,
            "variable": ((1.0 + X[0] * X[1] * X[2]) * mod.inner(u, v)
                         * mod.dx
                         + mod.inner(mod.grad(u), mod.grad(v)) * mod.dx)}


# ---------------------------------------------------------------------------
# fem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["mass", "stiffness", "variable"])
def test_hex_local_operators(form):
    sj, st = spaces(4)
    Aj = J.assemble(forms(J, sj)[form])
    At = T.assemble(forms(T, st)[form])
    close(Aj.A, At.A, 1e-13)
    x = np.random.default_rng(1).standard_normal((2,) + sj.grid_shape)
    close(Aj.apply(jnp.asarray(x)), At.apply(torch.as_tensor(x)), 1e-13)


def test_hex_gather_scatter():
    sj, st = spaces(4)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2,) + sj.grid_shape)
    close(sj.gather(jnp.asarray(x)), st.gather(torch.as_tensor(x)), 0.0)
    r = rng.standard_normal((2, sj.mesh.n_cells, 8))
    close(sj.scatter_add(jnp.asarray(r)), st.scatter_add(torch.as_tensor(r)),
          1e-13)


@pytest.mark.parametrize("sub_domain", [1, 2, 3, 4, 5, 6, "on_boundary"])
def test_hex_boundary_faces(sub_domain):
    sj, st = spaces(4)
    mj, mt = sj.boundary_mask(sub_domain), st.boundary_mask(sub_domain)
    assert mj.shape == mt.shape == (5, 5, 5)
    assert mt.any() and (mj == mt).all()
    assert (np.asarray(J.DirichletBC(sj, 0.0, sub_domain).mask)
            == T.DirichletBC(st, 0.0, sub_domain).mask.numpy()).all()


def test_hex_interpolate_and_load_vector():
    sj, st = spaces(4)

    def profile(mod, sp):
        X = mod.SpatialCoordinate(sp.mesh)
        return (mod.sin(mod.pi * X[0]) * mod.sin(mod.pi * X[1])
                * mod.sin(mod.pi * X[2]))

    fj = J.Function(sj).interpolate(profile(J, sj))
    ft = T.Function(st).interpolate(profile(T, st))
    close(fj.data, ft.data, 1e-13)
    close(J.assemble(J.inner(fj, J.TestFunction(sj)) * J.dx).data,
          T.assemble(T.inner(ft, T.TestFunction(st)) * T.dx).data, 1e-13)


# ---------------------------------------------------------------------------
# stencils
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [True, False])
def test_node_stencil_3d(masked):
    sj, st = spaces(4)
    Aj = J.assemble(forms(J, sj)["variable"])
    At = T.assemble(forms(T, st)["variable"])
    mask_j = J.DirichletBC(sj, 0.0).mask if masked else None
    mask_t = T.DirichletBC(st, 0.0).mask if masked else None
    wj = js.node_stencil(Aj.A, sj, mask=mask_j)
    wt = ts.node_stencil(At.A, st, mask=mask_t)
    assert tuple(wt.shape) == (27, 5, 5, 5)
    close(wj, wt)
    close(js.stencil_diag(wj, False, nd=3), ts.stencil_diag(wt, nd=3))
    close(js.stencil_abs_rowsum(wj, False, nd=3),
          ts.stencil_abs_rowsum(wt, nd=3))
    # the stencil applies the same operator as the local matrices
    x = np.random.default_rng(3).standard_normal(st.grid_shape)
    if masked:
        x[np.asarray(mask_j)] = 0.0
    ref = Aj.apply(jnp.asarray(x))
    if masked:
        ref = jnp.where(mask_j, jnp.asarray(x), ref)
    close(ref, ts.apply_stencil(wt, torch.as_tensor(x), 1, nd=3))


def _spd_stencil_3d(rng, lead, grid, cplx=False):
    """A diagonally dominant 27-point stencil and its inverse diagonal."""
    w = -0.3 * rng.uniform(0.2, 1.0, lead + (27,) + grid)
    w[..., 13, :, :, :] = 9.0 + rng.uniform(0.0, 1.0, lead + grid)
    if cplx:
        w = w * np.exp(1j * rng.uniform(-0.3, 0.3, w.shape))
    return w, 1.0 / w[..., 13, :, :, :]


# The TPU kernels, run as the JAX package's tests run them on the CPU
# (Pallas interpret mode), compiled once per dtype: the JAX side always
# gets per-batch operands (shared ones broadcast, which computes the same
# function), the port the layout under test.
_TPU_APPLY = jax.jit(functools.partial(js._apply_3d_pallas, degree=1,
                                       interpret=True))
_TPU_CHEB = jax.jit(functools.partial(js._fused_cheb_nd3, steps=3, degree=1,
                                      want_residual=True, interpret=True))


@pytest.mark.parametrize("layout", ["shared", "per_batch", "unbatched"])
def test_apply_plain_3d_matches_tpu_kernel(layout):
    """K6's plain version against the TPU kernel."""
    rng = np.random.default_rng(4)
    n = 2
    wlead, xlead = {"shared": ((1,), (n,)), "per_batch": ((n,), (n,)),
                    "unbatched": ((), ())}[layout]
    w = rng.standard_normal(wlead + (27,) + GRID)
    x = rng.standard_normal(xlead + GRID)
    ref = _TPU_APPLY(jnp.asarray(np.broadcast_to(w, (n, 27) + GRID)),
                     jnp.asarray(np.broadcast_to(x, (n,) + GRID)))
    got = ts.apply_stencil(torch.as_tensor(w), torch.as_tensor(x), 1, nd=3)
    close(ref if xlead else ref[0], got)


@functools.lru_cache(maxsize=None)
def _cheb_case(cplx, layout):
    """Inputs of one K5 layout and the TPU kernel's (x, r) on them (one
    run serves the residual-on and -off tests): shared weights with a
    shared dinv and x0 broadcast to the batch and scalar bounds, or
    per-batch weights, dinv, x0 and (n,) bounds."""
    rng = np.random.default_rng(5)
    n = 2
    shared = layout == "shared"
    w, dinv = _spd_stencil_3d(rng, () if shared else (n,), GRID, cplx)

    def field(shape):
        a = rng.standard_normal(shape)
        return a + 1j * rng.standard_normal(shape) if cplx else a

    b = field((n,) + GRID)
    x0 = field(GRID if shared else (n,) + GRID)
    if shared:
        theta, delta = 1.3, 0.6
    else:
        theta, delta = rng.uniform(1.0, 2.0, n), rng.uniform(0.3, 0.8, n)

    def per_batch(a, shape):
        return jnp.asarray(np.broadcast_to(np.asarray(a), shape))

    ref = _TPU_CHEB(per_batch(w, (n, 27) + GRID), per_batch(dinv, b.shape),
                    jnp.asarray(b), per_batch(x0, b.shape),
                    theta=per_batch(theta, (n,)),
                    delta=per_batch(delta, (n,)))
    return (w, dinv, b, x0, theta, delta), tuple(np.asarray(a) for a in ref)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("layout", ["shared", "per_batch"])
@pytest.mark.parametrize("want_residual", [True, False])
def test_cheb_plain_3d_matches_tpu_kernel(cplx, layout, want_residual):
    """K5's plain version (3 steps) against the TPU kernel."""
    (w, dinv, b, x0, theta, delta), ref = _cheb_case(cplx, layout)
    got = ts.fused_cheb_smooth(
        *(torch.as_tensor(a) for a in (w, dinv, b, x0)), 3,
        *(t if np.isscalar(t) else torch.as_tensor(t)
          for t in (theta, delta)), 1, want_residual=want_residual, nd=3)
    if want_residual:
        close(ref[0], got[0])
        close(ref[1], got[1])
    else:
        close(ref[0], got)


def test_cpu_tensors_never_touch_the_kernels_3d(monkeypatch):
    """On CPU tensors the 3-D wrappers run their plain versions: no launch
    is counted and the kernel library is never asked for."""
    def no_library():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(kernels, "library", no_library)
    before = dict(ts.launch_counts)
    w = torch.ones(27, 4, 4, 4, dtype=torch.float64)
    x = torch.ones(2, 4, 4, 4, dtype=torch.float64)
    ts.apply_stencil(w, x, 1, nd=3)
    ts.fused_cheb_smooth(w, x[0], x, x, 2, 1.0, 0.5, 1, nd=3)
    ts.fused_cheb_smooth(w.to(torch.complex128), x[0].to(torch.complex128),
                         x.to(torch.complex128), x.to(torch.complex128), 2,
                         1.0, 0.5, 1, want_residual=True, nd=3)
    assert ts.launch_counts == before


def test_unported_3d_cuda_paths_raise():
    """The CUDA wrappers refuse what no kernel covers (degree 4 in 3-D,
    vector stencils, complex 3-D application) before any launch; there
    is no plain fallback on the card."""
    x = torch.zeros(2, 5, 5, 5, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        ts._apply_cuda(torch.zeros(729, 5, 5, 5, dtype=torch.float64), x, 4,
                       3)
    with pytest.raises(NotImplementedError):
        ts._cheb_cuda(torch.zeros(27, 5, 5, 5, 3, 3, dtype=torch.float64),
                      x, x, x, 2, 1.0, 0.5, 1, False, 3)
    xc = x.to(torch.complex128)
    with pytest.raises(NotImplementedError):
        ts._apply_cuda(torch.zeros(27, 5, 5, 5, dtype=torch.complex128), xc,
                       1, 3)


# ---------------------------------------------------------------------------
# multigrid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cplx", [False, True])
def test_transfer_3d(cplx):
    sj, st = spaces(4)
    trj, trt = jm.Transfer(sj), tm.Transfer(st)
    rng = np.random.default_rng(6)

    def field(shape):
        a = rng.standard_normal(shape)
        return a + 1j * rng.standard_normal(shape) if cplx else a

    cj, ct = trj.coarse.mesh, trt.coarse.mesh       # StructuredMesh3D.coarsen
    assert [getattr(ct, a) for a in ("nx", "ny", "nz", "hx", "hy", "hz")] \
        == [getattr(cj, a) for a in ("nx", "ny", "nz", "hx", "hy", "hz")]
    assert ct.device == torch.device("cpu") and ct.dtype == torch.float64
    xc = field((2,) + trj.coarse.grid_shape)
    close(trj.prolong(jnp.asarray(xc)), trt.prolong(torch.as_tensor(xc)))
    rf = field((2,) + sj.grid_shape)
    close(trj.restrict(jnp.asarray(rf)), trt.restrict(torch.as_tensor(rf)))


@pytest.mark.parametrize("per_cell", [True, False])
def test_galerkin_3d(per_cell):
    """Coarse local matrices from the 8 children of each coarse cell."""
    sj, st = spaces(4)
    trj, trt = jm.Transfer(sj), tm.Transfer(st)
    A = np.random.default_rng(7).standard_normal(
        (sj.mesh.n_cells if per_cell else 1, 8, 8))
    close(trj.galerkin(jnp.asarray(A)), trt.galerkin(torch.as_tensor(A)))


def _mg_pair():
    """9^3 hierarchies (9^3 -> 5^3 dense) with zero Dirichlet rows."""
    sj, st = spaces(N)
    bj, bt = J.DirichletBC(sj, 0.0), T.DirichletBC(st, 0.0)
    kw = dict(coarse_max_dofs=600, pre=3, post=2)
    cj, ct = jm.MGConfig(sj, bj.mask, **kw), tm.MGConfig(st, bt.mask, **kw)
    assert len(cj.spaces) == len(ct.spaces) == 2
    Fj = (J.assemble(forms(J, sj)["stiffness"]).A
          + 2.5 * J.assemble(forms(J, sj)["mass"]).A)
    Ft = (T.assemble(forms(T, st)["stiffness"]).A
          + 2.5 * T.assemble(forms(T, st)["mass"]).A)
    Sj = J.assemble(forms(J, sj)["mass"]).A
    St = T.assemble(forms(T, st)["mass"]).A
    return sj, bj, cj, ct, (Fj, Sj), (Ft, St)


def _compare_params(pj, pt):
    for key in ("Ws", "diags", "dinvs"):
        for a, b in zip(pj[key], pt[key]):
            close(a, b)
    close(pj["lams"], pt["lams"])
    close(pj["Ainv"], pt["Ainv"], tol=1e-11)


def _j_apply(cj, pj, b):
    # one compiled program (the reference's own solves run its V-cycles
    # under jit; op-by-op dispatch would compile each operation apart)
    return jax.jit(lambda p, x: cj.apply(p, x, cycles=2))(pj, jnp.asarray(b))


def test_mg_apply_real_3d():
    sj, bj, cj, ct, (Fj, _), (Ft, _) = _mg_pair()
    pj, pt = jax.jit(cj.build)(Fj), ct.build(Ft)
    _compare_params(pj, pt)
    b = np.random.default_rng(8).standard_normal((2,) + sj.grid_shape)
    b[:, np.asarray(bj.mask)] = 0.0
    close(_j_apply(cj, pj, b), ct.apply(pt, torch.as_tensor(b), cycles=2))


def test_mg_apply_complex_batched_3d():
    """Two per-frequency complex hierarchies (the ParaDiag blocks
    F + mu_k S), built as one batch, against the reference's vmapped
    build."""
    sj, bj, cj, ct, (Fj, Sj), (Ft, St) = _mg_pair()
    mu = 0.5 * np.exp(-2j * np.pi * np.arange(2) / 5)
    Akj = (Fj.astype(jnp.complex128)[None]
           + jnp.asarray(mu)[:, None, None, None] * Sj[None])
    Akt = (Ft.to(torch.complex128)[None]
           + torch.as_tensor(mu)[:, None, None, None] * St[None])
    pj, pt = jax.jit(jax.vmap(cj.build))(Akj), ct.build(Akt)
    _compare_params(pj, pt)
    rng = np.random.default_rng(9)
    b = (rng.standard_normal((2,) + sj.grid_shape)
         + 1j * rng.standard_normal((2,) + sj.grid_shape))
    b[:, np.asarray(bj.mask)] = 0.0
    close(_j_apply(cj, pj, b), ct.apply(pt, torch.as_tensor(b), cycles=2))


# ---------------------------------------------------------------------------
# the slice: bench_extra.py's heat3d problem at 8^3 x 8
# ---------------------------------------------------------------------------

SOLVER_PARAMETERS = {"linear_solver": "gmres", "gmres_restart": 10,
                     "maximum_iterations": 50, "relative_tolerance": 1.0e-6,
                     "absolute_tolerance": 0.0,
                     "monitor_convergence": False}
LAMBDA_V_BOUNDS = (0.125, 3.375)


def heat3d_problem(mod, mode):
    kw = {"device": "cpu"} if mod is T else {}
    mesh = mod.UnitCubeMesh(N, N, N, dtype="float64", **kw)
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
                                   force_f=ff, beta=1e-4, n_t=N_T,
                                   time_interval=(0.0, 2.0), CN=True,
                                   bcs_v=bc_t)
    ctl.set_schur_sweep(mode)
    return ctl


@pytest.fixture(scope="module", params=["paradiag", "scan"])
def solved(request):
    """Both packages' solves of one mode (the JAX one compiles once per
    module)."""
    mode = request.param
    out = {}
    for mod in (J, T):
        ctl = heat3d_problem(mod, mode)
        kw = {"create_output": False} if mod is J else {}
        info = ctl.linear_solve(lambda_v_bounds=LAMBDA_V_BOUNDS,
                                solver_parameters=SOLVER_PARAMETERS,
                                print_error=False, **kw)
        out[mod] = (ctl, info)
    return mode, out[J], out[T]


def test_heat3d_iterations_match_reference(solved):
    mode, (_, ij), (ct, it) = solved
    assert ij.iterations == 4
    assert it.iterations == ij.iterations
    assert it.converged and it.rnorm / it.rnorm0 < 1e-6
    state = next(iter(ct._pc_state_cache.values()))
    if mode == "paradiag":
        assert set(state["fwd"]) == {"params", "wF", "wS"}
        # one real stencil pair per level for the N_T // 2 frequencies
        params = state["fwd"]["params"]
        for key in ("WF", "WS"):
            assert [tuple(w.shape) for w in params[key]] == [
                (27, 9, 9, 9), (27, 5, 5, 5)]
        assert tuple(params["mu"].shape) == (N_T // 2,)
        assert [tuple(d.shape) for d in params["dinvs"]] == [
            (N_T // 2, 9, 9, 9), (N_T // 2, 5, 5, 5)]
    else:
        assert set(state["fwd"]) == {"params", "sub"}


def test_heat3d_residual_history_matches_reference(solved):
    _, (_, ij), (_, it) = solved
    k = ij.iterations + 1
    rel = np.abs(ij.res_norms[:k] - it.res_norms[:k]) / ij.res_norms[:k]
    assert float(rel.max()) < 1e-10, rel


@pytest.mark.parametrize("field", ["_v", "_zeta"])
def test_heat3d_solution_matches_reference(solved, field):
    _, (cj, _), (ct, _) = solved
    a = np.asarray(getattr(cj, field).data)
    b = getattr(ct, field).data.numpy()
    assert a.shape == b.shape == (N_T, N + 1, N + 1, N + 1)
    assert float(np.abs(a - b).max() / np.abs(a).max()) < 1e-10


def _close_trees(a, b, tol):
    """Two nested dict/list states: the same keys, every leaf within
    ``tol`` relative to its largest entry."""
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _close_trees(a[k], b[k], tol)
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close_trees(x, y, tol)
    else:
        assert a.dtype == b.dtype
        close(a, b, tol)


def _formed(state):
    """A pc state with every stencil-pair hierarchy's per-frequency planes
    formed (``form_planes``): the layout of the JAX package's state."""
    if isinstance(state, dict):
        if "WF" in state:
            return tm.form_planes(state)
        return {k: _formed(v) for k, v in state.items()}
    return state


def test_heat3d_pc_application_with_carried_state(solved):
    """The CN block preconditioner state the JAX package derived for its
    solve (multigrid hierarchies, complex per-frequency ones in ParaDiag,
    stencils, coarse inverses), carried across by utils.convert, equals
    the port's own (its ParaDiag stencil pairs formed into per-frequency
    planes) to 1e-11 (the coarse inverses' rounding); the pc built from
    it applies as the port's own to 1e-12."""
    _, (cj, _), (ct, _) = solved
    own = next(iter(ct._pc_state_cache.values()))
    carried = convert.to_torch(
        jax.tree_util.tree_map(np.asarray,
                               next(iter(cj._pc_state_cache.values()))),
        ct._space_v)
    _close_trees(carried, _formed(own), 1e-11)
    mask = t_combine(ct._space_v, ct._bcs_v[1])
    Dt, Mt = ct._D_stack(ct._v.data), T.assemble(ct._M_v)
    rng = np.random.default_rng(21)
    shape = (N_T - 1,) + (N + 1,) * 3
    mk = mask.numpy()[None]
    b = [torch.as_tensor(np.where(mk, 0.0, rng.standard_normal(shape)))
         for _ in range(2)]
    u_own, u_carried = (
        ct.construct_pc(False, LAMBDA_V_BOUNDS, mask, Dt, Mt,
                        prebuilt=state)(*b) for state in (own, carried))
    for a, c in zip(u_own, u_carried):
        close(a, c)


# ---------------------------------------------------------------------------
# the default device
# ---------------------------------------------------------------------------

def test_meshes_default_to_the_card(monkeypatch):
    """Without ``device`` a mesh goes to the CUDA card; with no card that
    raises (no silent CPU run), and ``device="cpu"`` builds on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda **kw: T.UnitCubeMesh(2, **kw),
                  lambda **kw: T.UnitSquareMesh(2, quadrilateral=True,
                                                **kw)):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            build()
        assert build(device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert T.BoxMesh(2, 2, 2, 1.0, 1.0, 1.0).device == torch.device("cuda")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["shared", "per_batch", "unbatched"])
@pytest.mark.parametrize("kind", ["float64", "float32", "complex128",
                                  "complex64"])
def test_kernels_3d_match_plain_versions_on_card(layout, kind):
    """K6 (real) and K5 (real and complex) on the card against their plain
    versions on the same CUDA tensors: shared weights with a shared dinv,
    x0 and scalar bounds, per-batch weights, dinv, x0 and (n,) bounds, and
    unbatched fields, on an odd (9, 13, 37) grid.  Tolerance: 1e-12 in
    double precision, 1e-5 (K6) and 1e-4 (K5) in single (another
    summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, kind)
    cplx = dt.is_complex
    rdt = torch.float64 if dt in (torch.float64, torch.complex128) \
        else torch.float32
    tol_apply, tol_cheb = ((1e-12, 1e-12) if rdt == torch.float64
                           else (1e-5, 1e-4))
    rng = np.random.default_rng(37)
    grid, n = (9, 13, 37), 3
    per_batch = layout == "per_batch"
    lead = () if layout == "unbatched" else (n,)
    w, dinv = _spd_stencil_3d(rng, (n,) if per_batch else (), grid, cplx)

    def field(shape):
        a = rng.standard_normal(shape)
        return a + 1j * rng.standard_normal(shape) if cplx else a

    def cu(a, dtype=dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device="cuda")

    b = cu(field(lead + grid))
    x0 = cu(field(lead + grid if per_batch else grid))
    wt, dt_ = cu(w), cu(dinv)
    if per_batch:
        th = cu(rng.uniform(1.0, 2.0, n), rdt)
        de = cu(rng.uniform(0.3, 0.8, n), rdt)
    else:
        th, de = 1.3, 0.6

    def rel(got, ref):
        return float((got - ref).abs().max() / ref.abs().max())

    before = dict(ts.launch_counts)
    if cplx:
        with pytest.raises(NotImplementedError):
            ts.apply_stencil(wt, b, 1, nd=3)
    else:
        assert rel(ts.apply_stencil(wt, b, 1, nd=3),
                   ts._apply_plain(wt, b, 1, nd=3)) <= tol_apply
    for steps in (1, 4):
        got = ts.fused_cheb_smooth(wt, dt_, b, x0, steps, th, de, 1,
                                   want_residual=True, nd=3)
        ref = ts._cheb_plain(wt, dt_, b, x0, steps, th, de, 1,
                             want_residual=True, nd=3)
        assert rel(got[0], ref[0]) <= tol_cheb
        assert rel(got[1], ref[1]) <= tol_cheb
        assert rel(ts.fused_cheb_smooth(wt, dt_, b, x0, steps, th, de, 1,
                                        nd=3), ref[0]) <= tol_cheb
    torch.cuda.synchronize()
    key = "cheb_smooth_3d_complex" if cplx else "cheb_smooth_3d_real"
    assert ts.launch_counts["stencil_apply_3d"] == (
        before["stencil_apply_3d"] + (0 if cplx else 1))
    assert ts.launch_counts[key] == before[key] + 4
    for k in ("stencil_apply", "cheb_smooth_real", "cheb_smooth_complex"):
        assert ts.launch_counts[k] == before[k]

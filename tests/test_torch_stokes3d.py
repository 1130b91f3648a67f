"""3-D Taylor-Hood Stokes control (hexahedral Q2-Q1, Crank-Nicolson, the
nested preconditioner with the default ``scan`` sweeps) and 3-D heat
control on Q2 hexahedra: the port against the JAX package, in float64 on
the CPU.

* K5v's plain version (``_cheb_plain`` on 3-D vector stencils, dim = 3)
  against the TPU kernel ``_fused_cheb_nd3`` in Pallas interpret mode at
  degree 1 on a (6, 7, 9) grid, and against the JAX package's shifted-add
  path (``fused_cheb_smooth(use_pallas=False, nd=3)``) at degrees 1 and 2,
  per-batch and shared weights; tolerance 1e-12 (one float64 recurrence,
  summed in another order);
* K5 (real, complex) and K6 at degree 2 (K = 125): the plain versions
  against ``_fused_cheb_nd3`` (real) and ``_apply_3d_pallas`` in interpret
  mode and against the shifted-add path; 1e-12;
* Q2 hexahedra: the Taylor-Hood local operators, the vector space, node
  stencils, transfers (real and complex) and one two-level vector V-cycle
  with ``levels=2`` forced (at test sizes the velocity space is below
  ``coarse_max_dofs``); 1e-12;
* stokes3d, the problem of ``tests/test_instationary_stokes3d.py`` at
  2^3 x 3: the regularised pressure stiffness and the Q2^3 / Q1 mass
  solves (1e-12), the right-hand sides, the block system's ``mult`` on
  seeded vectors (1e-10, as the 2-D file) and the nested pc's state; the
  port's own solve meets that test's assertions (converged; the discrete
  divergence of every velocity below 1e-8);
* heat3d_q2, ``bench_extra.py``'s heat3d problem on Q2 hexahedra at
  4^3 x 4: the port's ParaDiag and scan solves converge to the same
  solution.

Marked ``slow``, since the JAX package takes minutes on a CPU for each
(measured: its ParaDiag solve of heat3d_q2 at 4^3 x 4 703 s, scan 117 s,
one eager application of the stokes3d pc 118 s, jitted 147 s): one
application of the nested stokes3d ``pc_fn`` (1e-10); the whole stokes3d
solve (equal iterations, histories within 1e-9 of the initial residual);
the heat3d_q2 solves (equal iterations, histories within 1e-10 of the
initial residual, v / zeta within 1e-10); K5 complex at degree 2 against the TPU kernel in interpret mode.

The tests marked ``gpu`` hold the CUDA kernels K5v (every variant its C
entry point picks by shape among them; the checks are those of the K4
tests in ``test_torch_stokes.py``) and K5/K6 at degree 2 against their plain
versions on the card, and skip elsewhere.
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
from control_tpu_torch.solvers import multigrid as tm
from control_tpu_torch.utils import convert
from test_torch_stokes import VECTOR_CARD_CASES, vector_kernel_on_card

TOL = 1e-12
GRID = (6, 7, 9)


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
# seeded stencils
# ---------------------------------------------------------------------------

def spd_vector_stencil(rng, lead, grid, degree):
    """A diagonally dominant 3-D stencil with a 3 x 3 coupling block per
    offset, its inverse diagonal per component and Gershgorin Chebyshev
    bounds (theta, delta)."""
    K = (2 * degree + 1) ** 3
    w = rng.uniform(-1.0, 1.0, lead + (K,) + grid + (3, 3)) / K
    for c in range(3):
        w[..., K // 2, :, :, :, c, c] += 2.0 + rng.uniform(
            0.0, 1.0, lead + grid)
    diag = np.stack([w[..., K // 2, :, :, :, c, c] for c in range(3)], -1)
    lam = 1.05 * float((np.abs(w).sum(axis=(-6, -1)) / diag).max())
    return w, 1.0 / diag, 0.5 * (lam + lam / 4.0), 0.5 * (lam - lam / 4.0)


def spd_stencil(rng, lead, grid, degree, cplx=False):
    """A diagonally dominant scalar 3-D stencil and its inverse diagonal."""
    K = (2 * degree + 1) ** 3
    w = -rng.uniform(0.2, 1.0, lead + (K,) + grid) * (8.0 / K)
    w[..., K // 2, :, :, :] = 9.0 + rng.uniform(0.0, 1.0, lead + grid)
    if cplx:
        w = w * np.exp(1j * rng.uniform(-0.3, 0.3, w.shape))
    return w, 1.0 / w[..., K // 2, :, :, :]


def field(rng, shape, cplx=False):
    a = rng.standard_normal(shape)
    return a + 1j * rng.standard_normal(shape) if cplx else a


# layout: (weight lead, field lead, per-batch dinv, x0 and bounds)
LAYOUTS = {"per_batch": ((2,), (2,), True),
           "shared_on_batch": ((), (2,), False),
           "unbatched": ((), (), False)}


def vector_inputs(rng, layout, degree, grid):
    wlead, blead, per_batch = LAYOUTS[layout]
    w, dinv, theta, delta = spd_vector_stencil(rng, wlead, grid, degree)
    b = field(rng, blead + grid + (3,))
    x0 = field(rng, (blead if per_batch else ()) + grid + (3,))
    if per_batch:
        theta = theta * rng.uniform(1.0, 1.2, blead)
        delta = delta * rng.uniform(1.0, 1.2, blead)
    return w, dinv, b, x0, theta, delta


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX package
# ---------------------------------------------------------------------------

def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.as_tensor(a) if isinstance(a, np.ndarray) else a


def _per_batch(a, shape):
    return jnp.asarray(np.broadcast_to(np.asarray(a), shape))


# The TPU kernels, run as the JAX package's tests run them on the CPU
# (Pallas interpret mode), compiled once per case; the JAX side gets
# per-batch operands (shared ones broadcast, which computes the same
# function), the port the layout under test.
_TPU_CHEB_Q1 = jax.jit(functools.partial(
    js._fused_cheb_nd3, steps=3, degree=1, want_residual=True,
    interpret=True))
# at degree 2 the kernel runs eagerly: compiling its 125-offset body takes
# ten times as long as running it op by op
_TPU_CHEB_Q2 = functools.partial(js._fused_cheb_nd3, steps=2, degree=2,
                                 want_residual=True, interpret=True)
_TPU_APPLY_Q2 = jax.jit(functools.partial(js._apply_3d_pallas, degree=2,
                                          interpret=True))


@functools.lru_cache(maxsize=None)
def _vector_q1_case(layout):
    """K5v inputs of one layout at degree 1 on GRID and the TPU kernel's
    (x, r) on them (one run serves the residual-on and -off tests)."""
    rng = np.random.default_rng(61)
    w, dinv, b, x0, theta, delta = vector_inputs(rng, layout, 1, GRID)
    n = b.shape[0]
    ref = _TPU_CHEB_Q1(_per_batch(w, (n,) + w.shape[-6:]),
                       _per_batch(dinv, b.shape), _j(b),
                       _per_batch(x0, b.shape),
                       theta=_per_batch(theta, (n,)),
                       delta=_per_batch(delta, (n,)))
    return (w, dinv, b, x0, theta, delta), tuple(np.asarray(a) for a in ref)


@pytest.mark.parametrize("want_residual", [True, False])
def test_cheb_vector3d_plain_matches_tpu_kernel(want_residual):
    """K5v's plain version (3 steps, dim = 3, K = 27, per-batch weights
    and bounds) against the TPU kernel ``_fused_cheb_nd3`` (the C = dim
    branch of its coupled form)."""
    (w, dinv, b, x0, theta, delta), ref = _vector_q1_case("per_batch")
    got = ts.fused_cheb_smooth(*map(_t, (w, dinv, b, x0)), 3, _t(theta),
                               _t(delta), 1, want_residual=want_residual,
                               nd=3)
    if want_residual:
        close(ref[0], got[0])
        close(ref[1], got[1])
    else:
        close(ref[0], got)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("degree", [1, 2])
def test_cheb_vector3d_plain_matches_reference(layout, degree):
    """K5v's plain version (K = 27 and 125, 3 steps and the residual)
    against the JAX package's shifted-add path."""
    rng = np.random.default_rng(62)
    w, dinv, b, x0, theta, delta = vector_inputs(rng, layout, degree,
                                                 (5, 5, 6))
    got = ts.fused_cheb_smooth(*map(_t, (w, dinv, b, x0)), 3, _t(theta),
                               _t(delta), degree, want_residual=True, nd=3)
    ref = js.fused_cheb_smooth(*map(_j, (w, dinv, b, x0)), 3, _j(theta),
                               _j(delta), degree, want_residual=True,
                               use_pallas=False, nd=3)
    close(ref[0], got[0])
    close(ref[1], got[1])


def _scalar_q2_inputs(cplx, layout):
    """K5 inputs at degree 2: shared weights with a shared dinv and x0 and
    scalar bounds, or per-batch weights, dinv, x0 and (n,) bounds."""
    rng = np.random.default_rng(64)
    n, grid = 2, (5, 6, 7)
    shared = layout == "shared"
    w, dinv = spd_stencil(rng, () if shared else (n,), grid, 2, cplx)
    b = field(rng, (n,) + grid, cplx)
    x0 = field(rng, grid if shared else (n,) + grid, cplx)
    if shared:
        theta, delta = 1.3, 0.6
    else:
        theta, delta = rng.uniform(1.0, 2.0, n), rng.uniform(0.3, 0.8, n)
    return w, dinv, b, x0, theta, delta


@functools.lru_cache(maxsize=None)
def _scalar_q2_case(cplx, layout):
    """K5 inputs at degree 2 and the TPU kernel's (x, r) on them."""
    w, dinv, b, x0, theta, delta = _scalar_q2_inputs(cplx, layout)
    n, grid = b.shape[0], b.shape[1:]
    ref = _TPU_CHEB_Q2(_per_batch(w, (n, 125) + grid),
                       _per_batch(dinv, b.shape), _j(b),
                       _per_batch(x0, b.shape),
                       theta=_per_batch(theta, (n,)),
                       delta=_per_batch(delta, (n,)))
    return (w, dinv, b, x0, theta, delta), tuple(np.asarray(a) for a in ref)


@pytest.mark.parametrize("want_residual", [True, False])
def test_cheb_q2_plain_matches_tpu_kernel(want_residual):
    """K5's plain version at degree 2 (2 steps, real, per-batch weights and
    bounds) against the TPU kernel."""
    (w, dinv, b, x0, theta, delta), ref = _scalar_q2_case(False,
                                                          "per_batch")
    got = ts.fused_cheb_smooth(*map(_t, (w, dinv, b, x0)), 2, _t(theta),
                               _t(delta), 2, want_residual=want_residual,
                               nd=3)
    if want_residual:
        close(ref[0], got[0])
        close(ref[1], got[1])
    else:
        close(ref[0], got)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("layout", ["shared", "per_batch"])
def test_cheb_q2_plain_matches_reference(cplx, layout):
    """K5's plain version at degree 2 (2 steps and the residual), real and
    complex, against the JAX package's shifted-add path."""
    w, dinv, b, x0, theta, delta = _scalar_q2_inputs(cplx, layout)
    got = ts.fused_cheb_smooth(*map(_t, (w, dinv, b, x0)), 2, _t(theta),
                               _t(delta), 2, want_residual=True, nd=3)
    ref = js.fused_cheb_smooth(*map(_j, (w, dinv, b, x0)), 2, _j(theta),
                               _j(delta), 2, want_residual=True,
                               use_pallas=False, nd=3)
    close(ref[0], got[0])
    close(ref[1], got[1])


@pytest.mark.parametrize("layout", ["shared", "per_batch", "unbatched"])
def test_apply_q2_plain_matches_tpu_kernel(layout):
    """K6's plain version at degree 2 against the TPU kernel."""
    rng = np.random.default_rng(65)
    n, grid = 2, (5, 6, 7)
    wlead, xlead = {"shared": ((1,), (n,)), "per_batch": ((n,), (n,)),
                    "unbatched": ((), ())}[layout]
    w = rng.standard_normal(wlead + (125,) + grid)
    x = rng.standard_normal(xlead + grid)
    ref = _TPU_APPLY_Q2(_per_batch(w, (n, 125) + grid),
                        _per_batch(x, (n,) + grid))
    got = ts.apply_stencil(_t(w), _t(x), 2, nd=3)
    close(ref if xlead else ref[0], got)


@pytest.mark.parametrize("chunks", [1, 5])
def test_vector_apply_q2_chunks(monkeypatch, chunks):
    """The vector apply at degree 2 in 3-D, in one product and one
    leading window offset at a time (what large fields take), against the
    JAX package's shifted multiply-adds."""
    if chunks > 1:
        monkeypatch.setattr(ts, "_APPLY_CHUNK_BYTES", 1)
    rng = np.random.default_rng(66)
    w = rng.standard_normal((125, 5, 5, 6, 3, 3))
    x = rng.standard_normal((2, 5, 5, 6, 3))
    ref = js._apply_xla(_j(w), _j(x), 2, nd=3)
    close(ref, ts.apply_stencil(_t(w), _t(x), 2, nd=3), 1e-13)


def test_cpu_tensors_never_touch_the_kernels(monkeypatch):
    """On CPU tensors the 3-D vector and degree-2 wrappers run their plain
    versions: no launch is counted and the kernel library is never asked
    for."""
    from control_tpu_torch.ops import kernels

    def no_library():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(kernels, "library", no_library)
    before = dict(ts.launch_counts)
    rng = np.random.default_rng(67)
    w, dinv, b, x0, th, de = map(_t, vector_inputs(rng, "unbatched", 2,
                                                   (3, 4, 5)))
    ts.fused_cheb_smooth(w, dinv, b, x0, 2, th, de, 2, want_residual=True,
                         nd=3)
    ws = torch.ones(125, 3, 4, 5, dtype=torch.float64)
    xs = torch.ones(2, 3, 4, 5, dtype=torch.float64)
    ts.apply_stencil(ws, xs, 2, nd=3)
    ts.fused_cheb_smooth(ws.to(torch.complex128), xs[0], xs.to(
        torch.complex128), xs.to(torch.complex128), 2, 1.0, 0.5, 2, nd=3)
    assert ts.launch_counts == before


@pytest.mark.parametrize("case", ["complex", "dim2", "degree3", "two_batch",
                                  "shape"])
def test_cheb_vector3d_cuda_wrapper_refuses(case):
    """What K5v does not cover raises before any launch: complex vector
    fields (no TPU kernel either), 3-D fields with dim = 2, degree 3, two
    batch axes, mismatched weights; nothing falls back to the plain
    version on the card."""
    dt = torch.complex128 if case == "complex" else torch.float64
    dim = 2 if case == "dim2" else 3
    degree = 3 if case == "degree3" else 2
    lead = (2, 3) if case == "two_batch" else (3,)
    K = (2 * degree + 1) ** 3
    grid = (5, 5, 5)
    w = torch.zeros((K,) + grid + (dim, dim), dtype=dt)
    b = torch.zeros(lead + grid + (dim,), dtype=dt)
    error = NotImplementedError
    if case == "shape":
        w = torch.zeros((27,) + grid + (3, 3), dtype=dt)
        error = ValueError
    with pytest.raises(error):
        ts._cheb_vector_cuda(w, b, b, b, 2, 1.0, 0.5, degree, False, 3)


# ---------------------------------------------------------------------------
# fem and multigrid on Q2 hexahedra
# ---------------------------------------------------------------------------

def space_pair(n, kind):
    """The same space in both packages on UnitCubeMesh(n, n, n):
    "vector_q2" (the velocity, dim = 3), "scalar_q2", "scalar_q1" (the
    pressure)."""
    mj = J.UnitCubeMesh(n, n, n, dtype="float64")
    mt = T.UnitCubeMesh(n, n, n, dtype="float64", device="cpu")
    deg = 1 if kind == "scalar_q1" else 2
    if kind == "vector_q2":
        return (J.VectorFunctionSpace(mj, "Lagrange", 2, dim=3),
                T.VectorFunctionSpace(mt, "Lagrange", 2, dim=3))
    return (J.FunctionSpace(mj, "Lagrange", deg),
            T.FunctionSpace(mt, "Lagrange", deg))


def coupled_form(mod, sp):
    """A form that varies in space and, on the vector space, couples the
    components (grad-div), so that no stencil block is trivially
    diagonal."""
    u, v = mod.TrialFunction(sp), mod.TestFunction(sp)
    X = mod.SpatialCoordinate(sp.mesh)
    form = ((1.0 + X[0] * X[1] * X[2]) * mod.inner(u, v) * mod.dx
            + mod.inner(mod.grad(u), mod.grad(v)) * mod.dx)
    if sp.dim is not None:
        form = form + mod.inner(mod.div(u), mod.div(v)) * mod.dx
    return form


def bc_mask(mod, sp):
    value = 0.0 if sp.dim is None else (0.0,) * sp.dim
    return mod.DirichletBC(sp, value, "on_boundary").mask


def velocity_profile(mod, X):
    """v_d of ``tests/test_instationary_stokes3d.py``."""
    s, c, pi = mod.sin, mod.cos, mod.pi
    return (s(pi * X[0]) * s(2 * pi * X[1]) * s(pi * X[2]),
            s(2 * pi * X[0]) * s(pi * X[1]) * s(pi * X[2]),
            c(pi * X[0]) * s(pi * X[1]) * s(2 * pi * X[2]))


@pytest.mark.parametrize("form", ["mass", "stiffness", "B", "B_T"])
def test_taylor_hood_hex_local_operators(form):
    """The Q2^3 mass and stiffness and the rectangular divergence operators
    to the Q1 pressure on hexahedra: arrays and actions."""
    svj, svt = space_pair(2, "vector_q2")
    spj, spt = space_pair(2, "scalar_q1")

    def forms(mod, sv, sp):
        vt, vs = mod.TrialFunction(sv), mod.TestFunction(sv)
        pt, ps = mod.TrialFunction(sp), mod.TestFunction(sp)
        return {"mass": mod.inner(vt, vs) * mod.dx,
                "stiffness": mod.inner(mod.grad(vt), mod.grad(vs)) * mod.dx,
                "B": -mod.inner(mod.div(vt), ps) * mod.dx,
                "B_T": -mod.inner(pt, mod.div(vs)) * mod.dx}[form]

    Aj, At = J.assemble(forms(J, svj, spj)), T.assemble(forms(T, svt, spt))
    assert tuple(At.A.shape) == {"mass": (1, 81, 81),
                                 "stiffness": (1, 81, 81), "B": (1, 8, 81),
                                 "B_T": (1, 81, 8)}[form]
    close(Aj.A, At.A, 1e-13)
    trial = spj if form == "B_T" else svj
    x = np.random.default_rng(1).standard_normal((2,) + trial.grid_shape)
    close(Aj.apply(_j(x)), At.apply(_t(x)), 1e-13)


def test_vector_q2_hex_space():
    """Gather / scatter, ``interpolate`` of the v_d triple, the
    (nz, ny, nx, 3) Dirichlet mask."""
    sj, st = space_pair(2, "vector_q2")
    assert st.grid_shape == (5, 5, 5, 3) and st.nloc == 81
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2,) + sj.grid_shape)
    close(sj.gather(_j(x)), st.gather(_t(x)), 0.0)
    r = rng.standard_normal((2, sj.mesh.n_cells, sj.nloc))
    close(sj.scatter_add(_j(r)), st.scatter_add(_t(r)), 1e-13)
    fj = J.Function(sj).interpolate(velocity_profile(J, J.SpatialCoordinate(
        sj.mesh)))
    ft = T.Function(st).interpolate(velocity_profile(T, T.SpatialCoordinate(
        st.mesh)))
    close(fj.data, ft.data, 1e-13)
    mj, mt = bc_mask(J, sj), bc_mask(T, st)
    assert tuple(mt.shape) == st.grid_shape
    assert (np.asarray(mj) == mt.numpy()).all()


@pytest.mark.parametrize("kind", ["vector_q2", "scalar_q2"])
@pytest.mark.parametrize("masked", [True, False])
def test_node_stencil_q2_hex(kind, masked):
    """Node stencils on Q2 hexahedra (K = 125), their diagonal and row
    sums, and the operator they apply."""
    sj, st = space_pair(2, kind)
    Aj, At = J.assemble(coupled_form(J, sj)), T.assemble(coupled_form(T, st))
    mask_j = bc_mask(J, sj) if masked else None
    mask_t = bc_mask(T, st) if masked else None
    wj = js.node_stencil(Aj.A, sj, mask=mask_j, alpha=2.5)
    wt = ts.node_stencil(At.A, st, mask=mask_t, alpha=2.5)
    vec = st.dim is not None
    assert tuple(wt.shape) == (125,) + st.node_grid + ((3, 3) if vec else ())
    close(wj, wt, 1e-13)
    close(js.stencil_diag(wj, vec, nd=3), ts.stencil_diag(wt, vec, nd=3),
          1e-13)
    close(js.stencil_abs_rowsum(wj, vec, nd=3),
          ts.stencil_abs_rowsum(wt, vec, nd=3), 1e-13)
    x = np.random.default_rng(3).standard_normal((2,) + st.grid_shape)
    if masked:
        x[:, np.asarray(mask_j)] = 0.0
    ref = Aj.apply(_j(x))
    if masked:
        ref = jnp.where(mask_j, 2.5 * _j(x), ref)
    close(ref, ts.apply_stencil(wt, _t(x), 2, nd=3), 1e-13)


@pytest.mark.parametrize("kind", ["vector_q2", "scalar_q2"])
@pytest.mark.parametrize("cplx", [False, True])
def test_transfer_q2_hex(kind, cplx):
    """Prolongation, restriction (real, and complex as the ParaDiag
    frequency blocks have it) and Galerkin coarsening on Q2 hexahedra (the
    gather/scatter path)."""
    sj, st = space_pair(4, kind)
    trj, trt = jm.Transfer(sj), tm.Transfer(st)
    rng = np.random.default_rng(6)
    xc = field(rng, (2,) + trj.coarse.grid_shape, cplx)
    got = trt.prolong(_t(xc))
    assert tuple(got.shape) == (2,) + st.grid_shape
    close(trj.prolong(_j(xc)), got)
    rf = field(rng, (2,) + sj.grid_shape, cplx)
    close(trj.restrict(_j(rf)), trt.restrict(_t(rf)))
    if not cplx:
        Aj, At = J.assemble(coupled_form(J, sj)).A, T.assemble(
            coupled_form(T, st)).A
        close(trj.galerkin(Aj), trt.galerkin(At))


def test_vector_q2_hex_two_level_vcycle():
    """``MGConfig(space_v, mask, levels=2)`` on 4^3 cells (9^3 x 3 -> 5^3 x
    3 dense): the hierarchy and one V-cycle, whose fine level smooths with
    K5v's plain version."""
    sj, st = space_pair(4, "vector_q2")
    Aj, At = J.assemble(coupled_form(J, sj)).A, T.assemble(
        coupled_form(T, st)).A
    mask_j, mask_t = bc_mask(J, sj), bc_mask(T, st)
    cj = jm.MGConfig(sj, mask_j, levels=2, pre=3, post=3)
    ct = tm.MGConfig(st, mask_t, levels=2, pre=3, post=3)
    assert [s.grid_shape for s in ct.spaces] == [(9, 9, 9, 3), (5, 5, 5, 3)]
    pj, pt = cj.build(Aj), ct.build(At)
    for key in ("Ws", "diags", "dinvs"):
        for a, b in zip(pj[key], pt[key]):
            close(a, b)
    close(pj["lams"], pt["lams"])
    close(pj["Ainv"], pt["Ainv"], 1e-11)
    b = np.random.default_rng(9).standard_normal(sj.grid_shape)
    b[np.asarray(mask_j)] = 0.0
    ref = jax.jit(lambda p, x: cj.apply(p, x))(pj, _j(b))
    close(ref, ct.apply(pt, _t(b)), 1e-11)


# ---------------------------------------------------------------------------
# stokes3d: tests/test_instationary_stokes3d.py's problem at 2^3 x 3
# ---------------------------------------------------------------------------

N3, N3_T = 2, 3
LAMBDA_V, LAMBDA_P = (0.1, 2.3), (0.1, 3.4)


def stokes3d_parameters(rtol):
    return {"linear_solver": "fgmres", "fgmres_restart": 10,
            "maximum_iterations": 100, "relative_tolerance": rtol,
            "absolute_tolerance": 0.0, "monitor_convergence": False}


def stokes3d_problem(mod, n=N3, n_t=N3_T, **kw):
    mesh = mod.UnitCubeMesh(n, n, n, dtype="float64", **kw)
    space_v = mod.VectorFunctionSpace(mesh, "Lagrange", 2, dim=3)
    space_p = mod.FunctionSpace(mesh, "Lagrange", 1)
    X = mod.SpatialCoordinate(mesh)

    def fdo(trial, test, u, t):
        return mod.inner(mod.grad(trial), mod.grad(test)) * mod.dx

    def ds_(test, t):
        v_d = mod.Function(space_v).interpolate(velocity_profile(mod, X))
        return mod.inner(v_d, test) * mod.dx, v_d

    def ff(test, t):
        return mod.inner(mod.Function(space_v), test) * mod.dx

    def bc_t(s, t):
        return mod.DirichletBC(s, (0.0, 0.0, 0.0), "on_boundary")

    return mod.Control.Instationary(
        space_v, fdo, desired_state=ds_, force_f=ff, beta=1e-2,
        space_p=space_p, n_t=n_t, time_interval=(0.0, 1.0), CN=True,
        bcs_v=bc_t)


def stokes3d_kw(rtol=1e-6, **extra):
    return dict(lambda_v_bounds=LAMBDA_V, lambda_p_bounds=LAMBDA_P,
                solver_parameters=stokes3d_parameters(rtol),
                print_error=False, create_output=False, **extra)


def test_regularized_stiffness_3d():
    """The regularised Q1 pressure stiffness on hexahedra (K_p's
    operator)."""
    from control_tpu.models import common as jc
    from control_tpu_torch.models import common as tc
    spj, spt = space_pair(N3, "scalar_q1")

    def ops(mod, sp):
        u, v = mod.TrialFunction(sp), mod.TestFunction(sp)
        return (mod.assemble(mod.inner(mod.grad(u), mod.grad(v)) * mod.dx),
                mod.assemble(mod.inner(u, v) * mod.dx))

    close(jc.regularized_stiffness(*ops(J, spj)).A,
          tc.regularized_stiffness(*ops(T, spt)).A, 1e-13)


@pytest.mark.parametrize("kind", ["vector_q2", "scalar_q1"])
def test_mass_solver_3d(kind):
    """The Chebyshev mass solve on the Q2^3 velocity space (masked; K5v's
    plain version) and on the Q1 pressure space (``mask=None``; K5's)."""
    from control_tpu.models import common as jc
    from control_tpu_torch.models import common as tc
    sj, st = space_pair(N3, kind)
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
    close(solj(_j(b)), solt(_t(b)))


@pytest.fixture(scope="module")
def stokes3d_pieces():
    """Both packages' (system, pc_fn, b_0, b_1) of the same problem."""
    pj = stokes3d_problem(J).incompressible_linear_solve(
        J.ConstantNullspace(), plots=False, _return_pieces=True,
        **stokes3d_kw())
    pt = stokes3d_problem(T, device="cpu").incompressible_linear_solve(
        T.ConstantNullspace(), _return_pieces=True, **stokes3d_kw())
    return pj, pt


def seeded(shape, seed):
    return np.random.default_rng(seed).standard_normal(tuple(shape))


def test_stokes3d_rhs(stokes3d_pieces):
    (_, _, b0j, b1j), (_, _, b0t, b1t) = stokes3d_pieces
    n = N3_T - 1
    assert tuple(b0t.shape) == (2 * n,) + (2 * N3 + 1,) * 3 + (3,)
    assert tuple(b1t.shape) == (2 * n,) + (N3 + 1,) * 3
    close(b0j, b0t, 1e-13)
    close(b1j, b1t, 0.0)


def test_stokes3d_system_mult(stokes3d_pieces):
    """The 2n + 2n block operator on seeded vectors."""
    (sysj, _, b0j, b1j), (syst, _, _, _) = stokes3d_pieces
    x0, x1 = seeded(b0j.shape, 11), seeded(b1j.shape, 12)
    yj = sysj.mult(_j(x0), _j(x1))
    yt = syst.mult(_t(x0), _t(x1))
    close(yj[0], yt[0], 1e-10)
    close(yj[1], yt[1], 1e-10)


@pytest.mark.slow
def test_stokes3d_pc_application(stokes3d_pieces):
    """One application of the nested preconditioner (five inner GMRES
    iterations on the velocity KKT system with the Q2^3 mass solves, the
    pressure Schur part)."""
    (_, pcj, b0j, b1j), (_, pct, _, _) = stokes3d_pieces
    x0, x1 = seeded(b0j.shape, 13), seeded(b1j.shape, 14)
    yj = pcj(_j(x0), _j(x1))
    yt = pct(_t(x0), _t(x1))
    close(yj[0], yt[0], 1e-10)
    close(yj[1], yt[1], 1e-10)


def test_stokes3d_pc_state(stokes3d_pieces):
    """The nested pc's state, carried across from the JAX package by
    ``utils.convert``, has the port's layout and values."""
    (_, pcj, _, _), (syst, pct, _, _) = stokes3d_pieces
    sj = convert.to_torch(jax.tree_util.tree_map(np.asarray, pcj.state),
                          syst.space_0)
    st = pct.state
    assert set(sj) == set(st) == {"inner", "K_p", "M_p"}
    w = st["inner"]["solver_0"]["w"]
    assert tuple(w.shape) == (125,) + (2 * N3 + 1,) * 3 + (3, 3)
    close(sj["inner"]["solver_0"]["w"], w, 1e-13)
    close(sj["M_p"]["w"], st["M_p"]["w"], 1e-13)
    for side in ("fwd", "bwd"):
        close(sj["inner"][side]["sub"], st["inner"][side]["sub"], 1e-13)


def test_stokes3d_solve_meets_reference_assertions():
    """The port's own solve, with the settings of
    ``tests/test_instationary_stokes3d.py`` (rtol 1e-10): it converges,
    and every returned velocity is discretely divergence free (< 1e-8)."""
    ctl = stokes3d_problem(T, device="cpu")
    info = ctl.incompressible_linear_solve(T.ConstantNullspace(),
                                           **stokes3d_kw(rtol=1e-10))
    assert info.converged and ctl.last_solve_info.converged
    assert info.rnorm / info.rnorm0 < 1e-10
    space_v, space_p = ctl._space_v, ctl._space_p
    test_p = T.TestFunction(space_p)
    assert tuple(ctl._v.data.shape) == (N3_T,) + space_v.grid_shape
    for i in range(ctl._v.data.shape[0]):
        vi = T.Function(space_v, data=ctl._v.data[i])
        dv = T.assemble(-T.inner(T.div(vi), test_p) * T.dx).data
        assert float(dv.abs().max()) < 1e-8


@pytest.mark.slow
def test_stokes3d_solve_matches_reference():
    """The whole solve against the JAX package's: equal iterations,
    residual histories within 1e-9 of the initial residual, v and zeta
    within 1e-9, p and mu (means removed) within 1e-8."""
    cj = stokes3d_problem(J)
    ij = cj.incompressible_linear_solve(J.ConstantNullspace(), plots=False,
                                        **stokes3d_kw())
    ct = stokes3d_problem(T, device="cpu")
    it = ct.incompressible_linear_solve(T.ConstantNullspace(),
                                        **stokes3d_kw())
    assert ij.converged and it.converged
    assert it.iterations == ij.iterations
    k = ij.iterations + 1
    hj, ht = np.asarray(ij.res_norms[:k]), it.res_norms[:k]
    assert float(np.max(np.abs(hj - ht)) / hj[0]) < 1e-9
    for name, tol in (("v", 1e-9), ("zeta", 1e-9), ("p", 1e-8),
                      ("mu", 1e-8)):
        a = np.asarray(getattr(cj, "_" + name).data)
        b = getattr(ct, "_" + name).data.numpy()
        if name in ("p", "mu"):
            a = a - a.mean(axis=(1, 2, 3), keepdims=True)
            b = b - b.mean(axis=(1, 2, 3), keepdims=True)
        close(a, b, tol)


@pytest.mark.slow
@pytest.mark.parametrize("layout", ["shared", "per_batch"])
def test_cheb_q2_complex_plain_matches_tpu_kernel(layout):
    """K5's plain version at degree 2 on complex fields against the TPU
    kernel in interpret mode (its C = 2 coupled form: 500 traced
    volume products a residual, minutes on a CPU)."""
    (w, dinv, b, x0, theta, delta), ref = _scalar_q2_case(True, layout)
    got = ts.fused_cheb_smooth(*map(_t, (w, dinv, b, x0)), 2, _t(theta),
                               _t(delta), 2, want_residual=True, nd=3)
    close(ref[0], got[0])
    close(ref[1], got[1])


def test_carry_state_3d(stokes3d_pieces):
    """``utils.convert.carry_state`` takes (n, nz, ny, nx, 3) velocity and
    (n, nz, ny, nx) pressure stacks."""
    rng = np.random.default_rng(15)
    ctl = stokes3d_problem(T, device="cpu")
    state = {"v": rng.standard_normal((N3_T,) + ctl._space_v.grid_shape),
             "p": rng.standard_normal((N3_T - 1,) + ctl._space_p.grid_shape)}
    mask = ctl._bcs_v[1][0].mask.numpy()
    state["v"][:, mask] = 0.0
    convert.carry_state(ctl, **state)
    close(state["v"], ctl._v.data, 0.0)
    close(state["p"], ctl._p.data, 0.0)
    with pytest.raises(ValueError):
        convert.carry_state(ctl, p=state["v"])


# ---------------------------------------------------------------------------
# heat3d_q2: bench_extra.py's heat3d problem on Q2 hexahedra at 4^3 x 4
# ---------------------------------------------------------------------------

N2, N2_T = 4, 4
HEAT_PARAMETERS = {"linear_solver": "gmres", "gmres_restart": 10,
                   "maximum_iterations": 50, "relative_tolerance": 1.0e-6,
                   "absolute_tolerance": 0.0, "monitor_convergence": False}
LAMBDA_Q2 = (0.1, 2.3)


def heat3d_q2_problem(mod, mode):
    kw = {"device": "cpu"} if mod is T else {}
    mesh = mod.UnitCubeMesh(N2, N2, N2, dtype="float64", **kw)
    space = mod.FunctionSpace(mesh, "Lagrange", 2)
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
                                   force_f=ff, beta=1e-4, n_t=N2_T,
                                   time_interval=(0.0, 2.0), CN=True,
                                   bcs_v=bc_t)
    ctl.set_schur_sweep(mode)
    return ctl


def _heat3d_q2_solve(mod, mode):
    ctl = heat3d_q2_problem(mod, mode)
    kw = {"create_output": False} if mod is J else {}
    info = ctl.linear_solve(lambda_v_bounds=LAMBDA_Q2,
                            solver_parameters=HEAT_PARAMETERS,
                            print_error=False, **kw)
    return ctl, info


def test_heat3d_q2_port_solves():
    """The port's ParaDiag and scan solves converge and agree with each
    other to the solver tolerance; ParaDiag's frequency hierarchies are
    Q2 (K = 125), 9^3 nodes above a dense 5^3 level."""
    (cp, ip), (cs, is_) = (_heat3d_q2_solve(T, m)
                           for m in ("paradiag", "scan"))
    assert ip.converged and is_.converged
    assert ip.rnorm / ip.rnorm0 < 1e-6 and is_.rnorm / is_.rnorm0 < 1e-6
    state = next(iter(cp._pc_state_cache.values()))
    n_f = (N2_T - 1) // 2 + 1
    # one real stencil pair per level for the n_f frequencies
    params = state["fwd"]["params"]
    for key in ("WF", "WS"):
        assert [tuple(w.shape) for w in params[key]] == [
            (125, 9, 9, 9), (125, 5, 5, 5)]
    assert tuple(params["mu"].shape) == (n_f,)
    assert [tuple(d.shape) for d in params["dinvs"]] == [
        (n_f, 9, 9, 9), (n_f, 5, 5, 5)]
    for name in ("_v", "_zeta"):
        a, b = getattr(cp, name).data, getattr(cs, name).data
        assert tuple(a.shape) == (N2_T,) + (2 * N2 + 1,) * 3
        assert float((a - b).abs().max() / b.abs().max()) < 1e-4


@pytest.fixture(scope="module", params=["paradiag", "scan"])
def heat3d_q2_solved(request):
    """Both packages' solves of one mode."""
    mode = request.param
    return mode, _heat3d_q2_solve(J, mode), _heat3d_q2_solve(T, mode)


@pytest.mark.slow
def test_heat3d_q2_iterations_and_history(heat3d_q2_solved):
    mode, (_, ij), (ct, it) = heat3d_q2_solved
    assert ij.converged and it.converged
    assert it.iterations == ij.iterations
    assert it.rnorm / it.rnorm0 < 1e-6
    k = ij.iterations + 1
    hj, ht = np.asarray(ij.res_norms[:k]), it.res_norms[:k]
    # within 1e-10 of the initial residual; entry by entry the last one,
    # seven orders below it, drifts to ~1e-9 of its own size
    assert float(np.max(np.abs(hj - ht)) / hj[0]) < 1e-10
    assert float(np.max(np.abs(hj - ht) / hj)) < 1e-8


@pytest.mark.slow
@pytest.mark.parametrize("name", ["_v", "_zeta"])
def test_heat3d_q2_solution(heat3d_q2_solved, name):
    _, (cj, _), (ct, _) = heat3d_q2_solved
    a = np.asarray(getattr(cj, name).data)
    b = getattr(ct, name).data.numpy()
    assert a.shape == b.shape == (N2_T,) + (2 * N2 + 1,) * 3
    assert float(np.abs(a - b).max() / np.abs(a).max()) < 1e-10


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda(a, dtype):
    if not isinstance(a, np.ndarray):
        return a
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device="cuda")


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(VECTOR_CARD_CASES))
@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("kind", ["float64", "float32"])
def test_cheb_vector3d_kernel_matches_plain_on_card(case, degree, kind):
    """K5v against its plain version on the card: batches of 1 to 31 fields
    with shared and per-batch weights, scalar and (n,) bounds, unbatched
    fields, a grid smaller than a block's 32 nodes and the odd (7, 11, 37)
    one."""
    vector_kernel_on_card(3, degree, kind, case, [(5, 5, 5), (7, 11, 37)])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["shared", "per_batch", "unbatched"])
@pytest.mark.parametrize("kind", ["float64", "float32", "complex128",
                                  "complex64"])
def test_kernels_3d_q2_match_plain_versions_on_card(layout, kind):
    """K6 (real) and K5 (real and complex) at degree 2 (K = 125) on the
    card against their plain versions: shared weights with a shared dinv,
    x0 and scalar bounds, per-batch weights, dinv, x0 and (n,) bounds, and
    unbatched fields, on an odd (7, 11, 37) grid.  Tolerance: 1e-12 in
    double precision, 1e-5 (K6) and 1e-4 (K5) in single."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, kind)
    cplx = dt.is_complex
    rdt = torch.float64 if dt in (torch.float64, torch.complex128) \
        else torch.float32
    tol_apply, tol_cheb = ((1e-12, 1e-12) if rdt == torch.float64
                           else (1e-5, 1e-4))
    rng = np.random.default_rng(53)
    grid, n = (7, 11, 37), 3
    per_batch = layout == "per_batch"
    lead = () if layout == "unbatched" else (n,)
    w, dinv = spd_stencil(rng, (n,) if per_batch else (), grid, 2, cplx)
    b = _cuda(field(rng, lead + grid, cplx), dt)
    x0 = _cuda(field(rng, lead + grid if per_batch else grid, cplx), dt)
    wt, dt_ = _cuda(w, dt), _cuda(dinv, dt)
    if per_batch:
        th = _cuda(rng.uniform(1.0, 2.0, n), rdt)
        de = _cuda(rng.uniform(0.3, 0.8, n), rdt)
    else:
        th, de = 1.3, 0.6
    before = dict(ts.launch_counts)
    if cplx:
        with pytest.raises(NotImplementedError):
            ts.apply_stencil(wt, b, 2, nd=3)
    else:
        assert _rel(ts.apply_stencil(wt, b, 2, nd=3),
                    ts._apply_plain(wt, b, 2, nd=3)) <= tol_apply
    for steps in (1, 4):
        got = ts.fused_cheb_smooth(wt, dt_, b, x0, steps, th, de, 2,
                                   want_residual=True, nd=3)
        ref = ts._cheb_plain(wt, dt_, b, x0, steps, th, de, 2,
                             want_residual=True, nd=3)
        assert _rel(got[0], ref[0]) <= tol_cheb
        assert _rel(got[1], ref[1]) <= tol_cheb
        assert _rel(ts.fused_cheb_smooth(wt, dt_, b, x0, steps, th, de, 2,
                                         nd=3), ref[0]) <= tol_cheb
    torch.cuda.synchronize()
    key = "cheb_smooth_3d_complex_q2" if cplx else "cheb_smooth_3d_real_q2"
    moved = {key: 4, "stencil_apply_3d_q2": 0 if cplx else 1}
    if not cplx and ts.apply_design(dt, n if lead else 1, not per_batch, 3,
                                    2)[0] == "tile":
        # the shared-weight batch's application ran the plane tile
        moved["stencil_apply_3d_tile_q2"] = 1
    for k in before:
        assert ts.launch_counts[k] == before[k] + moved.get(k, 0), k

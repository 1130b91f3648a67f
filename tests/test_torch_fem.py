"""The PyTorch port's FEM layer against the JAX package, in float64 on the
CPU: meshes, Q1/Q2 gather/scatter, boundary masks, assembled operators and
linear forms, interpolation.  Inputs are made with numpy from a seed;
tolerance 1e-13 (both sides run the same float64 arithmetic, in another
summation order at most)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import control_tpu as J
import control_tpu_torch as T
from control_tpu.fem.space import combine_masks as j_combine
from control_tpu_torch.fem.space import combine_masks as t_combine

TOL = 1e-13


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
    scale = max(float(np.max(np.abs(a))), 1.0)
    err = float(np.max(np.abs(a - b))) / scale if a.size else 0.0
    assert err <= tol, err


def spaces(nx, ny, quad, degree):
    mj = J.UnitSquareMesh(nx, ny, quadrilateral=quad, dtype="float64")
    mt = T.UnitSquareMesh(nx, ny, quadrilateral=quad, dtype="float64",
                          device="cpu")
    return (J.FunctionSpace(mj, "Lagrange", degree),
            T.FunctionSpace(mt, "Lagrange", degree))


@pytest.mark.parametrize("quad", [True, False])
def test_mesh_matches(quad):
    mj = J.UnitSquareMesh(6, 4, quadrilateral=quad)
    mt = T.UnitSquareMesh(6, 4, quadrilateral=quad, dtype=torch.float64,
                          device="cpu")
    assert (mt.nx, mt.ny, mt.cell, mt.n_cells) == (mj.nx, mj.ny, mj.cell,
                                                  mj.n_cells)
    assert mt.dtype == torch.float64 and mt.device == torch.device("cpu")
    np.testing.assert_array_equal(mt.cell_origins(), mj.cell_origins())
    mc = mt.coarsen()
    assert (mc.nx, mc.ny, mc.dtype, mc.device) == (3, 2, mt.dtype,
                                                   mt.device)


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_gather_scatter_add(degree, batch):
    sj, st = spaces(5, 3, True, degree)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(batch + sj.grid_shape)
    close(sj.gather(jnp.asarray(x)), st.gather(torch.as_tensor(x)))
    r = rng.standard_normal(batch + (sj.mesh.n_cells, sj.nloc))
    close(sj.scatter_add(jnp.asarray(r)),
          st.scatter_add(torch.as_tensor(r)))


@pytest.mark.parametrize("sub", ["on_boundary", 1, 2, 3, 4, (1, 3)])
def test_boundary_mask(sub):
    sj, st = spaces(4, 5, True, 2)
    np.testing.assert_array_equal(st.boundary_mask(sub),
                                  sj.boundary_mask(sub))
    bj, bt = J.DirichletBC(sj, 0.0, sub), T.DirichletBC(st, 0.0, sub)
    np.testing.assert_array_equal(bt.mask.numpy(), np.asarray(bj.mask))
    np.testing.assert_array_equal(t_combine(st, (bt,)).numpy(),
                                  np.asarray(j_combine(sj, (bj,))))


def _forms(mod, sp, kind):
    u, v = mod.TrialFunction(sp), mod.TestFunction(sp)
    X = mod.SpatialCoordinate(sp.mesh)
    if kind == "mass":
        return mod.inner(u, v) * mod.dx
    if kind == "stiffness":
        return mod.inner(mod.grad(u), mod.grad(v)) * mod.dx
    # variable coefficient: a Function and a spatial expression
    w = mod.Function(sp).interpolate(X[0] + 0.3 * X[1])
    return (mod.inner(mod.grad(u), mod.grad(v)) * mod.dx
            + (mod.Constant(1.0) + w ** 2.0 + mod.sin(X[1]))
            * mod.inner(u, v) * mod.dx)


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("kind", ["mass", "stiffness", "variable"])
def test_assembled_operator(quad, degree, kind):
    sj, st = spaces(4, 3, quad, degree)
    Aj = J.assemble(_forms(J, sj, kind))
    At = T.assemble(_forms(T, st, kind))
    close(Aj.A, At.A)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2,) + sj.grid_shape)
    close(Aj.apply(jnp.asarray(x)), At.apply(torch.as_tensor(x)))
    close(Aj.diag(), At.diag())
    close(Aj.to_dense(), At.to_dense())


def test_masked_operator_and_linear_form():
    sj, st = spaces(5, 4, True, 1)
    bj, bt = J.DirichletBC(sj, 0.0), T.DirichletBC(st, 0.0)
    Aj = J.assemble(_forms(J, sj, "variable"), bcs=bj)
    At = T.assemble(_forms(T, st, "variable"), bcs=bt)
    close(Aj.to_dense(), At.to_dense())
    close(Aj.diag(), At.diag())

    def rhs(mod, sp):
        X = mod.SpatialCoordinate(sp.mesh)
        v = mod.TestFunction(sp)
        return mod.cos(mod.pi * X[0]) * X[1] * v * mod.dx

    close(J.assemble(rhs(J, sj), bcs=bj).data,
          T.assemble(rhs(T, st), bcs=bt).data)

    def functional(mod, sp):
        X = mod.SpatialCoordinate(sp.mesh)
        f = mod.Function(sp).interpolate(mod.exp(X[0] * X[1]))
        return mod.inner(f, f) * mod.dx

    close(J.assemble(functional(J, sj)), T.assemble(functional(T, st)))


@pytest.mark.parametrize("space", ["q1", "q2", "q2_vector", "hex_q1",
                                   "hex_q2", "hex_q2_vector"])
def test_to_dense_equals_numpy_assembly(space):
    """``LocalOp.to_dense`` (a fixed-order sum per entry) equals a dense
    matrix assembled cell by cell with numpy, for the scalar Q1/Q2 and
    vector spaces the multigrid hierarchies assemble, with per-cell and
    batched local matrices; the coarse inverses of the card's pc builds
    rest on it."""
    from control_tpu_torch.ops.local_op import LocalOp, _global_indices
    hexa = space.startswith("hex")
    degree = 1 if space.endswith("q1") else 2
    dim = (3 if hexa else 2) if space.endswith("vector") else None
    mesh = (T.UnitCubeMesh(2, 3, 2, dtype="float64", device="cpu") if hexa
            else T.UnitSquareMesh(4, 3, quadrilateral=True, dtype="float64",
                                  device="cpu"))
    sp = (T.FunctionSpace(mesh, "Lagrange", degree) if dim is None
          else T.VectorFunctionSpace(mesh, "Lagrange", degree, dim=dim))
    rng = np.random.default_rng(12)
    A = rng.standard_normal((2, mesh.n_cells, sp.nloc, sp.nloc))
    got = LocalOp(torch.as_tensor(A), sp, sp).to_dense()
    gi = _global_indices(sp)
    ref = np.zeros((2, sp.n_dofs, sp.n_dofs))
    for e in range(mesh.n_cells):
        for i, gr in enumerate(gi[e]):
            for j, gc in enumerate(gi[e]):
                ref[:, gr, gc] += A[:, e, i, j]
    close(ref, got)
    # the shared (E = 1) local matrix of a constant-coefficient form
    shared = LocalOp(torch.as_tensor(A[0, :1]), sp, sp).to_dense()
    ref1 = np.zeros((sp.n_dofs, sp.n_dofs))
    for e in range(mesh.n_cells):
        ref1[np.ix_(gi[e], gi[e])] += A[0, 0]
    close(ref1, shared)


@pytest.mark.parametrize("degree", [1, 2])
def test_interpolate(degree):
    sj, st = spaces(6, 5, True, degree)

    def expr(mod, X):
        return (mod.cos(0.5 * mod.pi * (X[0] - 1.0))
                * mod.cos(0.5 * mod.pi * (X[1] - 1.0)) + X[0] ** 2.0)

    Xj, Xt = J.SpatialCoordinate(sj.mesh), T.SpatialCoordinate(st.mesh)
    close(J.interpolate(sj, expr(J, Xj)), T.interpolate(st, expr(T, Xt)))
    # spatial derivatives through autodiff
    e_j = J.div(J.grad(expr(J, Xj)))
    e_t = T.div(T.grad(expr(T, Xt)))
    close(J.interpolate(sj, e_j), T.interpolate(st, e_t))
    # a FEM function inside the expression
    fj = J.Function(sj).interpolate(expr(J, Xj))
    ft = T.Function(st).interpolate(expr(T, Xt))
    close(J.interpolate(sj, fj * Xj[1] + 1.0),
          T.interpolate(st, ft * Xt[1] + 1.0))


def test_convert_local_op():
    """Reference local matrices carried across by utils.convert apply like
    the reference operator."""
    from control_tpu_torch.utils import convert
    sj, st = spaces(5, 4, True, 2)
    Aj = J.assemble(_forms(J, sj, "variable"))
    At = convert.local_op(np.asarray(Aj.A), st)
    assert At.A.dtype == torch.float64 and At.A.device == st.device
    x = np.random.default_rng(6).standard_normal(sj.grid_shape)
    close(Aj.apply(jnp.asarray(x)), At.apply(torch.as_tensor(x)))


def test_function_containers_follow_the_mesh_device():
    mt = T.UnitSquareMesh(3, 3, quadrilateral=True, dtype="float32",
                          device="cpu")
    st = T.FunctionSpace(mt, "Lagrange", 1)
    f = T.Function(st)
    mf = T.MixedFunction(st, 4)
    assert f.data.dtype == torch.float32 and f.data.device == mt.device
    assert tuple(mf.data.shape) == (4, 4, 4)
    mf.sub(2).assign(1.5)
    assert float(mf.data[2].sum()) == 1.5 * 16
    assert float(mf.data[1].abs().sum()) == 0.0

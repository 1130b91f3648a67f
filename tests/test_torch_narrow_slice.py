"""ParaDiag with narrow weight planes (``set_schur_sweep("paradiag", ...,
weight_dtype=...)``): the port's solves against the JAX package's, in
float64 on the CPU.

* the flagship problem (``bench.py``'s settings: (3, 3) smoothing, one
  cycle, 10 mass steps, GMRES(10), rtol 1e-6) at 32^2 x 8 -- the smallest
  size whose frequency hierarchies smooth a level (33^2 above a dense
  17^2) -- with float32 weights (narrower than the float64 fields) and
  with bfloat16 (the value the JAX benchmarks pass): the JAX package's 9
  iterations, histories within 1e-8 relative, v / zeta within 1e-9, the
  tolerances of the full-precision ParaDiag test; the pc stores its
  frequency planes narrow, and one built from the JAX package's state
  (carried across by ``utils.convert``) applies as the port's own to
  1e-12;
* heat3d (``bench_extra.py``: hex Q1, ParaDiag defaults) at 8^3 x 8 with
  bfloat16: the JAX package's 4 iterations, histories within 1e-10;
* heat3d_q2 (hex Q2) at 4^3 x 4 with bfloat16, marked ``slow``: the JAX
  package compiles its K = 125 ParaDiag programs for many minutes;
* heat3d in float32 (the dtype ``chip_smoke.py`` runs) with bfloat16,
  marked ``slow``: at 16^3 x 16 both packages converge in one count; at
  64^3 x 16, ``chip_smoke.py``'s width, neither converges within a budget
  of 10 and both stand at one level (the recipe's stall, ``ROADMAP.md``
  Queue 3).
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
from test_torch_instationary import (heat_problem, solve,
                                     LAMBDA_V_BOUNDS as LAMBDA_2D)
from test_torch_heat3d import (heat3d_problem, SOLVER_PARAMETERS,
                               LAMBDA_V_BOUNDS as LAMBDA_3D)
from test_torch_stokes3d import heat3d_q2_problem, LAMBDA_Q2


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


def _narrow(ctl, wd, **kw):
    ctl.set_schur_sweep("paradiag", weight_dtype=wd, **kw)
    return ctl


def _history_rel(ij, it):
    k = ij.iterations + 1
    hj = np.asarray(ij.res_norms[:k])
    return float(np.max(np.abs(hj - it.res_norms[:k]) / hj))


def _field_rel(cj, ct, name):
    a = np.asarray(getattr(cj, name).data)
    b = getattr(ct, name).data.numpy()
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(a).max())


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def flagship(request):
    """Both packages' flagship ParaDiag solves at 32^2 x 8 with one
    ``weight_dtype``."""
    wd = request.param
    out = {}
    for mod in (J, T):
        ctl = _narrow(heat_problem(mod, 32, 8, "paradiag"), wd,
                      paradiag_cycles=1, smooth=(3, 3))
        out[mod] = (ctl, solve(mod, ctl))
    return wd, out[J], out[T]


def test_flagship_narrow_matches_reference(flagship):
    wd, (cj, ij), (ct, it) = flagship
    assert ij.iterations == 9
    assert it.iterations == ij.iterations
    assert it.converged and it.rnorm / it.rnorm0 < 1e-6
    assert _history_rel(ij, it) < 1e-8
    for name in ("_v", "_zeta"):
        assert _field_rel(cj, ct, name) < 1e-9


def test_flagship_pc_stores_narrow_planes(flagship):
    """The frequency hierarchies hold their smoothers' planes narrow, as
    (re, im) pairs; the defect-correction stencils stay float64."""
    wd, _, (ct, _) = flagship
    state = next(iter(ct._pc_state_cache.values()))
    for sweep in ("fwd", "bwd"):
        params = state[sweep]["params"]
        for w, d in zip(params["Ws"], params["dinvs"]):
            assert w.dtype == d.dtype == getattr(torch, wd)
            assert w.shape[-1] == d.shape[-1] == 2
        assert state[sweep]["wF"].dtype == torch.float64
        assert state[sweep]["wS"].dtype == torch.float64
    assert tuple(state["fwd"]["params"]["Ws"][0].shape) == (4, 9, 33, 33, 2)


def test_flagship_narrow_pc_with_carried_state(flagship):
    """A pc built from the JAX package's state (full planes; the JAX package
    rounds them at each smoothing) stores them narrow and applies as the
    port's own pc to 1e-12."""
    wd, (cj, _), (ct, _) = flagship
    mj = j_combine(cj._space_v, cj._bcs_v[1])
    mt = t_combine(ct._space_v, ct._bcs_v[1])
    Dt, Mt = ct._D_stack(ct._v.data), T.assemble(ct._M_v)
    pc_j = cj.construct_pc(False, LAMBDA_2D, mj, cj._D_stack(cj._v.data),
                           J.assemble(cj._M_v))
    carried = convert.to_torch(
        jax.tree_util.tree_map(np.asarray, pc_j.state), ct._space_v)
    own = next(iter(ct._pc_state_cache.values()))
    pc_c = ct.construct_pc(False, LAMBDA_2D, mt, Dt, Mt, prebuilt=carried)
    pc_o = ct.construct_pc(False, LAMBDA_2D, mt, Dt, Mt, prebuilt=own)
    assert pc_c.state["fwd"]["params"]["Ws"][0].dtype == getattr(torch, wd)
    rng = np.random.default_rng(21)
    shape = (7, 33, 33)
    mask = np.broadcast_to(np.asarray(mj)[None], shape)
    b = [np.where(mask, 0.0, rng.standard_normal(shape)) for _ in range(2)]
    uj = pc_j(*(jnp.asarray(a) for a in b))
    uc = pc_c(*(torch.as_tensor(a) for a in b))
    uo = pc_o(*(torch.as_tensor(a) for a in b))
    for a, c, o in zip(uj, uc, uo):
        a = np.asarray(a)
        scale = np.abs(a).max()
        assert float(np.abs(a - c.numpy()).max() / scale) < 1e-12
        assert float((c - o).abs().max() / o.abs().max()) < 1e-12


def test_heat3d_bf16_matches_reference():
    out = {}
    for mod in (J, T):
        ctl = _narrow(heat3d_problem(mod, "paradiag"), "bfloat16")
        kw = {"create_output": False} if mod is J else {}
        out[mod] = ctl.linear_solve(lambda_v_bounds=LAMBDA_3D,
                                    solver_parameters=SOLVER_PARAMETERS,
                                    print_error=False, **kw)
    ij, it = out[J], out[T]
    assert ij.iterations == 4
    assert it.iterations == ij.iterations
    assert it.converged and it.rnorm / it.rnorm0 < 1e-6
    assert _history_rel(ij, it) < 1e-10


@pytest.mark.slow
def test_heat3d_q2_bf16_matches_reference():
    out = {}
    for mod in (J, T):
        ctl = _narrow(heat3d_q2_problem(mod, "paradiag"), "bfloat16")
        kw = {"create_output": False} if mod is J else {}
        out[mod] = ctl.linear_solve(lambda_v_bounds=LAMBDA_Q2,
                                    solver_parameters=SOLVER_PARAMETERS,
                                    print_error=False, **kw)
    ij, it = out[J], out[T]
    assert ij.converged and it.converged
    assert it.iterations == ij.iterations
    k = ij.iterations + 1
    hj = np.asarray(ij.res_norms[:k])
    assert float(np.max(np.abs(hj - it.res_norms[:k])) / hj[0]) < 1e-10


def _heat3d_float32(mod, n, n_t):
    """heat3d (``bench_extra.py``: hex Q1, CN, beta = 1e-4, ParaDiag
    defaults) on n^3 cells x n_t in float32, with bfloat16 planes."""
    kw = {"device": "cpu"} if mod is T else {}
    mesh = mod.UnitCubeMesh(n, n, n, dtype="float32", **kw)
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
                                   time_interval=(0.0, 2.0), CN=True,
                                   bcs_v=bc_t)
    return _narrow(ctl, "bfloat16")


@pytest.mark.slow
@pytest.mark.parametrize("n, budget", [(16, 50), (64, 10)])
def test_heat3d_bf16_float32_follows_reference(n, budget):
    """In float32 the two packages round differently, so their histories
    are not held entry by entry: at 16^3 x 16 both converge below 1e-6 in
    one count; at 64^3 x 16 neither converges within ``budget`` and their
    residuals after it are within a factor 2 of each other (a stalled
    float32 GMRES amplifies rounding-level differences; on the card the
    narrow and the full-precision kernels on the same rounded planes part
    by up to 14% an iteration).  Both histories are printed."""
    parameters = dict(SOLVER_PARAMETERS, maximum_iterations=budget)
    if n == 64:
        parameters["preconditioner"] = True
    out = {}
    for mod in (J, T):
        kw = {"create_output": False} if mod is J else {}
        info = _heat3d_float32(mod, n, 16).linear_solve(
            lambda_v_bounds=LAMBDA_3D, solver_parameters=parameters,
            print_error=False, **kw)
        k = info.iterations + 1
        h = np.asarray(info.res_norms[:k]) / float(info.res_norms[0])
        print(f"heat3d {n}^3x16 float32 bf16 {mod.__name__}: "
              f"{info.iterations} its, history {h.tolist()}")
        out[mod] = (info, float(h[-1]))
    (ij, rj), (it, rt) = out[J], out[T]
    if n == 64:
        assert not ij.converged and not it.converged
        assert ij.iterations == it.iterations == budget
        assert 0.5 < rt / rj < 2.0
    else:
        assert ij.converged and it.converged
        assert it.iterations == ij.iterations
        assert rj < 1e-6 and rt < 1e-6

"""ParaDiag frequency hierarchies stored as one real stencil pair
(``MGConfig.build_pair``) and the pair smoother (``fused_cheb_smooth_pair``):
the port against the JAX package, in float64 on the CPU.

* the pair hierarchy against the JAX package's per-frequency hierarchies,
  ``jax.vmap(config.build)`` of the blocks A_k = F + mu_k S (its
  ``_ParaDiagSweep``), on 2-D Q1 (three levels), hex Q1 and hex Q2 (two
  levels) with Dirichlet masks: per level and frequency W_F + mu_k W_S
  against ``Ws[k]``, and ``diags``, ``dinvs`` and ``lams`` to 1e-12,
  ``Ainv`` to 1e-11 (the coarse inverses' rounding);
* the pair smoother's plain twin against ``_cheb_plain`` on the formed
  planes W_F + mu_k W_S (1e-12), and against the TPU kernels
  ``_fused_cheb_complex`` (2-D, K3) and ``_fused_cheb_nd3`` (3-D, C = 2,
  K5 complex) on the formed planes in Pallas interpret mode (1e-12: the
  same float64 recurrence, summed in another order);
* the V-cycle on a pair hierarchy against the one on per-frequency
  hierarchies, ``index_params``/``flip_params``/``store`` on a pair, which
  hierarchy a ParaDiag sweep builds, and the CUDA wrapper's refusals
  before any launch.

The tests marked ``gpu`` hold the kernel against its twin on the card
(3-D degree 1-3 and 2-D degree 1, complex64 and complex128, ragged
frequency chunks); they skip elsewhere.  Whole ParaDiag solves against
the JAX package stay in ``test_torch_instationary.py``,
``test_torch_heat3d.py`` and ``test_torch_be.py``, which now run the pair.
"""

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
from control_tpu_torch.models.instationary import _ParaDiagSweep

TOL = 1e-12
ALPHA, N_ROWS = 1e-3, 5


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


def frequencies(n_f=3, n=N_ROWS, alpha=ALPHA):
    """The ParaDiag frequencies mu_k = alpha^(1/n) e^(-2 pi i k / n)."""
    return alpha ** (1.0 / n) * np.exp(-2j * np.pi * np.arange(n_f) / n)


# ---------------------------------------------------------------------------
# the pair hierarchy against the JAX package's per-frequency hierarchies
# ---------------------------------------------------------------------------

# (dim, degree, cells per axis, coarse_max_dofs): 17^2 -> 9^2 -> 5^2,
# 9^3 -> 5^3 (Q1: 8^3 cells, Q2: 4^3)
HIERARCHIES = {"q1_2d": (2, 1, 16, 30), "q1_hex": (3, 1, 8, 600),
               "q2_hex": (3, 2, 4, 600)}


def _space(mod, dim, degree, n):
    kw = {"device": "cpu"} if mod is T else {}
    if dim == 2:
        mesh = mod.UnitSquareMesh(n, n, quadrilateral=True, dtype="float64",
                                  **kw)
    else:
        mesh = mod.UnitCubeMesh(n, n, n, dtype="float64", **kw)
    return mod.FunctionSpace(mesh, "Lagrange", degree)


def _factors(mod, sp):
    """Crank-Nicolson-shaped factors F = M + c K, S = -M + c K."""
    u, v = mod.TrialFunction(sp), mod.TestFunction(sp)
    M = mod.assemble(mod.inner(u, v) * mod.dx).A
    K = mod.assemble(mod.inner(mod.grad(u), mod.grad(v)) * mod.dx).A
    return M + 0.05 * K, -M + 0.05 * K


@pytest.fixture(scope="module", params=sorted(HIERARCHIES))
def hierarchies(request):
    """The JAX package's per-frequency params and the port's pair."""
    dim, degree, n, cmax = HIERARCHIES[request.param]
    mu = frequencies()
    out = []
    for mod, cfg_mod in ((J, jm), (T, tm)):
        sp = _space(mod, dim, degree, n)
        mask = mod.DirichletBC(sp, 0.0).mask
        cfg = cfg_mod.MGConfig(sp, mask, coarse_max_dofs=cmax, pre=3,
                               post=2)
        F, S = _factors(mod, sp)
        if mod is J:
            A_k = (F.astype(jnp.complex128)[None]
                   + jnp.asarray(mu)[:, None, None, None] * S[None])
            # hex Q2's jitted K = 125 build compiles for ~95 s here, op
            # by op for ~35 s; the Q1 builds compile faster jitted
            build = jax.vmap(cfg.build)
            out.append((build if degree > 1 else jax.jit(build))(A_k))
        else:
            out.append(cfg.build_pair(F, S, torch.as_tensor(mu)))
        out.append(cfg)
    pj, cj, pt, ct = out
    assert len(cj.spaces) == len(ct.spaces) == (3 if dim == 2 else 2)
    return request.param, pj, pt


@pytest.mark.parametrize("key", ["Ws", "diags", "dinvs"])
def test_pair_planes_match_jax_per_frequency(hierarchies, key):
    """Per level and frequency: W_F + mu_k W_S against the JAX package's
    ``Ws[k]``, and the diagonals and inverse diagonals of each W_k."""
    _, pj, pt = hierarchies
    formed = tm.form_planes(pt)
    assert len(pj[key]) == len(formed[key])
    for a, b in zip(pj[key], formed[key]):
        assert b.shape[0] == len(frequencies())
        for k in range(b.shape[0]):
            close(a[k], b[k])


def test_pair_bounds_and_coarse_inverses_match_jax(hierarchies):
    """The Gershgorin bounds (n, levels) to 1e-12 and the coarsest dense
    inverses of F_c + mu_k S_c to 1e-11, frequency by frequency."""
    _, pj, pt = hierarchies
    close(pj["lams"], pt["lams"])
    for k in range(pt["Ainv"].shape[0]):
        close(pj["Ainv"][k], pt["Ainv"][k], tol=1e-11)


def test_pair_storage(hierarchies):
    """A level's pair is two real (K, *grid) stencils shared by every
    frequency: the JAX package's per-frequency weights, n_f complex
    volumes, hold n_f times the pair's reals."""
    name, pj, pt = hierarchies
    assert set(pt) == {"WF", "WS", "mu", "diags", "dinvs", "lams", "Ainv"}
    for wF, wS, wj in zip(pt["WF"], pt["WS"], pj["Ws"]):
        assert not wF.is_complex() and wF.dtype == torch.float64
        assert wF.shape == wS.shape == tuple(wj.shape[1:])
        assert 2 * wj.size == len(frequencies()) * (wF.numel()
                                                    + wS.numel())


# ---------------------------------------------------------------------------
# the pair smoother's twin against _cheb_plain and the TPU kernels
# ---------------------------------------------------------------------------

def _pair(rng, grid, degree, n_f):
    """A random real stencil pair (W_F diagonally dominant), frequencies,
    the per-frequency inverse diagonals of W_F + mu_k W_S and their
    Gershgorin Chebyshev bounds (theta, delta), numpy."""
    nd = len(grid)
    K = (2 * degree + 1) ** nd
    centre = (Ellipsis, K // 2) + (slice(None),) * nd
    wF = -0.5 * rng.uniform(0.2, 1.0, (K,) + grid) * 9.0 / K
    wF[centre] = 4.0 + rng.uniform(0.0, 1.0, grid)
    wS = 0.3 * rng.uniform(-1.0, 1.0, (K,) + grid) * 9.0 / K
    mu = frequencies(n_f)
    Wk = wF[None] + mu.reshape((-1,) + (1,) * (nd + 1)) * wS[None]
    dk = Wk[(slice(None), K // 2)]
    lam = 1.05 * (np.abs(Wk).sum(axis=1) / np.abs(dk)).max(
        axis=tuple(range(1, nd + 1)))
    return wF, wS, mu, 1.0 / dk, 0.5 * (lam + lam / 4), 0.5 * (lam - lam / 4)


def _field(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _formed(wF, wS, mu):
    nd = wF.dim() - 1
    return wF[None] + mu.reshape((-1,) + (1,) * (nd + 1)) * wS[None]


@pytest.mark.parametrize("nd,degree", [(2, 1), (2, 2), (2, 3), (3, 1),
                                       (3, 2)])
@pytest.mark.parametrize("layout", ["per_frequency", "shared", "unbatched"])
def test_pair_twin_matches_cheb_plain_on_formed_planes(nd, degree, layout):
    """``_cheb_pair_plain`` (A_k x = W_F x + mu_k W_S x) against
    ``_cheb_plain`` on the formed planes W_F + mu_k W_S: per-frequency
    dinv, x0 and (n,) bounds; a shared dinv and x0 with scalar bounds; one
    unbatched frequency.  Residual on and off, 1 and 3 steps."""
    rng = np.random.default_rng(40 + 3 * nd + degree)
    grid = (7, 8, 9)[3 - nd:] if degree < 3 else (11, 12)
    n_f = 3
    wF, wS, mu, dinv, theta, delta = (torch.as_tensor(a) for a in
                                      _pair(rng, grid, degree, n_f))
    b = torch.as_tensor(_field(rng, (n_f,) + grid))
    x0 = torch.as_tensor(_field(rng, (n_f,) + grid))
    if layout == "shared":
        dinv, x0 = dinv[1], x0[0]
        theta, delta = float(theta[1]), float(delta[1])
    elif layout == "unbatched":
        mu, dinv, b, x0 = mu[2], dinv[2], b[2], x0[2]
        theta, delta = theta[2], delta[2]
    W = _formed(wF, wS, mu.reshape(-1))
    W = W[0] if layout == "unbatched" else W
    for steps in (1, 3):
        got = ts.fused_cheb_smooth_pair(wF, wS, mu, dinv, b, x0, steps,
                                        theta, delta, degree,
                                        want_residual=True, nd=nd)
        ref = ts._cheb_plain(W, dinv, b, x0, steps, theta, delta, degree,
                             want_residual=True, nd=nd)
        close(ref[0].numpy(), got[0])
        close(ref[1].numpy(), got[1])
        close(ref[0].numpy(), ts.fused_cheb_smooth_pair(
            wF, wS, mu, dinv, b, x0, steps, theta, delta, degree, nd=nd))


@pytest.mark.parametrize("nd,degree,steps", [(2, 1, 3), (2, 2, 2),
                                             (3, 1, 2)])
def test_pair_twin_matches_tpu_kernels(nd, degree, steps):
    """The twin against the JAX package's TPU kernels on the formed
    planes, in Pallas interpret mode: ``_fused_cheb_complex`` (K3) in 2-D,
    ``_fused_cheb_nd3`` (K5 complex, C = 2) in 3-D; per-frequency planes,
    dinv and bounds, residual on."""
    rng = np.random.default_rng(60 + 3 * nd + degree)
    grid = (11, 12) if nd == 2 else (4, 5, 6)
    n_f = 2
    wF, wS, mu, dinv, theta, delta = _pair(rng, grid, degree, n_f)
    b, x0 = _field(rng, (n_f,) + grid), _field(rng, (n_f,) + grid)
    W = _formed(torch.as_tensor(wF), torch.as_tensor(wS),
                torch.as_tensor(mu)).numpy()
    kernel = js._fused_cheb_complex if nd == 2 else js._fused_cheb_nd3
    ref = kernel(jnp.asarray(W), jnp.asarray(dinv), jnp.asarray(b),
                 jnp.asarray(x0), steps, jnp.asarray(theta),
                 jnp.asarray(delta), degree, want_residual=True,
                 interpret=True)
    t = torch.as_tensor
    got = ts.fused_cheb_smooth_pair(t(wF), t(wS), t(mu), t(dinv), t(b),
                                    t(x0), steps, t(theta), t(delta), degree,
                                    want_residual=True, nd=nd)
    close(ref[0], got[0])
    close(ref[1], got[1])


# ---------------------------------------------------------------------------
# the V-cycle, the params helpers, the sweep's choice of hierarchy
# ---------------------------------------------------------------------------

def _port_hierarchy(n=8):
    sp = _space(T, 3, 1, n)
    bc = T.DirichletBC(sp, 0.0)
    cfg = tm.MGConfig(sp, bc.mask, coarse_max_dofs=600, pre=3, post=2)
    F, S = _factors(T, sp)
    mu = torch.as_tensor(frequencies())
    A_k = (F.to(torch.complex128)[None]
           + mu[:, None, None, None] * S.to(torch.complex128)[None])
    return sp, bc.mask, cfg, F, S, mu, cfg.build_pair(F, S, mu), \
        cfg.build(A_k)


def test_pair_vcycle_matches_per_frequency_hierarchies():
    """Two V-cycles on the pair hierarchy against two on the per-frequency
    hierarchies ``build`` makes of the blocks A_k (1e-12); the same for
    ``index_params`` (one frequency) and ``flip_params`` (reversed)."""
    sp, mask, cfg, _, _, mu, pp, pf = _port_hierarchy()
    rng = np.random.default_rng(3)
    b = torch.as_tensor(_field(rng, (len(mu),) + sp.grid_shape))
    b[:, mask] = 0.0
    ref = cfg.apply(pf, b, cycles=2)
    close(ref.numpy(), cfg.apply(pp, b, cycles=2))
    close(ref[1].numpy(), cfg.apply(tm.index_params(pp, 1), b[1], cycles=2))
    flipped = cfg.apply(tm.flip_params(pp), torch.flip(b, (0,)), cycles=2)
    close(ref.numpy(), torch.flip(flipped, (0,)))


def test_store_of_a_pair():
    """Without a narrower ``weight_dtype`` a pair passes ``store``
    untouched; with one (float32 planes under complex128 fields) its
    per-frequency planes are formed and stored narrow, the layout of a
    narrow ``build``."""
    sp, mask, cfg, _, _, mu, pp, pf = _port_hierarchy()
    assert cfg.store(pp) is pp
    narrow = tm.MGConfig(sp, mask, coarse_max_dofs=600, pre=3, post=2,
                         weight_dtype="float32")
    stored = narrow.store(pp)
    formed = tm.form_planes(pp)
    assert set(stored) == set(pf) and "WF" not in stored
    for got, full in zip(stored["Ws"] + stored["dinvs"],
                         formed["Ws"] + formed["dinvs"]):
        assert got.dtype == torch.float32
        assert torch.equal(got, ts.narrow_planes(full, "float32"))


@pytest.mark.parametrize("weight_dtype,pair", [(None, True),
                                               ("float64", True),
                                               ("float32", False)])
def test_paradiag_sweep_builds_the_pair(weight_dtype, pair):
    """A ParaDiag sweep builds the stencil pair unless its weight planes
    are stored narrower than the problem (float64 here); level 0's pair
    is the defect correction's exact factor stencils, not a copy.  Both
    solve alike (float32 planes: to their rounding)."""
    sp, mask, _, F, S, _, _, _ = _port_hierarchy(4)
    kw = dict(alpha=ALPHA, smooth=(3, 2))
    sweep = _ParaDiagSweep(sp, mask, F[None], S[None], N_ROWS,
                           weight_dtype=weight_dtype, **kw)
    params = sweep.state["params"]
    assert ("WF" in params) == pair
    assert ("Ws" in params) == (not pair)
    if pair:
        assert params["WF"][0] is sweep._wF and params["WS"][0] is sweep._wS
        close(ts.node_stencil(S, sp, mask=mask, alpha=0.0).numpy(),
              sweep._wS, 0.0)
    else:
        assert params["Ws"][0].dtype == torch.float32
    rng = np.random.default_rng(5)
    b = torch.as_tensor(rng.standard_normal((N_ROWS,) + sp.grid_shape))
    b[:, mask] = 0.0
    ref = _ParaDiagSweep(sp, mask, F[None], S[None], N_ROWS, **kw)
    close(ref.solve(b).numpy(), sweep.solve(b), TOL if pair else 1e-6)


def test_paradiag_sweep_takes_per_frequency_state():
    """A state with per-frequency planes (as ``utils.convert`` carries the
    JAX package's) builds a sweep that keeps them and solves as the
    pair's to 1e-12."""
    sp, mask, _, F, S, _, _, _ = _port_hierarchy(4)
    own = _ParaDiagSweep(sp, mask, F[None], S[None], N_ROWS, alpha=ALPHA)
    state = dict(own.state, params=tm.form_planes(own.state["params"]))
    carried = _ParaDiagSweep(sp, mask, F[None], S[None], N_ROWS,
                             alpha=ALPHA, state=state)
    assert "Ws" in carried.params and "WF" not in carried.params
    rng = np.random.default_rng(6)
    b = torch.as_tensor(rng.standard_normal((N_ROWS,) + sp.grid_shape))
    b[:, mask] = 0.0
    close(own.solve(b).numpy(), carried.solve(b))
    close(own.solve(b, reverse=True).numpy(), carried.solve(b, reverse=True))


# ---------------------------------------------------------------------------
# the CUDA wrapper's refusals (before any launch) and the CPU dispatch
# ---------------------------------------------------------------------------

def _cpu_pair(dtype=torch.complex128, degree=1, grid=(5, 6, 7), n=3):
    rng = np.random.default_rng(9)
    wF, wS, mu, dinv, theta, delta = (torch.as_tensor(a) for a in
                                      _pair(rng, grid, degree, n))
    rdt = dtype.to_real()
    b = torch.as_tensor(_field(rng, (n,) + grid)).to(dtype)
    return (wF.to(rdt), wS.to(rdt), mu.to(dtype), dinv.to(dtype), b,
            torch.zeros_like(b), 2, theta, delta)


@pytest.mark.parametrize("case", ["real_fields", "complex_weights",
                                  "weights_of_another_dtype",
                                  "batched_weights", "shape_mismatch",
                                  "mu_count", "dinv_dtype", "degree"])
def test_pair_wrapper_refuses_before_launch(case, monkeypatch):
    """What the kernel does not take raises before the kernel library is
    loaded: real fields, complex or mistyped pair weights, per-frequency
    (batched) weights, a pair off the fields' grid, one mu per frequency
    missing, dinv of another dtype, a degree with no kernel."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(kernels, "library", no_library)
    wF, wS, mu, dinv, b, x0, steps, th, de = _cpu_pair()
    degree, nd = 1, 3
    err = (TypeError, ValueError)
    if case == "real_fields":
        b, x0, dinv = b.real, x0.real, dinv.real
    elif case == "complex_weights":
        wF = wF.to(torch.complex128)
    elif case == "weights_of_another_dtype":
        wS = wS.float()
    elif case == "batched_weights":
        wF, wS = wF[None].expand(3, *wF.shape), wS[None].expand(3, *wS.shape)
    elif case == "shape_mismatch":
        wF, wS = wF[..., :-1], wS[..., :-1]
    elif case == "mu_count":
        mu = mu[:2]
    elif case == "dinv_dtype":
        dinv = dinv.to(torch.complex64)
    elif case == "degree":
        K = 9 ** 3
        wF = torch.zeros((K,) + tuple(b.shape[1:]), dtype=torch.float64)
        wS, degree, err = wF.clone(), 4, NotImplementedError
    with pytest.raises(err):
        ts._cheb_pair_cuda(wF, wS, mu, dinv, b, x0, steps, th, de, degree,
                           True, nd)


def test_cpu_tensors_run_the_twin(monkeypatch):
    """CPU tensors never reach the kernel library, nor count a launch."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(kernels, "library", no_library)
    before = dict(ts.launch_counts)
    wF, wS, mu, dinv, b, x0, steps, th, de = _cpu_pair()
    ts.fused_cheb_smooth_pair(wF, wS, mu, dinv, b, x0, steps, th, de, 1,
                              want_residual=True, nd=3)
    assert ts.launch_counts == before
    assert {"cheb_smooth_pair_2d", "cheb_smooth_pair_2d_q3",
            "cheb_smooth_pair_2d_q4", "cheb_smooth_pair_3d",
            "cheb_smooth_pair_3d_q2",
            "cheb_smooth_pair_3d_q3"} <= set(ts.launch_counts)
    assert not any(k.startswith("cheb_smooth_pair") and k.endswith(tag)
                   for k in ts.launch_counts for tag in ("bf16", "f16",
                                                         "f32"))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("nd,degree", [(3, 1), (3, 2), (3, 3), (2, 1)])
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_pair_kernel_matches_twin_on_card(nd, degree, dtype):
    """The kernel against its twin on the same CUDA tensors: nine
    frequencies (ragged chunks: 8 + 1 in complex64, 4 + 4 + 1 in
    complex128) on an odd grid, per-frequency dinv and (n,) bounds, 1 and
    4 steps, residual on and off; a shared dinv and x0 with scalar bounds;
    one unbatched frequency.  Tolerance 1e-12 in complex128, 1e-4 in
    complex64 (another summation order).  Each call counts one launch of
    its key, and no per-frequency kernel launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    rdt = dt.to_real()
    tol = 1e-12 if dt == torch.complex128 else 1e-4
    rng = np.random.default_rng(70 + 3 * nd + degree)
    grid = (9, 13, 37) if nd == 3 else (45, 71)
    n = 9
    wF, wS, mu, dinv, theta, delta = _pair(rng, grid, degree, n)

    def cu(a, d=dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=d,
                               device="cuda")

    wF, wS, th, de = cu(wF, rdt), cu(wS, rdt), cu(theta, rdt), cu(delta,
                                                                   rdt)
    mu, dinv = cu(mu), cu(dinv)
    b, x0 = cu(_field(rng, (n,) + grid)), cu(_field(rng, (n,) + grid))

    def rel(got, ref):
        return float((got - ref).abs().max() / ref.abs().max())

    key = ts._pair_key(degree, nd)
    before = dict(ts.launch_counts)
    calls = 0
    cases = [(mu, dinv, b, x0, th, de),
             (mu, dinv[0], b, x0[0], float(theta[0]), float(delta[0])),
             (mu[3], dinv[3], b[3], x0[3], th[3], de[3])]
    for m, d, bb, xx, t, e in cases:
        for steps in (1, 4):
            got = ts.fused_cheb_smooth_pair(wF, wS, m, d, bb, xx, steps, t,
                                            e, degree, want_residual=True,
                                            nd=nd)
            ref = ts._cheb_pair_plain(wF, wS, m, d, bb, xx, steps, t, e,
                                      degree, want_residual=True, nd=nd)
            assert rel(got[0], ref[0]) <= tol
            assert rel(got[1], ref[1]) <= tol
            assert rel(ts.fused_cheb_smooth_pair(
                wF, wS, m, d, bb, xx, steps, t, e, degree, nd=nd),
                ref[0]) <= tol
            calls += 2
    torch.cuda.synchronize()
    assert ts.launch_counts[key] == before[key] + calls
    for k, v in ts.launch_counts.items():
        if k != key:
            assert v == before[k], k


@pytest.mark.gpu
def test_pair_vcycle_on_card_launches_the_pair():
    """A V-cycle on the pair hierarchy on the card agrees with the CPU's
    to 1e-12 and launches only the pair smoother among the smoothers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sp, mask, cfg, F, S, mu, pp, _ = _port_hierarchy()
    rng = np.random.default_rng(4)
    b = torch.as_tensor(_field(rng, (len(mu),) + sp.grid_shape))
    b[:, mask] = 0.0
    ref = cfg.apply(pp, b, cycles=2)
    spc = T.FunctionSpace(T.UnitCubeMesh(8, 8, 8, dtype="float64",
                                         device="cuda"), "Lagrange", 1)
    cfgc = tm.MGConfig(spc, mask.cuda(), coarse_max_dofs=600, pre=3, post=2)
    ppc = cfgc.build_pair(F.cuda(), S.cuda(), mu.cuda())
    ts.reset_launch_counts()
    got = cfgc.apply(ppc, b.cuda(), cycles=2)
    torch.cuda.synchronize()
    close(ref.numpy(), got.cpu())
    launched = {k for k, v in ts.launch_counts.items() if v}
    assert launched == {"cheb_smooth_pair_3d"}

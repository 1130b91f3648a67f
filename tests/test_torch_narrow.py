"""Narrow weight planes (``weight_dtype``) of the fused Chebyshev smoothers
K2, K3 and K5: the port against the JAX package, in float64 fields on the
CPU.

* ``narrow_planes`` stores planes as the JAX package's ``astype`` rounds
  them, bit for bit (float64 to bfloat16 through float32, float64 to
  float16 directly), complex planes as (re, im) pairs;
* the plain versions on planes stored narrow against the TPU kernels with
  the same ``weight_dtype`` in Pallas interpret mode: K3
  (``_fused_cheb_complex``) and K5 (``_fused_cheb_nd3``, complex and real,
  degree 1 and 2); K2's TPU kernel takes no interpret flag, so K2 is held
  to the reference's own fallback, which rounds as its kernel does.
  Tolerance 1e-12 relative (the same float64 recurrence on the same
  rounded weights, summed in another order);
* the multigrid hierarchy stores its planes narrow once per build, from
  full-precision bounds;
* the CUDA wrapper's checks refuse planes that do not fit their fields
  before any launch.

The tests marked ``gpu`` hold the narrow kernels against their plain
versions on the card, show which kernel each ``weight_dtype`` runs, and
that the card makes the CPU's narrow planes bit for bit; they skip
elsewhere.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from control_tpu.ops import stencil as js
from control_tpu.solvers import multigrid as jm
import control_tpu as J
import control_tpu_torch as T
from control_tpu_torch.ops import stencil as ts
from control_tpu_torch.ops import kernels
from control_tpu_torch.solvers import multigrid as tm

TOL = 1e-12
GRID3 = (4, 5, 6)


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


def _stencil(rng, lead, grid, cplx, degree=1):
    """A diagonally dominant (2 degree + 1)^nd-point stencil and its inverse
    diagonal, float64 or complex128."""
    K = (2 * degree + 1) ** len(grid)
    w = -0.5 * rng.uniform(0.2, 1.0, lead + (K,) + grid) * 9.0 / K
    centre = (Ellipsis, K // 2) + (slice(None),) * len(grid)
    w[centre] = 4.0 + rng.uniform(0.0, 1.0, lead + grid)
    if cplx:
        w = w * np.exp(1j * rng.uniform(-0.3, 0.3, w.shape))
    return w, 1.0 / w[centre]


def _field(rng, shape, cplx):
    a = rng.standard_normal(shape)
    return a + 1j * rng.standard_normal(shape) if cplx else a


def _jax_narrow(a, wd):
    """The JAX package's storage of planes ``a`` in ``wd``, widened back."""
    a = jnp.asarray(a)
    if jnp.iscomplexobj(a):
        return np.stack([np.asarray(jnp.real(a).astype(wd).astype(
            jnp.float64)), np.asarray(jnp.imag(a).astype(wd).astype(
                jnp.float64))], axis=-1)
    return np.asarray(a.astype(wd).astype(jnp.float64))


# ---------------------------------------------------------------------------
# the narrow storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,wd", [
    ("float64", "bfloat16"), ("float64", "float16"), ("float64", "float32"),
    ("float32", "bfloat16"), ("float32", "float16"),
    ("complex128", "bfloat16"), ("complex128", "float16"),
    ("complex128", "float32"), ("complex64", "bfloat16")])
def test_narrow_planes_equal_jax_astype(src, wd):
    """Every value rounds as the JAX package's ``astype`` rounds it, bit for
    bit, over eleven decades and the cases a second rounding through
    float32 would get wrong (ties of the narrow format just above a
    float32 tie, values past the narrow range, signed zeros)."""
    rng = np.random.default_rng(1)
    m = 20000
    a = rng.standard_normal(m) * 10.0 ** rng.integers(-6, 6, m)
    a = np.concatenate([a, [1 + 2 ** -11 + 2 ** -40, -(1 + 2 ** -8 + 2 **
                                                           -30),
                            7e4, -7e4, 65519.99, 0.0, -0.0, 1e-9]])
    if src.startswith("complex"):
        a = a + 1j * rng.permutation(a)
    a = a.astype(src)
    got = ts.narrow_planes(torch.as_tensor(a), wd)
    assert got.dtype == getattr(torch, wd)
    assert tuple(got.shape) == a.shape + ((2,) if a.dtype.kind == "c"
                                          else ())
    ref = _jax_narrow(a, wd)
    np.testing.assert_array_equal(got.double().numpy(), ref)


def test_weight_storage_dtype():
    """A weight dtype narrower than the fields' real dtype is stored; an
    equal or wider one rounds nothing and stores nothing."""
    f = ts.weight_storage_dtype
    assert f(None, torch.float32) is None
    assert f("bfloat16", torch.float32) == torch.bfloat16
    assert f("float16", torch.complex64) == torch.float16
    assert f("float32", torch.float64) == torch.float32
    assert f("float32", torch.complex128) == torch.float32
    assert f("float32", torch.float32) is None
    assert f("float64", torch.complex64) is None


def test_plain_version_takes_narrow_planes():
    """The plain version on planes stored narrow equals the plain version
    rounding the full planes itself, bit for bit."""
    rng = np.random.default_rng(2)
    w, dinv = _stencil(rng, (3,), (9, 10), True)
    b, x0 = _field(rng, (3, 9, 10), True), _field(rng, (3, 9, 10), True)
    W, D = torch.as_tensor(w), torch.as_tensor(dinv)
    bt, xt = torch.as_tensor(b), torch.as_tensor(x0)
    full = ts.fused_cheb_smooth(W, D, bt, xt, 3, 1.3, 0.6, 1,
                                want_residual=True, weight_dtype="bfloat16")
    narrow = ts.fused_cheb_smooth(ts.narrow_planes(W, "bfloat16"),
                                  ts.narrow_planes(D, "bfloat16"), bt, xt,
                                  3, 1.3, 0.6, 1, want_residual=True,
                                  weight_dtype="bfloat16")
    for a, c in zip(full, narrow):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# the plain versions against the TPU kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wd,shared", [("bfloat16", False),
                                       ("float16", False),
                                       ("float32", False),
                                       ("bfloat16", True)])
def test_narrow_k3_matches_tpu_kernel(wd, shared):
    """K3 with narrow planes (per-frequency or shared weights, (n,)
    bounds, residual on) against ``_fused_cheb_complex`` with the same
    ``weight_dtype``."""
    rng = np.random.default_rng(7)
    n, grid = 3, (11, 12)
    w, dinv = _stencil(rng, (1,) if shared else (n,), grid, True)
    dinv = np.array(np.broadcast_to(dinv, (n,) + grid))
    b, x0 = _field(rng, (n,) + grid, True), _field(rng, (n,) + grid, True)
    theta, delta = rng.uniform(1.0, 2.0, n), rng.uniform(0.3, 0.8, n)
    ref = js._fused_cheb_complex(
        jnp.asarray(w), jnp.asarray(dinv), jnp.asarray(b), jnp.asarray(x0),
        3, jnp.asarray(theta), jnp.asarray(delta), 1, want_residual=True,
        interpret=True, weight_dtype=wd)
    W = ts.narrow_planes(torch.as_tensor(w), wd)
    D = ts.narrow_planes(torch.as_tensor(dinv), wd)
    got = ts.fused_cheb_smooth(W, D, torch.as_tensor(b),
                               torch.as_tensor(x0), 3,
                               torch.as_tensor(theta),
                               torch.as_tensor(delta), 1,
                               want_residual=True, weight_dtype=wd)
    close(ref[0], got[0])
    close(ref[1], got[1])


@pytest.mark.parametrize("degree,cplx,wd,steps", [(1, True, "bfloat16", 2),
                                                  (1, True, "float32", 2),
                                                  (2, True, "bfloat16", 1),
                                                  (1, False, "bfloat16", 2),
                                                  (2, False, "float16", 2)])
def test_narrow_k5_matches_tpu_kernel(degree, cplx, wd, steps):
    """K5 with narrow planes (per-batch weights, (n,) bounds, residual on)
    against ``_fused_cheb_nd3`` with the same ``weight_dtype``: complex
    (the ParaDiag frequency blocks) at degree 1 and 2, real at both.  The
    complex degree-2 case takes one step (two stencil passes with the
    narrow planes): interpret mode spends some 30 s a step on its
    K = 125 complex program here."""
    rng = np.random.default_rng(11 + degree)
    n = 2
    w, dinv = _stencil(rng, (n,), GRID3, cplx, degree)
    b, x0 = _field(rng, (n,) + GRID3, cplx), _field(rng, (n,) + GRID3, cplx)
    theta, delta = rng.uniform(1.0, 2.0, n), rng.uniform(0.3, 0.8, n)
    ref = js._fused_cheb_nd3(
        jnp.asarray(w), jnp.asarray(dinv), jnp.asarray(b), jnp.asarray(x0),
        steps, jnp.asarray(theta), jnp.asarray(delta), degree,
        want_residual=True, interpret=True, weight_dtype=wd)
    got = ts.fused_cheb_smooth(
        ts.narrow_planes(torch.as_tensor(w), wd),
        ts.narrow_planes(torch.as_tensor(dinv), wd), torch.as_tensor(b),
        torch.as_tensor(x0), steps, torch.as_tensor(theta),
        torch.as_tensor(delta), degree, want_residual=True,
        weight_dtype=wd, nd=3)
    close(ref[0], got[0])
    close(ref[1], got[1])


@pytest.mark.parametrize("wd", ["bfloat16", "float16", "float32"])
def test_narrow_k2_matches_reference(wd):
    """K2 with narrow planes (shared weights and dinv, scalar bounds)
    against the reference's fallback, which rounds its planes as its TPU
    kernel stores them."""
    rng = np.random.default_rng(5)
    w, dinv = _stencil(rng, (), (13, 14), False)
    b = _field(rng, (4, 13, 14), False)
    ref = js.fused_cheb_smooth(jnp.asarray(w), jnp.asarray(dinv),
                               jnp.asarray(b), jnp.zeros_like(b), 5, 1.4,
                               0.6, 1, want_residual=True, use_pallas=False,
                               weight_dtype=wd)
    got = ts.fused_cheb_smooth(ts.narrow_planes(torch.as_tensor(w), wd),
                               ts.narrow_planes(torch.as_tensor(dinv), wd),
                               torch.as_tensor(b),
                               torch.zeros(4, 13, 14, dtype=torch.float64),
                               5, 1.4, 0.6, 1, want_residual=True,
                               weight_dtype=wd)
    close(ref[0], got[0])
    close(ref[1], got[1])


# ---------------------------------------------------------------------------
# the multigrid hierarchy
# ---------------------------------------------------------------------------

def _complex_hierarchy_ops(n=2):
    """Local matrices of two complex frequency operators F + mu_k S on a
    Q1 17^2 mesh with its Dirichlet mask (the ParaDiag V-cycles' kind)."""
    mt = T.UnitSquareMesh(16, 16, quadrilateral=True, dtype="float64",
                          device="cpu")
    st = T.FunctionSpace(mt, "Lagrange", 1)
    u, v = T.TrialFunction(st), T.TestFunction(st)
    K = T.assemble(T.inner(T.grad(u), T.grad(v)) * T.dx).A
    M = T.assemble(T.inner(u, v) * T.dx).A
    mu = torch.as_tensor([0.3 + 0.1j, -0.2 + 0.4j][:n],
                         dtype=torch.complex128)
    A = (K + 2.0 * M).to(torch.complex128)[None] \
        + mu[:, None, None, None] * M.to(torch.complex128)[None]
    return st, T.DirichletBC(st, 0.0).mask, A


def test_hierarchy_stores_narrow_planes_once():
    """With a narrower ``weight_dtype`` the build stores every level's
    weights and inverse diagonal narrow, as (re, im) pairs, with the
    bounds and diagonals of the full planes; storing them again changes
    nothing; a V-cycle equals the JAX package's with the same
    ``weight_dtype`` (which rounds full planes at every smoothing)."""
    st, mask, A = _complex_hierarchy_ops()
    full = tm.MGConfig(st, mask, coarse_max_dofs=100, pre=3, post=3)
    cfg = tm.MGConfig(st, mask, coarse_max_dofs=100, pre=3, post=3,
                      weight_dtype="bfloat16")
    pf, pn = full.build(A), cfg.build(A)
    assert len(pn["Ws"]) == 2
    for wf, wn, df, dn in zip(pf["Ws"], pn["Ws"], pf["dinvs"],
                              pn["dinvs"]):
        assert wn.dtype == dn.dtype == torch.bfloat16
        assert tuple(wn.shape) == tuple(wf.shape) + (2,)
        assert torch.equal(wn, ts.narrow_planes(wf, "bfloat16"))
        assert torch.equal(dn, ts.narrow_planes(df, "bfloat16"))
    assert torch.equal(pf["lams"], pn["lams"])
    for a, c in zip(pf["diags"], pn["diags"]):
        assert torch.equal(a, c)
    again = cfg.store(pn)
    assert all(a is c for a, c in zip(again["Ws"], pn["Ws"]))

    rng = np.random.default_rng(8)
    b = np.where(mask.numpy()[None], 0.0,
                 _field(rng, (2,) + st.grid_shape, True))
    mj = J.UnitSquareMesh(16, 16, quadrilateral=True, dtype="float64")
    sj = J.FunctionSpace(mj, "Lagrange", 1)
    cj = jm.MGConfig(sj, jnp.asarray(mask.numpy()), coarse_max_dofs=100,
                     pre=3, post=3, weight_dtype="bfloat16")
    pj = jax.vmap(cj.build)(jnp.asarray(A.numpy()))
    ref = cj.apply(pj, jnp.asarray(b))
    close(ref, cfg.apply(pn, torch.as_tensor(b)))


def test_cuda_wrapper_refuses_planes_that_do_not_fit(monkeypatch):
    """The CUDA wrapper's checks run before the kernel library is asked
    for: planes stored in a dtype no narrower than the fields, planes of
    another ``weight_dtype`` than asked, complex fields with unpaired
    planes, and vector stencils with narrow planes raise."""
    def no_library():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(kernels, "library", no_library)
    x = torch.zeros(2, 5, 6, dtype=torch.float32)
    wb = torch.zeros(9, 5, 6, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        ts._cheb_cuda(wb, wb[0], x, x, 2, 1.0, 0.5, 1, False, 2,
                      weight_dtype="float16")
    wd = torch.zeros(9, 5, 6, dtype=torch.float64)
    with pytest.raises(TypeError):
        ts._cheb_cuda(wd, wd[0], x, x, 2, 1.0, 0.5, 1, False, 2)
    xc = torch.zeros(2, 5, 6, dtype=torch.complex64)
    with pytest.raises(TypeError):
        ts._cheb_cuda(wb, wb[0], xc, xc, 2, 1.0, 0.5, 1, False, 2)
    xv = torch.zeros(5, 6, 2, dtype=torch.float32)
    wv = torch.zeros(25, 5, 6, 2, 2, dtype=torch.float32)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(NotImplementedError, match="K4, K5v"):
        ts.fused_cheb_smooth(wv, xv, xv, xv, 2, 1.0, 0.5, 2,
                             weight_dtype="bfloat16")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


NARROW_CASES = [
    # (nd, degree, field dtype, weight dtype, shared weights)
    (2, 1, "complex64", "bfloat16", False),
    (2, 1, "complex64", "float16", True),
    (2, 2, "complex128", "float32", False),
    (2, 1, "float32", "bfloat16", True),
    (2, 2, "float64", "bfloat16", False),
    (3, 1, "complex64", "bfloat16", False),
    (3, 2, "complex64", "bfloat16", False),
    (3, 1, "complex128", "float32", False),
    (3, 2, "complex128", "float16", True),
    (3, 1, "float32", "float16", True),
    (3, 2, "float64", "float32", False),
    (3, 1, "float64", "bfloat16", False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", NARROW_CASES, ids=str)
def test_narrow_kernels_match_plain_versions_on_card(case):
    """The narrow K2/K3/K5 kernels against ``_cheb_plain`` on the same CUDA
    tensors (planes stored narrow), over 2-D and 3-D, degree 1 and 2,
    real and complex fields, shared and per-batch weights, 1 and 4 steps,
    residual on and off; each launch counted under its narrow key.
    Tolerance 1e-12 in double-precision fields, 1e-4 in single (another
    summation order over 4 steps)."""
    dev = _cuda()
    nd, degree, fdt, wd, shared = case
    dt = getattr(torch, fdt)
    cplx = dt.is_complex
    tol = 1e-12 if dt in (torch.float64, torch.complex128) else 1e-4
    rng = np.random.default_rng(41)
    n = 3
    grid = (7, 9, 11) if nd == 3 else (37, 45)
    w, dinv = _stencil(rng, (1,) if shared else (n,), grid, cplx, degree)
    dinv = np.broadcast_to(dinv, (n,) + grid)
    W = ts.narrow_planes(torch.as_tensor(w, dtype=dt, device=dev), wd)
    D = ts.narrow_planes(torch.as_tensor(np.ascontiguousarray(dinv),
                                         dtype=dt, device=dev), wd)
    b = torch.as_tensor(_field(rng, (n,) + grid, cplx), dtype=dt,
                        device=dev)
    x0 = torch.as_tensor(_field(rng, (n,) + grid, cplx), dtype=dt,
                         device=dev)
    rdt = b.real.dtype
    th = torch.as_tensor(rng.uniform(1.0, 2.0, n), dtype=rdt, device=dev)
    de = torch.as_tensor(rng.uniform(0.3, 0.8, n), dtype=rdt, device=dev)
    kind = "complex" if cplx else "real"
    key = (f"cheb_smooth_3d_{kind}" + ("_q2" if degree == 2 else "")
           if nd == 3 else f"cheb_smooth_{kind}")
    key += "_" + {"bfloat16": "bf16", "float16": "f16",
                  "float32": "f32"}[wd]
    before = ts.launch_counts[key]

    def rel(got, ref):
        return float((got - ref).abs().max() / ref.abs().max())

    for steps in (1, 4):
        got = ts.fused_cheb_smooth(W, D, b, x0, steps, th, de, degree,
                                   want_residual=True, nd=nd)
        ref = ts._cheb_plain(W, D, b, x0, steps, th, de, degree,
                             want_residual=True, nd=nd)
        assert rel(got[0], ref[0]) <= tol
        assert rel(got[1], ref[1]) <= tol
        assert rel(ts.fused_cheb_smooth(W, D, b, x0, steps, th, de, degree,
                                        weight_dtype=wd, nd=nd),
                   ref[0]) <= tol
    torch.cuda.synchronize()
    assert ts.launch_counts[key] == before + 4


@pytest.mark.gpu
@pytest.mark.parametrize("wd", ["bfloat16", "float16", "float32"])
def test_card_makes_the_cpu_narrow_planes(wd):
    """``narrow_planes`` on the card gives the CPU's bits for the same
    float64 and complex128 input (torch's cast, no device intrinsic: CUDA's
    own double -> bfloat16 rounding would differ on 1 + 2^-8 + 2^-30)."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    a = rng.standard_normal(50000) * 10.0 ** rng.integers(-6, 6, 50000)
    a = np.concatenate([a, [1 + 2 ** -8 + 2 ** -30, 1 + 2 ** -11 + 2 **
                            -40, 65519.99]])
    for src in (a, a + 1j * rng.permutation(a)):
        cpu = ts.narrow_planes(torch.as_tensor(src), wd)
        card = ts.narrow_planes(torch.as_tensor(src, device=dev), wd)
        assert torch.equal(card.cpu(), cpu)


@pytest.mark.gpu
def test_weight_dtype_picks_the_kernel_on_card():
    """On the card: a narrower ``weight_dtype`` runs the narrow kernel on
    planes stored narrow, and refuses full planes (no cast inside a
    call); an equal or wider one runs the full-precision kernel on the
    planes as they are; vector stencils (K4, K5v) with a narrow one
    raise."""
    dev = _cuda()
    rng = np.random.default_rng(4)
    w, dinv = _stencil(rng, (), (33, 34), False)
    W = torch.as_tensor(w, dtype=torch.float32, device=dev)
    D = torch.as_tensor(dinv, dtype=torch.float32, device=dev)
    b = torch.as_tensor(_field(rng, (2, 33, 34), False),
                        dtype=torch.float32, device=dev)
    ts.reset_launch_counts()
    with pytest.raises(TypeError, match="narrow_planes first"):
        ts.fused_cheb_smooth(W, D, b, b, 3, 1.3, 0.6, 1,
                             weight_dtype="bfloat16")
    assert ts.launch_counts["cheb_smooth_real_bf16"] == 0
    stored = ts.fused_cheb_smooth(ts.narrow_planes(W, "bfloat16"),
                                  ts.narrow_planes(D, "bfloat16"), b, b, 3,
                                  1.3, 0.6, 1, weight_dtype="bfloat16")
    assert ts.launch_counts["cheb_smooth_real_bf16"] == 1
    # the CPU's plain version rounds the full planes in the call
    plain = ts.fused_cheb_smooth(W.cpu(), D.cpu(), b.cpu(), b.cpu(), 3, 1.3,
                                 0.6, 1, weight_dtype="bfloat16")
    assert float((stored.cpu() - plain).abs().max()
                 / plain.abs().max()) <= 1e-4
    for wide in ("float32", "float64", None):
        full = ts.fused_cheb_smooth(W, D, b, b, 3, 1.3, 0.6, 1,
                                    weight_dtype=wide)
        assert torch.equal(full, ts.fused_cheb_smooth(W, D, b, b, 3, 1.3,
                                                      0.6, 1))
    assert ts.launch_counts["cheb_smooth_real"] == 6
    assert ts.launch_counts["cheb_smooth_real_bf16"] == 1
    wv = torch.zeros(25, 9, 9, 2, 2, dtype=torch.float32, device=dev)
    xv = torch.zeros(9, 9, 2, dtype=torch.float32, device=dev)
    with pytest.raises(NotImplementedError, match="K4, K5v"):
        ts.fused_cheb_smooth(wv, xv, xv, xv, 2, 1.0, 0.5, 2,
                             weight_dtype="bfloat16")
    wv3 = torch.zeros(27, 5, 5, 5, 3, 3, dtype=torch.float64, device=dev)
    xv3 = torch.zeros(5, 5, 5, 3, dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError, match="K4, K5v"):
        ts.fused_cheb_smooth(wv3, xv3, xv3, xv3, 2, 1.0, 0.5, 1,
                             weight_dtype="float32", nd=3)
    assert ts.launch_counts["cheb_smooth_vector"] == 0
    assert ts.launch_counts["cheb_smooth_3d_vector"] == 0

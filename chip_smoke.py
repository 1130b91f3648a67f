#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (the CUDA toolkit) and the repository's
``control_tpu_torch`` package; imports nothing of JAX.  Phases, each of
which raises (and the script exits non-zero) on failure:

1. the card: refuses to run without CUDA; prints the card's name and power
   limit (``nvidia-smi``), the torch and nvcc versions;
2. builds the hand-written kernels (``control_tpu_torch/csrc``) with nvcc;
3. holds each kernel against its plain PyTorch version on the card, on
   inputs made from a numpy seed at the shapes of the path that runs it,
   in float64 (max relative error <= 1e-12) and float32 (<= 1e-5 for the
   applications K1/K6, <= 1e-4 for the smoothers K2/K3/K4/K5: the summation
   order differs), and times both with CUDA events: K1-K3 at the 2-D
   flagship's shapes, K6 and K5 (real, complex) at heat3d's, K4 at the
   Stokes path's (the velocity mass solve and the two smoothed V-cycle
   levels), K5v (3-D vector fields, dim = 3) at the stokes3d path's, K5
   (real, complex) and K6 at degree 2 at heat3d_q2's;
4. the 2-D slice: a small float64 solve on the card against the same solve
   on the CPU (plain versions), then the flagship heat-control KKT solve
   (Q1 256^2 x 64, Crank-Nicolson, ParaDiag Schur sweeps, GMRES(10), rtol
   1e-6, float32) through ``Control.Instationary(...).linear_solve``: solved
   once, then timed; it must converge below 1e-6 relative residual in at
   most 12 iterations with K1-K3 launched during the timed solve; then the
   default ``scan`` sweeps at the same size, once;
5. the 3-D slice, ``heat3d`` (``bench_extra.py``: hex Q1 64^3 x 16, CN,
   ParaDiag with its default settings, GMRES(10), rtol 1e-6, float32):
   small float64 solves (ParaDiag and scan, 8^3 x 8) on the card against
   the CPU, then the full-size solve, once and then timed; it must converge
   below 1e-6 in at most 10 iterations with K5 (real, complex) and K6
   launched during the timed solve; then the ``scan`` sweeps once;
6. the Stokes slice (``bench_extra.py``'s ``stokes``: Taylor-Hood Q2-Q1 on
   64^2 cells x 32 time steps, CN, beta = 1e-2, the nested preconditioner
   with the default ``scan`` sweeps, FGMRES(10), rtol 1e-6, at most 100
   iterations) through
   ``Control.Instationary(...).incompressible_linear_solve``: a small
   float64 solve (8^2 x 4) on the card against the CPU, then the full-width
   solve in float64, once and then timed; it must converge below 1e-6 with
   K4 and K2 launched during the timed solve.  In float32 this recipe
   stalls at this width, in the JAX package as in the port (each stage of
   the preconditioner is accurate to float32, the five fixed inner GMRES
   iterations amplify the difference), so float32 is a measurement here,
   not a target: its first 20 outer iterations run at full width and their
   residual history is printed beside float64's;
7. the 3-D Stokes slice, ``stokes3d`` (``tests/test_instationary_stokes3d.py``
   at production width: Taylor-Hood Q2-Q1 on hexahedra, 16^3 cells x 8
   time steps, CN, beta = 1e-2, FGMRES(10), rtol 1e-6, at most 100
   iterations, float64): a small float64 solve (2^3 x 3) on the card
   against the CPU, then the full-width solve, once and then timed; it
   must converge below 1e-6 with K5v and K5 (real) launched during the
   timed solve;
8. the Q2 heat slice, ``heat3d_q2`` (heat3d on Q2 hexahedra, 32^3 cells:
   65^3 nodes, x 16, float32, ParaDiag defaults): small float64 solves
   (ParaDiag and scan, 4^3 x 4) on the card against the CPU, then the
   full-size solve, once and then timed; it must converge below 1e-6 within
   the solver's budget with K5 (real, complex) and K6 at degree 2 launched
   during the timed solve; then the ``scan`` sweeps once;
9. prints ``{"kernels": [...]}``, a JSON line of each slice's numbers, and
   last ``{"ok": true, "device": {...}}``.

A full record goes to ``smoke_out/chip_smoke.json`` (git-ignored), the
ptxas register and spill report to ``smoke_out/ptxas.txt``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
OUT_DIR = "smoke_out"
REPEATS = 20
TOL = {("K1", "float64"): 1e-12, ("K1", "float32"): 1e-5,
       ("K2", "float64"): 1e-12, ("K2", "float32"): 1e-4,
       ("K3", "float64"): 1e-12, ("K3", "float32"): 1e-4,
       ("K6", "float64"): 1e-12, ("K6", "float32"): 1e-5,
       ("K5r", "float64"): 1e-12, ("K5r", "float32"): 1e-4,
       ("K5c", "float64"): 1e-12, ("K5c", "float32"): 1e-4,
       ("K4", "float64"): 1e-12, ("K4", "float32"): 1e-4,
       ("K5v", "float64"): 1e-12, ("K5v", "float32"): 1e-4,
       ("K6q2", "float64"): 1e-12, ("K6q2", "float32"): 1e-5,
       ("K5rq2", "float64"): 1e-12, ("K5rq2", "float32"): 1e-4,
       ("K5cq2", "float64"): 1e-12, ("K5cq2", "float32"): 1e-4}
FLAGSHIP = dict(n=256, n_t=64)
HEAT3D = dict(n=64, n_t=16, scan_n=64)
STOKES = dict(n=64, n_t=32, small_n=8, small_n_t=4, float32_budget=20)
STOKES3D = dict(n=16, n_t=8, small_n=2, small_n_t=3)
HEAT3D_Q2 = dict(n=32, n_t=16, small_n=4, small_n_t=4)
# the plain versions of the large 3-D rows are timed over fewer calls
PLAIN_REPEATS_3D = 3
# the H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores; float64 runs at half the rate
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 33.5e12}
SOLVER_PARAMETERS = {"linear_solver": "gmres", "gmres_restart": 10,
                     "maximum_iterations": 50, "relative_tolerance": 1.0e-6,
                     "absolute_tolerance": 0.0,
                     "monitor_convergence": False}
STOKES_PARAMETERS = {"linear_solver": "fgmres", "fgmres_restart": 10,
                     "maximum_iterations": 100, "relative_tolerance": 1.0e-6,
                     "absolute_tolerance": 0.0,
                     "monitor_convergence": False}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nvcc_version():
    from control_tpu_torch.ops import kernels
    out = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


def cuda_ms(fn, repeats=REPEATS):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(min(3, repeats)):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def in_turns(kernel_fn, plain_fn, plain_repeats=REPEATS):
    """Kernel and plain times measured plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn, plain_repeats)
    k1 = cuda_ms(kernel_fn)
    k2 = cuda_ms(kernel_fn)
    p2 = cuda_ms(plain_fn, plain_repeats)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def bound(nbytes, flops, dtype):
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``flops``:
    (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


def stencil_flops(K, x, applies):
    """Multiply-adds of ``applies`` K-point stencil applications to fields
    x (a complex multiply-add is 8 flops, a real one 2)."""
    return applies * K * x.numel() * (8 if x.is_complex() else 2)


def cheb_flops(K, b, steps, residual, dim=1):
    """The stencil work of a smoothing call plus its per-node updates (r, z,
    p, x: about 8 real flops per step, 4x that on complex fields).  On a
    vector field every value sums ``dim`` multiply-adds per offset."""
    upd = steps * b.numel() * (32 if b.is_complex() else 8)
    return dim * stencil_flops(K, b, steps + int(residual)) + upd


def errors(got, ref):
    got = [got] if torch.is_tensor(got) else list(got)
    ref = [ref] if torch.is_tensor(ref) else list(ref)
    abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    for g in got:
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("kernel output is not finite")
    return abs_err, abs_err / scale


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_stencil(rng, n_w, grid, complex_=False, degree=1):
    """A diagonally dominant ((2 degree + 1)^nd)-point stencil
    (Dirichlet-like centre) on ``grid``, its inverse diagonal and
    Gershgorin Chebyshev bounds (theta, delta)."""
    grid = tuple(grid)
    K = (2 * degree + 1) ** len(grid)
    w = -0.5 * rng.uniform(0.2, 1.0, (n_w, K) + grid)
    w[:, K // 2] = 4.0 + (K - 9) / 2.0 + rng.uniform(0.0, 1.0, (n_w,) + grid)
    if complex_:
        phase = rng.uniform(-0.3, 0.3, (n_w, K) + grid)
        w = w * np.exp(1j * phase)
    axes = tuple(range(1, len(grid) + 1))
    lam = (np.abs(w).sum(axis=1) / np.abs(w[:, K // 2])).max(axis=axes)
    lam = 1.05 * lam
    theta = 0.5 * (lam + lam / 4.0)
    delta = 0.5 * (lam - lam / 4.0)
    return w, 1.0 / w[:, K // 2], theta, delta


def make_vector_stencil(rng, grid, degree=2):
    """A diagonally dominant (2d+1)^2-point stencil with a 2 x 2 coupling
    block per offset on a 2-D ``grid`` (shared weights), its inverse
    diagonal per component and Gershgorin Chebyshev bounds."""
    grid = tuple(grid)
    K = (2 * degree + 1) ** 2
    w = -0.1 * rng.uniform(0.2, 1.0, (K,) + grid + (2, 2))
    for c in range(2):
        w[K // 2, :, :, c, c] = 4.0 + rng.uniform(0.0, 1.0, grid)
    diag = np.stack([w[K // 2, :, :, c, c] for c in range(2)], axis=-1)
    lam = 1.05 * float((np.abs(w).sum(axis=(0, -1)) / np.abs(diag)).max())
    return w, 1.0 / diag, 0.5 * (lam + lam / 4.0), 0.5 * (lam - lam / 4.0)


def make_vector_stencil_3d(rng, grid, degree):
    """A diagonally dominant (2d+1)^3-point stencil with a 3 x 3 coupling
    block per offset on a 3-D ``grid`` (shared weights), its inverse
    diagonal per component and Gershgorin Chebyshev bounds."""
    K = (2 * degree + 1) ** 3
    w = rng.uniform(-1.0, 1.0, (K,) + grid + (3, 3)) / K
    for c in range(3):
        w[K // 2, :, :, :, c, c] += 2.0 + rng.uniform(0.0, 1.0, grid)
    diag = np.stack([w[K // 2, :, :, :, c, c] for c in range(3)], axis=-1)
    lam = 1.05 * float((np.abs(w).sum(axis=(0, -1)) / diag).max())
    return w, 1.0 / diag, 0.5 * (lam + lam / 4.0), 0.5 * (lam - lam / 4.0)


def check_row(name, dtype, shape, got, ref, kernel_fn, plain_fn, work,
              plain_repeats=REPEATS, **extra):
    """One kernel check: errors against the plain version, times of both
    (in turns), and the bound of the work (bytes, flops)."""
    ab, rel = errors(got, ref)
    ms, pms = in_turns(kernel_fn, plain_fn, plain_repeats)
    b_ms, b_by = bound(*work, dtype)
    return dict(dtype=dtype, shape=list(shape), max_abs_err=ab,
                max_rel_err=rel, tol=TOL[(name, dtype)], ms=ms,
                plain_ms=pms, bound_ms=b_ms, bound_by=b_by, **extra)


def report(results):
    for kname, rows in results.items():
        for r in rows:
            print(f"{kname} {r['dtype']} {r['shape']}: rel err "
                  f"{r['max_rel_err']:.3e} (tol {r['tol']:.0e}), kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
            if not r["max_rel_err"] <= r["tol"]:
                raise AssertionError(f"{kname} disagrees with its plain "
                                     f"version: {r}")


def check_kernels(dev, record):
    """K1-K3 at the 2-D flagship's shapes, K6 and K5 at heat3d's, K4 at
    the Stokes path's, K5v at stokes3d's, K5 and K6 at degree 2 at
    heat3d_q2's."""
    from control_tpu_torch.ops import stencil as st

    rng = np.random.default_rng(SEED)
    n_t = FLAGSHIP["n_t"]
    g = FLAGSHIP["n"] + 1
    g3 = HEAT3D["n"] + 1
    n3 = HEAT3D["n_t"] - 1
    gs = 2 * STOKES["n"] + 1
    ns = STOKES["n_t"] - 1
    g3v = 2 * STOKES3D["n"] + 1
    n3v = STOKES3D["n_t"] - 1
    gq2 = 2 * HEAT3D_Q2["n"] + 1
    nq2 = HEAT3D_Q2["n_t"] - 1
    results = {"K1": [], "K2": [], "K3": [], "K6": [], "K5r": [],
               "K5c": [], "K4": [], "K5v": [], "K6q2": [], "K5rq2": [],
               "K5cq2": []}

    def field(shape, cplx=False):
        a = rng.standard_normal(shape)
        if cplx:
            a = a + 1j * rng.standard_normal(shape)
        return a

    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        cdt = torch.complex128 if dtype == torch.float64 else torch.complex64

        def T(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt, device=dev)

        def apply_check(kname, grid, nb):
            # one application, shared weights (the pc's stacked actions)
            nd = len(grid)
            w, _, _, _ = make_stencil(rng, 1, grid)
            wt, xt = T(w), T(field((nb,) + grid))
            results[kname].append(check_row(
                kname, name, xt.shape, st.apply_stencil(wt, xt, 1, nd=nd),
                st._apply_plain(wt, xt, 1, nd=nd),
                lambda: st.apply_stencil(wt, xt, 1, nd=nd),
                lambda: st._apply_plain(wt, xt, 1, nd=nd),
                (nbytes(wt, xt, xt), stencil_flops(3 ** nd, xt, 1))))

        def real_cheb_check(kname, grid, nb, steps):
            # shared w and dinv, scalar bounds (the (1,1) mass solve)
            nd = len(grid)
            w, dinv, theta, delta = make_stencil(rng, 1, grid)
            wt, dt_, bt = T(w), T(dinv[0]), T(field((nb,) + grid))
            x0 = torch.zeros_like(bt)
            th, de = float(theta[0]), float(delta[0])

            def kern():
                return st.fused_cheb_smooth(wt, dt_, bt, x0, steps, th, de,
                                            1, want_residual=True, nd=nd)

            def plain():
                return st._cheb_plain(wt, dt_, bt, x0, steps, th, de, 1,
                                      want_residual=True, nd=nd)

            results[kname].append(check_row(
                kname, name, bt.shape, kern(), plain(), kern, plain,
                (nbytes(wt, dt_, bt, x0, bt, bt),
                 cheb_flops(3 ** nd, bt, steps, True)), steps=steps))

        def complex_cheb_check(kname, grid, nb, steps):
            # per-batch complex w, (n,) bounds, residual on (the ParaDiag
            # frequency V-cycles)
            nd = len(grid)
            w, dinv, theta, delta = make_stencil(rng, nb, grid,
                                                 complex_=True)
            wt, dt_ = T(w, cdt), T(dinv, cdt)
            bt = T(field((nb,) + grid, cplx=True), cdt)
            xt = T(field((nb,) + grid, cplx=True), cdt)
            th, de = T(theta), T(delta)

            def kern():
                return st.fused_cheb_smooth(wt, dt_, bt, xt, steps, th, de,
                                            1, want_residual=True, nd=nd)

            def plain():
                return st._cheb_plain(wt, dt_, bt, xt, steps, th, de, 1,
                                      want_residual=True, nd=nd)

            results[kname].append(check_row(
                kname, name, bt.shape, kern(), plain(), kern, plain,
                (nbytes(wt, dt_, bt, xt, th, de, bt, bt),
                 cheb_flops(3 ** nd, bt, steps, True)), steps=steps))

        def vector_cheb_check(grid, nb, steps, residual):
            # shared Q2 weights (K = 25) and dinv, scalar bounds: the
            # velocity mass solve (a batch, x0 = 0, no residual) and the
            # V-cycle levels (unbatched, residual on)
            w, dinv, th, de = make_vector_stencil(rng, grid)
            lead = (nb,) if nb else ()
            wt, dt_ = T(w), T(dinv)
            bt = T(field(lead + grid + (2,)))
            x0 = torch.zeros_like(bt) if nb else T(field(grid + (2,)))

            def kern():
                return st.fused_cheb_smooth(wt, dt_, bt, x0, steps, th, de,
                                            2, want_residual=residual)

            def plain():
                return st._cheb_plain(wt, dt_, bt, x0, steps, th, de, 2,
                                      want_residual=residual)

            outs = (bt, bt) if residual else (bt,)
            results["K4"].append(check_row(
                "K4", name, bt.shape, kern(), plain(), kern, plain,
                (nbytes(wt, dt_, bt, x0, *outs),
                 cheb_flops(25, bt, steps, residual, dim=2)), steps=steps))

        def vector3_cheb_check(grid, nb, steps, residual, degree=2):
            # shared weights (K = 125 at degree 2) and dinv, scalar bounds:
            # the velocity mass solve (a batch, x0 = 0, no residual) and
            # the V-cycle levels (unbatched, residual on)
            w, dinv, th, de = make_vector_stencil_3d(rng, grid, degree)
            lead = (nb,) if nb else ()
            wt, dt_ = T(w), T(dinv)
            bt = T(field(lead + grid + (3,)))
            x0 = torch.zeros_like(bt) if nb else T(field(grid + (3,)))

            def kern():
                return st.fused_cheb_smooth(wt, dt_, bt, x0, steps, th, de,
                                            degree, want_residual=residual,
                                            nd=3)

            def plain():
                return st._cheb_plain(wt, dt_, bt, x0, steps, th, de, degree,
                                      want_residual=residual, nd=3)

            outs = (bt, bt) if residual else (bt,)
            results["K5v"].append(check_row(
                "K5v", name, bt.shape, kern(), plain(), kern, plain,
                (nbytes(wt, dt_, bt, x0, *outs),
                 cheb_flops((2 * degree + 1) ** 3, bt, steps, residual,
                            dim=3)),
                plain_repeats=PLAIN_REPEATS_3D, steps=steps, degree=degree))

        def q2_apply_check(grid, nb):
            # one degree-2 application, shared weights
            w, _, _, _ = make_stencil(rng, 1, grid, degree=2)
            wt, xt = T(w), T(field((nb,) + grid))
            results["K6q2"].append(check_row(
                "K6q2", name, xt.shape, st.apply_stencil(wt, xt, 2, nd=3),
                st._apply_plain(wt, xt, 2, nd=3),
                lambda: st.apply_stencil(wt, xt, 2, nd=3),
                lambda: st._apply_plain(wt, xt, 2, nd=3),
                (nbytes(wt, xt, xt), stencil_flops(125, xt, 1)),
                plain_repeats=PLAIN_REPEATS_3D))

        def q2_cheb_check(kname, grid, nb, steps, complex_):
            # real: shared w and dinv, scalar bounds, x0 = 0, no residual
            # (the mass solve); complex: per-batch w, (n,) bounds, residual
            # on (the ParaDiag frequency V-cycles)
            w, dinv, theta, delta = make_stencil(
                rng, nb if complex_ else 1, grid, complex_, degree=2)
            if complex_:
                wt, dt_ = T(w, cdt), T(dinv, cdt)
                bt = T(field((nb,) + grid, cplx=True), cdt)
                x0 = T(field((nb,) + grid, cplx=True), cdt)
                th, de = T(theta), T(delta)
            else:
                wt, dt_ = T(w), T(dinv[0])
                bt = T(field((nb,) + grid))
                x0 = torch.zeros_like(bt)
                th, de = float(theta[0]), float(delta[0])

            def kern():
                return st.fused_cheb_smooth(wt, dt_, bt, x0, steps, th, de,
                                            2, want_residual=complex_, nd=3)

            def plain():
                return st._cheb_plain(wt, dt_, bt, x0, steps, th, de, 2,
                                      want_residual=complex_, nd=3)

            outs = (bt, bt) if complex_ else (bt,)
            bounds = (th, de) if complex_ else ()
            results[kname].append(check_row(
                kname, name, bt.shape, kern(), plain(), kern, plain,
                (nbytes(wt, dt_, bt, x0, *bounds, *outs),
                 cheb_flops(125, bt, steps, complex_)),
                plain_repeats=PLAIN_REPEATS_3D, steps=steps))

        # K1 (63, 257^2); K2 (63, 257^2), 10 steps; K3 32 frequencies, 3
        # steps, at every smoothed level of the flagship's hierarchy
        apply_check("K1", (g, g), n_t - 1)
        real_cheb_check("K2", (g, g), n_t - 1, 10)
        for gl in (257, 129, 65, 33):
            complex_cheb_check("K3", (gl, gl), (n_t - 1) // 2 + 1, 3)
        # K6 (15, 65^3); K5 real (15, 65^3), 10 steps; K5 complex 8
        # frequencies, 8 steps, at every smoothed level of heat3d's
        apply_check("K6", (g3,) * 3, n3)
        real_cheb_check("K5r", (g3,) * 3, n3, 10)
        for gl in (65, 33, 17, 9):
            complex_cheb_check("K5c", (gl,) * 3, n3 // 2 + 1, 8)
        # K4: the mass solve (31, 129^2, 2), 20 steps; the V-cycle levels
        # 129^2 and 65^2, 8 steps and the residual
        vector_cheb_check((gs, gs), ns, 20, False)
        for gl in (gs, (gs + 1) // 2):
            vector_cheb_check((gl, gl), 0, 8, True)
        # K5v: the stokes3d mass solve (7, 33^3, 3), 20 steps; the V-cycle
        # levels 33^3 and 17^3, 8 steps and the residual; one degree-1
        # (K = 27) case at the finest level's shape
        vector3_cheb_check((g3v,) * 3, n3v, 20, False)
        for gl in (g3v, (g3v + 1) // 2):
            vector3_cheb_check((gl,) * 3, 0, 8, True)
        vector3_cheb_check((g3v,) * 3, 0, 8, True, degree=1)
        # degree 2 at heat3d_q2's shapes: K6 (15, 65^3); K5 real (15,
        # 65^3), 20 steps (the mass solve); K5 complex 8 frequencies, 8
        # steps, at every smoothed level
        q2_apply_check((gq2,) * 3, nq2)
        q2_cheb_check("K5rq2", (gq2,) * 3, nq2, 20, False)
        for gl in (65, 33, 17, 9):
            q2_cheb_check("K5cq2", (gl,) * 3, nq2 // 2 + 1, 8, True)
    record["kernel_checks"] = results
    report(results)
    return results


# ---------------------------------------------------------------------------
# phases 4-5: the 2-D and 3-D slices
# ---------------------------------------------------------------------------

LAMBDA_2D = (0.25, 2.25)
LAMBDA_3D = (0.125, 3.375)
LAMBDA_STOKES = dict(lambda_v_bounds=(0.25, 1.5625),
                     lambda_p_bounds=(0.25, 2.25))
KEYS_2D = ("stencil_apply", "cheb_smooth_real", "cheb_smooth_complex")
KEYS_STOKES = ("cheb_smooth_vector", "cheb_smooth_real")
KEYS_3D = ("stencil_apply_3d", "cheb_smooth_3d_real",
           "cheb_smooth_3d_complex")
LAMBDA_STOKES3D = dict(lambda_v_bounds=(0.1, 2.3),
                       lambda_p_bounds=(0.1, 3.4))
# the velocity is Q2 (K5v); the pressure's K_p V-cycle and M_p solve are
# scalar Q1 (K5 real)
KEYS_STOKES3D = ("cheb_smooth_3d_vector", "cheb_smooth_3d_real")
LAMBDA_Q2 = (0.1, 2.3)
KEYS_3D_Q2 = ("stencil_apply_3d_q2", "cheb_smooth_3d_real_q2",
              "cheb_smooth_3d_complex_q2")


def heat_problem(n, n_t, dtype, device, mode):
    """The flagship heat-control problem (a Q1 UnitSquareMesh, CN,
    beta = 1e-4, zero Dirichlet data)."""
    from control_tpu_torch import (Control, UnitSquareMesh, FunctionSpace,
                                   Function, DirichletBC, SpatialCoordinate,
                                   grad, inner, dx, cos, pi)
    mesh = UnitSquareMesh(n, n, quadrilateral=True, dtype=dtype,
                          device=device)
    space = FunctionSpace(mesh, "Lagrange", 1)
    X = SpatialCoordinate(mesh)

    def forw_diff_operator(trial, test, u, t):
        return inner(grad(trial), grad(test)) * dx

    def desired_state(test, t):
        v_d = Function(space).interpolate(
            cos(0.5 * pi * (X[0] - 1.0)) * cos(0.5 * pi * (X[1] - 1.0)))
        return inner(v_d, test) * dx, v_d

    def force_f(test, t):
        f = Function(space).interpolate(
            cos(0.5 * pi * (X[0] - 1.0)) * cos(0.5 * pi * (X[1] - 1.0)))
        return inner(f, test) * dx

    def bc_t(space_0, t):
        return DirichletBC(space_0, 0.0, "on_boundary")

    ctl = Control.Instationary(
        space, forw_diff_operator, desired_state=desired_state,
        force_f=force_f, beta=1e-4, n_t=n_t, time_interval=(0.0, 2.0),
        CN=True, bcs_v=bc_t)
    if mode == "paradiag":
        ctl.set_schur_sweep("paradiag", paradiag_cycles=1, smooth=(3, 3))
        ctl.set_mass_solver_steps(10)
    return ctl


def heat3d_problem(n, n_t, dtype, device, mode, degree=1):
    """``bench_extra.py``'s heat3d problem: hex Q1 (``degree`` 2: Q2)
    UnitCubeMesh, CN, beta = 1e-4, v_d = sin(pi x) sin(pi y) sin(pi z),
    f = 0, zero Dirichlet data; ParaDiag with its default settings (2
    cycles, (8, 8) smoothing, alpha 1e-3, one defect step, 20 mass
    steps)."""
    from control_tpu_torch import (Control, UnitCubeMesh, FunctionSpace,
                                   Function, DirichletBC, SpatialCoordinate,
                                   grad, inner, dx, sin, pi)
    mesh = UnitCubeMesh(n, n, n, dtype=dtype, device=device)
    space = FunctionSpace(mesh, "Lagrange", degree)
    X = SpatialCoordinate(mesh)

    def fdo(trial, test, u, t):
        return inner(grad(trial), grad(test)) * dx

    def ds_(test, t):
        v_d = Function(space).interpolate(
            sin(pi * X[0]) * sin(pi * X[1]) * sin(pi * X[2]))
        return inner(v_d, test) * dx, v_d

    def ff(test, t):
        return inner(Function(space), test) * dx

    def bc_t(s, t):
        return DirichletBC(s, 0.0, "on_boundary")

    ctl = Control.Instationary(space, fdo, desired_state=ds_, force_f=ff,
                               beta=1e-4, n_t=n_t, time_interval=(0.0, 2.0),
                               CN=True, bcs_v=bc_t)
    ctl.set_schur_sweep(mode)
    return ctl


def heat3d_q2_problem(n, n_t, dtype, device, mode):
    """heat3d on Q2 hexahedra: n^3 cells, (2n + 1)^3 nodes."""
    return heat3d_problem(n, n_t, dtype, device, mode, degree=2)


def stokes3d_problem(n, n_t, dtype, device):
    """``tests/test_instationary_stokes3d.py``'s problem: Taylor-Hood
    Q2-Q1 (velocity dim 3) on a UnitCubeMesh, CN, beta = 1e-2, time
    interval (0, 1), v_d a smooth divergent triple, f = 0, zero Dirichlet
    velocity, the default ``scan`` sweeps."""
    from control_tpu_torch import (Control, UnitCubeMesh, FunctionSpace,
                                   VectorFunctionSpace, Function,
                                   DirichletBC, SpatialCoordinate, grad,
                                   inner, dx, sin, cos, pi)
    mesh = UnitCubeMesh(n, n, n, dtype=dtype, device=device)
    space_v = VectorFunctionSpace(mesh, "Lagrange", 2, dim=3)
    space_p = FunctionSpace(mesh, "Lagrange", 1)
    X = SpatialCoordinate(mesh)

    def fdo(trial, test, u, t):
        return inner(grad(trial), grad(test)) * dx

    def ds_(test, t):
        v_d = Function(space_v).interpolate(
            (sin(pi * X[0]) * sin(2 * pi * X[1]) * sin(pi * X[2]),
             sin(2 * pi * X[0]) * sin(pi * X[1]) * sin(pi * X[2]),
             cos(pi * X[0]) * sin(pi * X[1]) * sin(2 * pi * X[2])))
        return inner(v_d, test) * dx, v_d

    def ff(test, t):
        return inner(Function(space_v), test) * dx

    def bc_t(s, t):
        return DirichletBC(s, (0.0, 0.0, 0.0), "on_boundary")

    return Control.Instationary(space_v, fdo, desired_state=ds_, force_f=ff,
                                beta=1e-2, space_p=space_p, n_t=n_t,
                                time_interval=(0.0, 1.0), CN=True,
                                bcs_v=bc_t)


def stokes_problem(n, n_t, dtype, device):
    """``bench_extra.py``'s stokes problem: Taylor-Hood Q2-Q1 on a
    quadrilateral UnitSquareMesh, CN, beta = 1e-2, time interval (0, 1),
    zero Dirichlet velocity, the default ``scan`` sweeps."""
    from control_tpu_torch import (Control, UnitSquareMesh, FunctionSpace,
                                   VectorFunctionSpace, Function,
                                   DirichletBC, SpatialCoordinate, grad,
                                   inner, dx, sin, pi)
    mesh = UnitSquareMesh(n, n, quadrilateral=True, dtype=dtype,
                          device=device)
    space_v = VectorFunctionSpace(mesh, "Lagrange", 2)
    space_p = FunctionSpace(mesh, "Lagrange", 1)
    X = SpatialCoordinate(mesh)

    def fdo(trial, test, u, t):
        return inner(grad(trial), grad(test)) * dx

    def ds_(test, t):
        v_d = Function(space_v).interpolate(
            (0.2 * sin(pi * X[0]) * sin(pi * X[1]),
             0.1 * sin(2 * pi * X[0]) * sin(pi * X[1])))
        return inner(v_d, test) * dx, v_d

    def ff(test, t):
        return inner(Function(space_v), test) * dx

    def bc_t(s, t):
        return DirichletBC(s, (0.0, 0.0), "on_boundary")

    return Control.Instationary(space_v, fdo, desired_state=ds_, force_f=ff,
                                beta=1e-2, space_p=space_p, n_t=n_t,
                                time_interval=(0.0, 1.0), CN=True,
                                bcs_v=bc_t)


def stokes_solve(ctl, lambdas=LAMBDA_STOKES, **extra):
    from control_tpu_torch import ConstantNullspace
    return ctl.incompressible_linear_solve(
        ConstantNullspace(), solver_parameters=STOKES_PARAMETERS,
        print_error=False, **lambdas, **extra)


def solve(ctl, bounds):
    return ctl.linear_solve(lambda_v_bounds=bounds,
                            solver_parameters=SOLVER_PARAMETERS,
                            print_error=False)


def check_small_f64(dev, record, key, cases):
    """A slice in float64 on the card against the same solve on the CPU
    (plain versions, which the CPU tests hold to the JAX reference).
    ``cases``: (label, problem constructor, mode, n, n_t, lambda bounds)."""
    out = {}
    for label, build, mode, n, n_t, bounds in cases:
        runs = {}
        for device in ("cpu", dev):
            ctl = build(n, n_t, torch.float64, device, mode)
            info = solve(ctl, bounds)
            runs[str(device)] = (info, ctl._v.data.cpu(),
                                 ctl._zeta.data.cpu())
        (ic, vc, zc), (ig, vg, zg) = runs["cpu"], runs[str(dev)]
        its = ic.iterations
        hist = float(np.max(np.abs(ic.res_norms[:its + 1]
                                   - ig.res_norms[:its + 1])
                            / np.abs(ic.res_norms[:its + 1])))
        dv = float((vc - vg).abs().max() / vc.abs().max())
        dz = float((zc - zg).abs().max() / zc.abs().max())
        row = dict(n=n, n_t=n_t, iterations_cpu=its,
                   iterations_gpu=ig.iterations, hist_rel=hist, v_rel=dv,
                   zeta_rel=dz)
        out[mode] = row
        print(f"slice f64 {mode} {label}: cuda vs cpu {row}", flush=True)
        if not (ig.iterations == its and hist < 1e-8 and dv < 1e-9
                and dz < 1e-9):
            raise AssertionError(f"cuda slice disagrees with cpu: {row}")
    record[key] = out


def timed_solve(dev, record, card, key, metric, build, size, bounds,
                max_its, keys):
    """A slice's ParaDiag solve at full size, float32: solved once, the pc
    build timed apart, then solved again with CUDA events around it and
    every launch count set to 0 just before; ``keys`` are the kernels of
    the path, each of which must launch."""
    from control_tpu_torch.config import full_precision
    from control_tpu_torch.fem.assemble import assemble
    from control_tpu_torch.fem.space import combine_masks

    n, n_t = size
    t0 = time.perf_counter()
    ctl = build(n, n_t, torch.float32, dev, "paradiag")
    first = solve(ctl, bounds)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    # the pc build alone, on the card, from the solve's own inputs
    with full_precision():
        mask = combine_masks(ctl._space_v, ctl._bcs_v[1])
        Dv_A = ctl._D_stack(ctl._v.data)
        M = assemble(ctl._M_v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctl.construct_pc(False, bounds, mask, Dv_A, M)
        torch.cuda.synchronize()
        pc_build_s = time.perf_counter() - t0

    info, row = repeat_solve_row(lambda: solve(ctl, bounds), metric,
                                 "paradiag", card)
    row.update(pc_build_s=pc_build_s, first_solve_s=first_s,
               first_iterations=first.iterations)
    fields = {"v": (ctl._v.data, ctl._space_v, n_t),
              "zeta": (ctl._zeta.data, ctl._space_v, n_t)}
    return judge_solve(record, key, row, info, max_its, keys, fields)


def repeat_solve_row(solve_fn, metric, schur, card, dtype="float32"):
    """A repeat solve with CUDA events around it and every launch count
    set to 0 just before, read just after."""
    from control_tpu_torch.ops import stencil as st

    st.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    info = solve_fn()
    end.record()
    torch.cuda.synchronize()
    solve_host_s = time.perf_counter() - t0
    launches = dict(st.launch_counts)
    return info, {"metric": metric, "schur": schur, "dtype": dtype,
                  "iterations": info.iterations,
                  "relative_residual": info.rnorm / info.rnorm0,
                  "converged": info.converged,
                  "solve_s": start.elapsed_time(end) / 1e3,
                  "solve_host_s": solve_host_s, "launches": launches,
                  "card": card}


def judge_solve(record, key, row, info, max_its, keys, fields):
    """Print and record a timed solve's row, and hold it to its targets:
    convergence below 1e-6 within ``max_its``, every field
    (name: (tensor, space, blocks)) on the card, finite and of its shape,
    every kernel of ``keys`` launched."""
    print(json.dumps(row), flush=True)
    record[key] = row
    if not (info.converged and row["relative_residual"] < 1e-6
            and info.iterations <= max_its):
        raise AssertionError(f"{key} solve off target: {row}")
    for name, (x, space, blocks) in fields.items():
        if not x.is_cuda:
            raise AssertionError(f"{name} left the card")
        if (tuple(x.shape) != (blocks,) + tuple(space.grid_shape)
                or not bool(torch.isfinite(x).all())):
            raise AssertionError(f"{name} has the wrong shape or is not "
                                 "finite")
    for k in keys:
        if row["launches"][k] <= 0:
            raise AssertionError(f"kernel {k} never launched in the "
                                 f"timed solve: {row['launches']}")
    return row


def check_small_stokes(dev, record, key="small_f64_stokes", label=None,
                       build=stokes_problem, size=None,
                       lambdas=LAMBDA_STOKES):
    """The Stokes slice in float64 on the card against the same solve on
    the CPU (plain versions, which the CPU tests hold to the JAX
    reference): equal iterations; residual histories within 1e-9 of the
    initial residual (the dense inverse of the regularised pressure
    stiffness, condition number ~1e6, comes from two LAPACK-like paths, and
    the tail of the history, six orders down, drifts by more of its own
    size); v, zeta within 1e-9; p, mu (means removed) within 1e-8."""
    n, n_t = size or (STOKES["small_n"], STOKES["small_n_t"])
    label = label or f"stokes scan {n}^2x{n_t}"
    runs = {}
    for device in ("cpu", dev):
        ctl = build(n, n_t, torch.float64, device)
        info = stokes_solve(ctl, lambdas)
        runs[str(device)] = (info, {k: getattr(ctl, "_" + k).data.cpu()
                                    for k in ("v", "zeta", "p", "mu")})
    (ic, sc), (ig, sg) = runs["cpu"], runs[str(dev)]
    its = ic.iterations
    hc, hg = ic.res_norms[:its + 1], ig.res_norms[:its + 1]
    row = dict(n=n, n_t=n_t, iterations_cpu=its,
               iterations_gpu=ig.iterations,
               hist_rel_to_initial=float(np.max(np.abs(hc - hg)) / hc[0]),
               hist_rel_entrywise=float(np.max(np.abs(hc - hg) / hc)))
    for k in ("v", "zeta", "p", "mu"):
        a, b = sc[k], sg[k]
        if k in ("p", "mu"):
            axes = tuple(range(1, a.dim()))
            a = a - a.mean(dim=axes, keepdim=True)
            b = b - b.mean(dim=axes, keepdim=True)
        row[k + "_rel"] = float((a - b).abs().max() / a.abs().max())
    record[key] = row
    print(f"slice f64 {label}: cuda vs cpu {row}", flush=True)
    if not (ig.iterations == its and row["hist_rel_to_initial"] < 1e-9
            and row["v_rel"] < 1e-9 and row["zeta_rel"] < 1e-9
            and row["p_rel"] < 1e-8 and row["mu_rel"] < 1e-8):
        raise AssertionError(f"cuda stokes slice disagrees with cpu: {row}")


def timed_stokes(dev, record, card, key="stokes",
                 metric="stokes_64x64_nt32_kkt_solve_cuda",
                 build=stokes_problem, size=None, lambdas=LAMBDA_STOKES,
                 keys=KEYS_STOKES):
    """The Stokes solve at full width, float64: solved once, the build of
    its pieces (block system, preconditioner state, right-hand sides) timed
    apart, then solved again with CUDA events around it and the launch
    counts set to 0 just before."""
    n, n_t = size or (STOKES["n"], STOKES["n_t"])
    t0 = time.perf_counter()
    ctl = build(n, n_t, torch.float64, dev)
    first = stokes_solve(ctl, lambdas)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stokes_solve(ctl, lambdas, _return_pieces=True)
    torch.cuda.synchronize()
    pc_build_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    info, row = repeat_solve_row(lambda: stokes_solve(ctl, lambdas), metric,
                                 "scan", card, dtype="float64")
    its = info.iterations
    row.update(pc_build_s=pc_build_s, first_solve_s=first_s,
               first_iterations=first.iterations,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               residual_history=[float(r) for r in info.res_norms[:its + 1]])
    fields = {"v": (ctl._v.data, ctl._space_v, n_t),
              "zeta": (ctl._zeta.data, ctl._space_v, n_t),
              "p": (ctl._p.data, ctl._space_p, n_t - 1),
              "mu": (ctl._mu.data, ctl._space_p, n_t - 1)}
    return judge_solve(record, key, row, info,
                       STOKES_PARAMETERS["maximum_iterations"], keys,
                       fields)


def stokes_float32_history(dev, record, card, float64_history):
    """A measurement, not a check: the first outer iterations of the same
    Stokes solve in float32 at full width, beside float64's.  The
    reference's recipe stalls in float32 at this width in both packages, so
    the solve runs with a budget of ``float32_budget`` iterations and
    reports where it got to; only a residual that is not finite fails."""
    n, n_t, budget = STOKES["n"], STOKES["n_t"], STOKES["float32_budget"]
    ctl = stokes_problem(n, n_t, torch.float32, dev)
    from control_tpu_torch import ConstantNullspace
    from control_tpu_torch.ops import stencil as st

    st.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # "preconditioner": the solve returns its record at the end of the
    # budget instead of raising
    info = ctl.incompressible_linear_solve(
        ConstantNullspace(), print_error=False, **LAMBDA_STOKES,
        solver_parameters=dict(STOKES_PARAMETERS, preconditioner=True,
                               maximum_iterations=budget))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    its = info.iterations
    hist = [float(r / info.res_norms[0]) for r in info.res_norms[:its + 1]]
    row = {"metric": "stokes_64x64_nt32_float32_first_iterations",
           "dtype": "float32", "budget": budget, "iterations": its,
           "converged": info.converged, "relative_history": hist,
           "float64_relative_history": [
               r / float64_history[0] for r in float64_history[:budget + 1]],
           "first_solve_s": seconds, "launches": dict(st.launch_counts),
           "card": card}
    print(json.dumps(row), flush=True)
    record["stokes_float32"] = row
    if not np.all(np.isfinite(hist)):
        raise AssertionError(f"float32 stokes residuals not finite: {row}")


def scan_once(dev, record, key, build, size, bounds):
    """The README's default (``scan`` sweeps), float32, once."""
    n, n_t = size
    ctl = build(n, n_t, torch.float32, dev, "scan")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = solve(ctl, bounds)
    torch.cuda.synchronize()
    row = {"schur": "scan", "dtype": "float32", "n": n, "n_t": n_t,
           "iterations": info.iterations,
           "relative_residual": info.rnorm / info.rnorm0,
           "converged": info.converged,
           "first_solve_s": time.perf_counter() - t0}
    print(f"{key} scan sweeps " + json.dumps(row), flush=True)
    record[key] = row
    if not (info.converged and row["relative_residual"] < 1e-6):
        raise AssertionError(f"{key} scan solve off target: {row}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    from control_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__} "
          f"(CUDA {torch.version.cuda}), {nvcc_version()}", flush=True)
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    _, ptxas = kernels.build(verbose=True)
    kernels.library()
    build_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as fh:
        fh.write(ptxas)
    regs = sorted({int(line.split("Used ")[1].split()[0])
                   for line in ptxas.splitlines() if "Used " in line})
    spills = [line for line in ptxas.splitlines()
              if "spill" in line and not line.strip().startswith("0 bytes")]
    print(f"kernel build + load: {build_s:.2f} s; registers per thread "
          f"{regs}; spilling functions: {len(spills)}", flush=True)
    record["build_s"] = build_s

    checks = check_kernels(dev, record)
    # the 2-D slice
    check_small_f64(dev, record, "small_f64", (
        ("32^2x8", heat_problem, "paradiag", 32, 8, LAMBDA_2D),
        ("16^2x8", heat_problem, "scan", 16, 8, LAMBDA_2D)))
    flag = timed_solve(dev, record, card, "flagship",
                       "heat_control_256x256_nt64_kkt_solve_cuda",
                       heat_problem, (FLAGSHIP["n"], FLAGSHIP["n_t"]),
                       LAMBDA_2D, 12, KEYS_2D)
    scan_once(dev, record, "flagship_scan", heat_problem,
              (FLAGSHIP["n"], FLAGSHIP["n_t"]), LAMBDA_2D)
    # the 3-D slice
    check_small_f64(dev, record, "small_f64_3d", (
        ("8^3x8", heat3d_problem, "paradiag", 8, 8, LAMBDA_3D),
        ("8^3x8", heat3d_problem, "scan", 8, 8, LAMBDA_3D)))
    h3 = timed_solve(dev, record, card, "heat3d",
                     "heat3d_64cubed_nt16_kkt_solve_cuda", heat3d_problem,
                     (HEAT3D["n"], HEAT3D["n_t"]), LAMBDA_3D, 10, KEYS_3D)
    scan_once(dev, record, "heat3d_scan", heat3d_problem,
              (HEAT3D["scan_n"], HEAT3D["n_t"]), LAMBDA_3D)
    # the Stokes slice
    check_small_stokes(dev, record)
    sk = timed_stokes(dev, record, card)
    stokes_float32_history(dev, record, card, sk["residual_history"])
    # the 3-D Stokes slice
    small3 = (STOKES3D["small_n"], STOKES3D["small_n_t"])
    check_small_stokes(dev, record, "small_f64_stokes3d",
                       f"stokes3d scan {small3[0]}^3x{small3[1]}",
                       stokes3d_problem, small3, LAMBDA_STOKES3D)
    s3 = timed_stokes(dev, record, card, "stokes3d",
                      "stokes3d_16cubed_nt8_kkt_solve_cuda",
                      stokes3d_problem, (STOKES3D["n"], STOKES3D["n_t"]),
                      LAMBDA_STOKES3D, KEYS_STOKES3D)
    # the Q2 heat slice
    nq, ntq = HEAT3D_Q2["small_n"], HEAT3D_Q2["small_n_t"]
    check_small_f64(dev, record, "small_f64_heat3d_q2", (
        (f"q2 {nq}^3x{ntq}", heat3d_q2_problem, "paradiag", nq, ntq,
         LAMBDA_Q2),
        (f"q2 {nq}^3x{ntq}", heat3d_q2_problem, "scan", nq, ntq,
         LAMBDA_Q2)))
    q2 = timed_solve(dev, record, card, "heat3d_q2",
                     "heat3d_q2_32cubed_nt16_kkt_solve_cuda",
                     heat3d_q2_problem, (HEAT3D_Q2["n"], HEAT3D_Q2["n_t"]),
                     LAMBDA_Q2, SOLVER_PARAMETERS["maximum_iterations"],
                     KEYS_3D_Q2)
    scan_once(dev, record, "heat3d_q2_scan", heat3d_q2_problem,
              (HEAT3D_Q2["n"], HEAT3D_Q2["n_t"]), LAMBDA_Q2)

    def row(kname, source, replaces, key, launches, checks_rows,
            dtype="float32"):
        # the numbers of the first shape checked, in the dtype its path
        # runs; the largest error over that dtype's shapes
        rows = [r for r in checks_rows if r["dtype"] == dtype]
        main = rows[0]
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": None}

    apply_src = "control_tpu_torch/csrc/stencil_apply.cu"
    cheb_src = "control_tpu_torch/csrc/cheb_smooth.cu"
    vector_src = "control_tpu_torch/csrc/cheb_smooth_vector.cu"
    fl, hl, sl = flag["launches"], h3["launches"], sk["launches"]
    s3l, ql = s3["launches"], q2["launches"]
    kernels_line = {"kernels": [
        row("K1 stencil_apply", apply_src, "control_tpu/ops/stencil.py:206",
            "stencil_apply", fl, checks["K1"]),
        row("K2 cheb_smooth (real)", cheb_src,
            "control_tpu/ops/stencil.py:589", "cheb_smooth_real", fl,
            checks["K2"]),
        row("K3 cheb_smooth (complex)", cheb_src,
            "control_tpu/ops/stencil.py:728", "cheb_smooth_complex", fl,
            checks["K3"]),
        row("K4 cheb_smooth (vector)", vector_src,
            "control_tpu/ops/stencil.py:853", "cheb_smooth_vector", sl,
            checks["K4"], dtype="float64"),
        row("K5 cheb_smooth 3-D (real)", cheb_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_real", hl,
            checks["K5r"]),
        row("K5 cheb_smooth 3-D (complex)", cheb_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_complex", hl,
            checks["K5c"]),
        row("K6 stencil_apply 3-D", apply_src,
            "control_tpu/ops/stencil.py:255", "stencil_apply_3d", hl,
            checks["K6"]),
        row("K5 cheb_smooth 3-D (vector)", vector_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_vector", s3l,
            checks["K5v"], dtype="float64"),
        row("K5 cheb_smooth 3-D (real, degree 2)", cheb_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_real_q2", ql,
            checks["K5rq2"]),
        row("K5 cheb_smooth 3-D (complex, degree 2)", cheb_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_complex_q2",
            ql, checks["K5cq2"]),
        row("K6 stencil_apply 3-D (degree 2)", apply_src,
            "control_tpu/ops/stencil.py:255", "stencil_apply_3d_q2", ql,
            checks["K6q2"]),
    ]}
    record["kernels"] = kernels_line["kernels"]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   applications K1/K6, <= 1e-4 for the smoothers K2/K3/K5: the summation
   order differs), and times both with CUDA events: K1-K3 at the 2-D
   flagship's shapes, K6 and K5 (real, complex) at heat3d's;
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
6. prints ``{"kernels": [...]}``, a JSON line of each slice's numbers, and
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
       ("K5c", "float64"): 1e-12, ("K5c", "float32"): 1e-4}
FLAGSHIP = dict(n=256, n_t=64)
HEAT3D = dict(n=64, n_t=16, scan_n=64)
# the H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores; float64 runs at half the rate
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 33.5e12}
SOLVER_PARAMETERS = {"linear_solver": "gmres", "gmres_restart": 10,
                     "maximum_iterations": 50, "relative_tolerance": 1.0e-6,
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
    for _ in range(3):
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


def in_turns(kernel_fn, plain_fn):
    """Kernel and plain times measured plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn)
    k1 = cuda_ms(kernel_fn)
    k2 = cuda_ms(kernel_fn)
    p2 = cuda_ms(plain_fn)
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


def cheb_flops(K, b, steps, residual):
    """The stencil work of a smoothing call plus its per-node updates (r, z,
    p, x: about 8 real flops per step, 4x that on complex fields)."""
    upd = steps * b.numel() * (32 if b.is_complex() else 8)
    return stencil_flops(K, b, steps + int(residual)) + upd


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

def make_stencil(rng, n_w, grid, complex_=False):
    """A diagonally dominant (3^nd)-point stencil (Dirichlet-like centre)
    on ``grid``, its inverse diagonal and Gershgorin Chebyshev bounds
    (theta, delta)."""
    grid = tuple(grid)
    K = 3 ** len(grid)
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


def check_row(name, dtype, shape, got, ref, kernel_fn, plain_fn, work,
              **extra):
    """One kernel check: errors against the plain version, times of both
    (in turns), and the bound of the work (bytes, flops)."""
    ab, rel = errors(got, ref)
    ms, pms = in_turns(kernel_fn, plain_fn)
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
    """K1-K3 at the 2-D flagship's shapes, K6 and K5 at heat3d's."""
    from control_tpu_torch.ops import stencil as st

    rng = np.random.default_rng(SEED)
    n_t = FLAGSHIP["n_t"]
    g = FLAGSHIP["n"] + 1
    g3 = HEAT3D["n"] + 1
    n3 = HEAT3D["n_t"] - 1
    results = {"K1": [], "K2": [], "K3": [], "K6": [], "K5r": [],
               "K5c": []}

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
    record["kernel_checks"] = results
    report(results)
    return results


# ---------------------------------------------------------------------------
# phases 4-5: the 2-D and 3-D slices
# ---------------------------------------------------------------------------

LAMBDA_2D = (0.25, 2.25)
LAMBDA_3D = (0.125, 3.375)
KEYS_2D = ("stencil_apply", "cheb_smooth_real", "cheb_smooth_complex")
KEYS_3D = ("stencil_apply_3d", "cheb_smooth_3d_real",
           "cheb_smooth_3d_complex")


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


def heat3d_problem(n, n_t, dtype, device, mode):
    """``bench_extra.py``'s heat3d problem: hex Q1 UnitCubeMesh, CN,
    beta = 1e-4, v_d = sin(pi x) sin(pi y) sin(pi z), f = 0, zero Dirichlet
    data; ParaDiag with its default settings (2 cycles, (8, 8) smoothing,
    alpha 1e-3, one defect step, 20 mass steps)."""
    from control_tpu_torch import (Control, UnitCubeMesh, FunctionSpace,
                                   Function, DirichletBC, SpatialCoordinate,
                                   grad, inner, dx, sin, pi)
    mesh = UnitCubeMesh(n, n, n, dtype=dtype, device=device)
    space = FunctionSpace(mesh, "Lagrange", 1)
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


def solve(ctl, bounds):
    return ctl.linear_solve(lambda_v_bounds=bounds,
                            solver_parameters=SOLVER_PARAMETERS,
                            print_error=False)


def check_small_f64(dev, record, key, cases):
    """A slice in float64 on the card against the same solve on the CPU
    (plain versions, which the CPU tests hold to the JAX reference).
    ``cases``: (label, problem builder, mode, n, lambda bounds)."""
    out = {}
    for label, build, mode, n, bounds in cases:
        runs = {}
        for device in ("cpu", dev):
            ctl = build(n, 8, torch.float64, device, mode)
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
        row = dict(n=n, n_t=8, iterations_cpu=its,
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
    from control_tpu_torch.ops import stencil as st
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

    st.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    info = solve(ctl, bounds)
    end.record()
    torch.cuda.synchronize()
    solve_host_s = time.perf_counter() - t0
    solve_s = start.elapsed_time(end) / 1e3
    launches = dict(st.launch_counts)

    v, zeta = ctl._v.data, ctl._zeta.data
    rel = info.rnorm / info.rnorm0
    row = {"metric": metric, "schur": "paradiag", "dtype": "float32",
           "iterations": info.iterations, "relative_residual": rel,
           "converged": info.converged, "solve_s": solve_s,
           "solve_host_s": solve_host_s, "pc_build_s": pc_build_s,
           "first_solve_s": first_s, "first_iterations": first.iterations,
           "launches": launches, "card": card}
    print(json.dumps(row), flush=True)
    record[key] = row
    if not (info.converged and rel < 1e-6 and info.iterations <= max_its):
        raise AssertionError(f"{key} solve off target: {row}")
    if not (v.is_cuda and zeta.is_cuda):
        raise AssertionError("solution left the card")
    shape = (n_t,) + tuple(ctl._space_v.grid_shape)
    if (tuple(v.shape) != shape or tuple(zeta.shape) != shape
            or not bool(torch.isfinite(v).all())
            or not bool(torch.isfinite(zeta).all())):
        raise AssertionError("solution has the wrong shape or is not "
                             "finite")
    for k in keys:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched in the "
                                 f"timed solve: {launches}")
    return row


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
        ("32^2x8", heat_problem, "paradiag", 32, LAMBDA_2D),
        ("16^2x8", heat_problem, "scan", 16, LAMBDA_2D)))
    flag = timed_solve(dev, record, card, "flagship",
                       "heat_control_256x256_nt64_kkt_solve_cuda",
                       heat_problem, (FLAGSHIP["n"], FLAGSHIP["n_t"]),
                       LAMBDA_2D, 12, KEYS_2D)
    scan_once(dev, record, "flagship_scan", heat_problem,
              (FLAGSHIP["n"], FLAGSHIP["n_t"]), LAMBDA_2D)
    # the 3-D slice
    check_small_f64(dev, record, "small_f64_3d", (
        ("8^3x8", heat3d_problem, "paradiag", 8, LAMBDA_3D),
        ("8^3x8", heat3d_problem, "scan", 8, LAMBDA_3D)))
    h3 = timed_solve(dev, record, card, "heat3d",
                     "heat3d_64cubed_nt16_kkt_solve_cuda", heat3d_problem,
                     (HEAT3D["n"], HEAT3D["n_t"]), LAMBDA_3D, 10, KEYS_3D)
    scan_once(dev, record, "heat3d_scan", heat3d_problem,
              (HEAT3D["scan_n"], HEAT3D["n_t"]), LAMBDA_3D)

    def row(kname, source, replaces, key, launches, checks_rows):
        f32 = [r for r in checks_rows if r["dtype"] == "float32"]
        main = f32[0]
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": max(r["max_abs_err"] for r in f32),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": None}

    apply_src = "control_tpu_torch/csrc/stencil_apply.cu"
    cheb_src = "control_tpu_torch/csrc/cheb_smooth.cu"
    fl, hl = flag["launches"], h3["launches"]
    kernels_line = {"kernels": [
        row("K1 stencil_apply", apply_src, "control_tpu/ops/stencil.py:206",
            "stencil_apply", fl, checks["K1"]),
        row("K2 cheb_smooth (real)", cheb_src,
            "control_tpu/ops/stencil.py:589", "cheb_smooth_real", fl,
            checks["K2"]),
        row("K3 cheb_smooth (complex)", cheb_src,
            "control_tpu/ops/stencil.py:728", "cheb_smooth_complex", fl,
            checks["K3"]),
        row("K5 cheb_smooth 3-D (real)", cheb_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_real", hl,
            checks["K5r"]),
        row("K5 cheb_smooth 3-D (complex)", cheb_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_complex", hl,
            checks["K5c"]),
        row("K6 stencil_apply 3-D", apply_src,
            "control_tpu/ops/stencil.py:255", "stencil_apply_3d", hl,
            checks["K6"]),
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

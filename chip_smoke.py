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
   inputs made from a numpy seed at the flagship's shapes, in float64
   (max relative error <= 1e-12) and float32 (<= 1e-5 for K1, <= 1e-4 for
   K2/K3: the summation order differs), and times both with CUDA events;
4. the slice: a small float64 solve on the card against the same solve on
   the CPU (plain versions), then the flagship heat-control KKT solve
   (Q1 256^2 x 64, Crank-Nicolson, ParaDiag Schur sweeps, GMRES(10), rtol
   1e-6, float32) through ``Control.Instationary(...).linear_solve``: solved
   once, then timed; it must converge below 1e-6 relative residual in at
   most 12 iterations with every kernel launched during the timed solve;
   then the default ``scan`` sweeps at the same size, once;
5. prints ``{"kernels": [...]}``, a JSON line of the slice's numbers, and
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
       ("K3", "float64"): 1e-12, ("K3", "float32"): 1e-4}
FLAGSHIP = dict(n=256, n_t=64)
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

def make_stencil(rng, n_w, ny, nx, complex_=False):
    """A diagonally dominant 9-point stencil (Dirichlet-like centre), its
    inverse diagonal and Gershgorin Chebyshev bounds (theta, delta)."""
    K = 9
    w = -0.5 * rng.uniform(0.2, 1.0, (n_w, K, ny, nx))
    w[:, K // 2] = 4.0 + rng.uniform(0.0, 1.0, (n_w, ny, nx))
    if complex_:
        phase = rng.uniform(-0.3, 0.3, (n_w, K, ny, nx))
        w = w * np.exp(1j * phase)
    lam = (np.abs(w).sum(axis=1) / np.abs(w[:, K // 2])).max(axis=(1, 2))
    lam = 1.05 * lam
    theta = 0.5 * (lam + lam / 4.0)
    delta = 0.5 * (lam - lam / 4.0)
    return w, 1.0 / w[:, K // 2], theta, delta


def check_kernels(dev, record):
    from control_tpu_torch.ops import stencil as st

    rng = np.random.default_rng(SEED)
    n_t = FLAGSHIP["n_t"]
    g = FLAGSHIP["n"] + 1
    results = {"K1": [], "K2": [], "K3": []}

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

        # K1: (63, 257, 257), shared weights (the pc's stacked actions)
        w, _, _, _ = make_stencil(rng, 1, g, g)
        x = field((n_t - 1, g, g))
        wt, xt = T(w), T(x)
        got = st.apply_stencil(wt, xt, 1)
        ref = st._apply_plain(wt, xt, 1)
        torch.cuda.synchronize()
        ab, rel = errors(got, ref)
        ms, pms = in_turns(lambda: st.apply_stencil(wt, xt, 1),
                           lambda: st._apply_plain(wt, xt, 1))
        results["K1"].append(dict(dtype=name, shape=[n_t - 1, g, g],
                                  max_abs_err=ab, max_rel_err=rel,
                                  tol=TOL[("K1", name)], ms=ms,
                                  plain_ms=pms))

        # K2: (63, 257, 257), 10 steps, shared w and dinv, scalar bounds
        # (the (1,1) mass solve)
        w, dinv, theta, delta = make_stencil(rng, 1, g, g)
        b = field((n_t - 1, g, g))
        wt, dt_, bt = T(w), T(dinv[0]), T(b)
        x0 = torch.zeros_like(bt)
        th, de = float(theta[0]), float(delta[0])

        def k2():
            return st.fused_cheb_smooth(wt, dt_, bt, x0, 10, th, de, 1,
                                        want_residual=True)

        def p2():
            return st._cheb_plain(wt, dt_, bt, x0, 10, th, de, 1,
                                  want_residual=True)

        ab, rel = errors(k2(), p2())
        ms, pms = in_turns(k2, p2)
        results["K2"].append(dict(dtype=name, shape=[n_t - 1, g, g],
                                  steps=10, max_abs_err=ab, max_rel_err=rel,
                                  tol=TOL[("K2", name)], ms=ms,
                                  plain_ms=pms))

        # K3: n_f = 32 frequencies, per-batch complex w, (n,) bounds, 3
        # steps, residual on, at every smoothed level of the hierarchy
        n_f = (n_t - 1) // 2 + 1
        for gl in (257, 129, 65, 33):
            w, dinv, theta, delta = make_stencil(rng, n_f, gl, gl,
                                                 complex_=True)
            b = field((n_f, gl, gl), cplx=True)
            x0 = field((n_f, gl, gl), cplx=True)
            wt, dt_ = T(w, cdt), T(dinv, cdt)
            bt, xt = T(b, cdt), T(x0, cdt)
            th, de = T(theta), T(delta)

            def k3():
                return st.fused_cheb_smooth(wt, dt_, bt, xt, 3, th, de, 1,
                                            want_residual=True)

            def p3():
                return st._cheb_plain(wt, dt_, bt, xt, 3, th, de, 1,
                                      want_residual=True)

            ab, rel = errors(k3(), p3())
            ms, pms = in_turns(k3, p3)
            results["K3"].append(dict(dtype=name, shape=[n_f, gl, gl],
                                      steps=3, max_abs_err=ab,
                                      max_rel_err=rel,
                                      tol=TOL[("K3", name)], ms=ms,
                                      plain_ms=pms))
    record["kernel_checks"] = results
    for kname, rows in results.items():
        for r in rows:
            print(f"{kname} {r['dtype']} {r['shape']}: rel err "
                  f"{r['max_rel_err']:.3e} (tol {r['tol']:.0e}), kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms",
                  flush=True)
            if not r["max_rel_err"] <= r["tol"]:
                raise AssertionError(f"{kname} disagrees with its plain "
                                     f"version: {r}")
    return results


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

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


def solve(ctl):
    return ctl.linear_solve(lambda_v_bounds=(0.25, 2.25),
                            solver_parameters=SOLVER_PARAMETERS,
                            print_error=False)


def check_small_f64(dev, record):
    """The slice in float64 on the card against the same solve on the CPU
    (plain versions, which the CPU tests hold to the JAX reference)."""
    out = {}
    for mode, n in (("paradiag", 32), ("scan", 16)):
        runs = {}
        for device in ("cpu", dev):
            ctl = heat_problem(n, 8, torch.float64, device, mode)
            info = solve(ctl)
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
        print(f"slice f64 {mode} {n}^2x8: cuda vs cpu {row}", flush=True)
        if not (ig.iterations == its and hist < 1e-8 and dv < 1e-9
                and dz < 1e-9):
            raise AssertionError(f"cuda slice disagrees with cpu: {row}")
    record["small_f64"] = out


def flagship(dev, record, card):
    from control_tpu_torch.ops import stencil as st
    from control_tpu_torch.config import full_precision
    from control_tpu_torch.fem.assemble import assemble
    from control_tpu_torch.fem.space import combine_masks

    n, n_t = FLAGSHIP["n"], FLAGSHIP["n_t"]
    t0 = time.perf_counter()
    ctl = heat_problem(n, n_t, torch.float32, dev, "paradiag")
    first = solve(ctl)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    # the pc build alone, on the card, from the solve's own inputs
    with full_precision():
        mask = combine_masks(ctl._space_v, ctl._bcs_v[1])
        Dv_A = ctl._D_stack(ctl._v.data)
        M = assemble(ctl._M_v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctl.construct_pc(False, (0.25, 2.25), mask, Dv_A, M)
        torch.cuda.synchronize()
        pc_build_s = time.perf_counter() - t0

    st.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    info = solve(ctl)
    end.record()
    torch.cuda.synchronize()
    solve_host_s = time.perf_counter() - t0
    solve_s = start.elapsed_time(end) / 1e3
    launches = dict(st.launch_counts)

    v, zeta = ctl._v.data, ctl._zeta.data
    rel = info.rnorm / info.rnorm0
    row = {"metric": "heat_control_256x256_nt64_kkt_solve_cuda",
           "schur": "paradiag", "dtype": "float32",
           "iterations": info.iterations, "relative_residual": rel,
           "converged": info.converged, "solve_s": solve_s,
           "solve_host_s": solve_host_s, "pc_build_s": pc_build_s,
           "first_solve_s": first_s, "first_iterations": first.iterations,
           "launches": launches, "card": card}
    print(json.dumps(row), flush=True)
    record["flagship"] = row
    if not (info.converged and rel < 1e-6 and info.iterations <= 12):
        raise AssertionError(f"flagship solve off target: {row}")
    if not (v.is_cuda and zeta.is_cuda):
        raise AssertionError("solution left the card")
    shape = (n_t, n + 1, n + 1)
    if (tuple(v.shape) != shape or tuple(zeta.shape) != shape
            or not bool(torch.isfinite(v).all())
            or not bool(torch.isfinite(zeta).all())):
        raise AssertionError("solution has the wrong shape or is not "
                             "finite")
    for k, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {k} never launched in the "
                                 f"timed solve: {launches}")
    return row


def scan_default(dev, record):
    """The README's default (``scan`` sweeps) at the flagship size, once."""
    n, n_t = FLAGSHIP["n"], FLAGSHIP["n_t"]
    ctl = heat_problem(n, n_t, torch.float32, dev, "scan")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = solve(ctl)
    torch.cuda.synchronize()
    row = {"schur": "scan", "dtype": "float32",
           "iterations": info.iterations,
           "relative_residual": info.rnorm / info.rnorm0,
           "converged": info.converged,
           "first_solve_s": time.perf_counter() - t0}
    print("scan sweeps " + json.dumps(row), flush=True)
    record["flagship_scan"] = row
    if not (info.converged and row["relative_residual"] < 1e-6):
        raise AssertionError(f"scan solve off target: {row}")


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
    check_small_f64(dev, record)
    flag = flagship(dev, record, card)
    scan_default(dev, record)

    def row(kname, route, source, replaces, key, checks_rows):
        main = next(r for r in checks_rows if r["dtype"] == "float32")
        return {"name": kname, "route": route, "source": source,
                "replaces": replaces,
                "launches": flag["launches"][key],
                "max_abs_err": max(r["max_abs_err"] for r in checks_rows
                                   if r["dtype"] == "float32"),
                "ms": main["ms"], "plain_ms": main["plain_ms"]}

    kernels_line = {"kernels": [
        row("K1 stencil_apply", "cuda",
            "control_tpu_torch/csrc/stencil_apply.cu",
            "control_tpu/ops/stencil.py:206", "stencil_apply",
            checks["K1"]),
        row("K2 cheb_smooth (real)", "cuda",
            "control_tpu_torch/csrc/cheb_smooth.cu",
            "control_tpu/ops/stencil.py:589", "cheb_smooth_real",
            checks["K2"]),
        row("K3 cheb_smooth (complex)", "cuda",
            "control_tpu_torch/csrc/cheb_smooth.cu",
            "control_tpu/ops/stencil.py:728", "cheb_smooth_complex",
            checks["K3"]),
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

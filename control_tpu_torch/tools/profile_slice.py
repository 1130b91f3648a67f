#!/usr/bin/env python3
"""Measure the port's slices on the card, beyond what ``chip_smoke.py``
checks.  Run from the root of a checkout (its ``control_tpu_torch`` and
``chip_smoke.py`` are the ones measured, so two checkouts can be compared
in turns within one call on one card):

    python3 control_tpu_torch/tools/profile_slice.py kernels2d
        K1-K3 at the 2-D flagship's shapes (f32, CUDA events) and the
        flagship ParaDiag solve (best of 3 repeat solves): one JSON line;
    python3 control_tpu_torch/tools/profile_slice.py profile heat3d
        one torch.profiler trace of a repeat heat3d (64^3 x 16, f32,
        ParaDiag) solve: device busy share (union of kernel intervals over
        the solve's wall time), device time by kernel and the complex
        smoothers' (K3, K5 complex: on per-frequency planes, and the pair
        smoother on the stencil pairs) share of it, one JSON line;
        ``profile flagship`` and ``profile heat3d_q2`` (hex Q2 32^3 x 16)
        do the same for the 2-D flagship and the Q2 heat slice, and the
        targets ``flagship_bf16``, ``heat3d_bf16`` and ``heat3d_q2_bf16``
        for the same solves with the ParaDiag weight planes stored in
        bfloat16 (``weight_dtype``); ``be`` and ``heat3d_be`` for the
        flagship and heat3d under backward Euler (``CN=False``, ParaDiag,
        GMRES(30), budget 100) and ``be_scan`` for the flagship under
        backward Euler with the scan sweeps in float64 (the reference
        recipe);
    python3 control_tpu_torch/tools/profile_slice.py profile stokes
        the Stokes slice (64^2 x 32, f64, scan): the repeat solve timed
        unprofiled, then a trace of a window of it, the first two outer
        FGMRES iterations (a whole solve is millions of launches), with the
        device time of K4 and of the multigrid transfers (every kernel
        launched inside ``Transfer.prolong`` / ``restrict``) beside the
        busy share;
    python3 control_tpu_torch/tools/profile_slice.py profile stokes3d
        the same for the 3-D Stokes slice (Taylor-Hood Q2-Q1 on 16^3
        hexahedra x 8, f64, scan), with K5v's device time;
    python3 control_tpu_torch/tools/profile_slice.py profile poisson
        the stationary ``poisson`` solve (Q1 256^2, f32; ``poisson_large``
        at 2048^2; ``poisson_q3``, the manufactured Q3 problem at 256^2 in
        f64), traced whole, with K1's and K2's device time (2-D, real);
        ``profile stationary_hex_q3`` (the exact pair on hex Q3 32^3,
        f64) and ``profile heat3d_q3`` (heat3d on hex Q3 24^3 x 16, f32,
        ParaDiag), with K6's and K5 real's device time at degree 3.

    python3 <this checkout>/control_tpu_torch/tools/profile_slice.py vector
        K4 and K5v at the shapes of their paths (the velocity mass solves,
        a ragged batch of nine, the smoothed V-cycle levels) through the
        public wrapper: the time of a call (CUDA events; the host's share
        of a small level's call shows here), its device time (the
        kernels' time in a torch.profiler trace) and, at the unbatched
        V-cycle levels, the host's time a call (a CPU clock over
        thousands of calls); the script of one checkout times the kernels
        of whichever checkout it is run from: one JSON line.

    python3 <this checkout>/control_tpu_torch/tools/profile_slice.py pair
        the ParaDiag pair smoother (``fused_cheb_smooth_pair``) at the
        finest shapes of heat3d_q3 (8 x 73^3, degree 3), heat3d_q2 and
        heat3d (8 x 65^3, degree 2 and 1), 8 steps + r, and the flagship
        (32 x 257^2, 3 steps + r), complex64: its time and that of the
        per-frequency kernel on the same operator's formed planes, in
        turns (pair, per-frequency, pair), and its error against the
        plain twin; like ``vector``, it times the kernels of whichever
        checkout it is run from: one JSON line.

    python3 <this checkout>/control_tpu_torch/tools/profile_slice.py real \
            [name ...]
        K2 and K5 real (``fused_cheb_smooth`` on real fields) at the
        shapes of their paths (the mass solves' shared-weight batches,
        the batch-one V-cycle levels, bf16 planes; ``REAL_SHAPES``, or the
        names given): the time of a call, its error against the plain
        version, the bound and the (steps + 1)-pass weight floor; like
        ``vector``, it times the kernels of whichever checkout it is run
        from: one JSON line.

    python3 <this checkout>/control_tpu_torch/tools/profile_slice.py ring
        one field of K2 and K5 real at the V-cycle levels' shapes (1 x
        257^2 and 1 x 65^3 at degree 1, 8 steps + r; 769^2 and 97^3 at
        degree 3, 20 + r; 73^3 at degree 3, 10 + r) with planes in
        float64, float32 under float64, float32 and bfloat16 under
        float32: the kernel ``fused_cheb_smooth`` runs there (the weight
        ring, or the per-entry kernel where ``cheb_design`` picks it)
        against the per-entry kernel called at its C entry point
        (``chip_smoke.per_entry_one``), in turns (wrapper, per-entry,
        per-entry, wrapper): device time (the summed durations of the
        ``cheb`` kernels in a torch.profiler trace, with their count a
        call, steps + 1 when no record is lost) and event time (host
        included); like ``vector``, it times the kernels of whichever
        checkout it is run from: one JSON line.

    python3 control_tpu_torch/tools/profile_slice.py history stokes \
            float32|float64 [n n_t [iterations]]
        the Stokes solve's relative residual history within a budget of
        outer iterations (default 64 32 100), without raising when it does
        not converge, with its seconds: one JSON line.

    python3 control_tpu_torch/tools/profile_slice.py history <slice> \
            float32|float64 [n n_t [iterations]] [cpu]
        the same for a heat slice (flagship, heat3d, heat3d_q2 or their
        _bf16 targets, or be, be_scan, heat3d_be; default their
        chip_smoke.py size and budget); ``cpu`` runs it on the CPU (the
        plain versions, no card needed), to hold the card's history
        against it.

    python3 control_tpu_torch/tools/profile_slice.py determinism \
            stokes|stokes3d [n n_t]
        whether a Stokes solve (default its chip_smoke.py size, f64)
        repeats itself in one process: two preconditioner builds (every
        coarse dense inverse compared bit for bit), then pairs of solves
        (iterations, residual histories bit for bit): with torch's
        defaults (the transfers ask cuDNN for deterministic algorithms
        themselves) and under ``torch.use_deterministic_algorithms(True)``:
        one JSON line.

    python3 control_tpu_torch/tools/profile_slice.py precision stokes \
            [n n_t [iterations]]
        where float32 loses the Stokes solve (default 64 8 20): the
        relative residual after the budget in float64, in float32, and with
        the operator and the Krylov loop in float32 but the whole
        preconditioner applied in float64; and the float32-against-float64
        error of each stage of the preconditioner on one seeded input.

Needs one CUDA card (``history ... cpu`` does not); imports nothing of
JAX.
"""

import bisect
import json
import os
import re
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402  (the checkout's own problem definitions)

SOLVER_PARAMETERS = chip_smoke.SOLVER_PARAMETERS
BE_PARAMETERS = chip_smoke.BE_PARAMETERS
# name: (size, lambda bounds, problem, sweep, Krylov parameters, dtype of
# ``profile``); the backward-Euler slices with ``bench.py``'s BE recipe
# (GMRES(30), budget 100), the scan in float64 as its reference recipe
SLICES = {
    "flagship": ((256, 64), (0.25, 2.25), "heat_problem", "paradiag",
                 SOLVER_PARAMETERS, "float32"),
    "heat3d": ((64, 16), (0.125, 3.375), "heat3d_problem", "paradiag",
               SOLVER_PARAMETERS, "float32"),
    "heat3d_q2": ((32, 16), (0.1, 2.3), "heat3d_q2_problem", "paradiag",
                  SOLVER_PARAMETERS, "float32"),
    "be": ((256, 64), (0.25, 2.25), "heat_be_problem", "paradiag",
           BE_PARAMETERS, "float32"),
    "be_scan": ((256, 64), (0.25, 2.25), "heat_be_problem", "scan",
                SOLVER_PARAMETERS, "float64"),
    "heat3d_be": ((64, 16), (0.125, 3.375), "heat3d_be_problem", "paradiag",
                  BE_PARAMETERS, "float32"),
    # hex Q3 24^3 x 16 with the Jacobi-scaled Q3 mass bounds, computed
    "heat3d_q3": ((chip_smoke.HEX_Q3["heat_n"],
                   chip_smoke.HEX_Q3["heat_n_t"]),
                  lambda: chip_smoke.q3_mass_bounds(3), "heat3d_q3_problem",
                  "paradiag", SOLVER_PARAMETERS, "float32")}
# the Crank-Nicolson ParaDiag slices with their weight planes stored narrow
NARROW = {f"{k}_bf16": (k, "bfloat16")
          for k in ("flagship", "heat3d", "heat3d_q2")}
# the stationary solves of chip_smoke.py: name -> problem(device), which
# returns the problem and its linear_solve arguments
STATIONARY_SLICES = {
    "poisson": lambda dev: chip_smoke.poisson_problem(
        chip_smoke.STATIONARY["n"], torch.float32, dev),
    "poisson_large": lambda dev: chip_smoke.poisson_problem(
        chip_smoke.STATIONARY["large_n"], torch.float32, dev),
    "poisson_q3": lambda dev: chip_smoke.poisson_q3_problem(
        chip_smoke.STATIONARY["q3_n"], torch.float64, dev,
        chip_smoke.q3_mass_bounds())[:2],
    "stationary_hex_q3": lambda dev: chip_smoke.stationary_hex_problem(
        chip_smoke.HEX_Q3["stationary_n"], 3, torch.float64, dev,
        chip_smoke.q3_mass_bounds(3))[:2]}
STOKES_SLICES = {
    "stokes": ((chip_smoke.STOKES["n"], chip_smoke.STOKES["n_t"]),
               "stokes_problem", chip_smoke.LAMBDA_STOKES),
    "stokes3d": ((chip_smoke.STOKES3D["n"], chip_smoke.STOKES3D["n_t"]),
                 "stokes3d_problem", chip_smoke.LAMBDA_STOKES3D)}


WINDOW_ITERATIONS = 2


def problem(name):
    """The slice's problem, its solve, and the solve that is traced (for
    Stokes a window of ``WINDOW_ITERATIONS`` outer iterations, which does
    not converge and says so instead of raising)."""
    dev = torch.device("cuda", 0)
    if name in STATIONARY_SLICES:
        ctl, kw = STATIONARY_SLICES[name](dev)

        def solve():
            return ctl.linear_solve(print_error=False, **kw)
        return ctl, solve, solve
    if name in STOKES_SLICES:
        size, maker, lambdas = STOKES_SLICES[name]
        ctl = getattr(chip_smoke, maker)(*size, torch.float64, dev)
        window = dict(chip_smoke.STOKES_PARAMETERS, preconditioner=True,
                      maximum_iterations=WINDOW_ITERATIONS)

        def solve(parameters=chip_smoke.STOKES_PARAMETERS):
            from control_tpu_torch import ConstantNullspace
            return ctl.incompressible_linear_solve(
                ConstantNullspace(), solver_parameters=parameters,
                print_error=False, **lambdas)
        return ctl, solve, lambda: solve(window)
    name, weight_dtype = NARROW.get(name, (name, None))
    (n, n_t), bounds, maker, mode, parameters, dtype = SLICES[name]
    if callable(bounds):
        bounds = bounds()
    ctl = getattr(chip_smoke, maker)(n, n_t, getattr(torch, dtype), dev,
                                     mode)
    if weight_dtype is not None:
        ctl.set_schur_sweep("paradiag", weight_dtype=weight_dtype)
        # the 3-D slices stall with bfloat16 weights at this width
        # (ROADMAP.md Queue 3): the solve reports its budget's end
        parameters = dict(parameters, preconditioner=True)

    def solve():
        return ctl.linear_solve(lambda_v_bounds=bounds,
                                solver_parameters=parameters,
                                print_error=False)
    return ctl, solve, solve


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _stencil9(rng, n_w, g, cplx=False):
    """A diagonally dominant 9-point stencil on a g x g grid, its inverse
    diagonal and Chebyshev bounds."""
    w = -0.5 * rng.uniform(0.2, 1.0, (n_w, 9, g, g))
    w[:, 4] = 4.0 + rng.uniform(0.0, 1.0, (n_w, g, g))
    if cplx:
        w = w * np.exp(1j * rng.uniform(-0.3, 0.3, w.shape))
    lam = 1.05 * (np.abs(w).sum(axis=1) / np.abs(w[:, 4])).max(axis=(1, 2))
    return w, 1.0 / w[:, 4], 0.625 * lam, 0.375 * lam


def kernels2d():
    """K1-K3 at the flagship's shapes, through the public wrappers (the
    same calls in every checkout), and the flagship's repeat solve."""
    from control_tpu_torch.ops import stencil as st
    rng = np.random.default_rng(chip_smoke.SEED)
    dev = torch.device("cuda", 0)
    g, n = 257, 63

    def T(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=dt, device=dev)

    w, dinv, theta, delta = _stencil9(rng, 1, g)
    x = T(rng.standard_normal((n, g, g)))
    wt, dt_ = T(w), T(dinv[0])
    out = {}
    out["K1_ms"] = chip_smoke.cuda_ms(lambda: st.apply_stencil(wt, x, 1))
    x0 = torch.zeros_like(x)
    out["K2_ms"] = chip_smoke.cuda_ms(lambda: st.fused_cheb_smooth(
        wt, dt_, x, x0, 10, float(theta[0]), float(delta[0]), 1,
        want_residual=True))
    nf = 32
    w, dinv, theta, delta = _stencil9(rng, nf, g, True)
    wc, dc = T(w, torch.complex64), T(dinv, torch.complex64)
    bc = T(rng.standard_normal((nf, g, g)), torch.complex64)
    th, de = T(theta), T(delta)
    out["K3_ms"] = chip_smoke.cuda_ms(lambda: st.fused_cheb_smooth(
        wc, dc, bc, bc, 3, th, de, 1, want_residual=True))
    _, solve, _ = problem("flagship")
    solve()
    out["flagship_solve_s"] = min(timed(solve)[0] for _ in range(3))
    return out


RANGE = "mg_transfer"


def device_busy(prof, wall_us):
    """Union of the device kernels' intervals, and device time by name
    (the device-side copies of the profiler ranges are no kernels)."""
    spans, by_name = [], {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name == RANGE):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return busy / wall_us, len(spans), [(k[:90], v / 1e3) for k, v in top]


def _in_range(cls, method, label):
    """Run ``cls.method`` inside a profiler range, so that the trace sums
    the device time of the kernels it launches under ``label``."""
    inner = getattr(cls, method)

    def ranged(*args, **kwargs):
        with torch.profiler.record_function(label):
            return inner(*args, **kwargs)
    setattr(cls, method, ranged)


# K4's and K5v's kernel names: this tree's, and those of trees before the
# two shared one template (so that a run from an older checkout reads them)
K4_NAMES = ("vector_cheb_kernel<2,", "vector_step_kernel",
            "vector_residual_kernel")
K5V_NAMES = ("vector_cheb_kernel<3,", "vector3_step_kernel",
             "vector3_residual_kernel")


def profile(name):
    from torch.profiler import profile as tprofile, ProfilerActivity
    from control_tpu_torch.solvers.multigrid import Transfer
    from control_tpu_torch.ops import stencil as st
    ctl, solve, window = problem(name)
    first_s, _ = timed(solve)
    st.reset_launch_counts()
    plain_s, info = timed(solve)
    launches = {k: v for k, v in st.launch_counts.items() if v}
    window_s, _ = timed(window)
    for method in ("prolong", "restrict"):
        _in_range(Transfer, method, RANGE)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        prof_s, winfo = timed(window)
    share, n_kernels, top = device_busy(prof, prof_s * 1e6)
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in on_device if e.name != RANGE]
    # the ranges' device-side copies span their kernels on the device's
    # timeline (they do not nest): a kernel inside one belongs to it
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in on_device if e.name == RANGE)
    starts = [a for a, _ in ranges]

    def in_range(e):
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        return i >= 0 and e.time_range.end <= ranges[i][1]

    def ms(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3

    def complex_smoother(e, nd):
        # cheb_smooth.cuh's kernels on complex fields (full or narrow
        # weights): cheb_step_kernel<nd, D, float2|double2, ...>
        return (any(f"{k}<{nd}," in e.name
                    for k in ("cheb_step_kernel", "residual_kernel"))
                and any(f", {v}," in e.name for v in ("float2", "double2")))

    def real(e, names, nd=2):
        # the field type is the third template argument (the complex
        # kernels' last one is their real type)
        return any(re.search(rf"{k}<{nd}, \d+, (float|double)[,>]", e.name)
                   for k in names)

    def tile(e, nd, ns):
        # cheb_tile.cuh's kernels: cheb_tile_step<nd, D, NB, NS, V, ...>,
        # NS = 1 for K2 / K5 real, 2 for the pair smoother
        return any(re.search(rf"{k}<{nd}, \d+, \d+, {ns},", e.name)
                   for k in ("cheb_tile_step", "cheb_tile_residual"))

    def real_smoother(e, nd):
        # the per-entry kernel, the plane tile and the weight ring
        # (cheb_ring_step<nd, D, V, Wt>)
        return (real(e, ("cheb_step_kernel", "residual_kernel",
                         "cheb_ring_step", "cheb_ring_residual"), nd)
                or tile(e, nd, 1))

    def pair_smoother(e, nd):
        return tile(e, nd, 2)

    device_ms = ms(kernels)
    k3_ms = ms(e for e in kernels if complex_smoother(e, 2))
    k5c_ms = ms(e for e in kernels if complex_smoother(e, 3))
    k3p_ms = ms(e for e in kernels if pair_smoother(e, 2))
    k5cp_ms = ms(e for e in kernels if pair_smoother(e, 3))
    return {"slice": name, "iterations": info.iterations,
            "converged": info.converged,
            "relative_residual": info.rnorm / info.rnorm0,
            "first_solve_s": first_s, "solve_s": plain_s,
            "traced_iterations": winfo.iterations,
            "traced_unprofiled_s": window_s, "profiled_solve_s": prof_s,
            "device_busy_share_of_profiled": share,
            "device_ms_over_unprofiled_window": device_ms / 1e3 / window_s,
            "device_kernels": n_kernels, "device_ms": device_ms,
            "k4_device_ms": ms(e for e in kernels
                               if any(k in e.name for k in K4_NAMES)),
            "k5v_device_ms": ms(e for e in kernels
                                if any(k in e.name for k in K5V_NAMES)),
            "mg_transfer_device_ms": ms(e for e in kernels if in_range(e)),
            "k1_device_ms": ms(e for e in kernels
                               if real(e, ("stencil_apply_kernel",))),
            "k2_device_ms": ms(e for e in kernels if real_smoother(e, 2)),
            "k6_device_ms": ms(e for e in kernels
                               if real(e, ("stencil_apply_kernel",), 3)),
            "k5_real_device_ms": ms(e for e in kernels
                                    if real_smoother(e, 3)),
            "k3_device_ms": k3_ms, "k5_complex_device_ms": k5c_ms,
            "k3_share_of_device": k3_ms / device_ms,
            "k5_complex_share_of_device": k5c_ms / device_ms,
            "k3_pair_device_ms": k3p_ms,
            "k5_complex_pair_device_ms": k5cp_ms,
            "k3_pair_share_of_device": k3p_ms / device_ms,
            "k5_complex_pair_share_of_device": k5cp_ms / device_ms,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "weight_dtype": NARROW.get(name, (name, None))[1],
            "launches": dict(launches),
            "device_ms_by_kernel": top}


def vector_cases():
    """K4's and K5v's shapes on their paths, as ``chip_smoke.py`` checks
    them: (name, nd, grid, batch (0: unbatched), steps, residual, degree,
    dtypes)."""
    gs = 2 * chip_smoke.STOKES["n"] + 1
    ns = chip_smoke.STOKES["n_t"] - 1
    g3 = 2 * chip_smoke.STOKES3D["n"] + 1
    n3 = chip_smoke.STOKES3D["n_t"] - 1
    both, f64 = ("float64", "float32"), ("float64",)
    return [
        ("K4 mass solve", 2, (gs, gs), ns, 20, False, 2, both),
        ("K4 ragged batch", 2, (gs, gs), 9, 20, False, 2, f64),
        ("K4 level", 2, (gs, gs), 0, 8, True, 2, f64),
        ("K4 level", 2, ((gs + 1) // 2,) * 2, 0, 8, True, 2, f64),
        ("K5v mass solve", 3, (g3,) * 3, n3, 20, False, 2, both),
        ("K5v ragged batch", 3, (g3,) * 3, 9, 20, False, 2, f64),
        ("K5v level", 3, (g3,) * 3, 0, 8, True, 2, both),
        ("K5v level", 3, ((g3 + 1) // 2,) * 3, 0, 8, True, 2, both),
        ("K5v level, degree 1", 3, (g3,) * 3, 0, 8, True, 1, f64)]


def _vector_inputs(case, dtype, rng):
    """Seeded inputs of one case on the card (``chip_smoke.py``'s
    stencils: shared weights and dinv, scalar bounds)."""
    _, nd, grid, n, _, _, degree, _ = case
    maker = (chip_smoke.make_vector_stencil if nd == 2
             else chip_smoke.make_vector_stencil_3d)
    w, dinv, th, de = maker(rng, grid, degree)

    def T(a):
        return torch.as_tensor(a, dtype=getattr(torch, dtype),
                               device=torch.device("cuda", 0))

    lead = (n,) if n else ()
    b = T(rng.standard_normal(lead + grid + (nd,)))
    x0 = torch.zeros_like(b) if n else T(rng.standard_normal(grid + (nd,)))
    return T(w), T(dinv), b, x0, th, de


VECTOR_REPEATS = 20
# calls a host timing of an unbatched level averages over (K4, K5v)
HOST_CALLS = {2: 10000, 3: 2000}


def device_ms(fn, calls=VECTOR_REPEATS):
    """Device time of the kernels one call of ``fn`` launches (the mean
    over ``calls`` calls in a torch.profiler trace)."""
    from torch.profiler import profile as tprofile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / calls


def host_us(fn, calls):
    """The host's time (us) a call of ``fn``: a CPU clock over ``calls``
    calls with no synchronisation between them, read before and after the
    final one.  Where the card keeps up, the first is the wrapper's host
    work (Python, allocation, launches); where it does not, the launch
    queue fills and both approach the device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / calls * 1e6, (t2 - t0) / calls * 1e6


def vector():
    """K4 and K5v at their paths' shapes through ``fused_cheb_smooth``."""
    from control_tpu_torch.ops import stencil as st
    rng = np.random.default_rng(chip_smoke.SEED)
    rows = []
    for case in vector_cases():
        name, nd, grid, n, steps, residual, degree, dtypes = case
        for dtype in dtypes:
            w, dinv, b, x0, th, de = _vector_inputs(case, dtype, rng)
            # the unbatched levels take a tenth of a millisecond, and the
            # host's noise needs more calls to average out
            def call():
                return st.fused_cheb_smooth(w, dinv, b, x0, steps, th, de,
                                            degree, want_residual=residual,
                                            nd=nd)
            ms = chip_smoke.cuda_ms(
                call, VECTOR_REPEATS if n else 10 * VECTOR_REPEATS)
            row = {"case": name, "dtype": dtype, "shape": list(b.shape),
                   "steps": steps, "residual": residual, "degree": degree,
                   "ms": ms, "device_ms": device_ms(call)}
            if not n:
                row["host_us"], row["host_sync_us"] = host_us(
                    call, HOST_CALLS[nd])
            rows.append(row)
            del w, dinv, b, x0
    return {"vector": rows}


def history(name, dtype, n, n_t, budget, device="cuda"):
    """A slice's residual history in ``dtype`` within ``budget`` outer
    iterations; a solve that does not converge is reported, not
    raised."""
    from control_tpu_torch import ConstantNullspace
    dev = torch.device(device)
    if name == "stokes":
        ctl = chip_smoke.stokes_problem(n, n_t, getattr(torch, dtype), dev)
        parameters = dict(chip_smoke.STOKES_PARAMETERS, preconditioner=True,
                          maximum_iterations=budget)

        def solve():
            return ctl.incompressible_linear_solve(
                ConstantNullspace(), solver_parameters=parameters,
                print_error=False, **chip_smoke.LAMBDA_STOKES)
    else:
        base, weight_dtype = NARROW.get(name, (name, None))
        _, bounds, maker, mode, parameters, _ = SLICES[base]
        if callable(bounds):
            bounds = bounds()
        ctl = getattr(chip_smoke, maker)(n, n_t, getattr(torch, dtype), dev,
                                         mode)
        if weight_dtype is not None:
            ctl.set_schur_sweep("paradiag", weight_dtype=weight_dtype)
        parameters = dict(parameters, preconditioner=True,
                          maximum_iterations=budget)

        def solve():
            return ctl.linear_solve(lambda_v_bounds=bounds,
                                    solver_parameters=parameters,
                                    print_error=False)
    if dev.type == "cuda":
        seconds, info = timed(solve)
    else:
        t0 = time.perf_counter()
        info = solve()
        seconds = time.perf_counter() - t0
    its = info.iterations
    return {"slice": name, "device": device, "dtype": dtype, "n": n,
            "n_t": n_t,
            "budget": budget, "iterations": its,
            "converged": info.converged,
            "relative_residual": info.rnorm / info.rnorm0,
            "first_solve_s": seconds,
            "relative_history": [float(r / info.res_norms[0])
                                 for r in info.res_norms[:its + 1]]}


def determinism(name, n, n_t):
    """Repeat builds and solves of a Stokes slice in one process."""
    from control_tpu_torch import ConstantNullspace
    dev = torch.device("cuda", 0)
    _, maker, lambdas = STOKES_SLICES[name]
    ctl = getattr(chip_smoke, maker)(n, n_t, torch.float64, dev)

    def solve(**extra):
        return ctl.incompressible_linear_solve(
            ConstantNullspace(), solver_parameters=chip_smoke.
            STOKES_PARAMETERS, print_error=False, **lambdas, **extra)

    first, second = (
        chip_smoke.dense_inverses(solve(_return_pieces=True)[1].state)
        for _ in range(2))
    out = {"slice": name, "dtype": "float64", "n": n, "n_t": n_t,
           "dense_inverses": {k: list(v.shape) for k, v in first.items()},
           "dense_inverses_bit_equal": all(
               torch.equal(first[k], second[k]) for k in first)}
    modes = {"default": False, "deterministic_algorithms": True}
    for mode, strict in modes.items():
        runs = []
        for _ in range(2):
            torch.use_deterministic_algorithms(strict)
            seconds, info = timed(solve)
            runs.append((info, seconds))
        torch.use_deterministic_algorithms(False)
        hists = [np.asarray(i.res_norms[:i.iterations + 1]) for i, _ in runs]
        k = min(len(h) for h in hists)
        out[mode] = {
            "iterations": [i.iterations for i, _ in runs],
            "relative_residual": [i.rnorm / i.rnorm0 for i, _ in runs],
            "solve_s": [s for _, s in runs],
            "histories_bit_equal": bool(np.array_equal(*hists)),
            "history_max_rel": float(np.max(np.abs(hists[0][:k]
                                                   - hists[1][:k])
                                            / hists[0][:k]))}
    return out


def precision(n, n_t, budget):
    """Float32 against float64 on the Stokes slice: three solves within
    ``budget`` outer iterations, and each preconditioner stage's relative
    error (max norm) on the same seeded input."""
    from control_tpu_torch import (ConstantNullspace, TrialFunction,
                                   TestFunction, inner, grad, dx)
    from control_tpu_torch.config import full_precision
    from control_tpu_torch.fem.assemble import assemble
    from control_tpu_torch.fem.space import combine_masks
    from control_tpu_torch.models.common import (BlockSolver, mass_solver,
                                                 regularized_stiffness)
    from control_tpu_torch.models.instationary import _SweepSolver

    dev = torch.device("cuda", 0)
    parameters = dict(chip_smoke.STOKES_PARAMETERS, preconditioner=True,
                      maximum_iterations=budget)
    kw = dict(solver_parameters=parameters, print_error=False,
              **chip_smoke.LAMBDA_STOKES)
    lam_v = chip_smoke.LAMBDA_STOKES["lambda_v_bounds"]
    lam_p = chip_smoke.LAMBDA_STOKES["lambda_p_bounds"]
    parts, out = {}, {"slice": "stokes", "n": n, "n_t": n_t,
                      "budget": budget}
    with full_precision():
        for name in ("float64", "float32"):
            ctl = chip_smoke.stokes_problem(n, n_t, getattr(torch, name),
                                            dev)
            info = ctl.incompressible_linear_solve(ConstantNullspace(), **kw)
            out[f"{name}_relative_residual"] = info.rnorm / info.rnorm0
            sp, spp = ctl._space_v, ctl._space_p
            mask = combine_masks(sp, ctl._bcs_v[1])
            Dv_A = ctl._D_stack(ctl._v.data)
            M = assemble(ctl._M_v)
            c = 0.5 * ctl._tau / ctl._beta ** 0.5
            fwd = _SweepSolver(
                sp, mask, (0.5 * ctl._tau * Dv_A[0] + (1 + c) * M.A)[None],
                (0.5 * ctl._tau * Dv_A[0] + (c - 1) * M.A)[None])
            pt, ps = TrialFunction(spp), TestFunction(spp)
            M_p = assemble(inner(pt, ps) * dx)
            K_p = regularized_stiffness(
                assemble(inner(grad(pt), grad(ps)) * dx), M_p)
            system, pc, b0, b1 = ctl.incompressible_linear_solve(
                ConstantNullspace(), _return_pieces=True, **kw)
            parts[name] = dict(
                mask=mask, system=system, pc=pc, b0=b0, b1=b1, fwd=fwd,
                inner_pc=ctl.construct_pc(False, lam_v, mask, Dv_A, M),
                mass=mass_solver(M, mask, False, lam_v),
                K_p=BlockSolver(K_p, None, ("mg", 1)),
                M_p=mass_solver(M_p, None, False, lam_p))

        hi, lo = parts["float64"], parts["float32"]

        # float32 operator and Krylov loop, float64 preconditioner
        def pc_in_double(x0, x1):
            y0, y1 = hi["pc"](x0.double(), x1.double())
            return y0.float(), y1.float()

        solve = lo["system"].solve_fn(solver_parameters=parameters,
                                      pc_fn=pc_in_double)
        _, _, d = solve(torch.zeros_like(lo["b0"]),
                        torch.zeros_like(lo["b1"]), lo["b0"], lo["b1"])
        out["float32_with_float64_pc_relative_residual"] = float(
            d["rnorm"] / d["rnorm0"])

        rng = np.random.default_rng(chip_smoke.SEED)
        nb = n_t - 1
        xv = rng.standard_normal((nb,) + tuple(lo["b0"].shape[1:]))
        xv[:, hi["mask"].cpu().numpy()] = 0.0
        xp = rng.standard_normal((2 * nb,) + tuple(lo["b1"].shape[1:]))
        xp -= xp.mean(axis=(1, 2), keepdims=True)

        def err(fn, *arrays):
            ref = fn(hi, *[torch.as_tensor(a, dtype=torch.float64,
                                           device=dev) for a in arrays])
            got = fn(lo, *[torch.as_tensor(a, dtype=torch.float32,
                                           device=dev) for a in arrays])
            ref = ref if isinstance(ref, tuple) else (ref,)
            got = got if isinstance(got, tuple) else (got,)
            return [float((g.double() - r).abs().max() / r.abs().max())
                    for g, r in zip(got, ref)]

        x0 = np.concatenate([xv, xv[::-1]])
        out["stage_errors"] = {
            "velocity_mass_solve": err(lambda q, x: q["mass"](x), xv),
            "velocity_vcycle": err(lambda q, x: q["fwd"].config.apply(
                q["fwd"].params, x), xv[0]),
            "forward_sweep": err(lambda q, x: q["fwd"].solve(x), xv),
            "inner_pc_u0_u1": err(lambda q, x, y: q["inner_pc"](x, y), xv,
                                  xv[::-1].copy()),
            "K_p_solve": err(lambda q, x: q["K_p"](x), xp),
            "M_p_solve": err(lambda q, x: q["M_p"](x), xp),
            "system_mult_y0_y1": err(lambda q, x, y: q["system"].mult(x, y),
                                     x0, xp),
            "nested_pc_u0_u1": err(lambda q, x, y: q["pc"](x, y), x0, xp)}
    return out


# name: (grid, ParaDiag time rows n (n // 2 + 1 frequencies), degree,
# steps) of the pair smoother's rows
PAIR_SHAPES = {"q3": ((73,) * 3, 15, 3, 8), "q2": ((65,) * 3, 15, 2, 8),
               "q1": ((65,) * 3, 15, 1, 8), "k3": ((257, 257), 63, 1, 3)}


def pair(repeats=10):
    from control_tpu_torch.ops import stencil as st
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def ms(fn):
        for _ in range(2):
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

    out = {}
    for name, (grid, n_rows, degree, steps) in PAIR_SHAPES.items():
        nd, K = len(grid), (2 * degree + 1) ** len(grid)
        nf = n_rows // 2 + 1
        wF = rand((K,) + grid).mul_(-0.4).sub_(0.1)
        wF[K // 2] = 4.0 + (K - 9) / 2.0 + rand(grid)
        wS = rand((K,) + grid).sub_(0.5).mul_(0.6)
        mu = torch.as_tensor(1e-3 ** (1 / n_rows) * np.exp(
            -2j * np.pi * np.arange(nf) / n_rows), dtype=torch.complex64,
            device=dev)
        per = (-1,) + (1,) * nd
        dinv = 1.0 / (wF[K // 2][None] + mu.reshape(per) * wS[K // 2][None])
        lam = 1.05 * float(((wF.abs().sum(0) + wS.abs().sum(0))
                            / (wF[K // 2] - wS[K // 2].abs())).max())
        th = torch.full((nf,), 0.625 * lam, device=dev)
        de = torch.full((nf,), 0.375 * lam, device=dev)
        b = torch.complex(rand((nf,) + grid) - 0.5, rand((nf,) + grid) - 0.5)
        x0 = torch.zeros_like(b)

        def kern():
            return st.fused_cheb_smooth_pair(wF, wS, mu, dinv, b, x0, steps,
                                             th, de, degree,
                                             want_residual=True, nd=nd)

        ref = st._cheb_pair_plain(wF, wS, mu, dinv, b, x0, steps, th, de,
                                  degree, want_residual=True, nd=nd)
        err = max(float((g - r).abs().max() / r.abs().max())
                  for g, r in zip(kern(), ref))
        del ref
        W = wF[None] + mu.reshape((-1,) + (1,) * (nd + 1)) * wS[None]

        def per_frequency():
            return st.fused_cheb_smooth(W, dinv, b, x0, steps, th, de,
                                        degree, want_residual=True, nd=nd)

        first = ms(kern)
        out[name] = {"shape": [nf, *grid], "degree": degree, "steps": steps,
                     "pair_ms": [first], "per_frequency_ms": ms(per_frequency),
                     "max_rel_err": err}
        out[name]["pair_ms"].append(ms(kern))
        del W
        torch.cuda.empty_cache()
    return {"pair": out}


# K2 and K5 real at the shapes of their paths: name -> (grid, batch,
# degree, steps, final residual, field dtype, weight storage)
REAL_SHAPES = {
    "K2 mass solve (flagship)": ((257, 257), 63, 1, 10, True, "float32",
                                 None),
    "K2 mass solve, bf16 planes": ((257, 257), 63, 1, 10, True, "float32",
                                   "bfloat16"),
    "K2 batch one (flagship BE)": ((257, 257), 1, 1, 10, True, "float32",
                                   None),
    "K2 q3 batch one (poisson_q3)": ((769, 769), 1, 3, 20, True, "float64",
                                     None),
    "K5 mass solve (heat3d)": ((65,) * 3, 15, 1, 10, True, "float32", None),
    "K5 mass solve, bf16 planes": ((65,) * 3, 15, 1, 10, True, "float32",
                                   "bfloat16"),
    "K5 batch one (heat3d BE)": ((65,) * 3, 1, 1, 10, True, "float32",
                                 None),
    "K5 q2 mass solve (heat3d_q2)": ((65,) * 3, 15, 2, 20, False, "float32",
                                     None),
    "K5 q3 mass solve (heat3d_q3)": ((73,) * 3, 15, 3, 10, True, "float32",
                                     None),
    "K5 q3 batch one (stationary_hex_q3)": ((97,) * 3, 1, 3, 20, True,
                                            "float64", None),
    "K5 q3 batch one, f32": ((73,) * 3, 1, 3, 10, True, "float32", None),
    "K2 batch one, bf16 planes (multigrid 2-D)": ((257, 257), 1, 1, 8, True,
                                                  "float32", "bfloat16"),
    "K5 batch one, bf16 planes (multigrid 3-D)": ((65,) * 3, 1, 1, 8, True,
                                                  "float32", "bfloat16")}


def real(names=None, repeats=6):
    """K2 and K5 real (``fused_cheb_smooth`` on real fields) at
    ``REAL_SHAPES``: the time of a call (CUDA events, mean of
    ``repeats``), its error against the plain version, the bound (each
    input read once, each output written once, or the flops) and the
    floor of its design: (steps + 1) passes over the weight set from HBM.
    Times the kernels of whichever checkout it is run from."""
    from control_tpu_torch.ops import stencil as st
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    out = {}
    for name, (grid, n, degree, steps, resid, dtype, wd) in \
            REAL_SHAPES.items():
        if names and name not in names:
            continue
        dt = getattr(torch, dtype)
        nd, K = len(grid), (2 * degree + 1) ** len(grid)
        w = torch.rand((K,) + grid, generator=gen, device=dev, dtype=dt)
        w.mul_(-0.4).sub_(0.1)
        w[K // 2] = 4.0 + (K - 9) / 2.0 + torch.rand(
            grid, generator=gen, device=dev, dtype=dt)
        dinv = 1.0 / w[K // 2]
        lam = 1.05 * float((w.abs().sum(0) / w[K // 2]).max())
        th, de = 0.625 * lam, 0.375 * lam
        if wd:
            w, dinv = st.narrow_planes(w, wd), st.narrow_planes(dinv, wd)
        b = torch.rand((n,) + grid, generator=gen, device=dev,
                       dtype=dt) - 0.5
        x0 = torch.zeros_like(b)

        def kern():
            return st.fused_cheb_smooth(w, dinv, b, x0, steps, th, de,
                                        degree, want_residual=resid,
                                        weight_dtype=wd, nd=nd)

        got = kern()
        ref = st._cheb_plain(w, dinv, b, x0, steps, th, de, degree,
                             want_residual=resid, weight_dtype=wd, nd=nd)
        got, ref = ((got, ref) if resid else ((got,), (ref,)))
        err = max(float((g - r).abs().max() / r.abs().max())
                  for g, r in zip(got, ref))
        del got, ref
        t = chip_smoke.cuda_ms(kern, repeats)
        passes = steps + int(resid)
        wbytes = chip_smoke.nbytes(w)
        nbytes = chip_smoke.nbytes(w, dinv, b, x0, *((b,) * (1 + resid)))
        bound_ms, bound_by = chip_smoke.bound(
            nbytes, chip_smoke.cheb_flops(K, b, steps, resid), dtype)
        floor_ms = passes * wbytes / chip_smoke.HBM_BYTES_S * 1e3
        out[name] = {"shape": [n, *grid], "degree": degree, "steps": steps,
                     "residual": resid, "dtype": dtype, "weights": wd,
                     "design": st.cheb_design(dt, n, True, nd, degree,
                                              w.dtype)
                     if hasattr(st, "cheb_design") else "per_entry",
                     "ms": t, "max_rel_err": err, "bound_ms": bound_ms,
                     "bound_by": bound_by, "weight_floor_ms": floor_ms,
                     "share_of_weight_floor": floor_ms / t}
        print(name, json.dumps(out[name]), file=sys.stderr, flush=True)
        del w, dinv, b, x0
        torch.cuda.empty_cache()
    return {"real": out}


RING_SHAPES = (((257, 257), 1, 8), ((65,) * 3, 1, 8), ((769, 769), 3, 20),
               ((97,) * 3, 3, 20), ((73,) * 3, 3, 10))
RING_STORAGE = (("float64", None), ("float64", "float32"),
                ("float32", None), ("float32", "bfloat16"))


def _cheb_device(fn, calls):
    """Device milliseconds and kernel count a call of ``fn``: the
    ``cheb`` kernels in a torch.profiler trace of ``calls`` calls."""
    from torch.profiler import profile as tprofile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "cheb" in e.name]
    return (sum(e.time_range.elapsed_us() for e in ks) / 1e3 / calls,
            len(ks) / calls)


def ring():
    """The ``ring`` subcommand (module docstring)."""
    from control_tpu_torch.ops import stencil as st
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    out = []
    for grid, degree, steps in RING_SHAPES:
        nd = len(grid)
        for dtype, wd in RING_STORAGE:
            if grid == (73,) * 3 and dtype == "float64":
                continue
            dt = getattr(torch, dtype)
            w, dinv, theta, delta = chip_smoke.make_stencil_on_card(
                gen, 1, grid, False, degree, dev, dt)
            w, dinv = w[0], dinv[0]
            th, de = float(theta[0]), float(delta[0])
            if wd:
                w, dinv = st.narrow_planes(w, wd), st.narrow_planes(dinv, wd)
            b = torch.randn((1,) + grid, generator=gen, dtype=dt, device=dev)
            x0 = torch.zeros_like(b)

            def wrapper():
                return st.fused_cheb_smooth(w, dinv, b, x0, steps, th, de,
                                            degree, want_residual=True,
                                            weight_dtype=wd, nd=nd)

            def per_entry():
                return chip_smoke.per_entry_one(w, dinv, b, x0, steps, th,
                                                de, degree, nd, True)

            got, ref = wrapper()[0], per_entry()[0]
            calls = 3 if grid[0] >= 73 else 20
            d = [_cheb_device(f, calls)
                 for f in (wrapper, per_entry, per_entry, wrapper)]
            e = [chip_smoke.cuda_ms(f, calls)
                 for f in (wrapper, per_entry, per_entry, wrapper)]
            row = {"grid": list(grid), "degree": degree, "steps": steps,
                   "dtype": dtype, "weights": wd or dtype,
                   "design": st.cheb_design(dt, 1, True, nd, degree,
                                            w.dtype)[0],
                   "device_ms": [d[0][0], d[3][0]],
                   "per_entry_device_ms": [d[1][0], d[2][0]],
                   "kernels_a_call": [d[0][1], d[1][1]],
                   "event_ms": [e[0], e[3]],
                   "per_entry_event_ms": [e[1], e[2]],
                   "weight_floor_ms": (steps + 1) * chip_smoke.nbytes(w)
                   / chip_smoke.HBM_BYTES_S * 1e3,
                   "max_rel_diff": float((got - ref).abs().max()
                                         / ref.abs().max())}
            print(json.dumps(row), file=sys.stderr, flush=True)
            out.append(row)
            del w, dinv, b, x0, got, ref
            torch.cuda.empty_cache()
    return {"ring": out}


def main(argv):
    on_cpu = argv[:1] == ["history"] and argv[-1:] == ["cpu"]
    if on_cpu:
        argv = argv[:-1]
    elif not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 1
    card = "cpu" if on_cpu else chip_smoke.card_line()
    paradiag = list(SLICES) + list(NARROW)
    if argv[:1] == ["kernels2d"]:
        out = kernels2d()
    elif argv == ["vector"]:
        out = vector()
    elif argv == ["pair"]:
        out = pair()
    elif argv[:1] == ["real"]:
        out = real(argv[1:])
    elif argv == ["ring"]:
        out = ring()
    elif argv[:1] == ["profile"] and len(argv) == 2 and (
            argv[1] in SLICES or argv[1] in NARROW
            or argv[1] in STOKES_SLICES or argv[1] in STATIONARY_SLICES):
        out = profile(argv[1])
    elif (argv[:1] == ["history"] and len(argv) in (3, 5, 6)
          and argv[1] in ["stokes"] + paradiag
          and argv[2] in ("float32", "float64")):
        name = argv[1]
        base = NARROW.get(name, (name, None))[0]
        default = ([64, 32, 100] if name == "stokes"
                   else [*SLICES[base][0], SLICES[base][4][
                       "maximum_iterations"]])
        n, n_t, budget = [int(a) for a in argv[3:]] + default[len(argv) - 3:]
        out = history(name, argv[2], n, n_t, budget,
                      "cpu" if on_cpu else "cuda")
    elif (argv[:1] == ["determinism"] and len(argv) in (2, 4)
          and argv[1] in STOKES_SLICES):
        n, n_t = [int(a) for a in argv[2:]] or STOKES_SLICES[argv[1]][0]
        out = determinism(argv[1], n, n_t)
    elif (argv[:2] == ["precision", "stokes"] and len(argv) in (2, 4, 5)):
        n, n_t, budget = [int(a) for a in argv[2:]] + [64, 8, 20][
            len(argv) - 2:]
        out = precision(n, n_t, budget)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    out["card"] = card
    out["checkout"] = os.getcwd()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

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
        the solve's wall time) and device time by kernel, one JSON line;
        ``profile flagship`` does the same for the 2-D flagship;
    python3 control_tpu_torch/tools/profile_slice.py profile stokes
        the Stokes slice (64^2 x 32, f64, scan): the repeat solve timed
        unprofiled, then a trace of a window of it, the first two outer
        FGMRES iterations (a whole solve is millions of launches), with the
        device time of K4 and of the multigrid transfers (every kernel
        launched inside ``Transfer.prolong`` / ``restrict``) beside the
        busy share;
    python3 control_tpu_torch/tools/profile_slice.py profile stokes3d
        the same for the 3-D Stokes slice (Taylor-Hood Q2-Q1 on 16^3
        hexahedra x 8, f64, scan), with K5v's device time.

    python3 <this checkout>/control_tpu_torch/tools/profile_slice.py vector
        K4 and K5v at the shapes of their paths (the velocity mass solves,
        a ragged batch of nine, the smoothed V-cycle levels) through the
        public wrapper: the time of a call (CUDA events; the host's share
        of a small level's call shows here), its device time (the
        kernels' time in a torch.profiler trace) and, at the unbatched
        V-cycle levels, the host's time a call (a CPU clock over
        thousands of calls); the script of one checkout times the kernels
        of whichever checkout it is run from: one JSON line.

    python3 control_tpu_torch/tools/profile_slice.py history stokes \
            float32|float64 [n n_t [iterations]]
        the Stokes solve's relative residual history within a budget of
        outer iterations (default 64 32 100), without raising when it does
        not converge, with its seconds: one JSON line.

    python3 control_tpu_torch/tools/profile_slice.py precision stokes \
            [n n_t [iterations]]
        where float32 loses the Stokes solve (default 64 8 20): the
        relative residual after the budget in float64, in float32, and with
        the operator and the Krylov loop in float32 but the whole
        preconditioner applied in float64; and the float32-against-float64
        error of each stage of the preconditioner on one seeded input.

Needs one CUDA card; imports nothing of JAX.
"""

import bisect
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402  (the checkout's own problem definitions)

SOLVER_PARAMETERS = chip_smoke.SOLVER_PARAMETERS
SLICES = {"flagship": ((256, 64), (0.25, 2.25), "heat_problem"),
          "heat3d": ((64, 16), (0.125, 3.375), "heat3d_problem")}
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
    (n, n_t), bounds, maker = SLICES[name]
    ctl = getattr(chip_smoke, maker)(n, n_t, torch.float32, dev, "paradiag")

    def solve():
        return ctl.linear_solve(lambda_v_bounds=bounds,
                                solver_parameters=SOLVER_PARAMETERS,
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
    ctl, solve, window = problem(name)
    first_s, _ = timed(solve)
    plain_s, info = timed(solve)
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

    device_ms = ms(kernels)
    return {"slice": name, "iterations": info.iterations,
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


def history(dtype, n, n_t, budget):
    """The Stokes solve's residual history in ``dtype`` within ``budget``
    outer iterations; a solve that does not converge is reported, not
    raised."""
    from control_tpu_torch import ConstantNullspace
    ctl = chip_smoke.stokes_problem(n, n_t, getattr(torch, dtype),
                                    torch.device("cuda", 0))
    parameters = dict(chip_smoke.STOKES_PARAMETERS, preconditioner=True,
                      maximum_iterations=budget)
    seconds, info = timed(lambda: ctl.incompressible_linear_solve(
        ConstantNullspace(), solver_parameters=parameters,
        print_error=False, **chip_smoke.LAMBDA_STOKES))
    its = info.iterations
    return {"slice": "stokes", "dtype": dtype, "n": n, "n_t": n_t,
            "budget": budget, "iterations": its,
            "converged": info.converged,
            "relative_residual": info.rnorm / info.rnorm0,
            "first_solve_s": seconds,
            "relative_history": [float(r / info.res_norms[0])
                                 for r in info.res_norms[:its + 1]]}


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


def main(argv):
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    if argv[:1] == ["kernels2d"]:
        out = kernels2d()
    elif argv == ["vector"]:
        out = vector()
    elif argv[:1] == ["profile"] and len(argv) == 2 and (
            argv[1] in SLICES or argv[1] in STOKES_SLICES):
        out = profile(argv[1])
    elif (argv[:2] == ["history", "stokes"] and len(argv) in (3, 5, 6)
          and argv[2] in ("float32", "float64")):
        n, n_t, budget = [int(a) for a in argv[3:]] + [64, 32, 100][
            len(argv) - 3:]
        out = history(argv[2], n, n_t, budget)
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

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
        ``profile flagship`` does the same for the 2-D flagship.

Needs one CUDA card; imports nothing of JAX.
"""

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


def problem(name):
    (n, n_t), bounds, builder = SLICES[name]
    ctl = getattr(chip_smoke, builder)(n, n_t, torch.float32,
                                       torch.device("cuda", 0), "paradiag")

    def solve():
        return ctl.linear_solve(lambda_v_bounds=bounds,
                                solver_parameters=SOLVER_PARAMETERS,
                                print_error=False)
    return ctl, solve


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
    _, solve = problem("flagship")
    solve()
    out["flagship_solve_s"] = min(timed(solve)[0] for _ in range(3))
    return out


def device_busy(prof, wall_us):
    """Union of the device kernels' intervals, and device time by name."""
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
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


def profile(name):
    from torch.profiler import profile as tprofile, ProfilerActivity
    ctl, solve = problem(name)
    solve()
    plain_s, _ = timed(solve)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        prof_s, info = timed(solve)
    share, n_kernels, top = device_busy(prof, prof_s * 1e6)
    return {"slice": name, "iterations": info.iterations,
            "solve_s": plain_s, "profiled_solve_s": prof_s,
            "device_busy_share_of_profiled": share,
            "device_kernels": n_kernels, "device_ms_by_kernel": top}


def main(argv):
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    if argv[:1] == ["kernels2d"]:
        out = kernels2d()
    elif argv[:1] == ["profile"] and len(argv) == 2 and argv[1] in SLICES:
        out = profile(argv[1])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    out["card"] = card
    out["checkout"] = os.getcwd()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

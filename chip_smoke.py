#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (the CUDA toolkit) and the repository's
``control_tpu_torch`` package; imports nothing of JAX.  Phases, each of
which raises (and the script exits non-zero) on failure:

1. the card: refuses to run without CUDA; prints the card's name and power
   limit (``nvidia-smi``), the torch and nvcc versions;
2. builds the hand-written kernels (``control_tpu_torch/csrc``) with nvcc
   and fails if ptxas reports a kernel that spills registers;
3. holds each kernel against its plain PyTorch version on the card, on
   inputs made from a numpy seed at the shapes of the path that runs it,
   in float64 (max relative error <= 1e-12) and float32 (<= 1e-5 for the
   applications K1/K6, <= 1e-4 for the smoothers K2/K3/K4/K5: the summation
   order differs), and times both with CUDA events: K1-K3 at the 2-D
   flagship's shapes, K6 and K5 (real, complex) at heat3d's, K4 at the
   Stokes path's (the velocity mass solve, a ragged batch of nine fields
   and the two smoothed V-cycle levels), K5v (3-D vector fields, dim = 3)
   at the stokes3d path's (the same four kinds of call), K5 (real,
   complex) and K6 at degree 2 at heat3d_q2's; the K4 and K5v rows print
   the floor of their design (one weight pass per step for the whole
   batch) beside the bound; the narrow-weight variants of K2, K3 and K5
   (real; complex at degree 1 and 2) at their paths' finest shapes, with
   the planes stored in bfloat16 under float32 fields and in float32
   under float64 ones (``weight_dtype``), the full-precision kernel's time
   beside each, and the narrow K2 and K5 real on the one field of the
   bfloat16 multigrid path's finest level (257^2, 65^3, 8 steps + r);
   every K2 and K5 real row (real fields: the plane tile on a
   shared-weight batch, the weight ring on one field,
   ``csrc/cheb_tile.cuh``; the per-entry kernel with bf16 planes and on
   one field of a 2-D degree-1 stencil) also prints the kernel
   ``cheb_design`` picks and, for a batch, the floor of its design and
   the per-entry kernel's time on the weights copied per field, for one
   field the (steps + 1)-pass floor of its weight stream, the share of it
   reached and, beside the ring, the per-entry kernel's time on the same
   field; every K1 and K6 row likewise prints the kernel ``apply_design``
   picks (the plane tile, ``csrc/stencil_apply_tile.cu``, on a
   shared-weight batch; the per-entry kernel on one field) and, for a
   batch, the floor of its design and the times of the tile and the
   per-entry kernel on the same fields, both called at their C entry
   points, in turns; K1
   and K6 also run on the one field of the backward-Euler edge rows
   (1 x 257^2, 1 x 65^3); then
   the ParaDiag smoother on stencil pairs
   (``fused_cheb_smooth_pair``: A_k = W_F + mu_k W_S, one real pair for
   all frequencies) against its plain twin at the flagship's (32 x 257^2,
   3 steps + r), heat3d's and heat3d_q2's (8 x 65^3, degree 1 and 2) and
   heat3d_q3's (8 x 73^3, degree 3) shapes, 8 steps + r, in complex64,
   and in complex128 on 257^2 and the next coarser 3-D levels, with the
   per-frequency kernel's time on the same operator's formed planes
   beside each; then K2 and K5 real on ragged shared-weight batches (7,
   9, 17 fields) at small odd grids, degree 1 and 3;
4. the 2-D slice: a small float64 solve on the card against the same solve
   on the CPU (plain versions), then the flagship heat-control KKT solve
   (Q1 256^2 x 64, Crank-Nicolson, ParaDiag Schur sweeps, GMRES(10), rtol
   1e-6, float32) through ``Control.Instationary(...).linear_solve``: solved
   once, then timed; it must converge below 1e-6 relative residual in at
   most 12 iterations with K1 (on the plane tile: every ParaDiag
   application is a shared-weight batch; so in every ParaDiag solve
   below), K2 and the pair smoother launched during
   the timed solve and no per-frequency K3 (its frequency hierarchies
   are stencil pairs); then the same solve from its pc state with
   per-frequency planes (the layout of a state carried from the JAX
   package, and the path's smoothing before the pair): the pair's count
   within one, K3 launched and no pair smoother, timed in the same call;
   every full-precision ParaDiag solve below does the same, with its
   peak device memory and pc state bytes beside each; then the
   default ``scan`` sweeps at the same size, once; then the same ParaDiag
   solve with the frequency V-cycles' weight planes in bfloat16
   (``set_schur_sweep(..., weight_dtype="bfloat16")``; after small
   float64 solves with float32 and bfloat16 weights on the card against
   the CPU): it must converge within the solver's budget with the narrow
   K3 launched during the timed solve, and prints the
   full-precision solve's numbers beside its own; then geometric
   multigrid with bfloat16 planes (``Multigrid(op, weight_dtype=...)``)
   as the preconditioner of GMRES on a Dirichlet stiffness-plus-mass
   operator at 256^2 and 64^3, the path of the narrow K2 and K5 real;
5. the 3-D slice, ``heat3d`` (``bench_extra.py``: hex Q1 64^3 x 16, CN,
   ParaDiag with its default settings, GMRES(10), rtol 1e-6, float32):
   small float64 solves (ParaDiag and scan, 8^3 x 8) on the card against
   the CPU, then the full-size solve, once and then timed; it must converge
   below 1e-6 in at most 10 iterations with K5 real, the pair smoother
   and K6 launched during the timed solve (then from the per-frequency
   state, K5 complex); then the ``scan`` sweeps once; then
   the same with bfloat16 weight planes (after a small float64 solve on
   the card against the CPU), which stalls at this width (``ROADMAP.md``
   Queue 3): a measurement, not a check of convergence, with the narrow
   K5 complex launched, held instead to the same solve run by the
   full-precision kernels on its planes rounded beforehand (the first
   three iterations' relative residuals within 1e-4 of each other's);
6. the Stokes slice (``bench_extra.py``'s ``stokes``: Taylor-Hood Q2-Q1 on
   64^2 cells x 32 time steps, CN, beta = 1e-2, the nested preconditioner
   with the default ``scan`` sweeps, FGMRES(10), rtol 1e-6, at most 100
   iterations) through
   ``Control.Instationary(...).incompressible_linear_solve``: a small
   float64 solve (8^2 x 4) on the card against the CPU, then the full-width
   solve in float64: two builds of its preconditioner give bit-equal
   coarse dense inverses (so the pc, and the count, repeat themselves in
   one process), then one timed solve (it is host-bound) must converge
   below 1e-6 with K4 and K2 launched during it.  In float32 this
   recipe stalls at this width, in the JAX package as in the port (each
   stage of
   the preconditioner is accurate to float32, the five fixed inner GMRES
   iterations amplify the difference), so float32 is a measurement here,
   not a target: its first 20 outer iterations run at full width and their
   residual history is printed beside float64's;
7. the 3-D Stokes slice, ``stokes3d`` (``tests/test_instationary_stokes3d.py``
   at production width: Taylor-Hood Q2-Q1 on hexahedra, 16^3 cells x 8
   time steps, CN, beta = 1e-2, FGMRES(10), rtol 1e-6, at most 100
   iterations, float64): a small float64 solve (2^3 x 3) on the card
   against the CPU, then two pc builds with bit-equal coarse inverses
   and the timed full-width solve, as for the Stokes slice; it must
   converge below 1e-6 with K5v and K5 (real) launched during it;
8. the Q2 heat slice, ``heat3d_q2`` (heat3d on Q2 hexahedra, 32^3 cells:
   65^3 nodes, x 16, float32, ParaDiag defaults): small float64 solves
   (ParaDiag and scan, 4^3 x 4) on the card against the CPU, then the
   full-size solve, once and then timed; it must converge below 1e-6 within
   the solver's budget with K5 real, the pair smoother and K6 at degree 2
   launched during the timed solve (then from the per-frequency state, K5
   complex at degree 2); then the ``scan`` sweeps once; then the
   ParaDiag solve with bfloat16 weight planes, a measurement like
   heat3d's;
9. backward Euler (``CN=False``, epsilon = 1e-3: the Sigma-rescaled pc,
   the edge-row ParaDiag sweeps, the Krylov iteration on the eps-scaled
   unknowns): small float64 solves (flagship 32^2 x 8 ParaDiag and scan,
   heat3d 8^3 x 8 ParaDiag) on the card against the CPU (equal
   iterations, histories within 1e-10 of the initial residual); the
   flagship ParaDiag in float32
   with ``bench.py``'s BE recipe (``BENCH_CN=0``: GMRES(30), budget 100),
   once and then timed, which must converge below 1e-6 with K1, K2 and
   the pair smoother launched (then from the per-frequency state, K3),
   and the same solve at GMRES(10), ungated, its count printed;
   the flagship in float64 with the scan sweeps and the default 20 mass
   steps (``tools/tpu_results/be_parity.json``'s reference recipe), which
   must converge, and the record's own Krylov iteration (on the
   untransformed unknowns: 16 iterations on a CPU) on the same pc, which
   must converge in 15-17 iterations; heat3d
   (64^3 x 16, float32, ParaDiag defaults, GMRES(30), budget 100), once
   and then timed, which must converge below 1e-6 with K5 real, the
   pair smoother and K6 launched; the kernel rows K2 and K5 real at batch one
   (the edge rows' V-cycles) and K3 at the interior's 32 frequencies;
10. stationary control (``Control.Stationary(...).linear_solve``): K1,
   K2 and K3 at degree 3 (K = 49) and 4 (K = 81) against their plain
   versions (K1 and the 20-step K2 on one 769^2 field, the Q3 256^2
   finest level, and on 513^2 at degree 4; K3 32 frequencies on 385^2
   and 257^2, 3 steps; the narrow K3 at degree 3), float64 and float32;
   small float64 solves (``poisson`` 32^2, the Q3 problem 8^2, P2
   triangles 16^2) on the card against the CPU; ``bench_extra.py``'s
   ``poisson`` (Q1 256^2, float32, GMRES(10), rtol 1e-6), once and then
   timed, which must converge within the JAX package's 4 iterations + 3
   with K1 and K2 launched; the same in float64; both at 2048^2, float64
   within its 256^2 count + 2 (multigrid counts stay mesh-independent)
   and float32 within the budget (its count grows with the mesh, in the
   JAX package too); ``tests/test_degree3.py``'s manufactured Q3 problem at 256^2 (769^2
   nodes, float64, FGMRES(10), rtol 1e-10), which must converge within
   500 iterations with K1 and K2 at degree 3 launched, and prints the L2
   errors of v and zeta against the exact pair;
11. hex Q3 (K = 343): K6, K5 real and K5 complex at degree 3 against
   their plain versions (K6 on one 97^3 float64 field and on 15 x 73^3
   float32 fields with shared weights; K5 real 20 steps + r on 97^3
   float64, 10 steps + r on 73^3 float32 and on heat3d_q3's 15 x 73^3
   shared-weight mass-solve batch; K5 complex 8 frequencies
   with their own weights, 8 steps + r, on 73^3 complex64 and 37^3
   complex128; the narrow K5 complex with bfloat16 planes on 8 x 73^3;
   the batch of K6 on the plane tile, beside the per-entry kernel);
   small float64 solves (the exact pair of ``tests/test_solvers3d.py:69``
   at hex Q3 4^3, heat3d Q3 ParaDiag 4^3 x 4) on the card against the
   CPU; ``stationary_hex_q3``, that exact pair on 32^3 hex Q3 cells (97^3
   nodes, float64, FGMRES(10), rtol 1e-10), which must converge within 100
   iterations with K6 and K5 real at degree 3 launched and meet the
   exact pair in L2; ``heat3d_q3``, heat3d on 24^3 Q3 cells (73^3 nodes)
   x 16, float32, ParaDiag, which must converge below 1e-6 within 20
   iterations with K6, K5 real and the pair smoother at degree 3 launched
   (then from the per-frequency state, K5 complex at degree 3); both
   take the Jacobi-scaled hex Q3 mass bounds computed on 2^3 cells;
12. prints ``{"kernels": [...]}``, a JSON line of each slice's numbers,
   and last ``{"ok": true, "device": {...}}``.

A full record goes to ``smoke_out/chip_smoke.json`` (git-ignored), the
ptxas register and spill report to ``smoke_out/ptxas.txt``.
"""

import json
import os
import re
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
       ("K5cq2", "float64"): 1e-12, ("K5cq2", "float32"): 1e-4,
       ("K2n", "float64"): 1e-12, ("K2n", "float32"): 1e-4,
       ("K3n", "float64"): 1e-12, ("K3n", "float32"): 1e-4,
       ("K5rn", "float64"): 1e-12, ("K5rn", "float32"): 1e-4,
       ("K5cn", "float64"): 1e-12, ("K5cn", "float32"): 1e-4,
       ("K5cnq2", "float64"): 1e-12, ("K5cnq2", "float32"): 1e-4,
       ("K2be", "float64"): 1e-12, ("K2be", "float32"): 1e-4,
       ("K5rbe", "float64"): 1e-12, ("K5rbe", "float32"): 1e-4,
       ("K3be", "float64"): 1e-12, ("K3be", "float32"): 1e-4,
       ("K1be", "float64"): 1e-12, ("K1be", "float32"): 1e-5,
       ("K6be", "float64"): 1e-12, ("K6be", "float32"): 1e-5}
# degree 3 and 4 (2-D) and the narrow K3 at degree 3: the same tolerances
TOL.update({(f"{k}{q}", dt): tol for k, tol32 in (("K1", 1e-5),
                                                   ("K2", 1e-4),
                                                   ("K3", 1e-4))
            for q in ("q3", "q4")
            for dt, tol in (("float64", 1e-12), ("float32", tol32))})
TOL.update({("K3nq3", "float64"): 1e-12, ("K3nq3", "float32"): 1e-4})
# the shared-weight batch of K5 real at degree 3 and the ragged batches of
# K2 and K5 real
TOL.update({(k, dt): tol for k in ("K5rq3s", "K2rag", "K5rag", "K2n1",
                                   "K5rn1")
            for dt, tol in (("float64", 1e-12), ("float32", 1e-4))})
# the narrow weight storage of each field dtype in the kernel rows: the
# JAX benchmarks' bfloat16 under float32 fields, float32 under float64
NARROW_WEIGHTS = {"float32": "bfloat16", "float64": "float32"}
# the ParaDiag solves with their weight planes in bfloat16
WEIGHT_DTYPE = "bfloat16"
FLAGSHIP = dict(n=256, n_t=64)
HEAT3D = dict(n=64, n_t=16, scan_n=64)
STOKES = dict(n=64, n_t=32, small_n=8, small_n_t=4, float32_budget=20)
STOKES3D = dict(n=16, n_t=8, small_n=2, small_n_t=3)
HEAT3D_Q2 = dict(n=32, n_t=16, small_n=4, small_n_t=4)
# backward Euler (CN=False): the flagship and heat3d at full width, with
# the default final-block regularisation epsilon = 1e-3; the f64 scan's
# record recipe must take 15-17 iterations (tools/tpu_results/
# be_parity.json, on a CPU: 16 at 256^2 x 64, 17 at 32^2 x 16 and 64^2 x
# 32)
BE = dict(n=256, n_t=64, small_n=32, small_n_t=8, scan_its=(15, 17))
HEAT3D_BE = dict(n=64, n_t=16, small_n=8, small_n_t=8)
# the plain versions of the large 3-D rows are timed over fewer calls
PLAIN_REPEATS_3D = 3
# the H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores; float64 runs at half the rate
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 33.5e12}
# the H100's 50 MB L2 (NVIDIA data sheet) and the read rate assumed for
# it in the design floor of K4 and K5v, about 6 TB/s: not a published
# figure, but what K4's earlier one-entry-a-thread design moved from L2 on
# the card (8.25 GB of weights in 1.34 ms)
L2_BYTES = 50e6
L2_BYTES_S = 6e12
SOLVER_PARAMETERS = {"linear_solver": "gmres", "gmres_restart": 10,
                     "maximum_iterations": 50, "relative_tolerance": 1.0e-6,
                     "absolute_tolerance": 0.0,
                     "monitor_convergence": False}
# bench.py's backward-Euler defaults (BENCH_CN=0): GMRES(30), budget 100
BE_PARAMETERS = dict(SOLVER_PARAMETERS, gmres_restart=30,
                     maximum_iterations=100)
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


def spilling_functions(ptxas):
    """The functions of a ``ptxas -v`` report with spill stores or loads:
    {mangled name: (store bytes, load bytes)}."""
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (int(m.group(1)) or int(m.group(2))):
            out[name] = (int(m.group(1)), int(m.group(2)))
    return out


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


def vector_batch_width(nd, dtype, n):
    """The batch width K4 (nd = 2) and K5v (nd = 3) run for n fields with
    shared weights, as ``pick`` in csrc/cheb_smooth_vector.cu chooses it."""
    if n <= 1:
        return 1
    if nd == 3:
        return 2 if n <= 2 else 4 if n <= 4 else 8
    # the fewest padded entries, the larger width on a tie
    return min((8, 4, 2) if dtype == "float64" else (4, 2),
               key=lambda nb: -(-n // nb) * nb)


def design_floor(w, n, passes, width):
    """The least time (ms) of K4's, K5v's and the tile's (K2 and K5 real on
    a batch with shared weights) design at these inputs: every
    weight read once per step for the whole batch (``passes`` = steps, +1
    for the residual).  Each chunk of ``width`` batch entries reads the
    weight set from L2 (at the assumed ``L2_BYTES_S``); a set larger than
    the L2 streams from HBM once a pass."""
    wb = nbytes(w)
    chunks = -(-max(n, 1) // width)
    t_l2 = passes * chunks * wb / L2_BYTES_S
    if wb <= L2_BYTES:
        return t_l2 * 1e3
    return max(passes * wb / HBM_BYTES_S, t_l2) * 1e3


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


def per_entry_one(w, dinv, b, x0, steps, th, de, degree, nd, residual):
    """One real field through the per-entry kernel of
    ``csrc/cheb_smooth.cuh`` (``cheb_smooth``, or ``cheb_smooth_narrow``
    for narrow planes: the kernel a single field ran before the weight
    ring), called at its C entry point with the wrapper's arguments; for
    timing beside the ring, so it counts no launch."""
    from control_tpu_torch.ops import kernels
    from control_tpu_torch.ops import stencil as st
    grid = tuple(b.shape[-nd:])
    thv, dev_, th_s = st._bound_vectors(th, de, 1, b.dtype, b.device)
    bc = b.reshape(grid).contiguous()
    xc = x0.reshape(grid).contiguous()
    x_out, x_tmp, p = (torch.empty_like(bc) for _ in range(3))
    r = torch.empty_like(bc) if residual else None
    lib = kernels.library()
    args = (w.contiguous().data_ptr(), 0, dinv.contiguous().data_ptr(), 0,
            bc.data_ptr(), xc.data_ptr(), thv.data_ptr(), dev_.data_ptr(),
            th_s, x_out.data_ptr(), x_tmp.data_ptr(), p.data_ptr(),
            None if r is None else r.data_ptr(), 1, *st._zyx(grid), nd,
            degree, int(steps), kernels.stream_ptr(b.device))
    code = kernels.DTYPE_CODES[b.dtype]
    if w.dtype != b.dtype:
        kernels.check(lib.cheb_smooth_narrow(
            code, kernels.WEIGHT_CODES[w.dtype], *args), "cheb_smooth_narrow")
    else:
        kernels.check(lib.cheb_smooth(code, *args), "cheb_smooth")
    return (x_out, r) if residual else x_out


def entry_apply(w, x, degree, nd, width=0):
    """The fields x through K1 / K6 called at a C entry point with the
    shared weights w: the per-entry kernel of ``csrc/stencil_apply.cu``
    (one thread per node and field: the kernel every K1 / K6 call ran
    before the plane tile), or with a chunk ``width`` the plane tile of
    ``csrc/stencil_apply_tile.cu``.  For timing the two side by side with
    the same host work a call, so it counts no launch."""
    from control_tpu_torch.ops import kernels
    from control_tpu_torch.ops import stencil as st
    grid = tuple(x.shape[-nd:])
    xc = x.contiguous()
    y = torch.empty_like(xc)
    lib = kernels.library()
    tail = (y.data_ptr(), xc.numel() // int(np.prod(grid)), *st._zyx(grid),
            nd, degree, kernels.stream_ptr(x.device))
    code = kernels.DTYPE_CODES[x.dtype]
    if width:
        kernels.check(lib.stencil_apply_tile(
            code, width, w.contiguous().data_ptr(), xc.data_ptr(), *tail),
            "stencil_apply_tile")
    else:
        kernels.check(lib.stencil_apply(
            code, w.contiguous().data_ptr(), 0, xc.data_ptr(), *tail),
            "stencil_apply")
    return y


def apply_extras(row, w, x, degree, nd):
    """What a K1 / K6 row prints beside its time: the kernel
    ``apply_design`` picks and, where that is the plane tile, the floor of
    its design (the bound, or the weight set read once a chunk from L2 at
    the assumed ``L2_BYTES_S`` where that takes longer: ``design_floor``)
    and the times of the per-entry kernel and of the tile on the same
    inputs, both called at their C entry points (``entry_apply``) in
    turns (per-entry, tile, tile, per-entry).  At small shapes the
    wrapper's host work a call exceeds the kernel's: its device time
    beside the per-entry kernel's is ``profile_slice.py apply``'s."""
    from control_tpu_torch.ops import stencil as st
    n = x.shape[0] if x.dim() == nd + 1 else 1
    design, width = st.apply_design(x.dtype, n, True, nd, degree)
    row.update(design=design, batch_width=width)
    if design == "per_entry":
        return row
    row["design_floor_ms"] = max(row["bound_ms"],
                                 design_floor(w, n, 1, width))
    ms, pe = in_turns(lambda: entry_apply(w, x, degree, nd, width),
                      lambda: entry_apply(w, x, degree, nd))
    row.update(tile_entry_ms=ms, per_entry_ms=pe)
    return row


def real_extras(row, w, dinv, b, x0, steps, th, de, degree, nd, residual,
                weight_dtype=None):
    """What a K2 / K5 real row prints beside its time: the kernel
    ``cheb_design`` picks; for a batch with shared weights, the floor of
    that design (``design_floor``: the weights read once a step for the
    batch) and the time of the per-entry kernel (``csrc/cheb_smooth.cuh``,
    the kernel these batches ran before the tile) on the same weights
    copied once per field, which it needs to run; for one field, the
    (steps + 1)-pass floor of the weight stream from HBM and the share of
    it the kernel reaches, and where that is the ring, the per-entry
    kernel's time on the same inputs (``per_entry_one``; its device
    time beside the ring's: ``profile_slice.py ring``).  Where ``cheb_design`` picks the per-entry
    kernel itself (2-byte planes, one field of a 2-D degree-1 stencil),
    the row's time is that kernel's."""
    from control_tpu_torch.ops import stencil as st
    n = b.shape[0] if b.dim() == nd + 1 else 1
    design, width = st.cheb_design(b.dtype, n, True, nd, degree, w.dtype)
    passes = steps + int(residual)
    row.update(design=design, batch_width=width)
    if n == 1:
        floor_ms = passes * nbytes(w) / HBM_BYTES_S * 1e3
        row.update(weight_floor_ms=floor_ms,
                   weight_floor_share=floor_ms / row["ms"])
    if design == "per_entry":
        # 2-byte planes and one field of a 2-D degree-1 stencil: the row's
        # own kernel is the per-entry one
        return row
    if design == "ring":
        row["per_entry_ms"] = cuda_ms(lambda: per_entry_one(
            w, dinv, b, x0, steps, th, de, degree, nd, residual))
        return row
    row["design_floor_ms"] = design_floor(w, n, passes, width)
    wk = w.reshape(tuple(w.shape[-(nd + 1):]))
    w_e = wk.expand((n,) + tuple(wk.shape)).contiguous()

    def per_entry():
        return st.fused_cheb_smooth(w_e, dinv, b, x0, steps, th, de, degree,
                                    want_residual=residual,
                                    weight_dtype=weight_dtype, nd=nd)

    row["per_entry_ms"] = cuda_ms(per_entry, 3 if nd == 3 else REPEATS)
    del w_e
    torch.cuda.empty_cache()
    return row


def report(results):
    for kname, rows in results.items():
        for r in rows:
            floor = (f", design floor {r['design_floor_ms']:.4f} ms "
                     f"(chunks of {r['batch_width']}, L2 at an assumed "
                     f"{L2_BYTES_S / 1e12:g} TB/s)"
                     if "design_floor_ms" in r else "")
            if "weight_dtype" in r:
                floor += (f", weights {r['weight_dtype']}; full-precision "
                         f"kernel {r['full_precision_ms']:.4f} ms, bound "
                         f"{r['full_precision_bound_ms']:.4f} ms")
            if "design" in r:
                floor += f"; {r['design']} kernel"
            if "per_entry_ms" in r and r.get("design") == "ring":
                floor += (f"; per-entry kernel on the same field "
                          f"{r['per_entry_ms']:.4f} ms")
            elif "tile_entry_ms" in r:
                floor += (f"; at their C entry points, in turns: the tile "
                          f"{r['tile_entry_ms']:.4f} ms, the per-entry "
                          f"kernel on the same fields "
                          f"{r['per_entry_ms']:.4f} ms")
            elif "per_entry_ms" in r:
                floor += (f"; per-entry kernel on the weights copied per "
                          f"field {r['per_entry_ms']:.4f} ms")
            if "weight_floor_ms" in r:
                floor += (f"; weight floor {r['weight_floor_ms']:.4f} ms "
                          f"({100 * r['weight_floor_share']:.1f}% of it)")
            if "per_frequency_ms" in r:
                floor = (f"; per-frequency kernel on the formed planes "
                         f"{r['per_frequency_ms']:.4f} ms, bound "
                         f"{r['per_frequency_bound_ms']:.4f} ms, rel err "
                         f"{r['per_frequency_max_rel_err']:.3e}")
            print(f"{kname} {r['dtype']} {r['shape']}: rel err "
                  f"{r['max_rel_err']:.3e} (tol {r['tol']:.0e}), kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}){floor}",
                  flush=True)
            if not (r["max_rel_err"] <= r["tol"]
                    and r.get("per_frequency_max_rel_err", 0.0) <= r["tol"]):
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
               "K5cq2": [], "K2n": [], "K3n": [], "K5rn": [], "K5cn": [],
               "K5cnq2": [], "K2be": [], "K5rbe": [], "K3be": [],
               "K2n1": [], "K5rn1": [], "K1be": [], "K6be": []}

    def field(shape, cplx=False):
        a = rng.standard_normal(shape)
        if cplx:
            a = a + 1j * rng.standard_normal(shape)
        return a

    made = {}

    def stencil(n_w, grid, complex_=False, degree=1):
        # one smoother stencil per shape, shared by both dtypes and by the
        # narrow rows: numpy takes many seconds for a complex K = 125 one
        # at 65^3
        key = (n_w, tuple(grid), complex_, degree)
        if key not in made:
            made[key] = make_stencil(rng, n_w, grid, complex_, degree)
        return made[key]

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
            results[kname].append(apply_extras(check_row(
                kname, name, xt.shape, st.apply_stencil(wt, xt, 1, nd=nd),
                st._apply_plain(wt, xt, 1, nd=nd),
                lambda: st.apply_stencil(wt, xt, 1, nd=nd),
                lambda: st._apply_plain(wt, xt, 1, nd=nd),
                (nbytes(wt, xt, xt), stencil_flops(3 ** nd, xt, 1))),
                wt, xt, 1, nd))

        def real_cheb_check(kname, grid, nb, steps):
            # shared w and dinv, scalar bounds (the (1,1) mass solve)
            nd = len(grid)
            w, dinv, theta, delta = stencil(1, grid)
            wt, dt_, bt = T(w), T(dinv[0]), T(field((nb,) + grid))
            x0 = torch.zeros_like(bt)
            th, de = float(theta[0]), float(delta[0])

            def kern():
                return st.fused_cheb_smooth(wt, dt_, bt, x0, steps, th, de,
                                            1, want_residual=True, nd=nd)

            def plain():
                return st._cheb_plain(wt, dt_, bt, x0, steps, th, de, 1,
                                      want_residual=True, nd=nd)

            results[kname].append(real_extras(check_row(
                kname, name, bt.shape, kern(), plain(), kern, plain,
                (nbytes(wt, dt_, bt, x0, bt, bt),
                 cheb_flops(3 ** nd, bt, steps, True)), steps=steps),
                wt, dt_, bt, x0, steps, th, de, 1, nd, True))

        def complex_cheb_check(kname, grid, nb, steps):
            # per-batch complex w, (n,) bounds, residual on (the ParaDiag
            # frequency V-cycles)
            nd = len(grid)
            w, dinv, theta, delta = stencil(nb, grid, complex_=True)
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

        def floor(nd, wt, nb, passes):
            width = vector_batch_width(nd, name, nb)
            return dict(batch_width=width,
                        design_floor_ms=design_floor(wt, nb, passes, width))

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
                 cheb_flops(25, bt, steps, residual, dim=2)), steps=steps,
                **floor(2, wt, nb, steps + int(residual))))

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
                plain_repeats=PLAIN_REPEATS_3D, steps=steps, degree=degree,
                **floor(3, wt, nb, steps + int(residual))))

        def q2_apply_check(grid, nb):
            # one degree-2 application, shared weights
            w, _, _, _ = make_stencil(rng, 1, grid, degree=2)
            wt, xt = T(w), T(field((nb,) + grid))
            results["K6q2"].append(apply_extras(check_row(
                "K6q2", name, xt.shape, st.apply_stencil(wt, xt, 2, nd=3),
                st._apply_plain(wt, xt, 2, nd=3),
                lambda: st.apply_stencil(wt, xt, 2, nd=3),
                lambda: st._apply_plain(wt, xt, 2, nd=3),
                (nbytes(wt, xt, xt), stencil_flops(125, xt, 1)),
                plain_repeats=PLAIN_REPEATS_3D), wt, xt, 2, 3))

        def q2_cheb_check(kname, grid, nb, steps, complex_):
            # real: shared w and dinv, scalar bounds, x0 = 0, no residual
            # (the mass solve); complex: per-batch w, (n,) bounds, residual
            # on (the ParaDiag frequency V-cycles)
            w, dinv, theta, delta = stencil(nb if complex_ else 1, grid,
                                            complex_, degree=2)
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
            row = check_row(
                kname, name, bt.shape, kern(), plain(), kern, plain,
                (nbytes(wt, dt_, bt, x0, *bounds, *outs),
                 cheb_flops(125, bt, steps, complex_)),
                plain_repeats=PLAIN_REPEATS_3D, steps=steps)
            if not complex_:
                real_extras(row, wt, dt_, bt, x0, steps, th, de, 2, 3, False)
            results[kname].append(row)

        def narrow_cheb_check(kname, grid, nb, steps, complex_, degree):
            # planes stored narrow (``narrow_planes``: bf16 under float32
            # fields, f32 under float64), residual on; complex: per-batch
            # w and dinv, (n,) bounds (the ParaDiag frequency V-cycles);
            # real: shared w and dinv, scalar bounds, x0 = 0.  The
            # full-precision kernel is timed on the full planes beside it.
            nd = len(grid)
            K = (2 * degree + 1) ** nd
            wd = NARROW_WEIGHTS[name]
            w, dinv, theta, delta = stencil(nb if complex_ else 1, grid,
                                            complex_, degree)
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
            wn, dn = st.narrow_planes(wt, wd), st.narrow_planes(dt_, wd)

            def kern():
                return st.fused_cheb_smooth(wn, dn, bt, x0, steps, th, de,
                                            degree, want_residual=True,
                                            weight_dtype=wd, nd=nd)

            def plain():
                return st._cheb_plain(wn, dn, bt, x0, steps, th, de, degree,
                                      want_residual=True, weight_dtype=wd,
                                      nd=nd)

            def full():
                return st.fused_cheb_smooth(wt, dt_, bt, x0, steps, th, de,
                                            degree, want_residual=True,
                                            nd=nd)

            bounds = (th, de) if complex_ else ()
            row = check_row(
                kname, name, bt.shape, kern(), plain(), kern, plain,
                (nbytes(wn, dn, bt, x0, *bounds, bt, bt),
                 cheb_flops(K, bt, steps, True)),
                plain_repeats=PLAIN_REPEATS_3D if nd == 3 else REPEATS,
                steps=steps, degree=degree, weight_dtype=wd,
                full_precision_ms=cuda_ms(full),
                full_precision_bound_ms=bound(
                    nbytes(wt, dt_, bt, x0, *bounds, bt, bt),
                    cheb_flops(K, bt, steps, True), name)[0])
            if not complex_:
                real_extras(row, wn, dn, bt, x0, steps, th, de, degree, nd,
                            True, weight_dtype=wd)
            results[kname].append(row)
            del wt, dt_, wn, dn, bt, x0

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
        # 129^2 and 65^2, 8 steps and the residual; a ragged batch of
        # nine (the batch loop's chunks of eight), 20 steps
        vector_cheb_check((gs, gs), ns, 20, False)
        for gl in (gs, (gs + 1) // 2):
            vector_cheb_check((gl, gl), 0, 8, True)
        vector_cheb_check((gs, gs), 9, 20, False)
        # K5v: the stokes3d mass solve (7, 33^3, 3), 20 steps; the V-cycle
        # levels 33^3 and 17^3, 8 steps and the residual; one degree-1
        # (K = 27) case at the finest level's shape; a ragged batch of
        # nine, 20 steps
        vector3_cheb_check((g3v,) * 3, n3v, 20, False)
        for gl in (g3v, (g3v + 1) // 2):
            vector3_cheb_check((gl,) * 3, 0, 8, True)
        vector3_cheb_check((g3v,) * 3, 0, 8, True, degree=1)
        vector3_cheb_check((g3v,) * 3, 9, 20, False)
        # degree 2 at heat3d_q2's shapes: K6 (15, 65^3); K5 real (15,
        # 65^3), 20 steps (the mass solve); K5 complex 8 frequencies, 8
        # steps, at every smoothed level
        q2_apply_check((gq2,) * 3, nq2)
        q2_cheb_check("K5rq2", (gq2,) * 3, nq2, 20, False)
        for gl in (65, 33, 17, 9):
            q2_cheb_check("K5cq2", (gl,) * 3, nq2 // 2 + 1, 8, True)
        # narrow weight planes at the finest shape of each path: K3 32
        # frequencies (257^2), 3 steps; K5 complex 8 frequencies (65^3),
        # 8 steps, degree 1 and 2; K2 (63, 257^2) and K5 real (15, 65^3),
        # 10 steps, the tile on the mass solves' batches (no path runs
        # them with narrow planes)
        narrow_cheb_check("K3n", (g, g), (n_t - 1) // 2 + 1, 3, True, 1)
        narrow_cheb_check("K5cn", (g3,) * 3, n3 // 2 + 1, 8, True, 1)
        narrow_cheb_check("K5cnq2", (gq2,) * 3, nq2 // 2 + 1, 8, True, 2)
        narrow_cheb_check("K2n", (g, g), n_t - 1, 10, False, 1)
        narrow_cheb_check("K5rn", (g3,) * 3, n3, 10, False, 1)
        # the one field of ``narrow_multigrid``'s finest level (the weight
        # ring), the pre-smoothing's 8 steps + r
        narrow_cheb_check("K2n1", (g, g), 1, 8, False, 1)
        narrow_cheb_check("K5rn1", (g3,) * 3, 1, 8, False, 1)
        # backward Euler: the edge rows' single-block V-cycles, K2 at
        # (1, 257^2) and K5 real at (1, 65^3), 10 steps + r; the interior
        # ParaDiag's frequencies, (n_t - 2) // 2 + 1 = 32 for the flagship,
        # K3 at 257^2, 3 steps + r
        real_cheb_check("K2be", (g, g), 1, 10)
        real_cheb_check("K5rbe", (g3,) * 3, 1, 10)
        # and their one-field applications (the per-entry K1 and K6)
        apply_check("K1be", (g, g), 1)
        apply_check("K6be", (g3,) * 3, 1)
        complex_cheb_check("K3be", (g, g), (BE["n_t"] - 2) // 2 + 1, 3)
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
# the ParaDiag frequency V-cycles smooth on their stencil pairs
# (``fused_cheb_smooth_pair``); the per-frequency complex kernels run on
# a pc state carried with per-frequency planes (``carried_solve``); the
# applications on time batches run the plane tile (``_tile`` keys)
KEYS_2D = ("stencil_apply", "stencil_apply_tile", "cheb_smooth_real",
           "cheb_smooth_pair_2d")
KEYS_STOKES = ("cheb_smooth_vector", "cheb_smooth_real")
KEYS_3D = ("stencil_apply_3d", "stencil_apply_3d_tile", "cheb_smooth_3d_real",
           "cheb_smooth_pair_3d")
LAMBDA_STOKES3D = dict(lambda_v_bounds=(0.1, 2.3),
                       lambda_p_bounds=(0.1, 3.4))
# the velocity is Q2 (K5v); the pressure's K_p V-cycle and M_p solve are
# scalar Q1 (K5 real)
KEYS_STOKES3D = ("cheb_smooth_3d_vector", "cheb_smooth_3d_real")
LAMBDA_Q2 = (0.1, 2.3)
KEYS_3D_Q2 = ("stencil_apply_3d_q2", "stencil_apply_3d_tile_q2",
              "cheb_smooth_3d_real_q2", "cheb_smooth_pair_3d_q2")
# with bfloat16 weight planes the ParaDiag V-cycles run the narrow complex
# kernels; the mass solves and applications stay full precision
KEYS_2D_BF16 = ("stencil_apply", "stencil_apply_tile", "cheb_smooth_real",
                "cheb_smooth_complex_bf16")
KEYS_3D_BF16 = ("stencil_apply_3d", "stencil_apply_3d_tile",
                "cheb_smooth_3d_real", "cheb_smooth_3d_complex_bf16")
KEYS_3D_Q2_BF16 = ("stencil_apply_3d_q2", "stencil_apply_3d_tile_q2",
                   "cheb_smooth_3d_real_q2",
                   "cheb_smooth_3d_complex_q2_bf16")


def heat_problem(n, n_t, dtype, device, mode, CN=True):
    """The flagship heat-control problem (a Q1 UnitSquareMesh, CN or with
    ``CN=False`` backward Euler, beta = 1e-4, zero Dirichlet data); the
    ParaDiag sweeps with ``bench.py``'s settings."""
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
        CN=CN, bcs_v=bc_t)
    if mode == "paradiag":
        ctl.set_schur_sweep("paradiag", paradiag_cycles=1, smooth=(3, 3))
        ctl.set_mass_solver_steps(10)
    return ctl


def heat_be_problem(n, n_t, dtype, device, mode):
    """The flagship problem under backward Euler: ``bench.py``'s BE recipe
    (``BENCH_CN=0``) with ParaDiag, the reference recipe
    (``be_parity.json``: default 20 mass steps) with the scan."""
    return heat_problem(n, n_t, dtype, device, mode, CN=False)


def heat3d_problem(n, n_t, dtype, device, mode, degree=1, CN=True):
    """``bench_extra.py``'s heat3d problem: hex Q1 (``degree`` 2: Q2)
    UnitCubeMesh, CN (or backward Euler), beta = 1e-4,
    v_d = sin(pi x) sin(pi y) sin(pi z), f = 0, zero Dirichlet data;
    ParaDiag with its default settings (2 cycles, (8, 8) smoothing, alpha
    1e-3, one defect step, 20 mass steps)."""
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
                               CN=CN, bcs_v=bc_t)
    ctl.set_schur_sweep(mode)
    return ctl


def heat3d_be_problem(n, n_t, dtype, device, mode):
    """heat3d under backward Euler (``CN=False``)."""
    return heat3d_problem(n, n_t, dtype, device, mode, CN=False)


def heat3d_q2_problem(n, n_t, dtype, device, mode):
    """heat3d on Q2 hexahedra: n^3 cells, (2n + 1)^3 nodes."""
    return heat3d_problem(n, n_t, dtype, device, mode, degree=2)


def with_weights(build, weight_dtype):
    """A ParaDiag problem constructor whose frequency V-cycles store their
    weight planes in ``weight_dtype`` (``set_schur_sweep(...,
    weight_dtype=...)``, the JAX benchmarks' ``BENCH_PD_WEIGHT_DTYPE``)."""
    def narrow_build(n, n_t, dtype, device, mode):
        ctl = build(n, n_t, dtype, device, mode)
        ctl.set_schur_sweep(mode, weight_dtype=weight_dtype)
        return ctl
    return narrow_build


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


def solve(ctl, bounds, gated=True, budget=None,
          parameters=SOLVER_PARAMETERS):
    """The slice's solve; ``gated=False`` returns the record at the end of
    the budget instead of raising when it does not converge."""
    if not gated:
        parameters = dict(parameters, preconditioner=True)
    if budget is not None:
        parameters = dict(parameters, maximum_iterations=budget)
    return ctl.linear_solve(lambda_v_bounds=bounds,
                            solver_parameters=parameters,
                            print_error=False)


def held_on_card(dev, label, run, hist_tol=1e-8, to_initial=False,
                 **extra):
    """One float64 solve, ``run(device) -> (info, problem)``, on the card
    against the same solve on the CPU (plain versions, which the CPU tests
    hold to the JAX reference): equal iterations, residual histories
    within ``hist_tol`` relative (entry by entry, or with ``to_initial``
    relative to the initial residual, which only a history ending more
    than six orders below its initial residual may take: its last entries
    are rounding), v and zeta within 1e-9.  Returns the printed row
    (``extra`` first)."""
    runs = {}
    for device in ("cpu", dev):
        info, ctl = run(device)
        runs[str(device)] = (info, ctl._v.data.cpu(), ctl._zeta.data.cpu())
    (ic, vc, zc), (ig, vg, zg) = runs["cpu"], runs[str(dev)]
    its = ic.iterations
    hc = ic.res_norms[:its + 1]
    gap = np.abs(hc - ig.res_norms[:its + 1])
    row = dict(extra, iterations_cpu=its, iterations_gpu=ig.iterations,
               hist_rel=float(np.max(gap / np.abs(hc))),
               hist_rel_to_initial=float(np.max(gap) / hc[0]),
               last_rel=float(hc[-1] / hc[0]),
               v_rel=float((vc - vg).abs().max() / vc.abs().max()),
               zeta_rel=float((zc - zg).abs().max() / zc.abs().max()))
    print(f"slice f64 {label}: cuda vs cpu {row}", flush=True)
    held = row["hist_rel_to_initial"] if to_initial else row["hist_rel"]
    if not (ig.iterations == its and held < hist_tol
            and row["v_rel"] < 1e-9 and row["zeta_rel"] < 1e-9
            and (not to_initial or row["last_rel"] < 1e-6)):
        raise AssertionError(f"cuda slice disagrees with cpu: {row}")
    return row


def check_small_f64(dev, record, key, cases, hist_tol=1e-8,
                    to_initial=False):
    """A slice in float64 on the card against the same solve on the CPU
    (``held_on_card``).  ``cases``: (label, problem constructor, mode, n,
    n_t, lambda bounds)."""
    out = {}
    for label, build, mode, n, n_t, bounds in cases:
        def run(device):
            ctl = build(n, n_t, torch.float64, device, mode)
            return solve(ctl, bounds), ctl

        out[f"{mode} {label}"] = held_on_card(
            dev, f"{mode} {label}", run, hist_tol, to_initial, n=n, n_t=n_t)
    record[key] = out


# the iterations of a stalled narrow-plane solve held to the same solve on
# rounded planes run by the full-precision kernels
ROUNDED_ITERATIONS = 3


def rounded_planes_solve(dev, build, size, bounds, narrow_ctl):
    """The ParaDiag solve of ``narrow_ctl`` (weight planes stored narrow)
    run instead by the full-precision kernels on its planes widened back:
    a problem from ``build`` (no ``weight_dtype``) whose pc state takes
    the narrow pc's smoother planes, widened exactly; every other part of
    the state (bounds, diagonals, coarse inverses) is made from the full
    planes in both, as the reference makes it.  The narrow kernels widen
    each weight on load and then compute as the full-precision ones do,
    up to float32 rounding (the two instantiations do not round alike),
    so both solves start on one residual history; a stalled float32
    GMRES amplifies those rounding differences after a few iterations
    (to a few percent of the residual by the budget's end, where both
    stand at the same level)."""
    from control_tpu_torch.ops.stencil import widen_planes
    n, n_t = size
    ctl = build(n, n_t, torch.float32, dev, "paradiag")
    solve(ctl, bounds, gated=False, budget=1)   # builds and caches the pc
    (state,) = ctl._pc_state_cache.values()
    (narrow,) = narrow_ctl._pc_state_cache.values()
    # the full pc's stencil pairs as per-frequency planes, the narrow
    # pc's layout
    per_frequency_state(state)
    for sweep in ("fwd", "bwd"):
        full, stored = state[sweep]["params"], narrow[sweep]["params"]
        for k in ("Ws", "dinvs"):
            full[k] = [widen_planes(a, b) for a, b in zip(stored[k],
                                                          full[k])]
    return solve(ctl, bounds, gated=False)


def timed_solve(dev, record, card, key, metric, build, size, bounds,
                max_its, keys, full_row=None, gated=True, full_build=None,
                parameters=SOLVER_PARAMETERS, carried=None):
    """A slice's ParaDiag solve at full size, float32, with the Krylov
    ``parameters``: solved once, the pc
    build timed apart, then solved again with CUDA events around it and
    every launch count set to 0 just before; ``keys`` are the kernels of
    the path, each of which must launch (narrow planes come stored narrow
    from the pc build: the kernel wrappers refuse full ones on the card).
    ``full_precision``: the row of
    the same slice with its weights in float32, printed beside this one's
    numbers.  ``gated=False``: a measurement, not a check of convergence
    (the recipe's behaviour at this width, ``ROADMAP.md`` Queue 3): the
    first solve is a one-iteration warm-up that builds the pc, the timed
    solve runs to its budget and the row says where it got to; instead of
    convergence it is held to ``rounded_planes_solve`` with ``full_build``
    (the relative residuals of the first ``ROUNDED_ITERATIONS``
    iterations, each one preconditioner application deeper, within 1e-4
    of each other's; the rest of both histories is printed), and the
    other checks hold.  A full-precision solve must launch no
    per-frequency complex smoother (its frequency hierarchies are stencil
    pairs), a narrow one no pair smoother.  ``carried``: the
    per-frequency complex kernel's key; the same solve then runs again
    from the pc state with per-frequency planes (``carried_solve``).  The
    row carries the peak device memory of the first solve (pc build
    included) and of the timed one, and the pc state's bytes."""
    from control_tpu_torch.config import full_precision
    from control_tpu_torch.fem.assemble import assemble
    from control_tpu_torch.fem.space import combine_masks

    n, n_t = size
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctl = build(n, n_t, torch.float32, dev, "paradiag")
    first = solve(ctl, bounds, gated, budget=None if gated else 1,
                  parameters=parameters)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first_peak = torch.cuda.max_memory_allocated()

    # the pc build alone, on the card, from the solve's own inputs
    with full_precision():
        mask = combine_masks(ctl._space_v, ctl._bcs_v[1])
        Dv_A = ctl._D_stack(ctl._v.data)
        M = assemble(ctl._M_v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctl.construct_pc(False, bounds, mask, Dv_A, M,
                         epsilon=None if ctl._CN else 1.0e-3)
        torch.cuda.synchronize()
        pc_build_s = time.perf_counter() - t0

    def solve_fn(budget=None):
        return solve(ctl, bounds, gated and budget is None, budget=budget,
                     parameters=parameters)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    info, row = repeat_solve_row(solve_fn, metric, "paradiag", card)
    weight_dtype = getattr(ctl, "_mg_weight_dtype", None)
    row.update(pc_build_s=pc_build_s, first_solve_s=first_s,
               first_iterations=first.iterations, weight_dtype=weight_dtype,
               CN=ctl._CN, gmres_restart=parameters["gmres_restart"],
               first_solve_peak_bytes=first_peak,
               peak_bytes=torch.cuda.max_memory_allocated(),
               pc_state_bytes=state_bytes(ctl._pc_state_cache))
    if full_row is not None:
        row["full_precision"] = {
            k: full_row[k] for k in ("iterations", "relative_residual",
                                     "solve_s", "pc_build_s")}
    fields = {"v": (ctl._v.data, ctl._space_v, n_t),
              "zeta": (ctl._zeta.data, ctl._space_v, n_t)}
    if not gated:
        row["gated"] = False
        k = info.iterations + 1
        row["relative_history"] = [float(r / info.res_norms[0])
                                   for r in info.res_norms[:k]]
        rounded = rounded_planes_solve(dev, full_build, size, bounds, ctl)
        k = min(info.iterations, rounded.iterations) + 1
        ours = np.asarray(info.res_norms[:k]) / info.res_norms[0]
        theirs = np.asarray(rounded.res_norms[:k]) / rounded.res_norms[0]
        gap = np.abs(ours - theirs) / ours
        row["rounded_planes_full_kernels"] = {
            "iterations": rounded.iterations,
            "relative_residual": rounded.rnorm / rounded.rnorm0,
            "first_iterations_max_rel": float(
                np.max(gap[:ROUNDED_ITERATIONS + 1])),
            "history_max_rel": float(np.max(gap)),
            "relative_history": [float(r) for r in theirs]}
    absent = pair_keys() if weight_dtype else per_frequency_keys()
    row = judge_solve(record, key, row, info, max_its, keys, fields,
                      gated=gated, absent=absent)
    if carried is not None:
        row["per_frequency_state"] = carried_solve(ctl, solve_fn, metric,
                                                   card, info, carried)
    if not gated:
        same = row["rounded_planes_full_kernels"]
        if not (info.iterations >= ROUNDED_ITERATIONS
                and same["first_iterations_max_rel"] <= 1e-4
                and np.isfinite(same["relative_residual"])):
            raise AssertionError(f"{key}: the narrow kernels part from the "
                                 "full-precision ones on the same rounded "
                                 f"planes: {same}")
    return row


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


def judge_solve(record, key, row, info, max_its, keys, fields,
                gated=True, absent=()):
    """Print and record a timed solve's row, and hold it to its targets:
    convergence below 1e-6 within ``max_its`` (unless not ``gated``: then
    a finite residual), every field (name: (tensor, space, blocks)) on
    the card, finite and of its shape, every kernel of ``keys``
    launched and none of ``absent``."""
    print(json.dumps(row), flush=True)
    record[key] = row
    if gated and not (info.converged and row["relative_residual"] < 1e-6
                      and info.iterations <= max_its):
        raise AssertionError(f"{key} solve off target: {row}")
    if not np.isfinite(row["relative_residual"]):
        raise AssertionError(f"{key} residual not finite: {row}")
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
    for k in absent:
        if row["launches"][k] != 0:
            raise AssertionError(f"kernel {k} launched in the timed solve, "
                                 f"which should not run it: "
                                 f"{row['launches']}")
    return row


def pair_keys():
    from control_tpu_torch.ops import stencil as st
    return tuple(k for k in st.launch_counts
                 if k.startswith("cheb_smooth_pair"))


def per_frequency_keys():
    """The full-precision complex smoothers on per-frequency planes (K3,
    K5 complex)."""
    from control_tpu_torch.ops import stencil as st
    return tuple(k for k in st.launch_counts
                 if re.fullmatch(r"cheb_smooth(_3d)?_complex(_q\d)?", k))


def state_bytes(tree, seen=None):
    """Device bytes of the tensors in a pc state (nested dicts and lists),
    each storage counted once (level 0's stencil pair is the defect
    correction's ``wF``/``wS``)."""
    seen = set() if seen is None else seen
    if torch.is_tensor(tree):
        ptr = tree.untyped_storage().data_ptr()
        if ptr in seen:
            return 0
        seen.add(ptr)
        return tree.untyped_storage().nbytes()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(state_bytes(t, seen) for t in tree)
    return 0


def per_frequency_state(state):
    """``state`` (a pc state, in place) with every stencil-pair hierarchy
    replaced by its per-frequency planes (``form_planes``): the layout
    of a pc state carried from the JAX package by ``utils.convert``, on
    which the per-frequency complex kernels run."""
    from control_tpu_torch.solvers.multigrid import form_planes
    for key, sub in state.items():
        if isinstance(sub, dict):
            if "WF" in sub:
                state[key] = form_planes(sub)
            else:
                per_frequency_state(sub)
    return state


def carried_solve(ctl, solve_fn, metric, card, pair_info, key):
    """The timed solve of ``ctl`` again (``solve_fn``), from its cached pc
    state with per-frequency planes (``per_frequency_state``): the path
    of a state carried from the JAX package, and the smoothing the
    ParaDiag path ran before the stencil pair, timed in the same call.
    After a one-iteration warm-up, every launch count is set to 0 and the
    solve timed (``repeat_solve_row``); it must converge below 1e-6
    within one iteration of the pair's count (the same pc up to float32
    rounding), launch the per-frequency kernel ``key`` and no pair
    smoother.  Returns its row with its peak device memory and pc state
    bytes."""
    (state,) = ctl._pc_state_cache.values()
    per_frequency_state(state)
    solve_fn(budget=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    info, row = repeat_solve_row(solve_fn, metric + "_per_frequency_state",
                                 "paradiag", card)
    row.update(peak_bytes=torch.cuda.max_memory_allocated(),
               pc_state_bytes=state_bytes(state))
    print(json.dumps(row), flush=True)
    if not (info.converged and row["relative_residual"] < 1e-6
            and abs(info.iterations - pair_info.iterations) <= 1):
        raise AssertionError(f"{metric}: the per-frequency state's solve "
                             f"is off the pair's: {row}")
    if row["launches"][key] <= 0 or any(row["launches"][k]
                                        for k in pair_keys()):
        raise AssertionError(f"{metric}: the per-frequency state's solve "
                             f"did not run {key} alone: {row['launches']}")
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
    """The Stokes solve at full width, float64: the build of its pieces
    (block system, preconditioner state, right-hand sides) made twice and
    the second build timed, every coarse dense inverse of the two held bit
    for bit (the dense coarse assembly sums in a fixed order, so the pc,
    and with it the iteration count, repeats itself in one process), then
    one solve with CUDA events around it and the launch counts set to 0
    just before.  The solve is host-bound (47-92 s at 64^2 x 32), so it
    runs once."""
    n, n_t = size or (STOKES["n"], STOKES["n_t"])
    ctl = build(n, n_t, torch.float64, dev)
    first_inv = dense_inverses(
        stokes_solve(ctl, lambdas, _return_pieces=True)[1].state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pieces = stokes_solve(ctl, lambdas, _return_pieces=True)
    torch.cuda.synchronize()
    pc_build_s = time.perf_counter() - t0
    second_inv = dense_inverses(pieces[1].state)
    del pieces

    torch.cuda.reset_peak_memory_stats()
    info, row = repeat_solve_row(lambda: stokes_solve(ctl, lambdas), metric,
                                 "scan", card, dtype="float64")
    its = info.iterations
    row.update(pc_build_s=pc_build_s,
               dense_inverses_bit_equal=all(
                   torch.equal(first_inv[p], second_inv[p])
                   for p in first_inv),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               residual_history=[float(r) for r in info.res_norms[:its + 1]])
    if not (row["dense_inverses_bit_equal"] and first_inv):
        raise AssertionError(f"{key} does not repeat itself: two pc builds "
                             "give coarse inverses that are not bit-equal")
    fields = {"v": (ctl._v.data, ctl._space_v, n_t),
              "zeta": (ctl._zeta.data, ctl._space_v, n_t),
              "p": (ctl._p.data, ctl._space_p, n_t - 1),
              "mu": (ctl._mu.data, ctl._space_p, n_t - 1)}
    return judge_solve(record, key, row, info,
                       STOKES_PARAMETERS["maximum_iterations"], keys,
                       fields)


def dense_inverses(state, path=""):
    """Every coarse dense inverse (``Ainv``) of a pc state, by path."""
    if isinstance(state, dict):
        items = state.items()
    elif isinstance(state, (list, tuple)):
        items = enumerate(state)
    else:
        return {path: state} if path.endswith("Ainv") else {}
    out = {}
    for k, v in items:
        out.update(dense_inverses(v, f"{path}/{k}"))
    return out


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


def narrow_multigrid(dev, record, card):
    """Geometric multigrid with its weight planes stored in bfloat16
    (``Multigrid(op, weight_dtype=...)``, the JAX package's BoomerAMG
    stand-in, whose hierarchies take ``weight_dtype`` whatever their
    operator) as the preconditioner of GMRES(30), rtol 1e-6, on a Dirichlet
    stiffness-plus-mass operator at the flagship's width (Q1 256^2) and
    heat3d's (hex Q1 64^3), float32: its real V-cycles run the narrow K2
    (2-D) and K5 real (3-D) kernels.  Each solve, and the same solve with
    full-precision planes beside it, runs with every launch count set to 0
    just before; the narrow one must converge, with a true residual below
    1e-5, its narrow kernel launched in the solve."""
    from control_tpu_torch import (UnitSquareMesh, UnitCubeMesh,
                                   FunctionSpace, DirichletBC, TrialFunction,
                                   TestFunction, inner, grad, dx, assemble)
    from control_tpu_torch.config import full_precision
    from control_tpu_torch.ops import stencil as st
    from control_tpu_torch.ops.local_op import MaskedOp
    from control_tpu_torch.solvers.krylov import gmres
    from control_tpu_torch.solvers.multigrid import Multigrid

    rng = np.random.default_rng(SEED)
    n2, n3 = FLAGSHIP["n"], HEAT3D["n"]
    cases = (
        ("multigrid_2d", "cheb_smooth_real_bf16", lambda: UnitSquareMesh(
            n2, n2, quadrilateral=True, dtype=torch.float32, device=dev)),
        ("multigrid_3d", "cheb_smooth_3d_real_bf16", lambda: UnitCubeMesh(
            n3, n3, n3, dtype=torch.float32, device=dev)))
    out = {}
    for label, key, mesh_fn in cases:
        sp = FunctionSpace(mesh_fn(), "Lagrange", 1)
        u, v = TrialFunction(sp), TestFunction(sp)
        op = MaskedOp(assemble(inner(grad(u), grad(v)) * dx
                               + inner(u, v) * dx),
                      DirichletBC(sp, 0.0, "on_boundary").mask)
        b = torch.where(op.mask, 0.0, torch.as_tensor(
            rng.standard_normal(sp.grid_shape), dtype=torch.float32,
            device=dev))
        rows = {}
        for wd in (None, WEIGHT_DTYPE):
            with full_precision():
                mg = Multigrid(op, weight_dtype=wd)
                st.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, info = gmres(op.apply, b, M=mg, restart=30, rtol=1e-6,
                                maxiter=100)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                true_rel = float(torch.linalg.vector_norm(b - op.apply(x))
                                 / torch.linalg.vector_norm(b))
            rows[wd or "float32"] = {
                "iterations": info["iterations"],
                "relative_residual": float(info["rnorm"] / info["rnorm0"]),
                "true_relative_residual": true_rel,
                "converged": info["converged"], "solve_s": seconds,
                "launches": {k: c for k, c in st.launch_counts.items()
                             if c}}
        row = {"metric": f"{label}_{sp.grid_shape[0]}_gmres_mg_bf16_cuda",
               **rows[WEIGHT_DTYPE], "full_precision": rows["float32"],
               "card": card}
        print(json.dumps(row), flush=True)
        out[label] = row
        if not (row["converged"] and row["true_relative_residual"] < 1e-5
                and bool(torch.isfinite(x).all())
                and tuple(x.shape) == tuple(sp.grid_shape)):
            raise AssertionError(f"{label} off target: {row}")
        if row["launches"].get(key, 0) <= 0:
            raise AssertionError(f"{label}: {key} not launched in the "
                                 f"solve: {row}")
    record["narrow_multigrid"] = out
    return out


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


def be_restart10(dev, record, card, size, bounds):
    """A measurement, not a check: the flagship BE ParaDiag solve in
    float32 at GMRES(10) with a budget of 100 (``bench.py`` runs BE at
    GMRES(30) for the TPU's float32 noise; whether the card needs the
    longer restart is ROADMAP's question).  Prints its iterations and
    final residual; only a residual that is not finite fails."""
    n, n_t = size
    ctl = heat_be_problem(n, n_t, torch.float32, dev, "paradiag")
    parameters = dict(BE_PARAMETERS, gmres_restart=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = solve(ctl, bounds, gated=False, parameters=parameters)
    torch.cuda.synchronize()
    row = {"metric": "heat_control_be_256x256_nt64_gmres10", "CN": False,
           "schur": "paradiag", "dtype": "float32", "gmres_restart": 10,
           "budget": parameters["maximum_iterations"],
           "iterations": info.iterations,
           "relative_residual": info.rnorm / info.rnorm0,
           "converged": info.converged,
           "first_solve_s": time.perf_counter() - t0, "card": card}
    print(json.dumps(row), flush=True)
    record["flagship_be_gmres10"] = row
    if not np.isfinite(row["relative_residual"]):
        raise AssertionError(f"BE GMRES(10) residual not finite: {row}")
    return row


def be_parity_recipe(ctl, bounds):
    """``tools/tpu_results/be_parity.json``'s recipe on the problem ``ctl``
    (solved once, so its pc state is cached): the same pc and system, but
    the Krylov iteration on the untransformed unknowns, as the JAX
    package's BE solve ran it when the record was made.  Its linear solve
    has since run GMRES on the eps-scaled final state block
    (``unknown_scale``): the same preconditioned spectrum, another
    residual norm, so another count (the port at 32^2 x 16 and 64^2 x 32
    in float64 on a CPU: 13 with the transform, 17 and 17 without, the
    record's counts and residuals)."""
    from control_tpu_torch import MultiBlockSystem, DirichletBCNullspace
    from control_tpu_torch.config import full_precision
    from control_tpu_torch.fem.assemble import assemble
    from control_tpu_torch.fem.space import combine_masks
    from control_tpu_torch.solvers.block import finalize_solve_info

    space, n_t, bcs = ctl._space_v, ctl._n_t, ctl._bcs_v[1]
    with full_precision():
        mask = combine_masks(space, bcs)
        Dv_A, M = ctl._D_stack(ctl._v.data), assemble(ctl._M_v)
        b_0, b_1 = ctl._build_rhs(None, None, ctl._initial_state(), Dv_A, M,
                                  mask, False, ctl._bcs_v)
        (state,) = ctl._pc_state_cache.values()
        pc = ctl.construct_pc(False, bounds, mask, Dv_A, M, epsilon=1.0e-3,
                              prebuilt=state)
        ns = tuple(DirichletBCNullspace(bcs) for _ in range(n_t))
        system = MultiBlockSystem(space, space, *ctl._blocks(Dv_A, M=M)[:4],
                                  n_blocks_00=n_t, n_blocks_11=n_t,
                                  nullspace_0=ns, nullspace_1=ns, CN=False)
        fn = system.solve_fn(solver_parameters=SOLVER_PARAMETERS, pc_fn=pc)
        _, _, info = fn(torch.zeros_like(b_0), torch.zeros_like(b_1), b_0,
                        b_1)
    return finalize_solve_info(info, SOLVER_PARAMETERS)


def be_scan_f64(dev, record, card, size, bounds, its):
    """The flagship under backward Euler in float64 with the ``scan``
    sweeps (one real hierarchy per time row, 64 sequential V-cycles a
    sweep), the default 20-step mass Chebyshev, GMRES(10), rtol 1e-6: the
    reference recipe of ``tools/tpu_results/be_parity.json``.  A first
    ``linear_solve`` (the pc build inside it, timed), then a repeat solve
    with CUDA events around it and the launch counts set to 0 just before,
    which must converge below 1e-6 with K1 and K2 launched; then
    ``be_parity_recipe`` on the same pc, which must converge below 1e-6 in
    ``its`` = (least, most) iterations (the record: 16 at rel. res.
    5.27e-7)."""
    n, n_t = size
    ctl = heat_be_problem(n, n_t, torch.float64, dev, "scan")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = solve(ctl, bounds)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    info, row = repeat_solve_row(lambda: solve(ctl, bounds),
                                 "heat_control_be_256x256_nt64_scan_f64_cuda",
                                 "scan", card, dtype="float64")
    row.update(CN=False, first_solve_s=first_s,
               first_iterations=first.iterations)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parity = be_parity_recipe(ctl, bounds)
    torch.cuda.synchronize()
    row["be_parity_recipe"] = {
        "iterations": parity.iterations,
        "relative_residual": parity.rnorm / parity.rnorm0,
        "converged": parity.converged,
        "solve_s": time.perf_counter() - t0,
        "record": {"iterations": 16, "relative_residual": 5.268712166e-7}}
    fields = {"v": (ctl._v.data, ctl._space_v, n_t),
              "zeta": (ctl._zeta.data, ctl._space_v, n_t)}
    row = judge_solve(record, "flagship_be_scan_f64", row, info,
                      SOLVER_PARAMETERS["maximum_iterations"],
                      ("stencil_apply", "cheb_smooth_real"), fields)
    got = row["be_parity_recipe"]
    if not (parity.converged and got["relative_residual"] < 1e-6
            and its[0] <= parity.iterations <= its[1]):
        raise AssertionError("BE scan f64 off the be_parity.json record: "
                             f"{got}")
    return row


# ---------------------------------------------------------------------------
# phase 10: stationary control, K1-K3 at degree 3 and 4
# ---------------------------------------------------------------------------

# bench_extra.py's poisson at 256^2 (its configuration) and at 2048^2 (2049^2
# nodes: 151 MB of float32 weights per finest-level operator, beyond the 50
# MB L2), each in float32 and float64; tests/test_degree3.py's manufactured
# Q3 problem at 256^2 (769^2 nodes); the small float64 solves held on the
# card against the CPU.  jax_iterations: the JAX package's count for the
# float32 poisson at 256^2 (its own CPU run: 4 iterations, rel. res.
# 9.08e-8); the card must take at most 3 more.  In float64 the count stays
# mesh-independent (2 at 256^2 and 512^2 in the JAX package on a CPU), and
# the 2048^2 solve must take at most 2 more than 256^2's; in float32 it
# grows with the mesh in both packages (the JAX package on a CPU: 4, 5, 7
# at 256^2, 512^2, 1024^2), and the 2048^2 solve must converge within the
# budget of 50
STATIONARY = dict(n=256, large_n=2048, q3_n=256, jax_iterations=4,
                  small_n=32, small_q3_n=8, small_tri_n=16)
Q3_PARAMETERS = {"linear_solver": "fgmres", "fgmres_restart": 10,
                 "maximum_iterations": 500, "relative_tolerance": 1.0e-10,
                 "absolute_tolerance": 0.0, "monitor_convergence": False}
TRI_PARAMETERS = {"linear_solver": "fgmres", "fgmres_restart": 30,
                  "maximum_iterations": 500, "relative_tolerance": 1.0e-9,
                  "absolute_tolerance": 1.0e-9,
                  "monitor_convergence": False}
# the P2 triangle bounds of the JAX package's table (utils/spectral.py)
LAMBDA_TRI2 = (0.3923, 2.0599)
# node grids of the degree-3 and 4 kernel rows: (K1, K2 field; K3 field)
HIGH_DEGREE_GRIDS = {3: (769, 385), 4: (513, 257)}
KEYS_POISSON = ("stencil_apply", "cheb_smooth_real")
KEYS_Q3 = ("stencil_apply_q3", "cheb_smooth_real_q3")


def poisson_problem(n, dtype, device):
    """``bench_extra.py``'s ``poisson``: Q1 quads, beta = 1e-4, v_d =
    sin(pi x) sin(pi y), f = 0, zero Dirichlet data, GMRES(10), budget 50,
    rtol 1e-6, the 20-step Chebyshev mass solve (``Multigrid=False``).
    Returns the problem and its ``linear_solve`` arguments."""
    from control_tpu_torch import (Control, UnitSquareMesh, FunctionSpace,
                                   Function, DirichletBC, SpatialCoordinate,
                                   grad, inner, dx, sin, pi)
    mesh = UnitSquareMesh(n, n, quadrilateral=True, dtype=dtype,
                          device=device)
    space = FunctionSpace(mesh, "Lagrange", 1)
    X = SpatialCoordinate(mesh)

    def fdo(trial, test, u):
        return inner(grad(trial), grad(test)) * dx

    def ds_(test):
        v_d = Function(space).interpolate(sin(pi * X[0]) * sin(pi * X[1]))
        return inner(v_d, test) * dx, v_d

    def ff(test):
        return inner(Function(space), test) * dx

    ctl = Control.Stationary(space, fdo, desired_state=ds_, force_f=ff,
                             beta=1e-4,
                             bcs_v=DirichletBC(space, 0.0, "on_boundary"))
    return ctl, dict(lambda_v_bounds=LAMBDA_2D,
                     solver_parameters=SOLVER_PARAMETERS)


def q3_mass_bounds(nd=2):
    """The Jacobi-scaled mass bounds of Q3 (``tests/test_degree3.py``'s
    recipe, ``utils.spectral.jacobi_mass_bounds``): the spectrum of
    diag(M)^{-1} M on an 8^2 mesh (``nd`` 3: a 2^3 hex mesh, whose
    interval equals that of 4^3), in float64 on the CPU, widened by 0.98 /
    1.02."""
    from control_tpu_torch import UnitSquareMesh, UnitCubeMesh, FunctionSpace
    from control_tpu_torch.utils.spectral import jacobi_mass_bounds
    if nd == 3:
        mesh = UnitCubeMesh(2, 2, 2, dtype=torch.float64, device="cpu")
    else:
        mesh = UnitSquareMesh(8, 8, quadrilateral=True, dtype=torch.float64,
                              device="cpu")
    return jacobi_mass_bounds(FunctionSpace(mesh, "Lagrange", 3))


def poisson_q3_problem(n, dtype, device, bounds):
    """``tests/test_degree3.py:62-125``: Q3 quads, forward operator
    -div grad + I, beta = 1e-3, no boundary conditions, right-hand sides
    assembled from the exact pair (v = x e^y, zeta = sin(pi x) sin(2 pi
    y)), so that the discrete solution is the interpolated pair itself;
    FGMRES(10), budget 500, rtol 1e-10.  Returns the problem, its
    ``linear_solve`` arguments and the exact pair."""
    from control_tpu_torch import (Control, UnitSquareMesh, FunctionSpace,
                                   Function, TestFunction,
                                   SpatialCoordinate, grad, inner, dx, sin,
                                   exp, pi, assemble)
    mesh = UnitSquareMesh(n, n, quadrilateral=True, dtype=dtype,
                          device=device)
    X = SpatialCoordinate(mesh)
    space = FunctionSpace(mesh, "Lagrange", 3)
    test = TestFunction(space)
    beta = 1.0e-3

    def fdo(trial, test, u):
        return inner(grad(trial), grad(test)) * dx + inner(trial, test) * dx

    ctl = Control.Stationary(space, fdo, beta=beta, bcs_v=None)
    v_ref = Function(space).interpolate(X[0] * exp(X[1]))
    zeta_ref = Function(space).interpolate(sin(pi * X[0])
                                           * sin(2.0 * pi * X[1]))
    b_0 = assemble(inner(v_ref, test) * dx
                   + inner(grad(zeta_ref), grad(test)) * dx
                   + inner(zeta_ref, test) * dx)
    b_1 = assemble(inner(grad(v_ref), grad(test)) * dx
                   + inner(v_ref, test) * dx
                   - 1.0 / beta * inner(zeta_ref, test) * dx)
    return ctl, dict(lambda_v_bounds=bounds, v_d=b_0, f=b_1,
                     solver_parameters=Q3_PARAMETERS), (v_ref, zeta_ref)


def tri_mms_problem(n, dtype, device):
    """``tests/test_stationary.py:76-143`` at one size: Poisson control on
    P2 triangles, beta = 1e-3, zero Dirichlet data, FGMRES(30) to 1e-9."""
    from control_tpu_torch import (Control, UnitSquareMesh, FunctionSpace,
                                   Function, DirichletBC, SpatialCoordinate,
                                   grad, div, inner, dx, sin, exp, pi)
    mesh = UnitSquareMesh(n, n, dtype=dtype, device=device)
    X = SpatialCoordinate(mesh)
    space = FunctionSpace(mesh, "Lagrange", 2)
    beta = 1.0e-3
    v = sin(pi * X[0]) * sin(pi * X[1]) * exp(X[0] + X[1])
    zeta = sin(2.0 * pi * X[0]) * sin(2.0 * pi * X[1])

    def fdo(trial, test, u):
        return inner(grad(trial), grad(test)) * dx

    def ds_(test):
        v_d = Function(space).interpolate(-div(grad(zeta)) + v)
        return inner(v_d, test) * dx, Function(space).interpolate(v)

    def ff(test):
        f = Function(space).interpolate(-div(grad(v)) - 1.0 / beta * zeta)
        return inner(f, test) * dx

    ctl = Control.Stationary(space, fdo, desired_state=ds_, force_f=ff,
                             beta=beta,
                             bcs_v=DirichletBC(space, 0.0, "on_boundary"))
    return ctl, dict(lambda_v_bounds=LAMBDA_TRI2,
                     solver_parameters=TRI_PARAMETERS)


def stationary_solve(ctl, kw):
    return ctl.linear_solve(print_error=False, **kw)


def check_small_stationary(dev, record, cases, key="small_f64_stationary"):
    """Stationary solves in float64 on the card against the same solves on
    the CPU (``held_on_card``), recorded under ``key``.  ``cases``: (label,
    build(device) -> (problem, solve arguments), to_initial)."""
    out = {}
    for label, build, to_initial in cases:
        def run(device):
            ctl, kw = build(device)
            return stationary_solve(ctl, kw), ctl

        out[label] = held_on_card(dev, f"stationary {label}", run,
                                  to_initial=to_initial)
    record[key] = out


def timed_stationary(dev, record, card, key, metric, build, max_its, keys,
                     dtype):
    """A stationary solve at full width: solved once (building and caching
    its pc), the pc build timed apart from the solve's own inputs, then
    solved again with CUDA events around it and every launch count set to
    0 just before (``repeat_solve_row``); it must converge within
    ``max_its`` below 1e-6 with the kernels ``keys`` launched, v and zeta
    finite and on the card."""
    from control_tpu_torch import inner, dx
    from control_tpu_torch.config import full_precision
    from control_tpu_torch.fem.assemble import assemble
    from control_tpu_torch.fem.space import Function, combine_masks

    t0 = time.perf_counter()
    ctl, kw, *extra = build(dev)
    first = stationary_solve(ctl, kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    with full_precision():
        space = ctl._space_v
        mask = combine_masks(space, ctl._bcs_v) if ctl._bcs_v else None
        D_v, D_zeta = ctl.construct_D_v(Function(space, data=ctl._v.data))
        M = assemble(ctl._M_v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctl.construct_pc(False, kw["lambda_v_bounds"], mask, mask, D_v,
                         D_zeta, M)
        torch.cuda.synchronize()
        pc_build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    info, row = repeat_solve_row(lambda: stationary_solve(ctl, kw), metric,
                                 "stationary", card, dtype=dtype)
    its = info.iterations
    row.update(pc_build_s=pc_build_s, first_solve_s=first_s,
               first_iterations=first.iterations,
               nodes=list(space.grid_shape),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               residual_history=[float(r) for r in info.res_norms[:its + 1]])
    if extra:
        # the L2 errors of v and zeta against the exact discrete pair
        for name, got, ref in (("v", ctl._v, extra[0][0]),
                               ("zeta", ctl._zeta, extra[0][1])):
            d = Function(space, data=got.data - ref.data)
            row[f"l2_error_{name}"] = float(
                abs(float(assemble(inner(d, d) * dx))) ** 0.5)
    fields = {"v": (ctl._v.data[None], space, 1),
              "zeta": (ctl._zeta.data[None], space, 1)}
    return judge_solve(record, key, row, info, max_its, keys, fields)


def make_stencil_on_card(gen, n_w, grid, complex_, degree, dev,
                         dtype=torch.float64):
    """``make_stencil`` made on the card from a seeded generator, in the
    real ``dtype`` (complex ones as complex of it): the large degree-3
    and 4 stencils (up to 232 M complex weights in 2-D, 1.07 G at hex Q3)
    would take numpy tens of seconds, and in float32 the hex Q3 rows need
    no float64 copies of their 8.5 GB of complex64 weights."""
    grid = tuple(grid)
    K = (2 * degree + 1) ** len(grid)

    def uniform(lo, hi, shape):
        u = torch.rand(shape, generator=gen, dtype=dtype, device=dev)
        return u.mul_(hi - lo).add_(lo)

    w = uniform(0.2, 1.0, (n_w, K) + grid).mul_(-0.5)
    w[:, K // 2] = 4.0 + (K - 9) / 2.0 + uniform(0.0, 1.0, (n_w,) + grid)
    axes = tuple(range(1, len(grid) + 1))
    lam = 1.05 * torch.amax(w.abs().sum(dim=1) / w[:, K // 2].abs(),
                            dim=axes)
    if complex_:
        w = torch.polar(w, uniform(-0.3, 0.3, (n_w, K) + grid))
    return (w, 1.0 / w[:, K // 2], 0.5 * (lam + lam / 4.0),
            0.5 * (lam - lam / 4.0))


def check_kernels_high_degree(dev, record):
    """K1, K2 and K3 at degree 3 (K = 49) and 4 (K = 81) against their
    plain versions on the card, float64 and float32: K1 one application
    and K2 the 20-step mass solve + r on the Q3 256^2 finest level (one
    769^2 field, shared weights) and at degree 4 on 513^2; K3 32
    frequencies, 3 steps + r, on 385^2 (degree 3) and 257^2 (degree 4);
    the narrow K3 (bf16 planes under float32 fields, float32 under
    float64) at degree 3."""
    from control_tpu_torch.ops import stencil as st

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = {k: [] for k in ("K1q3", "K2q3", "K3q3", "K1q4", "K2q4",
                               "K3q4", "K3nq3")}
    nf = (FLAGSHIP["n_t"] - 1) // 2 + 1
    made = {}

    def stencil(n_w, grid, complex_, degree):
        key = (n_w, grid, complex_, degree)
        if key not in made:
            made[key] = make_stencil_on_card(gen, n_w, grid, complex_,
                                             degree, dev)
        return made[key]

    def field(shape, dt):
        a = torch.randn(shape, generator=gen, dtype=torch.float64,
                        device=dev)
        if dt.is_complex:
            a = a + 1j * torch.randn(shape, generator=gen,
                                     dtype=torch.float64, device=dev)
        return a.to(dt)

    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
        for degree, (g, gc) in HIGH_DEGREE_GRIDS.items():
            K = (2 * degree + 1) ** 2
            w, dinv, theta, delta = stencil(1, (g, g), False, degree)
            wt, dt_ = w[0].to(dtype), dinv[0].to(dtype)
            xt = field((1, g, g), dtype)
            results[f"K1q{degree}"].append(check_row(
                f"K1q{degree}", name, xt.shape,
                st.apply_stencil(wt, xt, degree),
                st._apply_plain(wt, xt, degree),
                lambda: st.apply_stencil(wt, xt, degree),
                lambda: st._apply_plain(wt, xt, degree),
                (nbytes(wt, xt, xt), stencil_flops(K, xt, 1)),
                degree=degree))
            bt, x0 = xt, torch.zeros_like(xt)
            th, de = float(theta[0]), float(delta[0])

            def kern():
                return st.fused_cheb_smooth(wt, dt_, bt, x0, 20, th, de,
                                            degree, want_residual=True)

            def plain():
                return st._cheb_plain(wt, dt_, bt, x0, 20, th, de, degree,
                                      want_residual=True)

            results[f"K2q{degree}"].append(real_extras(check_row(
                f"K2q{degree}", name, bt.shape, kern(), plain(), kern, plain,
                (nbytes(wt, dt_, bt, x0, bt, bt),
                 cheb_flops(K, bt, 20, True)), steps=20, degree=degree),
                wt, dt_, bt, x0, 20, th, de, degree, 2, True))
            del wt, dt_, xt, bt, x0
            wc, dc, thc, dec = stencil(nf, (gc, gc), True, degree)
            wt, dt_ = wc.to(cdt), dc.to(cdt)
            bt, xt = field((nf, gc, gc), cdt), field((nf, gc, gc), cdt)
            th, de = thc.to(dtype), dec.to(dtype)

            def kern():
                return st.fused_cheb_smooth(wt, dt_, bt, xt, 3, th, de,
                                            degree, want_residual=True)

            def plain():
                return st._cheb_plain(wt, dt_, bt, xt, 3, th, de, degree,
                                      want_residual=True)

            work = (nbytes(wt, dt_, bt, xt, th, de, bt, bt),
                    cheb_flops(K, bt, 3, True))
            results[f"K3q{degree}"].append(check_row(
                f"K3q{degree}", name, bt.shape, kern(), plain(), kern, plain,
                work, steps=3, degree=degree))
            if degree == 3:
                wd = NARROW_WEIGHTS[name]
                wn, dn = st.narrow_planes(wt, wd), st.narrow_planes(dt_, wd)

                def nkern():
                    return st.fused_cheb_smooth(wn, dn, bt, xt, 3, th, de,
                                                3, want_residual=True,
                                                weight_dtype=wd)

                def nplain():
                    return st._cheb_plain(wn, dn, bt, xt, 3, th, de, 3,
                                          want_residual=True,
                                          weight_dtype=wd)

                results["K3nq3"].append(check_row(
                    "K3nq3", name, bt.shape, nkern(), nplain(), nkern,
                    nplain, (nbytes(wn, dn, bt, xt, th, de, bt, bt),
                             cheb_flops(K, bt, 3, True)),
                    steps=3, degree=3, weight_dtype=wd,
                    full_precision_ms=cuda_ms(kern),
                    full_precision_bound_ms=bound(*work, name)[0]))
                del wn, dn
            del wt, dt_, bt, xt
    made.clear()
    torch.cuda.empty_cache()
    record["kernel_checks_high_degree"] = results
    report(results)
    return results


def stationary_phase(dev, record, card):
    """The small float64 solves on the card against the CPU, then
    ``poisson`` at 256^2 and 2048^2 (float32 and float64) and
    ``poisson_q3`` at 256^2 (float64), each timed with its launches;
    returns their rows."""
    q3_bounds = q3_mass_bounds()
    record["q3_mass_bounds"] = q3_bounds
    st_ = STATIONARY
    check_small_stationary(dev, record, (
        (f"poisson {st_['small_n']}^2",
         lambda d: poisson_problem(st_["small_n"], torch.float64, d),
         True),
        (f"poisson_q3 {st_['small_q3_n']}^2",
         lambda d: poisson_q3_problem(st_["small_q3_n"], torch.float64, d,
                                      q3_bounds)[:2], True),
        (f"P2 triangles {st_['small_tri_n']}^2",
         lambda d: tri_mms_problem(st_["small_tri_n"], torch.float64, d),
         True)))
    rows = {}
    n, big = st_["n"], st_["large_n"]
    for key, size, dtype, max_its in (
            ("poisson", n, "float32", st_["jax_iterations"] + 3),
            ("poisson_f64", n, "float64",
             SOLVER_PARAMETERS["maximum_iterations"]),
            ("poisson_large", big, "float32",
             SOLVER_PARAMETERS["maximum_iterations"]),
            ("poisson_large_f64", big, "float64", None)):
        if max_its is None:
            # multigrid counts stay mesh-independent in float64
            max_its = rows["poisson_f64"]["iterations"] + 2
        suffix = "" if dtype == "float32" else "_f64"
        rows[key] = timed_stationary(
            dev, record, card, key,
            f"poisson_{size}x{size}_kkt_solve{suffix}_cuda",
            lambda d, size=size, dtype=dtype: poisson_problem(
                size, getattr(torch, dtype), d),
            max_its, KEYS_POISSON, dtype)
    rows["poisson_q3"] = timed_stationary(
        dev, record, card, "poisson_q3",
        f"poisson_q3_{st_['q3_n']}x{st_['q3_n']}_kkt_solve_cuda",
        lambda d: poisson_q3_problem(st_["q3_n"], torch.float64, d,
                                     q3_bounds),
        Q3_PARAMETERS["maximum_iterations"], KEYS_Q3, "float64")
    return rows


# ---------------------------------------------------------------------------
# phase 11: hex Q3, K5 and K6 at degree 3 (K = 343)
# ---------------------------------------------------------------------------

# tests/test_solvers3d.py:69's exact pair at degree 3 on 32^3 hexahedra
# (97^3 nodes, 343 weight planes of 2.50 GB per finest-level operator in
# float64) through Control.Stationary(...).linear_solve; heat3d on Q3
# hexahedra, 24^3 cells (73^3 nodes) x 16, float32, ParaDiag defaults
# (8 frequencies: 8.5 GB of complex64 weights per sweep at the finest
# level); the small float64 solves (4^3, 4^3 x 4) held on the card against
# the CPU.  Both take the Jacobi-scaled hex Q3 mass bounds
# (``q3_mass_bounds(3)``): the JAX package's table has hex degrees 1 and 2
# only.  The stationary solve's L2 errors against the exact pair are
# bounded by HEX_Q3["l2_bounds"] (v, zeta): the card's first run gave
# 2.2e-11 and 9.6e-14 (PERF.md), and the bounds leave a factor of 40-100
HEX_Q3 = dict(stationary_n=32, heat_n=24, heat_n_t=16, small_n=4,
              small_n_t=4, heat_max_its=20, l2_bounds=(1e-9, 1e-11))
HEX_STATIONARY_PARAMETERS = {"linear_solver": "fgmres", "fgmres_restart": 10,
                             "maximum_iterations": 100,
                             "relative_tolerance": 1.0e-10,
                             "absolute_tolerance": 0.0,
                             "monitor_convergence": False}
# the small solve: tests/test_solvers3d.py:69's parameters
HEX_SMALL_PARAMETERS = dict(HEX_STATIONARY_PARAMETERS,
                            maximum_iterations=300,
                            relative_tolerance=1.0e-13,
                            absolute_tolerance=1.0e-13)
KEYS_HEX_STATIONARY = ("stencil_apply_3d_q3", "cheb_smooth_3d_real_q3")
KEYS_3D_Q3 = ("stencil_apply_3d_q3", "stencil_apply_3d_tile_q3",
              "cheb_smooth_3d_real_q3", "cheb_smooth_pair_3d_q3")
TOL.update({(k, dt): tol for k, tol32 in (("K6q3", 1e-5), ("K5rq3", 1e-4),
                                          ("K5cq3", 1e-4), ("K5cnq3", 1e-4))
            for dt, tol in (("float64", 1e-12), ("float32", tol32))})


def stationary_hex_problem(n, degree, dtype, device, bounds,
                           parameters=HEX_STATIONARY_PARAMETERS):
    """``tests/test_solvers3d.py:69-121``: hex ``degree`` elements on
    n^3 cells, forward operator -div grad + I, beta = 1e-3, no boundary
    conditions, right-hand sides assembled from the exact pair (v = x e^y
    (1 + z), zeta = sin(pi x) sin(2 pi y) sin(pi z)), so that the discrete
    solution is the interpolated pair itself.  Returns the problem, its
    ``linear_solve`` arguments and the exact pair."""
    from control_tpu_torch import (Control, UnitCubeMesh, FunctionSpace,
                                   Function, TestFunction,
                                   SpatialCoordinate, grad, inner, dx, sin,
                                   exp, pi, assemble)
    mesh = UnitCubeMesh(n, n, n, dtype=dtype, device=device)
    X = SpatialCoordinate(mesh)
    space = FunctionSpace(mesh, "Lagrange", degree)
    test = TestFunction(space)
    beta = 1.0e-3

    def fdo(trial, test, u):
        return inner(grad(trial), grad(test)) * dx + inner(trial, test) * dx

    ctl = Control.Stationary(space, fdo, beta=beta, bcs_v=None)
    v_ref = Function(space).interpolate(X[0] * exp(X[1]) * (1.0 + X[2]))
    zeta_ref = Function(space).interpolate(
        sin(pi * X[0]) * sin(2.0 * pi * X[1]) * sin(pi * X[2]))
    b_0 = assemble(inner(v_ref, test) * dx
                   + inner(grad(zeta_ref), grad(test)) * dx
                   + inner(zeta_ref, test) * dx)
    b_1 = assemble(inner(grad(v_ref), grad(test)) * dx
                   + inner(v_ref, test) * dx
                   - 1.0 / beta * inner(zeta_ref, test) * dx)
    return ctl, dict(lambda_v_bounds=bounds, v_d=b_0, f=b_1,
                     solver_parameters=parameters), (v_ref, zeta_ref)


def heat3d_q3_problem(n, n_t, dtype, device, mode):
    """heat3d on Q3 hexahedra: n^3 cells, (3n + 1)^3 nodes."""
    return heat3d_problem(n, n_t, dtype, device, mode, degree=3)


def check_kernels_hex_q3(dev, record):
    """K6, K5 real and K5 complex at degree 3 (K = 343) against their
    plain versions on the card at the hex Q3 paths' shapes: K6 one
    application on the stationary finest level (1 x 97^3, float64) and on
    heat3d_q3's 15 time steps with shared weights (15 x 73^3, float32);
    K5 real the 20-step smoothing + r on 1 x 97^3 (float64), 10 steps + r
    on 1 x 73^3 (float32) and on the 15 x 73^3 shared-weight batch of
    heat3d_q3's mass solve (float32); K5 complex heat3d_q3's 8 frequencies with
    per-frequency weights, 8 steps + r (the frequency V-cycles' smoothing)
    on 73^3 (complex64) and on 37^3 (complex128, the next level); the
    narrow K5 complex with bfloat16 planes at 8 x 73^3."""
    from control_tpu_torch.ops import stencil as st

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    K = 343
    g_st = 3 * HEX_Q3["stationary_n"] + 1
    g_h = 3 * HEX_Q3["heat_n"] + 1
    nt = HEX_Q3["heat_n_t"] - 1
    nf = nt // 2 + 1
    results = {k: [] for k in ("K6q3", "K5rq3", "K5rq3s", "K5cq3",
                               "K5cnq3")}

    def field(shape, dt):
        a = torch.randn(shape, generator=gen, dtype=dt.to_real(), device=dev)
        if dt.is_complex:
            a = torch.complex(a, torch.randn(shape, generator=gen,
                                             dtype=dt.to_real(), device=dev))
        return a

    def real_rows(g, dtype, n_apply, steps):
        name = str(dtype).split(".")[-1]
        w, dinv, theta, delta = make_stencil_on_card(gen, 1, (g,) * 3,
                                                     False, 3, dev, dtype)
        w, dinv = w[0], dinv[0]
        x = field((n_apply,) + (g,) * 3, dtype)
        results["K6q3"].append(apply_extras(check_row(
            "K6q3", name, x.shape, st.apply_stencil(w, x, 3, nd=3),
            st._apply_plain(w, x, 3, nd=3),
            lambda: st.apply_stencil(w, x, 3, nd=3),
            lambda: st._apply_plain(w, x, 3, nd=3),
            (nbytes(w, x, x), stencil_flops(K, x, 1)),
            plain_repeats=PLAIN_REPEATS_3D), w, x, 3, 3))
        th, de = float(theta[0]), float(delta[0])
        # batch one, and (heat3d_q3's mass solve) the shared-weight batch
        for kname, b in (("K5rq3", x[:1]), ("K5rq3s", x))[:1 + (n_apply > 1)]:
            x0 = torch.zeros_like(b)

            def kern():
                return st.fused_cheb_smooth(w, dinv, b, x0, steps, th, de, 3,
                                            want_residual=True, nd=3)

            def plain():
                return st._cheb_plain(w, dinv, b, x0, steps, th, de, 3,
                                      want_residual=True, nd=3)

            results[kname].append(real_extras(check_row(
                kname, name, b.shape, kern(), plain(), kern, plain,
                (nbytes(w, dinv, b, x0, b, b), cheb_flops(K, b, steps, True)),
                plain_repeats=PLAIN_REPEATS_3D, steps=steps),
                w, dinv, b, x0, steps, th, de, 3, 3, True))

    def complex_rows(g, cdt, narrow):
        rdt = cdt.to_real()
        name = str(rdt).split(".")[-1]
        w, dinv, theta, delta = make_stencil_on_card(gen, nf, (g,) * 3,
                                                     True, 3, dev, rdt)
        b = field((nf,) + (g,) * 3, cdt)
        x0 = field((nf,) + (g,) * 3, cdt)
        steps = 8
        work = (nbytes(w, dinv, b, x0, theta, delta, b, b),
                cheb_flops(K, b, steps, True))

        def kern():
            return st.fused_cheb_smooth(w, dinv, b, x0, steps, theta, delta,
                                        3, want_residual=True, nd=3)

        def plain():
            return st._cheb_plain(w, dinv, b, x0, steps, theta, delta, 3,
                                  want_residual=True, nd=3)

        results["K5cq3"].append(check_row(
            "K5cq3", name, b.shape, kern(), plain(), kern, plain, work,
            plain_repeats=PLAIN_REPEATS_3D, steps=steps))
        if not narrow:
            return
        wd = NARROW_WEIGHTS[name]
        full_ms = results["K5cq3"][-1]["ms"]
        wn, dn = st.narrow_planes(w, wd), st.narrow_planes(dinv, wd)
        del w, dinv

        def nkern():
            return st.fused_cheb_smooth(wn, dn, b, x0, steps, theta, delta,
                                        3, want_residual=True,
                                        weight_dtype=wd, nd=3)

        def nplain():
            return st._cheb_plain(wn, dn, b, x0, steps, theta, delta, 3,
                                  want_residual=True, weight_dtype=wd, nd=3)

        results["K5cnq3"].append(check_row(
            "K5cnq3", name, b.shape, nkern(), nplain(), nkern, nplain,
            (nbytes(wn, dn, b, x0, theta, delta, b, b),
             cheb_flops(K, b, steps, True)),
            plain_repeats=PLAIN_REPEATS_3D, steps=steps, degree=3,
            weight_dtype=wd, full_precision_ms=full_ms,
            full_precision_bound_ms=bound(*work, name)[0]))

    # the stationary path in float64 (first: the rows' numbers in the
    # kernels line), heat3d_q3's in float32
    real_rows(g_st, torch.float64, 1, 20)
    real_rows(g_h, torch.float32, nt, 10)
    complex_rows(g_h, torch.complex64, True)
    complex_rows((g_h + 1) // 2, torch.complex128, False)
    torch.cuda.empty_cache()
    record["kernel_checks_hex_q3"] = results
    report(results)
    return results


RAGGED_BATCHES = (7, 9, 17)
RAGGED_GRIDS = {2: (45, 71), 3: (9, 13, 37)}


def check_kernels_ragged(dev, record):
    """K2 and K5 real on ragged shared-weight batches (n = 7, 9, 17: chunks
    of 8 and 16 with a part-filled last one) at small odd 2-D and 3-D
    grids, degree 1 and 3, 4 steps + r, float64 and float32, against the
    plain version: the random weights at the offsets outside the grid
    are nonzero, so a kernel that fails to mask a neighbour or a padded
    field disagrees."""
    from control_tpu_torch.ops import stencil as st

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    results = {"K2rag": [], "K5rag": []}
    steps = 4
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for nd, grid in RAGGED_GRIDS.items():
            kname = "K2rag" if nd == 2 else "K5rag"
            for degree in (1, 3):
                K = (2 * degree + 1) ** nd
                w, dinv, theta, delta = make_stencil_on_card(
                    gen, 1, grid, False, degree, dev, dtype)
                w, dinv = w[0], dinv[0]
                th, de = float(theta[0]), float(delta[0])
                for n in RAGGED_BATCHES:
                    b = torch.randn((n,) + grid, generator=gen, dtype=dtype,
                                    device=dev)
                    x0 = torch.zeros_like(b)

                    def kern():
                        return st.fused_cheb_smooth(
                            w, dinv, b, x0, steps, th, de, degree,
                            want_residual=True, nd=nd)

                    def plain():
                        return st._cheb_plain(w, dinv, b, x0, steps, th, de,
                                              degree, want_residual=True,
                                              nd=nd)

                    results[kname].append(real_extras(check_row(
                        kname, name, b.shape, kern(), plain(), kern, plain,
                        (nbytes(w, dinv, b, x0, b, b),
                         cheb_flops(K, b, steps, True)), steps=steps,
                        degree=degree), w, dinv, b, x0, steps, th, de,
                        degree, nd, True))
    record["kernel_checks_ragged"] = results
    report(results)
    return results


# ---------------------------------------------------------------------------
# the ParaDiag smoother on stencil pairs
# ---------------------------------------------------------------------------

TOL.update({(k, dt): tol for k in ("K3p", "K5cp", "K5cpq2", "K5cpq3")
            for dt, tol in (("float64", 1e-12), ("float32", 1e-4))})


def pair_flops(K, b, steps, residual):
    """The pair smoother's work on complex fields b: per application,
    frequency and node 8 K flops (W_F x and W_S x, two real-by-complex
    multiply-adds an offset) and 8 to form accF + mu accS; the per-node
    updates as ``cheb_flops``."""
    return ((steps + int(residual)) * b.numel() * (8 * K + 8)
            + steps * b.numel() * 32)


def check_kernels_pair(dev, record):
    """The pair smoother (``fused_cheb_smooth_pair``) against its plain
    twin on the card at the ParaDiag paths' finest shapes, complex64: the
    flagship's 32 frequencies on 257^2 (degree 1, 3 steps + r), heat3d's
    8 on 65^3 (degree 1), heat3d_q2's 8 on 65^3 (degree 2) and heat3d_q3's
    8 on 73^3 (degree 3), 8 steps + r; complex128 on 257^2 and on the next
    coarser 3-D level (33^3, 33^3, 37^3).  A random real pair (W_F
    diagonally dominant), the paths' frequencies mu_k (alpha = 1e-3),
    per-frequency dinv and Gershgorin bounds.  Each row also times the
    per-frequency kernel (``fused_cheb_smooth``, the path's kernel
    before the pair) on the same operator's formed planes
    W_F + mu_k W_S, in turns with the pair (per-frequency, pair, pair,
    per-frequency), with its bound and its error against the twin."""
    from control_tpu_torch.ops import stencil as st

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    results = {k: [] for k in ("K3p", "K5cp", "K5cpq2", "K5cpq3")}

    def uniform(lo, hi, shape, dt):
        u = torch.rand(shape, generator=gen, dtype=dt, device=dev)
        return u.mul_(hi - lo).add_(lo)

    def field(shape, cdt):
        rdt = cdt.to_real()
        return torch.complex(
            torch.randn(shape, generator=gen, dtype=rdt, device=dev),
            torch.randn(shape, generator=gen, dtype=rdt, device=dev))

    def rows(kname, grid, n_rows, degree, steps, cdt):
        rdt = cdt.to_real()
        name = str(rdt).split(".")[-1]
        nd, K = len(grid), (2 * degree + 1) ** len(grid)
        nf = n_rows // 2 + 1
        wF = uniform(0.2, 1.0, (K,) + grid, rdt).mul_(-0.5)
        wF[K // 2] = 4.0 + (K - 9) / 2.0 + uniform(0.0, 1.0, grid, rdt)
        wS = uniform(-0.3, 0.3, (K,) + grid, rdt)
        k = np.arange(nf)
        mu = torch.as_tensor(1e-3 ** (1.0 / n_rows)
                             * np.exp(-2j * np.pi * k / n_rows), dtype=cdt,
                             device=dev)
        per = (-1,) + (1,) * nd
        d = wF[K // 2][None] + mu.reshape(per) * wS[K // 2][None]
        dinv = 1.0 / d
        # Gershgorin: |W_F| + |mu_k| |W_S| bounds |W_F + mu_k W_S|
        rows_ = (wF.abs().sum(0)[None]
                 + mu.abs().reshape(per) * wS.abs().sum(0)[None])
        lam = 1.05 * torch.amax(rows_ / d.abs(), dim=tuple(range(1,
                                                                 nd + 1)))
        theta, delta = 0.5 * (lam + lam / 4.0), 0.5 * (lam - lam / 4.0)
        del d, rows_
        b, x0 = field((nf,) + grid, cdt), field((nf,) + grid, cdt)

        def kern():
            return st.fused_cheb_smooth_pair(wF, wS, mu, dinv, b, x0, steps,
                                             theta, delta, degree,
                                             want_residual=True, nd=nd)

        def plain():
            return st._cheb_pair_plain(wF, wS, mu, dinv, b, x0, steps,
                                       theta, delta, degree,
                                       want_residual=True, nd=nd)

        ref = plain()
        W = wF[None] + mu.reshape((-1,) + (1,) * (nd + 1)) * wS[None]

        def per_frequency():
            return st.fused_cheb_smooth(W, dinv, b, x0, steps, theta, delta,
                                        degree, want_residual=True, nd=nd)

        pf_err = errors(per_frequency(), ref)[1]
        pf1 = cuda_ms(per_frequency)
        row = check_row(
            kname, name, b.shape, kern(), ref, kern, plain,
            (nbytes(wF, wS, mu, dinv, b, x0, theta, delta, b, b),
             pair_flops(K, b, steps, True)),
            plain_repeats=PLAIN_REPEATS_3D if nd == 3 else REPEATS,
            steps=steps, degree=degree, per_frequency_max_rel_err=pf_err)
        pf2 = cuda_ms(per_frequency)
        row.update(per_frequency_ms=0.5 * (pf1 + pf2),
                   per_frequency_bound_ms=bound(
                       nbytes(W, dinv, b, x0, theta, delta, b, b),
                       cheb_flops(K, b, steps, True), name)[0],
                   pair_weight_bytes=nbytes(wF, wS),
                   per_frequency_weight_bytes=nbytes(W))
        results[kname].append(row)
        del W
        torch.cuda.empty_cache()

    g2 = FLAGSHIP["n"] + 1
    g3 = HEAT3D["n"] + 1
    gq2 = 2 * HEAT3D_Q2["n"] + 1
    gq3 = 3 * HEX_Q3["heat_n"] + 1
    for cdt in (torch.complex64, torch.complex128):
        full = cdt == torch.complex64
        rows("K3p", (g2, g2), FLAGSHIP["n_t"] - 1, 1, 3, cdt)
        rows("K5cp", (g3 if full else (g3 + 1) // 2,) * 3,
             HEAT3D["n_t"] - 1, 1, 8, cdt)
        rows("K5cpq2", (gq2 if full else (gq2 + 1) // 2,) * 3,
             HEAT3D_Q2["n_t"] - 1, 2, 8, cdt)
        rows("K5cpq3", (gq3 if full else (gq3 + 1) // 2,) * 3,
             HEX_Q3["heat_n_t"] - 1, 3, 8, cdt)
    record["kernel_checks_pair"] = results
    report(results)
    return results


def hex_q3_phase(dev, record, card):
    """The small float64 solves on the card against the CPU, then
    ``stationary_hex_q3`` at 32^3 (float64, FGMRES(10), rtol 1e-10, budget
    100, its L2 errors bounded) and ``heat3d_q3`` at 24^3 x 16 (float32,
    ParaDiag, GMRES(10), rtol 1e-6, at most 20 iterations), each timed
    with its launches; returns their rows."""
    bounds = q3_mass_bounds(3)
    record["hex_q3_mass_bounds"] = bounds
    hq = HEX_Q3
    n, nt = hq["small_n"], hq["small_n_t"]
    check_small_stationary(dev, record, (
        (f"hex q3 {n}^3",
         lambda d: stationary_hex_problem(
             n, 3, torch.float64, d, bounds, HEX_SMALL_PARAMETERS)[:2],
         True),), key="small_f64_stationary_hex_q3")
    check_small_f64(dev, record, "small_f64_heat3d_q3", (
        (f"q3 {n}^3x{nt}", heat3d_q3_problem, "paradiag", n, nt, bounds),))
    rows = {}
    ns = hq["stationary_n"]
    rows["stationary"] = row = timed_stationary(
        dev, record, card, "stationary_hex_q3",
        f"stationary_hex_q3_{ns}cubed_kkt_solve_f64_cuda",
        lambda d: stationary_hex_problem(ns, 3, torch.float64, d, bounds),
        HEX_STATIONARY_PARAMETERS["maximum_iterations"], KEYS_HEX_STATIONARY,
        "float64")
    if not (row["l2_error_v"] < hq["l2_bounds"][0]
            and row["l2_error_zeta"] < hq["l2_bounds"][1]):
        raise AssertionError(f"stationary_hex_q3 misses the exact pair: "
                             f"{row}")
    torch.cuda.empty_cache()
    nh = hq["heat_n"]
    rows["heat"] = timed_solve(
        dev, record, card, "heat3d_q3",
        f"heat3d_q3_{nh}cubed_nt{hq['heat_n_t']}_kkt_solve_cuda",
        heat3d_q3_problem, (nh, hq["heat_n_t"]), bounds, hq["heat_max_its"],
        KEYS_3D_Q3, carried="cheb_smooth_3d_complex_q3")
    return rows


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
    spills = spilling_functions(ptxas)
    print(f"kernel build + load: {build_s:.2f} s; registers per thread "
          f"{regs}; spilling functions: {len(spills)}", flush=True)
    record["build_s"] = build_s
    if spills:
        # the launch bounds (csrc/cheb_tile.cuh tile_min_blocks) were
        # chosen so that no kernel spills; a spill costs the smoothers up
        # to half their speed
        raise AssertionError(f"ptxas spilled registers in {len(spills)} "
                             f"kernels: {spills}")
    # seconds of each phase since the previous mark (smoke_out's record)
    marks = record["phase_s"] = {}
    last = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        marks[name] = now - last[0]
        last[0] = now

    checks = check_kernels(dev, record)
    lap("kernel_checks")
    pairk = check_kernels_pair(dev, record)
    lap("kernel_checks_pair")
    check_kernels_ragged(dev, record)
    lap("kernel_checks_ragged")
    # the 2-D slice
    check_small_f64(dev, record, "small_f64", (
        ("32^2x8", heat_problem, "paradiag", 32, 8, LAMBDA_2D),
        ("16^2x8", heat_problem, "scan", 16, 8, LAMBDA_2D)))
    flag = timed_solve(dev, record, card, "flagship",
                       "heat_control_256x256_nt64_kkt_solve_cuda",
                       heat_problem, (FLAGSHIP["n"], FLAGSHIP["n_t"]),
                       LAMBDA_2D, 12, KEYS_2D, carried="cheb_smooth_complex")
    scan_once(dev, record, "flagship_scan", heat_problem,
              (FLAGSHIP["n"], FLAGSHIP["n_t"]), LAMBDA_2D)
    lap("2d")
    # the 2-D slice with narrow weight planes
    check_small_f64(dev, record, "small_f64_narrow", (
        ("32^2x8 float32 weights", with_weights(heat_problem, "float32"),
         "paradiag", 32, 8, LAMBDA_2D),
        ("32^2x8 bfloat16 weights", with_weights(heat_problem, "bfloat16"),
         "paradiag", 32, 8, LAMBDA_2D)))
    flag_n = timed_solve(dev, record, card, "flagship_bf16",
                         "heat_control_256x256_nt64_kkt_solve_bf16_cuda",
                         with_weights(heat_problem, WEIGHT_DTYPE),
                         (FLAGSHIP["n"], FLAGSHIP["n_t"]), LAMBDA_2D,
                         SOLVER_PARAMETERS["maximum_iterations"],
                         KEYS_2D_BF16, full_row=flag)
    lap("2d_bf16")
    # the real V-cycles with narrow weight planes (narrow K2, K5 real)
    mg_n = narrow_multigrid(dev, record, card)
    lap("multigrid_bf16")
    # the 3-D slice
    check_small_f64(dev, record, "small_f64_3d", (
        ("8^3x8", heat3d_problem, "paradiag", 8, 8, LAMBDA_3D),
        ("8^3x8", heat3d_problem, "scan", 8, 8, LAMBDA_3D),
        ("8^3x8 bfloat16 weights", with_weights(heat3d_problem, "bfloat16"),
         "paradiag", 8, 8, LAMBDA_3D)))
    h3 = timed_solve(dev, record, card, "heat3d",
                     "heat3d_64cubed_nt16_kkt_solve_cuda", heat3d_problem,
                     (HEAT3D["n"], HEAT3D["n_t"]), LAMBDA_3D, 10, KEYS_3D,
                     carried="cheb_smooth_3d_complex")
    h3n = timed_solve(dev, record, card, "heat3d_bf16",
                      "heat3d_64cubed_nt16_kkt_solve_bf16_cuda",
                      with_weights(heat3d_problem, WEIGHT_DTYPE),
                      (HEAT3D["n"], HEAT3D["n_t"]), LAMBDA_3D,
                      SOLVER_PARAMETERS["maximum_iterations"], KEYS_3D_BF16,
                      full_row=h3, gated=False, full_build=heat3d_problem)
    scan_once(dev, record, "heat3d_scan", heat3d_problem,
              (HEAT3D["scan_n"], HEAT3D["n_t"]), LAMBDA_3D)
    lap("3d")
    # the Stokes slice
    check_small_stokes(dev, record)
    sk = timed_stokes(dev, record, card)
    stokes_float32_history(dev, record, card, sk["residual_history"])
    lap("stokes")
    # the 3-D Stokes slice
    small3 = (STOKES3D["small_n"], STOKES3D["small_n_t"])
    check_small_stokes(dev, record, "small_f64_stokes3d",
                       f"stokes3d scan {small3[0]}^3x{small3[1]}",
                       stokes3d_problem, small3, LAMBDA_STOKES3D)
    s3 = timed_stokes(dev, record, card, "stokes3d",
                      "stokes3d_16cubed_nt8_kkt_solve_cuda",
                      stokes3d_problem, (STOKES3D["n"], STOKES3D["n_t"]),
                      LAMBDA_STOKES3D, KEYS_STOKES3D)
    lap("stokes3d")
    # the Q2 heat slice
    nq, ntq = HEAT3D_Q2["small_n"], HEAT3D_Q2["small_n_t"]
    check_small_f64(dev, record, "small_f64_heat3d_q2", (
        (f"q2 {nq}^3x{ntq}", heat3d_q2_problem, "paradiag", nq, ntq,
         LAMBDA_Q2),
        (f"q2 {nq}^3x{ntq}", heat3d_q2_problem, "scan", nq, ntq,
         LAMBDA_Q2),
        (f"q2 {nq}^3x{ntq} bfloat16 weights",
         with_weights(heat3d_q2_problem, "bfloat16"), "paradiag", nq, ntq,
         LAMBDA_Q2)))
    q2 = timed_solve(dev, record, card, "heat3d_q2",
                     "heat3d_q2_32cubed_nt16_kkt_solve_cuda",
                     heat3d_q2_problem, (HEAT3D_Q2["n"], HEAT3D_Q2["n_t"]),
                     LAMBDA_Q2, SOLVER_PARAMETERS["maximum_iterations"],
                     KEYS_3D_Q2, carried="cheb_smooth_3d_complex_q2")
    q2n = timed_solve(dev, record, card, "heat3d_q2_bf16",
                      "heat3d_q2_32cubed_nt16_kkt_solve_bf16_cuda",
                      with_weights(heat3d_q2_problem, WEIGHT_DTYPE),
                      (HEAT3D_Q2["n"], HEAT3D_Q2["n_t"]), LAMBDA_Q2,
                      SOLVER_PARAMETERS["maximum_iterations"],
                      KEYS_3D_Q2_BF16, full_row=q2, gated=False,
                      full_build=heat3d_q2_problem)
    scan_once(dev, record, "heat3d_q2_scan", heat3d_q2_problem,
              (HEAT3D_Q2["n"], HEAT3D_Q2["n_t"]), LAMBDA_Q2)

    lap("heat3d_q2")
    # backward Euler: small float64 solves on the card against the CPU
    # (histories within 1e-10 of the initial residual: the last entries
    # lie six orders below it, where the two devices' rounding, amplified
    # by 1/eps and 1/alpha, reaches 1e-10 of the entry itself),
    # the flagship ParaDiag (bench.py's BE recipe, GMRES(30), timed) and
    # its GMRES(10) count, the flagship scan in float64 (the reference
    # recipe), heat3d ParaDiag
    check_small_f64(dev, record, "small_f64_be", (
        (f"BE {BE['small_n']}^2x{BE['small_n_t']}", heat_be_problem,
         "paradiag", BE["small_n"], BE["small_n_t"], LAMBDA_2D),
        (f"BE {BE['small_n']}^2x{BE['small_n_t']}", heat_be_problem,
         "scan", BE["small_n"], BE["small_n_t"], LAMBDA_2D),
        (f"BE {HEAT3D_BE['small_n']}^3x{HEAT3D_BE['small_n_t']}",
         heat3d_be_problem, "paradiag", HEAT3D_BE["small_n"],
         HEAT3D_BE["small_n_t"], LAMBDA_3D)), hist_tol=1e-10,
        to_initial=True)
    be = timed_solve(dev, record, card, "flagship_be",
                     "heat_control_be_256x256_nt64_kkt_solve_cuda",
                     heat_be_problem, (BE["n"], BE["n_t"]), LAMBDA_2D,
                     BE_PARAMETERS["maximum_iterations"], KEYS_2D,
                     parameters=BE_PARAMETERS, carried="cheb_smooth_complex")
    be_restart10(dev, record, card, (BE["n"], BE["n_t"]), LAMBDA_2D)
    be_scan_f64(dev, record, card, (BE["n"], BE["n_t"]), LAMBDA_2D,
                BE["scan_its"])
    lap("be_2d")
    h3be = timed_solve(dev, record, card, "heat3d_be",
                       "heat3d_be_64cubed_nt16_kkt_solve_cuda",
                       heat3d_be_problem, (HEAT3D_BE["n"], HEAT3D_BE["n_t"]),
                       LAMBDA_3D, BE_PARAMETERS["maximum_iterations"],
                       KEYS_3D, parameters=BE_PARAMETERS)
    lap("be_3d")
    # stationary control: K1-K3 at degree 3 and 4, then the solves
    high = check_kernels_high_degree(dev, record)
    lap("kernel_checks_high_degree")
    stat = stationary_phase(dev, record, card)
    lap("stationary")
    # hex Q3: K5 and K6 at degree 3, then the two solves
    hexk = check_kernels_hex_q3(dev, record)
    lap("kernel_checks_hex_q3")
    hexq = hex_q3_phase(dev, record, card)
    lap("hex_q3")
    print(f"phase seconds {json.dumps(marks)}", flush=True)

    def row(kname, source, replaces, key, launches, checks_rows,
            dtype="float32"):
        # the numbers of the first shape checked, in the dtype its path
        # runs; the largest error over that dtype's shapes
        rows = [r for r in checks_rows if r["dtype"] == dtype]
        main = rows[0]
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches.get(key, 0),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": None}

    apply_src = "control_tpu_torch/csrc/stencil_apply.cu"
    # K1 and K6 on a shared-weight batch of real fields: the plane tile
    apply_tile_src = "control_tpu_torch/csrc/stencil_apply_tile.cu"

    def per_entry_only(launches, key, tile_key):
        # the K1 / K6 calls of a run that the per-entry kernel ran
        return {key: launches.get(key, 0) - launches.get(tile_key, 0)}

    cheb_src = "control_tpu_torch/csrc/cheb_smooth.cu"
    narrow_src = "control_tpu_torch/csrc/cheb_smooth_narrow.cu"
    vector_src = "control_tpu_torch/csrc/cheb_smooth_vector.cu"
    pair_src = "control_tpu_torch/csrc/cheb_smooth_pair.cu"
    # K2 and K5 real: the plane tile (a shared-weight batch) and the
    # weight ring (one field), csrc/cheb_tile.cuh; with bf16 planes, and
    # on one field of a 2-D degree-1 stencil, the per-entry kernel
    tile_src = "control_tpu_torch/csrc/cheb_smooth_tile.cu"
    fl, hl, sl = flag["launches"], h3["launches"], sk["launches"]
    s3l, ql = s3["launches"], q2["launches"]
    # the per-frequency complex kernels' launches: the same solves from a
    # pc state with per-frequency planes
    fpl, hpl, qpl = (r["per_frequency_state"]["launches"]
                     for r in (flag, h3, q2))
    bepl = be["per_frequency_state"]["launches"]
    hhpl = hexq["heat"]["per_frequency_state"]["launches"]
    fnl, hnl, qnl = (flag_n["launches"], h3n["launches"],
                     q2n["launches"])
    m2l = mg_n["multigrid_2d"]["launches"]
    m3l = mg_n["multigrid_3d"]["launches"]
    bel, h3bel = be["launches"], h3be["launches"]
    q3l = stat["poisson_q3"]["launches"]
    hsl, hhl = hexq["stationary"]["launches"], hexq["heat"]["launches"]
    kernels_line = {"kernels": [
        row("K1 stencil_apply (plane tile, shared-weight batch)",
            apply_tile_src, "control_tpu/ops/stencil.py:206",
            "stencil_apply_tile", fl, checks["K1"]),
        row("K1 stencil_apply (per entry, backward-Euler edge rows, "
            "batch 1)", apply_src, "control_tpu/ops/stencil.py:206",
            "stencil_apply", per_entry_only(bel, "stencil_apply",
                                            "stencil_apply_tile"),
            checks["K1be"]),
        row("K2 cheb_smooth (real)", tile_src,
            "control_tpu/ops/stencil.py:589", "cheb_smooth_real", fl,
            checks["K2"]),
        row("K3 cheb_smooth (complex)", cheb_src,
            "control_tpu/ops/stencil.py:728", "cheb_smooth_complex", fpl,
            checks["K3"]),
        row("K4 cheb_smooth (vector)", vector_src,
            "control_tpu/ops/stencil.py:853", "cheb_smooth_vector", sl,
            checks["K4"], dtype="float64"),
        row("K5 cheb_smooth 3-D (real)", tile_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_real", hl,
            checks["K5r"]),
        row("K5 cheb_smooth 3-D (complex)", cheb_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_complex", hpl,
            checks["K5c"]),
        row("K6 stencil_apply 3-D (plane tile, shared-weight batch)",
            apply_tile_src, "control_tpu/ops/stencil.py:255",
            "stencil_apply_3d_tile", hl, checks["K6"]),
        row("K6 stencil_apply 3-D (per entry, backward-Euler edge rows, "
            "batch 1)", apply_src, "control_tpu/ops/stencil.py:255",
            "stencil_apply_3d", per_entry_only(h3bel, "stencil_apply_3d",
                                               "stencil_apply_3d_tile"),
            checks["K6be"]),
        row("K5 cheb_smooth 3-D (vector)", vector_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_vector", s3l,
            checks["K5v"], dtype="float64"),
        row("K5 cheb_smooth 3-D (real, degree 2)", tile_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_real_q2", ql,
            checks["K5rq2"]),
        row("K5 cheb_smooth 3-D (complex, degree 2)", cheb_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_complex_q2",
            qpl, checks["K5cq2"]),
        row("K6 stencil_apply 3-D (degree 2, plane tile)", apply_tile_src,
            "control_tpu/ops/stencil.py:255", "stencil_apply_3d_tile_q2", ql,
            checks["K6q2"]),
        row("K3 cheb_smooth (complex, bf16 weights)", narrow_src,
            "control_tpu/ops/stencil.py:728", "cheb_smooth_complex_bf16",
            fnl, checks["K3n"]),
        row("K5 cheb_smooth 3-D (complex, bf16 weights)", narrow_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_complex_bf16",
            hnl, checks["K5cn"]),
        row("K5 cheb_smooth 3-D (complex, degree 2, bf16 weights)",
            narrow_src, "control_tpu/ops/stencil.py:1090",
            "cheb_smooth_3d_complex_q2_bf16", qnl, checks["K5cnq2"]),
        # the multigrid path's one field first, then the shared-weight
        # batch
        row("K2 cheb_smooth (real, bf16 weights)", narrow_src,
            "control_tpu/ops/stencil.py:589", "cheb_smooth_real_bf16", m2l,
            checks["K2n1"] + checks["K2n"]),
        row("K5 cheb_smooth 3-D (real, bf16 weights)", narrow_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_real_bf16",
            m3l, checks["K5rn1"] + checks["K5rn"]),
        row("K2 cheb_smooth (real, backward-Euler edge rows, batch 1)",
            cheb_src, "control_tpu/ops/stencil.py:589", "cheb_smooth_real",
            bel, checks["K2be"]),
        row("K3 cheb_smooth (complex, backward-Euler interior)", cheb_src,
            "control_tpu/ops/stencil.py:728", "cheb_smooth_complex", bepl,
            checks["K3be"]),
        row("K5 cheb_smooth 3-D (real, backward-Euler edge rows, batch 1)",
            tile_src, "control_tpu/ops/stencil.py:1090",
            "cheb_smooth_3d_real", h3bel, checks["K5rbe"]),
        row("K1 stencil_apply (degree 3)", apply_src,
            "control_tpu/ops/stencil.py:206", "stencil_apply_q3", q3l,
            high["K1q3"], dtype="float64"),
        row("K2 cheb_smooth (real, degree 3)", tile_src,
            "control_tpu/ops/stencil.py:589", "cheb_smooth_real_q3", q3l,
            high["K2q3"], dtype="float64"),
        row("K3 cheb_smooth (complex, degree 3)", cheb_src,
            "control_tpu/ops/stencil.py:728", "cheb_smooth_complex_q3", q3l,
            high["K3q3"]),
        row("K1 stencil_apply (degree 4)", apply_src,
            "control_tpu/ops/stencil.py:206", "stencil_apply_q4", q3l,
            high["K1q4"], dtype="float64"),
        row("K2 cheb_smooth (real, degree 4)", tile_src,
            "control_tpu/ops/stencil.py:589", "cheb_smooth_real_q4", q3l,
            high["K2q4"], dtype="float64"),
        row("K3 cheb_smooth (complex, degree 4)", cheb_src,
            "control_tpu/ops/stencil.py:728", "cheb_smooth_complex_q4", q3l,
            high["K3q4"]),
        row("K3 cheb_smooth (complex, degree 3, bf16 weights)", narrow_src,
            "control_tpu/ops/stencil.py:728", "cheb_smooth_complex_q3_bf16",
            q3l, high["K3nq3"]),
        row("K6 stencil_apply 3-D (degree 3, per entry, batch 1)",
            apply_src, "control_tpu/ops/stencil.py:255",
            "stencil_apply_3d_q3",
            per_entry_only(hsl, "stencil_apply_3d_q3",
                           "stencil_apply_3d_tile_q3"),
            hexk["K6q3"], dtype="float64"),
        row("K6 stencil_apply 3-D (degree 3, plane tile, shared-weight "
            "batch)", apply_tile_src, "control_tpu/ops/stencil.py:255",
            "stencil_apply_3d_tile_q3", hhl, hexk["K6q3"]),
        row("K5 cheb_smooth 3-D (real, degree 3)", tile_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_real_q3", hsl,
            hexk["K5rq3"], dtype="float64"),
        row("K5 cheb_smooth 3-D (real, degree 3, shared-weight batch)",
            tile_src, "control_tpu/ops/stencil.py:1090",
            "cheb_smooth_3d_real_q3", hhl, hexk["K5rq3s"]),
        row("K5 cheb_smooth 3-D (complex, degree 3)", cheb_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_3d_complex_q3",
            hhpl, hexk["K5cq3"]),
        row("K5 cheb_smooth 3-D (complex, degree 3, bf16 weights)",
            narrow_src, "control_tpu/ops/stencil.py:1090",
            "cheb_smooth_3d_complex_q3_bf16", hhl, hexk["K5cnq3"]),
        row("K3 cheb_smooth_pair (complex, stencil pair)", pair_src,
            "control_tpu/ops/stencil.py:728", "cheb_smooth_pair_2d", fl,
            pairk["K3p"]),
        row("K5 cheb_smooth_pair 3-D (complex, stencil pair)", pair_src,
            "control_tpu/ops/stencil.py:1090", "cheb_smooth_pair_3d", hl,
            pairk["K5cp"]),
        row("K5 cheb_smooth_pair 3-D (complex, stencil pair, degree 2)",
            pair_src, "control_tpu/ops/stencil.py:1090",
            "cheb_smooth_pair_3d_q2", ql, pairk["K5cpq2"]),
        row("K5 cheb_smooth_pair 3-D (complex, stencil pair, degree 3)",
            pair_src, "control_tpu/ops/stencil.py:1090",
            "cheb_smooth_pair_3d_q3", hhl, pairk["K5cpq3"]),
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

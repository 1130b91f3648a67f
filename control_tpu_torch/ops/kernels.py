"""Build and bind the hand-written Hopper kernels in ``control_tpu_torch/csrc``.

The sources compile with ``nvcc`` for ``sm_90a`` (one compiler process per
source, all started together) and link into one shared library with a plain
C interface, loaded with ``ctypes``.  The library is built at
first use into ``control_tpu_torch/_build/`` (git-ignored), named by a hash
of the sources, so an edited source is never served a stale build.  Nothing
here runs at import: the CPU tests import every module on machines with no
``nvcc`` and no card.

Each binding takes device pointers and PyTorch's current CUDA stream; the C
entry point returns ``cudaGetLastError()`` after its launches, and the
wrappers here raise on any non-zero code.  There is no fallback: a CUDA
tensor either runs its kernel or the call raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("stencil_apply.cu", "cheb_smooth.cu", "cheb_smooth_narrow.cu",
           "cheb_smooth_vector.cu", "cheb_smooth_pair.cu",
           "cheb_smooth_tile.cu", "cheb_smooth_tile_narrow.cu")
HEADERS = ("field_ops.cuh", "cheb_smooth.cuh", "cheb_tile.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# dtype codes shared with the C entry points
DTYPE_CODES = {torch.float32: 0, torch.float64: 1,
               torch.complex64: 2, torch.complex128: 3}
# storage codes of narrow weight planes (``cheb_smooth_narrow``); complex
# fields read (re, im) pairs of the same type
WEIGHT_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _source_hash():
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path():
    return BUILD_DIR / f"libcontrol_kernels_{_source_hash()}.so"


def build(verbose=False):
    """Compile the kernel library if it is not built yet; return its path
    and the compiler's output (with ``verbose``, ptxas's register and
    spill report per kernel; empty when the library was already built).

    Every source compiles to an object file in a process of its own, all
    running at once; one more ``nvcc`` call links them.  The work happens
    in a temporary directory and the library is renamed into place, so
    concurrent builds never load a half-written library."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-I", str(CSRC)]
    if verbose:
        flags += ["-Xptxas", "-v"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *flags, "-c", str(CSRC / s), "-o", o],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [f"{s}:\n{log}" for s, proc, log
                  in zip(SOURCES, procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        os.replace(lib, out)
    return out, "".join(logs)


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # (..., n, nz, ny, nx, nd, degree[, steps], stream)
        lib.stencil_apply.argtypes = [i32, vp, i64, vp, vp, i32, i32, i32,
                                      i32, i32, i32, vp]
        lib.stencil_apply.restype = i32
        lib.cheb_smooth.argtypes = [i32, vp, i64, vp, i64, vp, vp, vp, vp,
                                    i32, vp, vp, vp, vp, i32, i32, i32, i32,
                                    i32, i32, i32, vp]
        lib.cheb_smooth.restype = i32
        # (dtype, wdtype, then as cheb_smooth)
        lib.cheb_smooth_narrow.argtypes = [i32, i32, vp, i64, vp, i64, vp,
                                           vp, vp, vp, i32, vp, vp, vp, vp,
                                           i32, i32, i32, i32, i32, i32, i32,
                                           vp]
        lib.cheb_smooth_narrow.restype = i32
        # (..., th_stride, coef, x_out, x_tmp, p, r, n, ny, nx, degree,
        # steps, stream)
        lib.cheb_smooth_vector.argtypes = [i32, vp, i64, vp, i64, vp, vp,
                                           vp, vp, i32, vp, vp, vp, vp, vp,
                                           i32, i32, i32, i32, i32, vp]
        lib.cheb_smooth_vector.restype = i32
        # (..., n, nz, ny, nx, degree, steps, stream)
        lib.cheb_smooth_vector3d.argtypes = [i32, vp, i64, vp, i64, vp, vp,
                                             vp, vp, i32, vp, vp, vp, vp, vp,
                                             i32, i32, i32, i32, i32, i32,
                                             vp]
        lib.cheb_smooth_vector3d.restype = i32
        # (dtype, wF, wS, mu, dinv, d_bstride, b, x0, theta, delta,
        # th_stride, x_out, x_tmp, p, r, n, nz, ny, nx, nd, degree, steps,
        # stream)
        lib.cheb_smooth_pair.argtypes = [i32, vp, vp, vp, vp, i64, vp, vp,
                                         vp, vp, i32, vp, vp, vp, vp, i32,
                                         i32, i32, i32, i32, i32, i32, vp]
        lib.cheb_smooth_pair.restype = i32
        # (dtype, wdtype (-1: the field dtype), nb, w, dinv, d_bstride, b,
        # x0, theta, delta, th_stride, x_out, x_tmp, p, r, n, nz, ny, nx,
        # nd, degree, steps, stream)
        lib.cheb_smooth_tile.argtypes = [i32, i32, i32, vp, vp, i64, vp, vp,
                                         vp, vp, i32, vp, vp, vp, vp, i32,
                                         i32, i32, i32, i32, i32, i32, vp]
        lib.cheb_smooth_tile.restype = i32
        _lib = lib
    return _lib


def check(code, what):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({torch.cuda.get_device_name()})")


def stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream

"""Build and bind the hand-written Hopper kernels in ``control_tpu_torch/csrc``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``.  The library is built at
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
SOURCES = ("stencil_apply.cu", "cheb_smooth.cu")
HEADERS = ("field_ops.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# dtype codes shared with the C entry points
DTYPE_CODES = {torch.float32: 0, torch.float64: 1,
               torch.complex64: 2, torch.complex128: 3}

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

    The compiler writes to a temporary file that is renamed into place, so
    concurrent builds never load a half-written library."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", tmp]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += [str(CSRC / s) for s in SOURCES]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


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
        _lib = lib
    return _lib


def check(code, what):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({torch.cuda.get_device_name()})")


def stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream

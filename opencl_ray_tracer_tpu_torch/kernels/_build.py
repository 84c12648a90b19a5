"""Build and load the CUDA kernels: nvcc into a shared library, ctypes to call.

The library is compiled on first use from the sources in `csrc/` into
`kernels/build/` (listed in .gitignore), named by a hash of the sources,
their headers and the nvcc flags, so an edited source or flag builds anew
and an unchanged one loads the existing file. Each source compiles to an
object in its own nvcc process, all started together, and one more nvcc
call links them. The C entry points take plain pointers, ints and the CUDA
stream, so no PyTorch header is compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from opencl_ray_tracer_tpu_torch.utils import tracing

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "build")
SOURCES = ("fwd_tiled.cu", "fwd_brute.cu", "soft_tiled.cu", "soft_brute.cu",
           "graph_cond.cu", "bin_tiled.cu")
HEADERS = ("soft_tiled.cuh", "tile_list.cuh")

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# No --use_fast_math; -fmad=false keeps every product/sum rounded once, as in
# the float32 plain twins (see the notes at the top of the csrc/ sources).
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
    "-Xptxas", "-v",
)

_LIB = None
BUILD_LOG = ""       # nvcc/ptxas output of the build this process ran


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"liboctrt_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Run the commands at once; raise with the output of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{log}")
    return "".join(logs)


def build() -> str:
    """Compile the library unless a build of these sources exists; the
    build's wall time adds to the counter `kernels.build_s`
    (`utils.tracing`)."""
    global BUILD_LOG
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.splitext(s)[0]}.{tag}.o")
            for s in SOURCES]
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(SRC_DIR, s)]
                    for s, o in zip(SOURCES, objs)])
    tmp = f"{path}.{tag}"
    log += _run_all([[nvcc, *_ARCH, "-shared", "-o", tmp, *objs]])
    for o in objs:
        os.remove(o)
    os.replace(tmp, path)
    tracing.count("kernels.build_s", time.perf_counter() - t0)
    BUILD_LOG = log
    return path


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.octrt_fwd_tiled.restype = i
        lib.octrt_fwd_tiled.argtypes = [ptr] * 10 + [i] * 13 + [ptr, i, ptr, ptr]
        lib.octrt_bin_tiled.restype = i
        lib.octrt_bin_tiled.argtypes = [ptr] * 24 + [i] * 16 + [ptr]
        lib.octrt_bin_soft.restype = i
        lib.octrt_bin_soft.argtypes = [ptr] * 22 + [i] * 16 + [ptr]
        lib.octrt_gather_tiled.restype = i
        lib.octrt_gather_tiled.argtypes = [ptr] * 24 + [i] * 7 + [ptr]
        lib.octrt_soft_tiled_fwd.restype = i
        lib.octrt_soft_tiled_fwd.argtypes = [ptr] * 12 + [i] * 12 + [ptr, i, ptr]
        lib.octrt_soft_tiled_bwd.restype = i
        lib.octrt_soft_tiled_bwd.argtypes = [ptr] * 20 + [i] * 12 + [ptr]
        lib.octrt_fwd_brute.restype = i
        lib.octrt_fwd_brute.argtypes = [ptr] * 8 + [i] * 10 + [ptr, i, ptr, ptr]
        lib.octrt_soft_brute_fwd.restype = i
        lib.octrt_soft_brute_fwd.argtypes = [ptr] * 8 + [i] * 10 + [ptr, i, ptr]
        lib.octrt_soft_brute_bwd.restype = i
        lib.octrt_soft_brute_bwd.argtypes = [ptr] * 16 + [i] * 10 + [ptr]
        lib.octrt_cond_handles.restype = i
        lib.octrt_cond_handles.argtypes = [ptr, ptr, ptr, ptr]
        lib.octrt_cond_begin_body.restype = i
        lib.octrt_cond_begin_body.argtypes = [ctypes.c_ulonglong, ptr, ptr]
        lib.octrt_cond_end_body.restype = i
        lib.octrt_cond_end_body.argtypes = [ptr]
        lib.octrt_body_stream.restype = i
        lib.octrt_body_stream.argtypes = [ptr]
        lib.octrt_cuda_error_string.restype = ctypes.c_char_p
        lib.octrt_cuda_error_string.argtypes = [i]
        _LIB = lib
    return _LIB

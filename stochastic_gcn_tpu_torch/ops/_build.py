"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with ``nvcc`` into a shared library
with a plain C interface and loaded with :mod:`ctypes` — no PyTorch
headers, so the build takes seconds.  ``spmm.cu`` is compiled once per
part (``-DSGT_PART``: the gathers, the CV delta, the backward), the parts'
``nvcc`` processes side by side, and the objects linked into one library.  The library lands in
``stochastic_gcn_tpu_torch/_build/`` (git-ignored) under a name that hashes
the sources and flags, so an edited source is never served a stale build.

Nothing here runs at import time: the CPU test-suite imports every module
on machines that have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "spmm.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
PARTS = (1, 2, 3)     # SGT_PART of each source's compiles (csrc/spmm.cu)

# (name, argtypes) of every extern "C" entry point; each returns an int,
# the cudaError_t of its launch (the plans: a split)
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# (table, dtype, rows, d, idx, w, n_out, k, out, stream)
_GATHER_ARGS = [_P, _I, _I64, _I, _P, _P, _I, _I, _P, _P]
# (x, dtype, c, d, pos, w, ends or NULL, n_out, k, out, stream)
_FANOUT_ARGS = [_P, _I, _I64, _I, _P, _P, _P, _I, _I, _P, _P]
# (g, pos, w, ends or NULL, n_out, k, c, d, grad_x, stream)
_BACKWARD_ARGS = [_P, _P, _P, _P, _I, _I, _I64, _I, _P, _P]
# (x, c, d, hist, hist_dtype, hist_rows, field_in, sentinel, pos, w, n_out,
#  k, base, out, stream)
_CV_ARGS = [_P, _I64, _I, _P, _I, _I64, _P, _I64, _P, _P, _I, _I, _P, _P, _P]
_ENTRY_POINTS = {
    "sgt_hbm_gather_aggregate": _GATHER_ARGS,
    "sgt_fanout_aggregate": _FANOUT_ARGS,
    "sgt_gather_aggregate_split": _GATHER_ARGS + [_I],  # split
    "sgt_gather_plan": [_I, _I, _I, _I],                # dtype, d, n_out, k
    "sgt_backward_plan": [_I, _I],                      # n_out, k
    "sgt_cv_fanout_aggregate": _CV_ARGS,
    "sgt_fanout_aggregate_backward": _BACKWARD_ARGS,
    "sgt_empty": [_P],                                  # stream
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (searched PATH and $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def build() -> tuple[Path, float, str]:
    """Compile the sources if no matching library exists.

    Returns (library path, build seconds — 0.0 when reused, the compiler's
    output including ``-Xptxas -v`` register and spill counts)."""
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(repr(PARTS).encode())
    lib = BUILD_DIR / f"libsgt_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [lib.with_suffix(f".{os.getpid()}.{i}.o")
            for i in range(len(SOURCES) * len(PARTS))]
    cmds = [[nvcc, *NVCC_FLAGS, f"-DSGT_PART={part}", "-c", "-o", str(obj),
             str(src)]
            for obj, (src, part) in zip(
                objs, ((src, part) for src in SOURCES for part in PARTS))]
    cmds.append([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)])
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds[:-1]]
        runs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, proc in zip(cmds, procs)]
        if all(rc == 0 for _, _, rc in runs):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            runs.append((cmds[-1], link.stdout + link.stderr,
                         link.returncode))
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    for cmd, out, rc in runs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, lib)      # atomic: concurrent builds publish whole files
    return lib, seconds, "".join(out for _, out, _ in runs)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def entry(name: str):
    """The bound C function ``name``, resolved once per process."""
    return getattr(library(), name)

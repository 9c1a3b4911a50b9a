"""Build and load the port's CUDA kernels (`vstrains_tpu_torch/csrc/`).

nvcc compiles every `csrc/*.cu` into one shared library with a plain C
interface, for sm_90a (Hopper), at first use: one compiler process per
source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<source>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> <objs>

The library lands in `build/vstrains_tpu_torch/` beside the package (a
directory `.gitignore` lists), named by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one is reused. The
compiler writes a temporary name first and `os.replace` moves it into
place, so a concurrent process never loads a half-written library.
Nothing here runs at import time: the CPU tests import this module on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "vstrains_tpu_torch")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libvt_kernels_{source_hash()}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def build() -> dict:
    """Compile the kernels unless a library for these sources exists.
    Returns {"path", "seconds", "built", "log"}; raises on a failed
    build with the compiler's output."""
    path = library_path()
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "built": False, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = f"{path}.tmp{tag}"
    cu = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{path}.{os.path.basename(p)}.{tag}.o" for p in cu]
    nvcc = _nvcc()
    t0 = time.time()
    procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c",
                                "-o", obj, src], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True), src)
             for src, obj in zip(cu, objs)]
    logs, failed = [], []
    for proc, src in procs:
        out = proc.communicate()[0]
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    if not failed:
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    seconds = time.time() - t0
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    log = "".join(logs)
    if failed:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    os.replace(tmp, path)
    with open(path + ".log", "w") as fh:
        fh.write(log)
    return {"path": path, "seconds": seconds, "built": True, "log": log}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    sigs = {
        "vt_window_hashes_wire": [p, *[i64] * 8, p, p, p, p],
        "vt_window_hashes_bytes": [p, p, *[i64] * 7, p, p, p, p],
        "vt_stats_accum": [p, i64, i64, i64, i64, p, p, p],
        "vt_stats_accum_uses_shared": [i64],
        "vt_pair_counts": [p, p, i64, i64, p, i64, p, i64, i64, p, p, p,
                           p],
        "vt_sort_rows": [p, p, i64, i64, p, p, p, p],
        "vt_sort_rows_uses_network": [i64],
        "vt_sort_cols": [p, i64, i64, p, p],
        "vt_dup_stats": [*[p] * 5, *[i64] * 5, p, p, p],
        "vt_dup_scan": [*[p] * 5, *[i64] * 4, p, p, p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per
    process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(build()["path"]))
        return _LIB

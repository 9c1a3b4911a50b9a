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

`Prefetch` builds and loads the library on a background thread, so that
a cold build overlaps the host work a run does before its first kernel
call; its `join` re-raises the build's error.
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
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "vstrains_tpu_torch")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LOADED: Optional[dict] = None  # build()'s record of the library in _LIB


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


def _compile(nvcc: str, src: str, obj: str):
    t0 = time.time()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o",
                           obj, src], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc, time.time() - t0


def build() -> dict:
    """Compile the kernels unless a library for these sources exists.
    Returns {"path", "seconds", "built", "log", "source_seconds"} (each
    source's nvcc seconds; empty when the library was reused); raises on
    a failed build with the compiler's output."""
    path = library_path()
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "built": False, "log": "",
                "source_seconds": {}}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = f"{path}.tmp{tag}"
    cu = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{path}.{os.path.basename(p)}.{tag}.o" for p in cu]
    nvcc = _nvcc()
    t0 = time.time()
    # one thread a source, so that every nvcc starts at once and each
    # source's seconds end when its own compiler does
    with ThreadPoolExecutor(len(cu)) as pool:
        runs = list(pool.map(_compile, [nvcc] * len(cu), cu, objs))
    logs, failed, source_seconds = [], [], {}
    for src, (proc, sec) in zip(cu, runs):
        name = os.path.basename(src)
        source_seconds[name] = sec
        logs.append(f"== {name}\n{proc.stdout}")
        if proc.returncode != 0:
            failed.append(name)
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
    return {"path": path, "seconds": seconds, "built": True, "log": log,
            "source_seconds": source_seconds}


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
        "vt_coo_accum": [p, i64, i64, i64, i64, p, i64, p, i64, p, p, p],
        "vt_coo_rehash": [p, i64, p, i64, p, p],
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
    global _LIB, _LOADED
    with _LOCK:
        if _LIB is None:
            info = build()
            _LIB = _bind(ctypes.CDLL(info["path"]))
            _LOADED = info
        return _LIB


def loaded_info() -> Optional[dict]:
    """build()'s record of the library this process loaded, or None."""
    return _LOADED


class Prefetch:
    """`load()` on a background thread, started here when `device` is a
    CUDA device (on the CPU nothing starts and nothing is built), so that
    a cold nvcc build overlaps the host work before the first kernel
    call. The thread compiles and loads the library and launches
    nothing. `join()` waits for it, adds the wait to `wait_seconds` and
    re-raises its exception: a failed build fails the caller with nvcc's
    output, before any kernel call builds again. Leaving it as a context
    manager waits for the thread and drops its result (the caller has
    joined, or is failing for another reason), so no build outlives its
    caller."""

    def __init__(self, device):
        self.wait_seconds = 0.0
        self._exc: Optional[Exception] = None
        self._thread: Optional[threading.Thread] = None
        self._started = torch.device(device).type == "cuda"
        self._preloaded = _LIB is not None
        if self._started:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="vt-kernel-build")
            self._thread.start()

    def _run(self) -> None:
        try:
            load()
        except Exception as exc:  # re-raised on the caller's thread
            self._exc = exc

    def join(self) -> None:
        if self._thread is not None:
            t0 = time.time()
            self._thread.join()
            self.wait_seconds += time.time() - t0
            self._thread = None
        exc, self._exc = self._exc, None
        if exc is not None:
            raise exc

    def __enter__(self) -> "Prefetch":
        return self

    def __exit__(self, *exc) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def report(self) -> Optional[str]:
        """One line for the log: the library, whether this run built it
        or found it, the build's seconds and the caller's wait; None
        when nothing was started."""
        if not self._started:
            return None
        info = loaded_info()
        if self._preloaded:
            how = "already loaded in this process"
        elif info is None:
            how = "not loaded"
        elif info["built"]:
            slow = max(info["source_seconds"],
                       key=info["source_seconds"].get)
            how = (f"built this run in {info['seconds']:.3f} s (slowest "
                   f"source {slow}: {info['source_seconds'][slow]:.3f} s)")
        else:
            how = "reused (built by an earlier run)"
        path = info["path"] if info else library_path()
        return (f"CUDA kernel library {path}: {how}; waited "
                f"{self.wait_seconds:.3f} s for it")

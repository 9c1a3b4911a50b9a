"""Native (C++) host-side components, built on demand with g++ and loaded
via ctypes. Falls back to pure Python silently when no toolchain exists."""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

_LOG = logging.getLogger(__name__)
_DIR = os.path.dirname(os.path.abspath(__file__))
_SO_PATH = os.path.join(_DIR, "libfastq.so")
_LIB = None
_TRIED = False


def _build() -> bool:
    src = os.path.join(_DIR, "fastq_reader.cpp")
    if not os.path.exists(src):
        return False
    if (os.path.exists(_SO_PATH)
            and os.path.getmtime(_SO_PATH) >= os.path.getmtime(src)):
        return True
    for flags in (["-O3", "-fopenmp"], ["-O3"]):
        tmp = f"{_SO_PATH}.tmp{os.getpid()}"  # then moved into place
        cmd = ["g++", *flags, "-shared", "-fPIC", "-o", tmp, src,
               "-lz"]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, _SO_PATH)
            return True
        except Exception as e:  # try next flag set
            _LOG.debug("native build failed (%s): %s", flags, e)
    return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        if not _build():
            return None
        lib = ctypes.CDLL(_SO_PATH)
        lib.fq_open.restype = ctypes.c_void_p
        lib.fq_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_int64]
        for fn in ["fq_num_pairs", "fq_n_reads", "fq_short_reads",
                   "fq_max_flen", "fq_max_rlen"]:
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.fq_fill.restype = None
        lib.fq_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64]
        lib.fq_close.restype = None
        lib.fq_close.argtypes = [ctypes.c_void_p]
        try:  # absent in pre-wire builds of the .so
            lib.wire_pack.restype = ctypes.c_int64
            lib.wire_pack.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
        except AttributeError:
            pass
        _LIB = lib
    except Exception as e:
        _LOG.debug("native lib unavailable: %s", e)
        _LIB = None
    return _LIB


_TBL_SO_PATH = os.path.join(_DIR, "libtable.so")
_TBL_LIB = None
_TBL_TRIED = False


def _build_table_lib() -> bool:
    src = os.path.join(_DIR, "table_build.cpp")
    if not os.path.exists(src):
        return False
    if (os.path.exists(_TBL_SO_PATH)
            and os.path.getmtime(_TBL_SO_PATH) >= os.path.getmtime(src)):
        return True
    tmp = f"{_TBL_SO_PATH}.tmp{os.getpid()}"  # then moved into place
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", tmp, src]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _TBL_SO_PATH)
        return True
    except Exception as e:
        _LOG.debug("native table lib build failed: %s", e)
        return False


def get_table_lib() -> Optional[ctypes.CDLL]:
    global _TBL_LIB, _TBL_TRIED
    if _TBL_TRIED:
        return _TBL_LIB
    _TBL_TRIED = True
    try:
        if not _build_table_lib():
            return None
        lib = ctypes.CDLL(_TBL_SO_PATH)
        lib.tb_build.restype = ctypes.c_int64
        lib.tb_build.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),   # ascii
            ctypes.POINTER(ctypes.c_int64),   # starts
            ctypes.POINTER(ctypes.c_int32),   # lens
            ctypes.POINTER(ctypes.c_int32),   # ids
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32),  # h1 out
            ctypes.POINTER(ctypes.c_uint32),  # h2 out
            ctypes.POINTER(ctypes.c_int32),   # node out
            ctypes.POINTER(ctypes.c_int32),   # offset out
            ctypes.c_int64,                   # cap
            ctypes.POINTER(ctypes.c_int64)]   # max_dup out
        _TBL_LIB = lib
    except Exception as e:
        _LOG.debug("native table lib unavailable: %s", e)
        _TBL_LIB = None
    return _TBL_LIB


def build_table_entries_native(seqs, split_len: int):
    """C++ fast path of the hash+sort phases of build_kmer_table.

    Returns (h1, h2, node, offset, max_dup) — sorted exactly as the numpy
    path sorts (lexicographic (packed key, node, offset)) — or None when
    the native library is unavailable or no node is long enough (the
    caller's numpy path handles the trivial case)."""
    import numpy as np

    lib = get_table_lib()
    if lib is None:
        return None
    parts = []
    ids = []
    lens = []
    for i, s in enumerate(seqs):
        n = len(s)
        if n < split_len:
            continue
        parts.append(s.encode("ascii") if isinstance(s, str) else bytes(s))
        ids.append(i)
        lens.append(n)
    if not ids:
        return None
    cat = b"".join(parts)
    lens_a = np.asarray(lens, np.int32)
    ids_a = np.asarray(ids, np.int32)
    starts = np.zeros(len(ids), np.int64)
    np.cumsum(lens_a[:-1], out=starts[1:])
    cap = int(2 * (lens_a.astype(np.int64) - split_len + 1).sum())
    h1 = np.empty(cap, np.uint32)
    h2 = np.empty(cap, np.uint32)
    node = np.empty(cap, np.int32)
    offset = np.empty(cap, np.int32)
    max_dup = ctypes.c_int64(0)
    cat_a = np.frombuffer(cat, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    nthreads = min(8, os.cpu_count() or 4)
    m = lib.tb_build(
        cat_a.ctypes.data_as(u8p), starts.ctypes.data_as(i64p),
        lens_a.ctypes.data_as(i32p), ids_a.ctypes.data_as(i32p),
        len(ids), split_len, nthreads,
        h1.ctypes.data_as(u32p), h2.ctypes.data_as(u32p),
        node.ctypes.data_as(i32p), offset.ctypes.data_as(i32p),
        cap, ctypes.byref(max_dup))
    if m < 0:
        return None
    return (h1[:m].copy(), h2[:m].copy(), node[:m].copy(),
            offset[:m].copy(), int(max_dup.value) if m else 1)


def load_read_pairs_native(fwd_path: str, rve_path: str, split_len: int,
                           pad_to_multiple: int = 1):
    """C++ fast path of core.fastq.load_read_pairs; returns None if the
    native library is unavailable."""
    import numpy as np

    from vstrains_tpu_torch.core.fastq import ReadPairBatch

    lib = get_lib()
    if lib is None:
        return None
    h = lib.fq_open(fwd_path.encode(), rve_path.encode(), split_len)
    if not h:
        return None
    try:
        n = lib.fq_num_pairs(h)
        tf = int(lib.fq_max_flen(h))
        tr = int(lib.fq_max_rlen(h))
        if pad_to_multiple > 1:
            if tf % pad_to_multiple:
                tf += pad_to_multiple - tf % pad_to_multiple
            if tr % pad_to_multiple:
                tr += pad_to_multiple - tr % pad_to_multiple
        fwd_codes = np.empty((n, tf), dtype=np.uint8)
        rve_codes = np.empty((n, tr), dtype=np.uint8)
        fwd_len = np.empty(n, dtype=np.int32)
        rve_len = np.empty(n, dtype=np.int32)
        if n > 0:
            lib.fq_fill(
                h,
                fwd_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                fwd_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                rve_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                rve_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                tf, tr)
        return ReadPairBatch(fwd_codes, fwd_len, rve_codes, rve_len,
                             int(lib.fq_n_reads(h)),
                             int(lib.fq_short_reads(h)), int(n))
    finally:
        lib.fq_close(h)

def wire_pack_native(fc, fl, rc, rl, T: int):
    """C++ fast path of ops.pe_infer._pack_wire_np with the in-read
    bad-code check fused in. Returns the packed uint8 [B, W] array, or
    None when the batch holds a non-ACGT code inside a read (caller
    must fall back to the byte feed) or the library is unavailable.

    Distinguish the two None cases with get_lib() when it matters.
    """
    import numpy as np

    lib = get_lib()
    if lib is None or not hasattr(lib, "wire_pack"):
        return None
    B = fc.shape[0]
    T4 = -(-T // 4)
    out = np.empty((B, 2 * T4 + 4), dtype=np.uint8)
    fc = np.ascontiguousarray(fc)
    rc = np.ascontiguousarray(rc)
    fl = np.ascontiguousarray(fl, dtype=np.int32)
    rl = np.ascontiguousarray(rl, dtype=np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc_ok = lib.wire_pack(
        fc.ctypes.data_as(u8p), fl.ctypes.data_as(i32p),
        rc.ctypes.data_as(u8p), rl.ctypes.data_as(i32p),
        B, fc.shape[1], rc.shape[1], T,
        out.ctypes.data_as(u8p))
    return out if rc_ok == 0 else None

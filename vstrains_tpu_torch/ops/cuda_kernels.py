"""The port's eight hand-written CUDA kernels, each beside its plain
PyTorch version.

  * window_hashes_wire / window_hashes_bytes: csrc/window_hashes.cu,
    replacing pallas_kernels.py::window_hashes_pallas;
  * stats_accum: csrc/stats_accum.cu, replacing
    pallas_kernels.py::stats_accum_pallas;
  * pair_counts: csrc/pair_counts.cu, replacing
    pallas_kernels.py::pair_matmuls_pallas;
  * sort_rows: csrc/sort_rows.cu, replacing
    pallas_sort.py::sort_rows_pallas (the sparse engine's row sorts);
  * sort_cols: csrc/sort_cols.cu, replacing the column sorter prototype
    tools/colsort_proto.py::sort_cols_pallas (no caller on any path, as
    in the JAX package); it shares sort_rows' network (csrc/sort_net.cuh);
  * dup_stats and dup_scan: csrc/dup_stats.cu and csrc/dup_scan.cu, the
    classic probe's duplicate-run walk (csrc/dup_walk.cuh), fused with the
    per-(read, node) stats for the dense engine and expanded to the sparse
    tail's (node, window) planes for the sparse engine: the port's own
    kernels for XLA stages of the JAX package
    (pe_infer.py::_dup_scan_stats_impl and _sparse_expand_matches; no
    Pallas kernel there);
  * coo_accum: csrc/coo_accum.cu, the sparse engine's link keys counted
    into two hash tables on the card, in place of the JAX package's host
    COO (pe_infer.py::_sparse_pairs_np and _merge_coo; no TPU kernel);
    its launches count the tables' growth (coo_rehash) too.

A wrapper takes its plain version only when its tensors lie on the CPU
(the CPU tests, `--device cpu`). On a CUDA tensor it launches the kernel,
or raises: there is no fallback. Every launch adds one to the kernel's
entry in LAUNCHES, so a run can show that it went through the kernels;
the plain versions (`*_plain`) never count.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from vstrains_tpu_torch.core.seq import (HASH_MULT_1, HASH_MULT_2,
                                         prefix_hash_weights)
from vstrains_tpu_torch.utils import tracing

INF = 2**31 - 1
_M32 = 0xFFFFFFFF

# kernel name -> launches since the last reset_launches(): the counter
# group "launches" of the program's registry (utils/tracing.py)
LAUNCHES: Dict[str, int] = tracing.counter_group("launches", {
    "window_hashes": 0, "stats_accum": 0, "pair_counts": 0, "sort_rows": 0,
    "dup_scan": 0, "dup_stats": 0, "sort_cols": 0, "coo_accum": 0})
# sort_rows' launches since the last reset_launches(), by padded row width
# (which says the branch: the one-block network up to SORT_NET_MAX)
SORT_ROWS_WIDTHS: Dict[int, int] = tracing.counter_group("sort_rows_widths")

# what chip_smoke.py reports for each kernel
KERNELS = [
    {"name": "window_hashes", "route": "cuda",
     "source": "vstrains_tpu_torch/csrc/window_hashes.cu",
     "replaces": "vstrains_tpu/ops/pallas_kernels.py:63"},
    {"name": "stats_accum", "route": "cuda",
     "source": "vstrains_tpu_torch/csrc/stats_accum.cu",
     "replaces": "vstrains_tpu/ops/pallas_kernels.py:154"},
    {"name": "pair_counts", "route": "cuda",
     "source": "vstrains_tpu_torch/csrc/pair_counts.cu",
     "replaces": "vstrains_tpu/ops/pallas_kernels.py:267"},
    {"name": "sort_rows", "route": "cuda",
     "source": "vstrains_tpu_torch/csrc/sort_rows.cu",
     "replaces": "vstrains_tpu/ops/pallas_sort.py:75"},
    {"name": "dup_scan", "route": "cuda",
     "source": "vstrains_tpu_torch/csrc/dup_scan.cu",
     "replaces": "vstrains_tpu/ops/pe_infer.py:1094",
     "note": "port-only: the XLA stage _sparse_expand_matches, no TPU "
             "kernel"},
    {"name": "dup_stats", "route": "cuda",
     "source": "vstrains_tpu_torch/csrc/dup_stats.cu",
     "replaces": "vstrains_tpu/ops/pe_infer.py:677",
     "note": "port-only: the XLA stage _dup_scan_stats_impl, no TPU kernel"},
    {"name": "sort_cols", "route": "cuda",
     "source": "vstrains_tpu_torch/csrc/sort_cols.cu",
     "replaces": "tools/colsort_proto.py:58",
     "note": "no caller on any path: the JAX package's column sorter is a "
             "tested prototype that its engine does not use"},
    {"name": "coo_accum", "route": "cuda",
     "source": "vstrains_tpu_torch/csrc/coo_accum.cu",
     "replaces": "vstrains_tpu/ops/pe_infer.py:1431",
     "note": "port-only: replaces the host COO of "
             "vstrains_tpu/ops/pe_infer.py:1431 (_sparse_pairs_np) and "
             ":1458 (_merge_coo), no TPU kernel"},
]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SORT_ROWS_WIDTHS.clear()


# --------------------------------------------------------------------------
# plumbing
# --------------------------------------------------------------------------

def _lib():
    from vstrains_tpu_torch.ops import _build
    return _build.load()


def _on_cuda(*tensors) -> bool:
    """True when every tensor is on CUDA, False when every one is on the
    CPU; mixed or other devices raise."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors on {sorted(str(t.device) for t in tensors)}:"
                     " expected all on the CPU or all on one CUDA device")


def _expect(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        text = _lib().vt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {text} "
                           f"({err})")
    LAUNCHES[name] += 1


# --------------------------------------------------------------------------
# window hashes (csrc/window_hashes.cu)
# --------------------------------------------------------------------------

def wire_width(T: int) -> int:
    return 2 * (-(-T // 4)) + 4


def wire_lens(wire: torch.Tensor) -> torch.Tensor:
    """Stacked (2B,) int32 read lengths of a wire batch (forward reads
    first), the u16s in each row's last four bytes."""
    w = wire.to(torch.int32)
    return torch.cat([w[:, -4] | (w[:, -3] << 8), w[:, -2] | (w[:, -1] << 8)])


def unpack_wire_plain(wire: torch.Tensor, T: int):
    """Inverse of pe_infer._pack_wire_np -> stacked ((2B, T) uint8 codes,
    (2B,) int32 lens); the torch form of the JAX package's _unpack_wire."""
    B = wire.shape[0]
    T4 = -(-T // 4)
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=wire.device)

    def unpack(packed):
        c = (packed[:, :, None] >> shifts[None, None, :]) & 3
        return c.reshape(B, 4 * T4)[:, :T]

    codes = torch.cat([unpack(wire[:, :T4]), unpack(wire[:, T4:2 * T4])])
    return codes.contiguous(), wire_lens(wire)


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors holding values in [0, 2^32),
    split so that no product leaves int64."""
    lo = b & 0xFFFF
    hi = b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _as_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same 32 bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def window_hashes_plain(codes: torch.Tensor, lens: torch.Tensor,
                        split_len: int):
    """The torch form of the JAX package's _device_window_hashes (the
    prefix-sum factorization, core/seq.prefix_hash_weights) with the sign
    bias applied: returns q1 = h1 ^ 0x80000000 and h2 as int32 [R, K],
    and valid bool [R, K], K = T - split_len + 1."""
    R, T = codes.shape
    L = split_len
    K = T - L + 1
    dev = codes.device
    c64 = codes.to(torch.int64)
    bad = c64 >= 4
    c = torch.where(bad, 0, c64) + 1
    hs = []
    for w, s in prefix_hash_weights(L, T):
        wt = torch.from_numpy(w.astype(np.int64)).to(dev)
        st = torch.from_numpy(s.astype(np.int64)).to(dev)
        p = torch.cumsum(_mulmod32(c, wt[None, :]), dim=1)
        p = torch.nn.functional.pad(p, (1, 0))
        hs.append(_mulmod32((p[:, L:] - p[:, :K]) & _M32, st[None, :]))
    nb = torch.nn.functional.pad(torch.cumsum(bad.to(torch.int32), dim=1),
                                 (1, 0))
    nbad = nb[:, L:] - nb[:, :K]
    win = torch.arange(K, device=dev)
    valid = ((win[None, :] + L) <= lens[:, None]) & (nbad == 0)
    return (_as_int32_bits(hs[0] ^ 0x80000000), _as_int32_bits(hs[1]),
            valid)


def hash_constants(split_len: int):
    """(M1, M1^(L-1), M2, M2^(L-1)) mod 2^32: what the kernel's Horner
    steps and rolls multiply by (csrc/window_hashes.cu)."""
    return tuple(v for m in (int(HASH_MULT_1), int(HASH_MULT_2))
                 for v in (m, pow(m, split_len - 1, 2**32)))


def _hash_outputs(R: int, K: int, device):
    return (torch.empty((R, K), dtype=torch.int32, device=device),
            torch.empty((R, K), dtype=torch.int32, device=device),
            torch.empty((R, K), dtype=torch.uint8, device=device))


def window_hashes_wire(wire: torch.Tensor, T: int, split_len: int):
    """Window hashes of a packed wire batch (uint8 [B, wire_width(T)]):
    returns (q1, h2, valid) for the stacked (2B, K) end-batch."""
    if not _on_cuda(wire):
        codes, lens = unpack_wire_plain(wire, T)
        return window_hashes_plain(codes, lens, split_len)
    _expect(wire, "wire", torch.uint8, 2)
    B, W = wire.shape
    if W != wire_width(T):
        raise ValueError(f"wire width {W} != {wire_width(T)} for T={T}")
    K = T - split_len + 1
    if K <= 0:
        raise ValueError(f"read width {T} is shorter than a window")
    q1, h2, valid = _hash_outputs(2 * B, K, wire.device)
    _launch("window_hashes", _lib().vt_window_hashes_wire, wire.device,
            wire.data_ptr(), B, W, T, split_len, *hash_constants(split_len),
            q1.data_ptr(), h2.data_ptr(), valid.data_ptr())
    return q1, h2, valid.view(torch.bool)


def window_hashes_bytes(codes: torch.Tensor, lens: torch.Tensor,
                        split_len: int):
    """Window hashes of byte codes (uint8 [R, T], codes >= 4 invalidate
    their windows) and int32 lengths [R]: returns (q1, h2, valid)."""
    if not _on_cuda(codes, lens):
        return window_hashes_plain(codes, lens, split_len)
    _expect(codes, "codes", torch.uint8, 2)
    _expect(lens, "lens", torch.int32, 1)
    R, T = codes.shape
    if lens.shape[0] != R:
        raise ValueError(f"lens has {lens.shape[0]} rows, codes {R}")
    K = T - split_len + 1
    if K <= 0:
        raise ValueError(f"read width {T} is shorter than a window")
    q1, h2, valid = _hash_outputs(R, K, codes.device)
    _launch("window_hashes", _lib().vt_window_hashes_bytes, codes.device,
            codes.data_ptr(), lens.data_ptr(), R, T, split_len,
            *hash_constants(split_len), q1.data_ptr(), h2.data_ptr(), valid.data_ptr())
    return q1, h2, valid.view(torch.bool)


# --------------------------------------------------------------------------
# per-(read, node) stats (csrc/stats_accum.cu)
# --------------------------------------------------------------------------

def stats_accum_plain(node_t: torch.Tensor, depth: int, num_nodes: int):
    """scatter_add_ / scatter_reduce(amin) over a sentinel column, as the
    JAX package's _slots_scatter_accum: (cnt, kmin) int32 [R, N]."""
    R, C = node_t.shape
    dev = node_t.device
    idx = node_t.to(torch.int64)
    kidx = (torch.arange(C, device=dev, dtype=torch.int32)
            // depth).expand(R, C)
    cnt = torch.zeros((R, num_nodes + 1), dtype=torch.int32, device=dev)
    cnt.scatter_add_(1, idx, torch.ones_like(node_t, dtype=torch.int32))
    kmin = torch.full((R, num_nodes + 1), INF, dtype=torch.int32,
                      device=dev)
    kmin.scatter_reduce_(1, idx, kidx, reduce="amin", include_self=True)
    return cnt[:, :num_nodes], kmin[:, :num_nodes]


def stats_accum_uses_shared(num_nodes: int) -> bool:
    """Whether the kernel keeps a row's counters in shared memory (else
    global atomics) — the branch chip_smoke.py exercises both sides of."""
    return bool(_lib().vt_stats_accum_uses_shared(num_nodes))


def stats_accum(node_t: torch.Tensor, depth: int, num_nodes: int):
    """(cnt, kmin) int32 [R, N] from per-slot node ids int32 [R, C]
    (slot j = window j // depth; ids outside [0, N) are misses)."""
    if not _on_cuda(node_t):
        return stats_accum_plain(node_t, depth, num_nodes)
    _expect(node_t, "node_t", torch.int32, 2)
    R, C = node_t.shape
    cnt = torch.empty((R, num_nodes), dtype=torch.int32,
                      device=node_t.device)
    kmin = torch.empty_like(cnt)
    _launch("stats_accum", _lib().vt_stats_accum, node_t.device,
            node_t.data_ptr(), R, C, depth, num_nodes, cnt.data_ptr(),
            kmin.data_ptr())
    return cnt, kmin


# --------------------------------------------------------------------------
# pair counts (csrc/pair_counts.cu)
# --------------------------------------------------------------------------

def pair_counts_plain(f: torch.Tensor, r: torch.Tensor,
                      acc_nm: torch.Tensor, acc_sm: torch.Tensor) -> None:
    """acc_nm += f^T r ; acc_sm += triu(f^T f + r^T r), through float32
    matmuls: exact, since every entry is at most 2B < 2^24."""
    ff = f.to(torch.float32)
    rf = r.to(torch.float32)
    acc_nm += (ff.T @ rf).to(torch.int64)
    acc_sm += torch.triu(ff.T @ ff + rf.T @ rf).to(torch.int64)


# the work list's units: output tiles of PAIR_TILE nodes, read ranges of
# PAIR_STEP reads (csrc/pair_counts.cu's kTile and 32 kWords; the wrapper
# passes both and the kernel refuses others)
PAIR_TILE = 128
PAIR_STEP = 128
# cost of one step of a tile, off the diagonal and on it (4 staged
# operands and 4 products, against 2 and 3): a balance estimate only
PAIR_STEP_COST = (5, 3)


def pair_counts_layout(B: int, N: int):
    """(Np, Bp): the extents the kernel computes over, N rounded up to
    whole tiles (rows past N are zeros) and B to whole packed words."""
    return -(-N // PAIR_TILE) * PAIR_TILE, -(-B // PAIR_STEP) * PAIR_STEP


def pair_counts_schedule(B: int, N: int, sms: int):
    """The kernel's work list for a card of `sms` SMs: (starts int32
    [blocks + 1], segs int32 [segments, 4]). The steps of every upper
    tile I <= J of the PAIR_TILE-node grid, tile after tile, are cut into
    `blocks` <= sms runs of equal cost (PAIR_STEP_COST), one per block
    (the kernel runs one block per SM); a run that crosses tiles
    is several segments (tile I, tile J, first read, end read), and block
    b owns segments starts[b] .. starts[b + 1]. Each segment adds its
    partial sums once, so a tile is shared by only a few blocks."""
    T = -(-N // PAIR_TILE)
    _, Bp = pair_counts_layout(B, N)
    steps = Bp // PAIR_STEP
    tiles = [(i, j) for i in range(T) for j in range(i, T)]
    costs = [PAIR_STEP_COST[i == j] for i, j in tiles]
    total = steps * sum(costs)
    blocks = min(sms, steps * len(tiles))
    ends = [total * (b + 1) // blocks for b in range(blocks)]
    starts, segs, b, done = [0], [], 0, 0
    for (i, j), c in zip(tiles, costs):
        k = 0
        while k < steps:
            while done + k * c >= ends[b]:
                b += 1
                starts.append(len(segs))
            k_end = min(steps, max(k + 1, -(-(ends[b] - done) // c)))
            segs.append((i, j, k * PAIR_STEP, k_end * PAIR_STEP))
            k = k_end
        done += steps * c
    starts += [len(segs)] * (blocks + 1 - len(starts))
    return (np.array(starts, dtype=np.int32),
            np.array(segs, dtype=np.int32).reshape(-1, 4))


@functools.lru_cache(maxsize=16)
def _pair_schedule(B: int, N: int, device: torch.device, sms: int):
    return tuple(torch.from_numpy(a).to(device)
                 for a in pair_counts_schedule(B, N, sms))


def pair_counts(f: torch.Tensor, r: torch.Tensor, acc_nm: torch.Tensor,
                acc_sm: torch.Tensor) -> None:
    """Add one batch's link counts into the int64 [N, N] accumulators, in
    place. f, r: 0/1 masks [B, N] (bool or uint8) of the forward and
    reverse reads."""
    if not _on_cuda(f, r, acc_nm, acc_sm):
        pair_counts_plain(f, r, acc_nm, acc_sm)
        return
    if f.dtype == torch.bool:
        f = f.view(torch.uint8)
    if r.dtype == torch.bool:
        r = r.view(torch.uint8)
    _expect(f, "f", torch.uint8, 2)
    _expect(r, "r", torch.uint8, 2)
    _expect(acc_nm, "acc_nm", torch.int64, 2)
    _expect(acc_sm, "acc_sm", torch.int64, 2)
    B, N = f.shape
    if r.shape != f.shape or acc_nm.shape != (N, N) \
            or acc_sm.shape != (N, N):
        raise ValueError(f"shapes f{tuple(f.shape)} r{tuple(r.shape)} "
                         f"acc {tuple(acc_nm.shape)}/{tuple(acc_sm.shape)}")
    if B == 0 or N == 0:
        return
    sms = torch.cuda.get_device_properties(f.device).multi_processor_count
    starts, segs = _pair_schedule(B, N, f.device, sms)
    # the kernel's bit-packed copies of f and r: [Bp / 32, N] each
    _, Bp = pair_counts_layout(B, N)
    words = torch.empty(2 * (Bp // 32) * N, dtype=torch.int32,
                        device=f.device)
    _launch("pair_counts", _lib().vt_pair_counts, f.device, f.data_ptr(),
            r.data_ptr(), B, N, starts.data_ptr(), starts.shape[0] - 1,
            segs.data_ptr(), PAIR_TILE, PAIR_STEP, words.data_ptr(),
            acc_nm.data_ptr(), acc_sm.data_ptr())


# --------------------------------------------------------------------------
# row and column sorts (csrc/sort_rows.cu, csrc/sort_cols.cu, both on the
# network of csrc/sort_net.cuh)
# --------------------------------------------------------------------------

# the longest sequence one block's network sorts (csrc/sort_net.cuh
# kMaxLen): rows up to this padded width, columns up to this many rows
SORT_NET_MAX = 16384


def _pow2_at_least(c: int) -> int:
    L = 1
    while L < c:
        L *= 2
    return L


def sort_rows_plain(key: torch.Tensor, val: Optional[torch.Tensor] = None):
    """torch.sort of one int64 per slot, (key << 32) + (val + 2^31), which
    is the signed (key, val) order; key-only sorts the keys. Returns
    (key, val) sorted per row, or the sorted keys when val is None."""
    if val is None:
        return torch.sort(key, dim=1).values
    w = (key.to(torch.int64) << 32) + (val.to(torch.int64) + 2**31)
    w = torch.sort(w, dim=1).values
    return ((w >> 32).to(torch.int32),
            ((w & _M32) - 2**31).to(torch.int32))


def sort_rows_uses_network(C: int) -> bool:
    """Whether rows of width C sort in one block's register network (else
    its global branch) — the branch chip_smoke.py exercises both sides
    of."""
    return bool(_lib().vt_sort_rows_uses_network(_pow2_at_least(C)))


def sort_rows(key: torch.Tensor, val: Optional[torch.Tensor] = None):
    """Sort each row of int32 [R, C] ascending by (key, val), or by key
    alone when val is None. Returns (key, val), or the sorted keys."""
    tensors = (key,) if val is None else (key, val)
    if not _on_cuda(*tensors):
        return sort_rows_plain(key, val)
    _expect(key, "key", torch.int32, 2)
    if val is not None:
        _expect(val, "val", torch.int32, 2)
        if val.shape != key.shape:
            raise ValueError(f"val {tuple(val.shape)} != key "
                             f"{tuple(key.shape)}")
    R, C = key.shape
    key_out = torch.empty_like(key)
    val_out = None if val is None else torch.empty_like(val)
    if key.numel():
        L = max(32, _pow2_at_least(C))
        # the global branch's words: 8 bytes with values, 4 key-only
        scratch = (None if _lib().vt_sort_rows_uses_network(L) else
                   torch.empty(R * L * (1 if val is None else 2),
                               dtype=torch.int32, device=key.device))
        _launch("sort_rows", _lib().vt_sort_rows, key.device,
                key.data_ptr(), None if val is None else val.data_ptr(),
                R, C, key_out.data_ptr(),
                None if val_out is None else val_out.data_ptr(),
                None if scratch is None else scratch.data_ptr())
        SORT_ROWS_WIDTHS[L] = SORT_ROWS_WIDTHS.get(L, 0) + 1
    return key_out if val is None else (key_out, val_out)


def sort_cols_plain(x: torch.Tensor) -> torch.Tensor:
    """Each column of x ascending."""
    return torch.sort(x, dim=0).values


def sort_cols(x: torch.Tensor) -> torch.Tensor:
    """Sort each column of int32 [L, W] ascending (L up to
    SORT_NET_MAX)."""
    if x.dim() == 2 and x.shape[0] > SORT_NET_MAX:
        raise ValueError(f"sort_cols: {x.shape[0]} rows, past the "
                         f"kernel's limit of {SORT_NET_MAX} (one block's "
                         "network)")
    if not _on_cuda(x):
        return sort_cols_plain(x)
    _expect(x, "x", torch.int32, 2)
    out = torch.empty_like(x)
    if x.numel():
        _launch("sort_cols", _lib().vt_sort_cols, x.device, x.data_ptr(),
                x.shape[0], x.shape[1], out.data_ptr())
    return out


# --------------------------------------------------------------------------
# classic probe: the duplicate-run walk (csrc/dup_walk.cuh), fused with the
# per-(read, node) stats (csrc/dup_stats.cu, dense engine) or expanded to
# the sparse tail's planes (csrc/dup_scan.cu, sparse engine)
#
# Both take the windows (q1, h2 int32 [R, K], valid bool [R, K]), their
# table positions lo (int32 [R, K], the first entry with h1 >= q1; M for a
# window the bucket lookup did not find) and the padded table, sorted by
# h1, as one interleaved int32 [M, 4] record (h1, h2, node, 0) an entry
# (table_record). The JAX rule: loc = min(lo, M - 1); rank d < depth
# matches when the window is valid, loc + d < M, and the entry at loc + d
# has h1 == q1 and h2 == h2.
# --------------------------------------------------------------------------

def table_record(h1: torch.Tensor, h2: torch.Tensor,
                 node: torch.Tensor) -> torch.Tensor:
    """The table as one int32 [M, 4] record (h1, h2, node, 0) an entry,
    which the kernels read in one 16-byte load."""
    return torch.stack([h1, h2, node, torch.zeros_like(h1)], dim=1)


def _rank_matches(q1, h2, valid, lo, table, d):
    """(match bool, node) of every window at the ranks d (int64 [..., D]
    broadcast against the windows' trailing axis), by the JAX rule."""
    M = table.shape[0]
    pos = lo.to(torch.int64).clamp(max=M - 1)[..., None] + d
    idx = pos.clamp(max=M - 1)
    m = (valid[..., None] & (table[idx, 0] == q1[..., None])
         & (table[idx, 1] == h2[..., None]) & (pos < M))
    return m, table[idx, 2]


def dup_stats_plain(q1, h2, valid, lo, table, depth: int, num_nodes: int):
    """The torch form of the JAX package's _dup_scan_stats_impl: a loop
    over the ranks with scatter_add_ / scatter_reduce_(amin) over a
    sentinel column, as stats_accum_plain does. Returns (cnt, kmin) int32
    [R, N]: matches of each row's windows at each node, and the lowest
    window index of those (INT32_MAX where cnt is 0)."""
    R, K = q1.shape
    dev = q1.device
    kidx = torch.arange(K, dtype=torch.int32, device=dev).expand(R, K)
    cnt = torch.zeros((R, num_nodes + 1), dtype=torch.int32, device=dev)
    kmin = torch.full((R, num_nodes + 1), INF, dtype=torch.int32,
                      device=dev)
    for d in range(depth):
        m, node = _rank_matches(q1, h2, valid, lo, table,
                                torch.tensor([d], device=dev))
        m, node = m[..., 0], node[..., 0]
        idx = torch.where(m, node, num_nodes).to(torch.int64)
        cnt.scatter_add_(1, idx, m.to(torch.int32))
        kmin.scatter_reduce_(1, idx, torch.where(m, kidx, INF),
                             reduce="amin", include_self=True)
    return cnt[:, :num_nodes], kmin[:, :num_nodes]


def dup_scan_plain(q1, h2, valid, lo, table, depth: int):
    """The torch form of the JAX package's _sparse_expand_matches: per-slot
    (node_key, kidx_v), int32 [R, K * depth] each, slot k * depth + d of a
    row holding the matched entry's node and k where window k matches at
    rank d, INT32_MAX in both for a miss."""
    R, K = q1.shape
    d = torch.arange(depth, dtype=torch.int64, device=q1.device)
    m, node = _rank_matches(q1, h2, valid, lo, table, d)
    kidx = torch.arange(K, dtype=torch.int32, device=q1.device)
    node_key = torch.where(m, node, INF).to(torch.int32)
    kidx_v = torch.where(m, kidx[None, :, None], INF).to(torch.int32)
    return node_key.reshape(R, K * depth), kidx_v.reshape(R, K * depth)


def _check_classic(q1, h2, valid, lo, table, depth: int) -> None:
    """Checks a classic kernel's operands on the card."""
    for t, name in zip((q1, h2, lo), ("q1", "h2", "lo")):
        _expect(t, name, torch.int32, 2)
    _expect(valid, "valid", torch.bool, 2)
    _expect(table, "table record", torch.int32, 2)
    if h2.shape != q1.shape or valid.shape != q1.shape \
            or lo.shape != q1.shape:
        raise ValueError(f"shapes q1{tuple(q1.shape)} h2{tuple(h2.shape)} "
                         f"valid{tuple(valid.shape)} lo{tuple(lo.shape)}")
    if table.shape[1] != 4 or table.data_ptr() % 16:
        raise ValueError(f"table record: expected a 16-byte aligned "
                         f"[M, 4], got {tuple(table.shape)}")
    if depth < 1 or table.shape[0] < 1:
        raise ValueError(f"depth {depth} and table length "
                         f"{table.shape[0]} must be >= 1")


def dup_stats(q1, h2, valid, lo, table, depth: int, num_nodes: int):
    """(cnt, kmin) int32 [R, N] of the windows' duplicate-run matches: the
    contract of dup_stats_plain (the table must be sorted by h1, as the
    join needs)."""
    if not _on_cuda(q1, h2, valid, lo, table):
        return dup_stats_plain(q1, h2, valid, lo, table, depth, num_nodes)
    _check_classic(q1, h2, valid, lo, table, depth)
    R, K = q1.shape
    cnt = torch.empty((R, num_nodes), dtype=torch.int32, device=q1.device)
    kmin = torch.empty_like(cnt)
    if cnt.numel():
        _launch("dup_stats", _lib().vt_dup_stats, q1.device, q1.data_ptr(),
                h2.data_ptr(), valid.data_ptr(), lo.data_ptr(),
                table.data_ptr(), R, K, depth, table.shape[0], num_nodes,
                cnt.data_ptr(), kmin.data_ptr())
    return cnt, kmin


def dup_scan(q1, h2, valid, lo, table, depth: int):
    """(node_key, kidx_v) int32 [R, K * depth] of the windows'
    duplicate-run matches: the contract of dup_scan_plain (the table must
    be sorted by h1, as the join needs)."""
    if not _on_cuda(q1, h2, valid, lo, table):
        return dup_scan_plain(q1, h2, valid, lo, table, depth)
    _check_classic(q1, h2, valid, lo, table, depth)
    R, K = q1.shape
    node_key = torch.empty((R, K * depth), dtype=torch.int32,
                           device=q1.device)
    kidx_v = torch.empty_like(node_key)
    if node_key.numel():
        _launch("dup_scan", _lib().vt_dup_scan, q1.device, q1.data_ptr(),
                h2.data_ptr(), valid.data_ptr(), lo.data_ptr(),
                table.data_ptr(), R * K, K, depth, table.shape[0],
                node_key.data_ptr(), kidx_v.data_ptr())
    return node_key, kidx_v


# --------------------------------------------------------------------------
# the sparse engine's link keys counted on the card (csrc/coo_accum.cu)
# --------------------------------------------------------------------------

COO_EMPTY = 2**63 - 1  # a free slot's key
# CooTables.stats, int64, copied to the host after each batch: that
# batch's cap-overflow flag, the keys expanded so far, each table's filled
# slots (pair, short) and full flags (pair, short)
COO_OVF, COO_KEYS, COO_FILL, COO_FULL, COO_STATS = 0, 1, 2, 4, 6


def coo_table_slots(num_nodes: int) -> int:
    """A link table's first size: the power of two at or above 64 N and
    2^16, and at most the first one above 2 N², which holds every key
    with half its slots free."""
    slots = max(_pow2_at_least(64 * num_nodes), 1 << 16)
    return max(2, min(slots, _pow2_at_least(2 * num_nodes ** 2 + 1)))


def _empty_table(slots: int, device) -> torch.Tensor:
    return torch.tensor([COO_EMPTY, 0], dtype=torch.int64,
                        device=device).repeat(slots, 1)


class CooTables:
    """The sparse engine's two link-key tables, pair keys and same-end
    (short) keys, for the passes of one engine call. Each is int64
    [slots, 2] (key, count) rows: on CUDA an open-addressing hash table
    (COO_EMPTY keys are free slots); in the plain version the table's
    keys ascending in its first rows, then COO_EMPTY rows. `stats` holds
    the COO_* counters. `reset()` empties both tables for a pass, at the
    sizes in `slots`; `grow(t)` moves table t into 4x its slots."""

    def __init__(self, num_nodes: int, device, slots: Optional[int] = None):
        slots = coo_table_slots(num_nodes) if slots is None else slots
        if slots < 2 or slots & (slots - 1):
            raise ValueError(f"link table of {slots} slots: expected a "
                             "power of two of at least 2")
        self.num_nodes = num_nodes
        self.device = torch.device(device)
        self.slots = [slots, slots]
        self.reset()

    def reset(self) -> None:
        self.tabs = [_empty_table(s, self.device) for s in self.slots]
        self.stats = torch.zeros(COO_STATS, dtype=torch.int64,
                                 device=self.device)

    def grow(self, t: int) -> None:
        """Table t (0 pair, 1 short) into 4x its slots, every key kept
        with its count: one rehash launch on CUDA."""
        old = self.tabs[t]
        new = _empty_table(4 * self.slots[t], self.device)
        if _on_cuda(old):
            _launch("coo_accum", _lib().vt_coo_rehash, old.device,
                    old.data_ptr(), old.shape[0], new.data_ptr(),
                    (4 * self.slots[t]).bit_length() - 1,
                    self.stats[COO_FULL + t:].data_ptr())
        else:
            new[:old.shape[0]] = old
        self.tabs[t] = new
        self.slots[t] *= 4


# the host COO, coo_accum's plain version (numpy, as in the JAX package)

def _ragged_cross_np(av, ao, bv, bo, na, nb, N, triu=False):
    """Cross-product link keys over ragged per-read node lists.

    (av, ao, na) are the flattened values / row offsets / row counts of
    one side; work is O(actual pairs). With triu only position pairs
    i <= j survive (ascending same-end pairs, diagonal included)."""
    per = (na * nb).astype(np.int64)
    P = int(per.sum())
    if not P:
        return np.zeros(0, np.int64)
    starts = np.zeros(len(per), np.int64)
    np.cumsum(per[:-1], out=starts[1:])
    row = np.repeat(np.arange(len(per)), per)
    local = np.arange(P, dtype=np.int64) - starts[row]
    i = local // nb[row]
    j = local % nb[row]
    keys = av[ao[row] + i] * N + bv[bo[row] + j]
    if triu:
        keys = keys[i <= j]
    return keys


def _sparse_pairs_np(f_nodes: np.ndarray, r_nodes: np.ndarray, N: int):
    """COO link keys for one batch from compacted saturated node lists:
    PE pairs are the full fwd x rve cross product; same-end pairs are
    ascending (u at or before v in the per-read list, diagonal included),
    as the reference pair loops (PE_Inference.py:174-188)."""
    fm = f_nodes >= 0
    rm = r_nodes >= 0
    nf = fm.sum(1).astype(np.int64)
    nr = rm.sum(1).astype(np.int64)
    fv = f_nodes[fm].astype(np.int64)
    rv = r_nodes[rm].astype(np.int64)
    fo = np.zeros(len(nf), np.int64)
    np.cumsum(nf[:-1], out=fo[1:])
    ro = np.zeros(len(nr), np.int64)
    np.cumsum(nr[:-1], out=ro[1:])
    pe = _ragged_cross_np(fv, fo, rv, ro, nf, nr, N)
    shorts = [
        _ragged_cross_np(fv, fo, fv, fo, nf, nf, N, triu=True),
        _ragged_cross_np(rv, ro, rv, ro, nr, nr, N, triu=True),
    ]
    return pe, np.concatenate(shorts)


def _merge_coo(key_chunks, count_chunks):
    """Merge per-batch (keys, counts) COO chunks into one sorted unique
    (keys, counts) pair (sort + reduceat)."""
    if not key_chunks:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    keys = np.concatenate(key_chunks)
    counts = np.concatenate(count_chunks)
    if keys.size == 0:
        return (keys, counts.astype(np.int64))
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    counts = counts[order]
    starts = np.flatnonzero(
        np.concatenate([[True], keys[1:] != keys[:-1]]))
    return keys[starts], np.add.reduceat(counts.astype(np.int64), starts)


def coo_accum_plain(out: torch.Tensor, ovf: torch.Tensor,
                    tables: CooTables) -> None:
    """The JAX package's host COO, a batch at a time: the batch's keys
    from _sparse_pairs_np, made unique (np.unique) and merged into each
    table's keys (_merge_coo). A table whose keys outgrow its
    slots keeps the first of them and is marked full; while a table is
    full, batches add keys to COO_KEYS only."""
    stats = tables.stats
    stats[COO_OVF] = int(bool(ovf))
    if stats[COO_OVF]:
        return
    sn = out.numpy()
    b = sn.shape[0] // 2
    keys = _sparse_pairs_np(sn[:b], sn[b:], tables.num_nodes)
    stats[COO_KEYS] += sum(k.size for k in keys)
    if stats[COO_FULL:].any():
        return
    for t, k in enumerate(keys):
        tab = tables.tabs[t].numpy()
        fill = int(stats[COO_FILL + t])
        u, c = np.unique(k, return_counts=True)
        mk, mc = _merge_coo([tab[:fill, 0], u], [tab[:fill, 1], c])
        n = min(mk.size, tab.shape[0])
        tab[:n, 0] = mk[:n]
        tab[:n, 1] = mc[:n]
        stats[COO_FILL + t] = n
        stats[COO_FULL + t] = int(mk.size > n)


def coo_accum(out: torch.Tensor, ovf: torch.Tensor,
              tables: CooTables) -> torch.Tensor:
    """Add one batch's link keys into `tables`: out int32 [2B, cap] (rows
    may lie apart, columns adjacent), the forward then the reverse read
    ends' saturated node ids (each row its ids, then -1s), as the sparse
    tail returns them; ovf, bool (one
    element), the batch's cap overflow: an overflowed batch adds
    nothing. Returns tables.stats, this batch's flag at COO_OVF."""
    if not _on_cuda(out, ovf, tables.stats):
        coo_accum_plain(out, ovf, tables)
        return tables.stats
    if out.dtype != torch.int32 or out.dim() != 2 or out.stride(1) != 1:
        raise ValueError(f"out: expected a 2-D int32 tensor with adjacent "
                         f"columns, got {out.dtype} {tuple(out.shape)} "
                         f"strides {out.stride()}")
    if ovf.dtype != torch.bool or ovf.numel() != 1:
        raise ValueError(f"ovf: expected one bool, got {ovf.dtype} "
                         f"{tuple(ovf.shape)}")
    B2, cap = out.shape
    if B2 % 2:
        raise ValueError(f"out has {B2} rows: expected forward and reverse "
                         "rows, 2B")
    pair, short = tables.tabs
    _launch("coo_accum", _lib().vt_coo_accum, out.device, out.data_ptr(),
            B2 // 2, cap, out.stride(0), tables.num_nodes, pair.data_ptr(),
            pair.shape[0].bit_length() - 1, short.data_ptr(),
            short.shape[0].bit_length() - 1, ovf.data_ptr(),
            tables.stats.data_ptr())
    return tables.stats

"""Paired-end link inference, dense engine — the PyTorch port of
`vstrains_tpu/ops/pe_infer.py`.

Host (numpy, as in the JAX package): the k-mer table over node sequences
(both strands, dual 32-bit window hashes, hash-sorted), the packed
sortfill payloads, the compact wire format, length buckets, the output
files and the PE-info stores.

Device (torch), per batch of B read pairs stacked into one (2B, T)
end-batch, forward reads first:
  1. unpack the wire batch and hash every (k+1)-window  — CUDA kernel
     `window_hashes` (ops/cuda_kernels.py, csrc/window_hashes.cu);
  2. probe the table: `torch.searchsorted` of each window's biased h1 into
     the sorted table, then one row gather of the packed payloads
     (tag | top h2 bits | node id per duplicate rank). A window matches an
     entry when h1 is equal and the top 31 - node_bits bits of h2 are
     equal — exactly the accept rule of the JAX package's sortfill probe
     (`_sortfill_node_slots`, docs/DIVERGENCES.md #12), for any of its
     table strides;
  3. per-(read, node) hit count and lowest window index — CUDA kernel
     `stats_accum`;
  4. the reference's saturation test in exact int32 arithmetic
     (`_saturate`; the min ref coordinate cancels, see the JAX module's
     docstring);
  5. link counts node_mat += fᵀr, short_mat += triu(fᵀf + rᵀr) — CUDA
     kernel `pair_counts`, which adds straight into int64 device
     accumulators (so the JAX driver's int32 spill logic is gone).

On CPU tensors each kernel wrapper runs its plain torch version instead
(`--device cpu`, the CPU tests). Paths of the JAX engine not ported yet
raise NotPortedError: the sparse engine for large graphs, the classic
sort join (graphs beyond the payload packing), and the 'lookup' /
'searchsorted' / 'sortjoin' probe modes.
"""

from __future__ import annotations

import logging
import os
import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from vstrains_tpu_torch.core.fastq import ReadPairBatch
from vstrains_tpu_torch.core.seq import (encode_seq, prefix_hash_weights,
                                         revcomp_codes, window_hashes_np)
from vstrains_tpu_torch.device import resolve_device
from vstrains_tpu_torch.ops import cuda_kernels as ck

_LOG = logging.getLogger(__name__)

_INF = np.int32(2**31 - 1)
_BIAS = np.uint32(0x80000000)


class NotPortedError(NotImplementedError):
    """A path of the JAX engine that the PyTorch port does not have yet."""


# --------------------------------------------------------------------------
# host: table construction
# --------------------------------------------------------------------------

@dataclass
class KmerTable:
    """Flat hash-sorted (k+1)-mer table over all node sequences, both strands.

    Entry value layout matches the reference's kmer_htable entries (node
    index, forward-strand offset) — the reverse-complement k-mer of a window
    maps to the *same* (node, offset) value (PE_Inference.py:123-135).
    """
    h1_biased: np.ndarray   # int32 [M], sorted (uint32 order via bias)
    h2: np.ndarray          # int32 [M] (bitcast uint32; equality compares)
    node: np.ndarray        # int32 [M]
    offset: np.ndarray      # int32 [M]
    max_dup: int            # max run length of equal h1
    num_nodes: int
    split_len: int
    seq_lens: np.ndarray    # int32 [N] node sequence lengths
    num_entries: int = 0    # real entries (arrays may be bucket-padded
                            # with never-matching sentinels)


def _bucket_size(n: int) -> int:
    """Round up to the next power of two (>= 1024): table shapes stay in
    a few buckets across datasets."""
    size = 1024
    while size < n:
        size *= 2
    return size


_PARALLEL_SORT_MIN = 1 << 20  # entries; below this the serial sort wins


def _finish_kmer_table(h1, h2, node, offset, max_dup, num_nodes,
                       split_len, seq_lens, pad_to_bucket):
    """Common tail of build_kmer_table: bias/bitcast the sorted entry
    arrays and pad to the shape bucket. (The JAX package's direct-address
    bucket index serves only its 'lookup' probe, which is not ported.)"""
    h1b = (h1 ^ _BIAS).view(np.int32)
    h2b = h2.view(np.int32)
    if pad_to_bucket and h1.size:
        m_pad = _bucket_size(h1.size)
        pad = m_pad - h1.size
        if pad:
            h1b = np.concatenate([h1b, np.full(pad, _INF, np.int32)])
            h2b = np.concatenate([h2b, np.full(pad, -1, np.int32)])
            node = np.concatenate([node, np.zeros(pad, np.int32)])
            offset = np.concatenate([offset, np.zeros(pad, np.int32)])
    return KmerTable(h1_biased=h1b, h2=h2b, node=node, offset=offset,
                     max_dup=max_dup, num_nodes=num_nodes,
                     split_len=split_len, seq_lens=seq_lens,
                     num_entries=int(h1.size))


def build_kmer_table(seqs: Sequence[str], split_len: int,
                     pad_to_bucket: bool = True) -> KmerTable:
    """Build the sorted dual-hash table of all valid (k+1)-mers (both
    strands) of every node sequence.

    With pad_to_bucket, entry arrays pad to a power-of-two bucket with
    never-matching sentinels (h1 = INT32_MAX biased, h2 = -1)."""
    h1s: List[np.ndarray] = []
    h2s: List[np.ndarray] = []
    nodes: List[np.ndarray] = []
    offsets: List[np.ndarray] = []
    seq_lens = np.array([len(s) for s in seqs], dtype=np.int32)

    # C++ fast path (hash both strands + sort): bit-identical to the
    # numpy path below; the numpy path remains for the no-toolchain
    # fallback and as the oracle.
    if os.environ.get("VSTRAINS_NATIVE_TABLE", "1") != "0":
        from vstrains_tpu_torch import native as _native
        nat = _native.build_table_entries_native(seqs, split_len)
        if nat is not None:
            n_h1, n_h2, n_node, n_off, n_max_dup = nat
            return _finish_kmer_table(n_h1, n_h2, n_node, n_off,
                                      n_max_dup, len(seqs), split_len,
                                      seq_lens, pad_to_bucket)

    # every node batches into ONE sentinel-separated concatenation per
    # strand. A window crossing a node boundary necessarily contains the
    # never-valid sentinel code, so boundary windows drop out through the
    # same validity mask as N bases.
    _CHUNK_CODES = 32 * 1024 * 1024  # bound the hashing temporaries
    parts: List[str] = []
    keep: List[int] = []
    klens: List[int] = []
    cat_len = 0

    def _flush():
        nonlocal parts, keep, klens, cat_len
        if not keep:
            return
        keep_a = np.asarray(keep, np.int32)
        klens_a = np.asarray(klens, np.int64)
        bounds = np.concatenate([[0], np.cumsum(klens_a + 1)])
        cat = encode_seq("N".join(parts))
        S = cat.shape[0]
        # the rc window at cat position p images the forward window at
        # q = S - L - p, so node lookup and the forward-offset formula
        # (PE_Inference.py:123-135 parity) are shared via q.
        prefix_hash_weights(split_len, S)  # warm before the strand race

        def _strand(is_rc: bool):
            cc = revcomp_codes(cat) if is_rc else cat
            hh1, hh2, vv = window_hashes_np(cc, split_len)
            idx = np.nonzero(vv)[0]
            q = (S - split_len - idx) if is_rc else idx
            which = np.searchsorted(bounds, q, side="right") - 1
            return (hh1[idx], hh2[idx], keep_a[which],
                    (q - bounds[which]).astype(np.int32))

        # numpy releases the GIL in its inner loops, so the two strands
        # hash concurrently; results append in fixed (fwd, rc) order
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(_strand, False), ex.submit(_strand, True)]
            for fut in futs:
                hh1, hh2, nd, off = fut.result()
                h1s.append(hh1)
                h2s.append(hh2)
                nodes.append(nd)
                offsets.append(off)
        parts, keep, klens, cat_len = [], [], [], 0

    for i, seq in enumerate(seqs):
        n = len(seq)
        if n < split_len:
            continue
        parts.append(seq if isinstance(seq, str) else seq.decode("ascii"))
        keep.append(i)
        klens.append(n)
        cat_len += n + 1
        if cat_len >= _CHUNK_CODES:
            _flush()
    _flush()

    if h1s:
        h1 = np.concatenate(h1s)
        h2 = np.concatenate(h2s)
        node = np.concatenate(nodes)
        offset = np.concatenate(offsets)
    else:
        h1 = np.zeros(0, np.uint32)
        h2 = np.zeros(0, np.uint32)
        node = np.zeros(0, np.int32)
        offset = np.zeros(0, np.int32)

    # (h1, h2, node, offset) order via a packed-u64 sort plus a tie
    # fix-up (equal (h1, h2) across different (node, offset) are hash
    # collisions), so the table order is input-order-independent. Above
    # 1M entries the sort partitions by the key's top byte and sorts
    # partitions in threads; the result is identical to the serial path.
    M_real = int(h1.size)
    if sys.byteorder == "little" and M_real:
        key_h = np.empty(M_real, np.uint64)
        kv = key_h.view(np.uint32)
        kv[0::2] = h2
        kv[1::2] = h1
    else:
        key_h = ((h1.astype(np.uint64) << np.uint64(32))
                 | h2.astype(np.uint64))

    def _canonize_ties(seg, ks):
        ties = np.flatnonzero(ks[1:] == ks[:-1])
        if ties.size:
            in_run = np.zeros(ks.shape[0], bool)
            in_run[ties] = True
            in_run[ties + 1] = True
            sub = np.flatnonzero(in_run)
            key_no = ((node[seg[sub]].astype(np.uint64) << np.uint64(32))
                      | offset[seg[sub]].astype(np.uint32))
            so = np.lexsort((key_no, ks[sub]))
            seg[sub] = seg[sub[so]]
        return seg

    def _max_h1_run(hs: np.ndarray) -> int:
        if not hs.size:
            return 0
        neq = np.flatnonzero(hs[1:] != hs[:-1])
        bnds = np.empty(neq.size + 2, np.int64)
        bnds[0] = -1
        bnds[1:-1] = neq
        bnds[-1] = hs.size - 1
        return int(np.diff(bnds).max())

    if M_real >= _PARALLEL_SORT_MIN:
        top = (h1 >> np.uint32(24)).astype(np.uint8)
        porder = np.argsort(top, kind="stable")  # O(n) uint8 radix
        pbnd = np.empty(257, np.int64)
        pbnd[0] = 0
        np.cumsum(np.bincount(top, minlength=256), out=pbnd[1:])
        h1o = np.empty_like(h1)
        h2o = np.empty_like(h2)
        nodeo = np.empty_like(node)
        offso = np.empty_like(offset)
        max_dup_parts = np.zeros(256, np.int64)

        def _sort_part(p):
            a, b = int(pbnd[p]), int(pbnd[p + 1])
            if a == b:
                return
            seg = porder[a:b]
            keys = key_h[seg]
            so = np.argsort(keys)
            seg = seg[so]
            seg = _canonize_ties(seg, keys[so])
            hs = h1[seg]
            h1o[a:b] = hs
            h2o[a:b] = h2[seg]
            nodeo[a:b] = node[seg]
            offso[a:b] = offset[seg]
            # equal h1 share the top byte, so h1 runs never cross
            # partition boundaries
            max_dup_parts[p] = _max_h1_run(hs)

        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(min(8, os.cpu_count() or 4)) as ex:
            list(ex.map(_sort_part, range(256)))
        h1, h2, node, offset = h1o, h2o, nodeo, offso
        max_dup = int(max_dup_parts.max())
    elif M_real:
        order = np.argsort(key_h, kind="stable")
        order = _canonize_ties(order, key_h[order])
        h1 = h1[order]
        h2 = h2[order]
        node = node[order]
        offset = offset[order]
        max_dup = _max_h1_run(h1)
    else:
        max_dup = 1

    return _finish_kmer_table(h1, h2, node, offset, max_dup, len(seqs),
                              split_len, seq_lens, pad_to_bucket)


# --------------------------------------------------------------------------
# host: packed sortfill payloads
#
# Payload packing (adaptive): bit31 tag | h2_bits of h2's top bits |
# node_bits = max(9, bits(N-1)) node id, with h2_bits = 31 - node_bits.
# The secondary-hash check narrows from 32 to h2_bits bits
# (docs/DIVERGENCES.md #12). Graphs beyond 2^18 nodes, or with duplicate
# h1 runs longer than 16, need the classic join, which is not ported.
# --------------------------------------------------------------------------

_SORTFILL_MAX_NODE_BITS = 18
_SORTFILL_MAX_DUP = 16


def _sortfill_node_bits(num_nodes: int):
    """Payload node-id width for a graph, or None when the graph is too
    large for the packed-payload probe."""
    bits = max(9, int(num_nodes - 1).bit_length()) if num_nodes > 1 else 9
    return bits if bits <= _SORTFILL_MAX_NODE_BITS else None


def _build_sortfill_payloads(table: KmerTable, node_bits: int = 9):
    """Host-built payload matrix, int32 [M, D], D = min(max_dup, cap).

    pays[i, d] packs (tag, h2 top bits, node) of table entry i+d when
    entries i..i+d share one h1 (they are consecutive in the hash-sorted
    table), else 0 (no tag bit -> never matches)."""
    h1 = table.h1_biased
    h2u = table.h2.view(np.uint32)
    node = table.node.astype(np.uint32)
    M = h1.shape[0]
    D = min(table.max_dup, _SORTFILL_MAX_DUP)
    h2_bits = 31 - node_bits
    h2_shift = np.uint32(32 - h2_bits)
    pays = np.zeros((M, D), dtype=np.uint32)
    for d in range(D):
        same = np.zeros(M, dtype=bool)
        h2p = np.zeros(M, dtype=np.uint32)
        nd = np.zeros(M, dtype=np.uint32)
        if d == 0:
            same[:] = True
            h2p[:] = h2u >> h2_shift
            nd[:] = node
        elif M > d:
            same[: M - d] = h1[d:] == h1[:-d]
            h2p[: M - d] = h2u[d:] >> h2_shift
            nd[: M - d] = node[d:]
        pays[:, d] = np.where(same,
                              np.uint32(1 << 31) | (h2p << node_bits) | nd,
                              np.uint32(0))
    return pays.view(np.int32)


# --------------------------------------------------------------------------
# device: probe + saturation + the per-batch core
# --------------------------------------------------------------------------

def _sortfill_probe(q1: torch.Tensor, h2: torch.Tensor,
                    valid: torch.Tensor, tab_h1: torch.Tensor,
                    pays: torch.Tensor, node_bits: int,
                    num_nodes: int) -> torch.Tensor:
    """Per-slot matched node ids, int32 [R, K*D] (k-major slots, sentinel
    num_nodes for misses) — the input of the stats kernel.

    Each window's first table entry with h1 >= q comes from a binary
    search; its payload row holds all D duplicate ranks of that h1 run.
    Sentinel padding entries (h1 = INT32_MAX) can be found like any
    other; their payloads obey the same accept rule as in the JAX
    package."""
    R, K = q1.shape
    M = tab_h1.shape[0]
    D = pays.shape[1]
    q = q1.reshape(-1)
    idx = torch.searchsorted(tab_h1, q, side="left")
    found = idx < M
    idx = idx.clamp_(max=M - 1)
    hit = found & (tab_h1[idx] == q)
    outp = torch.where(hit[:, None], pays[idx], 0)
    h2_bits = 31 - node_bits
    h2_mask = (1 << h2_bits) - 1
    h2q_top = (h2.reshape(-1) >> (32 - h2_bits)) & h2_mask
    m = (valid.reshape(-1, 1) & (outp < 0)
         & (((outp >> node_bits) & h2_mask) == h2q_top[:, None]))
    return torch.where(m, outp & ((1 << node_bits) - 1),
                       num_nodes).reshape(R, K * D)


def _saturate(cnt: torch.Tensor, kmin: torch.Tensor, lens: torch.Tensor,
              seq_lens: torch.Tensor, split_len: int) -> torch.Tensor:
    """The reference saturation test in exact-integer form with the min
    ref coord cancelled; returns the per-(read, node) mask as bool."""
    hit = cnt > 0
    rl = lens[:, None].to(torch.int32)
    ref = seq_lens[None, :].to(torch.int32)
    kminz = torch.where(hit, kmin, 0)
    sat_thresh = torch.minimum(ref - 1, rl - 1 - kminz) - split_len + 2
    A = torch.minimum(rl, ref) - split_len + 1
    exp_num = A * (rl - split_len)
    return hit & ((cnt >= sat_thresh) | (cnt * rl >= exp_num))


@dataclass
class _DeviceTable:
    h1: torch.Tensor        # int32 [M] sorted biased h1
    pays: torch.Tensor      # int32 [M, D] packed payloads
    seq_lens: torch.Tensor  # int32 [N]
    node_bits: int
    split_len: int
    num_nodes: int


def _batch_core(q1, h2, valid, lens, tab: _DeviceTable, acc_nm, acc_sm):
    """Probe + stats + saturation + pair counts of one stacked end-batch,
    added into the int64 accumulators in place."""
    node_t = _sortfill_probe(q1, h2, valid, tab.h1, tab.pays,
                             tab.node_bits, tab.num_nodes)
    cnt, kmin = ck.stats_accum(node_t, tab.pays.shape[1], tab.num_nodes)
    sat = _saturate(cnt, kmin, lens, tab.seq_lens, tab.split_len)
    B = sat.shape[0] // 2
    ck.pair_counts(sat[:B], sat[B:], acc_nm, acc_sm)


def _pe_batch_wire(wire: torch.Tensor, T: int, tab: _DeviceTable, acc_nm,
                   acc_sm) -> None:
    """One batch in the compact wire format (uint8 [B, W])."""
    q1, h2, valid = ck.window_hashes_wire(wire, T, tab.split_len)
    _batch_core(q1, h2, valid, ck.wire_lens(wire), tab, acc_nm, acc_sm)


def _pe_batch_bytes(codes: torch.Tensor, lens: torch.Tensor,
                    tab: _DeviceTable, acc_nm, acc_sm) -> None:
    """One batch of stacked byte codes (uint8 [2B, T], int32 [2B])."""
    q1, h2, valid = ck.window_hashes_bytes(codes, lens, tab.split_len)
    _batch_core(q1, h2, valid, lens, tab, acc_nm, acc_sm)


# --------------------------------------------------------------------------
# compact wire format
#
# 2-bit packed bases + u16 lengths, one uint8 row per pair: fwd codes |
# rve codes | 4 length bytes (~3.9x fewer bytes than the code rows at
# 150 bp). Windows past a read's length are invalidated by the length
# test, so packed padding bits never match; chunks containing a non-ACGT
# base inside a read go through the byte feed, where the bad-code
# invalidation applies — identical matrices either way.
# --------------------------------------------------------------------------

def _pack_wire_np(fc, fl, rc, rl, T: int) -> np.ndarray:
    """Host-side wire packing of one chunk -> uint8 [B, 2*ceil(T/4) + 4]."""
    B = fc.shape[0]
    T4 = -(-T // 4)
    out = np.zeros((B, 2 * T4 + 4), dtype=np.uint8)

    def pack(codes, dst):
        c = np.where(codes < 4, codes, 0).astype(np.uint8)
        if c.shape[1] < 4 * T4:
            c = np.pad(c, ((0, 0), (0, 4 * T4 - c.shape[1])))
        dst[:] = (c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4)
                  | (c[:, 3::4] << 6))

    pack(fc, out[:, :T4])
    pack(rc, out[:, T4: 2 * T4])
    out[:, -4] = fl & 0xFF
    out[:, -3] = fl >> 8
    out[:, -2] = rl & 0xFF
    out[:, -1] = rl >> 8
    return out


def _stack_ends_np(fc, fl, rc, rl):
    """Stack fwd+rve reads into one (2B, T) end-batch, padding to a
    common read length with the bad code 255."""
    T = max(fc.shape[1], rc.shape[1])
    fc = np.pad(fc, ((0, 0), (0, T - fc.shape[1])), constant_values=255)
    rc = np.pad(rc, ((0, 0), (0, T - rc.shape[1])), constant_values=255)
    return (np.ascontiguousarray(np.concatenate([fc, rc])),
            np.concatenate([fl, rl]).astype(np.int32))


def _has_bad_in_read(codes: np.ndarray, lens: np.ndarray) -> bool:
    """True when any non-ACGT code sits INSIDE a read (padding past the
    length is exempt) — the wire format can't represent it."""
    cols = np.arange(codes.shape[1], dtype=np.int32)
    return bool(np.any((codes > 3) & (cols[None, :] < lens[:, None])))


def _wire_batches(reads: ReadPairBatch, batch_size: int,
                  force_bytes: bool = False):
    """Batch feed over the compact wire format (see _pack_wire_np), as
    host numpy arrays.

    Yields ("wire", uint8[B, W]) batches, falling back to
    ("bytes", (fc, fl, rc, rl)) for any batch holding an in-read
    non-ACGT code or reads too long for u16 lengths. Packing runs per
    batch — the C++ packer (native.wire_pack_native, check fused in) when
    available, numpy otherwise — so the host packs batch i+1 while the
    device runs batch i."""
    B = reads.num_pairs
    T = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
    wire_ok = T < 65536 and not force_bytes
    native_ok = False
    if wire_ok:
        from vstrains_tpu_torch import native as _native
        lib = _native.get_lib()
        native_ok = lib is not None and hasattr(lib, "wire_pack")
    for s in range(0, B, batch_size):
        e = min(s + batch_size, B)
        pad = batch_size - (e - s)
        fc = reads.fwd_codes[s:e]
        rc = reads.rve_codes[s:e]
        fl = reads.fwd_len[s:e]
        rl = reads.rve_len[s:e]
        if pad:
            # zero-length padding reads contribute nothing
            fc = np.pad(fc, ((0, pad), (0, 0)), constant_values=255)
            rc = np.pad(rc, ((0, pad), (0, 0)), constant_values=255)
            fl = np.pad(fl, (0, pad))
            rl = np.pad(rl, (0, pad))
        if wire_ok:
            if native_ok:
                wire = _native.wire_pack_native(fc, fl, rc, rl, T)
            elif not (_has_bad_in_read(fc, fl)
                      or _has_bad_in_read(rc, rl)):
                wire = _pack_wire_np(fc, fl, rc, rl, T)
            else:
                wire = None
            if wire is not None:
                yield ("wire", wire)
                continue
        yield ("bytes", (fc, fl, rc, rl))


def _length_buckets(reads: ReadPairBatch, split_len: int,
                    batch_size: int, multiple: int = 32,
                    min_frac: float = 0.10, min_saving: float = 0.15):
    """Width buckets for mixed-length libraries.

    Reads are padded to the dataset-wide maximum, so one 300bp read in a
    150bp library doubles every window count. Pairs are grouped by
    max(end lengths) rounded up to `multiple`; buckets holding under
    `min_frac` of the pairs merge into the next wider one. Returns a list
    of (width, index-array) in descending width order, or None when
    bucketing would save < `min_saving` of the window volume (uniform
    libraries, tiny datasets).

    Safe to reorder: the accumulated matrices are integer sums over
    pairs, invariant under any pair permutation."""
    n = reads.num_pairs
    if n < 4 * batch_size:
        return None
    t_max = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
    w = np.maximum(reads.fwd_len[:n], reads.rve_len[:n])
    w = np.maximum(w, split_len)
    w = np.minimum(-(-w // multiple) * multiple, t_max)
    widths, counts = np.unique(w, return_counts=True)
    if len(widths) == 1:
        return None
    # merge sub-threshold buckets upward (the widest always survives)
    kept = [int(wd) for wd, c in zip(widths, counts)
            if c >= min_frac * n or wd == widths[-1]]
    target = np.empty_like(w)
    for wd in sorted(kept, reverse=True):
        target[w <= wd] = wd
    vol = sum(int((target == wd).sum()) * wd for wd in kept)
    if vol > (1.0 - min_saving) * n * t_max:
        return None
    return [(wd, np.nonzero(target == wd)[0])
            for wd in sorted(kept, reverse=True)]


@dataclass
class PEResult:
    ids: List[str]
    node_mat: np.ndarray    # int64 [N, N]  fwd x rve PE links
    short_mat: np.ndarray   # int64 [N, N]  same-end co-occurrence links
    n_reads: int
    short_reads: int
    used_reads: int


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def infer_pe_links(ids: Sequence[str], seqs: Sequence[str],
                   reads: ReadPairBatch, kmer_size: int,
                   batch_size: int = 16384,
                   probe_mode: str = "sort",
                   stats_mode: str = "auto",
                   table: Optional[KmerTable] = None,
                   logger: logging.Logger = None,
                   device="cuda") -> PEResult:
    """End-to-end PE-link inference for pre-loaded reads, on `device`
    ("cuda" runs the CUDA kernels; "cpu" their plain torch versions).

    `kmer_size` is the graph k; windows are (k+1)-mers
    (PE_Inference.py:114). Per-batch link counts accumulate in int64
    device matrices, so the host loop just packs and streams batches
    while the device computes."""
    logger = logger or _LOG
    dev = resolve_device(device)
    split_len = kmer_size + 1
    if probe_mode not in ("sort", "sortfill"):
        raise NotPortedError(f"probe_mode={probe_mode!r} is not yet ported "
                             "(the port has the sortfill probe only)")
    if table is None:
        table = build_kmer_table(seqs, split_len)
    elif table.split_len != split_len:
        raise ValueError(f"prebuilt table has split_len {table.split_len},"
                         f" k={kmer_size} needs {split_len}")
    N = table.num_nodes
    logger.info("kmer table: %d entries, max_dup=%d, %d nodes",
                table.num_entries, table.max_dup, N)

    # dense/sparse cutover: the JAX engine's memory rule (only; its
    # backend-specific early cutovers were measured on CPU and TPU)
    budget_rows = max(512, (1_500_000_000 // (12 * (N + 1))) // 2)
    sparse = (stats_mode == "sparse"
              or (stats_mode == "auto" and batch_size > budget_rows))
    # don't pad small datasets up to a huge batch
    if reads.num_pairs and batch_size > reads.num_pairs:
        clamped = 512
        while clamped < reads.num_pairs:
            clamped *= 2
        if clamped < batch_size:
            logger.info("pe batch clamped %d -> %d for %d pairs",
                        batch_size, clamped, reads.num_pairs)
            batch_size = clamped
            if stats_mode == "auto":
                sparse = batch_size > budget_rows

    if reads.num_pairs == 0 or table.num_entries == 0:
        node_mat = np.zeros((N, N), dtype=np.int64)
        short_mat = np.zeros((N, N), dtype=np.int64)
        return PEResult(list(ids), node_mat, short_mat, reads.n_reads,
                        reads.short_reads, reads.used_reads)

    # the exact-integer saturation test needs count*rlen < 2^31, i.e.
    # rlen <= ~46k; PE reads are hundreds of bp, so fail loud rather
    # than overflow silently on absurd input
    max_rl = int(max(reads.fwd_len.max(initial=0),
                     reads.rve_len.max(initial=0)))
    if max_rl > 46340:
        raise ValueError(
            f"read length {max_rl} exceeds the engine's exact-integer "
            "saturation range (~46 kb); this engine targets paired-end "
            "short reads")

    if sparse:
        raise NotPortedError(
            f"the sparse PE engine is not yet ported (N={N} nodes, batch "
            f"{batch_size} > {budget_rows} dense rows, or "
            f"stats_mode='sparse')")
    node_bits = _sortfill_node_bits(N)
    if node_bits is None or table.max_dup > _SORTFILL_MAX_DUP:
        raise NotPortedError(
            f"the classic sort join is not yet ported (N={N}, max_dup="
            f"{table.max_dup} > {_SORTFILL_MAX_DUP} or node ids beyond "
            f"{_SORTFILL_MAX_NODE_BITS} bits)")

    tab = _DeviceTable(
        h1=torch.from_numpy(table.h1_biased).to(dev),
        pays=torch.from_numpy(_build_sortfill_payloads(table,
                                                       node_bits)).to(dev),
        seq_lens=torch.from_numpy(table.seq_lens).to(dev),
        node_bits=node_bits, split_len=split_len, num_nodes=N)
    acc_nm = torch.zeros((N, N), dtype=torch.int64, device=dev)
    acc_sm = torch.zeros((N, N), dtype=torch.int64, device=dev)

    # mixed-length libraries: feed per-width bucket sub-batches so short
    # reads don't pay the widest read's window count
    buckets = _length_buckets(reads, split_len, batch_size)
    if buckets is None:
        parts = [reads]
    else:
        logger.info("length buckets (width, pairs): %s",
                    [(wd, len(ix)) for wd, ix in buckets])
        parts = [ReadPairBatch(
            np.ascontiguousarray(reads.fwd_codes[ix, :wd]),
            reads.fwd_len[ix],
            np.ascontiguousarray(reads.rve_codes[ix, :wd]),
            reads.rve_len[ix], 0, 0, len(ix)) for wd, ix in buckets]

    for p in parts:
        Tp = max(p.fwd_codes.shape[1], p.rve_codes.shape[1])
        for kind, payload in _wire_batches(p, batch_size):
            if kind == "wire":
                _pe_batch_wire(torch.from_numpy(payload).to(dev), Tp, tab,
                               acc_nm, acc_sm)
            else:
                codes, lens = _stack_ends_np(*payload)
                _pe_batch_bytes(torch.from_numpy(codes).to(dev),
                                torch.from_numpy(lens).to(dev), tab,
                                acc_nm, acc_sm)

    return PEResult(list(ids), acc_nm.cpu().numpy(), acc_sm.cpu().numpy(),
                    reads.n_reads, reads.short_reads, reads.used_reads)


# --------------------------------------------------------------------------
# file-format parity (aln/pe_info, aln/st_info)
# --------------------------------------------------------------------------

def write_pe_files(result: PEResult, pe_path: str, st_path: str) -> None:
    """Write the N^2-line `u:v:count` files
    (parity: PE_Inference.py:190-207)."""
    ids = result.ids
    n = len(ids)
    with open(pe_path, "w") as f_pe, open(st_path, "w") as f_st:
        for i in range(n):
            u = ids[i]
            nrow = result.node_mat[i].tolist()
            srow = result.short_mat[i].tolist()
            f_pe.write("".join(
                f"{u}:{ids[j]}:{nrow[j]}\n" for j in range(n)))
            f_st.write("".join(
                f"{u}:{ids[j]}:{srow[j]}\n" for j in range(n)))


def write_pe_files_sparse(result: PEResult, pe_path: str,
                          st_path: str) -> None:
    """Write only the NONZERO `u:v:count` lines of the link matrices,
    row-major. The reference's loader (VStrains_IO.py:598-627, ours in
    process_pe_info) initializes every pair to 0, so these files load to
    the same stores as the full N^2-line format."""
    ids = result.ids
    for mat, path in ((result.node_mat, pe_path),
                      (result.short_mat, st_path)):
        us, vs = np.nonzero(mat)
        cs = mat[us, vs]
        with open(path, "w") as fh:
            fh.write("".join(
                f"{ids[u]}:{ids[v]}:{c}\n" for u, v, c in
                zip(us.tolist(), vs.tolist(), cs.tolist())))


def process_pe_info(node_ids: Sequence[str], pe_info_file: str,
                    st_info_file: str):
    """File-based PE-info loader — full parity with the reference
    (VStrains_IO.py:598-627), for interoperating with files produced by
    either engine. Returns (pe_info, dcpy)."""
    pe_info = {}
    node_ids = list(node_ids)
    for u in node_ids:
        for v in node_ids:
            pe_info[(min(u, v), max(u, v))] = 0
    for path in (pe_info_file, st_info_file):
        with open(path, "r") as fh:
            for line in fh:
                if line == "\n":
                    break
                parts = line[:-1].split(":")[:3]
                if len(parts) < 3:
                    continue
                u, v, mark = parts
                key = (min(u, v), max(u, v))
                if key in pe_info:
                    pe_info[key] += int(mark)
    return pe_info, dict(pe_info)


def pe_info_sparse_from_result(node_ids: Sequence[str], result: PEResult):
    """Vectorized sparse construction of the symmetric PE-link store:
    equivalent to pe_info_from_result but O(nonzero pairs) instead of
    O(N^2) Python loops, returning PEInfo stores whose missing pairs read
    as 0 (the reference's dense zero-init contract). Returns (pe_info,
    dcpy_pe_info)."""
    from vstrains_tpu_torch.core.pe_store import PEInfo

    ids = result.ids
    node_set = set(node_ids)
    keep = np.array([vid in node_set for vid in ids], dtype=bool)
    total = result.node_mat + result.short_mat
    sym = total + total.T
    pe = PEInfo()
    # off-diagonal upper triangle
    iu, ju = np.nonzero(np.triu(sym, k=1))
    for i, j in zip(iu.tolist(), ju.tolist()):
        if keep[i] and keep[j]:
            u, v = ids[i], ids[j]
            pe[(min(u, v), max(u, v))] = int(sym[i, j])
    # diagonal
    for i in np.nonzero(np.diagonal(total))[0].tolist():
        if keep[i]:
            u = ids[i]
            pe[(u, u)] = int(total[i, i])
    return pe, PEInfo(pe)


def pe_info_from_result(node_ids: Sequence[str], result: PEResult):
    """Symmetric pe_info dict keyed by lexicographic (min,max) id pairs,
    summing PE and single-strand counts — same contract as process_pe_info
    (VStrains_IO.py:598-627) minus the file round-trip. Returns (pe_info,
    dcpy_pe_info)."""
    pe_info = {}
    node_ids = list(node_ids)
    for u in node_ids:
        for v in node_ids:
            pe_info[(min(u, v), max(u, v))] = 0
    index = {vid: i for i, vid in enumerate(result.ids)}
    total = result.node_mat + result.short_mat
    for u in node_ids:
        iu = index.get(u)
        if iu is None:
            continue
        for v in node_ids:
            iv = index.get(v)
            if iv is None:
                continue
            key = (min(u, v), max(u, v))
            if u == v:
                pe_info[key] += int(total[iu][iu])
            elif u < v:
                # both orders of the matrix fold into the same key
                pe_info[key] += int(total[iu][iv]) + int(total[iv][iu])
    dcpy = dict(pe_info)
    return pe_info, dcpy

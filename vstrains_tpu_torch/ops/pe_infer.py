"""Paired-end link inference, dense and sparse engines — the PyTorch port
of `vstrains_tpu/ops/pe_infer.py`.

Host (numpy, as in the JAX package): the node sequences encoded for the
k-mer table, the compact wire format, length buckets, the output files
and the PE-info stores; the host build of the table (both strands, dual
32-bit window hashes, hash-sorted) and its packed sortfill payloads, the
device build's references and the sequence-parallel route's build.

Device (torch), once a call: the k-mer table built from the encoded
sequences (`_card_table`: both strands hashed by the CUDA kernel
`window_hashes`, one stable sort), bit for bit the host build's; a mesh
rank's shard of it; the payloads or the classic probe's record.

Device (torch), per batch of B read pairs stacked into one (2B, T)
end-batch, forward reads first:
  1. unpack the wire batch and hash every (k+1)-window  — CUDA kernel
     `window_hashes` (ops/cuda_kernels.py, csrc/window_hashes.cu);
  2. probe the table for each window's per-rank node ids. The packed
     probe ("sortfill", every graph within its packing): `torch.searchsorted`
     of each window's biased h1 into the sorted table, then one row gather
     of the packed payloads (tag | top h2 bits | node id per duplicate
     rank); a window matches an entry when h1 is equal and the top
     31 - node_bits bits of h2 are equal — exactly the accept rule of the
     JAX package's sortfill probe (`_sortfill_node_slots`,
     docs/DIVERGENCES.md #12), for any of its table strides. The classic
     probe (graphs beyond the packing: more than 2^18 nodes or duplicate
     runs longer than 16; the 'sortjoin', 'lookup' and 'searchsorted'
     modes): each window's first table position with h1 >= q1 (`_join_lo`,
     or the bucket index's `_lookup_lo`), then a walk of the duplicate run
     from there with the full 32-bit h1 and h2 equality, fused with step 3
     — CUDA kernel `dup_stats` (csrc/dup_stats.cu);
  3. per-(read, node) hit count and lowest window index — CUDA kernel
     `stats_accum` (the packed probe's slots);
  4. the reference's saturation test in exact int32 arithmetic
     (`_saturate`; the min ref coordinate cancels, see the JAX module's
     docstring);
  5. link counts node_mat += fᵀr, short_mat += triu(fᵀf + rᵀr) — CUDA
     kernel `pair_counts`, which adds straight into int64 device
     accumulators (so the JAX driver's int32 spill logic is gone).

Graphs above the dense/sparse cutover (the JAX package's memory rule,
`dense_budget_rows`) take the sparse engine instead of steps 3-5: the probe's
per-slot (node, window) pairs (the classic probe's from the CUDA kernel
`dup_scan`, csrc/dup_scan.cu) are row-sorted by (node, window) — CUDA
kernel `sort_rows` (csrc/sort_rows.cu) — and reduced to per-run counts and
lowest windows by running scans; the saturated nodes of each read
compact into a (2B, cap) list, whose link keys the CUDA kernel
`coo_accum` (csrc/coo_accum.cu) counts into two hash tables that live
for the pass, sorted into COO form at its end (`PESparseResult`).

One driver (`_engine`) serves one process and each rank of a (data,
model) mesh: parallel/mesh.py passes its rows, a table shard's collectives
and the end of a pass over the world as `_Seams`; the probe, the routes
and clamps, the length buckets and the drain are decided here alone.

On CPU tensors each kernel wrapper runs its plain torch version instead
(`--device cpu`, the CPU tests). Every probe mode and stats mode of the
JAX engine is served, with the JAX engine's routing and bit-equal
results; the JAX package's TPU-only machinery (its compile race, the
small-workload CPU fallback, the opt-in Pallas hash path and the int32
accumulator spill) has no counterpart here.
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
from vstrains_tpu_torch.utils.tracing import count, span

_LOG = logging.getLogger(__name__)

_INF = np.int32(2**31 - 1)
_BIAS = np.uint32(0x80000000)
# encode_seq's byte -> code map as a bytes.translate table (one pass in C,
# ~2x numpy's table lookup over a graph's sequences)
_CODE_OF_BYTE = encode_seq(bytes(range(256))).tobytes()


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


@dataclass
class EncodedTable:
    """The node sequences a KmerTable is built from, encoded once on the
    host: what the engine builds the table from on its device
    (_card_table)."""
    codes: np.ndarray       # uint8 [S]: the nodes joined by one bad code
                            # each, so a window over a node's end is invalid
    starts: np.ndarray      # int32 [N]: each node's first code
    seq_lens: np.ndarray    # int32 [N] node sequence lengths
    num_nodes: int
    split_len: int


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
    """Common tail of _build_kmer_table: bias/bitcast the sorted entry
    arrays and pad to the shape bucket."""
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


def _bucket_index(table: KmerTable):
    """The direct-address index that the 'lookup' probe reads, built when
    that probe runs (the JAX package's bucket_index=True table fields):
    (starts int32 [2^b + 1], shift, depth) over the real entries, so the
    padding cannot inflate the depth. starts[x] = #entries whose unsigned
    h1 >> shift < x (a bincount prefix sum); depth = the largest bucket's
    population, the find steps a window needs to reach its equal-h1 run."""
    h1 = table.h1_biased[:table.num_entries].view(np.uint32) ^ _BIAS
    if not h1.size:
        return np.zeros(2, np.int32), 32, 1
    bits = max(10, min(26, int(np.ceil(np.log2(2 * h1.size)))))
    shift = 32 - bits
    counts = np.bincount((h1 >> np.uint32(shift)).astype(np.int64),
                         minlength=(1 << bits))
    starts = np.empty((1 << bits) + 1, dtype=np.int64)
    starts[0] = 0
    np.cumsum(counts, out=starts[1:])
    return starts.astype(np.int32), shift, max(int(counts.max()), 1)


def build_kmer_table(seqs: Sequence[str], split_len: int) -> EncodedTable:
    """The node sequences encoded for the engine's table of all valid
    (k+1)-mers (both strands) of every node sequence, which it builds on
    its device (_card_table). Runs in the span `pe.table_build`."""
    with span("pe.table_build"):
        seq_lens = np.array([len(s) for s in seqs], dtype=np.int32)
        try:
            joined = "N".join(seqs)
        except TypeError:  # some sequences are bytes
            joined = "N".join(s if isinstance(s, str) else s.decode("ascii")
                              for s in seqs)
        codes = np.frombuffer(joined.encode("ascii").translate(_CODE_OF_BYTE),
                              dtype=np.uint8)
        starts = np.zeros(len(seqs), dtype=np.int32)
        np.cumsum(seq_lens[:-1] + 1, out=starts[1:])
        return EncodedTable(codes, starts, seq_lens, len(seqs), split_len)


def _build_kmer_table(seqs: Sequence[str], split_len: int,
                      pad_to_bucket: bool = True,
                      long_hash: Optional[tuple] = None) -> KmerTable:
    """The host build of the sorted dual-hash table of all valid
    (k+1)-mers (both strands) of every node sequence: what the tests hold
    the engine's device build to, and the sequence-parallel route's build.

    With pad_to_bucket, entry arrays pad to a power-of-two bucket with
    never-matching sentinels (h1 = INT32_MAX biased, h2 = -1).

    `long_hash` = (min_len, hash_fn): node sequences of at least min_len
    codes are hashed by hash_fn(codes) -> (h1, h2, valid) over all their
    windows (uint32, uint32, bool: core/seq.window_hashes_np's contract;
    parallel/mesh.build_table_auto passes the sequence-parallel step),
    the others by the host build; the table is the host build's, bit for
    bit."""
    h1s: List[np.ndarray] = []
    h2s: List[np.ndarray] = []
    nodes: List[np.ndarray] = []
    offsets: List[np.ndarray] = []
    seq_lens = np.array([len(s) for s in seqs], dtype=np.int32)

    # Long nodes (with long_hash) hash on their own through hash_fn.
    long_min = long_hash[0] if long_hash is not None else None
    host_seqs = (seqs if long_min is None else
                 ["" if len(s) >= long_min else s for s in seqs])
    # C++ fast path (hash both strands + sort) for the other nodes:
    # bit-identical to the numpy path below; the numpy path remains for
    # the no-toolchain fallback and as the oracle. Its sorted rows join
    # the long nodes' in the sort below.
    host_done = False
    if os.environ.get("VSTRAINS_NATIVE_TABLE", "1") != "0":
        from vstrains_tpu_torch import native as _native
        nat = _native.build_table_entries_native(host_seqs, split_len)
        if nat is not None:
            n_h1, n_h2, n_node, n_off, n_max_dup = nat
            if long_hash is None:
                return _finish_kmer_table(n_h1, n_h2, n_node, n_off,
                                          n_max_dup, len(seqs), split_len,
                                          seq_lens, pad_to_bucket)
            h1s.append(n_h1)
            h2s.append(n_h2)
            nodes.append(n_node)
            offsets.append(n_off)
            host_done = True

    # Every other node batches into ONE sentinel-separated concatenation
    # per strand. A window crossing a node boundary necessarily contains
    # the never-valid sentinel code, so boundary windows drop out through
    # the same validity mask as N bases.
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
        if long_min is not None and n >= long_min:
            codes = encode_seq(seq)
            f1, f2, fv = long_hash[1](codes)
            idx = np.nonzero(fv)[0]
            h1s.append(f1[idx])
            h2s.append(f2[idx])
            nodes.append(np.full(idx.shape, i, dtype=np.int32))
            offsets.append(idx.astype(np.int32))
            # rc window j <-> forward offset n-L-j
            r1, r2, rv = long_hash[1](revcomp_codes(codes))
            jdx = np.nonzero(rv)[0]
            h1s.append(r1[jdx])
            h2s.append(r2[jdx])
            nodes.append(np.full(jdx.shape, i, dtype=np.int32))
            offsets.append((n - split_len - jdx).astype(np.int32))
            continue
        if host_done:
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
# h1 runs longer than 16, take the classic probe (_join_lo / _lookup_lo
# and the dup_stats or dup_scan kernel).
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


def _join_lo(q1: torch.Tensor, tab_h1: torch.Tensor) -> torch.Tensor:
    """Each window's first table position with h1 >= q1, int32 [R, K]: a
    binary search. It equals the JAX package's sort-merge join
    (_hash_join_impl, _join_from_q1: the count of table entries before the
    query in the stable argsort of [queries, table]). The 'searchsorted'
    probe (_probe_stats) scans from this same left bound; its `idx < hi`
    mask is the scan's equal-h1 test, since the table is sorted."""
    return torch.searchsorted(tab_h1, q1.reshape(-1), side="left").to(
        torch.int32).reshape(q1.shape)


def _lookup_lo(q1: torch.Tensor, bstarts: torch.Tensor,
               tab_h1: torch.Tensor, shift: int,
               probe_depth: int) -> torch.Tensor:
    """The JAX package's two-phase direct-address lookup (_hash_lookup_impl,
    _lookup_from_q1), int32 [R, K]: one gather into the bucket index at
    the window's bucket (its unsigned h1 >> shift, taken in int64), then
    probe_depth find steps for the first equal h1 in the bucket; a window
    not found keeps M, the padded table length."""
    M = tab_h1.shape[0]
    h1 = q1.to(torch.int64) + 2**31  # undo the sign bias: h1 as unsigned
    base = bstarts[h1 >> shift].to(torch.int64)
    found = torch.full_like(base, M)
    for p in range(probe_depth):
        pos = base + p
        idx = pos.clamp(max=M - 1)
        hit = (tab_h1[idx] == q1) & (pos < M) & (found == M)
        found = torch.where(hit, idx, found)
    return found.to(torch.int32)


@dataclass
class _DeviceTable:
    """The table arrays one probe reads, on the run's device: the packed
    probe carries h2 and node inside its payloads, and only the lookup
    builds and reads the bucket index (the JAX engine uploads the same
    subsets)."""
    probe: str              # "sortfill", "join" or "lookup"
    h1: torch.Tensor        # int32 [M] sorted biased h1, padded
    seq_lens: torch.Tensor  # int32 [N]
    split_len: int
    num_nodes: int
    depth: int              # duplicate ranks a window scans
    pays: Optional[torch.Tensor] = None     # sortfill: int32 [M, depth]
    node_bits: int = 9
    # join, lookup: the table dup_stats / dup_scan walk, one int32 [M, 4]
    # record (h1, h2, node, 0) an entry (cuda_kernels.table_record)
    rec: Optional[torch.Tensor] = None
    bstarts: Optional[torch.Tensor] = None  # lookup: int32 [2^b + 1]
    shift: int = 32
    scan_depth: int = 1


def _upload(arr: np.ndarray, dev) -> torch.Tensor:
    """A host array on `dev`; its bytes count as the engine's H2D
    (`pe.h2d_bytes`, on any device)."""
    count("pe.h2d_bytes", arr.nbytes)
    return torch.from_numpy(arr).to(dev)


@dataclass
class _CardTable:
    """A table's entries on the run's device: a KmerTable's padded entry
    arrays as int32 tensors, under its names (the engine's device build,
    _card_table, or a host table's copy, _upload_table)."""
    h1_biased: torch.Tensor
    h2: torch.Tensor
    node: torch.Tensor
    offset: torch.Tensor
    max_dup: int
    num_nodes: int
    split_len: int
    num_entries: int
    seq_lens: torch.Tensor  # int32 [N]


_CARD_ROW_WINDOWS = 512  # windows a row of the device build's hash rows
_I64_MAX = 2**63 - 1
_TAG = -2**31            # a payload's bit 31, as int32


def _card_table(enc: EncodedTable, dev) -> _CardTable:
    """The table of the encoded sequences built on `dev`, bit for bit the
    host build's (_build_kmer_table: entries, tie order, padding,
    max_dup), in the span `pe.table_upload` (counter
    `pe.table_card_builds`):

      * one H2D: node starts and lengths and the codes, padded with bad
        codes to whole rows of _CARD_ROW_WINDOWS windows;
      * the reverse complement of the padded codes made on the device,
        so that its window R*K - 1 - q is the other strand of forward
        window q; both strands cut into rows that overlap by split_len - 1
        and hashed by cuda_kernels.window_hashes_bytes, the batches'
        kernel (its plain version on the CPU);
      * window q's two entries side by side, the valid ones moved to the
        front in that (node, offset) order, then one stable sort of the
        packed int64 key (h1_biased << 32 | uint32 h2): entries with one
        key stay in (node, offset) order, the host build's tie order (a
        forward and a reverse entry at one (node, offset) with one key
        are the same four values);
      * max_dup, the longest run of equal h1 among the real entries, and
        their count read back in one D2H of two integers;
      * padding to _bucket_size with the host build's sentinels."""
    with span("pe.table_upload"):
        count("pe.table_card_builds")
        N, L, S = enc.num_nodes, enc.split_len, enc.codes.size
        K = _CARD_ROW_WINDOWS
        R = -(-(S - L + 1) // K)
        if R <= 0:
            return _empty_card(enc, _upload(enc.seq_lens, dev))
        host = np.empty(8 * N + R * K + L - 1, dtype=np.uint8)
        ints = host[:8 * N].view(np.int32)
        ints[:N], ints[N:] = enc.starts, enc.seq_lens
        host[8 * N:8 * N + S] = enc.codes
        host[8 * N + S:] = 255
        buf = _upload(host, dev)
        ints = buf[:8 * N].view(torch.int32)
        starts, seq_lens, fwd = ints[:N], ints[N:], buf[8 * N:]
        # x ^ 3 complements codes 0-3 and keeps the bad codes (>= 4) bad
        rows = torch.stack([fwd, fwd.flip(0) ^ 3]).unfold(
            1, K + L - 1, K).reshape(2 * R, K + L - 1)
        q1, h2, valid = ck.window_hashes_bytes(
            rows, torch.full((2 * R,), K + L - 1, dtype=torch.int32,
                             device=dev), L)
        # the int32 pair (h2, q1) read as one int64: q1 << 32 | uint32 h2
        key = torch.stack([h2, q1], dim=-1).view(torch.int64).reshape(2, -1)
        key = torch.stack([key[0], key[1].flip(0)], dim=1).reshape(-1)
        ok = valid.reshape(2, -1)
        ok = torch.stack([ok[0], ok[1].flip(0)], dim=1).reshape(-1)
        n = key.shape[0]
        before = torch.cumsum(ok, 0)
        m_dev = before[-1]
        # the valid entries to the front, the others to a dropped slot
        sort_in = torch.full((n + 1,), _I64_MAX, dtype=torch.int64,
                             device=dev)
        sort_in.index_copy_(0, torch.where(ok, before - 1, n), key)
        key, order = torch.sort(sort_in[:n], stable=True)
        # each real entry's place in its run of equal h1
        h1 = key >> 32
        pos = torch.arange(n, device=dev)
        gap = torch.where(pos < m_dev, pos - torch.searchsorted(h1, h1), -1)
        M, max_gap = _read_back(torch.stack([m_dev, gap.max()]))
        if M == 0:
            return _empty_card(enc, seq_lens)
        out = torch.empty((4, _bucket_size(M)), dtype=torch.int32,
                          device=dev)
        h2_h1, node, offset = out[:2], out[2], out[3]
        h2_h1[:, :M].T.copy_(key[:M].view(torch.int32).view(M, 2))
        h2_h1[0, M:] = -1
        h2_h1[1, M:] = int(_INF)
        out[2:, M:] = 0
        # the i-th valid entry's window: the first place where before > i
        win = torch.searchsorted(before, order[:M], right=True,
                                 out_int32=True).bitwise_right_shift_(1)
        torch.searchsorted(starts[1:], win, right=True, out_int32=True,
                           out=node[:M])
        torch.sub(win, starts[node[:M]], out=offset[:M])
        return _CardTable(out[1], out[0], node, offset, max_gap + 1, N, L,
                          M, seq_lens)


def _upload_table(table: KmerTable, dev) -> _CardTable:
    """A host-built table's entries copied to `dev` (the span
    `pe.table_upload`)."""
    with span("pe.table_upload"):
        return _CardTable(*(_upload(a, dev) for a in (
            table.h1_biased, table.h2, table.node, table.offset)),
            table.max_dup, table.num_nodes, table.split_len,
            table.num_entries, _upload(table.seq_lens, dev))


def _empty_card(enc: EncodedTable, seq_lens: torch.Tensor) -> _CardTable:
    z = seq_lens.new_zeros(0)
    return _CardTable(z, z, z, z, 1, enc.num_nodes, enc.split_len, 0,
                      seq_lens)


def _read_back(vals: torch.Tensor) -> list:
    """A few device integers as Python ints: one D2H, counted in
    `pe.d2h_bytes`."""
    count("pe.d2h_bytes", vals.nbytes)
    return vals.tolist()


def _card_payloads(card: _CardTable, node_bits: int) -> torch.Tensor:
    """_build_sortfill_payloads' matrix of a device table, on its device:
    int32 [M, min(max_dup, 16)], the padding's rows included."""
    h1 = card.h1_biased
    M = h1.shape[0]
    D = min(card.max_dup, _SORTFILL_MAX_DUP)
    # each entry's payload word, tag | h2's top 30 - node_bits bits |
    # node (the arithmetic shift's sign bit lands under the tag), then D
    # - 1 zero words: an entry past the table never matches
    word = h1.new_zeros(M + D - 1)
    torch.bitwise_and(card.h2, -(1 << (node_bits + 1)), out=word[:M])
    word[:M].bitwise_right_shift_(1).bitwise_or_(card.node).bitwise_or_(_TAG)
    h1 = torch.cat([h1, h1[:D - 1]]).unfold(0, D, 1)
    return torch.where(h1 == h1[:, :1], word.unfold(0, D, 1), 0)


def _card_bucket_index(card: _CardTable):
    """_bucket_index of a device table, on its device: (starts, shift,
    depth), the depth read back."""
    m = card.num_entries
    if not m:
        return card.h1_biased.new_zeros(2), 32, 1
    bits = max(10, min(26, int(np.ceil(np.log2(2 * m)))))
    h1 = card.h1_biased[:m].to(torch.int64) + 2**31  # h1 as unsigned
    counts = torch.zeros(1 << bits, dtype=torch.int64, device=h1.device)
    counts.index_add_(0, h1 >> (32 - bits), torch.ones_like(h1))
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    depth, = _read_back(counts.max().reshape(1))
    return starts.to(torch.int32), 32 - bits, max(depth, 1)


def _device_table(card: _CardTable, probe: str) -> _DeviceTable:
    """What `probe` reads of a device table (the span `pe.table_upload`):
    the sortfill payloads, or the classic probe's record and, for the
    lookup, its bucket index, made on the table's device."""
    with span("pe.table_upload"):
        tab = _DeviceTable(probe, card.h1_biased, card.seq_lens,
                           card.split_len, card.num_nodes, card.max_dup)
        if probe == "sortfill":
            tab.node_bits = _sortfill_node_bits(card.num_nodes)
            tab.pays = _card_payloads(card, tab.node_bits)
            tab.depth = tab.pays.shape[1]
            return tab
        tab.rec = ck.table_record(tab.h1, card.h2, card.node)
        if probe == "lookup":
            tab.bstarts, tab.shift, tab.scan_depth = _card_bucket_index(card)
        return tab


def _classic_lo(q1, tab: _DeviceTable) -> torch.Tensor:
    """Each window's table position for the classic probe's walk, int32
    [R, K]: the bucket lookup's or the join's."""
    if tab.probe == "lookup":
        return _lookup_lo(q1, tab.bstarts, tab.h1, tab.shift, tab.scan_depth)
    return _join_lo(q1, tab.h1)


def _batch_stats(q1, h2, valid, tab: _DeviceTable):
    """Probe + per-(read, node) stats of one stacked end-batch, (cnt,
    kmin) int32 [2B, N] (kmin INT32_MAX where cnt is 0): the packed
    probe's slots through stats_accum, or the classic probe's walk fused
    with the stats (dup_stats). Against a table shard these are the
    shard's partials, which merge across shards by (sum, min)."""
    if tab.probe == "sortfill":
        node_t = _sortfill_probe(q1, h2, valid, tab.h1, tab.pays,
                                 tab.node_bits, tab.num_nodes)
        return ck.stats_accum(node_t, tab.depth, tab.num_nodes)
    return ck.dup_stats(q1, h2, valid, _classic_lo(q1, tab), tab.rec,
                        tab.depth, tab.num_nodes)


def _batch_pairs(cnt, kmin, lens, tab: _DeviceTable, acc_nm,
                 acc_sm) -> None:
    """Saturation + pair counts of one end-batch's stats, added into the
    int64 accumulators in place."""
    sat = _saturate(cnt, kmin, lens, tab.seq_lens, tab.split_len)
    B = sat.shape[0] // 2
    ck.pair_counts(sat[:B], sat[B:], acc_nm, acc_sm)


def _upload_batch(kind: str, payload, dev) -> tuple:
    """One batch that _wire_batches yielded, on `dev`: (wire,) or (codes,
    lens) of its stacked end-batch. A byte batch is stacked in the span
    `pe.pack`; the H2D runs in `pe.upload`."""
    if kind == "wire":
        host = (payload,)
    else:
        with span("pe.pack"):
            host = _stack_ends_np(*payload)
    with span("pe.upload"):
        count("pe.batches")
        return tuple(_upload(x, dev) for x in host)


def _batch_hashes(kind: str, feed: tuple, T: int, split_len: int):
    """Window hashes of an uploaded batch: (q1, h2, valid, lens) of its
    stacked (2B, K) end-batch."""
    if kind == "wire":
        wire, = feed
        return (*ck.window_hashes_wire(wire, T, split_len),
                ck.wire_lens(wire))
    codes, lens = feed
    return (*ck.window_hashes_bytes(codes, lens, split_len), lens)


# --------------------------------------------------------------------------
# device: sparse per-batch stats (large-N engine)
#
# Nothing N-wide per batch: each read's matched (node, window) slots are
# row-sorted by node id (CUDA kernel `sort_rows`), per-(read, node) count
# and lowest window fall out of running scans over each sorted row, and
# the saturated nodes compact into a small (2B, cap) list. Link counts
# accumulate as (u * N + v) -> count keys in the device's link tables
# (CUDA kernel `coo_accum`).
# --------------------------------------------------------------------------

_I32_MAX = 2**31 - 1


def _segmented_scans(startf, start_val, kidx_s):
    """Row-wise segmented (max, min) scans with reset flags: within each
    run of a sorted row, the run's start position and the running min
    k-index. A log-step (Hillis-Steele) scan of the JAX package's
    associative combine."""
    f, s, k = startf, start_val, kidx_s
    R = f.shape[1]
    d = 1
    while d < R:
        fa, sa, ka = f[:, :-d], s[:, :-d], k[:, :-d]
        fb, sb, kb = f[:, d:], s[:, d:], k[:, d:]
        s = torch.cat([s[:, :d], torch.where(fb, sb, torch.maximum(sa, sb))],
                      dim=1)
        k = torch.cat([k[:, :d], torch.where(fb, kb, torch.minimum(ka, kb))],
                      dim=1)
        f = torch.cat([f[:, :d], fa | fb], dim=1)
        d *= 2
    return s, k


def _row_run_stats(node_key, kidx_v, num_nodes: int,
                   kmax: Optional[int] = None):
    """Row-sort matched (node, k-index) slots and reduce each equal-node
    run to (count, min-k).

    Returns (node_s, cnt, kmin, is_end), all int32/bool [B2, R]: the sorted
    node ids, the running per-run count / min-k (exact at run ends) and
    the run-end mask (sentinel runs excluded). With `kmax` (exclusive
    bound on kidx) and node ids small enough that node << kbits | kidx
    fits int31, the sort carries one packed operand and one cummax
    replaces the two-plane scan, as in the JAX package; otherwise the
    two-operand sort and the segmented scans."""
    B2, R = node_key.shape
    N = num_nodes
    kbits = max(1, int(kmax - 1).bit_length()) if kmax else None
    packed = (kmax is not None
              and ((N - 1) << kbits) | (kmax - 1) < _I32_MAX
              and ((R - 1) << kbits) | (kmax - 1) < _I32_MAX)
    if packed:
        kmask = (1 << kbits) - 1
        v = torch.where(node_key == _I32_MAX, _I32_MAX,
                        (node_key << kbits) | kidx_v)
        v_s = ck.sort_rows(v.contiguous())
        node_s = torch.where(v_s == _I32_MAX, _I32_MAX, v_s >> kbits)
        kidx_s = v_s & kmask
    else:
        node_s, kidx_s = ck.sort_rows(node_key.contiguous(),
                                      kidx_v.contiguous())

    prev = torch.cat([torch.full((B2, 1), -1, dtype=torch.int32,
                                 device=node_s.device), node_s[:, :-1]], 1)
    startf = node_s != prev
    pos = torch.arange(R, dtype=torch.int32,
                       device=node_s.device).expand(B2, R)
    if packed:
        # the run start's (pos, kidx) packed: start values increase with
        # pos and non-starts carry -1, so the running max is the latest
        # start, and kidx at a run start is the run's min (the sort
        # orders kidx ascending within a node)
        sv = torch.where(startf, (pos << kbits) | kidx_s, -1)
        ps = torch.cummax(sv, dim=1).values
        startpos = ps >> kbits
        kmin = ps & kmask
    else:
        start_val = torch.where(startf, pos, -1)
        startpos, kmin = _segmented_scans(startf, start_val, kidx_s)

    nxt = torch.cat([node_s[:, 1:], torch.full((B2, 1), -1,
                                               dtype=torch.int32,
                                               device=node_s.device)], 1)
    is_end = (node_s != nxt) & (node_s != _I32_MAX)
    cnt = pos - startpos + 1
    return node_s, cnt, kmin, is_end


def _sat_ok(node_s, cnt, kmin, lens, seq_lens, split_len: int):
    """The reference saturation test in exact integers (the algebra of
    _saturate), elementwise; callers mask to run ends."""
    rl = lens[:, None].to(torch.int32)
    N = seq_lens.shape[0]
    ref = seq_lens[node_s.clamp(0, N - 1).to(torch.int64)].to(torch.int32)
    sat_thresh = torch.minimum(ref - 1, rl - 1 - kmin) - split_len + 2
    A = torch.minimum(rl, ref) - split_len + 1
    exp_num = A * (rl - split_len)
    return (cnt >= sat_thresh) | (cnt * rl >= exp_num)


def _compact_rows(ok, node_s, cap: int):
    """Compact the ok entries of each row into a (B2, cap) list (-1
    padded, source order kept); returns (out, overflow, counts). The JAX
    scatter drops out-of-range targets; here they land in a spare last
    column that is cut off."""
    B2, R = node_s.shape
    sidx = torch.cumsum(ok.to(torch.int32), dim=1, dtype=torch.int32) - 1
    overflow = torch.any(ok & (sidx >= cap))
    tgt = torch.where(ok & (sidx < cap), sidx, cap).to(torch.int64)
    out = torch.full((B2, cap + 1), -1, dtype=torch.int32,
                     device=node_s.device)
    out.scatter_(1, tgt, node_s)
    counts = sidx[:, -1] + 1
    return out[:, :cap], overflow, counts


def _sort_compact_runs(node_s, cnt, kmin, is_end, cap_c: int):
    """Compact every run-end (node, count, min-k) triple to the first
    cap_c columns: one row sort of (candidate index, column) and one
    gather by the sorted column. Candidate indices below cap_c are unique,
    so those columns are JAX's wherever `valid` holds. Returns (valid,
    node, cnt, kmin) as (B2, cap_c) planes and the candidate-overflow
    flag."""
    B2, R = node_s.shape
    csidx = torch.cumsum(is_end.to(torch.int32), dim=1,
                         dtype=torch.int32) - 1
    cand_ovf = torch.any(is_end & (csidx >= cap_c))
    key = torch.where(is_end & (csidx < cap_c), csidx, _I32_MAX)
    col = torch.arange(R, dtype=torch.int32,
                       device=node_s.device).expand(B2, R).contiguous()
    key_s, col_s = ck.sort_rows(key.contiguous(), col)
    idx = col_s[:, :cap_c].to(torch.int64)
    valid = key_s[:, :cap_c] != _I32_MAX
    return (valid, node_s.gather(1, idx), cnt.gather(1, idx),
            kmin.gather(1, idx), cand_ovf)


def _sparse_sat_tail(node_key, kidx_v, lens, seq_lens, split_len: int,
                     cap: int, kmax: Optional[int] = None, cap_c: int = 32):
    """Row-sort stats, then two-phase saturation: compact every run to
    (B2, cap_c) first and test saturation on the narrow planes. A read
    with more than cap_c distinct matched nodes, or more than cap
    saturated ones, raises the overflow flag; the run retries with
    larger caps. Returns (out, overflow, counts)."""
    node_s, cnt, kmin, is_end = _row_run_stats(
        node_key, kidx_v, seq_lens.shape[0], kmax)
    if cap_c >= node_s.shape[1]:
        # cap_c covers every slot: the narrow phase cannot drop runs
        ok = is_end & _sat_ok(node_s, cnt, kmin, lens, seq_lens, split_len)
        return _compact_rows(ok, node_s, cap)
    valid, node_c, cnt_c, kmin_c, cand_ovf = _sort_compact_runs(
        node_s, cnt, kmin, is_end, cap_c)
    ok = valid & _sat_ok(node_c, cnt_c, kmin_c, lens, seq_lens, split_len)
    node_m = torch.where(ok, node_c, _I32_MAX)
    out, ovf2, counts = _compact_rows(ok, node_m, cap)
    return out, cand_ovf | ovf2, counts


def _slot_planes(q1, h2, valid, tab: _DeviceTable):
    """The sparse tail's per-slot (node_key, kidx_v) planes, int32 [2B,
    K * depth] (INT32_MAX for a miss): the classic probe's straight from
    dup_scan (the JAX package's _sparse_expand_matches), the packed
    probe's built from its slots."""
    N = tab.num_nodes
    if tab.probe != "sortfill":
        return ck.dup_scan(q1, h2, valid, _classic_lo(q1, tab), tab.rec,
                           tab.depth)
    node_t = _sortfill_probe(q1, h2, valid, tab.h1, tab.pays,
                             tab.node_bits, N)
    B2, R = node_t.shape
    matched = node_t < N
    node_key = torch.where(matched, node_t, _I32_MAX)
    kidx = (torch.arange(R, dtype=torch.int32, device=node_t.device)
            // tab.depth).expand(B2, R)
    return node_key, torch.where(matched, kidx, _I32_MAX)


def _sparse_core(q1, h2, valid, lens, tab: _DeviceTable, cap: int,
                 cap_c: int):
    """Probe + sparse tail of one stacked end-batch: (out [2B, cap]
    saturated node ids ascending, -1 padded; overflow; counts)."""
    node_key, kidx_v = _slot_planes(q1, h2, valid, tab)
    return _sparse_sat_tail(node_key, kidx_v, lens, tab.seq_lens,
                            tab.split_len, cap, kmax=q1.shape[1],
                            cap_c=cap_c)


def _sparse_run_stats_compact(node_key, kidx_v, num_nodes: int,
                              kmax: Optional[int], cap_c: int):
    """Per-shard candidate lists for the table-parallel sparse engine:
    every distinct matched node of each read with its local (count,
    min-k) partial, compacted to (B2, cap_c) planes (-1 / 0 / INT32_MAX
    padded, node-ascending), and the candidate-overflow flag. Partials
    from different table shards merge exactly in _sparse_merge_sat_tail
    (integer sum and min)."""
    node_s, cnt, kmin, is_end = _row_run_stats(node_key, kidx_v,
                                               num_nodes, kmax)
    valid, node_c, cnt_c, kmin_c, overflow = _sort_compact_runs(
        node_s, cnt, kmin, is_end, min(cap_c, node_s.shape[1]))
    pad = cap_c - node_c.shape[1]
    planes = (torch.where(valid, node_c, -1), torch.where(valid, cnt_c, 0),
              torch.where(valid, kmin_c, _I32_MAX))
    if pad > 0:  # cap_c exceeded the slot width; pad the planes
        planes = tuple(torch.nn.functional.pad(x, (0, pad), value=v)
                       for x, v in zip(planes, (-1, 0, _I32_MAX)))
    return (*planes, overflow)


def _sparse_merge_sat_tail(nodes, cnts, kmins, lens, seq_lens,
                           split_len: int, cap: int):
    """Merge gathered per-shard candidate lists into the saturated-node
    lists: a row sort by node id (its packed (node, column) key through
    sort_rows, then a gather of the partial counts and min-k; order
    within a node is free, the merge being (sum, min)), segmented
    (sum, min) over each node's partials, then the saturation test and
    compaction. Padding entries (node -1 -> INT32_MAX, count 0) sort last
    and are excluded by the run-end mask. Returns (out, overflow,
    counts), as _sparse_sat_tail."""
    B2, C = nodes.shape
    dev = nodes.device
    node_key = torch.where(nodes >= 0, nodes, _I32_MAX).contiguous()
    col = torch.arange(C, dtype=torch.int32, device=dev).expand(
        B2, C).contiguous()
    node_s, col_s = ck.sort_rows(node_key, col)
    idx = col_s.to(torch.int64)
    cnt_s = cnts.gather(1, idx)
    kmin_s = kmins.gather(1, idx)
    prev = torch.cat([torch.full((B2, 1), -1, dtype=torch.int32, device=dev),
                      node_s[:, :-1]], 1)
    startf = node_s != prev
    pos = torch.arange(C, dtype=torch.int32, device=dev).expand(B2, C)
    startpos, kmin_tot = _segmented_scans(
        startf, torch.where(startf, pos, -1), kmin_s)
    # a run's sum: the running total at its end less the total before
    # its start
    cs = torch.cumsum(cnt_s, dim=1, dtype=torch.int32)
    before = (cs - cnt_s).gather(1, startpos.to(torch.int64))
    nxt = torch.cat([node_s[:, 1:], torch.full((B2, 1), -1,
                                               dtype=torch.int32,
                                               device=dev)], 1)
    is_end = (node_s != nxt) & (node_s != _I32_MAX)
    ok = is_end & _sat_ok(node_s, cs - before, kmin_tot, lens, seq_lens,
                          split_len)
    return _compact_rows(ok, node_s, cap)


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
    device runs batch i. Each batch is packed in the span `pe.pack`."""
    B = reads.num_pairs
    T = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
    wire_ok = T < 65536 and not force_bytes
    native_ok = False
    if wire_ok:
        from vstrains_tpu_torch import native as _native
        lib = _native.get_lib()
        native_ok = lib is not None and hasattr(lib, "wire_pack")
    for s in range(0, B, batch_size):
        with span("pe.pack"):
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
            wire = None
            if wire_ok:
                if native_ok:
                    wire = _native.wire_pack_native(fc, fl, rc, rl, T)
                elif not (_has_bad_in_read(fc, fl)
                          or _has_bad_in_read(rc, rl)):
                    wire = _pack_wire_np(fc, fl, rc, rl, T)
            item = (("bytes", (fc, fl, rc, rl)) if wire is None
                    else ("wire", wire))
        yield item


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


@dataclass
class PESparseResult:
    """COO form of the link matrices (the sparse engine's output): keys
    are u * num_nodes + v (int64, sorted unique), counts int64 —
    node_mat[u, v] == the pair count."""
    ids: List[str]
    pair_keys: np.ndarray
    pair_counts: np.ndarray
    short_keys: np.ndarray
    short_counts: np.ndarray
    n_reads: int
    short_reads: int
    used_reads: int


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def dense_budget_rows(num_nodes: int) -> int:
    """The dense/sparse cutover: the largest batch (in pairs) the dense
    engine takes at `num_nodes`; `stats_mode="auto"` sends a larger batch
    to the sparse engine. The JAX engine's memory rule (only; its
    backend-specific early cutovers were measured on CPU and TPU)."""
    return max(512, (1_500_000_000 // (12 * (num_nodes + 1))) // 2)


_PROBE_MODES = ("sort", "sortfill", "sortjoin", "lookup", "searchsorted")


def _route_probe(probe_mode: str, sparse: bool, table: _CardTable,
                 logger: logging.Logger) -> str:
    """The JAX engine's probe choice, a function of the whole table alone
    (so every device picks the same probe): "sortfill" (the packed probe),
    "join" or "lookup". The packed probe needs node ids of at most 18
    bits and duplicate runs of at most 16; the sparse engine takes it only
    for "sort" (JAX infer_pe_links and _infer_pe_links_sparse).
    "searchsorted" is an alias of "sortjoin" here: the JAX engine's
    searchsorted probe scans from the join's left bound (_join_lo)."""
    fits = (_sortfill_node_bits(table.num_nodes) is not None
            and table.max_dup <= _SORTFILL_MAX_DUP)
    if probe_mode == "lookup":
        return "lookup"
    if probe_mode == "sort" and fits:
        return "sortfill"
    if probe_mode == "sortfill" and not sparse:
        if fits:
            return "sortfill"
        logger.warning("probe_mode=sortfill unsupported here (N=%d, "
                       "max_dup=%d > %d or id overflow); using the classic "
                       "sort join instead", table.num_nodes, table.max_dup,
                       _SORTFILL_MAX_DUP)
    return "join"


def _is_sparse(stats_mode: str, batch_size: int, num_nodes: int) -> bool:
    """The dense/sparse cutover: "auto" takes the sparse engine for a
    batch past dense_budget_rows (looked up by name at each call)."""
    return stats_mode == "sparse" or (
        stats_mode == "auto" and batch_size > dense_budget_rows(num_nodes))


def _empty_result(ids, reads: ReadPairBatch, num_nodes: int,
                  sparse: bool = False):
    """The links of an input with no pairs or a table with no entries:
    the all-zero PEResult, which the engine returns on either route (as
    the JAX engine does), or with `sparse` the empty PESparseResult, for
    the callers that promise one."""
    if sparse:
        z = np.zeros(0, np.int64)
        return PESparseResult(list(ids), z, z.copy(), z.copy(), z.copy(),
                              reads.n_reads, reads.short_reads,
                              reads.used_reads)
    z = np.zeros((num_nodes, num_nodes), dtype=np.int64)
    return PEResult(list(ids), z, z.copy(), reads.n_reads,
                    reads.short_reads, reads.used_reads)


class _Seams:
    """Where a rank of a (data, model) mesh runs the engine driver
    differently from one process. This class is one process's (`_ONE`);
    parallel/mesh.py passes a subclass for its ranks. Three seams:

      rows: the batches this rank runs (`rows`; `n_data` ranks split
        each batch);
      a table shard's partials: the part of the table this rank probes
        (`shard`, on the device), a batch's dense stats (`stats`) or
        sparse saturated lists (`lists`) made whole, and whether this
        rank counts the links (`counts`);
      the end of a pass: the dense accumulators before the drain
        (`end_dense`), a sparse pass's outcome (`end_pass`) and the
        final COO (`merge`)."""
    n_data = 1
    counts = True

    def rows(self, reads: ReadPairBatch, batch_size: int,
             force_bytes: bool = False):
        return _wire_batches(reads, batch_size, force_bytes)

    def shard(self, card: _CardTable) -> _CardTable:
        return card

    def stats(self, cnt, kmin):
        return cnt, kmin

    def lists(self, q1, h2, valid, lens, tab: _DeviceTable, cap: int,
              cap_c: int):
        return _sparse_core(q1, h2, valid, lens, tab, cap, cap_c)[:2]

    def end_dense(self, acc_nm, acc_sm) -> None:
        pass

    def end_pass(self, coo):
        return coo

    def merge(self, coo):
        return coo


_ONE = _Seams()


def infer_pe_links(ids: Sequence[str], seqs: Sequence[str],
                   reads: ReadPairBatch, kmer_size: int,
                   batch_size: int = 16384,
                   probe_mode: str = "sort",
                   stats_mode: str = "auto",
                   table=None,
                   logger: logging.Logger = None,
                   device="cuda"):
    """End-to-end PE-link inference for pre-loaded reads, on `device`
    ("cuda" runs the CUDA kernels; "cpu" their plain torch versions).

    `kmer_size` is the graph k; windows are (k+1)-mers
    (PE_Inference.py:114). Below the dense/sparse cutover (or with
    stats_mode="dense") per-batch link counts accumulate in int64 device
    matrices and the result is a PEResult; above it (or with
    stats_mode="sparse") the sparse engine returns a PESparseResult.

    probe_mode (all give identical links, as in the JAX package): "sort"
    takes the packed probe where the graph fits its packing and the
    classic sort join elsewhere; "sortfill" asks for the packed probe
    (the dense engine warns and joins beyond the packing; the sparse
    engine always joins); "sortjoin" forces the join, and "searchsorted"
    is its alias; "lookup" probes a bucket index of the table, built for
    this call.

    `table`: build_kmer_table(seqs, k + 1), built on the device by this
    call, or a host-built KmerTable (parallel/mesh.build_table_auto's
    sequence-parallel build), copied to it; None encodes `seqs` here."""
    return _engine(ids, seqs, reads, kmer_size, batch_size, probe_mode,
                   stats_mode, table, logger or _LOG, resolve_device(device))


def _engine(ids, seqs, reads: ReadPairBatch, kmer_size: int,
            batch_size: int, probe_mode: str, stats_mode: str,
            table, logger: logging.Logger, dev,
            seams: _Seams = _ONE, cap: int = 16, cap_c: int = 32,
            coo_slots: Optional[int] = None):
    """The engine driver, infer_pe_links' on the resolved device `dev`,
    with one process's seams or a mesh rank's (`seams`); `cap`, `cap_c`
    and `coo_slots` are the sparse engine's first caps and link-table
    size (_infer_pe_links_sparse)."""
    split_len = kmer_size + 1
    if probe_mode not in _PROBE_MODES:
        raise ValueError(f"probe_mode {probe_mode!r} is not one of "
                         f"{_PROBE_MODES}")
    if table is None:
        table = build_kmer_table(seqs, split_len)
    elif table.split_len != split_len:
        raise ValueError(f"prebuilt table has split_len {table.split_len},"
                         f" k={kmer_size} needs {split_len}")
    count("pe.table_card_builds", 0)
    card = (_upload_table(table, dev) if isinstance(table, KmerTable)
            else _card_table(table, dev))
    N = card.num_nodes
    logger.info("kmer table: %d entries, max_dup=%d, %d nodes",
                card.num_entries, card.max_dup, N)

    # don't pad small datasets up to a huge batch; "auto" routes the
    # clamped batch
    if reads.num_pairs and batch_size > reads.num_pairs:
        clamped = 512
        while clamped < reads.num_pairs:
            clamped *= 2
        if clamped < batch_size:
            logger.info("pe batch clamped %d -> %d for %d pairs",
                        batch_size, clamped, reads.num_pairs)
            batch_size = clamped
    sparse = _is_sparse(stats_mode, batch_size, N)

    if reads.num_pairs == 0 or card.num_entries == 0:
        return _empty_result(ids, reads, N)

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

    tab = _device_table(seams.shard(card),
                        _route_probe(probe_mode, sparse, card, logger))
    if sparse:
        return _infer_pe_links_sparse(ids, tab, reads, batch_size, logger,
                                      cap, cap_c, coo_slots, seams)
    acc_nm = torch.zeros((N, N), dtype=torch.int64, device=dev)
    acc_sm = torch.zeros((N, N), dtype=torch.int64, device=dev)

    # mixed-length libraries: feed per-width bucket sub-batches so short
    # reads don't pay the widest read's window count
    with span("pe.pack"):
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
        for kind, payload in seams.rows(p, batch_size):
            feed = _upload_batch(kind, payload, dev)
            with span("pe.queue"):
                q1, h2, valid, lens = _batch_hashes(kind, feed, Tp,
                                                    split_len)
                cnt, kmin = seams.stats(*_batch_stats(q1, h2, valid, tab))
                if seams.counts:
                    _batch_pairs(cnt, kmin, lens, tab, acc_nm, acc_sm)

    seams.end_dense(acc_nm, acc_sm)
    with span("pe.drain"):
        node_mat, short_mat = _drain_dense(acc_nm, acc_sm)
    return PEResult(list(ids), node_mat, short_mat,
                    reads.n_reads, reads.short_reads, reads.used_reads)


def _drain_dense(*accs: torch.Tensor) -> tuple:
    """The dense engine's accumulators as host numpy arrays (the engine's
    D2H, `pe.d2h_bytes`).

    On CUDA each lands in a page-locked tensor of torch's caching host
    allocator: both copies are queued, then the stream is waited on once.
    The DMA writes straight into the block, with no staging through a
    CUDA-owned bounce buffer and no page faults on fresh host memory. The
    returned `.numpy()` views hold their tensors, so a block returns to
    the allocator when the caller drops the result, and a later drain of
    the same size takes it back already resident (`pe.d2h_pinned_bytes`).
    On the CPU the accumulators' own arrays are returned."""
    dev = accs[0].device
    if dev.type != "cuda":
        out = tuple(a.cpu().numpy() for a in accs)
    else:
        host = tuple(torch.empty(a.shape, dtype=a.dtype, device="cpu",
                                 pin_memory=True) for a in accs)
        for h, a in zip(host, accs):
            h.copy_(a, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        out = tuple(h.numpy() for h in host)
        count("pe.d2h_pinned_bytes", sum(a.nbytes for a in out))
    count("pe.d2h_bytes", sum(a.nbytes for a in out))
    return out


def _infer_pe_links_sparse(ids, tab: _DeviceTable,
                           reads: ReadPairBatch, batch_size: int,
                           logger: logging.Logger, cap: int = 16,
                           cap_c: int = 32,
                           coo_slots: Optional[int] = None,
                           seams: _Seams = _ONE) -> PESparseResult:
    """Large-N engine: the same probes, sparse per-batch stats and link
    keys counted into hash tables on the device; the footprint grows with
    the distinct links, not with N². The classic probe takes the byte
    feed, as in the JAX package. A cap overflow retries the whole run at
    4x the caps with the same table on the device. `coo_slots` sets the
    link tables' first size (default ck.coo_table_slots(N)); a rank that
    does not count the links (`seams.counts`) keeps no tables."""
    N = tab.num_nodes
    dev = tab.h1.device
    T = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
    batch_size = _sparse_batch_clamp(batch_size, T, tab.split_len,
                                     tab.depth, logger, seams.n_data)
    tables = ck.CooTables(N, dev, coo_slots) if seams.counts else None

    def one_pass(cap, cap_c):
        logger.info("sparse PE stats path: N=%d, cap=%d, depth=%d, "
                    "batch=%d", N, cap, tab.depth, batch_size)

        def core(kind, payload):
            feed = _upload_batch(kind, payload, dev)
            with span("pe.queue"):
                return seams.lists(
                    *_batch_hashes(kind, feed, T, tab.split_len), tab, cap,
                    cap_c)

        batches = seams.rows(reads, batch_size,
                             force_bytes=tab.probe != "sortfill")
        return seams.end_pass(_sparse_run(batches, core, dev, tables))

    pk, pc, sk, sc = seams.merge(_sparse_retry(one_pass, cap, cap_c,
                                               logger))
    return PESparseResult(list(ids), pk, pc, sk, sc, reads.n_reads,
                          reads.short_reads, reads.used_reads)


def _sparse_batch_clamp(batch_size: int, T: int, split_len: int,
                        depth: int, logger: logging.Logger,
                        n_data: int = 1) -> int:
    """The sparse engine's batch, clamped by its own footprint (~8 live
    (2B, K * depth) int32 planes through sort + scans) on each of the
    n_data ranks that split a batch."""
    K = T - split_len + 1
    row_bytes = max(K * max(depth, 1) * 4 * 8, 1)
    budget = max(512, (1_500_000_000 // row_bytes) // 2)
    if batch_size // n_data <= budget:
        return batch_size
    clamped = max(512, 1 << (budget.bit_length() - 1)) * n_data
    logger.info("sparse pe batch clamped %d -> %d (K=%d, depth=%d)",
                batch_size, clamped, K, depth)
    return clamped


# _sparse_run's outcome when a key found no free slot in a link table
_TABLE_FULL = "link table full"


def _sparse_retry(one_pass, cap: int, cap_c: int, logger: logging.Logger):
    """one_pass(cap, cap_c) -> the merged COO, None on a cap overflow or
    _TABLE_FULL. An overflow retries the pass at 4x the caps, up to 256,
    and adds one to the counter `pe.sparse_retries`; a full link table
    restarts it at the same caps (the table has grown 4x and counted
    `pe.coo_table_grows`). Both counters are named, at 0, on every
    call."""
    count("pe.sparse_retries", 0)
    count("pe.coo_table_grows", 0)
    while True:
        coo = one_pass(cap, cap_c)
        if coo is _TABLE_FULL:
            logger.info("sparse link table full; restarting the pass with "
                        "a 4x table")
            continue
        if coo is not None:
            return coo
        if cap >= 256:
            raise RuntimeError(
                "a read saturated more than 256 nodes; graph too "
                "repetitive for the sparse PE path")
        count("pe.sparse_retries")
        logger.info("sparse caps %d/%d overflowed; retrying with %d/%d",
                    cap, cap_c, cap * 4, cap_c * 4)
        cap, cap_c = cap * 4, cap_c * 4


def _sparse_run(batches, core, dev, tables: Optional[ck.CooTables] = None):
    """One pass of the sparse engine: core(kind, payload) -> (out [2B, cap]
    saturated node ids, overflow flag) queued on `dev` for each of
    `batches` ((kind, payload) as _wire_batches yields them), and each
    batch's link keys counted into `tables` (coo_accum, behind `core`).
    Returns the pass's COO (pair keys, counts, short keys, counts: sorted
    unique int64 host arrays; empty without `tables`), None on a cap
    overflow, which ends the pass, or _TABLE_FULL when a key found no free
    slot in a table (the pass runs to its end, so that ranks sharing its
    batches stay in step, and the full table is 4x larger for the next
    pass). The tables start empty each pass.

    Batch i's flags (tables.stats, or the overflow flag alone without
    tables) are copied to the host behind its own kernels and read after
    batch i+1 is queued, so the device always has the next batch and no
    batch syncs the stream on its own. A table whose filled slots, so
    read, pass half its slots grows 4x (a rehash queued before the next
    batch).

    Spans besides those of the batches and `core` (pe.pack, pe.upload,
    pe.queue): pe.queue around coo_accum and the queued D2H, pe.drain
    around each pulled batch (pe.wait: the host blocked on the device for
    the batch's flags) and around the pass's end (pe.coo: the tables'
    keys sorted and copied to the host, one wait). Counters: `pe.coo_keys`
    the keys the pass expanded (an aborted pass's too), read from the
    device counter; `pe.coo_unique_keys` the distinct keys it ends with;
    `pe.coo_table_grows` each growth."""
    on_cuda = dev.type == "cuda"
    if tables is not None:
        tables.reset()
    last = [0] * ck.COO_STATS  # the latest batch's flags

    def queue(kind, payload):
        out, ovf = core(kind, payload)
        with span("pe.queue"):
            flags = (ovf.reshape(1).to(torch.int64) if tables is None
                     else ck.coo_accum(out, ovf, tables))
            if on_cuda:
                block = torch.empty(flags.shape, dtype=flags.dtype,
                                    device="cpu", pin_memory=True)
                block.copy_(flags, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
            else:
                block, done = flags.clone(), None
        count("pe.d2h_bytes", block.nbytes)
        return block, done

    def drain(item) -> bool:
        block, done = item
        with span("pe.wait"):
            if done is not None:
                done.synchronize()
        flags = block.tolist()
        last[:len(flags)] = flags
        if flags[ck.COO_OVF]:
            return False
        if tables is not None and not any(flags[ck.COO_FULL:]):
            for t in (0, 1):
                if 2 * flags[ck.COO_FILL + t] > tables.slots[t]:
                    tables.grow(t)
                    count("pe.coo_table_grows")
        return True

    ok, pending = True, None
    while ok:
        nxt = next(batches, None)
        item = None if nxt is None else queue(*nxt)
        if pending is not None:
            with span("pe.drain"):
                ok = drain(pending)
        if item is None:
            break
        pending = item
    if tables is None:
        if not ok:
            return None
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy(), z.copy()
    count("pe.coo_keys", last[ck.COO_KEYS])
    if not ok:
        return None
    full = [t for t in (0, 1) if last[ck.COO_FULL + t]]
    if full:
        for t in full:
            tables.slots[t] *= 4
            count("pe.coo_table_grows")
        return _TABLE_FULL
    with span("pe.drain"), span("pe.coo"):
        return _coo_finish(tables, last[ck.COO_FILL:ck.COO_FILL + 2])


def _coo_finish(tables: ck.CooTables, fills) -> tuple:
    """Each table's keys ascending with their counts, cut to its filled
    slots (free slots' COO_EMPTY keys sort last): host int64 arrays (pair
    keys, counts, short keys, counts), on CUDA copied into page-locked
    blocks behind one wait. Adds the distinct keys to
    `pe.coo_unique_keys`."""
    parts = []
    for tab, fill in zip(tables.tabs, fills):
        keys, order = torch.sort(tab[:, 0])
        parts += [keys[:fill], tab[:, 1][order[:fill]]]
    if tables.device.type == "cuda":
        host = [torch.empty(p.shape, dtype=p.dtype, device="cpu",
                            pin_memory=True) for p in parts]
        for h, p in zip(host, parts):
            h.copy_(p, non_blocking=True)
        torch.cuda.current_stream(tables.device).synchronize()
        parts = host
    out = tuple(p.numpy() for p in parts)
    count("pe.d2h_bytes", sum(a.nbytes for a in out))
    count("pe.coo_unique_keys", sum(fills))
    return out


# --------------------------------------------------------------------------
# file-format parity (aln/pe_info, aln/st_info)
# --------------------------------------------------------------------------

def write_pe_files(result, pe_path: str, st_path: str) -> None:
    """Write the N^2-line `u:v:count` files
    (parity: PE_Inference.py:190-207). Accepts a dense PEResult or a COO
    PESparseResult (rows rebuilt one by one) — identical bytes."""
    ids = result.ids
    n = len(ids)
    if isinstance(result, PESparseResult):
        streams = ((result.pair_keys, result.pair_counts, pe_path),
                   (result.short_keys, result.short_counts, st_path))
        for keys, counts, path in streams:
            with open(path, "w") as fh:
                for i in range(n):
                    row = np.zeros(n, dtype=np.int64)
                    a = np.searchsorted(keys, i * n)
                    b = np.searchsorted(keys, (i + 1) * n)
                    row[(keys[a:b] - i * n).astype(np.int64)] = counts[a:b]
                    fh.write("".join(
                        f"{ids[i]}:{ids[j]}:{row[j]}\n" for j in range(n)))
        return
    with open(pe_path, "w") as f_pe, open(st_path, "w") as f_st:
        for i in range(n):
            u = ids[i]
            nrow = result.node_mat[i].tolist()
            srow = result.short_mat[i].tolist()
            f_pe.write("".join(
                f"{u}:{ids[j]}:{nrow[j]}\n" for j in range(n)))
            f_st.write("".join(
                f"{u}:{ids[j]}:{srow[j]}\n" for j in range(n)))


def write_pe_files_sparse(result, pe_path: str, st_path: str) -> None:
    """Write only the NONZERO `u:v:count` lines of the link matrices,
    row-major, from a PEResult or a PESparseResult. The reference's loader
    (VStrains_IO.py:598-627, ours in process_pe_info) initializes every
    pair to 0, so these files load to the same stores as the full
    N^2-line format."""
    ids = result.ids
    if isinstance(result, PESparseResult):
        n = len(ids)
        streams = ((result.pair_keys, result.pair_counts, pe_path),
                   (result.short_keys, result.short_counts, st_path))
        for keys, counts, path in streams:
            nz = counts != 0
            keys, counts = keys[nz], counts[nz]
            us = (keys // n).astype(np.int64)
            vs = (keys - us * n).astype(np.int64)
            with open(path, "w") as fh:
                fh.write("".join(
                    f"{ids[u]}:{ids[v]}:{c}\n" for u, v, c in
                    zip(us.tolist(), vs.tolist(), counts.tolist())))
        return
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


def _coo_to_pe_info(node_ids: Sequence[str], result: PESparseResult):
    """Symmetric PEInfo stores from COO link arrays: (u, v) and (v, u)
    fold into lexicographic (min, max) id keys, the diagonal counted
    once — the contract of the dense fold below."""
    from vstrains_tpu_torch.core.pe_store import PEInfo

    ids = result.ids
    N = len(ids)
    keys = np.concatenate([result.pair_keys, result.short_keys])
    counts = np.concatenate([result.pair_counts, result.short_counts])
    pe = PEInfo()
    if keys.size:
        u = keys // N
        v = keys % N
        folded = np.minimum(u, v) * N + np.maximum(u, v)
        order = np.argsort(folded, kind="stable")
        folded = folded[order]
        counts = counts[order]
        starts = np.flatnonzero(
            np.concatenate([[True], folded[1:] != folded[:-1]]))
        uniq = folded[starts]
        sums = np.add.reduceat(counts, starts)
        node_set = set(node_ids)
        keep = np.array([vid in node_set for vid in ids], dtype=bool)
        for k, c in zip(uniq.tolist(), sums.tolist()):
            i, j = divmod(k, N)
            if keep[i] and keep[j]:
                uu, vv = ids[i], ids[j]
                pe[(min(uu, vv), max(uu, vv))] = int(c)
    return pe, PEInfo(pe)


def pe_info_sparse_from_result(node_ids: Sequence[str], result):
    """Vectorized sparse construction of the symmetric PE-link store:
    equivalent to pe_info_from_result but O(nonzero pairs) instead of
    O(N^2) Python loops, returning PEInfo stores whose missing pairs read
    as 0 (the reference's dense zero-init contract). Accepts a dense
    PEResult or a COO PESparseResult. Returns (pe_info, dcpy_pe_info)."""
    from vstrains_tpu_torch.core.pe_store import PEInfo

    if isinstance(result, PESparseResult):
        return _coo_to_pe_info(node_ids, result)

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

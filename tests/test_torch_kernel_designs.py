"""The logic of the port's six redesigned CUDA kernels, which cannot
run on the CPU, emulated in numpy step for step and held to the plain
versions and the JAX package's Pallas kernels (interpret mode):

  * pair_counts (csrc/pair_counts.cu): the work list that the wrapper
    uploads (ops/cuda_kernels.py::pair_counts_schedule): the steps of the
    upper tiles I <= J cut into one equal-cost run of segments per SM;
    the emulation runs one integer product per segment as the kernel's
    wgmma loop does
    (f_I^T r_J, r_I^T f_J written transposed, f_I^T f_J + r_I^T r_J with
    the diagonal tile masked to i <= j) on the operand bytes it stages:
    the first launch's bit-packed words, expanded per nibble.
  * sort_rows (csrc/sort_rows.cu on csrc/sort_net.cuh): the
    register-resident bitonic network, with each stage as a permutation of
    (warp, lane, register) slots: compare-exchange between registers for
    strides below P, a lane shuffle for strides below one warp's span,
    and above it the row's shared copy read back in the cube layout (up
    to four long strides in registers, a longer one pairwise), coalesced
    loads in any order and the sorted row out through shared memory; and
    past one block, the global branch: chunks sorted by the same network,
    global passes of up to four strides, in-chunk merges.
  * sort_cols (csrc/sort_cols.cu): the tile plan (NC columns a block, the
    tile read and stored row by row through a column-major padded tile in
    shared memory) around the same network, one column a group of warps.
  * window_hashes (csrc/window_hashes.cu): the launch plan (lanes a row,
    rows a warp, wide rows cut into window chunks), each warp's codes
    staged one a byte and read four at a time as words; each lane's run
    of windows, its first by Horner's rule and the rest by rolling, with
    a rolling count of bad codes; each warp's outputs staged as one flat
    range and stored in 16-byte groups with a head and tail a lane each.
  * dup_stats and dup_scan (csrc/dup_stats.cu, csrc/dup_scan.cu,
    csrc/dup_walk.cuh): each window's walk of its duplicate run (16-byte
    records in groups of 2, then 4; stop after the first entry past the
    run, never past the depth or the table's end), the block-to-row
    (dup_stats) and
    block-to-window (dup_scan) plans, the shared counters of dup_stats and
    its global branch, and the staged planes of dup_scan, each stored as a
    flat range congruent with its output: a scalar head, 16-byte vectors,
    a scalar tail.

Every output is an integer, so every comparison is exact (tolerance 0).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from tests.test_torch_pe_classic import _scan_case
from vstrains_tpu.ops import pe_infer as JP
from vstrains_tpu.ops.pallas_kernels import pair_matmuls_pallas
from vstrains_tpu.ops.pallas_kernels import window_hashes_pallas
from vstrains_tpu.ops.pallas_sort import sort_rows_pallas
from vstrains_tpu_torch.core.seq import HASH_MULT_1, HASH_MULT_2, _mult_pows
from vstrains_tpu_torch.ops import cuda_kernels as ck
from vstrains_tpu_torch.ops import pe_infer as TP

torch.set_num_threads(1)

_I32_MAX = 2**31 - 1
# the SMs of an H100 SXM, the card the work list is balanced for here
_H100_SMS = 132


# --------------------------------------------------------------------------
# pair_counts
# --------------------------------------------------------------------------

def _operand_rows(m, Np, Bp):
    """What the kernel stages for mask m [B, N]: pack_words' words [W, N]
    (bit k of word w = read 32 w + k), each expanded per nibble into
    bytes (nibble * 0x204081 & 0x01010101, little-endian) as a row of
    Bp bytes per node; rows past N are zero (zero-filled loads)."""
    B, N = m.shape
    W = Bp // 32
    words = np.zeros((W, N), np.uint32)
    for k in range(32):
        b = np.arange(W) * 32 + k
        ok = b < B
        words[ok] |= (m[b[ok]] != 0).astype(np.uint32) << np.uint32(k)
    rows = np.zeros((Np, W, 32), np.int64)
    for nib in range(8):
        q = (words >> np.uint32(4 * nib)) & np.uint32(15)
        four = (q * np.uint32(0x00204081)) & np.uint32(0x01010101)
        rows[:N, :, 4 * nib:4 * nib + 4] = four.T[..., None].view(
            np.uint8).reshape(N, W, 4)
    return rows.reshape(Np, Bp)


def _emulate_pair_counts(f, r, segs):
    """The kernel's arithmetic, segment by segment, on uint8 masks [B, N]:
    returns (nm, sm) int64 [N, N]."""
    B, N = f.shape
    Np, Bp = ck.pair_counts_layout(B, N)
    T = ck.PAIR_TILE
    ft = _operand_rows(f, Np, Bp)
    rt = _operand_rows(r, Np, Bp)
    nm = np.zeros((Np, Np), np.int64)
    sm = np.zeros((Np, Np), np.int64)
    rows = np.arange(T)
    for ti, tj, k0, k1 in segs:
        assert (k1 - k0) % ck.PAIR_STEP == 0 and k0 % ck.PAIR_STEP == 0
        i0, j0 = ti * T, tj * T
        fI, rI = ft[i0:i0 + T, k0:k1], rt[i0:i0 + T, k0:k1]
        fJ, rJ = ft[j0:j0 + T, k0:k1], rt[j0:j0 + T, k0:k1]
        nm[i0:i0 + T, j0:j0 + T] += fI @ rJ.T
        if ti != tj:
            nm[j0:j0 + T, i0:i0 + T] += (rI @ fJ.T).T
        upper = (i0 + rows[:, None]) <= (j0 + rows[None, :])
        sm[i0:i0 + T, j0:j0 + T] += np.where(upper, fI @ fJ.T + rI @ rJ.T,
                                             0)
    return nm[:N, :N], sm[:N, :N]


def _segments(B, N, sms=_H100_SMS):
    """The work list's segments, after checking that `starts` hands each
    block a contiguous run of them."""
    starts, segs = ck.pair_counts_schedule(B, N, sms)
    assert starts.dtype == np.int32 and segs.dtype == np.int32
    assert segs.ndim == 2 and segs.shape[1] == 4
    assert starts[0] == 0 and starts[-1] == len(segs)
    assert (np.diff(starts) >= 0).all() and len(starts) - 1 <= sms
    return starts, segs


@pytest.mark.parametrize("B,N", [(1, 1), (1, 65), (33, 65), (33, 130),
                                 (200, 130), (4097, 70), (130, 300),
                                 (64, 30000)])
def test_pair_schedule_covers_each_product_once(B, N):
    """Every upper tile I <= J appears with read ranges that tile the
    padded read axis [0, Bp) exactly once, in whole staging steps, and no
    lower tile appears."""
    _, segs = _segments(B, N)
    Np, Bp = ck.pair_counts_layout(B, N)
    T = -(-N // ck.PAIR_TILE)
    assert Np == T * ck.PAIR_TILE and Bp % ck.PAIR_STEP == 0 \
        and B <= Bp < B + ck.PAIR_STEP
    ranges = {}
    for ti, tj, k0, k1 in segs:
        assert 0 <= ti <= tj < T
        assert 0 <= k0 < k1 <= Bp and k0 % ck.PAIR_STEP == 0 \
            and k1 % ck.PAIR_STEP == 0
        ranges.setdefault((ti, tj), []).append((k0, k1))
    assert set(ranges) == {(i, j) for i in range(T) for j in range(i, T)}
    for rs in ranges.values():
        rs.sort()
        assert rs[0][0] == 0 and rs[-1][1] == Bp
        assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))


def _check_balance(sms):
    """At B = 16,384, N = 773 the 28 upper tiles of 128 nodes go to one
    run per SM of equal cost (within one step of the mean), each tile
    shared by few blocks (each segment adds its partial sums once)."""
    starts, segs = _segments(16384, 773, sms)
    assert len(starts) - 1 == sms
    assert len({(i, j) for i, j, _, _ in segs}) == 28
    cost = [sum((k1 - k0) // ck.PAIR_STEP * ck.PAIR_STEP_COST[int(i == j)]
                for i, j, k0, k1 in segs[starts[b]:starts[b + 1]])
            for b in range(sms)]
    step = max(ck.PAIR_STEP_COST)
    assert np.mean(cost) - step <= min(cost) <= max(cost) \
        <= np.mean(cost) + step
    assert len(segs) <= sms + 28


def test_pair_schedule_balances_the_sms_at_the_hiv_shape():
    _check_balance(_H100_SMS)


def test_pair_schedule_balances_a_card_with_fewer_sms():
    """The wrapper asks the card for its SM count (114 on the H100 PCIe):
    the list then has that many runs, so no block waits for a second
    wave."""
    _check_balance(114)


@pytest.mark.parametrize("B,N,sms,pallas", [
    (1, 1, 132, False), (33, 65, 132, True), (200, 130, 7, True),
    (4097, 70, 132, False), (130, 300, 1, False), (64, 773, 132, False)])
def test_pair_schedule_emulation_matches_plain_and_pallas(B, N, sms,
                                                          pallas):
    rng = np.random.RandomState(B * 7 + N)
    f = (rng.rand(B, N) < 0.3).astype(np.uint8)
    r = (rng.rand(B, N) < 0.3).astype(np.uint8)
    nm, sm = _emulate_pair_counts(f, r, _segments(B, N, sms)[1])
    acc_nm = torch.zeros((N, N), dtype=torch.int64)
    acc_sm = torch.zeros((N, N), dtype=torch.int64)
    ck.pair_counts_plain(torch.from_numpy(f), torch.from_numpy(r), acc_nm,
                         acc_sm)
    np.testing.assert_array_equal(nm, acc_nm.numpy())
    np.testing.assert_array_equal(sm, acc_sm.numpy())
    xnm, xsm = JP._pair_matmuls(jnp.asarray(f, jnp.float32),
                                jnp.asarray(r, jnp.float32), N)
    np.testing.assert_array_equal(nm, np.asarray(xnm))
    np.testing.assert_array_equal(sm, np.asarray(xsm))
    if pallas:
        pnm, psm = pair_matmuls_pallas(jnp.asarray(f, jnp.float32),
                                       jnp.asarray(r, jnp.float32),
                                       interpret=True)
        np.testing.assert_array_equal(nm, np.asarray(pnm))
        np.testing.assert_array_equal(sm, np.asarray(psm))


def test_pair_emulation_all_ones():
    """All-ones masks: every acc_nm cell counts B, every upper acc_sm cell
    2B, the lower triangle 0 (the chip check's all-ones case, smaller)."""
    B, N = 300, 130
    f = np.ones((B, N), np.uint8)
    nm, sm = _emulate_pair_counts(f, f, _segments(B, N)[1])
    assert (nm == B).all()
    np.testing.assert_array_equal(sm, np.triu(np.full((N, N), 2 * B)))


# --------------------------------------------------------------------------
# sort_rows
# --------------------------------------------------------------------------

def _net_shape(C):
    """(P, W): registers a lane and warps a sequence of C words in the
    network (csrc/sort_net.cuh)."""
    L = max(32, ck._pow2_at_least(C))
    return (L // 32, 1) if L <= 512 else (16, L // 512)


def _order(a, b, asc):
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    return np.where(asc, lo, hi), np.where(asc, hi, lo)


def _lg(n):
    return int(n).bit_length() - 1


def _cube_words(P, W, word_bytes):
    """sort_net.cuh's cube_words: the words a thread holds a span apart in
    the cube layout (1: every long stride pairwise)."""
    return 1 if word_bytes == 8 and W < 16 else min(W, P)


def _cube_index(P, W, tid, m, word_bytes=4):
    """sort_net.cuh's cube_index: the in-sequence index of register m of
    thread tid in the layout of the long strides."""
    lg_span = _lg(32 * P)
    G = _cube_words(P, W, word_bytes)
    g = _lg(G)
    lane, wr = tid & 31, tid >> 5
    return (lane | ((m >> g) << 5) | ((wr & (G - 1)) << (lg_span - g))
            | ((m & (G - 1)) << lg_span) | ((wr >> g) << (lg_span + g)))


def _pair_index(t, j):
    """The lower index of pair t at stride j (the pairwise passes)."""
    return ((t & ~(j - 1)) << 1) | (t & (j - 1))


def _network(x, P, W, kfirst=2, flip=None):
    """sort_net.cuh's net_sort on x[R, 32W, P] (register p of thread tid
    in the normal layout: index tid * P + p): merges kfirst .. L, each
    sequence ascending, or descending where flip[r]. Strides of a span
    (32 P) and more go through the sequence's shared copy (an unpadded
    array here: the padding is checked on its own): pairwise at the cube's
    span (32 P G) and more, then in the cube layout's registers."""
    R = x.shape[0]
    span = 32 * P
    L = span * W
    G = _cube_words(P, W, x.dtype.itemsize)
    cube = span * G
    tid = np.arange(32 * W)[:, None]
    lane = tid & 31
    base = tid * P
    idx = (base + np.arange(P)[None, :]).ravel()
    cidx = _cube_index(P, W, tid, np.arange(P)[None, :],
                       x.dtype.itemsize)                 # [32W, P]
    flip = np.zeros(R, bool) if flip is None else np.asarray(flip)
    f = flip[:, None]
    x = x.copy()
    k = kfirst
    while k <= L:
        if k > span:                               # long_merge
            s = np.empty((R, L), x.dtype)
            s[:, idx] = x.reshape(R, -1)
            j = k // 2
            while j >= cube:
                i = _pair_index(np.arange(L // 2), j)
                s[:, i], s[:, i + j] = _order(s[:, i], s[:, i + j],
                                              ((i & k) == 0)[None, :] != f)
                j //= 2
            if G > 1:
                xc = s[:, cidx]
                j = min(k // 2, cube // 2)
                while j >= span:
                    d = j // span
                    for m in range(P):
                        if m & d:
                            continue
                        asc = ((cidx[:, m] & k) == 0)[None, :] != f
                        xc[:, :, m], xc[:, :, m + d] = _order(
                            xc[:, :, m], xc[:, :, m + d], asc)
                    j //= 2
                s[:, cidx.ravel()] = xc.reshape(R, -1)
            x = s[:, idx].reshape(x.shape)
        j = min(k // 2, span // 2)
        while j > 0:
            if j >= P:                             # lane shuffle
                m = j // P
                y = x.reshape(R, W, 32, P)[:, :, np.arange(32) ^ m, :]
                y = y.reshape(x.shape)
                keep_min = ((lane & m) == 0)[None] == (
                    ((base & k) == 0)[None] != f[:, :, None])
                x = np.where(keep_min, np.minimum(x, y), np.maximum(x, y))
            else:                                  # registers
                for q in range(P):
                    if q & j:
                        continue
                    asc = ((q & k) == 0) if k < P else (base[:, 0] & k) == 0
                    asc = np.broadcast_to(asc, (32 * W,))[None, :] != f
                    x[..., q], x[..., q | j] = _order(x[..., q],
                                                      x[..., q | j], asc)
            j //= 2
        k *= 2
    return x


def _coalesced_slots(P, W):
    """[32W, P]: the slot register p of thread tid loads (and stores out
    of shared memory) in the kernels: warp * 32 P + 32 p + lane."""
    tid = np.arange(32 * W)[:, None]
    return (tid >> 5) * 32 * P + np.arange(P)[None, :] * 32 + (tid & 31)


def _emulate_net(words, C, pad):
    """The network branch (sort_rows_net) on words [R, C] (uint32 or
    uint64): the coalesced loads, pads made in registers, the network, and
    the sorted row out of shared memory; returns the sorted [R, C]."""
    R = words.shape[0]
    P, W = _net_shape(C)
    L = 32 * P * W
    e = _coalesced_slots(P, W)
    x = np.full((R,) + e.shape, pad, words.dtype)
    inside = e < C
    x[:, inside] = words[:, e[inside]]
    # out through shared memory in the normal layout (index tid P + p)
    return _network(x, P, W).reshape(R, L)[:, :C]


def _global_pass(w, L, j, m, S):
    """sort_global_pass<S>: strides j .. j / 2^(S-1) of merge m over the
    flat scratch w, thread t on the 2^S words b + q * jl."""
    jl = j >> (S - 1)
    t = np.arange(w.size >> S)
    lo = t & (jl - 1)
    b = ((t - lo) << S) | lo
    pos = b[:, None] + np.arange(1 << S)[None, :] * jl
    assert np.array_equal(np.sort(pos.ravel()), np.arange(w.size))
    v = w[pos]
    asc = ((b & (L - 1) & m) == 0)
    d = (1 << S) // 2
    while d > 0:
        for q in range(1 << S):
            if not q & d:
                v[:, q], v[:, q + d] = _order(v[:, q], v[:, q + d], asc)
        d //= 2
    w = w.copy()
    w[pos] = v
    return w


def _emulate_global(words, C, pad):
    """The global branch (L > SORT_NET_MAX): sort_chunk's chunk sort from
    the inputs (chunks alternately ascending and descending), then for
    each merge m > E the global passes (up to four strides each) and
    sort_chunk's in-chunk merge; returns the sorted [R, C] and the passes'
    stride counts."""
    E = ck.SORT_NET_MAX
    R = words.shape[0]
    L = ck._pow2_at_least(C)
    n = R * (L // E)
    P, W = _net_shape(E)
    src = np.full((R, L), pad, words.dtype)
    src[:, :C] = words
    c0 = (np.arange(n) % (L // E)) * E
    e = _coalesced_slots(P, W)
    x = _network(src.reshape(n, E)[:, e], P, W, 2, (c0 & E) != 0)
    w = x.reshape(-1)                              # normal layout out
    passes = []
    m = 2 * E
    while m <= L:
        left, j = _lg(m // E), m // 2
        while left > 0:
            S = min(left, 4)
            w = _global_pass(w, L, j, m, S)
            passes.append(S)
            j >>= S
            left -= S
        x = w.reshape(n, 32 * W, P)                # in, to the normal layout
        w = _network(x, P, W, E, (c0 & m) != 0).reshape(-1)
        m *= 2
    return w.reshape(R, L)[:, :C], passes


def _operands(rng, R, C):
    key = rng.randint(-2**31, 2**31, (R, C)).astype(np.int32)
    key[rng.rand(R, C) < 0.2] = _I32_MAX
    key[rng.rand(R, C) < 0.2] = -3
    val = rng.randint(-2**31, 2**31, (R, C)).astype(np.int32)
    val[rng.rand(R, C) < 0.1] = _I32_MAX
    return key, val


_BIAS = np.uint32(0x80000000)
# the network branch: one warp a row up to 512 slots, then 2-32 warps a
# row up to 16,384 (6,080 is the repeat64 tail's row)
_NET_WIDTHS = [1, 5, 100, 285, 402, 513, 4096, 4097, 6080, 10000, 16384]
# the global branch: one, three and five merges past a chunk, passes of
# 1, 2, 3 and 4 strides
_GLOBAL_WIDTHS = [(2, 16385), (2, 40000), (1, 200000)]


def _words_key_val(key, val):
    return ((key.view(np.uint32) ^ _BIAS).astype(np.uint64) << np.uint64(
        32)) | (val.view(np.uint32) ^ _BIAS).astype(np.uint64)


def _unpack_key_val(got):
    gk = ((got >> np.uint64(32)).astype(np.uint32) ^ _BIAS).view(np.int32)
    gv = ((got & np.uint64(0xFFFFFFFF)).astype(np.uint32) ^ _BIAS).view(
        np.int32)
    return gk, gv


@pytest.mark.parametrize("C", _NET_WIDTHS)
def test_sort_network_emulation_key_only(C):
    """32-bit words key ^ 2^31, pads all-ones: equals np.sort and the
    plain version."""
    rng = np.random.RandomState(C)
    key, _ = _operands(rng, 3, C)
    words = key.view(np.uint32) ^ _BIAS
    got = (_emulate_net(words, C, np.uint32(0xFFFFFFFF)) ^ _BIAS).view(
        np.int32)
    np.testing.assert_array_equal(got, np.sort(key, axis=1))
    np.testing.assert_array_equal(
        got, ck.sort_rows_plain(torch.from_numpy(key)).numpy())


@pytest.mark.parametrize("C", _NET_WIDTHS)
def test_sort_network_emulation_key_val(C):
    """64-bit words (key ^ 2^31) << 32 | (val ^ 2^31), with INT32_MAX
    slots that must sort before the padding: equals np.lexsort, the plain
    version and the Pallas sorter."""
    rng = np.random.RandomState(1000 + C)
    key, val = _operands(rng, 3, C)
    gk, gv = _unpack_key_val(_emulate_net(_words_key_val(key, val), C,
                                          np.uint64(2**64 - 1)))
    order = np.lexsort((val, key), axis=-1)
    np.testing.assert_array_equal(gk, np.take_along_axis(key, order, 1))
    np.testing.assert_array_equal(gv, np.take_along_axis(val, order, 1))
    pk, pv = ck.sort_rows_plain(torch.from_numpy(key), torch.from_numpy(val))
    np.testing.assert_array_equal(gk, pk.numpy())
    np.testing.assert_array_equal(gv, pv.numpy())
    if C <= 513:
        jk, jv = sort_rows_pallas(jnp.asarray(key), jnp.asarray(val),
                                  block=3, interpret=True)
        np.testing.assert_array_equal(gk, np.asarray(jk))
        np.testing.assert_array_equal(gv, np.asarray(jv))


@pytest.mark.parametrize("R,C", _GLOBAL_WIDTHS)
def test_sort_global_branch_emulation(R, C):
    """Rows past one block: the chunk sort, the multi-stride global
    passes and the in-chunk merges, key-only and (key, val), equal the
    plain version; 200,000 slots (L = 2^18) reach a pass of four
    strides."""
    rng = np.random.RandomState(C)
    key, val = _operands(rng, R, C)
    got, passes = _emulate_global(key.view(np.uint32) ^ _BIAS, C,
                                  np.uint32(0xFFFFFFFF))
    np.testing.assert_array_equal((got ^ _BIAS).view(np.int32),
                                  ck.sort_rows_plain(
                                      torch.from_numpy(key)).numpy())
    words, p2 = _emulate_global(_words_key_val(key, val), C,
                                np.uint64(2**64 - 1))
    gk, gv = _unpack_key_val(words)
    pk, pv = ck.sort_rows_plain(torch.from_numpy(key), torch.from_numpy(val))
    np.testing.assert_array_equal(gk, pk.numpy())
    np.testing.assert_array_equal(gv, pv.numpy())
    L = ck._pow2_at_least(C)
    merges = _lg(L // ck.SORT_NET_MAX)
    assert passes == p2 and sum(passes) == merges * (merges + 1) // 2
    assert max(passes) <= 4 and (C < 200000 or 4 in passes)


def _conflict_free(pos, word_bytes):
    """Whether a warp's 32 shared-memory word positions (in access order)
    fall in distinct banks within each 128-byte phase."""
    per_phase = 128 // word_bytes
    for ph in range(0, 32, per_phase):
        banks = (pos[ph:ph + per_phase] * (word_bytes // 4)) % 32
        if len(set(banks.tolist())) != per_phase:
            return False
    return True


def _padded(i, word_bytes):
    return i + (i >> (5 if word_bytes == 4 else 4))


@pytest.mark.parametrize("C", _NET_WIDTHS)
def test_sort_network_shared_pad_is_conflict_free(C):
    """The kernels' shared-memory index i + (i >> 5) (32-bit words) and
    i + (i >> 4) (64-bit) puts each warp's accesses in distinct banks
    within each 128-byte phase: the normal layout's strided stores (thread
    tid, register p: slot tid P + p), the coalesced loads and stores (slot
    warp 32P + 32p + lane), the cube layout's registers (a permutation of
    the sequence) and the pairwise passes; at every W of 1-32 warps."""
    P, W = _net_shape(C)
    L = 32 * P * W
    tid = np.arange(32 * W)[:, None]
    m = np.arange(P)[None, :]
    normal = tid * P + m
    coalesced = _coalesced_slots(P, W)
    for word_bytes in (4, 8):
        G = _cube_words(P, W, word_bytes)
        cube = _cube_index(P, W, tid, m, word_bytes)
        assert G == 1 or np.array_equal(np.sort(cube.ravel()), np.arange(L))
        for v in [normal, coalesced] + ([cube] if G > 1 else []):
            for w in range(W):
                for q in range(P):
                    assert _conflict_free(
                        _padded(v[32 * w:32 * w + 32, q], word_bytes),
                        word_bytes)
        j = L // 2
        while j >= 32 * P * G:
            for t0 in range(0, L // 2, 32):
                i = _pair_index(np.arange(t0, t0 + 32), j)
                assert _conflict_free(_padded(i, word_bytes), word_bytes)
                assert _conflict_free(_padded(i + j, word_bytes), word_bytes)
            j //= 2


_SORT_NET_CUH = os.path.join(os.path.dirname(ck.__file__), os.pardir,
                             "csrc", "sort_net.cuh")


def test_sort_net_limit_matches_the_source():
    """SORT_NET_MAX is csrc/sort_net.cuh's kMaxLen = 32 kP kMaxWarps."""
    assert ck.SORT_NET_MAX == 32 * _cu_const("kP", _SORT_NET_CUH) \
        * _cu_const("kMaxWarps", _SORT_NET_CUH)


# --------------------------------------------------------------------------
# sort_cols
# --------------------------------------------------------------------------

def _col_plan(rows):
    """csrc/sort_cols.cu's plan for columns of `rows` rows: (P, Wc, NC,
    CS): registers a lane and warps a column, columns a block, and the
    shared tile's column stride (room for a padded column, congruent with
    Wc modulo the 32 banks)."""
    P, Wc = _net_shape(rows)
    pl_ = _padded(32 * P * Wc, 4)
    return P, Wc, 32 // Wc, pl_ + ((Wc - pl_ % 32) % 32 + 32) % 32


def _emulate_sort_cols(x):
    """sort_cols_net on int32 x [rows, cols], all blocks at once: the
    tile read row by row into the column-major padded tile, each column
    group's normal-layout registers (pads past rows made there), the
    network, the column written back, the tile stored row by row."""
    rows, cols = x.shape
    P, Wc, NC, CS = _col_plan(rows)
    blocks = -(-cols // NC)
    s = np.full((blocks, NC * CS), 0xDEADBEEF, np.uint32)
    i = np.arange(rows * NC)
    l, c = i // NC, i % NC
    col = np.arange(blocks)[:, None] * NC + c[None, :]     # [blocks, i]
    ok = col < cols
    addr = c * CS + _padded(l, 4)
    bi = np.broadcast_to(np.arange(blocks)[:, None], ok.shape)
    s[bi[ok], np.broadcast_to(addr, ok.shape)[ok]] = (
        x[np.broadcast_to(l, ok.shape)[ok], col[ok]].view(np.uint32) ^ _BIAS)
    tid = np.arange(1024)
    grp, ct = tid // (32 * Wc), tid % (32 * Wc)
    ii = ct[:, None] * P + np.arange(P)[None, :]           # [1024, P]
    live = (np.arange(blocks)[:, None] * NC + grp[None, :]) < cols
    regs = np.where(live[:, :, None] & (ii < rows)[None],
                    s[:, grp[:, None] * CS + _padded(ii, 4)],
                    np.uint32(0xFFFFFFFF))
    v = _network(regs.reshape(blocks * NC, 32 * Wc, P), P, Wc)
    v = v.reshape(blocks, 1024, P)
    back = grp[:, None] * CS + _padded(ii, 4)
    keep = np.broadcast_to(ii < rows, back.shape)
    s[:, back[keep]] = v[:, keep]
    out = np.zeros_like(x)
    out[np.broadcast_to(l, ok.shape)[ok], col[ok]] = (
        s[bi[ok], np.broadcast_to(addr, ok.shape)[ok]] ^ _BIAS).view(np.int32)
    return out


# (rows, cols): one to 32 columns a block, ragged last blocks, rows that
# are not a power of two, 2,048 (the chip check's length) and the limit
_COL_SHAPES = [(1, 1), (5, 3), (33, 40), (300, 37), (512, 33), (1000, 17),
               (2048, 24), (3000, 5), (5000, 3), (10000, 1), (16384, 2)]


@pytest.mark.parametrize("rows,cols", _COL_SHAPES)
def test_sort_cols_emulation_matches_plain(rows, cols):
    rng = np.random.RandomState(rows + cols)
    x, _ = _operands(rng, rows, cols)
    got = _emulate_sort_cols(x)
    np.testing.assert_array_equal(got, np.sort(x, axis=0))
    np.testing.assert_array_equal(
        got, ck.sort_cols_plain(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(
        got, ck.sort_cols(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("rows,cols", [(300, 37), (1000, 17), (64, 512)])
def test_sort_cols_emulation_matches_the_prototype(rows, cols, monkeypatch,
                                                   tmp_path):
    """Against tools/colsort_proto.py::sort_cols_pallas in interpret mode,
    which takes a power-of-two length and whole blocks of columns: the
    columns padded with INT32_MAX rows (which sort last), one block of all
    columns or blocks of 256."""
    import importlib
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    proto = importlib.import_module("tools.colsort_proto")
    rng = np.random.RandomState(rows * cols)
    x, _ = _operands(rng, rows, cols)
    Lp = ck._pow2_at_least(rows)
    xp = np.full((Lp, cols), _I32_MAX, np.int32)
    xp[:rows] = x
    want = np.asarray(proto.sort_cols_pallas(
        jnp.asarray(xp), blk=256 if cols % 256 == 0 else cols,
        interpret=True))[:rows]
    np.testing.assert_array_equal(_emulate_sort_cols(x), want)


@pytest.mark.parametrize("rows", [1, 33, 512, 1000, 2048, 5000, 16384])
def test_sort_cols_tile_is_conflict_free(rows):
    """Each warp's tile access (32 / NC rows x NC columns, column-major at
    stride CS, padded rows) falls in 32 distinct banks; the columns'
    regions (padded length of the network) do not overlap; the tile fits
    two blocks an SM (2 x 227 KB would not, 2 x 114 does)."""
    P, Wc, NC, CS = _col_plan(rows)
    assert CS >= _padded(32 * P * Wc, 4) and 4 * NC * CS <= 114 * 1024
    for i0 in range(0, rows * NC, 32):
        i = np.arange(i0, i0 + 32)
        addr = (i % NC) * CS + _padded(i // NC, 4)
        assert _conflict_free(addr, 4)


def test_sort_cols_refuses_past_its_limit():
    x = torch.zeros((ck.SORT_NET_MAX + 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match=str(ck.SORT_NET_MAX)):
        ck.sort_cols(x)
    assert ck.sort_cols(x[:ck.SORT_NET_MAX]).shape == (ck.SORT_NET_MAX, 2)


# --------------------------------------------------------------------------
# window_hashes
# --------------------------------------------------------------------------

_BIAS = np.uint32(0x80000000)  # the kernel carries q1 = h1 + 2^31
_HASH_CU = os.path.join(os.path.dirname(ck.__file__), os.pardir, "csrc",
                        "window_hashes.cu")


def _cu_const(name, path=_HASH_CU):
    """An integer constant of a kernel source, csrc/window_hashes.cu by
    default (`constexpr ... name = value;`), so that the emulated plan
    follows the kernel's source."""
    with open(path) as fh:
        m = re.search(rf"constexpr \w+ {name} = ([0-9 *]+);", fh.read())
    return eval(m.group(1))


def _r16(nbytes):
    return -(-nbytes // 16) * 16


def _layout(rows, chunk, L):
    """A warp's shared memory (the kernel's Layout): bytes of the q1 / h2
    staging, of the valid staging, and of one row's staged codes."""
    return (_r16(4 * (rows * chunk + 3)), _r16(rows * chunk + 15),
            _r16(chunk + L + 15))


def _layout_bytes(rows, chunk, L):
    words, flags, stride = _layout(rows, chunk, L)
    return 2 * words + flags + rows * stride


def _hash_plan(T, L, lanes=None):
    """The kernel's launch plan (plan() in csrc/window_hashes.cu): lanes,
    run, chunk, chunks, warps and the block's shared memory. With `lanes`
    given, the rows are not cut and take that many lanes (the kernel
    takes any power of two; the emulation runs it at others)."""
    K = T - L + 1
    kl, kw = _cu_const("kLanes"), _cu_const("kWarps")
    smem = _cu_const("kSmem")
    chunk, chunks = K, 1
    if lanes is None:
        lanes = kl
        if _layout_bytes(32 // kl, K, L) > smem // kw:
            lanes = 32
            chunk = min(K, _cu_const("kChunk"))
            chunks = -(-K // chunk)
    run = -(-chunk // lanes)
    if lanes == 32:
        run |= 1
    per_warp = _layout_bytes(32 // lanes, chunk, L)
    warps = kw
    while warps > 1 and warps * per_warp > smem:
        warps //= 2
    return dict(lanes=lanes, run=run, chunk=chunk, chunks=chunks,
                warps=warps, smem=warps * per_warp)


def _bank_load(lanes, run, chunk):
    """The most lanes of a warp whose first staging stores (row rr of the
    warp, lane g of the row: word rr chunk + g run) fall in one bank."""
    return int(np.bincount([((lane // lanes) * chunk + (lane % lanes) * run)
                            % 32 for lane in range(32)], minlength=32).max())


def _row_of_word(i, sw):
    """The row of a warp's staged word i, as the kernel finds it: i times
    the float32 reciprocal of sw, truncated, then one step of correction
    each way."""
    r = (i.astype(np.float32) * (np.float32(1) / np.float32(sw))).astype(
        np.int64)
    r += (r + 1) * sw <= i
    r -= r * sw > i
    return r


def _stage_word(feed, x):
    """A loaded word as four staged code bytes: the wire's packed byte
    spread one code a byte, plus one; a byte-feed word through the
    per-byte compare (__vcmpltu4), v = c + 1 where c < 4, else 0x81."""
    x = x.astype(np.uint32)
    if feed == "wire":
        return (((x & 0x03) | (x & 0x0C) << 6 | (x & 0x30) << 12
                 | (x & 0xC0) << 18) + np.uint32(0x01010101))
    ok = np.where(np.ascontiguousarray(x).view(np.uint8) < 4, 0xFF,
                  0).astype(np.uint8).view(np.uint32)
    return (((x & ok) + (ok & np.uint32(0x01010101)))
            | (~ok & np.uint32(0x81818181)))


def _unpack_warp(feed, src, T, B, row0, nrows, c0, sw):
    """One warp's unpack of its `nrows` rows from code c0 on: word i of
    its staged codes is word c0 / 4 + i % sw of row row0 + i // sw,
    loaded from the feed (wire: one packed byte, 0 past ceil(T/4); bytes:
    four codes, 0 past T) and staged. Returns the staged bytes [nrows,
    4 sw]."""
    assert c0 % 4 == 0
    i = np.arange(nrows * sw)
    r = _row_of_word(i, sw)
    assert (r == i // sw).all()
    t = i - r * sw + c0 // 4
    row = row0 + r
    if feed == "wire":
        T4 = -(-T // 4)
        half = (row >= B).astype(np.int64)
        col = np.minimum(half * T4 + t, src.shape[1] - 1)
        x = np.where(t < T4, src[row - half * B, col], 0)
    else:
        pos = 4 * t[:, None] + np.arange(4)[None, :]
        byte = np.where(pos < T, src[row[:, None], np.minimum(pos, T - 1)],
                        0).astype(np.uint32)
        x = (byte[:, 0] | byte[:, 1] << 8 | byte[:, 2] << 16
             | byte[:, 3] << 24)
    return _stage_word(feed, x).reshape(nrows, sw).view(np.uint8)


def _wire_lens(wire):
    w = wire.astype(np.int32)
    return np.concatenate([w[:, -4] | w[:, -3] << 8, w[:, -2] | w[:, -1] << 8])


class _CodeStream:
    """Four code bytes at a time from byte position p (one per lane), as
    the funnel shift of two aligned words; each read must stay inside the
    row's staged codes."""

    def __init__(self, words, p):
        self.words, self.p, self.k = words, p, 0

    def next(self, live):
        w = (self.p >> 2) + self.k
        self.k += 1
        assert (w[live] + 1 < self.words.shape[1]).all()
        w = np.minimum(w, self.words.shape[1] - 2)
        lo = self.words[:, w].astype(np.uint64)
        hi = self.words[:, w + 1].astype(np.uint64)
        sh = ((self.p & 3) * 8).astype(np.uint64)
        return (((hi << np.uint64(32)) | lo) >> sh).astype(np.uint32)


def _v(x, b):
    return (x >> np.uint32(8 * b)) & np.uint32(7)


def _bad(x, b):
    return ((x >> np.uint32(8 * b + 7)) & np.uint32(1)).astype(np.int64)


def _emulate_lanes(staged, lens, c0, kc, L, lanes, run):
    """A warp's lanes over its rows' windows [c0, c0 + kc): lane g of a
    row takes the local run [g run, (g + 1) run), the first window by
    Horner's rule and the rest by rolling, q1 carried as h1 + 2^31 from
    the start, with the rolling bad-code count. Returns q1, h2 (uint32)
    and valid (uint8) [nrows, kc] and how often each window was
    emitted."""
    R = staged.shape[0]
    m1, p1, m2, p2 = (np.uint32(c) for c in ck.hash_constants(L))
    words = np.ascontiguousarray(staged).view(np.uint32)
    j0 = np.arange(lanes) * run
    j0 = j0[j0 < kc]
    j1 = np.minimum(kc, j0 + run)
    out = [np.zeros((R, kc), np.uint32), np.zeros((R, kc), np.uint32),
           np.zeros((R, kc), np.uint8)]
    emitted = np.zeros((R, kc), np.int64)
    a1 = np.full((R, len(j0)), _BIAS, np.uint32)
    a2 = np.zeros_like(a1)
    nbad = np.zeros(a1.shape, np.int64)
    room = lens - L - c0

    def emit(j, live):
        rows, ln = np.nonzero(np.broadcast_to(live, a1.shape))
        jj = j[ln]
        out[0][rows, jj] = a1[rows, ln]
        out[1][rows, jj] = a2[rows, ln]
        out[2][rows, jj] = (nbad[rows, ln] == 0) & (jj <= room[rows])
        emitted[rows, jj] += 1

    every = np.ones(len(j0), bool)
    with np.errstate(over="ignore"):
        first = _CodeStream(words, j0)
        for i in range(0, L, 4):
            x = first.next(every)
            for b in range(min(4, L - i)):
                a1 = a1 * m1 + _v(x, b)
                a2 = a2 * m2 + _v(x, b)
                nbad += _bad(x, b)
        emit(j0, every)
        out_s, in_s = _CodeStream(words, j0), _CodeStream(words, j0 + L)
        for t in range(1, run, 4):
            live = j0 + t < j1
            xo, xi = out_s.next(live), in_s.next(live)
            for b in range(4):
                live = j0 + t + b < j1
                a1 = np.where(live, (a1 - _v(xo, b) * p1) * m1 + _v(xi, b),
                              a1)
                a2 = np.where(live, (a2 - _v(xo, b) * p2) * m2 + _v(xi, b),
                              a2)
                nbad += np.where(live, _bad(xi, b) - _bad(xo, b), 0)
                emit(j0 + t + b, live)
    return out, emitted


def _emulate_store_range(got, writes, flat, e0, room, item):
    """One warp's staged flat range leaving for global elements [e0, e0 +
    n) in 16-byte groups (global addresses 16-byte aligned), the partial
    groups at the two ends one element a lane (lanes 0-15 the head,
    16-31 the tail), for an output whose base address is 16-byte aligned
    (torch's allocations are). `room` is the staging's size in
    elements."""
    n, per = flat.size, 16 // item
    off = (e0 * item % 16) // item
    staged = np.zeros(room, flat.dtype)
    assert off + n <= room
    staged[off:off + n] = flat
    base = e0 - off
    end = off + n
    head = min(end, -(-off // per) * per)
    tail = max(head, end // per * per)
    for lane in range(32):
        k = off + lane if lane < 16 else tail + lane - 16
        if k < (head if lane < 16 else end):
            got[base + k] = staged[k]
            writes[base + k] += 1
        for lo in range(head + lane * per, tail, 32 * per):
            assert (base + lo) * item % 16 == 0
            got[base + lo:base + lo + per] = staged[lo:lo + per]
            writes[base + lo:base + lo + per] += 1


def _emulate_window_hashes(feed, src, lens, T, L, R, B, plan):
    """Every warp of the launch: its rows and window chunk, unpack, lanes
    and stores. Each window must be emitted and each output element
    written exactly once."""
    K = T - L + 1
    lanes, chunk, chunks = plan["lanes"], plan["chunk"], plan["chunks"]
    rows = 32 // lanes
    assert chunks == 1 or rows == 1
    words, flags, stride = _layout(rows, chunk, L)
    outs = [np.zeros(R * K, np.uint32), np.zeros(R * K, np.uint32),
            np.zeros(R * K, np.uint8)]
    writes = [np.zeros(R * K, np.int64) for _ in range(3)]
    for w in range(-(-R // rows) * chunks):
        row0, c0 = w // chunks * rows, w % chunks * chunk
        kc, nrows = min(chunk, K - c0), min(rows, R - row0)
        staged = _unpack_warp(feed, src, T, B, row0, nrows, c0, stride // 4)
        per_row, emitted = _emulate_lanes(staged, lens[row0:row0 + nrows],
                                          c0, kc, L, lanes, plan["run"])
        assert (emitted == 1).all()
        for d, (nbytes, item) in enumerate(((words, 4), (words, 4),
                                            (flags, 1))):
            _emulate_store_range(outs[d], writes[d], per_row[d].reshape(-1),
                                 row0 * K + c0, nbytes // item, item)
    assert all((wr == 1).all() for wr in writes)
    return (outs[0].view(np.int32).reshape(R, K),
            outs[1].view(np.int32).reshape(R, K),
            outs[2].astype(bool).reshape(R, K))


def _hash_case(feed, T, L, plan, seed):
    """13 pairs (26 rows, not a whole number of warps at 1, 2 or 8 rows a
    warp), lengths from 0 to T; the byte feed with in-read code 4 and 255
    padding. Returns the emulated kernel's outputs, the plain version's
    and the stacked codes and lengths."""
    rng = np.random.RandomState(seed)
    B = 13
    fl = rng.randint(0, T + 1, B).astype(np.int32)
    rl = rng.randint(0, T + 1, B).astype(np.int32)
    fl[0] = rl[1] = T
    fc = rng.randint(0, 4, (B, T)).astype(np.uint8)
    rc = rng.randint(0, 4, (B, T)).astype(np.uint8)
    if feed == "bytes":
        fc[rng.rand(B, T) < 0.03] = 4
        rc[rng.rand(B, T) < 0.03] = 4
    cols = np.arange(T)[None, :]
    fc[cols >= fl[:, None]] = 255
    rc[cols >= rl[:, None]] = 255
    if feed == "wire":
        wire = TP._pack_wire_np(fc, fl, rc, rl, T)
        lens = _wire_lens(wire)
        got = _emulate_window_hashes(feed, wire, lens, T, L, 2 * B, B, plan)
        codes, plain_lens = ck.unpack_wire_plain(torch.from_numpy(wire), T)
        np.testing.assert_array_equal(lens, plain_lens.numpy())
        codes = codes.numpy()
    else:
        codes, lens = TP._stack_ends_np(fc, fl, rc, rl)
        got = _emulate_window_hashes(feed, codes, lens, T, L, 2 * B, 0, plan)
    want = ck.window_hashes_plain(torch.from_numpy(codes),
                                  torch.from_numpy(lens), L)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    return got, codes, lens


_HASH_SHAPES = [(256, 56), (150, 56), (24, 7), (320, 128), (37, 7)]


@pytest.mark.parametrize("lanes", [None, 4, 16, 32])
@pytest.mark.parametrize("feed", ["wire", "bytes"])
@pytest.mark.parametrize("T,L", _HASH_SHAPES)
def test_window_hashes_emulation_matches_plain_and_pallas(feed, T, L, lanes):
    """Every window, valid or not, equals the plain version and the
    Pallas kernel, at the kernel's plan (None) and at other lanes a row
    over whole rows."""
    got, codes, lens = _hash_case(feed, T, L, _hash_plan(T, L, lanes),
                                  T * 1000 + L)
    B = codes.shape[0] // 2
    K = T - L + 1
    pal = window_hashes_pallas(jnp.asarray(codes), jnp.asarray(lens), L,
                               block=B, interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(pal[0])[:, :K])
    np.testing.assert_array_equal(got[1], np.asarray(pal[1])[:, :K])
    np.testing.assert_array_equal(got[2],
                                  np.asarray(pal[2])[:, :K].astype(bool))


@pytest.mark.parametrize("feed", ["wire", "bytes"])
@pytest.mark.parametrize("T,L", [(700, 56), (1300, 56), (2100, 56),
                                 (6000, 5900)])
def test_window_hashes_emulation_wide_rows(feed, T, L):
    """Rows too wide for four a warp: one row a warp in chunks of windows
    (one whole chunk at T = 700 and at L = 5,900; 1,056 + 189 windows at
    T = 1,300; 1,056 + 989 at T = 2,100), every window equal to the
    plain version."""
    plan = _hash_plan(T, L)
    assert plan["lanes"] == 32
    assert plan["chunks"] == (2 if T in (1300, 2100) else 1)
    _hash_case(feed, T, L, plan, T * 1000 + L)


@pytest.mark.parametrize("L", [1, 2, 7, 56, 128])
def test_hash_constants_match_mult_pows(L):
    """The wrapper passes M and M^(L-1) of each hash, the entries of
    core/seq._mult_pows that the L-term definition starts from."""
    m1, p1, m2, p2 = ck.hash_constants(L)
    for mult, (m, p) in ((HASH_MULT_1, (m1, p1)), (HASH_MULT_2, (m2, p2))):
        pows = _mult_pows(mult, L + 1)
        assert (m, p) == (int(pows[1]), int(pows[L - 1]))


def test_hash_bias_obeys_the_recurrences():
    """q1 = h1 + 2^31 (= h1 ^ 2^31) follows the Horner step and the roll
    unchanged, because 2^31 M = 2^31 mod 2^32 for the odd multiplier."""
    rng = np.random.RandomState(5)
    m, p = (np.uint32(c) for c in ck.hash_constants(56)[:2])
    h = rng.randint(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    vo, vi = (rng.randint(1, 5, 1000).astype(np.uint32) for _ in range(2))
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal((h + _BIAS) * m + vi,
                                      (h * m + vi) ^ _BIAS)
        np.testing.assert_array_equal((h + _BIAS - vo * p) * m + vi,
                                      ((h - vo * p) * m + vi) ^ _BIAS)


@pytest.mark.parametrize("T", [8, 24, 37, 150, 256, 320, 4096, 20000])
def test_hash_unpack_row_of_word(T):
    """The kernel's float32 reciprocal finds the row of every staged word
    of a warp's rows (up to 32 of them)."""
    sw = _r16(T + 16) // 4
    i = np.arange(32 * sw)
    np.testing.assert_array_equal(_row_of_word(i, sw), i // sw)


@pytest.mark.parametrize("T,L", _HASH_SHAPES + [
    (129, 56), (1024, 56), (4096, 56), (700, 56), (30000, 56), (70000, 56),
    (2**20 - 1, 56), (6000, 5900)])
def test_hash_layout_lanes_runs_and_banks(T, L):
    """The plan covers every window once: lanes run covers a chunk and
    the chunks cover K; only a row alone in its warp is cut, at a
    multiple of four codes (the word loads). Rows that fit four to a warp
    are not cut; every block stays within the kernel's aim for shared
    memory (and its limit on sm_90), so wide rows cost no more of it.
    With one row a warp the run is odd, so the 32 lanes' first staging
    stores fall in 32 banks."""
    K = T - L + 1
    p = _hash_plan(T, L)
    lanes, run, chunk, chunks = p["lanes"], p["run"], p["chunk"], p["chunks"]
    rows = 32 // lanes
    assert lanes in (_cu_const("kLanes"), 32)
    assert lanes * run >= chunk > lanes * (run - 1 - (lanes == 32))
    assert chunks * chunk >= K > (chunks - 1) * chunk
    assert chunks == 1 or (rows == 1 and chunk % 4 == 0)
    if _layout_bytes(4, K, L) <= _cu_const("kSmem") // _cu_const("kWarps"):
        assert (lanes, chunks) == (_cu_const("kLanes"), 1)
    assert p["smem"] <= _cu_const("kSmem") <= _cu_const("kMaxSmem")
    if rows == 1:
        assert _bank_load(lanes, run, chunk) == 1


# --------------------------------------------------------------------------
# dup_stats and dup_scan
# --------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(ck.__file__), os.pardir, "csrc")
_WALK_CUH = os.path.join(_CSRC, "dup_walk.cuh")
_STATS_CU = os.path.join(_CSRC, "dup_stats.cu")
_SCAN_CU = os.path.join(_CSRC, "dup_scan.cu")


def _walk(rec, loc, n, q, h):
    """One thread's walk (dup_walk.cuh::walk) over n records (h1, h2,
    node, 0) from loc: returns (hits [(rank, node)], entries examined up to
    and including the first h1 above q, records loaded)."""
    group = _cu_const("kWalkGroup", _WALK_CUH)
    hits, examined, loaded, stopped = [], 0, 0, False
    d, g = 0, 2
    while d < n:
        us = [u for u in range(g) if d + u < n]
        e = [rec[loc + d + u] for u in us]
        loaded += len(us)
        for x in e:
            if not stopped:
                examined += 1
                stopped = int(x[0]) > q
        for u, x in zip(us, e):
            if int(x[0]) == q and int(x[1]) == h:
                hits.append((d + u, int(x[2])))
        if any(int(x[0]) > q for x in e):
            break
        d, g = d + g, group
    # a group's loads past the stopping entry are the only excess
    assert examined <= loaded < examined + group
    return hits, examined, loaded


def _window_walk(win, rec, w, depth):
    """The walk of flat window w as a thread runs it: nothing for an
    invalid window, else from loc = min(lo, M - 1) over min(D, M - loc)
    entries."""
    q1, h2, valid, lo = (x.reshape(-1) for x in win)
    if not valid[w]:
        return [], 0, 0
    M = rec.shape[0]
    loc = min(int(lo[w]), M - 1)
    return _walk(rec, loc, min(depth, M - loc), int(q1[w]), int(h2[w]))


def _flat_store(g0, span, src, dst, s0):
    """store_flat (dup_walk.cuh): words g0 .. g0 + span of an output whose
    base is 16-byte aligned, from shared words s0 .. (congruent: s0 = g0
    mod 4). The head, the 16-byte vectors and the tail cover the range
    once, and every vector is aligned at both ends."""
    assert (s0 - g0) % 4 == 0
    head = min(span, (4 - g0) & 3)
    quads = (span - head) >> 2
    done = np.zeros(span, np.int64)
    for i in range(head):
        dst[g0 + i] = src[s0 + i]
        done[i] += 1
    for i in range(quads):
        j = head + 4 * i
        assert (g0 + j) % 4 == 0 and (s0 + j) % 4 == 0
        dst[g0 + j:g0 + j + 4] = src[s0 + j:s0 + j + 4]
        done[j:j + 4] += 1
    for i in range(head + 4 * quads, span):
        dst[g0 + i] = src[s0 + i]
        done[i] += 1
    assert (done == 1).all()


def _staged_ranges(g_a, g_b, span, smem_bytes):
    """Where a block stages two flat ranges in shared memory (word 0 is
    16-byte aligned): the first congruent with output word g_a, the second
    from the next 16-byte boundary, congruent with g_b. Both ranges'
    16-byte fills (fill_shared) stay apart and inside the block's shared
    memory."""
    a = g_a & 3
    end = -(-(a + span) // 4) * 4
    b = end + ((g_b - end) & 3)
    fill_a = (a // 4 * 4, -(-(a + span) // 4) * 4)
    fill_b = (b // 4 * 4, -(-(b + span) // 4) * 4)
    assert fill_a[1] <= fill_b[0] and fill_b[1] * 4 <= smem_bytes
    return a, b


def _stats_plan(R, K, N):
    """plan() of csrc/dup_stats.cu: (rows a block, threads, shared bytes;
    0 for the global branch)."""
    windows = _cu_const("kWindows", _STATS_CU)
    smem_max = _cu_const("kSmemMax", _STATS_CU)

    def smem(rows):
        return 4 * (2 * rows * N + 16)
    rows = min(R, 1 if K >= windows else windows // max(K, 1))
    while rows > 1 and smem(rows) > smem_max:
        rows -= 1
    threads = min(_cu_const("kMaxThreads", _STATS_CU),
                  max(32, -(-rows * K // 32) * 32))
    return rows, threads, smem(rows) if smem(rows) <= smem_max else 0


def _emulate_dup_stats(win, rec, depth, N, base=(0, 4)):
    """dup_stats, block by block: returns (cnt, kmin) int32 [R, N] and the
    entries each window examined, int64 [R, K]. `base` is the word address
    of each output (16-byte aligned)."""
    R, K = win[0].shape
    rows, threads, smem = _stats_plan(R, K, N)
    cnt = np.full(base[0] + R * N, -7, np.int64)
    kmin = np.full(base[1] + R * N, -7, np.int64)
    examined = np.zeros(R * K, np.int64)
    for b in range(-(-R // rows)):
        r0 = b * rows
        nrows = min(rows, R - r0)
        span = nrows * N
        c = np.zeros(span, np.int64)
        km = np.full(span, _I32_MAX, np.int64)
        # the thread loop gives each of the block's windows one thread
        owned = np.concatenate([np.arange(t, nrows * K, threads)
                                for t in range(threads)])
        assert np.array_equal(np.sort(owned), np.arange(nrows * K))
        for wl in range(nrows * K):
            hits, examined[r0 * K + wl], _ = _window_walk(
                win, rec, r0 * K + wl, depth)
            rl, k = divmod(wl, K)
            for _, node in hits:
                if 0 <= node < N:
                    c[rl * N + node] += 1
                    km[rl * N + node] = min(km[rl * N + node], k)
        g0 = r0 * N
        if smem:
            s = np.zeros(smem // 4, np.int64)
            a, bk = _staged_ranges(base[0] + g0, base[1] + g0, span, smem)
            s[a:a + span], s[bk:bk + span] = c, km
            _flat_store(base[0] + g0, span, s, cnt, a)
            _flat_store(base[1] + g0, span, s, kmin, bk)
        else:
            cnt[base[0] + g0:base[0] + g0 + span] = c
            kmin[base[1] + g0:base[1] + g0 + span] = km
    return (cnt[base[0]:].reshape(R, N), kmin[base[1]:].reshape(R, N),
            examined.reshape(R, K))


def _scan_block_windows(D):
    """block_windows() of csrc/dup_scan.cu."""
    w = _cu_const("kThreads", _SCAN_CU)
    while w > 0 and 4 * (2 * w * D + 16) > _cu_const("kSmemMax", _SCAN_CU):
        w //= 2
    return w


def _emulate_dup_scan(win, rec, depth, base=(0, 4)):
    """dup_scan, block by block: returns (node_key, kidx_v) int32
    [R, K * D] and the entries each window examined, int64 [R, K]."""
    R, K = win[0].shape
    W = R * K
    bw = _scan_block_windows(depth)
    assert bw >= 1
    smem = 4 * (2 * bw * depth + 16)
    node_key = np.full(base[0] + W * depth, -7, np.int64)
    kidx_v = np.full(base[1] + W * depth, -7, np.int64)
    examined = np.zeros(W, np.int64)
    for b in range(-(-W // bw)):
        w0 = b * bw
        nw = min(bw, W - w0)
        span = nw * depth
        g0 = w0 * depth
        s = np.zeros(smem // 4, np.int64)
        a, bk = _staged_ranges(base[0] + g0, base[1] + g0, span, smem)
        s[a:a + span] = _I32_MAX
        s[bk:bk + span] = _I32_MAX
        for t in range(nw):
            hits, examined[w0 + t], _ = _window_walk(win, rec, w0 + t, depth)
            for d, node in hits:
                s[a + t * depth + d] = node
                s[bk + t * depth + d] = (w0 + t) % K
        _flat_store(base[0] + g0, span, s, node_key, a)
        _flat_store(base[1] + g0, span, s, kidx_v, bk)
    return (node_key[base[0]:].reshape(R, K * depth),
            kidx_v[base[1]:].reshape(R, K * depth), examined.reshape(R, K))


def _table_union(lo, examined, M):
    """The entries the emulated walks examined, each once: the union of
    [loc, loc + examined) over the windows."""
    loc = np.minimum(lo.numpy().reshape(-1).astype(np.int64), M - 1)
    seen = set()
    for a, n in zip(loc, examined.reshape(-1)):
        seen.update(range(a, a + n))
    return seen


def _check_table_bytes(lo, examined, M):
    """chip_smoke.dup_table_bytes (the table part of the classic bound)
    against the emulated walks' entries, counted once: 12 bytes an entry
    with the table in L2, else ceil(12 L / 32) sectors for each run of L
    adjacent entries (forced here with an L2 of 0 bytes)."""
    seen = _table_union(lo, examined, M)
    n = torch.from_numpy(examined)
    assert chip_smoke.dup_table_bytes(lo, n, M) == (
        len(seen), 12 * len(seen), "bytes (in L2)")
    sectors = sum(-(-12 * L // 32) for L in _runs(sorted(seen)))
    assert chip_smoke.dup_table_bytes(lo, n, M, l2_bytes=0) == (
        len(seen), 32 * sectors, "32-byte sectors (past L2)")


def _runs(entries):
    """The lengths of the runs of adjacent values in a sorted list."""
    runs = []
    for i, e in enumerate(entries):
        if i and e == entries[i - 1] + 1:
            runs[-1] += 1
        else:
            runs.append(1)
    return runs


def _check_dup_emulations(win, tab, depth, N):
    """Both emulations against the plain versions, with the table as the
    record the kernels read, and their examined entries against
    chip_smoke.dup_walk_entries and dup_table_bytes (what the smoke's bound
    counts)."""
    rec = ck.table_record(*tab)
    want_entries = chip_smoke.dup_walk_entries(win[0], win[2], win[3],
                                               tab[0], depth).numpy()
    cnt, kmin, ex_stats = _emulate_dup_stats(win, rec.numpy(), depth, N)
    node_key, kidx_v, ex_scan = _emulate_dup_scan(win, rec.numpy(), depth)
    wc, wk = ck.dup_stats_plain(*win, rec, depth, N)
    np.testing.assert_array_equal(cnt, wc.numpy())
    np.testing.assert_array_equal(kmin, wk.numpy())
    wn, wv = ck.dup_scan_plain(*win, rec, depth)
    np.testing.assert_array_equal(node_key, wn.numpy())
    np.testing.assert_array_equal(kidx_v, wv.numpy())
    np.testing.assert_array_equal(ex_stats, want_entries)
    np.testing.assert_array_equal(ex_scan, want_entries)
    _check_table_bytes(win[3], ex_stats, rec.shape[0])
    return cnt, kmin, node_key, kidx_v


@pytest.mark.parametrize("depth", [1, 2, 17, 40])
def test_dup_emulations_match_plain_and_jax(depth):
    """Both kernels' emulations on the reads' windows over a padded table
    (with the padding, M - 3 and all-invalid rows): equal to the plain
    versions and to the JAX package's _dup_scan_stats_impl and
    _sparse_expand_matches; each window examines exactly the entries the
    bound counts."""
    table, win, tab, j = _scan_case()
    N = table.num_nodes
    cnt, kmin, node_key, kidx_v = _check_dup_emulations(win, tab, depth, N)
    wc, wk = JP._dup_scan_stats_impl(*j, depth, N)
    np.testing.assert_array_equal(cnt, np.asarray(wc))
    np.testing.assert_array_equal(kmin, np.asarray(wk))
    wn, wv = JP._sparse_expand_matches(*j, depth)
    np.testing.assert_array_equal(node_key, np.asarray(wn))
    np.testing.assert_array_equal(kidx_v, np.asarray(wv))
    assert cnt.sum() > 0


@pytest.mark.parametrize("R,K,D,m_real,M,N", [
    (min(R, 41), K, D, m_real, M, N)
    for R, K, D, m_real, M, N in chip_smoke.CLASSIC_RAGGED])
def test_dup_emulations_ragged(R, K, D, m_real, M, N):
    """The emulations at the smoke's ragged shapes (rows cut to 41 here)
    against the plain versions, with output bases at every 16-byte phase
    the staging meets (the rows' flat offsets)."""
    win, tab = chip_smoke.classic_ragged_case(np.random.RandomState(R * K + D),
                                              R, K, m_real, M, N)
    win = tuple(torch.from_numpy(a) for a in win)
    tab = tuple(torch.from_numpy(a) for a in tab)
    _check_dup_emulations(win, tab, D, N)
    shared = _stats_plan(R, K, N)[2] > 0
    assert shared == (N != 30000)


@pytest.mark.parametrize("R,K,N", [(32768, 95, 1024), (32768, 201, 773),
                                   (16384, 95, 6000), (64, 95, 30000),
                                   (32768, 18, 773), (2, 5000, 50)])
def test_dup_stats_plan(R, K, N):
    """The plan at the paths' shapes (repeat: 2 rows, 192 threads; HIV: 1
    row, 224 threads) and beyond: about kWindows windows a block, whole
    warps, shared counters within a block's 227 KB, else global atomics."""
    rows, threads, smem = _stats_plan(R, K, N)
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert threads >= min(rows * K, 1024)
    assert rows == 1 or rows * K <= _cu_const("kWindows", _STATS_CU)
    assert smem <= 227 * 1024
    assert (smem > 0) == (8 * N + 64 <= 227 * 1024)
    if (K, N) == (95, 1024):
        assert (rows, threads) == (2, 192)
    if (K, N) == (201, 773):
        assert (rows, threads) == (1, 224)


@pytest.mark.parametrize("D", [1, 4, 32, 64, 226, 227, 3000, 29000])
def test_dup_scan_block_windows(D):
    """Windows a dup_scan block stages: 128 (one a thread) while both
    planes fit a block's 227 KB, then halved; none past what one window
    can stage (the entry refuses it)."""
    w = _scan_block_windows(D)
    assert w == 0 or 4 * (2 * w * D + 16) <= 227 * 1024
    assert (w == 128) == (D <= 226)
    assert (w == 0) == (D > 29054)


def test_dup_table_bytes_counts_each_entry_once():
    """Windows that walk the same entries count them once: windows over
    entries 5-7, 6-9 and 6-9 again, one invalid (n = 0) window at 0, one
    clamped at M - 1 (entry 10) and one over entry 2 alone. Past L2, the
    run 5-10 (72 bytes) needs 3 sectors at best and entry 2 one."""
    M = 11
    lo = torch.tensor([[5, 6, 6, 0, 40, 2]], dtype=torch.int32)
    n = torch.tensor([[3, 4, 4, 0, 1, 1]], dtype=torch.int64)
    assert chip_smoke.dup_table_bytes(lo, n, M) == (7, 84, "bytes (in L2)")
    assert chip_smoke.dup_table_bytes(lo, n, M, l2_bytes=0) == (
        7, 128, "32-byte sectors (past L2)")

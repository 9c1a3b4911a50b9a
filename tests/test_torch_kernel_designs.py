"""The logic of the port's two redesigned CUDA kernels, which cannot run
on the CPU, emulated in numpy step for step and held to the plain
versions and the JAX package's Pallas kernels (interpret mode):

  * pair_counts (csrc/pair_counts.cu): the work list that the wrapper
    uploads (ops/cuda_kernels.py::pair_counts_schedule): the steps of the
    upper tiles I <= J cut into one equal-cost run of segments per SM;
    the emulation runs one integer product per segment as the kernel's
    wgmma loop does
    (f_I^T r_J, r_I^T f_J written transposed, f_I^T f_J + r_I^T r_J with
    the diagonal tile masked to i <= j) on the operand bytes it stages:
    the first launch's bit-packed words, expanded per nibble.
  * sort_rows (csrc/sort_rows.cu): the register-resident bitonic network,
    with each stage as a permutation of (warp, lane, register) slots:
    compare-exchange between registers for strides below P, a lane
    shuffle for strides below one warp's span, shared memory above it,
    coalesced loads in any order and the sorted row out through shared
    memory.

Every output is an integer, so every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vstrains_tpu.ops import pe_infer as JP
from vstrains_tpu.ops.pallas_kernels import pair_matmuls_pallas
from vstrains_tpu.ops.pallas_sort import sort_rows_pallas
from vstrains_tpu_torch.ops import cuda_kernels as ck

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
    """(P, W): registers a lane and warps a row of the network branch."""
    L = max(32, ck._pow2_at_least(C))
    return (L // 32, 1) if L <= 512 else (16, L // 512)


def _order(a, b, asc):
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    return np.where(asc, lo, hi), np.where(asc, hi, lo)


def _emulate_net(words, C, pad):
    """The network branch on words [R, C] (uint32 or uint64): x[r, w, l, p]
    is register p of lane l of warp w; returns the sorted [R, C]."""
    R = words.shape[0]
    P, W = _net_shape(C)
    span = 32 * P
    L = span * W
    wr = np.arange(W)[:, None, None]
    lane = np.arange(32)[None, :, None]
    p = np.arange(P)[None, None, :]
    e = wr * span + p * 32 + lane                  # coalesced load slot
    base = (wr * 32 + lane) * P                    # in-row index of x[0]
    idx = base + p                                 # in-row index of x[p]
    x = np.full((R, W, 32, P), pad, words.dtype)
    inside = np.broadcast_to(e < C, x.shape[1:])
    x[:, inside] = words[:, e[inside]]
    k = 2
    while k <= L:
        if k > span:                               # shared memory
            s = np.empty((R, L), words.dtype)
            s[:, idx.ravel()] = x.reshape(R, -1)
            j = k // 2
            while j >= span:
                t = np.arange(L // 2)
                i = ((t & ~(j - 1)) << 1) | (t & (j - 1))
                s[:, i], s[:, i + j] = _order(s[:, i], s[:, i + j],
                                              (i & k) == 0)
                j //= 2
            x = s[:, idx.ravel()].reshape(x.shape)
        j = min(k // 2, span // 2)
        while j > 0:
            if j >= P:                             # lane shuffle
                m = j // P
                y = x[:, :, np.arange(32) ^ m, :]
                keep_min = ((lane & m) == 0) == ((base & k) == 0)
                x = np.where(keep_min, np.minimum(x, y), np.maximum(x, y))
            else:                                  # registers
                for q in range(P):
                    if q & j:
                        continue
                    asc = (q & k) == 0 if k < P else (base[..., 0] & k) == 0
                    x[..., q], x[..., q | j] = _order(x[..., q],
                                                      x[..., q | j], asc)
            j //= 2
        k *= 2
    s = np.empty((R, L), words.dtype)
    s[:, idx.ravel()] = x.reshape(R, -1)
    return s[:, :C]


def _operands(rng, R, C):
    key = rng.randint(-2**31, 2**31, (R, C)).astype(np.int32)
    key[rng.rand(R, C) < 0.2] = _I32_MAX
    key[rng.rand(R, C) < 0.2] = -3
    val = rng.randint(-2**31, 2**31, (R, C)).astype(np.int32)
    val[rng.rand(R, C) < 0.1] = _I32_MAX
    return key, val


_BIAS = np.uint32(0x80000000)


@pytest.mark.parametrize("C", [1, 5, 100, 285, 402, 513, 4096])
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


@pytest.mark.parametrize("C", [1, 5, 100, 285, 402, 513, 4096])
def test_sort_network_emulation_key_val(C):
    """64-bit words (key ^ 2^31) << 32 | (val ^ 2^31), with INT32_MAX
    slots that must sort before the padding: equals np.lexsort, the plain
    version and the Pallas sorter."""
    rng = np.random.RandomState(1000 + C)
    key, val = _operands(rng, 3, C)
    words = ((key.view(np.uint32) ^ _BIAS).astype(np.uint64) << np.uint64(
        32)) | (val.view(np.uint32) ^ _BIAS).astype(np.uint64)
    got = _emulate_net(words, C, np.uint64(2**64 - 1))
    gk = ((got >> np.uint64(32)).astype(np.uint32) ^ _BIAS).view(np.int32)
    gv = ((got & np.uint64(0xFFFFFFFF)).astype(np.uint32) ^ _BIAS).view(
        np.int32)
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


def test_sort_network_shared_pad_is_conflict_free():
    """The kernel's shared-memory index i + (i >> 5) (32-bit words) and
    i + (i >> 4) (64-bit) puts a warp's strided stores (lane l, register
    p: slot 16 l + p) and its coalesced loads (slot 32 q + l) in distinct
    banks within each 128-byte access phase."""
    lane = np.arange(32)
    for shift, words_per_phase, bank_words in ((5, 32, 1), (4, 16, 2)):
        for p in range(16):
            for slots in (16 * lane + p, 32 * p + lane):
                pos = slots + (slots >> shift)
                for ph in range(0, 32, words_per_phase):
                    banks = (pos[ph:ph + words_per_phase] * bank_words) % 32
                    assert len(set(banks.tolist())) == words_per_phase

"""The port's kernel wrappers (plain PyTorch versions on CPU tensors) vs
the JAX package's Pallas kernels in interpret mode and their XLA
counterparts, on the same numpy-seeded inputs. Every output is an
integer, so every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vstrains_tpu.ops import pe_infer as JP
from vstrains_tpu.ops.pallas_kernels import (pair_matmuls_pallas,
                                             stats_accum_pallas,
                                             window_hashes_pallas)
from vstrains_tpu_torch.ops import cuda_kernels as ck
from vstrains_tpu_torch.ops import pe_infer as TP

torch.set_num_threads(1)


def _reads(rng, B, T, L, bad_rate=0.0):
    """uint8 codes [B, T] with 255 padding past each length, optional
    in-read bad codes, and int32 lengths in [L, T]."""
    codes = rng.randint(0, 4, (B, T)).astype(np.uint8)
    lens = rng.randint(L, T + 1, B).astype(np.int32)
    lens[0] = T
    if bad_rate:
        codes[rng.rand(B, T) < bad_rate] = 4
    codes[np.arange(T)[None, :] >= lens[:, None]] = 255
    return codes, lens


def _jax_hashes(codes, lens, L):
    h1, h2, valid = JP._device_window_hashes(jnp.asarray(codes),
                                             jnp.asarray(lens), L)
    q1 = (np.asarray(h1) ^ np.uint32(0x80000000)).view(np.int32)
    return q1, np.asarray(h2).view(np.int32), np.asarray(valid)


@pytest.mark.parametrize("B,T,L,bad_rate", [(16, 40, 7, 0.0),
                                            (16, 40, 7, 0.05),
                                            (8, 96, 22, 0.02),
                                            (4, 256, 56, 0.01)])
def test_window_hashes_match_pallas_and_xla(B, T, L, bad_rate):
    rng = np.random.RandomState(B + T + L)
    codes, lens = _reads(rng, B, T, L, bad_rate)
    q1, h2, valid = ck.window_hashes_bytes(torch.from_numpy(codes),
                                           torch.from_numpy(lens), L)
    xq1, xh2, xvalid = _jax_hashes(codes, lens, L)
    np.testing.assert_array_equal(q1.numpy(), xq1)
    np.testing.assert_array_equal(h2.numpy(), xh2)
    np.testing.assert_array_equal(valid.numpy(), xvalid)
    K = T - L + 1
    pq1, ph2, pvalid = window_hashes_pallas(
        jnp.asarray(codes), jnp.asarray(lens), L, block=min(B, 8),
        interpret=True)
    np.testing.assert_array_equal(q1.numpy(), np.asarray(pq1)[:, :K])
    np.testing.assert_array_equal(h2.numpy(), np.asarray(ph2)[:, :K])
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(pvalid)[:, :K].astype(bool))


def test_window_hashes_match_host_definition():
    """Against the host's direct L-term definition of the hash."""
    from vstrains_tpu.core.seq import _window_hashes_np_direct
    rng = np.random.RandomState(2)
    codes, lens = _reads(rng, 6, 64, 15, 0.03)
    q1, h2, valid = ck.window_hashes_bytes(torch.from_numpy(codes),
                                           torch.from_numpy(lens), 15)
    for i in range(6):
        d1, d2, dv = _window_hashes_np_direct(codes[i], 15)
        np.testing.assert_array_equal(
            q1[i].numpy(), (d1 ^ np.uint32(0x80000000)).view(np.int32))
        np.testing.assert_array_equal(h2[i].numpy(), d2.view(np.int32))
        K = 64 - 15 + 1
        inside = np.arange(K) + 15 <= lens[i]
        np.testing.assert_array_equal(valid[i].numpy(), dv & inside)


@pytest.mark.parametrize("T,L", [(40, 7), (250, 56)])
def test_wire_feed_matches_jax_unpack(T, L):
    """Wire pack -> the port's unpack + hash equals the JAX package's
    _unpack_wire + _device_window_hashes (the fused kernel's contract),
    including zero-length padding rows."""
    rng = np.random.RandomState(T)
    B = 12
    fc, fl = _reads(rng, B, T, L)
    rc, rl = _reads(rng, B, T - 3, L)
    fl[-2:] = 0
    rl[-2:] = 0
    wire = TP._pack_wire_np(fc, fl, rc, rl, T)
    np.testing.assert_array_equal(wire, JP._pack_wire_np(fc, fl, rc, rl, T))
    q1, h2, valid = ck.window_hashes_wire(torch.from_numpy(wire), T, L)
    codes, lens = JP._unpack_wire(jnp.asarray(wire), T)
    xq1, xh2, xvalid = _jax_hashes(np.asarray(codes), np.asarray(lens), L)
    np.testing.assert_array_equal(q1.numpy(), xq1)
    np.testing.assert_array_equal(h2.numpy(), xh2)
    np.testing.assert_array_equal(valid.numpy(), xvalid)
    assert not valid.numpy()[[B - 2, B - 1, 2 * B - 2, 2 * B - 1]].any()
    np.testing.assert_array_equal(ck.wire_lens(torch.from_numpy(wire))
                                  .numpy(), np.asarray(lens))


def _node_slots(rng, R, K, depth, N):
    nt = rng.randint(0, N, (R, K * depth)).astype(np.int32)
    nt[rng.rand(R, K * depth) < 0.6] = N  # misses carry the sentinel
    return nt


@pytest.mark.parametrize("depth", [1, 4, 16])
@pytest.mark.parametrize("N", [10, 773])
def test_stats_accum_matches_pallas_and_scatter(depth, N):
    rng = np.random.RandomState(depth * 1000 + N)
    R, K = 16, 12
    nt = _node_slots(rng, R, K, depth, N)
    cnt, kmin = ck.stats_accum(torch.from_numpy(nt), depth, N)
    xc, xk = JP._slots_scatter_accum(jnp.asarray(nt), depth, N)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(xc))
    np.testing.assert_array_equal(kmin.numpy(), np.asarray(xk))
    pc, pk = stats_accum_pallas(jnp.asarray(nt), depth=depth, num_nodes=N,
                                interpret=True)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(pc))
    np.testing.assert_array_equal(kmin.numpy(), np.asarray(pk))


@pytest.mark.parametrize("B,N,pallas", [(32, 10, True), (64, 100, True),
                                        (48, 773, False)])
def test_pair_counts_match_pallas_and_xla(B, N, pallas):
    rng = np.random.RandomState(B + N)
    f = (rng.rand(B, N) < 0.3).astype(np.float32)
    r = (rng.rand(B, N) < 0.3).astype(np.float32)
    acc_nm = torch.full((N, N), 5, dtype=torch.int64)
    acc_sm = torch.full((N, N), 7, dtype=torch.int64)
    ck.pair_counts(torch.from_numpy(f).bool(), torch.from_numpy(r).bool(),
                   acc_nm, acc_sm)
    xnm, xsm = JP._pair_matmuls(jnp.asarray(f), jnp.asarray(r), N)
    np.testing.assert_array_equal(acc_nm.numpy() - 5, np.asarray(xnm))
    np.testing.assert_array_equal(acc_sm.numpy() - 7, np.asarray(xsm))
    if pallas:
        pnm, psm = pair_matmuls_pallas(jnp.asarray(f), jnp.asarray(r),
                                       interpret=True)
        np.testing.assert_array_equal(acc_nm.numpy() - 5, np.asarray(pnm))
        np.testing.assert_array_equal(acc_sm.numpy() - 7, np.asarray(psm))


def test_cpu_wrappers_do_not_count_launches():
    ck.reset_launches()
    rng = np.random.RandomState(0)
    codes, lens = _reads(rng, 4, 30, 7)
    ck.window_hashes_bytes(torch.from_numpy(codes), torch.from_numpy(lens),
                           7)
    ck.stats_accum(torch.from_numpy(_node_slots(rng, 4, 5, 2, 9)), 2, 9)
    key = torch.from_numpy(_node_slots(rng, 4, 5, 2, 9))
    ck.sort_rows(key, key.clone())
    ck.sort_rows(key)
    tab = torch.arange(16, dtype=torch.int32)
    win = torch.zeros((4, 5), dtype=torch.int32)
    ones = torch.ones((4, 5), dtype=torch.bool)
    rec = ck.table_record(tab, tab, tab)
    ck.dup_scan(win, win, ones, win, rec, 3)
    ck.dup_stats(win, win, ones, win, rec, 3, 9)
    ck.sort_cols(key)
    tables = ck.CooTables(9, "cpu", slots=4)
    ck.coo_accum(torch.tensor([[0, 1, -1], [2, -1, -1]], dtype=torch.int32),
                 torch.tensor(False), tables)
    tables.grow(0)
    assert ck.LAUNCHES == {"window_hashes": 0, "stats_accum": 0,
                           "pair_counts": 0, "sort_rows": 0, "dup_scan": 0,
                           "dup_stats": 0, "sort_cols": 0, "coo_accum": 0}
    assert ck.SORT_ROWS_WIDTHS == {}
    assert [k["name"] for k in ck.KERNELS] == list(ck.LAUNCHES)


def test_non_cpu_tensors_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel or raises; here
    (meta and mixed devices) it must raise rather than run the plain
    version."""
    meta = torch.empty((4, 30), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        ck.window_hashes_bytes(meta, torch.zeros(4, dtype=torch.int32), 7)
    with pytest.raises(ValueError):
        ck.stats_accum(torch.empty((4, 8), dtype=torch.int32,
                                   device="meta"), 2, 9)
    acc = torch.zeros((3, 3), dtype=torch.int64)
    with pytest.raises(ValueError):
        ck.pair_counts(torch.zeros((2, 3), dtype=torch.uint8),
                       torch.zeros((2, 3), dtype=torch.uint8,
                                   device="meta"), acc, acc)
    key = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ck.sort_rows(key)
    with pytest.raises(ValueError):
        ck.sort_rows(key, torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        ck.sort_cols(key)
    tab = torch.zeros(16, dtype=torch.int32)
    meta_valid = torch.zeros((4, 8), dtype=torch.bool)
    rec = ck.table_record(tab, tab, tab)
    with pytest.raises(ValueError):
        ck.dup_scan(key, key, meta_valid, key, rec, 2)
    with pytest.raises(ValueError):
        ck.dup_stats(key, key, meta_valid, key, rec, 2, 9)

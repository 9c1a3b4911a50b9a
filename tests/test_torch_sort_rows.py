"""The port's row sorter (`sort_rows`, plain PyTorch version on CPU
tensors) vs the JAX package's Pallas bitonic sorter in interpret mode,
np.lexsort, and — key-only on the transpose — the column sorter
prototype. Every output is an integer, so every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vstrains_tpu.ops.pallas_sort import sort_rows_pallas
from vstrains_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

_I32_MAX = 2**31 - 1


def _operands(rng, R, C):
    """int32 keys and values over the whole signed range, with repeated
    keys, INT32_MAX keys (they must sort before the padding) and negative
    and INT32_MAX values."""
    key = rng.randint(-2**31, 2**31, (R, C)).astype(np.int32)
    key[rng.rand(R, C) < 0.2] = _I32_MAX
    key[rng.rand(R, C) < 0.2] = -3
    val = rng.randint(-2**31, 2**31, (R, C)).astype(np.int32)
    val[rng.rand(R, C) < 0.1] = _I32_MAX
    return key, val


def _lexsorted(key, val):
    order = np.lexsort((val, key), axis=-1)
    return (np.take_along_axis(key, order, axis=1),
            np.take_along_axis(val, order, axis=1))


# the shapes of test_pallas_kernels.test_sort_rows_pallas_matches_lexsort
# plus one-slot rows and a row one past a power of two
@pytest.mark.parametrize("R,C", [(32, 100), (16, 256), (8, 5), (4, 1),
                                 (2, 513)])
def test_sort_rows_matches_pallas_and_lexsort(R, C):
    rng = np.random.RandomState(R * 1000 + C)
    key, val = _operands(rng, R, C)
    ko, vo = ck.sort_rows(torch.from_numpy(key), torch.from_numpy(val))
    want_k, want_v = _lexsorted(key, val)
    np.testing.assert_array_equal(ko.numpy(), want_k)
    np.testing.assert_array_equal(vo.numpy(), want_v)
    pk, pv = sort_rows_pallas(jnp.asarray(key), jnp.asarray(val),
                              block=min(R, 8), interpret=True)
    np.testing.assert_array_equal(ko.numpy(), np.asarray(pk))
    np.testing.assert_array_equal(vo.numpy(), np.asarray(pv))


def test_signed_order_on_negative_values():
    """A plain (key << 32) | val packing would order a negative value
    after every positive one; the plain version must not."""
    key = np.array([[5, 5, 5, 5, -1]], np.int32)
    val = np.array([[3, -7, _I32_MAX, -2**31, 0]], np.int32)
    ko, vo = ck.sort_rows(torch.from_numpy(key), torch.from_numpy(val))
    np.testing.assert_array_equal(ko.numpy(), [[-1, 5, 5, 5, 5]])
    np.testing.assert_array_equal(vo.numpy(),
                                  [[0, -2**31, -7, 3, _I32_MAX]])


@pytest.mark.parametrize("R,C", [(16, 100), (3, 1)])
def test_key_only_orders_by_key(R, C):
    rng = np.random.RandomState(C)
    key, _ = _operands(rng, R, C)
    ko = ck.sort_rows(torch.from_numpy(key))
    assert isinstance(ko, torch.Tensor)
    np.testing.assert_array_equal(ko.numpy(), np.sort(key, axis=1))


@pytest.mark.parametrize("L,W", [(16, 256), (64, 512)])
def test_key_only_transpose_matches_column_sorter(L, W, monkeypatch,
                                                  tmp_path):
    """Key-only on the transpose is the column sort of
    tools/colsort_proto.py::sort_cols_pallas (run in interpret mode)."""
    import importlib

    # the tool defaults a compilation-cache directory in the environment
    # when imported; keep that inside the test
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    proto = importlib.import_module("tools.colsort_proto")
    rng = np.random.RandomState(L + W)
    x = rng.randint(-2**31, 2**31, (L, W)).astype(np.int32)
    got = ck.sort_rows(torch.from_numpy(x).T.contiguous()).T
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=0))
    want = proto.sort_cols_pallas(jnp.asarray(x), blk=min(W, 256),
                                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_empty_rows():
    k = torch.zeros((0, 7), dtype=torch.int32)
    ko, vo = ck.sort_rows(k, k.clone())
    assert ko.shape == (0, 7) and vo.shape == (0, 7)

"""The port's graph passes vs the JAX package's: the exact host path must
be equal; the float32 device path (torch index_add_) sums in another
order than JAX's segment_sum, so it is held to rtol 1e-6."""

import numpy as np
import pytest
import torch

from vstrains_tpu.core.graph import new_view as jax_new_view
from vstrains_tpu.ops import graph_ops as JG
from vstrains_tpu_torch.core.graph import new_view
from vstrains_tpu_torch.ops import graph_ops as TG

torch.set_num_threads(1)


def _random_graph(factory, seed, n=60, m=150):
    rng = np.random.RandomState(seed)
    v = factory()
    nodes = [v.add_vertex(str(i), float(rng.randint(1, 500)), "ACGT" * 3)
             for i in range(n)]
    seen = set()
    while len(seen) < m:
        a, b = (int(x) for x in rng.randint(0, n, 2))
        if a != b and (a, b) not in seen:
            seen.add((a, b))
            v.add_edge(nodes[a], nodes[b], 3)
    return v


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_path_equal(seed):
    a = _random_graph(new_view, seed)
    b = _random_graph(jax_new_view, seed)
    TG.assign_edge_flow(a)
    JG.assign_edge_flow(b)
    assert [e.flow for e in a.edges.values()] == \
        [e.flow for e in b.edges.values()]


@pytest.mark.parametrize("seed", [0, 1])
def test_device_path_matches_jax_float32(seed):
    a = _random_graph(new_view, seed)
    b = _random_graph(jax_new_view, seed)
    with torch.device("cpu"):
        got = TG.edge_flow_device(a.tensors())
        TG.assign_edge_flow(a, exact=False)
    want = JG.edge_flow_device(b.tensors())
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose([e.flow for e in a.edges.values()], want,
                               rtol=1e-6)


@pytest.mark.parametrize("dps", [
    [50.0] * 10,
    [1.0] * 50 + [3.0] * 30 + [5.0] * 10 + [100.0] * 20,
    [1.0] * 5 + [100.0] * 60 + [50.0] * 10,
])
def test_threshold_estimation_equal(dps):
    assert TG.threshold_estimation(np.array(dps)) == \
        JG.threshold_estimation(np.array(dps))

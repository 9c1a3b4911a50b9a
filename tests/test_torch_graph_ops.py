"""The port's graph passes vs the JAX package's: the exact host path must
be equal; the float32 device path (torch index_add_) sums in another
order than JAX's segment_sum, so it is held to rtol 1e-6."""

import numpy as np
import pytest
import torch

from vstrains_tpu.core.graph import new_view as jax_new_view
from vstrains_tpu.ops import graph_ops as JG
from vstrains_tpu_torch.core.graph import new_view
from vstrains_tpu_torch.device import run_on
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
    got = TG.edge_flow_device(a.tensors(), device="cpu")
    with run_on(torch.device("cpu")):  # device=None: the run's device
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


def _graph_kind(factory, kind):
    """A seeded graph of one kind: a DAG (edges low -> high id only), the
    DAG plus one back edge, the DAG plus a self loop, or a random graph
    (cycles), built alike in either package."""
    rng = np.random.RandomState(11)
    v = factory()
    n = 40
    nodes = [v.add_vertex(str(i), float(rng.randint(1, 500)), "ACGT")
             for i in range(n)]
    if kind == "random":
        seen = set()
        while len(seen) < 90:
            a, b = (int(x) for x in rng.randint(0, n, 2))
            if a != b and (a, b) not in seen:
                seen.add((a, b))
                v.add_edge(nodes[a], nodes[b], 3)
        return v
    seen = set()
    while len(seen) < 80:
        a, b = sorted(int(x) for x in rng.randint(0, n, 2))
        if a != b and (a, b) not in seen:
            seen.add((a, b))
            v.add_edge(nodes[a], nodes[b], 3)
    if kind == "back_edge":
        a, b = max(seen, key=lambda e: e[1] - e[0])  # a path a -> b exists
        v.add_edge(nodes[b], nodes[a], 3)
    elif kind == "self_loop":
        v.add_edge(nodes[7], nodes[7], 3)
    return v


@pytest.mark.parametrize("kind,is_dag", [("dag", True), ("back_edge", False),
                                         ("self_loop", False),
                                         ("random", False)])
def test_graph_is_dag_device_matches_jax_and_host(kind, is_dag):
    """The source-elimination DAG check (on the CPU here) against the JAX
    package's _dag_check_kernel and the host DFS (algos/dag.graph_is_DAG)."""
    from vstrains_tpu_torch.algos.dag import graph_is_DAG
    a = _graph_kind(new_view, kind)
    b = _graph_kind(jax_new_view, kind)
    got = TG.graph_is_dag_device(a.tensors(), device="cpu")
    assert got is is_dag
    assert JG.graph_is_dag_device(b.tensors()) is is_dag
    assert graph_is_DAG(a) is is_dag


def test_assign_edge_flow_device_cpu_matches_exact_at_scale():
    """At the device path's own size (20,000 edges, where exact=None
    switches to it) the float32 pass on the CPU equals the float64 host
    path to rtol 1e-6: integer depths and sums are exact in float32, and
    the flow takes a few roundings of 2^-24 each."""
    a = _random_graph(new_view, 3, n=6000, m=20_000)
    b = _random_graph(new_view, 3, n=6000, m=20_000)
    assert a.num_edges() == 20_000
    TG.assign_edge_flow(a, exact=False, device="cpu")
    TG.assign_edge_flow(b, exact=True)
    got = np.array([e.flow for e in a.edges.values()])
    want = np.array([e.flow for e in b.edges.values()])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert not np.array_equal(got, want)  # it did take the float32 pass


@pytest.mark.parametrize("call", [
    lambda v: TG.edge_flow_device(v.tensors()),
    lambda v: TG.edge_flow_device(v.tensors(), device="cuda"),
    lambda v: TG.assign_edge_flow(v, exact=False, device="cuda"),
    lambda v: TG.assign_edge_flow(v, exact=False),
    lambda v: TG.graph_is_dag_device(v.tensors())],
    ids=["edge_flow_default", "edge_flow_cuda", "assign_edge_flow_cuda",
         "assign_edge_flow_default", "dag_default"])
def test_device_passes_without_cuda_raise(call):
    """The device passes run on the card unless the caller asks for the
    CPU: without a card they raise instead of measuring the host. Outside
    a run, assign_edge_flow's device=None means the card, whatever torch's
    default device is."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    with torch.device("cpu"), \
            pytest.raises(RuntimeError, match="CUDA is not available"):
        call(_random_graph(new_view, 0))

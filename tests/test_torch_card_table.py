"""The PE k-mer table built on the run's device (`pe_infer._card_table`,
here on the CPU through the plain window hashes) against the JAX
package's table (`build_kmer_table(..., bucket_index=True)` and
`_build_sortfill_payloads`), and the port's host build beside it: every
entry array with its padding, max_dup, the entry count, the packed
payloads, the classic probe's record and bucket index, on graphs that
reach each rule of the build. Then the engine: the same links whether its
table is a host build copied over or built on the device, one device
build a call, and nothing kept from one call to the next."""

import numpy as np
import pytest
import torch

from vstrains_tpu.ops import pe_infer as JP
from vstrains_tpu_torch.core.fastq import ReadPairBatch, _pack
from vstrains_tpu_torch.ops import cuda_kernels as ck
from vstrains_tpu_torch.ops import pe_infer as TP
from vstrains_tpu_torch.utils import tracing

torch.set_num_threads(1)

CPU = torch.device("cpu")
_COMP = str.maketrans("ACGT", "TGCA")


def _random(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.randint(0, 4, n))


def _revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def _hiv_labmix():
    """The graph of the benchmark's hiv_labmix generator at seed 0: 773
    nodes."""
    from portbench.gen import hivsim
    genomes, _ = hivsim.simulate_strains(9719, seed=0)
    return hivsim._build_unitigs(genomes, 56)[0], 56


def _n_bases():
    """N and lowercase bases inside nodes: their windows are invalid."""
    rng = np.random.RandomState(1)
    seqs = []
    for i in range(40):
        s = list(_random(rng, rng.randint(20, 200)))
        for p in rng.randint(0, len(s), rng.randint(0, 4)):
            s[p] = "N" if i % 3 else "a"
        seqs.append("".join(s))
    return seqs, 12


def _short_nodes():
    """Nodes shorter than split_len, empty ones, and nodes of exactly
    split_len, between long ones."""
    rng = np.random.RandomState(2)
    lens = [0, 5, 11, 12, 13, 90, 0, 3, 150, 11, 12, 70]
    return [_random(rng, n) for n in lens], 12


def _duplicated_nodes():
    """One sequence in several nodes, and one node's reverse complement in
    another: equal (h1, h2) across nodes, so the tie order counts."""
    rng = np.random.RandomState(3)
    a, b = _random(rng, 80), _random(rng, 60)
    return [a, _random(rng, 50), a, b, _revcomp(b), a[10:70], b], 12


def _palindromes():
    """Windows that are their own reverse complements: the forward and
    the reverse entry at one (node, offset) are equal."""
    rng = np.random.RandomState(4)
    seqs = []
    for n in (6, 10, 20):
        x = _random(rng, n)
        seqs.append(_random(rng, 15) + x + _revcomp(x) + _random(rng, 15))
    return seqs + ["ACGT" * 20, "AT" * 30], 12


def _max_dup_over_16():
    """A motif in 20 nodes: max_dup past 16, the classic probe's table."""
    rng = np.random.RandomState(5)
    motif = _random(rng, 40)
    return [motif + _random(rng, 60) for _ in range(20)] + \
        [_random(rng, 90) for _ in range(5)], 12


def _no_usable_node():
    return ["ACG", "", "ACGTACGTAC", "NNNNNNNNNNNNNNNNNNNN"], 12


def _past_a_bucket():
    """1,026 entries: 2 past the bucket of 1,024, padded to 2,048."""
    return [_random(np.random.RandomState(6), 12 + 512)], 12


GRAPHS = {"hiv_labmix": _hiv_labmix, "n_bases": _n_bases,
          "short_nodes": _short_nodes, "duplicated_nodes": _duplicated_nodes,
          "palindromes": _palindromes, "max_dup_over_16": _max_dup_over_16,
          "no_usable_node": _no_usable_node, "past_a_bucket": _past_a_bucket}


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_card_table_equals_the_host_build(graph):
    seqs, L = GRAPHS[graph]()
    table = TP.build_kmer_table(seqs, L)
    assert table.codes.dtype == np.uint8 and table.num_nodes == len(seqs)
    card = TP._card_table(table, CPU)
    jax = JP.build_kmer_table(seqs, L, bucket_index=True)
    host = TP._build_kmer_table(seqs, L)
    for f in ("h1_biased", "h2", "node", "offset"):
        got = getattr(card, f).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, getattr(jax, f), err_msg=f)
        np.testing.assert_array_equal(got, getattr(host, f), err_msg=f)
    assert (card.max_dup, card.num_entries, card.num_nodes) == \
        (jax.max_dup, jax.num_entries, jax.num_nodes) == \
        (host.max_dup, host.num_entries, len(seqs))
    if graph == "no_usable_node":
        assert card.num_entries == 0 and card.h1_biased.numel() == 0
        return
    M = jax.h1_biased.size
    assert M == TP._bucket_size(jax.num_entries)
    if graph == "past_a_bucket":
        assert (jax.num_entries, M) == (1026, 2048)
    if graph == "duplicated_nodes":
        key = jax.h1_biased.astype(np.int64) << 32 | jax.h2.view(np.uint32)
        assert (np.diff(key[:jax.num_entries]) == 0).any()
    if graph == "palindromes":
        m = jax.num_entries
        rows = np.stack([jax.h1_biased, jax.h2, jax.node,
                         jax.offset])[:, :m]
        assert (rows[:, 1:] == rows[:, :-1]).all(axis=0).any()
    nb = TP._sortfill_node_bits(len(seqs))
    pays = TP._card_payloads(card, nb).numpy()
    np.testing.assert_array_equal(pays, JP._build_sortfill_payloads(jax, nb))
    np.testing.assert_array_equal(pays, TP._build_sortfill_payloads(host, nb))
    want = ck.table_record(*(torch.from_numpy(getattr(jax, f))
                             for f in ("h1_biased", "h2", "node")))
    tab = TP._device_table(card, "join")
    assert torch.equal(tab.rec, want)
    assert tab.depth == jax.max_dup
    starts, shift, depth = TP._card_bucket_index(card)
    np.testing.assert_array_equal(starts.numpy(), jax.bucket_starts)
    assert (shift, depth) == (jax.bucket_shift, jax.scan_depth)
    w_starts, w_shift, w_depth = TP._bucket_index(host)
    np.testing.assert_array_equal(starts.numpy(), w_starts)
    assert (shift, depth) == (w_shift, w_depth)
    if graph == "max_dup_over_16":
        assert jax.max_dup > TP._SORTFILL_MAX_DUP
        assert TP._route_probe("sort", False, card, TP._LOG) == "join"


def _reads(seqs, n_pairs, read_len, seed):
    """Read pairs drawn from the nodes, either strand."""
    rng = np.random.RandomState(seed)
    long = [s for s in seqs if len(s) >= read_len]

    def draw():
        ref = long[rng.randint(len(long))]
        p = rng.randint(0, len(ref) - read_len + 1)
        read = ref[p:p + read_len]
        return read if rng.rand() < 0.5 else _revcomp(read)

    pairs = [(draw().encode(), draw().encode()) for _ in range(n_pairs)]
    fc, fl = _pack([f for f, _ in pairs], pad_to_multiple=32)
    rc, rl = _pack([r for _, r in pairs], pad_to_multiple=32)
    return ReadPairBatch(fc, fl, rc, rl, 0, 0, n_pairs)


def _links(res):
    if isinstance(res, TP.PEResult):
        return res.node_mat, res.short_mat
    return res.pair_keys, res.pair_counts, res.short_keys, res.short_counts


@pytest.mark.parametrize("stats_mode,probe_mode", [
    ("dense", "sort"), ("sparse", "sort"), ("dense", "sortjoin"),
    ("dense", "lookup"), ("sparse", "lookup")])
def test_engine_links_equal_on_either_table_route(stats_mode, probe_mode):
    """The engine's dense, COO and classic results with the table built on
    the device equal those with the host build's arrays copied over."""
    seqs, L = _duplicated_nodes()
    seqs = seqs + _max_dup_over_16()[0][:6]
    reads = _reads(seqs, 300, 40, 7)
    ids = [str(i) for i in range(len(seqs))]
    kw = dict(batch_size=64, stats_mode=stats_mode, probe_mode=probe_mode,
              device="cpu")
    card = TP.infer_pe_links(ids, seqs, reads, L - 1,
                             table=TP.build_kmer_table(seqs, L), **kw)
    host = TP.infer_pe_links(ids, seqs, reads, L - 1,
                             table=TP._build_kmer_table(seqs, L), **kw)
    assert type(card) is type(host)
    got, want = _links(card), _links(host)
    assert sum(int(np.sum(a)) for a in want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_one_card_build_a_call_and_none_from_host_arrays():
    """pe.table_card_builds rises by one for each call on an encoded
    table, also the same table again, and not for a host-built table."""
    seqs, L = _n_bases()
    reads = _reads(seqs, 100, 30, 8)
    ids = [str(i) for i in range(len(seqs))]
    table = TP.build_kmer_table(seqs, L)

    def builds(t):
        before = tracing.totals()["counters"].get("pe.table_card_builds", 0)
        TP.infer_pe_links(ids, seqs, reads, L - 1, batch_size=64, table=t,
                          device="cpu")
        return tracing.totals()["counters"]["pe.table_card_builds"] - before

    assert [builds(table), builds(table), builds(None),
            builds(TP._build_kmer_table(seqs, L))] == [1, 1, 1, 0]


def test_a_second_call_on_altered_sequences_sees_them():
    """No table is kept from a call: a table of altered sequences gives
    their own entries and links."""
    seqs, L = _short_nodes()
    reads = _reads(seqs, 120, 30, 9)
    ids = [str(i) for i in range(len(seqs))]
    first = TP.infer_pe_links(ids, seqs, reads, L - 1, batch_size=64,
                              table=TP.build_kmer_table(seqs, L),
                              device="cpu")
    altered = [s[:40] + _revcomp(s[40:80]) + s[80:] if len(s) > 80 else s
               for s in seqs]
    table = TP.build_kmer_table(altered, L)
    card = TP._card_table(table, CPU)
    host = TP._build_kmer_table(altered, L)
    np.testing.assert_array_equal(card.h1_biased.numpy(), host.h1_biased)
    second = TP.infer_pe_links(ids, altered, reads, L - 1, batch_size=64,
                               table=table, device="cpu")
    want = TP.infer_pe_links(ids, altered, reads, L - 1, batch_size=64,
                             table=host, device="cpu")
    np.testing.assert_array_equal(second.node_mat, want.node_mat)
    np.testing.assert_array_equal(second.short_mat, want.short_mat)
    assert not np.array_equal(second.node_mat, first.node_mat)

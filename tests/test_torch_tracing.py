"""The port's spans and counters (`utils/tracing.py`) on the CPU: always
on and cheap with no profiler running, in the profiler's trace on its
clock while one runs, and placed in the PE engine so that every span of
each engine shows in one pass, with the H2D and D2H bytes counted."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vstrains_tpu_torch.core.fastq import ReadPairBatch, _pack
from vstrains_tpu_torch.ops import cuda_kernels as ck
from vstrains_tpu_torch.ops import pe_infer as TP
from vstrains_tpu_torch.utils import tracing

torch.set_num_threads(1)

DENSE_SPANS = {"pe.table_build", "pe.table_upload", "pe.pack", "pe.upload",
               "pe.queue", "pe.drain"}
SPARSE_SPANS = DENSE_SPANS | {"pe.wait", "pe.coo"}


def _inputs(seed=5, n_nodes=7, n_pairs=150, read_len=40, k=11):
    """A few random nodes and read pairs drawn from them (both strands)."""
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = [bases[rng.randint(0, 4, n)].tobytes().decode()
            for n in rng.randint(read_len + 10, 160, n_nodes)]
    comp = str.maketrans("ACGT", "TGCA")

    def draw():
        ref = refs[rng.randint(n_nodes)]
        p = rng.randint(0, len(ref) - read_len)
        read = ref[p: p + read_len]
        return read if rng.rand() < 0.5 else read.translate(comp)[::-1]

    pairs = [(draw().encode(), draw().encode()) for _ in range(n_pairs)]
    fc, fl = _pack([f for f, _ in pairs], pad_to_multiple=32)
    rc, rl = _pack([r for _, r in pairs], pad_to_multiple=32)
    reads = ReadPairBatch(fc, fl, rc, rl, 0, 0, n_pairs)
    return [str(i) for i in range(n_nodes)], refs, reads, k


def _profiled_pass(tmp_path, **kw):
    """One engine pass under a CPU profiler: (result, the registry's
    spans of the pass, the exported trace)."""
    ids, refs, reads, k = _inputs()
    before = len(tracing.profiled()["spans"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = TP.infer_pe_links(ids, refs, reads, k, batch_size=32,
                                device="cpu", **kw)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    return res, tracing.profiled()["spans"][before:], trace


def test_span_without_profiler_only_adds_to_its_total():
    before = tracing.totals()["span_ns"].get("pe.test_off", 0)
    reg = tracing.profiled()
    with tracing.span("pe.test_off"):
        sum(range(1000))
    tracing.count("pe.test_count", 3)
    now = tracing.totals()
    assert now["span_ns"]["pe.test_off"] > before
    assert now["counters"]["pe.test_count"] >= 3
    after = tracing.profiled()
    assert after["spans"] == reg["spans"]
    assert "pe.test_off" not in after["span_ns"]
    assert "pe.test_count" not in after["counters"]
    # a profiler started afterwards finds no event of that span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert not [e for e in prof.events() if e.name.startswith("pe.")]


@pytest.mark.parametrize("mode,names", [("dense", DENSE_SPANS),
                                        ("sparse", SPARSE_SPANS)])
def test_engine_spans_in_trace_and_registry(tmp_path, mode, names):
    _, spans, trace = _profiled_pass(tmp_path, stats_mode=mode)
    assert {s[0] for s in spans} == names
    base = trace["baseTimeNanoseconds"]
    events = [e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("pe.")]
    for name in names:
        mine = sorted(s[1] for s in spans if s[0] == name)
        theirs = sorted(base + 1000 * float(e["ts"]) for e in events
                        if e["name"] == name)
        assert len(mine) == len(theirs), name
        worst = max(abs(a - b) for a, b in zip(mine, theirs))
        assert worst < 1e6, (name, worst)  # within 1 ms


def test_engine_spans_do_not_nest():
    """The six spans of a dense pass tile it: none starts inside another
    (the sparse engine's pe.wait and pe.coo nest in pe.drain)."""
    ids, refs, reads, k = _inputs()
    before = len(tracing.profiled()["spans"])
    with profile(activities=[ProfilerActivity.CPU]):
        TP.infer_pe_links(ids, refs, reads, k, batch_size=32, device="cpu",
                          stats_mode="dense")
    spans = sorted((s[1], s[1] + s[2]) for s in
                   tracing.profiled()["spans"][before:]
                   if s[0] in DENSE_SPANS)
    # registry stamps are on the wall clock, durations on the monotonic
    # one: allow a few microseconds of disagreement
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert b0 >= a1 - 50_000, (a0, a1, b0)


def test_dense_counters():
    ids, refs, reads, k = _inputs()
    table = TP.build_kmer_table(refs, k + 1)
    N = table.num_nodes
    before = tracing.totals()["counters"]
    res = TP.infer_pe_links(ids, refs, reads, k, batch_size=32,
                            device="cpu", stats_mode="dense", table=table)
    got = {key: v - before.get(key, 0)
           for key, v in tracing.totals()["counters"].items()}
    # the result, and the device table build's entry count and max_dup
    assert got["pe.d2h_bytes"] == 2 * N * N * 8 + 16
    assert res.node_mat.nbytes + res.short_mat.nbytes == 2 * N * N * 8
    batches = list(TP._wire_batches(reads, 32))
    assert all(kind == "wire" for kind, _ in batches)
    # the table goes over as node starts and lengths and its codes, padded
    # to whole hash rows, and is built there
    S, L, K = table.codes.size, table.split_len, TP._CARD_ROW_WINDOWS
    want = (table.starts.nbytes + table.seq_lens.nbytes
            + -(-(S - L + 1) // K) * K + L - 1
            + sum(p.nbytes for _, p in batches))
    assert got["pe.h2d_bytes"] == want
    assert got["pe.batches"] == len(batches) == -(-reads.num_pairs // 32)


def test_sparse_counters():
    ids, refs, reads, k = _inputs()
    before = tracing.totals()["counters"]
    res = TP.infer_pe_links(ids, refs, reads, k, batch_size=32,
                            device="cpu", stats_mode="sparse")
    got = {key: v - before.get(key, 0)
           for key, v in tracing.totals()["counters"].items()}
    n = -(-reads.num_pairs // 32)
    assert got["pe.batches"] == n
    # each batch's flags (the link tables' int64 counters), then the
    # pass's COO arrays, and the device table build's two integers
    coo = (res.pair_keys, res.pair_counts, res.short_keys, res.short_counts)
    assert got["pe.d2h_bytes"] == (n * ck.COO_STATS * 8
                                   + sum(a.nbytes for a in coo) + 16)
    assert got["pe.coo_unique_keys"] == res.pair_keys.size \
        + res.short_keys.size > 0


def test_profiled_counters_only_while_profiling():
    ids, refs, reads, k = _inputs()
    before = tracing.profiled()["counters"].get("pe.batches", 0)
    TP.infer_pe_links(ids, refs, reads, k, batch_size=32, device="cpu")
    assert tracing.profiled()["counters"].get("pe.batches", 0) == before
    with profile(activities=[ProfilerActivity.CPU]):
        TP.infer_pe_links(ids, refs, reads, k, batch_size=32, device="cpu")
    assert (tracing.profiled()["counters"]["pe.batches"] - before
            == -(-reads.num_pairs // 32))


def test_launch_counters_are_the_registrys_group():
    assert ck.LAUNCHES is tracing.counter_group("launches")
    assert ck.SORT_ROWS_WIDTHS is tracing.counter_group("sort_rows_widths")
    assert list(ck.LAUNCHES) == ["window_hashes", "stats_accum",
                                 "pair_counts", "sort_rows", "dup_scan",
                                 "dup_stats", "sort_cols", "coo_accum"]
    assert set(tracing.totals()["launches"]) == set(ck.LAUNCHES)


def test_stage_timer_stage_is_a_span():
    timer = tracing.StageTimer()
    before = tracing.totals()["span_ns"].get("test_stage", 0)
    with timer.stage("test_stage"):
        pass
    assert tracing.totals()["span_ns"]["test_stage"] > before
    assert [s["stage"] for s in timer.summary()["stages"]] == ["test_stage"]
    assert not hasattr(tracing.StageTimer, "device_trace")


def test_pipeline_logs_engine_line_and_span_line(tmp_path):
    from vstrains_tpu_torch import cli
    from vstrains_tpu_torch.evals.synth import make_dataset
    ds = make_dataset(str(tmp_path / "data"), num_strains=2, num_bubbles=2,
                      pairs_per_strain=150, seed=3)
    out = str(tmp_path / "out")
    argv = ["-a", "spades", "-g", ds.gfa_path, "-p", ds.paths_path,
            "-fwd", ds.fwd_path, "-rve", ds.rve_path, "-o", out,
            "--pe-batch-size", "128", "--device", "cpu"]
    with pytest.raises(SystemExit):
        cli.main(argv[:-2] + ["--profile-dir", str(tmp_path / "p")])
    assert cli.main(argv) == 0
    with open(os.path.join(out, "vstrains.log")) as fh:
        # the stages' lines are "<time> INFO | <message>"
        lines = [ln.split(" | ", 1)[-1] for ln in fh.read().splitlines()]
    engine = [i for i, ln in enumerate(lines)
              if ln.startswith("PE engine: ")]
    assert len(engine) == 1
    parts = lines[engine[0]].split()
    assert parts[3:5] == ["pairs", "in"] and parts[-1] == "s"
    float(parts[-2])
    spans = lines[engine[0] + 1]
    assert spans.startswith("PE spans and counters (table build and "
                            "engine): ")
    for name in sorted(DENSE_SPANS):
        assert f"{name} " in spans, name
    for name in ("pe.batches", "pe.h2d_bytes", "pe.d2h_bytes"):
        assert f"{name} " in spans, name
    # the engine built the table handed to it on its device, once
    assert "pe.table_card_builds 1" in spans


def test_counts_from_many_threads_are_not_lost():
    """Counters and span totals are updated under one lock: no update is
    lost with more threads than cores and a short switch interval."""
    import sys
    import threading
    n_threads, n_each = 2 * (os.cpu_count() or 4), 2000
    before = tracing.totals()["counters"].get("pe.test_threads", 0)

    def work():
        for _ in range(n_each):
            with tracing.span("pe.test_threads_span"):
                tracing.count("pe.test_threads")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = tracing.totals()["counters"]["pe.test_threads"] - before
    assert got == n_threads * n_each

"""Drift check: the port's copies of the JAX package's framework-free host
modules must equal the originals with the import prefix rewritten
(`vstrains_tpu` -> `vstrains_tpu_torch` on import lines), apart from an
explicit allow-list of original lines."""

import difflib
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIED = (
    [f"core/{m}.py" for m in ("__init__", "seq", "fastq", "graph", "gfa",
                              "canon", "contig_io", "pe_store")]
    + [f"algos/{m}.py" for m in ("__init__", "pathmath", "branches", "dag",
                                 "contig_ops", "compact", "preprocess",
                                 "decomposition", "extension", "tips")]
    + ["utils/__init__.py", "utils/checkpoint.py", "utils/validate.py",
       "native/__init__.py", "native/fastq_reader.cpp",
       "native/table_build.cpp", "ops/__init__.py"]
    + [f"evals/{m}.py" for m in ("__init__", "synth", "hivsim", "nga50",
                                 "refmap", "graphviz", "paf_interop",
                                 "quast", "sampling", "spades_wrapper")])

# original lines the port may change or drop: store_reinit_graph's edge
# flow comes from the port's own ops/graph_ops (the rewrite makes the
# line point there), the numeric guard is numpy.seterr alone, the native
# builds write a temporary name and move it into place (processes that
# build at once never load a half-written library) and the table entries
# are copies, not views that keep the cap-sized buffers alive, and the
# eval tools' usage lines name the port's modules
ALLOWED = {
    "native/__init__.py": {
        '        cmd = ["g++", *flags, "-shared", "-fPIC", "-o", _SO_PATH, '
        'src,',
        '           "-o", _TBL_SO_PATH, src]',
        "    return (h1[:m], h2[:m], node[:m], offset[:m],",
        "            int(max_dup.value) if m else 1)",
    },
    "evals/quast.py": {
        "    python -m vstrains_tpu.evals.quast -quast PATH -cs a.fasta "
        "b.fasta \\"},
    "evals/sampling.py": {
        "    python -m vstrains_tpu.evals.sampling -s 2 -f r1.fq -r r2.fq \\"},
    "evals/spades_wrapper.py": {
        "    python -m vstrains_tpu.evals.spades_wrapper -f R1 -r R2 \\"},
    "core/gfa.py": {
        "    from vstrains_tpu.ops.graph_ops import assign_edge_flow"},
    "utils/validate.py": {
        "`enable_numeric_guards()` mirrors the numpy fail-fast setting and "
        "turns",
        "on jax NaN debugging.",
        '    """Fail fast on FP anomalies (reference parity: numpy.seterr) '
        "and NaNs",
        '    escaping jitted device code."""',
        "    import jax",
        '    jax.config.update("jax_debug_nans", True)',
    },
}

# lines the port adds where the original has none: each native build
# moves its finished library into place
ADDED = {
    "native/__init__.py": {
        '        tmp = f"{_SO_PATH}.tmp{os.getpid()}"  # then moved into place',
        "            os.replace(tmp, _SO_PATH)",
        '    tmp = f"{_TBL_SO_PATH}.tmp{os.getpid()}"  # then moved into '
        'place',
        "        os.replace(tmp, _TBL_SO_PATH)"},
}

_IMPORT = re.compile(r"^(\s*)(from|import) vstrains_tpu(?=[.\s])")


def rewrite(line: str) -> str:
    return _IMPORT.sub(r"\1\2 vstrains_tpu_torch", line)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_equals_original(rel):
    with open(os.path.join(ROOT, "vstrains_tpu", rel)) as fh:
        orig = fh.read().splitlines()
    with open(os.path.join(ROOT, "vstrains_tpu_torch", rel)) as fh:
        port = fh.read().splitlines()
    want = [rewrite(x) for x in orig] if rel.endswith(".py") else orig
    allowed = ALLOWED.get(rel, set())
    sm = difflib.SequenceMatcher(a=want, b=port, autojunk=False)
    for op, i1, i2, j1, j2 in sm.get_opcodes():
        if op == "equal":
            continue
        changed = [orig[i] for i in range(i1, i2)]
        stray = [x for x in changed if x not in allowed]
        if i2 == i1:  # an insertion: only the listed port lines
            stray = [x for x in port[j1:j2] if x not in ADDED.get(rel, ())]
        assert not stray, (
            f"{rel}: port differs from the original beyond the allow-list:"
            f"\n- {changed}\n+ {port[j1:j2]}")


def test_allow_list_names_real_lines():
    for rel, lines in ALLOWED.items():
        with open(os.path.join(ROOT, "vstrains_tpu", rel)) as fh:
            orig = set(fh.read().splitlines())
        assert lines <= orig, f"{rel}: stale allow-list entries"

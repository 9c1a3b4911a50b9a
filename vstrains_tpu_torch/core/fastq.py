"""FASTQ ingestion: decode read pairs into padded device-ready code tensors.

Host-side data loader feeding the PE-link inference engine
(ops/pe_infer.py). Replaces the reference's readlines()-into-RAM string loop
(/root/reference/utils/VStrains_PE_Inference.py:147-188) with a vectorized
byte-table decode into fixed-shape uint8 code arrays (A,C,G,T -> 0..3,
padding/N -> 255) plus per-read lengths, ready for sharding across a device
mesh.

Pair filtering parity (PE_Inference.py:160-165): a pair is dropped if either
mate contains 'N' (counted as n_reads) else if either mate is shorter than
k+1 (short_reads); remaining pairs are the tensor workload.

A C++ fast path (native/fastq_reader.cpp, loaded via ctypes) is used when
available; this module is the reference implementation and fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from vstrains_tpu_torch.core.seq import BAD_CODE, _ENC as _ENC_N


@dataclass
class ReadPairBatch:
    """All usable read pairs, padded to a common length per side."""
    fwd_codes: np.ndarray  # uint8 [B, Tf], BAD_CODE padded
    fwd_len: np.ndarray    # int32 [B]
    rve_codes: np.ndarray  # uint8 [B, Tr]
    rve_len: np.ndarray    # int32 [B]
    n_reads: int           # pairs dropped: contained N
    short_reads: int       # pairs dropped: shorter than k+1
    used_reads: int

    @property
    def num_pairs(self) -> int:
        return int(self.fwd_codes.shape[0])


def read_fastq_seqs(path: str) -> List[bytes]:
    """Return the raw sequence line (bytes) of every record.

    Accepts plain or gzip-compressed (.gz) FASTQ; CRLF line endings are
    tolerated (trailing '\\r' stripped)."""
    if path.endswith(".gz"):
        import gzip
        with gzip.open(path, "rb") as fh:
            data = fh.read()
    else:
        with open(path, "rb") as fh:
            data = fh.read()
    lines = data.split(b"\n")
    nrec = len(lines) // 4
    return [lines[i * 4 + 1].rstrip(b"\r") for i in range(nrec)]


def _pack(seqs: List[bytes], pad_to_multiple: int = 1
          ) -> Tuple[np.ndarray, np.ndarray]:
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    tmax = int(lens.max()) if len(seqs) else 0
    if pad_to_multiple > 1 and tmax % pad_to_multiple:
        tmax += pad_to_multiple - tmax % pad_to_multiple
    out = np.full((len(seqs), tmax), BAD_CODE, dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = _ENC_N[np.frombuffer(s, dtype=np.uint8)]
    return out, lens


def load_read_pairs(fwd_path: str, rve_path: str, split_len: int,
                    pad_to_multiple: int = 1,
                    use_native: bool = True) -> ReadPairBatch:
    """Load and filter paired FASTQ files into a ReadPairBatch.

    Uses the C++ loader (native/fastq_reader.cpp) when available; this
    Python path is the reference implementation and fallback.
    """
    if use_native:
        try:
            from vstrains_tpu_torch.native import load_read_pairs_native
            batch = load_read_pairs_native(fwd_path, rve_path, split_len,
                                           pad_to_multiple)
            if batch is not None:
                return batch
        except Exception:
            pass
    fwd = read_fastq_seqs(fwd_path)
    rve = read_fastq_seqs(rve_path)
    total = min(len(fwd), len(rve))

    n_reads = 0
    short_reads = 0
    keep_f: List[bytes] = []
    keep_r: List[bytes] = []
    for i in range(total):
        fs, rs = fwd[i], rve[i]
        if b"N" in fs or b"N" in rs:
            n_reads += 1
        elif len(fs) < split_len or len(rs) < split_len:
            short_reads += 1
        else:
            keep_f.append(fs)
            keep_r.append(rs)

    fwd_codes, fwd_len = _pack(keep_f, pad_to_multiple)
    rve_codes, rve_len = _pack(keep_r, pad_to_multiple)
    return ReadPairBatch(fwd_codes, fwd_len, rve_codes, rve_len,
                         n_reads, short_reads, len(keep_f))

"""Paired-end link counts in plain PyTorch: the reference the benchmark
holds the program's PE engine to.

The semantics are VStrains' PE inference (VStrains_PE_Inference.py),
written out literally over exact k-mers rather than hashes:

  * the table holds every (k+1)-window of every node, and the reverse
    complement of it, each as an entry (node, forward offset); a window
    that is its own reverse complement is in it twice. Windows with a
    base other than A, C, G, T never match a read and are left out;
  * a pair is left out when either read holds an N (`n_reads`), else
    when either read is shorter than k+1 (`short_reads`);
  * for each read and node: the entries of that node that the read's
    windows match (`count`), the least offset (`coord`) and the least
    window index (`kidx`) among them. The node is saturated by the read
    when count >= max(min(R - L - k + 1, expected), 1), with
    L = max(coord, coord - kidx), R = min(coord + len(node) - 1,
    coord - kidx + len(read) - 1) and expected =
    (min(len(read), len(node)) - k) * (len(read) - k - 1) / len(read),
    in float64 as VStrains computes it;
  * node_mat[u, v] counts the pairs whose forward read saturates u and
    whose reverse read saturates v; short_mat[u, v], u <= v, counts the
    reads that saturate both u and v (each read of a pair counted).

A window is keyed exactly: its bases, two bits each, in words of at
most 31 bases, each word ranked among the table's words, so that a key
is a tuple of small ranks. Nothing here is taken from the program: no
hash, no table, no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
_WORD = 31  # bases in one int64 word
_MIX = 0x9E3779B97F4A7C15 - (1 << 64)  # odd, as a signed int64


@dataclass
class Reads:
    """The usable pairs, as base codes (255 past a read's end)."""
    fwd: np.ndarray      # uint8 [P, T]
    fwd_len: np.ndarray  # int64 [P]
    rve: np.ndarray
    rve_len: np.ndarray
    n_reads: int
    short_reads: int

    @property
    def num_pairs(self) -> int:
        return int(self.fwd.shape[0])


def fastq_seqs(path: str) -> List[bytes]:
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    return [line.rstrip(b"\r") for line in lines[1::4]]


def _codes(seqs: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    out = np.full((len(seqs), int(lens.max(initial=0))), 255, np.uint8)
    if len(seqs):
        flat = _CODE[np.frombuffer(b"".join(seqs), dtype=np.uint8)]
        rows = np.repeat(np.arange(len(seqs)), lens)
        cols = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens,
                                                lens)
        out[rows, cols] = flat
    return out, lens


def load_reads(fwd_path: str, rve_path: str, split_len: int,
               order: np.ndarray = None) -> Reads:
    """Read both FASTQ files and keep the usable pairs, in file order or,
    with `order`, in that order of the file's pairs."""
    fwd = fastq_seqs(fwd_path)
    rve = fastq_seqs(rve_path)
    n = min(len(fwd), len(rve))
    if order is not None:
        fwd = [fwd[i] for i in order]
        rve = [rve[i] for i in order]
    has_n = np.array([b"N" in fwd[i] or b"N" in rve[i] for i in range(n)],
                     dtype=bool)
    short = np.array([len(fwd[i]) < split_len or len(rve[i]) < split_len
                      for i in range(n)], dtype=bool) & ~has_n
    keep = np.flatnonzero(~has_n & ~short)
    fc, fl = _codes([fwd[i] for i in keep])
    rc, rl = _codes([rve[i] for i in keep])
    return Reads(fc, fl, rc, rl, int(has_n.sum()), int(short.sum()))


def _window_words(codes: torch.Tensor, split_len: int) -> List[torch.Tensor]:
    """[R, W] int64 words of each (split_len)-window of each row (W =
    T - split_len + 1): word j holds bases [31 j, 31 j + 31) of the
    window, two bits each; -1 where the window runs past the row or
    holds a base other than A, C, G, T."""
    R, T = codes.shape
    W = T - split_len + 1
    c = codes.to(torch.int64)
    bad = (c == 255)
    c = torch.where(bad, 0, c)
    badw = torch.zeros((R, W), dtype=torch.bool, device=codes.device)
    for t in range(split_len):
        badw |= bad[:, t:t + W]
    words = []
    for lo in range(0, split_len, _WORD):
        w = torch.zeros((R, W), dtype=torch.int64, device=codes.device)
        for t in range(lo, min(lo + _WORD, split_len)):
            w = w * 4 + c[:, t:t + W]
        words.append(torch.where(badw, -1, w))
    return words


class KmerIndex:
    """The exact (k+1)-mer table of the nodes, both strands."""

    def __init__(self, seqs: Sequence[str], split_len: int, device,
                 key_bits: int = None):
        self.split_len = split_len
        self.key_bits = key_bits
        self.num_nodes = len(seqs)
        self.seq_lens = torch.tensor([len(s) for s in seqs],
                                     dtype=torch.int64, device=device)
        codes, lens = _codes([s.encode() for s in seqs])
        if codes.shape[1] < split_len:
            codes = np.full((len(seqs), split_len), 255, np.uint8)
        fw = torch.as_tensor(codes, device=device)
        # reverse complement of each row, aligned so that window i of the
        # row reads the reverse complement of forward window i
        rc = np.full_like(codes, 255)
        for i, n in enumerate(lens.tolist()):
            row = codes[i, :n]
            rc[i, :n] = np.where(row == 255, 255, 3 - row)[::-1]
        rv = torch.as_tensor(rc, device=device)
        W = codes.shape[1] - split_len + 1
        off = torch.arange(W, device=device).expand(len(seqs), W)
        node = torch.arange(len(seqs), device=device)[:, None].expand(
            len(seqs), W)
        # reverse window j of a row of length n is forward window n - k - 1 - j
        n_t = torch.as_tensor(lens, device=device)[:, None]
        rv_off = n_t - split_len - off
        keys, nodes, offs = [], [], []
        for words, offset in ((_window_words(fw, split_len), off),
                              (_window_words(rv, split_len), rv_off)):
            ok = words[0] >= 0
            keys.append(torch.stack([w[ok] for w in words], 1))
            nodes.append(node[ok])
            offs.append(offset[ok])
        keys = torch.cat(keys)
        nodes = torch.cat(nodes)
        offs = torch.cat(offs)
        # each word ranked among the table's values of that word
        self.word_values = [torch.unique(keys[:, j])
                            for j in range(keys.shape[1])]
        key, _ = self._key(keys)
        order = torch.argsort(key, stable=True)
        key, self.node, self.offset = key[order], nodes[order], offs[order]
        self.keys, first = torch.unique_consecutive(key, return_counts=True)
        self.key_start = torch.cumsum(first, 0) - first
        self.key_count = first
        self.num_entries = int(key.numel())

    def _ranks(self, words: torch.Tensor) -> torch.Tensor:
        """[n, J] ranks of each word among the table's values; -1 for a
        value the table lacks."""
        out = []
        for j, vals in enumerate(self.word_values):
            w = words[:, j].contiguous()
            pos = torch.searchsorted(vals, w).clamp(max=vals.numel() - 1)
            out.append(torch.where(vals[pos] == w, pos, -1))
        return torch.stack(out, 1)

    def _combine(self, ranks: torch.Tensor) -> torch.Tensor:
        span = 1
        for vals in self.word_values:
            span *= vals.numel() + 1
        if span >= 2**62:
            raise ValueError("k-mer too long for a combined int64 key")
        key = torch.zeros(ranks.shape[0], dtype=torch.int64,
                          device=ranks.device)
        for j, vals in enumerate(self.word_values):
            key = key * (vals.numel() + 1) + ranks[:, j]
        return key

    def _key(self, flat: torch.Tensor):
        """(key, miss) of [n, J] words: the exact key of ranks, or with
        `key_bits` (the control) that many bits of a hash of the words,
        so that distinct k-mers may share a key."""
        if self.key_bits:
            h = torch.zeros(flat.shape[0], dtype=torch.int64,
                            device=flat.device)
            for j in range(flat.shape[1]):
                h = (h ^ flat[:, j]) * _MIX
                h = h ^ ((h >> 29) & ((1 << 35) - 1))
            key = (h >> (64 - self.key_bits)) & ((1 << self.key_bits) - 1)
            return key, flat[:, 0] < 0
        ranks = self._ranks(flat)
        miss = (ranks < 0).any(1) | (flat[:, 0] < 0)
        return self._combine(ranks.clamp(min=0)), miss

    def lookup(self, words: List[torch.Tensor]):
        """(key index or -1) for each window given as words."""
        flat = torch.stack([w.reshape(-1) for w in words], 1)
        key, miss = self._key(flat)
        pos = torch.searchsorted(self.keys, key).clamp(
            max=self.keys.numel() - 1)
        hit = ~miss & (self.keys[pos] == key)
        return torch.where(hit, pos, -1).reshape(words[0].shape)


def saturated(index: KmerIndex, codes: torch.Tensor, lens: torch.Tensor,
              hit: torch.Tensor):
    """(read, node) pairs, sorted, of the nodes each read saturates, and
    the number of (read, node) pairs with a match; marks in `hit` the
    table keys that some window matches."""
    k1 = index.split_len
    N = index.num_nodes
    dev = codes.device
    if codes.shape[1] < k1:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty, 0
    kid = index.lookup(_window_words(codes, k1))           # [R, W]
    rr, ww = torch.nonzero(kid >= 0, as_tuple=True)
    kk = kid[rr, ww]
    cnt = index.key_count[kk]
    # expand every matching window to each entry of its key
    rep = torch.repeat_interleave(torch.arange(kk.numel(), device=dev), cnt)
    within = (torch.arange(rep.numel(), device=dev)
              - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt))
    entry = index.key_start[kk][rep] + within
    read = rr[rep]
    node = index.node[entry]
    rn = read * N + node
    uniq, inv = torch.unique(rn, return_inverse=True)
    count = torch.zeros(uniq.numel(), dtype=torch.int64, device=dev)
    count.index_add_(0, inv, torch.ones_like(inv))
    big = torch.iinfo(torch.int64).max
    coord = torch.full((uniq.numel(),), big, dtype=torch.int64, device=dev)
    coord.scatter_reduce_(0, inv, index.offset[entry], "amin")
    kidx = torch.full((uniq.numel(),), big, dtype=torch.int64, device=dev)
    kidx.scatter_reduce_(0, inv, ww[rep], "amin")
    hit[kk] = True
    u_read = uniq // N
    u_node = uniq % N
    rlen = lens[u_read]
    slen = index.seq_lens[u_node]
    L = torch.maximum(coord, coord - kidx)
    Rt = torch.minimum(coord + slen - 1, coord - kidx + rlen - 1)
    sat = (Rt - L - (k1 - 1) + 1).to(torch.float64)
    expected = ((torch.minimum(rlen, slen) - k1 + 1).to(torch.float64)
                * (rlen - k1).to(torch.float64) / rlen.to(torch.float64))
    thr = torch.clamp(torch.minimum(sat, expected), min=1.0)
    ok = count.to(torch.float64) >= thr
    return u_read[ok], u_node[ok], int(uniq.numel())


def _cross(a_row, a_val, b_row, b_val, num_rows: int, upper: bool):
    """(a_val, b_val) for every a entry and b entry of the same row,
    a_val <= b_val when `upper`. Both lists are sorted by row."""
    dev = a_row.device
    b_n = torch.bincount(b_row, minlength=num_rows)
    b_start = torch.cumsum(b_n, 0) - b_n
    rep = b_n[a_row]
    ai = torch.repeat_interleave(torch.arange(a_row.numel(), device=dev),
                                 rep)
    within = (torch.arange(ai.numel(), device=dev)
              - torch.repeat_interleave(torch.cumsum(rep, 0) - rep, rep))
    u = a_val[ai]
    v = b_val[b_start[a_row[ai]] + within]
    if upper:
        keep = u <= v
        u, v = u[keep], v[keep]
    return u, v


@dataclass
class Links:
    node_mat: torch.Tensor   # int64 [N, N]
    short_mat: torch.Tensor  # int64 [N, N]
    n_reads: int
    short_reads: int
    used_reads: int
    work: Dict[str, int]


def pe_links(seqs: Sequence[str], reads: Reads, kmer_size: int, device,
             block: int = 16384, key_bits: int = None) -> Links:
    """The link matrices of `reads` over the nodes `seqs`, int64, on
    `device`, in blocks of `block` pairs. `work` counts what the
    inputs need: windows, read bases, the table entries that some window
    matches and the (read, node) pairs with a match."""
    dev = torch.device(device)
    k1 = kmer_size + 1
    index = KmerIndex(seqs, k1, dev, key_bits)
    N = index.num_nodes
    node_flat = torch.zeros(N * N, dtype=torch.int64, device=dev)
    short_flat = torch.zeros(N * N, dtype=torch.int64, device=dev)
    hit = torch.zeros(index.keys.numel(), dtype=torch.bool, device=dev)
    read_node_hits = 0
    P = reads.num_pairs
    for s in range(0, P, block):
        e = min(s + block, P)
        sides = []
        for codes, lens in ((reads.fwd, reads.fwd_len),
                            (reads.rve, reads.rve_len)):
            c = torch.as_tensor(codes[s:e], device=dev)
            ln = torch.as_tensor(lens[s:e], device=dev)
            row, val, n = saturated(index, c, ln, hit)
            sides.append((row, val))
            read_node_hits += n
        (fr, fn), (rr, rn) = sides
        u, v = _cross(fr, fn, rr, rn, e - s, upper=False)
        node_flat += torch.bincount(u * N + v, minlength=N * N)
        for row, val in sides:
            u, v = _cross(row, val, row, val, e - s, upper=True)
            short_flat += torch.bincount(u * N + v, minlength=N * N)
    lens = np.concatenate([reads.fwd_len, reads.rve_len])
    work = {"read_node_hits": read_node_hits,
            "entries": int(index.key_count[hit].sum()),
            "table_entries": index.num_entries, "reads": int(lens.size),
            "read_bases": int(lens.sum()),
            "windows": int(np.clip(lens - k1 + 1, 0, None).sum()),
            "pairs": P, "nodes": N}
    return Links(node_flat.reshape(N, N), short_flat.reshape(N, N),
                 reads.n_reads, reads.short_reads, P, work)

"""A numpy model of K3's schedule (``datacomp_tpu_torch/csrc/decode.cu``),
held to the plain decoder ``decode_reference`` on the CPU.

The kernel cannot run here, so its algorithm is modelled step for step,
vectorised over every lane of every sub-block: the span and lane ranges with
the gcd rounding, pass A, the synchronisation rounds with the bitmap's early
stop (staged route) or without it (direct route), the exclusive scan of the
counts and the writing pass, each symbol decoded through the direct table
and, for codes longer than it, the plain version's compares.  Streams are
made from numpy seeds at 64 KB to 1 MB.  The model must return exactly what
``decode_reference`` returns, and no sub-block may take more than 31 rounds.
A second test holds the direct table to the canonical decode of every code.

The kernel itself is held to ``decode_reference`` on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from datacomp_tpu_torch import ops  # noqa: E402
from datacomp_tpu_torch.core.huffman import (  # noqa: E402
    build_codebook, canonical_codes_from_lengths,
)
from datacomp_tpu_torch.utils.testdata import generate_bytes  # noqa: E402

CODE_BITS = 16
MAX_DIRECT_BITS = 12
WARP_WORDS = 1024  # a warp's stream buffer and bitmap (words)
LANES = 32


def lengths_in_use(limits: np.ndarray) -> list:
    """The code lengths in use as the kernel reads them from ``limits``:
    length l where limits[l-1] != limits[l-2] (limits[-1] taken as 0)."""
    prev, used = 0, []
    for ln in range(1, CODE_BITS + 1):
        if int(limits[ln - 1]) != prev:
            used.append(ln)
        prev = int(limits[ln - 1])
    return used


def direct_table(limits, adj, sym, tbits: int) -> np.ndarray:
    """The kernel's 2^T entries: length << 8 | symbol, 0 for a longer code."""
    w = np.arange(1 << tbits, dtype=np.int64) << (CODE_BITS - tbits)
    lim = limits.astype(np.int64)
    ln = 1 + (w[:, None] >= lim[None, :]).sum(1)
    idx = np.clip((w >> (CODE_BITS - ln)) + adj.astype(np.int64)[np.minimum(ln, 16) - 1], 0, 255)
    entry = (ln << 8) | (sym.astype(np.int64)[idx] & 0xFF)
    return np.where(w < lim[tbits - 1], entry, 0).astype(np.uint16)


def compare_decode(win, limits, adj, sym):
    """The plain version's step on 16-bit windows: (length, symbol)."""
    ln = np.minimum(1 + (win[:, None] >= limits.astype(np.int64)[None, :]).sum(1), CODE_BITS)
    idx = np.clip((win >> (CODE_BITS - ln)) + adj.astype(np.int64)[ln - 1], 0, 255)
    return ln, sym.astype(np.int64)[idx]


class Model:
    """K3's schedule over every lane of every sub-block at once."""

    def __init__(self, words, gaps, limits, adj, sym, subblock: int, n_out: int):
        self.words = np.concatenate([words.astype(np.uint64), np.zeros(3, np.uint64)])
        self.nwords = words.size
        self.limits, self.adj, self.sym = limits, adj, sym
        used = lengths_in_use(limits)
        self.maxlen = max(used, default=1)
        self.g = math.gcd(*used) if used else 1
        self.tbits = min(self.maxlen, MAX_DIRECT_BITS)
        self.table = direct_table(limits, adj, sym, self.tbits)
        unit = 32 * self.g // math.gcd(32, self.g)

        nsub = gaps.size
        i = np.arange(nsub, dtype=np.int64)
        first = i * subblock
        self.live = first < n_out
        count = np.minimum(subblock, n_out - first)
        stream_bits = 32 * self.nwords
        lo = np.minimum(gaps.astype(np.int64), stream_bits)
        hi = np.where(i + 1 < nsub, np.append(gaps[1:], 0).astype(np.int64), stream_bits)
        hi = np.minimum(np.maximum(hi, lo), stream_bits)
        hi = np.minimum(hi, lo + self.maxlen * count)
        per_lane = (hi - lo + 31) // 32
        seg = np.where(per_lane > 0, (per_lane + unit - 1) // unit, 1) * unit
        nbuf = (hi >> 5) + 3 - (lo >> 5)
        self.staged = (nbuf <= WARP_WORDS) & (count <= 4 * WARP_WORDS)

        self.sub = np.repeat(i, LANES)
        self.lane = np.tile(np.arange(LANES, dtype=np.int64), nsub)
        self.lo = lo[self.sub]
        self.b = self.lo + self.lane * seg[self.sub]
        self.e = np.minimum(self.b + seg[self.sub], hi[self.sub])
        self.seg, self.count, self.first = seg, count, first
        self.width = int((hi - lo).max(initial=0)) + 1
        self.bitmap = np.zeros((nsub, self.width + 1), bool)  # codeword starts, relative to lo
        self.n_out = n_out

    def step(self, p):
        """Decode the codeword at each position: (length, symbol)."""
        wi = p >> 5
        w = (self.words[wi] << np.uint64(32)) | self.words[wi + 1]
        shift = np.uint64(48) - (p & 31).astype(np.uint64)
        win = ((w >> shift) & np.uint64(0xFFFF)).astype(np.int64)
        e = self.table[win >> (CODE_BITS - self.tbits)].astype(np.int64)
        ln, s = compare_decode(win, self.limits, self.adj, self.sym)
        return np.where(e > 0, e >> 8, ln), np.where(e > 0, e & 0xFF, s)

    def count_pass(self, s, active, check: bool, q_prev, c_prev):
        """Pass A (``check`` False) or a round's pass for the lanes in
        ``active``; returns (q, c) for every lane and updates the bitmap."""
        p, c = s.copy(), np.where(active, 0, c_prev)
        merged_at = np.full(p.size, -1, np.int64)
        new_rows, new_cols = [], []
        run = active & (p < self.e)
        while run.any():
            idx = np.flatnonzero(run)
            rel = p[idx] - self.lo[idx]
            if check:
                hit = self.staged[self.sub[idx]] & self.bitmap[self.sub[idx], rel]
                merged_at[idx[hit]] = p[idx[hit]]
                run[idx[hit]] = False
                idx, rel = idx[~hit], rel[~hit]
            new_rows.append(self.sub[idx])
            new_cols.append(rel)
            ln, _ = self.step(p[idx])
            p[idx] += ln
            c[idx] += 1
            run[idx] = p[idx] < self.e[idx]
        q = np.where(active, p, q_prev)
        # a merged lane: its exit stays, and its count adds the previous
        # parse's starts from the merge to the end of its range
        m = np.flatnonzero(merged_at >= 0)
        rows, cols, which = self._ranges(m, merged_at[m], self.e[m])
        c[m] += np.bincount(which, self.bitmap[rows, cols], m.size).astype(np.int64)
        q[m] = q_prev[m]
        # the lane's range now holds this parse's starts before the merge (or
        # all of them) and the previous parse's from the merge on
        a = np.flatnonzero(active)
        cut = np.where(merged_at[a] >= 0, merged_at[a], self.e[a])
        rows, cols, _ = self._ranges(a, self.b[a], cut)
        self.bitmap[rows, cols] = False
        if new_rows:
            self.bitmap[np.concatenate(new_rows), np.concatenate(new_cols)] = True
        return q, c

    def _ranges(self, lanes, start, stop):
        """(row, column, lane's place in ``lanes``) of every bitmap position
        in [start, stop) of each lane."""
        n = np.maximum(stop - start, 0)
        which = np.repeat(np.arange(lanes.size), n)
        step = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
        cols = np.repeat(start - self.lo[lanes], n) + step
        return self.sub[lanes][which], cols, which

    def run(self):
        """(decoded bytes, rounds per live sub-block)."""
        live = self.live[self.sub]
        s = self.b.copy()
        q, c = self.count_pass(s, live, False, s, np.zeros_like(s))
        rounds = np.zeros(self.seg.size, np.int64)
        lane0 = self.lane == 0
        live &= self.e > self.b  # a lane past the span decodes nothing
        for _ in range(LANES):
            s_new = np.where(lane0, s, np.roll(q, 1))
            changed = live & (s_new != s)
            any_sub = changed.reshape(-1, LANES).any(1)
            if not any_sub.any():
                break
            rounds += any_sub
            s = np.where(changed, s_new, s)
            q, c = self.count_pass(s, changed, True, q, c)
        assert not (live & (np.where(lane0, s, np.roll(q, 1)) != s)).any()

        cc = c.reshape(-1, LANES)
        off = (np.cumsum(cc, 1) - cc).reshape(-1)
        total = cc.sum(1)
        out = np.zeros(self.n_out, np.uint8)  # what a short stream leaves: zeros
        count = self.count[self.sub]
        n = np.where(live, np.minimum(c, count - off), 0)
        p, j = s.copy(), np.zeros_like(s)
        run = j < n
        while run.any():
            idx = np.flatnonzero(run)
            ln, sy = self.step(p[idx])
            out[self.first[self.sub[idx]] + off[idx] + j[idx]] = sy
            p[idx] += ln
            j[idx] += 1
            run[idx] = j[idx] < n[idx]
        self.total = total
        return out, rounds[self.live]


def _chain_codebook(depth: int, n: int):
    """Lengths 1..depth-1 and two depth-bit codes (a complete code)."""
    lengths = np.zeros(256, np.int32)
    lengths[: depth - 1] = np.arange(1, depth)
    lengths[depth - 1 : depth + 1] = depth
    data = np.random.default_rng(depth).integers(0, depth + 1, n).astype(np.uint8)
    return data, lengths, canonical_codes_from_lengths(lengths)


def _case(kind: str, n: int):
    if kind.startswith("depth"):
        return _chain_codebook(int(kind[5:]), n)
    if kind == "fixed6":  # 64 symbols at 6 bits
        lengths = np.zeros(256, np.int32)
        lengths[:64] = 6
        data = np.random.default_rng(6).integers(0, 64, n).astype(np.uint8)
        return data, lengths, canonical_codes_from_lengths(lengths)
    data = np.frombuffer(generate_bytes(kind, n), np.uint8)
    lengths, codes = build_codebook(np.bincount(data, minlength=256), mode="fast", max_len=-1)
    return data, lengths, codes


def _stream(data, lengths, codes, subblock: int):
    """(words, gaps) as the codec hands them to the decoder."""
    n_pad = -(-data.size // 32) * 32
    padded = np.zeros(n_pad, np.uint8)
    padded[: data.size] = data
    words, tb, gaps = ops.encode(torch.from_numpy(padded), data.size,
                                 *ops.codebook_to_torch(lengths, codes, "cpu"),
                                 2 * n_pad + 2, subblock)
    payload = ops.words_to_bytes(words.numpy(), int(tb))
    nsub = -(-data.size // subblock)
    return ops.payload_to_words(payload), gaps.numpy()[:nsub].copy()


CASES = [
    ("text", 1 << 20, 4032), ("skewed", 1 << 18, 4032), ("compressible", 1 << 20, 4032),
    *((f"depth{d}", 1 << 16, 4032) for d in range(1, 17)),
    ("fixed6", 16 * 4032 + 1616, 4032),  # lanes past the last sub-block's span
    ("text", 1 << 16, 32), ("skewed", (1 << 16) + 1, 64), ("skewed", 1 << 18, 16384),
]


@pytest.mark.parametrize("kind,n,subblock", CASES)
def test_schedule_reproduces_plain_decode(kind, n, subblock):
    data, lengths, codes = _case(kind, n)
    words, gaps = _stream(data, lengths, codes, subblock)
    limits, adj, sym = ops.build_decode_tables(lengths)
    model = Model(words, gaps, limits, adj, sym, subblock, data.size)
    got, rounds = model.run()
    plain = ops.decode(*(torch.from_numpy(a) for a in (words, gaps, limits, adj, sym)),
                       subblock, data.size).numpy()
    assert np.array_equal(got, plain)
    assert np.array_equal(got, data)
    assert rounds.max(initial=0) <= LANES - 1
    if subblock == 16384:  # beyond the per-warp buffers: the direct route
        assert not model.staged.any()
    elif subblock == 4032 and kind in ("text", "skewed", "compressible"):
        assert model.staged.all()
    if kind == "fixed6":  # every lane starts on a codeword: no round
        assert not rounds.any()
    # every lane's start is a multiple of g past its sub-block's start
    assert not ((model.b - model.lo) % model.g).any()


def test_schedule_on_a_corrupt_stream_stays_in_the_stream():
    """Random words with non-monotone gaps: every sub-block still ends, in at
    most 31 rounds, and the output has n_out bytes."""
    rng = np.random.default_rng(11)
    _, lengths, _ = _case("skewed", 1 << 16)
    words = rng.integers(0, 1 << 32, 3000, dtype=np.uint64).astype(np.uint32)
    gaps = rng.integers(0, 32 * 3000 + 500, 40).astype(np.uint32)
    model = Model(words, gaps, *ops.build_decode_tables(lengths), 256, 40 * 256 - 5)
    out, rounds = model.run()
    assert out.size == 40 * 256 - 5 and rounds.max() <= LANES - 1


@pytest.mark.parametrize("kind", ["text", "skewed", "compressible", "depth16", "depth12",
                                  "depth1", "fixed6"])
def test_direct_table_matches_canonical_decode(kind):
    """Every code of at most T bits fills exactly its 2^(T-l) entries with
    (l, symbol); every other entry marks a longer code; and on all 2^16
    windows the table-or-compare step equals the plain version's."""
    _, lengths, codes = _case(kind, 1 << 16)
    limits, adj, sym = ops.build_decode_tables(lengths)
    used = lengths_in_use(limits)
    assert used == sorted(set(lengths[lengths > 0].tolist()))
    tbits = min(max(used), MAX_DIRECT_BITS)
    table = direct_table(limits, adj, sym, tbits)
    want = np.zeros(1 << tbits, np.int64)
    for s in np.flatnonzero(lengths):
        ln = int(lengths[s])
        if ln <= tbits:
            lo = int(codes[s]) << (tbits - ln)
            assert not want[lo : lo + (1 << (tbits - ln))].any()
            want[lo : lo + (1 << (tbits - ln))] = (ln << 8) | int(s)
    assert np.array_equal(table.astype(np.int64), want)

    win = np.arange(1 << CODE_BITS, dtype=np.int64)
    e = table[win >> (CODE_BITS - tbits)].astype(np.int64)
    ln, s = compare_decode(win, limits, adj, sym)
    assert np.array_equal(np.where(e > 0, e >> 8, ln), ln)
    assert np.array_equal(np.where(e > 0, e & 0xFF, s), s)

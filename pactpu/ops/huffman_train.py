"""Huffman table training: device histograms -> host tree build -> dense
tables.

The reference trains its 10 static genre tables offline
(reference codec/Huffman.py:156-250): `HuffmanTrainer.countFreq` accumulates
symbol frequencies into a `Histogram` (Huffman.py:71-81), then
`constructHuffmanTable` folds symbols with frequency < LOW_FREQ(=10) into the
escape symbol (Huffman.py:92-109, counting *one escape occurrence per folded
symbol*, not its frequency), builds the tree by repeatedly merging the two
lowest-frequency nodes from a stable-sorted deque (Huffman.py:218-231), and
assigns '0' to the first-popped (lower-frequency) child (Huffman.py:234-250).

Device/host split:

- **Statistics are a device computation**: `symbol_histogram` bincounts the
  unsigned mantissa symbols of a whole block batch in one scatter-add, and
  under `shard_map` the per-shard histograms all-reduce with one `psum`
  (pactpu.parallel.shard.sharded_encode_fn) — the distributed analogue of
  `countFreq` over a corpus spread across chips.
- **Tree construction is host code**: it is O(symbols log symbols) on a
  few-thousand-entry array, far below the dispatch cost of any device
  formulation, and runs once per table, offline.

The built tables use the same dense layout as the ported reference pickles
(pactpu/data/huffman_tables.npz): lengths[T, S] uint8 (0 = absent),
codes[T, S] uint32 (MSB-first in the low bits), escape_lengths[T],
escape_codes[T] — directly consumable by `pactpu.ops.huffman.encode_select`
(pass as `tables=`), the native decoder (pactpu/native.py init_tables) and
the oracle (pactpu.compat.refcodec.HuffmanTables).

Tie-breaking note: where the reference's sort order among equal-frequency
symbols depends on Python 2 dict iteration order (Huffman.py:193-194), this
trainer uses ascending symbol value — deterministic, and any tie order
yields an optimal (equal total length) code.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

LOW_FREQ = 10          # reference codec/Huffman.py:38
ESCAPE = -1            # reference codec/Huffman.py:39
NUM_SYMBOLS = 1 << 15  # unsigned BFP mantissas have <= 15 magnitude bits


def symbol_histogram(syms: jax.Array, transmit: Optional[jax.Array] = None,
                     n_symbols: int = NUM_SYMBOLS) -> jax.Array:
    """Frequency count of unsigned mantissa symbols, one scatter-add.

    syms: int array (any shape) of symbols; entries < 0 (untransmitted
    lines) are ignored, as is everything where `transmit` is False.
    Returns i32[n_symbols].  Device-side analogue of reference
    Histogram.generateStatistics (codec/Huffman.py:71-81).
    """
    s = syms.reshape(-1)
    ok = s >= 0
    if transmit is not None:
        ok = ok & transmit.reshape(-1)
    hist = jnp.zeros((n_symbols,), jnp.int32)
    return hist.at[jnp.where(ok, s, 0)].add(jnp.where(ok, 1, 0))


def build_table(freqs: np.ndarray, low_freq: int = LOW_FREQ):
    """Build one Huffman table from a symbol-frequency histogram.

    Replicates the reference construction (codec/Huffman.py:92-109,
    218-250): symbols with 0 < freq < low_freq fold into the escape symbol
    (one escape count per folded symbol); zero-frequency symbols are absent
    entirely; nodes merge two-at-a-time from a stable frequency-sorted
    queue; the first-popped child takes bit '0'.

    Returns (lengths u8[S], codes u32[S], esc_len int, esc_code int).
    """
    freqs = np.asarray(freqs)
    s = freqs.shape[0]
    present = np.nonzero(freqs > 0)[0]
    escape_freq = int(np.count_nonzero(freqs[present] < low_freq))
    kept = [(int(sym), int(freqs[sym])) for sym in present
            if freqs[sym] >= low_freq]

    # stable sort by frequency (reference makeHuffmanNodeQueue sorts the
    # symbol list, appends the escape node last, then stable-sorts again)
    entries = sorted(kept, key=lambda t: t[1])
    entries.append((ESCAPE, escape_freq))
    # node = (freq, leaf_symbol_or_None, left, right)
    queue = sorted([(f, sym, None, None) for sym, f in entries],
                   key=lambda t: t[0])

    while len(queue) > 1:
        first, second = queue[0], queue[1]
        joined = (first[0] + second[0], None, first, second)
        rest = queue[2:]
        rest.append(joined)
        queue = sorted(rest, key=lambda t: t[0])  # stable: joined last
    root = queue[0]

    lengths = np.zeros(s, np.uint8)
    codes = np.zeros(s, np.uint32)
    esc_len = 0
    esc_code = 0

    # degenerate single-leaf tree (no symbol reached low_freq: the table is
    # escape-only).  The reference would assign the root a 0-bit code, which
    # is unencodable (the decoder's bit-walk would never consume a bit and
    # encode_select's cost model would undercut every real table), so give
    # the lone escape leaf the 1-bit code '0' instead — prefix-free and
    # decodable, at +1 bit per line vs the reference's impossible 0
    if root[2] is None:
        return lengths, codes, 1, 0

    stack = [(root, 0, 0)]  # node, code, depth
    while stack:
        (freq, sym, left, right), code, depth = stack.pop()
        if left is None:
            if sym == ESCAPE:
                esc_len, esc_code = depth, code
            else:
                lengths[sym] = depth
                codes[sym] = code
            continue
        stack.append((left, code << 1, depth + 1))       # first popped -> 0
        stack.append((right, (code << 1) | 1, depth + 1))
    # encode_select packs code lengths into 5-bit fields; a depth > 31 would
    # silently corrupt bitstreams, so refuse to build such a table (a corpus
    # skewed enough to produce one needs its low_freq cutoff raised)
    max_len = max(int(lengths.max(initial=0)), esc_len)
    if max_len > 31:
        raise ValueError(
            f"Huffman table has a {max_len}-bit code; the codec supports "
            "code lengths up to 31 bits — raise low_freq to flatten the "
            "tail of the symbol distribution")
    return lengths, codes, esc_len, esc_code


class HuffmanTrainer:
    """Streaming trainer with the reference's two-call API
    (reference codec/Huffman.py:156-207): `count(symbols)` accumulates
    statistics (device scatter-add; accepts pre-reduced histograms too,
    e.g. the psum'd output of pactpu.parallel.shard.sharded_encode_fn),
    `build()` constructs the dense table."""

    def __init__(self, table_id: int, n_symbols: int = NUM_SYMBOLS):
        self.table_id = table_id
        self.freqs = np.zeros(n_symbols, np.int64)

    def count(self, symbols) -> None:
        """Accumulate raw symbols (device scatter-add histogram)."""
        self.freqs += np.asarray(
            symbol_histogram(jnp.asarray(symbols),
                             n_symbols=self.freqs.shape[0]), np.int64)

    def count_histogram(self, hist) -> None:
        """Accumulate a pre-reduced histogram (e.g. the psum'd output of
        pactpu.parallel.shard.sharded_encode_fn across a mesh)."""
        self.freqs += np.asarray(hist, np.int64)

    def build(self):
        return build_table(self.freqs)


def train_tables(histograms: Dict[int, np.ndarray],
                 n_symbols: int = NUM_SYMBOLS):
    """Build a full table set from per-table histograms.

    histograms: {table_id (1-based): freqs}.  Missing ids get escape-only
    tables (1-bit escape code, see build_table's single-leaf case) so the
    set stays dense and decodable — an escape-only row with a 0-bit escape
    would undercut every real table in encode_select's argmin and emit an
    undecodable stream.  Returns dense arrays in the huffman_tables.npz
    layout: (lengths[T, S] u8, codes[T, S] u32, escape_lengths[T] u8,
    escape_codes[T] u32) with T = max table id.
    """
    t = max(histograms)
    lengths = np.zeros((t, n_symbols), np.uint8)
    codes = np.zeros((t, n_symbols), np.uint32)
    esc_len = np.ones(t, np.uint8)       # escape-only default (code '0')
    esc_code = np.zeros(t, np.uint32)
    for tid, freqs in histograms.items():
        le, co, el, ec = build_table(np.asarray(freqs))
        lengths[tid - 1, :le.shape[0]] = le
        codes[tid - 1, :co.shape[0]] = co
        esc_len[tid - 1] = el
        esc_code[tid - 1] = ec
    return lengths, codes, esc_len, esc_code


def save_tables(path: str, lengths: np.ndarray, codes: np.ndarray,
                escape_lengths: np.ndarray, escape_codes: np.ndarray) -> None:
    """Write a table set in the pactpu/data/huffman_tables.npz format (the
    analogue of the reference's huffmanTables.pickle rewrite,
    codec/Huffman.py:197-203)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, lengths=lengths, codes=codes,
                        escape_lengths=escape_lengths,
                        escape_codes=escape_codes)

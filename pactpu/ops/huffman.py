"""Static-table Huffman coding as device gathers.

The reference encoder walks dicts: for each channel-block it encodes the
unsigned mantissas with *all ten* genre tables and keeps the cheapest
(reference codec/Huffman.py:274-309), with an escape code (symbol -1)
followed by the raw bitAlloc-bit mantissa for symbols absent from a table
(Huffman.py:294-298).

Design: the ten tables live as dense `[10, 32768]` (length, code)
arrays (ported from codec/huffmanTables.pickle by
tools/port_huffman_tables.py).  Per-line code lengths for all ten tables are
one gather; the best-table choice is an argmin over the ten per-table length
sums; codewords are a second gather.  Everything is batched over
(block, channel) rows — table selection for a whole file is a handful of
fused ops.

Bit-serial decoding does not vectorize (codeword boundaries are
data-dependent, Huffman.py:321-344); decode runs on the host in native code
(csrc/wakbits.cc), parallel across channel-blocks.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=1)
def load_tables():
    """Dense numpy tables: (lengths[10, S], codes[10, S], esc_len[10],
    esc_code[10])."""
    import importlib.resources as res
    path = str(res.files("pactpu").joinpath("data/huffman_tables.npz"))
    z = np.load(path)
    return (z["lengths"].astype(np.int32), z["codes"].astype(np.int32),
            z["escape_lengths"].astype(np.int32),
            z["escape_codes"].astype(np.int32))


def encode_select(symbols: jax.Array, line_bits: jax.Array,
                  transmit: jax.Array, tables=None):
    """Best-table Huffman encode of a batch of channel-blocks.

    symbols:   i32[R, L] unsigned mantissa codes (sign stripped)
    line_bits: i32[R, L] the band bit allocation of each line (escape cost)
    transmit:  bool[R, L] lines actually transmitted (bitAlloc > 0)
    tables:    optional (lengths[T, S], codes[T, S], esc_len[T], esc_code[T])
               arrays — pass device-resident arrays so the 2.6 MB of tables
               are program parameters, not embedded constants; also how
               freshly trained tables (pactpu.ops.huffman_train) plug in.

    Returns (table_id i32[R] in 1..T, codes i32[R, L], lengths i32[R, L],
    total_bits i32[R]).  Lengths are zero for untransmitted lines; ties in
    total length go to the lowest table id (reference Huffman.py:284-308).
    """
    if tables is None:
        tables = load_tables()
    lengths_np, codes_np, esc_len_np, esc_code_np = tables
    # code lengths pack into 5-bit fields below; a >31-bit code (possible
    # only with freshly trained tables — huffman_train refuses to build
    # them, but tables= accepts arbitrary arrays) must fail loudly here
    # rather than encode garbage
    if isinstance(lengths_np, np.ndarray):
        assert int(lengths_np.max(initial=0)) <= 31, \
            "Huffman code lengths > 31 bits cannot be packed"
    tab_lens = jnp.asarray(lengths_np)        # [10, S]
    tab_codes = jnp.asarray(codes_np)
    esc_len = jnp.asarray(esc_len_np)         # [10]
    esc_code = jnp.asarray(esc_code_np)

    sym = symbols.astype(jnp.int32)
    n_tab = tab_lens.shape[0]
    n_lo = min(6, n_tab)                      # 6 x 5-bit lengths per word

    # pack every table's 5-bit code length into two i32 words per symbol:
    # the per-line length lookup for ALL tables is then two [R, L] gathers
    # instead of a [T, R, L] one — the gathers are the cost here, the
    # unpacking shifts are cheap elementwise work
    shifts_lo = 5 * jnp.arange(n_lo, dtype=jnp.int32)
    packed_lo = jnp.sum(
        jnp.left_shift(tab_lens[:n_lo], shifts_lo[:, None]), axis=0)
    shifts_hi = 5 * jnp.arange(n_tab - n_lo, dtype=jnp.int32)
    packed_hi = jnp.sum(
        jnp.left_shift(tab_lens[n_lo:], shifts_hi[:, None]), axis=0)

    # ONE gather per line: the per-symbol record carries both
    # packed-length words AND every table's codeword in one [S, 2+T] row
    combined = jnp.concatenate(
        [packed_lo[:, None], packed_hi[:, None], tab_codes.T], axis=1)
    rec = combined[sym]                       # [R, L, 2+T] single gather
    pl_, ph_ = rec[..., 0], rec[..., 1]

    def table_len(t):
        w = pl_ if t < n_lo else ph_
        return (w >> (5 * (t % n_lo))) & 31

    # one fused unpack+reduce per table — no [T, R, L] intermediate
    totals = jnp.stack([
        jnp.sum(jnp.where(
            transmit,
            jnp.where(table_len(t) > 0, table_len(t),
                      esc_len[t] + line_bits), 0), axis=-1)
        for t in range(n_tab)])               # [T, R]
    best = jnp.argmin(totals, axis=0)         # first min -> lowest id

    # winning table's lengths/codes re-derived from the gathered records
    b_col = best[:, None]
    best_shift = jnp.where(b_col < n_lo, 5 * b_col, 5 * (b_col - n_lo))
    len_best = (jnp.where(b_col < n_lo, pl_, ph_) >> best_shift) & 31
    in_best = len_best > 0
    lens = jnp.where(transmit,
                     jnp.where(in_best, len_best,
                               esc_len[best][:, None] + line_bits), 0)
    r = jnp.arange(sym.shape[0])
    native = sym * 0
    for t in range(n_tab):                    # 10-way select, elementwise
        native = jnp.where(b_col == t, rec[..., 2 + t], native)
    escape = jnp.left_shift(esc_code[best][:, None], line_bits) + sym
    codes = jnp.where(in_best, native, escape)
    codes = jnp.where(transmit, codes, 0)
    return best + 1, codes, lens, totals[best, r]


def split_sign(mantissas: jax.Array, line_bits: jax.Array):
    """Strip the BFP sign bit: mantissa -> (sign, unsigned symbol)
    (reference codec/codec.py:67-81 StripSignBits)."""
    lb = jnp.maximum(line_bits, 1)
    sign = jnp.right_shift(mantissas, lb - 1) & 1
    unsigned = mantissas & (jnp.left_shift(jnp.int32(1), lb - 1) - 1)
    return sign, unsigned

"""On-device bitstream packing.

The reference packs payload bits serially on the host
(reference codec/bitpack.py:36-101 MSB-first `WriteBits`, driven by
codec/pacfile.py:288-351 per channel-block).  Here the whole payload of a
block batch is produced on the device:

1. The payload item stream (overallScale, tableID, per band: bitAlloc-1,
   scaleFactor, sign bits, Huffman codes; trailing LRMS flags) is a *static
   permutation* of the concatenated field arrays — one gather.
2. Bit offsets are an exclusive cumsum of the per-item widths.
3. Each item contributes to at most two 32-bit words (values are < 2^30
   bits wide); two scatter-adds assemble the MSB-first words (disjoint bit
   ranges, so add == or).

The host then just slices `ceil(nbits/8)` big-endian bytes per row and
prepends the uint32 length prefix (pactpu.codec.engine) — byte-exact with
the native serial packer (csrc/wakbits.cc wak_pack_file), which remains
the reference implementation and the decode path.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=8)
def _pack_plan(n_lines: tuple, n_scale_bits: int, n_mant_size_bits: int,
               n_table_id_bits: int):
    """Static stream plan for one channel-block payload.

    Source vector layout (what pack_payload_bits concatenates per row):
      [overall(1), tid(1), ba_field(nb), sf(nb), sign(L), code(L),
       lrms(nb), sign_groups(G)]
    A band's nLines sign bits are contiguous in the stream (reference
    codec/pacfile.py:334-337), so they pack as ceil(nLines/32)
    multi-bit GROUP items instead of nLines 1-bit items — the item axis
    shrinks ~2x (2,125 -> ~1,150 for the 44.1 kHz layout).

    Returns (perm i32[M], const_width i32[M], kind i8[M], groups) where
    kind selects the width source: 0 = constant width, 2 = code (dynamic
    length array), 3 = sign group (const_width bits if the band
    transmits, else 0); groups = (band i32[G], start_line i32[G],
    glen i32[G]) metadata for building the grouped values.
    """
    nb = len(n_lines)
    total = int(np.sum(n_lines))
    lo = np.concatenate([[0], np.cumsum(n_lines)[:-1]]).astype(np.int64)
    o_overall, o_tid = 0, 1
    o_ba, o_sf = 2, 2 + nb
    o_code = 2 + 2 * nb + total
    o_lrms = 2 + 2 * nb + 2 * total
    o_group = o_lrms + nb

    perm, cw, kind = [], [], []
    g_band, g_start, g_len = [], [], []

    def emit(src, width, k=0):
        perm.append(src)
        cw.append(width)
        kind.append(k)

    emit(o_overall, n_scale_bits)
    emit(o_tid, n_table_id_bits)
    for b in range(nb):
        emit(o_ba + b, n_mant_size_bits)
        emit(o_sf + b, n_scale_bits)
        for j in range(0, int(n_lines[b]), 32):
            glen = min(32, int(n_lines[b]) - j)
            emit(o_group + len(g_band), glen, k=3)
            g_band.append(b)
            g_start.append(int(lo[b]) + j)
            g_len.append(glen)
        for j in range(int(n_lines[b])):
            emit(o_code + lo[b] + j, 0, k=2)
    for b in range(nb):
        emit(o_lrms + b, 1)

    groups = (np.asarray(g_band, np.int32), np.asarray(g_start, np.int32),
              np.asarray(g_len, np.int32))
    return (np.asarray(perm, np.int32), np.asarray(cw, np.int32),
            np.asarray(kind, np.int8), groups)


def pack_payload_bits(overall: jax.Array, tid: jax.Array, ba: jax.Array,
                      sf: jax.Array, sign: jax.Array, codes: jax.Array,
                      lens: jax.Array, lrms_row: jax.Array,
                      n_lines: tuple, n_scale_bits: int,
                      n_mant_size_bits: int, n_table_id_bits: int,
                      n_words: int):
    """Pack a batch of channel-block payloads into MSB-first u32 words.

    Shapes (R = channel-blocks): overall/tid i32[R]; ba/sf i32[R, nb];
    sign/codes/lens i32[R, L] (zeroed where untransmitted); lrms_row
    bool/i32[R, nb] (the per-block flags, already replicated per channel).
    Returns (words u32[R, n_words], nbits i32[R]).
    """
    perm, cw, kind, groups = _pack_plan(tuple(int(x) for x in n_lines),
                                        n_scale_bits, n_mant_size_bits,
                                        n_table_id_bits)
    g_band, g_start, g_len = groups
    r = overall.shape[0]
    i32 = lambda a: a.astype(jnp.int32)  # noqa: E731
    ba = i32(ba)
    ba_field = jnp.where(ba > 0, ba - 1, 0)

    seg = np.repeat(np.arange(len(n_lines), dtype=np.int64),
                    np.asarray(n_lines, np.int64))
    band_on = (ba > 0)[:, seg]                      # [R, L]

    # grouped sign values: group g = the band's sign bits [start, start+
    # glen) packed MSB-first into one <=32-bit item (static index map;
    # uint32 weights so a 32-bit group's top bit survives exactly)
    total = int(np.sum(n_lines))
    gl = np.arange(32, dtype=np.int64)[None, :]
    g_lines = np.minimum(g_start[:, None] + gl, total - 1)   # [G, 32]
    g_mask = gl < g_len[:, None]
    g_weights = np.where(
        g_mask, (1 << np.maximum(g_len[:, None] - 1 - gl, 0)), 0
    ).astype(np.uint32)
    sv = sign.astype(jnp.uint32)[:, g_lines]                 # [R, G, 32]
    grouped = jnp.sum(sv * jnp.asarray(g_weights)[None], axis=-1)
    grouped = grouped.astype(jnp.int32)                      # bit pattern

    src_v = jnp.concatenate([
        i32(overall)[:, None], i32(tid)[:, None], ba_field, i32(sf),
        i32(sign), i32(codes), i32(lrms_row), grouped], axis=1)
    # width sources aligned with src_v where dynamic: sign-group widths
    # are glen if the band transmits (ba > 0), else 0
    group_w = jnp.where((ba > 0)[:, g_band], jnp.asarray(g_len)[None], 0)
    src_w = jnp.concatenate([
        jnp.zeros((r, 2 + 2 * ba.shape[1]), jnp.int32),
        band_on.astype(jnp.int32), i32(lens),
        jnp.zeros((r, ba.shape[1]), jnp.int32), group_w], axis=1)

    values = src_v[:, perm]                          # [R, M]
    widths = jnp.where(jnp.asarray(kind)[None, :] == 0,
                       jnp.asarray(cw)[None, :], src_w[:, perm])

    ends = jnp.cumsum(widths, axis=1)
    offs = ends - widths
    nbits = ends[:, -1]

    # each item spans word w0 (and possibly w0+1); all shift amounts are
    # clamped to [0, 31] — XLA shifts >= the bit width are undefined even
    # in unselected `where` branches
    u = values.astype(jnp.uint32)
    w0 = offs >> 5
    sh = offs & 31
    avail = 32 - sh                                  # bits left in word0
    spill = jnp.maximum(widths - avail, 0)           # 0..31 (avail >= 1)
    sh0 = jnp.clip(avail - widths, 0, 31).astype(jnp.uint32)
    part0 = jnp.where(widths <= avail, u << sh0,
                      u >> spill.astype(jnp.uint32))
    mask = (jnp.uint32(1) << spill.astype(jnp.uint32)) - 1
    sh1 = jnp.clip(32 - spill, 0, 31).astype(jnp.uint32)
    part1 = jnp.where(spill > 0, (u & mask) << sh1, 0)

    part0 = jnp.where(widths > 0, part0, 0)
    # ~30 items land in each word; their bit ranges are disjoint, so the
    # integer scatter-add is exact in any order
    words = jnp.zeros((r, n_words), jnp.uint32)
    rows = jnp.broadcast_to(jnp.arange(r)[:, None], w0.shape)
    words = words.at[rows, w0].add(part0, mode="drop")
    words = words.at[rows, w0 + 1].add(part1, mode="drop")
    return words, nbits


def extract_codes(words: jax.Array, off: jax.Array,
                  width: jax.Array) -> jax.Array:
    """Slice fixed-width bit fields out of MSB-first u32 word rows — the
    decode-side inverse of the packer (native.repack_codes lays codes
    out this way).

    words: u32/i32[R, W]; off/width: i32[R, L] bit offset and width
    (0..32, 0 -> 0) per line.  Each line gathers the two words that hold
    the 32 bits starting at `off` and shifts them together.  Returns
    i32[R, L]."""
    r, w = words.shape
    words = jnp.concatenate(
        [jax.lax.bitcast_convert_type(words, jnp.uint32)
         if words.dtype == jnp.int32 else words.astype(jnp.uint32),
         jnp.zeros((r, 1), jnp.uint32)], axis=1)
    off = off.astype(jnp.int32)
    w0 = jnp.clip(off >> 5, 0, w)
    w1 = jnp.clip((off >> 5) + 1, 0, w)
    hi = jnp.take_along_axis(words, w0, axis=1)
    lo = jnp.take_along_axis(words, w1, axis=1)
    sh = (off & 31).astype(jnp.uint32)
    win = (hi << sh) | jnp.where(
        sh > 0, lo >> ((jnp.uint32(32) - sh) & jnp.uint32(31)),
        jnp.uint32(0))
    wd = width.astype(jnp.uint32)
    out = jnp.where(wd > 0, win >> ((jnp.uint32(32) - wd) & jnp.uint32(31)),
                    jnp.uint32(0))
    return out.astype(jnp.int32)


@partial(jax.jit, static_argnames=("cap",))
def compact_rows(words: jax.Array, nbits: jax.Array, cap: int) -> jax.Array:
    """Dense-pack padded payload rows for download (jitted: eagerly this
    is ~10 op dispatches for a tiny computation).

    words: u32[R, W] device-packed rows; nbits: i32[R].  Row r occupies
    ceil(nbits[r]/32) words (clamped to W); those words land contiguously
    at the exclusive prefix sum of the counts.  Returns u32[cap + R]: the
    dense buffer followed by nbits (as u32), so the whole payload of a
    file arrives in ONE fetch sized by the chunk TOTAL (~mean payload x
    rows) instead of rows x worst-case width — per-row spikes amortize
    across the chunk.  Content past the cap is silently dropped;
    the caller must check sum(counts) <= cap from the appended nbits and
    fall back to the padded download when it overflows.
    """
    r, w = words.shape
    counts = jnp.minimum((nbits.astype(jnp.int32) + 31) // 32, w)
    ends = jnp.cumsum(counts)
    # slot -> source row via scatter(+1 at each row boundary) + cumsum:
    # two vectorized passes instead of a binary search per slot
    bump = jnp.zeros(cap + 1, jnp.int32).at[jnp.minimum(ends, cap)].add(
        1, mode="drop")
    row = jnp.cumsum(bump[:cap])
    row_c = jnp.minimum(row, r - 1)
    col = jnp.arange(cap, dtype=jnp.int32) - (ends[row_c] - counts[row_c])
    valid = (row < r) & (col >= 0) & (col < w)
    dense = jnp.where(
        valid, words[row_c, jnp.clip(col, 0, w - 1)], jnp.uint32(0))
    return jnp.concatenate([dense, nbits.astype(jnp.uint32)])

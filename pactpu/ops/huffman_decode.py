"""Device-side Huffman payload parsing: the bit-serial decode walk as a
batched XLA program.

The reference decodes payloads with a per-line bit-by-bit tree walk
(reference codec/Huffman.py:321-344) inside a per-band side-info loop
(reference codec/pacfile.py:187-217) — inherently serial *within* a
channel-block because every field's bit offset depends on the decoded
lengths before it, but perfectly parallel *across* channel-blocks (the
parallelism csrc/wakbits.cc already exploits on the host).

Design: all R channel-block rows of a chunk walk their bitstreams in
lockstep.  The serial dimension is a `lax.scan` over the lines of each
band (trip counts are static: the band layout), and every step is
vectorized over the R rows:

- **Code lengths resolve in ONE gather, not a tree walk.**  Each table's
  codes are expanded offline into a peek-indexed LUT: entry
  `lut[base[t] + (next K_t bits)]` holds `(symbol << 6) | length` for
  whatever codeword prefixes that K_t-bit window (K_t = the table's
  longest code, 16-21 bits for the shipped set).  The reference's ~21
  sequential bit reads per line collapse to one [R] gather from a 23 MB
  HBM table.
- **Escapes resolve in the same step**: a second 32-bit peek at
  `off + len` supplies the raw `ba`-bit mantissa (reference
  Huffman.py:326-328), selected by the escape sentinel.
- **Side info and sign bits read in bulk**: the per-band ba/sf fields are
  plain vectorized bit reads, and a band's nLines sign bits load as one
  [R, nLines] gather (they precede the codes contiguously,
  reference codec/pacfile.py:334-342).

Corruption handling: the walk never faults (gathers clamp, garbage
decodes to garbage); instead each row carries a `bad` flag — table id out
of range, dead LUT entry (no such codeword), or final bit position past
the row's payload — which the engine checks from the same single fetch
that returns the PCM and raises like the host parser does.

This makes decode end-to-end device-native: the host only frames the
payload bytes into word rows (a length-prefix scan + memcpy), and the
upload is the raw compressed payload instead of repacked fixed-width
codes (~2x less traffic than the round-3 dense-word path).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

ESC_SENTINEL = 0xFFFF        # symbol field value marking the escape code
MAX_LUT_BITS = 24            # refuse tables whose LUT would exceed 2^24/table


# --------------------------------------------------------------------------
# LUT construction (host, cached)
# --------------------------------------------------------------------------


def _tables_fingerprint(tables) -> tuple:
    """Cache key for a table set: shape + a real content digest.  A sum
    fingerprint can collide across distinct trained sets (e.g. permuted
    codes preserve sums) and silently decode with a stale LUT."""
    import hashlib
    lengths, codes, esc_len, esc_codes = tables
    h = hashlib.sha1()
    for a in (lengths, codes, esc_len, esc_codes):
        h.update(np.ascontiguousarray(np.asarray(a, np.int64)).tobytes())
    return (lengths.shape, h.hexdigest())


_lut_cache: dict = {}


def build_lut(tables=None):
    """Peek-indexed decode LUT for a table set.

    Returns dict(lut i32[total], base i32[T], kbits i32[T]) or None when
    any table's longest code exceeds MAX_LUT_BITS (callers fall back to
    the host parser).  Entry = (symbol << 6) | code_length, with symbol
    ESC_SENTINEL for the escape code and 0 (length 0) for dead prefixes.
    """
    if tables is None:
        from pactpu.ops.huffman import load_tables
        tables = load_tables()
    key = _tables_fingerprint(tables)
    if key in _lut_cache:
        return _lut_cache[key]
    lengths = np.asarray(tables[0], np.int64)
    codes = np.asarray(tables[1], np.int64)
    esc_len = np.asarray(tables[2], np.int64)
    esc_codes = np.asarray(tables[3], np.int64)
    n_tab = lengths.shape[0]
    kbits = np.maximum(lengths.max(axis=1), esc_len).astype(np.int64)
    if int(kbits.max()) > MAX_LUT_BITS or int(kbits.min()) < 1:
        _lut_cache[key] = None
        return None
    base = np.concatenate([[0], np.cumsum(1 << kbits)[:-1]])
    lut = np.zeros(int((1 << kbits).sum()), np.int32)
    for t in range(n_tab):
        k = int(kbits[t])
        view = lut[int(base[t]):int(base[t]) + (1 << k)]
        syms = np.nonzero(lengths[t])[0]
        for sym, code, ln in [(int(s), int(codes[t, s]), int(lengths[t, s]))
                              for s in syms] + [
                (ESC_SENTINEL, int(esc_codes[t]), int(esc_len[t]))]:
            lo = code << (k - ln)
            view[lo:lo + (1 << (k - ln))] = (sym << 6) | ln
    out = dict(lut=lut, base=base.astype(np.int32),
               kbits=kbits.astype(np.int32))
    _lut_cache[key] = out
    return out


_dev_lut_cache: dict = {}


def device_lut(tables=None):
    """build_lut uploaded once per (table set, backend) — the ~23 MB LUT
    must not ride the host->device link once per Engine."""
    if tables is None:
        from pactpu.ops.huffman import load_tables
        tables = load_tables()
    key = (_tables_fingerprint(tables), jax.default_backend())
    if key not in _dev_lut_cache:
        host = build_lut(tables)
        _dev_lut_cache[key] = (None if host is None
                               else jax.device_put(host))
    return _dev_lut_cache[key]


# --------------------------------------------------------------------------
# host framing: payload bytes -> word rows
# --------------------------------------------------------------------------


def frame_rows(payload: bytes, word_cap: int = 1 << 14):
    """Split a stream payload (past the header) into per-row word arrays.

    Each channel-block is a uint32-LE byte-count prefix + that many
    payload bytes (reference codec/pacfile.py:170-183).  Returns
    (words u32[R, W] big-endian MSB-first rows, nbits i32[R] payload bit
    counts) with W = max words over the rows; raises ValueError on
    structural corruption (prefix past the stream).  W > word_cap rows
    signal the caller to use the host parser instead."""
    data = np.frombuffer(payload, np.uint8)
    n = data.shape[0]
    spans = []
    off = 0
    while off < n:
        if off + 4 > n:
            raise ValueError("truncated channel-block header")
        nbytes = int(data[off]) | (int(data[off + 1]) << 8) | \
            (int(data[off + 2]) << 16) | (int(data[off + 3]) << 24)
        off += 4
        if off + nbytes > n:
            raise ValueError("corrupt payload: channel-block length "
                             "exceeds the stream")
        spans.append((off, nbytes))
        off += nbytes
    if not spans:
        raise ValueError("no channel-blocks found in payload")
    r = len(spans)
    max_bytes = max(nb for _, nb in spans)
    w = max(1, -(-max_bytes // 4))
    if w > word_cap:
        return None, None
    buf = np.zeros((r, w * 4), np.uint8)
    nbits = np.zeros(r, np.int32)
    for i, (o, nb) in enumerate(spans):
        buf[i, :nb] = data[o:o + nb]
        nbits[i] = 8 * nb
    words = buf.reshape(r, w, 4).astype(np.uint32)
    words = ((words[..., 0] << 24) | (words[..., 1] << 16)
             | (words[..., 2] << 8) | words[..., 3])
    return words, nbits


# --------------------------------------------------------------------------
# the traceable parser
# --------------------------------------------------------------------------


def _peek32(words: jax.Array, off: jax.Array) -> jax.Array:
    """Next 32 bits at bit offset `off` of each row, MSB-aligned.

    words: u32[R, W+1] (trailing zero word; gathers clamp so corrupt
    offsets read zeros); off: i32[R]."""
    wmax = words.shape[1] - 1
    w0i = jnp.clip(off >> 5, 0, wmax)
    w1i = jnp.clip((off >> 5) + 1, 0, wmax)
    w0 = jnp.take_along_axis(words, w0i[:, None].astype(jnp.int32),
                             axis=1)[:, 0]
    w1 = jnp.take_along_axis(words, w1i[:, None].astype(jnp.int32),
                             axis=1)[:, 0]
    b = (off & 31).astype(jnp.uint32)
    lo = jnp.where(b > 0,
                   w1 >> ((jnp.uint32(32) - b) & jnp.uint32(31)),
                   jnp.uint32(0))
    return (w0 << b) | lo


def _field(peek: jax.Array, n) -> jax.Array:
    """Top-`n` bits of a 32-bit peek as i32 (n may be a per-row array;
    n = 0 -> 0)."""
    n = jnp.asarray(n, jnp.uint32)
    val = peek >> ((jnp.uint32(32) - n) & jnp.uint32(31))
    return jnp.where(n > 0, val, jnp.uint32(0)).astype(jnp.int32)


def parse_rows_body(cfg, huff: bool = True):
    """Traceable payload parser over a batch of channel-block rows.

    `(words u32[R, W], nbits i32[R], lut dict | None, )` ->
    dict(overall i32[R], tid i32[R], ba i32[R, nb], sf i32[R, nb],
    mant i32[R, half] (sign-restored BFP codes), lrms i32[R, nb],
    bad bool[R]).

    huff=True parses the .wak layout (table id, sign bits, Huffman codes,
    trailing lrms bits); huff=False the baseline .pac layout (raw ba-bit
    mantissas, no signs/table id/lrms) — reference codec/pacfile.py
    vs codec/solution/pacfile_.py.
    """
    layout = cfg.band_layout
    nb = layout.n_bands
    n_lines = [int(x) for x in layout.n_lines]

    def run(words: jax.Array, nbits: jax.Array, lut=None):
        r = words.shape[0]
        words = jnp.concatenate(
            [words.astype(jnp.uint32),
             jnp.zeros((r, 1), jnp.uint32)], axis=1)
        off = jnp.zeros(r, jnp.int32)
        valid_row = jnp.asarray(nbits, jnp.int32) > 0
        bad = jnp.zeros(r, bool)

        def read(off, n_static):
            pk = _peek32(words, off)
            return (_field(pk, jnp.full(r, n_static, jnp.uint32)),
                    off + n_static)

        overall, off = read(off, cfg.n_scale_bits)
        if huff:
            tid, off = read(off, cfg.n_table_id_bits)
            n_tab = lut["base"].shape[0]
            bad |= valid_row & ((tid < 1) | (tid > n_tab))
            tidc = jnp.clip(tid, 1, n_tab) - 1
            tbase = lut["base"][tidc]
            kshift = (jnp.uint32(32)
                      - lut["kbits"][tidc].astype(jnp.uint32))
            lut_flat = lut["lut"]
        else:
            tid = jnp.ones(r, jnp.int32)

        ba_bands, sf_bands, mant_bands = [], [], []
        for band in range(nb):
            nl = n_lines[band]
            bav, off = read(off, cfg.n_mant_size_bits)
            ba = jnp.where(bav > 0, bav + 1, 0)     # Q6: stored minus one
            sfv, off = read(off, cfg.n_scale_bits)
            ba_bands.append(ba)
            sf_bands.append(sfv)
            active = ba > 0
            ba_u = ba.astype(jnp.uint32)

            if huff:
                # bulk sign bits: nl contiguous single bits per active row
                # (reference codec/pacfile.py:334-337)
                pos = off[:, None] + jnp.arange(nl, dtype=jnp.int32)[None]
                wi = jnp.clip(pos >> 5, 0, words.shape[1] - 1)
                wv = jnp.take_along_axis(words, wi, axis=1)
                sign = ((wv >> (jnp.uint32(31)
                                - (pos & 31).astype(jnp.uint32)))
                        & jnp.uint32(1)).astype(jnp.int32)
                sign = jnp.where(active[:, None], sign, 0)
                off = off + jnp.where(active, nl, 0)

            def step(carry, _):
                off, bad = carry
                if huff:
                    # ONE [R, 3] gather covers the whole step: a code is
                    # <= 24 bits and its escape tail <= 16 more, so bit
                    # positions [b, b + ln + ba) with b < 32 always live
                    # inside three consecutive words — the per-step
                    # critical path is 2 dependent gathers (words, LUT)
                    # instead of 5 (measured 75.6 -> see PERF.md)
                    wmax = words.shape[1] - 1
                    wi = jnp.clip(
                        (off >> 5)[:, None]
                        + jnp.arange(3, dtype=jnp.int32)[None], 0, wmax)
                    w3 = jnp.take_along_axis(words, wi, axis=1)
                    wa, wb, wc = w3[:, 0], w3[:, 1], w3[:, 2]
                    b32 = (off & 31).astype(jnp.uint32)
                    pk = (wa << b32) | jnp.where(
                        b32 > 0,
                        wb >> ((jnp.uint32(32) - b32) & jnp.uint32(31)),
                        jnp.uint32(0))
                    idx = tbase + (pk >> kshift).astype(jnp.int32)
                    ent = lut_flat[jnp.clip(idx, 0,
                                            lut_flat.shape[0] - 1)]
                    ln = ent & 63
                    sym = (ent >> 6).astype(jnp.int32)
                    isesc = sym == ESC_SENTINEL
                    # escape: the raw ba-bit mantissa at bit p = b + ln
                    # of the (wa, wb, wc) 96-bit window; p <= 31 + 24
                    p = b32 + ln.astype(jnp.uint32)
                    hi = jnp.where(p >= 32, wb, wa)
                    lo = jnp.where(p >= 32, wc, wb)
                    pm = p & jnp.uint32(31)
                    pk2 = (hi << pm) | jnp.where(
                        pm > 0,
                        lo >> ((jnp.uint32(32) - pm) & jnp.uint32(31)),
                        jnp.uint32(0))
                    raw = _field(pk2, ba_u)
                    val = jnp.where(isesc, raw, sym)
                    adv = ln + jnp.where(isesc, ba, 0)
                    bad = bad | (active & (ln == 0))
                else:
                    val = _field(_peek32(words, off), ba_u)
                    adv = ba
                val = jnp.where(active, val, 0)
                return ((off + jnp.where(active, adv, 0), bad), val)

            # skip the whole band when NO row allocates it bits — no
            # cursor moves, `bad` only sets while active, and the lines
            # decode to zeros, so the skip is exact.  At 2.27 bps the
            # top bands (two thirds of all lines) are usually silent
            # across a chunk, which halves the latency-bound walk.
            (off, bad), vals = jax.lax.cond(
                jnp.any(active),
                lambda c: jax.lax.scan(step, c, None, length=nl),
                lambda c: (c, jnp.zeros((nl, r), jnp.int32)),
                (off, bad))
            vals = vals.T                            # [R, nl]
            if huff:
                # m = huff + sign * 2^(ba-1) (reference pacfile.py:201-211)
                vals = vals + sign * jnp.where(
                    active, 1 << jnp.maximum(ba - 1, 0), 0)[:, None]
            mant_bands.append(vals)

        if huff:
            pos = off[:, None] + jnp.arange(nb, dtype=jnp.int32)[None]
            wi = jnp.clip(pos >> 5, 0, words.shape[1] - 1)
            wv = jnp.take_along_axis(words, wi, axis=1)
            lrms = ((wv >> (jnp.uint32(31)
                            - (pos & 31).astype(jnp.uint32)))
                    & jnp.uint32(1)).astype(jnp.int32)
            off = off + nb
        else:
            lrms = jnp.zeros((r, nb), jnp.int32)

        bad |= valid_row & (off > jnp.asarray(nbits, jnp.int32))
        bad &= valid_row
        return dict(overall=overall, tid=tid,
                    ba=jnp.stack(ba_bands, axis=1),
                    sf=jnp.stack(sf_bands, axis=1),
                    mant=jnp.concatenate(mant_bands, axis=1),
                    lrms=lrms, bad=bad)

    return run


@lru_cache(maxsize=16)
def parse_rows_fn(cfg, huff: bool = True):
    return jax.jit(parse_rows_body(cfg, huff))

"""The water-fill Pallas kernel and the plain-JAX bit-field extraction.

The kernel runs here in interpret mode (CPU backend); on the GPU the same
kernel compiles through Triton and is checked against the XLA loop by
chip_smoke.py and the `gpu`-marked test below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pactpu.ops import bitalloc as ba_ops
from pactpu.ops import bitpack
from pactpu.ops import pallas_ops as po
from pactpu.utils.config import CodecConfig


def _alloc_case(rows: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    smr = jnp.asarray(rng.uniform(-20, 60, (rows, 25)), jnp.float32)
    lrms = jnp.asarray(rng.random((rows, 25)) < 0.4)
    totals = jnp.asarray(rng.integers(0, 3000, rows).astype(np.int32))
    n_lines = np.asarray(CodecConfig().band_layout.n_lines, np.int32)
    return totals, n_lines, smr, lrms


@pytest.mark.parametrize("rows", [1, 13, 301, 1030])
def test_water_fill_kernel_matches_xla(rows):
    """Pallas water-fill (interpret mode) is bit-identical to the XLA loop
    — integer state, so exact equality — including row counts that are
    not a multiple of the row tile."""
    totals, n_lines, smr, lrms = _alloc_case(rows)
    gold_bits, gold_left = ba_ops.water_fill_xla(totals, 16, n_lines, smr,
                                                 lrms)
    bits, left = po.water_fill(totals, 16, n_lines, smr, lrms,
                               interpret=True)
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(gold_bits))
    np.testing.assert_array_equal(np.asarray(left), np.asarray(gold_left))


def test_water_fill_row_tile():
    """Row tiles are powers of two that keep >= 132 programs in flight
    where the batch allows it, capped at 16 rows."""
    for rows in (1, 131, 264, 512, 1024, 2048, 100_000):
        tile = po.row_tile(rows)
        assert tile & (tile - 1) == 0 and 1 <= tile <= 16
        if tile > 1:
            assert -(-rows // tile) >= 132
        if tile < 16:
            assert -(-rows // (2 * tile)) < 132
    assert po.row_tile(512) == 2


@pytest.mark.parametrize("backend,dtype,kernel", [
    ("gpu", jnp.float32, True),
    ("gpu", jnp.float64, False),
    ("cpu", jnp.float32, False),
])
def test_water_fill_kernel_choice(monkeypatch, backend, dtype, kernel):
    """bitalloc.water_fill picks the kernel from the backend (GPU) and the
    SMR dtype (f32), never from a flag."""
    calls = []

    def fake(*args, **kwargs):
        calls.append(args)
        return "kernel"

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(po, "water_fill", fake)
    totals, n_lines, smr, lrms = _alloc_case(4)
    with jax.enable_x64(dtype == jnp.float64):
        out = ba_ops.water_fill(totals, 16, n_lines, smr.astype(dtype), lrms)
    assert (out == "kernel") == kernel
    assert bool(calls) == kernel


@pytest.mark.gpu
def test_water_fill_kernel_on_gpu(gpu):
    """The compiled Triton kernel equals the XLA loop at a chunk's rows."""
    totals, n_lines, smr, lrms = _alloc_case(512)
    bits, left = po.water_fill(totals, 16, n_lines, smr, lrms)
    gold_bits, gold_left = ba_ops.water_fill_xla(totals, 16, n_lines, smr,
                                                 lrms)
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(gold_bits))
    np.testing.assert_array_equal(np.asarray(left), np.asarray(gold_left))


def _read_field(words: np.ndarray, off: int, width: int) -> int:
    """MSB-first bit read of one field (the plain host reference)."""
    val = 0
    for k in range(width):
        pos = off + k
        bit = (int(words[pos >> 5]) >> (31 - (pos & 31))) & 1
        val = (val << 1) | bit
    return val


@pytest.mark.parametrize("case", ["zero_width", "straddle", "w16_at_31"])
def test_extract_codes_edge_cases(case):
    """Width 0 reads 0; fields that cross a word boundary join both
    words; a 16-bit field at bit offset 31 takes 1 bit from its first
    word and 15 from the next."""
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2 ** 32, (2, 4), dtype=np.uint64).astype(
        np.uint32)
    if case == "zero_width":
        off = np.array([[0, 17, 64, 127], [5, 96, 128, 31]], np.int32)
        width = np.zeros((2, 4), np.int32)
    elif case == "straddle":
        off = np.array([[28, 60, 90, 1], [31, 63, 94, 20]], np.int32)
        width = np.array([[8, 9, 16, 3], [2, 5, 4, 12]], np.int32)
    else:
        off = np.array([[31, 63, 95, 31], [31, 63, 95, 0]], np.int32)
        width = np.array([[16, 16, 16, 1], [16, 16, 16, 16]], np.int32)
    got = np.asarray(bitpack.extract_codes(
        jnp.asarray(words), jnp.asarray(off), jnp.asarray(width)))
    padded = np.concatenate([words, np.zeros((2, 1), np.uint32)], axis=1)
    want = np.array([[_read_field(padded[r], int(off[r, j]),
                                  int(width[r, j])) for j in range(4)]
                     for r in range(2)], np.int32)
    np.testing.assert_array_equal(got, want)


def test_repack_extract_codes_roundtrip():
    """native.repack_codes -> extract_codes reproduces the mantissa codes
    exactly (untransmitted lines -> 0), including fields that span word
    boundaries."""
    from pactpu import native

    if not native.available():
        pytest.skip("native lib unavailable")
    cfg = CodecConfig()
    n_lines = np.asarray(cfg.band_layout.n_lines, np.int32)
    seg = np.asarray(cfg.band_layout.line_to_band)
    rng = np.random.default_rng(3)
    r, total = 9, int(n_lines.sum())
    ba = rng.integers(0, 17, (r, len(n_lines))).astype(np.int32)
    ba[ba == 1] = 0  # no 1-bit allocations, as in the codec
    width = ba[:, seg]
    mant = np.where(
        width > 0,
        rng.integers(0, 2 ** 16, (r, total)) & ((1 << width) - 1),
        0).astype(np.int32)

    n_words = 512
    words = native.repack_codes(mant, ba, n_lines, n_words)
    ends = np.cumsum(width, axis=1)
    out = bitpack.extract_codes(jnp.asarray(words),
                                jnp.asarray((ends - width).astype(np.int32)),
                                jnp.asarray(width.astype(np.int32)))
    np.testing.assert_array_equal(np.asarray(out), mant)


def test_engine_packed_decode_matches(monkeypatch):
    """The dense-word upload decode path (PACTPU_DECODE_UPLOAD=dense,
    repack_codes + extract_codes) produces the identical PCM as the
    default u16-per-line path."""
    from pactpu import native
    from pactpu.codec.engine import Engine

    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(21)
    pcm = np.clip(rng.standard_normal((44100, 2)) * 6000, -32767,
                  32767).astype(np.int16)
    eng = Engine(rate_mode="cbr")
    stream = eng.encode(pcm)
    fs, gold = eng.decode(stream)

    monkeypatch.setenv("PACTPU_DECODE_UPLOAD", "dense")
    fs2, out = Engine(rate_mode="cbr").decode(stream)
    assert fs2 == fs
    np.testing.assert_array_equal(out, gold)


def test_packed_decode_dense_overflow_fallback(monkeypatch):
    """At 4.93 bps the per-chunk payload exceeds the dense-download cap,
    forcing the padded-word-rows fallback — the branch whose latent
    double-reshape crashed the first time this path ran (fixed; this
    test pins it)."""
    import dataclasses as dc

    from pactpu import native
    from pactpu.codec.engine import Engine

    if not native.available():
        pytest.skip("native lib unavailable")
    cfg = dc.replace(CodecConfig(), target_bits_per_sample=4.93)
    rng = np.random.default_rng(11)
    pcm = np.clip(rng.standard_normal((1024 * 87, 2)) * 20000, -32767,
                  32767).astype(np.int16)
    eng = Engine(cfg=cfg, rate_mode="cbr")
    stream = eng.encode(pcm)
    fs, gold = eng.decode(stream)               # u16 path (the default)

    monkeypatch.setenv("PACTPU_DECODE_UPLOAD", "dense")
    fs2, out = Engine(cfg=cfg, rate_mode="cbr").decode(stream)
    np.testing.assert_array_equal(out, gold)

"""Unit parity: each device op against the float64 oracle (refcodec).

The oracle byte-reproduces the reference golden artifacts
(tests/test_compat_golden.py), so agreement here pins the device kernels to
true reference semantics at the *op* level — a drift in the water-filling
stop rule, the escape cost, or the spreading math fails a focused test here
instead of surfacing as a fractional-dB change in an end-to-end SNR bound.

Contracts: reference codec/bitalloc.py:129-184 (BitAlloc),
codec/psychoac.py:158-191 (findpeaks), :215-318 (getMaskedThreshold /
CalcSMRs), :506-682 (getStereoMaskThreshold), codec/Huffman.py:274-309
(encodeData best-table selection).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from pactpu.compat import refcodec as rc
from pactpu.ops import bitalloc as ba_ops
from pactpu.ops import huffman as huff_ops
from pactpu.ops import psycho
from pactpu.utils.config import CodecConfig
from conftest import REFERENCE, requires_reference

CFG = CodecConfig()
HALF = CFG.n_mdct_lines
N = 2 * HALF
LAYOUT = CFG.band_layout

# f32 analysis vs f64 oracle: thresholds/SMRs agree to ~5e-4 dB on real
# audio (measured); the asserted bound leaves ~10x headroom
DB_TOL = 5e-3


@pytest.fixture(scope="module")
def frames():
    """[B, 2, N] float64 signed-fraction 50%-overlap frames from a real
    input (loud, quiet and silent blocks included)."""
    from pactpu.codec.wav import read_wav, pcm16_to_float_np
    wav = read_wav(f"{REFERENCE}/inputs/castanets.wav")
    x = pcm16_to_float_np(wav.samples.T.astype(np.int64))  # [2, n]
    out = [x[:, i * HALF:i * HALF + N] for i in range(12)]
    return np.stack(out)


# -- water-filling allocation vs reference BitAlloc -------------------------


def _random_alloc_cases(seed, rows):
    rng = np.random.default_rng(seed)
    smr = (rng.uniform(-40.0, 60.0, (rows, LAYOUT.n_bands))
           .astype(np.float32))
    lrms = rng.random((rows, LAYOUT.n_bands)) < 0.5
    total = rng.integers(0, 6000, rows).astype(np.int32)
    # include the extremes: nothing to spend, everything cappable
    total[0] = 0
    total[1] = 16 * HALF + 5
    return smr, lrms, total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_water_fill_matches_oracle_exactly(seed):
    """Exact integer equality of (bits, leftover) on identical f32 SMRs,
    including the global stop rule (Q11) and the 1-bit refund (Q12)."""
    smr, lrms, total = _random_alloc_cases(seed, rows=48)
    max_mant = min(1 << CFG.n_mant_size_bits, CFG.max_mant_bits)
    n_lines = np.asarray(LAYOUT.n_lines, np.int64)

    bits_dev, left_dev = ba_ops.water_fill(
        jnp.asarray(total), max_mant, jnp.asarray(n_lines, jnp.int32),
        jnp.asarray(smr), jnp.asarray(lrms))
    bits_dev = np.asarray(bits_dev)
    left_dev = np.asarray(left_dev)

    for r in range(smr.shape[0]):
        bits_ref, diff_ref = rc.bit_alloc(
            float(total[r]), 0, max_mant, LAYOUT.n_bands, n_lines,
            smr[r].astype(np.float64), lrms[r])
        np.testing.assert_array_equal(bits_dev[r], bits_ref, err_msg=f"row {r}")
        assert int(left_dev[r]) == int(diff_ref), f"row {r}"


def test_water_fill_xla_fallback_matches_oracle():
    """The plain XLA loop (water_fill_xla, the path on every backend but
    the GPU and for f64) has the same exact semantics."""
    smr, lrms, total = _random_alloc_cases(7, rows=16)
    max_mant = 16
    n_lines = np.asarray(LAYOUT.n_lines, np.int64)
    bits_dev, left_dev = ba_ops.water_fill_xla(
        jnp.asarray(total), max_mant, jnp.asarray(n_lines, jnp.int32),
        jnp.asarray(smr), jnp.asarray(lrms))
    for r in range(smr.shape[0]):
        bits_ref, diff_ref = rc.bit_alloc(
            float(total[r]), 0, max_mant, LAYOUT.n_bands, n_lines,
            smr[r].astype(np.float64), lrms[r])
        np.testing.assert_array_equal(np.asarray(bits_dev)[r], bits_ref)
        assert int(np.asarray(left_dev)[r]) == int(diff_ref)


# -- psychoacoustics vs reference getMaskedThreshold / CalcSMRs -------------


@requires_reference
def test_masked_threshold_matches_oracle(frames):
    sw = rc.sine_window(N) * frames[:, 0]            # [B, N] f64
    thr_dev = np.asarray(psycho.masked_threshold(
        jnp.asarray(sw, jnp.float32),
        jnp.full(sw.shape[0], 15.0, jnp.float32), CFG.sample_rate))
    for i in range(sw.shape[0]):
        thr_ref = rc.masked_threshold(sw[i], HALF, CFG.sample_rate)
        np.testing.assert_allclose(thr_dev[i], thr_ref, atol=DB_TOL,
                                   err_msg=f"frame {i}")


@requires_reference
def test_masked_threshold_nodrop_matches_oracle(frames):
    """The no-drop variant feeding the MLD stereo thresholds."""
    hann = rc.hann_window(N)
    sw = hann * rc.sine_window(N) * frames[:, 1]
    thr_dev = np.asarray(psycho.masked_threshold(
        jnp.asarray(sw, jnp.float32),
        jnp.zeros(sw.shape[0], jnp.float32), CFG.sample_rate))
    for i in range(sw.shape[0]):
        thr_ref = rc.masked_threshold(sw[i], HALF, CFG.sample_rate,
                                      no_drop=True)
        np.testing.assert_allclose(thr_dev[i], thr_ref, atol=DB_TOL)


@requires_reference
def test_peak_mask_matches_oracle(frames):
    """Device peak detection (p^2 > 1e-6 loudness gate, psycho.py) equals
    the oracle's 10*log10(|X|) > -30 findpeaks gate (Q3: peaks are fully
    described by their bin index)."""
    sw = rc.sine_window(N) * frames[:, 0]
    _, peak = psycho.masker_levels(jnp.asarray(sw, jnp.float32),
                                   CFG.sample_rate)
    peak = np.asarray(peak)
    for i in range(sw.shape[0]):
        bins = rc.find_peak_bins(
            np.fft.fft(rc.hann_window(N) * sw[i])[:HALF])
        mask = np.zeros(HALF, bool)
        mask[bins] = True
        np.testing.assert_array_equal(peak[i], mask, err_msg=f"frame {i}")


@requires_reference
def test_calc_smrs_matches_oracle(frames):
    sw = rc.sine_window(N) * frames[:, 0]
    lines = rc.mdct_forward(sw)
    overall = np.asarray([rc.scale_factor_scalar(
        float(np.max(np.abs(lines[i]))), CFG.n_scale_bits)
        for i in range(sw.shape[0])], np.int64)
    scaled = lines * (2.0 ** overall)[:, None]
    smr_dev = np.asarray(psycho.calc_smrs(
        jnp.asarray(sw, jnp.float32), jnp.asarray(scaled, jnp.float32),
        jnp.asarray(overall, jnp.int32), CFG.sample_rate, LAYOUT))
    for i in range(sw.shape[0]):
        smr_ref = rc.calc_smrs(sw[i], scaled[i] / 2.0 ** overall[i] *
                               2.0 ** overall[i], int(overall[i]),
                               CFG.sample_rate, LAYOUT)
        np.testing.assert_allclose(smr_dev[i], smr_ref, atol=DB_TOL,
                                   err_msg=f"frame {i}")


@requires_reference
def test_stereo_smrs_matches_oracle(frames):
    """Full stereo SMR chain (six thresholds, MLD combine, band max, line
    mixing) vs reference getStereoMaskThreshold semantics, incl. the Q2
    window compounding and Q15 post-scale M/S averaging."""
    b = frames.shape[0]
    sw = rc.sine_window(N)[None, None, :] * frames    # [B, 2, N]
    lines = rc.mdct_forward(sw)
    overall = np.asarray(
        [[rc.scale_factor_scalar(float(np.max(np.abs(lines[i, c]))),
                                 CFG.n_scale_bits) for c in range(2)]
         for i in range(b)], np.int64)
    scaled = lines * (2.0 ** overall)[:, :, None]
    rng = np.random.default_rng(3)
    lrms = rng.random((b, LAYOUT.n_bands)) < 0.5

    smr_dev, mixed_dev = psycho.stereo_smrs(
        jnp.asarray(sw, jnp.float32), jnp.asarray(scaled, jnp.float32),
        jnp.asarray(overall, jnp.int32), jnp.asarray(lrms),
        CFG.sample_rate, LAYOUT)
    smr_dev = np.asarray(smr_dev)
    mixed_dev = np.asarray(mixed_dev)

    for i in range(b):
        smr_ref, mixed_ref = rc.stereo_mask_threshold(
            [sw[i, 0], sw[i, 1]], [scaled[i, 0], scaled[i, 1]],
            [int(overall[i, 0]), int(overall[i, 1])], CFG.sample_rate,
            LAYOUT, lrms[i])
        np.testing.assert_allclose(smr_dev[i], smr_ref, atol=2 * DB_TOL,
                                   err_msg=f"frame {i}")
        np.testing.assert_allclose(mixed_dev[i], mixed_ref,
                                   rtol=1e-5, atol=1e-7)


# -- Huffman best-table selection vs reference encodeData -------------------


def test_encode_select_matches_oracle_exactly():
    """Table choice (lowest-id ties), per-line codes/lengths and total bits
    equal HuffmanTables.encode_best on identical symbols, incl. escapes."""
    tabs = rc.HuffmanTables.load()
    rng = np.random.default_rng(11)
    rows, lines = 24, 96
    # mostly small symbols (in-table), a sprinkle of huge (escape-only)
    syms = rng.geometric(0.05, (rows, lines)).astype(np.int64)
    big = rng.random((rows, lines)) < 0.05
    syms = np.where(big, rng.integers(4096, 32768, (rows, lines)), syms)
    line_bits = rng.integers(1, 17, (rows, lines)).astype(np.int64)
    syms = np.minimum(syms, (1 << (line_bits - 1)) - 1)  # fit the alloc
    transmit = rng.random((rows, lines)) < 0.8
    transmit[0] = False                                  # empty row edge case

    tid_dev, codes_dev, lens_dev, bits_dev = huff_ops.encode_select(
        jnp.asarray(syms, jnp.int32), jnp.asarray(line_bits, jnp.int32),
        jnp.asarray(transmit))
    tid_dev = np.asarray(tid_dev)
    codes_dev = np.asarray(codes_dev)
    lens_dev = np.asarray(lens_dev)
    bits_dev = np.asarray(bits_dev)

    for r in range(rows):
        keep = transmit[r]
        tid_ref, codes_ref, lens_ref = tabs.encode_best(
            syms[r][keep], line_bits[r][keep])
        assert int(tid_dev[r]) == tid_ref, f"row {r}"
        np.testing.assert_array_equal(codes_dev[r][keep], codes_ref)
        np.testing.assert_array_equal(lens_dev[r][keep], lens_ref)
        assert int(bits_dev[r]) == int(lens_ref.sum())
        assert (lens_dev[r][~keep] == 0).all()
        assert (codes_dev[r][~keep] == 0).all()

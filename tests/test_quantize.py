"""Device quantizer kernels vs the exact float64 oracle.

Covers the reference quantizer chart fixture (codec/quantize.py:37) and
randomized sweeps over all mantissa widths used by the codec.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import pactpu.ops.quantize as q
from pactpu.compat import refcodec as rc

CHART = np.array([-1.0, -0.98, -0.51, -0.02, 0.0, 0.05, 0.41, 0.82, 0.95,
                  1.0])


@pytest.mark.parametrize("nbits", [4, 8, 12, 16])
def test_uniform_roundtrip_matches_oracle(nbits):
    codes = np.asarray(q.quantize_uniform(CHART.astype(np.float32), nbits))
    ref = rc.quantize_uniform_vec(CHART, nbits)
    np.testing.assert_array_equal(codes.astype(np.uint64), ref)
    vals = np.asarray(q.dequantize_uniform(codes, nbits))
    refv = rc.dequantize_uniform_vec(ref, nbits)
    np.testing.assert_allclose(vals, refv, atol=1e-7)


def test_uniform_random_16bit():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, 4096)
    codes = np.asarray(q.quantize_uniform(x.astype(np.float32), 16))
    ref = rc.quantize_uniform_vec(x, 16).astype(np.int64)
    # float32 rounding may flip the LSB near code boundaries
    assert np.max(np.abs((codes & 0x7FFF) - (ref & 0x7FFF))) <= 1
    assert np.array_equal(codes >> 15, (ref >> 15).astype(np.int64))


@pytest.mark.parametrize("nmant", [2, 3, 5, 8, 12, 16])
def test_bfp_roundtrip_matches_oracle(nmant):
    rng = np.random.default_rng(nmant)
    x = (rng.uniform(-1, 1, 512) * np.exp2(-rng.integers(0, 14, 512)))
    peak = float(np.max(np.abs(x)))
    scale = rc.scale_factor_scalar(peak, 4, nmant)

    s_dev = int(np.asarray(q.scale_factor(
        np.float32(peak), 4, np.int32(nmant))))
    assert s_dev == scale

    m_ref = rc.bfp_mantissa_vec(x, scale, 4, nmant)
    m_dev = np.asarray(q.bfp_mantissa(
        x.astype(np.float32), np.int32(scale), 4, np.int32(nmant)))
    mag_ref = (m_ref & np.uint64((1 << (nmant - 1)) - 1)).astype(np.int64)
    mag_dev = m_dev & ((1 << (nmant - 1)) - 1)
    assert np.max(np.abs(mag_dev - mag_ref)) <= 1  # f32 boundary rounding
    np.testing.assert_array_equal(
        m_dev >> (nmant - 1), (m_ref >> np.uint64(nmant - 1)).astype(np.int64))

    v_ref = rc.bfp_dequantize_vec(scale, m_ref, 4, nmant)
    v_dev = np.asarray(q.bfp_dequantize(
        np.int32(scale), m_ref.astype(np.int32), 4, np.int32(nmant)))
    np.testing.assert_allclose(v_dev, v_ref, atol=1e-6)


def test_bfp_per_line_bit_widths():
    """One fused call with per-line (scale, nmant) equals per-band calls.

    Data honors the BFP invariant scale <= leading zeros of the band max
    (as the encoder guarantees via scale_factor); codes may differ by one
    LSB at f32 floor boundaries, signs must match exactly.
    """
    rng = np.random.default_rng(7)
    nmants = np.repeat([2, 5, 9, 16], 16)
    scales = np.repeat([3, 0, 7, 12], 16)
    x = rng.uniform(-1, 1, 64) * np.exp2(-scales.astype(np.float64))
    fused = np.asarray(q.bfp_mantissa(
        x.astype(np.float32), scales.astype(np.int32), 4,
        nmants.astype(np.int32)))
    for i0 in range(0, 64, 16):
        nm = int(nmants[i0])
        ref = rc.bfp_mantissa_vec(x[i0:i0 + 16], int(scales[i0]), 4,
                                  nm).astype(np.int64)
        got = fused[i0:i0 + 16].astype(np.int64)
        sbm = 1 << (nm - 1)
        np.testing.assert_array_equal(got >> (nm - 1), ref >> (nm - 1))
        assert np.max(np.abs((got & (sbm - 1)) - (ref & (sbm - 1)))) <= 1
    back = np.asarray(q.bfp_dequantize(
        scales.astype(np.int32), fused, 4, nmants.astype(np.int32)))
    for i0 in range(0, 64, 16):
        ref = rc.bfp_dequantize_vec(
            int(scales[i0]), fused[i0:i0 + 16].astype(np.uint64), 4,
            int(nmants[i0]))
        np.testing.assert_allclose(back[i0:i0 + 16], ref, atol=1e-6)


def test_scale_factor_sweep():
    for nmant in (2, 5, 16):
        for e in range(18):
            a = 0.9 * 2.0 ** -e
            ref = rc.scale_factor_scalar(a, 4, nmant)
            dev = int(np.asarray(q.scale_factor(
                np.float32(a), 4, np.int32(nmant))))
            assert dev == ref, (nmant, e)
    assert int(np.asarray(q.scale_factor(np.float32(0.0), 4, 5))) == 15


def test_pcm16_conversions_match_reference_semantics():
    codes = np.array([-32768, -32767, -1, 0, 1, 16384, 32767], np.int16)
    vals = np.asarray(q.pcm16_to_float(codes))
    from pactpu.codec.wav import pcm16_to_float_np, float_to_pcm16_np
    ref = pcm16_to_float_np(codes)
    np.testing.assert_allclose(vals, ref, atol=1e-7)
    assert ref[0] == 0.0 and not np.signbit(ref[0])  # -32768 -> +0.0
    back = np.asarray(q.float_to_pcm16(ref.astype(np.float32)))
    np.testing.assert_array_equal(back, float_to_pcm16_np(ref))


# -- floating-point (hidden-bit) quantizer ---------------------------------

def _fp_mantissa_ref(a, scale, n_scale_bits=3, nmant=5):
    """Scalar re-statement of reference MantissaFP semantics
    (codec/quantize.py:180-208) with unbounded Python ints."""
    if nmant <= 0:
        return 0
    largest = (1 << n_scale_bits) - 1
    r = nmant + largest
    sbm = 1 << (r - 1)
    aa = abs(a)
    q = (sbm - 1) if aa >= 1.0 else int(((2 ** r - 1) * aa + 1) / 2)
    m = q << (scale + 1)
    if scale < largest:
        m -= 1 << (r - 1)
        m <<= 1
    m >>= r - nmant + 1
    if a < 0 or (a == 0 and np.signbit(a)):
        m += 1 << (nmant - 1)
    return m


def _fp_dequantize_ref(scale, m, n_scale_bits=3, nmant=5):
    if nmant <= 0:
        return 0.0
    largest = (1 << n_scale_bits) - 1
    r = nmant + largest
    sbm = 1 << (nmant - 1)
    sign = 1 if (m & sbm) else 0
    m = m - sbm if sign else m
    if scale < largest:
        m += 1 << (nmant - 1)
    if scale < largest - 1:
        m = ((m << 1) + 1) << (largest - scale - 2)
    val = 2.0 * m / (2 ** r - 1)
    return -val if sign else val


def test_fp_mantissa_matches_reference_semantics():
    from pactpu.ops.quantize import fp_mantissa, fp_dequantize, scale_factor
    vals = np.array([-0.99, -0.38, -0.10, -0.01, -0.001, 0.0,
                     0.05, 0.28, 0.65, 0.97])
    for nsb, nm in [(3, 5), (4, 8), (2, 3)]:
        scales = np.asarray(scale_factor(jnp.abs(jnp.asarray(vals)),
                                         nsb, nm))
        got = np.asarray(fp_mantissa(jnp.asarray(vals),
                                     jnp.asarray(scales), nsb, nm))
        expect = [_fp_mantissa_ref(v, int(s), nsb, nm)
                  for v, s in zip(vals, scales)]
        np.testing.assert_array_equal(got, expect, err_msg=f"{nsb}s{nm}m")

        back = np.asarray(fp_dequantize(jnp.asarray(scales),
                                        jnp.asarray(got), nsb, nm))
        eback = [_fp_dequantize_ref(int(s), int(m), nsb, nm)
                 for s, m in zip(scales, got)]
        # f32 device math: one ulp near 1.0 for the widest (R=23) format
        np.testing.assert_allclose(back, eback, rtol=1e-6, atol=1e-7,
                                   err_msg=f"{nsb}s{nm}m")


def test_fp_roundtrip_precision():
    """FP quantization error is bounded by half an LSB at the signal's own
    scale (the point of the hidden-bit format)."""
    from pactpu.ops.quantize import fp_mantissa, fp_dequantize, scale_factor
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, 512)
    nsb, nm = 3, 5
    scales = np.asarray(scale_factor(jnp.abs(jnp.asarray(x)), nsb, nm))
    m = fp_mantissa(jnp.asarray(x), jnp.asarray(scales), nsb, nm)
    y = np.asarray(fp_dequantize(jnp.asarray(scales), m, nsb, nm))
    r = nm + (1 << nsb) - 1
    largest = (1 << nsb) - 1
    # step size of the FP grid at scale s: uniform-R step widened by the
    # 2^(L-s) zero-padding of DequantizeFP
    step = 2.0 / (2 ** r - 1) * 2.0 ** (largest - scales.astype(float))
    assert np.all(np.abs(x - y) <= step * (1 + 1e-5) + 1e-7)

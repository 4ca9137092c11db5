"""Uniform / floating-point / block-floating-point quantizers (batched JAX).

Semantics follow the reference quantizer family (reference
codec/quantize.py): sign-magnitude *midtread* uniform quantization

    |code| = floor(((2^R - 1) * |x| + 1) / 2),  overload clip at 2^(R-1)-1,
    sign bit = 2^(R-1)                                   (quantize.py:40-64)

block-floating-point scale factors = number of leading zeros of the
uniformly quantized band maximum, capped at 2^nScaleBits - 1
(quantize.py:148-177), and BFP mantissas/dequantization with the half-LSB
reconstruction offset (quantize.py:249-376).

Design decisions:

- Everything is elementwise over arbitrary batch shapes; **bit widths are
  arrays**, so one fused call quantizes all 1024 MDCT lines of a block even
  though every scale-factor band has a different mantissa allocation — the
  per-band loop of the reference (codec/codec.py:269-278) becomes a gather
  of per-line (scale, bits) followed by one vector op.
- The reference's shift pipeline `Q << (scale+1) >> (R-nMant+1)` reduces
  algebraically to a single right shift `Q >> (L - scale)` (L = 2^Rs - 1),
  i.e. `floor(((2^R-1)|x| + 1) / 2^(L-scale+1))` — computed directly in
  float32 so no int64 is needed on device.
- Leading-zero counts use `lax.clz` instead of the reference's per-sample
  Python shift loop (quantize.py:173-176).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _exp2i(e: jax.Array, dtype=jnp.float32) -> jax.Array:
    """2**e as `dtype` for an integer array e (exact: powers of two)."""
    return jnp.exp2(e.astype(dtype))


def quantize_uniform(x: jax.Array, nbits) -> jax.Array:
    """Sign-magnitude midtread uniform quantize to int32 codes.

    x: float array of signed fractions; nbits: int or int array (<=31),
    broadcastable to x. Matches reference vQuantizeUniform
    (codec/quantize.py:91-117) including signbit(-0.0) == negative.
    """
    nbits = jnp.asarray(nbits, jnp.int32)
    a = jnp.abs(x)
    largest = _exp2i(nbits, a.dtype) - 1.0             # 2^R - 1
    sign_mask = jnp.left_shift(jnp.int32(1), nbits - 1)
    code = jnp.floor((largest * a + 1.0) * 0.5).astype(jnp.int32)
    clip = sign_mask - 1                               # overload level
    code = jnp.where(a >= 1.0, clip, code)
    neg = jnp.signbit(x)
    code = jnp.where(neg, code + sign_mask, code)
    return jnp.where(nbits <= 0, 0, code)


def dequantize_uniform(code: jax.Array, nbits,
                       dtype=jnp.float32) -> jax.Array:
    """Inverse of quantize_uniform: |x| = 2|code| / (2^R - 1)
    (reference codec/quantize.py:120-145)."""
    nbits = jnp.asarray(nbits, jnp.int32)
    code = code.astype(jnp.int32)
    sign_mask = jnp.left_shift(jnp.int32(1), nbits - 1)
    largest = _exp2i(nbits, dtype) - 1.0
    neg = (code & sign_mask) == sign_mask
    mag = jnp.where(neg, code - sign_mask, code).astype(dtype)
    val = 2.0 * mag / largest
    val = jnp.where(neg, -val, val)
    return jnp.where(nbits <= 0, 0.0, val)


def scale_factor(a: jax.Array, n_scale_bits: int, nmant) -> jax.Array:
    """Leading-zero count of the uniformly quantized |a|, capped at
    2^nScaleBits - 1 (reference codec/quantize.py:148-177).

    nmant may be an int array (per-band allocations); a is |max| per band.
    """
    nmant = jnp.asarray(nmant, jnp.int32)
    largest_scale = (1 << n_scale_bits) - 1
    r = nmant + largest_scale
    q = quantize_uniform(jnp.abs(a), r)
    # scale = zeros among magnitude bit positions R-2..0 above the msb
    msb = 31 - jax.lax.clz(q)                          # -1 when q == 0
    scale = jnp.clip(r - 2 - msb, 0, largest_scale)
    return jnp.where(nmant <= 0, 0, scale).astype(jnp.int32)


def fp_mantissa(x: jax.Array, scale: jax.Array, n_scale_bits: int,
                nmant) -> jax.Array:
    """Floating-point mantissa codes with hidden leading bit (int32).

    Reference MantissaFP (codec/quantize.py:180-208): uniform-quantize at
    R = nmant + L bits (L = 2^nScaleBits - 1), drop `scale` leading zeros
    AND the hidden leading 1 when scale < L, keep nmant-1 magnitude bits +
    sign.  The reference's Python-int shift chain
    `(Q << (scale+1) - 2^(R-1)) << 1 >> (R-nmant+1)` reduces to the
    int32-safe `(Q - 2^(R-scale-2)) >> (L-scale-1)`.
    """
    nmant = jnp.asarray(nmant, jnp.int32)
    scale = jnp.asarray(scale, jnp.int32)
    largest_scale = (1 << n_scale_bits) - 1
    r = nmant + largest_scale
    q = quantize_uniform(jnp.abs(x), r)
    # shifts clamped to >= 0: the low branch is only selected for scale < L,
    # but XLA evaluates both branches of the where
    hidden = jnp.left_shift(jnp.int32(1), jnp.maximum(r - scale - 2, 0))
    mag_low = jnp.right_shift(
        q - hidden, jnp.maximum(largest_scale - scale - 1, 0))
    mag = jnp.where(scale < largest_scale, mag_low, q)
    sign_mask = jnp.left_shift(jnp.int32(1), nmant - 1)
    code = jnp.where(jnp.signbit(x), mag + sign_mask, mag)
    return jnp.where(nmant <= 0, 0, code)


def fp_dequantize(scale: jax.Array, code: jax.Array, n_scale_bits: int,
                  nmant) -> jax.Array:
    """Inverse of fp_mantissa: restore the hidden bit when scale < L, add
    the half-step 1 and zero-pad when scale < L-1, then uniform-dequantize
    at R bits (reference DequantizeFP, codec/quantize.py:211-246)."""
    nmant = jnp.asarray(nmant, jnp.int32)
    scale = jnp.asarray(scale, jnp.int32)
    code = code.astype(jnp.int32)
    largest_scale = (1 << n_scale_bits) - 1
    r = nmant + largest_scale
    sign_mask = jnp.left_shift(jnp.int32(1), nmant - 1)
    neg = (code & sign_mask) == sign_mask
    mag = jnp.where(neg, code - sign_mask, code)
    mag = jnp.where(scale < largest_scale, mag + sign_mask, mag)
    padded = jnp.left_shift(jnp.left_shift(mag, 1) + 1,
                            jnp.maximum(largest_scale - scale - 2, 0))
    mag = jnp.where(scale < largest_scale - 1, padded, mag)
    full = jnp.where(neg, mag + jnp.left_shift(jnp.int32(1), r - 1), mag)
    val = dequantize_uniform(full, r)
    return jnp.where(nmant <= 0, 0.0, val)


def bfp_mantissa(x: jax.Array, scale: jax.Array, n_scale_bits: int,
                 nmant) -> jax.Array:
    """Block-floating-point sign-magnitude mantissa codes (int32).

    Equivalent to reference vMantissa (codec/quantize.py:315-342):
    magnitude = Q(|x|, R) >> (L - scale); sign bit = 2^(nmant-1).
    scale/nmant are int arrays broadcastable to x (per-line values gathered
    from per-band tables by the caller).
    """
    nmant = jnp.asarray(nmant, jnp.int32)
    scale = jnp.asarray(scale, jnp.int32)
    largest_scale = (1 << n_scale_bits) - 1
    r = nmant + largest_scale
    a = jnp.abs(x)
    # floor(((2^R-1)a + 1) / 2^(L-scale+1)) restructured for f32 precision:
    # = floor(a*2^(nmant+scale-1) + (1-a)*2^(scale-L-1)) — the main term stays
    # below 2^(nmant-1) under the BFP invariant (scale <= leading zeros), so
    # no large intermediate product loses mantissa bits.
    mag = jnp.floor(a * _exp2i(nmant + scale - 1, a.dtype)
                    + (1.0 - a) * _exp2i(scale - largest_scale - 1, a.dtype)
                    ).astype(jnp.int32)
    # overload: Q clipped to 2^(R-1)-1 then shifted
    clip_mag = jnp.right_shift(
        jnp.left_shift(jnp.int32(1), r - 1) - 1, largest_scale - scale)
    mag = jnp.where(a >= 1.0, clip_mag, mag)
    sign_mask = jnp.left_shift(jnp.int32(1), nmant - 1)
    code = jnp.where(jnp.signbit(x), mag + sign_mask, mag)
    return jnp.where(nmant <= 0, 0, code)


def bfp_dequantize(scale: jax.Array, code: jax.Array, n_scale_bits: int,
                   nmant, dtype=jnp.float32) -> jax.Array:
    """Inverse of bfp_mantissa with the reference's half-step reconstruction
    offset `1 << (L - scale - 1)` added when scale < L and magnitude > 0
    (reference codec/quantize.py:345-376)."""
    nmant = jnp.asarray(nmant, jnp.int32)
    scale = jnp.asarray(scale, jnp.int32)
    code = code.astype(jnp.int32)
    largest_scale = (1 << n_scale_bits) - 1
    r = nmant + largest_scale
    sign_mask = jnp.left_shift(jnp.int32(1), nmant - 1)
    neg = (code & sign_mask) == sign_mask
    mag = jnp.where(neg, code - sign_mask, code)
    shift = largest_scale - scale
    half = jnp.where((scale < largest_scale) & (mag > 0),
                     _exp2i(shift - 1, dtype), 0.0)
    num = mag.astype(dtype) * _exp2i(shift, dtype) + half
    val = 2.0 * num / (_exp2i(r, dtype) - 1.0)
    val = jnp.where(neg, -val, val)
    return jnp.where(nmant <= 0, 0.0, val)


def pcm16_to_float(codes: jax.Array, dtype=jnp.float32) -> jax.Array:
    """int16 PCM -> signed fractions via the reference's sign-magnitude
    16-bit dequantizer (reference codec/pcmfile.py:89-98): value =
    sign * 2*(|code| mod 2^15) / (2^16 - 1); note -32768 maps to 0.0."""
    c = codes.astype(jnp.int32)
    mag = jnp.abs(c) & 0x7FFF
    neg = (c < 0) & (mag > 0)  # -32768 maps to +0.0, as in the reference
    val = 2.0 * mag.astype(dtype) / 65535.0
    return jnp.where(neg, -val, val)


def float_to_pcm16(x: jax.Array) -> jax.Array:
    """Signed fractions -> int16 PCM codes via the reference's 16-bit
    sign-magnitude quantizer (reference codec/pcmfile.py:127-134)."""
    a = jnp.abs(x)
    mag = jnp.floor((65535.0 * a + 1.0) * 0.5).astype(jnp.int32)
    mag = jnp.where(a >= 1.0, 32767, mag)
    out = jnp.where(jnp.signbit(x), -mag, mag)
    return out.astype(jnp.int16)

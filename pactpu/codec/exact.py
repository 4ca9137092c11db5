"""Exact sequential-reservoir rate control on the device path.

The reference's bit reservoir couples block t to t+1: each block withdraws
1% of the deposit before allocating, channel 0's allocation leftover funds
channel 1, and each channel's Huffman savings are deposited back
(reference codec/Huffman.py:353-371, codec/codec.py:229, 258-260).  The
engine's default "reservoir" mode approximates this with measurements taken
at extraBits = 0; THIS module reproduces the trajectory exactly — the
engine's bitstream becomes bit-identical to a serial encode — while keeping
all the heavy math batch-parallel (SURVEY.md §7 hard parts, option (a)).

The trick: everything inside the sequential loop that depends on the
running `extraBits` does so only through the integer per-band bit
allocation, and an allocation value is one of 0..16.  So the expensive part
— BFP quantization + Huffman length lookup for every line under every
possible allocation — is *precomputed in parallel* as a dense cost table

    cost[b, ch, band, alloc, table] = sum over the band's lines of the
        Huffman code length (or escape length + alloc) of the mantissa
        that band would emit at that allocation

(16 quantize+gather passes over the whole batch, pure matmul/elementwise
work), and the sequential part collapses to a tiny `lax.scan` over blocks
whose body is one water-filling per channel plus a [bands, 17->1, tables]
gather — no data-dependent work, no host round trips; the scan carry
(deposit, extraBits) is two int32s chained across chunks.

Shipped as `Engine(rate_mode="exact")`.  With precision="f64" (and jax
x64 enabled) the engine byte-reproduces the reference golden bitstreams
(tests/test_exact_mode.py).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from pactpu.ops import bitalloc as ba_ops
from pactpu.ops import huffman as huff_ops
from pactpu.ops import psycho
from pactpu.ops import quantize as q_ops
from pactpu.utils.config import CodecConfig


@lru_cache(maxsize=8)
def cost_table_body(cfg: CodecConfig, precision: str = "f32"):
    """`(analysis dict, consts) -> cost i32[B, 2, bands, 17, T]`.

    Exactness hinges on the scale factor being a function of only the band
    peak and the allocation (reference codec/codec.py:269-278), so each
    allocation value's mantissas — and therefore Huffman lengths — are
    computable without knowing the reservoir state.
    """
    from pactpu.codec.engine import _dtype
    layout = cfg.band_layout
    seg = np.asarray(layout.line_to_band)
    max_mant = min(1 << cfg.n_mant_size_bits, cfg.max_mant_bits)
    dt = _dtype(precision)
    half = cfg.n_mdct_lines
    # one-hot line->band matrix: band sums become one contraction
    onehot = np.zeros((half, layout.n_bands), dt)
    onehot[np.arange(half), seg] = 1.0

    def run(analysis: dict, consts: dict):
        mixed = analysis["mixed"]                     # [B, 2, half]
        tab_lens = jnp.asarray(consts["tabs"][0])     # [T, S]
        esc_len = jnp.asarray(consts["tabs"][2])      # [T]
        n_tab = tab_lens.shape[0]
        n_lo = min(6, n_tab)

        # 5-bit packed lengths, two words per symbol (one gather for all
        # tables — same layout trick as huffman.encode_select)
        shifts_lo = 5 * jnp.arange(n_lo, dtype=jnp.int32)
        packed_lo = jnp.sum(
            jnp.left_shift(tab_lens[:n_lo], shifts_lo[:, None]), axis=0)
        shifts_hi = 5 * jnp.arange(n_tab - n_lo, dtype=jnp.int32)
        packed_hi = jnp.sum(
            jnp.left_shift(tab_lens[n_lo:], shifts_hi[:, None]), axis=0)
        packed = jnp.stack([packed_lo, packed_hi], axis=-1)  # [S, 2]

        peak = psycho.band_max(jnp.abs(mixed), layout, fill=0.0)

        def per_alloc(a):
            """Band Huffman costs at allocation `a` (traced scalar 1..16)."""
            sf = q_ops.scale_factor(peak, cfg.n_scale_bits, a)
            mant = q_ops.bfp_mantissa(mixed, sf[..., seg],
                                      cfg.n_scale_bits, a)
            _, unsigned = huff_ops.split_sign(mant, a)
            rec = packed[unsigned]                    # [B, 2, half, 2]
            lens = []
            for t in range(n_tab):
                w = rec[..., 0] if t < n_lo else rec[..., 1]
                line_len = (w >> (5 * (t % n_lo))) & 31
                lens.append(jnp.where(line_len > 0, line_len,
                                      esc_len[t] + a))
            lens = jnp.stack(lens, axis=-1).astype(dt)  # [B, 2, half, T]
            # exact in floating point: lengths are small ints, band sums
            # < 2^24
            return jnp.einsum("bclt,lk->bckt", lens, jnp.asarray(onehot),
                              precision=jax.lax.Precision.HIGHEST
                              ).astype(jnp.int32)

        allocs = jnp.arange(1, max_mant + 1, dtype=jnp.int32)
        by_alloc = jax.lax.map(per_alloc, allocs)     # [16, B, 2, bands, T]
        zero = jnp.zeros_like(by_alloc[:1])           # alloc 0: no lines
        return jnp.concatenate([zero, by_alloc]).transpose(1, 2, 3, 0, 4)

    return run


@lru_cache(maxsize=8)
def extras_scan_body(cfg: CodecConfig, precision: str = "f32"):
    """`(smr[B,2,bands], lrms[B,bands], cost[B,2,bands,17,T], valid[B],
    carry i32[2]) -> (extras f32[B], carry')`.

    The exact reference reservoir trajectory (codec/Huffman.py:353-371,
    codec/codec.py:229,258-260): per block, withdraw floor(deposit/divisor)
    when deposit > 10 (or settle a negative balance), grant `extras` to
    channel 0, chain channel 0's allocation leftover to channel 1, deposit
    both channels' Huffman savings, carry channel 1's leftover forward.
    `valid` gates padding blocks out of the state chain so chunk size never
    changes the trajectory.  carry = (bitDeposit, extraBits).
    """
    from pactpu.codec.engine import _dtype
    dt = _dtype(precision)
    layout = cfg.band_layout
    nl = jnp.asarray(np.asarray(layout.n_lines, np.int32))
    max_mant = min(1 << cfg.n_mant_size_bits, cfg.max_mant_bits)
    budget = float(cfg.bit_budget())
    tid_bits = cfg.n_table_id_bits
    divisor = cfg.reservoir_withdraw_divisor

    def chan(extra, smr_c, lrms_b, cost_c):
        # identical int(budget + extra) truncation to finalize_body's
        total = (jnp.asarray(budget, dt) + extra.astype(dt)
                 ).astype(jnp.int32)
        bits, left = ba_ops.water_fill_xla(
            total[None], max_mant, nl, smr_c[None], lrms_b[None],
            cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)
        bits, left = bits[0], left[0]
        band_cost = jnp.take_along_axis(
            cost_c, bits[:, None, None], axis=1)[:, 0]   # [bands, T]
        huff_best = jnp.min(jnp.sum(band_cost, axis=0))  # ties -> same cost
        raw = jnp.sum(bits * nl)
        n_signs = jnp.sum(jnp.where(bits > 0, nl, 0))
        savings = raw - (huff_best + n_signs + tid_bits)
        return savings.astype(jnp.int32), left.astype(jnp.int32)

    def step(carry, inp):
        deposit, extra = carry
        smr_b, lrms_b, cost_b, v = inp
        take = (jnp.where(deposit > 10, deposit // divisor, 0)
                + jnp.where(deposit < 0, deposit, 0))
        granted = extra + take
        # per-channel chain: channel k's allocation leftover funds
        # channel k+1; every channel's savings deposit (mono degenerates
        # to the single EncodeSingleChannel pass, codec/codec.py:131-210)
        chain, total_savings = granted, jnp.int32(0)
        for ch in range(cfg.n_channels):
            s_ch, chain = chan(chain, smr_b[ch], lrms_b, cost_b[ch])
            total_savings = total_savings + s_ch
        new_carry = (
            jnp.where(v, deposit - take + total_savings, deposit
                      ).astype(jnp.int32),
            jnp.where(v, chain, extra).astype(jnp.int32))
        return new_carry, jnp.where(v, granted, 0).astype(jnp.int32)

    def run(smr, lrms, cost, valid, carry):
        (dep, ext), extras = jax.lax.scan(
            step, (carry[0], carry[1]), (smr, lrms, cost, valid))
        return extras.astype(jnp.float32), jnp.stack([dep, ext])

    return run


@lru_cache(maxsize=8)
def _cost_fn(cfg: CodecConfig, precision: str = "f32"):
    return jax.jit(cost_table_body(cfg, precision))


@lru_cache(maxsize=8)
def _extras_fn(cfg: CodecConfig, precision: str = "f32"):
    return jax.jit(extras_scan_body(cfg, precision))


def exact_extras_chunked(analyses, consts, cfg: CodecConfig,
                         precision: str, n_real: int, carry=None):
    """Run the cost precompute + reservoir scan over device-resident chunk
    analyses (any per-chunk sizes — each chunk's length comes from its own
    arrays); returns (per-chunk extras device arrays, final carry).

    n_real: real coded blocks (padding beyond it is gated out of the scan
    state so the trajectory is chunk-size invariant)."""
    cost_fn = _cost_fn(cfg, precision)
    extras_fn = _extras_fn(cfg, precision)
    if carry is None:
        carry = jnp.zeros(2, jnp.int32)
    extras_chunks = []
    done = 0
    for a in analyses:
        size = a["smr"].shape[0]
        cost = cost_fn(a, consts)
        valid = jnp.arange(size) < max(0, n_real - done)
        ex, carry = extras_fn(a["smr"], a["lrms"], cost, valid, carry)
        extras_chunks.append(ex)
        done += size
    return extras_chunks, carry

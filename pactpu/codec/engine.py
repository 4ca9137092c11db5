"""End-to-end codec engine: batched encode/decode of whole files.

Where the reference iterates 2048-sample blocks serially through Python
(reference codec/pacfile.py:475-495), this engine frames the entire file
into `[B, 2, 2048]` chunks and runs analysis -> psychoacoustics ->
allocation -> quantization -> Huffman selection as ONE jitted device
computation per chunk; only the bit-serial payload serialization crosses to
the host (native C++, pactpu/native.py).

Performance design points:

- **Constants are program parameters.**  The MDCT cosine basis (8 MB), the
  psychoacoustic tables and the Huffman tables (2.6 MB)
  are passed as jit arguments (uploaded to HBM once per process), not
  closed-over constants — embedded constants ballooned compiled executables
  to >40 MB, which made every compile, cache load and upload slow.
- **Fixed chunk size.**  Files are processed in fixed-size block chunks
  (default 512, padded), so every file of every length reuses the same
  compiled program instead of compiling one program per length bucket.
- **int16 on the wire.**  Chunks upload as int16 PCM frames; the
  PCM->signed-fraction conversion runs on device.  Outputs are downcast to
  the narrowest dtype that holds them before download.

Rate-control modes (the reference's sequential bit reservoir couples block
t to t+1, codec/Huffman.py:353-371, codec/codec.py:229):

- "cbr":       every block allocates from the flat per-block budget
               (extraBits = 0); fully parallel, single pass.
- "reservoir": two parallel passes.  Pass 1 measures per-channel Huffman
               savings and allocation leftovers with extraBits = 0; a tiny
               device lax.scan then replays the reference reservoir policy
               (deposit savings, withdraw 1%/block, carry allocation
               leftovers) to assign per-block extra bits; pass 2 re-encodes
               with those extras.  This reproduces the reference's VBR
               behavior to second order while keeping every device op
               batch-parallel — and the whole encode fully async: the host
               blocks exactly once, on the packed-payload download.
- "exact":     the reference's exact sequential trajectory: per-allocation
               Huffman cost tables precomputed in parallel + a tiny device
               lax.scan over blocks (pactpu.codec.exact).  With
               precision="f64" the engine byte-reproduces the reference
               golden bitstreams.

In all modes channel 0's allocation leftover funds channel 1 within the
same block, as in the reference (codec/codec.py:258-260).
"""

from __future__ import annotations

import bisect
import itertools
import os
import struct
from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pactpu import native
from pactpu.ops import bitalloc as ba_ops
from pactpu.ops import bitpack as pack_ops
from pactpu.ops import huffman as huff_ops
from pactpu.ops import psycho
from pactpu.ops import quantize as q_ops
from pactpu.ops.mdct import _mdct_basis_np, mdct, imdct
from pactpu.ops.windows import analysis_window
from pactpu.utils.config import CodecConfig
from pactpu.compat import refcodec as rc

DEFAULT_CHUNK_BLOCKS = 512

# u32 words per channel-block payload for the on-device packer.  Sized for
# the real operating range INCLUDING post-quiet reservoir spikes (the
# reference's leftover chaining hands a block the whole unspent budget:
# castanets measures 232 words, speech 160 at 2.27 bits/sample), NOT the
# theoretical ceiling (~18.7 kbit), so that overflow is rare.  Past this
# width a chunk is transparently re-encoded with the wide packer, and past
# that, the host packer (Engine._chunk_payload).  This width, the dense
# download budget below and DEFAULT_CHUNK_BLOCKS are not yet tuned by any
# measurement on the GPU (PERF.md).
PACK_WORDS = 256
# Average u32 words per row budgeted for the DENSE payload download
# (Engine._payload_device_packed): corpus payloads average ~69 words per
# channel-block at 2.27 bits/sample, and the chunk TOTAL absorbs per-row
# spikes, so this cap overflows only on pathological content (then the
# padded download takes over).
PACK_DENSE_WORDS = 112
# True per-channel-block ceiling for the SHIPPED tables: overall(4) + tid(4)
# + 25*(ba 4 + sf 4) + 25 lrms + 1024 signs + 1024 * (max escape 13 + max
# mantissa 16) = 30,961 bits = 968 u32 words.  Freshly trained tables may
# have escape codes up to 31 bits (huffman_train caps depth there), for
# which the host serial packer in Engine._chunk_payload is the documented
# backstop — it handles any nbits the wide packer cannot.
PACK_WORDS_MAX = 968


@lru_cache(maxsize=8)
def engine_consts_np(cfg: CodecConfig, precision: str = "f32") -> dict:
    """The large lookup tables the jitted engine consumes, as numpy arrays
    (device-put once per process by `Engine`): MDCT basis, psychoacoustic
    spreading geometry, Huffman code tables.

    precision "f32" is the fast path; "f64" feeds the exact
    (golden-byte) mode — requires jax x64 to be enabled."""
    n = 2 * cfg.n_mdct_lines
    dt = _dtype(precision)
    return dict(
        basis=_mdct_basis_np(n).astype(dt),
        psy=psycho._consts(n, cfg.sample_rate, np.dtype(dt).name),
        tabs=huff_ops.load_tables(),
    )


def _dtype(precision: str):
    if precision == "f32":
        return np.float32
    if precision == "f64":
        return np.float64
    raise ValueError(f"unknown precision {precision!r}")


def frame_blocks(x: jax.Array, half: int, n_blocks: int) -> jax.Array:
    """[C, n] -> [B, C, 2*half] 50%-overlap frames, including the leading
    zero priorBlock and the trailing zero flush block (reference
    codec/pacfile.py:264-282, 355-366). B = n_blocks + 1."""
    pad_to = (n_blocks + 1) * half
    y = jnp.pad(x, ((0, 0), (half, pad_to - x.shape[1])))
    return _overlap_frames(y, half)


def _overlap_frames(y: jax.Array, half: int) -> jax.Array:
    """[C, (B+1)*half] -> [B, C, 2*half] 50%-overlap frames as two shifted
    CONTIGUOUS views + one concat — frame b is [y[b*half:(b+1)*half] ‖
    y[(b+1)*half:(b+2)*half]], so the overlapped "gather" is just
    reshapes, where a gather formulation (jnp.take with a [B, 2*half]
    index matrix) would read every sample through an index."""
    c = y.shape[0]
    b = y.shape[1] // half - 1
    first = y[:, : b * half].reshape(c, b, half)
    second = y[:, half:].reshape(c, b, half)
    return jnp.concatenate([first, second], axis=-1).transpose(1, 0, 2)


def frame_blocks_np(pcm: np.ndarray, half: int, b_pad: int) -> np.ndarray:
    """Host framing: int16 [n, C] -> int16 [b_pad, C, 2*half] 50%-overlap
    frames (leading zero priorBlock, zero-padded tail/flush blocks)."""
    from numpy.lib.stride_tricks import sliding_window_view
    c = pcm.shape[1]
    x = np.zeros((c, (b_pad + 1) * half), np.int16)
    n = min(pcm.shape[0], b_pad * half)
    x[:, half:half + n] = pcm[:n].T
    win = sliding_window_view(x, 2 * half, axis=1)[:, ::half, :]
    return np.ascontiguousarray(win[:, :b_pad].transpose(1, 0, 2))


@lru_cache(maxsize=16)
def analyze_body(cfg: CodecConfig, precision: str = "f32"):
    """The analysis front half of the encoder — window+MDCT, overall block
    scale, LRMS decision, stereo psychoacoustic SMRs — as a pure traceable
    `(frames i16[B, 2, 2N], consts) -> dict(mixed, smr, lrms, overall)`.

    Everything the rate/quantize/entropy tail (`finalize_body`) consumes.
    In the reservoir mode the engine keeps these arrays device-resident
    between the measurement pass and the final pass so the heavy
    psychoacoustic model runs ONCE per block instead of twice."""
    layout = cfg.band_layout
    half = cfg.n_mdct_lines
    fs = cfg.sample_rate
    dt = _dtype(precision)
    win = np.asarray(analysis_window(cfg.window, 2 * half), dt)

    def run(frames_i16: jax.Array, consts: dict):
        frames = q_ops.pcm16_to_float(frames_i16, dt)
        sw = frames * win[None, None, :]
        lines = mdct(sw, consts["basis"])
        overall = q_ops.scale_factor(
            jnp.max(jnp.abs(lines), axis=-1), cfg.n_scale_bits, 5)
        scaled = lines * jnp.exp2(overall[..., None].astype(lines.dtype))

        if cfg.n_channels == 1:
            # mono extension: no LRMS/stereo model, the mono psych chain of
            # reference EncodeSingleChannel (codec/codec.py:131-210)
            lrms = jnp.zeros((frames.shape[0], layout.n_bands), bool)
            smr = psycho.calc_smrs(
                sw[:, 0], scaled[:, 0], overall[:, 0], fs, layout,
                consts=consts["psy"], peak_mode=cfg.peak_mode)[:, None]
            return dict(mixed=scaled, smr=smr, lrms=lrms, overall=overall)

        if cfg.ms_decision == "bitalloc":
            # bitalloc-minimization variant: water-fill all four codings
            # and pick per band the pair that needs fewer bits (the WAK
            # paper's second decision rule; round-2 VERDICT #3)
            smr_lr, smr_ms, ms_lines = psycho.stereo_smr_pair(
                sw, scaled, overall, fs, layout,
                consts=consts["psy"], peak_mode=cfg.peak_mode)
            max_mant = min(1 << cfg.n_mant_size_bits, cfg.max_mant_bits)
            lrms = ba_ops.lrms_decision_bitalloc(
                smr_lr, smr_ms, layout.n_lines_array, int(cfg.bit_budget()),
                max_mant, cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)
            smr, mixed = psycho.select_coding(smr_lr, smr_ms, scaled,
                                              ms_lines, lrms, layout)
            return dict(mixed=mixed, smr=smr, lrms=lrms, overall=overall)

        lrms = psycho.lrms_decision(frames, layout, cfg.ms_decision_factor)
        smr, mixed = psycho.stereo_smrs(sw, scaled, overall, lrms, fs,
                                        layout, consts=consts["psy"],
                                        peak_mode=cfg.peak_mode)
        return dict(mixed=mixed, smr=smr, lrms=lrms, overall=overall)

    return run


@lru_cache(maxsize=16)
def finalize_body(cfg: CodecConfig, two_channel_chain: bool = True,
                  return_syms: bool = False, pack_words: int = 0,
                  measure_only: bool = False, precision: str = "f32"):
    """The rate-control/quantize/entropy tail of the encoder:
    `(analysis dict from analyze_body, extra0 f32[B], consts) -> dict` —
    water-filling allocation, BFP quantization, Huffman table selection and
    (pack_words > 0) on-device payload packing.

    measure_only returns just (savings, leftover) — the reservoir pass-1
    measurement; XLA dead-code-eliminates the payload serialization
    (scale factors, code gather, packer)."""
    layout = cfg.band_layout
    half = cfg.n_mdct_lines
    n_lines = np.asarray(layout.n_lines, np.int32)
    seg = np.asarray(layout.line_to_band)
    max_mant = min(1 << cfg.n_mant_size_bits, cfg.max_mant_bits)
    budget = float(cfg.bit_budget())
    dt = _dtype(precision)

    c = cfg.n_channels

    def run(analysis: dict, extra0: jax.Array, consts: dict):
        mixed = analysis["mixed"]
        smr = analysis["smr"]
        lrms = analysis["lrms"]
        overall = analysis["overall"].astype(jnp.int32)
        b = mixed.shape[0]

        # channel chain: each channel's allocation leftover funds the next
        # channel of the same block (reference codec/codec.py:258-260);
        # the last channel's leftover flows back to the reservoir
        extra = extra0.astype(dt)
        bits_ch, left = [], None
        # static loop bound for the legacy greedy allocators: with the
        # channel chain, a channel's budget never exceeds budget + the
        # previous channel's full leftover (+ reservoir extras, bounded
        # by one extra budget in practice) — 4x is a safe static cap
        legacy_cap = int(4 * max(budget, 1))
        if cfg.alloc_mode == "const_snr":
            # per-band peak SPL of the coded lines (MDCT SPL convention
            # SPL(4 X^2) - 6.02 overall, Q15) — the `peakSPL` argument of
            # reference BitAllocConstSNR (codec/bitalloc.py:60-90)
            pk = psycho.band_max(jnp.abs(mixed), layout, fill=0.0)
            peak_spl = (psycho.spl(4.0 * pk * pk)
                        - 6.02 * overall[..., None].astype(pk.dtype))
        for ch in range(c):
            total = (jnp.asarray(budget, dt) + extra).astype(jnp.int32)
            if cfg.alloc_mode == "closed_form":
                # kai's allocator (baselines/kai/bitalloc.py:84-134): no
                # LRMS stop thresholds; leftover = budget - spent
                bits_c = ba_ops.alloc_closed_form(
                    total, max_mant, n_lines, smr[:, ch])
            elif cfg.alloc_mode == "uniform":
                bits_c = ba_ops.alloc_uniform_batch(
                    total, max_mant, n_lines, legacy_cap)
            elif cfg.alloc_mode == "const_snr":
                bits_c = ba_ops.alloc_const_snr_batch(
                    total, max_mant, n_lines, peak_spl[:, ch], legacy_cap)
            elif cfg.alloc_mode == "const_mnr":
                bits_c = ba_ops.alloc_const_mnr_batch(
                    total, max_mant, n_lines, smr[:, ch], legacy_cap)
            else:
                bits_c, left = ba_ops.water_fill(
                    total, max_mant, n_lines, smr[:, ch], lrms,
                    cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)
            if cfg.alloc_mode != "water_fill":
                left = total - jnp.sum(bits_c * n_lines[None], axis=1)
            bits_ch.append(bits_c)
            if two_channel_chain:
                extra = left.astype(dt)
        bits = jnp.stack(bits_ch, axis=1)                 # [B, C, bands]

        peak = psycho.band_max(jnp.abs(mixed), layout, fill=0.0)
        sf = q_ops.scale_factor(peak, cfg.n_scale_bits, bits)
        sf_l = sf[..., seg]
        nm_l = bits[..., seg]
        mant = q_ops.bfp_mantissa(mixed, sf_l, cfg.n_scale_bits, nm_l)
        sign, unsigned = huff_ops.split_sign(mant, nm_l)
        transmit = nm_l > 0

        tid, codes, lens, huff_bits = huff_ops.encode_select(
            unsigned.reshape(b * c, half), nm_l.reshape(b * c, half),
            transmit.reshape(b * c, half), tables=consts["tabs"])

        raw_bits = jnp.sum(bits * n_lines[None, None, :], axis=-1)
        n_signs = jnp.sum(transmit, axis=-1)
        used = (huff_bits.reshape(b, c) + n_signs + cfg.n_table_id_bits)
        savings = raw_bits - used

        if measure_only:
            return dict(savings=savings.astype(jnp.int32),
                        leftover=left.astype(jnp.int32))

        out = dict(
            overall=overall.astype(jnp.int8), lrms=lrms,
            bits=bits.astype(jnp.int8), sf=sf.astype(jnp.int8),
            tid=tid.reshape(b, c).astype(jnp.int8),
            savings=savings.astype(jnp.int32),
            leftover=left.astype(jnp.int32))
        if pack_words:
            words, nbits = pack_ops.pack_payload_bits(
                overall.reshape(b * c), tid, bits.reshape(b * c, -1),
                sf.reshape(b * c, -1),
                jnp.where(transmit, sign, 0).reshape(b * c, half),
                codes.reshape(b * c, half), lens.reshape(b * c, half),
                jnp.repeat(lrms.astype(jnp.int32), c, axis=0),
                layout.n_lines, cfg.n_scale_bits, cfg.n_mant_size_bits,
                cfg.n_table_id_bits, pack_words)
            out["words"] = words
            out["nbits"] = nbits
        else:
            out["sign"] = jnp.where(transmit, sign, 0).astype(jnp.int8)
            out["codes"] = codes.reshape(b, c, half)
            out["lens"] = lens.reshape(b, c, half).astype(jnp.int8)
        if return_syms:
            out["syms"] = jnp.where(transmit, unsigned, -1)
        return out

    return run


@lru_cache(maxsize=16)
def encode_body(cfg: CodecConfig, two_channel_chain: bool = True,
                return_syms: bool = False, pack_words: int = 0,
                measure_only: bool = False, precision: str = "f32"):
    """The full per-block encode computation as a pure traceable function
    `(frames i16[B, 2, 2N], extra0 f32[B], consts) -> dict of device
    arrays` — analyze_body composed with finalize_body.  Jitted directly
    for single-chip use (`_encode_fn`) or wrapped in `shard_map` for
    block-sharded multi-chip encoding (pactpu.parallel.shard).  `consts`
    is `engine_consts_np(cfg)` (or its device-put copy).

    pack_words > 0 additionally runs the on-device bit packer
    (pactpu.ops.bitpack) and returns `words` u32[B*2, pack_words] +
    `nbits` i32[B*2] instead of the per-line sign/code/length arrays —
    the download shrinks ~10x and the host only slices bytes."""
    analyze = analyze_body(cfg, precision)
    finalize = finalize_body(cfg, two_channel_chain, return_syms,
                             pack_words, measure_only, precision)

    def run(frames_i16: jax.Array, extra0: jax.Array, consts: dict):
        return finalize(analyze(frames_i16, consts), extra0, consts)

    return run


@lru_cache(maxsize=16)
def _encode_fn(cfg: CodecConfig, two_channel_chain: bool = True,
               pack_words: int = 0, precision: str = "f32"):
    return jax.jit(encode_body(cfg, two_channel_chain,
                               pack_words=pack_words, precision=precision))


@lru_cache(maxsize=16)
def _chunk_analyze_fn(cfg: CodecConfig, precision: str = "f32"):
    """Chunk analysis program taking *raw* PCM: `(pcm i16[2, (B+1)*half],
    consts) -> analysis dict` (device-resident).  The 50%-overlap framing
    happens on device, so each chunk uploads (B+1)*half samples instead of
    B*2*half overlapped frames — half the upload traffic."""
    body = analyze_body(cfg, precision)
    half = cfg.n_mdct_lines

    def run(pcm: jax.Array, consts: dict):
        return body(_overlap_frames(pcm, half), consts)

    return jax.jit(run)


@lru_cache(maxsize=16)
def _finalize_fn(cfg: CodecConfig, pack_words: int = 0,
                 measure_only: bool = False, precision: str = "f32"):
    return jax.jit(finalize_body(cfg, pack_words=pack_words,
                                 measure_only=measure_only,
                                 precision=precision))


@lru_cache(maxsize=16)
def _chunk_encode_fn(cfg: CodecConfig, pack_words: int = 0,
                     measure_only: bool = False):
    """Single-program chunk encode (framing + analysis + finalize); used
    for the rare wide-packer re-encode and by callers that don't need the
    analysis kept resident."""
    body = encode_body(cfg, pack_words=pack_words,
                       measure_only=measure_only)
    half = cfg.n_mdct_lines

    def run(pcm: jax.Array, extra0: jax.Array, consts: dict):
        return body(_overlap_frames(pcm, half), extra0, consts)

    return jax.jit(run)


@lru_cache(maxsize=16)
def encode_body_baseline(cfg: CodecConfig):
    """The baseline (solution-variant) encode: independent L/R channels,
    mono psychoacoustics, 5-arg water-filling, raw BFP mantissas — the
    pipeline of reference codec/solution/codec_.py:69-148 producing the
    `.pac` layout.  `(frames i16[B, 2, 2N], consts) -> dict`."""
    layout = cfg.band_layout
    half = cfg.n_mdct_lines
    n = 2 * half
    fs = cfg.sample_rate
    n_lines = np.asarray(layout.n_lines, np.int32)
    seg = np.asarray(layout.line_to_band)
    max_mant = min(1 << cfg.n_mant_size_bits, cfg.max_mant_bits)
    # baseline budget: no Huffman table id field
    # (reference solution/codec_.py:84-87)
    budget = (cfg.target_bits_per_sample * half
              - cfg.n_scale_bits * (layout.n_bands + 1)
              - cfg.n_mant_size_bits * layout.n_bands)
    win = np.asarray(analysis_window(cfg.window, n), np.float32)

    c = cfg.n_channels

    def run(frames_i16: jax.Array, consts: dict):
        b = frames_i16.shape[0]
        frames = q_ops.pcm16_to_float(frames_i16)
        sw = frames * win[None, None, :]
        lines = mdct(sw, consts["basis"])
        overall = q_ops.scale_factor(
            jnp.max(jnp.abs(lines), axis=-1), cfg.n_scale_bits, 5)
        scaled = lines * jnp.exp2(overall[..., None].astype(lines.dtype))

        smr = psycho.calc_smrs(
            sw.reshape(b * c, n), scaled.reshape(b * c, half),
            overall.reshape(-1), fs, layout,
            consts=consts["psy"], peak_mode=cfg.peak_mode).reshape(b, c, -1)

        lrms = jnp.zeros((b * c, layout.n_bands), bool)
        bits, _ = ba_ops.water_fill(
            jnp.full(b * c, int(budget), jnp.int32), max_mant, n_lines,
            smr.reshape(b * c, -1), lrms,
            cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)
        bits = bits.reshape(b, c, -1)

        peak = psycho.band_max(jnp.abs(scaled), layout, fill=0.0)
        sf = q_ops.scale_factor(peak, cfg.n_scale_bits, bits)
        sf_l = sf[..., seg]
        nm_l = bits[..., seg]
        mant = q_ops.bfp_mantissa(scaled, sf_l, cfg.n_scale_bits, nm_l)
        return dict(overall=overall.astype(jnp.int8),
                    bits=bits.astype(jnp.int8), sf=sf.astype(jnp.int8),
                    mant=jnp.where(nm_l > 0, mant, 0),
                    nm_l=nm_l.astype(jnp.int8))

    return run


@lru_cache(maxsize=16)
def _encode_baseline_fn(cfg: CodecConfig):
    return jax.jit(encode_body_baseline(cfg))


@lru_cache(maxsize=16)
def decode_body(cfg: CodecConfig, precision: str = "f32"):
    """Pure traceable synthesis: quantized block arrays -> pre-overlap time
    samples; see `encode_body` for the jit/shard_map split."""
    layout = cfg.band_layout
    half = cfg.n_mdct_lines
    seg = np.asarray(layout.line_to_band)
    dt = _dtype(precision)
    win = np.asarray(analysis_window(cfg.window, 2 * half), dt)

    def run(ba: jax.Array, sf: jax.Array, mant: jax.Array,
            overall: jax.Array, lrms: jax.Array, consts: dict):
        """ba/sf: i32[B, 2, bands]; mant: i32[B, 2, half];
        overall: i32[B, 2]; lrms: bool[B, bands].
        Returns pre-overlap time samples f32[B, 2, 2*half]."""
        sf_l = sf[..., seg].astype(jnp.int32)
        nm_l = ba[..., seg].astype(jnp.int32)
        vals = q_ops.bfp_dequantize(sf_l, mant, cfg.n_scale_bits, nm_l,
                                    dtype=dt)
        vals = vals * jnp.exp2(-overall[..., None].astype(vals.dtype))

        if cfg.n_channels == 1:
            lines = vals                  # mono: no M/S reconstruction
        else:
            # Q1 aliasing: the reference decoder emits L' = M - S, R' = M
            # (reference codec/codec.py:46-56)
            line_ms = lrms[:, seg]
            m, s = vals[:, 0], vals[:, 1]
            out0 = jnp.where(line_ms, m - s, m)
            out1 = jnp.where(line_ms, m, s)
            lines = jnp.stack([out0, out1], axis=1)
        return imdct(lines, consts["basis"]) * win[None, None, :]

    return run


@lru_cache(maxsize=16)
def _decode_fn(cfg: CodecConfig, precision: str = "f32"):
    return jax.jit(decode_body(cfg, precision))


def _line_bit_offsets(ba_rows: jax.Array, layout):
    """Per-line bit offset/width of the packed mantissa codes, from the
    per-band allocations (`ba_rows` i32[rows, nb]).

    Widths are constant within a band, so the per-line offset is the
    band's exclusive bit cumsum plus line-in-band x width — a closed
    form over the 25 bands instead of a cumsum over the 1024 line lanes.
    Returns (off, width, total_bits): i32[rows, L] x2,
    i32[rows]."""
    seg = np.asarray(layout.line_to_band)
    n_lines = np.asarray(layout.n_lines_array, np.int32)
    line_in_band = np.concatenate(
        [np.arange(n, dtype=np.int32) for n in layout.n_lines])
    band_bits = ba_rows * n_lines[None, :]
    band_start = jnp.cumsum(band_bits, axis=-1) - band_bits
    width = ba_rows[:, seg]
    off = band_start[:, seg] + line_in_band[None, :] * width
    return off, width, jnp.sum(band_bits, axis=-1)


@lru_cache(maxsize=16)
def _chunk_decode_packed_fn(cfg: CodecConfig, n_words: int,
                            precision: str = "f32"):
    """Compact-upload chunk decoder: mantissa codes arrive as fixed-width
    MSB-first u32 word rows (native.repack_codes) instead of u16-per-line
    arrays — ~6x less host->device traffic.  Per-line bit offsets derive
    from ba alone (cumsum of band widths), and
    pactpu.ops.bitpack.extract_codes re-slices the codes on device.

    `(ba i8[B,2,nb], sf i8[B,2,nb], words u32[B,2,n_words],
    overall i8[B,2], lrms bool[B,nb], carry f32[2,half], consts)
    -> (pcm i16[B,2,half], carry')`."""
    body = decode_body(cfg, precision)
    half = cfg.n_mdct_lines
    c = cfg.n_channels

    def run(ba, sf, words, overall, lrms, carry, consts):
        b = ba.shape[0]
        ba_rows = ba.astype(jnp.int32).reshape(b * c, -1)
        off, width, _ = _line_bit_offsets(ba_rows, cfg.band_layout)
        mant = pack_ops.extract_codes(
            words.reshape(b * c, -1), off, width).reshape(b, c, half)
        td = body(ba.astype(jnp.int32), sf.astype(jnp.int32), mant,
                  overall.astype(jnp.int32), lrms, consts)
        first, second = td[:, :, :half], td[:, :, half:]
        prev_second = jnp.concatenate([carry[None], second[:-1]], axis=0)
        ola = prev_second + first
        return q_ops.float_to_pcm16(ola), second[-1]

    return jax.jit(run)


_WORD_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512)


@lru_cache(maxsize=16)
def _chunk_decode_flat_fn(cfg: CodecConfig, cap_words: int, n_words: int,
                          precision: str = "f32"):
    """Dense-upload chunk decoder: the mantissa words arrive as ONE flat
    u32[cap_words] buffer per chunk (rows compacted by their actual word
    counts, mirroring the encode-side dense download) instead of
    [rows, n_words] bucket-padded rows — rows average ~70 words, so the
    upload shrinks to the chunk total.  Row offsets derive from `ba` alone
    (identically on host and device), the rows re-expand with one gather,
    and extract_codes proceeds as in _chunk_decode_packed_fn."""
    body = decode_body(cfg, precision)
    half = cfg.n_mdct_lines
    c = cfg.n_channels

    def run(ba, sf, flat, overall, lrms, carry, consts):
        b = ba.shape[0]
        rows = b * c
        ba_rows = ba.astype(jnp.int32).reshape(rows, -1)
        off, width, total_bits = _line_bit_offsets(ba_rows,
                                                   cfg.band_layout)
        counts = jnp.minimum((total_bits + 31) // 32, n_words)
        row_off = jnp.cumsum(counts) - counts
        # re-expand rows with one CONTIGUOUS slice per row (a vmapped
        # dynamic_slice lowers to a strided-slice gather) rather than an
        # elementwise [rows, n_words] index gather.  The trailing zero pad
        # guarantees no row's slice is start-clamped (row_off <= cap);
        # words past a row's count belong to the NEXT row but are
        # harmless: only a field's final word can be over-read, and
        # those bits are always shifted out.
        flatp = jnp.concatenate(
            [flat, jnp.zeros(n_words, flat.dtype)])
        words = jax.vmap(
            lambda s: jax.lax.dynamic_slice(flatp, (s,), (n_words,)))(
                row_off)
        mant = pack_ops.extract_codes(words, off, width).reshape(b, c, half)
        td = body(ba.astype(jnp.int32), sf.astype(jnp.int32), mant,
                  overall.astype(jnp.int32), lrms, consts)
        first, second = td[:, :, :half], td[:, :, half:]
        prev_second = jnp.concatenate([carry[None], second[:-1]], axis=0)
        ola = prev_second + first
        return q_ops.float_to_pcm16(ola), second[-1]

    return jax.jit(run)


_PAYLOAD_WORD_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


@lru_cache(maxsize=16)
def _chunk_decode_payload_fn(cfg: CodecConfig, huff: bool,
                             precision: str = "f32"):
    """Fully device-native chunk decoder: the RAW payload word rows (the
    compressed bytes themselves, framed by pactpu.ops.huffman_decode.
    frame_rows) upload and the batched Huffman bit-walk + side-info parse
    run on device, chained straight into synthesis + overlap-add — no
    host parse, no repack, and ~2x less upload than the dense-word path
    (the raw payload vs fixed-width repacked codes).

    `(words u32[B*c, W], nbits i32[B*c], lut dict|None, carry f32[c,half],
    consts) -> (pcm i16[B, c, half], carry', bad bool[B*c])`; the engine
    folds `bad` into the single PCM fetch and raises like the host parser
    (reference codec/Huffman.py:321-344 corruption behavior)."""
    from pactpu.ops import huffman_decode as hd
    parse = hd.parse_rows_body(cfg, huff)
    body = decode_body(cfg, precision)
    half = cfg.n_mdct_lines
    c = cfg.n_channels

    def run(words, nbits, lut, carry, consts):
        p = parse(words, nbits, lut)
        b = words.shape[0] // c
        td = body(p["ba"].reshape(b, c, -1), p["sf"].reshape(b, c, -1),
                  p["mant"].reshape(b, c, half),
                  p["overall"].reshape(b, c),
                  p["lrms"].reshape(b, c, -1)[:, -1] != 0, consts)
        first, second = td[:, :, :half], td[:, :, half:]
        prev_second = jnp.concatenate([carry[None], second[:-1]], axis=0)
        ola = prev_second + first
        return q_ops.float_to_pcm16(ola), second[-1], p["bad"]

    return jax.jit(run)


@lru_cache(maxsize=16)
def _chunk_decode_fn(cfg: CodecConfig, precision: str = "f32"):
    """Compact-I/O chunk decoder: `(ba i8[B,2,nb], sf i8[B,2,nb],
    mant u16[B,2,half], overall i8[B,2], lrms bool[B,nb],
    carry f32[2,half], consts) -> (pcm i16[B,2,half], carry')`.

    Synthesis + in-chunk overlap-add + 16-bit PCM conversion all on device;
    `carry` chains the OLA across chunks (the decoder's overlapAndAdd
    state, reference codec/pacfile.py:223-226)."""
    body = decode_body(cfg, precision)
    half = cfg.n_mdct_lines

    def run(ba, sf, mant, overall, lrms, carry, consts):
        td = body(ba.astype(jnp.int32), sf.astype(jnp.int32),
                  mant.astype(jnp.int32), overall.astype(jnp.int32),
                  lrms, consts)
        first, second = td[:, :, :half], td[:, :, half:]
        prev_second = jnp.concatenate([carry[None], second[:-1]], axis=0)
        ola = prev_second + first
        return q_ops.float_to_pcm16(ola), second[-1]

    return jax.jit(run)


class DebugCheckError(RuntimeError):
    """Raised by Engine(debug_checks=True) when a device pass produces
    non-finite psychoacoustics or an out-of-range allocation (the build's
    jax.debug_nans analogue, SURVEY.md §5 — explicit finite checks work on
    every backend where debug_nans would disable compiler
    optimizations)."""


def _debug_check_encode(analyses, outs, max_mant: int, sizes) -> None:
    """Validate device encode outputs chunk by chunk; raises
    DebugCheckError naming the first offending chunk/block."""
    offs = _offsets(sizes)
    for k, a in enumerate(analyses):
        smr = np.asarray(a["smr"])
        if not np.isfinite(smr).all():
            blk = int(np.argwhere(~np.isfinite(smr))[0][0])
            raise DebugCheckError(
                f"non-finite SMR in chunk {k}, block {offs[k] + blk}")
    for k, o in enumerate(outs):
        bits = np.asarray(o["bits"])
        if bits.min(initial=0) < 0 or bits.max(initial=0) > max_mant:
            blk = int(np.argwhere((bits < 0) | (bits > max_mant))[0][0])
            raise DebugCheckError(
                f"allocation out of [0, {max_mant}] in chunk {k}, "
                f"block {offs[k] + blk}")
        if (bits == 1).any():
            blk = int(np.argwhere(bits == 1)[0][0])
            raise DebugCheckError(
                f"1-bit allocation escaped the refund (Q12) in chunk {k}, "
                f"block {offs[k] + blk}")


def _pad_blocks(b: int, cap: int = DEFAULT_CHUNK_BLOCKS) -> int:
    """Bucket the block count so jit specializations are reused: next power
    of two (min 16), capped at the streaming chunk size."""
    n = 16
    while n < b and n < cap:
        n <<= 1
    return min(n, cap)


def _prefetch_host_copies(arrays) -> None:
    """Start async device->host copies for a batch of arrays (jax.Array
    .copy_to_host_async) so later blocking np.asarray calls pipeline their
    transfers back to back instead of paying a link round trip each.
    Best-effort: backends without the PJRT async-copy hook just fall back
    to the synchronous fetch."""
    for a in arrays:
        if a is None:
            continue
        try:
            a.copy_to_host_async()
        except Exception:  # noqa: BLE001 — plugin-dependent, optional
            return


_TAIL_BUCKETS = (16, 32, 64, 96, 128, 192, 256, 384, 512)


def _offsets(sizes, scale: int = 1) -> list:
    """Exclusive prefix sum of `sizes` (times `scale`), length+1."""
    return list(itertools.accumulate((s * scale for s in sizes),
                                     initial=0))


def _chunk_sizes(b: int, chunk: int) -> list:
    """Per-chunk block counts for a b-block file: full `chunk`-sized
    chunks plus a bucketed tail (next size from _TAIL_BUCKETS, capped at
    `chunk`).

    The tail bucket keeps padded blocks off the host<->device link — with
    uniform 512-block chunks a 618-block file ships 1024 blocks of PCM
    upload, dense-payload download, code upload and device work; with a
    128-block tail it ships 640.
    Buckets bound the number of compiled program sizes, and the persistent
    compile cache amortizes them across files."""
    full = b // chunk
    sizes = [chunk] * full
    tail = b - full * chunk
    if tail:
        sizes.append(min(next((s for s in _TAIL_BUCKETS if s >= tail),
                              chunk), chunk))
    return sizes


@lru_cache(maxsize=16)
def _reservoir_scan_fn(cfg: CodecConfig):
    """Device replay of the reference reservoir policy over measured
    per-block (savings, leftover) — the same trajectory `_reservoir_extras`
    computes on the host, as a tiny `lax.scan` so the two-pass reservoir
    mode never downloads the measurement pass: the scan keeps the whole
    encode pipeline async until the payload download.

    `(savings i32[B, C], leftover i32[B], valid bool[B], carry i32[2])
    -> (extras f32[B], carry')`; carry = (bitDeposit, extraBits).
    Policy: reference codec/Huffman.py:353-371, codec/codec.py:229,258-260.
    """
    divisor = cfg.reservoir_withdraw_divisor

    def step(carry, x):
        deposit, extra = carry
        s, l, v = x
        w = jnp.where(deposit > 10, deposit // divisor, 0)
        neg = (deposit <= 10) & (deposit < 0)
        granted = extra + w + jnp.where(neg, deposit, 0)
        dep2 = jnp.where(deposit > 10, deposit - w,
                         jnp.where(neg, 0, deposit))
        new_carry = (jnp.where(v, dep2 + s, deposit).astype(jnp.int32),
                     jnp.where(v, l, extra).astype(jnp.int32))
        return new_carry, jnp.where(v, granted, 0)

    # 8 sequential policy steps per scan iteration: the math is a handful
    # of scalar ops, so a 512-trip scan is mostly loop overhead;
    # unrolling divides the trip count by 8 with bit-identical results
    # (chunk sizes are all multiples of 8)
    unroll = 8

    def step8(carry, xs):
        outs = []
        for j in range(unroll):
            carry, g = step(carry, (xs[0][j], xs[1][j], xs[2][j]))
            outs.append(g)
        return carry, jnp.stack(outs)

    def run(savings, leftover, valid, carry):
        b = valid.shape[0]
        pad = (-b) % unroll        # invalid steps are exact no-ops
        s = jnp.pad(jnp.sum(savings.astype(jnp.int32), axis=1),
                    (0, pad)).reshape(-1, unroll)
        le = jnp.pad(leftover.astype(jnp.int32), (0, pad)).reshape(
            -1, unroll)
        v = jnp.pad(valid, (0, pad)).reshape(-1, unroll)
        (dep, ext), extras = jax.lax.scan(
            step8, (carry[0], carry[1]), (s, le, v))
        return (extras.reshape(b + pad)[:b].astype(jnp.float32),
                jnp.stack([dep, ext]))

    return jax.jit(run)


def _reservoir_extras(savings: np.ndarray, leftover: np.ndarray,
                      divisor: int, deposit: int = 0, extra: int = 0):
    """Host replay of the reference reservoir policy over per-block pass-1
    measurements: deposit per-channel savings, withdraw 1/divisor per block
    (reference codec/Huffman.py:353-371), carry allocation leftovers
    (codec/codec.py:229,258-260).  Returns (extraBits for channel 0 of each
    block, final (deposit, extra) carry) — the carry is the encoder's entire
    sequential rate-control state, so a stream can checkpoint/resume at any
    block boundary (pactpu.codec.stream)."""
    b = savings.shape[0]
    extras = np.zeros(b, np.int64)
    for t in range(b):
        if deposit > 10:
            w = deposit // divisor
            deposit -= w
            extra += w
        elif deposit < 0:
            extra += deposit
            deposit = 0
        extras[t] = extra
        deposit += int(savings[t].sum())   # per-channel deposits, Q10
        extra = int(leftover[t])
    return extras, (deposit, extra)


class Engine:
    """File-level encoder/decoder around the jitted block engine.

    fmt="wak" is the full coder (Huffman + M/S + reservoir, the reference
    master branch); fmt="pac" is the baseline coder (independent L/R, raw
    mantissas — reference codec/solution/), which reads/writes the
    `coded/*.pac` golden artifacts.

    chunk_blocks fixes the device batch size (None = adapt up to
    DEFAULT_CHUNK_BLOCKS); all chunks of all files share one compiled
    program per size.
    """

    def __init__(self, cfg: Optional[CodecConfig] = None,
                 rate_mode: str = "reservoir", fmt: str = "wak",
                 chunk_blocks: Optional[int] = None,
                 device_pack: Optional[bool] = None,
                 precision: str = "f32", debug_checks: bool = False,
                 tables=None):
        if rate_mode not in ("cbr", "reservoir", "exact"):
            raise ValueError(f"unknown rate mode {rate_mode!r}")
        if fmt not in ("wak", "pac"):
            raise ValueError(f"unknown format {fmt!r}")
        if fmt == "pac" and rate_mode == "exact":
            raise ValueError("the baseline .pac coder has no reservoir")
        _dtype(precision)  # validate
        self.rate_mode = rate_mode
        self.fmt = fmt
        self.precision = precision
        self._consts_dev = None
        self.cfg = cfg or CodecConfig()   # validated property
        # debug_nans analogue (SURVEY.md §5): validate every encode pass
        # (finite SMRs, in-range allocations) at the cost of a blocking
        # fetch per chunk — a development switch, off on the hot path
        self.debug_checks = debug_checks
        # custom Huffman table set — the analogue of retraining the
        # reference's huffmanTables.pickle (codec/Huffman.py:197-203):
        # a path to an npz in the huffman_tables.npz layout (e.g. from
        # pactpu.ops.huffman_train.save_tables) or the 4-tuple of arrays
        # (lengths, codes, escape_lengths, escape_codes); None = shipped
        if isinstance(tables, str):
            z = np.load(tables)
            tables = (z["lengths"], z["codes"], z["escape_lengths"],
                      z["escape_codes"])
        self.tables = None if tables is None else tuple(
            np.ascontiguousarray(t, np.int32) for t in tables)
        if self.tables is not None:
            # the packed-length scheme carries 5-bit code lengths — refuse
            # tables the packer cannot represent (ADVICE round-1)
            if (int(self.tables[0].max(initial=0)) > 31
                    or int(self.tables[2].max(initial=0)) > 31):
                raise ValueError("Huffman code lengths > 31 bits cannot "
                                 "be packed")
            # a 0-bit escape code is unencodable: encode_select's cost
            # model would undercut every real table with it and the
            # decoder's bit-walk would never consume a bit
            if int(self.tables[2].min(initial=1)) < 1:
                raise ValueError("every Huffman table needs an escape code "
                                 "of length >= 1 (see huffman_train."
                                 "train_tables for the escape-only default)")
        self.chunk_blocks = chunk_blocks
        if device_pack is None:
            device_pack = not os.environ.get("PACTPU_NO_DEVICE_PACK")
        self.pack_words = PACK_WORDS if (device_pack and fmt == "wak") else 0
        # optional pactpu.utils.metrics.StageTimer: when set, encode/decode
        # record their host-side pipeline stages into it (the VERDICT
        # round-1 perf-breakdown contract; tools/perf_breakdown.py)
        self.timer = None
        # observability state (last_savings / last_measure / last_extras
        # properties): kept as DEVICE arrays and only fetched on first
        # access, so the hot encode path does not block on a fetch of
        # stats nobody reads
        self._savings_dev = None
        self._savings_np = None
        self._measure_dev = None
        self._measure_np = None
        self._extras_dev = None
        self._extras_np = None
        self._last_b = 0

    @property
    def cfg(self) -> CodecConfig:
        return self._cfg

    @cfg.setter
    def cfg(self, cfg: CodecConfig) -> None:
        """Replacing the config re-validates it against the engine's mode
        (callers adapt a constructed engine to an input file's sample
        rate/channel count — e.g. the CLI — and must not be able to skirt
        the constructor checks) and drops the device constant cache, which
        derives from the config."""
        if cfg.n_channels not in (1, 2):
            raise ValueError("n_channels must be 1 or 2")
        # exact mode supports mono: the trajectory is defined by the same
        # reservoir policy over the single channel chain; equality is
        # tested against the f64 oracle (which the reference ships no
        # mono golden artifacts for) — tests/test_exact_mode.py
        if cfg.alloc_mode not in ("water_fill", "closed_form", "uniform",
                                  "const_snr", "const_mnr"):
            raise ValueError(f"unknown alloc mode {cfg.alloc_mode!r}")
        if cfg.alloc_mode != "water_fill" and self.rate_mode == "exact":
            raise ValueError("exact mode reproduces the reference's "
                             "water-filling trajectory")
        if cfg.window not in ("sine", "kbd"):
            raise ValueError(f"unknown window {cfg.window!r}")
        if cfg.window != "sine" and self.rate_mode == "exact":
            raise ValueError("exact mode reproduces the reference's "
                             "sine-windowed trajectory")
        if cfg.ms_decision not in ("intensity", "bitalloc"):
            raise ValueError(f"unknown ms_decision {cfg.ms_decision!r}")
        if cfg.ms_decision != "intensity" and self.rate_mode == "exact":
            raise ValueError("exact mode reproduces the reference's "
                             "spectral-intensity M/S decisions")
        self._cfg = cfg
        self._consts_dev = None

    def consts(self) -> dict:
        """Device-resident constant tables (uploaded once per Engine)."""
        if self.precision == "f64" and not jax.config.jax_enable_x64:
            raise RuntimeError(
                "precision='f64' requires jax x64 (enable with "
                "jax.experimental.enable_x64() or JAX_ENABLE_X64=1)")
        if self._consts_dev is None:
            base = engine_consts_np(self.cfg, self.precision)
            if self.tables is not None:
                base = dict(base, tabs=self.tables)
            self._consts_dev = jax.device_put(base)
        return self._consts_dev

    def _chunk(self, b: int) -> int:
        return self.chunk_blocks or _pad_blocks(b)

    @property
    def last_savings(self):
        """Huffman bits saved by the last encode() (the reference driver's
        bits-saved readout, pacfile.py:439); fetched lazily."""
        if self._savings_dev is not None:
            self._savings_np = int(
                np.asarray(self._savings_dev)[:self._last_b].sum())
            self._savings_dev = None
        return self._savings_np

    @property
    def last_measure(self):
        """Measurement-pass (extraBits = 0) savings/leftover of the last
        reservoir-mode encode — the numbers that actually drove the
        reservoir scan, for exact stats reconstruction
        (pactpu.utils.metrics.collect_encode_stats); fetched lazily."""
        if self._measure_dev is not None:
            b = self._last_b
            self._measure_np = (
                np.concatenate([np.asarray(m["savings"])
                                for m in self._measure_dev])[:b],
                np.concatenate([np.asarray(m["leftover"])
                                for m in self._measure_dev])[:b])
            self._measure_dev = None
        return self._measure_np

    @property
    def last_extras(self):
        """Per-block extraBits granted by the last encode (any rate mode) —
        the trajectory observability tools/quality_report.py compares
        across rate modes; fetched lazily."""
        if self._extras_dev is not None:
            self._extras_np = np.concatenate(
                [np.asarray(e) for e in self._extras_dev])[:self._last_b]
            self._extras_dev = None
        return self._extras_np

    def _stage(self, name: str):
        """Timing scope for one pipeline stage (no-op without a timer).
        Dispatch stages measure enqueue time only (JAX is async); the
        blocking stages (downloads, host packing) absorb device time."""
        import contextlib
        return (self.timer.stage(name) if self.timer is not None
                else contextlib.nullcontext())

    # -- encode ----------------------------------------------------------

    def _encode_chunks(self, pcm: np.ndarray):
        """Upload each chunk's PCM once, run pass 1 (and the reservoir
        pass 2) with all dispatches enqueued asynchronously, and return
        (per-chunk device output dicts, n_blocks, device pcm chunks,
        extras, per-chunk sizes, staged dense payload) — callers download
        only the arrays they need.  The last chunk is tail-bucketed
        (_chunk_sizes) so padded blocks never ride the link, and the dense
        payload download buffer is staged here so batch callers can start
        its host copy early."""
        cfg = self.cfg
        half = cfg.n_mdct_lines
        if pcm.ndim != 2 or pcm.shape[1] != cfg.n_channels:
            raise ValueError(f"pcm must be [n, {cfg.n_channels}] int16, "
                             f"got {pcm.shape}")
        n_blocks = -(-pcm.shape[0] // half)
        b = n_blocks + 1                      # + flush block
        chunk = self._chunk(b)
        sizes = _chunk_sizes(b, chunk)
        offs = _offsets(sizes)
        b_pad = offs[-1]
        self._savings_dev = self._measure_dev = self._extras_dev = None
        self._savings_np = self._measure_np = self._extras_np = None
        self._last_b = b

        with self._stage("encode/upload-pcm"):
            glob = np.zeros((cfg.n_channels, (b_pad + 1) * half), np.int16)
            n = min(pcm.shape[0], b_pad * half)
            glob[:, half:half + n] = pcm[:n].T
            dev = [jnp.asarray(np.ascontiguousarray(
                       glob[:, offs[k] * half:(offs[k + 1] + 1) * half]))
                   for k in range(len(sizes))]

        consts = self.consts()

        # analysis (window+MDCT+psych model) runs ONCE per chunk; its
        # device-resident outputs feed both the reservoir measurement pass
        # and the final pass, so the reservoir mode pays only the cheap
        # alloc/quantize/Huffman tail twice
        analyze = _chunk_analyze_fn(cfg, self.precision)
        finalize = _finalize_fn(cfg, pack_words=self.pack_words,
                                precision=self.precision)
        with self._stage("encode/analyze-dispatch"):
            analyses = [analyze(d, consts) for d in dev]

        extras_chunks = [jnp.zeros(s, jnp.float32) for s in sizes]
        if self.rate_mode == "reservoir":
            # pass 1: measurement-only program (payload serialization
            # DCE'd), chained into the device reservoir scan — zero host
            # round trips; the measurement arrays are fetched lazily only
            # if somebody reads .last_measure
            measure = _finalize_fn(cfg, measure_only=True,
                                   precision=self.precision)
            scan = _reservoir_scan_fn(cfg)
            with self._stage("encode/measure+reservoir-dispatch"):
                carry = jnp.zeros(2, jnp.int32)
                extras_chunks, m_outs = [], []
                for k, a in enumerate(analyses):
                    m = measure(a, jnp.zeros(sizes[k], jnp.float32),
                                consts)
                    valid = jnp.arange(sizes[k]) < max(0, b - offs[k])
                    ex, carry = scan(m["savings"], m["leftover"], valid,
                                     carry)
                    extras_chunks.append(ex)
                    m_outs.append(m)
            self._measure_dev = m_outs
        elif self.rate_mode == "exact":
            # exact sequential trajectory: device cost tables + lax.scan,
            # zero host round trips (pactpu.codec.exact)
            from pactpu.codec import exact
            with self._stage("encode/exact-extras"):
                extras_chunks, _ = exact.exact_extras_chunked(
                    analyses, consts, cfg, self.precision, b)
        with self._stage("encode/finalize-dispatch"):
            outs = [finalize(a, ex, consts)
                    for a, ex in zip(analyses, extras_chunks)]
        if self.debug_checks:
            max_mant = min(1 << cfg.n_mant_size_bits, cfg.max_mant_bits)
            _debug_check_encode(analyses, outs, max_mant, sizes)
        self._extras_dev = extras_chunks
        # stage the dense payload download buffer (payload words compacted
        # to their actual sizes + nbits, ONE fetch per file) so batch
        # callers can start its device->host copy before they block
        dense_dev = None
        if outs and "words" in outs[0] and native.available():
            cap = b_pad * cfg.n_channels * PACK_DENSE_WORDS
            dense_dev = pack_ops.compact_rows(
                jnp.concatenate([o["words"] for o in outs]),
                jnp.concatenate([o["nbits"] for o in outs]), cap)
        return outs, b, analyses, extras_chunks, sizes, dense_dev

    def _chunk_payload(self, out, analysis, extra_chunk: np.ndarray,
                       n_blocks: int) -> bytes:
        """Payload bytes for one chunk's first n_blocks blocks.

        A chunk whose measured nbits overflow the narrow device packer is
        re-finalized from its device-resident analysis with the wide packer
        (payloads legitimately spike after quiet passages — reference
        leftover chaining, codec/codec.py:229); past even that, the host
        serial packer."""
        if "words" in out:
            nbits = np.asarray(out["nbits"])[:self.cfg.n_channels * n_blocks]
            need = -(-int(nbits.max(initial=0)) // 32)
            if need > out["words"].shape[1]:
                # smallest wide bucket that fits (few buckets -> few
                # compiled specializations; download scales with the bucket)
                wide_words = next((w for w in (192, 256, 384, PACK_WORDS_MAX)
                                   if w >= need), 0)
                wide = _finalize_fn(self.cfg, pack_words=wide_words,
                                    precision=self.precision)
                out = wide(analysis, jnp.asarray(extra_chunk), self.consts())
        return self.pack_payload(out, n_blocks)

    def encode_arrays(self, pcm: np.ndarray):
        """pcm: int16 [n, 2] -> (host outputs dict, n_blocks)."""
        outs, b, _, _, _, _ = self._encode_chunks(pcm)
        out = {k: np.concatenate([np.asarray(o[k]) for o in outs])
               for k in outs[0]}
        return out, b

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm: int16 [n, 2] -> complete .wak/.pac byte stream."""
        cfg = self.cfg
        n_lines = np.asarray(cfg.band_layout.n_lines, np.int32)
        header, _ = rc.write_header(cfg, pcm.shape[0])

        c = cfg.n_channels
        if self.fmt == "pac":
            out, b = self._encode_arrays_baseline(pcm)
            h = lambda k: np.asarray(out[k])[:b]  # noqa: E731
            r2 = lambda a: a.reshape(c * b, *a.shape[2:])  # noqa: E731
            zeros_l = np.zeros((c * b, int(n_lines.sum())), np.int32)
            payload = native.pack_file(
                n_lines, cfg.n_scale_bits, cfg.n_mant_size_bits, 0,
                r2(h("overall")), r2(h("overall")) * 0, r2(h("bits")),
                r2(h("sf")), zeros_l, r2(h("mant")), r2(h("nm_l")),
                np.zeros((b, cfg.n_bands), np.int32), write_lrms=False,
                n_channels=c)
            return header + payload

        outs, b, analyses, extras_chunks, sizes, dense = \
            self._encode_chunks(pcm)
        return header + self._finish_encode(outs, analyses, extras_chunks,
                                            b, sizes, dense)

    def encode_many(self, pcms) -> list:
        """Throughput-oriented batch encode: every file's device pipeline
        is dispatched (async) before any payload download blocks, so the
        device->host transfers overlap the other files' device compute.
        This is the production serving path for many-file workloads;
        device memory holds all staged files, so batch accordingly (a
        512-block chunk holds ~6 MB of analysis).
        Observability properties reflect the LAST file of the batch."""
        if self.fmt == "pac":
            return [self.encode(p) for p in pcms]
        staged = []
        for pcm in pcms:
            header, _ = rc.write_header(self.cfg, pcm.shape[0])
            staged.append((header, self._encode_chunks(pcm)))
        _prefetch_host_copies(st[5] for _, st in staged)
        return [header
                + self._finish_encode(outs, analyses, extras, b, sz, dense)
                for header, (outs, b, analyses, extras, sz, dense)
                in staged]

    def roundtrip_many(self, pcms, return_streams: bool = False):
        """Fully pipelined many-file encode->decode — the production
        serving path for roundtrip/transcode workloads: it overlaps each
        file's blocking fetches with the other files' device work.

        Schedule: every file's encode pipeline is dispatched up front
        (async); then file k's payload download (blocking) runs while
        files k+1..n compute their encodes on device, and file k's decode
        dispatch (uploads + synthesis compute) overlaps file k+1's payload
        download; finally the PCM downloads drain in order.  Unlike
        `decode_many(encode_many(...))`, no decode waits for ALL encodes
        to finish downloading.

        Returns [(sample_rate, pcm), ...]; with return_streams=True,
        ([(fs, pcm), ...], [stream bytes, ...]).  Device memory holds every
        staged file (see encode_many); results are byte/sample-identical
        to serial encode()/decode() calls."""
        if self.fmt == "pac":
            streams = [self.encode(p) for p in pcms]
            results = [self.decode(s) for s in streams]
            return (results, streams) if return_streams else results
        staged = []
        for pcm in pcms:
            header, _ = rc.write_header(self.cfg, pcm.shape[0])
            staged.append((header, self._encode_chunks(pcm)))
        # start the payload device->host copies for EVERY file before the
        # first blocking fetch: the link pipelines transfers back to back
        # instead of paying a round trip between files
        _prefetch_host_copies(st[5] for _, st in staged)
        streams, dec_staged = [], []
        for header, (outs, b, analyses, extras, sz, dense) in staged:
            stream = header + self._finish_encode(outs, analyses, extras,
                                                  b, sz, dense)
            streams.append(stream)
            dec_staged.append(self._decode_dispatch(stream))
        # same for the decoded-PCM buffers
        _prefetch_host_copies(s[-1] for s in dec_staged)
        results = [self._decode_finish(*s) for s in dec_staged]
        return (results, streams) if return_streams else results

    def _finish_encode(self, outs, analyses, extras_chunks, b: int,
                       sizes, dense_dev=None) -> bytes:
        """Blocking half of a wak encode: payload download + assembly."""
        parts = []
        if outs and "words" in outs[0]:
            parts.append(self._payload_device_packed(
                outs, analyses, extras_chunks, b, sizes, dense_dev))
        else:
            done = 0
            for o, a, ex, sz in zip(outs, analyses, extras_chunks, sizes):
                nb = min(sz, b - done)
                if nb <= 0:
                    break
                with self._stage("encode/payload-download+assemble"):
                    parts.append(self._chunk_payload(o, a, ex, nb))
                done += nb
        # observability: Huffman savings of the encoded stream (the
        # reference driver's bits-saved readout, pacfile.py:439); the
        # device concat is enqueued async and only fetched if read
        self._savings_dev = jnp.concatenate([o["savings"] for o in outs])
        return b"".join(parts)

    def _payload_device_packed(self, outs, analyses, extras_chunks,
                               b: int, sizes, dense_dev=None) -> bytes:
        """Assemble the payload from device-packed word rows with ONE
        blocking download for the whole file.

        The download is DENSE: rows are compacted by their actual word
        counts (pactpu.ops.bitpack.compact_rows) into a buffer sized
        PACK_DENSE_WORDS per row ON AVERAGE (chunk totals absorb per-row
        spikes that would overflow a per-row width), with nbits appended.
        Fallbacks, outermost first: dense-total overflow -> padded rows
        download; per-row overflow of the narrow packer -> that chunk is
        re-finalized with a wide packer; no native runtime -> padded rows
        + python framing."""
        c = self.cfg.n_channels
        width = outs[0]["words"].shape[1]
        row_offs = _offsets(sizes, scale=c)
        rows_all = row_offs[-1]
        words_all = None                   # padded rows (fallback only)
        use_dense = native.available()
        with self._stage("encode/words-download"):
            if use_dense:
                cap = rows_all * PACK_DENSE_WORDS
                if dense_dev is None:
                    dense_dev = pack_ops.compact_rows(
                        jnp.concatenate([o["words"] for o in outs]),
                        jnp.concatenate([o["nbits"] for o in outs]), cap)
                dn = np.asarray(dense_dev)
                nbits_all = dn[cap:].astype(np.int32)
                counts = np.minimum((nbits_all + 31) // 32, width)
                offsets = np.concatenate(
                    [[0], np.cumsum(counts[:-1])]).astype(np.int32)
                if int(counts.sum()) > cap:
                    use_dense = False      # dense overflow: padded rows
                else:
                    dense = dn[:cap]
            if not use_dense:
                wn = np.asarray(jnp.concatenate(
                    [jnp.concatenate(
                        [o["words"],
                         o["nbits"].astype(jnp.uint32)[:, None]], axis=1)
                     for o in outs]))
                nbits_all = wn[:, -1].astype(np.int32)
                words_all = wn[:, :-1]
        parts = []
        done = 0
        for k, (a, ex) in enumerate(zip(analyses, extras_chunks)):
            nb = min(sizes[k], b - done)
            if nb <= 0:
                break
            rows = slice(row_offs[k], row_offs[k] + c * nb)
            nb_rows = nbits_all[rows]
            need = -(-int(nb_rows.max(initial=0)) // 32)
            with self._stage("encode/payload-assemble"):
                if need > width:
                    # rare post-quiet spike beyond even PACK_WORDS
                    wide_words = next(
                        (w for w in (384, PACK_WORDS_MAX) if w >= need), 0)
                    wide = _finalize_fn(self.cfg, pack_words=wide_words,
                                        precision=self.precision)
                    wout = wide(a, jnp.asarray(ex), self.consts())
                    parts.append(self.pack_payload(
                        {kk: wout[kk] for kk in ("words", "nbits")}, nb))
                elif use_dense:
                    parts.append(native.assemble_rows_flat(
                        dense, offsets[rows], nb_rows))
                else:
                    parts.append(self._assemble_device_packed(
                        words_all[rows], nb_rows, c * nb))
            done += nb
        return b"".join(parts)

    def _assemble_device_packed(self, words: np.ndarray, nbits: np.ndarray,
                                rows: int) -> bytes:
        """Slice big-endian bytes per channel-block and prepend the uint32
        length prefix (reference pacfile.py:314-322)."""
        words = np.ascontiguousarray(words[:rows])
        nbits = np.asarray(nbits[:rows], np.int32)
        if native.available():
            return native.assemble_rows(words, nbits)
        nbytes = (nbits.astype(np.int64) + 7) // 8
        row_bytes = words.astype(">u4").tobytes()
        stride = words.shape[1] * 4
        parts = []
        for r in range(rows):
            nb = int(nbytes[r])
            parts.append(struct.pack("<L", nb))
            parts.append(row_bytes[r * stride:r * stride + nb])
        return b"".join(parts)

    def pack_payload(self, out, b: int) -> bytes:
        """Serialize encode outputs (fmt='wak') to the payload bytes."""
        cfg = self.cfg
        c = cfg.n_channels
        if "words" in out:
            return self._assemble_device_packed(
                np.asarray(out["words"]), np.asarray(out["nbits"]), c * b)
        n_lines = np.asarray(cfg.band_layout.n_lines, np.int32)
        h = lambda k: np.asarray(out[k])[:b]  # noqa: E731
        r2 = lambda a: a.reshape(c * b, *a.shape[2:])  # noqa: E731
        return native.pack_file(
            n_lines, cfg.n_scale_bits, cfg.n_mant_size_bits,
            cfg.n_table_id_bits,
            r2(h("overall")), r2(h("tid")), r2(h("bits")), r2(h("sf")),
            r2(h("sign")), r2(h("codes")), r2(h("lens")),
            h("lrms").astype(np.int32), n_channels=c)

    def _encode_arrays_baseline(self, pcm: np.ndarray):
        cfg = self.cfg
        half = cfg.n_mdct_lines
        self._savings_dev = self._measure_dev = self._extras_dev = None
        self._savings_np = self._measure_np = self._extras_np = None
        n_blocks = -(-pcm.shape[0] // half)
        b = n_blocks + 1
        chunk = self._chunk(b)
        b_pad = -(-b // chunk) * chunk
        frames = frame_blocks_np(pcm, half, b_pad)
        run = _encode_baseline_fn(cfg)
        consts = self.consts()
        outs = [run(jnp.asarray(frames[i:i + chunk]), consts)
                for i in range(0, b_pad, chunk)]
        out = {k: np.concatenate([np.asarray(o[k]) for o in outs])
               for k in outs[0]}
        return out, b

    # -- decode ----------------------------------------------------------

    def decode(self, data: bytes) -> tuple[int, np.ndarray]:
        """Full stream -> (sample_rate, int16 [n, C]), reproducing the
        reference driver's first-block skip and final overlap-add flush
        (reference codec/pacfile.py:484-487, 171-178), trimmed to the
        header's numSamples (the length the reference's decoded WAV
        declares, pacfile.py:231-271 incl. the Q6 padding quirk)."""
        return self._decode_finish(*self._decode_dispatch(data))

    def decode_range(self, data: bytes, start_sample: int,
                     num_samples: int) -> tuple[int, np.ndarray]:
        """Random-access decode: (sample_rate, int16 [n, C]) for the
        sample window [start_sample, start_sample + num_samples) WITHOUT
        decoding the rest of the stream.

        The per-channel-block nBytes prefixes make .pac/.wak streams
        seekable (reference codec/pacfile.py:170-183, a property the
        reference never exploits — its driver always decodes whole
        files): the host scans prefixes to the needed coded-block range,
        slices those payload bytes, and every existing chunk decoder
        (host-parse, device-parse, any format/layout) runs on the slice.
        Audio block i needs frames [i, i+1] (output block i = OLA of
        frame i's second half and frame i+1's first half), so a window
        parses ceil(window/1024) + 1 coded blocks regardless of file
        length.  Each frame runs in a chunk program of the same shape as
        in decode() (zero blocks pad the window to the full decode's
        chunk sizes), so the output equals the same slice of a full
        decode() exactly, also on backends whose matmul rounding depends
        on the row count."""
        cfg, total_samples, off = rc.read_header(data)
        half = cfg.n_mdct_lines
        c = cfg.n_channels
        # the window is the INTERSECTION of [start, start + num) with the
        # stream: a negative start clips, it does not extend
        s0 = max(0, int(start_sample))
        s1 = min(int(total_samples),
                 int(start_sample) + max(0, int(num_samples)))
        if s1 <= s0:
            return cfg.sample_rate, np.zeros((0, c), np.int16)

        # scan the nBytes prefixes up to the last frame the window needs
        payload = data[off:]
        i0, i1 = s0 // half, (s1 - 1) // half      # audio block range
        spans = []                                  # per-FRAME byte spans
        pos = 0
        frame = 0
        while pos < len(payload):
            start = pos
            for _ in range(c):
                if pos + 4 > len(payload):
                    raise ValueError("truncated channel-block header")
                nb = int.from_bytes(payload[pos:pos + 4], "little")
                pos += 4 + nb
                if pos > len(payload):
                    raise ValueError("corrupt payload: channel-block "
                                     "length exceeds the stream")
            spans.append((start, pos))
            frame += 1
            if frame > i1 + 1:
                break
        b = frame if pos >= len(payload) else None  # known only if scanned
        last = len(spans) - 1                       # last scanned frame
        f0 = min(i0, last)
        f1 = min(i1 + 1, last)
        at_eof = f1 == last and (b is not None and last == b - 1)

        # the chunk layout decode() runs this stream at (frame count from
        # the header when the scan stopped early: numSamples + the flush)
        b_full = b if b is not None else -(-int(total_samples) // half) + 1
        full_sizes = _chunk_sizes(b_full, self._chunk(b_full))
        full_offs = _offsets(full_sizes)
        layout = None
        if f1 < full_offs[-1]:
            k0 = bisect.bisect_right(full_offs, f0) - 1
            k1 = bisect.bisect_right(full_offs, f1) - 1
            layout = (full_sizes[k0:k1 + 1], f0 - full_offs[k0])

        header, _ = rc.write_header(cfg, total_samples)
        mini = header + payload[spans[f0][0]:spans[f1][1]]
        (mcfg, _, mb, mc, sizes, _offs, runs,
         chunk_args) = self._decode_staging(mini, layout)
        lead = layout[1] if layout else 0
        assert mb == lead + f1 - f0 + 1 and mc == c
        consts = self.consts()
        pcm_chunks, bad_chunks = [], []
        carry = jnp.zeros((c, half), _dtype(self.precision))
        for k in range(len(sizes)):
            args = [a if (a is None or isinstance(a, dict))
                    else jnp.asarray(a) for a in chunk_args[k]]
            res = runs[k](*args, carry, consts)
            pcm_chunks.append(res[0])
            carry = res[1]
            if len(res) > 2:
                bad_chunks.append(res[2])
        tail = q_ops.float_to_pcm16(carry)[None]
        ola = np.asarray(jnp.concatenate(pcm_chunks + [tail])[:mb + 1])
        if bad_chunks:
            bad = np.asarray(jnp.concatenate(bad_chunks))[:mb * c]
            if bad.any():
                raise ValueError(
                    f"corrupt payload at channel-block "
                    f"{(f0 - lead) * c + int(np.argmax(bad))}")
        # row lead+t = OLA of frames f0+t-1, f0+t -> audio block f0+t-1;
        # row `lead` lacks its true carry and is dropped (same as the
        # whole-file decoder's first-block skip); the tail row is the
        # final flush, valid only at end of stream
        rows = ola[lead + 1:mb + (1 if at_eof else 0)]
        audio = rows.transpose(1, 0, 2).reshape(c, -1).T
        base = f0 * half
        return cfg.sample_rate, audio[s0 - base:s1 - base].copy()

    def decode_many(self, datas) -> list:
        """Throughput-oriented batch decode: parse/upload/dispatch every
        stream before any PCM download blocks (see encode_many)."""
        staged = [self._decode_dispatch(d) for d in datas]
        _prefetch_host_copies(s[-1] for s in staged)
        return [self._decode_finish(*s) for s in staged]

    def _chunk_layout(self, b: int, layout=None):
        """(sizes, offs, lead) of a b-block decode: the chunk sizes it runs
        at and the zero blocks ahead of the first real one.  `layout` =
        (sizes, lead) overrides the default (decode_range reuses the full
        stream's chunk shapes)."""
        sizes, lead = layout or (_chunk_sizes(b, self._chunk(b)), 0)
        return list(sizes), _offsets(sizes), lead

    def _decode_staging(self, data: bytes, layout=None):
        """Host half of a decode dispatch: frame (or parse) the stream and
        select the chunk programs — everything up to (but not including)
        the device uploads.  Split out so the device-compute benchmark
        (pactpu.utils.devbench) can iterate the exact programs
        `_decode_dispatch` runs on device-resident inputs.

        Returns (cfg, num_samples, b, c, sizes, offs, runs, chunk_args):
        `runs[k](*chunk_args[k] uploaded, carry, consts)` -> (pcm16,
        carry'[, bad]); b counts the real blocks plus the leading zero
        blocks of `layout` (see _chunk_layout).

        Parse placement (PACTPU_DECODE_PARSE = auto | device | host):
        "device" runs the Huffman bit-walk on the accelerator as the
        batched XLA gather walk (pactpu.ops.huffman_decode) — the raw
        compressed payload is the upload and the host only frames byte
        rows; "host" parses in native C++ (csrc/wakbits.cc) and uploads
        the parsed arrays.  auto = host whenever the native library is
        available; without it (PACTPU_NO_NATIVE) auto falls back to the
        device walk."""
        cfg, num_samples, off = rc.read_header(data)
        if cfg.window != self.cfg.window:
            # the stream format carries no window field; synthesis follows
            # this engine's configured window (README: "kbd" streams are a
            # flag-gated extension decoded by a window="kbd" engine)
            import dataclasses
            cfg = dataclasses.replace(cfg, window=self.cfg.window)
        huff = self.fmt == "wak"

        parse_env = os.environ.get("PACTPU_DECODE_PARSE", "auto")
        if parse_env not in ("auto", "device", "host"):
            raise ValueError(f"PACTPU_DECODE_PARSE={parse_env!r}: "
                             "expected auto, device or host")
        want_device = parse_env == "device" or (
            parse_env == "auto" and not native.available())
        if want_device:
            staged = self._decode_staging_device_parse(
                data, off, cfg, num_samples, huff, layout)
            if staged is not None:
                return staged
            if parse_env == "device":
                raise ValueError(
                    "PACTPU_DECODE_PARSE=device: this stream/table set "
                    "does not fit the device parser (oversized rows or "
                    "Huffman codes beyond the LUT cap)")
        return self._decode_staging_host_parse(
            data, off, cfg, num_samples, huff, layout)

    def _decode_staging_device_parse(self, data: bytes, off: int, cfg,
                                     num_samples: int, huff: bool,
                                     layout=None):
        """Stage a device-parse decode: frame the raw payload into word
        rows; the chunk program does everything else.  Returns None when
        the stream/table set needs the host parser (rows wider than the
        largest bucket, or code lengths past the LUT cap)."""
        from pactpu.ops import huffman_decode as hd
        c = cfg.n_channels
        lut = None
        if huff:
            lut = hd.device_lut(self.tables)
            if lut is None:
                return None
        with self._stage("decode/frame-rows"):
            words, nbits = hd.frame_rows(
                data[off:], word_cap=_PAYLOAD_WORD_BUCKETS[-1])
        if words is None:
            return None
        rows = words.shape[0]
        if rows % c:
            raise ValueError(
                f"corrupt payload: {rows} channel-blocks for "
                f"{c} channels")
        w_bucket = next(w for w in _PAYLOAD_WORD_BUCKETS
                        if w >= words.shape[1])
        sizes, offs, lead = self._chunk_layout(rows // c, layout)
        b = lead + rows // c
        b_pad = offs[-1]
        # empty rows (nbits 0) pad: they parse to zeros and never flag
        words = np.pad(words, ((lead * c, (b_pad - b) * c),
                               (0, w_bucket - words.shape[1])))
        nbits = np.pad(nbits, (lead * c, (b_pad - b) * c))

        run = _chunk_decode_payload_fn(cfg, huff, self.precision)
        chunk_args = []
        for k, sz in enumerate(sizes):
            i, j = offs[k] * c, (offs[k] + sz) * c
            chunk_args.append((words[i:j], nbits[i:j], lut))
        return (cfg, num_samples, b, c, sizes, offs,
                [run] * len(sizes), chunk_args)

    def _decode_staging_host_parse(self, data: bytes, off: int, cfg,
                                   num_samples: int, huff: bool,
                                   layout=None):
        """Stage a host-parse decode (native C++ bit-walk + quantized-array
        or packed-word uploads)."""
        c = cfg.n_channels
        with self._stage("decode/parse-native"):
            parsed = native.unpack_file(
                data[off:], np.asarray(cfg.band_layout.n_lines, np.int32),
                cfg.n_scale_bits, cfg.n_mant_size_bits,
                cfg.n_table_id_bits if huff else 0, read_lrms=huff,
                n_channels=c, tables=self.tables)
        sizes, offs, lead = self._chunk_layout(parsed["n_cblocks"] // c,
                                               layout)
        b = lead + parsed["n_cblocks"] // c
        b_pad = offs[-1]

        def d2(a, pad_value=0):
            """Per channel-block rows -> [b_pad, c, ...] with the zero
            blocks of the layout ahead of and behind the real ones."""
            a = a.reshape(b - lead, c, *a.shape[1:])
            if b_pad > b - lead:
                pad = [(lead, b_pad - b)] + [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, pad, constant_values=pad_value)
            return a

        # compact upload dtypes: ba/sf/overall fit int8, mantissa codes
        # fit uint16 (<= 16 bits incl. sign), lrms is bool
        ba = d2(parsed["ba"]).astype(np.int8)
        sf = d2(parsed["sf"]).astype(np.int8)
        overall = d2(parsed["overall"]).astype(np.int8)
        lrms = parsed["lrms"] != 0
        if b_pad > b - lead:
            lrms = np.pad(lrms, ((lead, b_pad - b), (0, 0)))

        # mantissa upload form (PACTPU_DECODE_UPLOAD): "u16" (default)
        # uploads one u16 per line; "dense" uploads the codes repacked
        # into fixed-width words (~6x less host->device traffic), which
        # pactpu.ops.bitpack.extract_codes re-slices on device
        packed = (native.available()
                  and os.environ.get("PACTPU_DECODE_UPLOAD") == "dense")
        if packed:
            # On top of the word rows, rows compact into ONE flat buffer
            # per chunk (sized by the chunk TOTAL, ~70 words/row avg)
            # whenever they fit — mirroring the encode-side dense
            # download.
            with self._stage("decode/repack-native"):
                n_lines = np.asarray(cfg.band_layout.n_lines, np.int64)
                rowbits = (parsed["ba"] * n_lines[None, :]).sum(1)
                max_bits = int(rowbits.max(initial=0))
                n_words = next(
                    (w for w in _WORD_BUCKETS if w * 32 >= max_bits),
                    -(-max_bits // 32))
                rows_pad = native.repack_codes(
                    parsed["mant"], parsed["ba"],
                    np.asarray(cfg.band_layout.n_lines, np.int32), n_words)
                counts = np.minimum((rowbits + 31) // 32, n_words)
                # chunk-aligned views: the layout's leading zero rows
                rows_l = np.pad(rows_pad, ((lead * c, 0), (0, 0)))
                counts_l = np.pad(counts, (lead * c, 0))
                col = np.arange(n_words)[None, :]
                mant_chunks = []
                for k, sz in enumerate(sizes):
                    rpc = sz * c                # rows in this chunk
                    i = offs[k] * c
                    cap_k = rpc * PACK_DENSE_WORDS
                    cc = counts_l[i:i + rpc]
                    if int(cc.sum()) > cap_k:
                        mant_chunks = None      # dense overflow: padded rows
                        break
                    flat = rows_l[i:i + rpc][col < cc[:, None]]
                    mant_chunks.append(np.pad(
                        np.ascontiguousarray(flat, np.uint32),
                        (0, cap_k - flat.shape[0])))
            if mant_chunks is not None:
                runs = [_chunk_decode_flat_fn(
                            cfg, sz * c * PACK_DENSE_WORDS, n_words,
                            self.precision) for sz in sizes]
            else:
                # rows_pad is [n_cblocks, n_words] — d2 reshapes/pads it
                # to [b_pad, c, n_words] (the double-reshape that used to
                # sit here crashed the dense-overflow fallback)
                mant = d2(rows_pad)
                mant_chunks = [mant[offs[k]:offs[k] + sz]
                               for k, sz in enumerate(sizes)]
                runs = [_chunk_decode_packed_fn(cfg, n_words,
                                                self.precision)] * len(sizes)
        else:
            mant = d2(parsed["mant"]).astype(np.uint16)
            mant_chunks = [mant[offs[k]:offs[k] + sz]
                           for k, sz in enumerate(sizes)]
            runs = [_chunk_decode_fn(cfg, self.precision)] * len(sizes)
        chunk_args = []
        for k, sz in enumerate(sizes):
            i, j = offs[k], offs[k] + sz
            chunk_args.append((ba[i:j], sf[i:j], mant_chunks[k],
                               overall[i:j], lrms[i:j]))
        return cfg, num_samples, b, c, sizes, offs, runs, chunk_args

    def _decode_dispatch(self, data: bytes):
        """Async half of decode: stage, upload, dispatch; returns the
        staged state for `_decode_finish` without blocking on device
        results."""
        (cfg, num_samples, b, c, sizes, _offs, runs,
         chunk_args) = self._decode_staging(data)
        half = cfg.n_mdct_lines
        consts = self.consts()
        pcm_chunks, bad_chunks = [], []
        carry = jnp.zeros((c, half), _dtype(self.precision))
        with self._stage("decode/upload+dispatch"):
            for k in range(len(sizes)):
                args = [a if (a is None or isinstance(a, dict))
                        else jnp.asarray(a) for a in chunk_args[k]]
                res = runs[k](*args, carry, consts)
                pcm_chunks.append(res[0])
                carry = res[1]
                if len(res) > 2:
                    bad_chunks.append(res[2])
            # the final-flush half (reference pacfile.py:171-178) is the
            # carry when every block was real, else the OLA of the first
            # padded block — appending the carry row on device unifies
            # both and keeps the download a SINGLE fetch
            tail = q_ops.float_to_pcm16(carry)[None]
            rows = pcm_chunks + [tail]
            rows = [jnp.concatenate(rows)[:b + 1]]
            if bad_chunks:
                # device-parse corruption flags ride the SAME fetch as the
                # PCM: one extra row carrying (any_bad, first_bad_row)
                bad = jnp.concatenate(bad_chunks)[:b * c]
                flags = jnp.zeros((1, c, half), jnp.int16)
                flags = flags.at[0, 0, 0].set(
                    bad.any().astype(jnp.int16))
                flags = flags.at[0, 0, 1].set(jnp.minimum(
                    jnp.argmax(bad), 32767).astype(jnp.int16))
                rows.append(flags)
            ola_dev = jnp.concatenate(rows) if len(rows) > 1 else rows[0]
        return cfg, num_samples, b, c, bool(bad_chunks), ola_dev

    def _decode_finish(self, cfg, num_samples, b, c, has_flags, ola_dev):
        """Blocking half of decode: the single PCM fetch + reshaping."""
        with self._stage("decode/download"):
            ola = np.asarray(ola_dev)
        if has_flags:
            flags = ola[-1]
            if flags[0, 0]:
                raise ValueError(
                    f"corrupt payload at channel-block {int(flags[0, 1])}")
            ola = ola[:-1]
        # reference driver: drop block 0 (MDCT delay), keep the flush row
        audio = ola[1:b + 1]
        pcm = audio.transpose(1, 0, 2).reshape(c, -1).T[:num_samples].copy()
        return cfg.sample_rate, pcm

"""Observability: structured per-block encode statistics and profiling.

The reference's observability is print statements — bits saved via
`Huffman.getBitDeposit` (reference codec/pacfile.py:439), a `'*'`
starvation warning (codec/bitalloc.py:178), and matplotlib masking plots on
block 1 (codec/psychoac.py:524-528).  Here the engine's device outputs are
reduced into one structured `EncodeStats` object — per-block bit usage,
Huffman savings, reservoir trajectory, stereo-coding decisions, table
selection — and `device_trace` wraps `jax.profiler` for XLA-level traces
(SURVEY.md §5 tracing/metrics).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class EncodeStats:
    """Per-block encode statistics (arrays of length n_blocks)."""

    n_blocks: int
    bits_per_channel: np.ndarray     # i64[B, 2] payload bits (side info incl.)
    huffman_savings: np.ndarray      # i64[B, 2] raw - coded mantissa bits
    alloc_leftover: np.ndarray       # i64[B] unspent budget after channel 1
    reservoir_deposit: np.ndarray    # i64[B] bitDeposit before block t
    extra_bits: np.ndarray           # i64[B] extraBits granted to block t
    ms_band_fraction: np.ndarray     # f64[B] fraction of bands coded M/S
    table_id: np.ndarray             # i8[B, 2] selected Huffman table
    mant_bits_band: np.ndarray       # f64[2, n_bands] mean mantissa bits
    sample_rate: int
    n_mdct_lines: int

    def summary(self) -> Dict[str, float]:
        """Aggregate view, one flat dict (JSON-friendly)."""
        bits = self.bits_per_channel.sum()
        dur_s = self.n_blocks * self.n_mdct_lines / self.sample_rate
        tids, counts = np.unique(self.table_id, return_counts=True)
        return {
            "n_blocks": int(self.n_blocks),
            "total_payload_bits": int(bits),
            "mean_kbps": float(bits / max(dur_s, 1e-9) / 1000.0),
            "huffman_bits_saved": int(self.huffman_savings.sum()),
            "huffman_saving_pct": float(
                100.0 * self.huffman_savings.sum()
                / max(bits + self.huffman_savings.sum(), 1)),
            "mean_ms_band_fraction": float(self.ms_band_fraction.mean()),
            "reservoir_peak_bits": int(self.reservoir_deposit.max(initial=0)),
            "extra_bits_granted": int(self.extra_bits.sum()),
            "table_usage": {int(t): int(c) for t, c in zip(tids, counts)},
        }

    def to_json(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)


def collect_encode_stats(out: Dict[str, np.ndarray], n_blocks: int,
                         cfg, measure=None) -> EncodeStats:
    """Build EncodeStats from `Engine.encode_arrays` output.

    Works with both the device-packed output (words/nbits carry exact
    payload bits) and the host-pack output (bits reconstructed from the
    allocation + code lengths).

    measure: optional (savings, leftover) from the engine's reservoir
    measurement pass (`Engine.last_measure`) — the extraBits = 0 numbers
    that actually drove the reservoir decisions.  When given, the reported
    extra_bits/deposit trajectory is an exact replay; without it the
    trajectory is RE-DERIVED from the final-pass savings/leftover (computed
    with extraBits already applied), which can differ slightly from what
    was really granted."""
    from pactpu.codec.engine import _reservoir_extras

    b = n_blocks
    savings = np.asarray(out["savings"], np.int64)[:b]
    leftover = np.asarray(out["leftover"], np.int64)[:b]
    if measure is not None:
        m_savings = np.asarray(measure[0], np.int64)[:b]
        m_leftover = np.asarray(measure[1], np.int64)[:b]
    else:
        m_savings, m_leftover = savings, leftover
    lrms = np.asarray(out["lrms"])[:b]
    bits = np.asarray(out["bits"], np.int64)[:b]          # [B, 2, bands]
    n_lines = np.asarray(cfg.band_layout.n_lines, np.int64)

    if "nbits" in out:
        bpc = np.asarray(out["nbits"], np.int64)[:2 * b].reshape(b, 2)
    else:
        lens = np.asarray(out["lens"], np.int64)[:b]      # [B, 2, lines]
        side = (cfg.n_scale_bits * (cfg.n_bands + 1)
                + cfg.n_mant_size_bits * cfg.n_bands
                + cfg.n_table_id_bits + cfg.n_bands)
        signs = (bits > 0) * n_lines[None, None, :]
        bpc = lens.sum(-1) + signs.sum(-1) + side

    # reservoir trajectory: replay the deposit/withdraw policy over the
    # measurement-pass savings/leftovers when available, else over the
    # final-pass numbers (reference codec/Huffman.py:353-371)
    extras, _ = _reservoir_extras(m_savings, m_leftover,
                                  cfg.reservoir_withdraw_divisor)
    deposit = np.zeros(b, np.int64)
    d = 0
    for t in range(b):
        deposit[t] = d
        if d > 10:
            d -= d // cfg.reservoir_withdraw_divisor
        elif d < 0:
            d = 0
        d += int(m_savings[t].sum())

    transmit = bits > 0
    mant_mean = np.where(transmit, bits, 0).sum(0) / np.maximum(
        transmit.sum(0), 1)

    return EncodeStats(
        n_blocks=b,
        bits_per_channel=bpc,
        huffman_savings=savings,
        alloc_leftover=leftover,
        reservoir_deposit=deposit,
        extra_bits=extras,
        ms_band_fraction=lrms.mean(axis=-1).astype(np.float64),
        table_id=np.asarray(out["tid"], np.int8)[:b],
        mant_bits_band=mant_mean.astype(np.float64),
        sample_rate=cfg.sample_rate,
        n_mdct_lines=cfg.n_mdct_lines,
    )


class StageTimer:
    """Wall-clock per-stage timing (the engine's host-side pipeline stages;
    for device-internal timing use `device_trace`)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(self.totals[k], 4),
                    "calls": self.counts[k]}
                for k in sorted(self.totals)}


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """JAX profiler trace around a region (view with TensorBoard or
    xprof); no-op when disabled so callers can gate on a flag."""
    if not enabled:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield


def debug_block(pcm: np.ndarray, block_index: int, cfg=None,
                extra_bits: float = 0.0) -> Dict[str, np.ndarray]:
    """Full psychoacoustic + rate-control diagnostic for ONE block — the
    numeric analogue of the reference's block-1 masking-curve debug plots
    (reference codec/psychoac.py:524-658, gated on codingParams.curBlock==1).

    pcm: int16 [n, 2]; block_index counts coded blocks (0 = the first
    block, whose priorBlock is silence, as in pacfile.py:264-268).

    Returns a dict of numpy arrays, all in dB at the MDCT line frequencies
    unless noted:
      line_freqs f64[half]; spl_lr/spl_ms f32[2, half] signal SPLs;
      bthr f32[6, half] the six raw masked thresholds (L, R, M, S, and the
      no-drop MLD variants M', S'); thr_lr/thr_ms f32[2, half] the combined
      thresholds; mld f32[half]; smr_lr/smr_ms f32[2, bands];
      lrms bool[bands]; smr f32[2, bands] the selected per-band SMRs;
      bits i32[2, bands] the water-filling allocation; sf i32[2, bands]
      scale factors; overall i32[2]; budget f64[].
    """
    import jax.numpy as jnp

    from pactpu.ops import bitalloc as ba_ops
    from pactpu.ops import psycho
    from pactpu.ops import quantize as q_ops
    from pactpu.ops.mdct import mdct
    from pactpu.ops.windows import analysis_window
    from pactpu.utils.config import CodecConfig

    cfg = cfg or CodecConfig()
    half = cfg.n_mdct_lines
    layout = cfg.band_layout
    lo = (block_index - 1) * half
    frame = np.zeros((2, 2 * half), np.int16)
    seg = pcm[max(lo, 0):lo + 2 * half].T
    frame[:, max(-lo, 0):max(-lo, 0) + seg.shape[1]] = seg

    frames = q_ops.pcm16_to_float(jnp.asarray(frame[None]))
    win = jnp.asarray(analysis_window(cfg.window, 2 * half), frames.dtype)
    sw = frames * win[None, None, :]
    lines = mdct(sw)
    overall = q_ops.scale_factor(
        jnp.max(jnp.abs(lines), axis=-1), cfg.n_scale_bits, 5)
    scaled = lines * jnp.exp2(overall[..., None].astype(lines.dtype))
    if cfg.ms_decision == "bitalloc":
        # same decision the engine's analyze pass makes in this mode
        # (engine.analyze_body): pick per band whichever coding needs
        # fewer allocated bits
        smr_lr, smr_ms, _ = psycho.stereo_smr_pair(
            sw, scaled, overall, cfg.sample_rate, layout,
            peak_mode=cfg.peak_mode)
        lrms = ba_ops.lrms_decision_bitalloc(
            smr_lr, smr_ms, layout.n_lines_array, int(cfg.bit_budget()),
            min(1 << cfg.n_mant_size_bits, cfg.max_mant_bits),
            cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)
    else:
        lrms = psycho.lrms_decision(frames, layout, cfg.ms_decision_factor)
    smr, mixed, curves = psycho.stereo_smrs(
        sw, scaled, overall, lrms, cfg.sample_rate, layout,
        peak_mode=cfg.peak_mode, return_curves=True)

    max_mant = min(1 << cfg.n_mant_size_bits, cfg.max_mant_bits)
    budget = float(cfg.bit_budget())
    total0 = jnp.asarray([int(budget + extra_bits)], jnp.int32)
    bits0, left0 = ba_ops.water_fill(
        total0, max_mant, jnp.asarray(layout.n_lines_array), smr[:, 0],
        lrms, cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)
    total1 = jnp.asarray([int(budget)], jnp.int32) + left0
    bits1, _ = ba_ops.water_fill(
        total1, max_mant, jnp.asarray(layout.n_lines_array), smr[:, 1],
        lrms, cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)
    bits = jnp.concatenate([bits0, bits1])

    peak = psycho.band_max(jnp.abs(mixed), layout, fill=0.0)
    sf = q_ops.scale_factor(peak, cfg.n_scale_bits, bits[None])

    line_freqs = (np.arange(half) + 0.5) / half * (cfg.sample_rate / 2.0)
    out = dict(
        line_freqs=line_freqs,
        spl_lr=np.asarray(curves["spl_lr"][0]),
        spl_ms=np.asarray(curves["spl_ms"][0]),
        bthr=np.asarray(curves["bthr"][0]),
        thr_lr=np.asarray(curves["thr_lr"][0]),
        thr_ms=np.asarray(curves["thr_ms"][0]),
        mld=np.asarray(curves["mld"]),
        smr_lr=np.asarray(curves["smr_lr"][0]),
        smr_ms=np.asarray(curves["smr_ms"][0]),
        lrms=np.asarray(lrms[0]),
        smr=np.asarray(smr[0]),
        bits=np.asarray(bits),
        sf=np.asarray(sf[0]),
        overall=np.asarray(overall[0]),
        budget=np.asarray(budget),
    )
    return out


def encode_stats_for_file(path: str, rate_mode: str = "reservoir",
                          cfg=None) -> EncodeStats:
    """Convenience: WAV path -> EncodeStats (used by the CLI `stats`
    subcommand)."""
    import dataclasses as dc

    from pactpu.codec.engine import Engine
    from pactpu.codec.wav import read_wav

    wav = read_wav(path)
    eng = Engine(cfg=cfg, rate_mode=rate_mode)
    eng.cfg = dc.replace(eng.cfg, sample_rate=wav.sample_rate)
    out, b = eng.encode_arrays(wav.samples)
    return collect_encode_stats(out, b, eng.cfg, measure=eng.last_measure)

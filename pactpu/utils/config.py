"""Codec configuration.

The reference keeps its run-time knobs in a mutable attribute bag
(``CodingParams``, reference codec/audiofile.py:51-53) plus hard-coded module
constants (band limits at codec/psychoac.py:122, bit-allocation stop
thresholds at codec/bitalloc.py:160-161, reservoir withdrawal policy at
codec/Huffman.py:363-371, coding constants at codec/pacfile.py:452-457).

Here all of that is collected into one frozen, hashable dataclass so that it
can be passed to ``jax.jit`` as a static argument and every jitted kernel
specializes on it at trace time.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property, lru_cache
from typing import Tuple

import numpy as np

# 25 Zwicker & Fastl critical-band upper edges in Hz
# (reference codec/psychoac.py:122).
CRITICAL_BAND_LIMITS_HZ: Tuple[float, ...] = (
    100.0, 200.0, 300.0, 400.0, 510.0, 630.0, 770.0, 920.0, 1080.0, 1270.0,
    1480.0, 1720.0, 2000.0, 2320.0, 2700.0, 3150.0, 3700.0, 4400.0, 5300.0,
    6400.0, 7700.0, 9500.0, 12000.0, 15500.0, 24000.0,
)


def assign_mdct_lines(n_mdct_lines: int, sample_rate: float,
                      flimit: Tuple[float, ...] = CRITICAL_BAND_LIMITS_HZ
                      ) -> Tuple[int, ...]:
    """Number of MDCT lines per scale-factor band.

    MDCT line k sits at frequency (k + 0.5)/nLines * (fs/2); each band
    collects the lines in (lower, upper] where upper is the band limit
    clamped to fs/2 (reference codec/psychoac.py:124-156).
    """
    freqs = (np.arange(n_mdct_lines) + 0.5) / n_mdct_lines * (sample_rate / 2.0)
    counts = []
    lower = 0.0
    for limit in flimit:
        upper = sample_rate / 2.0 if limit >= sample_rate / 2.0 else limit
        counts.append(int(np.count_nonzero((freqs > lower) & (freqs <= upper))))
        lower = upper
    return tuple(counts)


@dataclasses.dataclass(frozen=True)
class BandLayout:
    """Scale-factor band layout: which MDCT lines share a scale factor and a
    mantissa bit allocation (reference codec/psychoac.py:193-213)."""

    n_lines: Tuple[int, ...]

    @property
    def n_bands(self) -> int:
        return len(self.n_lines)

    @cached_property
    def lower_line(self) -> Tuple[int, ...]:
        return tuple(int(x) for x in
                     np.concatenate(([0], np.cumsum(self.n_lines)[:-1])))

    @cached_property
    def upper_line(self) -> Tuple[int, ...]:
        # inclusive upper line index
        return tuple(lo + n - 1 for lo, n in zip(self.lower_line, self.n_lines))

    @cached_property
    def line_to_band(self) -> np.ndarray:
        """int32[total_lines] mapping each MDCT line to its band index."""
        total = int(sum(self.n_lines))
        out = np.zeros(total, dtype=np.int32)
        for b, (lo, n) in enumerate(zip(self.lower_line, self.n_lines)):
            out[lo:lo + n] = b
        return out

    @cached_property
    def n_lines_array(self) -> np.ndarray:
        return np.asarray(self.n_lines, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Static codec parameters (hashable; safe as a jit static argument)."""

    sample_rate: int = 44100
    n_channels: int = 2               # header nChannels; 1 = mono extension
    n_mdct_lines: int = 1024          # half the MDCT window; window = 2N lines
    n_scale_bits: int = 4             # bits per scale factor
    n_mant_size_bits: int = 4         # bits per band bit-allocation field
    n_table_id_bits: int = 4          # bits for the Huffman table id
    target_bits_per_sample: float = 2.27
    band_limits: Tuple[float, ...] = CRITICAL_BAND_LIMITS_HZ
    # Explicit per-band MDCT line counts.  None derives the layout from
    # band_limits; a stream read back from disk carries the layout verbatim
    # in its header nLines[] (reference codec/pacfile.py:123-151 constructs
    # sfBands from the header), so read_header sets this to whatever the
    # header declares — the decoder accepts ANY self-describing layout, not
    # just the default derivation.
    band_line_counts: Tuple[int, ...] | None = None
    max_mant_bits: int = 16           # cap (reference codec/codec.py:218-219)

    # Water-filling stop thresholds in dB on the global NMR residual
    # (reference codec/bitalloc.py:160-161).
    ms_stop_threshold_db: float = -5.0
    lr_stop_threshold_db: float = -15.0

    # Per-band L/R-vs-M/S decision rule: "intensity" = the reference's
    # spectral-power rule |sum(L^2-R^2)| < factor * |sum(L^2+R^2)|
    # (codec/codec.py:94-102); "bitalloc" = bitalloc-minimization — pick
    # M/S iff coding the pair needs fewer allocated bits (the WAK paper's
    # second variant; pactpu.ops.bitalloc.lrms_decision_bitalloc).
    ms_decision: str = "intensity"

    # Per-band L/R-vs-M/S decision factor (reference codec/codec.py:102).
    ms_decision_factor: float = 0.8

    # MDCT analysis/synthesis window: "sine" (the reference main path,
    # codec/window.py:27-39) or "kbd" (Kaiser-Bessel-derived alpha=4,
    # codec/window.py:56-78 — defined there but never wired into the
    # reference encode path).  Both satisfy Princen-Bradley, so either
    # reconstructs perfectly; the stream format carries NO window field,
    # so "kbd" streams are a non-reference-compatible extension that must
    # be decoded with window="kbd".
    window: str = "sine"

    # Peak-picker mode for the psychoacoustic model: "ref" = the master
    # model's findpeaks (reference codec/psychoac.py:158-191, Q3/Q4 quirks),
    # "para"/"weighted" = aidan's alternative pickers
    # (reference baselines/aidan/psychoac.py:105-189).
    peak_mode: str = "ref"

    # Mantissa-bit allocator: "water_fill" = the reference's greedy
    # NMR-residual loop (codec/bitalloc.py:129-184); "closed_form" = kai's
    # R = P/N + (SMR-avg)/6 allocator (baselines/kai/bitalloc.py:84-134) —
    # the loop-free mode: one vectorized formula + a short take-back
    # instead of ~2000 sequential grants.  The reference's legacy
    # experimental allocators are engine modes too: "uniform"
    # (BitAllocUniform, codec/bitalloc.py:22-57), "const_snr"
    # (BitAllocConstSNR, :60-90, per-band peak-SPL levelling) and
    # "const_mnr" (BitAllocConstMNR, :93-125, SMR levelling).
    alloc_mode: str = "water_fill"

    # Bit-reservoir trickle: fraction of the deposit withdrawn per block in
    # compat mode (reference codec/Huffman.py:363-371 withdraws 1/100).
    # The rate-control *policy* (cbr / reservoir / exact) is the Engine's
    # `rate_mode` constructor argument — it is runtime behavior, not stream
    # format, so it does not live in this (format-defining) config.
    reservoir_withdraw_divisor: int = 100

    @property
    def full_block_size(self) -> int:
        return 2 * self.n_mdct_lines

    @property
    def largest_scale(self) -> int:
        # 2^nScaleBits - 1 (reference codec/quantize.py:164)
        return (1 << self.n_scale_bits) - 1

    @property
    def band_layout(self) -> BandLayout:
        if self.band_line_counts is not None:
            return _explicit_layout(self.band_line_counts)
        return _band_layout(self.n_mdct_lines, self.sample_rate,
                            self.band_limits)

    @property
    def n_bands(self) -> int:
        return self.band_layout.n_bands

    def bit_budget(self, n_channels_side_info: bool = True) -> float:
        """Per-channel mantissa bit budget for one block.

        target*halfN minus scale factors (bands + overall), minus bit-alloc
        fields, minus the Huffman table id (reference codec/codec.py:223-227).
        """
        n_bands = self.n_bands
        budget = self.target_bits_per_sample * self.n_mdct_lines
        budget -= self.n_scale_bits * (n_bands + 1)
        budget -= self.n_mant_size_bits * n_bands
        budget -= self.n_table_id_bits
        return budget

    def num_blocks(self, num_samples: int) -> int:
        """Number of coded blocks an encode of num_samples produces,
        including the final flush block (reference codec/pacfile.py:355-366).
        """
        return math.ceil(num_samples / self.n_mdct_lines) + 1


@lru_cache(maxsize=32)
def _band_layout(n_mdct_lines: int, sample_rate: int,
                 band_limits: Tuple[float, ...]) -> BandLayout:
    return BandLayout(assign_mdct_lines(n_mdct_lines, sample_rate,
                                        band_limits))


@lru_cache(maxsize=32)
def _explicit_layout(n_lines: Tuple[int, ...]) -> BandLayout:
    return BandLayout(n_lines)


def default_config() -> CodecConfig:
    return CodecConfig()

"""Batched psychoacoustic model.

Re-design of the reference masking model (reference codec/psychoac.py) for
XLA: where the reference walks a variable-length peak list per block and
spreads each masker over 512 lines in a Python loop
(psychoac.py:158-191, 215-251, 409-456), here every interior FFT bin is a
*potential* masker carried in a fixed-shape mask, and the spreading function
evaluates as one dense `[B, bins, lines]` elementwise expression whose
data-independent pieces (bark distances, downward slope) are precomputed
constants.  Six masked-threshold variants per block (L, R, M, S and the
two no-drop MLD variants, psychoac.py:506-682) batch into one call.

Reference quirks deliberately reproduced (see pactpu.compat.refcodec):
Q3/Q4 peak frequency = bin * (fs // N) on an integer grid; Q5 empty SPL
window for bins < 3; Q2 window compounding is the *caller's* job (inputs
must carry the window state the reference mutated into them).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from pactpu.ops.windows import hann_window

# SPL floor constants (reference codec/psychoac.py:15-42)
_I_FLOOR = 10.0 ** ((-30.0 - 96.0) / 10.0)


def spl(intensity: jax.Array) -> jax.Array:
    """SPL in dB from intensity, 96 dB reference, -30 dB floor
    (reference codec/psychoac.py:15-33)."""
    i = jnp.maximum(intensity, _I_FLOOR)
    return jnp.maximum(96.0 + (10.0 / np.log(10.0)) * jnp.log(i), -30.0)


def _bark_np(f: np.ndarray) -> np.ndarray:
    khz = np.asarray(f, np.float64) / 1000.0
    return 13.0 * np.arctan(0.76 * khz) + 3.5 * np.arctan((khz / 7.5) ** 2)


def _thresh_quiet_np(f: np.ndarray) -> np.ndarray:
    khz = np.maximum(f, 10.0) / 1000.0
    return (3.64 * khz ** -0.8
            - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
            + 0.001 * khz ** 4)


def _mld_np(f: np.ndarray) -> np.ndarray:
    """MLD factor over linear frequency, normalized to max 1
    (reference codec/psychoac.py:349-372)."""
    out = np.power(10.0, 1.25 * (
        1.0 - np.cos(np.pi * (np.minimum(f, 3000.0) / 3000.0)) - 2.5))
    return out / np.amax(out)


@lru_cache(maxsize=8)
def _consts(n: int, fs: int, dtype_name: str = "float32"):
    """Static per-line/per-bin tables for window size n (n//2 lines/bins).

    Everything here depends only on (n, fs): threshold-in-quiet intensity at
    the MDCT line frequencies, bark of the MDCT lines, bark of the FFT
    masker bins (on the reference's Py2 integer frequency grid, Q4), and
    the MLD weighting (reference codec/psychoac.py:44-64, 158-191,
    349-372).
    """
    half = n // 2
    line_freqs = (np.arange(half, dtype=np.float64) + 0.5) / half * (fs / 2.0)
    zvec = _bark_np(line_freqs)
    quiet_i = 10.0 ** ((_thresh_quiet_np(line_freqs) - 96.0) / 10.0)
    grid = float(int(fs) // n)                     # Q4 integer grid
    bin_bark = _bark_np(np.arange(half, dtype=np.float64) * grid)
    mld = _mld_np(line_freqs)
    # cached as numpy: a device array materialized during one jit trace must
    # not leak into another (same reason as pactpu.ops.mdct._mdct_basis)
    cast = lambda a: np.asarray(a, np.dtype(dtype_name))  # noqa: E731
    return cast(quiet_i), cast(zvec), cast(bin_bark), cast(mld)


def masker_levels(x: jax.Array, fs: int):
    """Per-bin masker SPLs and the peak mask for a batch of blocks.

    x: f32[..., N] time blocks carrying their window state (one further Hann
    window is applied here, as in reference calcBTHR psychoac.py:428).
    Returns (mspl[..., N/2], peak_mask[..., N/2]).
    """
    n = x.shape[-1]
    half = n // 2
    hann = jnp.asarray(hann_window(n), x.dtype)
    spec = jnp.fft.rfft(x * hann)[..., :half]
    p2 = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2

    # interior local maxima of |X| with 10*log10(|X|) > -30 (psychoac.py:158-191)
    up = p2[..., 1:-1] > p2[..., :-2]
    down = p2[..., 1:-1] > p2[..., 2:]
    loud = p2[..., 1:-1] > 1e-6
    pad = jnp.zeros(p2.shape[:-1] + (1,), bool)
    peak = jnp.concatenate([pad, up & down & loud, pad], axis=-1)

    # masker SPL over the 6-bin window [i-3, i+3); empty (=0) when i < 3 (Q5)
    cs = jnp.cumsum(p2, axis=-1)
    idx = jnp.arange(half)
    hi = cs[..., jnp.minimum(idx + 2, half - 1)]
    lo = jnp.where(idx >= 4, cs[..., jnp.maximum(idx - 4, 0)], 0.0)
    win = jnp.where(idx >= 3, hi - lo, 0.0)
    scale8 = (8.0 / 3.0) * 4.0 / float(n) ** 2
    mspl = spl(scale8 * win)
    return mspl, peak


def _bark_jnp(f: jax.Array) -> jax.Array:
    khz = f / 1000.0
    return 13.0 * jnp.arctan(0.76 * khz) + 3.5 * jnp.arctan((khz / 7.5) ** 2)


def aidan_peaks(x: jax.Array, fs: int, mode: str = "weighted"):
    """Aidan's alternative peak pickers as fixed-shape masker slots
    (reference baselines/aidan/psychoac.py:105-189 FindPeaksPara/FindPeaks,
    spectrum + keep-set semantics from getMaskedThreshold :236-262).

    x: f32[B, N] time blocks (one Hann window is applied here, as in
    aidan's getMaskedThreshold).  The dB spectrum is the FULL N-point FFT
    normalized by the Hann window power, SPL(4|X|^2 / (N^2 mean(hann^2)));
    peaks are strict interior local maxima of the (floored) dB values, and
    only the FIRST HALF of the peak list survives — the reference's
    `allPeaks[0:len(allPeaks)/2]` Py2-floor quirk standing in for
    positive-frequency selection (the mirror-image peaks land in the second
    half).  An empty peak list yields the reference's single dummy masker
    at f=0, SPL=0.

    mode="para":     parabolic interpolation on dB values — the *fixed*
                     `1/2.` variant (baselines/aidan/psychoac.py:139-142):
                     p = (a-c) / (2(a-2b+c)), height = b - (a-c)p/4.
    mode="weighted": intensity-weighted bin centroid, height =
                     SPL(Ia+Ib+Ic) (baselines/aidan/psychoac.py:176-181).

    Returns (height f32[B, N], bark f32[B, N], keep bool[B, N]) — masker
    SPL, bark of the interpolated masker frequency, and the slot mask —
    ready for `masked_threshold(..., maskers=...)`.
    """
    n = x.shape[-1]
    hann_np = np.asarray(hann_window(n), np.float64)
    w2hann = float(np.mean(hann_np * hann_np))
    hann = jnp.asarray(hann_np, x.dtype)
    spec = jnp.fft.fft(x * hann)
    p2 = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    xspl = spl((4.0 / (float(n) ** 2 * w2hann)) * p2)    # dB, floored

    pad = jnp.zeros(xspl.shape[:-1] + (1,), bool)
    mask = jnp.concatenate(
        [pad, (xspl[..., 1:-1] > xspl[..., :-2])
         & (xspl[..., 1:-1] > xspl[..., 2:]), pad], axis=-1)
    cnt = jnp.cumsum(mask.astype(jnp.int32), axis=-1)
    total = cnt[..., -1:]
    keep = mask & (cnt <= total // 2)                    # first-half quirk

    idx = jnp.arange(n, dtype=x.dtype)
    a = jnp.roll(xspl, 1, axis=-1)
    b = xspl
    c = jnp.roll(xspl, -1, axis=-1)
    if mode == "para":
        denom = a - 2.0 * b + c                          # < 0 at a strict max
        p = 0.5 * (a - c) / jnp.where(denom != 0.0, denom, 1.0)
        loc = idx[None] + p
        height = b - 0.25 * (a - c) * p
    elif mode == "weighted":
        ia = jnp.exp2(jnp.asarray(np.log2(10.0) / 10.0, x.dtype) * (a - 96.0))
        ib = jnp.exp2(jnp.asarray(np.log2(10.0) / 10.0, x.dtype) * (b - 96.0))
        ic = jnp.exp2(jnp.asarray(np.log2(10.0) / 10.0, x.dtype) * (c - 96.0))
        loc = (ia * (idx[None] - 1.0) + ib * idx[None]
               + ic * (idx[None] + 1.0)) / (ia + ib + ic)
        height = spl(ia + ib + ic)
    else:
        raise ValueError(f"unknown aidan peak mode {mode!r}")

    # empty-list dummy masker: f=0, SPL=0 in slot 0
    empty = total == 0
    slot0 = jnp.arange(n) == 0
    keep = keep | (empty & slot0[None])
    # zero non-kept slots: their a/b/c come from wrapped neighbors and can
    # produce huge interpolated values that overflow the (masked-out)
    # spreading exponential into inf, and inf * 0 = NaN
    height = jnp.where(keep & ~(empty & slot0[None]), height, 0.0)
    loc = jnp.where(keep & ~(empty & slot0[None]), loc, 0.0)
    bark = _bark_jnp(loc * (float(fs) / float(n)))
    return height, bark, keep


def masked_threshold(x: jax.Array, drop_db: jax.Array, fs: int,
                     chunk: int = 16, consts=None, maskers=None,
                     up_coef: float = 0.367) -> jax.Array:
    """Masked thresholds (SPL dB at the MDCT line frequencies) for a batch.

    x: f32[B, N] windowed time blocks; drop_db: f32[B] per-row tonal-masker
    drop (15 for normal thresholds, 0 for the no-drop MLD variants,
    reference codec/psychoac.py:103-120, 409-456).

    The accumulation is intensity addition (alpha=1) of every masker plus
    the threshold in quiet (psychoac.py:215-251).  Maskers are compacted to
    K = N/4 top-k slots first: a strict local maximum needs both neighbors
    below it, so at most half of the N/2-2 interior bins can be peaks —
    the compaction is *exact* and halves the dominant [maskers x lines]
    spreading work (real audio has 40-350 peaks, see the corpus
    measurement in the commit history).  The spreading geometry (bark
    distance, slopes) is computed on the fly from O(N) vectors instead of
    gathered from [bins, lines] tables; `chunk` bounds peak memory.
    """
    n = x.shape[-1]
    half = n // 2
    c = consts if consts is not None else _consts(n, int(fs))
    quiet_i, zvec, bin_bark = c[0], c[1], c[2]
    zvec = jnp.asarray(zvec)
    bin_bark = jnp.asarray(bin_bark)
    if maskers is not None:
        # caller-supplied masker slots (e.g. aidan_peaks): SPL + bark are
        # data-dependent, so only the compact gather path applies
        mspl, peak, bark_arr = maskers
        m = mspl.shape[-1]
        # strict local maxima are non-adjacent (<= (m-1)/2 of the interior)
        # and the first-half quirk halves that again; +1 covers the dummy
        k = m // 4 + 1
    else:
        mspl, peak = masker_levels(x, fs)
        bark_arr = None
        m = half
        k = half // 2

    # compact peaks into K slots (indices of peak bins; empty slots -> -1)
    key = jnp.where(peak, jnp.arange(m, dtype=jnp.int32), -1)
    idx, _ = jax.lax.top_k(key, k)                 # actually values == idx
    valid = idx >= 0
    safe = jnp.maximum(idx, 0)
    mspl_k = jnp.take_along_axis(mspl, safe, axis=-1)
    lev_k = up_coef * jnp.maximum(mspl_k - 40.0, 0.0)
    bark_k = (bin_bark[safe] if bark_arr is None
              else jnp.take_along_axis(bark_arr, safe, axis=-1))

    log2_10_over_10 = jnp.asarray(np.log2(10.0) / 10.0, x.dtype)

    def one_chunk(args):
        mspl_c, lev_c, bark_c, valid_c, drop_c = args
        dz = zvec[None, None, :] - bark_c[:, :, None]     # [c, K, lines]
        onslope = jnp.where(jnp.abs(dz) > 0.5, jnp.abs(dz) - 0.5, 0.0)
        s_db = (mspl_c[:, :, None] - drop_c[:, None, None]
                - 27.0 * onslope
                + jnp.where(dz >= 0.0, lev_c[:, :, None] * onslope, 0.0))
        contrib = (jnp.exp2(log2_10_over_10 * (s_db - 96.0))
                   * valid_c[:, :, None])
        return jnp.sum(contrib, axis=1)

    b = x.shape[0]
    pad = (-b) % chunk

    def padded(a):
        return jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1)).reshape(
            (b + pad) // chunk, chunk, *a.shape[1:])

    total = jax.lax.map(one_chunk, (padded(mspl_k), padded(lev_k),
                                    padded(bark_k),
                                    padded(valid.astype(mspl.dtype)),
                                    padded(drop_db)))
    total = total.reshape(b + pad, -1)[:b]
    return spl(jnp.asarray(quiet_i)[None] + total)


def band_max(values: jax.Array, layout, fill: float = -96.0) -> jax.Array:
    """Per-scale-factor-band max over MDCT lines: [..., lines] -> [..., bands]
    (the band reduction of reference CalcSMRs / calcStereoSMR,
    psychoac.py:253-318, 458-504).  ONLY empty bands yield `fill`; non-empty
    bands carry their true max even below `fill` (the reference assigns
    `np.max(...)` unconditionally — seeding the scatter-max with `fill`
    would silently clamp deeply-masked bands)."""
    seg = jnp.asarray(layout.line_to_band)
    n_bands = layout.n_bands
    flat = values.reshape(-1, values.shape[-1])
    out = jnp.full((flat.shape[0], n_bands), -jnp.inf, values.dtype)
    out = out.at[:, seg].max(flat)
    empty = jnp.asarray(layout.n_lines_array == 0)
    out = jnp.where(empty[None, :], jnp.asarray(fill, values.dtype), out)
    return out.reshape(values.shape[:-1] + (n_bands,))


def mdct_spl(scaled_lines: jax.Array, overall_scale: jax.Array) -> jax.Array:
    """SPL of MDCT lines that were scaled by 2^overallScale:
    SPL(4 X^2) - 6.02 * scale (reference codec/psychoac.py:534-536)."""
    return (spl(4.0 * scaled_lines * scaled_lines)
            - 6.02 * overall_scale[..., None].astype(scaled_lines.dtype))


def _threshold_for_mode(x, drop, fs, consts, peak_mode):
    """Masked threshold dispatch over the flag-gated peak-picker modes:
    "ref" = the master model's findpeaks semantics (Q3/Q4 bin-center
    maskers, 6-bin window SPL, 0.367 upslope); "para"/"weighted" = aidan's
    pickers (baselines/aidan/psychoac.py:105-189) with aidan's 0.37
    upslope coefficient (ibid. :97)."""
    if peak_mode == "ref":
        return masked_threshold(x, drop, fs, consts=consts)
    return masked_threshold(x, drop, fs, consts=consts,
                            maskers=aidan_peaks(x, fs, peak_mode),
                            up_coef=0.37)


def calc_smrs(sine_windowed: jax.Array, scaled_lines: jax.Array,
              overall_scale: jax.Array, fs: int, layout,
              consts=None, peak_mode: str = "ref") -> jax.Array:
    """Mono per-band max SMR (reference CalcSMRs, psychoac.py:253-318).

    sine_windowed: f32[B, N]; scaled_lines: f32[B, N/2];
    overall_scale: i32[B].  Returns f32[B, n_bands].
    """
    drop = jnp.full(sine_windowed.shape[0], 15.0, sine_windowed.dtype)
    thr = _threshold_for_mode(sine_windowed, drop, fs, consts, peak_mode)
    # the mono path divides out 2^scale *before* the SPL floor clamps
    # (reference psychoac.py:253-318), unlike the stereo path's
    # clamp-then-subtract `SPL(4X^2) - 6.02*scale`
    true_lines = scaled_lines * jnp.exp2(
        -overall_scale[..., None].astype(scaled_lines.dtype))
    lines_spl = spl(4.0 * true_lines * true_lines)
    return band_max(lines_spl - thr, layout, fill=0.0)


def stereo_smr_pair(sine_windowed: jax.Array, scaled_lines: jax.Array,
                    overall_scale: jax.Array, fs: int, layout,
                    consts=None, peak_mode: str = "ref",
                    return_curves: bool = False):
    """Per-band SMRs of BOTH stereo codings for a batch of blocks
    (reference getStereoMaskThreshold, codec/psychoac.py:506-682, up to —
    but not including — the per-band L/R-vs-M/S selection).

    sine_windowed: f32[B, 2, N] analysis-windowed time blocks;
    scaled_lines: f32[B, 2, N/2] MDCT lines scaled by 2^overallScale;
    overall_scale: i32[B, 2].
    Returns (smr_lr f32[B, 2, bands], smr_ms f32[B, 2, bands],
    ms_lines f32[B, 2, N/2][, curves dict]).

    Quirk parity: the M/S time blocks are built from hann*sine data and the
    no-drop MLD variants from hann^2*sine data (Q2 window compounding);
    M/S MDCT lines average the per-channel scaled lines (Q15); the M SPL
    uses channel 0's overall scale and S uses channel 1's.
    """
    b, _, n = sine_windowed.shape
    half = n // 2
    hann = jnp.asarray(hann_window(n), sine_windowed.dtype)
    mld = (consts if consts is not None else _consts(n, int(fs)))[3]

    hl = hann * sine_windowed[:, 0]
    hr = hann * sine_windowed[:, 1]
    ms_m = (hl + hr) * 0.5
    ms_s = (hl - hr) * 0.5

    # six thresholds in one batched call: L, R, M, S, M_mld, S_mld
    stack = jnp.stack([sine_windowed[:, 0], sine_windowed[:, 1],
                       ms_m, ms_s, hann * ms_m, hann * ms_s], axis=1)
    drops = jnp.broadcast_to(
        jnp.asarray([15.0, 15.0, 15.0, 15.0, 0.0, 0.0],
                    sine_windowed.dtype), (b, 6)).reshape(-1)
    thr = _threshold_for_mode(stack.reshape(b * 6, n), drops, fs, consts,
                              peak_mode)
    thr = thr.reshape(b, 6, half)
    bthr_l, bthr_r, bthr_m, bthr_s, bthr_m_mld, bthr_s_mld = (
        thr[:, i] for i in range(6))

    ms_lines = jnp.stack([(scaled_lines[:, 0] + scaled_lines[:, 1]) * 0.5,
                          (scaled_lines[:, 0] - scaled_lines[:, 1]) * 0.5],
                         axis=1)

    lr_spl = mdct_spl(scaled_lines, overall_scale)
    ms_spl = mdct_spl(ms_lines, overall_scale)

    thr_ms = jnp.stack(
        [jnp.maximum(bthr_m, jnp.minimum(bthr_s, mld * bthr_s_mld)),
         jnp.maximum(bthr_s, jnp.minimum(bthr_m, mld * bthr_m_mld))], axis=1)
    thr_lr = jnp.stack([bthr_l, bthr_r], axis=1)

    smr_lr = band_max(lr_spl - thr_lr, layout)
    smr_ms = band_max(ms_spl - thr_ms, layout)
    if return_curves:
        # per-line diagnostic curves: the numeric analogue of the
        # reference's block-1 masking plots (psychoac.py:524-658)
        return smr_lr, smr_ms, ms_lines, dict(
            bthr=thr, thr_lr=thr_lr, thr_ms=thr_ms,
            spl_lr=lr_spl, spl_ms=ms_spl, mld=mld,
            smr_lr=smr_lr, smr_ms=smr_ms)
    return smr_lr, smr_ms, ms_lines


def select_coding(smr_lr: jax.Array, smr_ms: jax.Array,
                  scaled_lines: jax.Array, ms_lines: jax.Array,
                  lrms: jax.Array, layout):
    """Per-band SMR + MDCT-line selection by the LRMS flags (reference
    codec/psychoac.py:660-682)."""
    lrms_b = lrms[:, None, :]
    smr = jnp.where(lrms_b, smr_ms, smr_lr)
    line_lrms = lrms[:, None, jnp.asarray(layout.line_to_band)]
    mixed = jnp.where(line_lrms, ms_lines, scaled_lines)
    return smr, mixed


def stereo_smrs(sine_windowed: jax.Array, scaled_lines: jax.Array,
                overall_scale: jax.Array, lrms: jax.Array, fs: int, layout,
                consts=None, peak_mode: str = "ref",
                return_curves: bool = False):
    """Stereo SMRs + channel-mixed MDCT lines for a batch of blocks
    (reference getStereoMaskThreshold, codec/psychoac.py:506-682):
    stereo_smr_pair followed by the per-band LRMS selection.

    Returns (smr f32[B, 2, bands], mixed f32[B, 2, N/2][, curves])."""
    out = stereo_smr_pair(sine_windowed, scaled_lines, overall_scale, fs,
                          layout, consts=consts, peak_mode=peak_mode,
                          return_curves=return_curves)
    smr_lr, smr_ms, ms_lines = out[:3]
    smr, mixed = select_coding(smr_lr, smr_ms, scaled_lines, ms_lines,
                               lrms, layout)
    if return_curves:
        return smr, mixed, out[3]
    return smr, mixed


def lrms_decision(full_blocks: jax.Array, layout,
                  factor: float = 0.8) -> jax.Array:
    """Per-band L/R-vs-M/S decision from complex FFT band sums:
    |sum(L^2 - R^2)| < factor * |sum(L^2 + R^2)| over complex squares of the
    unwindowed block (Q14, reference codec/codec.py:94-102).

    full_blocks: f32[B, 2, N]. Returns bool[B, bands].
    """
    half = full_blocks.shape[-1] // 2
    spec = jnp.fft.rfft(full_blocks)[..., :half]
    sq = spec * spec                                 # complex squares
    seg = jnp.asarray(layout.line_to_band)
    n_bands = layout.n_bands

    def band_sum(v):
        flat = v.reshape(-1, half)
        out = jnp.zeros((flat.shape[0], n_bands), v.dtype)
        out = out.at[:, seg].add(flat)
        return out.reshape(v.shape[:-1] + (n_bands,))

    re = band_sum(jnp.real(sq))
    im = band_sum(jnp.imag(sq))
    diff = jnp.abs(jax.lax.complex(re[:, 0] - re[:, 1], im[:, 0] - im[:, 1]))
    tot = jnp.abs(jax.lax.complex(re[:, 0] + re[:, 1], im[:, 0] + im[:, 1]))
    return diff < factor * tot

"""Reference baseline variants: kai's closed-form allocator and aidan's
peak-pickers, each against a direct numpy restatement of the reference
semantics (reference baselines/kai/bitalloc.py:84-134,
baselines/aidan/psychoac.py:105-189).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from pactpu.ops import bitalloc as ba_ops
from pactpu.ops import psycho
from pactpu.utils.config import CodecConfig

CFG = CodecConfig()
LAYOUT = CFG.band_layout
N = 2 * CFG.n_mdct_lines


# -- kai's closed-form allocator ---------------------------------------------


def kai_bit_alloc(bit_budget, max_mant_bits, n_lines, smr):
    """Py3 restatement of kai's BitAlloc (baselines/kai/bitalloc.py:84-134):
    closed-form R(i) = P/sum(nLines) + (SMR - avgSMR)/6 with [2, max] gating,
    then an overshoot take-back loop from the min adjusted SMR."""
    n_lines = np.asarray(n_lines, np.int64)
    smr = np.asarray(smr, np.float64)
    n_bands = len(n_lines)
    total_lines = np.sum(n_lines)
    avg = np.sum(n_lines * smr) / total_lines
    bits = np.zeros(n_bands, np.int64)
    for i in range(n_bands):
        r = float(bit_budget) / total_lines + (smr[i] - avg) / 6.0
        if r < 2:
            r = 0
        if r > max_mant_bits:
            r = max_mant_bits
        bits[i] = int(r)
    total = np.sum(bits * n_lines)
    mysmr = smr.copy()
    sentinel = 1e9
    while not np.all(mysmr == sentinel):
        i = int(np.argmin(mysmr))
        if total >= bit_budget:
            mysmr[i] += 6.0
            if bits[i] != 0:
                bits[i] -= 1
                if bits[i] == 1:
                    bits[i] = 0
            total = np.sum(bits * n_lines)
            if bits[i] == 0:
                mysmr[i] = sentinel
        else:
            mysmr[i] = sentinel
    return bits


def _grid_smr(rng, rows):
    """SMRs on a 1/8-dB dyadic grid: exactly representable in f32, and +6.0
    adjustments stay on the grid, so device-f32 vs restatement-f64 argmin
    decisions are identical by construction."""
    return (rng.integers(-320, 480, (rows, LAYOUT.n_bands)) / 8.0
            ).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_closed_form_matches_kai_restatement(seed):
    rng = np.random.default_rng(seed)
    rows = 48
    smr = _grid_smr(rng, rows)
    budget = rng.integers(0, 4000, rows).astype(np.int32)
    budget[0] = 0
    budget[1] = 16 * CFG.n_mdct_lines + 7       # everything cappable
    max_mant = 16

    bits_dev = np.asarray(ba_ops.alloc_closed_form(
        jnp.asarray(budget), max_mant,
        jnp.asarray(LAYOUT.n_lines_array), jnp.asarray(smr)))

    # mask out rows whose closed-form R sits within 1e-3 of a floor/gate
    # boundary, where the f32 device math may legitimately round the other
    # way (kai's own comment: "will not bother to worry about slight
    # variations ... due to rounding")
    _, r_dev = ba_ops.closed_form_init(
        jnp.asarray(budget), max_mant,
        jnp.asarray(LAYOUT.n_lines_array), jnp.asarray(smr))
    r_dev = np.asarray(r_dev)
    # only R >= ~2 faces a floor/gate boundary (below the gate it is 0)
    near = (np.abs(r_dev - np.round(r_dev)) < 1e-3) & (r_dev > 2.0 - 1e-3)
    comparable = ~near.any(axis=1)
    assert comparable.sum() >= rows - 4          # boundaries must be rare

    for row in range(rows):
        if not comparable[row]:
            continue
        bits_ref = kai_bit_alloc(int(budget[row]), max_mant,
                                 LAYOUT.n_lines_array, smr[row])
        np.testing.assert_array_equal(bits_dev[row], bits_ref,
                                      err_msg=f"row {row}")


def test_closed_form_respects_budget_after_takeback():
    rng = np.random.default_rng(9)
    smr = _grid_smr(rng, 32)
    budget = rng.integers(100, 3000, 32).astype(np.int32)
    bits = np.asarray(ba_ops.alloc_closed_form(
        jnp.asarray(budget), 16,
        jnp.asarray(LAYOUT.n_lines_array), jnp.asarray(smr)))
    spent = (bits * LAYOUT.n_lines_array[None]).sum(axis=1)
    # the take-back loop runs while spent >= budget, so it terminates with
    # spent < budget (or everything zeroed)
    assert ((spent < budget) | (bits == 0).all(axis=1)).all()
    assert (bits != 1).all()                     # 1-bit zeroing
    assert (bits <= 16).all() and (bits >= 0).all()


# -- aidan's peak pickers ----------------------------------------------------


def _aidan_restatement(x, fs, mode):
    """Py3 restatement of FindPeaksPara / FindPeaks semantics
    (baselines/aidan/psychoac.py:105-189) on the full-N Hann dB spectrum of
    getMaskedThreshold (ibid. :236-262), incl. the first-half-of-list quirk
    and the empty-list dummy masker."""
    n = len(x)
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * (np.arange(n) + 0.5) / n))
    w2hann = np.mean(hann * hann)
    spec = np.fft.fft(x * hann)
    inten = np.maximum(4.0 * np.abs(spec) ** 2 / (n * n * w2hann),
                       10.0 ** ((-30.0 - 96.0) / 10.0))
    xspl = np.maximum(96.0 + 10.0 * np.log10(inten), -30.0)

    idxs = [i for i in range(1, n - 1)
            if xspl[i - 1] < xspl[i] and xspl[i] > xspl[i + 1]]
    if not idxs:
        return np.array([0.0]), np.array([0.0])     # (freqs, heights) dummy
    keep = idxs[:len(idxs) // 2]
    freqs, heights = [], []
    for i in keep:
        a, b, c = xspl[i - 1], xspl[i], xspl[i + 1]
        if mode == "para":
            p = 0.5 * (a - c) / (a - 2.0 * b + c)
            loc = i + p
            h = b - 0.25 * (a - c) * p
        else:
            ia, ib, ic = (10.0 ** ((v - 96.0) / 10.0) for v in (a, b, c))
            loc = (ia * (i - 1) + ib * i + ic * (i + 1)) / (ia + ib + ic)
            s = ia + ib + ic
            h = max(96.0 + 10.0 * np.log10(
                max(s, 10.0 ** ((-30.0 - 96.0) / 10.0))), -30.0)
        freqs.append(fs * loc / n)
        heights.append(h)
    return np.array(freqs), np.array(heights)


def _bark(f):
    khz = np.asarray(f, np.float64) / 1000.0
    return 13.0 * np.arctan(0.76 * khz) + 3.5 * np.arctan((khz / 7.5) ** 2)


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(4)
    t = np.arange(N) / CFG.sample_rate
    tones = sum(a * np.sin(2 * np.pi * f * t) for a, f in
                [(0.6, 420.0), (0.11, 530.0), (0.10, 640.0),
                 (0.08, 840.0), (0.05, 4200.0), (0.03, 8400.0)])
    noisy = 0.2 * np.sin(2 * np.pi * 1000.0 * t) \
        + 0.01 * rng.standard_normal(N)
    silent = np.zeros(N)
    tiny = 1e-7 * rng.standard_normal(N)
    return np.stack([tones, noisy, silent, tiny])


@pytest.mark.parametrize("mode", ["para", "weighted"])
def test_aidan_peaks_match_restatement(blocks, mode):
    h_dev, z_dev, keep_dev = psycho.aidan_peaks(
        jnp.asarray(blocks, jnp.float32), CFG.sample_rate, mode)
    h_dev, z_dev, keep_dev = map(np.asarray, (h_dev, z_dev, keep_dev))
    for i in range(blocks.shape[0]):
        freqs_ref, heights_ref = _aidan_restatement(
            blocks[i], CFG.sample_rate, mode)
        kept = np.where(keep_dev[i])[0]
        assert len(kept) == len(freqs_ref), f"block {i}"
        # device slots are bin-ordered; restatement keeps list order, which
        # is also bin-ascending
        np.testing.assert_allclose(z_dev[i][kept], _bark(freqs_ref),
                                   atol=1e-3, err_msg=f"block {i}")
        np.testing.assert_allclose(h_dev[i][kept], heights_ref,
                                   atol=5e-3, err_msg=f"block {i}")


@pytest.mark.parametrize("mode", ["para", "weighted"])
def test_aidan_threshold_mode_runs_and_differs(blocks, mode):
    x = jnp.asarray(blocks, jnp.float32)
    drop = jnp.full(x.shape[0], 15.0, jnp.float32)
    thr_ref_mode = np.asarray(psycho.masked_threshold(
        x, drop, CFG.sample_rate))
    thr_aidan = np.asarray(psycho.masked_threshold(
        x, drop, CFG.sample_rate,
        maskers=psycho.aidan_peaks(x, CFG.sample_rate, mode), up_coef=0.37))
    assert np.isfinite(thr_aidan).all()
    # quiet threshold floors both models identically on silence
    np.testing.assert_allclose(thr_aidan[2], thr_ref_mode[2], atol=1e-2)
    # but the pickers genuinely change the threshold on tonal content
    assert np.abs(thr_aidan[0] - thr_ref_mode[0]).max() > 0.5


@pytest.mark.parametrize("mode", ["ref", "weighted"])
def test_calc_smrs_peak_mode_plumbs(blocks, mode):
    sw = jnp.asarray(blocks, jnp.float32)
    from pactpu.ops.mdct import mdct
    lines = mdct(sw)
    overall = jnp.zeros(sw.shape[0], jnp.int32)
    smr = np.asarray(psycho.calc_smrs(sw, lines, overall, CFG.sample_rate,
                                      LAYOUT, peak_mode=mode))
    assert smr.shape == (blocks.shape[0], LAYOUT.n_bands)
    assert np.isfinite(smr).all()


def test_engine_closed_form_alloc_mode():
    """kai's allocator as an engine mode: the stream roundtrips (engine and
    oracle decodes agree — the format carries the allocation, so decode is
    allocator-agnostic) and genuinely differs from the water-fill stream."""
    from pactpu.codec.engine import Engine
    from pactpu.compat import refcodec as rc

    rng = np.random.default_rng(12)
    t = np.arange(4 * 1024) / 44100.0
    sig = (0.5 * np.sin(2 * np.pi * 440 * t)
           + 0.1 * np.sin(2 * np.pi * 3200 * t)
           + 0.02 * rng.standard_normal(t.shape[0]))
    pcm = np.clip(np.stack([sig, 0.6 * sig], 1) * 32767,
                  -32768, 32767).astype(np.int16)

    wf = Engine(CodecConfig(), rate_mode="reservoir")
    cf = Engine(CodecConfig(alloc_mode="closed_form"),
                rate_mode="reservoir")
    blob_wf, blob_cf = wf.encode(pcm), cf.encode(pcm)
    assert blob_cf != blob_wf
    fs, out_cf = cf.decode(blob_cf)
    fs2, out_oracle = rc.decode_file(blob_cf)
    assert out_cf.shape == out_oracle.shape
    assert np.abs(out_cf.astype(np.int64)
                  - out_oracle.astype(np.int64)).max() <= 1
    # quality stays in the same ballpark as water-fill on tonal content
    def snr(a, b):
        a = a.astype(np.float64); b = b.astype(np.float64)
        return 10 * np.log10(np.sum(a * a)
                             / max(np.sum((a - b) ** 2), 1e-30))
    _, out_wf = wf.decode(blob_wf)
    n = pcm.shape[0]   # Q6: multiple-of-1024 inputs decode with padding
    s_wf = snr(pcm[:, 0], out_wf[:n, 0])
    s_cf = snr(pcm[:, 0], out_cf[:n, 0])
    assert s_cf > s_wf - 6.0, (s_cf, s_wf)

    with pytest.raises(ValueError):
        Engine(CodecConfig(alloc_mode="closed_form"), rate_mode="exact")
    with pytest.raises(ValueError):
        Engine(CodecConfig(alloc_mode="bogus"))


def test_engine_kbd_window_mode():
    """KBD-windowed MDCT as an engine mode (round-2 VERDICT #4): encode +
    decode with window="kbd" round-trips at full quality (KBD is
    Princen-Bradley), produces a genuinely different stream than sine, and
    decoding a kbd stream with a sine engine degrades — the format carries
    no window field, so the mode is a flag-gated extension."""
    from pactpu.codec.engine import Engine

    rng = np.random.default_rng(21)
    t = np.arange(5 * 1024 - 64) / 44100.0
    sig = (0.5 * np.sin(2 * np.pi * 440 * t)
           + 0.1 * np.sin(2 * np.pi * 2800 * t)
           + 0.02 * rng.standard_normal(t.shape[0]))
    pcm = np.clip(np.stack([sig, 0.7 * sig], 1) * 32767,
                  -32768, 32767).astype(np.int16)

    def snr(a, b):
        a = a.astype(np.float64); b = b.astype(np.float64)
        return 10 * np.log10(np.sum(a * a)
                             / max(np.sum((a - b) ** 2), 1e-30))

    kbd = Engine(CodecConfig(window="kbd"), rate_mode="reservoir")
    sine = Engine(CodecConfig(), rate_mode="reservoir")
    blob_kbd = kbd.encode(pcm)
    blob_sine = sine.encode(pcm)
    assert blob_kbd != blob_sine

    n = pcm.shape[0]
    _, out_kbd = kbd.decode(blob_kbd)
    _, out_sine = sine.decode(blob_sine)
    s_kbd = snr(pcm[:n, 0], out_kbd[:n, 0])
    s_sine = snr(pcm[:n, 0], out_sine[:n, 0])
    # full-quality roundtrip, same quality ballpark as sine (measured:
    # kbd 10.32 dB vs sine 10.23 dB on this fixture — the absolute level
    # is set by the bit budget and the Q1 M/S aliasing quirk, not PR)
    assert s_kbd > 8.0, s_kbd
    assert s_kbd > s_sine - 1.0, (s_kbd, s_sine)

    # window mismatch on decode: mechanically decodes but measurably
    # degrades (sine and KBD are similar shapes, so the penalty is mild)
    _, out_mismatch = sine.decode(blob_kbd)
    assert snr(pcm[:n, 0], out_mismatch[:n, 0]) < s_kbd - 1.5

    with pytest.raises(ValueError):
        Engine(CodecConfig(window="kbd"), rate_mode="exact")
    with pytest.raises(ValueError):
        Engine(CodecConfig(window="hamming"))


def _ms_fraction(blob):
    """Fraction of bands coded M/S, parsed from the stream's LRMS flags."""
    from pactpu import native
    from pactpu.compat import refcodec as rc
    cfg, _, off = rc.read_header(blob)
    parsed = native.unpack_file(
        blob[off:], np.asarray(cfg.band_layout.n_lines, np.int32),
        cfg.n_scale_bits, cfg.n_mant_size_bits, cfg.n_table_id_bits,
        read_lrms=True, n_channels=2)
    return float(parsed["lrms"].mean())


def test_ms_decision_bitalloc_variant():
    """Bitalloc-minimization M/S decision (round-2 VERDICT #3): beats the
    spectral-intensity rule on dual-mono content and falls back to mostly
    L/R on decorrelated content, where intensity overuses M/S (the WAK
    paper's 'birdies').  Measured on these fixtures: dual-mono 22.44 vs
    22.14 dB; decorrelated 5.15 vs 3.97 dB with MS-fraction 0.13 vs 0.35."""
    from pactpu.codec.engine import Engine
    from pactpu.compat import refcodec as rc

    rng = np.random.default_rng(33)
    n = 1024 * 6
    t = np.arange(n) / 44100.0

    def snr(a, b):
        m = min(len(a), len(b))
        a, b = a[:m].astype(np.float64), b[:m].astype(np.float64)
        return 10 * np.log10((a ** 2).sum()
                             / max(((a - b) ** 2).sum(), 1e-30))

    def encode_both(pcm):
        out = {}
        for mode in ("intensity", "bitalloc"):
            e = Engine(CodecConfig(ms_decision=mode), rate_mode="cbr",
                       chunk_blocks=16)
            blob = e.encode(pcm)
            _, dec = e.decode(blob)
            s = (snr(pcm[:, 0], dec[:len(pcm), 0])
                 + snr(pcm[:, 1], dec[:len(pcm), 1])) / 2
            out[mode] = (s, _ms_fraction(blob), blob)
        return out

    # dual-mono: M/S halves the information; bitalloc must match or beat
    sig = (0.5 * np.sin(2 * np.pi * 440 * t)
           + 0.1 * np.sin(2 * np.pi * 2900 * t)
           + 0.01 * rng.standard_normal(n))
    dm = np.clip(np.stack([sig, sig], 1) * 32767,
                 -32768, 32767).astype(np.int16)
    r = encode_both(dm)
    assert r["bitalloc"][0] >= r["intensity"][0] - 0.1
    assert r["bitalloc"][1] > 0.5          # M/S on the active bands

    # decorrelated equal-power: intensity overuses M/S; bitalloc falls back
    a = 0.3 * np.sin(2 * np.pi * 500 * t) + 0.2 * rng.standard_normal(n)
    b = 0.3 * np.sin(2 * np.pi * 710 * t) + 0.2 * rng.standard_normal(n)
    dc = np.clip(np.stack([a, b], 1) * 32767,
                 -32768, 32767).astype(np.int16)
    r = encode_both(dc)
    assert r["bitalloc"][1] < r["intensity"][1]      # fewer M/S bands
    assert r["bitalloc"][0] > r["intensity"][0]      # and better quality

    # the format carries the flags, so any decoder reads the stream
    fs_o, out_o = rc.decode_file(r["bitalloc"][2])
    fs_e, out_e = Engine(rate_mode="cbr").decode(r["bitalloc"][2])
    m = min(len(out_o), len(out_e))
    assert np.abs(out_o[:m].astype(np.int64)
                  - out_e[:m].astype(np.int64)).max() <= 1

    with pytest.raises(ValueError):
        Engine(CodecConfig(ms_decision="bitalloc"), rate_mode="exact")
    with pytest.raises(ValueError):
        Engine(CodecConfig(ms_decision="bogus"))


def test_streaming_decoder_kbd_window():
    """StreamingDecoder(window='kbd') matches batch Engine.decode on a
    kbd stream."""
    from pactpu.codec.engine import Engine
    from pactpu.codec.stream import StreamingDecoder

    rng = np.random.default_rng(22)
    t = np.arange(3 * 1024 + 100) / 44100.0
    sig = 0.4 * np.sin(2 * np.pi * 520 * t) + 0.02 * rng.standard_normal(
        t.shape[0])
    pcm = np.clip(np.stack([sig, sig], 1) * 32767,
                  -32768, 32767).astype(np.int16)
    eng = Engine(CodecConfig(window="kbd"), rate_mode="cbr")
    blob = eng.encode(pcm)
    _, batch = eng.decode(blob)
    dec = StreamingDecoder(window="kbd", chunk_blocks=16)
    parts = [dec.push(blob[:97]), dec.push(blob[97:]), dec.flush()]
    out = np.concatenate([p for p in parts if p.size], axis=0)
    np.testing.assert_array_equal(out, batch)


# -- variant interaction matrix ----------------------------------------------


@pytest.mark.parametrize("combo", [
    dict(window="kbd", ms_decision="bitalloc"),
    dict(window="kbd", alloc_mode="closed_form", peak_mode="para"),
    dict(ms_decision="bitalloc", alloc_mode="closed_form", rate="cbr"),
    dict(window="kbd", n_channels=1),
    dict(sample_rate=48000, window="kbd", ms_decision="bitalloc"),
    dict(n_channels=1, alloc_mode="closed_form", peak_mode="weighted",
         rate="cbr"),
], ids=lambda c: "+".join(f"{k}={v}" for k, v in c.items()))
def test_variant_interactions_roundtrip(combo):
    """Every variant dimension must COMPOSE with the others, not just work
    alone: encode->decode round-trips with deterministic bytes and sane
    reconstruction for mixed flag settings (mono x kbd, bitalloc x
    closed-form x cbr, 48 kHz x kbd x bitalloc, ...)."""
    from pactpu.codec.engine import Engine

    combo = dict(combo)
    rate = combo.pop("rate", "reservoir")
    fs = combo.pop("sample_rate", 44100)
    chans = combo.pop("n_channels", 2)
    cfg = CodecConfig(sample_rate=fs, n_channels=chans, **combo)
    eng = Engine(cfg=cfg, rate_mode=rate)

    rng = np.random.default_rng(7)
    n = 1024 * 4 - 111
    t = np.arange(n) / fs
    sig = (0.45 * np.sin(2 * np.pi * 440 * t)
           + 0.12 * np.sin(2 * np.pi * 2900 * t)
           + 0.02 * rng.standard_normal(n))
    cols = [sig, 0.7 * sig][:chans]
    pcm = np.clip(np.stack(cols, 1) * 32767, -32768, 32767).astype(np.int16)

    stream = eng.encode(pcm)
    assert eng.encode(pcm) == stream            # deterministic bytes
    fs2, out = eng.decode(stream)
    assert fs2 == fs and out.shape == pcm.shape
    err = out.astype(np.float64) - pcm.astype(np.float64)
    snr = 10 * np.log10(
        np.sum(pcm.astype(np.float64) ** 2) / max(np.sum(err ** 2), 1.0))
    # stereo decode embeds the reference's M/S aliasing (SURVEY.md §8.1),
    # which caps SNR on wide material; mono has no such cap
    assert snr > (10.0 if chans == 1 else 1.0), snr


# ---------------------------------------------------------------------------
# legacy allocators as engine modes (round-4 VERDICT weak #4)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tone_pcm():
    rng = np.random.default_rng(11)
    n = 3 * 1024 + 200
    t = np.arange(n) / 44100.0
    sig = np.stack([np.sin(2 * np.pi * 440 * t),
                    np.sin(2 * np.pi * 660 * t)], 1) * 18000
    return np.clip(sig + rng.standard_normal((n, 2)) * 200,
                   -32768, 32767).astype(np.int16)


def test_legacy_batch_allocators_match_single():
    """The batched engine formulations reproduce the single-row op-layer
    allocators (which are parity-tested against reference
    codec/bitalloc.py:22-125) row for row."""
    import numpy as np
    from pactpu.ops import bitalloc as ba_ops

    rng = np.random.default_rng(5)
    layout = CodecConfig().band_layout
    nl = np.asarray(layout.n_lines, np.int32)
    budgets = np.asarray([900, 2200, 3100], np.int32)
    smr = rng.uniform(-20, 60, (3, 25)).astype(np.float32)

    uni = np.asarray(ba_ops.alloc_uniform_batch(budgets, 16, nl, 12800))
    snr = np.asarray(ba_ops.alloc_const_snr_batch(budgets, 16, nl, smr,
                                                  12800))
    mnr = np.asarray(ba_ops.alloc_const_mnr_batch(budgets, 16, nl, smr,
                                                  12800))
    for i, b in enumerate(budgets):
        np.testing.assert_array_equal(
            uni[i], np.asarray(ba_ops.alloc_uniform(int(b), 16, nl)))
        np.testing.assert_array_equal(
            snr[i], np.asarray(ba_ops.alloc_const_snr(int(b), 16, nl,
                                                      smr[i])))
        np.testing.assert_array_equal(
            mnr[i], np.asarray(ba_ops.alloc_const_mnr(int(b), 16, nl,
                                                      smr[i])))


@pytest.mark.parametrize("mode", ["uniform", "const_snr", "const_mnr"])
def test_legacy_alloc_engine_roundtrip(mode, tone_pcm):
    """Each legacy allocator is a real engine/CLI mode: the stream
    round-trips and decodes to something SNR-sane."""
    import dataclasses
    import numpy as np

    from pactpu.codec.engine import Engine
    cfg = dataclasses.replace(CodecConfig(), alloc_mode=mode)
    eng = Engine(cfg=cfg, rate_mode="cbr")
    stream = eng.encode(tone_pcm)
    fs, out = eng.decode(stream)
    assert fs == 44100 and out.shape == tone_pcm.shape
    n = min(len(out), len(tone_pcm))
    x = tone_pcm[:n].astype(np.float64)
    e = x - out[:n].astype(np.float64)
    snr = 10 * np.log10((x ** 2).sum() / max((e ** 2).sum(), 1e-9))
    assert snr > 10, f"{mode}: SNR {snr:.1f} dB"


def test_legacy_alloc_cli_flag(tone_pcm, tmp_path):
    from pactpu.codec import cli
    from pactpu.codec.wav import write_wav

    p = tmp_path / "t.wav"
    write_wav(str(p), 44100, tone_pcm)
    rc = cli.main(["encode", str(p), str(tmp_path / "t.wak"),
                   "--rate", "cbr", "--alloc-mode", "const_mnr"])
    assert rc == 0 and (tmp_path / "t.wak").exists()


def _dot_precisions(jaxpr) -> list:
    """Precision of every dot_general in a jaxpr, sub-jaxprs included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found.extend(_dot_precisions(inner))
    return found


def test_closed_form_matmul_pinned_highest():
    """`smr @ nLines` in the closed-form allocator is pinned to HIGHEST:
    a TF32 product on the GPU could move floor boundaries."""
    import jax
    smr = jnp.zeros((4, LAYOUT.n_bands), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda s: ba_ops.closed_form_init(
        jnp.full(4, 3000, jnp.int32), 16,
        jnp.asarray(LAYOUT.n_lines_array), s))(smr)
    precs = _dot_precisions(jaxpr.jaxpr)
    assert precs and all(p == (jax.lax.Precision.HIGHEST,) * 2
                         for p in precs), precs


def test_closed_form_unchanged_on_grid():
    """On dyadic-grid SMRs the pinned product is exact, so the raw
    allocation R equals the float64 formula and the allocation equals
    kai's restatement on every row."""
    rng = np.random.default_rng(4)
    smr = _grid_smr(rng, 16)
    budget = rng.integers(500, 4000, 16).astype(np.int32)
    nl = LAYOUT.n_lines_array.astype(np.float64)
    _, r_dev = ba_ops.closed_form_init(
        jnp.asarray(budget), 16, jnp.asarray(LAYOUT.n_lines_array),
        jnp.asarray(smr))
    avg = (smr.astype(np.float64) @ nl) / nl.sum()
    r_ref = budget[:, None] / nl.sum() + (smr - avg[:, None]) / 6.0
    np.testing.assert_allclose(np.asarray(r_dev), r_ref, rtol=0, atol=1e-5)
    bits = np.asarray(ba_ops.alloc_closed_form(
        jnp.asarray(budget), 16, jnp.asarray(LAYOUT.n_lines_array),
        jnp.asarray(smr)))
    near = (np.abs(r_ref - np.round(r_ref)) < 1e-4).any(axis=1)
    for row in np.nonzero(~near)[0]:
        np.testing.assert_array_equal(
            bits[row], kai_bit_alloc(int(budget[row]), 16,
                                     LAYOUT.n_lines_array, smr[row]))


def test_exact_cost_einsum_pinned_highest():
    """The exact mode's band-cost contraction states HIGHEST too (exact in
    any precision, since lengths are small integers)."""
    import jax
    from pactpu.codec import exact
    from pactpu.codec.engine import engine_consts_np
    body = exact.cost_table_body(CFG)
    mixed = jnp.zeros((2, 2, CFG.n_mdct_lines), jnp.float32)
    tabs = engine_consts_np(CFG)["tabs"]
    jaxpr = jax.make_jaxpr(lambda m: body({"mixed": m},
                                          {"tabs": tabs}))(mixed)
    precs = _dot_precisions(jaxpr.jaxpr)
    assert precs and all(p == (jax.lax.Precision.HIGHEST,) * 2
                         for p in precs), precs

"""Seeded synthetic music for tests, smoke runs and benchmarks.

The reference corpus (SURVEY.md §4: piano, harpsichord, trumpet,
castanets, speech, pop, rock at 44.1 kHz stereo) is not part of this
repository, so inputs are generated from a seed.  Four classes stand in
for the corpus's kinds of material, each exercising a different part of
the codec:

- "tonal":     harmonic notes with decaying envelopes (piano, harpsichord,
               trumpet) — few strong maskers, long-lived partials;
- "transient": a train of short percussive bursts over near-silence
               (castanets) — quiet passages feed the bit reservoir, the
               attacks drain it;
- "speech":    a jittered glottal pulse train through moving formant
               resonators, with pauses — near-mono, so M/S coding wins;
- "dense":     pinkish noise, sustained chords and a beat, decorrelated
               between channels (pop, rock) — many maskers per block and
               the largest payloads.

`generate` concatenates segments that cycle through the classes;
`class_signal` renders one class.  Every parameter below is ASSUMED (no
measurement of the corpus backs it): it is chosen to fall in the range
such material has, not fitted to any recording.  Output is int16 [n, C].
"""

from __future__ import annotations

import numpy as np

CLASSES = ("tonal", "transient", "speech", "dense")

# assumed: length of one class segment in `generate`
SEGMENT_SECONDS = 15.0
# assumed: RMS level of a segment, dBFS (peaks land ~10-15 dB above)
LEVEL_DBFS = -20.0


def _lfilter(b, a, x):
    from scipy.signal import lfilter
    return lfilter(b, a, x)


def _resonator(freq: float, bw: float, fs: int):
    """Two-pole resonator (b, a) at `freq` Hz with bandwidth `bw` Hz."""
    r = np.exp(-np.pi * bw / fs)
    a = [1.0, -2.0 * r * np.cos(2 * np.pi * freq / fs), r * r]
    return [1.0 - r], a


def _tonal(rng, n: int, fs: int, c: int) -> np.ndarray:
    out = np.zeros((c, n))
    t0 = 0
    while t0 < n:
        # assumed: note onsets every 0.25-1.2 s, decay 0.3-1.5 s,
        # fundamentals 110-880 Hz, 10 partials at 1/k^1.3 with slight
        # inharmonicity, random pan
        dur = int(rng.uniform(0.25, 1.2) * fs)
        ring = min(n - t0, int(2.5 * fs))
        t = np.arange(ring) / fs
        f0 = 110.0 * 2 ** rng.uniform(0, 3)
        tau = rng.uniform(0.3, 1.5)
        note = np.zeros(ring)
        for k in range(1, 11):
            fk = f0 * k * np.sqrt(1 + 2e-4 * k * k)
            if fk > 0.45 * fs:
                break
            note += (k ** -1.3) * np.sin(2 * np.pi * fk * t
                                         + rng.uniform(0, 2 * np.pi))
        env = np.exp(-t / tau) * np.minimum(1.0, t / 0.004)
        pan = rng.uniform(0.2, 0.8)
        gains = (np.sqrt(1 - pan), np.sqrt(pan))[:c]
        for ch in range(c):
            out[ch, t0:t0 + ring] += gains[ch] * note * env
        t0 += dur
    return out


def _transient(rng, n: int, fs: int, c: int) -> np.ndarray:
    out = np.zeros((c, n))
    # assumed: bursts every 60-300 ms, 1-3 ms attack, 8-40 ms decay,
    # high-passed noise (castanet-like), over a -60 dB noise floor
    hp_b, hp_a = [1.0, -1.0], [1.0, -0.85]
    t0 = int(rng.uniform(0, 0.1) * fs)
    while t0 < n:
        ln = min(n - t0, int(0.12 * fs))
        t = np.arange(ln) / fs
        att = rng.uniform(0.001, 0.003)
        env = np.minimum(1.0, t / att) * np.exp(-t / rng.uniform(0.008, 0.04))
        burst = _lfilter(hp_b, hp_a, rng.standard_normal(ln)) * env
        amp = rng.uniform(0.3, 1.0)
        pan = rng.uniform(0.3, 0.7)
        gains = (np.sqrt(1 - pan), np.sqrt(pan))[:c]
        for ch in range(c):
            out[ch, t0:t0 + ln] += amp * gains[ch] * burst
        t0 += int(rng.uniform(0.06, 0.3) * fs)
    out += 1e-3 * rng.standard_normal((c, n))
    return out


def _speech(rng, n: int, fs: int, c: int) -> np.ndarray:
    # assumed: f0 90-220 Hz with 5 Hz vibrato and 1% jitter, syllables of
    # 120-320 ms with three formants (F1 300-800, F2 900-2300, F3
    # 2400-3200 Hz), 20% of syllables silent, breath noise at -30 dB
    sig = np.zeros(n)
    t0 = 0
    f0 = rng.uniform(90, 220)
    phase = 0.0
    while t0 < n:
        ln = min(n - t0, int(rng.uniform(0.12, 0.32) * fs))
        if rng.random() < 0.2:
            t0 += ln
            continue
        t = np.arange(ln) / fs
        f = f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t)) * (
            1 + 0.01 * rng.standard_normal())
        ph = phase + np.cumsum(f) / fs
        pulses = np.diff(np.floor(ph), prepend=np.floor(phase)) > 0
        phase = ph[-1]
        src = pulses.astype(float) + 0.03 * rng.standard_normal(ln)
        src = _lfilter([1.0], [1.0, -0.9], src)      # glottal roll-off
        y = np.zeros(ln)
        for lo, hi, bw in ((300, 800, 80), (900, 2300, 120),
                           (2400, 3200, 180)):
            b, a = _resonator(rng.uniform(lo, hi), bw, fs)
            y += _lfilter(b, a, src)
        env = np.sin(np.pi * np.arange(ln) / ln) ** 0.5
        sig[t0:t0 + ln] = y * env
        t0 += ln
    out = np.tile(sig, (c, 1))
    if c == 2:
        out[1] = 0.95 * out[1] + 0.002 * rng.standard_normal(n)
    return out


def _dense(rng, n: int, fs: int, c: int) -> np.ndarray:
    # assumed: pink-ish noise (first-order lowpass of white) decorrelated
    # per channel at about -6 dB under the chords, 4-note chords changing
    # every 2 s, a decaying 60->40 Hz kick every 0.5 s
    out = np.zeros((c, n))
    for ch in range(c):
        out[ch] = 0.5 * _lfilter([0.1], [1.0, -0.9], rng.standard_normal(n))
    t = np.arange(n) / fs
    span = int(2.0 * fs)
    for s in range(0, n, span):
        e = min(n, s + span)
        for _ in range(4):
            f = 82.0 * 2 ** rng.uniform(0, 3.5)
            for ch in range(c):
                out[ch, s:e] += 0.15 * np.sin(
                    2 * np.pi * f * t[s:e] * (1 + 0.001 * ch)
                    + rng.uniform(0, 2 * np.pi))
    beat = int(0.5 * fs)
    tk = np.arange(min(beat, n)) / fs
    kick = np.sin(2 * np.pi * (60 * tk - 100 * tk * tk)) * np.exp(-tk / 0.08)
    for s in range(0, n, beat):
        ln = min(kick.shape[0], n - s)
        out[:, s:s + ln] += 0.8 * kick[:ln]
    return out


_RENDER = {"tonal": _tonal, "transient": _transient, "speech": _speech,
           "dense": _dense}


def _to_pcm16(x: np.ndarray) -> np.ndarray:
    """[C, n] float -> int16 [n, C] at LEVEL_DBFS RMS, or lower where
    that would put the peak above -1 dBFS."""
    rms = np.sqrt(np.mean(x * x)) or 1.0
    peak = np.max(np.abs(x)) or 1.0
    gain = min(10 ** (LEVEL_DBFS / 20) / rms, 10 ** (-1 / 20) / peak)
    y = x * gain * 32768.0
    return np.clip(np.rint(y), -32768, 32767).astype(np.int16).T.copy()


def class_signal(name: str, seconds: float, seed: int = 0,
                 sample_rate: int = 44100, channels: int = 2) -> np.ndarray:
    """One class of material, int16 [round(seconds * fs), channels]."""
    n = int(round(seconds * sample_rate))
    rng = np.random.default_rng([seed, CLASSES.index(name)])
    return _to_pcm16(_RENDER[name](rng, n, sample_rate, channels))


def generate(seconds: float, seed: int = 0, sample_rate: int = 44100,
             channels: int = 2) -> np.ndarray:
    """A programme of SEGMENT_SECONDS segments cycling through CLASSES,
    int16 [round(seconds * fs), channels]."""
    n = int(round(seconds * sample_rate))
    seg = int(SEGMENT_SECONDS * sample_rate)
    parts = []
    for k, s in enumerate(range(0, n, seg)):
        name = CLASSES[k % len(CLASSES)]
        ln = min(seg, n - s)
        rng = np.random.default_rng([seed, k, CLASSES.index(name)])
        parts.append(_to_pcm16(_RENDER[name](rng, ln, sample_rate,
                                             channels)))
    return np.concatenate(parts)

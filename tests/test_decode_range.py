"""Random-access range decode (Engine.decode_range): the nBytes framing
makes streams seekable (reference codec/pacfile.py:170-183 — a property
the reference driver never exploits); any sample window must decode
byte-identically to the same slice of a full decode, touching only the
coded blocks the window needs."""

import numpy as np
import pytest

from pactpu.codec.engine import Engine
from pactpu.utils.config import CodecConfig


def _pcm(n=9 * 1024 + 321, channels=2, seed=4):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    chans = [np.sin(2 * np.pi * f * t) for f in (440, 663)[:channels]]
    sig = np.stack(chans, 1) * 19000 + rng.standard_normal(
        (n, channels)) * 400
    return np.clip(sig, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def stereo_case():
    pcm = _pcm()
    eng = Engine()
    stream = eng.encode(pcm)
    fs, full = eng.decode(stream)
    return eng, stream, fs, full


WINDOWS = [(0, 500), (0, 1024), (100, 2000), (1023, 2), (1024, 1024),
           (5000, 4096), (-50, 200), (8 * 1024, 3000)]


def test_range_equals_full_slices(stereo_case):
    eng, stream, fs, full = stereo_case
    n = full.shape[0]
    for s0, cnt in WINDOWS + [(n - 700, 700), (n - 1, 1), (0, n),
                              (n - 1, 99)]:
        fs2, part = eng.decode_range(stream, s0, cnt)
        lo = max(0, s0)
        assert fs2 == fs
        np.testing.assert_array_equal(part, full[lo:lo + cnt + min(s0, 0)],
                                      err_msg=f"window {s0}:{cnt}")


def test_range_empty_and_past_eof(stereo_case):
    eng, stream, fs, full = stereo_case
    n = full.shape[0]
    assert eng.decode_range(stream, 100, 0)[1].shape == (0, 2)
    assert eng.decode_range(stream, n + 5, 10)[1].shape == (0, 2)
    # window straddling EOF clamps
    _, part = eng.decode_range(stream, n - 10, 1000)
    np.testing.assert_array_equal(part, full[n - 10:])


def test_range_device_parse(stereo_case, monkeypatch):
    eng, stream, fs, full = stereo_case
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "device")
    for s0, cnt in ((100, 2000), (8 * 1024, 3000)):
        _, part = eng.decode_range(stream, s0, cnt)
        np.testing.assert_array_equal(part, full[s0:s0 + cnt])


def test_range_never_touches_later_blocks(stereo_case):
    """Seek means seek: corrupting every byte past the needed blocks must
    not affect (or even be read by) a head-window decode."""
    eng, stream, fs, full = stereo_case
    bad = bytearray(stream)
    cut = len(bad) // 2
    for i in range(cut, len(bad)):
        bad[i] = 0xAA
    _, part = eng.decode_range(bytes(bad), 0, 2048)
    np.testing.assert_array_equal(part, full[:2048])


def test_range_mono_and_pac(monkeypatch):
    for eng, pcm in ((Engine(cfg=CodecConfig(n_channels=1)),
                      _pcm(channels=1)),
                     (Engine(rate_mode="cbr", fmt="pac"), _pcm())):
        stream = eng.encode(pcm)
        _, full = eng.decode(stream)
        for s0, cnt in ((0, 900), (3000, 2500), (full.shape[0] - 99, 99)):
            _, part = eng.decode_range(stream, s0, cnt)
            np.testing.assert_array_equal(part, full[s0:s0 + cnt],
                                          err_msg=f"{eng.fmt} {s0}:{cnt}")


def test_range_no_native(stereo_case, monkeypatch):
    """Range decode under the no-native contract (pure-Python framing is
    untouched; the device bit-walk parses the slice)."""
    eng, stream, fs, full = stereo_case
    monkeypatch.setenv("PACTPU_NO_NATIVE", "1")
    _, part = Engine().decode_range(stream, 2000, 3000)
    np.testing.assert_array_equal(part, full[2000:5000])


@pytest.mark.parametrize("parse", ["host", "device"])
def test_range_runs_full_decode_chunk_shapes(monkeypatch, parse):
    """Every frame of a window runs in a chunk program of the same shape
    as in the full decode (zero blocks pad around it), so backends whose
    matmul rounding depends on the row count still give identical
    samples; windows straddle chunk boundaries and reach the tail."""
    monkeypatch.setenv("PACTPU_DECODE_PARSE", parse)
    pcm = _pcm(n=530 * 1024 + 77)           # 532 frames: chunks 512 + 32
    eng = Engine(rate_mode="cbr")
    stream = eng.encode(pcm)
    shapes = []
    real = Engine._decode_staging

    def spy(self, data, layout=None):
        out = real(self, data, layout)
        shapes.append(list(out[4]))          # chunk sizes
        return out

    monkeypatch.setattr(Engine, "_decode_staging", spy)
    _, full = eng.decode(stream)
    full_shapes = shapes.pop()
    assert full_shapes == [512, 32]
    n = full.shape[0]
    for s0, cnt in ((100 * 1024 + 5, 2000), (510 * 1024, 4 * 1024),
                    (n - 3000, 3000)):
        _, part = eng.decode_range(stream, s0, cnt)
        np.testing.assert_array_equal(part, full[s0:s0 + cnt])
        used = shapes.pop()
        assert set(used) <= set(full_shapes), (s0, used)

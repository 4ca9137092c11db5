"""Seeded synthetic input (pactpu.utils.signals): deterministic per seed,
int16 stereo/mono of the requested length, every class audible and
unclipped."""

import numpy as np
import pytest

from pactpu.utils import signals


def test_generate_is_deterministic_per_seed():
    a = signals.generate(2.5, seed=3)
    b = signals.generate(2.5, seed=3)
    c = signals.generate(2.5, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (int(round(2.5 * 44100)), 2) and a.dtype == np.int16


@pytest.mark.parametrize("name", signals.CLASSES)
@pytest.mark.parametrize("channels", [1, 2])
def test_class_signal_levels(name, channels):
    x = signals.class_signal(name, 1.0, seed=1, channels=channels)
    assert x.shape == (44100, channels) and x.dtype == np.int16
    again = signals.class_signal(name, 1.0, seed=1, channels=channels)
    np.testing.assert_array_equal(x, again)
    peak = int(np.abs(x.astype(np.int32)).max())
    rms = float(np.sqrt(np.mean(x.astype(np.float64) ** 2)))
    assert peak < 32767                     # gain keeps the peak at -1 dBFS
    assert rms > 100.0                      # audible, not silence


def test_generate_cycles_classes():
    """Segments follow CLASSES in order: the first SEGMENT_SECONDS of a
    programme is the tonal class, the next the transient class."""
    seg = int(signals.SEGMENT_SECONDS * 44100)
    x = signals.generate(2 * signals.SEGMENT_SECONDS + 1.0, seed=0)
    assert x.shape[0] == 2 * seg + 44100
    # the transient class is mostly near-silence between bursts
    quiet = lambda a: np.mean(np.abs(a.astype(np.int32)) < 100)  # noqa: E731
    assert quiet(x[seg:2 * seg]) > quiet(x[:seg])

"""Corpus SNR parity in CI (VERDICT round-1 item 10).

Runs the full engine and the float64 reference-semantics oracle over a
diverse 5-file slice of the reference corpus (the QUALITY.md outliers
included: german/harmonic_test2 for the two-pass size gap, rock_test3 for
the worst observed ΔSNR, speech_test1 for the best) and asserts the
QUALITY.md numbers cannot silently regress: ΔSNR within ±0.25 dB, decode
agreement above 18 dB, and the engine stream within [0.70, 1.02] of the
oracle's size (the reservoir two-pass legitimately spends less on content
whose reference run dumps extras into saturated allocations; see
QUALITY.md).

Marked slow: ~2 min on CPU (the oracle is the cost).
"""

import numpy as np
import pytest

from pactpu.codec.engine import Engine
from pactpu.compat import refcodec as rc
from pactpu.codec.wav import read_wav
from pactpu.utils.config import CodecConfig
from conftest import REFERENCE, requires_reference

FILES = ["castanets.wav", "german.wav", "rock_test3.wav",
         "speech_test1.wav", "harmonic_test2.wav"]
MAX_BLOCKS = 160          # ~3.7 s per file keeps the oracle affordable

pytestmark = [pytest.mark.slow, requires_reference]


def _snr(a, b):
    n = min(len(a), len(b))
    a = a[:n].astype(np.float64)
    b = b[:n].astype(np.float64)
    err = np.sum((a - b) ** 2)
    return float("inf") if err <= 0 else \
        float(10.0 * np.log10(max(np.sum(a * a), 1e-12) / err))


@pytest.fixture(scope="module")
def engine():
    return Engine(CodecConfig())


@pytest.mark.parametrize("name", FILES)
def test_corpus_snr_and_size_parity(engine, name):
    cfg = engine.cfg
    pcm = read_wav(f"{REFERENCE}/inputs/{name}").samples
    pcm = pcm[: MAX_BLOCKS * cfg.n_mdct_lines]

    stream_e = engine.encode(pcm)
    _, dec_e = engine.decode(stream_e)
    stream_o = rc.encode_file(pcm, cfg.sample_rate, cfg)
    _, dec_o = rc.decode_file(stream_o)

    snr_e = _snr(pcm.reshape(-1), dec_e.reshape(-1))
    snr_o = _snr(pcm.reshape(-1), dec_o.reshape(-1))
    agree = _snr(dec_o.reshape(-1), dec_e.reshape(-1))
    ratio = len(stream_e) / len(stream_o)

    # asymmetric: regression below the oracle is the failure mode; a modest
    # upside is legitimate (the two-pass reservoir spends extras where the
    # reference would dump them into saturated allocations — speech content
    # with silence gaps measures up to ~+0.5 dB on this truncated slice)
    assert -0.25 <= snr_e - snr_o <= 1.0, \
        f"{name}: ΔSNR {snr_e - snr_o:+.3f} dB (engine {snr_e:.2f}, " \
        f"oracle {snr_o:.2f})"
    assert agree >= 18.0, f"{name}: decode agreement only {agree:.2f} dB"
    assert 0.70 <= ratio <= 1.02, \
        f"{name}: size ratio {ratio:.3f} ({len(stream_e)} vs {len(stream_o)})"

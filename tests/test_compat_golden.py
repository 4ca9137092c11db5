"""Golden parity of the compat oracle against the reference artifacts.

The strongest possible validation: the float64 oracle must reproduce the
checked-in reference bitstreams and decoded WAVs *byte-for-byte*
(reference coded/piano_test2.wak, outputs/piano_test2.wav).
"""

import numpy as np
import pytest

from pactpu.codec.wav import read_wav
from pactpu.compat import refcodec as rc
from conftest import REFERENCE, requires_reference


@pytest.fixture(scope="module")
def piano_wak() -> bytes:
    with open(f"{REFERENCE}/coded/piano_test2.wak", "rb") as f:
        return f.read()


@requires_reference
def test_decode_bit_exact_vs_golden_wav(piano_wak):
    fs, pcm = rc.decode_file(piano_wak)
    gold = read_wav(f"{REFERENCE}/outputs/piano_test2.wav")
    assert fs == gold.sample_rate
    assert len(pcm) == len(gold.samples)  # header numSamples trim
    np.testing.assert_array_equal(pcm, gold.samples)


@requires_reference
def test_encode_byte_exact_vs_golden_wak(piano_wak):
    wav = read_wav(f"{REFERENCE}/inputs/piano_test2.wav")
    out = rc.encode_file(wav.samples, wav.sample_rate)
    assert out == piano_wak


@requires_reference
def test_with_huffman_decodable_streams():
    """Provenance of coded/withHuffman/ (round-3 investigation, QUALITY.md
    'Golden artifact provenance'): three of its streams remain decodable
    with the shipped tables, and outputs/<name>.wav is THEIR decode —
    pinned here sample-exact for piano_test1."""
    with open(f"{REFERENCE}/coded/withHuffman/piano_test1.wak", "rb") as f:
        blob = f.read()
    fs, pcm = rc.decode_file(blob)
    gold = read_wav(f"{REFERENCE}/outputs/piano_test1.wav")
    assert fs == gold.sample_rate
    np.testing.assert_array_equal(pcm, gold.samples)
    # speech_test3 is byte-identical across the two golden families
    with open(f"{REFERENCE}/coded/withHuffman/speech_test3.wak", "rb") as a:
        with open(f"{REFERENCE}/coded/speech_test3.wak", "rb") as b:
            assert a.read() == b.read()


@requires_reference
def test_with_huffman_incompatible_streams_fail_cleanly():
    """The six withHuffman streams encoded with the (unrecoverable) older
    table state use codewords absent from the shipped tables: every decode
    path must reject them with ValueError, not crash."""
    from pactpu.codec.engine import Engine
    with open(f"{REFERENCE}/coded/withHuffman/rock.wak", "rb") as f:
        blob = f.read()
    with pytest.raises(ValueError):
        Engine(rate_mode="reservoir").decode(blob)
    with pytest.raises(ValueError):
        rc.decode_file(blob)


@requires_reference
def test_header_roundtrip(piano_wak):
    cfg, num_samples, off = rc.read_header(piano_wak)
    assert cfg.sample_rate == 44100
    assert cfg.n_mdct_lines == 1024
    assert cfg.band_layout.n_bands == 25
    header, n2 = rc.write_header(cfg, 176224)
    assert header == piano_wak[:off]
    assert n2 == num_samples

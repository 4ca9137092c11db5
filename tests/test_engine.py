"""End-to-end engine vs the byte-exact reference oracle.

Parity bar (BASELINE.json): SNR of the engine's decoded output must match
the reference pipeline at equal bit budget; streams must interoperate both
ways (engine stream decodable by the oracle and vice versa).
"""

import numpy as np
import pytest

from pactpu.codec.engine import Engine
from pactpu.codec.wav import read_wav, pcm16_to_float_np
from pactpu.compat import refcodec as rc
from conftest import REFERENCE, requires_reference


def _snr(ref_pcm: np.ndarray, test_pcm: np.ndarray) -> float:
    n = min(len(ref_pcm), len(test_pcm))
    x = pcm16_to_float_np(ref_pcm[:n].astype(np.int64))
    y = pcm16_to_float_np(test_pcm[:n].astype(np.int64))
    return 10 * np.log10(np.sum(x ** 2) / max(np.sum((x - y) ** 2), 1e-30))


@pytest.fixture(scope="module")
def piano():
    return read_wav(f"{REFERENCE}/inputs/piano_test2.wav")


@pytest.fixture(scope="module")
def engine_stream(piano):
    return Engine(rate_mode="reservoir").encode(piano.samples)


@requires_reference
def test_snr_parity_with_reference(piano, engine_stream):
    """Engine codec SNR equals the reference codec SNR at equal budget."""
    eng = Engine()
    _, pcm_eng = eng.decode(engine_stream)
    ref_out = read_wav(f"{REFERENCE}/outputs/piano_test2.wav").samples
    snr_eng = _snr(piano.samples, pcm_eng)
    snr_ref = _snr(piano.samples, ref_out)
    assert snr_eng >= snr_ref - 0.05, (snr_eng, snr_ref)


@requires_reference
def test_rate_within_reference_budget(piano, engine_stream):
    gold = open(f"{REFERENCE}/coded/piano_test2.wak", "rb").read()
    assert len(engine_stream) <= 1.02 * len(gold)


@requires_reference
def test_stream_interop_engine_to_oracle(engine_stream):
    """The oracle (bit-exact reference semantics) decodes engine streams."""
    eng = Engine()
    _, pcm_eng = eng.decode(engine_stream)
    _, pcm_oracle = rc.decode_file(engine_stream)
    assert len(pcm_eng) == len(pcm_oracle)  # both trim to header numSamples
    diff = np.abs(pcm_eng.astype(np.int32) - pcm_oracle.astype(np.int32))
    assert diff.max() <= 1  # f32 vs f64 IMDCT rounding


@requires_reference
def test_engine_decodes_golden_reference_stream(piano):
    """The engine decodes a reference-produced golden .wak identically to
    the golden decoded WAV (modulo f32 IMDCT rounding)."""
    gold = open(f"{REFERENCE}/coded/piano_test2.wak", "rb").read()
    _, pcm = Engine().decode(gold)
    gwav = read_wav(f"{REFERENCE}/outputs/piano_test2.wav").samples
    assert len(pcm) == len(gwav)  # decode-length parity with the reference
    diff = np.abs(pcm.astype(np.int32) - gwav.astype(np.int32))
    assert diff.max() <= 1
    assert float(np.mean(diff > 0)) < 2e-3


def test_cbr_mode_roundtrip():
    rng = np.random.default_rng(0)
    t = np.arange(8192) / 44100.0
    sig = (0.4 * np.sin(2 * np.pi * 440 * t)
           + 0.1 * np.sin(2 * np.pi * 2030 * t)
           + 0.02 * rng.standard_normal(8192))
    pcm = np.clip(sig * 20000, -32767, 32767).astype(np.int16)
    pcm = np.stack([pcm, np.roll(pcm, 7)], axis=1)
    eng = Engine(rate_mode="cbr")
    stream = eng.encode(pcm)
    fs, out = eng.decode(stream)
    assert fs == 44100
    assert _snr(pcm, out) > 0.0  # decodes into correlated audio


def test_chunk_sizes_tail_bucketing():
    """Per-chunk sizes: full chunks + a bucketed tail, never exceeding the
    chunk, covering at least b blocks (padded blocks stay off the link)."""
    from pactpu.codec.engine import _chunk_sizes, _TAIL_BUCKETS
    assert _chunk_sizes(512, 512) == [512]
    assert _chunk_sizes(618, 512) == [512, 128]
    assert _chunk_sizes(337, 512) == [384]
    assert _chunk_sizes(1025, 512) == [512, 512, 16]
    assert _chunk_sizes(5, 16) == [16]
    assert _chunk_sizes(20, 20) == [20]
    assert _chunk_sizes(27, 20) == [20, 16]
    for b in (1, 15, 16, 17, 96, 97, 511, 512, 513, 1000, 2049):
        for chunk in (16, 64, 512):
            sizes = _chunk_sizes(b, chunk)
            assert sum(sizes) >= b
            assert all(1 <= s <= chunk for s in sizes)
            assert all(s == chunk or s in _TAIL_BUCKETS or s == chunk
                       for s in sizes)
            assert sum(sizes) - b < chunk  # bounded padding


def test_encode_many_decode_many_match_serial():
    """The batch throughput APIs produce byte/sample-identical results to
    serial encode/decode calls."""
    import numpy as np
    from pactpu.codec.engine import Engine
    rng = np.random.default_rng(8)
    t = np.arange(3 * 1024) / 44100.0
    files = []
    for k in range(3):
        sig = (0.4 * np.sin(2 * np.pi * (300 + 200 * k) * t)
               + 0.03 * rng.standard_normal(t.shape[0]))
        files.append(np.clip(np.stack([sig, 0.7 * sig], 1) * 32767,
                             -32768, 32767).astype(np.int16))
    eng = Engine(rate_mode="reservoir")
    serial = [eng.encode(p) for p in files]
    batch = eng.encode_many(files)
    assert batch == serial
    dec_serial = [eng.decode(s) for s in serial]
    dec_batch = eng.decode_many(batch)
    for (fs_a, a), (fs_b, bb) in zip(dec_serial, dec_batch):
        assert fs_a == fs_b
        np.testing.assert_array_equal(a, bb)
    # the pipelined roundtrip path: same bytes, same samples
    results, streams = eng.roundtrip_many(files, return_streams=True)
    assert streams == serial
    for (fs_a, a), (fs_b, bb) in zip(dec_serial, results):
        assert fs_a == fs_b
        np.testing.assert_array_equal(a, bb)

def test_cfg_property_validates_and_invalidates_consts():
    """Replacing eng.cfg must re-run the mode-compatibility checks (the
    CLI adapts a constructed engine to the input file) and drop the
    cached device constants, which derive from the config."""
    import dataclasses as dc

    import pytest

    eng = Engine(rate_mode="exact", precision="f64")
    with pytest.raises(ValueError, match="1 or 2"):
        eng.cfg = dc.replace(eng.cfg, n_channels=3)
    with pytest.raises(ValueError, match="water-filling"):
        eng.cfg = dc.replace(eng.cfg, alloc_mode="closed_form")
    with pytest.raises(ValueError, match="sine"):
        eng.cfg = dc.replace(eng.cfg, window="kbd")
    with pytest.raises(ValueError, match="unknown window"):
        eng.cfg = dc.replace(eng.cfg, window="hann")

    eng2 = Engine()
    c1 = eng2.consts()
    eng2.cfg = dc.replace(eng2.cfg, sample_rate=48000)
    assert eng2.consts() is not c1          # stale tables dropped

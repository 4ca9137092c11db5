"""Bitstream format coverage: baseline .pac layout + CLI driver."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from pactpu.codec.engine import Engine
from pactpu.codec.wav import read_wav
from pactpu.utils.config import CodecConfig
from conftest import REFERENCE, requires_reference


@requires_reference
@pytest.mark.parametrize("name", ["harpsichord", "trumpet"])
def test_decode_golden_baseline_pac(name):
    """Engine decodes reference baseline-coder .pac artifacts to within
    1 LSB of the checked-in golden decoded WAVs."""
    eng = Engine(fmt="pac")
    with open(f"{REFERENCE}/coded/{name}.pac", "rb") as f:
        data = f.read()
    _, pcm = eng.decode(data)
    gold = read_wav(f"{REFERENCE}/outputs/{name}.wav").samples
    assert len(pcm) == len(gold)  # decode-length parity with the reference
    diff = np.abs(pcm.astype(np.int32) - gold.astype(np.int32))
    assert diff.max() <= 1
    assert float(np.mean(diff > 0)) < 2e-3


def test_baseline_roundtrip_snr():
    rng = np.random.default_rng(2)
    t = np.arange(32768) / 44100.0
    sig = 0.5 * np.sin(2 * np.pi * 660 * t) + 0.01 * rng.standard_normal(
        len(t))
    pcm = np.clip(sig * 24000, -32767, 32767).astype(np.int16)
    pcm = np.stack([pcm, pcm], axis=1)
    cfg = dataclasses.replace(CodecConfig(), target_bits_per_sample=4.93)
    eng = Engine(cfg=cfg, fmt="pac")
    stream = eng.encode(pcm)
    _, out = eng.decode(stream)
    n = min(len(out), len(pcm))
    x = pcm[:n, 0].astype(np.float64)
    y = out[:n, 0].astype(np.float64)
    snr = 10 * np.log10(np.sum(x ** 2) / max(np.sum((x - y) ** 2), 1e-30))
    assert snr > 15.0


@requires_reference
def test_cli_roundtrip(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    src = f"{REFERENCE}/inputs/piano_test2.wav"
    out = subprocess.run(
        [sys.executable, "-m", "pactpu", "roundtrip", src,
         "--outdir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=540,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "piano_test2.wak").exists()
    dec = read_wav(str(tmp_path / "piano_test2_decoded.wav"))
    assert dec.sample_rate == 44100
    assert dec.num_samples > 0


@requires_reference
def test_device_packer_byte_exact_vs_native():
    """The on-device bit packer produces byte-identical streams to the
    native serial packer (csrc/wakbits.cc) on real encode outputs."""
    wav = read_wav(f"{REFERENCE}/inputs/harpsichord.wav")
    pcm = wav.samples[: 1024 * 40]
    host = Engine(rate_mode="cbr", device_pack=False).encode(pcm)
    dev = Engine(rate_mode="cbr", device_pack=True).encode(pcm)
    assert dev == host


def test_device_packer_roundtrip_without_reference():
    rng = np.random.default_rng(11)
    t = np.arange(65536) / 44100.0
    sig = 0.4 * np.sin(2 * np.pi * 523 * t) + 0.02 * rng.standard_normal(
        len(t))
    pcm = np.clip(sig * 24000, -32767, 32767).astype(np.int16)
    pcm = np.stack([pcm, np.roll(pcm, 11)], axis=1)
    eng = Engine(rate_mode="reservoir", device_pack=True)
    stream = eng.encode(pcm)
    fs, out = eng.decode(stream)
    assert fs == 44100 and out.shape[0] >= pcm.shape[0]

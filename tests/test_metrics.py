"""Observability: EncodeStats consistency with the engine outputs."""

import json

import numpy as np
import pytest

from pactpu.codec.engine import Engine
from pactpu.utils.metrics import StageTimer, collect_encode_stats


@pytest.fixture(scope="module")
def pcm() -> np.ndarray:
    rng = np.random.default_rng(3)
    n = 5 * 1024
    t = np.arange(n)[:, None]
    x = (8000 * np.sin(2 * np.pi * 440 * t / 44100.0)
         + rng.normal(0, 800, (n, 2)))
    return np.clip(x, -32767, 32767).astype(np.int16)


def test_stats_match_stream_size(pcm):
    eng = Engine(rate_mode="reservoir")
    out, b = eng.encode_arrays(pcm)
    stats = collect_encode_stats(out, b, eng.cfg)

    assert stats.n_blocks == b == 6
    assert stats.bits_per_channel.shape == (b, 2)
    # payload bytes in the real stream = sum of per-channel ceil(bits/8)
    stream = eng.encode(pcm)
    from pactpu.compat import refcodec as rc
    _, _, off = rc.read_header(stream)
    payload_len = len(stream) - off
    nbytes = (stats.bits_per_channel + 7) // 8
    assert payload_len == int(nbytes.sum()) + 4 * 2 * b  # + length prefixes

    s = stats.summary()
    assert s["n_blocks"] == b
    assert 0.0 <= s["mean_ms_band_fraction"] <= 1.0
    assert set(s["table_usage"]) <= set(range(1, 11))
    json.loads(stats.to_json())  # serializable


def test_stats_host_pack_path_agrees(pcm):
    eng_dev = Engine(rate_mode="cbr")
    eng_host = Engine(rate_mode="cbr", device_pack=False)
    out_d, b = eng_dev.encode_arrays(pcm)
    out_h, b2 = eng_host.encode_arrays(pcm)
    assert b == b2
    s_d = collect_encode_stats(out_d, b, eng_dev.cfg)
    s_h = collect_encode_stats(out_h, b, eng_host.cfg)
    np.testing.assert_array_equal(s_d.bits_per_channel,
                                  s_h.bits_per_channel)
    np.testing.assert_array_equal(s_d.table_id, s_h.table_id)


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    rep = t.report()
    assert rep["a"]["calls"] == 2 and rep["b"]["calls"] == 1


def test_device_compute_bench_runs():
    """The device-compute benchmark must measure the
    same programs the engine dispatches and return sane positive rates."""
    from pactpu.utils.devbench import measure_device_compute

    res = measure_device_compute(blocks=16, iters=2)
    assert res["encode_blocks_per_s"] > 0
    assert res["decode_blocks_per_s"] > 0
    assert res["roundtrip_blocks_per_s"] <= min(
        res["encode_blocks_per_s"], res["decode_blocks_per_s"]) + 1e-6

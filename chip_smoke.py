"""Smoke run of the codec's main path on one GPU.

    python chip_smoke.py [--seed N]      # one card: the phases below
    python chip_smoke.py --chips 4       # four cards: sharded + fleet only

One process drives the card.  Phases, each printing one line (or a few)
when it finishes; any failure raises and the script exits non-zero:

1. device     — JAX must find a GPU (no CPU fallback); card name and
                power limit from nvidia-smi; whether the native bitstream
                library built from csrc/.
2. input      — 180 s of seeded 44.1 kHz 16-bit stereo music
                (pactpu.utils.signals), ~7,750 coded blocks.
3. main path  — Engine(rate_mode="reservoir") encode and decode of the
                whole file, one roundtrip_many over it and a 20 s slice,
                and one in-process `pactpu roundtrip` CLI call.
4. correctness — against the float64 oracle (pactpu.compat.refcodec):
                SNR parity per signal class, byte-identical exact f64
                encodes (stereo, mono), host-parse == device-parse
                decode, decode_range == the slice of a full decode.
5. kernels    — each hand-written kernel against its plain JAX version
                at the engine's shapes for a 512-block chunk.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SECONDS = 180.0
SLICE_SECONDS = 20.0
FLEET_SECONDS = 10.0
HALF = 1024                     # MDCT lines per block at the default config
SNR_SLACK_DB = 0.05             # the engine-vs-oracle bar of tests/test_engine


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu():
    """The JAX devices, if the first one is a GPU; otherwise exit."""
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devices[0].platform!r}")
    return devices


def card_line() -> str:
    """nvidia-smi's name and power limit of the card(s), from a child
    process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return " | ".join(ln.strip() for ln in out.stdout.splitlines()
                      if ln.strip())


def n_blocks(pcm) -> int:
    return -(-pcm.shape[0] // HALF) + 1


def snr_db(ref, test) -> float:
    import numpy as np
    n = min(len(ref), len(test))
    x = ref[:n].astype(np.float64)
    y = test[:n].astype(np.float64)
    return float(10 * np.log10(np.sum(x * x)
                               / max(np.sum((x - y) ** 2), 1e-30)))


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_device(count: int):
    devices = require_gpu()
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX found "
                         f"{len(devices)}")
    card = card_line()
    from pactpu import native
    d = devices[0]
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devices)}")
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] native library built from csrc/: {native.available()}")
    return devices, card


def phase_main_path(pcm, card: str):
    import jax
    import numpy as np

    from pactpu.codec import cli
    from pactpu.codec.engine import DEFAULT_CHUNK_BLOCKS, Engine
    from pactpu.codec.wav import read_wav, write_wav

    eng = Engine(rate_mode="reservoir")
    b = n_blocks(pcm)
    stream, t_enc0 = timed(lambda: eng.encode(pcm))
    (fs, out), t_dec0 = timed(lambda: eng.decode(stream))
    log(f"[main] cold (incl. compile): encode {t_enc0:.3f} s, "
        f"decode {t_dec0:.3f} s")
    stream2, t_enc = timed(lambda: eng.encode(pcm))
    (_, out2), t_dec = timed(lambda: eng.decode(stream))
    assert stream2 == stream, "encode is not deterministic"
    assert np.array_equal(out2, out), "decode is not deterministic"
    assert out.shape == pcm.shape and fs == 44100, (out.shape, fs)
    # low on wide stereo by design: the reference decoder's M/S aliasing
    # (L' = M - S, R' = M) is reproduced; phase 4 holds SNR to the oracle
    snr = snr_db(pcm, out)
    log(f"[main] encode: {b} blocks {t_enc:.4f} s "
        f"{b / t_enc:.1f} blocks/s [{card}]")
    log(f"[main] decode: {b} blocks {t_dec:.4f} s "
        f"{b / t_dec:.1f} blocks/s [{card}]")
    log(f"[main] stream {len(stream)} B, full-file SNR {snr:.3f} dB")

    sl = pcm[:int(SLICE_SECONDS * 44100)]
    ref_sl = eng.decode(eng.encode(sl))[1]         # also warms the shapes
    (res, streams), t_rt = timed(
        lambda: eng.roundtrip_many([pcm, sl], return_streams=True))
    assert streams[0] == stream and np.array_equal(res[0][1], out)
    assert np.array_equal(res[1][1], ref_sl)
    b_rt = b + n_blocks(sl)
    log(f"[main] roundtrip_many: {b_rt} blocks {t_rt:.4f} s "
        f"{b_rt / t_rt:.1f} blocks/s [{card}]")

    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "programme.wav")
        write_wav(wav, 44100, pcm)
        rc_, t_cli = timed(lambda: cli.main(
            ["roundtrip", wav, "--outdir", tmp]))
        assert rc_ == 0, rc_
        with open(os.path.join(tmp, "programme.wak"), "rb") as f:
            assert f.read() == stream, "CLI stream differs from Engine"
        cli_out = read_wav(os.path.join(tmp, "programme_decoded.wav"))
        assert np.array_equal(cli_out.samples, out), "CLI decode differs"
    log(f"[main] cli roundtrip: {b} blocks {t_cli:.4f} s "
        f"{b / t_cli:.1f} blocks/s (incl. WAV I/O) [{card}]")

    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[main] peak_bytes_in_use {peak} at DEFAULT_CHUNK_BLOCKS="
        f"{DEFAULT_CHUNK_BLOCKS}")
    return eng, stream, out


def phase_correctness(eng, stream, out, seed: int) -> None:
    import jax
    import numpy as np

    from pactpu.codec.engine import Engine
    from pactpu.compat import refcodec as rc
    from pactpu.utils import signals
    from pactpu.utils.config import CodecConfig

    for name in signals.CLASSES:
        x = signals.class_signal(name, 199 * HALF / 44100, seed)
        mine = snr_db(x, eng.decode(eng.encode(x))[1])
        oracle = snr_db(x, rc.decode_file(rc.encode_file(x, 44100))[1])
        assert mine >= oracle - SNR_SLACK_DB, (name, mine, oracle)
        log(f"[check] SNR {name}: engine {mine:.3f} dB, oracle "
            f"{oracle:.3f} dB ({n_blocks(x)} blocks)")

    for channels, name in ((2, "dense"), (1, "speech")):
        x = signals.class_signal(name, 39 * HALF / 44100, seed,
                                 channels=channels)
        cfg = CodecConfig(n_channels=channels)
        ref = rc.encode_file(x, 44100, cfg)
        with jax.enable_x64(True):
            mine = Engine(cfg=cfg, rate_mode="exact",
                          precision="f64").encode(x)
        assert mine == ref, f"exact f64 {channels}-channel differs"
        log(f"[check] exact f64 {channels}-channel: byte-identical to the "
            f"oracle ({len(ref)} B, {n_blocks(x)} blocks)")

    parsed = {}
    for mode in ("host", "device"):
        os.environ["PACTPU_DECODE_PARSE"] = mode
        try:
            eng.decode(stream)                # compiles this placement
            parsed[mode], t = timed(lambda: eng.decode(stream)[1])
        finally:
            os.environ.pop("PACTPU_DECODE_PARSE")
        log(f"[check] decode with {mode} parse: {t:.4f} s (warm)")
    assert np.array_equal(parsed["host"], parsed["device"])
    assert np.array_equal(parsed["host"], out)
    log("[check] host-parse == device-parse decode (sample-identical)")

    n = out.shape[0]
    for s0, cnt in ((0, 44100), (1_234_567, 100_000), (n - 5000, 10_000)):
        _, part = eng.decode_range(stream, s0, cnt)
        ref = out[s0:s0 + cnt]
        assert part.shape == ref.shape, (s0, cnt, part.shape, ref.shape)
        diff = np.abs(part.astype(np.int32) - ref.astype(np.int32))
        assert not diff.any(), (s0, cnt, int((diff > 0).sum()),
                                int(diff.max()))
    log("[check] decode_range == slice of the full decode (3 windows)")


def _time_op(fn, reps: int = 20) -> float:
    """Median seconds of fn() over `reps` runs after one warm-up, each
    ending in block_until_ready."""
    import jax
    import numpy as np
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_kernels(eng, pcm, card: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pactpu.codec import engine as E
    from pactpu.ops import bitalloc, pallas_ops

    cfg = eng.cfg
    chunk = E.DEFAULT_CHUNK_BLOCKS
    seg = np.zeros((cfg.n_channels, (chunk + 1) * HALF), np.int16)
    seg[:, HALF:] = pcm[:chunk * HALF].T
    a = E._chunk_analyze_fn(cfg)(jnp.asarray(seg), eng.consts())
    n_lines = jnp.asarray(cfg.band_layout.n_lines, jnp.int32)
    max_mant = min(1 << cfg.n_mant_size_bits, cfg.max_mant_bits)
    total = jnp.full(chunk, int(cfg.bit_budget()), jnp.int32)
    args = (total, max_mant, n_lines, a["smr"][:, 0], a["lrms"],
            cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)
    xla = jax.jit(bitalloc.water_fill_xla, static_argnums=(1, 5, 6))
    kb, kl = pallas_ops.water_fill(*args)
    rb, rl = xla(*args)
    assert np.array_equal(np.asarray(kb), np.asarray(rb)), "bits differ"
    assert np.array_equal(np.asarray(kl), np.asarray(rl)), "left differs"
    t_k = _time_op(lambda: pallas_ops.water_fill(*args))
    t_x = _time_op(lambda: xla(*args))
    log(f"[kernel] water_fill {chunk} rows x {cfg.n_bands} bands: "
        f"bit-identical; pallas-triton {1e3 * t_k:.4f} ms, "
        f"xla while_loop {1e3 * t_x:.4f} ms [{card}]")


def run_one_card(seed: int) -> list:
    devices, card = phase_device(1)
    from pactpu.utils import signals
    pcm, t_gen = timed(lambda: signals.generate(SECONDS, seed))
    log(f"[input] {SECONDS:.0f} s stereo 44.1 kHz int16, seed {seed}: "
        f"{pcm.shape[0]} samples, {n_blocks(pcm)} blocks "
        f"(generated in {t_gen:.2f} s)")
    eng, stream, out = phase_main_path(pcm, card)
    phase_correctness(eng, stream, out, seed)
    phase_kernels(eng, pcm, card)
    return devices


def run_four_cards(seed: int) -> list:
    import jax
    import numpy as np

    devices, card = phase_device(4)
    import __graft_entry__
    __graft_entry__.dryrun_multichip(4)

    from pactpu.codec.engine import Engine
    from pactpu.parallel.serve import DeviceFleet
    from pactpu.utils import signals
    # one file per card; equal lengths share one compiled chunk shape
    files = [signals.generate(FLEET_SECONDS, seed + k) for k in range(4)]
    fleet = DeviceFleet(devices=jax.devices()[:4])
    (res, streams), t = timed(
        lambda: fleet.roundtrip_many(files, return_streams=True))
    eng = Engine()
    for k, x in enumerate(files):
        ref = eng.encode(x)
        assert streams[k] == ref, f"fleet stream {k} differs"
        assert np.array_equal(res[k][1], eng.decode(ref)[1]), k
    b = sum(n_blocks(x) for x in files)
    log(f"[fleet] DeviceFleet(4).roundtrip_many: 4 files, {b} blocks "
        f"{t:.3f} s (incl. compile), byte-identical to one Engine [{card}]")
    return devices


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = p.parse_args(argv)
    run = run_four_cards if args.chips == 4 else run_one_card
    devices = run(args.seed)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark: encode+decode blocks/s on one device vs the reference pipeline.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

The workload is the BASELINE.json headline configuration — full encode ->
decode of 44.1 kHz stereo music (Huffman + M/S + reservoir path) at the
reference operating point, on seeded synthetic inputs
(pactpu.utils.signals: the castanet-like, dense-mix and speech classes).
`vs_baseline` is the speedup over the reference implementation's
semantics executed on this host's CPU (pactpu.compat.refcodec, the
bit-exact float64 re-statement of reference codec/pacfile.py), measured
on a slice each run.

The measurement runs in one child process under a watchdog; the parent
never touches JAX, so the child is the only process on the device.  A
failed or hung child fails the run: there is no fallback to another
backend.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

METRIC = ("encode+decode blocks/s/chip "
          "(44.1kHz stereo, Huffman+MS+reservoir)")
REPS = 5
INPUT_SECONDS = 10.0


def _card() -> str:
    """nvidia-smi's name and power limit of the cards ('' without one)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return " | ".join(ln.strip() for ln in out.stdout.splitlines()
                      if ln.strip())


def _measure() -> None:
    import jax
    import numpy as np

    from pactpu.codec.engine import Engine
    from pactpu.compat import refcodec as rc
    from pactpu.utils import signals
    from pactpu.utils.config import CodecConfig

    cfg = CodecConfig()
    half = cfg.n_mdct_lines
    dev = jax.devices()[0]
    inputs = [signals.class_signal(name, INPUT_SECONDS, seed)
              for seed, name in enumerate(("transient", "dense", "speech"))]

    eng = Engine(rate_mode="reservoir")
    for pcm in inputs:                         # warmup (compile)
        eng.decode(eng.encode(pcm))
    eng.roundtrip_many(inputs)

    from pactpu.utils.devbench import measure_device_compute
    device_compute = measure_device_compute(inputs[0], 512, 20, eng)

    rep_blocks = sum((-(-p.shape[0] // half) + 1) for p in inputs)
    serial, batch = [], []
    for _ in range(REPS):                      # interleaved serial / batch
        t0 = time.perf_counter()
        for pcm in inputs:
            eng.decode(eng.encode(pcm))
        serial.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        eng.roundtrip_many(inputs)
        batch.append(time.perf_counter() - t0)

    # reference-semantics baseline on a short slice (~40 blocks)
    slice_pcm = inputs[0][: 40 * half]
    t0 = time.perf_counter()
    rc.decode_file(rc.encode_file(slice_pcm, cfg.sample_rate, cfg))
    ref_blocks_per_s = ((-(-slice_pcm.shape[0] // half) + 1)
                        / (time.perf_counter() - t0))

    blocks_per_s = rep_blocks / float(np.median(serial))
    print(json.dumps({
        "metric": METRIC,
        "value": round(blocks_per_s, 2),
        "unit": "blocks/s",
        "vs_baseline": round(blocks_per_s / ref_blocks_per_s, 2),
        "value_is": "median_of_reps",
        "best_value": round(rep_blocks / min(serial), 2),
        "batch_api_value": round(rep_blocks / float(np.median(batch)), 2),
        "reps": REPS,
        "serial_s": [round(t, 4) for t in serial],
        "batch_s": [round(t, 4) for t in batch],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "device_compute": device_compute,
    }))


def main() -> int:
    if "--child" in sys.argv:
        _measure()
        return 0
    card = _card()
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"],
            capture_output=True, text=True, timeout=1500)
        lines = (out.stdout or "").strip().splitlines()
        result = json.loads(lines[-1]) if out.returncode == 0 else None
        error = (out.stderr or "").strip().splitlines()[-1:] or [
            f"child exited {out.returncode}"]
    except subprocess.TimeoutExpired:
        result, error = None, ["benchmark timed out"]
    except (json.JSONDecodeError, IndexError):
        result, error = None, ["child printed no result"]
    if result is None:
        print(json.dumps({"metric": METRIC, "value": 0.0,
                          "unit": "blocks/s", "vs_baseline": 0.0,
                          "card": card, "error": error[0]}))
        return 1
    result["card"] = card
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

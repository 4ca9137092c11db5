"""Single-device performance breakdown of the serving path.

Runs the full encode+decode pipeline over seeded synthetic inputs
(pactpu.utils.signals) with the Engine's StageTimer enabled, measures the
host<->device transfer rates with calibration transfers, and writes a
stage table (default PERF_STAGES.md): per-stage wall clock and where the
remaining gap lives.

Stages tagged `-dispatch` measure async enqueue only; device execution
time is absorbed by whichever later stage first blocks (downloads).

Usage: python tools/perf_breakdown.py [--out PERF_STAGES.md] [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure_link(sizes_mb=(1, 4, 8)) -> dict:
    """Calibrate host->device and device->host bandwidth (MB/s)."""
    import jax
    import jax.numpy as jnp

    up, down = [], []
    for mb in sizes_mb:
        host = np.zeros(mb * (1 << 20), np.uint8)
        # warm path
        jax.block_until_ready(jnp.asarray(host[: 1 << 16]))
        t0 = time.perf_counter()
        dev = jax.block_until_ready(jnp.asarray(host))
        up.append(mb / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        np.asarray(dev)
        down.append(mb / (time.perf_counter() - t0))
    return dict(upload_mb_s=round(max(up), 1),
                download_mb_s=round(max(down), 1))


def run(reps: int, inputs: list) -> dict:
    from pactpu.codec.engine import Engine
    from pactpu.utils.metrics import StageTimer

    eng = Engine(rate_mode="reservoir")
    # warmup / compile
    for pcm in inputs:
        eng.decode(eng.encode(pcm))

    half = eng.cfg.n_mdct_lines
    rep_blocks = sum((-(-p.shape[0] // half) + 1) for p in inputs)

    # Time (and stage-profile) each rep separately, report the BEST rep:
    # a rep that a host stall lands in misattributes the stall to
    # whichever stage it hit.  The best rep is the engine's steady state.
    best = None
    for _ in range(reps):
        eng.timer = StageTimer()
        payload_bytes = 0
        t0 = time.perf_counter()
        for pcm in inputs:
            stream = eng.encode(pcm)
            eng.decode(stream)
            payload_bytes += len(stream)
        wall = time.perf_counter() - t0
        if best is None or wall < best["wall_s"]:
            best = dict(report=eng.timer.report(), wall_s=wall,
                        payload_bytes=payload_bytes)
    return dict(report=best["report"], wall_s=round(best["wall_s"], 3),
                blocks=rep_blocks,
                blocks_per_s=round(rep_blocks / best["wall_s"], 1),
                payload_bytes=best["payload_bytes"])


def run_pipelined(reps: int, inputs: list) -> dict:
    """The production serving path: Engine.roundtrip_many overlaps each
    file's blocking downloads with the other files' device work and
    dispatches decode k before encode k+1's download."""
    from pactpu.codec.engine import Engine

    eng = Engine(rate_mode="reservoir")
    eng.roundtrip_many(inputs)     # warmup / compile
    half = eng.cfg.n_mdct_lines
    blocks_per_rep = sum((-(-p.shape[0] // half) + 1) for p in inputs)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        eng.roundtrip_many(inputs)
        walls.append(time.perf_counter() - t0)
    wall = min(walls)              # best rep (see run())
    return dict(wall_s=round(wall, 3), blocks=blocks_per_rep,
                blocks_per_s=round(blocks_per_rep / wall, 1))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="PERF_STAGES.md")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    from pactpu.utils import signals
    inputs = [signals.class_signal(name, 10.0, seed) for seed, name in
              enumerate(("transient", "dense", "speech"))]

    import jax
    backend = jax.devices()[0].platform
    link = measure_link()
    res = run(args.reps, inputs)
    piped = run_pipelined(args.reps, inputs)

    rep = res["report"]
    total_staged = sum(v["total_s"] for v in rep.values())
    lines = [
        "# PERF_STAGES — serving-path stage breakdown (generated)",
        "",
        f"Backend: **{backend}**; workload: encode+decode of "
        f"{res['blocks']} blocks (3 synthetic files), reservoir mode, "
        f"device packing; best of {args.reps} stage-profiled reps.",
        "",
        f"**Throughput: {res['blocks_per_s']} blocks/s** "
        f"(wall {res['wall_s']} s; staged time {total_staged:.2f} s; "
        "the remainder is un-staged host work: header/framing, python "
        "glue).",
        "",
        f"**Pipelined serving path (Engine.roundtrip_many): "
        f"{piped['blocks_per_s']} blocks/s** "
        f"({100 * piped['blocks_per_s'] / res['blocks_per_s'] - 100:+.0f}% "
        "vs serial) — every file's encode dispatched up front, each "
        "decode dispatched before the next file's payload download "
        "blocks.",
        "",
        f"Link calibration: upload {link['upload_mb_s']} MB/s, "
        f"download {link['download_mb_s']} MB/s.",
        "",
        "| stage | total s | calls | share |",
        "|---|---|---|---|",
    ]
    for k in sorted(rep, key=lambda k: -rep[k]["total_s"]):
        v = rep[k]
        lines.append(f"| {k} | {v['total_s']:.3f} | {v['calls']} | "
                     f"{100 * v['total_s'] / res['wall_s']:.0f}% |")
    lines += [
        "",
        "Dispatch stages measure async enqueue only; device compute is "
        "absorbed by the first blocking stage after it (downloads/"
        "payload assembly).",
    ]
    text = "\n".join(lines) + "\n"
    with open(args.out, "w") as f:
        f.write(text)
    print(text)
    print(json.dumps(dict(link=link, pipelined=piped,
                          **{k: v for k, v in res.items()
                             if k != "report"})))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())

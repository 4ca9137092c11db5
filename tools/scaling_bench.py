"""Scaling-efficiency benchmark: sharded encode over 1/2/4/8 devices.

Measures the SPMD block-sharded encode (pactpu.parallel.shard, the same
program the multi-host path runs) over growing mesh sizes and writes
SCALING.md with blocks/s and parallel efficiency.

The meshes here are virtual CPU devices
(XLA_FLAGS=--xla_force_host_platform_device_count=N), with the process
pinned to min(N, cores) cores so an n-device mesh gets n "chips" and the
1-device baseline cannot silently span every core.  Wall-clock
speedup is then capped by the host's physical cores; the efficiency column
is reported against min(n_devices, n_cores) — the host's ideal — which
isolates what the benchmark can actually measure here: the *overhead the
sharded program adds* (halo ppermute, histogram psum, per-shard batch
shrinkage).  On a real pod the same program's per-step collective volume
is ~4 KB/boundary (halo) + 128 KB (histogram psum) against ~10 MB of
per-shard compute inputs, so measured overhead on this host is the
binding figure for the >=80 % scaling target (BASELINE.md).

Two measurements:
  strong scaling — a fixed --blocks workload split over n devices (per-shard
    batch shrinks with n, so small workloads understate large meshes);
  weak scaling — a fixed --blocks-per-device workload per shard (the total
    grows with n), the standard way to isolate the overhead the collectives
    add: ideal weak scaling keeps wall-clock constant, so
    eff = t(1)/t(n) per ideal-core group.

Usage: python tools/scaling_bench.py [--blocks 1024] [--blocks-per-device 128]
                                     [--sizes 1,2,4,8]
Writes SCALING.md at the repo root and prints one JSON line per mesh size.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _measure(n_dev: int, blocks: int, reps: int) -> None:
    """Child-process measurement: one mesh size, prints one JSON line."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pactpu.codec.engine import engine_consts_np
    from pactpu.parallel import shard
    from pactpu.utils.config import CodecConfig

    cfg = CodecConfig()
    half = cfg.n_mdct_lines
    devices = jax.devices()[:n_dev]
    mesh = shard.make_mesh(devices)

    rng = np.random.default_rng(0)
    t = np.arange(blocks * half) / cfg.sample_rate
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(
        blocks * half)
    y = 0.8 * x + 0.01 * rng.standard_normal(blocks * half)
    pcm = np.clip(np.stack([x, y]) * 20000, -32767, 32767).astype(np.int16)

    xs = jax.device_put(jnp.asarray(pcm),
                        NamedSharding(mesh, P(None, shard.BLOCK_AXIS)))
    extra = jax.device_put(jnp.zeros(blocks, jnp.float32),
                           NamedSharding(mesh, P(shard.BLOCK_AXIS)))
    consts = jax.device_put(
        engine_consts_np(cfg),
        jax.tree.map(lambda _: NamedSharding(mesh, P()),
                     engine_consts_np(cfg)))

    from pactpu.codec.engine import PACK_DENSE_WORDS, PACK_WORDS
    rows_per_dev = 2 * (blocks // n_dev)
    dense_cap = rows_per_dev * PACK_DENSE_WORDS
    fn = shard.sharded_encode_fn(cfg, mesh, PACK_WORDS, dense_cap)
    out, hist = fn(xs, extra, consts)          # warmup + compile
    jax.block_until_ready((out["dense"], hist))

    t0 = time.perf_counter()
    for _ in range(reps):
        out, hist = fn(xs, extra, consts)
        jax.block_until_ready((out["dense"], hist))
    dt = time.perf_counter() - t0

    # measured per-mesh download volume: the round-5 dense path fetches
    # only each shard's OCCUPIED word prefix (counts from nbits) + the
    # nbits array; vs the round-4 fixed-width padded rows and the
    # round-3 per-line arrays
    nbits_np = np.asarray(out["nbits"]).astype(np.int64)
    counts = np.minimum((nbits_np + 31) // 32, PACK_WORDS)
    dense_bytes = int(counts.sum()) * 4 + int(out["nbits"].nbytes)
    rows = nbits_np.shape[0]
    padded_bytes = rows * PACK_WORDS * 4 + int(out["nbits"].nbytes)
    half = cfg.n_mdct_lines
    # round-3 shape: sign i8 + codes i32 + lens i8 per line, ba/sf i8 per
    # band, overall/tid i8, savings/leftover i32
    perline_bytes = rows * (half * (1 + 4 + 1) + cfg.n_bands * 2 + 2 + 8)
    actual_payload = int((nbits_np + 7).sum() // 8)
    print(json.dumps({
        "n_devices": n_dev,
        "blocks": blocks,
        "reps": reps,
        "seconds": round(dt, 4),
        "blocks_per_s": round(blocks * reps / dt, 2),
        "download_dense_bytes": dense_bytes,
        "download_packed_bytes": padded_bytes,
        "download_perline_bytes": int(perline_bytes),
        "payload_actual_bytes": actual_payload,
    }))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=1024)
    ap.add_argument("--blocks-per-device", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--child", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "SCALING.md"))
    args = ap.parse_args()

    if args.child:
        _measure(args.child, args.blocks, args.reps)
        return 0

    sizes = [int(s) for s in args.sizes.split(",")]
    n_cores = os.cpu_count() or 1
    have_taskset = os.path.exists("/usr/bin/taskset")

    def run_child(n: int, blocks: int):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
        # pin the child to min(n, cores) cores so an n-device mesh gets n
        # "chips": without pinning the 1-device baseline already spans
        # every core (XLA CPU shares one intra-op pool) and multi-device
        # speedup is unmeasurable
        pin = []
        if have_taskset:
            pin = ["taskset", "-c", ",".join(
                str(c) for c in range(min(n, n_cores)))]
        out = subprocess.run(
            pin + [sys.executable, os.path.abspath(__file__),
                   "--child", str(n),
                   "--blocks", str(blocks), "--reps", str(args.reps)],
            env=env, capture_output=True, text=True, timeout=1500, cwd=REPO)
        for ln in reversed((out.stdout or "").strip().splitlines()):
            try:
                return json.loads(ln)
            except json.JSONDecodeError:
                continue
        print(f"mesh size {n} failed:\n{out.stderr[-2000:]}",
              file=sys.stderr)
        return None

    strong, weak = [], []
    for n in sizes:
        r = run_child(n, args.blocks)
        if r is None:
            return 1
        strong.append(r)
        print(json.dumps({"mode": "strong", **r}))
    for n in sizes:
        r = run_child(n, args.blocks_per_device * n)
        if r is None:
            return 1
        weak.append(r)
        print(json.dumps({"mode": "weak", **r}))

    lines = [
        "# SCALING — block-sharded SPMD encode over an n-device mesh",
        "",
        "Generated by `tools/scaling_bench.py` (virtual CPU devices, the",
        f"process pinned to min(n, cores) cores; this host has {n_cores} "
        "physical cores, so",
        f"wall-clock speedup is capped at {n_cores}x — the `eff(host)` "
        "column is",
        "normalized to min(n, cores), isolating the overhead the sharded",
        "program adds: halo ppermute + histogram psum + per-shard batch",
        "shrinkage.  Multi-host correctness of the same program is covered",
        "by tests/test_cluster.py (2-process fake cluster, byte-equal",
        "streams) and the driver's dryrun_multichip.",
        "",
        f"## Strong scaling — fixed {args.blocks} blocks "
        f"(~{args.blocks * 1024 / 44100:.1f} s of 44.1 kHz stereo) split "
        "over n devices",
        "",
        "| devices | blocks/s | speedup | eff(linear) | eff(host) |",
        "|---|---|---|---|---|",
    ]
    base = strong[0]["blocks_per_s"]
    for r in strong:
        n = r["n_devices"]
        sp = r["blocks_per_s"] / base
        lines.append(f"| {n} | {r['blocks_per_s']} | {sp:.2f}x "
                     f"| {100 * sp / n:.0f}% "
                     f"| {100 * sp / min(n, n_cores):.0f}% |")
    lines += [
        "",
        f"## Weak scaling — fixed {args.blocks_per_device} blocks per "
        "device (total grows with n)",
        "",
        "Ideal weak scaling keeps per-shard wall-clock constant;",
        "eff = per-device throughput vs the 1-device run, normalized to",
        "the ideal-core group (min(n, cores)) as above.",
        "",
        "| devices | blocks | blocks/s | per-device blocks/s | eff(host) |",
        "|---|---|---|---|---|",
    ]
    wbase = weak[0]["blocks_per_s"]
    for r in weak:
        n = r["n_devices"]
        per_dev = r["blocks_per_s"] / min(n, n_cores)
        lines.append(f"| {n} | {r['blocks']} | {r['blocks_per_s']} "
                     f"| {per_dev:.2f} | {100 * per_dev / wbase:.0f}% |")
    dl = strong[-1]
    ratio = dl["download_perline_bytes"] / max(dl["download_dense_bytes"], 1)
    eff = dl["payload_actual_bytes"] / max(dl["download_dense_bytes"], 1)
    lines += [
        "",
        "Workload: full Huffman+M/S encode path, device time only (payload",
        "serialization is host-side and overlaps).",
        "",
        "## Measured device->host download volume (round-5 dense shard I/O)",
        "",
        "The sharded program packs AND compacts payloads on device: each",
        "shard holds a flat dense word buffer (compact_rows inside the",
        "shard program) and every host fetches only the OCCUPIED prefix",
        "of its shards + the nbits array",
        "(pactpu.parallel.shard.sharded_encode_fn(pack_words, dense_cap);",
        "round 4 downloaded fixed 256-word padded rows, round 3 per-line",
        f"arrays).  For the {dl['blocks']}-block strong-scaling workload:",
        "",
        f"- dense download: {dl['download_dense_bytes']:,} bytes "
        f"(r4 padded rows: {dl['download_packed_bytes']:,}; r3 per-line: "
        f"{dl['download_perline_bytes']:,} — **{ratio:.0f}x less**)",
        f"- actual compressed payload: {dl['payload_actual_bytes']:,} "
        f"bytes — the dense download is {1 / eff:.2f}x the payload "
        "(word-rounding + the nbits sidecar; round-4 was 4.4x)",
        "",
        "Decode side: `cluster.decode_distributed` now uploads the RAW",
        "framed payload rows and bit-walks them on device",
        "(shard.sharded_decode_payload_fn) — upload is the compressed",
        "bytes themselves instead of dense int32[B, 2, 1024] mantissas",
        "(8.4 MB per 1024 stereo blocks, ~8-15x more).",
    ]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

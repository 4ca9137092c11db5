"""Worker process for the multi-process (fake cluster) distribution test.

Launched by tests/test_cluster.py as
    python tests/cluster_worker.py <pid> <nproc> <port> <outdir>
with JAX forced onto the CPU backend and 2 virtual devices per process, so
2 processes form a 4-device global mesh on one machine — the jax
multi-process simulation SURVEY.md §4 prescribes for multi-host tests.
"""

import os
import sys


def make_test_pcm(n_blocks: int = 12, half: int = 1024):
    """Deterministic stereo test signal shared by workers and the parent."""
    import numpy as np
    rng = np.random.default_rng(17)
    n = n_blocks * half - 300
    t = np.arange(n) / 44100.0
    x = 0.3 * np.sin(2 * np.pi * 523 * t) + 0.04 * rng.standard_normal(n)
    y = 0.7 * x + 0.02 * rng.standard_normal(n)
    pcm = np.clip(np.stack([x, y], 1) * 22000, -32767, 32767)
    return pcm.astype(np.int16)


def main() -> None:
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    mode = sys.argv[5] if len(sys.argv) > 5 else "cbr"
    # CPU backend with 2 virtual devices per process
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=2").strip()

    import jax
    jax.config.update("jax_platforms", "cpu")

    from pactpu.parallel import cluster

    multi = cluster.initialize(f"localhost:{port}", num_processes=nproc,
                               process_id=pid)
    assert multi, "fake cluster did not form"
    assert jax.process_count() == nproc
    assert len(jax.devices()) == 2 * nproc

    import numpy as np
    pcm = make_test_pcm()

    if mode == "fault-reservoir":
        # fault-injection drill for shard-level elastic recovery: both
        # processes encode with the per-range reservoir policy, then
        # process 1 "dies" before delivering its part — its true payload
        # goes to a quarantine file the RECOVERY path never reads; the
        # parent redoes the range from the input PCM (cluster.encode_range)
        # and must reproduce those bytes exactly (tests/test_cluster.py).
        res = cluster.encode_distributed(pcm, rate_mode="reservoir")
        name = (f"part_{pid}.lost.npz" if pid == 1 else f"part_{pid}.npz")
        np.savez(os.path.join(outdir, name),
                 payload=np.frombuffer(res.payload, np.uint8),
                 header=np.frombuffer(res.header, np.uint8),
                 block_start=res.block_start, n_blocks=res.n_blocks,
                 n_blocks_total=res.n_blocks_total)
        cluster.shutdown()
        return

    res = cluster.encode_distributed(pcm, rate_mode="cbr")

    # round-4: the raw-payload sharded decode crosses the process
    # boundary too (every process holds the full stream; each uploads
    # only its block range's compressed rows and the OLA carry rides the
    # ppermute).  The stream comes from a single-process engine so the
    # parent can compare against Engine.decode exactly.
    from pactpu.codec.engine import Engine
    stream = Engine(rate_mode="cbr").encode(pcm)
    dec = cluster.decode_distributed(stream)

    np.savez(os.path.join(outdir, f"part_{pid}.npz"),
             payload=np.frombuffer(res.payload, np.uint8),
             header=np.frombuffer(res.header, np.uint8),
             block_start=res.block_start, n_blocks=res.n_blocks,
             n_blocks_total=res.n_blocks_total, histogram=res.histogram,
             dec_pcm=dec.pcm, dec_start=dec.sample_start,
             dec_total=dec.num_samples, dec_fs=dec.sample_rate)
    cluster.shutdown()


if __name__ == "__main__":
    main()

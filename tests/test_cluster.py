"""Multi-host distribution via a local fake cluster (SURVEY.md §4/§5).

Two processes x 2 virtual CPU devices form a 4-device global mesh through
`jax.distributed`; the SPMD encode's halo ppermute and histogram psum cross
the process boundary.  The assembled stream must equal the single-process
Engine's byte-for-byte (cbr rate control is process-count-invariant), and
the psum'd Huffman histogram must be globally consistent.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from cluster_worker import make_test_pcm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_shard_range_recovery_reproduces_lost_host(tmp_path):
    """Fault injection for shard-level elastic recovery (SURVEY.md §5):
    a 2-process reservoir-mode distributed encode where process 1 dies
    before delivering its part.  The redo (cluster.encode_range, driven
    only by the input PCM and the partition arithmetic) must reproduce
    the lost host's payload byte-for-byte, and the recovered stream must
    equal the no-fault stream exactly — the per-block nBytes framing
    makes the splice exact (reference codec/pacfile.py:153-229)."""
    nproc = 2
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "cluster_worker.py"),
         str(pid), str(nproc), str(port), str(tmp_path),
         "fault-reservoir"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(nproc)]
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-4000:]

    with np.load(tmp_path / "part_0.npz") as z:
        header = z["header"].tobytes()
        survivor = (int(z["block_start"]), z["payload"].tobytes())
    with np.load(tmp_path / "part_1.lost.npz") as z:
        lost_start = int(z["block_start"])
        lost_payload = z["payload"].tobytes()

    from pactpu.parallel import cluster
    pcm = make_test_pcm()
    n_dev = 2 * nproc
    ranges = cluster.process_block_ranges(pcm.shape[0], n_dev, nproc)
    assert ranges[0][0] == survivor[0] and ranges[1][0] == lost_start

    # the redo reproduces the dead host's bytes exactly
    redo = cluster.encode_range(pcm, *ranges[1], rate_mode="reservoir")
    assert redo == lost_payload

    # and the recovered stream equals the no-fault stream
    recovered = cluster.recover_stream(header, [survivor], pcm, n_dev,
                                       nproc, rate_mode="reservoir")
    no_fault = cluster.assemble_stream(
        header, [survivor, (lost_start, lost_payload)])
    assert recovered == no_fault


@pytest.mark.slow
def test_two_process_fake_cluster_matches_single_process(tmp_path):
    nproc = 2
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "cluster_worker.py"),
         str(pid), str(nproc), str(port), str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(nproc)]
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-4000:]

    parts = []
    hists = []
    dec_parts = []
    header = None
    total = None
    dec_total = dec_fs = None
    for pid in range(nproc):
        with np.load(tmp_path / f"part_{pid}.npz") as z:
            parts.append((int(z["block_start"]), z["payload"].tobytes()))
            hists.append(z["histogram"])
            dec_parts.append((int(z["dec_start"]), z["dec_pcm"]))
            dec_total = int(z["dec_total"])
            dec_fs = int(z["dec_fs"])
            header = z["header"].tobytes()
            total = int(z["n_blocks_total"])

    # the psum'd histogram is identical on every process
    np.testing.assert_array_equal(hists[0], hists[1])

    # assembled multi-process stream == single-process engine stream
    from pactpu.codec.engine import Engine
    from pactpu.parallel.cluster import assemble_stream
    pcm = make_test_pcm()
    stream = assemble_stream(header, parts)
    ref = Engine(rate_mode="cbr", device_pack=False).encode(pcm)
    assert total == -(-pcm.shape[0] // 1024) + 1
    assert stream == ref

    # and the global histogram matches a host bincount of the stream's
    # symbols (via the single-process engine's return_syms path)
    import jax.numpy as jnp
    from pactpu.codec.engine import (encode_body, engine_consts_np,
                                     frame_blocks)
    from pactpu.utils.config import CodecConfig
    cfg = CodecConfig()
    frames = frame_blocks(jnp.asarray(pcm.T.astype(np.int16)),
                          cfg.n_mdct_lines, total - 1)
    out = encode_body(cfg, return_syms=True)(
        frames, jnp.zeros(total, jnp.float32), engine_consts_np(cfg))
    syms = np.asarray(out["syms"]).reshape(-1)
    # the mesh pads to a device multiple with all-zero blocks (the flush
    # block before them is itself silent); count their symbols too
    pad_total = -(-total // 4) * 4
    if pad_total > total:
        zf = jnp.zeros((pad_total - total, 2, 2 * cfg.n_mdct_lines),
                       jnp.int16)
        zout = encode_body(cfg, return_syms=True)(
            zf, jnp.zeros(pad_total - total, jnp.float32),
            engine_consts_np(cfg))
        syms = np.concatenate([syms, np.asarray(zout["syms"]).reshape(-1)])
    expect = np.bincount(syms[syms >= 0], minlength=1 << 15)
    np.testing.assert_array_equal(hists[0], expect)

    # round-4 raw-payload sharded decode across the process boundary:
    # assembled per-range PCM equals the single-process Engine.decode of
    # the same stream (the workers decoded a single-process cbr stream)
    from pactpu.parallel.cluster import assemble_pcm
    got = assemble_pcm(dec_parts, dec_total)
    fs_ref, ref_pcm = Engine(rate_mode="cbr").decode(ref)
    assert dec_fs == fs_ref
    assert got.shape == ref_pcm.shape
    assert np.abs(got.astype(np.int32)
                  - ref_pcm.astype(np.int32)).max() <= 1

"""Failure detection + elastic recovery harness (pactpu.parallel.jobs).

The reference has no failure handling (SURVEY.md §5); the harness must
detect segment failures (exceptions, watchdog timeouts), restore from the
last good checkpoint on a FRESH engine, re-queue exactly the failed block
range, and still produce byte-identical output to an unfailed run.
"""

import time

import numpy as np
import pytest

from pactpu.codec.engine import Engine
from pactpu.parallel import jobs
from pactpu.utils.config import CodecConfig


def _pcm(n, seed=0, chans=2):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    sig = (0.4 * np.sin(2 * np.pi * 480 * t)
           + 0.05 * rng.standard_normal(n))
    cols = [sig] + [0.7 * sig] * (chans - 1)
    return np.clip(np.stack(cols, 1) * 32767, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def ref_streams():
    """Unfailed ground truth via the batch engine."""
    files = {f"f{k}": _pcm(1024 * 7 - 100 * k, seed=k) for k in range(2)}
    eng = Engine(rate_mode="reservoir")
    return files, {n: eng.encode(p) for n, p in files.items()}


def test_jobs_no_faults_match_batch_engine(ref_streams):
    files, streams = ref_streams
    res = jobs.run_encode_jobs(files.items(), segment_blocks=3)
    assert all(r.ok and r.retries == 0 for r in res)
    for r in res:
        assert r.stream == streams[r.name]


def test_injected_faults_are_absorbed_byte_identically(ref_streams):
    """Deterministic faults on several segments: the harness retries from
    checkpoints and the output bytes are unchanged."""
    files, streams = ref_streams
    hits = []

    def hook(name, seg, attempt):
        # fail the first attempt of segments 1 and 2 of f0, segment 0 of f1
        if attempt == 0 and ((name == "f0" and seg in (1, 2))
                             or (name == "f1" and seg == 0)):
            hits.append((name, seg))
            raise RuntimeError("injected device fault")

    res = jobs.run_encode_jobs(files.items(), segment_blocks=3,
                               max_retries=2, fault_hook=hook)
    assert len(hits) == 3
    by_name = {r.name: r for r in res}
    assert by_name["f0"].ok and by_name["f0"].retries == 2
    assert by_name["f0"].failed_segments == [1, 2]
    assert by_name["f1"].ok and by_name["f1"].retries == 1
    for r in res:
        assert r.stream == streams[r.name]


def test_exhausted_retries_fail_resumably(ref_streams):
    """A segment that keeps failing marks the job failed with its last
    good checkpoint; resume_encode_job finishes it byte-identically
    without redoing completed segments."""
    files, streams = ref_streams
    pcm = files["f0"]

    def always_fail_seg1(name, seg, attempt):
        if seg == 1:
            raise RuntimeError("persistent fault")

    res = jobs.run_encode_jobs([("f0", pcm)], segment_blocks=3,
                               max_retries=1, fault_hook=always_fail_seg1)
    (r,) = res
    assert not r.ok and "persistent fault" in r.error
    assert r.checkpoint is not None
    assert r.resume_offset == 3 * 1024          # segment 1 starts here
    assert r.failed_segments == [1, 1]

    pushed = []

    def count_segments(name, seg, attempt):
        pushed.append(seg)

    r2 = jobs.resume_encode_job(r, pcm, segment_blocks=3,
                                fault_hook=count_segments)
    assert r2.ok
    assert min(pushed) == 1                     # segment 0 NOT redone
    assert r2.stream == streams["f0"]
    assert r2.retries == r.retries              # history carried


def test_watchdog_times_out_hung_segment(ref_streams, monkeypatch):
    """A hung device call trips the wall-clock watchdog;
    the retry runs on a fresh engine and completes byte-identically."""
    from pactpu.codec import stream as stream_mod
    files, streams = ref_streams
    pcm = files["f1"]
    real_push = stream_mod.StreamingEncoder.push
    state = {"armed": True}

    def slow_push(self, data):
        if state["armed"]:
            state["armed"] = False
            time.sleep(3.0)                     # simulated wedge
        return real_push(self, data)

    monkeypatch.setattr(stream_mod.StreamingEncoder, "push", slow_push)
    res = jobs.run_encode_jobs([("f1", pcm)], segment_blocks=4,
                               max_retries=2, timeout_s=1.0)
    (r,) = res
    assert r.ok and r.retries == 1
    assert "f1" == r.name
    assert r.stream == streams["f1"]


def test_cli_batch_subcommand(ref_streams, tmp_path, capsys):
    """`python -m pactpu batch` drives the harness: outputs equal the
    batch engine's streams."""
    from pactpu.codec import cli
    from pactpu.codec.wav import write_wav
    files, streams = ref_streams
    paths = []
    for name, pcm in files.items():
        p = tmp_path / f"{name}.wav"
        write_wav(str(p), 44100, pcm)
        paths.append(str(p))
    assert cli.main(["batch", *paths, "--outdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "2/2 encoded" in out
    for name in files:
        assert (tmp_path / f"{name}.wak").read_bytes() == streams[name]


def test_decode_jobs_retry_and_fail_cleanly(ref_streams):
    files, streams = ref_streams
    eng = Engine(rate_mode="reservoir")
    flaky = {"n": 0}

    def hook(name, seg, attempt):
        if name == "f0" and attempt == 0:
            flaky["n"] += 1
            raise RuntimeError("transient decode fault")

    good = jobs.run_decode_jobs(streams.items(), fault_hook=hook)
    assert flaky["n"] == 1
    for r in good:
        assert r.ok
        fs, want = eng.decode(streams[r.name])
        assert r.sample_rate == fs
        np.testing.assert_array_equal(r.pcm, want)

    bad = jobs.run_decode_jobs([("x", b"PAC garbage stream")],
                               max_retries=1)
    assert not bad[0].ok and bad[0].error

def test_segment_blocks_validated(ref_streams):
    """segment_blocks < 1 used to loop forever (pos never advances);
    both entry points must reject it up front."""
    files, _ = ref_streams
    with pytest.raises(ValueError, match="segment_blocks"):
        jobs.run_encode_jobs(files.items(), segment_blocks=0)
    with pytest.raises(ValueError, match="segment_blocks"):
        jobs.run_encode_jobs(files.items(), segment_blocks=-4)


def test_failed_job_checkpoint_file_roundtrip(ref_streams, tmp_path):
    """save_failed_job/load_failed_job persist everything a resume needs;
    a resumed job is byte-identical and a corrupt file fails cleanly."""
    files, streams = ref_streams
    pcm = files["f0"]

    def fail_seg1(name, seg, attempt):
        if seg == 1:
            raise RuntimeError("persistent fault")

    (r,) = jobs.run_encode_jobs([("f0", pcm)], segment_blocks=3,
                                max_retries=1, fault_hook=fail_seg1)
    assert not r.ok
    path = tmp_path / "f0.resume"
    jobs.save_failed_job(r, str(path))
    r2 = jobs.load_failed_job(str(path))
    assert (r2.name, r2.resume_offset, r2.retries) == \
        (r.name, r.resume_offset, r.retries)
    assert r2.checkpoint == r.checkpoint and r2.parts == r.parts
    r3 = jobs.resume_encode_job(r2, pcm, segment_blocks=3)
    assert r3.ok and r3.stream == streams["f0"]

    path.write_bytes(path.read_bytes()[:-3])        # truncate
    with pytest.raises(ValueError, match="corrupt|checkpoint"):
        jobs.load_failed_job(str(path))
    with pytest.raises(ValueError, match="checkpoint"):
        jobs.load_failed_job(__file__)              # not a checkpoint


def test_cli_batch_resume(ref_streams, tmp_path, capsys, monkeypatch):
    """A failed CLI batch writes OUT.wak.resume; the rerun resumes from
    it (skipping completed segments), produces byte-identical output and
    removes the sidecar."""
    from pactpu.codec import cli
    from pactpu.codec import stream as stream_mod
    from pactpu.codec.wav import write_wav

    files, streams = ref_streams
    pcm = files["f1"]
    p = tmp_path / "f1.wav"
    write_wav(str(p), 44100, pcm)

    real_push = stream_mod.StreamingEncoder.push
    calls = {"n": 0}

    def flaky_push(self, data):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected wedge")
        return real_push(self, data)

    monkeypatch.setattr(stream_mod.StreamingEncoder, "push", flaky_push)
    rc = cli.main(["batch", str(p), "--outdir", str(tmp_path),
                   "--segment-blocks", "3", "--retries", "1"])
    assert rc == 1
    resume = tmp_path / "f1.wak.resume"
    assert resume.exists()
    assert "saved" in capsys.readouterr().err

    monkeypatch.setattr(stream_mod.StreamingEncoder, "push", real_push)
    rc = cli.main(["batch", str(p), "--outdir", str(tmp_path),
                   "--segment-blocks", "3"])
    assert rc == 0
    assert "resuming from sample" in capsys.readouterr().out
    assert not resume.exists()
    assert (tmp_path / "f1.wak").read_bytes() == streams["f1"]

    # the CLI surfaces library validation as a clean error, not a hang
    rc = cli.main(["batch", str(p), "--outdir", str(tmp_path),
                   "--segment-blocks", "0"])
    assert rc == 1
    assert "segment_blocks" in capsys.readouterr().err


def test_cli_batch_corrupt_sidecar_falls_through(ref_streams, tmp_path,
                                                 capsys):
    """A truncated .wak.resume must not wedge the batch: it is set aside
    (renamed .bad) and the file encodes fresh (ADVICE r3)."""
    from pactpu.codec import cli
    from pactpu.codec.wav import write_wav

    files, streams = ref_streams
    pcm = files["f0"]
    p = tmp_path / "f0.wav"
    write_wav(str(p), 44100, pcm)
    resume = tmp_path / "f0.wak.resume"
    resume.write_bytes(b"PJC1garbage-truncated")

    rc = cli.main(["batch", str(p), "--outdir", str(tmp_path)])
    assert rc == 0
    err = capsys.readouterr().err
    assert "corrupt resume checkpoint" in err
    assert (tmp_path / "f0.wak.resume.bad").exists()
    assert not resume.exists()
    assert (tmp_path / "f0.wak").read_bytes() == streams["f0"]


def test_cli_batch_fingerprint_mismatch_starts_fresh(ref_streams, tmp_path,
                                                     capsys, monkeypatch):
    """A sidecar saved under different coding settings (or input) must not
    be resumed — the header and early parts describe a different stream
    (ADVICE r3 medium)."""
    from pactpu.codec import cli
    from pactpu.codec import stream as stream_mod
    from pactpu.codec.wav import write_wav

    files, _ = ref_streams
    pcm = files["f1"]
    p = tmp_path / "f1.wav"
    write_wav(str(p), 44100, pcm)

    real_push = stream_mod.StreamingEncoder.push
    calls = {"n": 0}

    def flaky_push(self, data):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected wedge")
        return real_push(self, data)

    monkeypatch.setattr(stream_mod.StreamingEncoder, "push", flaky_push)
    rc = cli.main(["batch", str(p), "--outdir", str(tmp_path),
                   "--segment-blocks", "3", "--retries", "1",
                   "--bps", "2.27"])
    assert rc == 1
    assert (tmp_path / "f1.wak.resume").exists()
    capsys.readouterr()

    # rerun with a DIFFERENT bit rate: must refuse the checkpoint
    monkeypatch.setattr(stream_mod.StreamingEncoder, "push", real_push)
    rc = cli.main(["batch", str(p), "--outdir", str(tmp_path),
                   "--bps", "4.93"])
    assert rc == 0
    out = capsys.readouterr()
    assert "different settings/input" in out.err
    assert "resuming from sample" not in out.out
    assert not (tmp_path / "f1.wak.resume").exists()
    # and the result is a clean 4.93 bps encode
    from pactpu.codec.engine import Engine
    from pactpu.utils.config import CodecConfig
    import dataclasses as dc
    eng = Engine(cfg=dc.replace(CodecConfig(), target_bits_per_sample=4.93))
    assert (tmp_path / "f1.wak").read_bytes() == eng.encode(pcm)


def test_save_failed_job_atomic(ref_streams, tmp_path):
    """save_failed_job writes tmp + rename: no .tmp remnants, loadable."""
    files, _ = ref_streams
    pcm = files["f0"]

    def always_fail(name, seg, attempt):
        if seg == 1:
            raise RuntimeError("fault")

    (r,) = jobs.run_encode_jobs([("f0", pcm)], segment_blocks=3,
                                max_retries=0, fault_hook=always_fail)
    path = tmp_path / "f0.resume"
    jobs.save_failed_job(r, str(path), pcm=pcm)
    assert not (tmp_path / "f0.resume.tmp").exists()
    r2 = jobs.load_failed_job(str(path))
    fp = r2.meta["fingerprint"]
    assert fp["input_samples"] == pcm.shape[0] and "input_crc32" in fp

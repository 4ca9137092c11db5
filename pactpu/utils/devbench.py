"""Pure device-compute throughput: blocks/s of the codec programs.

The serving benchmarks (bench.py, tools/perf_breakdown.py) measure the
whole pipeline, host parse and transfers included.  This module measures
what the device sustains on the compute alone, stage by stage.

Measurement method: every stage is driven by ONE jitted `lax.fori_loop`
harness that repeats the stage `iters` times *inside a single XLA
program*, so per-dispatch host latency cannot enter the figure; wall
time per iteration is the slope between two trip counts.

To stop XLA from hoisting the loop-invariant stage out of the loop (or
dead-code-eliminating it), each iteration's input is perturbed by a
dynamic float `eps` derived from the previous iteration's OUTPUT as
`v - v` — exactly 0.0 at runtime, but float subtraction is not
algebraically foldable (NaN/inf semantics), so the compiler must chain
the iterations sequentially and recompute the stage each trip.

FLOP accounting: each stage's single-shot program is compiled and XLA's
own `cost_analysis()` FLOP estimate recorded, giving measured FLOP/s and,
on a device listed in PEAKS, the share of the published f32 peak.

The reference has no analogue (its driver is wall-clock only, reference
codec/pacfile.py:428,501-503).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

# Published peaks per device, keyed by `jax.Device.device_kind`.  Source:
# NVIDIA H100 Tensor Core GPU data sheet (SXM part, dense rates without
# sparsity, at its full 700 W power limit).  The codec's matmuls run in
# f32 (precision HIGHEST), so the f32 rate is the one FLOP shares use.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(device_kind: str) -> dict:
    """The PEAKS entry of a device; an unlisted device is an error, not a
    default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add it to PEAKS") from None


def _program_flops(fn, *args) -> Optional[float]:
    """XLA's own FLOP estimate for one invocation of a jitted fn."""
    try:
        compiled = fn.lower(*args).compile()
        total = 0.0
        for ca in compiled.cost_analysis() if isinstance(
                compiled.cost_analysis(), list) else [
                    compiled.cost_analysis()]:
            total += float(ca.get("flops", 0.0))
        return total or None
    except Exception:  # noqa: BLE001 — diagnostic only
        return None


def _time_loop(stage, feedback, iters: int) -> float:
    """Seconds per iteration of `stage`, measured inside one jitted
    fori_loop whose final carry is fetched to the host.

    stage:    eps (f32 scalar, dynamically 0.0) -> output pytree; must
              thread eps into its inputs so iterations chain.
    feedback: output pytree -> f32 scalar that is 0.0 at runtime but
              data-dependent (use `_f0`: `v - v` on a FULL float
              reduction, so slice-simplification cannot shrink the
              stage to the one element the carry reads).
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(n, eps0):
        return jax.lax.fori_loop(
            0, n, lambda i, eps: feedback(stage(eps)), eps0)

    eps0 = jnp.float32(0.0)
    float(np.asarray(run(jnp.int32(1), eps0)))         # compile + warm

    def timed(n):
        t0 = time.perf_counter()
        float(np.asarray(run(jnp.int32(n), eps0)))
        return time.perf_counter() - t0

    # two trip counts; the slope removes the constant dispatch + fetch
    # cost from the per-iteration figure.  min-of-3 per point (and a
    # retry on a non-positive slope) guards against a host stall landing
    # inside one sample and inverting the slope
    n_lo = max(2, iters // 4)
    for _ in range(3):
        t_lo = min(timed(n_lo) for _ in range(3))
        t_hi = min(timed(n_lo + iters) for _ in range(3))
        if t_hi > t_lo:
            return (t_hi - t_lo) / iters
    return max(t_hi - t_lo, 1e-9) / iters


def _f0(a):
    """Dynamic zero depending on EVERY element of `a` (not foldable:
    float x - x has NaN/inf semantics, and the full-sum reduction blocks
    XLA's slice-of-producer simplifications from deleting the work)."""
    import jax.numpy as jnp
    v = jnp.sum(a.astype(jnp.float32))
    return v - v


def _f0_tree(out):
    """_f0 over EVERY array leaf of a pytree output.

    Reading one output is not enough: XLA backward-DCEs every branch the
    carry does not consume (first observed on the analyze stage, whose
    `mixed` output does not depend on the psychoacoustic thresholds — the
    whole psych model was being deleted, under-reporting the stage by
    ~7 ms)."""
    import jax
    import jax.numpy as jnp
    total = jnp.float32(0.0)
    for leaf in jax.tree.leaves(out):
        total = total + jnp.sum(leaf.astype(jnp.float32))
    return total - total


def _perturb_tree(tree, eps):
    """Add a dynamic zero to every FLOAT leaf of an input pytree so no
    stage input is loop-invariant (XLA hoists computations that depend
    only on invariant inputs out of the measurement loop)."""
    import jax
    import jax.numpy as jnp

    def bump(leaf):
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            return leaf + eps.astype(leaf.dtype)
        return leaf

    return jax.tree.map(bump, tree)


def measure_device_compute(pcm: Optional[np.ndarray] = None,
                           blocks: int = 512, iters: int = 20,
                           eng=None) -> dict:
    """Returns blocks/s of the encode compute chain, the decode compute
    chain, and the serial encode+decode roundtrip, each stage measured by
    its own fori_loop harness (dispatch-latency-immune), with per-stage
    milliseconds and XLA-counted FLOPs.

    `pcm` (int16 [n, 2]) supplies realistic payload statistics; it is
    cropped/tiled to exactly `blocks` coded blocks (one chunk)."""
    import jax
    import jax.numpy as jnp

    from pactpu.codec import engine as E

    eng = eng or E.Engine(rate_mode="reservoir")
    cfg = eng.cfg
    half = cfg.n_mdct_lines
    c = cfg.n_channels
    n = (blocks - 1) * half            # b = n_blocks + 1 == `blocks`
    if pcm is None:
        rng = np.random.default_rng(0)
        t = np.arange(n) / cfg.sample_rate
        sig = (0.5 * np.sin(2 * np.pi * 440 * t)
               + 0.1 * rng.standard_normal(n))
        pcm = np.clip(np.stack([sig] * c, 1) * 24000,
                      -32768, 32767).astype(np.int16)
    elif pcm.shape[0] < n:
        reps = -(-n // pcm.shape[0])
        pcm = np.tile(pcm, (reps, 1))[:n]
    else:
        pcm = pcm[:n]

    # --- encode compute: the exact reservoir-mode dispatch chain of
    # Engine._encode_chunks on ONE device-resident chunk.  The production
    # engine enqueues these as separate programs; each is measured by its
    # own loop harness and the chain time is the per-stage sum.
    glob = np.zeros((c, (blocks + 1) * half), np.int16)
    glob[:, half:half + n] = pcm.T
    dev_pcm = jax.device_put(jnp.asarray(glob))
    consts = eng.consts()
    analyze = E._chunk_analyze_fn(cfg, eng.precision)
    measure = E._finalize_fn(cfg, measure_only=True, precision=eng.precision)
    scan = E._reservoir_scan_fn(cfg)
    finalize = E._finalize_fn(cfg, pack_words=eng.pack_words,
                              precision=eng.precision)
    zeros = jnp.zeros(blocks, jnp.float32)
    valid = jnp.ones(blocks, bool)
    carry0 = jnp.zeros(2, jnp.int32)
    dense_cap = blocks * c * E.PACK_DENSE_WORDS

    # device-resident intermediates for the per-stage harnesses
    a_dev = jax.block_until_ready(analyze(dev_pcm, consts))
    m_dev = jax.block_until_ready(measure(a_dev, zeros, consts))
    ex_dev, _ = scan(m_dev["savings"], m_dev["leftover"], valid, carry0)
    out_dev = jax.block_until_ready(finalize(a_dev, ex_dev, consts))

    stages = {
        "analyze": (
            lambda eps: analyze(dev_pcm + eps.astype(jnp.int16), consts),
            _f0_tree),
        "measure": (
            lambda eps: measure(_perturb_tree(a_dev, eps), zeros, consts),
            _f0_tree),
        "reservoir_scan": (
            lambda eps: scan(m_dev["savings"]
                             + eps.astype(m_dev["savings"].dtype),
                             m_dev["leftover"], valid, carry0),
            _f0_tree),
        "finalize": (
            lambda eps: finalize(_perturb_tree(a_dev, eps), ex_dev + eps,
                                 consts),
            _f0_tree),
    }
    flop_args = {
        "analyze": (analyze, dev_pcm, consts),
        "measure": (measure, a_dev, zeros, consts),
        "reservoir_scan": (scan, m_dev["savings"], m_dev["leftover"],
                           valid, carry0),
        "finalize": (finalize, a_dev, ex_dev, consts),
    }
    if "words" in out_dev:
        compact = jax.jit(lambda w, nb: E.pack_ops.compact_rows(
            w, nb, dense_cap))
        stages["compact"] = (
            lambda eps: compact(out_dev["words"]
                                + eps.astype(jnp.uint32),
                                out_dev["nbits"]),
            _f0_tree)
        flop_args["compact"] = (compact, out_dev["words"], out_dev["nbits"])

    stage_ms, stage_flops = {}, {}
    for name, (stage, feedback) in stages.items():
        stage_ms[name] = 1000 * _time_loop(stage, feedback, iters)
        stage_flops[name] = _program_flops(*flop_args[name])
    dt_enc = sum(stage_ms.values()) / 1000

    # --- decode compute: the exact chunk programs _decode_dispatch runs,
    # on the device-resident uploads of a real encoded stream ---
    stream = eng.encode(pcm)
    (_dcfg, _, b, cc, sizes, _offs, runs,
     chunk_args) = eng._decode_staging(stream)
    assert b == blocks and len(sizes) == 1, (b, sizes)
    args = [a if (a is None or isinstance(a, dict))
            else jax.device_put(jnp.asarray(a)) for a in chunk_args[0]]
    dcarry = jnp.zeros((cc, half), E._dtype(eng.precision))

    def decode_stage(eps):
        a2 = [a if (a is None or isinstance(a, dict)
                    or a.dtype == jnp.bool_)
              else a + eps.astype(a.dtype) for a in args]
        return runs[0](*a2, dcarry + eps.astype(dcarry.dtype), consts)

    stage_ms["decode"] = 1000 * _time_loop(decode_stage, _f0_tree, iters)
    stage_flops["decode"] = _program_flops(runs[0], *args, dcarry, consts)
    dt_dec = stage_ms["decode"] / 1000

    # --- device-parse decode (diagnostic row, not the headline): the
    # Huffman bit-walk on the device (pactpu.ops.huffman_decode) ---
    import os as _os
    _old_parse = _os.environ.get("PACTPU_DECODE_PARSE")
    try:
        _os.environ["PACTPU_DECODE_PARSE"] = "device"
        (_c2, _, _, _, dsizes, _, druns,
         dchunk_args) = eng._decode_staging(stream)
        if len(dsizes) == 1:
            dargs = [a if (a is None or isinstance(a, dict))
                     else jax.device_put(jnp.asarray(a))
                     for a in dchunk_args[0]]

            def devparse_stage(eps):
                a2 = [a if (a is None or isinstance(a, dict)
                            or a.dtype == jnp.bool_)
                      else a + eps.astype(a.dtype) for a in dargs]
                return druns[0](*a2, dcarry + eps.astype(dcarry.dtype),
                                consts)

            stage_ms["decode_device_parse"] = 1000 * _time_loop(
                devparse_stage, _f0_tree, iters)
            stage_flops["decode_device_parse"] = None
    except ValueError:
        pass                     # stream/table set outside the parser caps
    finally:
        if _old_parse is None:
            _os.environ.pop("PACTPU_DECODE_PARSE", None)
        else:
            _os.environ["PACTPU_DECODE_PARSE"] = _old_parse

    enc_flops = sum(v for k, v in stage_flops.items()
                    if k != "decode" and v)
    dec_flops = stage_flops.get("decode") or 0.0
    out = {
        "blocks": blocks,
        "iters": iters,
        "method": "fori_loop harness (dispatch-latency-immune)",
        "encode_blocks_per_s": round(blocks / dt_enc, 1),
        "decode_blocks_per_s": round(blocks / dt_dec, 1),
        "roundtrip_blocks_per_s": round(blocks / (dt_enc + dt_dec), 1),
        "encode_ms_per_chunk": round(1000 * dt_enc, 3),
        "decode_ms_per_chunk": round(1000 * dt_dec, 3),
        "stage_ms": {k: round(v, 3) for k, v in stage_ms.items()},
        "stage_gflops": {k: (round(v / 1e9, 2) if v else None)
                         for k, v in stage_flops.items()},
    }
    dev = jax.devices()[0]
    out["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    # a CPU run's FLOP/s is no device metric: shares of a published peak
    # are reported for accelerators only
    peak = peaks(dev.device_kind)["f32_flops"] if dev.platform == "gpu" \
        else None
    if enc_flops:
        out["encode_gflops_per_s"] = round(enc_flops / dt_enc / 1e9, 1)
        if peak:
            out["encode_f32_peak_pct"] = round(
                100 * enc_flops / dt_enc / peak, 2)
    if dec_flops:
        out["decode_gflops_per_s"] = round(dec_flops / dt_dec / 1e9, 1)
        if peak:
            out["decode_f32_peak_pct"] = round(
                100 * dec_flops / dt_dec / peak, 2)
    return out

"""Batched water-filling bit allocation.

The reference allocator (reference codec/bitalloc.py:129-184) is a
data-dependent greedy loop: one mantissa bit per iteration to the band with
the highest NMR residual, with a global stop test keyed to the candidate
band's L/R-vs-M/S flag, a max-bits cap, and post-loop refund of 1-bit bands.

Design: the loop body is fully vectorized over a batch of R independent
(block, channel) rows — every row performs its own masked argmax/grant per
iteration and rows that finish simply stop changing state, so one loop
allocates every block of an audio file in lockstep.  The trip count is
bounded: every iteration either grants a bit (at most nBands * maxMantBits
grants) or invalidates a band (at most nBands kills), so nBands *
(maxMantBits + 1) iterations always suffice.

Legacy allocators (Uniform / ConstSNR / ConstMNR, bitalloc.py:22-125) are
provided as bounded `fori_loop` equivalents for API parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# numpy, not jnp: a module-level jnp scalar would initialize the XLA
# backend at import time, which breaks jax.distributed.initialize (it must
# run before any backend init — pactpu.parallel.cluster)
_NEG = np.float32(-1e30)


def water_fill(total_bits: jax.Array, max_mant_bits: int,
               n_lines: jax.Array, smr: jax.Array, lrms: jax.Array,
               ms_stop: float = -5.0, lr_stop: float = -15.0):
    """Batched exact-semantics water-filling (reference bitalloc.py:129-184).

    total_bits: i32[R]  (int(bitBudget + extraBits) per row)
    n_lines:    i32[bands]
    smr:        f32[R, bands]
    lrms:       bool[R, bands]
    Returns (bits i32[R, bands], leftover i32[R]) where leftover is the
    unspent `totalBits` *after* the 1-bit refund; the caller computes
    bitDifference = leftover - extraBits.

    On the GPU backend f32 rows run as one Pallas kernel whose loop state
    stays in registers (pactpu.ops.pallas_ops.water_fill); elsewhere, and
    for f64, as the XLA loop `water_fill_xla`.
    """
    smr = jnp.asarray(smr)
    if not jnp.issubdtype(smr.dtype, jnp.floating):
        smr = smr.astype(jnp.float32)
    if jax.default_backend() == "gpu" and smr.dtype == jnp.float32:
        from pactpu.ops import pallas_ops
        return pallas_ops.water_fill(total_bits, max_mant_bits, n_lines,
                                     smr, lrms, ms_stop, lr_stop)
    return water_fill_xla(total_bits, max_mant_bits, n_lines, smr, lrms,
                          ms_stop, lr_stop)


def water_fill_xla(total_bits: jax.Array, max_mant_bits: int,
                   n_lines: jax.Array, smr: jax.Array, lrms: jax.Array,
                   ms_stop: float = -5.0, lr_stop: float = -15.0):
    """`water_fill` as a plain XLA loop over the whole batch: the
    reference the kernel is checked against, and the path on every
    backend but the GPU."""
    smr = jnp.asarray(smr)
    if not jnp.issubdtype(smr.dtype, jnp.floating):
        smr = smr.astype(jnp.float32)
    r, n_bands = smr.shape
    n_lines = jnp.asarray(n_lines, jnp.int32)

    def body(_, state):
        bits, total, valid = state
        resid = smr - 6.0 * bits.astype(smr.dtype)
        # first-index argmax among valid bands (np.argmax tie-break)
        cand = jnp.argmax(jnp.where(valid, resid, _NEG), axis=1)
        row = jnp.arange(r)
        active = valid.any(axis=1)

        # global stop: max over ALL bands of SMR - (bits-1)*6 vs the
        # candidate band's threshold
        global_resid = jnp.max(smr - (bits - 1).astype(smr.dtype) * 6.0,
                               axis=1)
        stop_thr = jnp.where(lrms[row, cand], ms_stop, lr_stop)
        kill_stop = global_resid < stop_thr

        cost = n_lines[cand]
        can_pay = (total - cost) >= 0
        grant = active & can_pay
        new_bits = bits.at[row, cand].add(
            jnp.where(grant, jnp.int32(1), jnp.int32(0)))
        new_total = total - jnp.where(grant, cost, 0)
        hit_cap = new_bits[row, cand] >= max_mant_bits
        kill = active & (kill_stop | ~can_pay | (grant & hit_cap))
        new_valid = valid.at[row, cand].set(
            jnp.where(kill, False, valid[row, cand]))
        return new_bits, new_total, new_valid

    # every iteration grants a bit or kills a band, so this bound is exact
    max_iters = n_bands * (max_mant_bits + 1)
    bits0 = jnp.zeros((r, n_bands), jnp.int32)
    valid0 = jnp.ones((r, n_bands), bool)

    # exact early exit: once every row's bands are retired the body is a
    # provable no-op (active false -> grant = kill = 0), so a while-loop
    # keyed on any-row-active skips the dead tail (real rows finish well
    # inside the 425 worst-case trips) — same trick as the Pallas
    # kernel, and what makes the per-block exact-mode scan affordable
    def cond(state):
        i, _, _, valid = state
        return jnp.logical_and(i < max_iters, valid.any())

    def wbody(state):
        i, bits, total, valid = state
        bits, total, valid = body(i, (bits, total, valid))
        return i + 1, bits, total, valid

    _, bits, total, _ = jax.lax.while_loop(
        cond, wbody,
        (jnp.int32(0), bits0, jnp.asarray(total_bits, jnp.int32), valid0))

    ones_mask = bits == 1
    refund = jnp.sum(jnp.where(ones_mask, n_lines[None], 0), axis=1)
    bits = jnp.where(ones_mask, 0, bits)
    return bits, total + refund


def lrms_decision_bitalloc(smr_lr: jax.Array, smr_ms: jax.Array,
                           n_lines: jax.Array, bit_budget: int,
                           max_mant_bits: int, ms_stop: float = -5.0,
                           lr_stop: float = -15.0) -> jax.Array:
    """Bitalloc-minimization per-band L/R-vs-M/S decision: choose M/S for a
    band iff coding the M/S pair there consumes FEWER allocated mantissa
    bits than coding L/R — the second decision variant named by the WAK
    paper alongside the spectral-intensity rule (the reference only ships
    the intensity rule, codec/codec.py:94-102; psycho.lrms_decision here).

    Vectorized through the existing allocation machinery: water-fill all
    four codings (L, R, M, S) of every block in ONE batched call — each
    under the flat per-channel budget with its own coding's stop thresholds
    — then compare per-band bit costs (allocated bits x lines).  Ties go to
    L/R (strictly-fewer wins), so decorrelated content where M/S buys
    nothing falls back to plain stereo.

    smr_lr/smr_ms: f32[B, 2, bands].  Returns bool[B, bands].
    """
    b, _, n_bands = smr_lr.shape
    nl = jnp.asarray(n_lines, jnp.int32)
    smr4 = jnp.concatenate([smr_lr.reshape(b * 2, n_bands),
                            smr_ms.reshape(b * 2, n_bands)])
    lrms4 = jnp.concatenate([
        jnp.zeros((b * 2, n_bands), bool),       # L/R rows: -15 dB stop
        jnp.ones((b * 2, n_bands), bool)])       # M/S rows:  -5 dB stop
    total = jnp.full(4 * b, int(bit_budget), jnp.int32)
    bits, _ = water_fill(total, max_mant_bits, nl, smr4, lrms4,
                         ms_stop, lr_stop)
    cost_lr = bits[:2 * b].reshape(b, 2, n_bands).sum(axis=1) * nl[None]
    cost_ms = bits[2 * b:].reshape(b, 2, n_bands).sum(axis=1) * nl[None]
    return cost_ms < cost_lr


def closed_form_init(bit_budget: jax.Array, max_mant_bits: int,
                     n_lines: jax.Array, smr: jax.Array):
    """Closed-form NMR-flattening allocation (kai's allocator, reference
    baselines/kai/bitalloc.py:107-115):

        R(i) = bitBudget / sum(nLines) + (SMR[i] - avgSMR) / 6
        avgSMR = sum(nLines * SMR) / sum(nLines)

    with R < 2 -> 0 and R capped at maxMantBits, floored to integers.
    Returns (bits i32[R, bands], r f32[R, bands]) where `r` is the raw
    real-valued allocation BEFORE the gate/cap/floor (exposed so
    callers/tests can reason about floor boundaries).  Fully vectorized —
    the loop-free alternative to the greedy water-fill: one matmul row per
    batch instead of ~2000 sequential grants.
    """
    smr = jnp.asarray(smr)
    if not jnp.issubdtype(smr.dtype, jnp.floating):
        smr = smr.astype(jnp.float32)
    nl = jnp.asarray(n_lines, smr.dtype)
    total_lines = jnp.sum(nl)
    # HIGHEST: a TF32 product on the GPU would move floor boundaries
    avg = jnp.matmul(smr, nl,
                     precision=jax.lax.Precision.HIGHEST) / total_lines
    r = (jnp.asarray(bit_budget, smr.dtype)[..., None] / total_lines
         + (smr - avg[..., None]) / 6.0)
    gated = jnp.where(r < 2.0, 0.0, jnp.minimum(r, float(max_mant_bits)))
    return jnp.floor(gated).astype(jnp.int32), r


def closed_form_takeback(bits0: jax.Array, bit_budget: jax.Array,
                         n_lines: jax.Array, smr: jax.Array,
                         max_mant_bits: int = 16) -> jax.Array:
    """Overshoot take-back loop of kai's allocator (reference
    baselines/kai/bitalloc.py:116-134): while the spent bits meet or exceed
    the budget, take one bit from the band with the minimum (6 dB/bit
    adjusted) SMR, zeroing 1-bit leftovers, retiring emptied bands.

    Batched over rows as a fixed-trip `fori_loop` (every iteration either
    returns a bit or retires a band, so bands * (maxMantBits + 1) trips
    always suffice — same bound argument as `water_fill`).
    bits0: i32[R, bands]; bit_budget: i32[R]; smr: f32[R, bands].
    """
    smr = jnp.asarray(smr)
    if not jnp.issubdtype(smr.dtype, jnp.floating):
        smr = smr.astype(jnp.float32)
    bits0 = jnp.asarray(bits0, jnp.int32)
    r, n_bands = bits0.shape
    nl = jnp.asarray(n_lines, jnp.int32)
    budget = jnp.broadcast_to(jnp.asarray(bit_budget, jnp.int32), (r,))
    pos_inf = jnp.asarray(np.float32(np.inf), smr.dtype)
    # static trip bound: worst case every band starts at the cap
    trips = n_bands * (max_mant_bits + 1)

    def body(_, state):
        bits, total, valid, mysmr = state
        row = jnp.arange(r)
        cand = jnp.argmin(jnp.where(valid, mysmr, pos_inf), axis=1)
        active = valid.any(axis=1)
        over = total >= budget

        cur = bits[row, cand]
        dec = jnp.maximum(cur - 1, 0)
        dec = jnp.where(dec == 1, 0, dec)                # 1-bit zeroing
        apply = active & over
        new_cur = jnp.where(apply, dec, cur)
        bits = bits.at[row, cand].set(new_cur)
        total = total - jnp.where(apply, (cur - new_cur) * nl[cand], 0)
        mysmr = mysmr.at[row, cand].add(
            jnp.where(apply, jnp.asarray(6.0, smr.dtype), 0.0))
        # retire: emptied band (over branch) or budget already met (else)
        kill = active & jnp.where(over, new_cur == 0, True)
        valid = valid.at[row, cand].set(
            jnp.where(kill, False, valid[row, cand]))
        return bits, total, valid, mysmr

    total0 = jnp.sum(bits0 * nl[None], axis=1)
    state = (bits0, total0, jnp.ones((r, n_bands), bool), smr)

    # exact early exit (no-op tail once every row's bands are retired)
    def cond(s):
        i, (_, _, valid, _) = s
        return jnp.logical_and(i < trips, valid.any())

    def wbody(s):
        i, st = s
        return i + 1, body(i, st)

    _, (bits, _, _, _) = jax.lax.while_loop(
        cond, wbody, (jnp.int32(0), state))
    return bits


def alloc_closed_form(bit_budget: jax.Array, max_mant_bits: int,
                      n_lines: jax.Array, smr: jax.Array) -> jax.Array:
    """kai's closed-form allocator end to end (reference
    baselines/kai/bitalloc.py:84-134): closed-form init + overshoot
    take-back.  bit_budget: i32[R] (or scalar); smr: f32[R, bands].
    Returns bits i32[R, bands]."""
    smr = jnp.asarray(smr)
    if smr.ndim == 1:
        squeeze = True
        smr = smr[None]
        bit_budget = jnp.asarray(bit_budget)[None]
    else:
        squeeze = False
    bits0, _ = closed_form_init(bit_budget, max_mant_bits, n_lines, smr)
    bits = closed_form_takeback(bits0, bit_budget, n_lines, smr,
                                max_mant_bits)
    return bits[0] if squeeze else bits


def _greedy_floor(allocation, max_mant_bits):
    allocation = jnp.where(allocation < 2, 0, allocation)
    return jnp.minimum(allocation, max_mant_bits)


def alloc_uniform(bit_budget: int, max_mant_bits: int,
                  n_lines: jax.Array) -> jax.Array:
    """Uniform allocation with round-robin distribution of leftovers
    (reference BitAllocUniform, codec/bitalloc.py:22-57)."""
    import numpy as np
    total_lines = float(np.sum(np.asarray(n_lines)))
    min_lines = max(1, int(np.min(np.asarray(n_lines))))
    n_lines = jnp.asarray(n_lines, jnp.int32)
    n_bands = n_lines.shape[0]
    per_line = jnp.int32(int(bit_budget / total_lines))
    alloc = jnp.full((n_bands,), per_line, jnp.int32)
    remaining = jnp.int32(bit_budget) - jnp.sum(alloc * n_lines)

    def body(line, state):
        alloc, remaining, stopped = state
        band = line % n_bands
        nxt = remaining - n_lines[band]
        # the reference round-robin halts for good at the first band it
        # cannot afford (its while-condition); carried as a sticky flag
        stopped = stopped | (remaining <= 0) | (nxt < 0)
        take = ~stopped
        inc = take & (alloc[band] < max_mant_bits)
        alloc = alloc.at[band].add(jnp.where(inc, 1, 0))
        return alloc, jnp.where(take, nxt, remaining), stopped

    # static trip count: each taken step spends >= min_lines bits
    max_iters = int(bit_budget) // min_lines + int(n_bands)
    alloc, _, _ = jax.lax.fori_loop(
        0, max_iters, body, (alloc, remaining, jnp.bool_(False)))
    return _greedy_floor(alloc, max_mant_bits)


def _greedy_noise_floor(bit_budget: int, max_mant_bits: int,
                        n_lines: jax.Array, level: jax.Array) -> jax.Array:
    """Shared greedy core of ConstSNR/ConstMNR (codec/bitalloc.py:60-125):
    give a bit to argmax(level), lower that level by 6 dB, until the budget
    can no longer pay.

    The reference's walk *skips* when the argmax band is capped or
    unaffordable (dropping only its level), so its trip count grows with
    the level spread — and it can spin forever once every band is capped.
    Here the argmax is masked to the *grantable* bands, which is exactly
    equivalent in the final allocation: grantability is monotone
    decreasing (`remaining` only falls, `alloc` only rises), and the skip
    drops of non-grantable levels never change the ordering among
    grantable bands — so the same grants happen in the same order, minus
    the skip trips.  Every trip grants, so the walk is bounded by the
    grant count (<= budget // min(nLines))."""
    import numpy as np
    min_lines = max(1, int(np.min(np.asarray(n_lines))))
    n_lines = jnp.asarray(n_lines, jnp.int32)
    n_bands = n_lines.shape[0]
    max_iters = _legacy_iter_bound(int(bit_budget), n_lines, int(n_bands))

    def can_grant(alloc, remaining):
        return (alloc < max_mant_bits) & (remaining >= n_lines)

    def cond(s):
        i, (alloc, remaining, _) = s
        return jnp.logical_and(i < max_iters,
                               can_grant(alloc, remaining).any())

    def body(s):
        i, (alloc, remaining, level) = s
        can = can_grant(alloc, remaining)
        band = jnp.argmax(jnp.where(can, level, -jnp.inf))
        alloc = alloc.at[band].add(1)
        remaining = remaining - n_lines[band]
        level = level.at[band].add(-6.0)
        return i + 1, (alloc, remaining, level)

    _, (alloc, _, _) = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), (jnp.zeros((n_bands,), jnp.int32),
                        jnp.int32(bit_budget), level.astype(jnp.float32))))
    return _greedy_floor(alloc, max_mant_bits)


def alloc_const_snr(bit_budget: int, max_mant_bits: int, n_lines: jax.Array,
                    peak_spl: jax.Array) -> jax.Array:
    """Constant-SNR allocation from per-band peak SPL
    (reference BitAllocConstSNR, codec/bitalloc.py:60-90)."""
    return _greedy_noise_floor(bit_budget, max_mant_bits, n_lines, peak_spl)


def alloc_const_mnr(bit_budget: int, max_mant_bits: int, n_lines: jax.Array,
                    smr: jax.Array) -> jax.Array:
    """Constant-MNR allocation from per-band SMR
    (reference BitAllocConstMNR, codec/bitalloc.py:93-125)."""
    return _greedy_noise_floor(bit_budget, max_mant_bits, n_lines, smr)


def _legacy_iter_bound(budget_cap: int, n_lines, n_bands: int) -> int:
    """Static loop trip bound for the legacy allocators.  With the
    masked-argmax formulation every trip grants a bit, so trips are
    bounded by the grant count: budget // min(nLines) paid grants plus
    16 * n_bands slack for degenerate zero-cost bands (nLines == 0 grants
    are free but cap at max_mant_bits <= 16 per band)."""
    min_lines = max(1, int(np.min(np.asarray(n_lines))))
    return int(budget_cap) // min_lines + 16 * n_bands


def alloc_uniform_batch(total_bits: jax.Array, max_mant_bits: int,
                        n_lines: jax.Array, budget_cap: int) -> jax.Array:
    """Batched BitAllocUniform (reference codec/bitalloc.py:22-57): equal
    bits per line, leftovers round-robined one bit per band until the
    first unaffordable band.

    total_bits: i32[R] per-row budgets (must stay <= budget_cap, the
    static loop bound — the Engine's cbr budgets qualify).  Returns
    bits i32[R, bands]."""
    nl = jnp.asarray(n_lines, jnp.int32)
    n_bands = nl.shape[0]
    total = jnp.asarray(total_bits, jnp.int32)
    r = total.shape[0]
    total_lines = jnp.sum(nl)
    per_line = total // total_lines                       # [R]
    alloc = jnp.broadcast_to(per_line[:, None], (r, n_bands)).astype(
        jnp.int32)
    remaining = total - per_line * total_lines

    def body(line, state):
        alloc, remaining, stopped = state
        band = line % n_bands
        nxt = remaining - nl[band]
        stopped = stopped | (remaining <= 0) | (nxt < 0)
        take = ~stopped
        inc = take & (alloc[:, band] < max_mant_bits)
        alloc = alloc.at[:, band].add(jnp.where(inc, 1, 0))
        return alloc, jnp.where(take, nxt, remaining), stopped

    iters = _legacy_iter_bound(budget_cap, n_lines, int(n_bands))

    def cond(s):
        i, (_, _, stopped) = s
        return jnp.logical_and(i < iters, ~stopped.all())

    def wbody(s):
        i, st = s
        return i + 1, body(i, st)

    _, (alloc, _, _) = jax.lax.while_loop(
        cond, wbody, (jnp.int32(0),
                      (alloc, remaining, jnp.zeros(r, bool))))
    return _greedy_floor(alloc, max_mant_bits)


def _greedy_noise_floor_batch(total_bits: jax.Array, max_mant_bits: int,
                              n_lines: jax.Array, level: jax.Array,
                              budget_cap: int) -> jax.Array:
    """Batched greedy core of ConstSNR/ConstMNR (reference
    codec/bitalloc.py:60-125): per row, grant a bit to argmax(level) and
    drop that level 6 dB until the budget runs out.

    Argmax is masked to the grantable bands — exactly equivalent to the
    reference's skip-and-drop walk (see _greedy_noise_floor) but bounded
    by the grant count, so large level spreads cannot truncate it against
    the static trip cap."""
    nl = jnp.asarray(n_lines, jnp.int32)
    n_bands = nl.shape[0]
    total = jnp.asarray(total_bits, jnp.int32)
    r = total.shape[0]
    row = jnp.arange(r)

    def can_grant(alloc, remaining):
        return (alloc < max_mant_bits) & (remaining[:, None] >= nl[None, :])

    def body(state):
        alloc, remaining, level = state
        can = can_grant(alloc, remaining)                 # [R, nb]
        band = jnp.argmax(jnp.where(can, level, -jnp.inf), axis=1)
        ok = jnp.take_along_axis(can, band[:, None], axis=1)[:, 0]
        alloc = alloc.at[row, band].add(jnp.where(ok, 1, 0))
        remaining = remaining - jnp.where(ok, nl[band], 0)
        level = level.at[row, band].add(jnp.where(ok, -6.0, 0.0))
        return alloc, remaining, level

    iters = _legacy_iter_bound(budget_cap, n_lines, int(n_bands))

    def cond(s):
        i, (alloc, remaining, _) = s
        return jnp.logical_and(i < iters,
                               can_grant(alloc, remaining).any())

    def wbody(s):
        i, st = s
        return i + 1, body(st)

    _, (alloc, _, _) = jax.lax.while_loop(
        cond, wbody,
        (jnp.int32(0), (jnp.zeros((r, n_bands), jnp.int32), total,
                        level.astype(jnp.float32))))
    return _greedy_floor(alloc, max_mant_bits)


def alloc_const_snr_batch(total_bits: jax.Array, max_mant_bits: int,
                          n_lines: jax.Array, peak_spl: jax.Array,
                          budget_cap: int) -> jax.Array:
    """Batched BitAllocConstSNR (reference codec/bitalloc.py:60-90)."""
    return _greedy_noise_floor_batch(total_bits, max_mant_bits, n_lines,
                                     peak_spl, budget_cap)


def alloc_const_mnr_batch(total_bits: jax.Array, max_mant_bits: int,
                          n_lines: jax.Array, smr: jax.Array,
                          budget_cap: int) -> jax.Array:
    """Batched BitAllocConstMNR (reference codec/bitalloc.py:93-125)."""
    return _greedy_noise_floor_batch(total_bits, max_mant_bits, n_lines,
                                     smr, budget_cap)

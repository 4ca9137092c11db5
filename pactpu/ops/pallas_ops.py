"""Pallas kernel for the GPU (Triton route): the greedy water-fill.

The reference allocator (reference codec/bitalloc.py:129-184) is a
data-dependent loop of ~100-425 grants per (block, channel) row.  XLA runs
it (pactpu.ops.bitalloc.water_fill) as a `while_loop` over the whole
[R, bands] batch, so every trip launches several small kernels and reads
its loop condition back to the host.  This kernel keeps the loop inside
one program per tile of rows: the state (bits, budget, live-band mask)
stays in registers, the 25 bands are padded to 32 lanes (one warp), and
each tile stops as soon as its own rows have retired every band.

The arithmetic is the XLA loop's, carried in f32 on small integers, so
the two agree bit for bit (tests/test_pallas_ops.py, interpret mode).
`pactpu.ops.bitalloc.water_fill` selects this kernel on the GPU backend.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_LANES = 32          # bands padded to one warp's width
_MIN_PROGRAMS = 132  # one program per SM of an H100 at least
_MAX_TILE = 16       # rows per program


def row_tile(rows: int) -> int:
    """Rows per program: the largest power of two (<= _MAX_TILE) that
    still leaves at least _MIN_PROGRAMS programs, and 1 for small
    batches."""
    tile = 1
    while tile < _MAX_TILE and -(-rows // (2 * tile)) >= _MIN_PROGRAMS:
        tile *= 2
    return tile


def _water_fill_kernel(smr_ref, lrms_ref, nlines_ref, total_ref,
                       bits_ref, left_ref, *, n_bands, max_mant_bits,
                       ms_stop, lr_stop, max_iters):
    """Greedy water-filling for one tile of rows.

    smr/lrms: f32[tile, 32] (padded lanes: smr -1e30, lrms 0);
    nlines: f32[1, 32] (0 in padded lanes); total: f32[tile, 1] budget.
    Outputs: bits f32[tile, 32], left f32[tile, 1] (unspent budget after
    the 1-bit refund).
    """
    smr = smr_ref[...]
    lrms = lrms_ref[...]
    nlines = nlines_ref[...]
    lane = jax.lax.broadcasted_iota(jnp.int32, smr.shape, 1)
    valid0 = jnp.where(lane < n_bands, 1.0, 0.0).astype(jnp.float32)

    def body(state):
        i, bits, total, valid = state
        resid = smr - 6.0 * bits
        masked = jnp.where(valid > 0.0, resid, -1e30)
        # first-index argmax, the np.argmax tie-break of the reference
        cand = jax.lax.argmax(masked, 1, jnp.int32)[:, None]
        onehot = jnp.where(lane == cand, 1.0, 0.0).astype(jnp.float32)
        active = jnp.max(valid, axis=1, keepdims=True)

        global_resid = jnp.max(smr - (bits - 1.0) * 6.0, axis=1,
                               keepdims=True)
        cand_ms = jnp.sum(onehot * lrms, axis=1, keepdims=True)
        stop_thr = jnp.where(cand_ms > 0.0, ms_stop, lr_stop)
        kill_stop = jnp.where(global_resid < stop_thr, 1.0, 0.0)

        cost = jnp.sum(onehot * nlines, axis=1, keepdims=True)
        can_pay = jnp.where(total - cost >= 0.0, 1.0, 0.0)
        grant = active * can_pay
        bits = bits + grant * onehot
        total = total - grant * cost
        cand_bits = jnp.sum(onehot * bits, axis=1, keepdims=True)
        hit_cap = jnp.where(cand_bits >= max_mant_bits, 1.0, 0.0)
        kill = active * jnp.minimum(
            kill_stop + (1.0 - can_pay) + grant * hit_cap, 1.0)
        valid = valid * (1.0 - onehot * kill)
        return i + 1, bits, total, valid

    # once every row of the tile has retired its last band the body is a
    # no-op (grant = kill = 0), so stopping there is exact
    def cond(state):
        i, _, _, valid = state
        return jnp.logical_and(i < max_iters, jnp.max(valid) > 0.0)

    bits0 = jnp.zeros(smr.shape, jnp.float32)
    _, bits, total, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), bits0, total_ref[...], valid0))

    ones = jnp.where(bits == 1.0, 1.0, 0.0).astype(jnp.float32)
    refund = jnp.sum(ones * nlines, axis=1, keepdims=True)
    bits_ref[...] = bits * (1.0 - ones)
    left_ref[...] = total + refund


@partial(jax.jit, static_argnames=("max_mant_bits", "ms_stop", "lr_stop",
                                   "interpret"))
def water_fill(total_bits: jax.Array, max_mant_bits: int,
               n_lines: jax.Array, smr: jax.Array, lrms: jax.Array,
               ms_stop: float = -5.0, lr_stop: float = -15.0,
               interpret: bool = False):
    """Kernel form of pactpu.ops.bitalloc.water_fill (same contract, f32
    SMRs, at most 32 bands)."""
    r, nb = smr.shape
    assert nb <= _LANES, nb
    tile = row_tile(r)
    pad_r = (-r) % tile
    rp = r + pad_r

    def pad2(a, value=0.0):
        return jnp.pad(a.astype(jnp.float32),
                       ((0, pad_r), (0, _LANES - nb)),
                       constant_values=value)

    # padded lanes must not win the global stop-rule max -> -1e30
    smr_p = pad2(smr, value=-1e30)
    lrms_p = pad2(lrms)
    nlines_p = jnp.pad(jnp.asarray(n_lines).astype(jnp.float32)[None, :],
                       ((0, 0), (0, _LANES - nb)))
    total_p = jnp.pad(jnp.asarray(total_bits).astype(jnp.float32)[:, None],
                      ((0, pad_r), (0, 0)))

    kernel = partial(_water_fill_kernel, n_bands=nb,
                     max_mant_bits=float(max_mant_bits),
                     ms_stop=float(ms_stop), lr_stop=float(lr_stop),
                     max_iters=nb * (max_mant_bits + 1))
    row = lambda w: pl.BlockSpec((tile, w), lambda i: (i, 0))  # noqa: E731
    bits, left = pl.pallas_call(
        kernel,
        grid=(rp // tile,),
        in_specs=[row(_LANES), row(_LANES),
                  pl.BlockSpec((1, _LANES), lambda i: (0, 0)), row(1)],
        out_specs=(row(_LANES), row(1)),
        out_shape=(jax.ShapeDtypeStruct((rp, _LANES), jnp.float32),
                   jax.ShapeDtypeStruct((rp, 1), jnp.float32)),
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="water_fill",
    )(smr_p, lrms_p, nlines_p, total_p)
    return (bits[:r, :nb].astype(jnp.int32),
            left[:r, 0].astype(jnp.int32))

"""Batched MDCT / IMDCT as one dense matmul.

The reference computes a per-block FFT-based MDCT (pre-twiddle, FFT,
post-twiddle — reference codec/mdct.py:49-88, Bosi & Goldberg pp. 141-143)
one 2048-sample block at a time.  Here the transform of a *batch* of
blocks is a single dense matmul against a precomputed cosine basis:

    forward:  X[b, k] = (2/N) * sum_n x[b, n] * C[n, k]
    inverse:  y[b, n] =   2   * sum_k X[b, k] * C[n, k]

with C[n, k] = cos((2*pi/N) * (n + n0) * (k + 1/2)), n0 = (N/2 + 1)/2.

A `[B, 2048] @ [2048, 1024]` f32 matmul amortizes perfectly over the
block-batch axis — the MDCT of a whole audio chunk is one matmul.  (An FFT
would use fewer FLOPs but fragments into several kernels; the basis is
only 8 MB.)

`MDCTslow` parity: the O(N^2) reference form (codec/mdct.py:10-43) *is* this
matmul — the fast/slow split of the reference collapses into one op here.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=None)
def _mdct_basis_np(n: int) -> np.ndarray:
    """C[n, k] (float64) for a symmetric window of length n (n/2 lines)."""
    half = n // 2
    n0 = (half + 1) / 2.0
    nn = np.arange(n, dtype=np.float64)[:, None]
    kk = np.arange(half, dtype=np.float64)[None, :]
    return np.cos((2.0 * np.pi / n) * (nn + n0) * (kk + 0.5))


@lru_cache(maxsize=None)
def _mdct_basis(n: int, dtype_name: str) -> np.ndarray:
    # cached as numpy: safe to close over inside any jit trace (a device
    # array created during one trace must not leak into another)
    return _mdct_basis_np(n).astype(dtype_name)


@partial(jax.jit, static_argnames=("precision",))
def mdct(blocks: jax.Array, basis: jax.Array = None,
         precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Forward MDCT of a batch of (already windowed) blocks.

    blocks: f32[..., N] -> f32[..., N/2] MDCT lines, including the reference's
    2/N forward normalization (reference codec/mdct.py:63-70).

    `basis` (f32[N, N/2]) may be passed as a runtime argument so the 8 MB
    cosine table becomes a program *parameter* (uploaded to HBM once per
    process) instead of an embedded constant in every compiled executable.
    """
    n = blocks.shape[-1]
    if basis is None:
        basis = _mdct_basis(n, str(blocks.dtype))
    return (2.0 / n) * jnp.matmul(blocks, basis, precision=precision)


@partial(jax.jit, static_argnames=("precision",))
def imdct(lines: jax.Array, basis: jax.Array = None,
          precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Inverse MDCT: f32[..., N/2] -> f32[..., N] time samples (x N
    normalization folded in as the reference's factor 2 on the inverse,
    reference codec/mdct.py:72-79).  `basis` as in `mdct`."""
    half = lines.shape[-1]
    if basis is None:
        basis = _mdct_basis(2 * half, str(lines.dtype))
    return 2.0 * jnp.matmul(lines, basis.T, precision=precision)


def mdct_slow(data: np.ndarray, a: int, b: int,
              is_inverse: bool = False) -> np.ndarray:
    """O(N^2) float64 direct-form reference transform
    (parity with reference codec/mdct.py:10-43); host-side, for tests."""
    n = a + b
    n0 = (b + 1) / 2.0
    nn = np.arange(n, dtype=np.float64)
    if not is_inverse:
        kk = np.arange(n // 2, dtype=np.float64)
        c = np.cos((2.0 * np.pi / n) * (nn[:, None] + n0) * (kk[None, :] + 0.5))
        return (2.0 / n) * (np.asarray(data, np.float64) @ c)
    kk = np.arange(n // 2, dtype=np.float64)
    c = np.cos((2.0 * np.pi / n) * (nn[:, None] + n0) * (kk[None, :] + 0.5))
    return 2.0 * (c @ np.asarray(data, np.float64))

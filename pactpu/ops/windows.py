"""Analysis/synthesis windows as precomputed device constants.

The reference defines sine, Hann and KBD windows that mutate their argument
in place (reference codec/window.py:27-78).  Here a window application is
a broadcasted elementwise multiply of a `[B, N]` block batch with a cached
`[N]` constant, which XLA fuses into the surrounding computation; nothing is
mutated.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def sine_window(n: int) -> np.ndarray:
    """sin((t + 0.5) * pi / N), the MDCT sine window
    (reference codec/window.py:27-39)."""
    t = np.arange(n, dtype=np.float64)
    return np.sin((t + 0.5) * np.pi / n)


@lru_cache(maxsize=None)
def hann_window(n: int) -> np.ndarray:
    """0.5 * (1 - cos(2*pi*(t + 0.5)/N)), the shifted Hann window used by the
    psychoacoustic side chain (reference codec/window.py:41-53)."""
    t = np.arange(n, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * (t + 0.5) * np.pi / n))


@lru_cache(maxsize=None)
def kbd_window(n: int, alpha: float = 4.0) -> np.ndarray:
    """Kaiser-Bessel-derived window with parameter alpha
    (reference codec/window.py:56-78).  Satisfies the Princen-Bradley
    condition w[t]^2 + w[t+N/2]^2 = 1 by construction (sqrt of cumulative
    Kaiser energy), so a KBD-windowed MDCT reconstructs perfectly under
    50% overlap-add."""
    t = np.arange(n // 2 + 1, dtype=np.float64)
    kaiser = (np.i0(alpha * np.pi * np.sqrt(1.0 - (4.0 * t / n - 1.0) ** 2))
              / np.i0(np.pi * alpha))
    denom = np.sum(kaiser ** 2)
    num = np.cumsum(kaiser[:-1] ** 2)
    num = np.concatenate((num, num[::-1]))
    return np.sqrt(num / denom)


def analysis_window(kind: str, n: int) -> np.ndarray:
    """The engine's analysis/synthesis window by config name
    (CodecConfig.window): "sine" is the reference main path
    (codec/window.py:27-39); "kbd" is the flag-gated KBD mode the
    reference defines but never wires in (codec/window.py:56-78)."""
    if kind == "sine":
        return sine_window(n)
    if kind == "kbd":
        return kbd_window(n)
    raise ValueError(f"unknown window {kind!r} (use 'sine' or 'kbd')")

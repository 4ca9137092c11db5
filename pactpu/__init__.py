"""pactpu — a batched JAX perceptual audio codec framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the WAK
perceptual audio codec (wisamreid/Perceptual-Audio-Codec): MDCT transform
coding with a psychoacoustic model, water-filling bit allocation,
block-floating-point quantization, M/S joint stereo and static-table Huffman
entropy coding, producing/consuming the `.pac`/`.wak` bitstream format.

Layout
------
- ``pactpu.ops``      device compute kernels (MDCT, windows, quantizers,
                      psychoacoustics, bit allocation, Huffman length/codes)
- ``pactpu.codec``    file formats + end-to-end engine (wav, bitstream,
                      encode, decode, cli)
- ``pactpu.parallel`` mesh sharding, halo exchange, collectives
- ``pactpu.utils``    configuration, profiling helpers
- ``pactpu.compat``   bit-exact float64 oracle of the reference semantics
                      (used for golden tests and `.wak` byte-parity)

Unlike the reference (a block-serial single-threaded Python 2 program),
this design batches every block of an audio file into device arrays and
runs the whole analysis/synthesis pipeline as one fused, jitted
computation, with `jax.sharding` meshes for multi-device scaling.
"""

import os as _os


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache.

    Loop-bearing programs take seconds to compile; the persistent cache
    makes that a one-time cost per program shape.  JAX_COMPILATION_CACHE_DIR,
    when set, is left to JAX; otherwise the cache lives at a fixed path
    inside the checkout (`<repo>/.jax_cache`).  Opt out with
    PACTPU_NO_COMPILE_CACHE=1.
    """
    if _os.environ.get("PACTPU_NO_COMPILE_CACHE"):
        return
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # user config wins
    import jax
    path = _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")
    try:
        _os.makedirs(path, exist_ok=True)
    except OSError:
        return  # read-only checkout: run without a persistent cache
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)


_enable_compile_cache()

from pactpu.utils.config import CodecConfig, default_config  # noqa: E402

__all__ = ["CodecConfig", "default_config", "Engine",
           "StreamingEncoder", "StreamingDecoder", "DeviceFleet"]
__version__ = "0.3.0"

_LAZY = {
    "Engine": ("pactpu.codec.engine", "Engine"),
    "StreamingEncoder": ("pactpu.codec.stream", "StreamingEncoder"),
    "StreamingDecoder": ("pactpu.codec.stream", "StreamingDecoder"),
    "DeviceFleet": ("pactpu.parallel.serve", "DeviceFleet"),
}


def __getattr__(name: str):
    """Lazy top-level exports (`pactpu.Engine` etc.) — the engine pulls in
    the full kernel stack, so plain `import pactpu` stays light."""
    try:
        mod, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib
    return getattr(importlib.import_module(mod), attr)

"""CLI for the device-compute benchmark (pactpu.utils.devbench).

Prints one JSON line with the device's pure-compute blocks/s for the
encode chain, the decode chain, and the serial roundtrip.

Usage: python tools/device_throughput.py [--blocks 512] [--iters 20]
                                         [--input WAV]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--input", default=None,
                    help="WAV supplying payload statistics (default: "
                         "seeded synthetic music)")
    args = ap.parse_args()

    import jax

    from pactpu.utils.devbench import measure_device_compute

    if args.input:
        from pactpu.codec.wav import read_wav
        pcm = read_wav(args.input).samples
    else:
        from pactpu.utils import signals
        pcm = signals.generate(15.0)
    res = measure_device_compute(pcm, blocks=args.blocks, iters=args.iters)
    res["backend"] = jax.devices()[0].platform
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One-time port of the reference Huffman tables to packed numpy arrays.

The reference ships 10 pre-trained static Huffman tables as a Python-2
cPickle of ``{tableID: HuffmanTable}`` where each table maps unsigned BFP
mantissa codes (plus the escape symbol -1) to '0'/'1' code strings
(reference codec/Huffman.py:138-153, codec/huffmanTables.pickle).

The device engine wants dense arrays, not dicts:

- ``lengths[table, symbol]``  uint8 code length (0 = symbol not in table)
- ``codes[table, symbol]``    uint32 codeword, MSB-first in the low bits
- ``escape_lengths[table]``, ``escape_codes[table]`` for the escape path

so that per-line code lookup on device is a single gather.

Run:  python3 tools/port_huffman_tables.py
"""

import pickle
import sys

import numpy as np

REF_PICKLE = "/root/reference/codec/huffmanTables.pickle"
OUT = "pactpu/data/huffman_tables.npz"
NUM_TABLES = 10
MAX_SYMBOL = 1 << 15  # unsigned mantissas have at most 15 magnitude bits


class _Stub:  # the pickle stores instances of classes we don't need
    pass


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name in ("HuffmanTable", "Histogram", "HuffmanNode"):
            return _Stub
        return super().find_class(module, name)


def main() -> None:
    with open(REF_PICKLE, "rb") as f:
        tables = _Unpickler(f, encoding="latin1").load()

    lengths = np.zeros((NUM_TABLES, MAX_SYMBOL), dtype=np.uint8)
    codes = np.zeros((NUM_TABLES, MAX_SYMBOL), dtype=np.uint32)
    escape_lengths = np.zeros(NUM_TABLES, dtype=np.uint8)
    escape_codes = np.zeros(NUM_TABLES, dtype=np.uint32)

    for tid in range(1, NUM_TABLES + 1):
        enc = tables[tid].__dict__["encodingTable"]
        for sym, bits in enc.items():
            value = int(bits, 2)
            assert len(bits) <= 32
            if sym == -1:
                escape_lengths[tid - 1] = len(bits)
                escape_codes[tid - 1] = value
            else:
                assert 0 <= sym < MAX_SYMBOL, sym
                lengths[tid - 1, sym] = len(bits)
                codes[tid - 1, sym] = value

    np.savez_compressed(OUT, lengths=lengths, codes=codes,
                        escape_lengths=escape_lengths,
                        escape_codes=escape_codes)
    n = int((lengths > 0).sum())
    print(f"wrote {OUT}: {n} symbols across {NUM_TABLES} tables")


if __name__ == "__main__":
    sys.exit(main())

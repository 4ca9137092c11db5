"""Device-side Huffman decode (pactpu.ops.huffman_decode): the batched
bit-walk parser must match the native C++ parser bit for bit, and the
engine's device-parse decode path must be byte-identical to the host-parse
path (reference codec/Huffman.py:321-344, codec/pacfile.py:153-229)."""

import numpy as np
import pytest

from conftest import REFERENCE, requires_reference

from pactpu import native
from pactpu.codec.engine import Engine
from pactpu.compat import refcodec as rc
from pactpu.ops import huffman_decode as hd
from pactpu.utils.config import CodecConfig


def _tone_pcm(n=5 * 1024 + 321, seed=3, channels=2):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    chans = [np.sin(2 * np.pi * f * t) for f in (440, 661)[:channels]]
    sig = np.stack(chans, 1) * 20000 + rng.standard_normal(
        (n, channels)) * 400
    return np.clip(sig, -32768, 32767).astype(np.int16)


@pytest.fixture(autouse=True)
def _device_parse(monkeypatch):
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "device")


HOST_PARSERS = ("native", "python")


def _host_unpack(host: str, payload: bytes, cfg, huff=True, tables=None,
                 n_channels=None):
    """The host parser: native C++ (csrc/wakbits.cc) or its pure-Python
    fallback (pactpu.native._unpack_file_py)."""
    args = (payload, np.asarray(cfg.band_layout.n_lines, np.int32),
            cfg.n_scale_bits, cfg.n_mant_size_bits,
            cfg.n_table_id_bits if huff else 0, huff,
            cfg.n_channels if n_channels is None else n_channels, tables)
    if host == "python":
        return native._unpack_file_py(*args)
    if not native.available():
        pytest.skip("native lib unavailable")
    return native.unpack_file(*args[:5], read_lrms=huff,
                              n_channels=args[6], tables=tables)


def _parse_both(data: bytes, cfg, huff=True, tables=None, host="native"):
    _, _, off = rc.read_header(data)
    parsed = _host_unpack(host, data[off:], cfg, huff, tables)
    words, nbits = hd.frame_rows(data[off:])
    out = hd.parse_rows_fn(cfg, huff)(
        words, nbits, hd.device_lut(tables) if huff else None)
    return parsed, {k: np.asarray(v) for k, v in out.items()}


def _frame(data: bytes):
    cfg, _, off = rc.read_header(data)
    return cfg, hd.frame_rows(data[off:])


def _assert_rows_match_host(cfg, words, nbits, host, tables=None):
    """Row by row, the XLA walk flags exactly the rows the host parser
    rejects, and decodes every other non-empty row to the host's fields;
    empty rows (nbits == 0) are padding: never bad, all zero."""
    out = {k: np.asarray(v) for k, v in hd.parse_rows_fn(cfg, True)(
        words, nbits, hd.device_lut(tables)).items()}
    checked = 0
    for r in range(words.shape[0]):
        if nbits[r] == 0:
            assert not out["bad"][r]
            assert not out["mant"][r].any() and not out["ba"][r].any()
            continue
        nbytes = int(nbits[r]) // 8
        row = words[r].astype(">u4").tobytes()[:nbytes]
        payload = nbytes.to_bytes(4, "little") + row
        try:
            host_row = _host_unpack(host, payload, cfg, True, tables,
                                    n_channels=1)
        except ValueError:
            assert out["bad"][r], f"row {r}: host rejects, walk does not"
            continue
        assert not out["bad"][r], f"row {r}: walk rejects, host does not"
        for k, nk in (("overall", "overall"), ("tid", "table_id"),
                      ("ba", "ba"), ("sf", "sf"), ("mant", "mant")):
            np.testing.assert_array_equal(out[k][r], host_row[nk][0],
                                          err_msg=f"{k} row {r}")
        np.testing.assert_array_equal(out["lrms"][r], host_row["lrms"][0])
        checked += 1
    return out, checked


def _assert_parse_equal(parsed, out, c):
    assert not out["bad"].any()
    for k, nk in (("overall", "overall"), ("tid", "table_id"),
                  ("ba", "ba"), ("sf", "sf"), ("mant", "mant")):
        if nk == "table_id" and (parsed[nk] == 0).all():
            continue                      # .pac layout: no table id field
        np.testing.assert_array_equal(out[k], parsed[nk], err_msg=k)
    b = parsed["n_cblocks"] // c
    np.testing.assert_array_equal(
        out["lrms"].reshape(b, c, -1)[:, -1], parsed["lrms"])


@pytest.mark.parametrize("host", HOST_PARSERS)
def test_parser_matches_native_synthetic(host):
    cfg = CodecConfig()
    stream = rc.encode_file(_tone_pcm(), 44100, cfg)
    parsed, out = _parse_both(stream, cfg, host=host)
    _assert_parse_equal(parsed, out, 2)


@pytest.mark.parametrize("host", HOST_PARSERS)
def test_parser_matches_host_high_rate(host):
    """4.93 bps streams exercise long codes and escapes much harder."""
    cfg = CodecConfig(target_bits_per_sample=4.93)
    stream = rc.encode_file(_tone_pcm(seed=11), 44100, cfg)
    parsed, out = _parse_both(stream, cfg, host=host)
    _assert_parse_equal(parsed, out, 2)


@pytest.mark.parametrize("host", HOST_PARSERS)
def test_parser_matches_host_corrupt_rows(host):
    """Word-flipped rows: the walk flags exactly the rows the host parser
    rejects and agrees with it on every row that still parses."""
    cfg = CodecConfig()
    stream = rc.encode_file(_tone_pcm(seed=7), 44100, cfg)
    cfg2, (words, nbits) = _frame(stream)
    words = words.copy()
    rng = np.random.default_rng(0)
    for r in range(0, words.shape[0], 3):
        w = rng.integers(0, max(1, nbits[r] // 32))
        words[r, w] ^= np.uint32(rng.integers(1, 1 << 32))
    out, _ = _assert_rows_match_host(cfg2, words, nbits, host)
    assert out["bad"].any(), "no flip desynchronized a row"


@pytest.mark.parametrize("host", HOST_PARSERS)
def test_parser_matches_host_zero_and_short_rows(host):
    """An empty row is padding (not bad); a row cut to 16 bits is bad."""
    cfg = CodecConfig()
    stream = rc.encode_file(_tone_pcm(seed=5), 44100, cfg)
    cfg2, (words, nbits) = _frame(stream)
    words, nbits = words.copy(), nbits.copy()
    nbits[0] = 0
    words[0] = 0
    nbits[2] = 16                            # truncated row -> bad
    out, checked = _assert_rows_match_host(cfg2, words, nbits, host)
    assert out["bad"][2] and not out["bad"][0] and checked > 0


@pytest.mark.parametrize("host", HOST_PARSERS)
def test_parser_matches_host_bad_table_id(host):
    """Table ids 15 and 0 (outside 1..10) are bad on both parsers."""
    cfg = CodecConfig()
    stream = rc.encode_file(_tone_pcm(seed=9), 44100, cfg)
    cfg2, (words, nbits) = _frame(stream)
    words = words.copy()
    # tid is the 4 bits after the 4-bit overall scale: force 15 and 0
    words[0] = (words[0] & ~np.uint32(0x0F000000)) | np.uint32(0x0F000000)
    words[1] = words[1] & ~np.uint32(0x0F000000)
    out, _ = _assert_rows_match_host(cfg2, words, nbits, host)
    assert out["bad"][0] and out["bad"][1]


def _custom_tables():
    from pactpu.ops import huffman_train as ht
    rng = np.random.default_rng(0)
    hists = {}
    for t in range(1, 11):
        h = np.zeros(1 << 15, np.int64)
        h[:256] = rng.integers(0, 2000, 256)
        hists[t] = h
    return ht.train_tables(hists)


@pytest.mark.parametrize("host", HOST_PARSERS)
def test_parser_matches_host_custom_tables(host):
    tables = _custom_tables()
    stream = Engine(tables=tables).encode(_tone_pcm(seed=13))
    cfg, _, _ = rc.read_header(stream)
    parsed, out = _parse_both(stream, cfg, tables=tables, host=host)
    _assert_parse_equal(parsed, out, 2)


@pytest.mark.parametrize("host", HOST_PARSERS)
def test_parser_matches_host_custom_band_layout(host):
    cfg = CodecConfig(band_line_counts=(100, 200, 300, 424))
    stream = rc.encode_file(_tone_pcm(seed=15), 44100, cfg)
    cfg2, _, _ = rc.read_header(stream)
    parsed, out = _parse_both(stream, cfg2, host=host)
    _assert_parse_equal(parsed, out, 2)


def test_device_parse_word_cap(monkeypatch):
    """Rows wider than the largest upload bucket: a forced device parse
    refuses the stream, and auto without the native library falls back
    to the host parser with the same samples."""
    from pactpu.codec import engine as E
    pcm = _tone_pcm()
    eng = Engine()
    stream = eng.encode(pcm)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "host")
    _, gold = eng.decode(stream)
    monkeypatch.setattr(E, "_PAYLOAD_WORD_BUCKETS", (8,))
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "device")
    with pytest.raises(ValueError, match="does not fit the device parser"):
        eng.decode(stream)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "auto")
    monkeypatch.setenv("PACTPU_NO_NATIVE", "1")
    _, out = eng.decode(stream)
    np.testing.assert_array_equal(out, gold)


@requires_reference
def test_parser_matches_native_golden():
    for name in ("coded/piano_test2.wak",
                 "coded/withHuffman/piano_test1.wak"):
        with open(f"{REFERENCE}/{name}", "rb") as f:
            data = f.read()
        cfg, _, _ = rc.read_header(data)
        parsed, out = _parse_both(data, cfg)
        _assert_parse_equal(parsed, out, 2)


def test_engine_device_parse_equals_host(monkeypatch):
    pcm = _tone_pcm()
    eng = Engine(rate_mode="reservoir")
    stream = eng.encode(pcm)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "host")
    fs_h, out_h = eng.decode(stream)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "device")
    fs_d, out_d = eng.decode(stream)
    assert fs_h == fs_d
    np.testing.assert_array_equal(out_h, out_d)


@requires_reference
def test_engine_device_parse_golden_stream(monkeypatch):
    """Device-parse and host-parse decodes of the golden reference stream
    are sample-identical (bit-exactness vs the golden WAV itself is the
    f64 oracle's bar, test_compat_golden)."""
    with open(f"{REFERENCE}/coded/piano_test2.wak", "rb") as f:
        data = f.read()
    eng = Engine()
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "host")
    fs_h, out_h = eng.decode(data)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "device")
    fs_d, out_d = eng.decode(data)
    assert fs_h == fs_d
    np.testing.assert_array_equal(out_h, out_d)


def test_engine_device_parse_pac_format(monkeypatch):
    pcm = _tone_pcm()
    eng = Engine(rate_mode="cbr", fmt="pac")
    stream = eng.encode(pcm)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "host")
    _, out_h = eng.decode(stream)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "device")
    _, out_d = eng.decode(stream)
    np.testing.assert_array_equal(out_h, out_d)


def test_engine_device_parse_mono(monkeypatch):
    pcm = _tone_pcm(channels=1)
    eng = Engine(cfg=CodecConfig(n_channels=1))
    stream = eng.encode(pcm)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "host")
    _, out_h = eng.decode(stream)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "device")
    _, out_d = eng.decode(stream)
    np.testing.assert_array_equal(out_h, out_d)


def test_device_parse_corrupt_payload_raises(monkeypatch):
    """Byte flips that desynchronize the host bit-walk must also flag on
    the device walk (a flip inside sign/raw-mantissa bits legitimately
    stays decodable — then both paths succeed)."""
    pcm = _tone_pcm()
    eng = Engine()
    stream = eng.encode(pcm)
    raised = 0
    for frac in (3, 5, 7, 11, 13):
        bad = bytearray(stream)
        bad[len(bad) // frac] ^= 0xFF
        bad = bytes(bad)

        def outcome(mode):
            monkeypatch.setenv("PACTPU_DECODE_PARSE", mode)
            try:
                return eng.decode(bad)[1]
            except ValueError:
                return None

        host = outcome("host")
        dev = outcome("device")
        if host is None:
            assert dev is None, f"host raised, device decoded (1/{frac})"
            raised += 1
        else:
            assert dev is not None and np.array_equal(host, dev)
    assert raised, "no flip position desynchronized the stream"


def test_device_parse_bad_table_id_raises():
    """A table id past the table count must flag, not gather garbage.
    Table id is the 4 bits after the overall scale in the first
    channel-block (reference codec/pacfile.py:187-193)."""
    pcm = _tone_pcm()
    eng = Engine()
    stream = bytearray(eng.encode(pcm))
    cfg, _, off = rc.read_header(bytes(stream))
    first = off + 4                        # past the nBytes prefix
    # overall scale is 4 bits; table id the next 4 -> low nibble of byte 0
    stream[first] = (stream[first] & 0xF0) | 0x0F   # tid = 15
    with pytest.raises(ValueError, match="corrupt payload"):
        eng.decode(bytes(stream))


def test_device_lut_rejects_oversized_codes():
    lengths = np.zeros((1, 64), np.int32)
    lengths[0, 1] = hd.MAX_LUT_BITS + 1
    codes = np.zeros((1, 64), np.int32)
    esc_len = np.asarray([7], np.int32)
    esc_codes = np.asarray([3], np.int32)
    assert hd.build_lut((lengths, codes, esc_len, esc_codes)) is None


def test_engine_device_parse_custom_tables(monkeypatch, tmp_path):
    """A retrained table set flows through the device LUT exactly like the
    native path (Engine(tables=...))."""
    from pactpu.ops import huffman_train as ht
    rng = np.random.default_rng(0)
    hists = {}
    for t in range(1, 11):
        h = np.zeros(1 << 15, np.int64)
        h[:256] = rng.integers(0, 2000, 256)
        hists[t] = h
    tables = ht.train_tables(hists)
    pcm = _tone_pcm()
    eng = Engine(tables=tables)
    stream = eng.encode(pcm)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "host")
    _, out_h = eng.decode(stream)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "device")
    _, out_d = eng.decode(stream)
    np.testing.assert_array_equal(out_h, out_d)


def test_device_parse_multi_chunk(monkeypatch):
    """Device parse across chunk boundaries (the OLA carry chains through
    the payload-parse chunk program like every other decoder)."""
    pcm = _tone_pcm(n=9 * 1024 + 100)
    eng = Engine(chunk_blocks=4)            # forces multiple chunks
    stream = eng.encode(pcm)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "host")
    _, out_h = eng.decode(stream)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "device")
    _, out_d = eng.decode(stream)
    np.testing.assert_array_equal(out_h, out_d)


def test_device_parse_custom_band_layout(monkeypatch):
    """Self-describing nLines[] headers (tests/test_band_layouts contract)
    decode identically through the device bit-walk."""
    import dataclasses as dc

    cfg = CodecConfig(band_line_counts=(100, 200, 300, 424))
    pcm = _tone_pcm()
    eng = Engine(cfg=cfg)
    stream = eng.encode(pcm)
    dec = Engine()                          # layout comes from the header
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "host")
    _, out_h = dec.decode(stream)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "device")
    _, out_d = dec.decode(stream)
    np.testing.assert_array_equal(out_h, out_d)


def test_decode_parse_env_validated(monkeypatch):
    pcm = _tone_pcm(n=2048)
    eng = Engine()
    stream = eng.encode(pcm)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "bogus")
    with pytest.raises(ValueError, match="PACTPU_DECODE_PARSE"):
        eng.decode(stream)


def test_frame_rows_word_cap_fallback():
    """Rows wider than word_cap signal the caller to use the host parser
    (None, None) instead of building a huge padded upload."""
    payload = (int(10).to_bytes(4, "little") + bytes(10)
               + int(100).to_bytes(4, "little") + bytes(100))
    words, nbits = hd.frame_rows(payload, word_cap=8)
    assert words is None and nbits is None
    words, nbits = hd.frame_rows(payload, word_cap=32)
    assert words.shape == (2, 25) and list(nbits) == [80, 800]


def test_device_parse_kbd_window(monkeypatch):
    """KBD-window streams (the flag-gated extension) decode identically
    through the device bit-walk (the parse is bit-level; synthesis
    follows the decoding engine's configured window)."""
    cfg = CodecConfig(window="kbd")
    pcm = _tone_pcm()
    eng = Engine(cfg=cfg)
    stream = eng.encode(pcm)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "host")
    _, out_h = eng.decode(stream)
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "device")
    _, out_d = eng.decode(stream)
    np.testing.assert_array_equal(out_h, out_d)

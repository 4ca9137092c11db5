// Native bitstream runtime for the pactpu perceptual audio codec.
//
// The device engine computes everything batched on device (MDCT, psych model,
// allocation, quantization, Huffman table selection); what remains is the
// inherently bit-serial host work the reference did per block in Python
// (reference codec/bitpack.py:36-170 MSB-first packing, codec/Huffman.py:
// 321-344 bit-by-bit tree-walk decoding, codec/pacfile.py:153-353 block
// payload layout).  This file implements that layout natively:
//
//   wak_init_tables   build Huffman decode trees from the dense tables
//   wak_pack_file     serialize all channel-block payloads of a file
//   wak_count_blocks  scan nBytes prefixes to count blocks
//   wak_unpack_file   parse all channel-block payloads of a file
//
// Field layout per channel payload (reference codec/pacfile.py:288-351):
//   overallScale(nScaleBits) tableID(nTableIDBits)
//   per band: bitAlloc-1|0 (nMantSizeBits), scaleFactor(nScaleBits),
//             [nLines sign bits][nLines Huffman codes]      (if bitAlloc)
//   nBands LRMS flags (1 bit each)                          (per channel!)
// padded to a byte, preceded by a uint32 little-endian byte count.
//
// Build: g++ -O3 -shared -fPIC -o libwakbits.so wakbits.cc

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Node {
  int32_t child[2];
  int32_t sym;  // -2 internal, -1 escape, >=0 literal symbol
};

struct Tables {
  std::vector<std::vector<Node>> trees;  // one per table id (0-based)
};

Tables g_tables;

void tree_insert(std::vector<Node>& t, uint32_t code, int len, int32_t sym) {
  int cur = 0;
  for (int bitpos = len - 1; bitpos >= 0; --bitpos) {
    int b = (code >> bitpos) & 1;
    int nxt = t[cur].child[b];
    if (nxt < 0) {
      t.push_back({{-1, -1}, -2});
      nxt = static_cast<int>(t.size()) - 1;
      t[cur].child[b] = nxt;
    }
    cur = nxt;
  }
  t[cur].sym = sym;
}

class BitWriter {
 public:
  explicit BitWriter(uint8_t* out) : out_(out), bitpos_(0) {}
  void write(uint32_t value, int nbits) {
    for (int i = nbits - 1; i >= 0; --i) {
      uint64_t p = bitpos_++;
      uint8_t bit = (value >> i) & 1;
      out_[p >> 3] |= bit << (7 - (p & 7));
    }
  }
  int64_t bits() const { return bitpos_; }

 private:
  uint8_t* out_;
  int64_t bitpos_;
};

class BitReader {
 public:
  BitReader(const uint8_t* data, int64_t nbytes)
      : data_(data), nbits_(nbytes * 8), bitpos_(0) {}
  int read_bit() {
    if (bitpos_ >= nbits_) {
      overrun_ = true;
      return 0;
    }
    int64_t p = bitpos_++;
    return (data_[p >> 3] >> (7 - (p & 7))) & 1;
  }
  uint32_t read(int nbits) {
    uint32_t v = 0;
    for (int i = 0; i < nbits; ++i) v = (v << 1) | read_bit();
    return v;
  }
  bool overrun() const { return overrun_; }

 private:
  const uint8_t* data_;
  int64_t nbits_;
  int64_t bitpos_;
  bool overrun_ = false;
};

}  // namespace

extern "C" {

// Build decode trees from dense tables: lengths/codes are [n_tables][n_syms];
// a zero length means the symbol is absent.  Escape codes decode to the
// symbol -1 sentinel handled in wak_unpack_file.
int wak_init_tables(const uint8_t* lengths, const uint32_t* codes,
                    const uint8_t* esc_len, const uint32_t* esc_codes,
                    int n_tables, int n_syms) {
  g_tables.trees.assign(n_tables, {});
  for (int t = 0; t < n_tables; ++t) {
    auto& tree = g_tables.trees[t];
    tree.reserve(1 << 17);
    tree.push_back({{-1, -1}, -2});
    tree_insert(tree, esc_codes[t], esc_len[t], -1);
    const uint8_t* len_row = lengths + static_cast<int64_t>(t) * n_syms;
    const uint32_t* code_row = codes + static_cast<int64_t>(t) * n_syms;
    for (int s = 0; s < n_syms; ++s) {
      if (len_row[s]) tree_insert(tree, code_row[s], len_row[s], s);
    }
  }
  return static_cast<int>(g_tables.trees.size());
}

// Serialize n_cblocks channel payloads (block-major, channel-minor order)
// into `out`.  Per channel-block inputs are rows of the given arrays:
//   overall[i], table_id[i], ba[i][n_bands], sf[i][n_bands],
//   sign/code/len[i][total_lines] (line-indexed; untransmitted lines are
//   skipped via ba), lrms[i / n_channels] given per block (all channels of
//   a block share one LRMS row).
// Format selection: n_table_id_bits == 0 selects the baseline .pac layout
// (reference codec/solution/pacfile_.py:290-305): no table id, no separate
// sign bits, each line written as its raw `len` (= bitAlloc)-bit
// sign-magnitude mantissa code; write_lrms == 0 omits the LRMS flags.
// Returns total bytes written, or -1 on overflow of out_cap.
int64_t wak_pack_file(int n_cblocks, int n_bands, const int32_t* n_lines,
                      int total_lines, int n_scale_bits, int n_mant_size_bits,
                      int n_table_id_bits, int write_lrms, int n_channels,
                      const int32_t* overall,
                      const int32_t* table_id, const int32_t* ba,
                      const int32_t* sf, const int32_t* sign,
                      const int32_t* code, const int32_t* len,
                      const int32_t* lrms, uint8_t* out, int64_t out_cap) {
  const bool huff = n_table_id_bits > 0;
  int64_t pos = 0;
  for (int i = 0; i < n_cblocks; ++i) {
    const int32_t* ba_r = ba + static_cast<int64_t>(i) * n_bands;
    const int32_t* sf_r = sf + static_cast<int64_t>(i) * n_bands;
    const int32_t* sg_r = sign + static_cast<int64_t>(i) * total_lines;
    const int32_t* cd_r = code + static_cast<int64_t>(i) * total_lines;
    const int32_t* ln_r = len + static_cast<int64_t>(i) * total_lines;
    const int32_t* lr_r = lrms + static_cast<int64_t>(i / n_channels) * n_bands;

    // count payload bits
    int64_t bits = n_scale_bits + n_table_id_bits +
                   static_cast<int64_t>(n_bands) *
                       (n_mant_size_bits + n_scale_bits + (write_lrms ? 1 : 0));
    int line0 = 0;
    for (int b = 0; b < n_bands; ++b) {
      if (ba_r[b]) {
        if (huff) bits += n_lines[b];  // sign bits
        for (int j = 0; j < n_lines[b]; ++j) bits += ln_r[line0 + j];
      }
      line0 += n_lines[b];
    }
    int64_t nbytes = (bits + 7) / 8;
    if (pos + 4 + nbytes > out_cap) return -1;

    out[pos] = static_cast<uint8_t>(nbytes & 0xff);
    out[pos + 1] = static_cast<uint8_t>((nbytes >> 8) & 0xff);
    out[pos + 2] = static_cast<uint8_t>((nbytes >> 16) & 0xff);
    out[pos + 3] = static_cast<uint8_t>((nbytes >> 24) & 0xff);
    pos += 4;

    std::memset(out + pos, 0, nbytes);
    BitWriter w(out + pos);
    w.write(static_cast<uint32_t>(overall[i]), n_scale_bits);
    if (huff) w.write(static_cast<uint32_t>(table_id[i]), n_table_id_bits);
    line0 = 0;
    for (int b = 0; b < n_bands; ++b) {
      int a = ba_r[b];
      w.write(static_cast<uint32_t>(a ? a - 1 : 0), n_mant_size_bits);
      w.write(static_cast<uint32_t>(sf_r[b]), n_scale_bits);
      if (a) {
        if (huff) {
          for (int j = 0; j < n_lines[b]; ++j)
            w.write(static_cast<uint32_t>(sg_r[line0 + j]), 1);
        }
        for (int j = 0; j < n_lines[b]; ++j)
          w.write(static_cast<uint32_t>(cd_r[line0 + j]), ln_r[line0 + j]);
      }
      line0 += n_lines[b];
    }
    if (write_lrms) {
      for (int b = 0; b < n_bands; ++b)
        w.write(static_cast<uint32_t>(lr_r[b]), 1);
    }
    pos += nbytes;
  }
  return pos;
}

// Assemble device-packed payload rows into the .wak framing: per row a
// uint32 little-endian byte-count prefix (reference codec/pacfile.py:314-322)
// followed by the first (nbits+7)/8 bytes of the row's u32 words rendered
// big-endian (the device packer emits MSB-first bitstreams in u32 words).
// Returns total bytes written, or -1 on overflow of out_cap.
int64_t wak_assemble_rows(const uint32_t* words, int n_rows, int n_words,
                          const int32_t* nbits, uint8_t* out,
                          int64_t out_cap) {
  int64_t pos = 0;
  for (int r = 0; r < n_rows; ++r) {
    int64_t nbytes = (static_cast<int64_t>(nbits[r]) + 7) / 8;
    if (pos + 4 + nbytes > out_cap ||
        nbytes > static_cast<int64_t>(n_words) * 4)
      return -1;
    out[pos] = static_cast<uint8_t>(nbytes & 0xff);
    out[pos + 1] = static_cast<uint8_t>((nbytes >> 8) & 0xff);
    out[pos + 2] = static_cast<uint8_t>((nbytes >> 16) & 0xff);
    out[pos + 3] = static_cast<uint8_t>((nbytes >> 24) & 0xff);
    pos += 4;
    const uint32_t* row = words + static_cast<int64_t>(r) * n_words;
    int64_t full = nbytes / 4;
    for (int64_t w = 0; w < full; ++w) {
      uint32_t v = row[w];
      out[pos++] = static_cast<uint8_t>(v >> 24);
      out[pos++] = static_cast<uint8_t>(v >> 16);
      out[pos++] = static_cast<uint8_t>(v >> 8);
      out[pos++] = static_cast<uint8_t>(v);
    }
    for (int k = 0; k < (nbytes & 3); ++k)
      out[pos++] = static_cast<uint8_t>(row[full] >> (24 - 8 * k));
  }
  return pos;
}

// Repack decoded sign-magnitude mantissa codes into a fixed-width
// MSB-first u32 word stream per channel-block: line j of band b
// contributes ba[b] bits (its full code, sign bit leading).  The device
// unpacker (pactpu extract_codes kernel) re-slices them from offsets
// computed on device out of ba alone — so the host uploads ~2.3 kbit per
// channel-block instead of 16 kbit of u16 codes through the
// host<->device link.  `words` must be zeroed, [n_cblocks][n_words].
// Returns the max bits used by any row, or -1 on overflow of n_words*32.
int64_t wak_repack_codes(int n_cblocks, int n_bands, const int32_t* n_lines,
                         int total_lines, const int32_t* ba,
                         const int32_t* mant, uint32_t* words, int n_words) {
  int64_t maxbits = 0;
  const int64_t cap = static_cast<int64_t>(n_words) * 32;
  for (int i = 0; i < n_cblocks; ++i) {
    const int32_t* ba_r = ba + static_cast<int64_t>(i) * n_bands;
    const int32_t* m_r = mant + static_cast<int64_t>(i) * total_lines;
    uint32_t* w_r = words + static_cast<int64_t>(i) * n_words;
    int64_t p = 0;
    int line0 = 0;
    for (int b = 0; b < n_bands; ++b) {
      int a = ba_r[b];
      if (a) {
        if (p + static_cast<int64_t>(a) * n_lines[b] > cap) return -1;
        for (int j = 0; j < n_lines[b]; ++j) {
          uint32_t v = static_cast<uint32_t>(m_r[line0 + j]);
          for (int k = a - 1; k >= 0; --k) {
            w_r[p >> 5] |= ((v >> k) & 1u) << (31 - (p & 31));
            ++p;
          }
        }
      }
      line0 += n_lines[b];
    }
    if (p > maxbits) maxbits = p;
  }
  return maxbits;
}

// Assemble DENSE device-packed payload rows (wak_assemble_rows over a
// flat buffer): row r's words start at word_offsets[r] in `words` and the
// first (nbits[r]+7)/8 bytes are emitted big-endian after the uint32
// little-endian byte-count prefix.  Returns bytes written, -1 on overflow.
int64_t wak_assemble_rows_flat(const uint32_t* words,
                               const int32_t* word_offsets,
                               const int32_t* nbits, int n_rows,
                               uint8_t* out, int64_t out_cap) {
  int64_t pos = 0;
  for (int r = 0; r < n_rows; ++r) {
    int64_t nbytes = (static_cast<int64_t>(nbits[r]) + 7) / 8;
    if (pos + 4 + nbytes > out_cap) return -1;
    out[pos] = static_cast<uint8_t>(nbytes & 0xff);
    out[pos + 1] = static_cast<uint8_t>((nbytes >> 8) & 0xff);
    out[pos + 2] = static_cast<uint8_t>((nbytes >> 16) & 0xff);
    out[pos + 3] = static_cast<uint8_t>((nbytes >> 24) & 0xff);
    pos += 4;
    const uint32_t* row = words + word_offsets[r];
    int64_t full = nbytes / 4;
    for (int64_t w = 0; w < full; ++w) {
      uint32_t v = row[w];
      out[pos++] = static_cast<uint8_t>(v >> 24);
      out[pos++] = static_cast<uint8_t>(v >> 16);
      out[pos++] = static_cast<uint8_t>(v >> 8);
      out[pos++] = static_cast<uint8_t>(v);
    }
    int rem = static_cast<int>(nbytes - full * 4);
    if (rem) {
      uint32_t v = row[full];
      for (int k = 0; k < rem; ++k)
        out[pos++] = static_cast<uint8_t>(v >> (24 - 8 * k));
    }
  }
  return pos;
}

// Count channel payloads by walking the nBytes prefixes.
int64_t wak_count_blocks(const uint8_t* data, int64_t size) {
  int64_t off = 0, n = 0;
  while (off + 4 <= size) {
    uint32_t nbytes;
    std::memcpy(&nbytes, data + off, 4);
    off += 4 + nbytes;
    if (off > size) break;
    ++n;
  }
  return n;
}

// Parse n_cblocks channel payloads starting at `data` (past the header).
// Outputs are row-per-channel-block arrays as in wak_pack_file; mantissas
// are reassembled as sign * 2^(ba-1) + unsigned (reference
// codec/pacfile.py:201-211).  n_table_id_bits == 0 selects the baseline
// .pac layout (raw ba-bit mantissas, no signs/table id); read_lrms == 0
// skips LRMS flags.  Returns bytes consumed, or -(i+1) if channel-block i
// overran its payload.
int64_t wak_unpack_file(const uint8_t* data, int64_t size, int n_cblocks,
                        int n_bands, const int32_t* n_lines, int total_lines,
                        int n_scale_bits, int n_mant_size_bits,
                        int n_table_id_bits, int read_lrms, int n_channels,
                        int32_t* overall,
                        int32_t* table_id, int32_t* ba, int32_t* sf,
                        int32_t* mant, int32_t* lrms) {
  const bool huff = n_table_id_bits > 0;
  int64_t off = 0;
  for (int i = 0; i < n_cblocks; ++i) {
    if (off + 4 > size) return -(i + 1);
    uint32_t nbytes;
    std::memcpy(&nbytes, data + off, 4);
    off += 4;
    if (off + nbytes > size) return -(i + 1);
    BitReader r(data + off, nbytes);
    off += nbytes;

    int32_t* ba_r = ba + static_cast<int64_t>(i) * n_bands;
    int32_t* sf_r = sf + static_cast<int64_t>(i) * n_bands;
    int32_t* mant_r = mant + static_cast<int64_t>(i) * total_lines;
    int32_t* lr_r = lrms + static_cast<int64_t>(i / n_channels) * n_bands;
    std::memset(mant_r, 0, sizeof(int32_t) * total_lines);

    overall[i] = static_cast<int32_t>(r.read(n_scale_bits));
    const std::vector<Node>* tree = nullptr;
    if (huff) {
      int tid = static_cast<int>(r.read(n_table_id_bits));
      table_id[i] = tid;
      if (tid < 1 || tid > static_cast<int>(g_tables.trees.size()))
        return -(i + 1);
      tree = &g_tables.trees[tid - 1];
    } else {
      table_id[i] = 0;
    }

    int line0 = 0;
    for (int b = 0; b < n_bands; ++b) {
      int a = static_cast<int>(r.read(n_mant_size_bits));
      if (a) a += 1;
      ba_r[b] = a;
      sf_r[b] = static_cast<int32_t>(r.read(n_scale_bits));
      if (a) {
        int nl = n_lines[b];
        if (huff) {
          // sign bits first, then Huffman codes (ref pacfile.py:334-342)
          for (int j = 0; j < nl; ++j)
            mant_r[line0 + j] = static_cast<int32_t>(r.read_bit()) << (a - 1);
          for (int j = 0; j < nl; ++j) {
            int cur = 0;
            while ((*tree)[cur].sym == -2) {
              cur = (*tree)[cur].child[r.read_bit()];
              if (cur < 0 || r.overrun()) return -(i + 1);
            }
            int32_t s = (*tree)[cur].sym;
            if (s == -1) s = static_cast<int32_t>(r.read(a));  // escape
            mant_r[line0 + j] += s;
          }
        } else {
          // raw sign-magnitude mantissa codes (solution/pacfile_.py:186-192)
          for (int j = 0; j < nl; ++j)
            mant_r[line0 + j] = static_cast<int32_t>(r.read(a));
        }
      }
      line0 += n_lines[b];
    }
    if (read_lrms) {
      for (int b = 0; b < n_bands; ++b)
        lr_r[b] = static_cast<int32_t>(r.read_bit());
    }
    if (r.overrun()) return -(i + 1);
  }
  return off;
}

}  // extern "C"

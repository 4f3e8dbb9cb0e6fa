// The strip and tile codings of TIFF for the port's image reader
// (frn_tpu_torch/data/image_io.py), as libtiff 4.7 decodes them under
// cv2.imread. OpenCV reads a TIFF through libtiff's TIFFRGBAImage interface
// without stopping on a decoding error, so what a damaged strip gives is the
// bytes libtiff's decoder wrote before it gave up (the rest of the strip
// buffer is zero) and whether it gave up (a failed decode skips the
// predictor). Each entry point decodes one strip or tile into a zeroed
// buffer of the strip's size and returns 1 where libtiff's decoder succeeds,
// 0 where it fails:
//  - frn_tiff_lzw: LZW (compression 5), libtiff's LZWDecode: MSB-first
//    codes of 9-12 bits, the width growing one code early, the stream
//    starting with a clear code; a code not yet in the table, or the data
//    ending before an end code, zero the rest and fail; a string longer than
//    the room left fills it and succeeds. With `compat`, LZWDecodeCompat,
//    the old-style LSB-first codes without the early change, which libtiff
//    picks for a strip whose first byte is 0 and whose second is odd and
//    then keeps for the rest of the file;
//  - frn_tiff_inflate: Deflate (compressions 8 and 32946), libtiff's
//    ZIPDecode over zlib's inflate: the zlib header and Adler-32 trailer, the
//    stored, fixed and dynamic blocks with zlib's checks on them; output
//    stops when the strip is full (the codes that write nothing after it are
//    still read), and any error, or a stream that ends short, fails;
//  - frn_tiff_packbits: PackBits (compression 32773), libtiff's
//    PackBitsDecode: runs cut to the room left, a run with too few bytes
//    after it ends the strip.
//
// Plain C ABI, bound by ctypes; built by frn_tpu_torch/utils/native.py.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------ LZW

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kBitsMin = 9, kBitsMax = 12, kCsize = 5119;

struct Code {
  int next;  // index of the prefix entry, -1 for none
  int length;
  uint8_t value;
  uint8_t firstchar;
};

struct LzwTable {
  std::vector<Code> tab;
  LzwTable() : tab(kCsize + 1) {
    for (int c = 0; c < 256; ++c) tab[c] = Code{-1, 1, static_cast<uint8_t>(c), static_cast<uint8_t>(c)};
    for (int c = 256; c < kFirst; ++c) tab[c] = Code{-1, 0, 0, 0};
  }
};

// Writes entry e's string into out[0, len) (the string of length len).
void put_string(const std::vector<Code>& tab, int e, uint8_t* out, int64_t len) {
  for (int64_t at = len - 1; at >= 0 && e >= 0; --at) {
    out[at] = tab[e].value;
    e = tab[e].next;
  }
}

// The prefix of entry e's string that fits in `room` bytes (libtiff walks
// back to the entry of that length).
void put_prefix(const std::vector<Code>& tab, int e, uint8_t* out, int64_t room) {
  while (e >= 0 && tab[e].length > room) e = tab[e].next;
  put_string(tab, e, out, room);
}

int lzw_new(const uint8_t* src, int64_t n, uint8_t* op, int64_t occ) {
  LzwTable t;
  std::vector<Code>& tab = t.tab;
  int nbits = kBitsMin;
  int nbitsmask = (1 << nbits) - 1;
  int free_ent = -1;  // libtiff starts the table "full": a clear code must come first
  int maxcode = nbitsmask - 1;
  int old = 0;
  uint64_t acc = 0;
  int accbits = 0;
  int64_t pos = 0;
  // whole bytes only: a code is read where the bytes of all its bits are there
  auto get = [&](int& code) -> bool {
    while (accbits < nbits) {
      if (pos >= n) return false;
      acc = (acc << 8) | src[pos++];
      accbits += 8;
    }
    accbits -= nbits;
    code = static_cast<int>((acc >> accbits) & static_cast<uint64_t>(nbitsmask));
    acc &= (uint64_t{1} << accbits) - 1;
    return true;
  };
  auto fail_zero = [&]() {
    std::memset(op, 0, static_cast<size_t>(occ));
    return 0;
  };
  auto grow = [&]() {
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask - 1;
      if (free_ent >= kCsize) free_ent = -1;
    }
  };
  if (occ == 0) return 1;
  for (;;) {
    int code;
    if (!get(code)) return fail_zero();
    if (code == kClear) {
      free_ent = kFirst;
      nbits = kBitsMin;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask - 1;
      do {
        if (!get(code)) return fail_zero();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kEoi) return fail_zero();
      *op++ = static_cast<uint8_t>(code);
      --occ;
      old = code;
      if (occ == 0) return 1;
      continue;
    }
    if (code == kEoi) break;
    if (code < 256) {
      if (free_ent < 0 || code > free_ent) return fail_zero();
      Code& f = tab[free_ent];
      f.next = old;
      f.firstchar = tab[old].firstchar;
      f.length = tab[old].length + 1;
      f.value = static_cast<uint8_t>(code);
      grow();
      old = code;
      *op++ = static_cast<uint8_t>(code);
      if (--occ == 0) return 1;
      continue;
    }
    // code >= 258
    if (free_ent < 0 || code > free_ent) return fail_zero();
    Code& f = tab[free_ent];
    f.value = code == free_ent ? tab[old].firstchar : tab[code].firstchar;
    f.next = old;
    f.firstchar = tab[old].firstchar;
    f.length = tab[old].length + 1;
    grow();
    old = code;
    const int64_t len = tab[code].length;
    if (len > occ) {
      put_prefix(tab, code, op, occ);
      return 1;
    }
    put_string(tab, code, op, len);
    op += len;
    occ -= len;
    if (occ == 0) return 1;
  }
  // an end code with room left
  std::memset(op, 0, static_cast<size_t>(occ));
  return 0;
}

int lzw_compat(const uint8_t* src, int64_t n, uint8_t* op, int64_t occ) {
  LzwTable t;
  std::vector<Code>& tab = t.tab;
  int64_t bitsleft = n * 8;
  int64_t pos = 0;
  uint64_t nextdata = 0;
  int nextbits = 0;
  int nbits = kBitsMin;
  int nbitsmask = (1 << nbits) - 1;
  int free_ent = -1;
  int maxcode = nbitsmask;
  int old = 0;
  auto next_code = [&]() -> int {
    if (bitsleft < nbits) return kEoi;  // "not terminated with EOI": taken as one
    nextdata |= static_cast<uint64_t>(src[pos++]) << nextbits;
    nextbits += 8;
    if (nextbits < nbits) {
      nextdata |= static_cast<uint64_t>(src[pos++]) << nextbits;
      nextbits += 8;
    }
    const int code = static_cast<int>(nextdata & static_cast<uint64_t>(nbitsmask));
    nextdata >>= nbits;
    nextbits -= nbits;
    bitsleft -= nbits;
    return code;
  };
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int c = kFirst; c <= kCsize; ++c) tab[c] = Code{-1, 0, 0, 0};
        nbits = kBitsMin;
        nbitsmask = (1 << nbits) - 1;
        maxcode = nbitsmask;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return 0;
      *op++ = static_cast<uint8_t>(code);
      --occ;
      old = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kCsize) return 0;
    Code& f = tab[free_ent];
    f.next = old;
    f.firstchar = tab[old].firstchar;
    f.length = tab[old].length + 1;
    f.value = code < free_ent ? tab[code].firstchar : f.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask;
    }
    old = code;
    if (code >= 256) {
      if (tab[code].length == 0) return 0;
      if (tab[code].length > occ) {
        put_prefix(tab, code, op, occ);
        occ = 0;
        break;
      }
      const int64_t len = tab[code].length;
      put_string(tab, code, op, len);
      op += len;
      occ -= len;
    } else {
      *op++ = static_cast<uint8_t>(code);
      --occ;
    }
  }
  return occ > 0 ? 0 : 1;
}

// ------------------------------------------------------------------ inflate

constexpr int kFastBits = 9;

struct Huffman {
  // canonical code: count of codes per length, symbols in code order
  int count[16];
  std::vector<int> symbol;
  bool empty;
  int max;
  // the codes of at most kFastBits bits by their next kFastBits input bits
  // (LSB first): (length << 16) | symbol, 0 for a longer or missing code
  uint32_t fast[1 << kFastBits];
};

// zlib's inflate_table checks: an over-subscribed set fails; an incomplete
// one fails unless its longest code has one bit and it is not the
// code-lengths code (then the missing code is an invalid one). An empty set
// builds, and decode() says what a code read from it gives.
bool build(Huffman& h, const int* lengths, int n, bool code_lengths_code) {
  std::memset(h.count, 0, sizeof(h.count));
  for (int i = 0; i < n; ++i) h.count[lengths[i]]++;
  int max = 15;
  while (max >= 1 && h.count[max] == 0) --max;
  h.empty = max == 0;
  h.max = max;
  h.symbol.assign(n, 0);
  if (h.empty) return true;
  int left = 1;
  for (int len = 1; len <= 15; ++len) {
    left <<= 1;
    left -= h.count[len];
    if (left < 0) return false;
  }
  if (left > 0 && (code_lengths_code || max != 1)) return false;
  int offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + h.count[len];
  for (int i = 0; i < n; ++i)
    if (lengths[i]) h.symbol[offs[lengths[i]]++] = i;
  std::memset(h.fast, 0, sizeof(h.fast));
  int code = 0, index = 0;
  for (int len = 1; len <= kFastBits; ++len) {
    for (int i = 0; i < h.count[len]; ++i, ++code, ++index) {
      int rev = 0;  // the code's bits in input order
      for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (int fill = rev; fill < (1 << kFastBits); fill += 1 << len)
        h.fast[fill] = (static_cast<uint32_t>(len) << 16) | static_cast<uint32_t>(h.symbol[index]);
    }
    code <<= 1;
  }
  return true;
}

struct Inflater {
  const uint8_t* src;
  int64_t n;
  int64_t pos = 0;  // next byte
  uint32_t hold = 0;
  int bits = 0;

  // Needs k bits; false where the input has run out.
  bool need(int k) {
    while (bits < k) {
      if (pos >= n) return false;
      hold |= static_cast<uint32_t>(src[pos++]) << bits;
      bits += 8;
    }
    return true;
  }
  uint32_t take(int k) {
    const uint32_t v = hold & ((1u << k) - 1);
    hold >>= k;
    bits -= k;
    return v;
  }
  // -1: the input ran out, -2: an invalid code. As zlib's tables decode
  // it: an empty set reads one bit and is invalid (for the code-lengths
  // code, whose entries zlib does not check, it reads one bit as length 0);
  // the missing code of an incomplete one-bit set is invalid.
  int decode(const Huffman& h, bool code_lengths_code = false) {
    if (h.empty) {
      if (!need(1)) return -1;
      take(1);
      return code_lengths_code ? 0 : -2;
    }
    while (bits < kFastBits && pos < n) {
      hold |= static_cast<uint32_t>(src[pos++]) << bits;
      bits += 8;
    }
    const uint32_t hit = h.fast[hold & ((1u << kFastBits) - 1)];
    if (hit != 0 && static_cast<int>(hit >> 16) <= bits) {
      take(static_cast<int>(hit >> 16));
      return static_cast<int>(hit & 0xFFFF);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= h.max; ++len) {
      if (!need(len)) return -1;
      code |= (hold >> (len - 1)) & 1;
      const int count = h.count[len];
      if (code - count < first) {
        const int sym = h.symbol[index + (code - first)];
        take(len);
        return sym;
      }
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    return -2;
  }
};

const int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                          31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const int kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const int kDistBase[30] = {1,   2,   3,   4,   5,   7,    9,    13,   17,   25,   33,   49,   65,    97,    129,
                           193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
const int kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// zlib's Adler-32, the sums reduced every 5552 bytes as zlib reduces them
uint32_t adler32(const uint8_t* p, int64_t len) {
  uint32_t a = 1, b = 0;
  while (len > 0) {
    const int64_t block = len < 5552 ? len : 5552;
    for (int64_t i = 0; i < block; ++i) {
      a += p[i];
      b += a;
    }
    a %= 65521;
    b %= 65521;
    p += block;
    len -= block;
  }
  return (b << 16) | a;
}

int inflate_strip(const uint8_t* src, int64_t n, uint8_t* out, int64_t occ) {
  Inflater z{src, n};
  int64_t written = 0;
  auto emit = [&](uint8_t v) { out[written++] = v; };
  // zlib returns for more input where the stream breaks off; libtiff then
  // succeeds if the strip is full and fails otherwise. Errors fail.
  const int short_input = -1, error = 0;
  auto result = [&](int r) { return r == short_input ? (written == occ ? 1 : 0) : r; };
  auto run = [&]() -> int {
    if (!z.need(16)) return short_input;
    const uint32_t cmf = z.hold & 0xFF, flg = (z.hold >> 8) & 0xFF;
    if (((cmf << 8) + flg) % 31 != 0) return error;  // incorrect header check
    if ((cmf & 15) != 8) return error;               // unknown compression method
    if ((cmf >> 4) + 8 > 15) return error;           // invalid window size
    z.take(16);
    if (flg & 0x20) return error;                    // a preset dictionary (Z_NEED_DICT)
    bool last = false;
    Huffman lens, dists;
    while (!last) {
      if (!z.need(3)) return short_input;
      last = z.take(1);
      const int type = static_cast<int>(z.take(2));
      if (type == 0) {
        z.take(z.bits & 7);
        if (!z.need(32)) return short_input;
        const uint32_t len = z.hold & 0xFFFF, nlen = (z.hold >> 16) & 0xFFFF;
        if (len != (nlen ^ 0xFFFF)) return error;  // invalid stored block lengths
        z.hold = 0;
        z.bits = 0;
        for (uint32_t i = 0; i < len; ++i) {
          if (written == occ) return 1;  // the strip is full
          if (z.pos >= n) return short_input;
          emit(src[z.pos++]);
        }
        continue;
      }
      if (type == 3) return error;  // invalid block type
      if (type == 1) {
        int fixed[288];
        for (int i = 0; i < 288; ++i) fixed[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
        build(lens, fixed, 288, false);
        // zlib's fixed distance table has 32 five-bit codes, 30 and 31 invalid
        const int d32[32] = {5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5,
                             5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5};
        build(dists, d32, 32, false);
      } else {
        if (!z.need(14)) return short_input;
        const int nlen = static_cast<int>(z.take(5)) + 257;
        const int ndist = static_cast<int>(z.take(5)) + 1;
        const int ncode = static_cast<int>(z.take(4)) + 4;
        if (nlen > 286 || ndist > 30) return error;  // too many length or distance symbols
        static const int order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
        int cl[19] = {0};
        for (int i = 0; i < ncode; ++i) {
          if (!z.need(3)) return short_input;
          cl[order[i]] = static_cast<int>(z.take(3));
        }
        Huffman codes;
        if (!build(codes, cl, 19, true)) return error;  // invalid code lengths set
        std::vector<int> lengths(nlen + ndist, 0);
        int have = 0;
        while (have < nlen + ndist) {
          const int sym = z.decode(codes, true);
          if (sym == -1) return short_input;
          if (sym < 16) {
            lengths[have++] = sym;
            continue;
          }
          int len = 0, copy;
          if (sym == 16) {
            if (have == 0) return error;  // invalid bit length repeat
            if (!z.need(2)) return short_input;
            len = lengths[have - 1];
            copy = 3 + static_cast<int>(z.take(2));
          } else if (sym == 17) {
            if (!z.need(3)) return short_input;
            copy = 3 + static_cast<int>(z.take(3));
          } else {
            if (!z.need(7)) return short_input;
            copy = 11 + static_cast<int>(z.take(7));
          }
          if (have + copy > nlen + ndist) return error;  // invalid bit length repeat
          while (copy--) lengths[have++] = len;
        }
        if (lengths[256] == 0) return error;  // invalid code -- missing end-of-block
        if (!build(lens, lengths.data(), nlen, false)) return error;
        if (!build(dists, lengths.data() + nlen, ndist, false)) return error;
      }
      for (;;) {
        const int sym = z.decode(lens);
        if (sym == -1) return short_input;
        if (sym == -2 || sym > 285) return error;  // invalid literal/length code
        if (sym < 256) {
          if (written == occ) return 1;
          emit(static_cast<uint8_t>(sym));
          continue;
        }
        if (sym == 256) break;
        const int li = sym - 257;
        if (!z.need(kLenExtra[li])) return short_input;
        const int len = kLenBase[li] + static_cast<int>(z.take(kLenExtra[li]));
        const int ds = z.decode(dists);
        if (ds == -1) return short_input;
        if (ds == -2 || ds > 29) return error;  // invalid distance code
        if (!z.need(kDistExtra[ds])) return short_input;
        const int dist = kDistBase[ds] + static_cast<int>(z.take(kDistExtra[ds]));
        if (written == occ) return 1;
        if (dist > written) return error;  // invalid distance too far back
        for (int i = 0; i < len; ++i) {
          if (written == occ) return 1;
          emit(out[written - dist]);
        }
      }
    }
    // the Adler-32 trailer, from the next byte boundary
    z.take(z.bits & 7);
    if (!z.need(32)) return short_input;
    const uint32_t b = z.hold;
    const uint32_t check = ((b & 0xFF) << 24) | ((b & 0xFF00) << 8) | ((b >> 8) & 0xFF00) | (b >> 24);
    if (check != adler32(out, written)) return error;  // incorrect data check
    return written == occ ? 1 : 0;  // the stream ends: the strip must be full
  };
  return result(run());
}

// ------------------------------------------------------------------ PackBits

int packbits(const uint8_t* src, int64_t cc, uint8_t* op, int64_t occ) {
  const int8_t* bp = reinterpret_cast<const int8_t*>(src);
  while (cc > 0 && occ > 0) {
    int64_t n = *bp++;
    --cc;
    if (n < 0) {
      if (n == -128) continue;
      n = -n + 1;
      if (occ < n) n = occ;
      if (cc == 0) break;
      occ -= n;
      const uint8_t b = static_cast<uint8_t>(*bp++);
      --cc;
      std::memset(op, b, static_cast<size_t>(n));
      op += n;
    } else {
      if (occ < n + 1) n = occ - 1;
      if (cc < n + 1) break;
      ++n;
      std::memcpy(op, bp, static_cast<size_t>(n));
      op += n;
      occ -= n;
      bp += n;
      cc -= n;
    }
  }
  if (occ > 0) {
    std::memset(op, 0, static_cast<size_t>(occ));
    return 0;
  }
  return 1;
}

}  // namespace

// One strip or tile of `n` bytes -> `occ` bytes of samples in `out` (zeroed
// by the caller). Each returns 1 where libtiff's decoder succeeds, else 0.
extern "C" int frn_tiff_lzw(const uint8_t* src, int64_t n, int compat, uint8_t* out, int64_t occ) {
  return compat ? lzw_compat(src, n, out, occ) : lzw_new(src, n, out, occ);
}

extern "C" int frn_tiff_inflate(const uint8_t* src, int64_t n, uint8_t* out, int64_t occ) {
  return inflate_strip(src, n, out, occ);
}

extern "C" int frn_tiff_packbits(const uint8_t* src, int64_t n, uint8_t* out, int64_t occ) {
  return packbits(src, n, out, occ);
}

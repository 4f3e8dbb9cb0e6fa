// JPEG decoder for the port's image reader (frn_tpu_torch/data/image_io.py).
//
// The JAX package reads every image through cv2.imread, whose JPEG codec is
// libjpeg-turbo at its defaults. This decoder gives the same pixels, bit for
// bit, without OpenCV:
//  - Huffman-coded frames: baseline and extended sequential (SOF0, SOF1) and
//    progressive (SOF2: spectral selection, successive approximation, EOB
//    runs), restart intervals, 8-bit samples, 1, 3 or 4 components; a scan
//    whose table was never defined takes the standard table of its slot, as
//    libjpeg-turbo does for Motion-JPEG frames;
//  - the integer inverse DCT (libjpeg's jidctint.c, JDCT_ISLOW) with its
//    level shift; its outputs saturate to 0..255, as libjpeg-turbo's SIMD
//    IDCT does;
//  - fancy upsampling (jdsample.c): triangular h2v1, h1v2 and h2v2 filters,
//    each edge sample repeated; h2v1 and h2v2 fall back to replication where
//    a component is at most 2 samples wide, and every other integral factor
//    replicates;
//  - colour conversion (jdcolor.c): fixed-point YCbCr -> RGB with 16-bit
//    tables, Y alone for gray output, RGB -> gray for an RGB-coded file,
//    YCCK -> CMYK; CMYK -> BGR and CMYK -> gray as OpenCV converts them;
//  - the colour space as libjpeg guesses it: JFIF APP0, then Adobe APP14's
//    transform, then the component ids.
// The EXIF orientation of the first APP1 segment is reported, not applied
// (the caller turns the image as OpenCV does). Arithmetic coding, lossless
// and hierarchical frames, precisions other than 8 bits, and a file whose
// entropy-coded data ends early or breaks its restart markers are refused
// with a message naming the kind. A progressive file whose scans leave any of
// the first ten coefficients incomplete is refused too (libjpeg would smooth
// its blocks).
//
// Plain C ABI, bound by ctypes; built by frn_tpu_torch/utils/native.py.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <new>
#include <string>
#include <vector>

namespace {

enum { kOk = 0, kUnsupported = 1, kCorrupt = 2 };

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw Error{code, msg}; }

// zigzag index -> natural index, with 16 extra entries so that a corrupt run
// past the end of a block stays inside it (as jpeg_natural_order does)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// the standard tables of ITU T.81 K.3 (luminance 0, chrominance 1)
const uint8_t kStdDcBits[2][17] = {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                   {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcBits[2][17] = {{0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                                   {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
     0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
     0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
     0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
     0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
     0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
     0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
     0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
     0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
     0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
     0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
     0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
     0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
     0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoff[18] = {};
  uint16_t look[1 << kLookBits] = {};  // (code length << 8) | symbol; 0: longer code

  void set(const uint8_t* bits, const uint8_t* v) {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    std::memcpy(vals, v, count);
    // canonical codes (jdhuff.c jpeg_make_d_derived_tbl)
    int huffcode[257];
    int code = 0, p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i) huffcode[p++] = code++;
      if (code > (1 << l)) fail(kCorrupt, "corrupt JPEG: bad Huffman table");
      code <<= 1;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoff[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        const int lookbits = huffcode[p] << (kLookBits - l);
        for (int c = 0; c < (1 << (kLookBits - l)); ++c) {
          look[lookbits + c] = static_cast<uint16_t>((l << 8) | vals[p]);
        }
      }
    }
    defined = true;
  }
};

// Entropy-coded data: stuffed FF 00 bytes become FF; at a marker (or the end
// of the file) zero bits are fed in, and a decode that consumes any of them
// is an error (libjpeg warns and decodes zeros; this decoder refuses).
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;   // bits in buf, from the top
  int fake = 0;  // of which zero bits fed in after the data ended
  bool ended = false;

  BitReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void fill() {
    if (!ended && pos + 8 <= n) {  // the next 8 bytes hold no FF: take the whole bytes that fit
      uint64_t w;
      std::memcpy(&w, d + pos, 8);
      const uint64_t v = ~w;
      if (((v - 0x0101010101010101ull) & ~v & 0x8080808080808080ull) == 0) {
        const int nbytes = (64 - cnt) >> 3;
        const uint64_t be = __builtin_bswap64(w) >> cnt;
        const int used = cnt + 8 * nbytes;
        buf |= used == 64 ? be : be & ~((1ull << (64 - used)) - 1);
        cnt = used;
        pos += nbytes;
        return;
      }
    }
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!ended) {
        if (pos >= n) {
          ended = true;
        } else if (d[pos] != 0xFF) {
          b = d[pos++];
        } else {
          size_t p = pos + 1;
          while (p < n && d[p] == 0xFF) ++p;  // fill bytes
          if (p < n && d[p] == 0) {
            b = 0xFF;
            pos = p + 1;
          } else {
            ended = true;  // a marker: pos stays on its first FF
          }
        }
      }
      if (ended) fake += 8;
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t get(int k) {  // k in 1..16
    if (cnt < k) fill();
    return take(k);
  }
  uint32_t take(int k) {  // k in 1..16 bits that are in buf
    const uint32_t v = static_cast<uint32_t>(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  int decode(const Huffman& h) {
    if (cnt < 16) fill();
    return decode_filled(h);
  }
  int decode_filled(const Huffman& h) {  // 16 bits are in buf
    const uint16_t e = h.look[buf >> (64 - kLookBits)];
    if (e) {
      const int l = e >> 8;
      buf <<= l;
      cnt -= l;
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = static_cast<int32_t>(buf >> (64 - l));
    while (code > h.maxcode[l]) {
      ++l;
      if (l > 16) fail(kCorrupt, "corrupt JPEG: bad Huffman code");
      code = static_cast<int32_t>(buf >> (64 - l));
    }
    buf <<= l;
    cnt -= l;
    return h.vals[(h.valoff[l] + code) & 0xFF];
  }
  void check() const {
    if (cnt < fake) {
      fail(kCorrupt, "truncated or corrupt JPEG: the entropy-coded data ends before its last block");
    }
  }
  // drop the buffered bits; pos is where the next marker search starts
  void reset() {
    buf = 0;
    cnt = 0;
    fake = 0;
    ended = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // blocks held (whole MCUs)
  int dw = 0, dh = 0;  // samples of the component (downsampled_width, _height)
  std::vector<int16_t> coef;
  int16_t q[64] = {};  // latched at the component's first scan, natural order
  bool latched = false;
  int coef_bits[64];
  int dc_pred = 0, td = 0, ta = 0;
};

struct Decoder {
  const uint8_t* d;
  size_t n, pos = 0;
  uint16_t qt[4][64] = {};
  bool qdef[4] = {};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool frame = false, progressive = false, jfif = false, adobe = false, app1 = false;
  bool sos_seen = false;  // libjpeg settles the colour space at the first SOS
  int adobe_transform = 0, orientation = 1;
  int width = 0, height = 0;
  std::vector<Component> comps;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int eobrun = 0;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) fail(kCorrupt, "truncated JPEG: the file ends inside a marker segment");
    return d[pos++];
  }
  int u16() {
    const int hi = u8();
    return (hi << 8) | u8();
  }

  // libjpeg's next_marker: skip anything up to FF, then fill FFs
  int next_marker() {
    while (true) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) fail(kCorrupt, "truncated JPEG: no EOI marker");
      const int m = d[pos++];
      if (m != 0) return m;
    }
  }

  void parse_exif(const uint8_t* p, size_t len) {
    // OpenCV's ExifReader: the TIFF header 6 bytes into the first APP1, IFD0's
    // Orientation (0x0112) as an unsigned short; anything out of bounds: none
    if (len < 6 + 8) return;
    p += 6;
    len -= 6;
    bool le;
    if (p[0] == 'I' && p[1] == 'I') {
      le = true;
    } else if (p[0] == 'M' && p[1] == 'M') {
      le = false;
    } else {
      return;
    }
    auto g16 = [&](size_t o) -> int {
      return le ? (p[o] | (p[o + 1] << 8)) : ((p[o] << 8) | p[o + 1]);
    };
    auto g32 = [&](size_t o) -> uint32_t {
      return le ? (p[o] | (p[o + 1] << 8) | (p[o + 2] << 16) | (static_cast<uint32_t>(p[o + 3]) << 24))
                : ((static_cast<uint32_t>(p[o]) << 24) | (p[o + 1] << 16) | (p[o + 2] << 8) | p[o + 3]);
    };
    if (g16(2) != 0x2A) return;
    const size_t ifd = g32(4);
    if (ifd + 2 > len) return;
    const int entries = g16(ifd);
    int found = 1;
    for (int i = 0; i < entries; ++i) {
      const size_t e = ifd + 2 + 12 * static_cast<size_t>(i);
      if (e + 12 > len) return;
      if (g16(e) == 0x0112) found = g16(e + 8);
    }
    orientation = found;
  }

  void read_app(int marker) {
    const int len = u16();
    if (len < 2 || pos + len - 2 > n) fail(kCorrupt, "truncated JPEG: a marker segment runs past the end");
    const uint8_t* p = d + pos;
    const size_t dl = len - 2;
    if (!sos_seen && marker == 0xE0 && dl >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
    if (!sos_seen && marker == 0xEE && dl >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    if (marker == 0xE1 && !app1 && !sos_seen) {
      app1 = true;
      parse_exif(p, dl);
    }
    pos += dl;
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      const int pq = u8();
      const int prec = pq >> 4, t = pq & 15;
      if (t >= 4) fail(kCorrupt, "corrupt JPEG: quantization table index out of range");
      for (int i = 0; i < 64; ++i) qt[t][kNatural[i]] = static_cast<uint16_t>(prec ? u16() : u8());
      qdef[t] = true;
      len -= 1 + 64 * (prec ? 2 : 1);
    }
    if (len != 0) fail(kCorrupt, "corrupt JPEG: bad DQT length");
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 16) {
      int index = u8();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = static_cast<uint8_t>(u8());
        count += bits[l];
      }
      len -= 17;
      if (count > 256 || count > len) fail(kCorrupt, "corrupt JPEG: bad Huffman table");
      uint8_t vals[256] = {0};
      for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(u8());
      len -= count;
      const bool is_ac = index & 0x10;
      index &= ~0x10;
      if (index < 0 || index >= 4) fail(kCorrupt, "corrupt JPEG: Huffman table index out of range");
      (is_ac ? ac[index] : dc[index]).set(bits, vals);
    }
    if (len != 0) fail(kCorrupt, "corrupt JPEG: bad DHT length");
  }

  void read_sof(int marker) {
    if (frame) fail(kCorrupt, "corrupt JPEG: more than one frame header");
    const int len = u16();
    const int precision = u8();
    height = u16();
    width = u16();
    const int nc = u8();
    if (len != 8 + 3 * nc) fail(kCorrupt, "corrupt JPEG: bad SOF length");
    if (precision != 8) {
      fail(kUnsupported, std::to_string(precision) + "-bit JPEG (only 8-bit samples are read)");
    }
    if (height == 0) fail(kUnsupported, "JPEG with a DNL-defined height (DNL is not supported)");
    if (width == 0 || nc == 0) fail(kCorrupt, "corrupt JPEG: empty image");
    if (static_cast<int64_t>(width) * height > (int64_t{1} << 30)) {  // cv2's CV_IO_MAX_IMAGE_PIXELS
      fail(kUnsupported, "JPEG of " + std::to_string(width) + "x" + std::to_string(height) +
                             " pixels (more than 2^30, which cv2.imread refuses too)");
    }
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail(kCorrupt, "corrupt JPEG: bad sampling factors");
      if (c.tq >= 4) fail(kCorrupt, "corrupt JPEG: quantization table index out of range");
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    progressive = marker == 0xC2;
    for (const auto& c : comps) {
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
    }
    frame = true;
  }

  static const char* sof_kind(int m) {
    switch (m) {
      case 0xC3: return "lossless JPEG (SOF3)";
      case 0xC5: return "hierarchical JPEG (SOF5, differential sequential)";
      case 0xC6: return "hierarchical JPEG (SOF6, differential progressive)";
      case 0xC7: return "hierarchical lossless JPEG (SOF7)";
      case 0xC9: return "arithmetic-coded JPEG (SOF9)";
      case 0xCA: return "arithmetic-coded progressive JPEG (SOF10)";
      case 0xCB: return "arithmetic-coded lossless JPEG (SOF11)";
      case 0xCD: return "arithmetic-coded hierarchical JPEG (SOF13)";
      case 0xCE: return "arithmetic-coded hierarchical JPEG (SOF14)";
      case 0xCF: return "arithmetic-coded hierarchical lossless JPEG (SOF15)";
      default: return nullptr;
    }
  }

  // Reads markers up to the first SOS (header_only) or to EOI, decoding every
  // scan on the way. Returns with pos after the SOS marker when header_only.
  void run(bool header_only) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail(kCorrupt, "not a JPEG file (no SOI marker)");
    pos = 2;
    while (true) {
      const int m = next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m);
      } else if (const char* kind = sof_kind(m)) {
        fail(kUnsupported, std::string(kind) + " is not read (Huffman-coded 8-bit baseline, "
                                               "extended and progressive JPEGs are)");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        if (u16() != 4) fail(kCorrupt, "corrupt JPEG: bad DRI length");
        restart_interval = u16();
      } else if (m == 0xDA) {
        if (!frame) fail(kCorrupt, "corrupt JPEG: a scan before the frame header");
        if (header_only) return;
        sos_seen = true;
        scan();
      } else if (m == 0xD9) {
        if (!frame) fail(kCorrupt, "corrupt JPEG: no frame header");
        if (header_only) fail(kCorrupt, "corrupt JPEG: no scan");
        return;
      } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xCC || m == 0xDC) {
        if (m == 0xFE || m == 0xCC || m == 0xDC) {  // COM, DAC, DNL: skipped
          const int len = u16();
          if (len < 2) fail(kCorrupt, "corrupt JPEG: bad marker length");
          pos += len - 2;
        } else {
          read_app(m);
        }
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // a stray RSTn or TEM: no parameters
      } else if (m == 0xDE || m == 0xDF) {
        fail(kUnsupported, "hierarchical JPEG (DHP/EXP markers) is not read");
      } else if (m == 0xD8) {
        fail(kCorrupt, "corrupt JPEG: a second SOI marker");
      } else {
        char buf[64];
        std::snprintf(buf, sizeof(buf), "corrupt JPEG: unknown marker 0x%02X", m);
        fail(kCorrupt, buf);
      }
      if (pos > n) fail(kCorrupt, "truncated JPEG: a marker segment runs past the end");
    }
  }

  const Huffman& table(bool is_ac, int index) {
    Huffman& h = is_ac ? ac[index] : dc[index];
    if (!h.defined) {
      if (index > 1) fail(kCorrupt, "corrupt JPEG: a scan uses an undefined Huffman table");
      if (is_ac) {
        h.set(kStdAcBits[index], kStdAcVals[index]);
      } else {
        h.set(kStdDcBits[index], kStdDcVals);
      }
    }
    return h;
  }

  void scan() {
    const int len = u16();
    const int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail(kCorrupt, "corrupt JPEG: bad SOS header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int cid = u8(), t = u8();
      Component* c = nullptr;
      for (auto& x : comps) {
        if (x.id == cid) c = &x;
      }
      if (c == nullptr) fail(kCorrupt, "corrupt JPEG: a scan names an unknown component");
      for (auto* o : sc) {
        if (o == c) fail(kCorrupt, "corrupt JPEG: a component twice in one scan");
      }
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td >= 4 || c->ta >= 4) fail(kCorrupt, "corrupt JPEG: Huffman table index out of range");
      sc.push_back(c);
    }
    const int ss = u8(), se = u8(), a = u8();
    const int ah = a >> 4, al = a & 15;
    if (progressive) {
      bool bad = false;
      if (ss == 0) {
        bad = se != 0;
      } else {
        bad = ss > se || se >= 64 || ns != 1;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail(kCorrupt, "corrupt JPEG: bad progression parameters");
      for (auto* c : sc) {
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      }
    }  // a sequential scan's Ss, Se, Ah and Al are ignored, as libjpeg ignores them
    int blocks_in_mcu = 0;
    for (auto* c : sc) {
      blocks_in_mcu += ns == 1 ? 1 : c->h * c->v;
      if (!c->latched) {
        if (!qdef[c->tq]) fail(kCorrupt, "corrupt JPEG: a component's quantization table is undefined");
        for (int k = 0; k < 64; ++k) c->q[k] = static_cast<int16_t>(qt[c->tq][k]);
        c->latched = true;
      }
      c->dc_pred = 0;
      if (!progressive || ss == 0) {
        if (!progressive || ah == 0) table(false, c->td);
      }
      if (!progressive || ss != 0) table(true, c->ta);
    }
    if (blocks_in_mcu > 10) fail(kCorrupt, "corrupt JPEG: too many blocks in an MCU");

    // the MCUs of the scan: a single component goes block by block over its
    // own samples' blocks, several go MCU by MCU
    int mx, my;
    if (ns == 1) {
      mx = (sc[0]->dw + 7) / 8;
      my = (sc[0]->dh + 7) / 8;
    } else {
      mx = mcux;
      my = mcuy;
    }
    const int64_t total = static_cast<int64_t>(mx) * my;
    // a scan that codes DC spends at least one bit a block: refuse a file too
    // short for it before its coefficients are allocated
    if ((!progressive || ss == 0) && static_cast<int64_t>(n - pos) * 8 < total * blocks_in_mcu) {
      fail(kCorrupt, "truncated or corrupt JPEG: the file is too short for the blocks of a scan");
    }
    for (auto* c : sc) {
      // zeros until a scan codes them, as libjpeg's pre-zeroed coefficient buffers
      if (c->coef.empty()) c->coef.assign(coef_size(*c), 0);
    }
    BitReader br(d, n, pos);
    eobrun = 0;
    int restarts_left = restart_interval;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && restarts_left == 0) {
        // libjpeg's process_restart: the next marker must be RSTn
        pos = br.pos;
        while (pos < n && d[pos] != 0xFF) ++pos;
        while (pos < n && d[pos] == 0xFF) ++pos;
        if (pos >= n) fail(kCorrupt, "truncated JPEG: the file ends before a restart marker");
        if (d[pos] != 0xD0 + next_rst) fail(kCorrupt, "corrupt JPEG: missing or out-of-order restart marker");
        ++pos;
        next_rst = (next_rst + 1) & 7;
        br = BitReader(d, n, pos);
        for (auto* c : sc) c->dc_pred = 0;
        eobrun = 0;
        restarts_left = restart_interval;
      }
      const int row = static_cast<int>(m / mx), col = static_cast<int>(m % mx);
      for (auto* c : sc) {
        if (ns == 1) {
          decode_block(br, *c, block(*c, col, row), ss, se, ah, al);
        } else {
          for (int by = 0; by < c->v; ++by) {
            for (int bx = 0; bx < c->h; ++bx) {
              decode_block(br, *c, block(*c, col * c->h + bx, row * c->v + by), ss, se, ah, al);
            }
          }
        }
      }
      br.check();
      if (restart_interval) --restarts_left;
    }
    pos = br.pos;  // the next marker search starts here
  }

  static size_t coef_size(const Component& c) { return static_cast<size_t>(c.bw) * c.bh * 64; }

  static int16_t* block(Component& c, int bx, int by) {
    return &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64];
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk, int ss, int se, int ah, int al) {
    if (!progressive) {
      const Huffman& hd = dc[c.td];
      const Huffman& ha = ac[c.ta];
      int s = br.decode(hd);
      if (s) {
        if (s > 16) fail(kCorrupt, "corrupt JPEG: bad DC magnitude");
        const int r = static_cast<int>(br.get(s));
        s = extend(r, s);
      }
      c.dc_pred += s;
      blk[0] = static_cast<int16_t>(c.dc_pred);
      for (int k = 1; k < 64; ++k) {
        if (br.cnt < 31) br.fill();  // a code (16 bits at most) and its value (15)
        const int rs = br.decode_filled(ha);
        const int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          const int v = static_cast<int>(br.take(s));
          blk[kNatural[k]] = static_cast<int16_t>(extend(v, s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (ah == 0) {
        int s = br.decode(dc[c.td]);
        if (s) {
          if (s > 16) fail(kCorrupt, "corrupt JPEG: bad DC magnitude");
          s = extend(static_cast<int>(br.get(s)), s);
        }
        c.dc_pred += s;
        blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
      } else if (br.get(1)) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
      return;
    }
    const Huffman& ha = ac[c.ta];
    if (ah == 0) {  // AC first pass
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        const int rs = br.decode(ha);
        int r = rs >> 4;
        const int s = rs & 15;
        if (s) {
          k += r;
          const int v = extend(static_cast<int>(br.get(s)), s);
          blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += static_cast<int>(br.get(r));
          --eobrun;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(ha);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // a size other than 1 is corrupt; libjpeg reads on
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += static_cast<int>(br.get(r));
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1)) {
              if ((*coef & p1) == 0) *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (br.get(1)) {
            if ((*coef & p1) == 0) *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
          }
        }
      }
      --eobrun;
    }
  }
};

// ------------------------------------------------------------ inverse DCT

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline uint8_t clamp_sample(int32_t v) {  // v + 128 saturated
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One 1-D pass of jidctint.c's jpeg_idct_islow over 8 vectors at once: x[k]
// holds input k of 8 independent transforms (lane j of each array is
// transform j), y[r] gets their output r descaled by `shift`. libjpeg skips
// the work for an input whose AC terms are all zero; the full computation
// gives the same values there, so there is no branch and the compiler can
// vectorize over the lanes.
inline void idct_pass(const int32_t (&x)[8][8], int32_t (&y)[8][8], int shift) {
  const int32_t half = 1 << (shift - 1);
  for (int j = 0; j < 8; ++j) {
    const int32_t z2e = x[2][j], z3e = x[6][j];
    const int32_t z1e = (z2e + z3e) * F0541;
    const int32_t t2 = z1e + z3e * (-F1847), t3 = z1e + z2e * F0765;
    const int32_t t0 = static_cast<int32_t>(static_cast<uint32_t>(x[0][j] + x[4][j]) << kConstBits);
    const int32_t t1 = static_cast<int32_t>(static_cast<uint32_t>(x[0][j] - x[4][j]) << kConstBits);
    const int32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    int32_t o0 = x[7][j], o1 = x[5][j], o2 = x[3][j], o3 = x[1][j];
    int32_t z1 = o0 + o3, z2 = o1 + o2, z3 = o0 + o2, z4 = o1 + o3;
    const int32_t z5 = (z3 + z4) * F1175;
    o0 *= F0298;
    o1 *= F2053;
    o2 *= F3072;
    o3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 = z3 * (-F1961) + z5;
    z4 = z4 * (-F0390) + z5;
    o0 += z1 + z3;
    o1 += z2 + z4;
    o2 += z2 + z3;
    o3 += z1 + z4;
    y[0][j] = (t10 + o3 + half) >> shift;
    y[7][j] = (t10 - o3 + half) >> shift;
    y[1][j] = (t11 + o2 + half) >> shift;
    y[6][j] = (t11 - o2 + half) >> shift;
    y[2][j] = (t12 + o1 + half) >> shift;
    y[5][j] = (t12 - o1 + half) >> shift;
    y[3][j] = (t13 + o0 + half) >> shift;
    y[4][j] = (t13 - o0 + half) >> shift;
  }
}

// jidctint.c jpeg_idct_islow: one 8x8 block into out (stride samples a
// row). Pass 1 runs the 8 columns as lanes, pass 2 the 8 rows (the
// workspace transposed between them); the outputs are level-shifted and
// saturated to 0..255.
void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride) {
  int32_t x[8][8], ws[8][8], wt[8][8], y[8][8];
  for (int k = 0; k < 8; ++k) {
    for (int j = 0; j < 8; ++j) x[k][j] = in[8 * k + j] * q[8 * k + j];  // x[row k][column j]
  }
  idct_pass(x, ws, kConstBits - kPass1Bits);  // ws[row r][column j]
  for (int r = 0; r < 8; ++r) {
    for (int c = 0; c < 8; ++c) wt[c][r] = ws[r][c];  // wt[input c][row r]
  }
  idct_pass(wt, y, kConstBits + kPass1Bits + 3);  // y[column k][row r]
  for (int r = 0; r < 8; ++r) {
    for (int k = 0; k < 8; ++k) out[r * stride + k] = clamp_sample(y[k][r]);
  }
}

// ------------------------------------------------------------ upsampling

// One component's samples (dw x dh, row stride `stride`) expanded to the
// frame's sampling, then cropped to width x height. The fancy filters' first
// and last columns repeat the edge sample, as jdsample.c's special cases do;
// 2 dw is width or width + 1, so only the last column can fall outside.
std::vector<uint8_t> upsample(const Component& c, const uint8_t* p, size_t stride, int hmax,
                              int vmax, int width, int height) {
  if (hmax % c.h || vmax % c.v) {
    fail(kUnsupported, "JPEG with fractional sampling ratios (not supported by libjpeg either)");
  }
  const int fx = hmax / c.h, fy = vmax / c.v;
  const int dw = c.dw, dh = c.dh;
  std::vector<uint8_t> out(static_cast<size_t>(width) * height);
  auto row = [&](int y) { return p + static_cast<size_t>(y < 0 ? 0 : (y >= dh ? dh - 1 : y)) * stride; };
  // restrict on the rows below: a uint8_t store may alias anything
  if (fx == 1 && fy == 1) {
    for (int y = 0; y < height; ++y) std::memcpy(&out[static_cast<size_t>(y) * width], row(y), width);
  } else if (fx == 2 && fy == 1 && dw > 2) {  // h2v1 fancy
    for (int y = 0; y < height; ++y) {
      const uint8_t* __restrict r = row(y);
      uint8_t* __restrict o = &out[static_cast<size_t>(y) * width];
      o[0] = r[0];
      o[1] = static_cast<uint8_t>((3 * r[0] + r[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        const int v3 = 3 * r[x];
        o[2 * x] = static_cast<uint8_t>((v3 + r[x - 1] + 1) >> 2);
        o[2 * x + 1] = static_cast<uint8_t>((v3 + r[x + 1] + 2) >> 2);
      }
      const int x = dw - 1;
      o[2 * x] = static_cast<uint8_t>((3 * r[x] + r[x - 1] + 1) >> 2);
      if (2 * x + 1 < width) o[2 * x + 1] = r[x];
    }
  } else if (fx == 1 && fy == 2) {  // h1v2 fancy
    for (int y = 0; y < height; ++y) {
      const int iy = y >> 1, bias = (y & 1) ? 2 : 1;
      const uint8_t *__restrict r0 = row(iy), *__restrict r1 = row((y & 1) ? iy + 1 : iy - 1);
      uint8_t* __restrict o = &out[static_cast<size_t>(y) * width];
      for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>((3 * r0[x] + r1[x] + bias) >> 2);
    }
  } else if (fx == 2 && fy == 2 && dw > 2) {  // h2v2 fancy
    std::vector<int> cs(dw);
    for (int y = 0; y < height; ++y) {
      const int iy = y >> 1;
      const uint8_t *__restrict r0 = row(iy), *__restrict r1 = row((y & 1) ? iy + 1 : iy - 1);
      int* __restrict c = cs.data();
      for (int x = 0; x < dw; ++x) c[x] = 3 * r0[x] + r1[x];
      uint8_t* __restrict o = &out[static_cast<size_t>(y) * width];
      o[0] = static_cast<uint8_t>((4 * cs[0] + 8) >> 4);
      o[1] = static_cast<uint8_t>((3 * cs[0] + cs[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; ++x) {
        const int t3 = 3 * cs[x];
        o[2 * x] = static_cast<uint8_t>((t3 + cs[x - 1] + 8) >> 4);
        o[2 * x + 1] = static_cast<uint8_t>((t3 + cs[x + 1] + 7) >> 4);
      }
      const int x = dw - 1;
      o[2 * x] = static_cast<uint8_t>((3 * cs[x] + cs[x - 1] + 8) >> 4);
      if (2 * x + 1 < width) o[2 * x + 1] = static_cast<uint8_t>((4 * cs[x] + 7) >> 4);
    }
  } else {  // replication (jdsample.c h2v1_upsample, h2v2_upsample, int_upsample)
    for (int y = 0; y < height; ++y) {
      uint8_t* o = &out[static_cast<size_t>(y) * width];
      const uint8_t* r = p + static_cast<size_t>(y / fy) * stride;
      for (int x = 0; x < width; ++x) o[x] = r[x / fx];
    }
  }
  return out;
}

// ------------------------------------------------------------ colour

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = 1 << (kScale - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

inline uint8_t limit(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// restrict: a uint8_t store may alias anything, and the tables would be
// reloaded after every pixel
void ycc_to_bgr(const uint8_t* __restrict p0, const uint8_t* __restrict p1,
                const uint8_t* __restrict p2, uint8_t* __restrict out, size_t npix,
                const YccTables& __restrict t) {
  for (size_t i = 0; i < npix; ++i) {
    const int y = p0[i], cb = p1[i], cr = p2[i];
    out[3 * i] = limit(y + t.cb_b[cb]);
    out[3 * i + 1] = limit(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
    out[3 * i + 2] = limit(y + t.cr_r[cr]);
  }
}

enum ColorSpace { kGray, kYCbCr, kRGB, kCMYK, kYCCK, kUnknown };

ColorSpace guess_color(const Decoder& dec) {  // jdapimin.c default_decompress_parms
  const size_t nc = dec.comps.size();
  if (nc == 1) return kGray;
  if (nc == 3) {
    if (dec.jfif) return kYCbCr;
    if (dec.adobe) return dec.adobe_transform == 0 ? kRGB : kYCbCr;
    const int c0 = dec.comps[0].id, c1 = dec.comps[1].id, c2 = dec.comps[2].id;
    if (c0 == 82 && c1 == 71 && c2 == 66) return kRGB;
    return kYCbCr;
  }
  if (nc == 4) {
    if (dec.adobe) return dec.adobe_transform == 0 ? kCMYK : kYCCK;
    return kCMYK;
  }
  return kUnknown;
}

void decode(const uint8_t* data, size_t size, bool gray, uint8_t* out) {
  Decoder dec(data, size);
  dec.run(false);
  const ColorSpace cs = guess_color(dec);
  if (cs == kUnknown) {
    fail(kUnsupported, "JPEG with " + std::to_string(dec.comps.size()) +
                           " components (1, 3 or 4 are read)");
  }
  if (dec.progressive) {  // jdcoefct.c smoothing_ok, after the last scan
    bool dc_known = true, smoothing = false;
    for (const auto& c : dec.comps) {
      if (c.coef_bits[0] < 0) dc_known = false;
      for (int k = 1; k < 10; ++k) {
        if (c.coef_bits[k] != 0) smoothing = true;
      }
    }
    if (dc_known && smoothing) {
      fail(kUnsupported, "progressive JPEG whose scans leave coefficients 1-9 incomplete "
                         "(libjpeg's block smoothing is not implemented)");
    }
  }
  const int w = dec.width, h = dec.height;
  const size_t npix = static_cast<size_t>(w) * h;
  // the components the output needs: Y alone for gray from gray or YCbCr
  const size_t needed = gray && (cs == kGray || cs == kYCbCr) ? 1 : dec.comps.size();
  std::vector<std::vector<uint8_t>> planes(needed);
  for (size_t ci = 0; ci < needed; ++ci) {
    Component& c = dec.comps[ci];
    if (c.coef.empty()) c.coef.assign(Decoder::coef_size(c), 0);  // no scan reached it: flat
    const size_t stride = static_cast<size_t>(c.bw) * 8;
    std::vector<uint8_t> samples(stride * c.bh * 8);
    for (int by = 0; by < c.bh; ++by) {
      for (int bx = 0; bx < c.bw; ++bx) {
        idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.q,
                   &samples[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
      }
    }
    planes[ci] = upsample(c, samples.data(), stride, dec.hmax, dec.vmax, w, h);
  }
  static const YccTables t;
  if (cs == kGray || (gray && cs == kYCbCr)) {
    const uint8_t* y = planes[0].data();
    if (gray) {
      std::memcpy(out, y, npix);
    } else {
      for (size_t i = 0; i < npix; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    }
    return;
  }
  if (cs == kYCbCr && !gray) {  // jdcolor.c ycc_rgb_convert, into BGR
    ycc_to_bgr(planes[0].data(), planes[1].data(), planes[2].data(), out, npix, t);
    return;
  }
  if (cs == kYCbCr || cs == kRGB) {
    const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(), *p2 = planes[2].data();
    for (size_t i = 0; i < npix; ++i) {
      int r = p0[i], g = p1[i], b = p2[i];
      if (cs == kYCbCr) {
        const int y = r, cb = g, cr = b;
        r = limit(y + t.cr_r[cr]);
        g = limit(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        b = limit(y + t.cb_b[cb]);
      }
      if (gray) {  // jdcolor.c rgb_gray_convert
        constexpr int32_t kR = 19595, kG = 38470, kB = 7471;  // FIX(0.299), FIX(0.587), FIX(0.114)
        out[i] = static_cast<uint8_t>((kR * r + kG * g + kB * b + (1 << 15)) >> 16);
      } else {
        out[3 * i] = static_cast<uint8_t>(b);
        out[3 * i + 1] = static_cast<uint8_t>(g);
        out[3 * i + 2] = static_cast<uint8_t>(r);
      }
    }
    return;
  }
  // CMYK (YCCK converted first, jdcolor.c ycck_cmyk_convert), then OpenCV's
  // icvCvt_CMYK2BGR_8u_C4C3R / icvCvt_CMYK2Gray_8u_C4C1R
  const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(), *p2 = planes[2].data(),
                *p3 = planes[3].data();
  for (size_t i = 0; i < npix; ++i) {
    int c, m, yy;
    const int k = p3[i];
    if (cs == kYCCK) {
      const int y = p0[i], cb = p1[i], cr = p2[i];
      c = limit(255 - (y + t.cr_r[cr]));
      m = limit(255 - (y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
      yy = limit(255 - (y + t.cb_b[cb]));
    } else {
      c = p0[i];
      m = p1[i];
      yy = p2[i];
    }
    c = k - (((255 - c) * k) >> 8);
    m = k - (((255 - m) * k) >> 8);
    yy = k - (((255 - yy) * k) >> 8);
    if (gray) {
      constexpr int kR = 4899, kG = 9617, kB = 1868;  // 0.299, 0.587 and the rest in 1/16384
      out[i] = static_cast<uint8_t>((yy * kB + m * kG + c * kR + (1 << 13)) >> 14);
    } else {
      out[3 * i] = static_cast<uint8_t>(yy);
      out[3 * i + 1] = static_cast<uint8_t>(m);
      out[3 * i + 2] = static_cast<uint8_t>(c);
    }
  }
}

int report(const Error& e, char* err, int errlen) {
  if (err != nullptr && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

// info: width, height, components, EXIF orientation (1-8 as stored; 1 when
// absent). Returns 0, or 1 (a kind not read) / 2 (corrupt) with a message in err.
extern "C" int frn_jpeg_info(const uint8_t* data, int64_t size, int32_t* info, char* err, int errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(size));
    dec.run(true);
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = static_cast<int32_t>(dec.comps.size());
    info[3] = dec.orientation;
    return kOk;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Error{kCorrupt, "JPEG too large to decode in memory"}, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kCorrupt, std::string("corrupt JPEG: ") + e.what()}, err, errlen);
  }
}

// Decodes into out: (height, width) gray when gray != 0, else (height,
// width, 3) BGR, in the file's own orientation. Same return codes.
extern "C" int frn_jpeg_decode(const uint8_t* data, int64_t size, int gray, uint8_t* out, char* err,
                               int errlen) {
  try {
    decode(data, static_cast<size_t>(size), gray != 0, out);
    return kOk;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Error{kCorrupt, "JPEG too large to decode in memory"}, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kCorrupt, std::string("corrupt JPEG: ") + e.what()}, err, errlen);
  }
}

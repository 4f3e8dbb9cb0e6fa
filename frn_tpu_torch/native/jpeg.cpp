// JPEG decoder for the port's image reader (frn_tpu_torch/data/image_io.py).
//
// The JAX package reads every image through cv2.imread, which hands a JPEG
// file to libjpeg-turbo through libjpeg's stdio source. This decoder gives the
// same pixels, bit for bit, without OpenCV:
//  - Huffman-coded frames: baseline and extended sequential (SOF0, SOF1) and
//    progressive (SOF2: spectral selection, successive approximation, EOB
//    runs), restart intervals, 8-bit samples, 1, 3 or 4 components; a scan
//    whose table was never defined takes the standard table of its slot, as
//    libjpeg-turbo does for Motion-JPEG frames;
//  - the integer inverse DCT as libjpeg-turbo's SIMD jsimd_idct_islow
//    computes it (jidctint.c's arithmetic, with the dequantized inputs and
//    three sums wrapped to 16 bits, each pass saturated to 16 bits, the
//    outputs to 0..255, and its shortcut for a block whose rows 1-7 are
//    zero); on a sound file this is jidctint.c's result;
//  - fancy upsampling (jdsample.c): triangular h2v1, h1v2 and h2v2 filters,
//    each edge sample repeated; h2v1 and h2v2 fall back to replication where
//    a component is at most 2 samples wide, and every other integral factor
//    replicates;
//  - colour conversion (jdcolor.c): fixed-point YCbCr -> RGB with 16-bit
//    tables, Y alone for gray output, RGB -> gray for an RGB-coded file,
//    YCCK -> CMYK; CMYK -> BGR and CMYK -> gray as OpenCV converts them;
//  - the colour space as libjpeg guesses it: JFIF APP0, then Adobe APP14's
//    transform, then the component ids;
//  - damaged files as libjpeg-turbo meets them under cv2.imread. Past the
//    end of the file the input reads as the stdio source's fake EOI markers.
//    Where entropy-coded data ends, or a marker interrupts it, the MCU in
//    progress is decoded to its end from zero bits and the rest of the
//    segment is left undecoded (zero coefficients in a sequential file, the
//    earlier scans' in a progressive one) until a restart marker that is
//    found; a bad Huffman code decodes as 0; missing or out-of-order restart
//    markers resynchronize as jpeg_resync_to_restart does; nothing after the
//    scan of a single-scan file is read; a progressive file whose scans leave
//    any of the first ten coefficients incomplete is smoothed as
//    libjpeg-turbo 2.1+'s decompress_smooth_data smooths it.
// The EXIF orientation of the first APP1 segment is reported, not applied
// (the caller turns the image as OpenCV does). frn_jpeg_decode_tiff decodes a
// strip or tile of a JPEG-compressed TIFF as libtiff's JPEG codec asks
// libjpeg for it: YCbCr converted to RGB whatever the markers say, or the
// components as they are; frn_jpeg_tables gives the tables that such a
// decompressor carries from one strip to the next.
//
// Return codes: kCorrupt where cv2.imread returns None (libjpeg-turbo stops
// with an error, as on a file cut before its first scan, a broken marker
// segment, hierarchical frames, 12-bit samples or an unknown marker; or
// OpenCV cannot convert the result); kUnsupported for a file cv2.imread reads
// and this decoder does not: arithmetic-coded and lossless frames, a frame of
// more than 2^30 pixels (cv2.imread raises), and a frame of more than 2^26
// pixels whose file is too short for its first scan (libjpeg would allocate
// the frame and decode it grey; the refusal keeps a small file from taking
// gigabytes).
//
// Plain C ABI, bound by ctypes; built by frn_tpu_torch/utils/native.py.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <new>
#include <string>
#include <utility>
#include <vector>

namespace {

enum { kOk = 0, kUnsupported = 1, kCorrupt = 2 };

constexpr int kMaxDimension = 65500;                 // libjpeg's JPEG_MAX_DIMENSION
constexpr int64_t kCv2MaxPixels = int64_t{1} << 30;  // cv2's CV_IO_MAX_IMAGE_PIXELS
constexpr int64_t kShortFileMaxPixels = int64_t{1} << 26;

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

struct RawTable {  // a table as DHT defines it (jdmarker.c get_dht)
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

struct Huffman {
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoff[18] = {};
  uint16_t look[1 << kLookBits] = {};  // (code length << 8) | symbol; 0: longer code

  // jdhuff.c jpeg_make_d_derived_tbl, run when a scan starts that uses the table
  void derive(const RawTable& t, bool dc) {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += t.bits[l];
    if (count > 256) fail(kCorrupt, "corrupt JPEG: bad Huffman table");
    std::memcpy(vals, t.vals, sizeof(vals));
    int huffcode[257];
    int code = 0, p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < t.bits[l]; ++i) huffcode[p++] = code++;
      // no code may be all ones
      if (code >= (1 << l)) fail(kCorrupt, "corrupt JPEG: bad Huffman table");
      code <<= 1;
    }
    if (dc) {  // DC symbols are magnitude categories 0..15
      for (int i = 0; i < count; ++i) {
        if (vals[i] > 15) fail(kCorrupt, "corrupt JPEG: bad Huffman table");
      }
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (t.bits[l]) {
        valoff[l] = p - huffcode[p];
        p += t.bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;  // a code of 17 bits ends the search: a bad code
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 0; i < t.bits[l]; ++i, ++p) {
        const int lookbits = huffcode[p] << (kLookBits - l);
        for (int c = 0; c < (1 << (kLookBits - l)); ++c) {
          look[lookbits + c] = static_cast<uint16_t>((l << 8) | vals[p]);
        }
      }
    }
  }
};

// The bytes libjpeg's stdio source gives: the file, then the fake EOI marker
// (FF D9) that fill_input_buffer inserts each time it is called at the end.
struct Input {
  const uint8_t* d;
  uint64_t n;
  uint64_t pos = 0;

  Input(const uint8_t* data, uint64_t size) : d(data), n(size) {}
  int at(uint64_t p) const { return p < n ? d[p] : (((p - n) & 1) ? 0xD9 : 0xFF); }
  int byte() { return at(pos++); }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  // jdmarker.c next_marker: skip anything up to FF, then fill FFs; FF 00 is data
  int next_marker() {
    int c = byte();
    while (true) {
      while (c != 0xFF) c = byte();
      do {
        c = byte();
      } while (c == 0xFF);
      if (c != 0) return c;
      c = byte();
    }
  }
};

// Entropy-coded data (jdhuff.c jpeg_fill_bit_buffer): stuffed FF 00 bytes
// become FF; at a marker the reader stops (the marker is then unread) and
// feeds zero bits. libjpeg sets its insufficient_data flag exactly when a
// decode takes any of those zero bits, which `crossed` tells.
struct BitReader {
  const Input* in;
  uint64_t pos;     // the next byte to read
  uint64_t buf = 0;
  int cnt = 0;      // bits in buf, from the top
  int fake = 0;     // of which zero bits fed in at the marker
  int marker = 0;   // the marker that stopped the reader (0: none yet)

  BitReader(const Input* input, uint64_t start, int unread) : in(input), pos(start), marker(unread) {}

  void fill() {
    const uint8_t* d = in->d;
    if (marker == 0 && pos + 8 <= in->n) {  // the next 8 bytes hold no FF: take the whole bytes that fit
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
      if (marker == 0) {
        int c = in->at(pos++);
        if (c == 0xFF) {
          do {
            c = in->at(pos++);
          } while (c == 0xFF);  // fill bytes
          if (c == 0) {
            b = 0xFF;
          } else {
            marker = c;  // pos is just past the marker, as libjpeg leaves it
          }
        } else {
          b = static_cast<uint32_t>(c);
        }
      }
      if (marker != 0) fake += 8;
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  bool crossed() const { return cnt < fake; }
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
    if (cnt < 17) fill();
    return decode_filled(h);
  }
  // 17 bits are in buf. A code longer than 16 bits takes 17 and decodes as 0
  // (jdhuff.c jpeg_huff_decode's "fake a zero").
  int decode_filled(const Huffman& h) {
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
      code = static_cast<int32_t>(buf >> (64 - l));
    }
    buf <<= l;
    cnt -= l;
    if (l > 16) return 0;
    return h.vals[(h.valoff[l] + code) & 0xFF];
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int index = 0, id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;  // blocks of the component's samples (width_in_blocks, height_in_blocks)
  int bw = 0, bh = 0;    // blocks held (whole MCUs)
  int dw = 0, dh = 0;    // samples of the component (downsampled_width, _height)
  std::vector<int16_t> coef;
  uint16_t q[64] = {};   // latched at the component's first scan, natural order
  bool latched = false;
  bool needed = true;
  int coef_bits[64];     // progressive: the last Al coded per coefficient (-1: none)
  int prev_bits[64];     // the same before the component's last scan
  int dc_pred = 0, td = 0, ta = 0;
};

struct Decoder {
  Input in;
  int unread = 0;  // a marker read and not yet processed (libjpeg's unread_marker)
  uint16_t qt[4][64] = {};
  bool qdef[4] = {};
  RawTable dc_raw[4], ac_raw[4];
  Huffman dc[4], ac[4];  // derived for the scan in progress
  int restart_interval = 0;
  bool saw_sof = false, progressive = false, lossless = false, arith = false;
  int sof_marker = 0, precision = 8;
  bool jfif = false, adobe = false, app1 = false, sos_seen = false;
  int adobe_transform = 0, orientation = 1;
  int width = 0, height = 0;
  std::vector<Component> comps;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool multiscan = false;
  int input_scan_number = 0;
  int last_good_row = 0;  // the last iMCU row a scan began with its data intact

  // the scan in progress
  std::vector<Component*> sc;
  int ss = 0, se = 0, ah = 0, al = 0, next_rst = 0, eobrun = 0;
  bool insufficient = false;

  Decoder(const uint8_t* data, size_t size) : in(data, size) {}

  void skip_variable() {  // jdmarker.c skip_variable: a length below 2 skips nothing
    const int len = in.u16() - 2;
    if (len > 0) in.pos += static_cast<uint64_t>(len);
  }

  void parse_exif(const uint8_t* p, size_t len) {
    // OpenCV's ExifReader: the TIFF header 6 bytes into the first APP1, IFD0's
    // Orientation (0x0112) as an unsigned short; where the block breaks off,
    // the entries read before it stand
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
    for (int i = 0; i < entries; ++i) {
      const size_t e = ifd + 2 + 12 * static_cast<size_t>(i);
      if (e + 12 > len) return;
      if (g16(e) == 0x0112) orientation = g16(e + 8);
    }
  }

  // APP0 and APP14 are examined, the first APP1 is kept for its EXIF (OpenCV
  // saves APP1 markers), the rest are skipped
  void read_app(int marker) {
    const int len = in.u16() - 2;
    if (len <= 0) return;
    std::vector<uint8_t> body(static_cast<size_t>(len));
    for (int i = 0; i < len; ++i) body[i] = static_cast<uint8_t>(in.byte());
    const uint8_t* p = body.data();
    const size_t dl = body.size();
    if (!sos_seen && marker == 0xE0 && dl >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
    if (!sos_seen && marker == 0xEE && dl >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    if (marker == 0xE1 && !app1 && !sos_seen) {
      app1 = true;
      parse_exif(p, dl);
    }
  }

  void read_dqt() {  // jdmarker.c get_dqt
    int len = in.u16() - 2;
    while (len > 0) {
      --len;
      const int pq = in.byte();
      const int prec = pq >> 4, t = pq & 15;
      if (t >= 4) fail(kCorrupt, "corrupt JPEG: quantization table index out of range");
      for (int i = 0; i < 64; ++i) qt[t][kNatural[i]] = static_cast<uint16_t>(prec ? in.u16() : in.byte());
      qdef[t] = true;
      len -= prec ? 128 : 64;
    }
    if (len != 0) fail(kCorrupt, "corrupt JPEG: bad DQT length");
  }

  void read_dht() {  // jdmarker.c get_dht
    int len = in.u16() - 2;
    while (len > 16) {
      const int index = in.byte();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = static_cast<uint8_t>(in.byte());
        count += bits[l];
      }
      len -= 17;
      if (count > 256 || count > len) fail(kCorrupt, "corrupt JPEG: bad Huffman table");
      RawTable t;
      for (int i = 0; i < count; ++i) t.vals[i] = static_cast<uint8_t>(in.byte());
      len -= count;
      const bool is_ac = index & 0x10;
      const int slot = is_ac ? index - 0x10 : index;
      if (slot < 0 || slot >= 4) fail(kCorrupt, "corrupt JPEG: Huffman table index out of range");
      std::memcpy(t.bits, bits, sizeof(bits));
      t.defined = true;
      (is_ac ? ac_raw : dc_raw)[slot] = t;
    }
    if (len != 0) fail(kCorrupt, "corrupt JPEG: bad DHT length");
  }

  void read_dac() {  // jdmarker.c get_dac (arithmetic conditioning)
    int len = in.u16() - 2;
    while (len > 0) {
      const int index = in.byte(), val = in.byte();
      len -= 2;
      if (index >= 32) fail(kCorrupt, "corrupt JPEG: DAC index out of range");
      if (index < 16 && (val & 15) > (val >> 4)) fail(kCorrupt, "corrupt JPEG: bad DAC value");
    }
    if (len != 0) fail(kCorrupt, "corrupt JPEG: bad DAC length");
  }

  void read_sof(int marker) {  // jdmarker.c get_sof
    if (saw_sof) fail(kCorrupt, "corrupt JPEG: more than one frame header");
    progressive = marker == 0xC2 || marker == 0xCA;
    lossless = marker == 0xC3 || marker == 0xCB;
    arith = marker >= 0xC9;
    const int len = in.u16();
    precision = in.byte();
    height = in.u16();
    width = in.u16();
    const int nc = in.byte();
    if (height == 0 || width == 0 || nc == 0) fail(kCorrupt, "corrupt JPEG: empty image (or a DNL-defined height)");
    if (len - 8 != 3 * nc) fail(kCorrupt, "corrupt JPEG: bad SOF length");
    comps.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[i];
      c.index = i;
      c.id = in.byte();
      const int hv = in.byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = in.byte();
    }
    saw_sof = true;
    sof_marker = marker;
  }

  void read_sos() {  // jdmarker.c get_sos
    if (!saw_sof) fail(kCorrupt, "corrupt JPEG: a scan before the frame header");
    const int len = in.u16();
    const int ns = in.byte();
    if (len != 6 + 2 * ns || ns < 1 || ns > 4) fail(kCorrupt, "corrupt JPEG: bad SOS header");
    Component* slot[4] = {};  // libjpeg's cur_comp_info
    for (int i = 0; i < ns; ++i) {
      const int cid = in.byte(), t = in.byte();
      Component* c = nullptr;
      // as libjpeg-turbo matches ids: component ci only while scan slot ci is free
      const int limit = std::min<int>(static_cast<int>(comps.size()), 4);
      for (int ci = 0; ci < limit && c == nullptr; ++ci) {
        if (comps[ci].id == cid && slot[ci] == nullptr) c = &comps[ci];
      }
      if (c == nullptr) fail(kCorrupt, "corrupt JPEG: a scan names an unknown component");
      for (int pi = 0; pi < i; ++pi) {
        if (slot[pi] == c) fail(kCorrupt, "corrupt JPEG: a component twice in one scan");
      }
      slot[i] = c;
      c->td = t >> 4;
      c->ta = t & 15;
    }
    sc.assign(slot, slot + ns);
    ss = in.byte();
    se = in.byte();
    const int a = in.byte();
    ah = a >> 4;
    al = a & 15;
    next_rst = 0;
    ++input_scan_number;
  }

  // the frames libjpeg-turbo reads and this decoder does not
  std::string frame_kind() const {
    switch (sof_marker) {
      case 0xC3: return "lossless JPEG (SOF3)";
      case 0xC9: return "arithmetic-coded JPEG (SOF9)";
      case 0xCA: return "arithmetic-coded progressive JPEG (SOF10)";
      case 0xCB: return "arithmetic-coded lossless JPEG (SOF11)";
      default: return "JPEG";
    }
  }
  static constexpr const char* kNotRead =
      " is not read (Huffman-coded 8-bit baseline, extended and progressive JPEGs are)";

  static const char* unread_kind(int m) {  // frames libjpeg-turbo refuses
    switch (m) {
      case 0xC5: return "hierarchical JPEG (SOF5, differential sequential)";
      case 0xC6: return "hierarchical JPEG (SOF6, differential progressive)";
      case 0xC7: return "hierarchical lossless JPEG (SOF7)";
      case 0xC8: return "JPEG extension frame (JPG marker)";
      case 0xCD: return "arithmetic-coded hierarchical JPEG (SOF13)";
      case 0xCE: return "arithmetic-coded hierarchical JPEG (SOF14)";
      case 0xCF: return "arithmetic-coded hierarchical lossless JPEG (SOF15)";
      default: return nullptr;
    }
  }

  // jdmarker.c read_markers: returns 0xDA at an SOS (its header read) or 0xD9 at EOI
  int read_markers() {
    while (true) {
      if (unread == 0) unread = in.next_marker();
      const int m = unread;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || (m >= 0xC9 && m <= 0xCB)) {
        read_sof(m);
      } else if (const char* kind = unread_kind(m)) {
        fail(kCorrupt, std::string(kind) + " (libjpeg-turbo does not read it)");
      } else if (m == 0xDA) {
        read_sos();
        unread = 0;
        return 0xDA;
      } else if (m == 0xD9) {
        unread = 0;
        return 0xD9;
      } else if (m == 0xCC) {
        read_dac();
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        if (in.u16() != 4) fail(kCorrupt, "corrupt JPEG: bad DRI length");
        restart_interval = in.u16();
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xFE || m == 0xDC) {  // COM, DNL
        skip_variable();
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // a stray RSTn or TEM: no parameters
      } else if (m == 0xD8) {
        fail(kCorrupt, "corrupt JPEG: a second SOI marker");
      } else {
        char buf[64];
        std::snprintf(buf, sizeof(buf), "corrupt JPEG: unknown marker 0x%02X", m);
        fail(kCorrupt, buf);
      }
      unread = 0;
    }
  }

  // jpeg_read_header: the markers up to the first SOS, then jdinput.c
  // initial_setup and OpenCV's size check
  void read_header() {
    if (in.n < 2 || in.d[0] != 0xFF || in.d[1] != 0xD8) fail(kCorrupt, "not a JPEG file (no SOI marker)");
    in.pos = 2;
    if (read_markers() != 0xDA) {
      fail(kCorrupt, saw_sof ? "truncated or corrupt JPEG: no scan after the frame header"
                             : "truncated or corrupt JPEG: no frame header before EOI");
    }
    sos_seen = true;
    if (height > kMaxDimension || width > kMaxDimension) {
      fail(kCorrupt, "JPEG of " + std::to_string(width) + "x" + std::to_string(height) +
                         " pixels (a side over libjpeg's 65500)");
    }
    if (lossless ? precision < 2 || precision > 16 : precision != 8 && precision != 12) {
      fail(kCorrupt, "corrupt JPEG: " + std::to_string(precision) + "-bit samples");
    }
    if (comps.size() > 10) fail(kCorrupt, "corrupt JPEG: more than 10 components");
    for (const auto& c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail(kCorrupt, "corrupt JPEG: bad sampling factors");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.wib = static_cast<int>((static_cast<int64_t>(width) * c.h + 8 * hmax - 1) / (8 * hmax));
      c.hib = static_cast<int>((static_cast<int64_t>(height) * c.v + 8 * vmax - 1) / (8 * vmax));
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 64, 0);
    }
    multiscan = sc.size() < comps.size() || progressive;
    if (static_cast<int64_t>(width) * height > kCv2MaxPixels) {
      fail(kUnsupported, "JPEG of " + std::to_string(width) + "x" + std::to_string(height) +
                             " pixels (more than 2^30, which cv2.imread refuses too)");
    }
    if (precision != 8 && !lossless) {
      fail(kCorrupt, std::to_string(precision) + "-bit JPEG (cv2.imread reads 8-bit samples only)");
    }
  }

  const RawTable& raw_table(bool is_ac, int index) {
    if (index >= 4) fail(kCorrupt, "corrupt JPEG: Huffman table index out of range");
    RawTable& t = is_ac ? ac_raw[index] : dc_raw[index];
    if (!t.defined) {  // jdhuff.c std_huff_tables fills slots 0 and 1 (not for progressive files)
      if (index > 1 || progressive) fail(kCorrupt, "corrupt JPEG: a scan uses an undefined Huffman table");
      const int count = is_ac ? 162 : 12;
      std::memcpy(t.bits, is_ac ? kStdAcBits[index] : kStdDcBits[index], 17);
      std::memcpy(t.vals, is_ac ? kStdAcVals[index] : kStdDcVals, count);
      t.defined = true;
    }
    return t;
  }

  int blocks_in_mcu() const {
    int blocks = 0;
    for (auto* c : sc) blocks += sc.size() == 1 ? 1 : c->h * c->v;
    return blocks;
  }

  // jdinput.c start_input_pass: per_scan_setup, latch_quant_tables and the
  // entropy decoder's start_pass
  void start_scan() {
    const int blocks = blocks_in_mcu();
    if (blocks > 10) fail(kCorrupt, "corrupt JPEG: too many blocks in an MCU");
    if (lossless) {  // jdlossls.c's scan checks, then the kind is refused
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision) {
        fail(kCorrupt, frame_kind() + " with bad scan parameters");
      }
      if (precision > 8) fail(kCorrupt, std::to_string(precision) + "-bit " + frame_kind());
      fail(kUnsupported, frame_kind() + kNotRead);
    }
    for (auto* c : sc) {
      if (!c->latched) {
        if (c->tq >= 4 || !qdef[c->tq]) fail(kCorrupt, "corrupt JPEG: a component's quantization table is undefined");
        std::memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->latched = true;
      }
    }
    if (progressive) {  // jdphuff.c start_pass_phuff_decoder
      bool bad;
      if (ss == 0) {
        bad = se != 0;
      } else {
        bad = ss > se || se >= 64 || sc.size() != 1;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail(kCorrupt, (arith ? frame_kind() + " with" : std::string("corrupt JPEG:")) +
                                   " bad progression parameters");
      if (!arith) {
        for (auto* c : sc) {
          for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k) {
            c->prev_bits[k] = input_scan_number > 1 ? c->coef_bits[k] : 0;
          }
          for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
        }
      }
    }
    if (arith) fail(kUnsupported, frame_kind() + kNotRead);
    for (auto* c : sc) {
      if (!progressive) {
        dc[c->td].derive(raw_table(false, c->td), true);
        ac[c->ta].derive(raw_table(true, c->ta), false);
      } else if (ss == 0) {
        if (ah == 0) dc[c->td].derive(raw_table(false, c->td), true);
      } else {
        ac[c->ta].derive(raw_table(true, c->ta), false);
      }
      c->dc_pred = 0;
    }
    // a scan that codes DC spends at least one bit a block: a large frame in a
    // file too short for it is refused before its coefficients are allocated
    const int64_t total = scan_mcus();
    if ((!progressive || ss == 0) && static_cast<int64_t>(width) * height > kShortFileMaxPixels &&
        (in.pos > in.n || static_cast<int64_t>(in.n - in.pos) * 8 < total * blocks)) {
      fail(kUnsupported, "truncated or corrupt JPEG: the file is too short for the blocks of a scan of " +
                             std::to_string(width) + "x" + std::to_string(height) +
                             " pixels (not decoded above 2^26 pixels)");
    }
    for (auto* c : sc) {
      // zeros until a scan codes them, as libjpeg's pre-zeroed coefficient buffers
      if (c->coef.empty()) c->coef.assign(coef_size(*c), 0);
    }
    insufficient = false;
    eobrun = 0;
  }

  int64_t scan_mcus() const {
    if (sc.size() == 1) return static_cast<int64_t>(sc[0]->wib) * sc[0]->hib;
    return static_cast<int64_t>(mcux) * mcuy;
  }

  // jdhuff.c process_restart with jdmarker.c read_restart_marker and
  // jpeg_resync_to_restart (the stdio source's resync)
  BitReader restart(const BitReader& br) {
    int m = br.marker;
    Input at = in;
    at.pos = br.pos;
    if (m == 0) m = at.next_marker();
    if (m == 0xD0 + next_rst) {
      m = 0;
    } else {
      while (true) {
        int action;
        if (m < 0xC0) {
          action = 2;  // not a valid marker
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;  // a valid marker that is not a restart
        } else if (m == 0xD0 + ((next_rst + 1) & 7) || m == 0xD0 + ((next_rst + 2) & 7)) {
          action = 3;  // one of the next two restarts
        } else if (m == 0xD0 + ((next_rst - 1) & 7) || m == 0xD0 + ((next_rst - 2) & 7)) {
          action = 2;  // a prior restart: scan on
        } else {
          action = 1;  // the desired restart or too far away
        }
        if (action == 1) {
          m = 0;
          break;
        }
        if (action == 3) break;  // left unread: the segment reads as empty
        m = at.next_marker();
      }
    }
    next_rst = (next_rst + 1) & 7;
    for (auto* c : sc) c->dc_pred = 0;
    eobrun = 0;
    if (m == 0) insufficient = false;
    return BitReader(&in, at.pos, m);
  }

  // jdcoefct.c consume_data / decompress_onepass over one scan
  void scan() {
    start_scan();
    const bool single = sc.size() == 1;
    const int mx = single ? sc[0]->wib : mcux;
    const int my = single ? sc[0]->hib : mcuy;
    const int row_div = single ? sc[0]->v : 1;  // MCU rows an iMCU row
    const bool dc_refine = progressive && ss == 0 && ah != 0;
    BitReader br(&in, in.pos, unread);
    unread = 0;
    int restarts_left = restart_interval;
    for (int row = 0; row < my; ++row) {
      for (int col = 0; col < mx; ++col) {
        if (restart_interval && restarts_left == 0) {
          br = restart(br);
          restarts_left = restart_interval;
        }
        if (!insufficient) last_good_row = row / row_div;
        if (!insufficient || dc_refine) {
          if (single) {
            decode_block(br, *sc[0], block(*sc[0], col, row));
          } else {
            for (auto* c : sc) {
              for (int by = 0; by < c->v; ++by) {
                for (int bx = 0; bx < c->h; ++bx) {
                  decode_block(br, *c, block(*c, col * c->h + bx, row * c->v + by));
                }
              }
            }
          }
          if (br.crossed()) insufficient = true;
        }
        if (restart_interval) --restarts_left;
      }
    }
    in.pos = br.pos;  // the next marker search starts here
    unread = br.marker;
  }

  static size_t coef_size(const Component& c) { return static_cast<size_t>(c.bw) * c.bh * 64; }

  static int16_t* block(Component& c, int bx, int by) {
    return &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64];
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    if (!progressive) {  // jdhuff.c decode_mcu
      const Huffman& hd = dc[c.td];
      const Huffman& ha = ac[c.ta];
      int s = br.decode(hd);
      if (s) s = extend(static_cast<int>(br.get(s)), s);
      c.dc_pred = static_cast<int>(static_cast<unsigned>(c.dc_pred) + static_cast<unsigned>(s));
      blk[0] = static_cast<int16_t>(c.dc_pred);
      for (int k = 1; k < 64; ++k) {
        if (br.cnt < 32) br.fill();  // a code (17 bits at most) and its value (15)
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
        if (s) s = extend(static_cast<int>(br.get(s)), s);
        if ((c.dc_pred >= 0 && s > INT32_MAX - c.dc_pred) || (c.dc_pred < 0 && s < INT32_MIN - c.dc_pred)) {
          fail(kCorrupt, "corrupt JPEG: DC coefficient out of range");
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

  // the scans after the first of a multi-scan file, up to EOI (real or fake)
  void consume() {
    scan();
    if (!multiscan) return;  // libjpeg reads no further before the pixels are out
    while (read_markers() == 0xDA) scan();
  }
};

// ------------------------------------------------------------ inverse DCT

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline int32_t sat16(int32_t v) { return std::min(32767, std::max(-32768, v)); }
inline int32_t w16(int32_t v) { return static_cast<int32_t>(static_cast<uint32_t>(v) << 16) >> 16; }

// One 1-D pass of jsimd_idct_islow over 8 vectors at once: x[k] holds input k
// of 8 independent transforms (lane j of each array is transform j), each a
// 16-bit value; y[r] gets their output r descaled by `shift` and saturated to
// 16 bits (packssdw). As in the SIMD code, in0 + in4, in0 - in4, in7 + in3
// and in5 + in1 wrap at 16 bits (paddw) and every product pairs two 16-bit
// inputs (pmaddwd). The compiler vectorizes over the lanes (on 32-bit lanes:
// 16-bit arrays cost it more).
inline void idct_pass(const int32_t (&x)[8][8], int32_t (&y)[8][8], int shift) {
  const int32_t half = 1 << (shift - 1);
  for (int j = 0; j < 8; ++j) {
    const int32_t z2 = x[2][j], z3 = x[6][j];
    const int32_t t2 = z2 * F0541 + z3 * (F0541 - F1847);
    const int32_t t3 = z2 * (F0541 + F0765) + z3 * F0541;
    const int32_t t0 = w16(x[0][j] + x[4][j]) * (1 << kConstBits);
    const int32_t t1 = w16(x[0][j] - x[4][j]) * (1 << kConstBits);
    const int32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    const int32_t i7 = x[7][j], i5 = x[5][j], i3 = x[3][j], i1 = x[1][j];
    const int32_t s73 = w16(i7 + i3), s51 = w16(i5 + i1);
    const int32_t z3p = s73 * (F1175 - F1961) + s51 * F1175;
    const int32_t z4p = s73 * F1175 + s51 * (F1175 - F0390);
    const int32_t o7 = i7 * (F0298 - F0899) + i1 * (-F0899) + z3p;
    const int32_t o1 = i7 * (-F0899) + i1 * (F1501 - F0899) + z4p;
    const int32_t o5 = i5 * (F2053 - F2562) + i3 * (-F2562) + z4p;
    const int32_t o3 = i5 * (-F2562) + i3 * (F3072 - F2562) + z3p;
    y[0][j] = sat16((t10 + o1 + half) >> shift);
    y[7][j] = sat16((t10 - o1 + half) >> shift);
    y[1][j] = sat16((t11 + o3 + half) >> shift);
    y[6][j] = sat16((t11 - o3 + half) >> shift);
    y[2][j] = sat16((t12 + o5 + half) >> shift);
    y[5][j] = sat16((t12 - o5 + half) >> shift);
    y[3][j] = sat16((t13 + o7 + half) >> shift);
    y[4][j] = sat16((t13 - o7 + half) >> shift);
  }
}
// jsimd_idct_islow: one 8x8 block into out (stride samples a row). Pass 1
// runs the 8 columns as lanes on the dequantized inputs (pmullw: the low 16
// bits of each product), pass 2 the 8 rows (the workspace transposed between
// them); the outputs are saturated to -128..127 (packsswb) and level-shifted.
// A block whose rows 1-7 are zero takes pass 1's shortcut: each column is its
// dequantized row-0 input shifted left by 2, at 16 bits.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, size_t stride) {
  int32_t x[8][8], ws[8][8], wt[8][8], y[8][8];
  uint64_t rows = 0;
  for (int k = 0; k < 14; ++k) {
    uint64_t w;
    std::memcpy(&w, in + 8 + 4 * k, 8);
    rows |= w;
  }
  for (int k = 0; k < 8; ++k) {
    for (int j = 0; j < 8; ++j) x[k][j] = w16(in[8 * k + j] * q[8 * k + j]);  // x[row k][column j]
  }
  if (rows == 0) {
    for (int j = 0; j < 8; ++j) {
      const int32_t dc = w16(x[0][j] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[r][j] = dc;
    }
  } else {
    idct_pass(x, ws, kConstBits - kPass1Bits);  // ws[row r][column j]
  }
  for (int r = 0; r < 8; ++r) {
    for (int c = 0; c < 8; ++c) wt[c][r] = ws[r][c];  // wt[input c][row r]
  }
  idct_pass(wt, y, kConstBits + kPass1Bits + 3);  // y[column k][row r]
  for (int r = 0; r < 8; ++r) {
    for (int k = 0; k < 8; ++k) {
      out[r * stride + k] = static_cast<uint8_t>(std::min<int>(127, std::max<int>(-128, y[k][r])) + 128);
    }
  }
}

// ------------------------------------------------------------ block smoothing

constexpr int kSavedCoefs = 10;  // coefficients 0-9 in zigzag order
// their natural positions: DC, AC01, AC10, AC20, AC11, AC02, AC03, AC12, AC21, AC30
constexpr int kSmoothPos[kSavedCoefs] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// jdcoefct.c smoothing_ok, after the last scan: each component's coef_bits
// latched (and those before its last scan, for the rows past the last intact one)
bool smoothing_ok(const Decoder& dec, std::vector<int>& latch, std::vector<int>& prev_latch) {
  if (!dec.progressive) return false;
  const size_t nc = dec.comps.size();
  latch.assign(nc * kSavedCoefs, 0);
  prev_latch.assign(nc * kSavedCoefs, 0);
  bool useful = false;
  for (size_t ci = 0; ci < nc; ++ci) {
    const Component& c = dec.comps[ci];
    if (!c.latched) return false;
    for (int k = 0; k < kSavedCoefs; ++k) {
      if (c.q[kSmoothPos[k]] == 0) return false;
    }
    if (c.coef_bits[0] < 0) return false;
    latch[ci * kSavedCoefs] = c.coef_bits[0];
    for (int k = 1; k < kSavedCoefs; ++k) {
      prev_latch[ci * kSavedCoefs + k] = dec.input_scan_number > 1 ? c.prev_bits[k] : -1;
      latch[ci * kSavedCoefs + k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

// an estimate of one coefficient from num, clamped below 2^Al where Al bits
// of it are still unknown (jdcoefct.c decompress_smooth_data)
inline int16_t estimate(int64_t num, int64_t q, int al) {
  int pred;
  if (num >= 0) {
    pred = static_cast<int>(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = static_cast<int>(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return static_cast<int16_t>(pred);
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1+) for one component:
// each block's coefficients 1-9 that are still zero and not known exactly are
// estimated from the DC values of its 5x5 neighbourhood; where no AC data has
// arrived at all the DC is re-estimated too. Then the block's IDCT.
void smooth_component(const Decoder& dec, const Component& c, const int* latch, const int* prev_latch,
                      uint8_t* samples, size_t stride) {
  const int total_rows = dec.mcuy;
  const int last_col = c.wib - 1;
  const int64_t q00 = c.q[0], q01 = c.q[1], q10 = c.q[8], q20 = c.q[16], q11 = c.q[9], q02 = c.q[2];
  auto at = [&](int row, int col) { return &c.coef[(static_cast<size_t>(row) * c.bw + col) * 64]; };
  int16_t ws[64];
  for (int imcu = 0; imcu < total_rows; ++imcu) {
    const int* bits = imcu > dec.last_good_row ? prev_latch : latch;
    const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                           bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
    const int64_t q03 = change_dc ? c.q[3] : 0, q12 = change_dc ? c.q[10] : 0,
                  q21 = change_dc ? c.q[17] : 0, q30 = change_dc ? c.q[24] : 0;
    int block_rows = c.v;
    if (imcu == total_rows - 1) {
      block_rows = c.hib % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    // libjpeg-turbo counts the image's block rows with this iMCU row's count
    const int image_block_rows = block_rows * total_rows;
    for (int b = 0; b < block_rows; ++b) {
      const int image_block_row = imcu * block_rows + b;
      const int row = imcu * c.v + b;
      const int prev = image_block_row > 0 ? row - 1 : row;
      const int pprev = image_block_row > 1 ? row - 2 : prev;
      const int next = image_block_row < image_block_rows - 1 ? row + 1 : row;
      const int nnext = image_block_row < image_block_rows - 2 ? row + 2 : next;
      const int rows[5] = {pprev, prev, row, next, nnext};
      int dcv[5][5];  // dcv[r][k]: DC(r*5 + k + 1) in libjpeg's numbering
      for (int r = 0; r < 5; ++r) {
        for (int k = 0; k < 5; ++k) dcv[r][k] = at(rows[r], 0)[0];
      }
      for (int col = 0; col <= last_col; ++col) {
        std::memcpy(ws, at(row, col), sizeof(ws));
        if (col == 0 && col < last_col) {
          for (int r = 0; r < 5; ++r) dcv[r][3] = dcv[r][4] = at(rows[r], 1)[0];
        }
        if (col + 1 < last_col) {
          for (int r = 0; r < 5; ++r) dcv[r][4] = at(rows[r], col + 2)[0];
        }
        const int64_t DC01 = dcv[0][0], DC02 = dcv[0][1], DC03 = dcv[0][2], DC04 = dcv[0][3], DC05 = dcv[0][4];
        const int64_t DC06 = dcv[1][0], DC07 = dcv[1][1], DC08 = dcv[1][2], DC09 = dcv[1][3], DC10 = dcv[1][4];
        const int64_t DC11 = dcv[2][0], DC12 = dcv[2][1], DC13 = dcv[2][2], DC14 = dcv[2][3], DC15 = dcv[2][4];
        const int64_t DC16 = dcv[3][0], DC17 = dcv[3][1], DC18 = dcv[3][2], DC19 = dcv[3][3], DC20 = dcv[3][4];
        const int64_t DC21 = dcv[4][0], DC22 = dcv[4][1], DC23 = dcv[4][2], DC24 = dcv[4][3], DC25 = dcv[4][4];
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
          const int64_t num = q00 * (change_dc ?
              (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
               3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
               13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25) :
              (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = estimate(num, q01, al);
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
          const int64_t num = q00 * (change_dc ?
              (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
               13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
               3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
              (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = estimate(num, q10, al);
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
          const int64_t num = q00 * (change_dc ?
              (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
               2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
              (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = estimate(num, q20, al);
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
          const int64_t num = q00 * (change_dc ?
              (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
              (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 - DC06 +
               10 * DC07 - 10 * DC09));
          ws[9] = estimate(num, q11, al);
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
          const int64_t num = q00 * (change_dc ?
              (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
               2 * DC17 - 5 * DC18 + 2 * DC19) :
              (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = estimate(num, q02, al);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0) {  // AC03
            ws[3] = estimate(q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), q03, al);
          }
          if ((al = bits[7]) != 0 && ws[10] == 0) {  // AC12
            ws[10] = estimate(q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), q12, al);
          }
          if ((al = bits[8]) != 0 && ws[17] == 0) {  // AC21
            ws[17] = estimate(q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), q21, al);
          }
          if ((al = bits[9]) != 0 && ws[24] == 0) {  // AC30
            ws[24] = estimate(q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), q30, al);
          }
          const int64_t num = q00 *
              (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
               42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
               8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 -
               6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          ws[0] = estimate(num, q00, 0);
        }
        idct_islow(ws, c.q, samples + static_cast<size_t>(row) * 8 * stride + col * 8, stride);
        for (int r = 0; r < 5; ++r) {
          for (int k = 0; k < 4; ++k) dcv[r][k] = dcv[r][k + 1];
        }
      }
    }
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
    fail(kCorrupt, "JPEG with fractional sampling ratios (libjpeg does not upsample them)");
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

// jpeg_read_header and the checks up to the pixels: OpenCV asks for BGR (or
// CMYK from 4 components) or gray, which libjpeg cannot give from another
// number of components
ColorSpace read_header(Decoder& dec) {
  dec.read_header();
  const ColorSpace cs = guess_color(dec);
  if (cs == kUnknown) {
    fail(kCorrupt, "JPEG with " + std::to_string(dec.comps.size()) +
                       " components (libjpeg converts 1, 3 or 4 only)");
  }
  return cs;
}

// The first `needed` components' samples at full size, each (height,
// width): the scans decoded, each block's inverse DCT (smoothed where a
// progressive file leaves coefficients incomplete), then upsampled.
std::vector<std::vector<uint8_t>> component_planes(Decoder& dec, size_t needed) {
  dec.consume();
  std::vector<int> latch, prev_latch;
  const bool smooth = smoothing_ok(dec, latch, prev_latch);
  const int w = dec.width, h = dec.height;
  std::vector<std::vector<uint8_t>> planes(needed);
  for (size_t ci = 0; ci < needed; ++ci) {
    Component& c = dec.comps[ci];
    if (c.coef.empty()) c.coef.assign(Decoder::coef_size(c), 0);  // no scan reached it: flat
    const size_t stride = static_cast<size_t>(c.bw) * 8;
    std::vector<uint8_t> samples(stride * c.bh * 8);
    if (smooth) {
      smooth_component(dec, c, &latch[ci * kSavedCoefs], &prev_latch[ci * kSavedCoefs], samples.data(), stride);
    } else {
      for (int by = 0; by < c.hib; ++by) {
        for (int bx = 0; bx < c.wib; ++bx) {
          idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.q,
                     &samples[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
        }
      }
    }
    planes[ci] = upsample(c, samples.data(), stride, dec.hmax, dec.vmax, w, h);
  }
  return planes;
}

void decode(const uint8_t* data, size_t size, bool gray, uint8_t* out) {
  Decoder dec(data, size);
  const ColorSpace cs = read_header(dec);
  // the components the output needs: Y alone for gray from gray or YCbCr
  const size_t needed = gray && (cs == kGray || cs == kYCbCr) ? 1 : dec.comps.size();
  const std::vector<std::vector<uint8_t>> planes = component_planes(dec, needed);
  const size_t npix = static_cast<size_t>(dec.width) * dec.height;
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

// A strip or tile of a JPEG-compressed TIFF as libtiff's JPEG codec asks
// libjpeg for it: YCbCr converted to RGB where `ycbcr` (JPEGCOLORMODE_RGB,
// whatever the markers say), else the components as they are (libtiff sets
// the colour spaces to JCS_UNKNOWN); samples in component order, (height,
// width, components).
void decode_tiff(const uint8_t* data, size_t size, bool ycbcr, uint8_t* out) {
  Decoder dec(data, size);
  dec.read_header();
  const size_t nc = dec.comps.size();
  if (ycbcr && nc != 3) fail(kCorrupt, "a YCbCr JPEG strip of " + std::to_string(nc) + " components");
  const std::vector<std::vector<uint8_t>> planes = component_planes(dec, nc);
  const size_t npix = static_cast<size_t>(dec.width) * dec.height;
  static const YccTables t;
  if (ycbcr) {  // into BGR, then R and B swapped into component order
    ycc_to_bgr(planes[0].data(), planes[1].data(), planes[2].data(), out, npix, t);
    for (size_t i = 0; i < npix; ++i) std::swap(out[3 * i], out[3 * i + 2]);
    return;
  }
  for (size_t i = 0; i < npix; ++i)
    for (size_t ci = 0; ci < nc; ++ci) out[nc * i + ci] = planes[ci][i];
}

// The decoder's quantization tables (16-bit, in zigzag order) and Huffman
// tables as they were defined, as DQT and DHT segments: the bytes written.
size_t write_tables(const Decoder& dec, uint8_t* out) {
  uint8_t* o = out;
  auto u16 = [&o](int v) {
    *o++ = static_cast<uint8_t>(v >> 8);
    *o++ = static_cast<uint8_t>(v);
  };
  for (int t = 0; t < 4; ++t) {
    if (!dec.qdef[t]) continue;
    *o++ = 0xFF;
    *o++ = 0xDB;
    u16(2 + 1 + 128);
    *o++ = static_cast<uint8_t>(0x10 | t);
    for (int i = 0; i < 64; ++i) u16(dec.qt[t][kNatural[i]]);
  }
  for (int ac = 0; ac < 2; ++ac) {
    for (int slot = 0; slot < 4; ++slot) {
      const RawTable& t = ac ? dec.ac_raw[slot] : dec.dc_raw[slot];
      if (!t.defined) continue;
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += t.bits[l];
      *o++ = 0xFF;
      *o++ = 0xC4;
      u16(2 + 1 + 16 + count);
      *o++ = static_cast<uint8_t>((ac << 4) | slot);
      std::memcpy(o, t.bits + 1, 16);
      std::memcpy(o + 16, t.vals, static_cast<size_t>(count));
      o += 16 + count;
    }
  }
  return static_cast<size_t>(o - out);
}

int report(const Error& e, char* err, int errlen) {
  if (err != nullptr && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

// info: width, height, components, EXIF orientation (1-8 as stored; 1 when
// absent), then the first four components' horizontal and vertical sampling
// factors (4 + 2 x 4 values, unused ones 0). Returns 0, or 1 (a kind not
// read) / 2 (cv2.imread returns None) with a message in err.
extern "C" int frn_jpeg_info(const uint8_t* data, int64_t size, int32_t* info, char* err, int errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(size));
    read_header(dec);
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = static_cast<int32_t>(dec.comps.size());
    info[3] = dec.orientation;
    for (size_t i = 0; i < 4; ++i) {
      info[4 + 2 * i] = i < dec.comps.size() ? dec.comps[i].h : 0;
      info[5 + 2 * i] = i < dec.comps.size() ? dec.comps[i].v : 0;
    }
    return kOk;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Error{kUnsupported, "JPEG too large to decode in memory"}, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kUnsupported, std::string("JPEG not decoded: ") + e.what()}, err, errlen);
  }
}

// The quantization and Huffman tables a decompressor holds after reading the
// markers from SOI to the first SOS or EOI (libjpeg keeps them from one
// stream to the next), as DQT and DHT segments into out, each defined slot
// once: at most 4 x 133 + 8 x 277 = 2,748 bytes. info: the bytes written, the marker that ended
// the read (0xDA or 0xD9). Same return codes.
extern "C" int frn_jpeg_tables(const uint8_t* data, int64_t size, uint8_t* out, int32_t* info, char* err,
                               int errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(size));
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail(kCorrupt, "not a JPEG stream (no SOI marker)");
    dec.in.pos = 2;
    info[1] = dec.read_markers();
    info[0] = static_cast<int32_t>(write_tables(dec, out));
    return kOk;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kUnsupported, std::string("JPEG not decoded: ") + e.what()}, err, errlen);
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
    return report(Error{kUnsupported, "JPEG too large to decode in memory"}, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kUnsupported, std::string("JPEG not decoded: ") + e.what()}, err, errlen);
  }
}

// A JPEG-in-TIFF strip or tile (the JPEGTables stream spliced in front) into
// out: (height, width, components), YCbCr converted to RGB where ycbcr != 0.
// Same return codes.
extern "C" int frn_jpeg_decode_tiff(const uint8_t* data, int64_t size, int ycbcr, uint8_t* out, char* err,
                                    int errlen) {
  try {
    decode_tiff(data, static_cast<size_t>(size), ycbcr != 0, out);
    return kOk;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Error{kUnsupported, "JPEG too large to decode in memory"}, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kUnsupported, std::string("JPEG not decoded: ") + e.what()}, err, errlen);
  }
}

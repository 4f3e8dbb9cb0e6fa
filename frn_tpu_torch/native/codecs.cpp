// Run-length and LZW decoding for the port's image reader
// (frn_tpu_torch/data/image_io.py), the parts of OpenCV's own BMP, Radiance
// HDR and GIF decoders that are not plain rows of samples. Each function
// gives what the matching part of cv2.imread gives, bit for bit, or
// kCorrupt where cv2.imread returns None:
//  - frn_bmp_rle: BI_RLE8 and BI_RLE4 as grfmt_bmp.cpp decodes them into
//    palette indices: encoded runs and absolute runs (neither may cross the
//    end of a row), the end-of-line, delta and end-of-bitmap escapes, every
//    pixel they skip set to index 0; an RLE8 run that ends a row moves to
//    the next row at once, and an end-of-line right after it is then
//    ignored; in RLE4 every escape moves by the rest of the row, or by a
//    delta's dx alone (OpenCV computes the full move and passes the other
//    one on); the image ends when its last row is passed, and a stream
//    that ends before it, or a run past a row's end, is kCorrupt;
//  - frn_hdr_pixels: the scanlines of rgbe.cpp's RGBE_ReadPixels_RLE, flat or
//    new-style run-length (the first scanline that is not run-length ends
//    the run-length reading, the rest is read flat), each pixel mantissa *
//    2^(exponent - 136) as a float in BGR order;
//  - frn_gif_lzw: a frame's LZW data as grfmt_gif.cpp decodes it: minimum
//    code sizes 2-11 bits (an index keeps its low 8 bits), the table grown
//    one code ahead of the standard decoder's, code width capped at 12 bits
//    (a full table keeps its entries), a clear code and an end code each
//    restarting the table, an end code ending the codes of the data byte it
//    is in; the frame must get exactly its pixel count, and a code after the
//    frame is full is allowed only in the last data byte, followed by the
//    block terminator.
// The file is read as OpenCV reads it: running out of bytes is kCorrupt.
//
// Plain C ABI, bound by ctypes; built by frn_tpu_torch/utils/native.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

enum { kOk = 0, kCorrupt = 2 };

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

struct Reader {
  const uint8_t* data;
  int64_t size;
  int64_t pos;

  int byte() {
    if (pos >= size) fail("the file ends inside its image data");
    return data[pos++];
  }
  void bytes(uint8_t* dst, int64_t n) {
    if (n > size - pos) fail("the file ends inside its image data");
    std::memcpy(dst, data + pos, static_cast<size_t>(n));
    pos += n;
  }
};

int report(const std::string& msg, char* err, int errlen) {
  if (errlen > 0) {
    std::strncpy(err, msg.c_str(), static_cast<size_t>(errlen) - 1);
    err[errlen - 1] = 0;
  }
  return kCorrupt;
}

// ------------------------------------------------------------------ BMP RLE

// FillUniColor: `count` pixels of value v from `at`, wrapping to the next row
// at each row's end; stops when the last row is passed.
int64_t fill_uni(uint8_t* out, int64_t at, int64_t& line_end, int64_t width, int& y, int height,
                 int64_t count, uint8_t v) {
  do {
    int64_t end = at + count;
    if (end > line_end) end = line_end;
    count -= end - at;
    for (; at < end; ++at) out[at] = v;
    if (at >= line_end) {
      line_end += width;
      at = line_end - width;
      if (++y >= height) break;
    }
  } while (count > 0);
  return at;
}

// Rows in file order (the first decoded row first); false where OpenCV's
// decoder gives up on a run that crosses a row's end.
bool bmp_rle8(Reader& in, uint8_t* out, int64_t width, int height) {
  int64_t at = 0, line_end = width;
  int y = 0, line_end_flag = 0;
  uint8_t src[256];
  for (;;) {
    int len = in.byte();
    int code = in.byte();
    if (len != 0) {  // encoded run
      int prev_y = y;
      if (at + len > line_end) return false;
      at = fill_uni(out, at, line_end, width, y, height, len, static_cast<uint8_t>(code));
      line_end_flag = y - prev_y;
      if (y >= height) break;
    } else if (code > 2) {  // absolute run
      if (at + code > line_end) return false;
      in.bytes(src, (code + 1) & ~1);
      std::memcpy(out + at, src, static_cast<size_t>(code));
      at += code;
      line_end_flag = 0;
    } else {  // 0: end of line, 1: end of bitmap, 2: delta
      int64_t x_shift = line_end - at;
      int64_t y_shift = height - y;
      if (code || !line_end_flag || x_shift < width) {
        if (code == 2) {
          x_shift = in.byte();
          y_shift = in.byte();
        }
        if (code != 0) x_shift += y_shift * width;
        if (y >= height) break;
        at = fill_uni(out, at, line_end, width, y, height, x_shift, 0);
        if (y >= height) break;
      }
      line_end_flag = 0;
      if (y >= height) break;
    }
  }
  return true;
}

bool bmp_rle4(Reader& in, uint8_t* out, int64_t width, int height) {
  int64_t at = 0, line_end = width;
  int y = 0;
  uint8_t src[256];
  for (;;) {
    int len = in.byte();
    int code = in.byte();
    if (len != 0) {  // encoded run: two indices in turn
      uint8_t pair[2] = {static_cast<uint8_t>(code >> 4), static_cast<uint8_t>(code & 15)};
      int64_t end = at + len;
      if (end > line_end) return false;
      int t = 0;
      do {
        out[at] = pair[t];
        t ^= 1;
      } while (++at < end);
    } else if (code > 2) {  // absolute run of `code` indices, high nibble first
      if (at + code > line_end) return false;
      in.bytes(src, (((code + 1) >> 1) + 1) & ~1);
      for (int i = 0; i < code; ++i) out[at + i] = (i & 1) ? (src[i >> 1] & 15) : (src[i >> 1] >> 4);
      at += code;
    } else {  // OpenCV moves by the rest of the row (0, 1) or by dx (2), dy unread
      int64_t x_shift = line_end - at;
      if (code == 2) {
        x_shift = in.byte();
        in.byte();
      }
      at = fill_uni(out, at, line_end, width, y, height, x_shift, 0);
      if (y >= height) break;
    }
  }
  return true;
}

// ------------------------------------------------------------------ HDR

void rgbe_to_bgr(const uint8_t* rgbe, float* bgr) {
  if (rgbe[3]) {
    float f = static_cast<float>(std::ldexp(1.0, rgbe[3] - (128 + 8)));
    bgr[2] = rgbe[0] * f;
    bgr[1] = rgbe[1] * f;
    bgr[0] = rgbe[2] * f;
  } else {
    bgr[0] = bgr[1] = bgr[2] = 0.0f;
  }
}

void hdr_flat(Reader& in, float* out, int64_t pixels) {
  uint8_t rgbe[4];
  for (int64_t i = 0; i < pixels; ++i) {
    in.bytes(rgbe, 4);
    rgbe_to_bgr(rgbe, out + 3 * i);
  }
}

void hdr_pixels(Reader& in, float* out, int width, int height) {
  if (width < 8 || width > 0x7fff) return hdr_flat(in, out, int64_t{width} * height);
  std::vector<uint8_t> line(4 * static_cast<size_t>(width));
  for (int remaining = height; remaining > 0; --remaining) {
    uint8_t rgbe[4];
    in.bytes(rgbe, 4);
    if (rgbe[0] != 2 || rgbe[1] != 2 || (rgbe[2] & 0x80)) {  // not run-length: flat from here
      rgbe_to_bgr(rgbe, out);
      return hdr_flat(in, out + 3, int64_t{width} * remaining - 1);
    }
    if ((rgbe[2] << 8 | rgbe[3]) != width) fail("wrong scanline width");
    for (int c = 0; c < 4; ++c) {
      uint8_t* ptr = line.data() + static_cast<size_t>(c) * width;
      uint8_t* end = ptr + width;
      while (ptr < end) {
        int n = in.byte();
        int value = in.byte();
        if (n > 128) {  // a run of one value
          n -= 128;
          if (n > end - ptr) fail("bad scanline data");
          std::memset(ptr, value, static_cast<size_t>(n));
          ptr += n;
        } else {  // n literal values
          if (n == 0 || n > end - ptr) fail("bad scanline data");
          *ptr++ = static_cast<uint8_t>(value);
          in.bytes(ptr, n - 1);
          ptr += n - 1;
        }
      }
    }
    for (int x = 0; x < width; ++x) {
      const uint8_t pixel[4] = {line[x], line[x + width], line[x + 2 * width], line[x + 3 * width]};
      rgbe_to_bgr(pixel, out + 3 * x);
    }
    out += 3 * static_cast<int64_t>(width);
  }
}

// ------------------------------------------------------------------ GIF LZW

// An entry is the string of `prev` (a code) followed by `last`; codes below
// the clear code are single indices (prev -1, last the index itself).
struct Entry {
  int32_t prev;
  uint8_t first;
  uint8_t last;
  int32_t length;
};

void gif_lzw(Reader& in, uint8_t* out, int64_t n) {
  const int min_size = in.byte();
  int size = min_size + 1;
  if (size <= 2 || size > 12) fail("LZW minimum code size " + std::to_string(min_size));
  const int clear = 1 << min_size, end_code = clear + 1;
  // codes have at most 12 bits: entries past 4096 are never read, and a full
  // table keeps its entries while the decoder counts on
  const int kTable = 4097;
  std::vector<Entry> table(kTable + 1);
  for (int c = 0; c < clear; ++c) table[c] = Entry{-1, static_cast<uint8_t>(c), static_cast<uint8_t>(c), 1};
  int tsize = end_code;  // the entry begun by the previous code
  int64_t idx = 0;
  int left = 0;
  uint32_t src = 0;
  int block = in.byte();
  while (block) {
    if (left < size) {
      src |= static_cast<uint32_t>(in.byte()) << left;
      --block;
      left += 8;
    }
    while (left >= size) {
      const int code = static_cast<int>(src & ((1u << size) - 1));
      src >>= size;
      left -= size;
      if (code == clear) {
        size = min_size + 1;
        tsize = end_code;
        continue;
      }
      if (code == end_code) {  // restarts the table and ends this byte's codes
        size = min_size + 1;
        tsize = end_code;
        break;
      }
      if (idx == n) {  // a code after the frame is full
        if (block == 0 && in.byte() == 0) return;
        fail("LZW data past the end of the frame");
      }
      if (code > tsize) fail("LZW code " + std::to_string(code) + " past the table");
      // the entry begun by the previous code ends with this code's first
      // index; this code begins the next one
      if (tsize <= kTable) table[tsize].last = table[code].first;
      ++tsize;
      if (tsize <= kTable) table[tsize] = Entry{code, table[code].first, 0, table[code].length + 1};
      const int64_t len = table[code].length;
      if (len > n - idx) fail("LZW string past the end of the frame");
      int e = code;
      for (int64_t at = idx + len - 1; at >= idx; --at) {
        out[at] = table[e].last;
        e = table[e].prev;
      }
      idx += len;
      if (tsize == (1 << size) && size < 12) ++size;
    }
    if (block == 0) block = in.byte();
  }
  if (idx != n) fail("LZW data ends before the frame is full");
}

}  // namespace

// BI_RLE8 (bits 8) or BI_RLE4 (bits 4) pixel data at `offset` -> (height,
// width) palette indices in file row order. kCorrupt where cv2.imread gives
// None.
extern "C" int frn_bmp_rle(const uint8_t* data, int64_t size, int64_t offset, int32_t width,
                           int32_t height, int32_t bits, uint8_t* out, char* err, int errlen) {
  try {
    Reader in{data, size, offset};
    bool ok = bits == 8 ? bmp_rle8(in, out, width, height) : bmp_rle4(in, out, width, height);
    return ok ? kOk : report("an RLE run crosses the end of a row", err, errlen);
  } catch (const Error& e) {
    return report(e.msg, err, errlen);
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

// The scanlines at `offset` -> (height, width, 3) floats, BGR.
extern "C" int frn_hdr_pixels(const uint8_t* data, int64_t size, int64_t offset, int32_t width,
                              int32_t height, float* out, char* err, int errlen) {
  try {
    Reader in{data, size, offset};
    hdr_pixels(in, out, width, height);
    return kOk;
  } catch (const Error& e) {
    return report(e.msg, err, errlen);
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

// The LZW minimum code size byte at `offset` and the data sub-blocks after it
// -> n colour indices in the frame's row order (interlaced rows as stored).
extern "C" int frn_gif_lzw(const uint8_t* data, int64_t size, int64_t offset, int64_t n, uint8_t* out,
                           char* err, int errlen) {
  try {
    Reader in{data, size, offset};
    gif_lzw(in, out, n);
    return kOk;
  } catch (const Error& e) {
    return report(e.msg, err, errlen);
  } catch (const std::exception& e) {
    return report(e.what(), err, errlen);
  }
}

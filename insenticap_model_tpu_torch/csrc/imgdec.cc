// Host image decoding for the serving surface: baseline, extended-
// sequential and progressive Huffman JPEG, PNG's row filters, GIF's LZW,
// BMP's RLE8 and RLE4, WebP's lossless (VP8L) bitstream and its lossy
// (VP8) key frame, TIFF's PackBits, LZW, JPEG and CCITT fax codings.
//
// The JAX package decodes with PIL (insenticap_model_tpu/preprocessing.py:
// 50-80); the machine that serves the port has no PIL, so the port decodes
// itself. The target is the pixels PIL gives, bit for bit: PIL decodes
// JPEG with libjpeg(-turbo)'s defaults, so this file follows libjpeg's
// integer paths exactly:
//
//  * entropy decoding: Huffman (DHT tables of any kind, derived at the
//    scan that uses them; libjpeg-turbo's standard tables for an undefined
//    table 0 or 1), DRI and RSTn restart markers (a wrong one resynced as
//    jpeg_resync_to_restart does), interleaved and single-component scans
//    of 1, 3 or 4 components, any number of scans of SOF0, SOF1 or SOF2 at
//    8 bits. Progressive scans (T.81 Annex G, libjpeg-turbo's jdphuff.c)
//    are DC first and refinement, AC first (a band Ss..Se, EOB runs) and
//    AC refinement, into whole-image coefficient arrays; their parameters
//    are checked as libjpeg's start_pass_phuff_decoder checks them (what it
//    refuses is refused, what it only warns of is decoded, as are a
//    sequential scan's Ss, Se, Ah and Al and a run past coefficient 63);
//  * block smoothing: a progressive file that ends with some of AC
//    coefficients 1-9 still inexact (an incomplete progression) is
//    decoded as libjpeg-turbo 2.1+'s decompress_smooth_data does it;
//  * IDCT: jpeg_idct_islow (jidctint.c; CONST_BITS 13, PASS1_BITS 2) as
//    libjpeg-turbo's x86 SIMD code computes it (16-bit wraps and
//    saturation, which part from the C code's range limit only for
//    coefficients past 16 bits);
//  * upsampling: libjpeg-turbo's "fancy" upsampling, which PIL leaves on
//    (and which turns merged upsampling off): h2v1 and h2v2 triangle
//    filters where the component's downsampled width exceeds 2, h1v2 always,
//    plain replication otherwise and for any other integral ratio
//    (int_upsample). Edges replicate at the component's downsampled width
//    and height, ceil(size * h / hmax);
//  * colour: the colour space libjpeg's default_decompress_parms
//    (jdapimin.c) takes from the markers and component ids, then what PIL
//    asks for. Grey stays grey. Three components are YCbCr, converted by
//    jdcolor.c's fixed-point tables (SCALEBITS 16, range-limited), or RGB,
//    left as they are (an Adobe marker with transform 0, or ids 'R' 'G'
//    'B', and no JFIF marker). Four are CMYK (no Adobe marker, or
//    transform 0) or YCCK (any other transform: ycck_cmyk_convert, the
//    same tables, 255 minus each, K passed through); PIL reads them as
//    "CMYK;I" (inverted) and converts to RGB with its cmyk2rgb.
//
// Refused, with a message that names what: lossless, hierarchical and
// arithmetic-coded JPEG, precision other than 8 bits, 2 or more than 4
// components. Entropy-coded data that meets a marker before its scan's
// blocks are decoded is read as libjpeg-turbo reads it (zero bits for the
// MCU where the bits end, no later MCU of the scan decoded); a file that
// ends early is refused as truncated, as PIL refuses it; a Huffman code
// that no table holds is refused by name (libjpeg warns and goes on with
// zeros).
//
// PNG: the Python side (preprocessing.py) parses the chunks, checks their
// CRCs, inflates IDAT with zlib and scatters Adam7's passes;
// isc_png_unfilter undoes the five row filters of an image or a pass,
// which run sequentially along a row (Sub, Paeth).
//
// GIF and BMP: the Python side parses the headers as Pillow's
// GifImagePlugin and BmpImagePlugin do; the two coders that run a pixel at
// a time live here. isc_gif_lzw is Pillow's GIF decoder (GifDecode.c) over
// the whole image data at once: the same table, code widths and sub-block
// framing, so that a stream Pillow decodes gives the same indices and a
// stream it cannot finish is refused. isc_bmp_rle is Pillow's BMP RLE
// decoder (BmpRleDecoder), quirks included.
//
// TIFF: the Python side reads the header, the first IFD and the strips
// or tiles as Pillow's TiffImagePlugin (and, for the compressed ones,
// libtiff) reads them, and undoes libtiff's predictors; isc_tiff_packbits
// decodes a PackBits strip or tile as libtiff's PackBitsDecode does,
// isc_tiff_lzw an LZW one as its LZWDecode (or, for old-style codes,
// LZWDecodeCompat) does, and isc_tiff_jpeg a JPEG (7) one as libtiff
// 4.7's JPEGPreDecode and JPEGDecode have libjpeg-turbo decode it for PIL
// (isc_tiff_jpeg_tables reads the page's JPEGTables). That reuses the
// JPEG decoder above in a mode of its own (Jpeg::tiff) for what libtiff's
// driver changes: the tables carried from strip to strip; YCbCr converted
// to RGB only where the caller asks (libtiff's JPEGCOLORMODE_RGB), every
// other page's components handed over as stored (JCS_UNKNOWN); a fake EOI
// past the strip's bytes, so that a strip that ends early decodes, where a
// file PIL reads itself is refused; libjpeg's own marker loop; a single scan
// decoded only as far as the rows read, and what libjpeg reads after it
// unable to fail the strip; libtiff's checks of the frame against the
// segment and the page. A bad Huffman code stays refused, by name.
// isc_tiff_inflate inflates a zlib stream as zlib's inflate does for
// libtiff's ZIPDecode, for the bytes it writes before a fault, which
// Python's zlib does not hand over (PIL's YCbCr pages, read through
// libtiff's RGBA interface, keep them). isc_tiff_fax decodes a CCITT
// strip or tile (RLE, RLEW, Group 3 one- and two-dimensional, Group 4) as
// libtiff 4.7's tif_fax3.c does for PIL, bit for bit on damaged data too:
// a bad code word or a row of the wrong length ends the row (padded white
// or clipped) and decoding goes on; Group 3 data that ends while an EOL
// is sought is read again without EOLs; a Group 4 strip may end early;
// the run arrays and that mode pass from strip to strip.
//
// WebP: the Python side walks the RIFF container as libwebp's demuxer
// does; isc_vp8l_decode decodes a VP8L chunk's bitstream (RFC 9649) to RGB,
// isc_vp8_decode a VP8 chunk's key frame (RFC 6386), and
// isc_vp8l_alpha_check an ALPH chunk's VP8L stream as far as libwebp
// refuses it.
//
// C interface (ctypes): every entry returns 0, or non-zero with a
// NUL-terminated message in err[errlen].
#include <limits.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <algorithm>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Error{m}; }

// zigzag index -> natural (row-major) index, with 16 extra entries of 63
// as libjpeg's jpeg_natural_order has for corrupt data
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  uint8_t vals[256] = {};
  int maxcode[18] = {};
  int valoffset[18] = {};
  // the first 9 bits of a code: its length (0: longer) and symbol
  uint8_t look_len[512] = {};
  uint8_t look_sym[512] = {};
};

// jdhuff.c's jpeg_make_d_derived_tbl: canonical codes, checked
void make_huff(Huff& t, const uint8_t counts[17], const uint8_t* vals,
               int nvals, bool dc) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = counts[l];
    if (p + n > 256) fail("JPEG: bad Huffman table (over 256 codes)");
    for (int i = 0; i < n; ++i) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  if (p != nvals) fail("JPEG: bad Huffman table (symbol count)");
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      ++code;
    }
    if (code >= (1 << si)) fail("JPEG: bad Huffman table (code overflow)");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l]) {
      t.valoffset[l] = p - huffcode[p];
      p += counts[l];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  memcpy(t.vals, vals, nvals);
  if (dc) {
    for (int i = 0; i < nvals; ++i)
      if (vals[i] > 15) fail("JPEG: bad DC Huffman table (symbol > 15)");
  }
  memset(t.look_len, 0, sizeof(t.look_len));
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 1; i <= counts[l]; ++i, ++p) {
      const int lookbits = huffcode[p] << (9 - l);
      for (int ctr = 1 << (9 - l); ctr > 0; --ctr) {
        t.look_len[lookbits + ctr - 1] = (uint8_t)l;
        t.look_sym[lookbits + ctr - 1] = vals[p];
      }
    }
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;            // allocated blocks (a whole number of MCUs)
  int dw = 0, dh = 0;            // downsampled size, ceil(size * h / hmax)
  bool latched = false;          // quantisation table fixed at first scan
  // natural order, as libjpeg's ISLOW_MULT_TYPE (short) holds it
  int16_t qt[64] = {};
  std::vector<int16_t> coef;     // [bh][bw][64], natural order
  bool seen = false;             // in some scan
  // progressive: the Al of each coefficient's last scan (zigzag order),
  // -1 before any; libjpeg's coef_bits; and (libjpeg-turbo 2.1's second
  // half of it) those before the component's latest scan, 0 where that
  // was the first scan of the stream
  int bits[64];
  int prev[64];
};

enum class Colour { kGrey, kYcc, kRgb, kCmyk, kYcck };

// The standard Huffman tables (T.81 Annex K.3) that libjpeg-turbo takes
// for an undefined table 0 or 1 (jstdhuff.c): counts a code length 1-16
// (index 0 unused), then the symbols
const uint8_t kStdDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1,
                                    0, 0, 0, 0, 0, 0, 0};
const uint8_t kStdDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1,
                                      1, 1, 0, 0, 0, 0, 0};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5,
                                    5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kStdAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7,
                                      5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kStdAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Jpeg {
  const uint8_t* d;
  size_t n, pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  bool sof = false, jfif = false, adobe = false, progressive = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qtab[4][64] = {};
  bool qdef[4] = {};
  Huff dc[4], ac[4];
  std::vector<Component> comp;
  int mcux = 0, mcuy = 0;
  int eobrun = 0;      // blocks left in a progressive scan's end-of-band run

  // entropy reader
  uint64_t bitbuf = 0;
  int bits = 0;        // bits in bitbuf (the top ones)
  int real = 0;        // of which come from the file (the rest: zeros)
  bool at_marker = false;
  int unread = 0;      // a marker taken from the data (libjpeg's
                       // unread_marker)
  bool hdef[8] = {};   // DC 0-3, AC 4-7: kept raw, derived at a scan's
  uint8_t hraw[8][17 + 256] = {};   // start

  // JPEG in TIFF (isc_tiff_jpeg): the stream as libtiff 4.7 has libjpeg
  // read it. Past its end the source hands over a fake EOI (FF D9) again
  // and again (pos counts on into them); a marker that ends entropy-coded
  // data is taken into ``unread``; the tables persist from stream to stream.
  bool tiff = false;
  bool insufficient = false;     // libjpeg's insufficient_data
  int last_good = 0;             // libjpeg's last_good_iMCU_row
  bool multi_scan = false;       // libjpeg's has_multiple_scans
  int scans = 0;
  // a single-scan stream: the MCU rows decoded for the rows read (-1: all),
  // and whether that leaves the scan unfinished (nothing after is read)
  long long mcu_rows = -1;
  bool stopped = false;
  // what libtiff checks the frame against (JPEGPreDecode) and the rows
  // JPEGDecode reads, set by the caller
  struct Segment {
    long long w = 0, h = 0, rows = 0;
    int comps = 0, hs = 1, vs = 1;
    bool cut_ok = false;
  } seg;

  Jpeg(const uint8_t* data, size_t len) : d(data), n(len) {}

  uint8_t byte() {
    if (pos >= n) {
      if (!tiff) fail("JPEG: truncated file");
      return (pos++ - n) % 2 ? 0xD9 : 0xFF;
    }
    return d[pos++];
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  // libtiff's skip_input_data: past the bytes left, a new fake EOI
  void skip(long long k) {
    if (k <= 0) return;
    if (pos < n) {
      pos = (long long)(n - pos) < k ? n : pos + (size_t)k;
    } else if ((pos - n) % 2) {
      ++pos;
    }
  }
  [[noreturn]] void unsupported(const std::string& what) const {
    fail(tiff ? "unsupported: TIFF JPEG " + what
              : "JPEG: unsupported: " + what);
  }

  int next_marker() {
    // markers start with 0xFF; fill bytes 0xFF may precede the code; FF 00
    // is data
    for (;;) {
      uint8_t b = byte();
      while (b != 0xFF) b = byte();   // libjpeg skips such data with a warning
      do {
        b = byte();
      } while (b == 0xFF);
      if (b) return b;
    }
  }

  void parse_sof(int marker) {
    const int len = word();
    const size_t end = pos + len - 2;
    if (sof) fail("JPEG: more than one frame header");
    sof = true;
    const int prec = byte();
    height = word();
    width = word();
    ncomp = byte();
    if (prec != 8 && tiff)      // JPEGPreDecode: not the page's 8 bits
      fail("TIFF: JPEG of " + std::to_string(prec) + "-bit samples in a "
           "page of 8");
    if (prec != 8)
      unsupported(std::to_string(prec) +
                  "-bit samples (only 8-bit baseline/extended sequential)");
    if (height == 0)
      unsupported("height 0 (DNL marker)");
    if (width == 0) fail("JPEG: width 0");
    // libjpeg: MAX_COMPONENTS and JPEG_MAX_DIMENSION; JCS_UNKNOWN takes
    // any count of components
    if (tiff ? ncomp < 1 || ncomp > 10
             : ncomp != 1 && ncomp != 3 && ncomp != 4)
      unsupported(std::to_string(ncomp) + " components");
    if (width > 65500 || height > 65500)
      fail("JPEG: a frame over 65500 samples wide or high");
    if ((size_t)len != 8 + 3 * (size_t)ncomp) fail("JPEG: bad SOF length");
    comp.resize(ncomp);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      // libjpeg checks the table number when it latches the table
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("JPEG: bad sampling factors or table in the frame header");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    progressive = marker == 0xC2;
    pos = end;
    if (tiff) check_segment();
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comp) {
      if (hmax % c.h || vmax % c.v)
        fail("JPEG: unsupported: fractional sampling ratio");
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((long long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long long)height * c.v + vmax - 1) / vmax);
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      std::fill(c.bits, c.bits + 64, -1);
      std::fill(c.prev, c.prev + 64, -1);
    }
  }

  // libtiff's JPEGPreDecode (its checks of the frame, which it makes at
  // the first scan, made here, before the coefficients are allocated):
  // the frame against the segment, the components and their sampling. A
  // frame past PIL's decompression-bomb limit is refused by name.
  void check_segment() const {
    const bool cut = seg.cut_ok && width == seg.w && height > seg.h;
    if (!cut && (width > seg.w || height > seg.h))
      fail("TIFF: JPEG strip or tile of " + std::to_string(width) + "x" +
           std::to_string(height) + " exceeds its " + std::to_string(seg.w) +
           "x" + std::to_string(seg.h));
    if (ncomp != seg.comps)
      fail("TIFF: JPEG of " + std::to_string(ncomp) + " components for " +
           std::to_string(seg.comps) + " samples");
    for (int ci = 0; ci < ncomp; ++ci)
      if (comp[ci].h != (ci ? 1 : seg.hs) || comp[ci].v != (ci ? 1 : seg.vs))
        fail("TIFF: improper JPEG sampling factors");
    if ((long long)width * height > 2LL * (1024 * 1024 * 1024 / 4 / 3))
      unsupported("frame of " + std::to_string(width) + "x" +
                  std::to_string(height) + " (past PIL's bomb limit)");
  }

  void parse_dqt() {
    const int len = word();
    const size_t end = pos + len - 2;
    while (pos < end) {
      const int pq_tq = byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("JPEG: bad quantisation table");
      for (int k = 0; k < 64; ++k)
        qtab[tq][kNatural[k]] = (uint16_t)(pq ? word() : byte());
      qdef[tq] = true;
    }
    if (pos != end) fail("JPEG: bad DQT length");
  }

  void parse_dht() {
    const int len = word();
    const size_t end = pos + len - 2;
    while (pos < end) {
      const int tc_th = byte();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("JPEG: bad Huffman table class or id");
      uint8_t counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) {
        counts[l] = byte();
        total += counts[l];
      }
      if (total > 256) fail("JPEG: bad Huffman table (over 256 codes)");
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) vals[i] = byte();
      uint8_t* raw = hraw[tc * 4 + th];   // derived at the scan's start
      memcpy(raw, counts, 17);
      memset(raw + 17, 0, 256);
      memcpy(raw + 17, vals, total);
      hdef[tc * 4 + th] = true;
    }
    if (pos != end) fail("JPEG: bad DHT length");
  }

  // a scan's Huffman table as jpeg_make_d_derived_tbl finds it: the one
  // defined, or libjpeg-turbo's standard table 0 or 1 (jstdhuff.c), which
  // then stays defined
  void derive(int tc, int th) {
    const int k = tc * 4 + th;
    if (!hdef[k]) {
      if (th > 1) fail("JPEG: scan uses an undefined Huffman table");
      const uint8_t* counts = tc ? (th ? kStdAcChromaBits : kStdAcLumaBits)
                                 : (th ? kStdDcChromaBits : kStdDcLumaBits);
      const uint8_t* vals = tc ? (th ? kStdAcChromaVals : kStdAcLumaVals)
                               : kStdDcVals;
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l];
      memcpy(hraw[k], counts, 17);
      memset(hraw[k] + 17, 0, 256);
      memcpy(hraw[k] + 17, vals, total);
      hdef[k] = true;
    }
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += hraw[k][l];
    make_huff(tc ? ac[th] : dc[th], hraw[k], hraw[k] + 17, total, tc == 0);
  }

  void parse_app(int marker) {
    const int len = word();
    if (len < 2) fail("JPEG: bad segment length");
    const size_t start = pos, end = pos + len - 2;
    if (end > n) fail("JPEG: truncated file");
    // jdmarker.c's examine_app0/app14: 14 and 12 bytes of data at least
    if (marker == 0xE0 && len - 2 >= 14 && memcmp(d + start, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && len >= 14 && memcmp(d + start, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[start + 11];
    }
    pos = end;
  }

  void skip_segment() {
    const int len = word();
    if (tiff) {                       // skip_variable: a length below 2 skips
      skip(len - 2);                  // nothing
      return;
    }
    if (len < 2) fail("JPEG: bad segment length");
    pos += len - 2;
    if (pos > n) fail("JPEG: truncated file");
  }

  // -- entropy-coded data ---------------------------------------------------

  void reset_bits() {
    bitbuf = 0;
    bits = real = 0;
    at_marker = false;
  }

  void fill() {
    if (tiff) {
      fill_tiff();
      return;
    }
    while (bits <= 56) {
      uint8_t b = 0;
      bool data = false;
      if (!at_marker && !unread && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          if (pos + 1 >= n) {
            at_marker = true;
          } else if (d[pos + 1] == 0x00) {
            pos += 2;
            data = true;
          } else if (d[pos + 1] == 0xFF) {
            ++pos;            // a fill byte before a marker
            continue;
          } else {
            at_marker = true;   // a marker: zeros from here on
          }
        } else {
          ++pos;
          data = true;
        }
      }
      if (!data) b = 0;
      bitbuf |= (uint64_t)b << (56 - bits);
      bits += 8;
      if (data) real += 8;
    }
  }

  // libjpeg's fill_bit_buffer: bytes up to a marker, which it takes
  // (unread), zeros after it
  void fill_tiff() {
    while (bits <= 56) {
      uint8_t b = 0;
      bool data = false;
      if (!unread) {
        b = byte();
        if (b == 0xFF) {
          do {
            b = byte();
          } while (b == 0xFF);
          if (b == 0) {
            b = 0xFF;
            data = true;
          } else {
            unread = b;
            b = 0;
          }
        } else {
          data = true;
        }
      }
      bitbuf |= (uint64_t)b << (56 - bits);
      bits += 8;
      if (data) real += 8;
    }
  }

  void consume(int k) {
    if (k > real) {
      // libjpeg-turbo decodes the MCU on with zero bits, and no MCU of the
      // scan after it (insufficient_data)
      insufficient = true;
      real = k;
    }
    bitbuf <<= k;
    bits -= k;
    real -= k;
  }

  int get_bits(int k) {
    if (k == 0) return 0;
    if (bits < k) fill();
    const int v = (int)(bitbuf >> (64 - k));
    consume(k);
    return v;
  }

  int decode(const Huff& t) {
    if (bits < 16) fill();
    const int look = (int)(bitbuf >> (64 - 9));
    int l = t.look_len[look];
    if (l) {
      consume(l);
      return t.look_sym[look];
    }
    l = 10;
    int code = (int)(bitbuf >> (64 - l));
    while (code > t.maxcode[l]) {
      ++l;
      if (l > 16) unsupported("bad Huffman code (libjpeg decodes it as a zero)");
      code = (int)(bitbuf >> (64 - l));
    }
    consume(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
  }

  // the DC predictor plus a difference, refused where it would leave int
  // (libjpeg's JERR_BAD_DCT_COEF)
  static void add_dc(int& pred, int s) {
    if ((pred >= 0 && s > INT_MAX - pred) || (pred < 0 && s < INT_MIN - pred))
      fail("JPEG: corrupt data (DC coefficient out of range)");
    pred += s;
  }

  void decode_block(int16_t* blk, const Huff& dct, const Huff& act,
                    int& pred) {
    int s = decode(dct);
    if (s) s = extend(get_bits(s), s);
    add_dc(pred, s);
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64; ++k) {
      int rs = decode(act);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;       // libjpeg writes a run past 63 to 63 (kNatural's spares)
        blk[kNatural[k]] = (int16_t)extend(get_bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // libjpeg's process_restart: read_restart_marker, and for another
  // marker than the one expected jpeg_resync_to_restart; data left after
  // the restart only where the marker was taken
  void restart(int& expected) {
    reset_bits();
    if (!unread) unread = next_marker();
    for (;;) {
      const int m = unread;
      const auto rst = [&](int k) { return m == 0xD0 + ((expected + k) & 7); };
      if (m == 0xD0 + expected) {
        unread = 0;
        break;
      }
      if (m < 0xC0 || rst(-1) || rst(-2)) {
        unread = next_marker();       // a prior restart: scan on
        continue;
      }
      if (m < 0xD0 || m > 0xD7 || rst(1) || rst(2)) break;   // left unread
      unread = 0;                     // too far off: dropped
      break;
    }
    expected = (expected + 1) & 7;
    if (!unread) insufficient = false;
  }

  // -- progressive scans: ITU T.81 Annex G, as libjpeg-turbo's jdphuff.c --
  // Coefficients keep their full scale: a first scan stores v << Al, a
  // refinement scan adds the bit 1 << Al. k runs to at most 63 + 15 on
  // corrupt data, inside kNatural's 16 spare entries.

  void dc_first(int16_t* blk, const Huff& t, int& pred, int al) {
    int s = decode(t);
    if (s) s = extend(get_bits(s), s);
    add_dc(pred, s);
    blk[0] = (int16_t)((unsigned)pred << al);
  }

  void dc_refine(int16_t* blk, int al) {
    if (get_bits(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  void ac_first(int16_t* blk, const Huff& t, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = decode(t);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)((unsigned)extend(get_bits(s), s) << al);
      } else if (r == 15) {
        k += 15;                       // ZRL
      } else {                         // EOBr: 2^r + r bits blocks
        eobrun = (1 << r) + get_bits(r) - 1;
        break;
      }
    }
  }

  // a correction bit for each coefficient that is already nonzero: 1 adds
  // 1 << Al to its magnitude
  void refine(int16_t& coef, int p1) {
    if (get_bits(1) && (coef & p1) == 0)
      coef = (int16_t)(coef >= 0 ? coef + p1 : coef - p1);
  }

  void ac_refine(int16_t* blk, const Huff& t, int ss, int se, int al) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = decode(t);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {                       // a new coefficient of +-1 << Al
          s = get_bits(1) ? p1 : -p1;
        } else if (r != 15) {
          eobrun = (1 << r) + get_bits(r);
          break;
        }
        // pass the nonzero coefficients (refining each) and r zero ones;
        // the new coefficient takes the zero after them
        do {
          int16_t& c = blk[kNatural[k]];
          if (c != 0) {
            refine(c, p1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& c = blk[kNatural[k]];
        if (c != 0) refine(c, p1);
      }
      --eobrun;
    }
  }

  // libjpeg's start_pass_phuff_decoder: a scan it refuses, refused
  void check_progression(int ns, int ss, int se, int ah, int al) const {
    bool bad = false;
    if (ss == 0) {
      bad = se != 0;
    } else {
      bad = ss > se || se > 63 || ns != 1;   // an AC scan: one component
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad)
      fail("JPEG: corrupt data (bad progressive scan: Ss " +
           std::to_string(ss) + ", Se " + std::to_string(se) + ", Ah " +
           std::to_string(ah) + ", Al " + std::to_string(al) + ")");
  }

  void parse_sos() {
    if (!sof) fail("JPEG: scan before frame header");
    const int len = word();
    const size_t end = pos + len - 2;
    const int ns = byte();
    if (ns < 1 || ns > 4 || (size_t)len != 6 + 2 * (size_t)ns)
      fail("JPEG: bad SOS");
    std::vector<int> sc(ns);
    std::vector<int> td(ns), ta(ns);
    for (int i = 0; i < ns; ++i) {
      const int cid = byte();
      const int t = byte();
      // libjpeg-turbo's get_sos: among the first four components, one
      // whose index is no slot of the scan taken yet (its index i on,
      // sic), and none twice
      int ci = -1;
      for (int j = i; j < ncomp && j < 4 && ci < 0; ++j)
        if (comp[j].id == cid) ci = j;
      for (int p = 0; p < i && ci >= 0; ++p)
        if (sc[p] == ci) ci = -1;
      if (ci < 0) fail("JPEG: scan names an unknown component");
      sc[i] = ci;
      td[i] = t >> 4;
      ta[i] = t & 15;
    }
    if (ns > 1) {
      int blocks = 0;
      for (int ci : sc) blocks += comp[ci].h * comp[ci].v;
      if (blocks > 10)   // libjpeg's D_MAX_BLOCKS_IN_MCU
        fail("JPEG: sampling factors too large for an interleaved scan");
    }
    const int ss = byte(), se = byte(), ahal = byte();
    const int ah = ahal >> 4, al = ahal & 15;
    ++scans;
    if (tiff) first_or_next_scan(ns);
    // libjpeg only warns of a sequential scan's Ss, Se, Ah and Al
    if (progressive) check_progression(ns, ss, se, ah, al);
    // the tables a scan reads: a DC refinement reads none
    const bool need_dc = !progressive || (ss == 0 && ah == 0);
    const bool need_ac = !progressive || ss != 0;
    pos = end;
    for (int ci : sc) {
      Component& c = comp[ci];
      if (!c.latched) {
        if (c.tq > 3 || !qdef[c.tq])
          fail("JPEG: undefined quantisation table");
        memcpy(c.qt, qtab[c.tq], sizeof(c.qt));
        c.latched = true;
      }
    }
    for (int i = 0; i < ns; ++i) {
      if ((need_dc && td[i] > 3) || (need_ac && ta[i] > 3))
        fail("JPEG: bad scan table ids");
      if (need_dc) derive(0, td[i]);
      if (need_ac) derive(1, ta[i]);
    }
    for (int ci : sc) {
      Component& c = comp[ci];
      c.seen = true;
      if (progressive) {
        for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
          c.prev[k] = scans > 1 ? c.bits[k] : 0;
        for (int k = ss; k <= se; ++k) c.bits[k] = al;
      }
    }

    reset_bits();
    insufficient = false;
    int preds[4] = {0, 0, 0, 0};
    int expected_rst = 0;
    int left = restart_interval;
    eobrun = 0;
    long long total;
    int bx, by;
    if (ns == 1) {
      const Component& c = comp[sc[0]];
      bx = (c.dw + 7) / 8;
      by = (c.dh + 7) / 8;
      total = (long long)bx * by;
    } else {
      bx = mcux;
      by = mcuy;
      total = (long long)mcux * mcuy;
    }
    // one block of component i of the scan
    auto block = [&](int i, int16_t* blk) {
      if (!progressive)
        decode_block(blk, dc[td[i]], ac[ta[i]], preds[i]);
      else if (ss == 0 && ah == 0)
        dc_first(blk, dc[td[i]], preds[i], al);
      else if (ss == 0)
        dc_refine(blk, al);
      else if (ah == 0)
        ac_first(blk, ac[ta[i]], ss, se, al);
      else
        ac_refine(blk, ac[ta[i]], ss, se, al);
    };
    // the rows read may end the scan early (a single scan in TIFF mode)
    const long long stop = mcu_rows >= 0 ? std::min(total, mcu_rows * bx)
                                         : total;
    for (long long m = 0; m < stop; ++m) {
      if (restart_interval) {
        if (left == 0) {
          restart(expected_rst);
          memset(preds, 0, sizeof(preds));
          eobrun = 0;
          left = restart_interval;
        }
        --left;
      }
      const int mx = (int)(m % bx), my = (int)(m / bx);
      if (insufficient) continue;      // libjpeg leaves the rest zero
      last_good = ns == 1 ? my / comp[sc[0]].v : my;
      if (ns == 1) {
        Component& c = comp[sc[0]];
        block(0, &c.coef[((size_t)my * c.bw + mx) * 64]);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = comp[sc[i]];
          for (int yy = 0; yy < c.v; ++yy)
            for (int xx = 0; xx < c.h; ++xx) {
              const size_t b =
                  (size_t)(my * c.v + yy) * c.bw + (mx * c.h + xx);
              block(i, &c.coef[b * 64]);
            }
        }
      }
    }
    if (stop < total) {
      stopped = true;
      return;
    }
    reset_bits();
  }

  // At a strip's first scan: jpeg_start_decompress's reading, a stream
  // of several scans read
  // whole (and refused at its 100th, libtiff's progress monitor), a
  // single scan only as far as the rows read need (JPEGDecode, the
  // upsampler's context rows included)
  void first_or_next_scan(int ns) {
    if (scans > 1) {
      if (!multi_scan) fail("JPEG: a second scan in a single-scan stream");
      if (scans >= 100)
        fail("TIFF: JPEG of 100 scans or more (libtiff's limit)");
      return;
    }
    multi_scan = progressive || ns < ncomp;
    const long long rows = std::min<long long>(seg.rows, height);
    if (multi_scan || rows >= height) return;
    const long long H = 8LL * vmax, last = rows - 1;
    bool context = false;
    for (const Component& c : comp) {
      const int hr = hmax / c.h, vr = vmax / c.v;
      if (vr == 2 && (hr == 1 || (hr == 2 && c.dw > 2))) context = true;
    }
    mcu_rows = last / H + 1;
    if (context && (last % H) / vmax == 7 && mcu_rows < mcuy) ++mcu_rows;
  }

  void parse(bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("JPEG: no SOI marker");
    pos = 2;
    for (;;) {
      const int m = unread ? unread : next_marker();
      unread = 0;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        parse_sof(m);
        if (header_only) return;
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        fail("JPEG: unsupported: lossless");
      } else if (m == 0xC5 || m == 0xC6) {
        fail("JPEG: unsupported: hierarchical");
      } else if (m == 0xC9 || m == 0xCA || m == 0xCE) {
        fail("JPEG: unsupported: arithmetic coding");
      } else if (m == 0xCC) {
        fail("JPEG: unsupported: arithmetic coding (DAC)");
      } else if (m == 0xC4) {
        parse_dht();
      } else if (m == 0xDB) {
        parse_dqt();
      } else if (m == 0xDD) {
        if (word() != 4) fail("JPEG: bad DRI length");
        restart_interval = word();
      } else if (m == 0xDA) {
        parse_sos();
      } else if (m == 0xD9) {
        break;
      } else if (m == 0xDC) {
        fail("JPEG: unsupported: DNL marker");
      } else if (m >= 0xE0 && m <= 0xEF) {
        parse_app(m);
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a stray restart marker: libjpeg ignores it
      } else if (m == 0xD8) {
        fail("JPEG: corrupt data (SOI inside the image)");
      } else {
        skip_segment();
      }
    }
    if (!sof) fail("JPEG: no frame header");
    for (const Component& c : comp)
      if (!c.seen) fail("JPEG: truncated file (a component has no scan)");
  }

  // libjpeg's read_markers as libtiff drives it: jpeg_read_header(FALSE)
  // of the JPEGTables field (``tables_only``: tables up to EOI, no frame),
  // or a strip's or tile's stream read as jpeg_read_header(TRUE),
  // jpeg_start_decompress and the rows JPEGDecode reads. After a single
  // scan whose rows were all read, jpeg_finish_decompress reads on to EOI,
  // its tables kept, but libtiff takes its failure for success. Markers
  // libjpeg refuses are refused; RSTn and TEM are passed over.
  void parse_tiff(bool tables_only) {
    if (byte() != 0xFF || byte() != 0xD8) fail("JPEG: no SOI marker");
    while (marker_tiff(tables_only)) {
      if (stopped) return;
      if (scans && !multi_scan) {
        try {
          while (marker_tiff(false)) {
          }
        } catch (const Error&) {
        }
        return;
      }
    }
    if (tables_only ? sof : !scans)
      fail(sof ? "JPEG: a frame header and no scan" : "JPEG: no image");
  }

  // one marker and its segment (and a scan's data); false at EOI
  bool marker_tiff(bool tables_only) {
    const int m = unread ? unread : next_marker();
    unread = 0;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      parse_sof(m);
    } else if (m == 0xC3 || m == 0xCB) {
      unsupported("lossless");
    } else if (m == 0xC9 || m == 0xCA) {
      unsupported("arithmetic coding");
    } else if (m == 0xCC) {                 // get_dac: checked, not used
      int len = word() - 2;
      while (len > 0) {
        const int index = byte(), val = byte();
        len -= 2;
        if (index >= 32 || (index >= 16 ? val < 1 || val > 63
                                        : (val & 15) > (val >> 4)))
          fail("JPEG: bad DAC");
      }
      if (len != 0) fail("JPEG: bad DAC length");
    } else if (m == 0xC4) {
      parse_dht();
    } else if (m == 0xDB) {
      parse_dqt();
    } else if (m == 0xDD) {
      if (word() != 4) fail("JPEG: bad DRI length");
      restart_interval = word();
    } else if (m == 0xDA) {
      if (tables_only) fail("TIFF: a scan in JPEGTables");
      parse_sos();
    } else if (m == 0xD9) {
      return false;
    } else if (m == 0xD8) {
      fail("JPEG: corrupt data (SOI inside the image)");
    } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
      skip_segment();
    } else if (!((m >= 0xD0 && m <= 0xD7) || m == 0x01)) {
      fail("JPEG: marker " + std::to_string(m) + " that libjpeg refuses");
    }
    return true;
  }

  // libjpeg's colour space of the file (jdapimin.c's
  // default_decompress_parms)
  Colour colour() const {
    if (ncomp == 1) return Colour::kGrey;
    if (ncomp == 4)
      return adobe && adobe_transform != 0 ? Colour::kYcck : Colour::kCmyk;
    if (jfif) return Colour::kYcc;
    if (adobe) return adobe_transform == 0 ? Colour::kRgb : Colour::kYcc;
    const bool rgb_ids =
        comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    return rgb_ids ? Colour::kRgb : Colour::kYcc;
  }
};

// -- IDCT: jpeg_idct_islow as libjpeg-turbo's SIMD code computes it ------

constexpr int kConstBits = 13, kPass1Bits = 2;

// jidctint.c's islow IDCT (CONST_BITS 13, PASS1_BITS 2) as libjpeg-
// turbo's SIMD code computes it on x86 (jidctint-sse2.asm,
// jidctint-avx2.asm), which PIL's libjpeg-turbo runs there: the C code's
// products, but the dequantised coefficients, in0 +- in4 and the odd
// part's in7 + in3 and in5 + in1 held in 16 bits (wrapping), each pass's
// results saturated to 16 bits, a block whose rows 1-7 are all zero
// taking DC x Q << 2 in 16 bits as its first pass, and the samples
// saturated to 0-255 where the C code's range limit wraps them. Where no
// value leaves 16 bits the C code gives the same numbers.
inline int16_t wrap16(int32_t v) { return (int16_t)(uint16_t)(uint32_t)v; }

inline int16_t sat16(int32_t v) {
  return (int16_t)(v > 32767 ? 32767 : (v < -32768 ? -32768 : v));
}

// One 1-D pass over x[0], x[xs], ..., x[7 xs] into o[0], o[os], ...: the
// products and sums in 32-bit lanes (wrapping), then add, shift, pack.
template <int kShift>
inline void idct_1d_simd(const int16_t* x, int xs, int16_t* o, int os) {
  using U = uint32_t;
  const U x1 = (U)x[xs], x2 = (U)x[2 * xs], x3 = (U)x[3 * xs],
          x5 = (U)x[5 * xs], x6 = (U)x[6 * xs], x7 = (U)x[7 * xs];
  const U tmp3 = x2 * 10703u + x6 * 4433u;
  const U tmp2 = x2 * 4433u - x6 * 10704u;
  const U tmp0 = (U)(int32_t)wrap16(x[0] + x[4 * xs]) << 13;
  const U tmp1 = (U)(int32_t)wrap16(x[0] - x[4 * xs]) << 13;
  const U t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
  const U t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  const U z3 = (U)(int32_t)wrap16((int)x[7 * xs] + x[3 * xs]);
  const U z4 = (U)(int32_t)wrap16((int)x[5 * xs] + x[xs]);
  const U Z3 = z4 * 9633u - z3 * 6436u, Z4 = z3 * 9633u + z4 * 6437u;
  const U a0 = Z3 - x7 * 4927u - x1 * 7373u;
  const U a3 = Z4 - x7 * 7373u + x1 * 4926u;
  const U a1 = Z4 - x5 * 4176u - x3 * 20995u;
  const U a2 = Z3 - x5 * 20995u + x3 * 4177u;
  const auto d = [](U v) {
    return sat16((int32_t)(v + (1u << (kShift - 1))) >> kShift);
  };
  o[0] = d(t10 + a3);
  o[7 * os] = d(t10 - a3);
  o[os] = d(t11 + a2);
  o[6 * os] = d(t11 - a2);
  o[2 * os] = d(t12 + a1);
  o[5 * os] = d(t12 - a1);
  o[3 * os] = d(t13 + a0);
  o[4 * os] = d(t13 - a0);
}

void idct_simd(const int16_t* in, const int16_t* q, uint8_t* out,
               int stride) {
  int16_t dq[64], ws[64], res[8];
  bool ac_rows = false;
  for (int k = 8; k < 64; ++k) ac_rows |= in[k] != 0;
  if (!ac_rows) {
    for (int c = 0; c < 8; ++c) {
      const int16_t dc = wrap16(wrap16((int32_t)in[c] * q[c]) * 4);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
    }
  } else {
    for (int k = 0; k < 64; ++k) dq[k] = wrap16((int32_t)in[k] * q[k]);
    for (int c = 0; c < 8; ++c) {
      bool ac = false;
      for (int r = 1; r < 8; ++r) ac |= in[r * 8 + c] != 0;
      if (ac) {
        idct_1d_simd<kConstBits - kPass1Bits>(dq + c, 8, ws + c, 8);
      } else {                  // the same pass on a lone DC: 4 x DC
        const int16_t v = sat16(4 * (int32_t)dq[c]);
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = v;
      }
    }
  }
  for (int r = 0; r < 8; ++r) {
    const int16_t* w = ws + r * 8;
    uint8_t* o = out + (size_t)r * stride;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      // the same pass on a lone DC: (DC + 16) >> 5
      const int v = (w[0] + 16) >> 5;
      memset(o, v < -128 ? 0 : (v > 127 ? 255 : v + 128), 8);
      continue;
    }
    idct_1d_simd<kConstBits + kPass1Bits + 3>(w, 1, res, 1);
    for (int c = 0; c < 8; ++c) {
      const int v = res[c] < -128 ? -128 : (res[c] > 127 ? 127 : res[c]);
      o[c] = (uint8_t)(v + 128);
    }
  }
}

// -- block smoothing: an incomplete progression ------------------------------
//
// A progressive file that ends with DC known and some of the first nine AC
// coefficients still inexact is decoded by libjpeg-turbo (2.1 and later)
// through jdcoefct.c's decompress_smooth_data: each such coefficient that is
// still zero is estimated from the DC values of the block's 5x5
// neighbourhood, and where no AC coefficient 1-9 has arrived at all, the
// DC is smoothed as well. This follows it term for term.

// natural positions of zigzag coefficients 0-9
const int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// libjpeg's smoothing_ok: progressive, every quantiser of coefficients
// 0-9 nonzero, every DC known, and some coefficient 1-9 inexact
bool smoothing_ok(const Jpeg& j) {
  if (!j.progressive) return false;
  bool useful = false;
  for (const Component& c : j.comp) {
    for (int q : kSmoothPos)
      if (c.qt[q] == 0) return false;
    if (c.bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.bits[k] != 0) useful = true;
  }
  return useful;
}

// The estimates for one block: dc[5 * row + col] is the DC of the block at
// (row - 2, col - 2) from it, as libjpeg's DC01..DC25; ws a copy of the
// block's coefficients.
void smooth_block(const Component& c, const int* bits, bool change_dc,
                  const int* dc, int16_t* ws) {
  auto D = [&](int i) -> long { return dc[i - 1]; };   // DC01 is D(1)
  const long q00 = (uint16_t)c.qt[0];
  auto estimate = [&](int zz, long num) {
    const int pos = kSmoothPos[zz], al = bits[zz];
    if (al == 0 || ws[pos] != 0) return;
    const long q = (uint16_t)c.qt[pos];
    num *= q00;
    int pred = (int)(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    ws[pos] = (int16_t)(num >= 0 ? pred : -pred);
  };
  estimate(1, change_dc
                  ? -D(1) - D(2) + D(4) + D(5) - 3 * D(6) + 13 * D(7) -
                        13 * D(9) + 3 * D(10) - 3 * D(11) + 38 * D(12) -
                        38 * D(14) + 3 * D(15) - 3 * D(16) + 13 * D(17) -
                        13 * D(19) + 3 * D(20) - D(21) - D(22) + D(24) +
                        D(25)
                  : -7 * D(11) + 50 * D(12) - 50 * D(14) + 7 * D(15));
  estimate(2, change_dc
                  ? -D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) - D(6) +
                        13 * D(7) + 38 * D(8) + 13 * D(9) - D(10) + D(16) -
                        13 * D(17) - 38 * D(18) - 13 * D(19) + D(20) +
                        D(21) + 3 * D(22) + 3 * D(23) + 3 * D(24) + D(25)
                  : -7 * D(3) + 50 * D(8) - 50 * D(18) + 7 * D(23));
  estimate(3, change_dc
                  ? D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) - 5 * D(12) -
                        14 * D(13) - 5 * D(14) + 2 * D(17) + 7 * D(18) +
                        2 * D(19) + D(23)
                  : -D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) - D(23));
  estimate(4, change_dc
                  ? -D(1) + D(5) + 9 * D(7) - 9 * D(9) - 9 * D(17) +
                        9 * D(19) + D(21) - D(25)
                  : D(10) + D(16) - 10 * D(17) + 10 * D(19) - D(2) - D(20) +
                        D(22) - D(24) + D(4) - D(6) + 10 * D(7) -
                        10 * D(9));
  estimate(5, change_dc
                  ? 2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) + 7 * D(12) -
                        14 * D(13) + 7 * D(14) + D(15) + 2 * D(17) -
                        5 * D(18) + 2 * D(19)
                  : -D(11) + 13 * D(12) - 24 * D(13) + 13 * D(14) - D(15));
  if (!change_dc) return;
  estimate(6, D(7) - D(9) + 2 * D(12) - 2 * D(14) + D(17) - D(19));
  estimate(7, D(7) - 3 * D(8) + D(9) - D(17) + 3 * D(18) - D(19));
  estimate(8, D(7) - D(9) - 3 * D(12) + 3 * D(14) + D(17) - D(19));
  estimate(9, D(7) + 2 * D(8) + D(9) - D(17) - 2 * D(18) - D(19));
  const long num =
      q00 * (-2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) - 2 * D(5) -
             6 * D(6) + 6 * D(7) + 42 * D(8) + 6 * D(9) - 6 * D(10) -
             8 * D(11) + 42 * D(12) + 152 * D(13) + 42 * D(14) - 8 * D(15) -
             6 * D(16) + 6 * D(17) + 42 * D(18) + 6 * D(19) - 6 * D(20) -
             2 * D(21) - 6 * D(22) - 8 * D(23) - 6 * D(24) - 2 * D(25));
  const int pred = (int)(((q00 << 7) + (num >= 0 ? num : -num)) / (q00 << 8));
  ws[0] = (int16_t)(num >= 0 ? pred : -pred);
}

// One component's IDCT plane [bh*8][bw*8] (stride bw*8): the block rows
// and columns that cover its downsampled size, smoothed where `smooth`.
// Which neighbour rows a block sees follows libjpeg's iMCU-row arithmetic,
// which in the last iMCU row of a component with v > 1 counts rows as if
// every iMCU row were as short as the last (it then clamps a row early);
// rows below the image in an iMCU row are read as their (dummy) blocks.
// Past iMCU row ``last_good`` (where a stream's data ran out) libjpeg-
// turbo smooths by the coefficients' Al before the last of ``scans``.
void idct_plane(const Component& c, int imcu_rows, bool smooth,
                uint8_t* plane, int last_good, int scans) {
  int prev[64];                       // smoothing_ok's latch of them
  for (int k = 0; k < 64; ++k) prev[k] = scans > 1 ? c.prev[k] : -1;
  const int stride = c.bw * 8;
  const int rows_b = (c.dh + 7) / 8, cols_b = (c.dw + 7) / 8;
  const auto dc_only = [](const int* bits) {
    bool only = true;
    for (int k = 1; k < 10; ++k) only = only && bits[k] == -1;
    return only;
  };
  const bool change_dc = dc_only(c.bits);
  const bool change_dc_prev = dc_only(prev);
  int16_t ws[64];
  int dc[25];
  auto dc_at = [&](int row, int col) -> int {
    row = std::min(row, c.bh - 1);
    col = col < 0 ? 0 : (col >= cols_b ? cols_b - 1 : col);
    return c.coef[((size_t)row * c.bw + col) * 64];
  };
  for (int by = 0; by < rows_b; ++by) {
    int rows[5];
    if (smooth) {
      const int r = by / c.v;
      int block_rows = c.v;
      if (r == imcu_rows - 1 && rows_b % c.v) block_rows = rows_b % c.v;
      const int i = r * block_rows + by % c.v, n = block_rows * imcu_rows;
      rows[2] = by;
      rows[1] = i > 0 ? by - 1 : by;
      rows[0] = i > 1 ? by - 2 : rows[1];
      rows[3] = i < n - 1 ? by + 1 : by;
      rows[4] = i < n - 2 ? by + 2 : rows[3];
    }
    for (int bx = 0; bx < cols_b; ++bx) {
      const int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
      if (smooth) {
        memcpy(ws, blk, sizeof(ws));
        for (int y = 0; y < 5; ++y)
          for (int x = 0; x < 5; ++x)
            dc[5 * y + x] = dc_at(rows[y], bx + x - 2);
        if (by / c.v > last_good)
          smooth_block(c, prev, change_dc_prev, dc, ws);
        else
          smooth_block(c, c.bits, change_dc, dc, ws);
        blk = ws;
      }
      uint8_t* dst = &plane[(size_t)by * 8 * stride + bx * 8];
      idct_simd(blk, c.qt, dst, stride);
    }
  }
}

// -- upsampling -------------------------------------------------------------

// One component's samples at full size [H][W], from its IDCT plane
// [bh*8][bw*8] (stride bw*8), as libjpeg-turbo's jdsample.c does it with
// do_fancy_upsampling on.
void upsample(const Component& c, const uint8_t* plane, int hmax, int vmax,
              int W, int H, uint8_t* out) {
  const int stride = c.bw * 8;
  const int hr = hmax / c.h, vr = vmax / c.v;
  const int dw = c.dw, dh = c.dh;
  auto px = [&](int y, int x) -> int {
    y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);
    x = x < 0 ? 0 : (x >= dw ? dw - 1 : x);
    return plane[(size_t)y * stride + x];
  };
  if (hr == 1 && vr == 1) {
    for (int y = 0; y < H; ++y)
      memcpy(out + (size_t)y * W, plane + (size_t)y * stride, W);
  } else if (hr == 2 && vr == 1 && dw > 2) {            // h2v1 fancy
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) {
        const int cx = x >> 1;
        const int t = 3 * px(y, cx);
        out[(size_t)y * W + x] =
            (uint8_t)((x & 1) ? (t + px(y, cx + 1) + 2) >> 2
                              : (t + px(y, cx - 1) + 1) >> 2);
      }
  } else if (hr == 1 && vr == 2) {                       // h1v2 fancy
    for (int y = 0; y < H; ++y) {
      const int cy = y >> 1;
      const int far = (y & 1) ? cy + 1 : cy - 1;
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x)
        out[(size_t)y * W + x] =
            (uint8_t)((3 * px(cy, x) + px(far, x) + bias) >> 2);
    }
  } else if (hr == 2 && vr == 2 && dw > 2) {             // h2v2 fancy
    for (int y = 0; y < H; ++y) {
      const int cy = y >> 1;
      const int far = (y & 1) ? cy + 1 : cy - 1;
      auto colsum = [&](int cx) { return 3 * px(cy, cx) + px(far, cx); };
      for (int x = 0; x < W; ++x) {
        const int cx = x >> 1;
        const int t = 3 * colsum(cx);
        out[(size_t)y * W + x] =
            (uint8_t)((x & 1) ? (t + colsum(cx + 1) + 7) >> 4
                              : (t + colsum(cx - 1) + 8) >> 4);
      }
    }
  } else {                                               // replication
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x)
        out[(size_t)y * W + x] =
            plane[(size_t)(y / vr) * stride + x / hr];
  }
}

// jdcolor.c's tables
constexpr int kScaleBits = 16;
constexpr long kOneHalf = 1L << (kScaleBits - 1);
inline long fix(double x) { return (long)(x * (1L << kScaleBits) + 0.5); }

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jdcolor.c's YCbCr -> RGB, before its range limit
struct YccTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      const long x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = (int)((fix(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
    }
  }
  int r(int y, int cr) const { return y + cr_r[cr]; }
  int g(int y, int cb, int cr) const {
    return y + (int)((cb_g[cb] + cr_g[cr]) >> kScaleBits);
  }
  int b(int y, int cb) const { return y + cb_b[cb]; }
};

void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                size_t count, uint8_t* out) {
  const YccTables t;
  for (size_t i = 0; i < count; ++i) {
    out[3 * i + 0] = clamp255(t.r(y[i], cr[i]));
    out[3 * i + 1] = clamp255(t.g(y[i], cb[i], cr[i]));
    out[3 * i + 2] = clamp255(t.b(y[i], cb[i]));
  }
}

// PIL's MULDIV255: a * b / 255, rounded as libImaging rounds it
inline int muldiv255(int a, int b) {
  const int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// Four components to RGB as PIL gives them: libjpeg's CMYK output (the
// samples themselves, or ycck_cmyk_convert's 255 - RGB of the first three
// and K as it is), read as "CMYK;I" (each inverted), then libImaging's
// cmyk2rgb: with nk = 255 - K, each channel nk - MULDIV255(C, nk).
void cmyk_to_rgb(const uint8_t* const p[4], bool ycck, size_t count,
                 uint8_t* out) {
  const YccTables t;
  for (size_t i = 0; i < count; ++i) {
    int c[3] = {p[0][i], p[1][i], p[2][i]};
    if (ycck) {
      const int y = c[0], cb = c[1], cr = c[2];
      c[0] = clamp255(255 - t.r(y, cr));
      c[1] = clamp255(255 - t.g(y, cb, cr));
      c[2] = clamp255(255 - t.b(y, cb));
    }
    const int nk = p[3][i];               // 255 - (255 - K)
    for (int k = 0; k < 3; ++k)
      out[3 * i + k] = clamp255(nk - muldiv255(255 - c[k], nk));
  }
}

// The tables a TIFF page's JPEG streams share: libjpeg keeps them in its
// decompressor from stream to stream (JPEGTables read once, a stream's own
// DQT and DHT replacing them for the streams after it). The caller holds
// them in a buffer of 4096 bytes, zeros at first.
struct TiffJpegTables {
  uint16_t q[4][64];
  uint8_t qdef[4];
  uint8_t hdef[8];
  uint8_t hraw[8][17 + 256];
};
static_assert(sizeof(TiffJpegTables) <= 4096, "the caller's buffer");

void load_tables(Jpeg& j, const uint8_t* state) {
  TiffJpegTables t;
  memcpy(&t, state, sizeof(t));
  memcpy(j.qtab, t.q, sizeof(t.q));
  for (int i = 0; i < 4; ++i) j.qdef[i] = t.qdef[i];
  for (int i = 0; i < 8; ++i) j.hdef[i] = t.hdef[i];
  memcpy(j.hraw, t.hraw, sizeof(t.hraw));
}

void save_tables(const Jpeg& j, uint8_t* state) {
  TiffJpegTables t;
  memcpy(t.q, j.qtab, sizeof(t.q));
  for (int i = 0; i < 4; ++i) t.qdef[i] = j.qdef[i];
  for (int i = 0; i < 8; ++i) t.hdef[i] = j.hdef[i];
  memcpy(t.hraw, j.hraw, sizeof(t.hraw));
  memcpy(state, &t, sizeof(t));
}

void set_err(char* err, int errlen, const std::string& m) {
  if (errlen <= 0) return;
  snprintf(err, (size_t)errlen, "%s", m.c_str());
}

}  // namespace

// -- WebP lossless (VP8L) ----------------------------------------------------
//
// The bitstream of RFC 9649, computing what libwebp's vp8l_dec.c,
// huffman_utils.c and lossless.c compute: the same prefix codes (and the
// same refusals of codes that are incomplete, over-subscribed or empty),
// the same LZ77 distances, colour cache and inverse transforms, so that a
// stream libwebp decodes gives its ARGB bit for bit and a stream it refuses
// is refused. Bits past the end of the data read as zeros, and a stream
// that consumes more bits than it holds (64 at least: libwebp's bit reader
// loads a stream shorter than 8 bytes into a 64-bit window) is refused;
// an alpha plane that libwebp decodes by its 8-bit path (Decoder::alpha)
// only where such a read leaves pixels undecoded.
namespace vp8l {

enum { kPredictor = 0, kCrossColour = 1, kSubtractGreen = 2, kIndexing = 3 };
const int kNumLiterals = 256, kNumLengths = 24, kNumDistances = 40;
const int kMaxCacheBits = 11;
const int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};
// the 120 short distance codes: (dx, dy) as libwebp's kCodeToPlane packs
// them, dy << 4 | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

// LSB-first bits; past the end, zeros
struct Bits {
  const uint8_t* p;
  uint64_t n, pos = 0, buf = 0, used = 0, limit;
  int cnt = 0;
  bool lenient = false, over = false;   // over: read past the limit
  Bits(const uint8_t* p_, uint64_t n_)
      : p(p_), n(n_), limit(std::max<uint64_t>(8 * n_, 64)) {}
  uint32_t peek(int k) {
    while (cnt < k) {
      buf |= (uint64_t)(pos < n ? p[pos] : 0) << cnt;
      ++pos;
      cnt += 8;
    }
    return (uint32_t)(buf & ((1ull << k) - 1));
  }
  void skip(int k) {
    buf >>= k;
    cnt -= k;
    used += k;
    if (used > limit) {
      if (!lenient) fail("WebP: truncated VP8L data");
      over = true;
    }
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
};

// A canonical prefix code: the symbols of up to 8 bits by a table of the
// next 8 bits, the longer ones code by code
struct Code {
  int single = -1;                 // a code of one symbol: no bits
  uint16_t lut[256];               // length << 12 | symbol, 0 for longer
  int count[16];
  std::vector<uint16_t> sorted;    // by (length, symbol)

  int decode(Bits& br) const {
    if (single >= 0) return single;
    const uint32_t v = br.peek(15);
    const uint16_t e = lut[v & 255];
    if (e) {
      br.skip(e >> 12);
      return e & 4095;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= 15; ++l) {
      code |= (v >> (l - 1)) & 1;
      if (code - count[l] < first) {
        br.skip(l);
        return sorted[index + code - first];
      }
      index += count[l];
      first = (first + count[l]) << 1;
      code <<= 1;
    }
    fail("WebP: VP8L prefix code");  // a complete code never gets here
  }
};

// huffman_utils.c's BuildHuffmanTable: one symbol of any length, or a
// complete code of lengths 1 to 15; false for anything else
bool build(Code& c, const int* len, int n) {
  int count[16] = {0};
  for (int s = 0; s < n; ++s) {
    if (len[s] < 0 || len[s] > 15) return false;
    ++count[len[s]];
  }
  if (count[0] == n) return false;
  c.sorted.clear();
  for (int l = 1; l <= 15; ++l)
    for (int s = 0; s < n; ++s)
      if (len[s] == l) c.sorted.push_back((uint16_t)s);
  c.single = c.sorted.size() == 1 ? c.sorted[0] : -1;
  if (c.single >= 0) return true;
  long long open = 1;
  for (int l = 1; l <= 15; ++l) {
    open = 2 * open - count[l];
    if (open < 0) return false;     // over-subscribed
  }
  if (open != 0) return false;      // incomplete
  memcpy(c.count, count, sizeof(count));
  memset(c.lut, 0, sizeof(c.lut));
  int code = 0;
  size_t k = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 0; i < count[l]; ++i, ++k, ++code) {
      int rev = 0;
      for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
      for (int j = rev; j < 256; j += 1 << l)
        c.lut[j] = (uint16_t)(l << 12 | c.sorted[k]);
    }
    code <<= 1;
  }
  return true;
}

// ReadHuffmanCode: a simple code (one or two symbols) or a normal one
// (code lengths coded by a code-length code, with repeats)
void read_code(Bits& br, int alphabet, Code& c, std::vector<int>& lens) {
  lens.assign(alphabet, 0);
  if (br.read(1)) {
    const int nsym = (int)br.read(1) + 1;
    int s = (int)br.read(br.read(1) ? 8 : 1);
    if (s < alphabet) lens[s] = 1;
    if (nsym == 2) {
      s = (int)br.read(8);
      if (s < alphabet) lens[s] = 1;
    }
  } else {
    int cl[19] = {0};
    const int ncodes = (int)br.read(4) + 4;
    for (int i = 0; i < ncodes; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    Code clc;
    if (!build(clc, cl, 19)) fail("WebP: invalid VP8L code-length code");
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * (int)br.read(3);
      max_symbol = 2 + (int)br.read(nbits);
      if (max_symbol > alphabet)
        fail("WebP: VP8L code lengths past the alphabet");
    }
    int prev = 8, sym = 0;
    while (sym < alphabet && max_symbol-- > 0) {
      const int v = clc.decode(br);
      if (v < 16) {
        lens[sym++] = v;
        if (v) prev = v;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int rep = (int)br.read(kExtra[v - 16]) + kOffset[v - 16];
        if (sym + rep > alphabet)
          fail("WebP: VP8L code length repeat past the alphabet");
        for (int i = 0; i < rep; ++i) lens[sym++] = v == 16 ? prev : 0;
      }
    }
  }
  if (!build(c, lens.data(), alphabet)) fail("WebP: invalid VP8L prefix code");
}

inline int subsample(int size, int bits) {
  return (int)(((long long)size + (1 << bits) - 1) >> bits);
}

// GetCopyDistance / GetCopyLength: a prefix symbol and its extra bits
inline int copy_value(int sym, Bits& br) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  return ((2 + (sym & 1)) << extra) + (int)br.read(extra) + 1;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
  int d = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (t >> s) & 255, b = (l >> s) & 255, c = (tl >> s) & 255;
    d += abs(b - c) - abs(a - c);
  }
  return d <= 0 ? t : l;
}

inline uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((a >> s) & 255) + (int)((b >> s) & 255) -
                             (int)((c >> s) & 255)) << s;
  return out;
}

inline uint32_t add_sub_half(uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t ave = average2(a, b);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = (ave >> s) & 255, y = (c >> s) & 255;
    out |= (uint32_t)clip255(x + (x - y) / 2) << s;   // C's division
  }
  return out;
}

// the 14 predictors (and modes 14, 15, which libwebp runs as mode 0) of
// pixel p with left L, top row pointer t (t[-1] TL, t[0] T, t[1] TR)
inline uint32_t predict(int mode, uint32_t l, const uint32_t* t) {
  switch (mode) {
    case 1: return l;
    case 2: return t[0];
    case 3: return t[1];
    case 4: return t[-1];
    case 5: return average2(average2(l, t[1]), t[0]);
    case 6: return average2(l, t[-1]);
    case 7: return average2(l, t[0]);
    case 8: return average2(t[-1], t[0]);
    case 9: return average2(t[0], t[1]);
    case 10: return average2(average2(l, t[-1]), average2(t[0], t[1]));
    case 11: return select(t[0], l, t[-1]);
    case 12: return add_sub_full(l, t[0], t[-1]);
    case 13: return add_sub_half(l, t[0], t[-1]);
    default: return 0xff000000u;
  }
}

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

struct Decoder {
  Bits br;
  Transform tr[4];
  int ntr = 0, seen = 0;
  // an alpha plane (ALPH): libwebp decodes one whose only transform is
  // colour indexing, with no colour cache and red, blue and alpha codes
  // of one symbol, by DecodeAlphaData, which refuses a read past the end
  // only where pixels are left to decode
  bool alpha = false;

  Decoder(const uint8_t* p, uint64_t n) : br(p, n) {}

  // DecodeImageStream: an image of xsize x ysize (the top level reads
  // the transforms, which may change xsize, and a meta code image)
  std::vector<uint32_t> stream(int xsize, int ysize, bool level0) {
    if (level0) {
      while (br.read(1)) {
        const int type = (int)br.read(2);
        if (seen & (1 << type)) fail("WebP: VP8L transform used twice");
        seen |= 1 << type;
        Transform& t = tr[ntr++];
        t.type = type;
        t.xsize = xsize;
        t.bits = 0;
        if (type == kPredictor || type == kCrossColour) {
          t.bits = 2 + (int)br.read(3);
          t.data = stream(subsample(xsize, t.bits), subsample(ysize, t.bits),
                          false);
        } else if (type == kIndexing) {
          const int ncolours = (int)br.read(8) + 1;
          t.bits = ncolours > 16 ? 0 : ncolours > 4 ? 1 : ncolours > 2 ? 2 : 3;
          xsize = subsample(xsize, t.bits);
          const std::vector<uint32_t> pal = stream(ncolours, 1, false);
          // delta-coded per channel; the entries past the palette that a
          // bundle width can index are transparent black
          t.data.assign((size_t)1 << (8 >> t.bits), 0);
          t.data[0] = pal[0];
          for (int i = 1; i < ncolours; ++i)
            t.data[i] = add_pixels(pal[i], t.data[i - 1]);
        }
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = (int)br.read(4);
      if (cache_bits < 1 || cache_bits > kMaxCacheBits)
        fail("WebP: bad VP8L colour cache size");
    }
    // the meta codes: a group index a block of pixels, in green and red
    int meta_bits = 0, meta_xsize = 0;
    std::vector<uint32_t> meta;
    std::vector<int> mapping(1, 0);
    int ngroups_max = 1, ngroups = 1;
    if (level0 && br.read(1)) {
      meta_bits = 2 + (int)br.read(3);
      meta_xsize = subsample(xsize, meta_bits);
      meta = stream(meta_xsize, subsample(ysize, meta_bits), false);
      for (uint32_t& g : meta) {
        g = (g >> 8) & 0xffff;
        ngroups_max = std::max(ngroups_max, (int)g + 1);
      }
      // only the groups the image uses are kept (the others are read)
      mapping.assign(ngroups_max, -1);
      ngroups = 0;
      for (uint32_t& g : meta) {
        if (mapping[g] < 0) mapping[g] = ngroups++;
        g = (uint32_t)mapping[g];
      }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    const int alphabet[5] = {kNumLiterals + kNumLengths + cache_size,
                             kNumLiterals, kNumLiterals, kNumLiterals,
                             kNumDistances};
    std::vector<Code> groups((size_t)ngroups * 5);
    std::vector<int> lens;
    Code scratch;
    for (int g = 0; g < ngroups_max; ++g)
      for (int j = 0; j < 5; ++j)
        read_code(br, alphabet[j],
                  mapping[g] < 0 ? scratch : groups[(size_t)mapping[g] * 5 + j],
                  lens);
    if (level0 && alpha && ntr == 1 && tr[0].type == kIndexing &&
        !cache_bits) {
      br.lenient = true;
      for (size_t g = 0; g < groups.size(); g += 5)
        for (int j = 1; j < 4; ++j)
          br.lenient = br.lenient && groups[g + j].single >= 0;
    }
    return pixels(xsize, ysize, cache_bits, groups, meta, meta_bits,
                  meta_xsize);
  }

  // DecodeImageData: literals, backward references and colour cache
  // lookups until every pixel is decoded
  std::vector<uint32_t> pixels(int xsize, int ysize, int cache_bits,
                               const std::vector<Code>& groups,
                               const std::vector<uint32_t>& meta,
                               int meta_bits, int meta_xsize) {
    const size_t total = (size_t)xsize * ysize;
    std::vector<uint32_t> data(total);
    std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0, 0);
    size_t i = 0, cached = 0;
    int x = 0, y = 0;
    const int len_limit = kNumLiterals + kNumLengths;
    while (i < total) {
      const Code* g = groups.data();
      if (meta_bits)
        g += (size_t)meta[(size_t)(y >> meta_bits) * meta_xsize +
                          (x >> meta_bits)] * 5;
      const int s = g[0].decode(br);
      if (s < kNumLiterals) {
        const uint32_t r = g[1].decode(br), b = g[2].decode(br),
                       a = g[3].decode(br);
        data[i++] = a << 24 | r << 16 | (uint32_t)s << 8 | b;
        if (++x == xsize) x = 0, ++y;
      } else if (s < len_limit) {
        const size_t length = (size_t)copy_value(s - kNumLiterals, br);
        const int code = copy_value(g[4].decode(br), br);
        size_t dist;
        if (code > 120) {
          dist = (size_t)(code - 120);
        } else {
          const int p = kCodeToPlane[code - 1];
          const long long d = (long long)(p >> 4) * xsize + 8 - (p & 15);
          dist = d >= 1 ? (size_t)d : 1;
        }
        if (i < dist || total - i < length)
          fail("WebP: VP8L backward reference outside the image");
        for (size_t k = 0; k < length; ++k, ++i) data[i] = data[i - dist];
        x += (int)(length % xsize);
        y += (int)(length / xsize);
        if (x >= xsize) x -= xsize, ++y;
      } else {
        for (; cached < i; ++cached)
          cache[(0x1e35a7bdu * data[cached]) >> (32 - cache_bits)] =
              data[cached];
        data[i++] = cache[s - len_limit];
        if (++x == xsize) x = 0, ++y;
      }
      if (br.over && i < total) fail("WebP: truncated VP8L data");
    }
    return data;
  }
};

// the inverse transforms, in place on the image of width `xsize` x h
void inverse_predictor(const Transform& t, uint32_t* d, int h) {
  const int w = t.xsize, tiles = subsample(w, t.bits);
  d[0] = add_pixels(d[0], 0xff000000u);
  for (int x = 1; x < w; ++x) d[x] = add_pixels(d[x], d[x - 1]);
  for (int y = 1; y < h; ++y) {
    uint32_t* row = d + (size_t)y * w;
    const uint32_t* top = row - w;
    const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles;
    row[0] = add_pixels(row[0], top[0]);
    for (int x = 1; x < w; ++x) {
      const int mode = (modes[x >> t.bits] >> 8) & 15;
      row[x] = add_pixels(row[x], predict(mode, row[x - 1], top + x));
    }
  }
}

inline int colour_delta(int8_t m, int8_t c) { return ((int)m * c) >> 5; }

void inverse_cross_colour(const Transform& t, uint32_t* d, int h) {
  const int w = t.xsize, tiles = subsample(w, t.bits);
  for (int y = 0; y < h; ++y) {
    const uint32_t* m = t.data.data() + (size_t)(y >> t.bits) * tiles;
    for (int x = 0; x < w; ++x) {
      const uint32_t code = m[x >> t.bits];
      uint32_t& p = d[(size_t)y * w + x];
      const int8_t green = (int8_t)(p >> 8);
      int red = (p >> 16) & 255, blue = p & 255;
      red = (red + colour_delta((int8_t)(code & 255), green)) & 255;
      blue += colour_delta((int8_t)((code >> 8) & 255), green);
      blue = (blue + colour_delta((int8_t)((code >> 16) & 255),
                                  (int8_t)red)) & 255;
      p = (p & 0xff00ff00u) | (uint32_t)red << 16 | (uint32_t)blue;
    }
  }
}

void inverse_subtract_green(uint32_t* d, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    const uint32_t g = (d[i] >> 8) & 255;
    d[i] = (d[i] & 0xff00ff00u) |
           (((d[i] & 0x00ff00ffu) + (g << 16 | g)) & 0x00ff00ffu);
  }
}

// colour indexing: the indices in green, 2^bits of them a pixel (the
// first in the low bits), through the palette
std::vector<uint32_t> inverse_indexing(const Transform& t,
                                       const std::vector<uint32_t>& in,
                                       int h) {
  const int w = t.xsize, packed = subsample(w, t.bits);
  const int per = 8 >> t.bits, mask = (1 << per) - 1;
  std::vector<uint32_t> out((size_t)w * h);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const uint32_t g = (in[(size_t)y * packed + (x >> t.bits)] >> 8) & 255;
      out[(size_t)y * w + x] =
          t.data[(g >> ((x & ((1 << t.bits) - 1)) * per)) & mask];
    }
  return out;
}

}  // namespace vp8l

// -- WebP lossy (VP8 key frames) ---------------------------------------------
//
// A key frame of RFC 6386 to RGB, computing what libwebp 1.6's vp8_dec.c,
// tree_dec.c, quant_dec.c, frame_dec.c and its dsp (dec.c, upsampling.c,
// yuv.h) compute, so that a frame libwebp decodes gives its pixels bit for
// bit and a frame it refuses is refused:
//
//  * the boolean decoder with libwebp's end of data: a load that finds no
//    byte left shifts in one zero byte and sets eof, which fails the first
//    partition at the end of a row of modes and a token partition at the
//    end of a macroblock;
//  * the frame header (colour space, clamping type and the refresh bit read
//    and ignored, as libwebp ignores them, and so the profile and the scale
//    bits), segments, loop filter and its deltas, 1 to 8 token partitions
//    (sizes clipped to the data), the quantisers (quant_dec.c's tables and
//    rules), the coefficient probability updates, the skip probability;
//  * per macroblock: segment, skip flag, the 16x16 or 4x4 intra modes and
//    the chroma mode, then the coefficient tokens (contexts from the
//    neighbours' non-zero flags, the Y2 block of a 16x16 one); the inverse
//    WHT and DCT; the intra predictors on libwebp's work buffer, whose
//    borders are 127 above the frame and 129 left of it;
//  * the simple or normal loop filter over the whole frame (prediction
//    reads unfiltered pixels), macroblock by macroblock, each with its
//    segment's and mode's strengths (PrecomputeFilterStrengths);
//  * libwebp's fancy upsampling of the 4:2:0 chroma and its YUV -> RGB
//    (14-bit BT.601 studio range, not the JPEG decoder's conversion).
//
// The full inverse DCT is computed as libwebp's SSE2 code computes it on
// x86, in wrapping 16-bit lanes (its C code computes in int; the two part
// only on coefficients no encoder writes); its DC-only and three-
// coefficient shortcuts, and the WHT, as its C code does. The tables are
// RFC 6386's, in libwebp's layout: its order of the 4x4 modes (DC, TM, VE,
// HE, RD, VR, LD, VL, HD, HU) indexes kBModesProba.
namespace vp8 {

enum { kBPS = 32 };   // the work buffer's stride (libwebp's BPS)
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

const uint8_t kCoeffsProba0[4][8][3][11] = {
    {{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
      {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
      {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
     {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
      {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
      {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
     {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
      {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
      {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
     {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
      {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
      {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
     {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
      {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
      {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
     {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
      {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
      {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
     {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
      {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
      {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
     {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
      {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
      {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
     {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
      {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
      {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
     {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
      {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
      {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
     {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
      {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
      {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
     {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
      {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
      {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
     {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
      {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
      {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
     {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
      {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
    {{{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
      {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
      {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
     {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
      {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
      {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
     {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
      {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
      {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
     {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
      {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
      {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
     {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
      {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
      {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
      {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {{{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
      {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
      {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
     {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
      {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
      {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
     {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
      {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
      {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
     {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
      {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
      {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
     {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
      {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
      {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
     {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
      {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
      {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
     {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
      {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
      {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
     {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
      {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
      {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
     {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
      {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};
const uint8_t kBModesProba[10][10][9] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112},
     {152, 179, 64, 126, 170, 118, 46, 70, 95},
     {175, 69, 143, 80, 85, 82, 72, 155, 103},
     {56, 58, 10, 171, 218, 189, 17, 13, 152},
     {114, 26, 17, 163, 44, 195, 21, 10, 173},
     {121, 24, 80, 195, 26, 62, 44, 64, 85},
     {144, 71, 10, 38, 171, 213, 144, 34, 26},
     {170, 46, 55, 19, 136, 160, 33, 206, 71},
     {63, 20, 8, 114, 114, 208, 12, 9, 226},
     {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148},
     {72, 187, 100, 130, 157, 111, 32, 75, 80},
     {66, 102, 167, 99, 74, 62, 40, 234, 128},
     {41, 53, 9, 178, 241, 141, 26, 8, 107},
     {74, 43, 26, 146, 73, 166, 49, 23, 157},
     {65, 38, 105, 160, 51, 52, 31, 115, 128},
     {104, 79, 12, 27, 217, 255, 87, 17, 7},
     {87, 68, 71, 44, 114, 51, 15, 186, 23},
     {47, 41, 14, 110, 182, 183, 21, 17, 194},
     {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205},
     {43, 97, 183, 117, 85, 38, 35, 179, 61},
     {39, 53, 200, 87, 26, 21, 43, 232, 171},
     {56, 34, 51, 104, 114, 102, 29, 93, 77},
     {39, 28, 85, 171, 58, 165, 90, 98, 64},
     {34, 22, 116, 206, 23, 34, 43, 166, 73},
     {107, 54, 32, 26, 51, 1, 81, 43, 31},
     {68, 25, 106, 22, 64, 171, 36, 225, 114},
     {34, 19, 21, 102, 132, 188, 16, 76, 124},
     {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111},
     {60, 148, 31, 172, 219, 228, 21, 18, 111},
     {112, 113, 77, 85, 179, 255, 38, 120, 114},
     {40, 42, 1, 196, 245, 209, 10, 25, 109},
     {88, 43, 29, 140, 166, 213, 37, 43, 154},
     {61, 63, 30, 155, 67, 45, 68, 1, 209},
     {100, 80, 8, 43, 154, 1, 51, 26, 71},
     {142, 78, 78, 16, 255, 128, 34, 197, 171},
     {41, 40, 5, 102, 211, 183, 4, 1, 221},
     {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229},
     {67, 87, 58, 169, 82, 115, 26, 59, 179},
     {63, 59, 90, 180, 59, 166, 93, 73, 154},
     {40, 40, 21, 116, 143, 209, 34, 39, 175},
     {47, 15, 16, 183, 34, 223, 49, 45, 183},
     {46, 17, 33, 183, 6, 98, 15, 32, 183},
     {57, 46, 22, 24, 128, 1, 54, 17, 37},
     {65, 32, 73, 115, 28, 128, 23, 128, 205},
     {40, 3, 9, 115, 51, 192, 18, 6, 223},
     {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226},
     {64, 90, 70, 205, 40, 41, 23, 26, 57},
     {54, 57, 112, 184, 5, 41, 38, 166, 213},
     {30, 34, 26, 133, 152, 116, 10, 32, 134},
     {39, 19, 53, 221, 26, 114, 32, 73, 255},
     {31, 9, 65, 234, 2, 15, 1, 118, 73},
     {75, 32, 12, 51, 192, 255, 160, 43, 51},
     {88, 31, 35, 67, 102, 85, 55, 186, 85},
     {56, 21, 23, 111, 59, 205, 45, 37, 192},
     {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82},
     {95, 84, 53, 89, 128, 100, 113, 101, 45},
     {75, 79, 123, 47, 51, 128, 81, 171, 1},
     {57, 17, 5, 71, 102, 57, 53, 41, 49},
     {38, 33, 13, 121, 57, 73, 26, 1, 85},
     {41, 10, 67, 138, 77, 110, 90, 47, 114},
     {115, 21, 2, 10, 102, 255, 166, 23, 6},
     {101, 29, 16, 10, 85, 128, 101, 196, 26},
     {57, 18, 10, 102, 102, 213, 34, 20, 43},
     {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192},
     {69, 60, 71, 38, 73, 119, 28, 222, 37},
     {68, 45, 128, 34, 1, 47, 11, 245, 171},
     {62, 17, 19, 70, 146, 85, 55, 62, 70},
     {37, 43, 37, 154, 100, 163, 85, 160, 1},
     {63, 9, 92, 136, 28, 64, 32, 201, 85},
     {75, 15, 9, 9, 64, 255, 184, 119, 16},
     {86, 6, 28, 5, 64, 255, 25, 248, 1},
     {56, 8, 17, 132, 137, 255, 55, 116, 128},
     {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218},
     {51, 103, 44, 131, 131, 123, 31, 6, 158},
     {86, 40, 64, 135, 148, 224, 45, 183, 128},
     {22, 26, 17, 131, 240, 154, 14, 1, 209},
     {45, 16, 21, 91, 64, 222, 7, 1, 197},
     {56, 21, 39, 155, 60, 138, 23, 102, 213},
     {83, 12, 13, 54, 192, 255, 68, 47, 28},
     {85, 26, 85, 85, 128, 128, 32, 146, 171},
     {18, 11, 7, 63, 144, 171, 4, 4, 246},
     {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45},
     {85, 126, 47, 87, 176, 51, 41, 20, 32},
     {101, 75, 128, 139, 118, 146, 116, 128, 85},
     {56, 41, 15, 176, 236, 85, 37, 9, 62},
     {71, 30, 17, 119, 118, 255, 17, 18, 138},
     {101, 38, 60, 138, 55, 70, 43, 26, 142},
     {146, 36, 19, 30, 171, 255, 97, 27, 20},
     {138, 45, 61, 62, 219, 1, 81, 188, 64},
     {32, 41, 20, 117, 151, 142, 20, 21, 163},
     {112, 19, 12, 61, 195, 128, 48, 4, 24}}};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16,
    17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25,
    25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37,
    38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77,
    78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93,
    95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151,
    154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
    32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45,
    46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
    62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88,
    90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158,
    161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274,
    279, 284};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14,
                             15};
// a coefficient's band, by its index in zigzag order (the 17th: past the
// last)
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
// DCT_CAT3 to DCT_CAT6: the probabilities of their extra bits
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
// the 4x4 mode tree: a leaf is minus its mode, a node the index of its pair
const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE,
                                  5, -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD,
                                  -B_HU};
// the 4x4 blocks' offsets in the work buffer, in raster order
const int kScan[16] = {0,        4,        8,        12,
                       4 * kBPS, 4 + 4 * kBPS, 8 + 4 * kBPS, 12 + 4 * kBPS,
                       8 * kBPS, 4 + 8 * kBPS, 8 + 8 * kBPS, 12 + 8 * kBPS,
                       12 * kBPS, 4 + 12 * kBPS, 8 + 12 * kBPS,
                       12 + 12 * kBPS};

// VP8BitReader as libwebp builds it for a 64-bit host: 56 bits at a time
// while 8 bytes are left, then a byte at a time; past the end one zero byte
// and eof. The range is kept less one. A corrupt stream drives the value
// past the range, where the bits kept in the 64-bit value and the 32-bit
// comparisons decide what is read, so they are libwebp's here too.
struct BoolDec {
  const uint8_t* buf = nullptr;
  const uint8_t* buf_end = nullptr;
  const uint8_t* buf_max = nullptr;   // the last start of an 8-byte load
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  bool eof = false;

  void init(const uint8_t* start, size_t n) {
    buf = start;
    buf_end = start + n;
    buf_max = n >= 8 ? start + n - 8 + 1 : start;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  // VP8LoadNewBytes and VP8LoadFinalBytes
  void load() {
    if (buf < buf_max) {
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = in << 8 | buf[i];
      buf += 7;
      value = in | value << 56;
      bits += 56;
    } else if (buf < buf_end) {
      bits += 8;
      value = value << 8 | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  // VP8GetBit
  int bit(int prob) {
    if (bits < 0) load();
    uint32_t r = range;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const int b = (uint32_t)(value >> bits) > split;
    if (b) {
      r -= split;
      value -= (uint64_t)(split + 1) << bits;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    range = (r << shift) - 1;
    bits -= shift;
    return b;
  }
  // VP8GetSigned: v or -v by a bit of probability 1/2, its comparison a
  // 32-bit difference's sign
  int sign(int v) {
    if (bits < 0) load();
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> bits);
    const int32_t mask = (int32_t)(split - val) >> 31;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << bits;
    range = (range + (uint32_t)mask) | 1;
    bits -= 1;
    return (v ^ mask) - mask;
  }
  // VP8GetValue, VP8GetSignedValue
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value_bits(n);
    return bit(0x80) ? -v : v;
  }
  int flag() { return bit(0x80); }
};

struct Quant {
  int y1[2], y2[2], uv[2];   // DC, AC
};

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev = 0;
};

// a macroblock's modes and coefficients
struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t is_i4x4 = 0, uvmode = 0, segment = 0, skip = 0;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

// the non-zero flags a macroblock leaves its neighbours: bits 0-3 luma,
// 4-5 U, 6-7 V; and the Y2 block's
struct NZ {
  uint8_t nz = 0, nz_dc = 0;
};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }
inline int clamp(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// -- the inverse transforms, added to dst (the work buffer's stride) -------

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline int16_t w16(int v) { return (int16_t)v; }
inline int16_t mulhi(int16_t a, int k) { return (int16_t)(((int)a * k) >> 16); }

// Transform_SSE2: the 4x4 inverse DCT, columns then rows, in 16-bit lanes
// (x * 35468 >> 16 as mulhi(x, 35468 - 65536) + x)
void transform(const int16_t* in, uint8_t* dst) {
  int16_t t[16];
  for (int pass = 0; pass < 2; ++pass) {
    int16_t o[16];
    for (int i = 0; i < 4; ++i) {
      const int16_t* s = pass ? t + i : in + i;   // a column, then a row
      const int16_t i0 = pass ? w16(s[0] + 4) : s[0];
      const int16_t i1 = s[4], i2 = s[8], i3 = s[12];
      const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
      const int16_t c = w16(w16(i1 - i3) +
                            w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
      const int16_t d = w16(w16(i1 + i3) +
                            w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
      o[4 * i] = w16(a + d);
      o[4 * i + 1] = w16(b + c);
      o[4 * i + 2] = w16(b - c);
      o[4 * i + 3] = w16(a - d);
    }
    // t[4 i + k]: after the columns, column i's k-th value; after the
    // rows, row i's k-th
    memcpy(t, o, sizeof(t));
  }
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x)
      dst[y * kBPS + x] = clip8(dst[y * kBPS + x] + (t[4 * y + x] >> 3));
}

// TransformDC_C and TransformAC3_C (coefficients 0, 1 and 4 alone)
void transform_dc(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x)
      dst[y * kBPS + x] = clip8(dst[y * kBPS + x] + (dc >> 3));
}

void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4, c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    const int v[4] = {rows[y] + d1, rows[y] + c1, rows[y] - c1,
                      rows[y] - d1};
    for (int x = 0; x < 4; ++x)
      dst[y * kBPS + x] = clip8(dst[y * kBPS + x] + (v[x] >> 3));
  }
}

// DoTransform: by the block's two bits of non_zero_y (3: any
// coefficient past the third, 2: past the first, 1: the DC alone)
void do_transform(uint32_t bits, const int16_t* in, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: transform(in, dst); break;
    case 2: transform_ac3(in, dst); break;
    case 1: transform_dc(in, dst); break;
    default: break;
  }
}

// DoUVTransform: four chroma blocks, by any AC coefficient among them
void do_uv_transform(uint32_t bits, const int16_t* in, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  for (int k = 0; k < 4; ++k) {
    uint8_t* d = dst + (k >> 1) * 4 * kBPS + (k & 1) * 4;
    if (bits & 0xaa)
      transform(in + 16 * k, d);
    else
      transform_dc(in + 16 * k, d);
  }
}

// TransformWHT_C: the Y2 block into the 16 luma blocks' DCs
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    out[0] = w16((a0 + a1) >> 3);
    out[16] = w16((a3 + a2) >> 3);
    out[32] = w16((a0 - a1) >> 3);
    out[48] = w16((a3 - a2) >> 3);
    out += 64;
  }
}

// -- the intra predictors, on the work buffer (top row at dst - kBPS, left
// column at dst[-1]) -------------------------------------------------------

inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) memset(dst + y * kBPS, v, size);
}

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBPS;
  for (int y = 0; y < size; ++y)
    for (int x = 0; x < size; ++x)
      dst[y * kBPS + x] = clip8(top[x] + dst[y * kBPS - 1] - top[-1]);
}

// a 16x16 luma or 8x8 chroma block; DC without the top row or the left
// column (or both) on the frame's first row and column, as CheckMode picks
void predict_block(uint8_t* dst, int size, int mode, int mb_x, int mb_y) {
  const int log = size == 16 ? 4 : 3;
  switch (mode) {
    case B_TM: true_motion(dst, size); return;
    case B_VE:
      for (int y = 0; y < size; ++y) memcpy(dst + y * kBPS, dst - kBPS, size);
      return;
    case B_HE:
      for (int y = 0; y < size; ++y)
        memset(dst + y * kBPS, dst[y * kBPS - 1], size);
      return;
    default: break;
  }
  int dc = 0;
  if (mb_x > 0)
    for (int j = 0; j < size; ++j) dc += dst[j * kBPS - 1];
  if (mb_y > 0)
    for (int j = 0; j < size; ++j) dc += dst[j - kBPS];
  if (mb_x > 0 && mb_y > 0)
    dc = (dc + size) >> (log + 1);
  else if (mb_x > 0 || mb_y > 0)
    dc = (dc + size / 2) >> log;
  else
    dc = 0x80;
  fill(dst, size, dc);
}

#define DST(x, y) dst[(x) + (y) * kBPS]
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - kBPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[kBPS - 1], K = dst[2 * kBPS - 1],
            L = dst[3 * kBPS - 1];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[i * kBPS - 1];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) memcpy(dst + y * kBPS, v, 4);
      break;
    }
    case B_HE: {
      const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                            avg3(K, L, L)};
      for (int y = 0; y < 4; ++y) memset(dst + y * kBPS, v[y], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:   // B_HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = (uint8_t)L;
      break;
  }
}
#undef DST

// -- the loop filter (dsp/dec.c), p at the first pixel past the edge,
// `step` across it ---------------------------------------------------------

inline int sclip1(int v) { return clamp(v, -128, 127); }
inline int sclip2(int v) { return clamp(v, -16, 15); }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
            a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  return abs(p[-2 * step] - p[-step]) > thresh ||
         abs(p[step] - p[0]) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * abs(p[-step] - p[0]) + abs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step],
            q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

// `size` pixels along an edge (`along` between them): the simple filter,
// or the normal one of a macroblock edge (six taps) or an inner one (four)
void simple_edge(uint8_t* p, int step, int along, int thresh) {
  for (int i = 0; i < 16; ++i, p += along)
    if (needs_filter(p, step, 2 * thresh + 1)) filter2(p, step);
}

void normal_edge(uint8_t* p, int step, int along, int size, int thresh,
                 int ithresh, int hev_thresh, bool mb_edge) {
  for (int i = 0; i < size; ++i, p += along) {
    if (!needs_filter2(p, step, 2 * thresh + 1, ithresh)) continue;
    if (hev(p, step, hev_thresh))
      filter2(p, step);
    else if (mb_edge)
      filter6(p, step);
    else
      filter4(p, step);
  }
}

// GetLargeValue: a token's magnitude past 1 (DCT_CAT1 to DCT_CAT6)
int large_value(BoolDec& br, const uint8_t* p) {
  if (!br.bit(p[3])) {
    if (!br.bit(p[4])) return 2;
    return 3 + br.bit(p[5]);
  }
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    const int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int bit1 = br.bit(p[8]);
  const int bit0 = br.bit(p[9 + bit1]);
  const int cat = 2 * bit1 + bit0;
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
  return v + 3 + (8 << cat);
}

// GetCoeffs: a block's tokens from index n, dequantised into out (natural
// order, int16 as libwebp stores them); the index past the last non-zero
// one, or 16 where the block ends in a run of zeros
int get_coeffs(BoolDec& br, const uint8_t (*prob)[3][11], int ctx,
               const int* dq, int n, int16_t* out) {
  const uint8_t* p = prob[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = prob[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*next)[11] = prob[kBands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = next[1];
    } else {
      v = large_value(br, p);
      p = next[2];
    }
    out[kZigzag[n]] = w16(br.sign(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t codes, int nz, int dc_nz) {
  return codes << 2 | (nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
}

struct Decoder {
  int w = 0, h = 0, mbw = 0, mbh = 0;
  BoolDec br, parts[8];
  int last_part = 0;
  // segments
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  int seg_proba[3] = {255, 255, 255};
  // the loop filter
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;   // 0 none, 1 simple, 2 normal
  FInfo fstrengths[4][2];
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  // per row and column: the 4x4 mode contexts, the non-zero flags
  std::vector<uint8_t> intra_t;
  uint8_t intra_l[4];
  std::vector<NZ> nz_top;
  NZ nz_left;
  std::vector<MBData> row;
  std::vector<FInfo> finfo;   // every macroblock's, for the filter
  // the work buffer (libwebp's yuv_b_) and each column's unfiltered
  // bottom rows (yuv_t_), the planes on the macroblock grid
  uint8_t yuv_b[kBPS * 17 + kBPS * 9];
  std::vector<uint8_t> top_y, top_u, top_v, Y, U, V;

  void header(const uint8_t* data, size_t n);
  void precompute_filter();
  void parse_segments();
  void parse_filter();
  void parse_partitions(const uint8_t* buf, size_t size);
  void parse_quant();
  void parse_proba();
  void parse_modes(int mb_x);
  bool parse_residuals(MBData& block, NZ& top, BoolDec& tok);
  void decode_mb(int mb_x, int mb_y, BoolDec& tok);
  void reconstruct_row(int mb_y);
  void filter();
  void to_rgb(uint8_t* out) const;
};

// VP8GetHeaders: the frame tag, the key frame's start code and size, then
// the first partition's header, to the skip probability
void Decoder::header(const uint8_t* data, size_t n) {
  if (n < 10) fail("WebP: truncated VP8 frame header");
  const uint32_t bits = data[0] | data[1] << 8 | data[2] << 16;
  if (bits & 1) fail("WebP: VP8 frame is not a key frame");
  if ((bits >> 1 & 7) > 3) fail("WebP: bad VP8 profile");
  if (!(bits >> 4 & 1)) fail("WebP: VP8 frame not shown");
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
    fail("WebP: bad VP8 start code");
  w = (data[6] | data[7] << 8) & 0x3fff;     // the scale bits ignored
  h = (data[8] | data[9] << 8) & 0x3fff;
  if (!w || !h) fail("WebP: VP8 frame of no pixels");
  mbw = (w + 15) >> 4;
  mbh = (h + 15) >> 4;
  const size_t part0 = bits >> 5;
  if (part0 > n - 10) fail("WebP: VP8 first partition past the data");
  br.init(data + 10, part0);
  br.flag();   // colour space
  br.flag();   // clamping type
  parse_segments();
  parse_filter();
  parse_partitions(data + 10 + part0, n - 10 - part0);
  parse_quant();
  br.flag();   // refresh entropy probabilities: one frame, unused
  parse_proba();
}

void Decoder::parse_segments() {
  use_segment = br.flag();
  if (use_segment) {
    update_map = br.flag();
    if (br.flag()) {   // update the data
      absolute_delta = br.flag();
      for (int& q : quantizer) q = br.flag() ? br.signed_value(7) : 0;
      for (int& f : filter_strength) f = br.flag() ? br.signed_value(6) : 0;
    }
    if (update_map)
      for (int& p : seg_proba) p = br.flag() ? br.value_bits(8) : 255;
  }
  if (br.eof) fail("WebP: VP8 segment header past its partition");
}

void Decoder::parse_filter() {
  simple = br.flag();
  level = br.value_bits(6);
  sharpness = br.value_bits(3);
  use_lf_delta = br.flag();
  if (use_lf_delta && br.flag()) {   // update the deltas
    for (int& d : ref_lf_delta)
      if (br.flag()) d = br.signed_value(6);
    for (int& d : mode_lf_delta)
      if (br.flag()) d = br.signed_value(6);
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) fail("WebP: VP8 filter header past its partition");
}

// ParsePartitions: 3-byte sizes of all but the last, each clipped to the
// data left; the last takes the rest and must not be empty
void Decoder::parse_partitions(const uint8_t* buf, size_t size) {
  last_part = (1 << br.value_bits(2)) - 1;
  if (size < 3 * (size_t)last_part)
    fail("WebP: VP8 partition sizes past the data");
  const uint8_t* sz = buf;
  const uint8_t* start = buf + 3 * last_part;
  size_t left = size - 3 * last_part;
  for (int p = 0; p < last_part; ++p, sz += 3) {
    size_t psize = sz[0] | sz[1] << 8 | sz[2] << 16;
    if (psize > left) psize = left;
    parts[p].init(start, psize);
    start += psize;
    left -= psize;
  }
  parts[last_part].init(start, left);
  if (start >= buf + size) fail("WebP: VP8 token partition past the data");
}

// VP8ParseQuant
void Decoder::parse_quant() {
  const int base = br.value_bits(7);
  int d[5];   // y1 DC, y2 DC, y2 AC, uv DC, uv AC
  for (int& v : d) v = br.flag() ? br.signed_value(4) : 0;
  for (int s = 0; s < 4; ++s) {
    int q = base;
    if (use_segment) {
      q = quantizer[s] + (absolute_delta ? 0 : base);
    } else if (s > 0) {
      dqm[s] = dqm[0];
      continue;
    }
    Quant& m = dqm[s];
    m.y1[0] = kDcTable[clamp(q + d[0], 0, 127)];
    m.y1[1] = kAcTable[clamp(q, 0, 127)];
    m.y2[0] = kDcTable[clamp(q + d[1], 0, 127)] * 2;
    m.y2[1] = std::max(kAcTable[clamp(q + d[2], 0, 127)] * 101581 >> 16, 8);
    m.uv[0] = kDcTable[clamp(q + d[3], 0, 117)];
    m.uv[1] = kAcTable[clamp(q + d[4], 0, 127)];
  }
}

// VP8ParseProba: the 1056 update flags, each with its value or the
// default; the skip probability
void Decoder::parse_proba() {
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba[t][b][c][p] = (uint8_t)(br.bit(kCoeffsUpdateProba[t][b][c][p])
                                            ? br.value_bits(8)
                                            : kCoeffsProba0[t][b][c][p]);
  use_skip_proba = br.flag();
  if (use_skip_proba) skip_p = br.value_bits(8);
}

// ParseIntraMode: segment, skip flag, luma modes (their contexts set as
// 4x4 modes), chroma mode
void Decoder::parse_modes(int mb_x) {
  MBData& block = row[mb_x];
  uint8_t* top = &intra_t[4 * mb_x];
  block.segment = 0;
  if (update_map)
    block.segment = !br.bit(seg_proba[0]) ? br.bit(seg_proba[1])
                                          : br.bit(seg_proba[2]) + 2;
  block.skip = use_skip_proba ? br.bit(skip_p) : 0;
  block.is_i4x4 = !br.bit(145);
  if (!block.is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE)
                                  : (br.bit(163) ? B_VE : B_DC);
    block.imodes[0] = (uint8_t)ymode;
    memset(top, ymode, 4);
    memset(intra_l, ymode, 4);
  } else {
    for (int y = 0; y < 4; ++y) {
      int ymode = intra_l[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[br.bit(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
        ymode = -i;
        top[x] = (uint8_t)ymode;
      }
      memcpy(block.imodes + 4 * y, top, 4);
      intra_l[y] = (uint8_t)ymode;
    }
  }
  block.uvmode = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE
                                   : br.bit(183) ? B_TM : B_HE;
}

// ParseResiduals: the tokens of a macroblock; true where all are zero
bool Decoder::parse_residuals(MBData& block, NZ& top, BoolDec& tok) {
  NZ& left = nz_left;
  const Quant& q = dqm[block.segment];
  int16_t* dst = block.coeffs;
  memset(dst, 0, sizeof(block.coeffs));
  int first;
  const uint8_t (*ac_proba)[3][11];
  if (!block.is_i4x4) {   // the Y2 block: the luma blocks' DCs
    int16_t dc[16] = {0};
    const int nz = get_coeffs(tok, proba[1], top.nz_dc + left.nz_dc, q.y2, 0,
                              dc);
    top.nz_dc = left.nz_dc = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 256; i += 16) dst[i] = w16(dc0);
    }
    first = 1;
    ac_proba = proba[0];
  } else {
    first = 0;
    ac_proba = proba[3];
  }
  uint8_t tnz = top.nz & 0x0f, lnz = left.nz & 0x0f;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t codes = 0;
    for (int x = 0; x < 4; ++x, dst += 16) {
      const int nz = get_coeffs(tok, ac_proba, l + (tnz & 1), q.y1, first,
                                dst);
      l = nz > first;
      tnz = (uint8_t)(tnz >> 1 | l << 7);
      codes = nz_code_bits(codes, nz, dst[0] != 0);
    }
    tnz >>= 4;
    lnz = (uint8_t)(lnz >> 1 | l << 7);
    non_zero_y = non_zero_y << 8 | codes;
  }
  uint32_t out_t = tnz, out_l = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t codes = 0;
    tnz = (uint8_t)(top.nz >> (4 + ch));
    lnz = (uint8_t)(left.nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x, dst += 16) {
        const int nz = get_coeffs(tok, proba[2], l + (tnz & 1), q.uv, 0, dst);
        l = nz > 0;
        tnz = (uint8_t)(tnz >> 1 | l << 3);
        codes = nz_code_bits(codes, nz, dst[0] != 0);
      }
      tnz >>= 2;
      lnz = (uint8_t)(lnz >> 1 | l << 5);
    }
    non_zero_uv |= codes << (4 * ch);
    out_t |= (uint32_t)(tnz << 4) << ch;
    out_l |= (uint32_t)(lnz & 0xf0) << ch;
  }
  top.nz = (uint8_t)out_t;
  left.nz = (uint8_t)out_l;
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// VP8DecodeMB: the tokens (none where the skip flag is set) and the
// macroblock's filter strengths, inner edges too where it is 4x4 or has
// coefficients
void Decoder::decode_mb(int mb_x, int mb_y, BoolDec& tok) {
  MBData& block = row[mb_x];
  NZ& top = nz_top[mb_x];
  bool skip = use_skip_proba && block.skip;
  if (!skip) {
    skip = parse_residuals(block, top, tok);
  } else {
    nz_left.nz = top.nz = 0;
    if (!block.is_i4x4) nz_left.nz_dc = top.nz_dc = 0;
    block.non_zero_y = block.non_zero_uv = 0;
  }
  if (filter_type > 0) {
    FInfo& f = finfo[(size_t)mb_y * mbw + mb_x];
    f = fstrengths[block.segment][block.is_i4x4];
    f.inner |= !skip;
  }
}

// ReconstructRow: each macroblock predicted and its residuals added in
// the work buffer (left samples rotated in from the previous one, top
// samples from the row above, unfiltered), then copied to the planes
void Decoder::reconstruct_row(int mb_y) {
  uint8_t* const y_dst = yuv_b + kBPS + 8;
  uint8_t* const u_dst = y_dst + 16 * kBPS + kBPS;
  uint8_t* const v_dst = u_dst + 16;
  for (int j = 0; j < 16; ++j) y_dst[j * kBPS - 1] = 129;
  for (int j = 0; j < 8; ++j) u_dst[j * kBPS - 1] = v_dst[j * kBPS - 1] = 129;
  if (mb_y > 0) {
    y_dst[-1 - kBPS] = u_dst[-1 - kBPS] = v_dst[-1 - kBPS] = 129;
  } else {
    memset(y_dst - kBPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - kBPS - 1, 127, 8 + 1);
    memset(v_dst - kBPS - 1, 127, 8 + 1);
  }
  const size_t ys = (size_t)16 * mbw, uvs = (size_t)8 * mbw;
  for (int mb_x = 0; mb_x < mbw; ++mb_x) {
    const MBData& block = row[mb_x];
    if (mb_x > 0) {
      for (int j = -1; j < 16; ++j)
        memcpy(y_dst + j * kBPS - 4, y_dst + j * kBPS + 12, 4);
      for (int j = -1; j < 8; ++j) {
        memcpy(u_dst + j * kBPS - 4, u_dst + j * kBPS + 4, 4);
        memcpy(v_dst + j * kBPS - 4, v_dst + j * kBPS + 4, 4);
      }
    }
    uint8_t* ty = &top_y[16 * (size_t)mb_x];
    uint8_t* tu = &top_u[8 * (size_t)mb_x];
    uint8_t* tv = &top_v[8 * (size_t)mb_x];
    if (mb_y > 0) {
      memcpy(y_dst - kBPS, ty, 16);
      memcpy(u_dst - kBPS, tu, 8);
      memcpy(v_dst - kBPS, tv, 8);
    }
    uint32_t bits = block.non_zero_y;
    if (block.is_i4x4) {
      uint8_t* top_right = y_dst - kBPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mbw - 1)
          memset(top_right, ty[15], 4);
        else
          memcpy(top_right, ty + 16, 4);
      }
      for (int k = 1; k < 4; ++k) memcpy(top_right + 4 * k * kBPS, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* dst = y_dst + kScan[n];
        predict4(dst, block.imodes[n]);
        do_transform(bits, block.coeffs + 16 * n, dst);
      }
    } else {
      predict_block(y_dst, 16, block.imodes[0], mb_x, mb_y);
      if (bits)
        for (int n = 0; n < 16; ++n, bits <<= 2)
          do_transform(bits, block.coeffs + 16 * n, y_dst + kScan[n]);
    }
    predict_block(u_dst, 8, block.uvmode, mb_x, mb_y);
    predict_block(v_dst, 8, block.uvmode, mb_x, mb_y);
    do_uv_transform(block.non_zero_uv, block.coeffs + 16 * 16, u_dst);
    do_uv_transform(block.non_zero_uv >> 8, block.coeffs + 20 * 16, v_dst);
    if (mb_y < mbh - 1) {
      memcpy(ty, y_dst + 15 * kBPS, 16);
      memcpy(tu, u_dst + 7 * kBPS, 8);
      memcpy(tv, v_dst + 7 * kBPS, 8);
    }
    for (int j = 0; j < 16; ++j)
      memcpy(&Y[(16 * (size_t)mb_y + j) * ys + 16 * (size_t)mb_x],
             y_dst + j * kBPS, 16);
    for (int j = 0; j < 8; ++j) {
      memcpy(&U[(8 * (size_t)mb_y + j) * uvs + 8 * (size_t)mb_x],
             u_dst + j * kBPS, 8);
      memcpy(&V[(8 * (size_t)mb_y + j) * uvs + 8 * (size_t)mb_x],
             v_dst + j * kBPS, 8);
    }
  }
}

// DoFilter over every macroblock in raster order: its left edge, its inner
// vertical edges, its top edge, its inner horizontal edges
void Decoder::filter() {
  if (filter_type == 0) return;
  const int ys = 16 * mbw, uvs = 8 * mbw;
  for (int mb_y = 0; mb_y < mbh; ++mb_y)
    for (int mb_x = 0; mb_x < mbw; ++mb_x) {
      const FInfo& f = finfo[(size_t)mb_y * mbw + mb_x];
      const int limit = f.limit;
      if (limit == 0) continue;
      uint8_t* y = &Y[(size_t)16 * mb_y * ys + 16 * mb_x];
      if (filter_type == 1) {
        if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
        if (f.inner)
          for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ys, limit);
        if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
        if (f.inner)
          for (int k = 4; k < 16; k += 4)
            simple_edge(y + k * ys, ys, 1, limit);
        continue;
      }
      const int il = f.ilevel, hv = f.hev;
      uint8_t* uv[2] = {&U[(size_t)8 * mb_y * uvs + 8 * mb_x],
                        &V[(size_t)8 * mb_y * uvs + 8 * mb_x]};
      if (mb_x > 0) {
        normal_edge(y, 1, ys, 16, limit + 4, il, hv, true);
        for (uint8_t* c : uv) normal_edge(c, 1, uvs, 8, limit + 4, il, hv, true);
      }
      if (f.inner) {
        for (int k = 4; k < 16; k += 4)
          normal_edge(y + k, 1, ys, 16, limit, il, hv, false);
        for (uint8_t* c : uv) normal_edge(c + 4, 1, uvs, 8, limit, il, hv, false);
      }
      if (mb_y > 0) {
        normal_edge(y, ys, 1, 16, limit + 4, il, hv, true);
        for (uint8_t* c : uv) normal_edge(c, uvs, 1, 8, limit + 4, il, hv, true);
      }
      if (f.inner) {
        for (int k = 4; k < 16; k += 4)
          normal_edge(y + k * ys, ys, 1, 16, limit, il, hv, false);
        for (uint8_t* c : uv)
          normal_edge(c + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
      }
    }
}

// yuv.h's VP8YUVToR/G/B: 14-bit fixed point, clipped
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip(int v) {
  return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255;
}

// EmitFancyRGB with UpsampleRgbaLinePair: each output row's chroma from
// the two nearest chroma rows (the first and, for an even height, the
// last from one), each pixel's from the two nearest columns, weighted
// 9-3-3-1 in two rounded steps (the edges 3-1)
void Decoder::to_rgb(uint8_t* out) const {
  const size_t ys = (size_t)16 * mbw, uvs = (size_t)8 * mbw;
  const int last_pair = (w - 1) >> 1;
  std::vector<uint8_t> cu(w), cv(w);
  for (int r = 0; r < h; ++r) {
    // the chroma rows above and below the output row, and which of the
    // pair it is
    int top_c, cur_c;
    bool bottom = false;
    if (r == 0) {
      top_c = cur_c = 0;
    } else if (r & 1) {
      top_c = (r - 1) >> 1;
      cur_c = r + 1 < h ? top_c + 1 : top_c;
    } else {
      top_c = r / 2 - 1;
      cur_c = r / 2;
      bottom = true;
    }
    for (int ch = 0; ch < 2; ++ch) {
      const uint8_t* plane = ch ? V.data() : U.data();
      const uint8_t* t = plane + (size_t)top_c * uvs;
      const uint8_t* c = plane + (size_t)cur_c * uvs;
      uint8_t* o = ch ? cv.data() : cu.data();
      // the "top" role weights the first row 3 to 1, "bottom" the second
      const uint8_t* near = bottom ? c : t;
      const uint8_t* far = bottom ? t : c;
      o[0] = (uint8_t)((3 * near[0] + far[0] + 2) >> 2);
      for (int x = 1; x <= last_pair; ++x) {
        const int tl = t[x - 1], tt = t[x], l = c[x - 1], cc = c[x];
        const int avg = tl + tt + l + cc + 8;
        const int diag_12 = (avg + 2 * (tt + l)) >> 3;
        const int diag_03 = (avg + 2 * (tl + cc)) >> 3;
        if (!bottom) {
          o[2 * x - 1] = (uint8_t)((diag_12 + tl) >> 1);
          o[2 * x] = (uint8_t)((diag_03 + tt) >> 1);
        } else {
          o[2 * x - 1] = (uint8_t)((diag_03 + l) >> 1);
          o[2 * x] = (uint8_t)((diag_12 + cc) >> 1);
        }
      }
      if (!(w & 1))
        o[w - 1] = (uint8_t)((3 * near[last_pair] + far[last_pair] + 2) >> 2);
    }
    const uint8_t* yr = &Y[(size_t)r * ys];
    uint8_t* dst = out + (size_t)r * w * 3;
    for (int x = 0; x < w; ++x, dst += 3) {
      const int y = mult_hi(yr[x], 19077), u = cu[x], v = cv[x];
      dst[0] = yuv_clip(y + mult_hi(v, 26149) - 14234);
      dst[1] = yuv_clip(y - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
      dst[2] = yuv_clip(y + mult_hi(u, 33050) - 17685);
    }
  }
}

// PrecomputeFilterStrengths: per segment and for 16x16 / 4x4 macroblocks
void Decoder::precompute_filter() {
  if (filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base = level;
    if (use_segment)
      base = filter_strength[s] + (absolute_delta ? 0 : level);
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = fstrengths[s][i4x4];
      int lv = base;
      if (use_lf_delta) {
        lv += ref_lf_delta[0];
        if (i4x4) lv += mode_lf_delta[0];
      }
      lv = clamp(lv, 0, 63);
      info = FInfo();
      if (lv > 0) {
        int ilevel = lv;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          ilevel = std::min(ilevel, 9 - sharpness);
        }
        ilevel = std::max(ilevel, 1);
        info.ilevel = (uint8_t)ilevel;
        info.limit = (uint8_t)(2 * lv + ilevel);
        info.hev = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
      }
      info.inner = (uint8_t)i4x4;
    }
  }
}

// the whole frame into out[h][w][3]
void decode(const uint8_t* data, size_t n, uint8_t* out, int want_w,
            int want_h) {
  Decoder d;
  d.header(data, n);
  if (d.w != want_w || d.h != want_h)
    fail("WebP: VP8 size unlike its header's");
  d.precompute_filter();
  const size_t ys = (size_t)16 * d.mbw, uvs = (size_t)8 * d.mbw;
  d.intra_t.assign(4 * (size_t)d.mbw, B_DC);
  d.nz_top.assign(d.mbw, NZ());
  d.row.resize(d.mbw);
  d.finfo.assign((size_t)d.mbw * d.mbh, FInfo());
  d.top_y.assign(ys, 0);
  d.top_u.assign(uvs, 0);
  d.top_v.assign(uvs, 0);
  d.Y.assign(ys * 16 * d.mbh, 0);
  d.U.assign(uvs * 8 * d.mbh, 0);
  d.V.assign(uvs * 8 * d.mbh, 0);
  memset(d.yuv_b, 0, sizeof(d.yuv_b));
  for (int mb_y = 0; mb_y < d.mbh; ++mb_y) {
    BoolDec& tok = d.parts[mb_y & d.last_part];
    memset(d.intra_l, B_DC, 4);
    d.nz_left = NZ();
    for (int mb_x = 0; mb_x < d.mbw; ++mb_x) d.parse_modes(mb_x);
    if (d.br.eof) fail("WebP: VP8 first partition ends early");
    for (int mb_x = 0; mb_x < d.mbw; ++mb_x) {
      d.decode_mb(mb_x, mb_y, tok);
      if (tok.eof) fail("WebP: VP8 token partition ends early");
    }
    d.reconstruct_row(mb_y);
  }
  d.filter();
  d.to_rgb(out);
}

}  // namespace vp8

extern "C" {

// Header of a JPEG: its height, width and number of output channels (1 for
// grey, 3 for the rest). Refuses what isc_jpeg_decode refuses at the frame
// header.
int isc_jpeg_info(const uint8_t* data, long long n, int* h, int* w, int* c,
                  char* err, int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    j.parse(true);
    if (!j.sof) fail("JPEG: no frame header");
    *h = j.height;
    *w = j.width;
    *c = j.ncomp == 1 ? 1 : 3;
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, std::string("JPEG: ") + e.what());
    return 2;
  }
}

// Decode a JPEG into out [h][w][c] uint8 (c from isc_jpeg_info; grey
// stays one channel, YCbCr, RGB, CMYK and YCCK become RGB).
int isc_jpeg_decode(const uint8_t* data, long long n, uint8_t* out,
                    long long out_size, char* err, int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    j.parse(false);
    const Colour colour = j.colour();
    const int W = j.width, H = j.height;
    const size_t count = (size_t)W * H;
    if ((long long)count * (j.ncomp == 1 ? 1 : 3) != out_size)
      fail("JPEG: output buffer size");
    std::vector<std::vector<uint8_t>> full(j.ncomp);
    std::vector<uint8_t> plane;
    const bool smooth = smoothing_ok(j);
    for (int ci = 0; ci < j.ncomp; ++ci) {
      const Component& c = j.comp[ci];
      plane.assign((size_t)c.bh * 8 * c.bw * 8, 0);
      idct_plane(c, j.mcuy, smooth, plane.data(), j.last_good, j.scans);
      if (j.ncomp == 1) {
        upsample(c, plane.data(), j.hmax, j.vmax, W, H, out);
      } else {
        full[ci].resize(count);
        upsample(c, plane.data(), j.hmax, j.vmax, W, H, full[ci].data());
      }
    }
    if (colour == Colour::kYcc) {
      ycc_to_rgb(full[0].data(), full[1].data(), full[2].data(), count, out);
    } else if (colour == Colour::kRgb) {
      for (size_t i = 0; i < count; ++i)
        for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
    } else if (colour != Colour::kGrey) {
      const uint8_t* p[4] = {full[0].data(), full[1].data(), full[2].data(),
                             full[3].data()};
      cmyk_to_rgb(p, colour == Colour::kYcck, count, out);
    }
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, std::string("JPEG: ") + e.what());
    return 2;
  }
}

// PNG row filters undone: in holds h rows of (1 + rowbytes) bytes (the
// filter type, then the filtered row), out gets h rows of rowbytes. bpp is
// the filter's byte distance: bytes a pixel, at least 1.
int isc_png_unfilter(const uint8_t* in, long long n, uint8_t* out, int h,
                     long long rowbytes, int bpp, char* err, int errlen) {
  if (n < (long long)h * (rowbytes + 1)) {
    set_err(err, errlen, "PNG: truncated image data");
    return 1;
  }
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = in + (size_t)y * (rowbytes + 1);
    const int ft = src[0];
    ++src;
    uint8_t* row = out + (size_t)y * rowbytes;
    const uint8_t* up = y ? row - rowbytes : nullptr;
    switch (ft) {
      case 0:
        memcpy(row, src, (size_t)rowbytes);
        break;
      case 1:
        for (long long i = 0; i < rowbytes; ++i)
          row[i] = (uint8_t)(src[i] + (i >= bpp ? row[i - bpp] : 0));
        break;
      case 2:
        for (long long i = 0; i < rowbytes; ++i)
          row[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (long long i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0, b = up ? up[i] : 0;
          row[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long long i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0, b = up ? up[i] : 0;
          const int c = (i >= bpp && up) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        set_err(err, errlen,
                "PNG: corrupt data (row filter type " + std::to_string(ft) +
                    ")");
        return 1;
    }
  }
  return 0;
}


// Frame 0 of a GIF: the LZW image data at in[0, n) (the sub-blocks that
// follow the minimum code size byte, up to the end of the file) decoded
// into the frame [x0, x0 + fw) x [y0, y0 + fh) of plane [ph][pw] of
// palette indices, rows in the order 0::8, 4::8, 2::4, 1::2 when
// interlaced. As in Pillow: only a full frame ends the decoding; the
// decoder sees the data as ImageFile.load hands it over, 64 KiB
// (MAXBLOCK) at a time, and where it stops short of a whole sub-block, or
// at an end code, the next 64 KiB are read and the codes after it go on
// filling the frame, or, at the end of the file, the file is refused as
// truncated; a code past the next free entry is refused; the table stops
// growing at 4096 entries until a clear.
int isc_gif_lzw(const uint8_t* in, long long n, uint8_t* plane, long long pw,
                long long ph, long long x0, long long y0, long long fw,
                long long fh, int bits, int interlace, char* err,
                int errlen) {
  enum { kTable = 4096, kBits = 12 };
  const long long kChunk = 65536;
  if (bits < 0 || bits > kBits) {
    set_err(err, errlen, "GIF: bad LZW minimum code size " +
                             std::to_string(bits));
    return 1;
  }
  if (fw <= 0 || fh <= 0 || x0 < 0 || y0 < 0 || x0 + fw > pw ||
      y0 + fh > ph) {
    set_err(err, errlen, "GIF: frame outside the image");
    return 1;
  }
  std::vector<int> link(kTable, 0);
  std::vector<uint8_t> data(kTable, 0), buffer(kTable, 0);
  const int clear = 1 << bits, end = clear + 1;
  int next = 0, codesize = 0, codemask = 0, lastcode = 0, bufferindex = 0;
  uint8_t lastdata = 0;
  int state = 1;                  // 1: reset, 2: after a clear, 3: running
  long long blocksize = 0, pos = 0, avail = std::min(n, kChunk);
  auto more = [&]() -> bool {     // the next chunk, if the file has one
    if (avail == n) {
      set_err(err, errlen, "GIF: truncated image data");
      return false;
    }
    avail = std::min(n, avail + kChunk);
    return true;
  };
  uint32_t bitbuffer = 0;
  int bitcount = 0;
  // rows: pass (0 plain), step; the frame's (x, y)
  int pass = interlace ? 1 : 0;
  long long step = interlace ? 8 : 1, x = 0, y = 0;
  auto newline = [&]() -> bool {  // false once the frame is full
    x = 0;
    y += step;
    while (y >= fh) {
      if (pass == 1) {
        y = 4;
        pass = 2;
      } else if (pass == 2) {
        step = 4;
        y = 2;
        pass = 3;
      } else if (pass == 3) {
        step = 2;
        y = 1;
        pass = 0;
      } else {
        return false;
      }
    }
    return true;
  };
  for (;;) {
    if (state == 1) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      bufferindex = kTable;
      state = 2;
    }
    const uint8_t* p;
    int count;
    if (bufferindex < kTable) {   // the rest of the last string
      count = kTable - bufferindex;
      p = &buffer[bufferindex];
      bufferindex = kTable;
    } else {
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuffer |= (uint32_t)in[pos++] << bitcount;
          bitcount += 8;
          --blocksize;
        } else if (pos >= avail || avail - pos < (long long)in[pos] + 1) {
          if (!more()) return 1;  // a sub-block is decoded whole
        } else {
          blocksize = in[pos++];
        }
      }
      int c = (int)(bitbuffer & (uint32_t)codemask);
      bitbuffer >>= codesize;
      bitcount -= codesize;
      if (c == clear) {
        if (state != 2) state = 1;
        continue;
      }
      if (c == end) {
        if (!more()) return 1;
        continue;
      }
      count = 1;
      p = &lastdata;
      if (state == 2) {
        if (c > clear) {
          set_err(err, errlen, "GIF: corrupt image data (first code)");
          return 1;
        }
        lastdata = (uint8_t)c;
        lastcode = c;
        state = 3;
      } else {
        const int thiscode = c;
        if (c > next) {
          set_err(err, errlen, "GIF: corrupt image data (undefined code)");
          return 1;
        }
        if (c == next) {
          if (bufferindex <= 0) {
            set_err(err, errlen, "GIF: corrupt image data");
            return 1;
          }
          buffer[--bufferindex] = lastdata;
          c = lastcode;
        }
        while (c >= clear) {
          if (bufferindex <= 0 || c >= kTable) {
            set_err(err, errlen, "GIF: corrupt image data");
            return 1;
          }
          buffer[--bufferindex] = data[c];
          c = link[c];
        }
        lastdata = (uint8_t)c;
        if (next < kTable) {
          data[next] = (uint8_t)c;
          link[next] = lastcode;
          if (next == codemask && codesize < kBits) {
            ++codesize;
            codemask = (1 << codesize) - 1;
          }
          ++next;
        }
        lastcode = thiscode;
      }
    }
    for (int k = 0; k < count; ++k) {
      plane[(size_t)(y0 + y) * pw + x0 + x] = p[k];
      if (++x >= fw && !newline()) return 0;
    }
  }
}

// A BMP's RLE8 or RLE4 pixels (in[0, n): the file from the pixel data's
// offset `base` on) into out[h * w] palette indices, rows in the file's
// order: Pillow's BmpRleDecoder. An encoded run is cut at the row's end
// (its column count is not reset by a row that an absolute run or a delta
// filled); end of line pads the row with index 0; a delta skips the two
// bytes after it and takes right and up from the next two; an absolute run
// of RLE4 reads count / 2 bytes (two pixels a byte), then the file
// position is made even; end of bitmap, or the data running out, ends the
// pixels, and too few of them is refused.
int isc_bmp_rle(const uint8_t* in, long long n, long long base, uint8_t* out,
                long long w, long long h, int rle4, char* err, int errlen) {
  const long long dest = w * h;
  long long len = 0, x = 0, pos = 0;
  auto put = [&](uint8_t v) {
    if (len < dest) out[len] = v;
    ++len;
  };
  auto zeros = [&](long long k) {
    for (long long i = len; i < len + k && i < dest; ++i) out[i] = 0;
    len += k;
  };
  while (len < dest) {
    if (n - pos < 2) break;
    long long count = in[pos];
    const uint8_t b = in[pos + 1];
    pos += 2;
    if (count) {
      if (x + count > w) count = std::max(0LL, w - x);
      for (long long i = 0; i < count; ++i)
        put(rle4 ? (uint8_t)(i % 2 ? b & 15 : b >> 4) : b);
      x += count;
    } else if (b == 0) {          // end of line
      zeros((w - len % w) % w);
      x = 0;
    } else if (b == 1) {          // end of bitmap
      break;
    } else if (b == 2) {          // delta
      if (n - pos < 2) break;
      pos += 2;
      if (n - pos < 2) {
        set_err(err, errlen, "BMP: truncated RLE delta");
        return 1;
      }
      zeros(in[pos] + (long long)in[pos + 1] * w);
      pos += 2;
      x = len % w;
    } else {                      // absolute run
      const long long want = rle4 ? b / 2 : b;
      const long long got = std::min(want, n - pos);
      for (long long i = 0; i < got; ++i) {
        if (rle4) {
          put(in[pos + i] >> 4);
          put(in[pos + i] & 15);
        } else {
          put(in[pos + i]);
        }
      }
      pos += got;
      if (got < want) break;
      x += b;
      if ((base + pos) % 2) ++pos;
    }
  }
  if (len < dest) {
    set_err(err, errlen, "BMP: not enough RLE image data");
    return 1;
  }
  return 0;
}

// A VP8L bitstream (in[0, n): a VP8L chunk's payload, with its pad byte
// where the file holds one) of a w x h image into out[h][w][3], the RGB of
// its ARGB (libwebp's RGBA output, not premultiplied, the alpha dropped).
// The header must give w x h; the transforms are undone in the reverse
// order of their reading.
int isc_vp8l_decode(const uint8_t* in, long long n, uint8_t* out,
                    long long w, long long h, char* err, int errlen) {
  try {
    vp8l::Decoder d(in, (uint64_t)n);
    if (d.br.read(8) != 0x2f) fail("WebP: bad VP8L signature");
    const int iw = (int)d.br.read(14) + 1, ih = (int)d.br.read(14) + 1;
    d.br.read(1);                     // alpha_is_used: a hint only
    if (d.br.read(3) != 0) fail("WebP: unknown VP8L version");
    if (iw != w || ih != h) fail("WebP: VP8L size unlike its header's");
    std::vector<uint32_t> px = d.stream(iw, ih, true);
    for (int k = d.ntr - 1; k >= 0; --k) {
      const vp8l::Transform& t = d.tr[k];
      if (t.type == vp8l::kPredictor)
        vp8l::inverse_predictor(t, px.data(), ih);
      else if (t.type == vp8l::kCrossColour)
        vp8l::inverse_cross_colour(t, px.data(), ih);
      else if (t.type == vp8l::kSubtractGreen)
        vp8l::inverse_subtract_green(px.data(), px.size());
      else
        px = vp8l::inverse_indexing(t, px, ih);
    }
    for (size_t i = 0; i < px.size(); ++i) {
      out[3 * i] = (uint8_t)(px[i] >> 16);
      out[3 * i + 1] = (uint8_t)(px[i] >> 8);
      out[3 * i + 2] = (uint8_t)px[i];
    }
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, std::string("WebP: ") + e.what());
    return 2;
  }
}

// A VP8 key frame (in[0, n): a VP8 chunk's payload with its pad byte,
// where the file holds one, as libwebp's demuxer hands it over) of a w x h
// image into out[h][w][3], libwebp's RGB of it. The frame header must give
// w x h.
int isc_vp8_decode(const uint8_t* in, long long n, uint8_t* out,
                   long long w, long long h, char* err, int errlen) {
  try {
    vp8::decode(in, (size_t)n, out, (int)w, (int)h);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, std::string("WebP: ") + e.what());
    return 2;
  }
}

// The VP8L bitstream of a WebP ALPH chunk (in[0, n): after its header
// byte) of a w x h alpha plane: its image stream, with no VP8L header,
// decoded as libwebp decodes it, to refuse what libwebp refuses. The
// alpha itself is not kept (the decoders return RGB), so neither the
// inverse transforms nor the chunk's filtering and level reduction are
// undone.
int isc_vp8l_alpha_check(const uint8_t* in, long long n, long long w,
                         long long h, char* err, int errlen) {
  try {
    vp8l::Decoder d(in, (uint64_t)n);
    d.alpha = true;
    d.stream((int)w, (int)h, true);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, std::string("WebP: ") + e.what());
    return 2;
  }
}

// A PackBits strip or tile (in[0, n)) into out[0, out_n), as libtiff
// 4.7's PackBitsDecode fills it: a header byte of -128 is skipped; a run
// or a literal that reaches past the output is cut at its end (libtiff
// warns and goes on); data that ends before the output is full is
// refused, the rest of out zeroed (as libtiff leaves its buffer).
int isc_tiff_packbits(const uint8_t* in, long long n, uint8_t* out,
                      long long out_n, char* err, int errlen) {
  long long pos = 0, o = 0;
  while (pos < n && o < out_n) {
    long long k = (int8_t)in[pos++];
    if (k < 0) {                  // a run: the next byte 1 - k times
      if (k == -128) continue;
      k = std::min(1 - k, out_n - o);
      if (pos == n) break;
      memset(out + o, in[pos++], (size_t)k);
      o += k;
    } else {                      // a literal: the next k + 1 bytes
      k = std::min(k + 1, out_n - o);
      if (n - pos < k) break;
      memcpy(out + o, in + pos, (size_t)k);
      o += k;
      pos += k;
    }
  }
  if (o < out_n) {
    memset(out + o, 0, (size_t)(out_n - o));
    set_err(err, errlen, "TIFF: not enough PackBits data for the strip");
    return 1;
  }
  return 0;
}

// A TIFF page's JPEGTables field (in[0, n)) read into the page's tables
// (state, see TiffJpegTables) as libtiff's JPEGSetupDecode reads it: an
// abbreviated stream of tables (SOI, DQT and DHT, EOI), a frame or a scan
// refused.
int isc_tiff_jpeg_tables(const uint8_t* in, long long n, uint8_t* state,
                         char* err, int errlen) {
  try {
    Jpeg j(in, (size_t)n);
    j.tiff = true;
    load_tables(j, state);
    j.parse_tiff(true);
    save_tables(j, state);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, std::string("TIFF: JPEG: ") + e.what());
    return 2;
  }
}

// A JPEG-compressed (7) strip or tile (in[0, n)) as libtiff 4.7's
// JPEGPreDecode and JPEGDecode have libjpeg(-turbo) decode it for PIL, the
// page's tables (state) read and updated: the frame checked against the
// segment seg_w x seg_h (a taller one of equal width, where ``cut_ok``,
// the last strip, cut to its rows), against ``comps`` components and
// component 0's sampling (hs, vs; the rest 1 x 1); then min(rows, the
// frame's height) rows of the frame's width into out (rows of ``stride``
// bytes), YCbCr to RGB where ``rgb`` (libtiff's JPEGCOLORMODE_RGB), else
// the components as they are (JCS_UNKNOWN: no colour transform, whatever
// the markers say). A stream that leaves part of the need_w x need_h the
// page reads unwritten is refused by name: PIL reads whatever its buffer
// held there. A fault in the stream's markers (what libtiff's
// JPEGPreDecode, jpeg_read_header and its checks, refuses before a row is
// decoded) returns 3, any other 1 or 2.
int isc_tiff_jpeg(const uint8_t* in, long long n, uint8_t* state,
                  long long seg_w, long long seg_h, long long rows,
                  int cut_ok, int comps, int hs, int vs, int rgb,
                  long long need_w, long long need_h, uint8_t* out,
                  long long stride, char* err, int errlen) {
  try {
    Jpeg j(in, (size_t)n);
    j.tiff = true;
    j.seg.w = seg_w;
    j.seg.h = seg_h;
    j.seg.rows = rows;
    j.seg.cut_ok = cut_ok != 0;
    j.seg.comps = comps;
    j.seg.hs = hs;
    j.seg.vs = vs;
    load_tables(j, state);
    try {
      j.parse_tiff(false);
    } catch (const Error& e) {
      set_err(err, errlen, e.msg);
      return 3;
    }
    save_tables(j, state);
    const int W = j.width, H = (int)std::min<long long>(rows, j.height);
    const int oc = rgb ? 3 : j.ncomp;
    if ((rgb && j.ncomp != 3) || (long long)W * oc > stride)
      fail("TIFF: JPEG rows longer than the strip's");
    const size_t count = (size_t)W * H;
    std::vector<std::vector<uint8_t>> full(j.ncomp);
    std::vector<uint8_t> plane;
    const bool smooth = smoothing_ok(j);
    for (int ci = 0; ci < j.ncomp; ++ci) {
      const Component& c = j.comp[ci];
      plane.assign((size_t)c.bh * 8 * c.bw * 8, 0);
      idct_plane(c, j.mcuy, smooth, plane.data(), j.last_good, j.scans);
      full[ci].resize(count);
      upsample(c, plane.data(), j.hmax, j.vmax, W, H, full[ci].data());
    }
    std::vector<uint8_t> px(count * oc);
    if (rgb) {
      ycc_to_rgb(full[0].data(), full[1].data(), full[2].data(), count,
                 px.data());
    } else {
      for (size_t i = 0; i < count; ++i)
        for (int k = 0; k < oc; ++k) px[i * oc + k] = full[k][i];
    }
    for (int y = 0; y < H; ++y)
      memcpy(out + (size_t)y * stride, &px[(size_t)y * W * oc],
             (size_t)W * oc);
    if (W < need_w || H < need_h)
      j.unsupported("strip or tile of " + std::to_string(W) + "x" +
                    std::to_string(H) + " where the page reads " +
                    std::to_string(need_w) + "x" + std::to_string(need_h) +
                    " (PIL reads what its buffer held past it)");
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, std::string("TIFF: JPEG: ") + e.what());
    return 2;
  }
}

// An LZW strip or tile (in[0, n)) into out[0, out_n), as libtiff 4.7's
// tif_lzw.c decodes it whole: codes of 9 to 12 bits, 256 CLEAR, 257 EOI,
// 258 the first entry. New style (old 0, LZWDecode): codes MSB-first, one
// bit wider once the table holds 2^bits - 1 entries (TIFF's "early
// change"); old style (old 1, LZWDecodeCompat, which the caller chooses as
// LZWPreDecode does): LSB-first, one bit wider at 2^bits. The table starts
// unusable, so the first code must be CLEAR; after a CLEAR (or a run of
// them) a code above EOI is refused, and so is any code past the next free
// entry. The table has libtiff's slack of 1024 entries past 4095 (CSIZE),
// the codes staying 12 bits wide; once it is full only CLEAR or EOI may
// follow. EOI, or the end of the data, before out_n bytes is refused; a
// string longer than the room left is cut, and nothing after is read. A
// refused strip leaves out as libtiff leaves its buffer: what was decoded,
// then zeros (new style) or the bytes out held before (old style, whose
// LZWDecodeCompat clears nothing).
int isc_tiff_lzw(const uint8_t* in, long long n, uint8_t* out,
                 long long out_n, int old, char* err, int errlen) {
  enum { kClear = 256, kEoi = 257, kFirst = 258, kSize = 4095 + 1024 };
  std::vector<int32_t> prefix(kSize), len(kSize);
  std::vector<uint8_t> head(kSize), tail(kSize);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    len[i] = 1;
    head[i] = tail[i] = (uint8_t)i;
  }
  const uint64_t total = (uint64_t)n * 8;
  uint64_t pos = 0;
  int nbits = 9, next = -1, prev = -1;
  long long o = 0;
  try {
    auto code = [&]() -> int {
      if (pos + nbits > total)
        fail("TIFF: LZW data ends before the strip is full");
      const uint64_t at = pos >> 3;
      uint32_t v = 0;
      for (uint64_t k = 0; k < 3; ++k) {
        const uint32_t b = at + k < (uint64_t)n ? in[at + k] : 0;
        v |= old ? b << (8 * k) : b << (16 - 8 * k);
      }
      const int shift = old ? (int)(pos & 7) : 24 - (int)(pos & 7) - nbits;
      pos += nbits;
      return (int)((v >> shift) & ((1u << nbits) - 1));
    };
    while (o < out_n) {
      int c = code();
      if (c == kEoi) break;
      if (c == kClear) {
        do {
          next = kFirst;
          nbits = 9;
          c = code();
        } while (c == kClear);
        if (c == kEoi) break;
        if (c > kEoi) fail("TIFF: corrupt LZW data (a code after CLEAR)");
        out[o++] = (uint8_t)c;
        prev = c;
        continue;
      }
      if (next < 0 || c > next)
        fail("TIFF: corrupt LZW data (a code not yet in the table)");
      prefix[next] = prev;
      len[next] = len[prev] + 1;
      head[next] = head[prev];
      tail[next] = c < next ? head[c] : head[prev];
      if (++next > (1 << nbits) - (old ? 1 : 2)) {
        nbits = std::min(nbits + 1, 12);
        if (next >= kSize) next = -1;
      }
      const long long take = std::min<long long>(len[c], out_n - o);
      int e = c;
      for (long long k = len[c]; k > take; --k) e = prefix[e];
      for (long long k = take; k > 0; --k) {
        out[o + k - 1] = tail[e];
        e = prefix[e];
      }
      o += take;
      prev = c;
    }
  } catch (const Error& e) {
    if (!old) memset(out + o, 0, (size_t)(out_n - o));
    set_err(err, errlen, e.msg);
    return 1;
  }
  if (o < out_n) {
    if (!old) memset(out + o, 0, (size_t)(out_n - o));
    set_err(err, errlen, "TIFF: not enough LZW data for the strip");
    return 1;
  }
  return 0;
}

// A zlib stream (in[0, n)) inflated into out[0, out_n) as zlib's inflate
// writes it in one call with all of the input and out_n bytes of room, as
// libtiff's ZIPDecode makes it: the header's checks (a multiple of 31,
// method 8, a window of at most 32 KiB, no preset dictionary), stored,
// fixed and dynamic blocks with inflate_table's rules (an over-subscribed
// code refused, an incomplete one too but a single code of one bit in the
// literal/length and distance codes, whose other half is an invalid
// code), then the Adler-32 trailer. Once out is full the decoder reads on
// as zlib's does up to the next symbol that needs room (so a bad block
// header, an invalid code or a bad checksum just past it is still found,
// a distance too far back is not). Returns 0 where out is full (or the
// stream's end checks), 1 where the data is faulty, 2 where it ends
// before out is full; *wrote the bytes written, the rest of out untouched.
namespace inflate_impl {

struct Huff {                   // canonical code: counts a length, symbols
  int count[16];
  int symbol[320];
  int max, complete_or_single;
};

struct Stream {
  const uint8_t* in;
  long long n, pos;
  uint64_t bits;
  int nbits;
  uint8_t* out;
  long long out_n, o;
  int need(int k) {             // 0 where the input ends first
    while (nbits < k) {
      if (pos >= n) return 0;
      bits |= (uint64_t)in[pos++] << nbits;
      nbits += 8;
    }
    return 1;
  }
  uint32_t take(int k) {             // k <= 16
    const uint32_t v = (uint32_t)(bits & ((1u << k) - 1));
    bits >>= k;
    nbits -= k;
    return v;
  }
};

enum { kOk = 0, kBad = 1, kShort = 2, kFull = 3 };

// inflate_table's checks: -1 over-subscribed or incomplete (CODES always;
// LENS and DISTS but a single code of length 1); max 0: no symbols (every
// code invalid).
int build(Huff* h, const int* len, int n, bool codes) {
  for (int i = 0; i < 16; ++i) h->count[i] = 0;
  for (int i = 0; i < n; ++i) h->count[len[i]]++;
  h->max = 0;
  for (int i = 15; i >= 1; --i)
    if (h->count[i]) { h->max = i; break; }
  if (h->max == 0) return 0;
  int left = 1;
  for (int i = 1; i < 16; ++i) {
    left <<= 1;
    left -= h->count[i];
    if (left < 0) return -1;
  }
  if (left > 0 && (codes || h->max != 1)) return -1;
  int offs[16];
  offs[1] = 0;
  for (int i = 1; i < 15; ++i) offs[i + 1] = offs[i] + h->count[i];
  for (int i = 0; i < n; ++i)
    if (len[i]) h->symbol[offs[len[i]]++] = i;
  return 0;
}

// A symbol: >= 0, -1 an invalid code (none of the code's, or no codes),
// -2 the input ends first. Bits are pulled as the code grows, as zlib's
// table lookups pull bytes until the entry's length is in hand.
int decode(Stream* s, const Huff* h) {
  if (h->max == 0) {
    if (!s->need(1)) return -2;
    s->take(1);
    return -1;
  }
  int code = 0, first = 0, index = 0;
  for (int len = 1; len <= h->max; ++len) {
    if (!s->need(len)) return -2;
    code |= (int)((s->bits >> (len - 1)) & 1);
    const int count = h->count[len];
    if (code - count < first) {
      s->take(len);
      return h->symbol[index + (code - first)];
    }
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  s->take(h->max);              // the other half of a single 1-bit code
  return -1;
}

const int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  13,
                          15, 17, 19, 23, 27, 31, 35, 43,  51,  59,
                          67, 83, 99, 115, 131, 163, 195, 227, 258};
const int kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                           2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const int kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,
                           17,   25,   33,   49,   65,   97,    129,   193,
                           257,  385,  513,  769,  1025, 1537,  2049,  3073,
                           4097, 6145, 8193, 12289, 16385, 24577};
const int kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,
                            4, 4, 5, 5, 6, 6, 7, 7,  8,  8,
                            9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

int codes(Stream* s, const Huff* lens, const Huff* dists) {
  for (;;) {
    int sym = decode(s, lens);
    if (sym == -2) return kShort;
    if (sym < 0 || sym > 285) return kBad;
    if (sym < 256) {
      if (s->o == s->out_n) return kFull;
      s->out[s->o++] = (uint8_t)sym;
      continue;
    }
    if (sym == 256) return kOk;
    sym -= 257;
    if (!s->need(kLenExtra[sym])) return kShort;
    const long long len = kLenBase[sym] + s->take(kLenExtra[sym]);
    int d = decode(s, dists);
    if (d == -2) return kShort;
    if (d < 0 || d > 29) return kBad;
    if (!s->need(kDistExtra[d])) return kShort;
    const long long dist = kDistBase[d] + s->take(kDistExtra[d]);
    if (s->o == s->out_n) return kFull;
    if (dist > s->o) return kBad;
    const long long k = std::min(len, s->out_n - s->o);
    for (long long i = 0; i < k; ++i, ++s->o)
      s->out[s->o] = s->out[s->o - dist];
    if (k < len) return kFull;
  }
}

int blocks(Stream* s) {
  for (;;) {
    if (!s->need(3)) return kShort;
    const int last = (int)s->take(1), type = (int)s->take(2);
    int r;
    if (type == 0) {
      s->take(s->nbits & 7);
      if (!s->need(32)) return kShort;
      const uint32_t len = s->take(16), nlen = s->take(16);
      if (len != (~nlen & 0xffff)) return kBad;
      r = kOk;
      for (uint32_t i = 0; i < len; ++i) {
        if (s->o == s->out_n) { r = kFull; break; }
        if (!s->need(8)) { r = kShort; break; }
        s->out[s->o++] = (uint8_t)s->take(8);
      }
    } else if (type == 1) {
      int len[320];
      for (int i = 0; i < 288; ++i)
        len[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
      for (int i = 0; i < 32; ++i) len[288 + i] = 5;
      Huff l, d;
      build(&l, len, 288, false);
      build(&d, len + 288, 32, false);
      r = codes(s, &l, &d);
    } else if (type == 2) {
      if (!s->need(14)) return kShort;
      const int nlen = (int)s->take(5) + 257, ndist = (int)s->take(5) + 1;
      const int ncode = (int)s->take(4) + 4;
      if (nlen > 286 || ndist > 30) return kBad;
      static const int order[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                    11, 4,  12, 3, 13, 2, 14, 1, 15};
      int len[320] = {0};
      for (int i = 0; i < ncode; ++i) {
        if (!s->need(3)) return kShort;
        len[order[i]] = (int)s->take(3);
      }
      Huff cl;
      if (build(&cl, len, 19, true) < 0) return kBad;
      int have = 0;
      int lens[320] = {0};
      while (have < nlen + ndist) {
        int sym;
        if (cl.max == 0) {      // no code: each symbol 0, one bit
          if (!s->need(1)) return kShort;
          s->take(1);
          sym = 0;
        } else {
          sym = decode(s, &cl);
          if (sym == -2) return kShort;
        }
        if (sym < 16) {
          lens[have++] = sym;
          continue;
        }
        int v = 0, rep;
        if (sym == 16) {
          if (!s->need(2)) return kShort;
          if (have == 0) return kBad;
          v = lens[have - 1];
          rep = 3 + (int)s->take(2);
        } else if (sym == 17) {
          if (!s->need(3)) return kShort;
          rep = 3 + (int)s->take(3);
        } else {
          if (!s->need(7)) return kShort;
          rep = 11 + (int)s->take(7);
        }
        if (have + rep > nlen + ndist) return kBad;
        while (rep--) lens[have++] = v;
      }
      if (lens[256] == 0) return kBad;
      Huff l, d;
      if (build(&l, lens, nlen, false) < 0) return kBad;
      if (build(&d, lens + nlen, ndist, false) < 0) return kBad;
      r = codes(s, &l, &d);
    } else {
      return kBad;
    }
    if (r != kOk) return r;
    if (last) return kOk;
  }
}

}  // namespace inflate_impl

int isc_tiff_inflate(const uint8_t* in, long long n, uint8_t* out,
                     long long out_n, long long* wrote, char* err,
                     int errlen) {
  using namespace inflate_impl;
  Stream s{in, n, 0, 0, 0, out, out_n, 0};
  int r;
  if (!s.need(16)) {
    r = kShort;
  } else {
    const uint32_t cmf = s.take(8), flg = s.take(8);
    if (((cmf << 8) | flg) % 31 || (cmf & 15) != 8 || (cmf >> 4) > 7 ||
        (flg & 32)) {
      r = kBad;
    } else {
      r = blocks(&s);
      if (r == kOk) {           // the trailer: Adler-32 of all written
        s.take(s.nbits & 7);
        if (!s.need(32)) {
          r = kShort;
        } else {
          uint32_t want = 0;
          for (int k = 0; k < 4; ++k) want = want << 8 | s.take(8);
          uint32_t a = 1, b = 0;
          for (long long i = 0; i < s.o; ++i) {
            a = (a + s.out[i]) % 65521;
            b = (b + a) % 65521;
          }
          r = (b << 16 | a) == want ? kOk : kBad;
        }
      }
    }
  }
  *wrote = s.o;
  if (r == kFull || (r != kBad && s.o == out_n)) return 0;
  set_err(err, errlen, r == kBad ? "TIFF: corrupt Deflate data"
                                 : "TIFF: not enough Deflate data");
  return r == kBad ? 1 : 2;
}

// CCITT fax (TIFF compressions 2, 3, 4 and 32771) as libtiff 4.7's
// tif_fax3.c decodes it: the state tables of mkg3states, the bit
// accumulator read a byte at a time through libtiff's bit-reversal table,
// Fax3DecodeRLE, Fax3Decode1D, Fax3Decode2D and Fax4Decode with their
// recovery from bad codes (CLEANUP_RUNS pads a short row white and clips a
// long one), _TIFFFax3fillruns.
namespace fax_impl {

enum : uint8_t { kNull, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW, kTermB,
                 kMakeUpW, kMakeUpB, kMakeUp, kEol };

struct Ent {
  uint8_t state, width;
  uint32_t param;
};

// T.4's codes, first bit first: terminating codes for runs 0-63, make-up
// codes for 64-1728 of each colour, and the make-up codes for 1792-2560
// that both colours share
const char* const kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
const char* const kWhiteMakeUp[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
const char* const kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kBlackMakeUp[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* const kExtMakeUp[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

// mkg3states' tables: a code's entry at every index whose low bits (the
// code's first bit lowest) are the code; indices no code reaches stay
// kNull, of width 0
struct Tables {
  Ent main[128], white[4096], black[8192];
  uint8_t rev[256];
  static void put(Ent* t, int bits, const char* code, uint8_t state,
                  uint32_t param) {
    const int w = (int)strlen(code);
    int v = 0;
    for (int i = 0; i < w; ++i) v |= (code[i] == '1') << i;
    for (int c = v; c < 1 << bits; c += 1 << w)
      t[c] = Ent{state, (uint8_t)w, param};
  }
  Tables() : main(), white(), black() {
    put(main, 7, "0001", kPass, 0);
    put(main, 7, "001", kHoriz, 0);
    put(main, 7, "1", kV0, 0);
    put(main, 7, "011", kVR, 1);
    put(main, 7, "000011", kVR, 2);
    put(main, 7, "0000011", kVR, 3);
    put(main, 7, "010", kVL, 1);
    put(main, 7, "000010", kVL, 2);
    put(main, 7, "0000010", kVL, 3);
    put(main, 7, "0000001", kExt, 0);
    put(main, 7, "0000000", kEol, 0);
    for (int i = 0; i < 27; ++i) {
      put(white, 12, kWhiteMakeUp[i], kMakeUpW, 64 * (i + 1));
      put(black, 13, kBlackMakeUp[i], kMakeUpB, 64 * (i + 1));
    }
    for (int i = 0; i < 13; ++i) {
      put(white, 12, kExtMakeUp[i], kMakeUp, 1792 + 64 * i);
      put(black, 13, kExtMakeUp[i], kMakeUp, 1792 + 64 * i);
    }
    for (int i = 0; i < 64; ++i) {
      put(white, 12, kWhiteTerm[i], kTermW, i);
      put(black, 13, kBlackTerm[i], kTermB, i);
    }
    put(white, 12, "00000000000", kEol, 0);
    put(black, 13, "00000000000", kEol, 0);
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int k = 0; k < 8; ++k) r |= (i >> k & 1) << (7 - k);
      rev[i] = (uint8_t)r;
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

enum { kRle = 0, kRlew = 1, kG31d = 2, kG32d = 3, kG4 = 4 };
enum { kNoEol = 1 };

// One strip or tile. The run arrays are libtiff's (sp->runs): two halves
// of nruns entries, curruns and refruns, that outlive the strip (a row's
// reference reads what earlier rows, or strips, left there); only their
// first cap entries are kept, the rest never written (zero, as libtiff's
// memset leaves them).
struct Strip {
  const uint8_t* in;
  long long n;
  int odd;                      // the data at an odd offset in the file
  uint8_t* out;
  long long rows, rowbytes;
  int32_t lastx;
  uint32_t* runs;
  long long cap;
  long long nruns;
  int* mode;
  long long* reach;             // a row's bits written, this strip or before
  long long done = 0;           // rows filled

  uint32_t rd(int half, long long k) const {
    return k < cap ? runs[half * cap + k] : 0;
  }
  void wr(int half, long long k, uint32_t v) {
    if (k >= cap) fail("TIFF: fax run array past its bound");
    runs[half * cap + k] = v;
  }
  // _TIFFFax3fillruns into row ``done``: runs clipped to lastx in place,
  // white bits cleared, black set; an odd count padded with a 0 run
  void fill(int half, long long pa) {
    if (pa & 1) wr(half, pa++, 0);
    uint8_t* row = out + done * rowbytes;
    const uint32_t last = (uint32_t)lastx;
    uint32_t x = 0;
    for (long long k = 0; k < pa; k += 2) {
      for (int c = 0; c < 2; ++c) {
        uint32_t run = rd(half, k + c);
        if (x + run > last || run > last) {
          run = last - x;
          wr(half, k + c, run);
        }
        if (!run) continue;
        for (uint32_t e = x + run; x < e;) {
          const uint32_t bx = x & 7;
          if (!bx && e - x >= 8) {
            const uint32_t nb = (e - x) >> 3;
            memset(row + (x >> 3), c ? 0xFF : 0, nb);
            x += nb * 8;
            continue;
          }
          const uint32_t k8 = std::min<uint32_t>(8 - bx, e - x);
          const uint8_t m = (uint8_t)(((0xFF00u >> k8) & 0xFF) >> bx);
          row[x >> 3] = c ? row[x >> 3] | m : row[x >> 3] & ~m;
          x += k8;
        }
      }
    }
    if (x > reach[done]) reach[done] = x;
    ++done;
  }
};

inline int32_t wrap(uint32_t v) { return (int32_t)v; }

// ---- the macros of libtiff's fax3.h, over Strip s and the locals below
#define FAX_NEED8(n, eoflab)                                  \
  do {                                                        \
    if (avail < (n)) {                                        \
      if (cp >= ep) {                                         \
        if (avail == 0) goto eoflab;                          \
        avail = (n);                                          \
      } else {                                                \
        acc |= (uint32_t)rev[in[cp++]] << avail;              \
        avail += 8;                                           \
      }                                                       \
    }                                                         \
  } while (0)
#define FAX_NEED16(n, eoflab)                                 \
  do {                                                        \
    if (avail < (n)) {                                        \
      if (cp >= ep) {                                         \
        if (avail == 0) goto eoflab;                          \
        avail = (n);                                          \
      } else {                                                \
        acc |= (uint32_t)rev[in[cp++]] << avail;              \
        if ((avail += 8) < (n)) {                             \
          if (cp >= ep) {                                     \
            avail = (n);                                      \
          } else {                                            \
            acc |= (uint32_t)rev[in[cp++]] << avail;          \
            avail += 8;                                       \
          }                                                   \
        }                                                     \
      }                                                       \
    }                                                         \
  } while (0)
#define FAX_BITS(n) (acc & ((1u << (n)) - 1))
#define FAX_CLR(n)  \
  do {              \
    avail -= (n);   \
    acc >>= (n);    \
  } while (0)
#define FAX_LOOKUP8(wid, tab, eoflab) \
  do {                                \
    FAX_NEED8(wid, eoflab);           \
    ent = &(tab)[FAX_BITS(wid)];      \
    FAX_CLR(ent->width);              \
  } while (0)
#define FAX_LOOKUP16(wid, tab, eoflab) \
  do {                                 \
    FAX_NEED16(wid, eoflab);           \
    ent = &(tab)[FAX_BITS(wid)];       \
    FAX_CLR(ent->width);               \
  } while (0)
#define FAX_SET(x)                                        \
  do {                                                    \
    const uint32_t v_ = (uint32_t)(x);                    \
    if (pa >= s.nruns) return -1;                         \
    s.wr(cur, pa++, (uint32_t)run_len + v_);              \
    a0 = wrap((uint32_t)a0 + v_);                         \
    run_len = 0;                                          \
  } while (0)
// EOL search at the start of a row: 11 zero bits (where the row before
// did not end in an EOL), then any more zeros and the 1. Data that ends
// before the search begins fails the strip (eoflab); data that ends
// while zeros are skipped makes libtiff 4.7 take the page as Group 3
// without EOLs from then on and decode the strip again from its start,
// into the rows still to fill
#define FAX_SYNC_EOL(eoflab, retry)                        \
  do {                                                     \
    if (!(*s.mode & kNoEol)) {                             \
      if (eolcnt == 0) {                                   \
        for (;;) {                                         \
          FAX_NEED16(11, eoflab);                          \
          if (FAX_BITS(11) == 0) break;                    \
          FAX_CLR(1);                                      \
        }                                                  \
      }                                                    \
      for (;;) {                                           \
        FAX_NEED8(8, noeol);                               \
        if (FAX_BITS(8)) break;                            \
        FAX_CLR(8);                                        \
      }                                                    \
      while (FAX_BITS(1) == 0) FAX_CLR(1);                 \
      FAX_CLR(1);                                          \
      eolcnt = 0;                                          \
      break;                                               \
    noeol:                                                 \
      *s.mode |= kNoEol;                                   \
      goto retry;                                          \
    }                                                      \
  } while (0)
#define FAX_CLEANUP()                                                    \
  do {                                                                   \
    if (run_len) FAX_SET(0);                                             \
    if (a0 != lastx) {                                                   \
      while (a0 > lastx && pa > 0) a0 = wrap((uint32_t)a0 - s.rd(cur, --pa)); \
      if (a0 < lastx) {                                                  \
        if (a0 < 0) a0 = 0;                                              \
        if (pa & 1) FAX_SET(0);                                          \
        FAX_SET(lastx - a0);                                             \
      } else if (a0 > lastx) {                                           \
        FAX_SET(lastx);                                                  \
        FAX_SET(0);                                                      \
      }                                                                  \
    }                                                                    \
  } while (0)
#define FAX_EXPAND1D(eoflab)                                    \
  do {                                                          \
    for (;;) {                                                  \
      for (;;) {                                                \
        FAX_LOOKUP16(12, t.white, eof1d);                       \
        switch (ent->state) {                                   \
          case kEol:                                            \
            eolcnt = 1;                                         \
            goto done1d;                                        \
          case kTermW:                                          \
            FAX_SET(ent->param);                                \
            goto done_white1d;                                  \
          case kMakeUpW:                                        \
          case kMakeUp:                                         \
            a0 = wrap((uint32_t)a0 + ent->param);               \
            run_len = wrap((uint32_t)run_len + ent->param);     \
            break;                                              \
          default:                                              \
            goto done1d;                                        \
        }                                                       \
      }                                                         \
    done_white1d:                                               \
      if (a0 >= lastx) goto done1d;                             \
      for (;;) {                                                \
        FAX_LOOKUP16(13, t.black, eof1d);                       \
        switch (ent->state) {                                   \
          case kEol:                                            \
            eolcnt = 1;                                         \
            goto done1d;                                        \
          case kTermB:                                          \
            FAX_SET(ent->param);                                \
            goto done_black1d;                                  \
          case kMakeUpB:                                        \
          case kMakeUp:                                         \
            a0 = wrap((uint32_t)a0 + ent->param);               \
            run_len = wrap((uint32_t)run_len + ent->param);     \
            break;                                              \
          default:                                              \
            goto done1d;                                        \
        }                                                       \
      }                                                         \
    done_black1d:                                               \
      if (a0 >= lastx) goto done1d;                             \
      if (s.rd(cur, pa - 1) == 0 && s.rd(cur, pa - 2) == 0) pa -= 2; \
    }                                                           \
  eof1d:                                                        \
    FAX_CLEANUP();                                              \
    goto eoflab;                                                \
  done1d:                                                       \
    FAX_CLEANUP();                                              \
  } while (0)
#define FAX_CHECK_B1                                        \
  do {                                                      \
    if (pa != 0)                                            \
      while (b1 <= a0 && b1 < lastx) {                      \
        if (pb + 1 >= s.nruns) return -1;                   \
        b1 = wrap((uint32_t)b1 + s.rd(ref, pb) + s.rd(ref, pb + 1)); \
        pb += 2;                                            \
      }                                                     \
  } while (0)
#define FAX_EXPAND2D(eoflab)                                              \
  do {                                                                    \
    while (a0 < lastx) {                                                  \
      if (pa >= s.nruns) return -1;                                       \
      FAX_LOOKUP8(7, t.main, eof2d);                                      \
      switch (ent->state) {                                               \
        case kPass:                                                       \
          FAX_CHECK_B1;                                                   \
          if (pb + 1 >= s.nruns) return -1;                               \
          b1 = wrap((uint32_t)b1 + s.rd(ref, pb++));                      \
          run_len = wrap((uint32_t)run_len + (uint32_t)b1 - (uint32_t)a0); \
          a0 = b1;                                                        \
          b1 = wrap((uint32_t)b1 + s.rd(ref, pb++));                      \
          break;                                                          \
        case kHoriz:                                                      \
          if (pa & 1) {                                                   \
            for (;;) {                                                    \
              FAX_LOOKUP16(13, t.black, eof2d);                           \
              switch (ent->state) {                                       \
                case kTermB:                                              \
                  FAX_SET(ent->param);                                    \
                  goto done_white2da;                                     \
                case kMakeUpB:                                            \
                case kMakeUp:                                             \
                  a0 = wrap((uint32_t)a0 + ent->param);                   \
                  run_len = wrap((uint32_t)run_len + ent->param);         \
                  break;                                                  \
                default:                                                  \
                  goto bad2d;                                             \
              }                                                           \
            }                                                             \
          done_white2da:;                                                 \
            for (;;) {                                                    \
              FAX_LOOKUP16(12, t.white, eof2d);                           \
              switch (ent->state) {                                       \
                case kTermW:                                              \
                  FAX_SET(ent->param);                                    \
                  goto done_black2da;                                     \
                case kMakeUpW:                                            \
                case kMakeUp:                                             \
                  a0 = wrap((uint32_t)a0 + ent->param);                   \
                  run_len = wrap((uint32_t)run_len + ent->param);         \
                  break;                                                  \
                default:                                                  \
                  goto bad2d;                                             \
              }                                                           \
            }                                                             \
          done_black2da:;                                                 \
          } else {                                                        \
            for (;;) {                                                    \
              FAX_LOOKUP16(12, t.white, eof2d);                           \
              switch (ent->state) {                                       \
                case kTermW:                                              \
                  FAX_SET(ent->param);                                    \
                  goto done_white2db;                                     \
                case kMakeUpW:                                            \
                case kMakeUp:                                             \
                  a0 = wrap((uint32_t)a0 + ent->param);                   \
                  run_len = wrap((uint32_t)run_len + ent->param);         \
                  break;                                                  \
                default:                                                  \
                  goto bad2d;                                             \
              }                                                           \
            }                                                             \
          done_white2db:;                                                 \
            for (;;) {                                                    \
              FAX_LOOKUP16(13, t.black, eof2d);                           \
              switch (ent->state) {                                       \
                case kTermB:                                              \
                  FAX_SET(ent->param);                                    \
                  goto done_black2db;                                     \
                case kMakeUpB:                                            \
                case kMakeUp:                                             \
                  a0 = wrap((uint32_t)a0 + ent->param);                   \
                  run_len = wrap((uint32_t)run_len + ent->param);         \
                  break;                                                  \
                default:                                                  \
                  goto bad2d;                                             \
              }                                                           \
            }                                                             \
          done_black2db:;                                                 \
          }                                                               \
          FAX_CHECK_B1;                                                   \
          break;                                                          \
        case kV0:                                                         \
          FAX_CHECK_B1;                                                   \
          FAX_SET((uint32_t)b1 - (uint32_t)a0);                           \
          if (pb >= s.nruns) return -1;                                   \
          b1 = wrap((uint32_t)b1 + s.rd(ref, pb++));                      \
          break;                                                          \
        case kVR:                                                         \
          FAX_CHECK_B1;                                                   \
          FAX_SET((uint32_t)b1 - (uint32_t)a0 + ent->param);              \
          if (pb >= s.nruns) return -1;                                   \
          b1 = wrap((uint32_t)b1 + s.rd(ref, pb++));                      \
          break;                                                          \
        case kVL:                                                         \
          FAX_CHECK_B1;                                                   \
          if (b1 < wrap((uint32_t)a0 + ent->param)) goto bad2d;           \
          FAX_SET((uint32_t)b1 - (uint32_t)a0 - ent->param);              \
          if (pb < 1) fail("TIFF: fax reference run before its start");   \
          b1 = wrap((uint32_t)b1 - s.rd(ref, --pb));                      \
          break;                                                          \
        case kExt:                                                        \
          s.wr(cur, pa++, (uint32_t)(lastx - a0));                        \
          goto eol2d;                                                     \
        case kEol:                                                        \
          s.wr(cur, pa++, (uint32_t)(lastx - a0));                        \
          FAX_NEED8(4, eof2d);                                            \
          FAX_CLR(4);                                                     \
          eolcnt = 1;                                                     \
          goto eol2d;                                                     \
        default:                                                          \
        bad2d:                                                            \
          goto eol2d;                                                     \
        eof2d:                                                            \
          FAX_CLEANUP();                                                  \
          goto eoflab;                                                    \
      }                                                                   \
    }                                                                     \
    if (run_len) {                                                        \
      if (run_len + a0 < lastx) {                                         \
        FAX_NEED8(1, eof2d);                                              \
        if (!FAX_BITS(1)) goto bad2d;                                     \
        FAX_CLR(1);                                                       \
      }                                                                   \
      FAX_SET(0);                                                         \
    }                                                                     \
  eol2d:                                                                  \
    FAX_CLEANUP();                                                        \
  } while (0)

#define FAX_STATE                                   \
  const Tables& t = tables();                       \
  const uint8_t* const rev = t.rev;                 \
  const uint8_t* const in = s.in;                   \
  const int32_t lastx = s.lastx;                    \
  const Ent* ent;                                   \
  uint32_t acc;                                     \
  int avail, eolcnt;                                \
  long long cp, ep;                                 \
  int32_t a0, run_len;                              \
  long long pa;                                     \
  int cur = 0, ref = 1;                             \
  int32_t b1 = 0;                                   \
  long long pb = 0;                                 \
  (void)b1;                                         \
  (void)pb;                                         \
  (void)ref
#define FAX_CACHE \
  do {            \
    acc = 0;      \
    avail = 0;    \
    eolcnt = 0;   \
    cp = 0;       \
    ep = s.n;     \
  } while (0)

// Fax3DecodeRLE: rows of Modified Huffman codes, no EOLs, each starting
// at a byte (RLE) or, for RLEW, with the bits held cut to 16 and a byte
// skipped where the file's next word starts after it
int decode_rle(Strip& s, bool words) {
  FAX_STATE;
  (void)eolcnt;
  FAX_CACHE;
  while (s.done < s.rows) {
    a0 = 0;
    run_len = 0;
    pa = 0;
    FAX_EXPAND1D(eof);
    s.fill(cur, pa);
    if (!words) {
      const int k = avail - (avail & ~7);
      FAX_CLR(k);
    } else {
      const int k = avail - (avail & ~15);
      FAX_CLR(k);
      if (avail == 0 && ((s.odd + cp) & 1)) cp++;
    }
    continue;
  eof:
    s.fill(cur, pa);
    return -1;
  }
  return 1;
}

// Fax3Decode1D: an EOL, then a row of Modified Huffman codes
int decode_1d(Strip& s) {
  FAX_STATE;
retry:
  FAX_CACHE;
  while (s.done < s.rows) {
    a0 = 0;
    run_len = 0;
    pa = 0;
    FAX_SYNC_EOL(eof, retry);
    FAX_EXPAND1D(eof_a);
    s.fill(cur, pa);
    continue;
  eof:
    FAX_CLEANUP();
  eof_a:
    s.fill(cur, pa);
    return -1;
  }
  return 1;
}

// Fax3Decode2D: an EOL, a tag bit, then a row of Modified Huffman codes
// (1) or of modes against the row before (0)
int decode_2d(Strip& s) {
  FAX_STATE;
  int is1d;
retry:
  FAX_CACHE;
  while (s.done < s.rows) {
    a0 = 0;
    run_len = 0;
    pa = 0;
    FAX_SYNC_EOL(eof, retry);
    FAX_NEED8(1, eof);
    is1d = (int)FAX_BITS(1);
    FAX_CLR(1);
    pb = 0;
    b1 = wrap(s.rd(ref, pb++));
    if (is1d)
      FAX_EXPAND1D(eof_a);
    else
      FAX_EXPAND2D(eof_a);
    s.fill(cur, pa);
    if (pa < s.nruns) FAX_SET(0);
    std::swap(cur, ref);
    continue;
  eof:
    FAX_CLEANUP();
  eof_a:
    s.fill(cur, pa);
    return -1;
  }
  return 1;
}

// Fax4Decode: rows of modes against the row before, no EOLs, until EOFB
int decode_g4(Strip& s) {
  FAX_STATE;
  FAX_CACHE;
  while (s.done < s.rows) {
    a0 = 0;
    run_len = 0;
    pa = 0;
    pb = 0;
    b1 = wrap(s.rd(ref, pb++));
    FAX_EXPAND2D(eofb);
    if (eolcnt) goto eofb;
    s.fill(cur, pa);
    FAX_SET(0);
    std::swap(cur, ref);
    continue;
  eofb:
    s.fill(cur, pa);
    // a strip that ends early (EOFB, or the end of its data) after a row
    // is no error: the rows after it are left as they were
    return s.done > 1 ? 1 : -1;
  }
  return 1;
}

}  // namespace fax_impl

// A CCITT strip or tile (in[0, n), its bytes read first bit first) into
// rows of rowbytes bytes at out, width pixels each (a black run's bits
// set), as libtiff 4.7 decodes it for PIL. kind: 0 RLE (2), 1 RLEW
// (32771), 2 Group 3 1D, 3 Group 3 2D (3), 4 Group 4 (4). runs: the
// page's two run arrays, 2 x cap uint32 zeroed before its first strip, of
// nruns entries each to libtiff; *mode carries FAXMODE_NOEOL from strip
// to strip; odd: the data lies at an odd offset in the file (RLEW aligns
// rows to the file's 16-bit words). out is the caller's buffer, kept from
// strip to strip as Pillow keeps its own: reach[r] (rows entries) is
// raised to the bits of row r that this strip writes, so that a row's
// first reach[r] bits are known after it, from this strip or one before.
// Returns 0 where libtiff decodes the strip, 1 where it fails it (and PIL
// refuses the page).
int isc_tiff_fax(const uint8_t* in, long long n, uint8_t* out,
                 long long rows, long long rowbytes, long long width,
                 int kind, int odd, uint32_t* runs, long long cap,
                 long long nruns, int* mode, long long* reach, char* err,
                 int errlen) {
  using namespace fax_impl;
  Strip s{in, n, odd, out, rows, rowbytes, (int32_t)width, runs, cap,
          nruns, mode, reach};
  int rc;
  try {
    if (kind == kG32d || kind == kG4) {   // Fax3PreDecode: a white reference
      s.wr(1, 0, (uint32_t)width);
      s.wr(1, 1, 0);
    }
    rc = kind <= kRlew ? decode_rle(s, kind == kRlew)
         : kind == kG31d ? decode_1d(s)
         : kind == kG32d ? decode_2d(s)
                         : decode_g4(s);
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 2;
  }
  if (rc < 0) {
    set_err(err, errlen, "TIFF: CCITT data that libtiff fails to decode");
    return 1;
  }
  return 0;
}

// TIFF CIELAB to RGB as PIL converts it (Image.convert's LAB branch:
// LittleCMS 2.17, a built-in Lab v2 profile to its built-in sRGB, 8 bits
// in and out): each pixel's L, a, b bytes (in[i * step + k], as PIL's
// "LAB" mode holds them) widened to 16 bits (v * 257), then the
// 16-bit tetrahedral interpolation (TetrahedralInterp16) of the
// optimised transform's 33 x 33 x 33 table clut[L][a][b][3], then cut to
// 8 bits (FROM_16_TO_8) into out[i * 3 + k]. Differences of neighbouring
// nodes times the fractions are summed in 64 bits.
int isc_tiff_lab(const uint8_t* in, long long n, long long step,
                 const uint16_t* clut, uint8_t* out, char* err,
                 int errlen) {
  (void)err;
  (void)errlen;
  const long long opta[3] = {33 * 33 * 3, 33 * 3, 3};
  for (long long i = 0; i < n; ++i) {
    long long base[3], next[3], r[3];
    for (int k = 0; k < 3; ++k) {
      const long long v = in[i * step + k] * 257LL;
      const long long fx = v * 32 + (v * 32 + 0x7fff) / 0xffff;
      base[k] = opta[k] * (fx >> 16);
      next[k] = base[k] + (v == 0xffff ? 0 : opta[k]);
      r[k] = fx & 0xffff;
    }
    const long long X0 = base[0], Y0 = base[1], Z0 = base[2];
    const long long X1 = next[0], Y1 = next[1], Z1 = next[2];
    const long long rx = r[0], ry = r[1], rz = r[2];
    for (int o = 0; o < 3; ++o) {
      auto d = [&](long long x, long long y, long long z) {
        return (long long)clut[x + y + z + o];
      };
      const long long c0 = d(X0, Y0, Z0);
      long long c1, c2, c3;
      if (rx >= ry && ry >= rz) {
        c1 = d(X1, Y0, Z0) - c0;
        c2 = d(X1, Y1, Z0) - d(X1, Y0, Z0);
        c3 = d(X1, Y1, Z1) - d(X1, Y1, Z0);
      } else if (rx >= rz && rz >= ry) {
        c1 = d(X1, Y0, Z0) - c0;
        c2 = d(X1, Y1, Z1) - d(X1, Y0, Z1);
        c3 = d(X1, Y0, Z1) - d(X1, Y0, Z0);
      } else if (rz >= rx && rx >= ry) {
        c1 = d(X1, Y0, Z1) - d(X0, Y0, Z1);
        c2 = d(X1, Y1, Z1) - d(X1, Y0, Z1);
        c3 = d(X0, Y0, Z1) - c0;
      } else if (ry >= rx && rx >= rz) {
        c1 = d(X1, Y1, Z0) - d(X0, Y1, Z0);
        c2 = d(X0, Y1, Z0) - c0;
        c3 = d(X1, Y1, Z1) - d(X1, Y1, Z0);
      } else if (ry >= rz && rz >= rx) {
        c1 = d(X1, Y1, Z1) - d(X0, Y1, Z1);
        c2 = d(X0, Y1, Z0) - c0;
        c3 = d(X0, Y1, Z1) - d(X0, Y1, Z0);
      } else {
        c1 = d(X1, Y1, Z1) - d(X0, Y1, Z1);
        c2 = d(X0, Y1, Z1) - d(X0, Y0, Z1);
        c3 = d(X0, Y0, Z1) - c0;
      }
      const long long rest = c1 * rx + c2 * ry + c3 * rz + 0x8001;
      const long long w = (c0 + ((rest + (rest >> 16)) >> 16)) & 0xffff;
      out[i * 3 + o] = (uint8_t)(((w * 65281 + 8388608) >> 24) & 0xff);
    }
  }
  return 0;
}

}  // extern "C"

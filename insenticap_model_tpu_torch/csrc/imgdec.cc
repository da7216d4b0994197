// Host image decoding for the serving surface: baseline, extended-
// sequential and progressive Huffman JPEG, and PNG's row filters.
//
// The JAX package decodes with PIL (insenticap_model_tpu/preprocessing.py:
// 50-80); the machine that serves the port has no PIL, so the port decodes
// itself. The target is the pixels PIL gives, bit for bit: PIL decodes
// JPEG with libjpeg(-turbo)'s defaults, so this file follows libjpeg's
// integer paths exactly:
//
//  * entropy decoding: Huffman (DHT tables of any kind), DRI and RSTn
//    restart markers, interleaved and single-component scans, any number
//    of scans of SOF0, SOF1 or SOF2 at 8 bits. Progressive scans (T.81
//    Annex G, libjpeg-turbo's jdphuff.c) are DC first and refinement, AC
//    first (a band Ss..Se, EOB runs) and AC refinement, into whole-image
//    coefficient arrays; their parameters are checked as libjpeg's
//    start_pass_phuff_decoder checks them (what it refuses is refused,
//    what it only warns of is decoded);
//  * block smoothing: a progressive file that ends with some of AC
//    coefficients 1-9 still inexact (an incomplete progression) is
//    decoded as libjpeg-turbo 2.1+'s decompress_smooth_data does it;
//  * IDCT: jpeg_idct_islow (jidctint.c; CONST_BITS 13, PASS1_BITS 2) and
//    its range-limit table; libjpeg-turbo's SIMD versions give the same
//    numbers;
//  * upsampling: libjpeg-turbo's "fancy" upsampling, which PIL leaves on
//    (and which turns merged upsampling off): h2v1 and h2v2 triangle
//    filters where the component's downsampled width exceeds 2, h1v2 always,
//    plain replication otherwise and for any other integral ratio
//    (int_upsample). Edges replicate at the component's downsampled width
//    and height, ceil(size * h / hmax);
//  * colour: jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16),
//    range-limited.
//
// Refused, with a message that names what: lossless, hierarchical and
// arithmetic-coded JPEG, precision other than 8 bits, 2 or 4 or more
// components (CMYK, YCCK), and 3-component files that libjpeg takes as RGB
// (an Adobe marker with transform 0, or component ids 'R' 'G' 'B' without
// JFIF). A file that ends, or whose entropy data ends, before every block
// of every scan is decoded is refused as truncated (libjpeg would fill the
// rest with zeros and warn; PIL refuses a file that ends early).
//
// PNG: the Python side (preprocessing.py) parses the chunks, checks their
// CRCs and inflates IDAT with zlib; isc_png_unfilter undoes the five row
// filters, which run sequentially along a row (Sub, Paeth).
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
  bool defined = false;
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
  t.defined = true;
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
  // -1 before any; libjpeg's coef_bits
  int bits[64];
};

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

  Jpeg(const uint8_t* data, size_t len) : d(data), n(len) {}

  uint8_t byte() {
    if (pos >= n) fail("JPEG: truncated file");
    return d[pos++];
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  int next_marker() {
    // markers start with 0xFF; fill bytes 0xFF may precede the code
    uint8_t b = byte();
    while (b != 0xFF) b = byte();   // libjpeg skips such data with a warning
    do {
      b = byte();
    } while (b == 0xFF);
    if (b == 0) return next_marker();
    return b;
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
    if (prec != 8)
      fail("JPEG: unsupported: " + std::to_string(prec) +
           "-bit samples (only 8-bit baseline/extended sequential)");
    if (height == 0)
      fail("JPEG: unsupported: height 0 (DNL marker)");
    if (width == 0) fail("JPEG: width 0");
    if (ncomp == 4)
      fail("JPEG: unsupported: 4 components (CMYK/YCCK)");
    if (ncomp != 1 && ncomp != 3)
      fail("JPEG: unsupported: " + std::to_string(ncomp) + " components");
    if ((size_t)len != 8 + 3 * (size_t)ncomp) fail("JPEG: bad SOF length");
    comp.resize(ncomp);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("JPEG: bad sampling factors or table in the frame header");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    progressive = marker == 0xC2;
    pos = end;
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
    }
  }

  void parse_dqt() {
    const int len = word();
    const size_t end = pos + len - 2;
    while (pos < end) {
      const int pq_tq = byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("JPEG: bad quantisation table");
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
      make_huff(tc ? ac[th] : dc[th], counts, vals, total, tc == 0);
    }
    if (pos != end) fail("JPEG: bad DHT length");
  }

  void parse_app(int marker) {
    const int len = word();
    if (len < 2) fail("JPEG: bad segment length");
    const size_t start = pos, end = pos + len - 2;
    if (end > n) fail("JPEG: truncated file");
    if (marker == 0xE0 && len >= 7 && memcmp(d + start, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && len >= 14 && memcmp(d + start, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[start + 11];
    }
    pos = end;
  }

  void skip_segment() {
    const int len = word();
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
    while (bits <= 56) {
      uint8_t b = 0;
      bool data = false;
      if (!at_marker && pos < n) {
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

  void consume(int k) {
    if (k > real) fail("JPEG: truncated or corrupt entropy-coded data");
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
      if (l > 16) fail("JPEG: corrupt entropy-coded data (bad Huffman code)");
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
        k += r;
        if (k > 63) fail("JPEG: corrupt entropy-coded data (run past 63)");
        blk[kNatural[k]] = (int16_t)extend(get_bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void restart(int& expected) {
    // the rest of the byte is padding; the marker follows the data
    reset_bits();
    while (pos < n && !(d[pos] == 0xFF && pos + 1 < n && d[pos + 1] != 0 &&
                        d[pos + 1] != 0xFF))
      ++pos;
    if (pos + 1 >= n) fail("JPEG: truncated file (missing restart marker)");
    const int m = d[pos + 1];
    if (m != 0xD0 + expected)
      fail("JPEG: corrupt data (expected restart marker " +
           std::to_string(expected) + ")");
    pos += 2;
    expected = (expected + 1) & 7;
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
      int ci = -1;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) ci = j;
      if (ci < 0) fail("JPEG: scan names an unknown component");
      sc[i] = ci;
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3) fail("JPEG: bad scan table ids");
    }
    if (ns > 1) {
      int blocks = 0;
      for (int ci : sc) blocks += comp[ci].h * comp[ci].v;
      if (blocks > 10)   // libjpeg's D_MAX_BLOCKS_IN_MCU
        fail("JPEG: sampling factors too large for an interleaved scan");
    }
    const int ss = byte(), se = byte(), ahal = byte();
    const int ah = ahal >> 4, al = ahal & 15;
    if (!progressive && (ss != 0 || se != 63 || ahal != 0))
      fail("JPEG: bad spectral selection for a sequential scan");
    if (progressive) check_progression(ns, ss, se, ah, al);
    // the tables a scan reads: a DC refinement reads none
    const bool need_dc = !progressive || (ss == 0 && ah == 0);
    const bool need_ac = !progressive || ss != 0;
    for (int i = 0; i < ns; ++i)
      if ((need_dc && !dc[td[i]].defined) || (need_ac && !ac[ta[i]].defined))
        fail("JPEG: scan uses an undefined Huffman table");
    pos = end;
    for (int ci : sc) {
      Component& c = comp[ci];
      if (!c.latched) {
        if (!qdef[c.tq]) fail("JPEG: undefined quantisation table");
        memcpy(c.qt, qtab[c.tq], sizeof(c.qt));
        c.latched = true;
      }
      c.seen = true;
      if (progressive)
        for (int k = ss; k <= se; ++k) c.bits[k] = al;
    }

    reset_bits();
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
    for (long long m = 0; m < total; ++m) {
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
    reset_bits();
  }

  void parse(bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("JPEG: no SOI marker");
    pos = 2;
    for (;;) {
      const int m = next_marker();
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

  // libjpeg's colour space choice for 3 components (jdapimin.c)
  void check_colour() const {
    if (ncomp != 3) return;
    bool rgb = false;
    if (jfif) {
      rgb = false;
    } else if (adobe) {
      rgb = adobe_transform == 0;
    } else if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) {
      rgb = true;
    }
    if (rgb) fail("JPEG: unsupported: RGB colour transform (Adobe)");
  }
};

// -- IDCT: jpeg_idct_islow ------------------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr long kF0_298 = 2446, kF0_390 = 3196, kF0_541 = 4433,
               kF0_765 = 6270, kF0_899 = 7373, kF1_175 = 9633,
               kF1_501 = 12299, kF1_847 = 15137, kF1_961 = 16069,
               kF2_053 = 16819, kF2_562 = 20995, kF3_072 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

// the post-IDCT range limit: (x & 1023) as a signed 10-bit value, + 128,
// clamped to 0..255
inline uint8_t idct_limit(long x) {
  int v = (int)(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    long z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = (long)ip[16] * qp[16];
    z3 = (long)ip[48] * qp[48];
    z1 = (z2 + z3) * kF0_541;
    t2 = z1 + z3 * (-kF1_847);
    t3 = z1 + z2 * kF0_765;
    z2 = (long)ip[0] * qp[0];
    z3 = (long)ip[32] * qp[32];
    t0 = (z2 + z3) * (1L << kConstBits);
    t1 = (z2 - z3) * (1L << kConstBits);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = (long)ip[56] * qp[56];
    t1 = (long)ip[40] * qp[40];
    t2 = (long)ip[24] * qp[24];
    t3 = (long)ip[8] * qp[8];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * kF1_175;
    t0 *= kF0_298;
    t1 *= kF2_053;
    t2 *= kF3_072;
    t3 *= kF1_501;
    z1 *= -kF0_899;
    z2 *= -kF2_562;
    z3 *= -kF1_961;
    z4 *= -kF0_390;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    ws[c + 0] = (int)descale(t10 + t3, sh);
    ws[c + 56] = (int)descale(t10 - t3, sh);
    ws[c + 8] = (int)descale(t11 + t2, sh);
    ws[c + 48] = (int)descale(t11 - t2, sh);
    ws[c + 16] = (int)descale(t12 + t1, sh);
    ws[c + 40] = (int)descale(t12 - t1, sh);
    ws[c + 24] = (int)descale(t13 + t0, sh);
    ws[c + 32] = (int)descale(t13 - t0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    long z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * kF0_541;
    t2 = z1 + z3 * (-kF1_847);
    t3 = z1 + z2 * kF0_765;
    t0 = ((long)w[0] + w[4]) * (1L << kConstBits);
    t1 = ((long)w[0] - w[4]) * (1L << kConstBits);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = w[7];
    t1 = w[5];
    t2 = w[3];
    t3 = w[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * kF1_175;
    t0 *= kF0_298;
    t1 *= kF2_053;
    t2 *= kF3_072;
    t3 *= kF1_501;
    z1 *= -kF0_899;
    z2 *= -kF2_562;
    z3 *= -kF1_961;
    z4 *= -kF0_390;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(t10 + t3, sh));
    o[7] = idct_limit(descale(t10 - t3, sh));
    o[1] = idct_limit(descale(t11 + t2, sh));
    o[6] = idct_limit(descale(t11 - t2, sh));
    o[2] = idct_limit(descale(t12 + t1, sh));
    o[5] = idct_limit(descale(t12 - t1, sh));
    o[3] = idct_limit(descale(t13 + t0, sh));
    o[4] = idct_limit(descale(t13 - t0, sh));
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
void smooth_block(const Component& c, bool change_dc, const int* dc,
                  int16_t* ws) {
  auto D = [&](int i) -> long { return dc[i - 1]; };   // DC01 is D(1)
  const long q00 = (uint16_t)c.qt[0];
  auto estimate = [&](int zz, long num) {
    const int pos = kSmoothPos[zz], al = c.bits[zz];
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
void idct_plane(const Component& c, int imcu_rows, bool smooth,
                uint8_t* plane) {
  const int stride = c.bw * 8;
  const int rows_b = (c.dh + 7) / 8, cols_b = (c.dw + 7) / 8;
  bool change_dc = true;
  for (int k = 1; k < 10; ++k) change_dc = change_dc && c.bits[k] == -1;
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
        smooth_block(c, change_dc, dc, ws);
        blk = ws;
      }
      idct_islow(blk, c.qt, &plane[(size_t)by * 8 * stride + bx * 8], stride);
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

void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                size_t count, uint8_t* out) {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const long x = i - 128;
    cr_r[i] = (int)((fix(1.40200) * x + kOneHalf) >> kScaleBits);
    cb_b[i] = (int)((fix(1.77200) * x + kOneHalf) >> kScaleBits);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kOneHalf;
  }
  for (size_t i = 0; i < count; ++i) {
    const int yy = y[i], b = cb[i], r = cr[i];
    out[3 * i + 0] = clamp255(yy + cr_r[r]);
    out[3 * i + 1] = clamp255(yy + (int)((cb_g[b] + cr_g[r]) >> kScaleBits));
    out[3 * i + 2] = clamp255(yy + cb_b[b]);
  }
}

void set_err(char* err, int errlen, const std::string& m) {
  if (errlen <= 0) return;
  snprintf(err, (size_t)errlen, "%s", m.c_str());
}

}  // namespace

extern "C" {

// Header of a JPEG: its height, width and number of output channels (1 or
// 3). Refuses what isc_jpeg_decode refuses at the frame header.
int isc_jpeg_info(const uint8_t* data, long long n, int* h, int* w, int* c,
                  char* err, int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    j.parse(true);
    if (!j.sof) fail("JPEG: no frame header");
    *h = j.height;
    *w = j.width;
    *c = j.ncomp;
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
// stays one channel, YCbCr becomes RGB).
int isc_jpeg_decode(const uint8_t* data, long long n, uint8_t* out,
                    long long out_size, char* err, int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    j.parse(false);
    j.check_colour();
    const int W = j.width, H = j.height;
    if ((long long)W * H * j.ncomp != out_size)
      fail("JPEG: output buffer size");
    std::vector<std::vector<uint8_t>> full(j.ncomp);
    std::vector<uint8_t> plane;
    const bool smooth = smoothing_ok(j);
    for (int ci = 0; ci < j.ncomp; ++ci) {
      const Component& c = j.comp[ci];
      plane.assign((size_t)c.bh * 8 * c.bw * 8, 0);
      idct_plane(c, j.mcuy, smooth, plane.data());
      if (j.ncomp == 1) {
        upsample(c, plane.data(), j.hmax, j.vmax, W, H, out);
      } else {
        full[ci].resize((size_t)W * H);
        upsample(c, plane.data(), j.hmax, j.vmax, W, H, full[ci].data());
      }
    }
    if (j.ncomp == 3)
      ycc_to_rgb(full[0].data(), full[1].data(), full[2].data(),
                 (size_t)W * H, out);
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

}  // extern "C"

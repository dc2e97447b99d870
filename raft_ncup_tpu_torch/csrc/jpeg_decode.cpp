// Host JPEG decoder to 8-bit grey or RGB, with libjpeg-turbo's arithmetic
// so that its output equals libjpeg-turbo's (the default decompression
// settings: the "islow" integer IDCT, fancy upsampling, table-driven
// YCbCr -> RGB).
//
// Supported: 8-bit Huffman-coded baseline and extended sequential
// (SOF0, SOF1) and progressive (SOF2) frames, restart intervals, 1 or 3
// components with sampling factors of 1 or 2, JFIF and Adobe (APP14)
// colour transforms. Arithmetic coding, 12-bit samples, lossless and
// hierarchical frames and 4-component (CMYK/YCCK) images raise. Every
// read is bounds-checked; a malformed file returns an error code and a
// message, never a partial image.
//
// C interface (ctypes):
//   int jpeg_probe(data, size, &width, &height, &channels, msg, msg_len)
//   int jpeg_decode(data, size, out, width, height, channels, msg, msg_len)
//       out is caller-owned, height * width * channels bytes
// Both return 0 on success.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <exception>
#include <string>
#include <vector>

namespace {

struct DecodeError : std::exception {
  std::string msg;
  explicit DecodeError(std::string m) : msg(std::move(m)) {}
  const char* what() const noexcept override { return msg.c_str(); }
};

[[noreturn]] void fail(const std::string& m) { throw DecodeError(m); }

const char* kRoadmap = " (ROADMAP item 3c)";

// zigzag index -> natural (row-major) index; entries past 63 catch
// corrupt run lengths as libjpeg's table does
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct HuffTable {
  bool defined = false;
  int lookup[1 << 9];  // (len << 8) | value for codes up to 9 bits, 0 if longer
  int maxcode[18];
  int valoffset[18];
  uint8_t values[256];
  int count = 0;

  void build(const uint8_t* bits, const uint8_t* vals, int n, bool is_dc) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l - 1]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) fail("JPEG: bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l - 1]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l - 1];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    memcpy(values, vals, n);
    count = n;
    memset(lookup, 0, sizeof(lookup));
    p = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++p) {
        const int lookbits = huffcode[p] << (9 - l);
        for (int c = 0; c < (1 << (9 - l)); ++c) lookup[lookbits + c] = (l << 8) | vals[p];
      }
    }
    if (is_dc)
      for (int i = 0; i < n; ++i)
        if (vals[i] > 15) fail("JPEG: bad Huffman table (DC symbol)");
    defined = true;
  }
};

// Entropy-coded data: MSB first, 0xFF00 stuffing, zeros after a marker.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t buf = 0;
  int nbits = 0;
  bool hit_marker = false;

  BitReader(const uint8_t* d, size_t n, size_t p) : data(d), size(n), pos(p) {}
  void fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!hit_marker && pos < size) {
        byte = data[pos];
        if (byte == 0xff) {
          const int next = pos + 1 < size ? data[pos + 1] : -1;
          if (next == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;  // leave the marker for the caller
            byte = 0;
          }
        } else {
          ++pos;
        }
      } else {
        hit_marker = true;
      }
      buf |= (uint64_t)byte << (56 - nbits);
      nbits += 8;
    }
  }
  int peek(int n) {
    if (nbits < n) fill();
    return (int)(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    nbits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    const int v = peek(n);
    skip(n);
    return v;
  }
  int decode(const HuffTable& t) {
    const int look = peek(16);
    const int e = t.lookup[look >> 7];
    if (e) {
      skip(e >> 8);
      return e & 0xff;
    }
    int l = 10;
    while (l <= 16 && (look >> (16 - l)) > t.maxcode[l]) ++l;
    if (l > 16) {  // corrupt data: libjpeg warns and yields 0
      skip(16);
      return 0;
    }
    skip(l);
    const int idx = (look >> (16 - l)) + t.valoffset[l];
    return idx >= 0 && idx < t.count ? t.values[idx] : 0;
  }
  // byte-align and drop the buffer, e.g. before a restart marker
  void reset() {
    buf = 0;
    nbits = 0;
    hit_marker = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + 1 - (1 << s) : v; }

struct Component {
  int id, h, v, tq;
  int bw, bh;      // blocks allocated (whole MCUs)
  int wib, hib;    // blocks holding image data
  int dw, dh;      // samples holding image data
  std::vector<int16_t> coefs;
  uint16_t quant[64];
  bool quant_latched = false;
  int dc_pred = 0;
  int td = 0, ta = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  bool frame = false, progressive = false;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  std::vector<Component> comps;
  int eobrun = 0;
  bool saw_scan = false;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  int byte() {
    if (pos >= size) fail("JPEG: truncated file");
    return data[pos++];
  }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker() {
    // skip anything up to 0xFF, then fill bytes
    while (true) {
      if (pos >= size) fail("JPEG: truncated file (no EOI)");
      if (data[pos] != 0xff) {
        ++pos;
        continue;
      }
      while (pos < size && data[pos] == 0xff) ++pos;
      if (pos >= size) fail("JPEG: truncated file (no EOI)");
      const int m = data[pos++];
      if (m != 0x00) return m;
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      const int pq_tq = byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("JPEG: bad DQT");
      for (int i = 0; i < 64; ++i) {
        const int v = pq ? u16() : byte();
        qt[tq][kNaturalOrder[i]] = (uint16_t)v;
      }
      qt_defined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      const int tc_th = byte();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("JPEG: bad DHT");
      uint8_t bits[16];
      int n = 0;
      for (int i = 0; i < 16; ++i) {
        bits[i] = (uint8_t)byte();
        n += bits[i];
      }
      if (n > 256 || pos + n > end) fail("JPEG: bad DHT");
      uint8_t vals[256];
      for (int i = 0; i < n; ++i) vals[i] = (uint8_t)byte();
      (tc == 0 ? dc[th] : ac[th]).build(bits, vals, n, tc == 0);
    }
  }

  void read_sof(int marker, size_t end) {
    if (frame) fail("JPEG: more than one frame");
    const int precision = byte();
    if (precision != 8)
      fail("JPEG: " + std::to_string(precision) + "-bit samples are not supported" + kRoadmap);
    height = u16();
    width = u16();
    const int nc = byte();
    if (height == 0) fail(std::string("JPEG: DNL-defined height is not supported") + kRoadmap);
    if (width == 0) fail("JPEG: zero width");
    if ((uint64_t)width * height > (1ull << 28)) fail("JPEG: image too large");
    if (nc == 4) fail(std::string("JPEG: 4-component (CMYK/YCCK) images are not supported") + kRoadmap);
    if (nc != 1 && nc != 3) fail("JPEG: " + std::to_string(nc) + " components are not supported");
    if (pos + 3 * (size_t)nc > end) fail("JPEG: bad SOF");
    comps.resize(nc);
    for (Component& c : comps) {
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        fail(std::string("JPEG: sampling factors above 2 are not supported") + kRoadmap);
      if (c.tq > 3) fail("JPEG: bad quantization table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      c.coefs.assign((size_t)c.bw * c.bh * 64, 0);
    }
    progressive = marker == 0xc2;
    frame = true;
  }

  // One scan's entropy-coded data, then the marker that ends it.
  void read_sos(size_t end) {
    if (!frame) fail("JPEG: scan before frame header");
    const int ns = byte();
    if (ns < 1 || ns > 4 || pos + 2 * (size_t)ns + 3 > end) fail("JPEG: bad SOS");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = byte();
      const int tt = byte();
      Component* found = nullptr;
      for (Component& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("JPEG: scan names an unknown component");
      for (Component* o : sc)
        if (o == found) fail("JPEG: component twice in one scan");
      found->td = tt >> 4;
      found->ta = tt & 15;
      if (found->td > 3 || found->ta > 3) fail("JPEG: bad Huffman table index");
      sc.push_back(found);
    }
    const int ss = byte(), se = byte(), ahl = byte();
    const int ah = ahl >> 4, al = ahl & 15;
    pos = end;
    if (progressive) {
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) fail("JPEG: bad progressive scan");
      if (al > 13 || ah > 13) fail("JPEG: bad successive approximation");
    } else {
      if (ss != 0 || se != 63 || ah != 0 || al != 0) fail("JPEG: bad sequential scan");
    }
    for (Component* c : sc) {
      if (!c->quant_latched) {
        if (!qt_defined[c->tq]) fail("JPEG: undefined quantization table");
        memcpy(c->quant, qt[c->tq], sizeof(c->quant));
        c->quant_latched = true;
      }
      c->dc_pred = 0;
      const bool need_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !progressive || ss > 0;
      if (need_dc && !dc[c->td].defined) fail("JPEG: undefined DC Huffman table");
      if (need_ac && !ac[c->ta].defined) fail("JPEG: undefined AC Huffman table");
    }
    eobrun = 0;
    saw_scan = true;

    BitReader br(data, size, pos);
    int blocks_x, blocks_y;  // MCUs in this scan
    if (ns == 1) {
      blocks_x = sc[0]->wib;
      blocks_y = sc[0]->hib;
    } else {
      blocks_x = mcus_x;
      blocks_y = mcus_y;
    }
    const int64_t total = (int64_t)blocks_x * blocks_y;
    int restarts_left = restart_interval;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval) {
        if (restarts_left == 0) {
          // expect RSTn at the byte-aligned position
          pos = br.pos;
          const int mk = next_marker();
          if (mk < 0xd0 || mk > 0xd7) fail("JPEG: missing restart marker");
          if (mk != 0xd0 + next_rst) fail("JPEG: restart markers out of order");
          br.pos = pos;
          br.reset();
          next_rst = (next_rst + 1) & 7;
          restarts_left = restart_interval;
          for (Component* c : sc) c->dc_pred = 0;
          eobrun = 0;
        }
        --restarts_left;
      }
      const int mx = (int)(m % blocks_x), my = (int)(m / blocks_x);
      if (ns == 1) {
        decode_block(br, *sc[0], my, mx, ss, se, ah, al);
      } else {
        for (Component* c : sc)
          for (int v = 0; v < c->v; ++v)
            for (int h = 0; h < c->h; ++h)
              decode_block(br, *c, my * c->v + v, mx * c->h + h, ss, se, ah, al);
      }
    }
    pos = br.pos;
  }

  void decode_block(BitReader& br, Component& c, int by, int bx, int ss, int se, int ah, int al) {
    int16_t* blk = c.coefs.data() + ((size_t)by * c.bw + bx) * 64;
    if (!progressive) {
      const int t = br.decode(dc[c.td]);
      const int diff = t ? extend(br.get(t), t) : 0;
      c.dc_pred += diff;
      blk[0] = (int16_t)c.dc_pred;
      const HuffTable& act = ac[c.ta];
      for (int k = 1; k < 64; ++k) {
        const int rs = br.decode(act);
        const int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNaturalOrder[k]] = (int16_t)extend(br.get(s), s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (ah == 0) {
        const int t = br.decode(dc[c.td]);
        const int diff = t ? extend(br.get(t), t) : 0;
        c.dc_pred += diff;
        blk[0] = (int16_t)(c.dc_pred * (1 << al));
      } else if (br.get(1)) {
        blk[0] |= (int16_t)(1 << al);
      }
      return;
    }
    const HuffTable& act = ac[c.ta];
    if (ah == 0) {  // AC first pass
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        const int rs = br.decode(act);
        int r = rs >> 4;
        const int s = rs & 15;
        if (s) {
          k += r;
          blk[kNaturalOrder[k]] = (int16_t)(extend(br.get(s), s) * (1 << al));
        } else {
          if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            --eobrun;
            break;
          }
        }
      }
      return;
    }
    // AC refinement
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(act);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // a newly non-zero coefficient's sign
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNaturalOrder[k];
          if (*coef != 0) {
            if (br.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s && k <= 63) blk[kNaturalOrder[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNaturalOrder[k];
        if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
          *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun;
    }
  }

  // The markers and scans up to EOI; with 'header_only', up to the frame
  // header (the size and components), without the scans.
  void parse(bool header_only) {
    if (size < 2 || data[0] != 0xff || data[1] != 0xd8) fail("not a JPEG file (no SOI)");
    pos = 2;
    while (true) {
      const int m = next_marker();
      if (m == 0xd9) break;  // EOI
      if (m >= 0xd0 && m <= 0xd7) continue;  // stray RSTn
      if (m == 0x01) continue;               // TEM
      const size_t len = u16();
      if (len < 2 || pos + len - 2 > size) fail("JPEG: truncated segment");
      const size_t end = pos + len - 2;
      switch (m) {
        case 0xc0: case 0xc1: case 0xc2:
          read_sof(m, end);
          if (header_only) return;
          break;
        case 0xc3:
          fail(std::string("JPEG: lossless (SOF3) is not supported") + kRoadmap);
        case 0xc5: case 0xc6: case 0xc7:
          fail(std::string("JPEG: hierarchical frames are not supported") + kRoadmap);
        case 0xc9: case 0xca: case 0xcb: case 0xcd: case 0xce: case 0xcf: case 0xcc:
          fail(std::string("JPEG: arithmetic coding is not supported") + kRoadmap);
        case 0xc4:
          read_dht(end);
          break;
        case 0xdb:
          read_dqt(end);
          break;
        case 0xdd:
          if (len != 4) fail("JPEG: bad DRI");
          restart_interval = u16();
          break;
        case 0xdc:
          fail(std::string("JPEG: DNL markers are not supported") + kRoadmap);
        case 0xda:
          read_sos(end);
          continue;  // pos already past the scan
        case 0xe0:
          if (len >= 7 && memcmp(data + pos, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xee:
          if (len >= 14 && memcmp(data + pos, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = data[pos + 11];
          }
          break;
        default:
          break;  // APPn, COM and others are skipped
      }
      pos = end;
    }
    if (!frame || !saw_scan) fail("JPEG: no image data");
  }

  bool is_rgb() const {  // the colour space libjpeg-turbo infers
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
  }
};

// ---------------------------------------------------- islow IDCT (jidctint.c)
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// libjpeg's post-IDCT range limit: the value is masked to 10 bits first
inline uint8_t idct_limit(int64_t v) {
  const int i = (int)(v & 1023);
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* in = coef + col;
    const uint16_t* q = quant + col;
    int* w = ws + col;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      const int dcval = (int)(in[0] * q[0]) * (1 << kPass1Bits);
      for (int i = 0; i < 8; ++i) w[8 * i] = dcval;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * q[16], z3 = (int64_t)in[48] * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * q[0];
    z3 = (int64_t)in[32] * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                  tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * q[56];
    tmp1 = (int64_t)in[40] * q[40];
    tmp2 = (int64_t)in[24] * q[24];
    tmp3 = (int64_t)in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = (int)descale(tmp10 + tmp3, sh);
    w[56] = (int)descale(tmp10 - tmp3, sh);
    w[8] = (int)descale(tmp11 + tmp2, sh);
    w[48] = (int)descale(tmp11 - tmp2, sh);
    w[16] = (int)descale(tmp12 + tmp1, sh);
    w[40] = (int)descale(tmp12 - tmp1, sh);
    w[24] = (int)descale(tmp13 + tmp0, sh);
    w[32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int row = 0; row < 8; ++row) {
    const int* w = ws + 8 * row;
    uint8_t* o = out + (size_t)row * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t dcval = idct_limit(descale(w[0], kPass1Bits + 3));
      memset(o, dcval, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                  tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, sh));
    o[7] = idct_limit(descale(tmp10 - tmp3, sh));
    o[1] = idct_limit(descale(tmp11 + tmp2, sh));
    o[6] = idct_limit(descale(tmp11 - tmp2, sh));
    o[2] = idct_limit(descale(tmp12 + tmp1, sh));
    o[5] = idct_limit(descale(tmp12 - tmp1, sh));
    o[3] = idct_limit(descale(tmp13 + tmp0, sh));
    o[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

// ------------------------------------------------------------ upsampling
// A component's samples at full resolution (jdsample.c): fancy
// (triangle-filter) h2v1, h1v2 and h2v2, box replication otherwise.
struct Plane {
  int w, h;
  std::vector<uint8_t> px;
  const uint8_t* row(int y) const { return px.data() + (size_t)y * w; }
};

Plane upsample(const Plane& in, const Component& c, int hmax, int vmax, int out_w, int out_h) {
  const int hx = hmax / c.h, vx = vmax / c.v;
  if (hx == 1 && vx == 1) return in;
  Plane out;
  out.w = c.dw * hx;
  out.h = out_h;
  out.px.assign((size_t)out.w * out.h, 0);
  const int dw = c.dw, dh = c.dh;
  auto src = [&](int y) { return in.row(y < 0 ? 0 : y >= dh ? dh - 1 : y); };
  const bool fancy_h2 = hx == 2 && dw > 2;
  if (hx == 2 && vx == 1 && fancy_h2) {
    for (int y = 0; y < out_h; ++y) {
      const uint8_t* s = src(y);
      uint8_t* o = out.px.data() + (size_t)y * out.w;
      int v = s[0];
      o[0] = (uint8_t)v;
      o[1] = (uint8_t)((v * 3 + s[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        v = s[x] * 3;
        o[2 * x] = (uint8_t)((v + s[x - 1] + 1) >> 2);
        o[2 * x + 1] = (uint8_t)((v + s[x + 1] + 2) >> 2);
      }
      v = s[dw - 1];
      o[2 * dw - 2] = (uint8_t)((v * 3 + s[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = (uint8_t)v;
    }
  } else if (hx == 1 && vx == 2) {
    for (int y = 0; y < out_h; ++y) {
      const int iy = y >> 1;
      const uint8_t* s0 = src(iy);
      const uint8_t* s1 = src((y & 1) ? iy + 1 : iy - 1);
      const int bias = (y & 1) ? 2 : 1;
      uint8_t* o = out.px.data() + (size_t)y * out.w;
      for (int x = 0; x < dw; ++x) o[x] = (uint8_t)((s0[x] * 3 + s1[x] + bias) >> 2);
    }
  } else if (hx == 2 && vx == 2 && fancy_h2) {
    for (int y = 0; y < out_h; ++y) {
      const int iy = y >> 1;
      const uint8_t* s0 = src(iy);
      const uint8_t* s1 = src((y & 1) ? iy + 1 : iy - 1);
      uint8_t* o = out.px.data() + (size_t)y * out.w;
      int thiscol = s0[0] * 3 + s1[0];
      int nextcol = s0[1] * 3 + s1[1];
      o[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
      o[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int x = 1; x < dw - 1; ++x) {
        nextcol = s0[x + 1] * 3 + s1[x + 1];
        o[2 * x] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        o[2 * x + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      o[2 * dw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      o[2 * dw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
    }
  } else {  // box: replicate each sample hx by vx
    for (int y = 0; y < out_h; ++y) {
      const uint8_t* s = src(y / vx);
      uint8_t* o = out.px.data() + (size_t)y * out.w;
      for (int x = 0; x < out.w; ++x) o[x] = s[x / hx];
    }
  }
  (void)out_w;
  return out;
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
};

YccTables make_ycc_tables() {
  YccTables t;
  const int64_t one_half = (int64_t)1 << 15;
  auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    t.cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
    t.cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
    t.cr_g[i] = -fix(0.71414) * x;
    t.cb_g[i] = -fix(0.34414) * x + one_half;
  }
  return t;
}

void decode_to(Decoder& d, uint8_t* out, int channels) {
  const int W = d.width, H = d.height;
  std::vector<Plane> full;
  for (Component& c : d.comps) {
    Plane p;
    p.w = c.bw * 8;
    p.h = c.bh * 8;
    p.px.assign((size_t)p.w * p.h, 0);
    for (int by = 0; by < c.hib; ++by)
      for (int bx = 0; bx < c.wib; ++bx)
        idct_islow(c.coefs.data() + ((size_t)by * c.bw + bx) * 64, c.quant,
                   p.px.data() + (size_t)by * 8 * p.w + bx * 8, p.w);
    full.push_back(upsample(p, c, d.hmax, d.vmax, W, H));
  }
  if (channels == 1) {
    for (int y = 0; y < H; ++y) memcpy(out + (size_t)y * W, full[0].row(y), W);
    return;
  }
  if (d.is_rgb()) {
    for (int y = 0; y < H; ++y) {
      const uint8_t *r = full[0].row(y), *g = full[1].row(y), *b = full[2].row(y);
      uint8_t* o = out + (size_t)y * W * 3;
      for (int x = 0; x < W; ++x) {
        o[3 * x] = r[x];
        o[3 * x + 1] = g[x];
        o[3 * x + 2] = b[x];
      }
    }
    return;
  }
  // jdcolor.c: SCALEBITS 16, tables rounded as libjpeg builds them
  static const YccTables t = make_ycc_tables();
  auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (int y = 0; y < H; ++y) {
    const uint8_t *py = full[0].row(y), *pcb = full[1].row(y), *pcr = full[2].row(y);
    uint8_t* o = out + (size_t)y * W * 3;
    for (int x = 0; x < W; ++x) {
      const int Y = py[x], cb = pcb[x], cr = pcr[x];
      o[3 * x] = clamp(Y + t.cr_r[cr]);
      o[3 * x + 1] = clamp(Y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp(Y + t.cb_b[cb]);
    }
  }
}

int report(const std::exception& e, char* msg, size_t msg_len) {
  if (msg && msg_len) snprintf(msg, msg_len, "%s", e.what());
  return 1;
}

}  // namespace

extern "C" {

int jpeg_probe(const uint8_t* data, size_t size, int* width, int* height, int* channels,
               char* msg, size_t msg_len) {
  try {
    Decoder d(data, size);
    d.parse(true);
    *width = d.width;
    *height = d.height;
    *channels = (int)d.comps.size();
    return 0;
  } catch (const std::bad_alloc&) {
    if (msg && msg_len) snprintf(msg, msg_len, "out of memory");
    return 2;
  } catch (const std::exception& e) {
    return report(e, msg, msg_len);
  }
}

int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int width, int height,
                int channels, char* msg, size_t msg_len) {
  try {
    Decoder d(data, size);
    d.parse(false);
    if (d.width != width || d.height != height || (int)d.comps.size() != channels)
      fail("output size differs from the image");
    decode_to(d, out, channels);
    return 0;
  } catch (const std::bad_alloc&) {
    if (msg && msg_len) snprintf(msg, msg_len, "out of memory");
    return 2;
  } catch (const std::exception& e) {
    return report(e, msg, msg_len);
  }
}

}  // extern "C"

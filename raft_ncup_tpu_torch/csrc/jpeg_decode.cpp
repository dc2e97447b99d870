// Host JPEG decoder to 8-bit grey, RGB or CMYK, with libjpeg-turbo's
// arithmetic so that its output equals what Pillow returns through
// libjpeg-turbo (the default decompression settings: the "islow" integer
// IDCT, fancy upsampling, table-driven YCbCr -> RGB).
//
// Supported: 8-bit sequential (SOF0, SOF1, SOF9) and progressive (SOF2,
// SOF10) DCT frames, Huffman or arithmetic coded (the QM coder of ITU T.81
// Annex D with DAC conditioning), and lossless frames (SOF3, predictors 1
// to 7, point transform); restart intervals; 1, 3 or 4 components with
// sampling factors 1 to 4 in integral ratios (libjpeg-turbo's fancy h2v1,
// h1v2 and h2v2 upsampling where it applies, box replication otherwise,
// and box only in lossless frames); JFIF and Adobe (APP14) colour
// transforms. Four components come out as Pillow's "CMYK;I" reads them:
// CMYK samples inverted, YCCK converted to CMYK by libjpeg and then
// inverted. What Pillow refuses raises: samples of other than 8 bits,
// a DNL-defined height, hierarchical frames, arithmetic lossless frames,
// fractional sampling ratios, an interleaved MCU of more than 10 blocks
// and a colour transform in a lossless frame. Every read is
// bounds-checked; a malformed file returns an error code and a message,
// never a partial image.
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

// T.81 Table D.2 (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) by
// state; state 113 is libjpeg's fixed one-half bin, which never adapts.
const uint16_t kQM[114][4] = {
    {0x5A1D, 1, 1, 1},    {0x2586, 14, 2, 0},   {0x1114, 16, 3, 0},   {0x080B, 18, 4, 0},
    {0x03D8, 20, 5, 0},   {0x01DA, 23, 6, 0},   {0x00E5, 25, 7, 0},   {0x006F, 28, 8, 0},
    {0x0036, 30, 9, 0},   {0x001A, 33, 10, 0},  {0x000D, 35, 11, 0},  {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},  {0x0001, 12, 13, 0},  {0x5A7F, 15, 15, 1},  {0x3F25, 36, 16, 0},
    {0x2CF2, 38, 17, 0},  {0x207C, 39, 18, 0},  {0x17B9, 40, 19, 0},  {0x1182, 42, 20, 0},
    {0x0CEF, 43, 21, 0},  {0x09A1, 45, 22, 0},  {0x072F, 46, 23, 0},  {0x055C, 48, 24, 0},
    {0x0406, 49, 25, 0},  {0x0303, 51, 26, 0},  {0x0240, 52, 27, 0},  {0x01B1, 54, 28, 0},
    {0x0144, 56, 29, 0},  {0x00F5, 57, 30, 0},  {0x00B7, 59, 31, 0},  {0x008A, 60, 32, 0},
    {0x0068, 62, 33, 0},  {0x004E, 63, 34, 0},  {0x003B, 32, 35, 0},  {0x002C, 33, 9, 0},
    {0x5AE1, 37, 37, 1},  {0x484C, 64, 38, 0},  {0x3A0D, 65, 39, 0},  {0x2EF1, 67, 40, 0},
    {0x261F, 68, 41, 0},  {0x1F33, 69, 42, 0},  {0x19A8, 70, 43, 0},  {0x1518, 72, 44, 0},
    {0x1177, 73, 45, 0},  {0x0E74, 74, 46, 0},  {0x0BFB, 75, 47, 0},  {0x09F8, 77, 48, 0},
    {0x0861, 78, 49, 0},  {0x0706, 79, 50, 0},  {0x05CD, 48, 51, 0},  {0x04DE, 50, 52, 0},
    {0x040F, 50, 53, 0},  {0x0363, 51, 54, 0},  {0x02D4, 52, 55, 0},  {0x025C, 53, 56, 0},
    {0x01F8, 54, 57, 0},  {0x01A4, 55, 58, 0},  {0x0160, 56, 59, 0},  {0x0125, 57, 60, 0},
    {0x00F6, 58, 61, 0},  {0x00CB, 59, 62, 0},  {0x00AB, 61, 63, 0},  {0x008F, 61, 32, 0},
    {0x5B12, 65, 65, 1},  {0x4D04, 80, 66, 0},  {0x412C, 81, 67, 0},  {0x37D8, 82, 68, 0},
    {0x2FE8, 83, 69, 0},  {0x293C, 84, 70, 0},  {0x2379, 86, 71, 0},  {0x1EDF, 87, 72, 0},
    {0x1AA9, 87, 73, 0},  {0x174E, 72, 74, 0},  {0x1424, 72, 75, 0},  {0x119C, 74, 76, 0},
    {0x0F6B, 74, 77, 0},  {0x0D51, 75, 78, 0},  {0x0BB6, 77, 79, 0},  {0x0A40, 77, 48, 0},
    {0x5832, 80, 81, 1},  {0x4D1C, 88, 82, 0},  {0x438E, 89, 83, 0},  {0x3BDD, 90, 84, 0},
    {0x34EE, 91, 85, 0},  {0x2EAE, 92, 86, 0},  {0x299A, 93, 87, 0},  {0x2516, 86, 71, 0},
    {0x5570, 88, 89, 1},  {0x4CA9, 95, 90, 0},  {0x44D9, 96, 91, 0},  {0x3E22, 97, 92, 0},
    {0x3824, 99, 93, 0},  {0x32B4, 99, 94, 0},  {0x2E17, 93, 86, 0},  {0x56A8, 95, 96, 1},
    {0x4F46, 101, 97, 0}, {0x47E5, 102, 98, 0}, {0x41CF, 103, 99, 0}, {0x3C3D, 104, 100, 0},
    {0x375E, 99, 93, 0},  {0x5231, 105, 102, 0}, {0x4C0F, 106, 103, 0}, {0x4639, 107, 104, 0},
    {0x415E, 103, 99, 0}, {0x5627, 105, 106, 1}, {0x50E7, 108, 107, 0}, {0x4B85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504F, 111, 107, 0}, {0x5A10, 110, 111, 1}, {0x5522, 112, 109, 0},
    {0x59EB, 112, 111, 1}, {0x5A1D, 113, 113, 0}};

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
  int max_value = 0;  // a DC table's categories are checked against the frame

  void build(const uint8_t* bits, const uint8_t* vals, int n) {
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
    max_value = 0;
    for (int i = 0; i < n; ++i) max_value = std::max(max_value, (int)vals[i]);
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

// The QM arithmetic decoder of jdarith.c: the C register holds the code
// base and the next input bits, with a floating cut-point counted by ct.
// A marker met in the data stops the input (zeros follow), as libjpeg
// does; 'error' is libjpeg's ct = -1, which makes the rest of the restart
// interval decode nothing.
struct ArithReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  int64_t c = 0, a = 0;
  int ct = -16;
  int unread_marker = 0;
  size_t marker_pos = 0;  // the 0xFF before unread_marker
  bool error = false;

  ArithReader(const uint8_t* d, size_t n, size_t p) : data(d), size(n), pos(p) {}
  int get_byte() {
    if (pos >= size) fail("JPEG: truncated file");
    return data[pos++];
  }
  void restart() {
    c = 0;
    a = 0;
    ct = -16;
    error = false;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int byte = 0;
        if (!unread_marker) {
          byte = get_byte();
          if (byte == 0xff) {
            do byte = get_byte();
            while (byte == 0xff);
            if (byte == 0) {
              byte = 0xff;  // a stuffed zero
            } else {
              unread_marker = byte;
              marker_pos = pos - 2;
              byte = 0;
            }
          }
        }
        c = (c << 8) | byte;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    const uint16_t* e = kQM[sv & 0x7f];
    const int64_t qe = e[0];
    const int nl = e[1] | (e[3] << 7), nm = e[2];
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // a conditional exchange: the MPS after all
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// The statistics of an arithmetic-coded scan (64 DC bins and 256 AC bins a
// table, and the fixed one-half bin), cleared at each scan and restart.
struct ArithStats {
  uint8_t dc[4][64];
  uint8_t ac[4][256];
  uint8_t fixed = 113;
  void clear() {
    memset(dc, 0, sizeof(dc));
    memset(ac, 0, sizeof(ac));
  }
};

struct Component {
  int id, h, v, tq;
  int bw, bh;      // blocks (samples in a lossless frame) allocated: whole MCUs
  int wib, hib;    // blocks (samples) holding image data
  int dw, dh;      // samples holding image data
  std::vector<int16_t> coefs;  // DCT: 64 a block; lossless: one a sample
  uint16_t quant[64];
  bool quant_latched = false;
  int dc_pred = 0;
  int dc_context = 0;
  int td = 0, ta = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  // DAC conditioning by table, libjpeg's defaults (16 tables a class)
  uint8_t arith_dc_L[16] = {}, arith_dc_U[16] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
  uint8_t arith_ac_K[16] = {5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5};
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  bool frame = false, progressive = false, arithmetic = false, lossless = false;
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
      (tc == 0 ? dc[th] : ac[th]).build(bits, vals, n);
    }
  }

  // DAC: conditioning of the arithmetic coder's DC (L, U) and AC (Kx) bins
  void read_dac(size_t end) {
    while (pos < end) {
      const int index = byte(), val = byte();  // (Tc << 4) | Tb
      if (index >= 32) fail("JPEG: bad DAC table index");
      if (index >= 16) {
        arith_ac_K[index - 16] = (uint8_t)val;
      } else {
        arith_dc_L[index] = (uint8_t)(val & 15);
        arith_dc_U[index] = (uint8_t)(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index]) fail("JPEG: bad DAC value");
      }
    }
  }

  void read_sof(int marker, size_t end) {
    if (frame) fail("JPEG: more than one frame");
    const int precision = byte();
    if (precision != 8)
      fail("JPEG: " + std::to_string(precision) +
           "-bit samples (Pillow, the reference, reads 8-bit layers only)");
    height = u16();
    width = u16();
    const int nc = byte();
    if (height == 0) fail("JPEG: a DNL-defined height (libjpeg refuses an empty image)");
    if (width == 0) fail("JPEG: zero width");
    if ((uint64_t)width * height > (1ull << 28)) fail("JPEG: image too large");
    if (nc != 1 && nc != 3 && nc != 4)
      fail("JPEG: " + std::to_string(nc) + " components are not supported");
    if (pos + 3 * (size_t)nc > end) fail("JPEG: bad SOF");
    comps.resize(nc);
    for (Component& c : comps) {
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("JPEG: bad sampling factors");
      if (c.tq > 3) fail("JPEG: bad quantization table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (const Component& c : comps)
      if (hmax % c.h || vmax % c.v)
        fail("JPEG: a fractional sampling ratio (libjpeg does not upsample by one)");
    progressive = marker == 0xc2 || marker == 0xca;
    arithmetic = marker == 0xc9 || marker == 0xca;
    lossless = marker == 0xc3;
    const int unit = lossless ? 1 : 8;  // a lossless "block" is one sample
    mcus_x = (width + unit * hmax - 1) / (unit * hmax);
    mcus_y = (height + unit * vmax - 1) / (unit * vmax);
    for (Component& c : comps) {
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.wib = (c.dw + unit - 1) / unit;
      c.hib = (c.dh + unit - 1) / unit;
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      c.coefs.assign((size_t)c.bw * c.bh * (lossless ? 1 : 64), 0);
    }
    frame = true;
  }

  // One scan's entropy-coded data, then the marker that ends it.
  void read_sos(size_t end) {
    if (!frame) fail("JPEG: scan before frame header");
    const int ns = byte();
    if (ns < 1 || ns > 4 || pos + 2 * (size_t)ns + 3 > end) fail("JPEG: bad SOS");
    std::vector<Component*> sc;
    int blocks_in_mcu = 0;
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
      if (found->td > 3 || found->ta > 3) fail("JPEG: bad entropy table index");
      sc.push_back(found);
      blocks_in_mcu += found->h * found->v;
    }
    if (ns > 1 && blocks_in_mcu > 10)
      fail("JPEG: an interleaved MCU of " + std::to_string(blocks_in_mcu) +
           " blocks (libjpeg's limit is 10)");
    const int ss = byte(), se = byte(), ahl = byte();
    const int ah = ahl >> 4, al = ahl & 15;
    pos = end;
    if (lossless) {
      if (ss < 1 || ss > 7 || al > 7) fail("JPEG: bad lossless scan (predictor or point transform)");
    } else if (progressive) {
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) fail("JPEG: bad progressive scan");
      if (al > 13 || ah > 13) fail("JPEG: bad successive approximation");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      fail("JPEG: bad sequential scan");
    }
    for (Component* c : sc) {
      if (!lossless && !c->quant_latched) {
        if (!qt_defined[c->tq]) fail("JPEG: undefined quantization table");
        memcpy(c->quant, qt[c->tq], sizeof(c->quant));
        c->quant_latched = true;
      }
      c->dc_pred = 0;
      c->dc_context = 0;
      if (arithmetic) continue;
      const bool need_dc = lossless || !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !lossless && (!progressive || ss > 0);
      if (need_dc && !dc[c->td].defined) fail("JPEG: undefined DC Huffman table");
      // a lossless frame's difference categories run to 16
      if (need_dc && dc[c->td].max_value > (lossless ? 16 : 15))
        fail("JPEG: bad Huffman table (DC symbol)");
      if (need_ac && !ac[c->ta].defined) fail("JPEG: undefined AC Huffman table");
    }
    eobrun = 0;
    saw_scan = true;

    int blocks_x, blocks_y;  // MCUs in this scan
    if (ns == 1) {
      blocks_x = sc[0]->wib;
      blocks_y = sc[0]->hib;
    } else {
      blocks_x = mcus_x;
      blocks_y = mcus_y;
    }
    if (lossless) {
      read_lossless_scan(sc, blocks_x, blocks_y, ss, al);
    } else if (arithmetic) {
      read_arith_scan(sc, blocks_x, blocks_y, ss, se, ah, al);
    } else {
      read_huffman_scan(sc, blocks_x, blocks_y, ss, se, ah, al);
    }
  }

  // The byte-aligned RSTn a restart interval ends with; 'expected' counts.
  void expect_restart(int& expected) {
    const int mk = next_marker();
    if (mk < 0xd0 || mk > 0xd7) fail("JPEG: missing restart marker");
    if (mk != 0xd0 + expected) fail("JPEG: restart markers out of order");
    expected = (expected + 1) & 7;
  }

  template <typename Block>
  void for_each_block(const std::vector<Component*>& sc, int blocks_x, int64_t m, Block fn) {
    const int mx = (int)(m % blocks_x), my = (int)(m / blocks_x);
    if (sc.size() == 1) {
      fn(*sc[0], my, mx);
      return;
    }
    for (Component* c : sc)
      for (int v = 0; v < c->v; ++v)
        for (int h = 0; h < c->h; ++h) fn(*c, my * c->v + v, mx * c->h + h);
  }

  void read_huffman_scan(const std::vector<Component*>& sc, int blocks_x, int blocks_y, int ss,
                         int se, int ah, int al) {
    BitReader br(data, size, pos);
    const int64_t total = (int64_t)blocks_x * blocks_y;
    int restarts_left = restart_interval;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval) {
        if (restarts_left == 0) {
          pos = br.pos;
          expect_restart(next_rst);
          br.pos = pos;
          br.reset();
          restarts_left = restart_interval;
          for (Component* c : sc) c->dc_pred = 0;
          eobrun = 0;
        }
        --restarts_left;
      }
      for_each_block(sc, blocks_x, m, [&](Component& c, int by, int bx) {
        decode_block(br, c, by, bx, ss, se, ah, al);
      });
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

  // ------------------------------------------------- arithmetic (jdarith.c)
  void read_arith_scan(const std::vector<Component*>& sc, int blocks_x, int blocks_y, int ss,
                       int se, int ah, int al) {
    ArithReader ar(data, size, pos);
    ArithStats stats;
    stats.clear();
    const int64_t total = (int64_t)blocks_x * blocks_y;
    int restarts_left = restart_interval;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval) {
        if (restarts_left == 0) {
          if (ar.unread_marker) {
            pos = ar.marker_pos;  // the marker the coder stopped at
          } else {
            pos = ar.pos;
          }
          expect_restart(next_rst);
          ar.pos = pos;
          ar.unread_marker = 0;
          ar.restart();
          stats.clear();
          for (Component* c : sc) {
            c->dc_pred = 0;
            c->dc_context = 0;
          }
          restarts_left = restart_interval;
        }
        --restarts_left;
      }
      if (ar.error) continue;
      for_each_block(sc, blocks_x, m, [&](Component& c, int by, int bx) {
        if (!ar.error) arith_block(ar, stats, c, by, bx, ss, se, ah, al);
      });
    }
    pos = ar.unread_marker ? ar.marker_pos : ar.pos;
  }

  // A DC difference (F.2.4.1), updating the component's conditioning.
  int arith_dc_diff(ArithReader& ar, uint8_t* bins, Component& c) {
    uint8_t* st = bins + c.dc_context;
    if (ar.decode(st) == 0) {
      c.dc_context = 0;
      return 0;
    }
    const int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = bins + 20;  // X1
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.error = true;  // a magnitude overflow: corrupt data
          return 0;
        }
        st += 1;
      }
    }
    if (m < (int)((1L << arith_dc_L[c.td]) >> 1))
      c.dc_context = 0;
    else if (m > (int)((1L << arith_dc_U[c.td]) >> 1))
      c.dc_context = 12 + sign * 4;
    else
      c.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // An AC coefficient's magnitude from bin st (F.2.4.2, after the sign).
  int arith_ac_value(ArithReader& ar, ArithStats& stats, uint8_t* st, int k, int tbl, int sign) {
    int m = ar.decode(st);
    if (m != 0 && ar.decode(st)) {
      m <<= 1;
      st = stats.ac[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.error = true;
          return 0;
        }
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // AC coefficients Ss..Se of a first pass (or 1..63 of a sequential scan).
  void arith_ac_first(ArithReader& ar, ArithStats& stats, Component& c, int16_t* blk, int ss,
                      int se, int al) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats.ac[c.ta] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ar.error = true;  // a spectral overflow: corrupt data
          return;
        }
      }
      const int sign = ar.decode(&stats.fixed);
      const int v = arith_ac_value(ar, stats, st + 2, k, c.ta, sign);
      if (ar.error) return;
      blk[kNaturalOrder[k]] = (int16_t)(int)((unsigned)v << al);
    }
  }

  void arith_block(ArithReader& ar, ArithStats& stats, Component& c, int by, int bx, int ss,
                   int se, int ah, int al) {
    int16_t* blk = c.coefs.data() + ((size_t)by * c.bw + bx) * 64;
    if (!progressive) {
      const int diff = arith_dc_diff(ar, stats.dc[c.td], c);
      if (ar.error) return;
      c.dc_pred = (int16_t)(c.dc_pred + diff);
      blk[0] = (int16_t)c.dc_pred;
      arith_ac_first(ar, stats, c, blk, 1, 63, 0);
      return;
    }
    if (ss == 0 && ah == 0) {
      const int diff = arith_dc_diff(ar, stats.dc[c.td], c);
      if (ar.error) return;
      c.dc_pred += diff;
      blk[0] = (int16_t)(int)((unsigned)c.dc_pred << al);
      return;
    }
    if (ss == 0) {
      if (ar.decode(&stats.fixed)) blk[0] |= (int16_t)(1 << al);
      return;
    }
    if (ah == 0) {
      arith_ac_first(ar, stats, c, blk, ss, se, al);
      return;
    }
    // AC refinement (G.2.3.3): EOBx, the previous pass's end of block
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (blk[kNaturalOrder[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats.ac[c.ta] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      while (true) {
        int16_t* coef = blk + kNaturalOrder[k];
        if (*coef) {  // a previously non-zero coefficient
          if (ar.decode(st + 2)) *coef = (int16_t)(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (ar.decode(st + 1)) {  // newly non-zero
          *coef = (int16_t)(ar.decode(&stats.fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ar.error = true;
          return;
        }
      }
    }
  }

  // ------------------------------------------------------- lossless (SOF3)
  // Sample differences, Huffman coded (H.2); the prediction and point
  // transform run when the frame is complete (undifference()).
  void read_lossless_scan(const std::vector<Component*>& sc, int blocks_x, int blocks_y,
                          int predictor, int pt) {
    if (restart_interval && restart_interval % blocks_x)
      fail("JPEG: a lossless restart interval that is not whole MCU rows");
    BitReader br(data, size, pos);
    const int64_t total = (int64_t)blocks_x * blocks_y;
    int restarts_left = restart_interval;
    int next_rst = 0;
    for (Component* c : sc) {
      lossless_scans.push_back({c, predictor, pt, restart_interval ? restart_interval / blocks_x
                                                                   : 0});
    }
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval) {
        if (restarts_left == 0) {
          pos = br.pos;
          expect_restart(next_rst);
          br.pos = pos;
          br.reset();
          restarts_left = restart_interval;
        }
        --restarts_left;
      }
      for_each_block(sc, blocks_x, m, [&](Component& c, int by, int bx) {
        const int s = br.decode(dc[c.td]);
        int diff = 0;
        if (s == 16) {
          diff = 32768;
        } else if (s) {
          diff = extend(br.get(s), s);
        }
        c.coefs[(size_t)by * c.bw + bx] = (int16_t)diff;
      });
    }
    pos = br.pos;
  }

  struct LosslessScan {
    Component* c;
    int predictor, pt, rows_per_restart;
  };
  std::vector<LosslessScan> lossless_scans;

  // A component's samples from its differences (jdlossls.c): the first row
  // of the scan and of each restart interval predicts from the left (its
  // first sample from 1 << (7 - Pt)); other rows' first samples from above.
  std::vector<uint8_t> undifference(const Component& c) const {
    const LosslessScan* scan = nullptr;
    for (const LosslessScan& s : lossless_scans)
      if (s.c == &c) scan = &s;
    if (!scan) fail("JPEG: a component without a scan");
    const int w = c.dw, h = c.dh, pt = scan->pt;
    std::vector<int> prev(w), row(w);
    std::vector<uint8_t> out((size_t)w * h);
    for (int y = 0; y < h; ++y) {
      const int16_t* diff = c.coefs.data() + (size_t)y * c.bw;
      const bool first = y == 0 || (scan->rows_per_restart && y % scan->rows_per_restart == 0);
      for (int x = 0; x < w; ++x) {
        int pred;
        if (first) {
          pred = x == 0 ? 1 << (8 - pt - 1) : row[x - 1];
        } else if (x == 0) {
          pred = prev[0];
        } else {
          const int ra = row[x - 1], rb = prev[x], rc = prev[x - 1];
          switch (scan->predictor) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = ra + rb - rc; break;
            case 5: pred = ra + ((rb - rc) >> 1); break;
            case 6: pred = rb + ((ra - rc) >> 1); break;
            default: pred = (ra + rb) >> 1; break;
          }
        }
        row[x] = (diff[x] + pred) & 0xffff;
        out[(size_t)y * w + x] = (uint8_t)(row[x] << pt);
      }
      std::swap(prev, row);
    }
    return out;
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
        case 0xc0: case 0xc1: case 0xc2: case 0xc3: case 0xc9: case 0xca:
          read_sof(m, end);
          if (header_only) return;
          break;
        case 0xc5: case 0xc6: case 0xc7: case 0xcd: case 0xce: case 0xcf:
          fail("JPEG: a hierarchical frame (libjpeg-turbo refuses SOF5-7 and SOF13-15)");
        case 0xcb:
          fail("JPEG: an arithmetic-coded lossless frame (libjpeg-turbo refuses SOF11)");
        case 0xc4:
          read_dht(end);
          break;
        case 0xcc:
          read_dac(end);
          break;
        case 0xdb:
          read_dqt(end);
          break;
        case 0xdd:
          if (len != 4) fail("JPEG: bad DRI");
          restart_interval = u16();
          break;
        case 0xdc:
          fail("JPEG: a DNL marker (libjpeg refuses a DNL-defined height)");
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

  // The colour space libjpeg-turbo infers (jdapimin.c): 'R' RGB, 'Y'
  // YCbCr, 'C' CMYK, 'K' YCCK, 'G' grey.
  char colour_space() const {
    if (comps.size() == 1) return 'G';
    if (comps.size() == 4) return saw_adobe && adobe_transform != 0 ? 'K' : 'C';
    if (saw_jfif) return 'Y';
    if (saw_adobe) return adobe_transform == 0 ? 'R' : 'Y';
    if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66) return 'R';
    // components 1, 2, 3 (or others) with no marker: YCbCr, or RGB in a
    // lossless frame
    return lossless ? 'R' : 'Y';
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

Plane upsample(const Plane& in, const Component& c, int hmax, int vmax, int out_h, bool fancy) {
  const int hx = hmax / c.h, vx = vmax / c.v;
  if (hx == 1 && vx == 1) return in;
  Plane out;
  out.w = c.dw * hx;
  out.h = out_h;
  out.px.assign((size_t)out.w * out.h, 0);
  const int dw = c.dw, dh = c.dh;
  auto src = [&](int y) { return in.row(y < 0 ? 0 : y >= dh ? dh - 1 : y); };
  const bool fancy_h2 = fancy && hx == 2 && dw > 2;
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
  } else if (fancy && hx == 1 && vx == 2) {
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

// A component's samples at its own resolution: the IDCT of its blocks, or
// a lossless frame's undifferenced samples.
Plane component_plane(const Decoder& d, const Component& c) {
  Plane p;
  if (d.lossless) {
    p.w = c.dw;
    p.h = c.dh;
    p.px = d.undifference(c);
    return p;
  }
  p.w = c.bw * 8;
  p.h = c.bh * 8;
  p.px.assign((size_t)p.w * p.h, 0);
  for (int by = 0; by < c.hib; ++by)
    for (int bx = 0; bx < c.wib; ++bx)
      idct_islow(c.coefs.data() + ((size_t)by * c.bw + bx) * 64, c.quant,
                 p.px.data() + (size_t)by * 8 * p.w + bx * 8, p.w);
  return p;
}

void decode_to(Decoder& d, uint8_t* out, int channels) {
  const int W = d.width, H = d.height;
  const char space = d.colour_space();
  // libjpeg-turbo converts no colour in a lossless frame
  if (d.lossless && (space == 'Y' || space == 'K'))
    fail(std::string("JPEG: a lossless frame in ") + (space == 'Y' ? "YCbCr" : "YCCK") +
         " (libjpeg-turbo converts no colour in lossless mode)");
  std::vector<Plane> full;
  // fancy upsampling needs the DCT's 8x8 scaling (jdsample.c)
  for (Component& c : d.comps)
    full.push_back(upsample(component_plane(d, c), c, d.hmax, d.vmax, H, !d.lossless));
  if (channels == 1) {
    for (int y = 0; y < H; ++y) memcpy(out + (size_t)y * W, full[0].row(y), W);
    return;
  }
  if (space == 'R' || space == 'C') {  // samples as stored; CMYK inverted ("CMYK;I")
    const uint8_t flip = space == 'C' ? 0xff : 0;
    for (int y = 0; y < H; ++y) {
      uint8_t* o = out + (size_t)y * W * channels;
      for (int ch = 0; ch < channels; ++ch) {
        const uint8_t* src = full[ch].row(y);
        for (int x = 0; x < W; ++x) o[channels * x + ch] = src[x] ^ flip;
      }
    }
    return;
  }
  // jdcolor.c: SCALEBITS 16, tables rounded as libjpeg builds them. YCCK
  // becomes CMYK = 255 - RGB and K as stored, which "CMYK;I" inverts: RGB
  // and 255 - K.
  static const YccTables t = make_ycc_tables();
  auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (int y = 0; y < H; ++y) {
    const uint8_t *py = full[0].row(y), *pcb = full[1].row(y), *pcr = full[2].row(y);
    const uint8_t* pk = channels == 4 ? full[3].row(y) : nullptr;
    uint8_t* o = out + (size_t)y * W * channels;
    for (int x = 0; x < W; ++x) {
      const int Y = py[x], cb = pcb[x], cr = pcr[x];
      uint8_t* px = o + (size_t)channels * x;
      px[0] = clamp(Y + t.cr_r[cr]);
      px[1] = clamp(Y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      px[2] = clamp(Y + t.cb_b[cb]);
      if (pk) px[3] = (uint8_t)(255 - pk[x]);
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

// Host WebP decoder: the RIFF container, VP8 (lossy, RFC 6386 key frames)
// and VP8L (lossless), to 8-bit RGB. Alpha (ALPH, VP8L's alpha channel) is
// dropped. An animation gives its first frame as libwebp's WebPAnimDecoder
// (Pillow's reader) composites it: a key frame, decoded at its offset onto
// a canvas cleared to transparent black, with no blending (the ANIM
// background colour is a hint it does not use). The lossy path turns YUV 4:2:0 into RGB as libwebp does for
// RGB(A) output: "fancy" chroma upsampling and 14-bit fixed-point
// conversion. Every read is bounds-checked; a malformed file returns an
// error code and a message, never a partial image.
//
// C interface (ctypes):
//   int webp_probe(data, size, &width, &height, &kind, msg, msg_len)
//       kind 1 = lossy (VP8), 2 = lossless (VP8L)
//   int webp_decode_rgb(data, size, out, width, height, msg, msg_len)
//       out is caller-owned, height * width * 3 bytes
// Both return 0 on success.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
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

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

// ------------------------------------------------------------------ tables
// RFC 6386: quantizer lookups (section 14.1), default coefficient
// probabilities (13.5), coefficient update probabilities (13.4) and
// key-frame sub-block mode probabilities (12.3, rows and columns in this
// file's B_* order below). kCodeToPlane: the VP8L distance map (RFC 9649,
// 4.2.2), each entry (yoffset << 4) | (8 - xoffset).

static const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

static const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
  20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
  36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
  78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
  110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
  155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
  213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

static const uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
    },
    {
      {253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
      {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
      {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128},
    },
    {
      {1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
      {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
      {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128},
    },
    {
      {1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
      {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
      {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128},
    },
    {
      {1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
      {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
      {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128},
    },
    {
      {1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
      {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
      {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128},
    },
    {
      {1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
      {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
      {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128},
    },
    {
      {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
    },
  },
  {
    {
      {198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
      {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
      {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128},
    },
    {
      {1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
      {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
      {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128},
    },
    {
      {1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
      {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
      {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128},
    },
    {
      {1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
      {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
      {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128},
    },
    {
      {1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
      {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
      {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128},
    },
    {
      {1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
      {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
      {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128},
    },
    {
      {1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
      {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
      {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128},
    },
    {
      {1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
      {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128},
    },
  },
  {
    {
      {253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
      {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
      {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128},
    },
    {
      {1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
      {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
      {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128},
    },
    {
      {1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
      {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
      {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128},
    },
    {
      {1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
      {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
      {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128},
    },
    {
      {1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
      {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    },
    {
      {1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    },
    {
      {1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
      {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
      {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    },
    {
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
    },
  },
  {
    {
      {202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
      {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
      {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128},
    },
    {
      {1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
      {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
      {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128},
    },
    {
      {1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
      {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
      {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128},
    },
    {
      {1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
      {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
      {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128},
    },
    {
      {1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
      {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
      {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128},
    },
    {
      {1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
      {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
      {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128},
    },
    {
      {1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
      {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
      {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128},
    },
    {
      {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
    },
  },
};

static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
      {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
  },
  {
    {
      {217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
      {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255},
    },
    {
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
  },
  {
    {
      {186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
      {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255},
    },
    {
      {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
  },
  {
    {
      {248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
    },
  },
};

static const uint8_t kBModesProba[10][10][9] = {
  {
    {231, 120, 48, 89, 115, 113, 120, 152, 112},
    {152, 179, 64, 126, 170, 118, 46, 70, 95},
    {175, 69, 143, 80, 85, 82, 72, 155, 103},
    {56, 58, 10, 171, 218, 189, 17, 13, 152},
    {114, 26, 17, 163, 44, 195, 21, 10, 173},
    {121, 24, 80, 195, 26, 62, 44, 64, 85},
    {144, 71, 10, 38, 171, 213, 144, 34, 26},
    {170, 46, 55, 19, 136, 160, 33, 206, 71},
    {63, 20, 8, 114, 114, 208, 12, 9, 226},
    {81, 40, 11, 96, 182, 84, 29, 16, 36},
  },
  {
    {134, 183, 89, 137, 98, 101, 106, 165, 148},
    {72, 187, 100, 130, 157, 111, 32, 75, 80},
    {66, 102, 167, 99, 74, 62, 40, 234, 128},
    {41, 53, 9, 178, 241, 141, 26, 8, 107},
    {74, 43, 26, 146, 73, 166, 49, 23, 157},
    {65, 38, 105, 160, 51, 52, 31, 115, 128},
    {104, 79, 12, 27, 217, 255, 87, 17, 7},
    {87, 68, 71, 44, 114, 51, 15, 186, 23},
    {47, 41, 14, 110, 182, 183, 21, 17, 194},
    {66, 45, 25, 102, 197, 189, 23, 18, 22},
  },
  {
    {88, 88, 147, 150, 42, 46, 45, 196, 205},
    {43, 97, 183, 117, 85, 38, 35, 179, 61},
    {39, 53, 200, 87, 26, 21, 43, 232, 171},
    {56, 34, 51, 104, 114, 102, 29, 93, 77},
    {39, 28, 85, 171, 58, 165, 90, 98, 64},
    {34, 22, 116, 206, 23, 34, 43, 166, 73},
    {107, 54, 32, 26, 51, 1, 81, 43, 31},
    {68, 25, 106, 22, 64, 171, 36, 225, 114},
    {34, 19, 21, 102, 132, 188, 16, 76, 124},
    {62, 18, 78, 95, 85, 57, 50, 48, 51},
  },
  {
    {193, 101, 35, 159, 215, 111, 89, 46, 111},
    {60, 148, 31, 172, 219, 228, 21, 18, 111},
    {112, 113, 77, 85, 179, 255, 38, 120, 114},
    {40, 42, 1, 196, 245, 209, 10, 25, 109},
    {88, 43, 29, 140, 166, 213, 37, 43, 154},
    {61, 63, 30, 155, 67, 45, 68, 1, 209},
    {100, 80, 8, 43, 154, 1, 51, 26, 71},
    {142, 78, 78, 16, 255, 128, 34, 197, 171},
    {41, 40, 5, 102, 211, 183, 4, 1, 221},
    {51, 50, 17, 168, 209, 192, 23, 25, 82},
  },
  {
    {138, 31, 36, 171, 27, 166, 38, 44, 229},
    {67, 87, 58, 169, 82, 115, 26, 59, 179},
    {63, 59, 90, 180, 59, 166, 93, 73, 154},
    {40, 40, 21, 116, 143, 209, 34, 39, 175},
    {47, 15, 16, 183, 34, 223, 49, 45, 183},
    {46, 17, 33, 183, 6, 98, 15, 32, 183},
    {57, 46, 22, 24, 128, 1, 54, 17, 37},
    {65, 32, 73, 115, 28, 128, 23, 128, 205},
    {40, 3, 9, 115, 51, 192, 18, 6, 223},
    {87, 37, 9, 115, 59, 77, 64, 21, 47},
  },
  {
    {104, 55, 44, 218, 9, 54, 53, 130, 226},
    {64, 90, 70, 205, 40, 41, 23, 26, 57},
    {54, 57, 112, 184, 5, 41, 38, 166, 213},
    {30, 34, 26, 133, 152, 116, 10, 32, 134},
    {39, 19, 53, 221, 26, 114, 32, 73, 255},
    {31, 9, 65, 234, 2, 15, 1, 118, 73},
    {75, 32, 12, 51, 192, 255, 160, 43, 51},
    {88, 31, 35, 67, 102, 85, 55, 186, 85},
    {56, 21, 23, 111, 59, 205, 45, 37, 192},
    {55, 38, 70, 124, 73, 102, 1, 34, 98},
  },
  {
    {125, 98, 42, 88, 104, 85, 117, 175, 82},
    {95, 84, 53, 89, 128, 100, 113, 101, 45},
    {75, 79, 123, 47, 51, 128, 81, 171, 1},
    {57, 17, 5, 71, 102, 57, 53, 41, 49},
    {38, 33, 13, 121, 57, 73, 26, 1, 85},
    {41, 10, 67, 138, 77, 110, 90, 47, 114},
    {115, 21, 2, 10, 102, 255, 166, 23, 6},
    {101, 29, 16, 10, 85, 128, 101, 196, 26},
    {57, 18, 10, 102, 102, 213, 34, 20, 43},
    {117, 20, 15, 36, 163, 128, 68, 1, 26},
  },
  {
    {102, 61, 71, 37, 34, 53, 31, 243, 192},
    {69, 60, 71, 38, 73, 119, 28, 222, 37},
    {68, 45, 128, 34, 1, 47, 11, 245, 171},
    {62, 17, 19, 70, 146, 85, 55, 62, 70},
    {37, 43, 37, 154, 100, 163, 85, 160, 1},
    {63, 9, 92, 136, 28, 64, 32, 201, 85},
    {75, 15, 9, 9, 64, 255, 184, 119, 16},
    {86, 6, 28, 5, 64, 255, 25, 248, 1},
    {56, 8, 17, 132, 137, 255, 55, 116, 128},
    {58, 15, 20, 82, 135, 57, 26, 121, 40},
  },
  {
    {164, 50, 31, 137, 154, 133, 25, 35, 218},
    {51, 103, 44, 131, 131, 123, 31, 6, 158},
    {86, 40, 64, 135, 148, 224, 45, 183, 128},
    {22, 26, 17, 131, 240, 154, 14, 1, 209},
    {45, 16, 21, 91, 64, 222, 7, 1, 197},
    {56, 21, 39, 155, 60, 138, 23, 102, 213},
    {83, 12, 13, 54, 192, 255, 68, 47, 28},
    {85, 26, 85, 85, 128, 128, 32, 146, 171},
    {18, 11, 7, 63, 144, 171, 4, 4, 246},
    {35, 27, 10, 146, 174, 171, 12, 26, 128},
  },
  {
    {190, 80, 35, 99, 180, 80, 126, 54, 45},
    {85, 126, 47, 87, 176, 51, 41, 20, 32},
    {101, 75, 128, 139, 118, 146, 116, 128, 85},
    {56, 41, 15, 176, 236, 85, 37, 9, 62},
    {71, 30, 17, 119, 118, 255, 17, 18, 138},
    {101, 38, 60, 138, 55, 70, 43, 26, 142},
    {146, 36, 19, 30, 171, 255, 97, 27, 20},
    {138, 45, 61, 62, 219, 1, 81, 188, 64},
    {32, 41, 20, 117, 151, 142, 20, 21, 163},
    {112, 19, 12, 61, 195, 128, 48, 4, 24},
  },
};

static const uint8_t kCodeToPlane[120] = {
  0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a,
  0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a,
  0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
  0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03,
  0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c,
  0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
  0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b,
  0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
  0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
  0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41,
  0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f,
  0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

// Sub-block intra modes. The 16x16 modes share the first four values, so a
// 16x16 macroblock's mode is also its sub-blocks' context.
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED, NUM_BMODES,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
  // DC prediction at the frame's edges
  DC_PRED_NOTOP = NUM_BMODES, DC_PRED_NOLEFT, DC_PRED_NOTOPLEFT
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// ------------------------------------------------------- boolean decoder
// RFC 6386 section 7, kept as libwebp keeps it: 'range' holds range - 1,
// 'bits' counts the bits buffered below the 8-bit window. Past the end of
// its partition the reader shifts in zeros and sets 'eof', which the
// callers turn into an error.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint32_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    buf = start;
    end = start + size;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;  // keep the shifts defined; the caller fails on eof
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = value >> pos;
    int bit;
    if (v > split) {
      r -= split;
      value -= (split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    int shift = 0;
    while ((r << shift) < 128) ++shift;
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)get_bit(0x80) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int v = (int)get_value(n);
    return get_value(1) ? -v : v;
  }
  int get_signed(int v) { return get_bit(0x80) ? -v : v; }
};

// ---------------------------------------------------------------- VP8
constexpr int kBps = 32;  // stride of the per-macroblock work buffers

struct SegmentHeader {
  bool use_segment = false, update_map = false, absolute_delta = true;
  int8_t quantizer[4] = {0, 0, 0, 0};
  int8_t filter_strength[4] = {0, 0, 0, 0};
};

struct FilterHeader {
  bool simple = false;
  int level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0, 0, 0, 0};
  int mode_lf_delta[4] = {0, 0, 0, 0};
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];  // [dc, ac]
};

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct MBInfo {     // per macroblock column: the 'top' token contexts
  uint8_t nz_y[4];  // non-zero flags of the bottom sub-block row
  uint8_t nz_u[2], nz_v[2];
  uint8_t nz_dc;
};

struct VP8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  SegmentHeader seg;
  FilterHeader filt;
  int filter_type = 0;  // 0 off, 1 simple, 2 normal
  uint8_t seg_proba[3] = {255, 255, 255};
  uint8_t proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  QuantMatrix dqm[4];
  FilterInfo fstrengths[4][2];
  BoolReader br;
  BoolReader parts[8];
  int num_parts = 1;

  std::vector<uint8_t> Y, U, V;  // unfiltered, then filtered planes
  int ystride = 0, uvstride = 0;
  std::vector<FilterInfo> finfo;  // per macroblock
};

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

void parse_segment_header(BoolReader& br, SegmentHeader& hdr, uint8_t* seg_proba) {
  hdr.use_segment = br.get_value(1);
  if (hdr.use_segment) {
    hdr.update_map = br.get_value(1);
    if (br.get_value(1)) {  // update data
      hdr.absolute_delta = br.get_value(1);
      for (int s = 0; s < 4; ++s) hdr.quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        hdr.filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
    }
    if (hdr.update_map)
      for (int s = 0; s < 3; ++s) seg_proba[s] = br.get_value(1) ? br.get_value(8) : 255;
  } else {
    hdr.update_map = false;
  }
}

void parse_filter_header(BoolReader& br, FilterHeader& hdr) {
  hdr.simple = br.get_value(1);
  hdr.level = br.get_value(6);
  hdr.sharpness = br.get_value(3);
  hdr.use_lf_delta = br.get_value(1);
  if (hdr.use_lf_delta) {
    if (br.get_value(1)) {  // update lf-delta
      for (int i = 0; i < 4; ++i)
        if (br.get_value(1)) hdr.ref_lf_delta[i] = br.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.get_value(1)) hdr.mode_lf_delta[i] = br.get_signed_value(6);
    }
  }
}

void parse_quant(VP8Decoder& dec) {
  BoolReader& br = dec.br;
  const int base_q0 = br.get_value(7);
  const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (dec.seg.use_segment) {
      q = dec.seg.quantizer[i];
      if (!dec.seg.absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        dec.dqm[i] = dec.dqm[0];
        continue;
      }
      q = base_q0;
    }
    QuantMatrix& m = dec.dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 for x in [0, 284] equals (x * 101581) >> 16
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void precompute_filter_strengths(VP8Decoder& dec) {
  if (dec.filter_type == 0) return;
  const FilterHeader& hdr = dec.filt;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (dec.seg.use_segment) {
      base_level = dec.seg.filter_strength[s];
      if (!dec.seg.absolute_delta) base_level += hdr.level;
    } else {
      base_level = hdr.level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FilterInfo& info = dec.fstrengths[s][i4x4];
      int level = base_level;
      if (hdr.use_lf_delta) {
        level += hdr.ref_lf_delta[0];
        if (i4x4) level += hdr.mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (hdr.sharpness > 0) {
          ilevel >>= hdr.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - hdr.sharpness) ilevel = 9 - hdr.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;  // no filtering
      }
      info.inner = i4x4;
    }
  }
}

// One block's tokens (RFC 6386 section 13), written dequantized at their
// raster positions. Returns the position after the last token read (0-16);
// 'first' is 1 for luma blocks whose DC comes from the Y2 block.
int get_coeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;  // end of block
    while (!br.get_bit(p[1])) {       // zero token
      ++n;
      if (n == 16) return 16;
      p = bands[kBands[n]][0];
    }
    int v;
    const uint8_t (*next)[11] = bands[kBands[n + 1]];
    if (!br.get_bit(p[2])) {
      v = 1;
      p = next[1];
    } else {
      if (!br.get_bit(p[3])) {
        if (!br.get_bit(p[4])) {
          v = 2;
        } else {
          v = 3 + br.get_bit(p[5]);
        }
      } else {
        if (!br.get_bit(p[6])) {
          if (!br.get_bit(p[7])) {
            v = 5 + br.get_bit(159);
          } else {
            v = 7 + 2 * br.get_bit(165);
            v += br.get_bit(145);
          }
        } else {
          const int bit1 = br.get_bit(p[8]);
          const int bit0 = br.get_bit(p[9 + bit1]);
          const int cat = 2 * bit1 + bit0;
          v = 0;
          for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
          v += 3 + (8 << cat);
        }
      }
      p = next[2];
    }
    out[kZigzag[n]] = (int16_t)(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// Inverse DCT of one 4x4 block, added to the prediction in 'dst'.
void transform_add(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += kBps;
  }
}

void transform_dc_add(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) dst[i + j * kBps] = clip8(dst[i + j * kBps] + (dc >> 3));
}

void do_transform(const int16_t* in, uint8_t* dst) {
  bool ac = false;
  for (int i = 1; i < 16; ++i) ac |= in[i] != 0;
  if (ac) {
    transform_add(in, dst);
  } else if (in[0] != 0) {
    transform_dc_add(in, dst);
  }
}

// ----------------------------------------------------- intra prediction
#define DST(x, y) dst[(x) + (y) * kBps]
inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBps;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += kBps;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * kBps, v, size);
}

void predict_block(uint8_t* dst, int mode, int size) {  // 16x16 luma or 8x8 chroma
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-kBps + j] + dst[-1 + j * kBps];
      fill(dst, dc >> (shift + 1), size);
      break;
    }
    case DC_PRED_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * kBps];
      fill(dst, dc >> shift, size);
      break;
    }
    case DC_PRED_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-kBps + j];
      fill(dst, dc >> shift, size);
      break;
    }
    case DC_PRED_NOTOPLEFT:
      fill(dst, 0x80, size);
      break;
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int j = 0; j < size; ++j) memcpy(dst + j * kBps, dst - kBps, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) memset(dst + j * kBps, dst[j * kBps - 1], size);
      break;
    default:
      fail("VP8: bad intra mode");
  }
}

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - kBps;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - kBps] + dst[-1 + i * kBps];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) memset(dst + i * kBps, (int)dc, 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * kBps, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - kBps], B = dst[-1], C = dst[-1 + kBps], D = dst[-1 + 2 * kBps],
                E = dst[-1 + 3 * kBps];
      memset(dst + 0 * kBps, avg3(A, B, C), 4);
      memset(dst + 1 * kBps, avg3(B, C, D), 4);
      memset(dst + 2 * kBps, avg3(C, D, E), 4);
      memset(dst + 3 * kBps, avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps], L = dst[-1 + 3 * kBps];
      const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
                G = top[6], H = top[7];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps];
      const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
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
    }
    case B_VL_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5],
                G = top[6], H = top[7];
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
    }
    case B_HU_PRED: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps], L = dst[-1 + 3 * kBps];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps], L = dst[-1 + 3 * kBps];
      const int X = top[-1], A = top[0], B = top[1], C = top[2];
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
    }
    default:
      fail("VP8: bad sub-block mode");
  }
}
#undef DST

int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_PRED_NOTOPLEFT : DC_PRED_NOLEFT;
    return mb_y == 0 ? DC_PRED_NOTOP : DC_PRED;
  }
  return mode;
}

// ------------------------------------------------------------ loop filter
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return 0;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

// 'hstride' steps across the edge, 'vstride' along it.
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * vstride, hstride, thresh2)) do_filter2(p + i * vstride, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else if (mb_edge) {
        do_filter6(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

void loop_filter(VP8Decoder& dec) {
  const int ys = dec.ystride, uvs = dec.uvstride;
  for (int mb_y = 0; mb_y < dec.mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < dec.mb_w; ++mb_x) {
      const FilterInfo& f = dec.finfo[mb_y * dec.mb_w + mb_x];
      const int limit = f.limit;
      if (limit == 0) continue;
      uint8_t* y = dec.Y.data() + (size_t)mb_y * 16 * ys + mb_x * 16;
      if (dec.filter_type == 1) {
        if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
        if (f.inner)
          for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
        if (f.inner)
          for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k * ys, ys, 1, limit);
      } else {
        uint8_t* u = dec.U.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
        uint8_t* v = dec.V.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
        const int il = f.ilevel, hv = f.hev_thresh;
        if (mb_x > 0) {
          filter_loop(y, 1, ys, 16, limit + 4, il, hv, true);
          filter_loop(u, 1, uvs, 8, limit + 4, il, hv, true);
          filter_loop(v, 1, uvs, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
          for (int k = 1; k < 4; ++k) filter_loop(y + 4 * k, 1, ys, 16, limit, il, hv, false);
          filter_loop(u + 4, 1, uvs, 8, limit, il, hv, false);
          filter_loop(v + 4, 1, uvs, 8, limit, il, hv, false);
        }
        if (mb_y > 0) {
          filter_loop(y, ys, 1, 16, limit + 4, il, hv, true);
          filter_loop(u, uvs, 1, 8, limit + 4, il, hv, true);
          filter_loop(v, uvs, 1, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
          for (int k = 1; k < 4; ++k)
            filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
          filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
          filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
        }
      }
    }
  }
}

// ------------------------------------------------------ YUV -> RGB
// libwebp's fixed-point conversion (14-bit precision, dsp/yuv.h) and its
// "fancy" upsampler (dsp/upsampling.c): each output pixel's chroma is a
// 9-3-3-1 blend of the four nearest chroma samples.
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = (uint8_t)yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// One output row: 'near' is the chroma row of this row's half, 'far' the
// other row it blends with at a quarter weight (the same row at the edges).
void upsample_row(const uint8_t* y, const uint8_t* far_u, const uint8_t* far_v,
                  const uint8_t* near_u, const uint8_t* near_v, uint8_t* dst, int len) {
#define LOAD_UV(u, v) ((uint32_t)(u) | ((uint32_t)(v) << 16))
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = LOAD_UV(far_u[0], far_v[0]);
  uint32_t l_uv = LOAD_UV(near_u[0], near_v[0]);
  {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(y[0], uv0 & 0xff, uv0 >> 16, dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = LOAD_UV(far_u[x], far_v[x]);
    const uint32_t uv = LOAD_UV(near_u[x], near_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    const uint32_t uv0 = (diag_03 + l_uv) >> 1;
    const uint32_t uv1 = (diag_12 + uv) >> 1;
    yuv_to_rgb(y[2 * x - 1], uv0 & 0xff, uv0 >> 16, dst + (2 * x - 1) * 3);
    yuv_to_rgb(y[2 * x], uv1 & 0xff, uv1 >> 16, dst + (2 * x) * 3);
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(y[len - 1], uv0 & 0xff, uv0 >> 16, dst + (len - 1) * 3);
  }
#undef LOAD_UV
}

// ------------------------------------------------------ VP8 frame decode
void vp8_decode(const uint8_t* data, size_t size, int exp_w, int exp_h, uint8_t* out) {
  if (size < 10) fail("VP8: truncated frame header");
  const uint32_t bits = le24(data);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (!key_frame) fail("VP8: not a key frame");
  if (profile > 3) fail("VP8: incorrect keyframe parameters (profile)");
  if (!show) fail("VP8: frame not displayable");
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) fail("VP8: bad start code");
  VP8Decoder dec;
  dec.width = le16(data + 6) & 0x3fff;
  dec.height = le16(data + 8) & 0x3fff;
  if (dec.width == 0 || dec.height == 0) fail("VP8: zero frame size");
  if (dec.width != exp_w || dec.height != exp_h) fail("VP8: frame size differs from the canvas");
  data += 10;
  size -= 10;
  if (partition_length > size) fail("VP8: bad partition length (truncated)");
  dec.mb_w = (dec.width + 15) >> 4;
  dec.mb_h = (dec.height + 15) >> 4;

  BoolReader& br = dec.br;
  br.init(data, partition_length);
  br.get_value(1);  // colour space
  br.get_value(1);  // clamping type (decoders always clamp)
  parse_segment_header(br, dec.seg, dec.seg_proba);
  parse_filter_header(br, dec.filt);
  if (br.eof) fail("VP8: cannot parse segment or filter header");
  dec.filter_type = dec.filt.level == 0 ? 0 : dec.filt.simple ? 1 : 2;

  {  // token partitions
    const uint8_t* sz = data + partition_length;
    const uint8_t* buf_end = data + size;
    const int last_part = (1 << br.get_value(2)) - 1;
    dec.num_parts = last_part + 1;
    if ((size_t)(buf_end - sz) < 3 * (size_t)last_part) fail("VP8: cannot parse partitions");
    const uint8_t* part_start = sz + last_part * 3;
    size_t size_left = buf_end - part_start;
    for (int p = 0; p < last_part; ++p) {
      size_t psize = le24(sz);
      if (psize > size_left) psize = size_left;
      dec.parts[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    dec.parts[last_part].init(part_start, size_left);
    if (part_start >= buf_end) fail("VP8: cannot parse partitions (truncated)");
  }
  parse_quant(dec);
  br.get_value(1);  // refresh entropy probabilities: one frame only
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          dec.proba[t][b][c][p] = br.get_bit(kCoeffsUpdateProba[t][b][c][p])
                                      ? br.get_value(8)
                                      : kCoeffsProba0[t][b][c][p];
  dec.use_skip_proba = br.get_value(1);
  if (dec.use_skip_proba) dec.skip_p = br.get_value(8);
  if (br.eof) fail("VP8: cannot parse header (truncated first partition)");
  precompute_filter_strengths(dec);

  dec.ystride = dec.mb_w * 16;
  dec.uvstride = dec.mb_w * 8;
  dec.Y.assign((size_t)dec.ystride * dec.mb_h * 16, 0);
  dec.U.assign((size_t)dec.uvstride * dec.mb_h * 8, 0);
  dec.V.assign((size_t)dec.uvstride * dec.mb_h * 8, 0);
  dec.finfo.assign((size_t)dec.mb_w * dec.mb_h, FilterInfo());

  std::vector<MBInfo> top(dec.mb_w);
  memset(top.data(), 0, top.size() * sizeof(MBInfo));
  std::vector<uint8_t> intra_t(4 * dec.mb_w, B_DC_PRED);
  // per macroblock of the row: modes and coefficients
  struct MBData {
    uint8_t imodes[16];
    uint8_t uvmode;
    bool is_i4x4, skip;
    int segment;
  };
  std::vector<MBData> row(dec.mb_w);
  int16_t coeffs[384];
  uint8_t ywork[kBps * 17], uwork[kBps * 9], vwork[kBps * 9];

  for (int mb_y = 0; mb_y < dec.mb_h; ++mb_y) {
    // intra modes of the row, from the first partition
    uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    for (int mb_x = 0; mb_x < dec.mb_w; ++mb_x) {
      MBData& b = row[mb_x];
      uint8_t* tmodes = &intra_t[4 * mb_x];
      if (dec.seg.update_map) {
        b.segment = !br.get_bit(dec.seg_proba[0]) ? br.get_bit(dec.seg_proba[1])
                                                   : br.get_bit(dec.seg_proba[2]) + 2;
      } else {
        b.segment = 0;
      }
      b.skip = dec.use_skip_proba ? br.get_bit(dec.skip_p) : false;
      b.is_i4x4 = !br.get_bit(145);
      if (!b.is_i4x4) {
        const int ymode = br.get_bit(156) ? (br.get_bit(128) ? TM_PRED : H_PRED)
                                          : (br.get_bit(163) ? V_PRED : DC_PRED);
        b.imodes[0] = (uint8_t)ymode;
        memset(tmodes, ymode, 4);
        memset(intra_l, ymode, 4);
      } else {
        uint8_t* modes = b.imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba[tmodes[x]][ymode];
            if (!br.get_bit(prob[0])) {
              ymode = B_DC_PRED;
            } else if (!br.get_bit(prob[1])) {
              ymode = B_TM_PRED;
            } else if (!br.get_bit(prob[2])) {
              ymode = B_VE_PRED;
            } else if (!br.get_bit(prob[3])) {
              ymode = !br.get_bit(prob[4]) ? B_HE_PRED
                                           : (!br.get_bit(prob[5]) ? B_RD_PRED : B_VR_PRED);
            } else if (!br.get_bit(prob[6])) {
              ymode = B_LD_PRED;
            } else if (!br.get_bit(prob[7])) {
              ymode = B_VL_PRED;
            } else {
              ymode = !br.get_bit(prob[8]) ? B_HD_PRED : B_HU_PRED;
            }
            tmodes[x] = (uint8_t)ymode;
          }
          memcpy(modes, tmodes, 4);
          modes += 4;
          intra_l[y] = (uint8_t)ymode;
        }
      }
      b.uvmode = !br.get_bit(142)   ? DC_PRED
                 : !br.get_bit(114) ? V_PRED
                 : br.get_bit(183)  ? TM_PRED
                                    : H_PRED;
    }
    if (br.eof) fail("VP8: premature end of the first partition");

    BoolReader& tbr = dec.parts[mb_y & (dec.num_parts - 1)];
    MBInfo left;
    memset(&left, 0, sizeof(left));
    for (int mb_x = 0; mb_x < dec.mb_w; ++mb_x) {
      MBData& b = row[mb_x];
      MBInfo& tp = top[mb_x];
      const QuantMatrix& q = dec.dqm[b.segment];
      memset(coeffs, 0, sizeof(coeffs));
      bool has_coeffs = false;
      if (!b.skip) {
        int first;
        const uint8_t (*ac_bands)[3][11];
        if (!b.is_i4x4) {
          int16_t dc[16] = {0};
          const int ctx = tp.nz_dc + left.nz_dc;
          const int nz = get_coeffs(tbr, dec.proba[1], ctx, q.y2, 0, dc);
          tp.nz_dc = left.nz_dc = nz > 0;
          if (nz > 1) {
            transform_wht(dc, coeffs);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) coeffs[i] = (int16_t)dc0;
          }
          first = 1;
          ac_bands = dec.proba[0];
        } else {
          first = 0;
          ac_bands = dec.proba[3];
        }
        for (int y = 0; y < 4; ++y) {
          for (int x = 0; x < 4; ++x) {
            int16_t* dst = coeffs + (y * 4 + x) * 16;
            const int ctx = left.nz_y[y] + tp.nz_y[x];
            const int nz = get_coeffs(tbr, ac_bands, ctx, q.y1, first, dst);
            tp.nz_y[x] = left.nz_y[y] = nz > first;
            has_coeffs |= nz > 1 || dst[0] != 0;
          }
        }
        for (int ch = 0; ch < 2; ++ch) {
          uint8_t* tnz = ch == 0 ? tp.nz_u : tp.nz_v;
          uint8_t* lnz = ch == 0 ? left.nz_u : left.nz_v;
          for (int y = 0; y < 2; ++y) {
            for (int x = 0; x < 2; ++x) {
              int16_t* dst = coeffs + 256 + ch * 64 + (y * 2 + x) * 16;
              const int ctx = lnz[y] + tnz[x];
              const int nz = get_coeffs(tbr, dec.proba[2], ctx, q.uv, 0, dst);
              tnz[x] = lnz[y] = nz > 0;
              has_coeffs |= nz > 1 || dst[0] != 0;
            }
          }
        }
      } else {
        memset(tp.nz_y, 0, 4);
        memset(tp.nz_u, 0, 2);
        memset(tp.nz_v, 0, 2);
        memset(left.nz_y, 0, 4);
        memset(left.nz_u, 0, 2);
        memset(left.nz_v, 0, 2);
        if (!b.is_i4x4) tp.nz_dc = left.nz_dc = 0;
      }
      if (dec.filter_type > 0) {
        FilterInfo& fi = dec.finfo[mb_y * dec.mb_w + mb_x];
        fi = dec.fstrengths[b.segment][b.is_i4x4];
        fi.inner = fi.inner || has_coeffs;
      }
      if (tbr.eof) fail("VP8: premature end of a token partition");

      // ---- reconstruct into the work buffers, then the planes
      uint8_t* yd = ywork + kBps + 8;  // row 0, column 0 of the macroblock
      uint8_t* ud = uwork + kBps + 8;
      uint8_t* vd = vwork + kBps + 8;
      const int px = mb_x * 16, py = mb_y * 16;
      const int ys = dec.ystride, uvs = dec.uvstride;
      // top row, top-left and top-right
      if (mb_y > 0) {
        const uint8_t* above = dec.Y.data() + (size_t)(py - 1) * ys + px;
        memcpy(yd - kBps, above, 16);
        yd[-kBps - 1] = mb_x > 0 ? above[-1] : 129;
        if (mb_x < dec.mb_w - 1) {
          memcpy(yd - kBps + 16, above + 16, 4);
        } else {
          memset(yd - kBps + 16, above[15], 4);
        }
        const uint8_t* au = dec.U.data() + (size_t)(mb_y * 8 - 1) * uvs + mb_x * 8;
        const uint8_t* av = dec.V.data() + (size_t)(mb_y * 8 - 1) * uvs + mb_x * 8;
        memcpy(ud - kBps, au, 8);
        memcpy(vd - kBps, av, 8);
        ud[-kBps - 1] = mb_x > 0 ? au[-1] : 129;
        vd[-kBps - 1] = mb_x > 0 ? av[-1] : 129;
      } else {
        memset(yd - kBps - 1, 127, 16 + 4 + 1);
        memset(ud - kBps - 1, 127, 8 + 1);
        memset(vd - kBps - 1, 127, 8 + 1);
      }
      // left column
      for (int j = 0; j < 16; ++j)
        yd[j * kBps - 1] = mb_x > 0 ? dec.Y[(size_t)(py + j) * ys + px - 1] : 129;
      for (int j = 0; j < 8; ++j) {
        ud[j * kBps - 1] = mb_x > 0 ? dec.U[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8 - 1] : 129;
        vd[j * kBps - 1] = mb_x > 0 ? dec.V[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8 - 1] : 129;
      }
      if (b.is_i4x4) {
        uint8_t* top_right = yd - kBps + 16;
        for (int k = 1; k < 4; ++k) memcpy(top_right + 4 * k * kBps, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = yd + (n & 3) * 4 + (n >> 2) * 4 * kBps;
          predict4(dst, b.imodes[n]);
          do_transform(coeffs + n * 16, dst);
        }
      } else {
        predict_block(yd, check_mode(mb_x, mb_y, b.imodes[0]), 16);
        for (int n = 0; n < 16; ++n)
          do_transform(coeffs + n * 16, yd + (n & 3) * 4 + (n >> 2) * 4 * kBps);
      }
      const int uvmode = check_mode(mb_x, mb_y, b.uvmode);
      predict_block(ud, uvmode, 8);
      predict_block(vd, uvmode, 8);
      for (int n = 0; n < 4; ++n) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * kBps;
        do_transform(coeffs + 256 + n * 16, ud + off);
        do_transform(coeffs + 320 + n * 16, vd + off);
      }
      for (int j = 0; j < 16; ++j) memcpy(&dec.Y[(size_t)(py + j) * ys + px], yd + j * kBps, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(&dec.U[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], ud + j * kBps, 8);
        memcpy(&dec.V[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], vd + j * kBps, 8);
      }
    }
  }
  if (dec.filter_type > 0) loop_filter(dec);

  // ---- YUV 4:2:0 -> RGB
  const int W = dec.width, H = dec.height;
  const int uvs = dec.uvstride;
  const int uv_h = (H + 1) >> 1;
  for (int r = 0; r < H; ++r) {
    int near_row, far_row;
    if (r == 0) {
      near_row = far_row = 0;
    } else if (r & 1) {  // first row of a pair: nearer to chroma row (r - 1) / 2
      near_row = (r - 1) >> 1;
      far_row = (r + 1) >> 1;
      if (far_row >= uv_h) far_row = near_row;
    } else {
      near_row = r >> 1;
      far_row = near_row - 1;
    }
    upsample_row(dec.Y.data() + (size_t)r * dec.ystride, dec.U.data() + (size_t)far_row * uvs,
                 dec.V.data() + (size_t)far_row * uvs, dec.U.data() + (size_t)near_row * uvs,
                 dec.V.data() + (size_t)near_row * uvs, out + (size_t)r * W * 3, W);
  }
}

// --------------------------------------------------------------- VP8L
// Lossless (RFC 9649): LSB-first bit reader; reading past the end yields
// zeros and marks 'eos', which fails the decode.
struct LBitReader {
  const uint8_t* data;
  size_t len;
  size_t bitpos = 0;
  bool eos = false;
  LBitReader(const uint8_t* d, size_t n) : data(d), len(n) {}
  // the next 'n' (<= 32) bits without consuming them
  uint32_t peek(int n) const {
    uint64_t v = 0;
    size_t byte = bitpos >> 3;
    const int shift = bitpos & 7;
    for (int i = 0; i < 5; ++i) {
      const uint64_t b = byte + i < len ? data[byte + i] : 0;
      v |= b << (8 * i);
    }
    v >>= shift;
    return n == 32 ? (uint32_t)v : (uint32_t)(v & ((1ull << n) - 1));
  }
  void skip(int n) {
    bitpos += n;
    if (bitpos > 8 * len) eos = true;
  }
  uint32_t read(int n) {
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

constexpr int kMaxCodeLength = 15;
constexpr int kFastBits = 8;

// A canonical prefix code; codes are read LSB first, so the fast table is
// indexed by the next kFastBits bits as they come.
struct HuffmanCode {
  int single = -1;                 // the symbol of a one-symbol code (0 bits)
  std::vector<uint16_t> fast;      // (len << 12 | sym), len 0 = longer code
  int first[kMaxCodeLength + 2];   // canonical first code of each length
  int count[kMaxCodeLength + 2];
  int offset[kMaxCodeLength + 2];
  std::vector<uint16_t> sorted;

  // Returns false for an invalid code (all zero, over- or
  // under-subscribed), as libwebp's VP8LBuildHuffmanTable does.
  bool build(const int* lengths, int n) {
    for (int i = 0; i <= kMaxCodeLength + 1; ++i) count[i] = 0;
    int nonzero = 0, last = -1;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > kMaxCodeLength || lengths[s] < 0) return false;
      ++count[lengths[s]];
      if (lengths[s]) {
        ++nonzero;
        last = s;
      }
    }
    if (nonzero == 0) return false;
    if (nonzero == 1) {
      single = last;
      return true;
    }
    single = -1;
    count[0] = 0;
    int left = 1;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      left <<= 1;
      left -= count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    offset[1] = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) offset[len + 1] = offset[len] + count[len];
    sorted.assign(nonzero, 0);
    int next[kMaxCodeLength + 2];
    for (int len = 1; len <= kMaxCodeLength + 1; ++len) next[len] = offset[len];
    for (int s = 0; s < n; ++s)
      if (lengths[s]) sorted[next[lengths[s]]++] = (uint16_t)s;
    int code = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      first[len] = code;
      code = (code + count[len]) << 1;
    }
    fast.assign(1 << kFastBits, 0);
    for (int len = 1; len <= kFastBits; ++len) {
      for (int i = 0; i < count[len]; ++i) {
        const int c = first[len] + i;  // MSB-first code
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((c >> (len - 1 - b)) & 1) << b;
        const uint16_t entry = (uint16_t)((len << 12) | sorted[offset[len] + i]);
        for (int fill = rev; fill < (1 << kFastBits); fill += 1 << len) fast[fill] = entry;
      }
    }
    return true;
  }

  int read(LBitReader& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek(kMaxCodeLength);
    const uint16_t e = fast[bits & ((1 << kFastBits) - 1)];
    if (e >> 12) {
      br.skip(e >> 12);
      return e & 0xfff;
    }
    int code = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      code = (code << 1) | ((bits >> (len - 1)) & 1);
      const int idx = code - first[len];
      if (len > kFastBits && idx >= 0 && idx < count[len]) {
        br.skip(len);
        return sorted[offset[len] + idx];
      }
    }
    fail("VP8L: invalid prefix code");
  }
};

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                      7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};

struct HTreeGroup {
  HuffmanCode codes[5];  // green (+ length prefixes + cache), red, blue, alpha, distance
};

inline int subsample_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Transform {
  int type;
  int bits;
  int xsize, ysize;  // the image size this transform's output has
  std::vector<uint32_t> data;
};

struct VP8LDecoder {
  LBitReader br;
  std::vector<Transform> transforms;
  explicit VP8LDecoder(const uint8_t* d, size_t n) : br(d, n) {}

  void read_code(int alphabet_size, HuffmanCode& code) {
    std::vector<int> lengths(alphabet_size, 0);
    if (br.read(1)) {  // simple code: one or two symbols
      const int num_symbols = br.read(1) + 1;
      const int first_bits = br.read(1) ? 8 : 1;
      int symbol = br.read(first_bits);
      if (symbol >= alphabet_size) fail("VP8L: simple code symbol out of range");
      lengths[symbol] = 1;
      if (num_symbols == 2) {
        symbol = br.read(8);
        if (symbol >= alphabet_size) fail("VP8L: simple code symbol out of range");
        lengths[symbol] = 1;
      }
    } else {  // code lengths, themselves prefix coded
      int cl_lengths[19] = {0};
      const int num_codes = br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
      HuffmanCode cl;
      if (!cl.build(cl_lengths, 19)) fail("VP8L: invalid code-length code");
      int max_symbol;
      if (br.read(1)) {
        const int length_nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(length_nbits);
        if (max_symbol > alphabet_size) fail("VP8L: code-length count out of range");
      } else {
        max_symbol = alphabet_size;
      }
      int symbol = 0, prev_len = 8;
      while (symbol < alphabet_size) {
        if (max_symbol-- == 0) break;
        if (br.eos) fail("VP8L: truncated code lengths");
        const int code_len = cl.read(br);
        if (code_len < 16) {
          lengths[symbol++] = code_len;
          if (code_len != 0) prev_len = code_len;
        } else {
          static const int kExtraBits[3] = {2, 3, 7};
          static const int kRepeatOffsets[3] = {3, 3, 11};
          const int slot = code_len - 16;
          int repeat = br.read(kExtraBits[slot]) + kRepeatOffsets[slot];
          if (symbol + repeat > alphabet_size) fail("VP8L: code-length repeat out of range");
          const int len = code_len == 16 ? prev_len : 0;
          while (repeat-- > 0) lengths[symbol++] = len;
        }
      }
    }
    if (br.eos) fail("VP8L: truncated prefix code");
    if (!code.build(lengths.data(), alphabet_size)) fail("VP8L: invalid prefix code");
  }

  static int copy_distance(int symbol, LBitReader& br) {
    if (symbol < 4) return symbol + 1;
    const int extra_bits = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra_bits;
    return offset + br.read(extra_bits) + 1;
  }

  static int plane_code_to_distance(int xsize, int plane_code) {
    if (plane_code > 120) return plane_code - 120;
    const int dist_code = kCodeToPlane[plane_code - 1];
    const int yoffset = dist_code >> 4;
    const int xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
  }

  // One entropy-coded image (RFC 9649 section 5); the level-0 image also
  // reads the transforms and may use a meta prefix-code image.
  std::vector<uint32_t> decode_image_stream(int xsize, int ysize, bool is_level0) {
    int tx = xsize;
    if (is_level0) {
      unsigned seen = 0;
      while (br.read(1)) {
        Transform t;
        t.type = br.read(2);
        if (seen & (1u << t.type)) fail("VP8L: a transform appears twice");
        seen |= 1u << t.type;
        t.xsize = tx;
        t.ysize = ysize;
        t.bits = 0;
        if (t.type == 0 || t.type == 1) {  // predictor, cross-colour
          t.bits = br.read(3) + 2;
          t.data = decode_image_stream(subsample_size(tx, t.bits), subsample_size(ysize, t.bits),
                                       false);
        } else if (t.type == 3) {  // colour indexing
          const int num_colors = br.read(8) + 1;
          t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
          std::vector<uint32_t> pal = decode_image_stream(num_colors, 1, false);
          t.data.assign(1u << (8 >> t.bits), 0);
          // the palette is delta coded, byte by byte
          uint32_t prev = 0;
          for (int i = 0; i < num_colors; ++i) {
            const uint32_t c = pal[i];
            uint32_t out = 0;
            for (int k = 0; k < 32; k += 8)
              out |= (((c >> k) + (prev >> k)) & 0xff) << k;
            t.data[i] = out;
            prev = out;
          }
          tx = subsample_size(tx, t.bits);
        }
        transforms.push_back(std::move(t));
        if (br.eos) fail("VP8L: truncated transform");
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) fail("VP8L: invalid colour cache size");
    }
    // prefix codes, with the meta image on level 0
    int huff_bits = 0, huff_xsize = 0;
    std::vector<uint32_t> huff_image;
    int num_groups = 1;
    if (is_level0 && br.read(1)) {
      huff_bits = br.read(3) + 2;
      huff_xsize = subsample_size(tx, huff_bits);
      huff_image = decode_image_stream(huff_xsize, subsample_size(ysize, huff_bits), false);
      for (uint32_t& v : huff_image) {
        v = (v >> 8) & 0xffff;
        if ((int)v + 1 > num_groups) num_groups = v + 1;
      }
    }
    if (br.eos) fail("VP8L: truncated header");
    // Every group's codes are in the stream, but only the groups the meta
    // image names are kept (a corrupt meta image may name up to 65536).
    std::vector<int> slot(num_groups, -1);
    int used = 0;
    if (huff_bits) {
      for (uint32_t& v : huff_image) {
        if (slot[v] < 0) slot[v] = used++;
        v = slot[v];
      }
    } else {
      slot[0] = used++;
    }
    std::vector<HTreeGroup> groups(used);
    for (int i = 0; i < num_groups; ++i) {
      HTreeGroup scratch;
      HTreeGroup& g = slot[i] >= 0 ? groups[slot[i]] : scratch;
      for (int j = 0; j < 5; ++j) {
        int alphabet = kAlphabetSize[j];
        if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
        read_code(alphabet, g.codes[j]);
      }
    }
    // the pixels: literals, backward references and cache hits
    const int width = tx;
    const size_t total = (size_t)width * ysize;
    std::vector<uint32_t> px(total);
    std::vector<uint32_t> cache(cache_bits ? (1u << cache_bits) : 0);
    size_t last_cached = 0;
    auto flush_cache = [&](size_t upto) {
      for (; last_cached < upto; ++last_cached)
        cache[(0x1e35a7bdu * px[last_cached]) >> (32 - cache_bits)] = px[last_cached];
    };
    size_t pos = 0;
    int col = 0, row = 0;
    const int mask = huff_bits ? (1 << huff_bits) - 1 : -1;
    const HTreeGroup* g = &groups[0];
    auto group_at = [&](int c, int r) -> const HTreeGroup* {
      if (!huff_bits) return &groups[0];
      return &groups[huff_image[(size_t)huff_xsize * (r >> huff_bits) + (c >> huff_bits)]];
    };
    while (pos < total) {
      if ((col & mask) == 0) g = group_at(col, row);
      const int code = g->codes[0].read(br);
      if (code < 256) {  // literal
        const int red = g->codes[1].read(br);
        const int blue = g->codes[2].read(br);
        const int alpha = g->codes[3].read(br);
        if (br.eos) break;
        px[pos] = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
        ++pos;
        if (++col >= width) {
          col = 0;
          ++row;
          if (cache_bits) flush_cache(pos);
        }
      } else if (code < 256 + 24) {  // backward reference
        const int length = copy_distance(code - 256, br);
        const int dist_symbol = g->codes[4].read(br);
        const int dist = plane_code_to_distance(width, copy_distance(dist_symbol, br));
        if (br.eos) break;
        if (pos < (size_t)dist || total - pos < (size_t)length)
          fail("VP8L: backward reference out of range");
        for (int i = 0; i < length; ++i) px[pos + i] = px[pos + i - dist];
        pos += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (col & mask) g = group_at(col, row);
        if (cache_bits) flush_cache(pos);
      } else {  // colour cache
        const int key = code - 256 - 24;
        if (key >= (1 << cache_bits)) fail("VP8L: colour cache index out of range");
        flush_cache(pos);
        px[pos] = cache[key];
        ++pos;
        if (++col >= width) {
          col = 0;
          ++row;
          if (cache_bits) flush_cache(pos);
        }
      }
    }
    if (br.eos || pos < total) fail("VP8L: truncated image data");
    return px;
  }
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int sub3(int a, int b, int c) { return abs(b - c) - abs(a - c); }
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int k = 0; k < 32; k += 8) {
    const int v = (int)((c0 >> k) & 0xff) + (int)((c1 >> k) & 0xff) - (int)((c2 >> k) & 0xff);
    out |= clip255((uint32_t)v) << k;
  }
  return out;
}
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int k = 0; k < 32; k += 8) {
    const int a = (ave >> k) & 0xff, b = (c2 >> k) & 0xff;
    out |= clip255((uint32_t)(a + (a - b) / 2)) << k;
  }
  return out;
}

uint32_t predict(int mode, uint32_t L, const uint32_t* top) {  // top[0] = T
  switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], L, top[-1]);
    case 12: return clamped_add_subtract_full(L, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and the unused 14 and 15
  }
}

std::vector<uint32_t> inverse_transform(const Transform& t, const std::vector<uint32_t>& in) {
  const int w = t.xsize, h = t.ysize;
  std::vector<uint32_t> out((size_t)w * h);
  if (t.type == 0) {  // predictor
    const int tiles_per_row = subsample_size(w, t.bits);
    for (int y = 0; y < h; ++y) {
      uint32_t* o = out.data() + (size_t)y * w;
      const uint32_t* r = in.data() + (size_t)y * w;
      for (int x = 0; x < w; ++x) {
        int mode;
        if (y == 0) {
          mode = x == 0 ? 0 : 1;
        } else if (x == 0) {
          mode = 2;
        } else {
          mode = (t.data[(size_t)(y >> t.bits) * tiles_per_row + (x >> t.bits)] >> 8) & 0xf;
        }
        // the row above, its right neighbour for the last column being
        // this row's first pixel (contiguous in memory)
        const uint32_t* top = out.data() + (size_t)(y > 0 ? y - 1 : 0) * w + x;
        const uint32_t L = x > 0 ? o[x - 1] : 0;
        o[x] = add_pixels(r[x], predict(mode, L, top));
      }
    }
  } else if (t.type == 1) {  // cross-colour
    const int tiles_per_row = subsample_size(w, t.bits);
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        const uint32_t m = t.data[(size_t)(y >> t.bits) * tiles_per_row + (x >> t.bits)];
        const int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff),
                     r2b = (int8_t)((m >> 16) & 0xff);
        const uint32_t argb = in[(size_t)y * w + x];
        const int8_t green = (int8_t)(argb >> 8);
        int new_red = (argb >> 16) & 0xff;
        int new_blue = argb & 0xff;
        new_red += ((int)g2r * green) >> 5;
        new_red &= 0xff;
        new_blue += ((int)g2b * green) >> 5;
        new_blue += ((int)r2b * (int8_t)new_red) >> 5;
        new_blue &= 0xff;
        out[(size_t)y * w + x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | new_blue;
      }
    }
  } else if (t.type == 2) {  // subtract green
    for (size_t i = 0; i < out.size(); ++i) {
      const uint32_t argb = in[i];
      const uint32_t green = (argb >> 8) & 0xff;
      uint32_t rb = argb & 0x00ff00ffu;
      rb += (green << 16) | green;
      out[i] = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
    }
  } else {  // colour indexing, several indices bundled per pixel
    const int in_w = subsample_size(w, t.bits);
    const int bits_per_pixel = 8 >> t.bits;
    const int count_mask = (1 << t.bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    for (int y = 0; y < h; ++y) {
      const uint32_t* src = in.data() + (size_t)y * in_w;
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        out[(size_t)y * w + x] = t.data[packed & bit_mask];
        packed >>= bits_per_pixel;
      }
    }
  }
  return out;
}

void vp8l_decode(const uint8_t* data, size_t size, int exp_w, int exp_h, uint8_t* out) {
  if (size < 5) fail("VP8L: truncated header");
  if (data[0] != 0x2f) fail("VP8L: bad signature");
  VP8LDecoder dec(data + 1, size - 1);
  const int w = dec.br.read(14) + 1;
  const int h = dec.br.read(14) + 1;
  dec.br.read(1);  // alpha hint
  if (dec.br.read(3) != 0) fail("VP8L: unknown version");
  if (w != exp_w || h != exp_h) fail("VP8L: image size differs from the canvas");
  std::vector<uint32_t> px = dec.decode_image_stream(w, h, true);
  for (int i = (int)dec.transforms.size() - 1; i >= 0; --i)
    px = inverse_transform(dec.transforms[i], px);
  for (size_t i = 0; i < (size_t)w * h; ++i) {
    out[3 * i + 0] = (px[i] >> 16) & 0xff;
    out[3 * i + 1] = (px[i] >> 8) & 0xff;
    out[3 * i + 2] = px[i] & 0xff;
  }
}

// ---------------------------------------------------------- container
struct Bitstream {
  const uint8_t* data;
  size_t size;
  int kind;  // 1 VP8, 2 VP8L
  int width, height;  // the image's (the canvas's, for an animation)
  int frame_x = 0, frame_y = 0, frame_w = 0, frame_h = 0;  // the bitstream's rectangle
};

// The image chunk of a still file or of an animation frame (ALPH chunks
// before it and unknown ones are skipped): kind, data and size.
bool image_chunk(const uint8_t* tag, const uint8_t* payload, uint32_t csize, Bitstream& bs) {
  if (memcmp(tag, "VP8 ", 4) != 0 && memcmp(tag, "VP8L", 4) != 0) return false;
  bs.data = payload;
  bs.size = csize;
  bs.kind = tag[3] == 'L' ? 2 : 1;
  if (bs.kind == 1) {
    if (csize < 10) fail("VP8: truncated frame header");
    bs.frame_w = le16(payload + 6) & 0x3fff;
    bs.frame_h = le16(payload + 8) & 0x3fff;
  } else {
    if (csize < 5 || payload[0] != 0x2f) fail("VP8L: bad header");
    const uint32_t b = le32(payload + 1);
    bs.frame_w = (b & 0x3fff) + 1;
    bs.frame_h = ((b >> 14) & 0x3fff) + 1;
  }
  if (bs.frame_w <= 0 || bs.frame_h <= 0) fail("zero image size");
  return true;
}

// One ANMF chunk (WebPDemux's rules): its rectangle inside the canvas, one
// image chunk of the rectangle's size, an ALPH chunk only before a VP8 one.
Bitstream anim_frame(const uint8_t* payload, uint32_t csize, int canvas_w, int canvas_h) {
  if (csize < 16) fail("truncated ANMF chunk");
  Bitstream bs;
  const int x = 2 * (int)le24(payload), y = 2 * (int)le24(payload + 3);
  const int w = 1 + (int)le24(payload + 6), h = 1 + (int)le24(payload + 9);
  const uint8_t* p = payload + 16;
  const uint8_t* end = payload + csize;
  bool found = false, alpha = false;
  while (end - p >= 8) {
    const uint32_t n = le32(p + 4);
    if ((size_t)n > (size_t)(end - p - 8)) fail("truncated chunk in an ANMF frame");
    if (image_chunk(p, p + 8, n, bs)) {
      if (found) fail("two images in one ANMF frame");
      if (alpha && bs.kind == 2) fail("an ALPH chunk before a VP8L frame");
      found = true;
    } else if (memcmp(p, "ALPH", 4) == 0) {
      if (found) fail("an ALPH chunk after its frame's image");
      alpha = true;
    }
    const size_t step = 8 + (size_t)n + (n & 1);
    if (step > (size_t)(end - p)) break;
    p += step;
  }
  if (!found) fail("an ANMF frame without an image");
  if (bs.frame_w != w || bs.frame_h != h) fail("an ANMF frame's image differs from its size");
  if ((int64_t)x + w > canvas_w || (int64_t)y + h > canvas_h)
    fail("an ANMF frame reaches past the canvas");
  bs.frame_x = x;
  bs.frame_y = y;
  return bs;
}

Bitstream parse_container(const uint8_t* data, size_t size) {
  if (size < 12 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WEBP", 4) != 0)
    fail("not a RIFF WEBP file");
  const uint32_t riff_size = le32(data + 4);
  if (riff_size < 12) fail("RIFF size too small");
  if ((size_t)riff_size > size - 8) fail("truncated file (RIFF size exceeds the data)");
  const uint8_t* end = data + 8 + riff_size;
  const uint8_t* p = data + 12;
  int canvas_w = -1, canvas_h = -1;
  bool first = true, animated = false, saw_anim = false;
  Bitstream frame0;
  int frames = 0;
  while (true) {
    if (end - p < 8) {
      if (!animated) fail("no VP8 or VP8L chunk");
      if (frames == 0) fail("an animation without frames");
      frame0.width = canvas_w;
      frame0.height = canvas_h;
      return frame0;
    }
    const uint8_t* tag = p;
    const uint32_t csize = le32(p + 4);
    if ((size_t)csize > (size_t)(end - p - 8)) fail("truncated chunk");
    const uint8_t* payload = p + 8;
    Bitstream bs;
    if (memcmp(tag, "VP8X", 4) == 0) {
      if (!first) fail("misplaced VP8X chunk");
      if (csize != 10) fail("bad VP8X chunk size");
      animated = (payload[0] & 0x02) != 0;
      canvas_w = 1 + le24(payload + 4);
      canvas_h = 1 + le24(payload + 7);
    } else if (memcmp(tag, "ANIM", 4) == 0) {
      if (!animated) fail("an ANIM chunk in a still image");
      if (csize < 6) fail("truncated ANIM chunk");
      saw_anim = true;
    } else if (memcmp(tag, "ANMF", 4) == 0) {
      if (!animated) fail("an ANMF chunk in a still image");
      if (!saw_anim) fail("an ANMF chunk before the ANIM chunk");
      // every frame is checked, as WebPDemux checks them; the first is drawn
      const Bitstream f = anim_frame(payload, csize, canvas_w, canvas_h);
      if (frames++ == 0) frame0 = f;
    } else if (!animated && image_chunk(tag, payload, csize, bs)) {
      if (canvas_w >= 0 && (canvas_w != bs.frame_w || canvas_h != bs.frame_h))
        fail("image size differs from the VP8X canvas");
      bs.width = bs.frame_w;
      bs.height = bs.frame_h;
      return bs;
    } else if (animated && (memcmp(tag, "VP8 ", 4) == 0 || memcmp(tag, "VP8L", 4) == 0)) {
      fail("an image chunk outside the frames of an animation");
    }
    // ALPH, ICCP, EXIF, XMP and unknown chunks are skipped
    first = false;
    const size_t step = 8 + (size_t)csize + (csize & 1);
    if (step > (size_t)(end - p)) fail("truncated chunk");
    p += step;
  }
}

int report(const std::exception& e, char* msg, size_t msg_len) {
  if (msg && msg_len) snprintf(msg, msg_len, "%s", e.what());
  return 1;
}

}  // namespace

extern "C" {

int webp_probe(const uint8_t* data, size_t size, int* width, int* height, int* kind, char* msg,
               size_t msg_len) {
  try {
    const Bitstream bs = parse_container(data, size);
    *width = bs.width;
    *height = bs.height;
    *kind = bs.kind;
    return 0;
  } catch (const std::exception& e) {
    return report(e, msg, msg_len);
  }
}

int webp_decode_rgb(const uint8_t* data, size_t size, uint8_t* out, int width, int height,
                    char* msg, size_t msg_len) {
  try {
    const Bitstream bs = parse_container(data, size);
    if (bs.width != width || bs.height != height) fail("output size differs from the image");
    const bool whole = bs.frame_w == width && bs.frame_h == height;
    std::vector<uint8_t> frame;
    uint8_t* dst = out;
    if (!whole) {
      frame.resize((size_t)bs.frame_w * bs.frame_h * 3);
      dst = frame.data();
    }
    if (bs.kind == 1) {
      vp8_decode(bs.data, bs.size, bs.frame_w, bs.frame_h, dst);
    } else {
      vp8l_decode(bs.data, bs.size, bs.frame_w, bs.frame_h, dst);
    }
    if (!whole) {  // the frame at its offset on the cleared canvas
      memset(out, 0, (size_t)width * height * 3);
      for (int y = 0; y < bs.frame_h; ++y)
        memcpy(out + ((size_t)(bs.frame_y + y) * width + bs.frame_x) * 3,
               frame.data() + (size_t)y * bs.frame_w * 3, (size_t)bs.frame_w * 3);
    }
    return 0;
  } catch (const std::bad_alloc&) {
    if (msg && msg_len) snprintf(msg, msg_len, "out of memory");
    return 2;
  } catch (const std::exception& e) {
    return report(e, msg, msg_len);
  }
}

}  // extern "C"

// Fused correlation-window lookup for RAFT, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels under corr_lookup_pallas in
// raft_ncup_tpu/ops/corr_pallas.py: _lookup_kernel, launched by
// _lookup_one_level (the resident tier, :422), and _banded_lookup_kernel,
// launched by _banded_lookup_one_level (the banded tier, :672). Both compute
// the same function; only the TPU's VMEM limit made the banded tier a second
// kernel. One call here covers every pyramid level, with no size gate.
//
// Function, per query q = (b, y, x) and level l, with K = 2r + 1:
//   p     = coords[q] / 2^l            (x first)
//   o     = floor(p) - r               window origin in level pixels
//   f     = p - floor(p)               sub-pixel offset (fx, fy)
//   P[i][j] = <f1s[q], f2_l[b, o_y + i, o_x + j, :]>, i, j in [0, K]
//             (0 where that position lies outside the level: the zero
//             padding of grid_sample, and the JAX clamp into the zero margin)
//   out[q, l*K*K + kx*K + ky] = (1-fy)(1-fx) P[ky][kx] + (1-fy) fx P[ky][kx+1]
//                             + fy (1-fx) P[ky+1][kx] + fy fx P[ky+1][kx+1]
// f1s is fmap1 pre-scaled by 1/sqrt(C); taps are x-major, levels major.
//
// What bounds it on this card. The work is (K+1)^2 dot products of length C
// per (query, level) in f32 FMA outside the tensor cores (67 TFLOP/s): about
// 1.8 GFLOP against 52 MB at the served shape (batch 2, 55x128 queries,
// C=256, r=4, 4 levels), so the operation bound is 27 us. What limits a
// kernel is the operand traffic. Each fmap2 pixel is dotted with every
// query whose window covers it: read once per (query, position), as a
// 1 KB row per dot product, the lookup pulls about 3.5 GB through L1 and
// L2 for 52 MB of distinct input, and the cache bandwidth (128 B per clock
// and SM from L1) caps it far below the FMA rate.
//
// Design. One warp takes a tile of 2x4 neighbouring queries at one level;
// blocks of 4 warps take 4 tiles side by side. Lane t works out the window
// of query t % 8, clipped to the level; the warp reduces them to the tile's
// bounding box (P pixels) and the sum S of the clipped windows' areas. Each
// tile then takes one of two exact paths:
//   - the tiled path, when C <= 256 and 2P <= S (kStripRatio; the windows
//     overlap: smooth flow, coarse levels): the warp holds the 8 queries''
//     f1 rows in registers, lanes splitting the channels, and walks the
//     box 4 pixels a pass. Each pixel row is read once for the tile, and
//     each element loaded feeds 8 FMAs (one per query), instead of one.
//     The 32 partial sums of a pass (4 pixels x 8 queries) are reduced
//     across the warp by a transposing butterfly of 31 shuffle-adds, with
//     no selects: lane t holds sum i ^ t in register i, which costs only a
//     lane-dependent choice of the pixel each 8-lane group loads into a
//     slot (still 128 contiguous bytes) and a permutation of the f1 rows
//     once per tile. Lane t ends with the sum of pixel t / 8 and query
//     t % 8, and writes it into that query's patch if the pixel lies in
//     its window.
//   - the per-query path, for the other tiles (discontinuous or random
//     flow, far windows, C > 256): the warp takes the tile's queries one
//     by one, walks only the in-level positions of each window, 8 a pass
//     (4 when C > 256) with their loads in flight together, and reduces
//     the 8 sums by a transposing butterfly (9 shuffle-adds instead of the
//     40 of a reduction per position).
// Positions outside the level are never read: the patches start at zero.
// Both paths end in the same bilinear blend from the patches in shared
// memory. The tiles of each path are counted in path_tiles[0] (tiled) and
// path_tiles[1] (per-query); corr_cuda.tile_paths states the same rule.
//
// What bounds this design on an H100: issue. The tiled path issues 437
// instructions per pass of 4 pixels (256 FMAs, 31 shuffles, 35 adds, the
// rest addressing); at the FMA rate its two 16-byte loads per lane and
// pixel would keep L1 only about half busy. The per-query path reads each
// window row once per query, near the L2 bandwidth on random flow (about
// 1.3 GB of rows at level 0 of the served shape). The path rule's ratio
// of 2 was timed against 1 and 3 (chip_compare.py): equal on smooth flow,
// about 5% faster on random flow.
//
// Staging the box in shared memory does not pay here. A variant that gave
// a block a tile of 4x8 queries, staged the tile's box through shared
// memory in 16-channel slices (cp.async, a ring of up to 16 stages) and
// let each thread hold the sums of up to 6 box pixels with 8 queries took
// 1.9x this design's time on smooth flow and 1.26x on random flow
// (chip_compare.py). Its threads cannot keep the f1 rows in registers
// across their pixels, so they re-read 8 f1 chunks from shared memory for
// every 4 channels. Those loads, not device memory, set its time: a level
// alone took 0.122, 0.101, 0.092 and 0.078 ms from the finest to the
// coarsest on smooth flow, where this design takes 0.084 down to 0.044.
//
// The first design (one warp per query and level, one 1 KB row load and a
// 5-step shuffle reduction per position) took 0.389 ms at the served shape
// on an H100 (15x its bound).
//
// Operands in bf16. Under the bf16 precision presets the Pallas kernels
// stage bf16 f1 rows and f2 patches and upcast both to f32 before the dot
// products (corr_pallas.py:355-356, :517-518); the output stays f32. Here
// the kernel is templated on the features' storage type (float, or bf16_t:
// the upper half of an f32's bits): each 4-channel chunk is one 16-byte
// load in f32 and one 8-byte load in bf16, widened to a float4 in
// registers, so the lane-to-channel map, the transposing butterflies, the
// path rule and every sum are those of the f32 kernel, in f32. What should
// bound it: half the operand bytes (the output, 4 bytes a tap, is then
// the larger part of the byte bound) and the same FMAs, plus 4
// conversions (a shift or a mask each) per chunk loaded, on a tiled path
// that is already bound by issue rather than by bytes. So expect it near
// the f32 kernel's time, not half of it; making it faster is later work.
// On an H100 at the served shape it took 0.267 ms on random flow and 0.154
// ms on smooth flow, against 0.329 and 0.155 ms for the f32 kernel on the
// same values (chip_smoke.py): only the per-query path gained.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

// bf16 storage: the upper 16 bits of an f32 (round-to-nearest-even done by
// the caller). Widening is a shift or a mask; no conversion instruction.
struct bf16_t {
  unsigned short bits;
};

// A 4-channel chunk c4 of a channel row, widened to f32.
__device__ __forceinline__ float4 load4(const float* row, int c4) {
  return __ldg(reinterpret_cast<const float4*>(row) + c4);
}
__device__ __forceinline__ float4 load4(const bf16_t* row, int c4) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + c4);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 8;
constexpr int kMaxChannels = 512;
constexpr int kTileH = 2;  // a warp's tile: kTileH rows of kTileW queries
constexpr int kTileW = 4;
constexpr int kTileQ = kTileH * kTileW;
constexpr int kWarps = 4;  // warps (tiles) per block
constexpr int kTiledPixels = 4;  // box pixels per pass of the tiled path
constexpr int kMaxTiledNV = 2;   // the tiled path takes C <= 256
// A tile takes the tiled path when kStripRatio * (pixels of the bounding
// box of its clipped windows) <= (sum of their areas). At least 1, so a
// tiled box holds at most 8 (K+1)^2 pixels and split() stays exact.
constexpr int kStripRatio = 2;
// Blocks per SM the registers must allow: 3 (at most 168 registers a
// thread). On an H100, 2 and 4 (which spills) were no faster.
constexpr int kMinBlocks = 3;
static_assert(kTileQ * kTiledPixels == 32, "one sum per lane after a pass");

struct LevelTable {
  const void* ptr[kMaxLevels];  // (B, Hl, Wl, C) of the features' type
  int h[kMaxLevels];
  int w[kMaxLevels];
};

struct Window {
  int ox, oy;  // origin in level pixels, clamped to [-(K+1), size]
  float fx, fy;
};

__device__ __forceinline__ Window window_of(const float* coords, size_t bq,
                                            int l, int radius, int Hl,
                                            int Wl) {
  const float inv = 1.0f / (float)(1 << l);  // exact: a power of two
  const float px = coords[2 * bq] * inv;
  const float py = coords[2 * bq + 1] * inv;
  const float x0 = floorf(px);
  const float y0 = floorf(py);
  const float k1 = (float)(2 * radius + 2);
  Window w;
  w.fx = px - x0;
  w.fy = py - y0;
  // Clamp before the integer conversion: an origin clamped to -(K+1) or to
  // the level's size still puts every position outside the level, so a
  // far-away window reads all zeros.
  w.ox = (int)fminf(fmaxf(x0 - radius, -k1), (float)Wl);
  w.oy = (int)fminf(fmaxf(y0 - radius, -k1), (float)Hl);
  return w;
}

__device__ __forceinline__ float dot4(float4 a, float4 v, float s) {
  s = fmaf(a.x, v.x, s);
  s = fmaf(a.y, v.y, s);
  s = fmaf(a.z, v.z, s);
  return fmaf(a.w, v.w, s);
}

// a if c is nonzero, else b: a register select (selp). Written as a ternary
// on array elements, the compiler may index the array in local memory.
__device__ __forceinline__ float select(int c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.s32 p, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, p;\n\t}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(c));
  return r;
}

// One transposing step of reduce_scatter over lane bit S, then the next
// ones: each lane keeps the half of its values that its bit S selects, plus
// the partner lane's copy of that half. S is a template parameter so that
// every index is a constant and the values stay in registers.
template <int S, int V>
struct TransposeSteps {
  static __device__ __forceinline__ void run(float (&v)[V], int lane) {
    const int upper = lane & S;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float send = select(upper, v[k], v[k + S]);
      const float keep = select(upper, v[k + S], v[k]);
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, S);
    }
    TransposeSteps<S / 2, V>::run(v, lane);
  }
};
template <int V>
struct TransposeSteps<0, V> {
  static __device__ __forceinline__ void run(float (&)[V], int) {}
};

// The same reduction when lane t holds value i ^ t in register i (all 32
// values): every step keeps register k and adds the partner's register
// k + S, which holds the same value, so no step selects. Lane t ends with
// the sum of value t.
template <int S>
struct XorSteps {
  static __device__ __forceinline__ void run(float (&v)[32]) {
#pragma unroll
    for (int k = 0; k < S; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k + S], S);
    XorSteps<S / 2>::run(v);
  }
};
template <>
struct XorSteps<0> {
  static __device__ __forceinline__ void run(float (&)[32]) {}
};

// Sums each of the V values across the 32 lanes and leaves lane t with the
// sum of value t % V: a transposing butterfly over the low lane bits, then
// plain steps over the others. V - 1 + log2(32 / V) shuffle-adds.
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&v)[V], int lane) {
  static_assert(V >= 1 && V <= 32 && (V & (V - 1)) == 0, "V: a power of two");
  TransposeSteps<V / 2, V>::run(v, lane);
#pragma unroll
  for (int s = V; s < 32; s <<= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], s);
  return v[0];
}

// (y, x) = (p / w, p % w) for 0 <= p < 2^22 - 1, w >= 1, inv_w = 1 / w,
// without an integer divide: (p + 1/2) / w lies at least 1/(2w) from an
// integer, and the two roundings of the float product err by less than
// (p + 1/2) / w * 2^-23, so the truncation is exact.
__device__ __forceinline__ void split(int p, int w, float inv_w, int& y,
                                      int& x) {
  y = (int)(((float)p + 0.5f) * inv_w);
  x = p - y * w;
}

// A warp's tile of 2x4 queries at one level: where it lies, lane t's query
// (t % 8) with its window clipped to the level, the bounding box of the
// tile's clipped windows and the path rule.
template <typename T>
struct Tile {
  int b, l, y_base, x_base, Hl, Wl;
  const T* level;  // the level's plane of batch element b
  Window me;
  int wx0, wy0, ww, area;  // this lane's clipped window (area 0: empty)
  int bx0, by0, bw, npix;  // the box (npix 0: every window off the level)
  bool tiled;
};

template <typename T>
__device__ __forceinline__ Tile<T> tile_of(int tile, const float* coords,
                                           const LevelTable& lv, int B, int H,
                                           int W, int C, int radius,
                                           int tiles_y, int tiles_x, int lane) {
  Tile<T> t;
  int rest = tile;
  const int tx = rest % tiles_x;
  rest /= tiles_x;
  const int ty = rest % tiles_y;
  rest /= tiles_y;
  t.b = rest % B;
  t.l = rest / B;
  // The level's entry by constant indices: a dynamic index into the kernel
  // parameter would copy the whole table to local memory.
  const void* base = lv.ptr[0];
  t.Hl = lv.h[0];
  t.Wl = lv.w[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i == t.l) {
      base = lv.ptr[i];
      t.Hl = lv.h[i];
      t.Wl = lv.w[i];
    }
  t.level = static_cast<const T*>(base) + (size_t)t.b * t.Hl * t.Wl * C;
  t.y_base = ty * kTileH;
  t.x_base = tx * kTileW;

  const int K1 = 2 * radius + 2;
  const int q = lane % kTileQ;
  const int qy = t.y_base + q / kTileW;
  const int qx = t.x_base + q % kTileW;
  t.me = Window{-K1, -K1, 0.f, 0.f};  // a query off the image covers nothing
  if (qy < H && qx < W)
    t.me = window_of(coords, ((size_t)t.b * H + qy) * W + qx, t.l, radius,
                     t.Hl, t.Wl);
  t.wx0 = max(t.me.ox, 0);
  t.wy0 = max(t.me.oy, 0);
  const int wx1 = min(t.me.ox + K1, t.Wl);
  const int wy1 = min(t.me.oy + K1, t.Hl);
  const bool some = t.wx0 < wx1 && t.wy0 < wy1;
  t.ww = wx1 - t.wx0;
  t.area = some ? t.ww * (wy1 - t.wy0) : 0;
  constexpr int kFar = 1 << 29;  // sentinels: no difference overflows
  int bx0 = some ? t.wx0 : kFar, bx1 = some ? wx1 : -kFar;
  int by0 = some ? t.wy0 : kFar, by1 = some ? wy1 : -kFar;
  int sum_area = t.area;
#pragma unroll
  for (int o = 1; o < kTileQ; o <<= 1) {
    bx0 = min(bx0, __shfl_xor_sync(0xffffffffu, bx0, o));
    bx1 = max(bx1, __shfl_xor_sync(0xffffffffu, bx1, o));
    by0 = min(by0, __shfl_xor_sync(0xffffffffu, by0, o));
    by1 = max(by1, __shfl_xor_sync(0xffffffffu, by1, o));
    sum_area += __shfl_xor_sync(0xffffffffu, sum_area, o);
  }
  t.bw = max(bx1 - bx0, 0);
  t.npix = t.bw * max(by1 - by0, 0);
  t.bx0 = t.npix > 0 ? bx0 : 0;  // no sentinel reaches an address
  t.by0 = t.npix > 0 ? by0 : 0;
  t.tiled = C <= kMaxTiledNV * 128 && kStripRatio * t.npix <= sum_area;
  return t;
}

// Bilinear blend of the tile's (K+1)^2 patches into each query's K*K taps
// (x-major), by the whole warp.
template <typename T>
__device__ __forceinline__ void blend_tile(const Tile<T>& t, const float* patch,
                                           float* __restrict__ out, int H,
                                           int W, int L, int radius,
                                           int lane) {
  const int K = 2 * radius + 1;
  const int K1 = K + 1;
  const float inv_k = 1.f / (float)K;
  for (int u = 0; u < kTileQ; ++u) {
    const float fx = __shfl_sync(0xffffffffu, t.me.fx, u);
    const float fy = __shfl_sync(0xffffffffu, t.me.fy, u);
    const int uy = t.y_base + u / kTileW;
    const int ux = t.x_base + u % kTileW;
    if (uy >= H || ux >= W) continue;
    const float* pu = patch + u * K1 * K1;
    float* orow = out + ((((size_t)t.b * H + uy) * W + ux) * L + t.l) * K * K;
    for (int k = lane; k < K * K; k += 32) {
      int kx, ky;
      split(k, K, inv_k, kx, ky);
      const float v00 = pu[ky * K1 + kx];
      const float v01 = pu[ky * K1 + kx + 1];
      const float v10 = pu[(ky + 1) * K1 + kx];
      const float v11 = pu[(ky + 1) * K1 + kx + 1];
      orow[k] = (1.f - fy) * (1.f - fx) * v00 + (1.f - fy) * fx * v01 +
                fy * (1.f - fx) * v10 + fy * fx * v11;
    }
  }
}

// Tiled path, NV: float4 chunks of a channel row each lane holds (C <=
// NV * 128, NV <= 2): the 8 queries' f1 rows in registers, the box 4 pixels
// a pass, each loaded element used by all 8 queries.
template <typename T, int NV>
__device__ __forceinline__ void tiled_path(const Tile<T>& t,
                                           const T* __restrict__ f1s,
                                           float* patch, int H, int W, int C,
                                           int K1, int lane) {
  const int C4 = C >> 2;
  const int KK1 = K1 * K1;
  // Value i of a pass is (pixel i / 8, query i % 8); lane t keeps value t.
  // Lane t holds value i ^ t in register i (XorSteps): a[k] holds query
  // k ^ q, and slot j of a pass pixel j ^ g.
  const int q = lane % kTileQ;
  const int g = lane / kTileQ;
  float4 a[kTileQ][NV];
#pragma unroll
  for (int u = 0; u < kTileQ; ++u) {
    const int uy = t.y_base + u / kTileW;
    const int ux = t.x_base + u % kTileW;
    const bool in = uy < H && ux < W;
    const T* row = f1s + (((size_t)t.b * H + (in ? uy : 0)) * W + (in ? ux : 0)) * C;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) {
      const int c4 = lane + 32 * jj;
      a[u][jj] = in && c4 < C4 ? load4(row, c4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // a[k] <- a[k ^ q]: a conditional swap for each bit of q.
#pragma unroll
  for (int bit = 1; bit < kTileQ; bit <<= 1) {
    const int swap = q & bit;
#pragma unroll
    for (int k = 0; k < kTileQ; ++k) {
      if (k & bit) continue;
#pragma unroll
      for (int jj = 0; jj < NV; ++jj) {
        const float4 lo = a[k][jj], hi = a[k | bit][jj];
        a[k][jj] = make_float4(select(swap, hi.x, lo.x), select(swap, hi.y, lo.y),
                               select(swap, hi.z, lo.z), select(swap, hi.w, lo.w));
        a[k | bit][jj] = make_float4(select(swap, lo.x, hi.x), select(swap, lo.y, hi.y),
                                     select(swap, lo.z, hi.z), select(swap, lo.w, hi.w));
      }
    }
  }
  // Loads are not masked: a pixel past the box reads the box's last one
  // (its sums are never written) and a chunk past C reads the row's last
  // one (its f1 chunk is zero), so no register is zeroed per pass.
  int c4s[NV];
#pragma unroll
  for (int jj = 0; jj < NV; ++jj) c4s[jj] = min(lane + 32 * jj, C4 - 1);
  const T* box = t.level + ((size_t)t.by0 * t.Wl + t.bx0) * C;
  const float inv_bw = 1.f / (float)max(t.bw, 1);
  for (int p0 = 0; p0 < t.npix; p0 += kTiledPixels) {
    float4 v[kTiledPixels][NV];
    int my_y = 0, my_x = 0;  // box position of pixel p0 + g (slot 0)
#pragma unroll
    for (int j = 0; j < kTiledPixels; ++j) {
      int sy, sx;  // box position of pixel p0 + (j ^ g), clamped to the box
      split(min(p0 + (j ^ g), t.npix - 1), t.bw, inv_bw, sy, sx);
      if (j == 0) {
        my_y = sy;
        my_x = sx;
      }
      const T* px = box + ((size_t)sy * t.Wl + sx) * C;
#pragma unroll
      for (int jj = 0; jj < NV; ++jj) v[j][jj] = load4(px, c4s[jj]);
    }
    float sums[kTiledPixels * kTileQ];
#pragma unroll
    for (int j = 0; j < kTiledPixels; ++j)
#pragma unroll
      for (int k = 0; k < kTileQ; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) acc = dot4(a[k][jj], v[j][jj], acc);
        sums[j * kTileQ + k] = acc;
      }
    XorSteps<16>::run(sums);
    // sums[0]: pixel p0 + g with query q.
    if (p0 + g < t.npix) {
      const int i = t.by0 + my_y - t.me.oy;
      const int jx = t.bx0 + my_x - t.me.ox;
      if (i >= 0 && i < K1 && jx >= 0 && jx < K1) patch[q * KK1 + i * K1 + jx] = sums[0];
    }
  }
}

// Per-query path: the tile's queries one by one, each window's in-level
// positions V a pass with their loads in flight together.
template <typename T, int NV, int V>
__device__ __forceinline__ void per_query_path(const Tile<T>& t,
                                               const T* __restrict__ f1s,
                                               float* patch, int H, int W,
                                               int C, int K1, int lane) {
  const int C4 = C >> 2;
  const int KK1 = K1 * K1;
  int c4s[NV];
#pragma unroll
  for (int jj = 0; jj < NV; ++jj) c4s[jj] = min(lane + 32 * jj, C4 - 1);
  for (int u = 0; u < kTileQ; ++u) {
    const int n = __shfl_sync(0xffffffffu, t.area, u);
    if (n == 0) continue;  // off the image or off the level: zeros
    const int ox = __shfl_sync(0xffffffffu, t.me.ox, u);
    const int oy = __shfl_sync(0xffffffffu, t.me.oy, u);
    const int x0 = __shfl_sync(0xffffffffu, t.wx0, u);
    const int y0 = __shfl_sync(0xffffffffu, t.wy0, u);
    const int ww = __shfl_sync(0xffffffffu, t.ww, u);
    const int uy = t.y_base + u / kTileW;
    const int ux = t.x_base + u % kTileW;
    const T* row = f1s + (((size_t)t.b * H + uy) * W + ux) * C;
    float4 a[NV];
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) {
      const int c4 = lane + 32 * jj;
      a[jj] = c4 < C4 ? load4(row, c4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // Unmasked loads, as in the tiled path: a position past the window
    // reads its last one (never written), a chunk past C the row's last.
    const T* win = t.level + ((size_t)y0 * t.Wl + x0) * C;
    const float inv_ww = 1.f / (float)ww;
    for (int p0 = 0; p0 < n; p0 += V) {
      float4 v[V][NV];
#pragma unroll
      for (int s = 0; s < V; ++s) {
        int sy, sx;  // window position of in-level position p0 + s
        split(min(p0 + s, n - 1), ww, inv_ww, sy, sx);
        const T* px = win + ((size_t)sy * t.Wl + sx) * C;
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) v[s][jj] = load4(px, c4s[jj]);
      }
      float sums[V];
#pragma unroll
      for (int s = 0; s < V; ++s) {
        float acc = 0.f;
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) acc = dot4(a[jj], v[s][jj], acc);
        sums[s] = acc;
      }
      const float sum = reduce_scatter<V>(sums, lane);
      if (lane < V && p0 + lane < n) {
        int py, px;
        split(p0 + lane, ww, inv_ww, py, px);
        patch[u * KK1 + (y0 + py - oy) * K1 + (x0 + px - ox)] = sum;
      }
    }
  }
}

// One warp per tile; the rule picks the path. T: the features' storage
// type; NV: 4-channel chunks of a channel row each lane holds (C <= NV * 128).
template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
corr_lookup_kernel(const T* __restrict__ f1s,
                   const float* __restrict__ coords, LevelTable lv,
                   float* __restrict__ out,
                   unsigned long long* __restrict__ path_tiles,
                   int B, int H, int W, int C, int L, int radius,
                   int tiles_y, int tiles_x, int n_tiles) {
  extern __shared__ float smem[];
  __shared__ int s_count[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < 2) s_count[threadIdx.x] = 0;
  __syncthreads();
  const int K1 = 2 * radius + 2;
  float* patch = smem + warp * kTileQ * K1 * K1;  // the tile's patches
  const int tile = blockIdx.x * kWarps + warp;
  if (tile < n_tiles) {  // uniform across the warp
    const Tile<T> t = tile_of<T>(tile, coords, lv, B, H, W, C, radius, tiles_y,
                                 tiles_x, lane);
    for (int e = lane; e < kTileQ * K1 * K1; e += 32) patch[e] = 0.f;
    __syncwarp();
    if (NV <= kMaxTiledNV && t.tiled)
      tiled_path<T, NV <= kMaxTiledNV ? NV : 1>(t, f1s, patch, H, W, C, K1, lane);
    else
      per_query_path<T, NV, NV <= 2 ? 8 : 4>(t, f1s, patch, H, W, C, K1, lane);
    __syncwarp();
    blend_tile(t, patch, out, H, W, L, radius, lane);
    if (lane == 0) atomicAdd(&s_count[t.tiled ? 0 : 1], 1);
  }
  __syncthreads();
  if (threadIdx.x < 2 && path_tiles != nullptr && s_count[threadIdx.x] > 0)
    atomicAdd(path_tiles + threadIdx.x, (unsigned long long)s_count[threadIdx.x]);
}

// Checks the shape, then launches corr_lookup_kernel<T, NV> for C's NV.
template <typename T>
int launch(const T* f1s, const float* coords, const void* const* level_ptrs,
           const int* level_hw, int num_levels, int B, int H, int W, int C,
           int radius, float* out, unsigned long long* path_tiles, int device,
           void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || C < 4 || C % 4 ||
      C > kMaxChannels || radius < 0 || radius > kMaxRadius || B < 0 ||
      H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W > INT_MAX) return (int)cudaErrorInvalidValue;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long n_tiles = (long long)num_levels * B * tiles_y * tiles_x;
  if (n_tiles == 0) return 0;
  if (n_tiles > INT_MAX - kWarps) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  LevelTable lv{};
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = level_ptrs[l];
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
  }
  const int K1 = 2 * radius + 2;
  // At most 4 * 8 * 18^2 floats (41 KB): no opt-in above 48 KB needed.
  const size_t smem = (size_t)kWarps * kTileQ * K1 * K1 * sizeof(float);
  const unsigned blocks = (unsigned)((n_tiles + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CORR_LAUNCH(NV)                                                    \
  corr_lookup_kernel<T, NV><<<blocks, kWarps * 32, smem, s>>>(             \
      f1s, coords, lv, out, path_tiles, B, H, W, C, num_levels, radius,    \
      tiles_y, tiles_x, (int)n_tiles)
  switch ((C / 4 + 31) / 32) {
    case 1: CORR_LAUNCH(1); break;
    case 2: CORR_LAUNCH(2); break;
    case 3: CORR_LAUNCH(3); break;
    default: CORR_LAUNCH(4); break;
  }
#undef CORR_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// f1s: (B, H, W, C) f32, coords: (B, H, W, 2) f32, level_ptrs[l]:
// (B, Hl, Wl, C) f32 with level_hw = {H0, W0, H1, W1, ...};
// out: (B, H, W, L*K*K) f32. A tile of 2x4 queries takes the tiled path
// when C <= 256 and 2 * (pixels of the bounding box of its clipped
// windows) <= (sum of their areas). path_tiles: 2 64-bit counts, to which
// the tiles that took the tiled and the per-query path are added, or
// null. Feature rows 16-byte aligned. Returns the CUDA error of the launch
// (0 on success).
int corr_lookup_f32(const float* f1s, const float* coords,
                    const void* const* level_ptrs, const int* level_hw,
                    int num_levels, int B, int H, int W, int C, int radius,
                    float* out, unsigned long long* path_tiles, int device,
                    void* stream) {
  return launch<float>(f1s, coords, level_ptrs, level_hw, num_levels, B, H,
                       W, C, radius, out, path_tiles, device, stream);
}

// The same with f1s and every level in bf16 (feature rows 8-byte aligned):
// the sums are f32, and coords and out stay f32.
int corr_lookup_bf16(const void* f1s, const float* coords,
                     const void* const* level_ptrs, const int* level_hw,
                     int num_levels, int B, int H, int W, int C, int radius,
                     float* out, unsigned long long* path_tiles, int device,
                     void* stream) {
  return launch<bf16_t>(static_cast<const bf16_t*>(f1s), coords, level_ptrs,
                        level_hw, num_levels, B, H, W, C, radius, out,
                        path_tiles, device, stream);
}

}  // extern "C"

// Backward of the fused correlation-window lookup, hand-written for Hopper
// (sm_90a).
//
// The TPU kernels under corr_lookup_pallas (raft_ncup_tpu/ops/corr_pallas.py)
// have no backward kernel: its custom_vjp (_bwd, :816) differentiates the XLA
// on-the-fly lookup. This kernel computes that VJP. With the forward's
// notation (corr_lookup.cu), per query q = (b, y, x) and level l, K = 2r + 1,
// window origin o = floor(p) - r and offset f = p - floor(p) of
// p = coords[q] / 2^l, patch P[i][j] = <f1s[q], f2_l[o_y + i, o_x + j]> and
// out[q, l, kx*K + ky] = the bilinear blend of P around (ky, kx), the
// upstream g[q, l, t] first becomes a patch gradient
//   gP[i][j] = sum over the taps t whose blend reads P[i][j] of
//              g[q, l, t] * (that corner's bilinear weight),
// and then, at each window position inside the level,
//   d f1s[q]                += gP[i][j] * f2_l[o_y + i, o_x + j]
//   d f2_l[o_y + i, o_x + j] += gP[i][j] * f1s[q]
//   d coords[q] = sum_l 2^-l sum_t g[q, l, t] * d(blend)/d(f_x, f_y)
// where d(blend)/df reads the patch P itself: it is recomputed, one dot
// product per position, only when d coords is asked for. Positions outside
// the level are never read, as in the forward (the zero padding).
//
// What bounds it on this card. Per in-level position the function needs a
// multiply-add of a row of C floats into d f1s and one into d f2: at the
// training shape (B=6, 50x90 queries, C=256, 4 levels, r=4) about 1.6-1.9 G
// of each, against 0.14 GB of distinct inputs and outputs, so the FMA rate
// bounds it (0.09-0.11 ms). d f2 is a scatter: rows that neighbouring
// queries' windows share get adds from each of them, so a design that adds
// per (query, position) spends its time in the L2's atomic units, and more
// so on smooth flow, where neighbouring windows coincide.
//
// Design. A warp takes a tile of 2x4 neighbouring queries, the forward's
// tiles, and one slice of 128 channels (lanes split the slice in float4
// chunks; C = 256 gives two warps a tile). It holds the 8 queries' f1
// chunks and d f1s sums in registers and walks every level, writing d f1s
// once. Per level the warp stages the 8 patch gradients in shared memory and
// takes the forward's path rule (kStripRatio, corr_cuda.tile_paths) for the
// tile:
//   - the tiled path (C <= 256 and 2 * box pixels <= sum of the clipped
//     windows' areas: smooth flow, coarse levels) walks the bounding box of
//     the tile's clipped windows once, 4 pixels a pass. Lane t looks up
//     gP of query t % 8 at pixel t / 8 (zero outside that query's window)
//     into a 32-float buffer, so each lane reads a pixel's 8 values with two
//     16-byte broadcast loads. Each f2 element loaded feeds 8 FMAs into the
//     8 queries' d f1s, and the pixel's d f2 row, sum over the queries of
//     gP_q * f1_q, is formed in registers and added with one float4 atomic
//     per lane: one add per covered box pixel instead of one per (query,
//     position). Every sum is lane-local.
//   - the per-query path (scattered or far windows, C > 256) walks each
//     query's in-level positions, 8 a pass with their loads in flight, and
//     adds a row per position, as the first design did.
// With d coords asked for (never on the model's path: the model detaches
// the coordinates) the first design runs instead: a warp per query, its
// patch's dot products reduced across the warp for d coords. The kernels
// count the tiles of each path and the d f2 row adds (counts[0..2]);
// corr_cuda.backward_counts states the same rule in tensor code.
//
// What bounds this design on an H100 (chip_compare.py, training shape): L2
// traffic. Smooth flow takes 0.87 ms (13689 of 13800 (tile, level) pairs
// tiled, 1.30 M d f2 row adds where a row per window position would be
// 7.0 M); random flow 1.70 ms, where half the pairs are per-query and each
// of their positions still reads a 1 KB row and adds one (4.23 M row adds:
// reckoned from these counts, about 9 GB through L2). What did not pay: no
// register cap (198 registers, 2 blocks an SM: 1.2x slower on smooth flow),
// g's taps staged through shared memory by coalesced loads (1.06x slower).
//
// The first design (a warp per query, a row atomic per position) took
// 2.33 ms on random and 2.84 ms on smooth flow at the training shape on an
// H100, 25x its bound, more than half of it in the atomics.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 8;
constexpr int kMaxChannels = 512;
constexpr int kWarps = 4;
constexpr int kMaxK1 = 2 * kMaxRadius + 2;
constexpr int kTileH = 2;  // a tile: kTileH rows of kTileW queries, as the forward's
constexpr int kTileW = 4;
constexpr int kTileQ = kTileH * kTileW;
constexpr int kSliceChunks = 32;  // float4 chunks of a warp's channel slice
constexpr int kBoxPass = 4;       // box pixels per pass of the tiled path
constexpr int kQueryPass = 8;     // window positions per pass of the per-query path
constexpr int kQueryKernelPass = 4;  // window positions per pass of the query kernel
constexpr int kMaxTiledChannels = 256;
// The forward's path rule (corr_lookup.cu): tiled when kStripRatio * box
// pixels <= sum of the clipped windows' areas.
constexpr int kStripRatio = 2;
static_assert(kTileQ * kBoxPass == 32, "one looked-up value per lane and pass");
// Blocks per SM the tile kernel's registers must allow: 3 (at most 168
// registers a thread). Uncapped it took 198 and ran 20% slower on smooth
// flow; a cap of 128 was no faster (chip_compare.py, H100).
constexpr int kTileMinBlocks = 3;
// Per warp of the query kernel: g's taps, the patch gradient and the patch.
constexpr int kQueryWarpFloats = (kMaxK1 - 1) * (kMaxK1 - 1) + 2 * kMaxK1 * kMaxK1;

struct LevelTable {
  const float* ptr[kMaxLevels];
  float* grad[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ void atomic_add4(float* p, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(p), v);
#else
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 fma4(float s, float4 v, float4 acc) {
  return make_float4(fmaf(s, v.x, acc.x), fmaf(s, v.y, acc.y), fmaf(s, v.z, acc.z),
                     fmaf(s, v.w, acc.w));
}

// a if c is nonzero, else b: a register select (selp), so that an array
// indexed by a runtime value stays in registers.
__device__ __forceinline__ float select(int c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.s32 p, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, p;\n\t}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(c));
  return r;
}

__device__ __forceinline__ float4 select4(int c, float4 a, float4 b) {
  return make_float4(select(c, a.x, b.x), select(c, a.y, b.y), select(c, a.z, b.z),
                     select(c, a.w, b.w));
}

// (y, x) = (p / w, p % w) for 0 <= p < 2^22 - 1, w >= 1, inv_w = 1 / w,
// without an integer divide (exact: see corr_lookup.cu).
__device__ __forceinline__ void split(int p, int w, float inv_w, int& y, int& x) {
  y = (int)(((float)p + 0.5f) * inv_w);
  x = p - y * w;
}

// The level's entries by constant indices: a dynamic index into the kernel
// parameter would copy the whole table to local memory.
__device__ __forceinline__ void level_entry(const LevelTable& lv, int l,
                                            const float*& base, float*& grad,
                                            int& Hl, int& Wl) {
  base = lv.ptr[0];
  grad = lv.grad[0];
  Hl = lv.h[0];
  Wl = lv.w[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i == l) {
      base = lv.ptr[i];
      grad = lv.grad[i];
      Hl = lv.h[i];
      Wl = lv.w[i];
    }
}

// Patch gradient of one (query, level) at patch entry (i, j) from the
// query's K*K taps gq (x-major: tap (kx, ky) at kx * K + ky reads P[ky][kx],
// P[ky][kx+1], P[ky+1][kx] and P[ky+1][kx+1]).
__device__ __forceinline__ float patch_grad(const float* gq, int i, int j, int K,
                                            float fx, float fy) {
  float v = 0.f;
  if (i < K && j < K) v += gq[j * K + i] * ((1.f - fy) * (1.f - fx));
  if (i < K && j > 0) v += gq[(j - 1) * K + i] * ((1.f - fy) * fx);
  if (i > 0 && j < K) v += gq[j * K + i - 1] * (fy * (1.f - fx));
  if (i > 0 && j > 0) v += gq[(j - 1) * K + i - 1] * (fy * fx);
  return v;
}

// ------------------------------------------------------------ tile kernel

// One warp per (tile, channel slice), every level; 4 warps a block. gp:
// the warp's [8][K1*K1] patch gradients, then its 32-float pass buffer.
__global__ void __launch_bounds__(kWarps * 32, kTileMinBlocks)
corr_lookup_bwd_tile_kernel(const float* __restrict__ f1s,
                            const float* __restrict__ coords, LevelTable lv,
                            const float* __restrict__ g, float* __restrict__ df1s,
                            unsigned long long* __restrict__ counts, int B, int H,
                            int W, int C, int L, int radius, int tiles_y,
                            int tiles_x, int slices, int n_warps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned int s_count[3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < 3) s_count[threadIdx.x] = 0;
  __syncthreads();
  const int K = 2 * radius + 1;
  const int KK = K * K;
  const int K1 = K + 1;
  const int KK1 = K1 * K1;
  float* gp = smem + warp * (kTileQ * KK1 + 32);
  float* buf = gp + kTileQ * KK1;
  const int gw = blockIdx.x * kWarps + warp;
  if (gw < n_warps) {  // uniform across the warp
    const int tile = gw / slices;
    const int slice = gw - tile * slices;
    const int tx = tile % tiles_x;
    const int ty = (tile / tiles_x) % tiles_y;
    const int b = tile / (tiles_x * tiles_y);
    const int C4 = C >> 2;
    const int c4 = slice * kSliceChunks + lane;
    const bool has = c4 < C4;  // this lane holds channels
    const int c4c = min(c4, C4 - 1);
    const bool counting = slice == 0 && lane == 0;
    const bool tiled_ok = C <= kMaxTiledChannels;

    float4 a[kTileQ], acc[kTileQ];
#pragma unroll
    for (int u = 0; u < kTileQ; ++u) {
      const int uy = ty * kTileH + u / kTileW, ux = tx * kTileW + u % kTileW;
      const bool in = uy < H && ux < W;
      a[u] = in && has ? reinterpret_cast<const float4*>(
                             f1s + (((size_t)b * H + uy) * W + ux) * C)[c4]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // Lane t's query: t % 8.
    const int q = lane % kTileQ;
    const int qy = ty * kTileH + q / kTileW, qx = tx * kTileW + q % kTileW;
    const bool qin = qy < H && qx < W;
    const size_t qidx = ((size_t)b * H + (qin ? qy : 0)) * W + (qin ? qx : 0);
    const float cx = qin ? coords[2 * qidx] : 0.f;
    const float cy = qin ? coords[2 * qidx + 1] : 0.f;
    unsigned int n_adds = 0;

    for (int l = 0; l < L; ++l) {
      const float* base;
      float* gbase;
      int Hl, Wl;
      level_entry(lv, l, base, gbase, Hl, Wl);
      const float* level = base + (size_t)b * Hl * Wl * C;
      float* glevel = gbase == nullptr ? nullptr : gbase + (size_t)b * Hl * Wl * C;
      // This lane's query window, clipped; the box and the path rule.
      const float inv = 1.0f / (float)(1 << l);
      const float px = cx * inv, py = cy * inv;
      const float x0f = floorf(px), y0f = floorf(py);
      const float fx = px - x0f, fy = py - y0f;
      const float k1f = (float)K1;
      int ox = (int)fminf(fmaxf(x0f - radius, -k1f), (float)Wl);
      int oy = (int)fminf(fmaxf(y0f - radius, -k1f), (float)Hl);
      if (!qin) ox = oy = -K1;  // a query off the image covers nothing
      const int wx0 = max(ox, 0), wy0 = max(oy, 0);
      const int wx1 = min(ox + K1, Wl), wy1 = min(oy + K1, Hl);
      const bool some = wx0 < wx1 && wy0 < wy1;
      const int ww = wx1 - wx0;
      const int area = some ? ww * (wy1 - wy0) : 0;
      constexpr int kFar = 1 << 29;
      int bx0 = some ? wx0 : kFar, bx1 = some ? wx1 : -kFar;
      int by0 = some ? wy0 : kFar, by1 = some ? wy1 : -kFar;
      int sum_area = area;
#pragma unroll
      for (int o = 1; o < kTileQ; o <<= 1) {
        bx0 = min(bx0, __shfl_xor_sync(0xffffffffu, bx0, o));
        bx1 = max(bx1, __shfl_xor_sync(0xffffffffu, bx1, o));
        by0 = min(by0, __shfl_xor_sync(0xffffffffu, by0, o));
        by1 = max(by1, __shfl_xor_sync(0xffffffffu, by1, o));
        sum_area += __shfl_xor_sync(0xffffffffu, sum_area, o);
      }
      const int bw = max(bx1 - bx0, 0);
      const int npix = bw * max(by1 - by0, 0);
      const bool tiled = tiled_ok && kStripRatio * npix <= sum_area;
      if (counting) atomicAdd(&s_count[tiled ? 0 : 1], 1u);
      if (npix == 0) continue;  // every window off the level: no term

      // The 8 patch gradients (8 * K1^2 is a multiple of 32: uniform loop).
      __syncwarp();  // the previous level's reads of gp are done
      const float inv_kk1 = 1.f / (float)KK1, inv_k1 = 1.f / (float)K1;
      for (int e = lane; e < kTileQ * KK1; e += 32) {
        int u, pe, i, j;
        split(e, KK1, inv_kk1, u, pe);
        split(pe, K1, inv_k1, i, j);
        const float ufx = __shfl_sync(0xffffffffu, fx, u);
        const float ufy = __shfl_sync(0xffffffffu, fy, u);
        const int uy = ty * kTileH + u / kTileW, ux = tx * kTileW + u % kTileW;
        float v = 0.f;
        if (uy < H && ux < W)
          v = patch_grad(g + ((((size_t)b * H + uy) * W + ux) * L + l) * KK, i, j,
                         K, ufx, ufy);
        gp[e] = v;
      }
      __syncwarp();


      if (tiled) {
        const float inv_bw = 1.f / (float)max(bw, 1);
        const float4* box =
            reinterpret_cast<const float4*>(level) + ((size_t)by0 * Wl + bx0) * C4;
        float* gbox = glevel == nullptr ? nullptr : glevel + ((size_t)by0 * Wl + bx0) * C;
        const int slot = lane / kTileQ;  // this lane's pixel of a pass
        for (int p0 = 0; p0 < npix; p0 += kBoxPass) {
          // Lane t: gP of query q at pixel p0 + slot, zero outside q's window.
          const int pp = p0 + slot;
          int sy, sx;
          split(min(pp, npix - 1), bw, inv_bw, sy, sx);
          const int i = by0 + sy - oy, j = bx0 + sx - ox;
          const bool in = pp < npix && i >= 0 && i < K1 && j >= 0 && j < K1;
          buf[lane] = in ? gp[q * KK1 + (in ? i * K1 + j : 0)] : 0.f;
          const unsigned covered = __ballot_sync(0xffffffffu, in);
          int pix[kBoxPass];
          float4 v[kBoxPass];
#pragma unroll
          for (int s = 0; s < kBoxPass; ++s) {
            int ry, rx;  // past the box: its last pixel (never used)
            split(min(p0 + s, npix - 1), bw, inv_bw, ry, rx);
            pix[s] = ry * Wl + rx;
            v[s] = __ldg(box + (size_t)pix[s] * C4 + c4c);
          }
          __syncwarp();
#pragma unroll
          for (int s = 0; s < kBoxPass; ++s) {
            const bool hit = ((covered >> (kTileQ * s)) & 0xffu) != 0;
            if (!hit) continue;  // uniform: past the box, or no window covers it
            const float4 g0 = *reinterpret_cast<const float4*>(buf + kTileQ * s);
            const float4 g1 = *reinterpret_cast<const float4*>(buf + kTileQ * s + 4);
            const float gq[kTileQ] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
            float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int u = 0; u < kTileQ; ++u) {
              acc[u] = fma4(gq[u], v[s], acc[u]);
              d = fma4(gq[u], a[u], d);
            }
            if (gbox != nullptr) {
              if (has) atomic_add4(gbox + (size_t)pix[s] * C + 4 * c4, d);
              if (counting) ++n_adds;
            }
          }
          __syncwarp();  // the next pass overwrites buf
        }
      } else {
#pragma unroll 1
        for (int u = 0; u < kTileQ; ++u) {
          const int n = __shfl_sync(0xffffffffu, area, u);
          const int uox = __shfl_sync(0xffffffffu, ox, u);
          const int uoy = __shfl_sync(0xffffffffu, oy, u);
          const int ux0 = __shfl_sync(0xffffffffu, wx0, u);
          const int uy0 = __shfl_sync(0xffffffffu, wy0, u);
          const int uww = __shfl_sync(0xffffffffu, ww, u);
          if (n == 0) continue;  // off the image or off the level: no term
          float4 au = a[0];
#pragma unroll
          for (int k = 1; k < kTileQ; ++k) au = select4(u == k, a[k], au);
          float4 accu = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4* win =
              reinterpret_cast<const float4*>(level) + ((size_t)uy0 * Wl + ux0) * C4;
          float* gwin = glevel == nullptr ? nullptr : glevel + ((size_t)uy0 * Wl + ux0) * C;
          const float* gpu = gp + u * KK1 + (uy0 - uoy) * K1 + (ux0 - uox);
          const float inv_ww = 1.f / (float)uww;
          for (int p0 = 0; p0 < n; p0 += kQueryPass) {
            int pix[kQueryPass], pe[kQueryPass];
            float4 v[kQueryPass];
#pragma unroll
            for (int s = 0; s < kQueryPass; ++s) {
              int sy, sx;  // past the window: its last position (never used)
              split(min(p0 + s, n - 1), uww, inv_ww, sy, sx);
              pix[s] = sy * Wl + sx;
              pe[s] = sy * K1 + sx;
              v[s] = __ldg(win + (size_t)pix[s] * C4 + c4c);
            }
#pragma unroll
            for (int s = 0; s < kQueryPass; ++s) {
              if (p0 + s >= n) break;  // uniform across the warp
              const float gpv = gpu[pe[s]];
              accu = fma4(gpv, v[s], accu);
              if (gwin != nullptr && has)
                atomic_add4(gwin + (size_t)pix[s] * C + 4 * c4,
                            make_float4(gpv * au.x, gpv * au.y, gpv * au.z, gpv * au.w));
            }
          }
          if (counting && gwin != nullptr) n_adds += n;
#pragma unroll
          for (int k = 0; k < kTileQ; ++k) {
            const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            const float4 add = select4(u == k, accu, z);
            acc[k] = make_float4(acc[k].x + add.x, acc[k].y + add.y, acc[k].z + add.z,
                                 acc[k].w + add.w);
          }
        }
      }
    }
    if (df1s != nullptr && has) {
#pragma unroll
      for (int u = 0; u < kTileQ; ++u) {
        const int uy = ty * kTileH + u / kTileW, ux = tx * kTileW + u % kTileW;
        if (uy < H && ux < W)
          reinterpret_cast<float4*>(df1s + (((size_t)b * H + uy) * W + ux) * C)[c4] = acc[u];
      }
    }
    if (counting && n_adds > 0) atomicAdd(&s_count[2], n_adds);
  }
  __syncthreads();
  if (threadIdx.x < 3 && counts != nullptr && s_count[threadIdx.x] > 0)
    atomicAdd(counts + threadIdx.x, (unsigned long long)s_count[threadIdx.x]);
}

// ----------------------------------------------------------- query kernel

// The first design, for d coords: one warp per query, every level; lanes
// split the channels (NV float4 chunks each, C <= NV * 128). It counts the
// (tile, level) pairs as per-query tiles (at each tile's first query) and
// the row adds of every in-level position.
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_bwd_query_kernel(const float* __restrict__ f1s,
                             const float* __restrict__ coords, LevelTable lv,
                             const float* __restrict__ g, float* __restrict__ df1s,
                             float* __restrict__ dcoords,
                             unsigned long long* __restrict__ counts, int B, int H,
                             int W, int C, int L, int radius) {
  __shared__ float smem[kWarps * kQueryWarpFloats];
  __shared__ unsigned int s_count[3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < 3) s_count[threadIdx.x] = 0;
  __syncthreads();
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q < (long long)B * H * W) {  // uniform across the warp
    const int b = (int)(q / ((long long)H * W));
    const int rest = (int)(q - (long long)b * H * W);
    const int y = rest / W, x = rest - (rest / W) * W;
    const int K = 2 * radius + 1;
    const int K1 = K + 1;
    const int KK = K * K;
    float* sg = smem + warp * kQueryWarpFloats;  // [K*K] taps of g
    float* sgp = sg + KK;                        // [K1*K1] patch gradient
    float* sp = sgp + K1 * K1;                   // [K1*K1] patch (for d coords)
    const int C4 = C >> 2;
    const bool want_df1 = df1s != nullptr;
    const bool want_dc = dcoords != nullptr;

    float4 a[NV], acc[NV];
    int c4s[NV];
    const float4* row1 = reinterpret_cast<const float4*>(f1s + (size_t)q * C);
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) {
      const int c4 = lane + 32 * jj;
      c4s[jj] = min(c4, C4 - 1);
      a[jj] = c4 < C4 ? row1[c4] : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float cx = coords[2 * q], cy = coords[2 * q + 1];
    float dcx = 0.f, dcy = 0.f;
    unsigned int n_adds = 0;

    for (int l = 0; l < L; ++l) {
      const float* base;
      float* gbase;
      int Hl, Wl;
      level_entry(lv, l, base, gbase, Hl, Wl);
      const float inv = 1.0f / (float)(1 << l);
      const float px = cx * inv, py = cy * inv;
      const float fx0 = floorf(px), fy0 = floorf(py);
      const float fx = px - fx0, fy = py - fy0;
      const float k1f = (float)K1;
      const int ox = (int)fminf(fmaxf(fx0 - radius, -k1f), (float)Wl);
      const int oy = (int)fminf(fmaxf(fy0 - radius, -k1f), (float)Hl);
      const int wx0 = max(ox, 0), wy0 = max(oy, 0);
      const int ww = min(ox + K1, Wl) - wx0;
      const int wh = min(oy + K1, Hl) - wy0;
      const int n = (ww > 0 && wh > 0) ? ww * wh : 0;

      __syncwarp();  // the previous level's reads of sg / sgp / sp are done
      const float* gq = g + ((size_t)q * L + l) * KK;
      for (int t = lane; t < KK; t += 32) sg[t] = gq[t];
      __syncwarp();
      for (int e = lane; e < K1 * K1; e += 32) {
        sgp[e] = patch_grad(sg, e / K1, e % K1, K, fx, fy);
        if (want_dc) sp[e] = 0.f;
      }
      __syncwarp();
      if (n == 0) continue;  // zero patch: no term of any gradient
      const float4* win = reinterpret_cast<const float4*>(base) +
                          (((size_t)b * Hl + wy0) * Wl + wx0) * C4;
      float* gwin = gbase == nullptr ? nullptr
                                     : gbase + (((size_t)b * Hl + wy0) * Wl + wx0) * C;
      if (gwin != nullptr) n_adds += n;
      for (int p0 = 0; p0 < n; p0 += kQueryKernelPass) {
        float4 v[kQueryKernelPass][NV];
        int pe[kQueryKernelPass];
        size_t off[kQueryKernelPass];
#pragma unroll
        for (int s = 0; s < kQueryKernelPass; ++s) {
          const int p = min(p0 + s, n - 1);  // past the end: the last position
          const int sy = p / ww, sx = p % ww;
          pe[s] = (wy0 + sy - oy) * K1 + (wx0 + sx - ox);
          off[s] = ((size_t)sy * Wl + sx) * C4;
#pragma unroll
          for (int jj = 0; jj < NV; ++jj) v[s][jj] = __ldg(win + off[s] + c4s[jj]);
        }
#pragma unroll
        for (int s = 0; s < kQueryKernelPass; ++s) {
          if (p0 + s >= n) break;  // uniform across the warp
          const float gpv = sgp[pe[s]];
          float dot = 0.f;
#pragma unroll
          for (int jj = 0; jj < NV; ++jj) {
            const bool in = lane + 32 * jj < C4;
            if (want_df1) acc[jj] = fma4(gpv, v[s][jj], acc[jj]);
            if (gwin != nullptr && in)
              atomic_add4(gwin + off[s] * 4 + 4 * (lane + 32 * jj),
                          make_float4(gpv * a[jj].x, gpv * a[jj].y, gpv * a[jj].z,
                                      gpv * a[jj].w));
            if (want_dc) {
              dot = fmaf(a[jj].x, v[s][jj].x, dot);
              dot = fmaf(a[jj].y, v[s][jj].y, dot);
              dot = fmaf(a[jj].z, v[s][jj].z, dot);
              dot = fmaf(a[jj].w, v[s][jj].w, dot);
            }
          }
          if (want_dc) {
            dot = warp_sum(dot);
            if (lane == 0) sp[pe[s]] = dot;
          }
        }
      }
      if (want_dc) {
        __syncwarp();
        float sx = 0.f, sy = 0.f;
        for (int t = lane; t < KK; t += 32) {
          const int kx = t / K, ky = t % K;
          const float p00 = sp[ky * K1 + kx], p01 = sp[ky * K1 + kx + 1];
          const float p10 = sp[(ky + 1) * K1 + kx], p11 = sp[(ky + 1) * K1 + kx + 1];
          const float gt = sg[t];
          sx = fmaf(gt, (1.f - fy) * (p01 - p00) + fy * (p11 - p10), sx);
          sy = fmaf(gt, (1.f - fx) * (p10 - p00) + fx * (p11 - p01), sy);
        }
        dcx = fmaf(warp_sum(sx), inv, dcx);
        dcy = fmaf(warp_sum(sy), inv, dcy);
      }
    }
    if (want_df1) {
      float4* drow = reinterpret_cast<float4*>(df1s + (size_t)q * C);
#pragma unroll
      for (int jj = 0; jj < NV; ++jj) {
        const int c4 = lane + 32 * jj;
        if (c4 < C4) drow[c4] = acc[jj];
      }
    }
    if (lane == 0) {
      if (want_dc) {
        dcoords[2 * q] = dcx;
        dcoords[2 * q + 1] = dcy;
      }
      if (y % kTileH == 0 && x % kTileW == 0) atomicAdd(&s_count[1], (unsigned)L);
      if (n_adds > 0) atomicAdd(&s_count[2], n_adds);
    }
  }
  __syncthreads();
  if (threadIdx.x < 3 && counts != nullptr && s_count[threadIdx.x] > 0)
    atomicAdd(counts + threadIdx.x, (unsigned long long)s_count[threadIdx.x]);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// f1s: (B, H, W, C) f32, coords: (B, H, W, 2) f32, level_ptrs[l]:
// (B, Hl, Wl, C) f32 with level_hw = {H0, W0, H1, W1, ...}; g: (B, H, W,
// L*K*K) f32, the upstream gradient of the forward's output. Outputs, each
// optional (null: not computed): df1s (B, H, W, C), grad_ptrs[l] (B, Hl, Wl,
// C) (grad_ptrs itself null for none; each level must be zero on entry: the
// kernel adds into it), dcoords (B, H, W, 2). counts: 3 64-bit counts, or
// null, to which the (tile, level) pairs that took the tiled and the
// per-query path and the d f2 row adds are added. Without dcoords a tile of
// 2x4 queries takes the tiled path at a level when C <= 256 and 2 * (pixels
// of the bounding box of its clipped windows) <= (sum of their areas), as
// in the forward; with dcoords every tile takes the per-query path. Returns
// the CUDA error of the launch (0 on success).
int corr_lookup_bwd_f32(const float* f1s, const float* coords,
                        const void* const* level_ptrs, const int* level_hw,
                        int num_levels, int B, int H, int W, int C, int radius,
                        const float* g, float* df1s, void* const* grad_ptrs,
                        float* dcoords, unsigned long long* counts, int device,
                        void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || C < 4 || C % 4 ||
      C > kMaxChannels || radius < 0 || radius > kMaxRadius || B < 0 ||
      H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  const long long queries = (long long)B * H * W;
  if (queries == 0) return 0;
  if (queries > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  LevelTable lv{};
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = static_cast<const float*>(level_ptrs[l]);
    lv.grad[l] = grad_ptrs == nullptr ? nullptr : static_cast<float*>(grad_ptrs[l]);
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dcoords != nullptr) {
    const unsigned blocks = (unsigned)((queries + kWarps - 1) / kWarps);
#define CORR_BWD_QUERY(NV)                                                    \
  corr_lookup_bwd_query_kernel<NV><<<blocks, kWarps * 32, 0, s>>>(            \
      f1s, coords, lv, g, df1s, dcoords, counts, B, H, W, C, num_levels, radius)
    switch ((C / 4 + 31) / 32) {
      case 1: CORR_BWD_QUERY(1); break;
      case 2: CORR_BWD_QUERY(2); break;
      case 3: CORR_BWD_QUERY(3); break;
      default: CORR_BWD_QUERY(4); break;
    }
#undef CORR_BWD_QUERY
    return (int)cudaGetLastError();
  }
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int slices = (C / 4 + kSliceChunks - 1) / kSliceChunks;
  const long long n_warps = (long long)B * tiles_y * tiles_x * slices;
  if (n_warps > INT_MAX - kWarps) return (int)cudaErrorInvalidValue;
  const int K1 = 2 * radius + 2;
  // At most 4 * (8 * 18^2 + 32) floats (42 KB): no opt-in above 48 KB.
  const size_t smem = (size_t)kWarps * (kTileQ * K1 * K1 + 32) * sizeof(float);
  const unsigned blocks = (unsigned)((n_warps + kWarps - 1) / kWarps);
  corr_lookup_bwd_tile_kernel<<<blocks, kWarps * 32, smem, s>>>(
      f1s, coords, lv, g, df1s, counts, B, H, W, C, num_levels, radius, tiles_y,
      tiles_x, slices, (int)n_warps);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
//   d f2_l[o_y + i, o_x + j] += gP[i][j] * f1s[q]      (float4 atomics)
//   d coords[q] = sum_l 2^-l sum_t g[q, l, t] * d(blend)/d(f_x, f_y)
// where d(blend)/df reads the patch P itself: it is recomputed, one dot
// product per position, only when d coords is asked for. Positions outside
// the level are never read, as in the forward (the zero padding).
//
// What bounds it on this card. Per in-level position the kernel reads a row
// of C floats of f2_l (through L1/L2; every window re-reads its rows) and
// adds a row of C floats into d f2_l. At the training shape (B=6, 50x90
// queries, C=256, 4 levels, r=4) that is about 2.2 G multiply-adds into
// d f1s and as many atomic adds into d f2, about 9 GB each way through L2
// against 0.14 GB of distinct inputs and outputs: the L2's atomic and load
// bandwidth, not device memory or the FMA rate, sets its time.
//
// Design (a first, simple kernel). One warp per query, 4 warps a block;
// lanes split the channels (float4 chunks, C <= 512), the query's f1 row and
// its d f1 sum stay in registers across the levels. Per level the warp
// stages g's K*K taps and the (K+1)^2 patch gradient in shared memory, then
// walks the in-level window positions 4 a pass, loads of a pass in flight
// together, and adds each position's row into d f2_l with float4 atomicAdd
// (sm_90). With d coords asked for, each position's dot product is reduced
// across the warp into the patch, and the warp then reduces the tap sums.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 8;
constexpr int kMaxChannels = 512;
constexpr int kWarps = 4;
constexpr int kPass = 4;  // window positions per pass
constexpr int kMaxK1 = 2 * kMaxRadius + 2;
// Per warp: g's taps, the patch gradient and the patch.
constexpr int kWarpFloats = (kMaxK1 - 1) * (kMaxK1 - 1) + 2 * kMaxK1 * kMaxK1;

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

// NV: float4 chunks of a channel row per lane (C <= NV * 128).
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_bwd_kernel(const float* __restrict__ f1s,
                       const float* __restrict__ coords, LevelTable lv,
                       const float* __restrict__ g, float* __restrict__ df1s,
                       float* __restrict__ dcoords, int B, int H, int W, int C,
                       int L, int radius) {
  __shared__ float smem[kWarps * kWarpFloats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q >= (long long)B * H * W) return;  // uniform across the warp
  const int b = (int)(q / ((long long)H * W));
  const int K = 2 * radius + 1;
  const int K1 = K + 1;
  const int KK = K * K;
  float* sg = smem + warp * kWarpFloats;  // [K*K] taps of g
  float* sgp = sg + KK;                   // [K1*K1] patch gradient
  float* sp = sgp + K1 * K1;              // [K1*K1] patch (for d coords)
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

  for (int l = 0; l < L; ++l) {
    // The level's entry by constant indices (no local copy of the table).
    const float* base = lv.ptr[0];
    float* gbase = lv.grad[0];
    int Hl = lv.h[0], Wl = lv.w[0];
#pragma unroll
    for (int i = 1; i < kMaxLevels; ++i)
      if (i == l) {
        base = lv.ptr[i];
        gbase = lv.grad[i];
        Hl = lv.h[i];
        Wl = lv.w[i];
      }
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
    const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
    const float w10 = fy * (1.f - fx), w11 = fy * fx;
    for (int e = lane; e < K1 * K1; e += 32) {
      const int i = e / K1, j = e % K1;  // patch row (y), column (x)
      float v = 0.f;
      // tap (kx, ky) sits at index kx * K + ky and reads P[ky][kx],
      // P[ky][kx+1], P[ky+1][kx] and P[ky+1][kx+1].
      if (i < K && j < K) v += sg[j * K + i] * w00;
      if (i < K && j > 0) v += sg[(j - 1) * K + i] * w01;
      if (i > 0 && j < K) v += sg[j * K + i - 1] * w10;
      if (i > 0 && j > 0) v += sg[(j - 1) * K + i - 1] * w11;
      sgp[e] = v;
      if (want_dc) sp[e] = 0.f;
    }
    __syncwarp();
    if (n == 0) continue;  // zero patch: no term of any gradient
    const float4* win = reinterpret_cast<const float4*>(base) +
                        (((size_t)b * Hl + wy0) * Wl + wx0) * C4;
    float* gwin = gbase == nullptr
                      ? nullptr
                      : gbase + (((size_t)b * Hl + wy0) * Wl + wx0) * C;
    for (int p0 = 0; p0 < n; p0 += kPass) {
      float4 v[kPass][NV];
      int pe[kPass];
      size_t off[kPass];
#pragma unroll
      for (int s = 0; s < kPass; ++s) {
        const int p = min(p0 + s, n - 1);  // past the end: the last position
        const int sy = p / ww, sx = p % ww;
        pe[s] = (wy0 + sy - oy) * K1 + (wx0 + sx - ox);
        off[s] = ((size_t)sy * Wl + sx) * C4;
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) v[s][jj] = __ldg(win + off[s] + c4s[jj]);
      }
#pragma unroll
      for (int s = 0; s < kPass; ++s) {
        if (p0 + s >= n) break;  // uniform across the warp
        const float gp = sgp[pe[s]];
        float dot = 0.f;
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) {
          const bool in = lane + 32 * jj < C4;
          if (want_df1) {
            acc[jj].x = fmaf(gp, v[s][jj].x, acc[jj].x);
            acc[jj].y = fmaf(gp, v[s][jj].y, acc[jj].y);
            acc[jj].z = fmaf(gp, v[s][jj].z, acc[jj].z);
            acc[jj].w = fmaf(gp, v[s][jj].w, acc[jj].w);
          }
          if (gwin != nullptr && in && gp != 0.f)
            atomic_add4(gwin + off[s] * 4 + 4 * (lane + 32 * jj),
                        make_float4(gp * a[jj].x, gp * a[jj].y, gp * a[jj].z,
                                    gp * a[jj].w));
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
  if (want_dc && lane == 0) {
    dcoords[2 * q] = dcx;
    dcoords[2 * q + 1] = dcy;
  }
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
// kernel adds into it), dcoords (B, H, W, 2). Returns the CUDA error of the
// launch (0 on success).
int corr_lookup_bwd_f32(const float* f1s, const float* coords,
                        const void* const* level_ptrs, const int* level_hw,
                        int num_levels, int B, int H, int W, int C, int radius,
                        const float* g, float* df1s, void* const* grad_ptrs,
                        float* dcoords, int device, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || C < 4 || C % 4 ||
      C > kMaxChannels || radius < 0 || radius > kMaxRadius || B < 0 ||
      H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  const long long queries = (long long)B * H * W;
  if (queries == 0) return 0;
  if (queries > (long long)INT_MAX * kWarps) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  LevelTable lv{};
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = static_cast<const float*>(level_ptrs[l]);
    lv.grad[l] = grad_ptrs == nullptr ? nullptr : static_cast<float*>(grad_ptrs[l]);
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
  }
  const unsigned blocks = (unsigned)((queries + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CORR_BWD_LAUNCH(NV)                                                  \
  corr_lookup_bwd_kernel<NV><<<blocks, kWarps * 32, 0, s>>>(                 \
      f1s, coords, lv, g, df1s, dcoords, B, H, W, C, num_levels, radius)
  switch ((C / 4 + 31) / 32) {
    case 1: CORR_BWD_LAUNCH(1); break;
    case 2: CORR_BWD_LAUNCH(2); break;
    case 3: CORR_BWD_LAUNCH(3); break;
    default: CORR_BWD_LAUNCH(4); break;
  }
#undef CORR_BWD_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"

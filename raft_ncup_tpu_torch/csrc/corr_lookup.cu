// Fused correlation-window lookup for RAFT, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels under corr_lookup_pallas in
// raft_ncup_tpu/ops/corr_pallas.py:
//   - _lookup_kernel, launched by _lookup_one_level (the resident tier);
//   - _banded_lookup_kernel, launched by _banded_lookup_one_level (the
//     banded tier).
// Both compute the same function; only the TPU's VMEM limit made the banded
// tier a second kernel. This kernel reads the fmap2 pyramid straight from
// device memory (through L1/L2), so it has no size gate and no band split.
// One launch covers every pyramid level.
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
// Bound on this card: the (K+1)^2 dot products of length C per (query,
// level). At 440x1024 (55x128 queries), C=256, r=4, L=4, batch 1 that is
// 7040 * 4 * 100 * 256 * 2 = 1.44 GFLOP of f32 FMA outside the tensor cores
// (67 TFLOP/s): ~21 us, against ~26 MB of bytes (~8 us at 3.35 TB/s). So
// the work is bound by f32 operations, not bytes.
//
// Design (simple first version): one warp per (query, level). The C
// channels of f1s[q] sit in registers, split across the 32 lanes as float4
// chunks. Each of the (K+1)^2 patch positions is one coalesced C*4-byte row
// of the level, dotted in registers and reduced with warp shuffles; the
// patch lands in shared memory and the lanes blend and write the K*K taps.
// Warps of a block take neighbouring queries of one level, so their
// overlapping windows hit in L1. Later work: reduce 32 positions at once
// with a transposing shuffle tree, reuse the overlap in shared memory, and
// run the dot products on the tensor cores (wgmma, TMA).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxRadius = 8;
constexpr int kMaxChannels = 512;

struct LevelTable {
  const float* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NV = float4 chunks of f1s each lane holds (C <= NV * 128).
template <int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
corr_lookup_kernel(const float* __restrict__ f1s,
                   const float* __restrict__ coords, LevelTable lv,
                   float* __restrict__ out, int BN, int N, int C, int L,
                   int radius) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int K = 2 * radius + 1;
  const int K1 = K + 1;
  const long long gw = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (gw >= (long long)BN * L) return;  // whole warps exit together
  const int l = (int)(gw / BN);
  const int bq = (int)(gw - (long long)l * BN);
  const int b = bq / N;

  const int C4 = C >> 2;
  const float4* f1row = reinterpret_cast<const float4*>(f1s + (size_t)bq * C);
  float4 a[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c4 = lane + 32 * j;
    a[j] = c4 < C4 ? f1row[c4] : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const float inv = 1.0f / (float)(1 << l);  // exact: a power of two
  const float px = coords[2 * (size_t)bq] * inv;
  const float py = coords[2 * (size_t)bq + 1] * inv;
  const float x0 = floorf(px);
  const float y0 = floorf(py);
  const float fx = px - x0;
  const float fy = py - y0;
  const int Hl = lv.h[l];
  const int Wl = lv.w[l];
  // Clamp the origin before the integer conversion. An origin clamped to
  // -K1 or to the level's size still puts every position outside the
  // level, so a far-away window reads all zeros, as before the clamp.
  const int ox = (int)fminf(fmaxf(x0 - radius, (float)(-K1)), (float)Wl);
  const int oy = (int)fminf(fmaxf(y0 - radius, (float)(-K1)), (float)Hl);

  float* patch = smem + warp * K1 * K1;
  const float* level = lv.ptr[l] + (size_t)b * Hl * Wl * C;
  for (int i = 0; i < K1; ++i) {
    const int iy = oy + i;
    const bool row_in = iy >= 0 && iy < Hl;
    for (int j = 0; j < K1; ++j) {
      const int ix = ox + j;
      float s = 0.f;
      if (row_in && ix >= 0 && ix < Wl) {  // uniform across the warp
        const float4* row = reinterpret_cast<const float4*>(
            level + ((size_t)iy * Wl + ix) * C);
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) {
          const int c4 = lane + 32 * jj;
          if (c4 < C4) {
            const float4 v = __ldg(row + c4);
            s = fmaf(a[jj].x, v.x, s);
            s = fmaf(a[jj].y, v.y, s);
            s = fmaf(a[jj].z, v.z, s);
            s = fmaf(a[jj].w, v.w, s);
          }
        }
        s = warp_sum(s);
      }
      if (lane == 0) patch[i * K1 + j] = s;
    }
  }
  __syncwarp();

  float* orow = out + ((size_t)bq * L + l) * K * K;
  for (int t = lane; t < K * K; t += 32) {
    const int kx = t / K;
    const int ky = t - kx * K;
    const float v00 = patch[ky * K1 + kx];
    const float v01 = patch[ky * K1 + kx + 1];
    const float v10 = patch[(ky + 1) * K1 + kx];
    const float v11 = patch[(ky + 1) * K1 + kx + 1];
    orow[t] = (1.f - fy) * (1.f - fx) * v00 + (1.f - fy) * fx * v01 +
              fy * (1.f - fx) * v10 + fy * fx * v11;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// f1s: (B, N, C) f32, coords: (B, N, 2) f32, level_ptrs[l]: (B, Hl, Wl, C)
// f32 with level_hw = {H0, W0, H1, W1, ...}; out: (B, N, L*K*K) f32.
// Returns the CUDA error of the launch (0 on success).
int corr_lookup_f32(const float* f1s, const float* coords,
                    const void* const* level_ptrs, const int* level_hw,
                    int num_levels, int B, int N, int C, int radius,
                    float* out, int device, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || C < 4 || C % 4 ||
      C > kMaxChannels || radius < 0 || radius > kMaxRadius || B < 0 ||
      N < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  LevelTable lv{};
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = static_cast<const float*>(level_ptrs[l]);
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
  }
  const long long bn = (long long)B * N;
  if (bn > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long warps = bn * num_levels;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int K1 = 2 * radius + 2;
  const size_t smem = (size_t)kWarpsPerBlock * K1 * K1 * sizeof(float);
  const dim3 grid((unsigned)blocks);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nv = (C / 4 + 31) / 32;
  switch (nv) {
    case 1:
      corr_lookup_kernel<1><<<grid, block, smem, s>>>(
          f1s, coords, lv, out, (int)bn, N, C, num_levels, radius);
      break;
    case 2:
      corr_lookup_kernel<2><<<grid, block, smem, s>>>(
          f1s, coords, lv, out, (int)bn, N, C, num_levels, radius);
      break;
    case 3:
      corr_lookup_kernel<3><<<grid, block, smem, s>>>(
          f1s, coords, lv, out, (int)bn, N, C, num_levels, radius);
      break;
    default:
      corr_lookup_kernel<4><<<grid, block, smem, s>>>(
          f1s, coords, lv, out, (int)bn, N, C, num_levels, radius);
      break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

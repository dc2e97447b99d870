// Fused normalized convolution (NConv2d) for NCUP, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel raft_ncup_tpu/ops/nconv_pallas.py:_kernel,
// launched by _forward under nconv2d_fused. Function, stride 1, SAME zero
// padding, odd square k, non-negative weight w (Cout, Cin, k, k):
//   acc_x[co] = sum_{ci,ky,kx} w * data * conf     (data*conf formed here)
//   acc_c[co] = sum_{ci,ky,kx} w * conf
//   out[co]      = acc_x / (acc_c + eps) + bias[co]
//   conf_out[co] = acc_c / sum_{ci,ky,kx} w[co]
// on NCHW planes. JAX forms data*conf and pads outside the kernel; here the
// product and the bounds check happen inside, so each input is read once.
//
// Bound on this card: bytes. NCUP runs it with 1-4 input and 1-2 output
// channels at full resolution, so each output costs at most 2*k*k*Cin*Cout
// FMAs against 4*(2*Cin + 2*Cout) bytes moved: at 440x1024 with 2 folded
// planes the four layers of one forward move ~115 MB (~34 us at 3.35 TB/s)
// for ~0.8 GFLOP.
//
// Design (simple first version): one thread per output pixel computes all
// Cout channels; neighbouring threads take neighbouring pixels of a row, so
// the k*k*Cin tap reads coalesce and the halo is served from L1. The
// weights and their per-channel sums sit in shared memory; both
// accumulators are f32 registers, and the divide and the propagated
// confidence are written in the same pass. There is no size gate.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxCout = 8;
constexpr int kMaxWeights = 4096;
constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads)
nconv_kernel(const float* __restrict__ data, const float* __restrict__ conf,
             const float* __restrict__ weight, const float* __restrict__ bias,
             float* __restrict__ out, float* __restrict__ conf_out, int B,
             int Cin, int Cout, int H, int W, float eps) {
  extern __shared__ float sw[];  // Cout*Cin*K*K weights, then Cout sums
  const int per_out = Cin * K * K;
  const int nw = Cout * per_out;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) sw[i] = weight[i];
  __syncthreads();
  if (threadIdx.x < Cout) {
    float s = 0.f;
    for (int i = 0; i < per_out; ++i) s += sw[threadIdx.x * per_out + i];
    sw[nw + threadIdx.x] = s;
  }
  __syncthreads();

  const long long HW = (long long)H * W;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)B * HW) return;
  const int b = (int)(p / HW);
  const long long rem = p - (long long)b * HW;
  const int y = (int)(rem / W);
  const int x = (int)(rem - (long long)y * W);
  constexpr int P = K / 2;

  float ax[kMaxCout];
  float ac[kMaxCout];
#pragma unroll
  for (int co = 0; co < kMaxCout; ++co) {
    ax[co] = 0.f;
    ac[co] = 0.f;
  }
  for (int ci = 0; ci < Cin; ++ci) {
    const float* dpl = data + ((size_t)b * Cin + ci) * HW;
    const float* cpl = conf + ((size_t)b * Cin + ci) * HW;
    const float* wci = sw + ci * K * K;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      const int iy = y + ky - P;
      if (iy < 0 || iy >= H) continue;
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const int ix = x + kx - P;
        if (ix < 0 || ix >= W) continue;
        const size_t o = (size_t)iy * W + ix;
        const float c = __ldg(cpl + o);
        const float dc = __ldg(dpl + o) * c;
#pragma unroll
        for (int co = 0; co < kMaxCout; ++co) {
          if (co < Cout) {
            const float wv = wci[co * per_out + ky * K + kx];
            ax[co] = fmaf(wv, dc, ax[co]);
            ac[co] = fmaf(wv, c, ac[co]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int co = 0; co < kMaxCout; ++co) {
    if (co < Cout) {
      const size_t o = ((size_t)b * Cout + co) * HW + rem;
      const float bv = bias != nullptr ? bias[co] : 0.f;
      out[o] = ax[co] / (ac[co] + eps) + bv;
      conf_out[o] = ac[co] / sw[nw + co];
    }
  }
}

template <int K>
cudaError_t launch(const float* data, const float* conf, const float* weight,
                   const float* bias, float* out, float* conf_out, int B,
                   int Cin, int Cout, int H, int W, float eps,
                   cudaStream_t s) {
  const long long pixels = (long long)B * H * W;
  const long long blocks = (pixels + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(Cout * Cin * K * K + Cout) * sizeof(float);
  nconv_kernel<K><<<(unsigned)blocks, kThreads, smem, s>>>(
      data, conf, weight, bias, out, conf_out, B, Cin, Cout, H, W, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// data, conf: (B, Cin, H, W) f32; weight: (Cout, Cin, k, k) f32 >= 0;
// bias: (Cout,) f32 or null; out, conf_out: (B, Cout, H, W) f32.
// Returns the CUDA error of the launch (0 on success).
int nconv_f32(const float* data, const float* conf, const float* weight,
              const float* bias, float* out, float* conf_out, int B, int Cin,
              int Cout, int H, int W, int k, float eps, int device,
              void* stream) {
  if (B < 0 || Cin < 1 || Cout < 1 || Cout > kMaxCout || H < 0 || W < 0 ||
      Cout * Cin * k * k > kMaxWeights)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      err = launch<1>(data, conf, weight, bias, out, conf_out, B, Cin, Cout,
                      H, W, eps, s);
      break;
    case 3:
      err = launch<3>(data, conf, weight, bias, out, conf_out, B, Cin, Cout,
                      H, W, eps, s);
      break;
    case 5:
      err = launch<5>(data, conf, weight, bias, out, conf_out, B, Cin, Cout,
                      H, W, eps, s);
      break;
    case 7:
      err = launch<7>(data, conf, weight, bias, out, conf_out, B, Cin, Cout,
                      H, W, eps, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"

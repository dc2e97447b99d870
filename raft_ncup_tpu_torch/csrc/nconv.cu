// Fused normalized convolution (NConv2d) for NCUP, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel raft_ncup_tpu/ops/nconv_pallas.py:_kernel,
// launched by _forward under nconv2d_fused (:125). Function, stride 1, SAME
// zero padding, odd square k, non-negative weight w (Cout, Cin, k, k):
//   acc_x[co] = sum_{ci,ky,kx} w * data * conf     (data*conf formed here)
//   acc_c[co] = sum_{ci,ky,kx} w * conf
//   out[co]      = acc_x / (acc_c + eps) + bias[co]
//   conf_out[co] = acc_c / sum_{ci,ky,kx} w[co]
// on NCHW planes. JAX forms data*conf and pads outside the kernel; here both
// happen while the input is staged, so each input is read once.
//
// What bounds it on this card: bytes. NCUP runs it with 1-4 input and 1-2
// output channels at full resolution, so each output costs at most
// 2*k*k*Cin*Cout FMAs against 4*(2*Cin + 2*Cout) bytes moved: at 440x1024
// with 4 folded planes the four layers of one forward move about 230 MB
// (69 us at 3.35 TB/s) for under 3 GFLOP.
//
// Design. The kernel is a template on (k, Cin, Cout) for the four NCUP
// layers, (5,1,2), (5,2,2), (3,4,2) and (1,2,1), with one generic
// instantiation per k for every other shape (runtime Cin, Cout <= 8). A
// block of 256 threads owns a 64x16 output tile of one plane. It stages the
// tile plus its halo of data*conf and conf into shared memory with 16-byte
// loads where the rows are aligned, forming the product once per input
// pixel and writing zeros outside the image, so the tap loop has no bounds
// test. Each thread issues all its staging loads before its first store,
// and the block copies its weights while they are in flight, so a tile
// waits for about one memory latency; one warp per output channel sums
// the weights. Each thread computes 4 adjacent outputs of a row for every
// output channel: per input row it loads a 12-wide register window with
// three 16-byte shared loads and slides it across kx, so each weight (read
// from shared memory as a broadcast) feeds 8 FMAs. Stores are 16-byte
// where the row is aligned. The specialised layers stage every input
// channel at once; the generic one stages one channel per pass.
//
// On an H100 (chip_smoke.py) the four NCUP layers take about 0.14 ms
// against the 0.069 ms byte bound. Issuing a thread's staging loads
// together took them from 0.17 ms; more blocks per SM (fewer registers)
// did not help.
//
// The first design (one thread per output pixel, two global loads per tap
// and a loop predicated over 8 output slots) took 0.605 ms for the four
// layers on an H100 (8.8x its bound).

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxCout = 8;
constexpr int kMaxWeights = 4096;
constexpr int kThreads = 256;
constexpr int kTileW = 64;            // outputs per tile row
constexpr int kTileH = 16;            // tile rows
constexpr int kRun = 4;               // adjacent outputs per thread
constexpr int kHalo = 4;              // staged columns each side (>= k/2)
constexpr int kCols = kTileW + 2 * kHalo;  // 72 staged columns
static_assert(kThreads == (kTileW / kRun) * kTileH, "one run per thread");
static_assert(kThreads / 32 >= kMaxCout, "a warp per output channel's sum");

// K: kernel size; CIN, COUT: channel counts, or 0 for the generic
// instantiation (runtime cin, cout <= kMaxCout, one channel staged per pass).
template <int K, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
nconv_kernel(const float* __restrict__ data, const float* __restrict__ conf,
             const float* __restrict__ weight, const float* __restrict__ bias,
             float* __restrict__ out, float* __restrict__ conf_out, int cin,
             int cout, int H, int W, int tiles_y, int tiles_x, int vec,
             float eps) {
  constexpr int P = K / 2;
  constexpr int kRows = kTileH + K - 1;
  constexpr int kStage = CIN > 0 ? CIN : 1;  // channels staged per pass
  constexpr int kCo = COUT > 0 ? COUT : kMaxCout;
  static_assert(P <= kHalo, "halo too narrow");
  if (CIN > 0) cin = CIN;
  if (COUT > 0) cout = COUT;

  extern __shared__ __align__(16) float smem[];
  float* sd = smem;                          // [kStage][kRows][kCols] data*conf
  float* sc = sd + kStage * kRows * kCols;   // [kStage][kRows][kCols] conf
  float* sw = sc + kStage * kRows * kCols;   // weights, then Cout sums
  const int per_out = cin * K * K;
  const int nw = cout * per_out;
  const int tid = threadIdx.x;

  int rest = blockIdx.x;
  const int tx = rest % tiles_x;
  rest /= tiles_x;
  const int ty = rest % tiles_y;
  const int b = rest / tiles_y;
  const int x0 = tx * kTileW;
  const int y0 = ty * kTileH;
  const size_t HW = (size_t)H * W;
  const int tr = tid / (kTileW / kRun);   // tile row of this thread
  const int tc = tid % (kTileW / kRun);   // run index within the row

  float ax[kCo][kRun];
  float ac[kCo][kRun];
#pragma unroll
  for (int co = 0; co < kCo; ++co)
#pragma unroll
    for (int o = 0; o < kRun; ++o) {
      ax[co][o] = 0.f;
      ac[co][o] = 0.f;
    }

  for (int c0 = 0; c0 < cin; c0 += kStage) {
    if (CIN == 0) __syncthreads();  // the previous channel's taps are done
    // Stage kStage channels: groups of 4 columns starting at x0 - kHalo.
    // Every load of a thread is issued before its first store, so the
    // staging waits for one memory latency rather than one per element.
    constexpr int kGroups = kCols / 4;
    constexpr int kElems = kStage * kRows * kGroups;
    constexpr int kPerThread = (kElems + kThreads - 1) / kThreads;
    float4 d4[kPerThread], c4[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int g = e % kGroups;
      const int r = (e / kGroups) % kRows;
      const int s = e / (kGroups * kRows);
      const int y = y0 - P + r;
      const int x = x0 - kHalo + 4 * g;
      d4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      c4[i] = d4[i];
      if (e < kElems && y >= 0 && y < H) {
        const size_t o = ((size_t)b * cin + c0 + s) * HW + (size_t)y * W;
        if (vec && x >= 0 && x + 3 < W) {
          d4[i] = __ldg(reinterpret_cast<const float4*>(data + o + x));
          c4[i] = __ldg(reinterpret_cast<const float4*>(conf + o + x));
        } else {
          float dv[4], cv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const bool in = x + k >= 0 && x + k < W;
            dv[k] = in ? __ldg(data + o + x + k) : 0.f;
            cv[k] = in ? __ldg(conf + o + x + k) : 0.f;
          }
          d4[i] = make_float4(dv[0], dv[1], dv[2], dv[3]);
          c4[i] = make_float4(cv[0], cv[1], cv[2], cv[3]);
        }
      }
    }
    if (c0 == 0) {  // the weights, while the first loads are in flight
      for (int i = tid; i < nw; i += kThreads) sw[i] = weight[i];
      __syncthreads();
      // Their sum per output channel, one warp each (cout <= 8 warps).
      const int warp = tid >> 5, lane = tid & 31;
      if (warp < cout) {
        float sum = 0.f;
        for (int i = lane; i < per_out; i += 32) sum += sw[warp * per_out + i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) sw[nw + warp] = sum;
      }
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < kElems) {
        const int g = e % kGroups;
        const int r = (e / kGroups) % kRows;
        const int s = e / (kGroups * kRows);
        const int so = (s * kRows + r) * kCols + 4 * g;
        *reinterpret_cast<float4*>(sd + so) = make_float4(
            d4[i].x * c4[i].x, d4[i].y * c4[i].y, d4[i].z * c4[i].z, d4[i].w * c4[i].w);
        *reinterpret_cast<float4*>(sc + so) = c4[i];
      }
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const float* wci = sw + (c0 + s) * K * K;
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        // Register window: staged columns 4*tc .. 4*tc + 11; output o at
        // tap kx reads column 4*tc + kHalo - P + o + kx.
        const int so = (s * kRows + tr + ky) * kCols + kRun * tc;
        float wd[12], wc[12];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(sd + so + 4 * q);
          const float4 c = *reinterpret_cast<const float4*>(sc + so + 4 * q);
          wd[4 * q] = a.x; wd[4 * q + 1] = a.y;
          wd[4 * q + 2] = a.z; wd[4 * q + 3] = a.w;
          wc[4 * q] = c.x; wc[4 * q + 1] = c.y;
          wc[4 * q + 2] = c.z; wc[4 * q + 3] = c.w;
        }
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
#pragma unroll
          for (int co = 0; co < kCo; ++co) {
            if (COUT > 0 || co < cout) {
              const float wv = wci[co * per_out + ky * K + kx];
#pragma unroll
              for (int o = 0; o < kRun; ++o) {
                ax[co][o] = fmaf(wv, wd[kHalo - P + o + kx], ax[co][o]);
                ac[co][o] = fmaf(wv, wc[kHalo - P + o + kx], ac[co][o]);
              }
            }
          }
        }
      }
    }
  }

  const int y = y0 + tr;
  const int x = x0 + kRun * tc;
  if (y >= H || x >= W) return;
#pragma unroll
  for (int co = 0; co < kCo; ++co) {
    if (COUT > 0 || co < cout) {
      const float bv = bias != nullptr ? bias[co] : 0.f;
      const float wsum = sw[nw + co];
      float ov[kRun], cv[kRun];
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        ov[o] = ax[co][o] / (ac[co][o] + eps) + bv;
        cv[o] = ac[co][o] / wsum;
      }
      const size_t base = ((size_t)b * cout + co) * HW + (size_t)y * W + x;
      if (vec && x + kRun <= W) {
        *reinterpret_cast<float4*>(out + base) =
            make_float4(ov[0], ov[1], ov[2], ov[3]);
        *reinterpret_cast<float4*>(conf_out + base) =
            make_float4(cv[0], cv[1], cv[2], cv[3]);
      } else {
#pragma unroll
        for (int o = 0; o < kRun; ++o) {
          if (x + o < W) {
            out[base + o] = ov[o];
            conf_out[base + o] = cv[o];
          }
        }
      }
    }
  }
}

// Shared memory of nconv_kernel<K, CIN, ...>: the staged planes, then the
// weights and their sums (at most kMaxWeights + kMaxCout floats).
template <int K, int CIN>
constexpr size_t kMaxSmem() {
  return (2 * (size_t)(CIN > 0 ? CIN : 1) * (kTileH + K - 1) * kCols +
          kMaxWeights + kMaxCout) * sizeof(float);
}

template <int K, int CIN, int COUT>
cudaError_t launch(const float* data, const float* conf, const float* weight,
                   const float* bias, float* out, float* conf_out, int B,
                   int cin, int cout, int H, int W, int vec, float eps,
                   int device, cudaStream_t s) {
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long blocks = (long long)B * tiles_y * tiles_x;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr int kStage = CIN > 0 ? CIN : 1;
  const size_t stage = 2 * (size_t)kStage * (kTileH + K - 1) * kCols;
  const size_t smem = (stage + cout * cin * K * K + cout) * sizeof(float);
  // Raise the kernel's shared-memory limit once per device (to the most
  // any launch of it asks for): the call can stall the launch queue, so it
  // stays out of the per-launch path.
  static std::atomic<unsigned long long> raised{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (!(raised.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        nconv_kernel<K, CIN, COUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem<K, CIN>());
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit);
  }
  nconv_kernel<K, CIN, COUT><<<(unsigned)blocks, kThreads, smem, s>>>(
      data, conf, weight, bias, out, conf_out, cin, cout, H, W, tiles_y,
      tiles_x, vec, eps);
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
  // 16-byte loads and stores need aligned rows and planes.
  const auto aligned = [](const void* p) {
    return reinterpret_cast<size_t>(p) % 16 == 0;
  };
  const int vec = W % 4 == 0 && aligned(data) && aligned(conf) &&
                  aligned(out) && aligned(conf_out);
#define NCONV_LAUNCH(KK, CI, CO)                                              \
  launch<KK, CI, CO>(data, conf, weight, bias, out, conf_out, B, Cin, Cout, \
                     H, W, vec, eps, device, s)
  if (k == 5 && Cin == 1 && Cout == 2) {
    err = NCONV_LAUNCH(5, 1, 2);
  } else if (k == 5 && Cin == 2 && Cout == 2) {
    err = NCONV_LAUNCH(5, 2, 2);
  } else if (k == 3 && Cin == 4 && Cout == 2) {
    err = NCONV_LAUNCH(3, 4, 2);
  } else if (k == 1 && Cin == 2 && Cout == 1) {
    err = NCONV_LAUNCH(1, 2, 1);
  } else {
    switch (k) {
      case 1: err = NCONV_LAUNCH(1, 0, 0); break;
      case 3: err = NCONV_LAUNCH(3, 0, 0); break;
      case 5: err = NCONV_LAUNCH(5, 0, 0); break;
      case 7: err = NCONV_LAUNCH(7, 0, 0); break;
      default: err = cudaErrorInvalidValue;
    }
  }
#undef NCONV_LAUNCH
  return (int)err;
}

}  // extern "C"

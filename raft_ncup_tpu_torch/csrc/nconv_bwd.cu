// Backward of the fused normalized convolution (NConv2d) for NCUP,
// hand-written for Hopper (sm_90a).
//
// The TPU kernel raft_ncup_tpu/ops/nconv_pallas.py:_kernel has no backward
// kernel: its custom_vjp (_bwd, :179) differentiates the two-convolution XLA
// composition. This kernel computes that VJP in one pass over the planes.
// Forward, stride 1, SAME zero padding, odd square k, P = k / 2:
//   N[o]  = conv(data * conf, w)[o]      D[o] = conv(conf, w)[o]
//   out   = N / (D + eps) + bias         conf_out = D / s,  s[o] = sum w[o]
// With upstream go (of out) and gc (of conf_out), y = D + eps:
//   gN = go / y
//   gD = (-go * N) * (1 / (y * y)) + gc / s   (JAX's division VJP, term for
//        term, so a window with no confidence (N = 0, 1/y^2 = inf) gives the
//        same NaN as jax.vjp of the reference)
//   Gdc[i, p] = sum_{o, ky, kx} w[o, i, ky, kx] gN[o, p - (ky, kx) + P]
//   Gc [i, p] = the same with gD             (transposed convolutions)
//   d data = Gdc * conf       d conf = Gdc * data + Gc
//   d w[o, i, ky, kx] = sum_{b, p} gN[o, p] (data*conf)[i, p + (ky, kx) - P]
//                     + gD[o, p] conf[i, p + (ky, kx) - P]  - sum gc conf_out / s
//   d bias[o] = sum go[o]
// N and D are recovered from the outputs (D = conf_out * s,
// N = (out - bias) * y), so the forward saves only its inputs and outputs.
//
// What bounds it on this card: bytes. Each input and upstream gradient is
// read once and each gradient written once: 4 (B Cin + B Cout) H W reads of
// data, conf, out, conf_out, go, gc and 2 B Cin H W writes, against at most
// 8 k^2 Cin Cout FMAs per pixel (k = 5, Cin = Cout = 2 for NCUP's widest
// layer: 400 flops per pixel, far below the 20 flops per byte where the
// card's f32 rate would take over).
//
// Design (a first, simple kernel). A block of 256 threads owns a 64x16 tile
// of one plane. It computes gN and gD for every output channel over the tile
// plus a halo of P (zero outside the image) into shared memory, forming them
// from go, gc, out and conf_out as it stages them, and sums go and gc *
// conf_out over the tile's own pixels for the bias and the weight-sum
// terms. Then, one input channel at a time, it stages data*conf and conf
// over the tile plus halo; each thread takes 4 adjacent pixels of a row and
// sums the transposed convolutions from shared memory, writing d data and
// d conf; and the block reduces the channel's weight gradient over its tile,
// thread (e mod n_w) of group (e div n_w) summing weight element e over a
// strided share of the pixels, then one atomicAdd per element and block.
// A second launch of one block adds the weight-sum term to d w. Sums over
// blocks use float atomics, so their order, and the last bits of d w and
// d bias, change from run to run.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxCout = 8;
constexpr int kMaxWeights = 4096;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 64;
constexpr int kTileH = 16;
constexpr int kRun = 4;  // adjacent pixels per thread
static_assert(kThreads == (kTileW / kRun) * kTileH, "one run per thread");
static_assert(kWarps >= kMaxCout, "a warp per output channel's sum");

template <int K>
struct Geometry {
  static constexpr int P = K / 2;
  static constexpr int kRows = kTileH + 2 * P;
  static constexpr int kCols = kTileW + 2 * P;
  static constexpr int kPlane = kRows * kCols;
};

// Shared memory of nconv_bwd_kernel<K> for cout, cin (floats).
template <int K>
__host__ __device__ constexpr size_t smem_floats(int cin, int cout) {
  return (size_t)cout * cin * K * K     // weights
         + kMaxCout                     // their sums
         + 2 * (size_t)cout * Geometry<K>::kPlane  // gN, gD with halo
         + 2 * (size_t)Geometry<K>::kPlane         // data*conf, conf
         + kThreads                                // weight-gradient partials
         + 2 * kMaxCout * kWarps;                  // bias / weight-sum partials
}

template <int K>
__global__ void __launch_bounds__(kThreads)
nconv_bwd_kernel(const float* __restrict__ data, const float* __restrict__ conf,
                 const float* __restrict__ weight, const float* __restrict__ bias,
                 const float* __restrict__ out, const float* __restrict__ conf_out,
                 const float* __restrict__ go, const float* __restrict__ gc,
                 float* __restrict__ ddata, float* __restrict__ dconf,
                 float* __restrict__ dweight, float* __restrict__ dbias,
                 float* __restrict__ gsum, int cin, int cout, int H, int W,
                 int tiles_y, int tiles_x, float eps) {
  using G = Geometry<K>;
  constexpr int P = G::P;
  extern __shared__ __align__(16) float smem[];
  const int per_out = cin * K * K;
  const int nw = cout * per_out;
  float* sw = smem;                        // [cout][cin][K][K]
  float* ssum = sw + nw;                   // [kMaxCout]
  float* sgN = ssum + kMaxCout;            // [cout][kRows][kCols]
  float* sgD = sgN + cout * G::kPlane;     // [cout][kRows][kCols]
  float* sdc = sgD + cout * G::kPlane;     // [kRows][kCols]
  float* sc = sdc + G::kPlane;             // [kRows][kCols]
  float* sred = sc + G::kPlane;            // [kThreads]
  float* sbias = sred + kThreads;          // [kMaxCout][kWarps]
  float* sgs = sbias + kMaxCout * kWarps;  // [kMaxCout][kWarps]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int rest = blockIdx.x;
  const int tx = rest % tiles_x;
  rest /= tiles_x;
  const int ty = rest % tiles_y;
  const int b = rest / tiles_y;
  const int x0 = tx * kTileW, y0 = ty * kTileH;
  const size_t HW = (size_t)H * W;

  for (int e = tid; e < nw; e += kThreads) sw[e] = weight[e];
  __syncthreads();
  if (warp < cout) {
    float s = 0.f;
    for (int e = lane; e < per_out; e += 32) s += sw[warp * per_out + e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) ssum[warp] = s;
  }
  __syncthreads();

  // gN, gD over the tile plus halo; bias and weight-sum partials over the
  // tile's own pixels (each output pixel is interior to exactly one tile).
  float pb[kMaxCout], pg[kMaxCout];
#pragma unroll
  for (int o = 0; o < kMaxCout; ++o) pb[o] = pg[o] = 0.f;
  for (int e = tid; e < cout * G::kPlane; e += kThreads) {
    const int o = e / G::kPlane;
    const int r = (e / G::kCols) % G::kRows;
    const int c = e % G::kCols;
    const int y = y0 - P + r, x = x0 - P + c;
    float vN = 0.f, vD = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const size_t idx = ((size_t)b * cout + o) * HW + (size_t)y * W + x;
      const float s = ssum[o];
      const float bo = bias != nullptr ? bias[o] : 0.f;
      const float gov = go != nullptr ? go[idx] : 0.f;
      const float gcv = gc != nullptr ? gc[idx] : 0.f;
      const float co = conf_out[idx];
      const float yv = co * s + eps;        // D + eps
      const float nv = (out[idx] - bo) * yv;  // N
      vN = gov / yv;
      vD = (-gov * nv) * (1.f / (yv * yv)) + gcv / s;
      if (r >= P && r < P + kTileH && c >= P && c < P + kTileW) {
#pragma unroll
        for (int oo = 0; oo < kMaxCout; ++oo)
          if (oo == o) {
            pb[oo] += gov;
            pg[oo] += gcv * co;
          }
      }
    }
    sgN[e] = vN;
    sgD[e] = vD;
  }
#pragma unroll
  for (int o = 0; o < kMaxCout; ++o) {
    float vb = pb[o], vg = pg[o];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      vb += __shfl_xor_sync(0xffffffffu, vb, s);
      vg += __shfl_xor_sync(0xffffffffu, vg, s);
    }
    if (lane == 0) {
      sbias[o * kWarps + warp] = vb;
      sgs[o * kWarps + warp] = vg;
    }
  }
  __syncthreads();
  if (tid < cout) {
    float vb = 0.f, vg = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      vb += sbias[tid * kWarps + w];
      vg += sgs[tid * kWarps + w];
    }
    if (dbias != nullptr) atomicAdd(dbias + tid, vb);
    atomicAdd(gsum + tid, vg);
  }

  const int tr = tid / (kTileW / kRun);  // tile row of this thread's run
  const int tc = tid % (kTileW / kRun);
  const int py = y0 + tr;
  const int px0 = x0 + kRun * tc;
  const int kw = cout * K * K;                 // weight elements per channel
  const int groups = kw <= kThreads ? kThreads / kw : 1;
  const int me = tid % kw;
  const int grp = tid / kw;

  for (int i = 0; i < cin; ++i) {
    __syncthreads();  // the previous channel's reads of sdc / sc are done
    const size_t plane = ((size_t)b * cin + i) * HW;
    for (int e = tid; e < G::kPlane; e += kThreads) {
      const int r = e / G::kCols, c = e % G::kCols;
      const int y = y0 - P + r, x = x0 - P + c;
      float dv = 0.f, cv = 0.f;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const size_t idx = plane + (size_t)y * W + x;
        cv = conf[idx];
        dv = data[idx] * cv;
      }
      sdc[e] = dv;
      sc[e] = cv;
    }
    __syncthreads();

    // d data and d conf for this thread's 4 pixels.
    float gdc[kRun], gcc[kRun];
#pragma unroll
    for (int q = 0; q < kRun; ++q) gdc[q] = gcc[q] = 0.f;
    for (int o = 0; o < cout; ++o) {
      const float* wo = sw + (o * cin + i) * K * K;
      const float* gn = sgN + o * G::kPlane;
      const float* gd = sgD + o * G::kPlane;
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        // gN at output (py - ky + P, px - kx + P): staged row tr + 2P - ky.
        const int row = (tr + 2 * P - ky) * G::kCols + kRun * tc + 2 * P;
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float wv = wo[ky * K + kx];
#pragma unroll
          for (int q = 0; q < kRun; ++q) {
            gdc[q] = fmaf(wv, gn[row + q - kx], gdc[q]);
            gcc[q] = fmaf(wv, gd[row + q - kx], gcc[q]);
          }
        }
      }
    }
    if (py < H) {
#pragma unroll
      for (int q = 0; q < kRun; ++q) {
        const int x = px0 + q;
        if (x < W) {
          const size_t idx = plane + (size_t)py * W + x;
          const float cv = sc[(tr + P) * G::kCols + kRun * tc + q + P];
          ddata[idx] = gdc[q] * cv;
          dconf[idx] = gdc[q] * data[idx] + gcc[q];
        }
      }
    }

    // d w[o, i, ky, kx] over the tile: element me, pixels grp, grp + groups, ...
    for (int e = me; e < kw; e += kThreads) {
      const int o = e / (K * K);
      const int ky = (e / K) % K, kx = e % K;
      const float* gn = sgN + o * G::kPlane;
      const float* gd = sgD + o * G::kPlane;
      float acc = 0.f;
      if (grp < groups) {
        for (int p = grp; p < kTileH * kTileW; p += groups) {
          const int r = p / kTileW, c = p % kTileW;
          const int so = (r + P) * G::kCols + c + P;  // output pixel
          const int si = (r + ky) * G::kCols + c + kx;  // its tap's input
          acc = fmaf(gn[so], sdc[si], acc);
          acc = fmaf(gd[so], sc[si], acc);
        }
      }
      if (groups > 1) {
        sred[tid] = acc;
      } else {
        atomicAdd(dweight + (size_t)o * per_out + i * K * K + ky * K + kx, acc);
      }
    }
    if (groups > 1) {
      __syncthreads();
      if (tid < kw) {
        float acc = 0.f;
        for (int g = 0; g < groups; ++g) acc += sred[g * kw + tid];
        const int o = tid / (K * K), t = tid % (K * K);
        atomicAdd(dweight + (size_t)o * per_out + i * K * K + t, acc);
      }
    }
  }
}

// d w[o, ...] += -gsum[o] / s[o]: the weight-sum term of conf_out.
__global__ void nconv_bwd_finalize(const float* __restrict__ weight,
                                   const float* __restrict__ gsum,
                                   float* __restrict__ dweight, int cout,
                                   int per_out) {
  __shared__ float ssum[kMaxCout];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < cout) {
    float s = 0.f;
    for (int e = lane; e < per_out; e += 32) s += weight[warp * per_out + e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) ssum[warp] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < cout * per_out; e += blockDim.x) {
    const int o = e / per_out;
    dweight[e] += -gsum[o] / ssum[o];
  }
}

template <int K>
cudaError_t launch(const float* data, const float* conf, const float* weight,
                   const float* bias, const float* out, const float* conf_out,
                   const float* go, const float* gc, float* ddata, float* dconf,
                   float* dweight, float* dbias, float* gsum, int B, int cin,
                   int cout, int H, int W, float eps, int device,
                   cudaStream_t s) {
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long blocks = (long long)B * tiles_y * tiles_x;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (blocks > 0) {
    static std::atomic<unsigned long long> raised{0};
    const unsigned long long bit = 1ull << (device & 63);
    if (!(raised.load() & bit)) {
      // The most any launch asks for: the weights bounded by kMaxWeights.
      const size_t most =
          (kMaxWeights + kMaxCout + 2 * (size_t)kMaxCout * Geometry<K>::kPlane +
           2 * (size_t)Geometry<K>::kPlane + kThreads + 2 * kMaxCout * kWarps) *
          sizeof(float);
      const cudaError_t err = cudaFuncSetAttribute(
          nconv_bwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)most);
      if (err != cudaSuccess) return err;
      raised.fetch_or(bit);
    }
    const size_t smem = smem_floats<K>(cin, cout) * sizeof(float);
    nconv_bwd_kernel<K><<<(unsigned)blocks, kThreads, smem, s>>>(
        data, conf, weight, bias, out, conf_out, go, gc, ddata, dconf, dweight,
        dbias, gsum, cin, cout, H, W, tiles_y, tiles_x, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  nconv_bwd_finalize<<<1, kThreads, 0, s>>>(weight, gsum, dweight, cout,
                                            cin * K * K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// data, conf, ddata, dconf: (B, Cin, H, W) f32; weight, dweight: (Cout,
// Cin, k, k) f32; bias, dbias: (Cout,) f32 or null (both or neither);
// out, conf_out, go, gc: (B, Cout, H, W) f32, go and gc null for a zero
// upstream gradient; gsum: (Cout,) f32 scratch. dweight, dbias and gsum
// must be zero on entry. Returns the CUDA error of the launches.
int nconv_bwd_f32(const float* data, const float* conf, const float* weight,
                  const float* bias, const float* out, const float* conf_out,
                  const float* go, const float* gc, float* ddata, float* dconf,
                  float* dweight, float* dbias, float* gsum, int B, int Cin,
                  int Cout, int H, int W, int k, float eps, int device,
                  void* stream) {
  if (B < 0 || Cin < 1 || Cout < 1 || Cout > kMaxCout || H < 0 || W < 0 ||
      Cout * Cin * k * k > kMaxWeights || (bias == nullptr) != (dbias == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NCONV_BWD_LAUNCH(KK)                                                   \
  launch<KK>(data, conf, weight, bias, out, conf_out, go, gc, ddata, dconf,    \
             dweight, dbias, gsum, B, Cin, Cout, H, W, eps, device, s)
  switch (k) {
    case 1: err = NCONV_BWD_LAUNCH(1); break;
    case 3: err = NCONV_BWD_LAUNCH(3); break;
    case 5: err = NCONV_BWD_LAUNCH(5); break;
    case 7: err = NCONV_BWD_LAUNCH(7); break;
    default: err = cudaErrorInvalidValue;
  }
#undef NCONV_BWD_LAUNCH
  return (int)err;
}

}  // extern "C"

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
// card's f32 rate would take over). What a design must avoid is spending
// more issue slots per pixel than the bytes allow: shared-memory loads per
// FMA, and a reduction of the weight gradient per channel and block.
//
// Design. A template on (k, Cin, Cout) for the four NCUP layers, (5,1,2),
// (5,2,2), (3,4,2) and (1,2,1), with one generic instantiation per k for
// every other shape (runtime Cin, Cout <= 8, one input channel staged per
// pass), as the forward kernel is. A block of 128 threads owns a 64x16 tile
// of one plane. Before any sum it stages, over the tile plus its halo and
// with zeros outside the image, gN and gD of every output channel (formed
// from go, gc, out and conf_out as they arrive, each channel's loads issued
// together) and data*conf and conf of every input channel, and sums go and
// gc * conf_out over its own pixels. Each thread then owns 2 rows of 4
// adjacent pixels:
//   - d data and d conf: per input channel it slides register windows of
//     12 staged values (three 16-byte loads) over each of the k + 1 gN and
//     gD rows its two output rows read, so one load feeds 2k (or k) taps of
//     4 pixels;
//   - d w: it keeps its 8 pixels' gN and gD in registers, slides the same
//     windows over the k + 1 data*conf and conf rows, and sums Cout * k^2
//     weight elements (50, 50 a channel, 18 a channel, 1) in registers. A
//     transposing warp butterfly (31 shuffle-adds for 32 values) and a sum
//     over the block's 4 warps in a fixed order give the block's partial,
//     written to a scratch row per weight element.
// A second launch sums the partials of every block in a fixed order,
// adds the weight-sum term of conf_out and writes d w and d bias, so both
// are equal bit for bit from run to run.
//
// What bounds this design on an H100 (chip_compare.py, training planes
// (12, 400, 720)): the four layers take 0.72 ms against the 0.26 ms byte
// bound, most likely in the staging: a block waits for its loads in phases
// (the weights, each output channel's gN and gD, the input channels), and
// 3 blocks an SM do not hide that. What did not pay: staging every input at
// once with cp.async (more shared memory, fewer blocks an SM: 1.1-1.45x
// slower), 4 rows of 2 pixels a thread with the weights in registers (fewer
// shared loads; no faster, decoder_0 1.26x slower), at most 128 registers
// (decoder_0 1.15x slower).
//
// The first design (256 threads, one input channel staged at a time
// with two block barriers, one shared load per FMA in the transposed
// convolutions, and the weight gradient summed over strided pixels from
// shared memory with an atomic per element and block) took 1.58 ms for the
// four NCUP layers of a training batch (12, 400, 720) on an H100, 6.1x its
// byte bound.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxCout = 8;
constexpr int kMaxWeights = 4096;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 64;          // pixels per tile row
constexpr int kTileH = 16;          // tile rows
constexpr int kRun = 4;             // adjacent pixels of a row per thread
constexpr int kRowsPer = 2;         // rows per thread
constexpr int kHalo = 4;            // staged columns each side (>= k/2)
constexpr int kCols = kTileW + 2 * kHalo;  // 72 staged columns
constexpr int kGroups = kCols / 4;  // 16-byte groups of a staged row
constexpr int kFinalThreads = 256;
static_assert(kThreads == (kTileW / kRun) * (kTileH / kRowsPer), "one run pair per thread");

// Values a warp reduces for V sums: V rounded up to a power of two up to
// 32, to a multiple of 32 above.
__host__ __device__ constexpr int padded(int v) {
  return v <= 1 ? 1 : v <= 32 ? (v <= 2 ? 2 : v <= 4 ? 4 : v <= 8 ? 8 : v <= 16 ? 16 : 32)
                              : (v + 31) / 32 * 32;
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

// One transposing step over lane bit S, then the next ones: each lane keeps
// the half of its values that its bit S selects, plus the partner lane's
// copy of that half (as in corr_lookup.cu).
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

// Sums each of the V values across the 32 lanes and leaves lane t with the
// sum of value t % V. V - 1 + log2(32 / V) shuffle-adds.
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&v)[V], int lane) {
  static_assert(V >= 1 && V <= 32 && (V & (V - 1)) == 0, "V: a power of two");
  TransposeSteps<V / 2, V>::run(v, lane);
#pragma unroll
  for (int s = V; s < 32; s <<= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], s);
  return v[0];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s[o] = sum of w[o, ...] by one warp, in the same order in both kernels.
__device__ __forceinline__ float weight_sum(const float* w, int per_out, int lane) {
  float s = 0.f;
  for (int e = lane; e < per_out; e += 32) s += w[e];
  return warp_sum(s);
}

// Four values of a row from column x on, zeros outside [0, W).
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int x, int W,
                                        int vec) {
  if (vec && x >= 0 && x + 3 < W) return __ldg(reinterpret_cast<const float4*>(row + x));
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = (x + k >= 0 && x + k < W) ? __ldg(row + x + k) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void window12(const float* p, float (&w)[12]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float4 a = *reinterpret_cast<const float4*>(p + 4 * q);
    w[4 * q] = a.x;
    w[4 * q + 1] = a.y;
    w[4 * q + 2] = a.z;
    w[4 * q + 3] = a.w;
  }
}

// Block-wide sums of the V values of each thread: a warp butterfly, then the
// 4 warps' sums added in a fixed order; value e goes to part[row(e) *
// n_blocks + block]. sred holds kWarps * padded(V) floats.
template <int V, class Row>
__device__ __forceinline__ void block_partials(const float (&acc)[V], float* sred,
                                               float* __restrict__ part, int n_blocks,
                                               Row row, int tid) {
  constexpr int VP = padded(V);
  const int lane = tid & 31, warp = tid >> 5;
  float* dst = sred + warp * VP;
  if constexpr (VP <= 32) {
    float v[VP];
#pragma unroll
    for (int k = 0; k < VP; ++k) v[k] = k < V ? acc[k] : 0.f;
    const float s = reduce_scatter<VP>(v, lane);
    if (lane < VP) dst[lane] = s;
  } else {
#pragma unroll
    for (int c = 0; c < VP / 32; ++c) {
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = c * 32 + k < V ? acc[c * 32 + k] : 0.f;
      dst[c * 32 + lane] = reduce_scatter<32>(v, lane);
    }
  }
  __syncthreads();
  for (int e = tid; e < V; e += kThreads) {
    float s = sred[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += sred[w * VP + e];
    part[(size_t)row(e) * n_blocks + blockIdx.x] = s;
  }
  __syncthreads();  // sred is free again
}

template <int K>
struct Geometry {
  static constexpr int P = K / 2;
  static constexpr int kRows = kTileH + 2 * P;  // staged rows
  static constexpr int kPlane = kRows * kCols;
  static_assert(P <= kHalo, "halo too narrow");
};

// Shared memory of nconv_bwd_kernel<K, CIN, ...> for cin, cout (floats):
// gN and gD of every output channel, data*conf and conf of the staged input
// channels, the weights and their sums, the reduction buffers.
template <int K, int CIN>
__host__ __device__ constexpr size_t smem_floats(int cin, int cout) {
  return 2 * (size_t)cout * Geometry<K>::kPlane +
         2 * (size_t)(CIN > 0 ? CIN : 1) * Geometry<K>::kPlane +
         (size_t)(cout * cin * K * K + 3) / 4 * 4 + kMaxCout +
         (size_t)kWarps * 64 + 2 * kMaxCout * kWarps;
}

// K: kernel size; CIN, COUT: channel counts, or 0 for the generic
// instantiation (runtime cin, cout <= kMaxCout, one input channel a pass).
template <int K, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
nconv_bwd_kernel(const float* __restrict__ data, const float* __restrict__ conf,
                 const float* __restrict__ weight, const float* __restrict__ bias,
                 const float* __restrict__ out, const float* __restrict__ conf_out,
                 const float* __restrict__ go, const float* __restrict__ gc,
                 float* __restrict__ ddata, float* __restrict__ dconf,
                 float* __restrict__ part, int cin, int cout, int H, int W,
                 int tiles_y, int tiles_x, int vec, float eps) {
  using G = Geometry<K>;
  constexpr int P = G::P;
  constexpr int KK = K * K;
  constexpr int kStage = CIN > 0 ? CIN : 1;   // input channels staged a pass
  constexpr int kCo = COUT > 0 ? COUT : 1;    // output channels a d w pass sums
  static_assert(padded(kCo * KK) <= 64, "the reduction buffer holds 64 values a warp");
  if (CIN > 0) cin = CIN;
  if (COUT > 0) cout = COUT;
  extern __shared__ __align__(16) float smem[];
  float* sgN = smem;                          // [cout][kRows][kCols]
  float* sgD = sgN + cout * G::kPlane;        // [cout][kRows][kCols]
  float* sdc = sgD + cout * G::kPlane;        // [kStage][kRows][kCols] data*conf
  float* sc = sdc + kStage * G::kPlane;       // [kStage][kRows][kCols] conf
  const int per_out = cin * KK;
  const int nw = cout * per_out;
  float* sw = sc + kStage * G::kPlane;        // [cout][cin][K][K]
  float* ssum = sw + (nw + 3) / 4 * 4;        // [kMaxCout]
  float* sred = ssum + kMaxCout;              // [kWarps][64]
  float* sbias = sred + kWarps * 64;          // [kMaxCout][kWarps]
  float* sgs = sbias + kMaxCout * kWarps;     // [kMaxCout][kWarps]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_blocks = gridDim.x;
  int rest = blockIdx.x;
  const int tx = rest % tiles_x;
  rest /= tiles_x;
  const int ty = rest % tiles_y;
  const int b = rest / tiles_y;
  const int x0 = tx * kTileW, y0 = ty * kTileH;
  const size_t HW = (size_t)H * W;
  const int tr0 = kRowsPer * (tid / (kTileW / kRun));  // first tile row of this thread
  const int tc = tid % (kTileW / kRun);                // run index within the row

  for (int e = tid; e < nw; e += kThreads) sw[e] = weight[e];
  __syncthreads();
  for (int o = warp; o < cout; o += kWarps) {
    const float s = weight_sum(sw + o * per_out, per_out, lane);
    if (lane == 0) ssum[o] = s;
  }
  __syncthreads();

  // gN and gD of every output channel over the tile plus halo; the bias and
  // weight-sum terms over the tile's own pixels (each output pixel is
  // interior to exactly one tile).
  constexpr int kNElems = G::kRows * kGroups;
  constexpr int kNPer = (kNElems + kThreads - 1) / kThreads;
  for (int o = 0; o < cout; ++o) {
    const size_t plane = ((size_t)b * cout + o) * HW;
    const float s = ssum[o];
    const float bo = bias != nullptr ? bias[o] : 0.f;
    float pb = 0.f, pg = 0.f;
    float4 vgo[kNPer], vgc[kNPer], vout[kNPer], vco[kNPer];
#pragma unroll
    for (int k = 0; k < kNPer; ++k) {
      const int e = tid + k * kThreads;
      const int r = e / kGroups, g = e % kGroups;
      const int y = y0 - P + r, x = x0 - kHalo + 4 * g;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      vgo[k] = vgc[k] = vout[k] = vco[k] = z;
      if (e < kNElems && y >= 0 && y < H) {
        const size_t ro = plane + (size_t)y * W;
        if (go != nullptr) vgo[k] = load4(go + ro, x, W, vec);
        if (gc != nullptr) vgc[k] = load4(gc + ro, x, W, vec);
        vout[k] = load4(out + ro, x, W, vec);
        vco[k] = load4(conf_out + ro, x, W, vec);
      }
    }
#pragma unroll
    for (int k = 0; k < kNPer; ++k) {
      const int e = tid + k * kThreads;
      if (e >= kNElems) continue;
      const int r = e / kGroups, g = e % kGroups;
      const int y = y0 - P + r, x = x0 - kHalo + 4 * g;
      const float gov[4] = {vgo[k].x, vgo[k].y, vgo[k].z, vgo[k].w};
      const float gcv[4] = {vgc[k].x, vgc[k].y, vgc[k].z, vgc[k].w};
      const float ov[4] = {vout[k].x, vout[k].y, vout[k].z, vout[k].w};
      const float cov[4] = {vco[k].x, vco[k].y, vco[k].z, vco[k].w};
      float vN[4], vD[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vN[j] = vD[j] = 0.f;
        if (y >= 0 && y < H && x + j >= 0 && x + j < W) {
          const float yv = cov[j] * s + eps;         // D + eps
          const float nv = (ov[j] - bo) * yv;        // N
          vN[j] = gov[j] / yv;
          vD[j] = (-gov[j] * nv) * (1.f / (yv * yv)) + gcv[j] / s;
          if (r >= P && r < P + kTileH && 4 * g + j >= kHalo && 4 * g + j < kHalo + kTileW) {
            pb += gov[j];
            pg += gcv[j] * cov[j];
          }
        }
      }
      const int so = o * G::kPlane + r * kCols + 4 * g;
      *reinterpret_cast<float4*>(sgN + so) = make_float4(vN[0], vN[1], vN[2], vN[3]);
      *reinterpret_cast<float4*>(sgD + so) = make_float4(vD[0], vD[1], vD[2], vD[3]);
    }
    pb = warp_sum(pb);
    pg = warp_sum(pg);
    if (lane == 0) {
      sbias[o * kWarps + warp] = pb;
      sgs[o * kWarps + warp] = pg;
    }
  }
  __syncthreads();
  if (tid < 2 * cout) {  // rows nw + o (bias), nw + cout + o (weight-sum term)
    const float* src = tid < cout ? sbias + tid * kWarps : sgs + (tid - cout) * kWarps;
    float v = src[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += src[w];
    part[(size_t)(nw + tid) * n_blocks + blockIdx.x] = v;
  }

  for (int c0 = 0; c0 < cin; c0 += kStage) {
    if (CIN == 0) __syncthreads();  // the previous channel's reads are done
    // data*conf and conf of kStage channels; every load of a batch is issued
    // before its first store.
    constexpr int kElems = kStage * G::kRows * kGroups;
    constexpr int kPer = (kElems + kThreads - 1) / kThreads;
    constexpr int kBatch = kPer < 6 ? kPer : 6;
#pragma unroll
    for (int k0 = 0; k0 < kPer; k0 += kBatch) {
      float4 d4[kBatch], c4[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = tid + (k0 + k) * kThreads;
        const int g = e % kGroups;
        const int r = (e / kGroups) % G::kRows;
        const int st = e / (kGroups * G::kRows);
        const int y = y0 - P + r;
        d4[k] = c4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + k < kPer && e < kElems && y >= 0 && y < H) {
          const size_t ro = ((size_t)b * cin + c0 + st) * HW + (size_t)y * W;
          const int x = x0 - kHalo + 4 * g;
          d4[k] = load4(data + ro, x, W, vec);
          c4[k] = load4(conf + ro, x, W, vec);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = tid + (k0 + k) * kThreads;
        if (k0 + k < kPer && e < kElems) {
          const int g = e % kGroups;
          const int r = (e / kGroups) % G::kRows;
          const int st = e / (kGroups * G::kRows);
          const int so = (st * G::kRows + r) * kCols + 4 * g;
          *reinterpret_cast<float4*>(sdc + so) = make_float4(
              d4[k].x * c4[k].x, d4[k].y * c4[k].y, d4[k].z * c4[k].z, d4[k].w * c4[k].w);
          *reinterpret_cast<float4*>(sc + so) = c4[k];
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int st = 0; st < kStage; ++st) {
      const int i = c0 + st;
      // d data and d conf of this thread's 2x4 pixels: gN row tr0 + m serves
      // output row j at ky = j + 2P - m.
      float gdc[kRowsPer][kRun], gcc[kRowsPer][kRun];
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j)
#pragma unroll
        for (int q = 0; q < kRun; ++q) gdc[j][q] = gcc[j][q] = 0.f;
      const auto taps_of = [&](int o) {
        const float* wo = sw + (o * cin + i) * KK;
#pragma unroll
        for (int m = 0; m <= K; ++m) {
          float wn[12], wd[12];
          const int so = o * G::kPlane + (tr0 + m) * kCols + kRun * tc;
          window12(sgN + so, wn);
          window12(sgD + so, wd);
#pragma unroll
          for (int j = 0; j < kRowsPer; ++j) {
            const int ky = j + 2 * P - m;
            if (ky < 0 || ky >= K) continue;
#pragma unroll
            for (int kx = 0; kx < K; ++kx) {
              const float wv = wo[ky * K + kx];
#pragma unroll
              for (int q = 0; q < kRun; ++q) {
                gdc[j][q] = fmaf(wv, wn[q - kx + P + kHalo], gdc[j][q]);
                gcc[j][q] = fmaf(wv, wd[q - kx + P + kHalo], gcc[j][q]);
              }
            }
          }
        }
      };
      if constexpr (COUT > 0) {
#pragma unroll
        for (int o = 0; o < COUT; ++o) taps_of(o);
      } else {
        for (int o = 0; o < cout; ++o) taps_of(o);
      }
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j) {
        const int y = y0 + tr0 + j;
        const int x = x0 + kRun * tc;
        if (y >= H || x >= W) continue;
        const size_t ro = ((size_t)b * cin + i) * HW + (size_t)y * W;
        const float4 dv4 = load4(data + ro, x, W, vec);
        const float dv[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
        const float* cv = sc + (st * G::kRows + tr0 + j + P) * kCols + kRun * tc + kHalo;
        float rd[kRun], rc[kRun];
#pragma unroll
        for (int q = 0; q < kRun; ++q) {
          rd[q] = gdc[j][q] * cv[q];
          rc[q] = gdc[j][q] * dv[q] + gcc[j][q];
        }
        if (vec && x + kRun <= W) {
          *reinterpret_cast<float4*>(ddata + ro + x) = make_float4(rd[0], rd[1], rd[2], rd[3]);
          *reinterpret_cast<float4*>(dconf + ro + x) = make_float4(rc[0], rc[1], rc[2], rc[3]);
        } else {
#pragma unroll
          for (int q = 0; q < kRun; ++q)
            if (x + q < W) {
              ddata[ro + x + q] = rd[q];
              dconf[ro + x + q] = rc[q];
            }
        }
      }

      // d w[o, i, :, :] over this thread's pixels, kCo output channels a
      // pass: data*conf row tr0 + m serves output row j at ky = m - j.
      for (int o0 = 0; o0 < cout; o0 += kCo) {
        float gn[kCo][kRowsPer][kRun], gd[kCo][kRowsPer][kRun];
#pragma unroll
        for (int oo = 0; oo < kCo; ++oo)
#pragma unroll
          for (int j = 0; j < kRowsPer; ++j) {
            const int so = (o0 + oo) * G::kPlane + (tr0 + j + P) * kCols + kRun * tc + kHalo;
            const float4 n4 = *reinterpret_cast<const float4*>(sgN + so);
            const float4 d4 = *reinterpret_cast<const float4*>(sgD + so);
            gn[oo][j][0] = n4.x; gn[oo][j][1] = n4.y; gn[oo][j][2] = n4.z; gn[oo][j][3] = n4.w;
            gd[oo][j][0] = d4.x; gd[oo][j][1] = d4.y; gd[oo][j][2] = d4.z; gd[oo][j][3] = d4.w;
          }
        float acc[kCo * KK];
#pragma unroll
        for (int v = 0; v < kCo * KK; ++v) acc[v] = 0.f;
#pragma unroll
        for (int m = 0; m <= K; ++m) {
          float wdc[12], wc[12];
          const int so = (st * G::kRows + tr0 + m) * kCols + kRun * tc;
          window12(sdc + so, wdc);
          window12(sc + so, wc);
#pragma unroll
          for (int j = 0; j < kRowsPer; ++j) {
            const int ky = m - j;
            if (ky < 0 || ky >= K) continue;
#pragma unroll
            for (int kx = 0; kx < K; ++kx)
#pragma unroll
              for (int oo = 0; oo < kCo; ++oo) {
                float a = acc[oo * KK + ky * K + kx];
#pragma unroll
                for (int q = 0; q < kRun; ++q) {
                  a = fmaf(gn[oo][j][q], wdc[q + kx - P + kHalo], a);
                  a = fmaf(gd[oo][j][q], wc[q + kx - P + kHalo], a);
                }
                acc[oo * KK + ky * K + kx] = a;
              }
          }
        }
        block_partials(acc, sred, part, n_blocks,
                       [&](int e) { return ((o0 + e / KK) * cin + i) * KK + e % KK; }, tid);
      }
    }
  }
}

// Sums row blockIdx.x of the partials over the blocks in a fixed order:
// rows [0, nw) give d w (with the weight-sum term of row nw + cout + o),
// rows [nw, nw + cout) give d bias.
__global__ void __launch_bounds__(kFinalThreads)
nconv_bwd_finalize(const float* __restrict__ weight, const float* __restrict__ part,
                   float* __restrict__ dweight, float* __restrict__ dbias, int cout,
                   int per_out, int n_blocks) {
  __shared__ float sred[kFinalThreads];
  __shared__ float s_w;
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int nw = cout * per_out;
  auto row_sum = [&](int r) {
    float v = 0.f;
    for (int k = tid; k < n_blocks; k += kFinalThreads) v += part[(size_t)r * n_blocks + k];
    sred[tid] = v;
    __syncthreads();
#pragma unroll
    for (int s = kFinalThreads / 2; s > 0; s >>= 1) {
      if (tid < s) sred[tid] += sred[tid + s];
      __syncthreads();
    }
    const float total = sred[0];
    __syncthreads();
    return total;
  };
  const float total = row_sum(row);
  if (row >= nw) {
    if (tid == 0) dbias[row - nw] = total;
    return;
  }
  const int o = row / per_out;
  const float gsum = row_sum(nw + cout + o);
  if (tid < 32) {
    const float s = weight_sum(weight + o * per_out, per_out, tid);
    if (tid == 0) s_w = s;
  }
  __syncthreads();
  if (tid == 0) dweight[row] = total + -gsum / s_w;
}

// Blocks of the main kernel for a (B, H, W) plane stack.
long long n_tiles(int B, int H, int W) {
  return (long long)B * ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
}

template <int K, int CIN, int COUT>
cudaError_t launch(const float* data, const float* conf, const float* weight,
                   const float* bias, const float* out, const float* conf_out,
                   const float* go, const float* gc, float* ddata, float* dconf,
                   float* dweight, float* dbias, float* part, int B, int cin,
                   int cout, int H, int W, int vec, float eps, int device,
                   cudaStream_t s) {
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long blocks = n_tiles(B, H, W);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (blocks > 0) {
    static std::atomic<unsigned long long> raised{0};
    const unsigned long long bit = 1ull << (device & 63);
    if (!(raised.load() & bit)) {
      // The most any launch asks for: Cout and the weights at their limits.
      constexpr size_t plane = Geometry<K>::kPlane;
      const size_t most = (2 * kMaxCout * plane + 2 * (size_t)(CIN > 0 ? CIN : 1) * plane +
                           kMaxWeights + kMaxCout + kWarps * 64 + 2 * kMaxCout * kWarps) *
                          sizeof(float);
      const cudaError_t err = cudaFuncSetAttribute(
          nconv_bwd_kernel<K, CIN, COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)most);
      if (err != cudaSuccess) return err;
      raised.fetch_or(bit);
    }
    const size_t smem = smem_floats<K, CIN>(cin, cout) * sizeof(float);
    nconv_bwd_kernel<K, CIN, COUT><<<(unsigned)blocks, kThreads, smem, s>>>(
        data, conf, weight, bias, out, conf_out, go, gc, ddata, dconf, part, cin,
        cout, H, W, tiles_y, tiles_x, vec, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int per_out = cin * K * K;
  const int rows = cout * per_out + (dbias != nullptr ? cout : 0);
  nconv_bwd_finalize<<<rows, kFinalThreads, 0, s>>>(weight, part, dweight, dbias, cout,
                                                    per_out, (int)blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of the scratch nconv_bwd_f32 takes for these shapes: a partial sum
// per block for each weight element, each bias and each weight-sum term.
long long nconv_bwd_scratch_floats(int B, int Cin, int Cout, int H, int W, int k) {
  if (B < 0 || H < 0 || W < 0 || Cin < 1 || Cout < 1) return -1;
  return ((long long)Cout * Cin * k * k + 2LL * Cout) * n_tiles(B, H, W);
}

// data, conf, ddata, dconf: (B, Cin, H, W) f32; weight, dweight: (Cout,
// Cin, k, k) f32; bias, dbias: (Cout,) f32 or null (both or neither);
// out, conf_out, go, gc: (B, Cout, H, W) f32, go and gc null for a zero
// upstream gradient; part: nconv_bwd_scratch_floats(...) f32 scratch.
// Every output is written (nothing needs zeroing first); d w and d bias
// are summed in a fixed order. Returns the CUDA error of the launches.
int nconv_bwd_f32(const float* data, const float* conf, const float* weight,
                  const float* bias, const float* out, const float* conf_out,
                  const float* go, const float* gc, float* ddata, float* dconf,
                  float* dweight, float* dbias, float* part, int B, int Cin,
                  int Cout, int H, int W, int k, float eps, int device,
                  void* stream) {
  if (B < 0 || Cin < 1 || Cout < 1 || Cout > kMaxCout || H < 0 || W < 0 ||
      Cout * Cin * k * k > kMaxWeights || (bias == nullptr) != (dbias == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte loads and stores need aligned rows and planes.
  const auto aligned = [](const void* p) {
    return reinterpret_cast<size_t>(p) % 16 == 0;
  };
  const int vec = W % 4 == 0 && aligned(data) && aligned(conf) && aligned(out) &&
                  aligned(conf_out) && aligned(go) && aligned(gc) && aligned(ddata) &&
                  aligned(dconf);
#define NCONV_BWD_LAUNCH(KK, CI, CO)                                              \
  launch<KK, CI, CO>(data, conf, weight, bias, out, conf_out, go, gc, ddata,   \
                     dconf, dweight, dbias, part, B, Cin, Cout, H, W, vec, eps, \
                     device, s)
  if (k == 5 && Cin == 1 && Cout == 2) {
    err = NCONV_BWD_LAUNCH(5, 1, 2);
  } else if (k == 5 && Cin == 2 && Cout == 2) {
    err = NCONV_BWD_LAUNCH(5, 2, 2);
  } else if (k == 3 && Cin == 4 && Cout == 2) {
    err = NCONV_BWD_LAUNCH(3, 4, 2);
  } else if (k == 1 && Cin == 2 && Cout == 1) {
    err = NCONV_BWD_LAUNCH(1, 2, 1);
  } else {
    switch (k) {
      case 1: err = NCONV_BWD_LAUNCH(1, 0, 0); break;
      case 3: err = NCONV_BWD_LAUNCH(3, 0, 0); break;
      case 5: err = NCONV_BWD_LAUNCH(5, 0, 0); break;
      case 7: err = NCONV_BWD_LAUNCH(7, 0, 0); break;
      default: err = cudaErrorInvalidValue;
    }
  }
#undef NCONV_BWD_LAUNCH
  return (int)err;
}

}  // extern "C"

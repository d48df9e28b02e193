// K1 on Hopper: the composite space-to-depth ("s2d") conv of the
// multicarrier front end.
//
// Replaces tetraear_tpu/ops/pallas/s2d_conv.py:_kernel (launched by _run,
// entry point pallas_s2d_conv_wk).  It computes
//
//     out[c, w] = sum_{a < Lp} sum_{i < 2D} K2[c, i, a] * X2[w + a, i]
//
// where X2 is the (N, 2) re/im input, left-padded by pad_l samples and
// viewed as (W, 2D).  Flattened, X2[w', i] = s[w' * 2D + i] with s the
// interleaved float stream of x shifted right by 2 * pad_l floats and
// zero outside [2 * pad_l, 2 * pad_l + 2N): the padding is index masking
// here, the wrapper pads nothing.
//
// Bound.  At the main-path shape (16 carriers: C2 = 32, 2D = 20, Lp = 77,
// 831,994 outputs per row) the kernel does 2 * 32 * 1540 * 831,994 =
// 82 GFLOP against about 173 MB moved (67 MB of complex64 input, 106 MB
// of f32 output): ~470 FLOP per byte, far above the card's ratio of
// FLOP rate to memory bandwidth, so it is bound by arithmetic.
//
// Design.  What the design does about that bound is reuse: every input
// float is read from device memory once per block, kept in shared
// memory, and feeds 32 output rows x Lp taps of FMAs; each thread holds
// a 4-position x 8-row register tile, so one float4 pair of weights and
// four input floats from shared memory feed 32 FMAs.
//   * A block owns kTileW = 256 consecutive output positions and one
//     group of kRows = 32 output rows (grid.y walks the row groups, so
//     C2 = 192 works the same way as 32).
//   * Its input window, X2 rows [w0, w0 + 256 + Lp - 1), is one
//     contiguous stretch of s.  It is loaded once, coalesced, and stored
//     transposed ([i][position], odd row stride) so that a warp reads 32
//     consecutive positions without bank conflicts.
//   * Weights arrive in the tap-major (Lp, 2D, C2) layout the wrapper
//     makes; they are staged kTapsPerStage taps at a time (20 KB), rows
//     innermost, and read as float4 broadcasts.
//   * Each stage sums its 8 taps x 2D products into a fresh register
//     tile before adding it to the running sum, which keeps the f32
//     rounding of the 1540-term sums near that of a pairwise order.
// The bf16 variant rounds both operands to bf16 (round to nearest even)
// as it stages them and multiplies and accumulates in f32: bf16 operands
// with f32 accumulation, as the Pallas bf16 variant.  The FMAs run on
// the CUDA cores; bf16 tensor cores (mma / wgmma), TMA and a pipelined
// stage ring are the next steps.
//
// C interface (ctypes): tetra_s2d_conv launches on the given stream and
// returns cudaGetLastError() (0 on success); it allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 256;         // output positions per block
constexpr int kRows = 32;           // output rows per block
constexpr int kPosPerThread = 4;    // positions tm + 64 * j
constexpr int kRowsPerThread = 8;   // rows tn * 8 + r
constexpr int kPosThreads = kTileW / kPosPerThread;   // 64
constexpr int kTapsPerStage = 8;

static_assert(kPosThreads * (kRows / kRowsPerThread) == kThreads,
              "thread tile does not cover the block tile");

template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
s2d_conv_kernel(const float* __restrict__ xf, long long n_floats,
                const float* __restrict__ k_taps, float* __restrict__ out,
                int c2, int ich, int lp, long long pad_floats,
                long long m_out, int xs, int w_off) {
  extern __shared__ __align__(16) float smem[];
  float* x_sh = smem;           // [ich][xs]: x_sh[i * xs + m] = X2[w0 + m, i]
  float* w_sh = smem + w_off;   // [kTapsPerStage * ich][kRows]

  const int tid = threadIdx.x;
  const int tm = tid % kPosThreads;
  const int tn = tid / kPosThreads;
  const long long w0 = static_cast<long long>(blockIdx.x) * kTileW;
  const int row0 = blockIdx.y * kRows;

  // input window: the contiguous stream s[w0 * ich, (w0 + win) * ich)
  const int win = kTileW + lp - 1;
  const long long q0 = w0 * ich - pad_floats;
  for (int idx = tid; idx < win * ich; idx += kThreads) {
    const long long q = q0 + idx;
    float v = 0.f;
    if (q >= 0 && q < n_floats) v = operand<kBf16>(__ldg(xf + q));
    const int m = idx / ich;
    x_sh[(idx - m * ich) * xs + m] = v;
  }

  float acc[kPosPerThread][kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kPosPerThread; ++j)
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[j][r] = 0.f;

  for (int a0 = 0; a0 < lp; a0 += kTapsPerStage) {
    const int na = min(kTapsPerStage, lp - a0);
    __syncthreads();  // input staged; previous stage's weights consumed
    // w_sh[(t * ich + i) * kRows + r] = K2[row0 + r, i, a0 + t]
    const float* k_stage = k_taps + static_cast<long long>(a0) * ich * c2;
    for (int idx = tid; idx < na * ich * kRows; idx += kThreads) {
      const int r = idx % kRows;
      const int ti = idx / kRows;    // t * ich + i
      const int c = row0 + r;
      float v = 0.f;
      if (c < c2) v = operand<kBf16>(
          __ldg(k_stage + static_cast<long long>(ti) * c2 + c));
      w_sh[idx] = v;
    }
    __syncthreads();

    float part[kPosPerThread][kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kPosPerThread; ++j)
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) part[j][r] = 0.f;

    for (int t = 0; t < na; ++t) {
      const float* xcol = x_sh + tm + a0 + t;
      const float* wcol = w_sh + t * ich * kRows + tn * kRowsPerThread;
#pragma unroll 4
      for (int i = 0; i < ich; ++i) {
        const float4 wa = *reinterpret_cast<const float4*>(wcol + i * kRows);
        const float4 wb =
            *reinterpret_cast<const float4*>(wcol + i * kRows + 4);
        const float wv[kRowsPerThread] = {wa.x, wa.y, wa.z, wa.w,
                                          wb.x, wb.y, wb.z, wb.w};
        const float* xi = xcol + i * xs;
#pragma unroll
        for (int j = 0; j < kPosPerThread; ++j) {
          const float xv = xi[j * kPosThreads];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r)
            part[j][r] = fmaf(xv, wv[r], part[j][r]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPosPerThread; ++j)
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[j][r] += part[j][r];
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int c = row0 + tn * kRowsPerThread + r;
    if (c >= c2) continue;
    float* orow = out + static_cast<long long>(c) * m_out;
#pragma unroll
    for (int j = 0; j < kPosPerThread; ++j) {
      const long long w = w0 + tm + j * kPosThreads;
      if (w < m_out) orow[w] = acc[j][r];
    }
  }
}

template <bool kBf16>
cudaError_t launch(const float* xf, long long n_floats, const float* k_taps,
                   float* out, int c2, int ich, int lp, long long pad_floats,
                   long long m_out, cudaStream_t stream) {
  const int win = kTileW + lp - 1;
  const int xs = win | 1;                      // odd stride: fewer conflicts
  const int w_off = (ich * xs + 3) & ~3;       // float4-aligned weights
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(w_off) + kTapsPerStage * ich * kRows);
  cudaError_t err = cudaFuncSetAttribute(
      s2d_conv_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((m_out + kTileW - 1) / kTileW),
                  static_cast<unsigned>((c2 + kRows - 1) / kRows));
  s2d_conv_kernel<kBf16><<<grid, kThreads, smem, stream>>>(
      xf, n_floats, k_taps, out, c2, ich, lp, pad_floats, m_out, xs, w_off);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tetra_s2d_conv(const float* xf, long long n_floats,
                              const float* k_taps, float* out, int c2,
                              int ich, int lp, long long pad_floats,
                              long long m_out, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<true>(xf, n_floats, k_taps, out, c2, ich, lp, pad_floats,
                          m_out, s)
           : launch<false>(xf, n_floats, k_taps, out, c2, ich, lp, pad_floats,
                           m_out, s);
  return static_cast<int>(err);
}

extern "C" const char* tetra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

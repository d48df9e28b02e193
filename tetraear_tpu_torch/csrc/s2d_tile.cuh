// One output tile of the composite space-to-depth ("s2d") conv, shared by
// K1 / K1-of (s2d_conv.cu) and K3 (s2d_conv_db.cu).
//
//     out[c, w] = sum_{a < Lp} sum_{i < ich} K[c, i, a] * X[w + a, i]
//
// X is the interleaved float stream s of the input viewed as (W, ich):
// X[w', i] = s[w' * ich + i], s shifted right by pad_floats and zero
// outside [pad_floats, pad_floats + n_floats).  A block computes one tile
// of kTileW consecutive positions x kRows rows; each thread holds a
// 4-position x 8-row register tile, so one float4 pair of weights and
// four input floats from shared memory feed 32 FMAs.
//
// The input window of a tile, X rows [w0, w0 + kTileW + Lp - 1), sits in
// shared memory transposed ([i][position], odd row stride xs) so that a
// warp reads 32 consecutive positions without bank conflicts.  Weights
// arrive in the tap-major (Lp, ich, C2) layout the wrapper makes and are
// staged `tps` taps at a time, rows innermost, read as float4
// broadcasts.  Each stage sums its tps x ich products into a fresh
// register tile before adding it to the running sum, which keeps the
// rounding of the long f32 sums near that of a pairwise order.  The
// order of every output's sum is fixed by (ich, Lp) alone, so two
// kernels that call conv_tile on the same window agree bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace s2d {

constexpr int kThreads = 256;
constexpr int kTileW = 256;         // output positions per tile
constexpr int kRows = 32;           // output rows per block
constexpr int kPosPerThread = 4;    // positions tm + 64 * j
constexpr int kRowsPerThread = 8;   // rows tn * 8 + r
constexpr int kPosThreads = kTileW / kPosPerThread;   // 64
constexpr int kMaxTapsPerStage = 8;
// window + one weight stage of K1 stay under this, so that two blocks
// share an SM where the shapes allow it
constexpr long kStageBudgetBytes = 110 * 1024;

static_assert(kPosThreads * (kRows / kRowsPerThread) == kThreads,
              "thread tile does not cover the block tile");

using Acc = float[kPosPerThread][kRowsPerThread];

// Taps per weight stage: 8 for every un-folded shape (ich = 2D = 20),
// fewer where the folded input's window leaves less room (K1-of at
// fold 4: 2; fold 5 and 6: 1).  A function of (ich, Lp) only.
__host__ __device__ inline int taps_per_stage(int ich, int lp) {
  const long x_bytes = 4L * ich * ((kTileW + lp - 1) | 1);
  const long t = (kStageBudgetBytes - x_bytes) / (4L * ich * kRows);
  return t < 1 ? 1 : (t > kMaxTapsPerStage ? kMaxTapsPerStage : (int)t);
}

// The tile's window straight from device memory, transposed as it is
// stored: x_sh[i * xs + m] = s[q0 + m * ich + i] (0 outside the input).
__device__ __forceinline__ void load_window(const float* __restrict__ xf,
                                            long long n_floats, long long q0,
                                            int win, int ich, int xs,
                                            float* x_sh) {
  for (int idx = threadIdx.x; idx < win * ich; idx += kThreads) {
    const long long q = q0 + idx;
    float v = 0.f;
    if (q >= 0 && q < n_floats) v = __ldg(xf + q);
    const int m = idx / ich;
    x_sh[(idx - m * ich) * xs + m] = v;
  }
}

// acc[j][r] = out[row0 + tn * 8 + r, w0 + tm + 64 j] for the window in
// x_sh.  Starts with a barrier, so the window may be written just before.
__device__ __forceinline__ void conv_tile(const float* x_sh, float* w_sh,
                                          const float* __restrict__ k_taps,
                                          int c2, int ich, int lp, int xs,
                                          int tps, int row0, Acc& acc) {
  const int tid = threadIdx.x;
  const int tm = tid % kPosThreads;
  const int tn = tid / kPosThreads;
#pragma unroll
  for (int j = 0; j < kPosPerThread; ++j)
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[j][r] = 0.f;

  for (int a0 = 0; a0 < lp; a0 += tps) {
    const int na = min(tps, lp - a0);
    __syncthreads();  // window staged; previous stage's weights consumed
    // w_sh[(t * ich + i) * kRows + r] = K[row0 + r, i, a0 + t]
    const float* k_stage = k_taps + static_cast<long long>(a0) * ich * c2;
    for (int idx = tid; idx < na * ich * kRows; idx += kThreads) {
      const int r = idx % kRows;
      const int ti = idx / kRows;    // t * ich + i
      const int c = row0 + r;
      float v = 0.f;
      if (c < c2) v = __ldg(k_stage + static_cast<long long>(ti) * c2 + c);
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
}

// Stores the tile whose first position is w0.  With fold F, kernel row
// cf = c * F + f at folded position w holds out[c, w * F + f] (K1-of):
// the un-fold happens here, in the store.  fold = 1 is the plain layout.
__device__ __forceinline__ void store_tile(const Acc& acc, float* out, int c2,
                                           long long w0, int row0, int fold,
                                           long long m_out) {
  const int tm = threadIdx.x % kPosThreads;
  const int tn = threadIdx.x / kPosThreads;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int cf = row0 + tn * kRowsPerThread + r;
    if (cf >= c2) continue;
    const int c = cf / fold;
    const int f = cf - c * fold;
    float* orow = out + static_cast<long long>(c) * m_out;
#pragma unroll
    for (int j = 0; j < kPosPerThread; ++j) {
      const long long w = (w0 + tm + j * kPosThreads) * fold + f;
      if (w < m_out) orow[w] = acc[j][r];
    }
  }
}

}  // namespace s2d

extern "C" const char* tetra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K4 on Hopper, f32 operands: the composite space-to-depth ("s2d") conv
// in the reference's direct-tap form.
//
// Replaces tetraear_tpu/ops/pallas/s2d_conv.py:_kernel_direct (entry
// point pallas_s2d_conv_dt_wk, variant "dt" of pallas_s2d_conv; the
// "dt_bf16" variant runs on the tensor cores in s2d_conv_tc.cu, whose
// implicit GEMM sums in this same tap-major order).  Same contraction as
// K1:
//
//     out[c, w] = sum_{a < Lp} sum_{i < 2D} K2[c, i, a] * X2[w + a, i]
//
// with the per-tap weights wkd[a] = K2[:, :, a] of the reference read
// straight from device memory, tap after tap, into one running f32 sum
// per output: no per-stage fresh register tile as in K1 (s2d_tile.cuh),
// and no weight staging in shared memory.  On the TPU the direct form
// traded 128-lane contraction for no patch copies; here K1 reads its
// window in place as well, so K4 differs from K1 in where the weights
// come from (L1, as warp-wide broadcasts of the tap-major layout the
// wrapper makes) and in the order of its sums.
//
// Bound.  At the 16-carrier main-path shape (C2 = 32, 2D = 20, Lp = 77,
// 831,994 outputs per row) it does K1's 82 GFLOP of FMAs on the CUDA
// cores against ~173 MB of traffic: bound by arithmetic, as K1.  Its
// block holds only the window (~27 KB), so more blocks share an SM than
// K1's window + weight stage allow; each FMA group of 32 needs two
// 16-byte weight loads from L1 instead of shared memory.
//
// The window of a tile, 2D x (256 + Lp - 1) floats, must fit one block's
// shared memory; the wrapper refuses an input-channel count that does
// not (ops/kernels/s2d_conv.py:check_dt).
//
// C interface (ctypes): tetra_s2d_conv_dt launches on the given stream
// and returns cudaGetLastError() (0 on success); it allocates nothing.

#include "s2d_tile.cuh"

namespace {

using namespace s2d;

__global__ void __launch_bounds__(kThreads)
s2d_conv_dt_kernel(const float* __restrict__ xf, long long n_floats,
                   const float* __restrict__ k_taps, float* __restrict__ out,
                   int c2, int c2p, int ich, int lp, long long pad_floats,
                   long long m_out, int xs) {
  extern __shared__ __align__(16) float x_sh[];   // [ich][xs]
  const long long w0 = static_cast<long long>(blockIdx.x) * kTileW;
  const int row0 = blockIdx.y * kRows;
  load_window(xf, n_floats, w0 * ich - pad_floats, kTileW + lp - 1, ich, xs,
              x_sh);
  __syncthreads();

  const int tm = threadIdx.x % kPosThreads;
  const int tn = threadIdx.x / kPosThreads;
  Acc acc;
#pragma unroll
  for (int j = 0; j < kPosPerThread; ++j)
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[j][r] = 0.f;

  // k_taps[(a * ich + i) * c2p + c] = K2[c, i, a], rows zero-padded to c2p
  const float* w_rows = k_taps + row0 + tn * kRowsPerThread;
  for (int a = 0; a < lp; ++a) {
    const float* xcol = x_sh + tm + a;
    const float* w_tap = w_rows + static_cast<long long>(a) * ich * c2p;
#pragma unroll 4
    for (int i = 0; i < ich; ++i) {
      const float4 wa = __ldg(reinterpret_cast<const float4*>(w_tap + i * c2p));
      const float4 wb =
          __ldg(reinterpret_cast<const float4*>(w_tap + i * c2p + 4));
      const float wv[kRowsPerThread] = {wa.x, wa.y, wa.z, wa.w,
                                        wb.x, wb.y, wb.z, wb.w};
      const float* xi = xcol + i * xs;
#pragma unroll
      for (int j = 0; j < kPosPerThread; ++j) {
        const float xv = xi[j * kPosThreads];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          acc[j][r] = fmaf(xv, wv[r], acc[j][r]);
      }
    }
  }
  store_tile(acc, out, c2, w0, row0, 1, m_out);
}

}  // namespace

// k_taps: (Lp, ich, c2p) f32, c2p = c2 rounded up to a multiple of 32;
// m_out = ceil(N / D).
extern "C" int tetra_s2d_conv_dt(const float* xf, long long n_floats,
                                 const float* k_taps, float* out, int c2,
                                 int ich, int lp, long long pad_floats,
                                 long long m_out, int c2p, void* stream) {
  const int xs = (kTileW + lp - 1) | 1;        // odd stride: fewer conflicts
  const size_t smem = sizeof(float) * static_cast<size_t>(ich) * xs;
  cudaError_t err = cudaFuncSetAttribute(
      s2d_conv_dt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((m_out + kTileW - 1) / kTileW),
                  static_cast<unsigned>((c2 + kRows - 1) / kRows));
  s2d_conv_dt_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      xf, n_floats, k_taps, out, c2, c2p, ich, lp, pad_floats, m_out, xs);
  return static_cast<int>(cudaGetLastError());
}

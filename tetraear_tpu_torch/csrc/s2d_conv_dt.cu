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
// summed as the reference sums it: one running f32 sum per output, in
// tap-major order k = a * 2D + i (K1 instead adds each weight stage's
// partial sum to its total, s2d_tile.cuh:conv_tile).
//
// Bound.  At the 16-carrier main-path shape (C2 = 32, 2D = 20, Lp = 77,
// 831,994 outputs per row) it does K1's 82 GFLOP of FMAs on the CUDA
// cores against ~173 MB of traffic: bound by arithmetic, as K1.  What
// keeps the FMA pipes fed is where the operands of each group of 32 FMAs
// come from.  The first form of this kernel read the weights of every
// (tap, channel) row from L1 (two 16-byte __ldg per 32 FMAs) and ran 14 %
// behind K1 (NVIDIA H100 80GB HBM3 at 700 W, PERF.md).  Here the weights go through shared memory as K1's do, but
// streamed: the tap-major rows k of the block's 32 output rows arrive in
// stages of up to 8 taps by 16-byte cp.async copies into two buffers, so
// stage s + 1 is in flight while the FMAs of stage s run, and a thread
// reads them as float4 broadcasts beside its window column.  Each thread
// keeps K1's 4-position x 8-row register tile (s2d_tile.cuh), one sum per
// output and no per-stage partial tile, so the block fits in fewer
// registers and, with ~67 KB of shared memory at 2D = 20, three blocks
// share an SM.
//
// A stage is a run of whole k rows, not whole taps, so that wide inputs
// whose window leaves room for less than a tap still run; the window of
// a tile, 2D x (256 + Lp - 1) floats, and two stages of one k row must
// fit one block's shared memory (ops/kernels/s2d_conv.py:check_dt).
//
// C interface (ctypes): tetra_s2d_conv_dt launches on the given stream
// and returns cudaGetLastError() (0 on success); it allocates nothing.

#include "s2d_tile.cuh"

namespace {

using namespace s2d;

constexpr long kMaxSmemBytes = 232448;   // dynamic shared memory of a block
constexpr int kChunksPerRow = kRows / 4; // 16-byte copies per k row

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts the copy of k rows [k0, k0 + nk) of the block's row group:
// dst[(k - k0) * kRows + r] = k_taps[k * c2p + row0 + r].
__device__ __forceinline__ void fetch_stage(const float* __restrict__ k_taps,
                                            int c2p, int row0, int k0,
                                            int nk, float* dst) {
  for (int q = threadIdx.x; q < nk * kChunksPerRow; q += kThreads) {
    const int kk = q / kChunksPerRow;
    const int c = (q - kk * kChunksPerRow) * 4;
    cp_async16(dst + kk * kRows + c,
               k_taps + static_cast<long long>(k0 + kk) * c2p + row0 + c);
  }
}

__global__ void __launch_bounds__(kThreads)
s2d_conv_dt_kernel(const float* __restrict__ xf, long long n_floats,
                   const float* __restrict__ k_taps, float* __restrict__ out,
                   int c2, int c2p, int ich, int lp, long long pad_floats,
                   long long m_out, int xs, int w_off, int stage_k) {
  extern __shared__ __align__(16) float smem[];
  float* x_sh = smem;                        // [ich][xs]
  float* w_sh = smem + w_off;                // two buffers of stage_k rows
  const long long w0 = static_cast<long long>(blockIdx.x) * kTileW;
  const int row0 = blockIdx.y * kRows;
  const int kdim = lp * ich;
  const int stages = (kdim + stage_k - 1) / stage_k;

  fetch_stage(k_taps, c2p, row0, 0, min(stage_k, kdim), w_sh);
  cp_async_commit();
  load_window(xf, n_floats, w0 * ich - pad_floats, kTileW + lp - 1, ich, xs,
              x_sh);

  const int tm = threadIdx.x % kPosThreads;
  const int tn = threadIdx.x / kPosThreads;
  Acc acc;
#pragma unroll
  for (int j = 0; j < kPosPerThread; ++j)
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[j][r] = 0.f;

  for (int s = 0; s < stages; ++s) {
    const int k0 = s * stage_k;
    const int k1 = min(k0 + stage_k, kdim);
    if (s + 1 < stages)   // into the buffer stage s - 1 used
      fetch_stage(k_taps, c2p, row0, k1, min(stage_k, kdim - k1),
                  w_sh + ((s + 1) & 1) * stage_k * kRows);
    cp_async_commit();                 // possibly empty: one group a stage
    cp_async_wait_all_but_newest();    // this thread's copies of stage s
    __syncthreads();                   // everyone's, and the window
    const float* w_buf = w_sh + (s & 1) * stage_k * kRows
                         + tn * kRowsPerThread;
    for (int a = k0 / ich; a * ich < k1; ++a) {
      const int i_lo = max(k0 - a * ich, 0);
      const int i_hi = min(ich, k1 - a * ich);
      const float* xcol = x_sh + tm + a;
      const float* wrow = w_buf + (a * ich + i_lo - k0) * kRows;
#pragma unroll 4
      for (int i = i_lo; i < i_hi; ++i) {
        const float* wk = wrow + (i - i_lo) * kRows;
        const float4 wa = *reinterpret_cast<const float4*>(wk);
        const float4 wb = *reinterpret_cast<const float4*>(wk + 4);
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
    __syncthreads();   // stage s consumed before stage s + 2 lands on it
  }
  store_tile(acc, out, c2, w0, row0, 1, m_out);
}

}  // namespace

// k_taps: (Lp, ich, c2p) f32, 16-byte aligned, c2p = c2 rounded up to a
// multiple of 32; m_out = ceil(N / D).
extern "C" int tetra_s2d_conv_dt(const float* xf, long long n_floats,
                                 const float* k_taps, float* out, int c2,
                                 int ich, int lp, long long pad_floats,
                                 long long m_out, int c2p, void* stream) {
  const int xs = (kTileW + lp - 1) | 1;        // odd stride: fewer conflicts
  const int w_off = (ich * xs + 3) & ~3;       // 16-byte aligned buffers
  const long free_floats = kMaxSmemBytes / 4 - w_off;
  const long fit = free_floats / (2L * kRows);
  const long most = static_cast<long>(kMaxTapsPerStage) * ich;
  const int stage_k = static_cast<int>(fit < most ? fit : most);
  if (stage_k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(w_off) + 2L * stage_k * kRows);
  cudaError_t err = cudaFuncSetAttribute(
      s2d_conv_dt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((m_out + kTileW - 1) / kTileW),
                  static_cast<unsigned>((c2 + kRows - 1) / kRows));
  s2d_conv_dt_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      xf, n_floats, k_taps, out, c2, c2p, ich, lp, pad_floats, m_out, xs,
      w_off, stage_k);
  return static_cast<int>(cudaGetLastError());
}

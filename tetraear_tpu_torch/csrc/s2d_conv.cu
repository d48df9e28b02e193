// K1 and K1-of on Hopper: the composite space-to-depth ("s2d") conv of
// the multicarrier front end, un-folded and output-folded.
//
// K1 replaces tetraear_tpu/ops/pallas/s2d_conv.py:_kernel as launched by
// _run (entry point pallas_s2d_conv_wk).  It computes
//
//     out[c, w] = sum_{a < Lp} sum_{i < 2D} K2[c, i, a] * X2[w + a, i]
//
// where X2 is the (N, 2) re/im input, left-padded by pad_l samples and
// viewed as (W, 2D).  Flattened, X2[w', i] = s[w' * 2D + i] with s the
// interleaved float stream of x shifted right by 2 * pad_l floats and
// zero outside [2 * pad_l, 2 * pad_l + 2N): the padding is index masking
// here, the wrapper pads nothing.
//
// K1-of replaces the same _kernel as launched by pallas_s2d_conv_of_wk
// (weights of_group_weights).  With fold F, F consecutive outputs become
// C2 * F kernel rows over the regrouped input X2f[w', f * 2D + i] =
// X2[w' * F + f, i]: 2D * F channels, ceil((Lp + F - 1) / F) taps.  X2f
// is the same stream s viewed as (W / F, 2D * F), so K1-of is K1 run
// with ich = 2D * F, and its store writes kernel row c * F + f at folded
// position w' to out[c, w' * F + f]: the un-folded (C2, ceil(N/D)) result
// with no separate un-fold pass (s2d_tile.cuh:store_tile).  On the TPU
// the fold filled 128 MXU output lanes; here it changes only the shapes
// (4 % more FMAs at F = 4 for the zero taps), and the weight stage
// shrinks with the fold so the window still fits (taps_per_stage).
//
// Bound.  At the main-path shape (16 carriers: C2 = 32, 2D = 20, Lp = 77,
// 831,994 outputs per row) the kernel does 2 * 32 * 1540 * 831,994 =
// 82 GFLOP against about 173 MB moved (67 MB of complex64 input, 106 MB
// of f32 output): ~470 FLOP per byte, far above the card's ratio of
// FLOP rate to memory bandwidth, so it is bound by arithmetic.  The
// design (s2d_tile.cuh) is reuse: every input float is read from device
// memory once per block, kept in shared memory, and feeds 32 output rows
// x Lp taps of FMAs.  A block owns one tile of 256 positions and one
// group of 32 rows (grid.y walks the row groups, so the PFB's C2 = 192
// and K1-of's C2 * F rows run the same way as 32).
//
// The bf16 variant rounds both operands to bf16 (round to nearest even)
// as it stages them and multiplies and accumulates in f32: bf16 operands
// with f32 accumulation, as the Pallas bf16 variant.  The FMAs run on
// the CUDA cores; bf16 tensor cores (mma / wgmma), TMA and a pipelined
// stage ring are the next steps.
//
// C interface (ctypes): tetra_s2d_conv launches on the given stream and
// returns cudaGetLastError() (0 on success); it allocates nothing.

#include "s2d_tile.cuh"

namespace {

using namespace s2d;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
s2d_conv_kernel(const float* __restrict__ xf, long long n_floats,
                const float* __restrict__ k_taps, float* __restrict__ out,
                int c2, int ich, int lp, long long pad_floats,
                long long m_out, int fold, int xs, int w_off, int tps) {
  extern __shared__ __align__(16) float smem[];
  float* x_sh = smem;           // [ich][xs]: x_sh[i * xs + m] = X[w0 + m, i]
  float* w_sh = smem + w_off;   // [tps * ich][kRows]
  const long long w0 = static_cast<long long>(blockIdx.x) * kTileW;
  const int row0 = blockIdx.y * kRows;
  load_window<kBf16>(xf, n_floats, w0 * ich - pad_floats, kTileW + lp - 1,
                     ich, xs, x_sh);
  Acc acc;
  conv_tile<kBf16>(x_sh, w_sh, k_taps, c2, ich, lp, xs, tps, row0, acc);
  store_tile(acc, out, c2, w0, row0, fold, m_out);
}

template <bool kBf16>
cudaError_t launch(const float* xf, long long n_floats, const float* k_taps,
                   float* out, int c2, int ich, int lp, long long pad_floats,
                   long long m_out, int fold, cudaStream_t stream) {
  const int win = kTileW + lp - 1;
  const int xs = win | 1;                      // odd stride: fewer conflicts
  const int w_off = (ich * xs + 3) & ~3;       // float4-aligned weights
  const int tps = taps_per_stage(ich, lp);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(w_off) + tps * ich * kRows);
  cudaError_t err = cudaFuncSetAttribute(
      s2d_conv_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long m_pos = (m_out + fold - 1) / fold;   // folded positions
  const dim3 grid(static_cast<unsigned>((m_pos + kTileW - 1) / kTileW),
                  static_cast<unsigned>((c2 + kRows - 1) / kRows));
  s2d_conv_kernel<kBf16><<<grid, kThreads, smem, stream>>>(
      xf, n_floats, k_taps, out, c2, ich, lp, pad_floats, m_out, fold, xs,
      w_off, tps);
  return cudaGetLastError();
}

}  // namespace

// c2, ich, lp: the kernel's rows, channels and taps as launched (C2 * F,
// 2D * F, ceil((Lp + F - 1) / F) for K1-of); m_out: the un-folded output
// count per row, ceil(N / D).
extern "C" int tetra_s2d_conv(const float* xf, long long n_floats,
                              const float* k_taps, float* out, int c2,
                              int ich, int lp, long long pad_floats,
                              long long m_out, int fold, int bf16,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<true>(xf, n_floats, k_taps, out, c2, ich, lp, pad_floats,
                          m_out, fold, s)
           : launch<false>(xf, n_floats, k_taps, out, c2, ich, lp,
                           pad_floats, m_out, fold, s);
  return static_cast<int>(err);
}

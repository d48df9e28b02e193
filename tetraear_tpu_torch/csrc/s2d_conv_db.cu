// K3 on Hopper: K1's contraction with the next tile's input prefetched
// asynchronously while the current tile is computed.
//
// Replaces tetraear_tpu/ops/pallas/s2d_conv.py:_kernel_db (launched by
// _run_db, variant "db", the frontends' pallas_db).  On the TPU the
// kernel received its window as two pipeline-managed blocks (tiles i and
// i + 1 of one array), so Mosaic's grid pipelining overlapped the next
// tile's DMA with this tile's matmuls.  Here a block walks
// `tiles_per_block` consecutive output tiles of 256 positions (the grid
// is sized to the card's resident blocks):
//   * while it computes tile t from the transposed window x_sh, the
//     raw interleaved window of tile t + 1 streams into the other of two
//     shared buffers with 16-byte cp.async copies (no registers, no
//     stall on device memory);
//   * when a tile's copy has landed, one pass transposes it into x_sh,
//     the layout K1 computes on ([i][position], odd stride: a warp
//     reads 32 consecutive positions without bank conflicts).  cp.async
//     copies contiguous bytes and cannot transpose; the pass costs
//     ~6,700 shared-memory moves per tile against 12.6 M FMAs
//     (256 positions x 32 rows x 1540 products).
// The tile is then computed by K1's own conv_tile (s2d_tile.cuh) with
// K1's taps per stage, so every output is summed in K1's order: the f32
// result is bit-identical to K1's, as the reference pins db == dma.
//
// Alignment.  A window starts at stream float w0 * 2D - 2 * pad_l, which
// need not be a multiple of 4 (the PFB kernel's pad_l = 767 gives 1534 =
// 2 mod 4), and the input may start at any float.  The copy therefore
// starts at the 16-byte boundary at or below the window and the
// transpose reads from `shift` floats in; 16-byte chunks that reach
// outside the input (the left zero pad, the ragged end) are filled
// element by element with zeros where there is no input.
//
// Bound: arithmetic, as K1 (s2d_conv.cu).  f32 only, like _run_db.
//
// C interface (ctypes): tetra_s2d_conv_db launches on the given stream
// and returns cudaGetLastError() (0 on success); it allocates nothing.

#include <cstdint>

#include "s2d_tile.cuh"

namespace {

using namespace s2d;

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

// Floats between the window's first float q0 and the 16-byte boundary
// at or below it; mis = the input's start in floats, mod 4.
__device__ __forceinline__ int window_shift(long long q0, int mis) {
  return static_cast<int>(((q0 + mis) % 4 + 4) % 4);
}

// Starts the copy of stream floats [q0 - shift, ...) covering the whole
// window into raw; chunks that reach outside the input are written
// directly (zeros where there is no input).
__device__ __forceinline__ void fetch_window(const float* __restrict__ xf,
                                             long long n_floats, long long q0,
                                             int mis, int count, float* raw) {
  const long long qa = q0 - window_shift(q0, mis);
  const int chunks = (static_cast<int>(q0 - qa) + count + 3) / 4;
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    const long long q = qa + 4LL * k;
    if (q >= 0 && q + 4 <= n_floats) {
      cp_async16(raw + 4 * k, xf + q);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long qe = q + e;
        raw[4 * k + e] = (qe >= 0 && qe < n_floats) ? __ldg(xf + qe) : 0.f;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
s2d_conv_db_kernel(const float* __restrict__ xf, long long n_floats,
                   const float* __restrict__ k_taps, float* __restrict__ out,
                   int c2, int ich, int lp, long long pad_floats,
                   long long m_out, int num_tiles, int tiles_per_block,
                   int mis, int xs, int raw_off, int raw_cap, int w_off,
                   int tps) {
  extern __shared__ __align__(16) float smem[];
  float* x_sh = smem;                       // [ich][xs], as K1
  float* raw0 = smem + raw_off;             // two raw windows of raw_cap
  float* w_sh = smem + w_off;               // [tps * ich][kRows]
  const int row0 = blockIdx.y * kRows;
  const int win = kTileW + lp - 1;
  const int count = win * ich;
  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(num_tiles, t_begin + tiles_per_block);
  auto q_of = [&](int t) {
    return static_cast<long long>(t) * kTileW * ich - pad_floats;
  };

  fetch_window(xf, n_floats, q_of(t_begin), mis, count, raw0);
  cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    float* raw = raw0 + ((t - t_begin) & 1) * raw_cap;
    float* raw_next = raw0 + (((t - t_begin) & 1) ^ 1) * raw_cap;
    // the next window's buffer was last read by tile t - 1's transpose,
    // which every thread finished before conv_tile's first barrier
    if (t + 1 < t_end)
      fetch_window(xf, n_floats, q_of(t + 1), mis, count, raw_next);
    cp_async_commit();                 // possibly empty: one group per tile
    cp_async_wait_all_but_newest();    // this thread's copies of tile t
    __syncthreads();                   // everyone's; x_sh free again
    const float* src = raw + window_shift(q_of(t), mis);
    for (int idx = threadIdx.x; idx < count; idx += kThreads) {
      const int m = idx / ich;
      x_sh[(idx - m * ich) * xs + m] = src[idx];
    }
    Acc acc;
    conv_tile(x_sh, w_sh, k_taps, c2, ich, lp, xs, tps, row0, acc);
    store_tile(acc, out, c2, static_cast<long long>(t) * kTileW, row0, 1,
               m_out);
  }
}

}  // namespace

extern "C" int tetra_s2d_conv_db(const float* xf, long long n_floats,
                                 const float* k_taps, float* out, int c2,
                                 int ich, int lp, long long pad_floats,
                                 long long m_out, void* stream) {
  const int win = kTileW + lp - 1;
  const int xs = win | 1;
  const int raw_off = (ich * xs + 3) & ~3;
  const int raw_cap = (win * ich + 3 + 3) & ~3;   // window + shift <= 3
  const int w_off = raw_off + 2 * raw_cap;
  const int tps = taps_per_stage(ich, lp);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(w_off) + tps * ich * kRows);
  cudaError_t err = cudaFuncSetAttribute(
      s2d_conv_db_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, s2d_conv_db_kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  // one wave of resident blocks, each walking consecutive tiles
  const long long num_tiles = (m_out + kTileW - 1) / kTileW;
  const long long groups = (c2 + kRows - 1) / kRows;
  const long long slots = static_cast<long long>(sms) * per_sm;
  const long long per_block =
      (num_tiles * groups + slots - 1) / slots;
  const int tiles_per_block = static_cast<int>(per_block < 1 ? 1 : per_block);
  const int mis = static_cast<int>(
      (reinterpret_cast<std::uintptr_t>(xf) / sizeof(float)) % 4);
  const dim3 grid(
      static_cast<unsigned>((num_tiles + tiles_per_block - 1) /
                            tiles_per_block),
      static_cast<unsigned>(groups));
  s2d_conv_db_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      xf, n_floats, k_taps, out, c2, ich, lp, pad_floats, m_out,
      static_cast<int>(num_tiles), tiles_per_block, mis, xs, raw_off,
      raw_cap, w_off, tps);
  return static_cast<int>(cudaGetLastError());
}

// K1 and K1-of with bf16 operands on Hopper's tensor cores (wgmma).
//
// Replaces tetraear_tpu/ops/pallas/s2d_conv.py:_kernel for the "bf16" and
// "of<N>_bf16" variants, as launched by _run (:224, entry point
// pallas_s2d_conv_wk) and by pallas_s2d_conv_of_wk (:371).  It computes
//
//     out[c, w] = sum_{a < Lp, i < ich} bf16(K[c, i, a]) * bf16(X[w + a, i])
//
// with f32 products and f32 accumulation, over the folded input
// X_F[w', f * 2D + i] = X[w' * F + f, i] with C2 * F kernel rows (K1-of;
// the un-fold is in the store, as store_tile in s2d_tile.cuh).  K1's own
// bf16 launch of up to 32 rows runs its weights' fold of 4 (the wrapper's
// tc_k1_fold; faster on the H100 than folds 2 and 1), the full band's 192
// rows unfolded.
//
// An implicit GEMM with no im2col.  X[w', i] = s[w' * ich + i], with s the
// interleaved float stream of the input shifted right by pad_floats and
// zero outside it, so with k = a * ich + i the contraction is
//
//     out[c, w] = sum_{k < K} A[w, k] * B[k, c],   A[w, k] = s[w * ich + k]
//
// M = positions, N = kernel rows, K = ich * Lp (1600 at fold 4), padded
// with zero weights to an even number of 16-wide k-steps.  Row w of A is
// one contiguous run of the stream: A is a strided (Hankel) view of one
// bf16 copy of the tile's window, so no patch matrix is built.  The f32
// input is rounded to bf16 (round to nearest even, as operand<true> and
// torch's .to(bfloat16)) once, as it enters shared memory.
//
// The MMA is wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate) with A
// from registers and B from shared memory; N = 64 kernel rows a block
// where the weights fit (at 2.4 MS/s every shape but folds 5 and 6, which
// take 32).  A Hankel view cannot be a wgmma shared-memory operand (a
// core matrix's rows sit 16 bytes apart), which is why A comes from
// registers.  B is the weights: the wrapper packs them once (a frontend
// at construction) into wgmma's no-swizzle core-matrix layout
// (ops/kernels/s2d_conv.py:tc_pack: per k-step [k half 2][row octet
// N/8][row 8][k 8] bf16), and a block copies its group of N rows, ksteps
// x 2N x 16 bytes (200 KB at fold 4), into shared memory once.  More rows
// go to more row groups (grid.y).  Where a row group's weights do not fit
// beside the window (2D * Lp above ~3400, as 2D = 66 at 8 MS/s), they
// stream through shared memory in chunks of kchunk k-steps, every tile.
//
// Bound and pace.  At the main-path shape (C2 = 32, 2D = 20, Lp = 77,
// 831,994 outputs per row) K1 is 2 * 32 * 1540 * 831,994 = 82.0 GFLOP,
// 0.083 ms at 989 TFLOP/s dense bf16, against 173 MB moved, 0.052 ms at
// 3.35 TB/s: bound by operations.  Full band (C2 = 192): 492 GFLOP,
// 0.50 ms.  K1-of at fold 4: 2 * 128 * 1600 * 207,999 = 85.2 GFLOP,
// 0.086 ms.  What sets the pace is the A fragments' shared-memory loads:
// every product of 64 positions x 16 k reloads 2 KB of A, so N = 64 halves
// their bytes per FLOP against N = 32.  Three things cut their cost:
//   * the packing permutes each k-step's 16 columns (TC_KPERM) so that a
//     thread's four A values of a row, MMA columns 2t, 2t + 1, 2t + 8,
//     2t + 9, sit on stream offsets 4t .. 4t + 3: one 8-byte load per row
//     instead of two 4-byte ones (where ich is a multiple of 4, so a
//     row starts on 8 bytes; 2D = 2 mod 4, an odd D, keeps two);
//   * MMA row g maps to position row_step * g (+ 1 for rows g + 8; step 4
//     interleaves two m16 slabs over 32 positions), with the step the
//     wrapper's tc_row_step picks so that each half warp's 8-byte loads
//     hit 32 distinct banks (W = ich / 2 words a position: row_step * W
//     an odd multiple of 8);
//   * two k-steps of fragments in flight: k-step k's group reads
//     a[k & 1], which is loaded again only after a wgmma.wait_group 1
//     has retired the group.  The loop has no branch between the loads and
//     the wgmmas, so ptxas keeps them asynchronous (a guarded tail made it
//     serialize every wgmma; hence the even k-steps).
//
// Persistent grid: one block per SM in all, each row group walking its
// share of position tiles (256 positions where a position is at most 20
// channels, else 128).  While a tile's wgmmas run, the next tile's f32
// window is already in flight into registers (8-byte loads, zero outside
// the input, so the left pad, the ragged end and inputs that start off
// the 16-byte grid need no special case: every window starts on an even
// float); after the tile it is rounded into the bf16 window.  A window
// larger than the prefetch registers (2D = 166 at 20 MS/s) is loaded
// after the tile instead.
//
// The store writes each accumulator straight from its fragment through a
// per-block table of each column's output row and fold phase; a store
// instruction covers 8 positions of a row within 32 (a whole 32-byte
// sector at row step 1, fold 1), and L2 merges the partial sectors of
// neighbouring instructions before device memory sees them.  The stores
// retire under the next tile's wgmmas.  Staging the tile through the
// window buffer (idle between the last wgmma and the next put) for
// 16-byte row stores was built and measured on the H100: 0.33 against
// 0.25 ms at C2 = 32 and 1.73 against 1.35 ms at the full band, as its
// barriers hold every warp of the SM's one block (PERF.md, section 6).
//
// C interface (ctypes): tetra_s2d_conv_tc launches on the given stream
// and returns the CUDA error (0 on success); it allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <int N>
struct Wgmma;

// wgmma.mma_async m64nNk16, bf16 A from registers, B by descriptor, f32
// accumulators d (N / 2 per thread), d += A * B
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous wgmmas
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x
// 16 bytes; lbo = bytes between core matrices along K, sbo = along N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__host__ __device__ inline int window_words(int tile_m, int ich,
                                            int ksteps) {
  // positions [0, tile_m) x k < 16 * ksteps, rounded to 16 bytes
  return (tile_m * (ich / 2) + 8 * ksteps + 3) & ~3;
}

// N kernel rows per block, MT m64 tiles per warpgroup, WG warpgroups:
// 64 * MT * WG positions a tile; PF float2 of the next window per thread;
// kVec8: ich a multiple of 4, so a row's A registers are one 8-byte load
// (else two 4-byte ones); kStreamB: the weights stream through shared
// memory kchunk k-steps at a time (else they stay resident)
template <int N, int MT, int WG, int PF, bool kVec8, bool kStreamB>
__global__ void __launch_bounds__(128 * WG, 1)
s2d_conv_tc_kernel(const float* __restrict__ xf, long long n_floats,
                   const uint4* __restrict__ wpk, float* __restrict__ out,
                   int c2, int ich, int ksteps, int kchunk,
                   long long pad_floats, long long m_out, int fold,
                   long long m_pos, int row_step) {
  constexpr int kThreads = 128 * WG;
  constexpr int kTileM = 64 * MT * WG;
  constexpr int kBStep = 2 * N;              // uint4 of B per k-step
  extern __shared__ __align__(16) unsigned char smem[];
  const int win_words = window_words(kTileM, ich, ksteps);
  uint4* b_sh = reinterpret_cast<uint4*>(smem);
  uint32_t* win = reinterpret_cast<uint32_t*>(b_sh + kchunk * kBStep);
  // per column of the block: out row offset c * m_out (-1: no such row)
  // and the fold phase f of kernel row cf = c * fold + f
  long long* col_base = reinterpret_cast<long long*>(win + win_words);
  int* col_f = reinterpret_cast<int*>(col_base + N);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long tiles = (m_pos + kTileM - 1) / kTileM;
  const int col0 = blockIdx.y * N;
  const uint4* wsrc =
      wpk + static_cast<long long>(blockIdx.y) * ksteps * kBStep;
  long long tile = blockIdx.x;

  // The next window, f32, in registers while the MMAs run (where it fits
  // PF float2 a thread): pf[i] = stream floats q0 + 2j, q0 + 2j + 1 of
  // window word j = tid + i * threads.  A larger window is loaded after
  // the tile instead.
  const bool prefetch = win_words <= PF * kThreads;
  float2 pf[PF];
  auto load2 = [&](long long q) {       // q, n_floats even
    return q >= 0 && q < n_floats
               ? __ldg(reinterpret_cast<const float2*>(xf + q))
               : make_float2(0.f, 0.f);
  };
  auto fetch = [&](long long tl) {
    const long long q0 = tl * kTileM * ich - pad_floats;
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int j = threadIdx.x + i * kThreads;
      pf[i] = j < win_words ? load2(q0 + 2LL * j) : make_float2(0.f, 0.f);
    }
  };
  // ... rounded to bf16 (nearest even) into the window
  auto put = [&](long long tl) {
    if (prefetch) {
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const int j = threadIdx.x + i * kThreads;
        if (j < win_words) {
          const __nv_bfloat162 h = __float22bfloat162_rn(pf[i]);
          win[j] = *reinterpret_cast<const uint32_t*>(&h);
        }
      }
    } else {
      const long long q0 = tl * kTileM * ich - pad_floats;
      for (int j = threadIdx.x; j < win_words; j += kThreads) {
        const __nv_bfloat162 h = __float22bfloat162_rn(load2(q0 + 2LL * j));
        win[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
  };
  // k-steps [k0, k0 + n) of B into shared memory; wgmma reads them
  // through the async proxy
  auto load_b = [&](int k0, int n) {
    const uint4* src = wsrc + static_cast<long long>(k0) * kBStep;
    for (int i = threadIdx.x; i < n * kBStep; i += kThreads)
      b_sh[i] = __ldg(src + i);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  if (prefetch && tile < tiles) fetch(tile);
  if (!kStreamB) load_b(0, ksteps);          // this block's row group, once
  for (int col = threadIdx.x; col < N; col += kThreads) {
    const int cf = col0 + col;
    const int c = cf / fold;
    col_base[col] = cf < c2 ? static_cast<long long>(c) * m_out : -1;
    col_f[col] = cf - c * fold;
  }
  if (tile < tiles) put(tile);
  __syncthreads();

  // Positions of this thread's MMA rows g and g + 8 of m16 slab s of the
  // tile (warp w of warpgroup q owns slab 4 (q MT + mt) + w) and their
  // first window words, plus 2t.  row_step 4 interleaves two slabs over
  // 32 positions: rows g -> 4g + 2 (s & 1), g + 8 -> 4g + 2 (s & 1) + 1.
  int pos_lo[MT], pos_hi[MT], row_lo[MT], row_hi[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int s = ((warp >> 2) * MT + mt) * 4 + (warp & 3);
    if (row_step == 4) {
      pos_lo[mt] = (s >> 1) * 32 + 4 * g + 2 * (s & 1);
      pos_hi[mt] = pos_lo[mt] + 1;
    } else if (row_step == 2) {
      pos_lo[mt] = s * 16 + 2 * g;
      pos_hi[mt] = pos_lo[mt] + 1;
    } else {
      pos_lo[mt] = s * 16 + g;
      pos_hi[mt] = pos_lo[mt] + 8;
    }
    row_lo[mt] = pos_lo[mt] * (ich / 2) + 2 * t;
    row_hi[mt] = pos_hi[mt] * (ich / 2) + 2 * t;
  }

  for (; tile < tiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (prefetch && next < tiles) fetch(next);

    float acc[MT][N / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[mt][e] = 0.f;

    // A row's two A registers: MMA columns 2t, 2t + 1 and 2t + 8, 2t + 9
    // of a k-step, which the packing puts on stream offsets 4t .. 4t + 3
    uint32_t a[2][MT][4];
    auto load_a = [&](uint32_t (&dst)[MT][4], int ks) {
      const int c0 = ks * 8;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (kVec8) {
          const uint2 lo =
              *reinterpret_cast<const uint2*>(win + row_lo[mt] + c0);
          const uint2 hi =
              *reinterpret_cast<const uint2*>(win + row_hi[mt] + c0);
          dst[mt][0] = lo.x;
          dst[mt][1] = hi.x;
          dst[mt][2] = lo.y;
          dst[mt][3] = hi.y;
        } else {
          dst[mt][0] = win[row_lo[mt] + c0];
          dst[mt][1] = win[row_hi[mt] + c0];
          dst[mt][2] = win[row_lo[mt] + c0 + 1];
          dst[mt][3] = win[row_hi[mt] + c0 + 1];
        }
      }
    };
    // k-step ks of the tile with B's k-step kb of shared memory
    auto issue = [&](const uint32_t (&src)[MT][4], int kb) {
      wgmma_fence();
      const uint64_t desc =
          smem_desc(b_sh + kb * kBStep, (N / 8) * 128, 128);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) Wgmma<N>::mma(acc[mt], src[mt], desc);
      wgmma_commit();
    };
    // k-steps [k0, k0 + n), n even, B's from shared k-step kb0: group k
    // reads a[k & 1]; a buffer is loaded again only after the wait that
    // follows the next group's issue has retired its group
    auto run = [&](int k0, int n, int kb0) {
      for (int k = 0; k < n; k += 2) {
        load_a(a[0], k0 + k);
        issue(a[0], kb0 + k);
        wgmma_wait<1>();
        load_a(a[1], k0 + k + 1);
        issue(a[1], kb0 + k + 1);
        wgmma_wait<1>();
      }
    };
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) fence_operand(acc[mt][e]);
    if (kStreamB) {
      for (int k0 = 0; k0 < ksteps; k0 += kchunk) {
        const int n = min(kchunk, ksteps - k0);
        wgmma_wait<0>();
        __syncthreads();   // every warp is done with the last chunk
        load_b(k0, n);
        __syncthreads();
        run(k0, n, 0);
      }
    } else {
      run(0, ksteps, 0);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) fence_operand(acc[mt][e]);

    __syncthreads();   // every warp is done with this tile's window
    if (next < tiles) put(next);
    // store: accumulator e of n-tile nt is (row g or g + 8, column
    // 8 nt + 2t + (e & 1)); column cf = c * fold + f at folded position
    // p is out[c, p * fold + f]
    const long long w0 = tile * kTileM;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const long long pos[2] = {w0 + pos_lo[mt], w0 + pos_hi[mt]};
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const long long base = col_base[col];
          const long long w = pos[e >> 1] * fold + col_f[col];
          if (base >= 0 && w < m_out) out[base + w] = acc[mt][nt * 4 + e];
        }
      }
    }
    __syncthreads();   // the next window is in place
  }
}

template <int N, int MT, int WG, int PF, bool kVec8, bool kStreamB>
cudaError_t launch(const float* xf, long long n_floats, const uint4* wpk,
                   float* out, int c2, int ich, int ksteps, int kchunk,
                   long long pad_floats, long long m_out, int fold,
                   int row_step, cudaStream_t stream) {
  constexpr int kTileM = 64 * MT * WG;
  const int win_words = window_words(kTileM, ich, ksteps);
  const size_t smem = 32u * N * kchunk + 4u * win_words + 12u * N;
  const auto kernel = s2d_conv_tc_kernel<N, MT, WG, PF, kVec8, kStreamB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  const long long m_pos = (m_out + fold - 1) / fold;
  const long long tiles = (m_pos + kTileM - 1) / kTileM;
  const int groups = (c2 + N - 1) / N;
  // one block per SM in all, each row group walking its share of tiles
  long long per_group = (sms + groups - 1) / groups;
  if (per_group > tiles) per_group = tiles;
  const dim3 grid(static_cast<unsigned>(per_group),
                  static_cast<unsigned>(groups));
  kernel<<<grid, 128 * WG, smem, stream>>>(xf, n_floats, wpk, out, c2, ich,
                                           ksteps, kchunk, pad_floats, m_out,
                                           fold, m_pos, row_step);
  return cudaGetLastError();
}

template <int N, int MT, int WG, int PF, bool kStreamB>
cudaError_t launch_ich(const float* xf, long long n_floats, const uint4* wpk,
                       float* out, int c2, int ich, int ksteps, int kchunk,
                       long long pad_floats, long long m_out, int fold,
                       int row_step, cudaStream_t stream) {
  return (ich & 3)
             ? launch<N, MT, WG, PF, false, kStreamB>(
                   xf, n_floats, wpk, out, c2, ich, ksteps, kchunk,
                   pad_floats, m_out, fold, row_step, stream)
             : launch<N, MT, WG, PF, true, kStreamB>(
                   xf, n_floats, wpk, out, c2, ich, ksteps, kchunk,
                   pad_floats, m_out, fold, row_step, stream);
}

}  // namespace

// c2, ich: kernel rows and input channels as launched (C2 * F, 2D * F
// with a fold F); ksteps: K / 16, K padded, even; kchunk: k-steps of B
// in shared memory at a time (ksteps: all of it, loaded once), even; wpk:
// the packed weights, (ceil(c2 / rows), ksteps, 2 rows) uint4; m_out: the
// un-folded output count per row; rows: kernel rows per block, 64 or 32;
// tile_m: positions per tile, 256 or 128; row_step: 1, 2 or 4
// (ops/kernels/s2d_conv.py:tc_config, tc_row_step).
extern "C" int tetra_s2d_conv_tc(const float* xf, long long n_floats,
                                 const void* wpk, float* out, int c2, int ich,
                                 int ksteps, long long pad_floats,
                                 long long m_out, int fold, int rows,
                                 int tile_m, int kchunk, int row_step,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* w = static_cast<const uint4*>(wpk);
  if ((ich & 1) || (ksteps & 1) || (kchunk & 1) || kchunk < 2 ||
      kchunk > ksteps || fold < 1 ||
      (row_step != 1 && row_step != 2 && row_step != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool stream_b = kchunk < ksteps;
  cudaError_t err = cudaErrorInvalidValue;
  if (rows == 64 && tile_m == 256)
    err = stream_b ? launch_ich<64, 1, 4, 12, true>(
                         xf, n_floats, w, out, c2, ich, ksteps, kchunk,
                         pad_floats, m_out, fold, row_step, s)
                   : launch_ich<64, 1, 4, 12, false>(
                         xf, n_floats, w, out, c2, ich, ksteps, kchunk,
                         pad_floats, m_out, fold, row_step, s);
  else if (rows == 64 && tile_m == 128)
    err = stream_b ? launch_ich<64, 1, 2, 24, true>(
                         xf, n_floats, w, out, c2, ich, ksteps, kchunk,
                         pad_floats, m_out, fold, row_step, s)
                   : launch_ich<64, 1, 2, 24, false>(
                         xf, n_floats, w, out, c2, ich, ksteps, kchunk,
                         pad_floats, m_out, fold, row_step, s);
  else if (rows == 32 && tile_m == 128 && !stream_b)
    err = launch_ich<32, 1, 2, 36, false>(xf, n_floats, w, out, c2, ich,
                                          ksteps, kchunk, pad_floats, m_out,
                                          fold, row_step, s);
  return static_cast<int>(err);
}

extern "C" const char* tetra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

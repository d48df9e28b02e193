// The multicarrier decode's sync walk on Hopper: every row's sync hits
// found in one launch, on the best-of-TS1/TS2 scores where the frontend
// left them.
//
// Replaces no TPU kernel: the JAX package walks each row on the host in
// numpy (TetraDecoder.find_sync's threshold cascade, up to four passes a
// row of about six full-row operations each).  Added because that walk
// held a third of the full band's host decode (20 ms of a 65 ms chunk at
// 96 rows of 32,241 scores), and it needed the whole score matrix pulled
// to the host first (12.4 MB of pageable copy a chunk).  Now the host
// pulls each row's positions: (R, ceil(W / 250)) int32 and a count.
//
// The rule (ops/sync.sync_walk_plain gives its derivation from the
// cascade, and the tests hold the two equal on every case it names): the
// valid windows of row r are [0, V), V = min(W, 2 max(count - 1, 0) -
// 21); M is their largest score, read as double; the threshold is 0.90
// if M >= 0.90, max(0.75, M - 0.02) if 0.75 <= M < 0.90 (the host's IEEE
// double arithmetic, every comparison (double)score >= thr), and there is
// no walk below 0.75.  The greedy walk takes the first window at or
// above the threshold, then the first at or after that position + 250,
// and so on.  The scores are finite (matches over 22).
//
// Layout.  One block of 1024 threads a row.  Pass 1: the row's valid
// scores, coalesced, reduced to M by warp shuffles and one shared word a
// warp; every warp then reduces the 32 words itself, so no second
// barrier.  Pass 2, per segment of 32,768 windows (one at the cells'
// 32,241): each thread loads its 32 scores at once, so one round trip
// serves the segment, and each warp's __ballot_sync of "score >= thr"
// over 32 neighbouring windows is one word of the segment's hit bitmask
// in shared memory (4 KB).  Then warp 0 walks the bitmask: lane l holds
// word w0 + l, where w0 holds the next free window p (bits below p
// masked off); a ballot of the nonzero words and __ffs give the first hit
// at or after p, 1,024 windows a step, the accept jumps p 250 ahead, and
// the walk's state carries into the next segment.  The walk is exact on
// any row, every window a hit included: it reads the bitmask, not a list
// of hits, so a row's work is its accepts plus V / 1,024 steps.
//
// Bound.  Bytes: the scores read twice, 2 R W 4 B (24.8 MB at the full
// band's 96 x 32,241, 7.4 us at 3.35 TB/s; once, 3.7 us), though the
// second read, and often the first, comes from the 50 MB L2.  Positions
// and counts are nothing.  Latency: per row two round trips to memory,
// then the walk's chain of dependent steps (shared load, ballot, shuffle,
// __ffs: ~40 clocks each) over about 36 steps at a quiet row's 4-6
// accepts, ~1 us; the 96 rows run at once on the 132 SMs.  chip_smoke.py
// (phase 3c) prices both and times the kernel beside them.
//
// C interface (ctypes): tetra_sync_walk launches on the given stream and
// returns the CUDA error (0 on success); it allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 32;                       // scores a segment
constexpr int kSegBits = kThreads * kPerThread;      // 32,768 windows
constexpr int kSegWords = kSegBits / 32;             // 4 KB of bitmask
constexpr int kSkip = 250;                           // SYNC_SKIP_BITS
constexpr int kSyncLen = 22;                         // SYNC_LEN_BITS
constexpr double kHigh = 0.90;                       // the first pass
constexpr double kFloor = 0.75;                      // SYNC_ADAPTIVE_FLOOR
constexpr double kTol = 0.02;                        // ..._TOLERANCE
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

__global__ void __launch_bounds__(kThreads)
sync_walk_kernel(const float* __restrict__ corr,
                 const int* __restrict__ count, int width, int cap,
                 int* __restrict__ positions, int* __restrict__ accepted) {
  __shared__ unsigned hits[kSegWords];
  __shared__ float maxima[kWarps];

  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* s = corr + static_cast<size_t>(row) * width;
  const long long nsym = max(count[row] - 1, 0);
  const int valid = static_cast<int>(
      min(static_cast<long long>(width),
          max(0LL, 2 * nsym - (kSyncLen - 1))));

  // pass 1: M, the largest valid score (-inf for no window)
  float m = -INFINITY;
#pragma unroll 8
  for (int i = threadIdx.x; i < valid; i += kThreads) m = fmaxf(m, s[i]);
  m = warp_max(m);
  if (lane == 0) maxima[warp] = m;
  __syncthreads();
  m = warp_max(maxima[lane]);

  // the threshold, in the host's double arithmetic
  const double md = static_cast<double>(m);
  const double thr = md >= kHigh ? kHigh : fmax(kFloor, md - kTol);
  const int end = md >= kFloor ? valid : 0;          // no walk below 0.75

  int* out = positions + static_cast<size_t>(row) * cap;
  int next_free = 0;           // warp 0's: the last accept + 250
  int n = 0;
  for (int seg = 0; seg < end; seg += kSegBits) {
    const int seg_end = min(end, seg + kSegBits);
    // pass 2: the segment's hit bitmask, all 32 loads of a thread at once
    float v[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = seg + k * kThreads + threadIdx.x;
      v[k] = i < seg_end ? s[i] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = seg + k * kThreads + threadIdx.x;
      const unsigned b = __ballot_sync(
          kFull, i < seg_end && static_cast<double>(v[k]) >= thr);
      if (lane == 0) hits[k * kWarps + warp] = b;
    }
    __syncthreads();
    if (warp == 0) {
      const int words = (seg_end - seg + 31) >> 5;
      int p = max(next_free, seg);
      while (p < seg_end) {
        const int w0 = (p - seg) >> 5;
        const int wi = w0 + lane;
        unsigned word = wi < words ? hits[wi] : 0u;
        if (lane == 0) word &= kFull << ((p - seg) & 31);
        const unsigned any = __ballot_sync(kFull, word != 0u);
        if (any == 0u) {
          p = seg + ((w0 + 32) << 5);
          continue;
        }
        const int f = __ffs(any) - 1;
        const unsigned fw = __shfl_sync(kFull, word, f);
        const int h = seg + ((w0 + f) << 5) + __ffs(fw) - 1;
        if (lane == 0 && n < cap) out[n] = h;
        ++n;
        next_free = h + kSkip;
        p = next_free;
      }
    }
    __syncthreads();                 // the next segment rewrites hits
  }
  if (warp == 0) {
    for (int k = n + lane; k < cap; k += 32) out[k] = -1;
    if (lane == 0) accepted[row] = n;
  }
}

}  // namespace

extern "C" const char* tetra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// corr: (rows, width) contiguous f32 on the card; count: (rows,) int32
// there; positions: (rows, cap) int32, cap = ceil(width / 250); accepted:
// (rows,) int32.
extern "C" int tetra_sync_walk(const float* corr, const int* count, int rows,
                               int width, int cap, int* positions,
                               int* accepted, void* stream) {
  if (rows < 1 || width < 1 || cap != (width + kSkip - 1) / kSkip)
    return static_cast<int>(cudaErrorInvalidValue);
  sync_walk_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      corr, count, width, cap, positions, accepted);
  return static_cast<int>(cudaGetLastError());
}

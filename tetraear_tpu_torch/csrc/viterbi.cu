// The TETRA channel decoder's Viterbi on Hopper: the soft-decision
// decoder of the rate-1/4 K = 5 mother code (EN 300 392-2 8.2.3, 16
// states), every trellis step and the traceback of every code block of a
// call in one launch.
//
// Replaces no TPU kernel: the JAX package decodes with a `lax.scan` over
// the trellis steps (tetraear_tpu/ops/viterbi.py:141, 154), and the
// port's plain version (ops/viterbi.viterbi_decode_plain) with a Python
// loop of about 15 launches a step.  Added because those launches held
// 92 % of the downlink's decode on the card: 592 trellis steps a
// multiframe, some 8,900 launches for a code whose arithmetic takes
// microseconds.
//
// The plain version's arithmetic, in its order, in float32 (the tests
// hold the two equal bit for bit, ties included):
//
//   branch metric  ((x0 s0 + x1 s1) + x2 s2) + x3 s3,  s = +-1, so each
//                  product is the soft value or its negation, exactly;
//   path metric    metric[pred] + bm, pred = (s' & 7) << 1 | {0, 1};
//   select         predecessor 1 only if m1 > m0: a tie takes 0;
//   start          0 in state 0, -1e9 elsewhere, never renormalised;
//   end            state 0 when terminated, else the best state (torch's
//                  argmax: the lowest index on ties, a NaN above all);
//   traceback      bit t = state >> 3, state = (state & 7) << 1 | d_t.
//
// Every sum is __fadd_rn, so nvcc contracts nothing into an FMA.
//
// Layout.  16 lanes decode one code block, lane s' holding the path
// metric of state s' in a register; a block holds 8 code blocks in 128
// threads.  The block first copies its code blocks' N x 4 soft values,
// contiguous in device memory, into static shared memory with coalesced
// loads: 18 bytes a step and code block, so N up to 341 (48 KB); the
// port's longest code is TCH/4.8's 292.  Each step a lane reads its two
// predecessors' metrics with __shfl_sync inside its 16-lane half of the
// warp, forms its two branch metrics from the step's
// four soft values (one 16-byte shared load, the same address for the
// group) and its two output-bit masks, computed once from the generator
// taps, and selects; the group's 16 decisions are one __ballot_sync, kept
// in shared memory as N 16-bit words.  The end state is a butterfly over
// the 16 lanes, and lane 0 traces back alone, writing uint8 bits straight
// into the (B, N) or (B, N - 4) output.
//
// Bound.  Not bytes or operations: a call moves 16 N B bytes in and N B
// out (SCH/F, B = 60: 0.3 MB, 0.1 us at 3.35 TB/s) and adds ~160 N B
// floats.  The bound is latency: the serial chain of N add-compare-select
// steps, each waiting on the last (shuffle, add, compare, select), then
// the traceback's N steps, each waiting on the last state (shift by it,
// mask, merge; the decision words' loads do not wait on it), after one
// DRAM round trip for the soft values.  chip_smoke.py (phase 3b) prices
// it from the card's latencies: ~6.6 us at N = 288 whatever B, which the
// grid spreads over the SMs.
//
// C interface (ctypes): tetra_viterbi launches on the given stream and
// returns the CUDA error (0 on success); it allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 16;
constexpr int kRate = 4;
constexpr int kThreads = 128;
constexpr int kGroups = kThreads / kStates;          // code blocks a block
constexpr int kMaxSteps = 341;                       // 48 KB of shared memory
constexpr unsigned kFull = 0xffffffffu;
// generator taps over r = u(k) << 4 | state (bit 4 u(k) ... bit 0 u(k-4))
__constant__ unsigned c_gen[kRate] = {0x19u, 0x17u, 0x1Fu, 0x1Bu};

// the four output bits of the branch from state s on input u, bit j = v_j
__device__ __forceinline__ unsigned out_bits(unsigned s, unsigned u) {
  unsigned out = 0;
#pragma unroll
  for (int j = 0; j < kRate; ++j)
    out |= (__popc(((u << 4) | s) & c_gen[j]) & 1u) << j;
  return out;
}

__device__ __forceinline__ float branch_metric(float4 x, unsigned out) {
  float a = (out & 1u) ? x.x : -x.x;
  a = __fadd_rn(a, (out & 2u) ? x.y : -x.y);
  a = __fadd_rn(a, (out & 4u) ? x.z : -x.z);
  return __fadd_rn(a, (out & 8u) ? x.w : -x.w);
}

// whether (bv, bi) comes before (av, ai) in torch.argmax's order
__device__ __forceinline__ bool beats(float bv, int bi, float av, int ai) {
  const bool bn = bv != bv, an = av != av;
  if (bn != an) return bn;
  if (!bn && bv != av) return bv > av;
  return bi < ai;
}

__global__ void __launch_bounds__(kThreads)
viterbi_kernel(const float* __restrict__ llrs, int batch, int n, int n_out,
               int terminated, uint8_t* __restrict__ bits) {
  __shared__ float4 xs[kGroups * kMaxSteps];           // kGroups x n used
  __shared__ uint16_t dec[kGroups * kMaxSteps];

  const int b0 = blockIdx.x * kGroups;
  const int rows = min(kGroups, batch - b0);
  float* xf = reinterpret_cast<float*>(xs);
  const float* src = llrs + static_cast<size_t>(b0) * n * kRate;
  // unrolled so that each thread keeps 8 loads in flight
#pragma unroll 8
  for (int i = threadIdx.x; i < kGroups * n * kRate; i += kThreads)
    xf[i] = i < rows * n * kRate ? src[i] : 0.0f;
  __syncthreads();

  const int g = threadIdx.x / kStates;                 // the code block
  const int sp = threadIdx.x & (kStates - 1);          // new state s'
  const int p0 = (sp & 7) << 1;
  const unsigned out0 = out_bits(p0, sp >> 3);
  const unsigned out1 = out_bits(p0 | 1, sp >> 3);
  const int half = threadIdx.x & 16;                   // the group's bits
  const float4* x = xs + g * n;
  uint16_t* d = dec + g * n;

  float metric = sp == 0 ? 0.0f : -1e9f;
#pragma unroll 4
  for (int t = 0; t < n; ++t) {
    const float4 v = x[t];
    const float a = __shfl_sync(kFull, metric, p0, kStates);
    const float b = __shfl_sync(kFull, metric, p0 | 1, kStates);
    const float m0 = __fadd_rn(a, branch_metric(v, out0));
    const float m1 = __fadd_rn(b, branch_metric(v, out1));
    const bool take1 = m1 > m0;
    metric = take1 ? m1 : m0;
    const unsigned ballot = __ballot_sync(kFull, take1);
    if (sp == 0) d[t] = static_cast<uint16_t>(ballot >> half);
  }

  int state = 0;
  if (terminated == 0) {
    float best = metric;
    int idx = sp;
#pragma unroll
    for (int off = kStates / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off, kStates);
      const int oi = __shfl_xor_sync(kFull, idx, off, kStates);
      if (beats(ov, oi, best, idx)) {
        best = ov;
        idx = oi;
      }
    }
    state = idx;
  }
  if (sp != 0 || g >= rows) return;
  uint8_t* o = bits + static_cast<size_t>(b0 + g) * n_out;
  for (int t = n - 1; t >= 0; --t) {
    const unsigned bit = (d[t] >> state) & 1u;
    if (t < n_out) o[t] = static_cast<uint8_t>(state >> 3);
    state = ((state & 7) << 1) | static_cast<int>(bit);
  }
}

}  // namespace

extern "C" const char* tetra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// llrs: (batch, 4 n) contiguous f32 on the card, > 0 meaning bit 1;
// bits: (batch, n_out) uint8 on the card, n_out = n - 4 when terminated,
// else n; n from 1 to 341.
extern "C" int tetra_viterbi(const float* llrs, int batch, int n, int n_out,
                             int terminated, uint8_t* bits, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxSteps ||
      n_out != (terminated ? n - 4 : n) || n_out < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((batch + kGroups - 1) / kGroups);
  viterbi_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      llrs, batch, n, n_out, terminated, bits);
  return static_cast<int>(cudaGetLastError());
}

"""The issue rate of Hopper's wgmma with A from registers, the shape the
tensor-core s2d conv (tetraear_tpu_torch/csrc/s2d_conv_tc.cu) runs:
m64nNk16 bf16 -> f32, N = 32 and 64, four warpgroups of two m64 tiles a
block, one block per SM, two k-steps in flight; with no A loads, with
eight 4-byte shared-memory loads per warp and k-step, or with four
8-byte ones.  It prints TFLOP/s beside the card's name and power limit:
the ceiling of the kernel's inner loop for each way of loading A.

    python3 tools/wgmma_rate.py        # on a machine with an H100 and nvcc
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

SRC = r'''
#include <cuda_runtime.h>
#include <cstdint>
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
template <int N> struct W;
template <> struct W<32> { static __device__ void mma(float* d, const uint32_t* a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\nwgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
    : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),"+f"(d[6]),"+f"(d[7]),"+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),"+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15])
    : "r"(a[0]),"r"(a[1]),"r"(a[2]),"r"(a[3]),"l"(b),"r"(1)); } };
template <> struct W<64> { static __device__ void mma(float* d, const uint32_t* a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
    : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),"+f"(d[6]),"+f"(d[7]),"+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),"+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15]),
      "+f"(d[16]),"+f"(d[17]),"+f"(d[18]),"+f"(d[19]),"+f"(d[20]),"+f"(d[21]),"+f"(d[22]),"+f"(d[23]),"+f"(d[24]),"+f"(d[25]),"+f"(d[26]),"+f"(d[27]),"+f"(d[28]),"+f"(d[29]),"+f"(d[30]),"+f"(d[31])
    : "r"(a[0]),"r"(a[1]),"r"(a[2]),"r"(a[3]),"l"(b),"r"(1)); } };
template <int N, int MT, int LOAD>
__global__ void __launch_bounds__(512, 1) k(float* out, int iters) {
  __shared__ __align__(16) unsigned char b_sh[8 * 2 * 1024];
  __shared__ uint32_t win[8192];
  for (int i = threadIdx.x; i < 8 * 2 * 1024 / 4; i += blockDim.x) ((uint32_t*)b_sh)[i] = 0x3f803f80u;
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) win[i] = 0x3c003c00u ^ i;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float acc[MT][N / 2];
  for (int m = 0; m < MT; ++m) for (int e = 0; e < N / 2; ++e) acc[m][e] = 0.f;
  uint32_t a[2][MT][4];
  for (int j = 0; j < 2; ++j) for (int m = 0; m < MT; ++m) for (int r = 0; r < 4; ++r) a[j][m][r] = 0x3f803f80u + threadIdx.x + r;
  const int lane = threadIdx.x & 31, base = (threadIdx.x >> 5) * 160 + (lane >> 2) * 20 + (lane & 3);
  for (int it = 0; it < iters; it += 2) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ks = (it + j) & 7;
      if (LOAD == 1) {
#pragma unroll
        for (int m = 0; m < MT; ++m) for (int r = 0; r < 4; ++r) a[j][m][r] = win[(base + m * 320 + r * 4 + ks * 8) & 8191];
      }
      if (LOAD == 2) {
        const int b2 = (threadIdx.x >> 5) * 160 + (lane >> 2) * 40 + 2 * (lane & 3);
#pragma unroll
        for (int m = 0; m < MT; ++m) for (int r = 0; r < 2; ++r) {
          const uint2 v = *reinterpret_cast<const uint2*>(&win[(b2 + m * 320 + r * 10 + ks * 8) & 8190]);
          a[j][m][2 * r] = v.x; a[j][m][2 * r + 1] = v.y; }
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint64_t d = desc(b_sh + ks * (N / 32) * 1024, (N / 8) * 128, 128);
#pragma unroll
      for (int m = 0; m < MT; ++m) W<N>::mma(acc[m], a[j][m], d);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.f;
  for (int m = 0; m < MT; ++m) for (int e = 0; e < N / 2; ++e) s += acc[m][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int variant, float* out, int iters, int blocks) {
  switch (variant) {
    case 0: k<32, 2, 0><<<blocks, 512>>>(out, iters); break;
    case 1: k<32, 2, 1><<<blocks, 512>>>(out, iters); break;
    case 2: k<32, 2, 2><<<blocks, 512>>>(out, iters); break;
    case 3: k<64, 2, 2><<<blocks, 512>>>(out, iters); break;
  }
  return (int)cudaGetLastError();
}
'''


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    with tempfile.TemporaryDirectory() as d:
        src, lib = os.path.join(d, "rate.cu"), os.path.join(d, "rate.so")
        with open(src, "w") as f:
            f.write(SRC)
        build = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                                "-O3", "-shared", "-Xcompiler", "-fPIC",
                                "-o", lib, src], capture_output=True, text=True)
        if build.returncode != 0:
            print(build.stderr[-2000:])
            return 1
        rate = ctypes.CDLL(lib)
        rate.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int]
        blocks = torch.cuda.get_device_properties(0).multi_processor_count
        out = torch.empty(blocks * 512, device="cuda")
        iters = 20000
        for v, (n, load) in enumerate([(32, "none"), (32, "8 x LDS.32"),
                                       (32, "4 x LDS.64"),
                                       (64, "4 x LDS.64")]):
            if rate.run(v, out.data_ptr(), 100, blocks) != 0:
                print(f"variant {v}: launch failed")
                return 1
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rate.run(v, out.data_ptr(), iters, blocks)
            end.record()
            end.synchronize()
            flop = 2.0 * 64 * n * 16 * 2 * 4 * iters * blocks
            print(f"{card}: m64n{n}k16, A loads per warp and k-step: "
                  f"{load}: {flop / start.elapsed_time(end) / 1e9:.1f} "
                  "TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

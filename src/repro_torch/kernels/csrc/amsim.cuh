// AMSim (paper Alg. 2) as a CUDA device function, plus the LUT staging
// shared by the GEMM and conv kernels.
//
// Port of repro/core/amsim.py:_amsim and of the gather brick
// repro/kernels/common.py:_gather_gemm_tile.  On the TPU the brick is a
// rank-`chunk` gather-GEMM update run on the vector unit; here it is one
// product per call, folded into the caller's f32 accumulator in k order,
// so there is no launch of its own.
//
// Words are uint32 bit patterns of float32 operands.  The LUT is either
// canonical (uint32 entries: carry << 23 | 23-bit mantissa) or packed
// (uint16 entries: carry << M | top-M mantissa), chosen by LutT, and it is
// read from shared memory when the caller staged it there (kSmem) or from
// global memory through the read-only cache otherwise.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace amsim {

// Default block size of the grid-stride kernels.
constexpr int kThreads = 256;

template <typename LutT, bool kSmem>
__device__ __forceinline__ uint32_t lut_load(const LutT* lut, uint32_t i) {
  if constexpr (kSmem) {
    return lut[i];
  } else {
    return __ldg(lut + i);
  }
}

// amsim(a, b) for the words ua, ub; M in [1, 12].
template <typename LutT, bool kSmem>
__device__ __forceinline__ float mul(uint32_t ua, uint32_t ub, const LutT* lut, int M) {
  const uint32_t amnt = ua & 0x007FFFFFu;
  const uint32_t bmnt = ub & 0x007FFFFFu;
  const uint32_t idx = ((amnt >> (23 - M)) << M) | (bmnt >> (23 - M));
  uint32_t entry = lut_load<LutT, kSmem>(lut, idx);
  if constexpr (sizeof(LutT) == 2) {
    entry = ((entry >> M) << 23) | ((entry & ((1u << M) - 1u)) << (23 - M));
  }
  const uint32_t carry = (entry >> 23) & 1u;
  const uint32_t mnt = entry & 0x007FFFFFu;
  const uint32_t sign = (ua ^ ub) & 0x80000000u;
  const int ea = static_cast<int>((ua >> 23) & 0xFFu);
  const int eb = static_cast<int>((ub >> 23) & 0xFFu);
  int e = ea + eb - 127;
  // Flush to zero is decided before the carry is added, overflow after.
  const bool zero = (e <= 0) || (ea == 0) || (eb == 0);
  e += static_cast<int>(carry);
  const bool inf = (e >= 255) && !zero;
  e = min(max(e, 0), 255);
  uint32_t out = sign | (static_cast<uint32_t>(e) << 23) | mnt;
  if (inf) out = sign | 0x7F800000u;
  if (zero) out = sign;
  return __uint_as_float(out);
}

// Copy the LUT of `bytes` bytes from global into shared memory; every
// thread of the block takes part.  Tables are a multiple of 4 bytes.
__device__ __forceinline__ void stage_lut(void* dst, const void* src, int bytes) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if (bytes % 16 == 0) {
    uint4* d = static_cast<uint4*>(dst);
    const uint4* s = static_cast<const uint4*>(src);
    for (int i = tid; i < bytes / 16; i += nthreads) d[i] = __ldg(s + i);
  } else {
    uint32_t* d = static_cast<uint32_t*>(dst);
    const uint32_t* s = static_cast<const uint32_t*>(src);
    for (int i = tid; i < bytes / 4; i += nthreads) d[i] = __ldg(s + i);
  }
  __syncthreads();
}

// Grid size for a grid-stride kernel of `threads` a block: as many blocks
// as fit on the card at once, no more than there is work for.  Staging the
// LUT costs each block a copy of the table, so blocks loop over work
// instead of being many.
template <typename Kernel>
inline cudaError_t grid_size(Kernel kernel, int smem_bytes, long long work_blocks,
                             int* blocks, int threads = kThreads) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
  if (err != cudaSuccess) return err;
  long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  *blocks = static_cast<int>(work_blocks < cap ? work_blocks : cap);
  return cudaSuccess;
}

}  // namespace amsim

extern "C" const char* amsim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

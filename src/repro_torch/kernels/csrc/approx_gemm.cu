// approx_gemm: (m, k) @ (k, n) -> (m, n), and its batched form
// approx_gemm_batched: (B, m, k) @ (B, k, n) -> (B, m, n), every product
// simulated by AMSim through the mantissa-product LUT, accumulated in
// float32.
//
// Replaces the TPU kernels repro/kernels/approx_gemm.py:_amsim_kernel
// (launched by approx_gemm) and _amsim_kernel_batched (approx_gemm_batched,
// whose grid adds the batch as a parallel dimension, one LUT for all of
// it).  There a grid (m/bm, n/bn, k/bk) runs in order on one core and
// carries the f32 accumulator tile in VMEM across the k steps.  Here
// blocks run in parallel, so the k loop lives inside the block; the batch
// is a third index of the blocks' walk over output tiles (tile t is batch
// t / tiles, tile t % tiles of that product), so one launch covers the
// whole batch and each block stages the LUT once for every batch element
// it serves.  The 2-D GEMM is the batch of one.
//
// What bounds it on the H100: operations.  A LUT product cannot use the
// tensor cores (wgmma multiplies, it does not look up), so each product
// is a gather from the table plus ~20 integer instructions; the bytes
// (each operand read once) are small beside that.  The design keeps the
// table next to the ALUs: a table of <= 128 KiB (packed M <= 8, canonical
// M <= 7) is staged into shared memory once per block, and blocks loop
// over output tiles (grid-stride, as many blocks as fit) so each copy of
// the table serves many tiles.  Larger tables are read from global memory
// through the read-only cache.  A and B k-tiles pass through shared
// memory, so each operand word is read from device memory once per tile.
//
// Each thread owns one output and folds k strictly in order,
// acc = acc + amsim(a[i,k], b[k,j]) from +0.0f: the chunk=1 order of the
// TPU kernel and of the plain version (kernels/ref.py:ref_amsim_gemm), so
// results are bitwise equal to both.  Built without fast-math flags: the
// sum must round, and keep denormals, as the CPU does.
#include "amsim.cuh"

namespace {

constexpr int kTile = 16;  // 16x16 threads, one output each

template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
approx_gemm_kernel(const float* __restrict__ a_all, const float* __restrict__ b_all,
                   const LutT* __restrict__ lut_g, float* __restrict__ out,
                   int batch, int m, int k, int n, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem_lut[];
  __shared__ uint32_t as[kTile][kTile];  // a[row, k0 + kk] as [ty][kk]
  __shared__ uint32_t bs[kTile][kTile];  // b[k0 + kk, col] as [kk][tx]

  const LutT* lut = lut_g;
  if constexpr (kSmem) {
    amsim::stage_lut(smem_lut, lut_g, lut_bytes);
    lut = reinterpret_cast<const LutT*>(smem_lut);
  }
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tiles_n = (n + kTile - 1) / kTile;
  const long long tiles = static_cast<long long>((m + kTile - 1) / kTile) * tiles_n;

  for (long long bt = blockIdx.x; bt < tiles * batch; bt += gridDim.x) {
    const long long e = bt / tiles;
    const int t = static_cast<int>(bt % tiles);
    const int row = (t / tiles_n) * kTile + ty;
    const int col = (t % tiles_n) * kTile + tx;
    const float* a = a_all + e * m * k;
    const float* b = b_all + e * k * n;
    float acc = 0.0f;
    for (int k0 = 0; k0 < k; k0 += kTile) {
      as[ty][tx] = (row < m && k0 + tx < k)
                       ? __float_as_uint(a[static_cast<size_t>(row) * k + k0 + tx])
                       : 0u;
      bs[ty][tx] = (k0 + ty < k && col < n)
                       ? __float_as_uint(b[static_cast<size_t>(k0 + ty) * n + col])
                       : 0u;
      __syncthreads();
      const int kk_end = min(kTile, k - k0);
      for (int kk = 0; kk < kk_end; ++kk) {
        acc = acc + amsim::mul<LutT, kSmem>(as[ty][kk], bs[kk][tx], lut, M);
      }
      __syncthreads();
    }
    if (row < m && col < n) out[e * m * n + static_cast<size_t>(row) * n + col] = acc;
  }
}

template <typename LutT, bool kSmem>
cudaError_t launch(const float* a, const float* b, const void* lut, float* out, int batch,
                   int m, int k, int n, int M, int lut_bytes, cudaStream_t stream) {
  auto kernel = approx_gemm_kernel<LutT, kSmem>;
  const int smem = kSmem ? lut_bytes : 0;
  const long long tiles =
      static_cast<long long>(batch) * ((m + kTile - 1) / kTile) * ((n + kTile - 1) / kTile);
  int blocks = 0;
  cudaError_t err = amsim::grid_size(kernel, smem, tiles, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, dim3(kTile, kTile), smem, stream>>>(
      a, b, static_cast<const LutT*>(lut), out, batch, m, k, n, M, lut_bytes);
  return cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t code: 0 when the launch was accepted.
// `packed` selects uint16 LUT entries; `smem_lut` stages the table in
// shared memory (the caller decides, kernels/common.py:lut_in_smem).
extern "C" int approx_gemm_batched_f32(const float* a, const float* b, const void* lut,
                                       float* out, int batch, int m, int k, int n, int M,
                                       int packed, int smem_lut, int lut_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (packed) {
    err = smem_lut ? launch<uint16_t, true>(a, b, lut, out, batch, m, k, n, M, lut_bytes, s)
                   : launch<uint16_t, false>(a, b, lut, out, batch, m, k, n, M, lut_bytes, s);
  } else {
    err = smem_lut ? launch<uint32_t, true>(a, b, lut, out, batch, m, k, n, M, lut_bytes, s)
                   : launch<uint32_t, false>(a, b, lut, out, batch, m, k, n, M, lut_bytes, s);
  }
  return static_cast<int>(err);
}

extern "C" int approx_gemm_f32(const float* a, const float* b, const void* lut, float* out,
                               int m, int k, int n, int M, int packed, int smem_lut,
                               int lut_bytes, void* stream) {
  return approx_gemm_batched_f32(a, b, lut, out, 1, m, k, n, M, packed, smem_lut, lut_bytes,
                                 stream);
}

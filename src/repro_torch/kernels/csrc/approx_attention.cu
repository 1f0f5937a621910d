// approx_attention: softmax(mask(q k^T / sqrt(dh))) v with both
// contractions simulated by AMSim, in one launch.
//
// Replaces the TPU kernel repro/kernels/approx_attention.py:_attn_kernel
// (launched by approx_attention_fused).  There one grid cell holds the
// K/V of a (batch, kv-head) and a (q-block x T) score tile in VMEM, which
// caps the shapes it takes.  Here one warp takes one query row
// (attention.cuh attend_row) and its scores go to a global-memory scratch
// of T floats per resident warp, so every shape is taken.
//
// What bounds it on the H100: at prefill, operations (two LUT products
// per (query row, live key, head dim)); at decode, the K/V bytes of the
// live keys.  Blocks loop over rows (grid-stride, as many blocks as fit)
// so each shared-memory copy of the LUT serves many rows; tables over
// 128 KiB are read from global memory.  Bitwise equal to
// kernels/approx_attention.py:approx_attention_plain.
#include <algorithm>

#include "attention.cuh"

namespace {

template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
attention_kernel(amsim::Attn a, const LutT* __restrict__ lut_g, float* __restrict__ out,
                 float* __restrict__ scratch, int scratch_warps, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LutT* lut = lut_g;
  int lut_space = 0;
  if constexpr (kSmem) {
    amsim::stage_lut(smem, lut_g, lut_bytes);
    lut = reinterpret_cast<const LutT*>(smem);
    lut_space = amsim::align16(lut_bytes);
  }
  float* qrows = reinterpret_cast<float*>(smem + lut_space);
  amsim::attention_rows<LutT, kSmem>(a, lut, M, qrows, scratch, scratch_warps, out);
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.  scratch
// holds scratch_warps rows of T floats (a multiple of 8 rows).
extern "C" int approx_attention_f32(const float* q, const float* k, const float* v,
                                    const int* q_pos, const int* k_pos, const void* lut,
                                    float* out, float* scratch, int B, int S, int H, int KV,
                                    int T, int dh, int causal, int window, int scratch_warps,
                                    int M, int packed, int smem_lut, int lut_bytes,
                                    void* stream) {
  const amsim::Attn a{q, k, v, q_pos, k_pos, B, S, H, KV, T, dh, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(amsim::with_lut(packed, smem_lut, [&](auto kind) {
    using LutT = typename decltype(kind)::T;
    constexpr bool kSmem = decltype(kind)::smem;
    auto kernel = attention_kernel<LutT, kSmem>;
    const int smem = (kSmem ? amsim::align16(lut_bytes) : 0) + amsim::kWarps * dh * 4;
    const long long rows = static_cast<long long>(B) * S * H;
    const long long work = (rows + amsim::kWarps - 1) / amsim::kWarps;
    int blocks = 0;
    cudaError_t err = amsim::grid_size(kernel, smem, work, &blocks);
    if (err != cudaSuccess) return err;
    blocks = std::min(blocks, scratch_warps / amsim::kWarps);
    kernel<<<blocks, amsim::kThreads, smem, s>>>(a, static_cast<const LutT*>(lut), out,
                                                 scratch, scratch_warps, M, lut_bytes);
    return cudaGetLastError();
  }));
}

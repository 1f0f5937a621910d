// approx_conv2d_dw: the weight gradient of the NHWC convolution, every
// product simulated by AMSim through the mantissa-product LUT, float32
// accumulate.
//   dw[ki, kj, c, o] = sum_{n, oy, ox} amsim(x[n, oy*s+ki-pt, ox*s+kj-pl, c],
//                                            g[n, oy, ox, o])
//
// Replaces the TPU kernel repro/kernels/approx_conv.py:_amconv_dw_kernel
// (launched by approx_conv2d_dw).  There a grid (kh*kw, n) carries each
// (ki, kj) slice of dw in a VMEM accumulator across the batch, which runs
// in order on one core.  Blocks of a CUDA grid run in parallel and in no
// order, so here the whole fold of one output lives inside one warp.
//
// The fold order is fixed: positions p = (n, oy, ox) row-major, strictly
// in order from +0.0f -- the TPU kernel's order at chunk=1 and the k order
// of the plain version (kernels/approx_conv.py:approx_conv2d_dw_plain, the
// im2col^T GEMM), so results are bitwise equal to both.  No atomics and no
// split-k tree: either would reorder the float32 sum.  A tap in the padding
// is skipped (it adds +0.0f, which never changes a sum that started at
// +0.0f under round-to-nearest; the reference adds amsim(+0, g) = +-0).
//
// The path gives few outputs and long folds (the resnet-mini stem: 432
// outputs of 65 536 products each), so one thread per output would leave
// most of the 132 SMs idle.  One warp owns one output: its 32 lanes compute
// 32 consecutive products in parallel, one each, and the warp folds them
// in order by broadcasting lane i's product to every lane (shuffles), so
// only the float32 adds are serial and no lane diverges.
//
// What bounds it on the H100: operations -- the lookups equal the forward
// conv's (one per in-bounds tap x C x O), each a gather plus ~20 integer
// instructions, and the in-order fold adds a shuffle and an add per product
// on every lane.  A LUT of <= 128 KiB is staged into shared memory once per
// block and blocks loop over outputs (grid-stride); larger tables are read
// from global memory.
#include "amsim.cuh"

namespace {

constexpr int kWarps = amsim::kThreads / 32;

// Advance the position (nn, oy, ox) until ox is inside the row.
__device__ __forceinline__ void wrap(int& nn, int& oy, int& ox, int oh, int ow) {
  while (ox >= ow) {
    ox -= ow;
    if (++oy == oh) {
      oy = 0;
      ++nn;
    }
  }
}

template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
approx_conv_dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const LutT* __restrict__ lut_g, float* __restrict__ out,
                      int n, int h, int wd, int c, int kh, int kw, int o, int stride,
                      int pt, int pl, int oh, int ow, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem_lut[];
  const LutT* lut = lut_g;
  if constexpr (kSmem) {
    amsim::stage_lut(smem_lut, lut_g, lut_bytes);
    lut = reinterpret_cast<const LutT*>(smem_lut);
  }
  const int lane = threadIdx.x & 31;
  const int total = kh * kw * c * o;
  const int positions = n * oh * ow;
  const int step = gridDim.x * kWarps;
  for (int t = blockIdx.x * kWarps + (threadIdx.x >> 5); t < total; t += step) {
    const int oc = t % o;
    int r = t / o;
    const int ci = r % c;
    r /= c;
    const int kj = r % kw;
    const int ki = r / kw;
    // This lane's position p0 + lane, carried as (nn, oy, ox).
    int nn = 0, oy = 0, ox = lane;
    wrap(nn, oy, ox, oh, ow);
    float acc = 0.0f;
    for (int p0 = 0; p0 < positions; p0 += 32) {
      float prod = 0.0f;
      const int iy = oy * stride + ki - pt;
      const int ix = ox * stride + kj - pl;
      if (p0 + lane < positions && iy >= 0 && iy < h && ix >= 0 && ix < wd) {
        const uint32_t xu = __float_as_uint(
            __ldg(x + ((static_cast<size_t>(nn) * h + iy) * wd + ix) * c + ci));
        const uint32_t gu =
            __float_as_uint(__ldg(g + static_cast<size_t>(p0 + lane) * o + oc));
        prod = amsim::mul<LutT, kSmem>(xu, gu, lut, M);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc = acc + __shfl_sync(0xffffffffu, prod, i);
      ox += 32;
      wrap(nn, oy, ox, oh, ow);
    }
    if (lane == 0) out[t] = acc;
  }
}

template <typename LutT, bool kSmem>
cudaError_t launch(const float* x, const float* g, const void* lut, float* out, int n, int h,
                   int wd, int c, int kh, int kw, int o, int stride, int pt, int pl, int oh,
                   int ow, int M, int lut_bytes, cudaStream_t stream) {
  auto kernel = approx_conv_dw_kernel<LutT, kSmem>;
  const int smem = kSmem ? lut_bytes : 0;
  const long long total = static_cast<long long>(kh) * kw * c * o;
  int blocks = 0;
  cudaError_t err = amsim::grid_size(kernel, smem, (total + kWarps - 1) / kWarps, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, amsim::kThreads, smem, stream>>>(x, g, static_cast<const LutT*>(lut), out, n,
                                                    h, wd, c, kh, kw, o, stride, pt, pl, oh, ow,
                                                    M, lut_bytes);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.  x is
// (n, h, wd, c), g is (n, oh, ow, o), out is (kh, kw, c, o); pads are the
// top and left ones.  The caller keeps n * oh * ow and the output count
// at most 2^30, so 32-bit indices cannot overflow.
extern "C" int approx_conv2d_dw_f32(const float* x, const float* g, const void* lut, float* out,
                                    int n, int h, int wd, int c, int kh, int kw, int o,
                                    int stride, int pt, int pl, int oh, int ow, int M, int packed,
                                    int smem_lut, int lut_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (packed) {
    err = smem_lut ? launch<uint16_t, true>(x, g, lut, out, n, h, wd, c, kh, kw, o, stride, pt,
                                            pl, oh, ow, M, lut_bytes, s)
                   : launch<uint16_t, false>(x, g, lut, out, n, h, wd, c, kh, kw, o, stride, pt,
                                             pl, oh, ow, M, lut_bytes, s);
  } else {
    err = smem_lut ? launch<uint32_t, true>(x, g, lut, out, n, h, wd, c, kh, kw, o, stride, pt,
                                            pl, oh, ow, M, lut_bytes, s)
                   : launch<uint32_t, false>(x, g, lut, out, n, h, wd, c, kh, kw, o, stride, pt,
                                             pl, oh, ow, M, lut_bytes, s);
  }
  return static_cast<int>(err);
}

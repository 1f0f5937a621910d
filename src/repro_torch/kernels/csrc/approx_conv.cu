// approx_conv2d: NHWC implicit-GEMM convolution forward, every product
// simulated by AMSim through the mantissa-product LUT, float32 accumulate.
//   out[n, oy, ox, o] = sum_{ki, kj, c} amsim(x[n, oy*s+ki-pt, ox*s+kj-pl, c],
//                                             w[ki, kj, c, o])
//
// Replaces the TPU kernel repro/kernels/approx_conv.py:_amconv_kernel
// (launched by approx_conv2d_fused).  The TPU kernel stages the whole
// padded image of one batch element in VMEM per grid point and gathers
// each tap's strided window there.  Shared memory is far smaller than
// VMEM, so this kernel stages nothing but the LUT: one thread per output
// element reads its input window straight from device memory (through L1
// and L2; the 32 threads of a warp share one or two pixels and read
// neighbouring output channels of w), and no im2col is written anywhere.
// Padding is index arithmetic, so the kernel takes every shape.
//
// What bounds it on the H100: operations, as for approx_gemm (a gather
// plus integer sign/exponent work per product, no tensor cores).  A LUT
// of <= 128 KiB is staged into shared memory once per block and blocks
// loop over outputs (grid-stride), so the table copy is paid once per
// block, not per output tile; larger tables are read from global memory.
//
// The fold runs ki, then kj, then c, from +0.0f: the chunk=1 order of the
// TPU kernel and of the (ki, kj, c) im2col columns of the plain version
// (kernels/approx_conv.py:approx_conv2d_plain), so results are bitwise
// equal to both.  A tap in the padding is skipped: the reference adds
// amsim(+0.0, w) = +-0.0 there, and adding a signed zero to a sum that
// started at +0.0 never changes it under round-to-nearest.
#include "amsim.cuh"

namespace {

template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
approx_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const LutT* __restrict__ lut_g, float* __restrict__ out,
                   int n, int h, int wd, int c, int kh, int kw, int o, int stride,
                   int pt, int pl, int oh, int ow, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem_lut[];
  const LutT* lut = lut_g;
  if constexpr (kSmem) {
    amsim::stage_lut(smem_lut, lut_g, lut_bytes);
    lut = reinterpret_cast<const LutT*>(smem_lut);
  }
  const long long total = static_cast<long long>(n) * oh * ow * o;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const int oc = static_cast<int>(t % o);
    long long p = t / o;
    const int ox = static_cast<int>(p % ow);
    p /= ow;
    const int oy = static_cast<int>(p % oh);
    const int nn = static_cast<int>(p / oh);
    float acc = 0.0f;
    for (int ki = 0; ki < kh; ++ki) {
      const int iy = oy * stride + ki - pt;
      if (iy < 0 || iy >= h) continue;
      for (int kj = 0; kj < kw; ++kj) {
        const int ix = ox * stride + kj - pl;
        if (ix < 0 || ix >= wd) continue;
        const float* xp = x + ((static_cast<size_t>(nn) * h + iy) * wd + ix) * c;
        const float* wp = w + static_cast<size_t>(ki * kw + kj) * c * o + oc;
        for (int ci = 0; ci < c; ++ci) {
          const uint32_t xu = __float_as_uint(__ldg(xp + ci));
          const uint32_t wu = __float_as_uint(__ldg(wp + static_cast<size_t>(ci) * o));
          acc = acc + amsim::mul<LutT, kSmem>(xu, wu, lut, M);
        }
      }
    }
    out[t] = acc;
  }
}

template <typename LutT, bool kSmem>
cudaError_t launch(const float* x, const float* w, const void* lut, float* out, int n, int h,
                   int wd, int c, int kh, int kw, int o, int stride, int pt, int pl, int oh,
                   int ow, int M, int lut_bytes, cudaStream_t stream) {
  auto kernel = approx_conv_kernel<LutT, kSmem>;
  const int smem = kSmem ? lut_bytes : 0;
  const long long total = static_cast<long long>(n) * oh * ow * o;
  int blocks = 0;
  cudaError_t err =
      amsim::grid_size(kernel, smem, (total + amsim::kThreads - 1) / amsim::kThreads, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, amsim::kThreads, smem, stream>>>(x, w, static_cast<const LutT*>(lut), out, n,
                                                    h, wd, c, kh, kw, o, stride, pt, pl, oh, ow,
                                                    M, lut_bytes);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.  Pads are the
// top and left ones; bottom and right follow from (oh, ow).
extern "C" int approx_conv2d_f32(const float* x, const float* w, const void* lut, float* out,
                                 int n, int h, int wd, int c, int kh, int kw, int o,
                                 int stride, int pt, int pl, int oh, int ow, int M, int packed,
                                 int smem_lut, int lut_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (packed) {
    err = smem_lut ? launch<uint16_t, true>(x, w, lut, out, n, h, wd, c, kh, kw, o, stride, pt,
                                            pl, oh, ow, M, lut_bytes, s)
                   : launch<uint16_t, false>(x, w, lut, out, n, h, wd, c, kh, kw, o, stride, pt,
                                             pl, oh, ow, M, lut_bytes, s);
  } else {
    err = smem_lut ? launch<uint32_t, true>(x, w, lut, out, n, h, wd, c, kh, kw, o, stride, pt,
                                            pl, oh, ow, M, lut_bytes, s)
                   : launch<uint32_t, false>(x, w, lut, out, n, h, wd, c, kh, kw, o, stride, pt,
                                             pl, oh, ow, M, lut_bytes, s);
  }
  return static_cast<int>(err);
}

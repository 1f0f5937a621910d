// approx_conv2d: NHWC convolution as an implicit GEMM, every product
// simulated by AMSim through the mantissa-product LUT, float32 accumulate.
//   out[n, oy, ox, o] = sum_{ki, kj, c} amsim(xd[n, oy*s+ki-pt, ox*s+kj-pl, c],
//                                             w[ki, kj, c, o])
// where xd is x with (dil - 1) zeros inserted between its rows and columns
// (XLA's lhs_dilation; dil = 1 for the forward conv, the forward stride for
// the data gradient, whose error g is then read undilated).
//
// Replaces the TPU kernel repro/kernels/approx_conv.py:_amconv_kernel
// (launched by approx_conv2d_fused).  The TPU kernel stages the whole
// padded image of one batch element in VMEM per grid point and gathers
// each tap's strided window there, and the JAX dx materialises the dilated
// error (repro/kernels/ops.py).  Here the conv is a GEMM over (positions x
// output channels), k = (ki, kj, c), with A = im2col(x) gathered on the fly.
//
// What bounds it on the H100: operations -- a gather from the table plus
// ~10 integer instructions a product (`product` of amsim_decoded.cuh, on
// operands decoded once), no tensor cores.  The design cuts what surrounds
// the gather, as the GEMM kernel (approx_gemm.cu) does:
// - A block takes a tile of BM output positions x BN output channels; each
//   thread holds a register tile of TM positions x TN = 8 channels, so a
//   decoded x word serves 8 products and a decoded w word TM.  Lanes run
//   along positions: a warp's 32 gathers meet one w word and 32 x words.
// - The table is staged swizzled: entry (ma, mb) of the canonical table
//   sits at (ma << M) | (mb ^ (ma & 31)) (packed: the 32-bit word index
//   XORed the same way), and the swizzle term is folded into the decoded
//   x word, so a product is still `ixa ^ ixb` and a gather.  Without it the
//   bank of an entry would be set by w's mantissa alone, and the 32 lanes
//   of a warp, which share w, would read one bank.
// - k runs in slabs of KB = 8 or 16 steps of one tap (or of whole taps
//   where the channels are fewer than KB): A and B of the next slab are
//   loaded into registers while one folds, then decoded into the other
//   shared buffer.  A position's input offset and window are computed once
//   a tile.
// - A table too large for shared memory is read from global memory, and
//   transposed (the host's copy), so that a warp's 32 gathers, which share
//   w, read one row of it: the warps that share the channels read the same
//   rows, and L1 holds them.
// - Taps in the padding are staged as +0.0 (their products are +-0).
//   With dil > 1 the outputs fall into dil^2 parity classes (dil / gcd(s,
//   dil) along each axis): the outputs of one class meet the real values of
//   xd at the same taps, ki = ki0, ki0 + dil, ...  A tile holds the outputs
//   of one class, so it walks only those taps and reads x densely: no
//   inserted zero is read or multiplied.
// The host picks the register tile and the warps' layout
// (approx_conv.py:conv_plan); blocks walk the tiles grid-stride, as many as
// fit on the card (amsim::grid_size).
//
// The fold runs ki, then kj, then c, strictly in order from +0.0f: the
// chunk=1 order of the TPU kernel and of the (ki, kj, c) im2col columns of
// the plain version (kernels/approx_conv.py:approx_conv2d_plain, which
// materialises the dilation), so results are bitwise equal to both.  A tap
// the kernel skips (a dead tap of a class) or stages as +0.0 (padding)
// adds amsim(+0.0, w) = +-0.0 in the reference: AMSim's zero test makes it
// so for every w, inf and NaN included, and adding a signed zero to a sum
// that started at +0.0 never changes it (the sum is never -0.0).  No
// split-k, no atomics, no fast-math.
#include <climits>

#include "amsim_decoded.cuh"

namespace {

using namespace amsim;

constexpr int kTN = 8;                 // output channels a thread
constexpr int kWarps = 8;
constexpr int kBlock = 32 * kWarps;

struct ConvArgs {
  const float* x;   // (n, h, wd, c), undilated
  const float* w;   // (kh, kw, c, o)
  const void* lut;
  float* out;       // (n, oh, ow, o)
  int n, h, wd, c, kh, kw, o, stride, dil, pt, pl, oh, ow, M, packed;
  int dp;           // parity classes along an axis: dil / gcd(stride, dil)
  int sp;           // a class's stride over x: stride / gcd(stride, dil)
};

// One axis of a parity class r: its outputs o = r + dp * q for q < q_n,
// its live taps k0, k0 + dil, ... (t_n of them), and the x index of output
// q at live tap t: q * sp + b + t.
struct Axis {
  int q_n, t_n, k0, b;
};

__host__ __device__ inline Axis class_axis(int r, int out, int k, int pad, int stride, int dil,
                                           int dp) {
  Axis a;
  a.q_n = r < out ? (out - r + dp - 1) / dp : 0;
  a.k0 = ((pad - r * stride) % dil + dil) % dil;
  a.t_n = a.k0 < k ? (k - a.k0 + dil - 1) / dil : 0;
  a.b = (r * stride + a.k0 - pad) / dil;   // exact: the numerator is a multiple of dil
  return a;
}

// The tile of a block whose threads hold TM positions x kTN channels, its
// warps WN along the channels: BM positions x BN channels, k walked in
// slabs of KB steps (16, 8 for the widest tiles: a slab's decoded A words
// stay at ~32 KiB), each thread staging LA words of A and LB of B a slab.
template <int TM, int WN>
struct Tile {
  static constexpr int BM = kWarps / WN * 32 * TM, BN = kTN * WN;
  static constexpr int KB = BM >= 256 ? 8 : 16;
  static constexpr int BMP = BM + (KB == 8 ? 2 : 1), BNP = BN + 2;
  static constexpr int ROWS = kBlock / KB;          // rows a staging pass
  static constexpr int LA = BM / ROWS, LB = (BN + ROWS - 1) / ROWS;
  static constexpr int kBufBytes = 2 * KB * (BMP + BNP) * 8 + BM * 16;
};

__host__ __device__ inline long long class_tiles(const ConvArgs& p, int cl, int bm, int bn) {
  const Axis y = class_axis(cl / p.dp, p.oh, p.kh, p.pt, p.stride, p.dil, p.dp);
  const Axis x = class_axis(cl % p.dp, p.ow, p.kw, p.pl, p.stride, p.dil, p.dp);
  const long long positions = static_cast<long long>(p.n) * y.q_n * x.q_n;
  return (positions + bm - 1) / bm * ((p.o + bn - 1) / bn);
}

__host__ __device__ inline long long tile_count(const ConvArgs& p, int bm, int bn) {
  long long tiles = 0;
  for (int cl = 0; cl < p.dp * p.dp; ++cl) tiles += class_tiles(p, cl, bm, bn);
  return tiles;
}

// The swizzle of a shared-memory table: the bits of ma XORed into mb
// (canonical, entry units) or into the 32-bit word index (packed).
__host__ __device__ inline int swizzle_mask(int kind, int M) {
  if (kind == kSmemCanon) return (1 << (M < 5 ? M : 5)) - 1;
  if (kind == kSmemPacked) return (1 << (M - 1 < 5 ? M - 1 : 5)) - 1;
  return 0;
}

// A word of x: decode_a's (sign | top-M mantissa << M, exponent - 127),
// the swizzle term (ma & smask) << shift folded into the index part.
__device__ __forceinline__ void decode_x(uint32_t u, int M, int smask, int shift, uint32_t& ix,
                                         uint32_t& ex) {
  const uint32_t e = (u >> 23) & 0xFFu;
  const uint32_t ma = (u >> (23 - M)) & ((1u << M) - 1u);
  ix = (u & 0x80000000u) | (ma << M) | ((ma & static_cast<uint32_t>(smask)) << shift);
  ex = static_cast<uint32_t>(e ? static_cast<int>(e) - 127 : kZeroExp);
}

// Stage the table of the launch, swizzled where it goes to shared memory;
// every thread of the block takes part.
template <int kKind>
__device__ Table<kKind> stage_table(const ConvArgs& p, unsigned char* smem) {
  const int entries = 1 << (2 * p.M);
  const int tid = threadIdx.x, nt = blockDim.x, M = p.M;
  const int smask = swizzle_mask(kKind, M);
  if constexpr (kKind == kSmemCanon) {
    uint32_t* t = reinterpret_cast<uint32_t*>(smem);
    auto put = [&](int i, uint32_t v) { t[i ^ ((i >> M) & smask)] = v; };
    if (p.packed) {  // expand 8 packed entries a load
      const uint16_t* s = static_cast<const uint16_t*>(p.lut);
      const uint4* s4 = static_cast<const uint4*>(p.lut);
      for (int q = tid; q < entries / 8; q += nt) {
        const uint4 v = __ldg(s4 + q);
        const uint32_t h[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          put(8 * q + 2 * j, expand(h[j] & 0xFFFFu, M));
          put(8 * q + 2 * j + 1, expand(h[j] >> 16, M));
        }
      }
      for (int i = entries / 8 * 8 + tid; i < entries; i += nt) put(i, expand(__ldg(s + i), M));
    } else {
      const uint32_t* s = static_cast<const uint32_t*>(p.lut);
      const uint4* s4 = static_cast<const uint4*>(p.lut);
      for (int q = tid; q < entries / 4; q += nt) {
        const uint4 v = __ldg(s4 + q);
        put(4 * q, v.x & 0xFFFFFFu);
        put(4 * q + 1, v.y & 0xFFFFFFu);
        put(4 * q + 2, v.z & 0xFFFFFFu);
        put(4 * q + 3, v.w & 0xFFFFFFu);
      }
      for (int i = entries / 4 * 4 + tid; i < entries; i += nt) put(i, __ldg(s + i) & 0xFFFFFFu);
    }
    __syncthreads();
    return {static_cast<uint32_t>(__cvta_generic_to_shared(smem))};
  } else if constexpr (kKind == kSmemPacked) {
    // word i holds entries 2i and 2i + 1, of one row (M >= 1)
    uint32_t* t = reinterpret_cast<uint32_t*>(smem);
    auto put = [&](int i, uint32_t v) { t[i ^ (((2 * i) >> M) & smask)] = v; };
    const int words = entries / 2;
    const uint32_t* s = static_cast<const uint32_t*>(p.lut);
    const uint4* s4 = static_cast<const uint4*>(p.lut);
    for (int q = tid; q < words / 4; q += nt) {
      const uint4 v = __ldg(s4 + q);
      put(4 * q, v.x);
      put(4 * q + 1, v.y);
      put(4 * q + 2, v.z);
      put(4 * q + 3, v.w);
    }
    for (int i = words / 4 * 4 + tid; i < words; i += nt) put(i, __ldg(s + i));
    __syncthreads();
    return {static_cast<uint32_t>(__cvta_generic_to_shared(smem))};
  } else if constexpr (kKind == kGlobalCanon) {
    return {static_cast<const uint32_t*>(p.lut)};
  } else {
    return {static_cast<const uint16_t*>(p.lut)};
  }
}

// Warp w folds positions (w / WN) * 32 * TM + lane + 32 i (i < TM) and
// channels (w % WN) * kTN + j (j < kTN) of its block's tile.  Shared memory:
// the table, then the decoded A planes [buf][kk][BMP] and B planes
// [buf][kk][BNP] (uint2 = index part, exponent; the pads keep the stores
// of a slab free of bank conflicts), then a tile's positions.  A global
// table is read transposed (the host passes it so: entry (mb, ma) at
// (mb << M) | ma), x decoded as decode_b and w as decode_a: the 32 lanes
// of a gather, which share w, then read one row of the table, and the
// warps of a block that share the channels read the same rows.  Three
// blocks an SM: registers at most 80 a thread (the compiler's own choice
// moved the step's time by 10% with edits outside the fold).
template <int TM, int WN, int kKind>
__global__ void __launch_bounds__(kBlock, 3)
conv_kernel(ConvArgs p) {
  using T = Tile<TM, WN>;
  constexpr int TN = kTN, BM = T::BM, BN = T::BN, KB = T::KB, BMP = T::BMP, BNP = T::BNP;
  constexpr bool kGlobal = kKind == kGlobalCanon || kKind == kGlobalPacked;
  constexpr int kShift = kKind == kSmemPacked ? 1 : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const Table<kKind> tab = stage_table<kKind>(p, smem);
  const int M = p.M, C = p.c, smask = swizzle_mask(kKind, M);
  uint2* As = reinterpret_cast<uint2*>(smem + table_smem_bytes(kKind, M));
  uint2* Bs = As + 2 * KB * BMP;
  // a tile's positions: x offset at tap (0, 0), first x row and column
  // (INT_MIN / 2 past the last position), output offset (-1 past the last)
  int4* pos = reinterpret_cast<int4*>(Bs + 2 * KB * BNP);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wmi = warp / WN, wni = warp % WN;
  // staging: this thread's k step of a slab, and its rows (A positions and
  // B columns srow + ROWS j)
  const int kk = tid % KB, srow = tid / KB;
  const long long tiles = tile_count(p, BM, BN);
  const int otiles = (p.o + BN - 1) / BN;
  const bool vec = p.o % 4 == 0;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    int cl = 0;
    long long rest = t;
    for (;;) {
      const long long ct = class_tiles(p, cl, BM, BN);
      if (rest < ct) break;
      rest -= ct;
      ++cl;
    }
    const int ry = cl / p.dp, rx = cl % p.dp;
    const Axis ay = class_axis(ry, p.oh, p.kh, p.pt, p.stride, p.dil, p.dp);
    const Axis ax = class_axis(rx, p.ow, p.kw, p.pl, p.stride, p.dil, p.dp);
    const int o0 = static_cast<int>(rest % otiles) * BN;
    const long long p0 = rest / otiles * BM;
    const int qhw = ay.q_n * ax.q_n;
    const long long positions = static_cast<long long>(p.n) * qhw;

    __syncthreads();  // the previous tile is done with the positions and the planes
    for (int m = tid; m < BM; m += kBlock) {
      int4 v = make_int4(0, INT_MIN / 2, INT_MIN / 2, -1);
      const long long q = p0 + m;
      if (q < positions) {
        const int nn = static_cast<int>(q / qhw), r = static_cast<int>(q % qhw);
        const int qy = r / ax.q_n, qx = r % ax.q_n;
        v.y = qy * p.sp + ay.b;
        v.z = qx * p.sp + ax.b;
        v.x = ((nn * p.h + v.y) * p.wd + v.z) * C;
        v.w = ((nn * p.oh + ry + p.dp * qy) * p.ow + rx + p.dp * qx) * p.o;
      }
      pos[m] = v;
    }
    __syncthreads();

    // The k walk: slabs of one tap and KB channels (c >= KB), or of g
    // whole taps (c < KB); (T0, C0) is a slab's first live tap and
    // channel, the same for every thread.  This thread stages k step kk of
    // each slab: live tap T0 + dt, channel C0 + dc.
    const int ntaps = ay.t_n * ax.t_n;
    const bool wide = C >= KB;
    const int g = wide ? 1 : KB / C;
    const int slabs = ntaps == 0 ? 0 : wide ? ntaps * ((C + KB - 1) / KB) : (ntaps + g - 1) / g;
    const int dt = wide ? 0 : kk / C, dc = wide ? kk : kk % C;
    int T0 = 0, C0 = 0;
    int ty = ntaps == 0 ? 0 : dt / ax.t_n, tx = ntaps == 0 ? 0 : dt % ax.t_n;   // tap T0 + dt
    auto slab_steps = [&]() { return wide ? min(KB, C - C0) : min(g, ntaps - T0) * C; };
    auto advance = [&]() {
      int d = g;
      if (wide) {
        C0 += KB;
        d = C0 >= C;
        if (d) C0 = 0;
      }
      T0 += d;
      tx += d;
      while (tx >= ax.t_n) {
        tx -= ax.t_n;
        ++ty;
      }
    };

    uint32_t ra[T::LA], rb[T::LB];
    auto load = [&](int kc) {
      const bool live = kk < kc;
      const int cc = C0 + dc;
      const int toff = (ty * p.wd + tx) * C + cc;
      const int wrow = ((ay.k0 + p.dil * ty) * p.kw + ax.k0 + p.dil * tx) * C + cc;
#pragma unroll
      for (int j = 0; j < T::LA; ++j) {
        const int4 v = pos[srow + T::ROWS * j];
        const bool ok = live && static_cast<unsigned>(v.y + ty) < static_cast<unsigned>(p.h) &&
                        static_cast<unsigned>(v.z + tx) < static_cast<unsigned>(p.wd);
        ra[j] = ok ? __float_as_uint(__ldg(p.x + (v.x + toff))) : 0u;
      }
#pragma unroll
      for (int j = 0; j < T::LB; ++j) {
        const int col = o0 + srow + T::ROWS * j;
        const bool ok = live && srow + T::ROWS * j < BN && col < p.o;
        rb[j] = ok ? __float_as_uint(__ldg(p.w + static_cast<size_t>(wrow) * p.o + col)) : 0u;
      }
    };
    auto store = [&](int buf) {
      uint2* a = As + (buf * KB + kk) * BMP + srow;
#pragma unroll
      for (int j = 0; j < T::LA; ++j) {
        uint2 v;
        if constexpr (kGlobal) {
          decode_b(ra[j], M, v.x, v.y);
        } else {
          decode_x(ra[j], M, smask, kShift, v.x, v.y);
        }
        a[T::ROWS * j] = v;
      }
      uint2* b = Bs + (buf * KB + kk) * BNP + srow;
#pragma unroll
      for (int j = 0; j < T::LB; ++j) {
        if (srow + T::ROWS * j < BN) {
          uint2 v;
          if constexpr (kGlobal) {
            decode_a(rb[j], M, v.x, v.y);
          } else {
            decode_b(rb[j], M, v.x, v.y);
          }
          b[T::ROWS * j] = v;
        }
      }
    };

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    int kc = slabs ? slab_steps() : 0;
    if (slabs) {
      load(kc);
      store(0);
      __syncthreads();
    }
    for (int s = 0; s < slabs; ++s) {
      const int buf = s & 1;
      const bool next = s + 1 < slabs;
      int kc_next = 0;
      if (next) {   // in flight while slab s folds
        advance();
        kc_next = slab_steps();
        load(kc_next);
      }
      const uint2* as = As + buf * KB * BMP + wmi * 32 * TM + lane;
      const uint4* bs = reinterpret_cast<const uint4*>(Bs + buf * KB * BNP + wni * TN);
      auto step = [&](int k) {
        uint2 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = as[k * BMP + 32 * i];
        uint32_t bi[TN], be[TN];
#pragma unroll
        for (int j = 0; j < TN / 2; ++j) {
          const uint4 v = bs[k * (BNP / 2) + j];
          bi[2 * j] = v.x;
          be[2 * j] = v.y;
          bi[2 * j + 1] = v.z;
          be[2 * j + 1] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = acc[i][j] + product(a[i].x, a[i].y, bi[j], be[j], tab, M);
      };
      if (kc == KB) {
#pragma unroll
        for (int k = 0; k < KB; ++k) step(k);
      } else {
        for (int k = 0; k < kc; ++k) step(k);
      }
      if (next) store(buf ^ 1);
      __syncthreads();
      kc = kc_next;
    }

    const int ob = o0 + wni * TN;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int off = pos[wmi * 32 * TM + lane + 32 * i].w;
      if (off < 0) continue;
      float* dst = p.out + off + ob;
      if (vec && ob + TN <= p.o) {
#pragma unroll
        for (int j = 0; j < TN; j += 4)
          *reinterpret_cast<float4*>(dst + j) =
              make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (ob + j < p.o) dst[j] = acc[i][j];
      }
    }
  }
}

int gcd_of(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// f(kernel, shared bytes, BM, BN) of the plan: `tm` positions a thread
// (1, 2), `wn` warps along the channels (1, 2, 4, 8; 2, 4, 8 where tm = 2).
template <int kKind, class F>
cudaError_t with_tile(int M, int tm, int wn, F&& f) {
  auto run = [&](auto kernel, auto tile) {
    using T = decltype(tile);
    return f(kernel, table_smem_bytes(kKind, M) + T::kBufBytes, T::BM, T::BN);
  };
  if (tm == 1 && wn == 1) return run(conv_kernel<1, 1, kKind>, Tile<1, 1>{});
  if (tm == 1 && wn == 2) return run(conv_kernel<1, 2, kKind>, Tile<1, 2>{});
  if (tm == 1 && wn == 4) return run(conv_kernel<1, 4, kKind>, Tile<1, 4>{});
  if (tm == 1 && wn == 8) return run(conv_kernel<1, 8, kKind>, Tile<1, 8>{});
  if (tm == 2 && wn == 2) return run(conv_kernel<2, 2, kKind>, Tile<2, 2>{});
  if (tm == 2 && wn == 4) return run(conv_kernel<2, 4, kKind>, Tile<2, 4>{});
  if (tm == 2 && wn == 8) return run(conv_kernel<2, 8, kKind>, Tile<2, 8>{});
  return cudaErrorInvalidValue;
}

template <class F>
cudaError_t with_plan(int M, int packed, int table, int tm, int tn, int wn, F&& f) {
  if (M < 1 || M > 12 || tn != kTN) return cudaErrorInvalidValue;
  switch (table) {
    case kSmemCanon: return with_tile<kSmemCanon>(M, tm, wn, f);
    case kSmemPacked:
      return packed ? with_tile<kSmemPacked>(M, tm, wn, f) : cudaErrorInvalidValue;
    case kGlobalCanon:
      return packed ? cudaErrorInvalidValue : with_tile<kGlobalCanon>(M, tm, wn, f);
    case kGlobalPacked:
      return packed ? with_tile<kGlobalPacked>(M, tm, wn, f) : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

ConvArgs make_args(const float* x, const float* w, const void* lut, float* out, int n, int h,
                   int wd, int c, int kh, int kw, int o, int stride, int dil, int pt, int pl,
                   int oh, int ow, int M, int packed) {
  const int g = gcd_of(stride, dil);
  return ConvArgs{x,  w,  lut, out, n,  h, wd,     c,       kh,        kw, o, stride,
                  dil, pt, pl, oh, ow, M, packed, dil / g, stride / g};
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.  x is the
// undilated input (n, h, wd, c), `dil` its dilation (>= 1), out is (n, oh,
// ow, o); pads are the top and left ones of the dilated input.  `packed`
// says the LUT holds uint16 entries; `table` (TableKind), `tile_m`,
// `tile_n` and `warps_n` are the plan of approx_conv.py:conv_plan.  The
// caller keeps every tensor under 2^31 elements.
extern "C" int approx_conv2d_f32(const float* x, const float* w, const void* lut, float* out,
                                 int n, int h, int wd, int c, int kh, int kw, int o, int stride,
                                 int dil, int pt, int pl, int oh, int ow, int M, int packed,
                                 int table, int tile_m, int tile_n, int warps_n, void* stream) {
  const ConvArgs args =
      make_args(x, w, lut, out, n, h, wd, c, kh, kw, o, stride, dil, pt, pl, oh, ow, M, packed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_plan(
      M, packed, table, tile_m, tile_n, warps_n, [&](auto kernel, int smem, int bm, int bn) {
        int blocks = 0;
        const cudaError_t err =
            amsim::grid_size(kernel, smem, tile_count(args, bm, bn), &blocks, kBlock);
        if (err != cudaSuccess) return err;
        if (blocks == 0) return cudaSuccess;
        kernel<<<blocks, kBlock, smem, s>>>(args);
        return cudaGetLastError();
      }));
}

// The grid a launch of this plan and shape takes, without launching:
// out = {blocks, tiles, shared bytes a block}.
extern "C" int approx_conv_grid(int n, int h, int wd, int c, int kh, int kw, int o, int stride,
                                int dil, int pt, int pl, int oh, int ow, int M, int packed,
                                int table, int tile_m, int tile_n, int warps_n, long long* out,
                                void*) {
  const ConvArgs args = make_args(nullptr, nullptr, nullptr, nullptr, n, h, wd, c, kh, kw, o,
                                  stride, dil, pt, pl, oh, ow, M, packed);
  return static_cast<int>(with_plan(
      M, packed, table, tile_m, tile_n, warps_n, [&](auto kernel, int smem, int bm, int bn) {
        int blocks = 0;
        out[1] = tile_count(args, bm, bn);
        out[2] = smem;
        const cudaError_t err = amsim::grid_size(kernel, smem, out[1], &blocks, kBlock);
        out[0] = blocks;
        return err;
      }));
}

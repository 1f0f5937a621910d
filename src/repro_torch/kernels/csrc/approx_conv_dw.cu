// approx_conv2d_dw: the weight gradient of the NHWC convolution, every
// product simulated by AMSim through the mantissa-product LUT, float32
// accumulate.
//   dw[ki, kj, c, o] = sum_{n, oy, ox} amsim(x[n, oy*s+ki-pt, ox*s+kj-pl, c],
//                                            g[n, oy, ox, o])
//
// Replaces the TPU kernel repro/kernels/approx_conv.py:_amconv_dw_kernel
// (launched by approx_conv2d_dw).  There a grid (kh*kw, n) carries each
// (ki, kj) slice of dw in a VMEM accumulator across the batch, which runs
// in order on one core, each step a `patch^T @ g` GEMM.  Here it is one
// GEMM too: rows (ki, kj, c), columns o, the contraction over the
// positions p = (n, oy, ox).  A is im2col(x)^T, gathered on the fly (at one
// tap a position's channels are contiguous in NHWC), B is g (a position's
// o values are contiguous).
//
// The fold order is fixed: positions row-major, strictly in order from
// +0.0f -- the TPU kernel's order at chunk=1 and the k order of the plain
// version (kernels/approx_conv.py:approx_conv2d_dw_plain, the im2col^T
// GEMM), so results are bitwise equal to both.  No atomics, no split-k and
// no shuffle tree: each output's sum is one chain of float adds, made by
// one owner thread.  A tap in the padding, or a position past the last,
// is staged as +0.0: its product is +-0 by AMSim's zero test whatever g
// holds (inf and NaN included), and adding +-0 never changes a sum that
// started at +0.0 under round-to-nearest (it is never -0.0), so the sums
// are those of the reference, which adds amsim(+0, g).
//
// What bounds it on the H100: operations -- one lookup a product (the
// forward conv's count), a gather plus ~10 integer instructions (`product`
// of amsim_decoded.cuh, shared with the GEMM kernel).  And, where outputs
// are few and folds long, the chain itself: each sum is P dependent FADDs
// of ~4 clocks (0.13 ms at P = 65536), and no fold order that keeps the
// bits is shorter.  Few outputs also mean little reuse: a tile of TC x TO
// outputs stages 1/TO + 1/TC words a product, so staging and shared-memory
// traffic, not lookups, are what the measured design spends (PERF.md).
//
// A block takes an output tile: one tap (ki, kj), TC channels and TO output
// channels, U = TC * TO outputs.  It walks the positions in chunks of KC,
// staging x at its tap for its channels and g for its columns (16 bytes a
// copy where o % 4 == 0), one block barrier a chunk.  The host picks the
// tile (approx_conv.py:dw_plan):
// - tiled path (U = 256, the block's threads; where the outputs fill such
//   a tile on every SM): each thread owns one output and folds its
//   products straight into its register accumulator; each staged word
//   meets 8-32 products, so the next chunk is loaded into registers while
//   one is folded and stored decoded (amsim_decoded.cuh), double-buffered;
// - split path (U = 8, 16 or 32: the other shapes -- few outputs, long
//   folds): the chunks come into a ring of kStages stages by cp.async, raw
//   (a word meets few products, so it is decoded where it is used); 256
//   threads compute a chunk's products (256 / U threads an output, each an
//   independent lookup) into shared memory, and a warp of owners of its own
//   (32 more threads) adds each output's products in position order, one
//   chunk behind (the split of decode_chain.cu's fold_cols).
// A position's (n, oy, ox) is divided out once a kernel and then advanced
// by KC a chunk with two carries, so staging x costs no division.  The grid
// is as many blocks as fit on the card (amsim::grid_size), no more than
// the tiles, which the blocks walk grid-stride.
#include "amsim_decoded.cuh"

namespace {

using namespace amsim;

constexpr int kMaxCols = 64;   // TO: output channels a tile, 8 .. 64
constexpr int kStages = 3;     // ring stages: chunks of raw x and g words copied or in flight

// Positions a chunk for a tile of U outputs (8, 16, 32: split; 256:
// tiled).
__host__ __device__ constexpr int chunk_positions(int U) { return U >= kThreads ? 32 : 128; }

struct DwArgs {
  const float* x;   // (n, h, w, c)
  const float* g;   // (n, oh, ow, o)
  const void* lut;
  float* out;       // (kh, kw, c, o)
  int n, h, w, c, kh, kw, o, stride, pt, pl, oh, ow, M, packed;
  int tc, to, lg_tc, lg_to;   // the tile: TC channels x TO output channels
  int g_quads;                // g is read 16 bytes at a time: o % 4 == 0, g 16-byte aligned
};

__host__ __device__ inline long long tile_count(int kh, int kw, int c, int o, int tc, int to) {
  return static_cast<long long>(kh) * kw * ((c + tc - 1) / tc) * ((o + to - 1) / to);
}

// A split tile (at most 32 outputs) gets a warp of owners of its own, in
// front of the 256 threads that stage and multiply: its adds are the
// chunk's longest chain.
__host__ __device__ constexpr int block_threads(int U) {
  return kThreads + (U < kThreads ? 32 : 0);
}

// A block's shared memory: the table, then on the split path the raw x
// and g words of kStages chunks and the products of two chunks, on the
// tiled path the decoded x and g words of two chunks.
__host__ __device__ inline int dw_smem_bytes(int kind, int M, int U, int tc, int to) {
  const int kc = chunk_positions(U);
  return table_smem_bytes(kind, M) + (U < kThreads ? kStages * kc * (tc + to) * 4 + 2 * kc * U * 4
                                                   : 2 * kc * (tc + to) * 8);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

template <int U, int kKind>
__global__ void __launch_bounds__(block_threads(U))
dw_kernel(DwArgs p) {
  constexpr bool kSplit = U < kThreads;
  constexpr int KC = chunk_positions(U);
  constexpr int kLead = kSplit ? 32 : 0;                  // the owner warp, if any
  constexpr int kThreadsAnOutput = kSplit ? kThreads / U : 1;
  constexpr int kProds = KC / kThreadsAnOutput;            // products a worker a chunk
  constexpr int kGroup = kProds < 8 ? kProds : 8;          // products loaded, then looked up
  constexpr int kAdds = 16;                                // owner: products loaded at once
  constexpr int kXSlots = (KC * (U / 8) + kThreads - 1) / kThreads;   // TC <= U / 8
  constexpr int kGSlots = (KC * (U < kMaxCols ? U : kMaxCols) / 4 + kThreads - 1) / kThreads;
  static_assert(U == 8 || U == 16 || U == 32 || U == kThreads, "U: 8, 16, 32 or 256");
  static_assert(KC % kAdds == 0 && kProds % kGroup == 0, "whole groups of products and adds");

  extern __shared__ __align__(16) unsigned char smem[];
  const Table<kKind> tab = make_table<kKind>(p, smem);
  const int tc = p.tc, to = p.to;
  unsigned char* buf = smem + table_smem_bytes(kKind, p.M);
  // split: the ring, a chunk's x words then its g words a stage; tiled: the
  // decoded planes of two chunks, x then g.
  uint32_t* ring = reinterpret_cast<uint32_t*>(buf);
  const int stage_words = KC * (tc + to);
  float* prod = reinterpret_cast<float*>(ring + kStages * stage_words);
  uint2* xa = reinterpret_cast<uint2*>(buf);
  uint2* gb = xa + 2 * KC * tc;
  const int tid = threadIdx.x;
  const int w = tid - kLead;   // this thread's worker index, < 0 in the owner warp
  const int hw = p.oh * p.ow;
  const long long positions = static_cast<long long>(p.n) * hw;
  const int nchunks = static_cast<int>((positions + KC - 1) / KC);
  // KC positions = step_n images + step_y rows + step_x columns.
  const int step_n = KC / hw, step_y = KC % hw / p.ow, step_x = KC % hw % p.ow;

  // A worker's products: output u of the tile (channel pc, column po) at
  // the positions q, q + kThreadsAnOutput, ..  The owner of output u is
  // thread u: in the owner warp on the split path; on the tiled path each
  // thread owns the output it multiplies.
  const int u = w & (U - 1);
  const int q = w / U;
  const int pc = u >> p.lg_to, po = u & (to - 1);
  const int own = tid < U ? tid : -1;   // the output this thread adds, if any
  const int oc = own >> p.lg_to, oo_own = own & (to - 1);

  // The x words this worker stages: word e = w + s * kThreads of a chunk,
  // position e / TC, channel e % TC; (n, oy, ox) of its position in chunk 0.
  int x_n0[kXSlots], x_y0[kXSlots], x_x0[kXSlots];
#pragma unroll
  for (int s = 0; s < kXSlots; ++s) {
    const int pl = max(w + s * kThreads, 0) >> p.lg_tc;
    x_n0[s] = pl / hw;
    x_y0[s] = pl % hw / p.ow;
    x_x0[s] = pl % hw % p.ow;
  }

  const long long tiles = tile_count(p.kh, p.kw, p.c, p.o, tc, to);
  const int ctiles = (p.c + tc - 1) / tc, otiles = (p.o + to - 1) / to;
  const int lg_quads = p.lg_to - 2;   // g is staged 4 words (16 bytes) at a time
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int o0 = static_cast<int>(t % otiles) * to;
    const long long rest = t / otiles;
    const int c0 = static_cast<int>(rest % ctiles) * tc;
    const int tap = static_cast<int>(rest / ctiles);
    const int ki = tap / p.kw, kj = tap % p.kw;
    // (n, oy, ox) of the x words of the next chunk to be staged.
    int xn[kXSlots], xy[kXSlots], xx[kXSlots];
#pragma unroll
    for (int s = 0; s < kXSlots; ++s) {
      xn[s] = x_n0[s];
      xy[s] = x_y0[s];
      xx[s] = x_x0[s];
    }
    // The source of x word slot s of the next chunk (ok: inside the image
    // and the channels, else +0.0); then the slot moves on a chunk.
    auto x_word = [&](int s, bool& ok) {
      const int e = w + s * kThreads;
      const int cc = c0 + (e & (tc - 1));
      const int iy = xy[s] * p.stride + ki - p.pt, ix = xx[s] * p.stride + kj - p.pl;
      ok = w >= 0 && e < KC * tc && xn[s] < p.n && cc < p.c && iy >= 0 && iy < p.h && ix >= 0 &&
           ix < p.w;
      const float* src =
          ok ? p.x + ((static_cast<size_t>(xn[s]) * p.h + iy) * p.w + ix) * p.c + cc : p.x;
      xx[s] += step_x;
      if (xx[s] >= p.ow) {
        xx[s] -= p.ow;
        ++xy[s];
      }
      xy[s] += step_y;
      if (xy[s] >= p.oh) {
        xy[s] -= p.oh;
        ++xn[s];
      }
      xn[s] += step_n;
      return src;
    };
    // The source of g quad slot s of chunk `chunk`: words 4e .. 4e + 3 of
    // the chunk, 4 columns of one position; `in`: the position exists.
    auto g_quad = [&](int chunk, int s, bool& in, int& oo) {
      const int e = w + s * kThreads;
      const long long pos = static_cast<long long>(chunk) * KC + (e >> lg_quads);
      oo = o0 + ((e << 2) & (to - 1));
      in = w >= 0 && e < KC * to / 4 && pos < positions;
      return p.g + pos * p.o + oo;
    };
    float acc = 0.0f;
    __syncthreads();  // the previous tile is done with every buffer

    if constexpr (kSplit) {
      // Copy chunk `chunk` (the next one, in order) into its ring stage.  One
      // commit group a call, empty past the last chunk or in the owner warp.
      auto issue = [&](int chunk) {
        if (w >= 0 && chunk < nchunks) {
          uint32_t* xr = ring + (chunk % kStages) * stage_words;
          uint32_t* gr = xr + KC * tc;
#pragma unroll
          for (int s = 0; s < kXSlots; ++s) {
            bool ok;
            const float* src = x_word(s, ok);
            if (w + s * kThreads < KC * tc) cp_async(xr + w + s * kThreads, src, 4, ok);
          }
#pragma unroll
          for (int s = 0; s < kGSlots; ++s) {
            bool in;
            int oo;
            const float* src = g_quad(chunk, s, in, oo);
            uint32_t* dst = gr + 4 * (w + s * kThreads);
            if (w + s * kThreads >= KC * to / 4) continue;
            if (p.g_quads) {   // 4 columns in or out of range together, 16-byte aligned
              cp_async(dst, in && oo < p.o ? src : p.g, 16, in && oo < p.o);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const bool ok = in && oo + j < p.o;
                cp_async(dst + j, ok ? src + j : p.g, 4, ok);
              }
            }
          }
        }
        cp_async_commit();
      };
      for (int c = 0; c < kStages - 1; ++c) issue(c);
      for (int i = 0; i <= nchunks; ++i) {
        cp_async_wait<kStages - 2>();   // this thread's words of chunk i landed
        __syncthreads();  // everyone's words of chunk i; chunk i - 1 read, its products stored
        issue(i + kStages - 1);         // into the stage chunk i - 1 left
        if (w >= 0 && i < nchunks) {
          // The products of chunk i, operands decoded on the way: each word
          // meets few products here.  Operands first, then the lookups, then
          // the stores, so that no store orders a later load.
          const uint32_t* xs = ring + (i % kStages) * stage_words + pc;
          const uint32_t* gs = ring + (i % kStages) * stage_words + KC * tc + po;
          float* ps = prod + (i & 1) * KC * U + u;
#pragma unroll
          for (int s0 = 0; s0 < kProds; s0 += kGroup) {
            uint32_t a[kGroup], b[kGroup];
#pragma unroll
            for (int s = 0; s < kGroup; ++s) {
              const int pl = q + (s0 + s) * kThreadsAnOutput;
              a[s] = xs[pl * tc];
              b[s] = gs[pl * to];
            }
            float v[kGroup];
#pragma unroll
            for (int s = 0; s < kGroup; ++s) {
              uint32_t ia, ea, ib, eb;
              decode_a(a[s], p.M, ia, ea);
              decode_b(b[s], p.M, ib, eb);
              v[s] = product(ia, ea, ib, eb, tab, p.M);
            }
#pragma unroll
            for (int s = 0; s < kGroup; ++s) ps[(q + (s0 + s) * kThreadsAnOutput) * U] = v[s];
          }
        }
        if (i >= 1 && own >= 0) {   // the owner: chunk i - 1's products in order
          const float* ps = prod + ((i - 1) & 1) * KC * U + own;
          float v[2][kAdds];   // the next group loads while one is added
#pragma unroll
          for (int s = 0; s < kAdds; ++s) v[0][s] = ps[s * U];
#pragma unroll
          for (int g = 0; g < KC / kAdds; ++g) {
            if (g + 1 < KC / kAdds) {
#pragma unroll
              for (int s = 0; s < kAdds; ++s) v[(g + 1) & 1][s] = ps[((g + 1) * kAdds + s) * U];
            }
#pragma unroll
            for (int s = 0; s < kAdds; ++s) acc = acc + v[g & 1][s];
          }
        }
      }
    } else {
      // Load chunk `chunk` (the next one) into registers, then decode it
      // into planes `plane`: each word meets TC or TO products here.
      uint32_t rx[kXSlots];
      uint4 rg[kGSlots];
      auto load = [&](int chunk) {
#pragma unroll
        for (int s = 0; s < kXSlots; ++s) {
          bool ok;
          const float* src = x_word(s, ok);
          rx[s] = ok ? __float_as_uint(__ldg(src)) : 0u;
        }
#pragma unroll
        for (int s = 0; s < kGSlots; ++s) {
          bool in;
          int oo;
          const float* src = g_quad(chunk, s, in, oo);
          if (in && p.g_quads) {
            rg[s] = oo < p.o ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
          } else {
            uint32_t v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              v[j] = in && oo + j < p.o ? __float_as_uint(__ldg(src + j)) : 0u;
            }
            rg[s] = make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
      };
      auto store = [&](int plane) {
#pragma unroll
        for (int s = 0; s < kXSlots; ++s) {
          const int e = w + s * kThreads;
          if (e < KC * tc) {
            uint2 v;
            decode_a(rx[s], p.M, v.x, v.y);
            xa[plane * KC * tc + e] = v;
          }
        }
#pragma unroll
        for (int s = 0; s < kGSlots; ++s) {
          const int e = w + s * kThreads;
          if (e < KC * to / 4) {
            uint4 v0, v1;
            decode_b(rg[s].x, p.M, v0.x, v0.y);
            decode_b(rg[s].y, p.M, v0.z, v0.w);
            decode_b(rg[s].z, p.M, v1.x, v1.y);
            decode_b(rg[s].w, p.M, v1.z, v1.w);
            uint4* dst = reinterpret_cast<uint4*>(gb + plane * KC * to + 4 * e);
            dst[0] = v0;
            dst[1] = v1;
          }
        }
      };
      load(0);
      store(0);
      for (int i = 0; i < nchunks; ++i) {
        __syncthreads();  // chunk i stored; chunk i - 1's planes read
        const bool next = i + 1 < nchunks;
        if (next) load(i + 1);   // in flight while chunk i is folded
        const uint2* xs = xa + (i & 1) * KC * tc + pc;
        const uint2* gs = gb + (i & 1) * KC * to + po;
#pragma unroll
        for (int s0 = 0; s0 < KC; s0 += 8) {
          uint2 a[8], b[8];
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            a[s] = xs[(s0 + s) * tc];
            b[s] = gs[(s0 + s) * to];
          }
#pragma unroll
          for (int s = 0; s < 8; ++s) acc = acc + product(a[s].x, a[s].y, b[s].x, b[s].y, tab, p.M);
        }
        if (next) store((i + 1) & 1);
      }
    }
    if (own >= 0 && c0 + oc < p.c && o0 + oo_own < p.o) {
      p.out[(static_cast<size_t>(tap) * p.c + c0 + oc) * p.o + o0 + oo_own] = acc;
    }
  }
  cp_async_wait<0>();
}

// f(kernel, block threads, shared bytes) of the tile U = tc * to for the
// table form `table` (TableKind), which must suit the stored layout
// (`packed`: uint16 entries).
template <int kKind, class F>
cudaError_t with_tile(int M, int tc, int to, F&& f) {
  const int smem = dw_smem_bytes(kKind, M, tc * to, tc, to);
  switch (tc * to) {
    case 8: return f(dw_kernel<8, kKind>, block_threads(8), smem);
    case 16: return f(dw_kernel<16, kKind>, block_threads(16), smem);
    case 32: return f(dw_kernel<32, kKind>, block_threads(32), smem);
    case 256: return f(dw_kernel<256, kKind>, block_threads(256), smem);
    default: return cudaErrorInvalidValue;
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

template <class F>
cudaError_t with_plan(int M, int packed, int table, int tc, int to, F&& f) {
  if (M < 1 || M > 12 || log2_exact(tc) < 0 || log2_exact(to) < 0 || to < 8 || to > kMaxCols) {
    return cudaErrorInvalidValue;
  }
  switch (table) {
    case kSmemCanon: return with_tile<kSmemCanon>(M, tc, to, f);
    case kSmemPacked:
      return packed ? with_tile<kSmemPacked>(M, tc, to, f) : cudaErrorInvalidValue;
    case kGlobalCanon:
      return packed ? cudaErrorInvalidValue : with_tile<kGlobalCanon>(M, tc, to, f);
    case kGlobalPacked:
      return packed ? with_tile<kGlobalPacked>(M, tc, to, f) : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.  x is
// (n, h, wd, c), g is (n, oh, ow, o), out is (kh, kw, c, o); pads are the
// top and left ones.  `packed` says the LUT holds uint16 entries; `table`
// (TableKind), `tile_c` and `tile_o` are the plan of approx_conv.py:dw_plan.
// The caller keeps n * oh * ow and the output count at most 2^30.
extern "C" int approx_conv2d_dw_f32(const float* x, const float* g, const void* lut, float* out,
                                    int n, int h, int wd, int c, int kh, int kw, int o,
                                    int stride, int pt, int pl, int oh, int ow, int M, int packed,
                                    int table, int tile_c, int tile_o, void* stream) {
  const DwArgs args{x,  g,  lut, out, n,  h,      wd,     c,
                    kh, kw, o,   stride, pt, pl, oh, ow, M, packed,
                    tile_c, tile_o, log2_exact(tile_c), log2_exact(tile_o),
                    o % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      with_plan(M, packed, table, tile_c, tile_o, [&](auto kernel, int threads, int smem) {
        int blocks = 0;
        const cudaError_t err = amsim::grid_size(
            kernel, smem, tile_count(kh, kw, c, o, tile_c, tile_o), &blocks, threads);
        if (err != cudaSuccess) return err;
        kernel<<<blocks, threads, smem, s>>>(args);
        return cudaGetLastError();
      }));
}

// The grid a launch of this plan and shape takes, without launching:
// out = {blocks, tiles, shared bytes a block}.
extern "C" int approx_conv_dw_grid(int kh, int kw, int c, int o, int M, int packed, int table,
                                   int tile_c, int tile_o, long long* out, void*) {
  return static_cast<int>(
      with_plan(M, packed, table, tile_c, tile_o, [&](auto kernel, int threads, int smem) {
        int blocks = 0;
        out[1] = tile_count(kh, kw, c, o, tile_c, tile_o);
        out[2] = smem;
        const cudaError_t err = amsim::grid_size(kernel, smem, out[1], &blocks, threads);
        out[0] = blocks;
        return err;
      }));
}

// The decode chain: one transformer layer of a decode step in two or
// three launches (dense) or four (MoE), every GEMM product simulated by
// AMSim.
//
//   fused_qkv_norm      h = rmsnorm(x; g1); q, k, v = h@wq, h@wk, h@wv
//   fused_out_mlp       x1 = x + attn@wo (+bo); h = rmsnorm(x1; g2);
//                       out = x1 + (silu(h@wg) * (h@wu))@wd (+bd)
//   fused_attn_out_mlp  the attention core of the step (attention.cuh),
//                       then fused_out_mlp's phases
//   fused_wo_norm       x1 = x + attn@wo (+bo); h = rmsnorm(x1; g2): the
//                       MoE back half's prefix, x1 and h both written out
//   fused_moe_ffn       for every expert e of the stacked banks:
//                       out[e] = (silu(h[e]@wg[e]) * (h[e]@wu[e]))@wd[e]
//
// Replace the TPU kernels repro/kernels/decode_chain.py:_qkv_kernel,
// _out_mlp_kernel, _attn_out_mlp_kernel, _wo_norm_kernel and
// _moe_ffn_kernel.  There a sequential grid streams weight blocks through
// VMEM and carries the accumulators from step to step.  Here the phases
// that need all of a row (the norms, the FFN after the gate/up columns,
// the down projection after the wo columns) are separated by grid-wide
// barriers of a cooperative launch (cooperative_groups::this_grid().sync(),
// grid sized from occupancy so every block is resident).  fused_qkv_norm
// needs no barrier: each block computes the norm scale of every row
// itself.  fused_wo_norm has one barrier between the wo columns and the
// norm, then one block a row writes h; fused_moe_ffn one between the
// gate/up columns of every expert (into an (E, C, F) scratch) and the down
// projection.
//
// What bounds it on the H100.  x has `rows` = batch rows, so each weight
// element is read once per launch and meets `rows` LUT lookups: the bytes
// bound is the weight stream, but at a few rows the ~20 integer
// instructions of a lookup (amsim::mul) cost more than the bytes, and what
// a design has to buy is SMs kept busy and weight loads kept out of the
// lookups' way.
//
// fused_qkv_norm, fused_wo_norm and fused_moe_ffn fold with fold_tile: each
// thread owns one output column and the accumulators of up to kRows rows,
// the block stages the activations a k-tile at a time in shared memory,
// and consecutive threads read consecutive weight columns.  The expert
// banks hold C capacity rows an expert; blocks walk (expert, row group of
// kRows, column tile) work items, so C > kRows re-reads the expert's
// weights once a row group (from L2 when the group's items run together).
//
// fused_out_mlp and fused_attn_out_mlp fold with fold_cols, which splits
// each output's products from its adds.  A work item is a row group and a
// narrow tile of CT columns (32 for the gate/up columns, 8 for wo and wd,
// whose n = d is 4x smaller), so every phase has hundreds of items and the
// cooperative grid fills every SM (granite-3-2b at 4 rows: 256 items a
// phase, 2 blocks a SM).  The item's weight columns come into shared
// memory a k-chunk at a time by cp.async, in a ring of kStages chunks, so
// the next chunks are in flight while one is folded.  All 256 threads
// compute a chunk's products (each an independent lookup) into shared
// memory; the thread that owns an output then adds its chunk's products in
// k order, one chunk behind.  The tile and chunk sizes were chosen by
// timing on the H100 (PERF.md).
// The LUT sits in shared memory when it is <= 128 KiB.
//
// Every output folds its products in contraction order from +0.0 (the
// order of kernels/ref.py:ref_amsim_gemm), the rmsnorm sum of squares runs
// in the lane_sum order and the elementwise steps are the float32
// operations of kernels/decode_chain.py's plain versions, written with
// _rn intrinsics so that nothing is contracted into an FMA; so each launch
// is bitwise equal to its plain version.
#include <algorithm>

#include <cooperative_groups.h>

#include "attention.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;    // rows a thread accumulates at once
constexpr int kKT = 128;    // contraction values staged per tile
// fold_cols: weight floats a k-chunk stages (k steps x CT columns of one
// matrix, or of two side by side), and the depth of the cp.async ring.
constexpr int kChunk = 1024;
constexpr int kStages = 3;
constexpr int kWideCols = 32;    // gate/up column tile: one 128-byte segment a weight row
constexpr int kNarrowCols = 8;   // wo and wd column tile: one 32-byte sector

// Shared memory after the LUT: the activation tile, the norm scales, and
// (attention phase) a q row per warp.
constexpr int kTileBytes = kRows * kKT * 4;
constexpr int kRinvBytes = kRows * 4;

struct Chain {
  const float* x;      // (rows, d) residual stream
  const float* attn;   // (rows, K) attention output (written in-launch by fused_attn_out_mlp)
  const float* g;      // (d,) norm scale
  const float* wo;     // (K, d)
  const float* wg;     // (d, F)
  const float* wu;     // (d, F)
  const float* wd;     // (F, d)
  const float* bo;     // (d,) or null
  const float* bd;     // (d,) or null
  float* out;          // (rows, d)
  float* x1;           // (rows, d) scratch
  float* act;          // (rows, F) scratch
  int rows, d, K, F;
  float eps;
};

__device__ __forceinline__ float silu(float g) {
  return __fdiv_rn(g, __fadd_rn(1.0f, expf(-g)));
}

// rinv[r] = rsqrt(lane_sum(x*x) / d + eps) for rows r0 .. r0 + nr of the
// (rows, d) array src; one warp a row.  Ends with a block barrier.
__device__ void row_rinv(const float* src, int d, int r0, int nr, float eps, float* rinv) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < nr; r += amsim::kWarps) {
    const float* row = src + static_cast<size_t>(r0 + r) * d;
    float ss = 0.0f;
    for (int k = lane; k < d; k += 32) {
      const float v = row[k];
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
    ss = amsim::warp_sum(ss);
    if (lane == 0) rinv[r] = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(d)), eps));
  }
  __syncthreads();
}

// For rows r0 .. r0 + nr (nr <= kRows) and the columns j = c0 ..
// c0 + kThreads of the (kdim, n) weights w1 (and w2 when kDual):
// acc[r] = sum_k amsim(A(r, k), w[k, j]), k in order from +0.0, then
// epi(r, j, acc1[r], acc2[r]).  stage(r, k) gives A(r, k); the block
// stages it a tile at a time.  Every thread of the block calls it.
template <typename LutT, bool kSmem, bool kDual, typename Stage, typename Epi>
__device__ void fold_tile(int c0, int n, int kdim, int nr, const float* w1, const float* w2,
                          Stage stage, Epi epi, const LutT* lut, int M, float* tile) {
  const int j = c0 + threadIdx.x;
  const bool active = j < n;
  float acc1[kRows], acc2[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc1[r] = acc2[r] = 0.0f;
  for (int k0 = 0; k0 < kdim; k0 += kKT) {
    const int kt = min(kKT, kdim - k0);
    for (int i = threadIdx.x; i < nr * kKT; i += amsim::kThreads) {
      const int r = i / kKT;
      const int kk = i % kKT;
      tile[i] = kk < kt ? stage(r, k0 + kk) : 0.0f;
    }
    __syncthreads();
    if (active) {
      for (int kk = 0; kk < kt; ++kk) {
        const size_t widx = static_cast<size_t>(k0 + kk) * n + j;
        const uint32_t u1 = __float_as_uint(w1[widx]);
        const uint32_t u2 = kDual ? __float_as_uint(w2[widx]) : 0u;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nr) {
            const uint32_t hv = __float_as_uint(tile[r * kKT + kk]);
            acc1[r] = acc1[r] + amsim::mul<LutT, kSmem>(hv, u1, lut, M);
            if (kDual) acc2[r] = acc2[r] + amsim::mul<LutT, kSmem>(hv, u2, lut, M);
          }
        }
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nr) epi(r, j, acc1[r], acc2[r]);
    }
  }
}

// fold_tile over every column tile, blocks striding over the tiles.
template <typename LutT, bool kSmem, bool kDual, typename Stage, typename Epi>
__device__ void column_fold(int n, int kdim, int nr, const float* w1, const float* w2,
                            Stage stage, Epi epi, const LutT* lut, int M, float* tile) {
  for (int c0 = blockIdx.x * amsim::kThreads; c0 < n; c0 += gridDim.x * amsim::kThreads) {
    fold_tile<LutT, kSmem, kDual>(c0, n, kdim, nr, w1, w2, stage, epi, lut, M, tile);
  }
}

// 4 bytes from global to shared memory, asynchronously; zeros when !full.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// fold_cols's shared memory: the weight ring, the activations of a chunk
// and its products, both double-buffered; products of up to `nrmax` rows.
// A matrix's chunk of KCN = kChunk / (1 + kDual) floats holds KC = KCN / CT
// k steps; a row's products of a chunk are padded by a column tile so that
// the owners of rows r and r + 1 read other banks.
constexpr int kActFloats = kChunk / kNarrowCols * kRows;
constexpr int kProdFloats = kChunk + 2 * kWideCols;   // a row's products, both matrices
struct FoldBufs {
  float* w;   // kStages x kChunk: matrix m's (kk, j) at [m * KCN + kk * CT + j]
  float* a;   // 2 x kActFloats: A(r, k0 + kk) at [kk * kRows + r]
  float* p;   // 2 x nrmax x kProdFloats: matrix m's (r, kk, j) at
              // [m * nrmax * (KCN + CT) + r * (KCN + CT) + kk * CT + j]
  int nrmax;
};

// The rows whose products a block buffers: one row group at most, so the
// buffers do not grow with the batch.
__host__ __device__ constexpr int fold_nrmax(int rows) { return rows < kRows ? rows : kRows; }

__host__ __device__ constexpr int fold_bytes(int rows) {
  return (kStages * kChunk + 2 * kActFloats + 2 * fold_nrmax(rows) * kProdFloats) * 4;
}

// Work items of fold_cols: (row group of kRows, tile of CT columns).
template <int CT>
__host__ __device__ long long fold_items(int rows, int n) {
  return static_cast<long long>((rows + kRows - 1) / kRows) * ((n + CT - 1) / CT);
}

// For every row r < rows and column j < n of the (kdim, n) weights w1 (and
// w2 when kDual): acc[r, j] = sum_k amsim(A(r, k), w[k, j]), k in order
// from +0.0, then epi(r, j, acc1, acc2).  stage(r, k) gives A(r, k);
// prep(r0, nr) runs before each item of rows r0 .. r0 + nr (a block-wide
// call, or nothing).  Blocks stride over the items; every thread of the
// block calls it.
//
// An item folds kdim / KC chunks.  Iteration i waits for weight chunk i,
// issues chunk i + kStages - 1, computes chunk i's products, adds chunk
// i - 1's and stores A of chunk i + 1, loaded into registers before the
// products.  One block barrier an iteration orders all of it.  Thread t
// stages and multiplies the chunk's elements e = t + p * kThreads (k step
// e / CT, column t % CT) for every row, rows outermost, so that the
// kElems x (1 + kDual) products of a row are independent of each other;
// past kdim and n both operands are staged as zeros, and no owner reads
// those products.  The owner of (r, j) is thread r * CT + j.
template <int CT, typename LutT, bool kSmem, bool kDual, typename Prep, typename Stage,
          typename Epi>
__device__ void fold_cols(int rows, int n, int kdim, const float* w1, const float* w2, Prep prep,
                          Stage stage, Epi epi, const LutT* lut, int M, const FoldBufs& fb) {
  constexpr int KCN = kDual ? kChunk / 2 : kChunk;
  constexpr int KC = KCN / CT;
  constexpr int kElems = KCN / amsim::kThreads;
  constexpr int kA = (KC * kRows + amsim::kThreads - 1) / amsim::kThreads;
  static_assert(KC * CT == KCN && KCN % amsim::kThreads == 0 && KC * kRows <= kActFloats &&
                    (1 + kDual) * (KCN + CT) <= kProdFloats,
                "a chunk's elements fill the block's threads and its buffers");
  const int tiles = (n + CT - 1) / CT;
  const int nchunks = (kdim + KC - 1) / KC;
  const long long items = fold_items<CT>(rows, n);
  const int own_r = threadIdx.x / CT;
  const int own_j = threadIdx.x % CT;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int c0 = static_cast<int>(it % tiles) * CT;
    const int r0 = static_cast<int>(it / tiles) * kRows;
    const int nr = min(kRows, rows - r0);
    const int col = c0 + own_j;
    __syncthreads();  // the previous item is done with every buffer
    prep(r0, nr);
    auto issue = [&](int c) {
      if (c < nchunks) {
        float* dst = fb.w + (c % kStages) * kChunk;
#pragma unroll
        for (int p = 0; p < kElems; ++p) {
          const int e = threadIdx.x + p * amsim::kThreads;
          const int k = c * KC + e / CT;
          const bool ok = k < kdim && col < n;
          const size_t g = ok ? static_cast<size_t>(k) * n + col : 0;
          cp_async4(dst + e, w1 + g, ok);
          if (kDual) cp_async4(dst + KCN + e, w2 + g, ok);
        }
      }
      cp_async_commit();
    };
    auto load_a = [&](int c, float (&regs)[kA]) {
#pragma unroll
      for (int q = 0; q < kA; ++q) {
        const int e = threadIdx.x + q * amsim::kThreads;
        const int r = e % kRows;
        const int k = c * KC + e / kRows;
        regs[q] = (e < KC * kRows && r < nr && k < kdim) ? stage(r0 + r, k) : 0.0f;
      }
    };
    auto store_a = [&](int buf, const float (&regs)[kA]) {
#pragma unroll
      for (int q = 0; q < kA; ++q) {
        const int e = threadIdx.x + q * amsim::kThreads;
        if (e < KC * kRows) fb.a[buf * kActFloats + e] = regs[q];
      }
    };
    for (int c = 0; c < kStages - 1; ++c) issue(c);
    float regs[kA];
    load_a(0, regs);
    store_a(0, regs);
    float acc1 = 0.0f, acc2 = 0.0f;
    for (int i = 0; i <= nchunks; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      issue(i + kStages - 1);
      if (i + 1 < nchunks) load_a(i + 1, regs);
      if (i < nchunks) {
        const float* ws = fb.w + (i % kStages) * kChunk;
        const float* as = fb.a + (i & 1) * kActFloats;
        float* p1 = fb.p + (i & 1) * fb.nrmax * kProdFloats;
        float* p2 = p1 + fb.nrmax * (KCN + CT);
        uint32_t u1[kElems], u2[kElems];
#pragma unroll
        for (int p = 0; p < kElems; ++p) {
          u1[p] = __float_as_uint(ws[threadIdx.x + p * amsim::kThreads]);
          u2[p] = kDual ? __float_as_uint(ws[KCN + threadIdx.x + p * amsim::kThreads]) : 0u;
        }
#pragma unroll 2
        for (int r = 0; r < nr; ++r) {
#pragma unroll
          for (int p = 0; p < kElems; ++p) {
            const int e = threadIdx.x + p * amsim::kThreads;
            const uint32_t hv = __float_as_uint(as[(e / CT) * kRows + r]);
            const int o = r * (KCN + CT) + e;
            p1[o] = amsim::mul<LutT, kSmem>(hv, u1[p], lut, M);
            if (kDual) p2[o] = amsim::mul<LutT, kSmem>(hv, u2[p], lut, M);
          }
        }
      }
      if (i >= 1 && own_r < nr) {
        const int kt = min(KC, kdim - (i - 1) * KC);
        const float* q1 = fb.p + ((i - 1) & 1) * fb.nrmax * kProdFloats + own_r * (KCN + CT) +
                          own_j;
        const float* q2 = q1 + fb.nrmax * (KCN + CT);
#pragma unroll 8
        for (int kk = 0; kk < kt; ++kk) {
          acc1 = __fadd_rn(acc1, q1[kk * CT]);
          if (kDual) acc2 = __fadd_rn(acc2, q2[kk * CT]);
        }
      }
      if (i + 1 < nchunks) store_a((i + 1) & 1, regs);
    }
    if (own_r < nr && col < n) epi(r0 + own_r, col, acc1, acc2);
  }
}

// Where the LUT and the scratch of a block live in shared memory.
template <typename LutT, bool kSmem>
struct Smem {
  const LutT* lut;
  float* tile;
  float* rinv;
  float* qrows;
};

template <typename LutT, bool kSmem>
__device__ Smem<LutT, kSmem> carve(unsigned char* smem, const LutT* lut_g, int lut_bytes) {
  Smem<LutT, kSmem> s;
  int off = 0;
  s.lut = lut_g;
  if constexpr (kSmem) {
    amsim::stage_lut(smem, lut_g, lut_bytes);
    s.lut = reinterpret_cast<const LutT*>(smem);
    off = amsim::align16(lut_bytes);
  }
  s.tile = reinterpret_cast<float*>(smem + off);
  s.rinv = reinterpret_cast<float*>(smem + off + kTileBytes);
  s.qrows = reinterpret_cast<float*>(smem + off + kTileBytes + amsim::align16(kRinvBytes));
  return s;
}

int smem_bytes(bool lut_in_smem, int lut_bytes, int qrow_floats) {
  return (lut_in_smem ? amsim::align16(lut_bytes) : 0) + kTileBytes + amsim::align16(kRinvBytes) +
         amsim::kWarps * qrow_floats * 4;
}

// The shared memory of the two fold_cols kernels: the LUT, the norm
// scales, a q row a warp (attention phase) and fold_cols's buffers.
template <typename LutT>
struct FoldSmem {
  const LutT* lut;
  float* rinv;
  float* qrows;
  FoldBufs fb;
};

int fold_smem_bytes(bool lut_in_smem, int lut_bytes, int qrow_floats, int rows) {
  return (lut_in_smem ? amsim::align16(lut_bytes) : 0) + amsim::align16(kRinvBytes) +
         amsim::align16(amsim::kWarps * qrow_floats * 4) + fold_bytes(rows);
}

template <typename LutT, bool kSmem>
__device__ FoldSmem<LutT> carve_fold(unsigned char* smem, const LutT* lut_g, int lut_bytes,
                                     int qrow_floats, int rows) {
  FoldSmem<LutT> s;
  int off = 0;
  s.lut = lut_g;
  if constexpr (kSmem) {
    amsim::stage_lut(smem, lut_g, lut_bytes);
    s.lut = reinterpret_cast<const LutT*>(smem);
    off = amsim::align16(lut_bytes);
  }
  s.rinv = reinterpret_cast<float*>(smem + off);
  off += amsim::align16(kRinvBytes);
  s.qrows = reinterpret_cast<float*>(smem + off);
  off += amsim::align16(amsim::kWarps * qrow_floats * 4);
  s.fb.nrmax = fold_nrmax(rows);
  s.fb.w = reinterpret_cast<float*>(smem + off);
  s.fb.a = s.fb.w + kStages * kChunk;
  s.fb.p = s.fb.a + 2 * kActFloats;
  return s;
}

// ---------------------------------------------------------- fused_qkv_norm
struct Qkv {
  const float* x;
  const float* g;
  const float* w[3];
  float* out[3];
  int n[3];
  int rows, d;
  float eps;
};

template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
qkv_kernel(Qkv p, const LutT* __restrict__ lut_g, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<LutT, kSmem> sm = carve<LutT, kSmem>(smem_raw, lut_g, lut_bytes);
  for (int r0 = 0; r0 < p.rows; r0 += kRows) {
    const int nr = min(kRows, p.rows - r0);
    row_rinv(p.x, p.d, r0, nr, p.eps, sm.rinv);
    auto stage = [&](int r, int k) {
      return __fmul_rn(__fmul_rn(p.x[static_cast<size_t>(r0 + r) * p.d + k], sm.rinv[r]), p.g[k]);
    };
    for (int m = 0; m < 3; ++m) {
      float* out = p.out[m];
      const int n = p.n[m];
      column_fold<LutT, kSmem, false>(
          n, p.d, nr, p.w[m], nullptr, stage,
          [&](int r, int j, float acc, float) { out[static_cast<size_t>(r0 + r) * n + j] = acc; },
          sm.lut, M, sm.tile);
    }
    __syncthreads();  // rinv is rewritten for the next row group
  }
}

// ----------------------------------------------------------- fused_wo_norm
// Its first phase: x1 = x + (attn @ wo (+ bo)) for every row.
template <typename LutT, bool kSmem>
__device__ void wo_residual(const Chain& c, const Smem<LutT, kSmem>& sm, int M) {
  for (int r0 = 0; r0 < c.rows; r0 += kRows) {
    const int nr = min(kRows, c.rows - r0);
    column_fold<LutT, kSmem, false>(
        c.d, c.K, nr, c.wo, nullptr,
        [&](int r, int k) { return c.attn[static_cast<size_t>(r0 + r) * c.K + k]; },
        [&](int r, int j, float acc, float) {
          const float y = c.bo ? __fadd_rn(acc, c.bo[j]) : acc;
          const size_t i = static_cast<size_t>(r0 + r) * c.d + j;
          c.x1[i] = __fadd_rn(c.x[i], y);
        },
        sm.lut, M, sm.tile);
  }
}

// ------------------------------------------------- the back half's phases
template <typename LutT, bool kSmem>
__device__ void out_mlp_phases(const Chain& c, const FoldSmem<LutT>& sm, int M) {
  cg::grid_group grid = cg::this_grid();
  auto no_prep = [](int, int) {};
  // Phase A: x1 = x + (attn @ wo (+ bo)).
  fold_cols<kNarrowCols, LutT, kSmem, false>(
      c.rows, c.d, c.K, c.wo, nullptr, no_prep,
      [&](int r, int k) { return c.attn[static_cast<size_t>(r) * c.K + k]; },
      [&](int r, int j, float acc, float) {
        const float y = c.bo ? __fadd_rn(acc, c.bo[j]) : acc;
        const size_t i = static_cast<size_t>(r) * c.d + j;
        c.x1[i] = __fadd_rn(c.x[i], y);
      },
      sm.lut, M, sm.fb);
  grid.sync();
  // Phase B: h = rmsnorm(x1; g); act = silu(h @ wg) * (h @ wu).  Each item
  // computes the norm scales of its row group.
  fold_cols<kWideCols, LutT, kSmem, true>(
      c.rows, c.F, c.d, c.wg, c.wu,
      [&](int r0, int nr) { row_rinv(c.x1, c.d, r0, nr, c.eps, sm.rinv); },
      [&](int r, int k) {
        return __fmul_rn(__fmul_rn(c.x1[static_cast<size_t>(r) * c.d + k], sm.rinv[r % kRows]),
                         c.g[k]);
      },
      [&](int r, int j, float g, float u) {
        c.act[static_cast<size_t>(r) * c.F + j] = __fmul_rn(silu(g), u);
      },
      sm.lut, M, sm.fb);
  grid.sync();
  // Phase C: out = x1 + (act @ wd (+ bd)).
  fold_cols<kNarrowCols, LutT, kSmem, false>(
      c.rows, c.d, c.F, c.wd, nullptr, no_prep,
      [&](int r, int k) { return c.act[static_cast<size_t>(r) * c.F + k]; },
      [&](int r, int j, float acc, float) {
        const float y = c.bd ? __fadd_rn(acc, c.bd[j]) : acc;
        const size_t i = static_cast<size_t>(r) * c.d + j;
        c.out[i] = __fadd_rn(c.x1[i], y);
      },
      sm.lut, M, sm.fb);
}

template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
out_mlp_kernel(Chain c, const LutT* __restrict__ lut_g, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FoldSmem<LutT> sm = carve_fold<LutT, kSmem>(smem_raw, lut_g, lut_bytes, 0, c.rows);
  out_mlp_phases<LutT, kSmem>(c, sm, M);
}

template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
attn_out_mlp_kernel(Chain c, amsim::Attn a, float* attn, float* scores, int scratch_warps,
                    const LutT* __restrict__ lut_g, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FoldSmem<LutT> sm = carve_fold<LutT, kSmem>(smem_raw, lut_g, lut_bytes, a.dh, c.rows);
  amsim::attention_rows<LutT, kSmem>(a, sm.lut, M, sm.qrows, scores, scratch_warps, attn);
  cg::this_grid().sync();
  out_mlp_phases<LutT, kSmem>(c, sm, M);
}

// Chain's x, attn, g (= g2), wo, bo, x1, rows, d, K, eps; `out` holds h.
template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
wo_norm_kernel(Chain c, const LutT* __restrict__ lut_g, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<LutT, kSmem> sm = carve<LutT, kSmem>(smem_raw, lut_g, lut_bytes);
  wo_residual<LutT, kSmem>(c, sm, M);
  cg::this_grid().sync();
  // h = rmsnorm(x1; g): one block a row.
  for (int r = blockIdx.x; r < c.rows; r += gridDim.x) {
    row_rinv(c.x1, c.d, r, 1, c.eps, sm.rinv);
    for (int j = threadIdx.x; j < c.d; j += amsim::kThreads) {
      const size_t i = static_cast<size_t>(r) * c.d + j;
      c.out[i] = __fmul_rn(__fmul_rn(c.x1[i], sm.rinv[0]), c.g[j]);
    }
    __syncthreads();  // rinv is rewritten for the next row
  }
}

// ----------------------------------------------------------- fused_moe_ffn
struct Moe {
  const float* h;      // (E, C, d) capacity buffer
  const float* wg;     // (E, d, F)
  const float* wu;     // (E, d, F)
  const float* wd;     // (E, F, d)
  float* act;          // (E, C, F) scratch
  float* out;          // (E, C, d)
  int E, C, d, F;
};

__host__ __device__ long long column_tiles(int n) {
  return (n + amsim::kThreads - 1) / amsim::kThreads;
}

// Work items of one phase: (expert, row group, column tile), tile fastest.
__host__ __device__ long long moe_items(const Moe& p, int n) {
  return static_cast<long long>(p.E) * ((p.C + kRows - 1) / kRows) * column_tiles(n);
}

template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
moe_ffn_kernel(Moe p, const LutT* __restrict__ lut_g, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<LutT, kSmem> sm = carve<LutT, kSmem>(smem_raw, lut_g, lut_bytes);
  const int groups = (p.C + kRows - 1) / kRows;
  // Phase 1: act[e] = silu(h[e] @ wg[e]) * (h[e] @ wu[e]).
  const int tiles_f = static_cast<int>(column_tiles(p.F));
  for (long long w = blockIdx.x; w < moe_items(p, p.F); w += gridDim.x) {
    const int t = static_cast<int>(w % tiles_f);
    const int r0 = static_cast<int>((w / tiles_f) % groups) * kRows;
    const size_t e = static_cast<size_t>(w / tiles_f / groups);
    const float* h = p.h + e * p.C * p.d;
    float* act = p.act + e * p.C * p.F;
    fold_tile<LutT, kSmem, true>(
        t * amsim::kThreads, p.F, p.d, min(kRows, p.C - r0), p.wg + e * p.d * p.F,
        p.wu + e * p.d * p.F,
        [&](int r, int k) { return h[static_cast<size_t>(r0 + r) * p.d + k]; },
        [&](int r, int j, float g, float u) {
          act[static_cast<size_t>(r0 + r) * p.F + j] = __fmul_rn(silu(g), u);
        },
        sm.lut, M, sm.tile);
  }
  cg::this_grid().sync();
  // Phase 2: out[e] = act[e] @ wd[e].
  const int tiles_d = static_cast<int>(column_tiles(p.d));
  for (long long w = blockIdx.x; w < moe_items(p, p.d); w += gridDim.x) {
    const int t = static_cast<int>(w % tiles_d);
    const int r0 = static_cast<int>((w / tiles_d) % groups) * kRows;
    const size_t e = static_cast<size_t>(w / tiles_d / groups);
    const float* act = p.act + e * p.C * p.F;
    float* out = p.out + e * p.C * p.d;
    fold_tile<LutT, kSmem, false>(
        t * amsim::kThreads, p.d, p.F, min(kRows, p.C - r0), p.wd + e * p.F * p.d, nullptr,
        [&](int r, int k) { return act[static_cast<size_t>(r0 + r) * p.F + k]; },
        [&](int r, int j, float acc, float) { out[static_cast<size_t>(r0 + r) * p.d + j] = acc; },
        sm.lut, M, sm.tile);
  }
}

template <typename Kernel>
cudaError_t launch_cooperative(Kernel kernel, int smem, long long work_blocks, void** args,
                               cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = amsim::grid_size(kernel, smem, work_blocks, &blocks);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks), dim3(amsim::kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The work of a back-half launch: items[0..2] are the work items of the
// wo, gate/up and down phases, items[3] the attention phase's blocks (a
// warp a query row); the grid is sized to the largest.
long long back_half_work(int rows, int d, int F, int heads, long long items[4]) {
  items[0] = fold_items<kNarrowCols>(rows, d);
  items[1] = fold_items<kWideCols>(rows, F);
  items[2] = items[0];
  items[3] = (static_cast<long long>(rows) * heads + amsim::kWarps - 1) / amsim::kWarps;
  return std::max({items[0], items[1], items[2], items[3]});
}

// f(kernel, shared memory bytes) of fused_attn_out_mlp (heads > 0) or
// fused_out_mlp for the LUT layout.
template <typename F>
cudaError_t with_back_half(int heads, int dh, int rows, int packed, int smem_lut, int lut_bytes,
                           F&& f) {
  return amsim::with_lut(packed, smem_lut, [&](auto kind) {
    using LutT = typename decltype(kind)::T;
    constexpr bool kSmem = decltype(kind)::smem;
    if (heads > 0) {
      return f(attn_out_mlp_kernel<LutT, kSmem>, fold_smem_bytes(kSmem, lut_bytes, dh, rows));
    }
    return f(out_mlp_kernel<LutT, kSmem>, fold_smem_bytes(kSmem, lut_bytes, 0, rows));
  });
}

}  // namespace

// Each returns a cudaError_t code: 0 when the launch was accepted.
// `packed` selects uint16 LUT entries; `smem_lut` stages the table in
// shared memory (kernels/common.py:lut_in_smem).

extern "C" int fused_qkv_norm_f32(const float* x, const float* g1, const float* wq,
                                  const float* wk, const float* wv, const void* lut, float* oq,
                                  float* ok, float* ov, int rows, int d, int nq, int nk, int nv,
                                  float eps, int M, int packed, int smem_lut, int lut_bytes,
                                  void* stream) {
  const Qkv p{x, g1, {wq, wk, wv}, {oq, ok, ov}, {nq, nk, nv}, rows, d, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(amsim::with_lut(packed, smem_lut, [&](auto kind) {
    using LutT = typename decltype(kind)::T;
    constexpr bool kSmem = decltype(kind)::smem;
    auto kernel = qkv_kernel<LutT, kSmem>;
    const int smem = smem_bytes(kSmem, lut_bytes, 0);
    int blocks = 0;
    cudaError_t err = amsim::grid_size(kernel, smem, column_tiles(std::max({nq, nk, nv})), &blocks);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, amsim::kThreads, smem, s>>>(p, static_cast<const LutT*>(lut), M, lut_bytes);
    return cudaGetLastError();
  }));
}

extern "C" int fused_out_mlp_f32(const float* x, const float* attn, const float* g2,
                                 const float* wo, const float* wg, const float* wu,
                                 const float* wd, const float* bo, const float* bd,
                                 const void* lut, float* out, float* x1, float* act, int rows,
                                 int d, int K, int F, float eps, int M, int packed, int smem_lut,
                                 int lut_bytes, void* stream) {
  Chain c{x, attn, g2, wo, wg, wu, wd, bo, bd, out, x1, act, rows, d, K, F, eps};
  int m = M, lb = lut_bytes;
  void* args[] = {&c, &lut, &m, &lb};
  long long items[4];
  const long long work = back_half_work(rows, d, F, 0, items);
  return static_cast<int>(
      with_back_half(0, 0, rows, packed, smem_lut, lut_bytes, [&](auto kernel, int smem) {
        return launch_cooperative(kernel, smem, work, args, static_cast<cudaStream_t>(stream));
      }));
}

extern "C" int fused_attn_out_mlp_f32(
    const float* x, const float* q, const float* k, const float* v, const int* q_pos,
    const int* k_pos, const float* g2, const float* wo, const float* wg, const float* wu,
    const float* wd, const float* bo, const float* bd, const void* lut, float* out, float* x1,
    float* act, float* attn, float* scores, int H, int KV, int T, int dh, int causal,
    int window, int scratch_warps, int rows, int d, int K, int F, float eps, int M, int packed,
    int smem_lut, int lut_bytes, void* stream) {
  Chain c{x, attn, g2, wo, wg, wu, wd, bo, bd, out, x1, act, rows, d, K, F, eps};
  amsim::Attn a{q, k, v, q_pos, k_pos, rows, 1, H, KV, T, dh, causal, window};
  int m = M, lb = lut_bytes, sw = scratch_warps;
  void* args[] = {&c, &a, &attn, &scores, &sw, &lut, &m, &lb};
  long long items[4];
  const long long work = back_half_work(rows, d, F, H, items);
  return static_cast<int>(
      with_back_half(H, dh, rows, packed, smem_lut, lut_bytes, [&](auto kernel, int smem) {
        return launch_cooperative(kernel, smem, work, args, static_cast<cudaStream_t>(stream));
      }));
}

// The grid a back-half launch of these shapes takes, without launching:
// out = {blocks, wo items, gate/up items, down items, attention blocks}
// (heads = 0: fused_out_mlp, no attention phase).
extern "C" int back_half_grid(int rows, int d, int F, int heads, int dh, int packed,
                              int smem_lut, int lut_bytes, long long* out, void*) {
  long long items[4];
  const long long work = back_half_work(rows, d, F, heads, items);
  for (int i = 0; i < 4; ++i) out[i + 1] = items[i];
  return static_cast<int>(
      with_back_half(heads, dh, rows, packed, smem_lut, lut_bytes, [&](auto kernel, int smem) {
        int blocks = 0;
        const cudaError_t err = amsim::grid_size(kernel, smem, work, &blocks);
        out[0] = blocks;
        return err;
      }));
}

extern "C" int fused_wo_norm_f32(const float* x, const float* attn, const float* g2,
                                 const float* wo, const float* bo, const void* lut, float* x1,
                                 float* h, int rows, int d, int K, float eps, int M, int packed,
                                 int smem_lut, int lut_bytes, void* stream) {
  Chain c{x, attn, g2, wo, nullptr, nullptr, nullptr, bo, nullptr, h, x1, nullptr, rows, d, K,
          0, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(amsim::with_lut(packed, smem_lut, [&](auto kind) {
    using LutT = typename decltype(kind)::T;
    constexpr bool kSmem = decltype(kind)::smem;
    const LutT* lut_t = static_cast<const LutT*>(lut);
    int m = M, lb = lut_bytes;
    void* args[] = {&c, &lut_t, &m, &lb};
    return launch_cooperative(wo_norm_kernel<LutT, kSmem>, smem_bytes(kSmem, lut_bytes, 0),
                              std::max<long long>(column_tiles(d), rows), args, s);
  }));
}

extern "C" int fused_moe_ffn_f32(const float* h, const float* wg, const float* wu,
                                 const float* wd, const void* lut, float* out, float* act, int E,
                                 int C, int d, int F, int M, int packed, int smem_lut,
                                 int lut_bytes, void* stream) {
  Moe p{h, wg, wu, wd, act, out, E, C, d, F};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(amsim::with_lut(packed, smem_lut, [&](auto kind) {
    using LutT = typename decltype(kind)::T;
    constexpr bool kSmem = decltype(kind)::smem;
    const LutT* lut_t = static_cast<const LutT*>(lut);
    int m = M, lb = lut_bytes;
    void* args[] = {&p, &lut_t, &m, &lb};
    return launch_cooperative(moe_ffn_kernel<LutT, kSmem>, smem_bytes(kSmem, lut_bytes, 0),
                              std::max(moe_items(p, F), moe_items(p, d)), args, s);
  }));
}

// expf and rsqrtf of every element, as the kernels above evaluate them:
// the probe that holds them against torch.exp and torch.rsqrt on the card.
namespace {
__global__ void libm_kernel(const float* __restrict__ x, float* __restrict__ e,
                            float* __restrict__ r, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    e[i] = expf(x[i]);
    r[i] = rsqrtf(x[i]);
  }
}
}  // namespace

extern "C" int libm_probe_f32(const float* x, float* e, float* r, long long n, void* stream) {
  const long long blocks = std::min<long long>((n + amsim::kThreads - 1) / amsim::kThreads, 4096);
  libm_kernel<<<static_cast<int>(std::max<long long>(blocks, 1)), amsim::kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(x, e, r, n);
  return static_cast<int>(cudaGetLastError());
}

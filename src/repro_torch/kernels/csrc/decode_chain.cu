// The decode chain: one transformer layer of a decode step in two or
// three launches (dense) or four (MoE), every GEMM product simulated by
// AMSim.
//
//   fused_qkv_norm      h = rmsnorm(x; g1); q, k, v = h@wq, h@wk, h@wv
//   fused_out_mlp       x1 = x + attn@wo (+bo); h = rmsnorm(x1; g2);
//                       out = x1 + (silu(h@wg) * (h@wu))@wd (+bd)
//   fused_attn_out_mlp  the attention core of the step (attention.cuh
//                       attend_tile, a block a group of heads), then
//                       fused_out_mlp's phases
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
// needs no barrier: each work item computes the norm scales of its rows
// itself.  fused_wo_norm has one barrier between the wo columns (the back
// half's phase A) and the norm, then one block a row writes h;
// fused_moe_ffn one after its live rows are listed and one between the
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
// Every kernel folds with fold_cols, which splits each output's products
// from its adds.  A work item is a row group of up to kRows rows and a
// narrow tile of CT columns (32 for the gate/up columns, 8 for q/k/v, wo
// and wd), so a launch has hundreds of items and the grid fills every SM
// (granite-3-2b at 4 rows: 384 qkv items, 256 items in each back-half
// phase).  The item's weight columns come into shared memory a k-chunk at
// a time by cp.async, in a ring of kStages chunks, so the next chunks are
// in flight while one is folded.  All 256 threads compute a chunk's
// products (each an independent lookup) into shared memory; the thread
// that owns an output then adds its chunk's products in k order, one
// chunk behind.  fold_item is one item; each kernel walks its own items:
//   fused_qkv_norm   q, k and v are one item space, each matrix with its
//                    own column tiles (an item never straddles two); each
//                    item computes its row group's norm scales; a plain
//                    launch, no barrier.
//   the back half    three phases of (row group, tile) items (fold_cols)
//                    between grid barriers.
//   fused_wo_norm    the back half's phase A (wo_phase: granite-moe at 4
//                    rows, 192 items), a grid barrier, the norm.
//   fused_moe_ffn    phase 0, a block an expert, lists the expert's live
//                    capacity rows; then (expert, group of 6 live rows,
//                    tile) items for gate/up and, after a barrier, for
//                    down (tiles of 16 or 32 and of 32 columns).
// The tile and chunk sizes were chosen by timing on the H100 (PERF.md).
//
// Dead capacity rows.  amsim::mul returns the bare sign when either
// operand's exponent field is 0, whatever the other operand is (inf and
// NaN included).  So a capacity row whose every element is +-0 or
// subnormal makes +-0 products only; each gate/up sum, folded from +0.0,
// is +0.0, silu(+0) * (+0) is +0.0, and so is every down output.
// fused_moe_ffn writes +0.0 over such a row and gives it no item: it costs
// no lookup and no weight read, and an expert with no live row has no
// items at all.  The bits are those of the plain version for every input.
//
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

constexpr int kRows = 8;    // rows of a work item
// fold_cols: weight floats a k-chunk stages (k steps x CT columns of one
// matrix, or of two side by side), and the depth of the cp.async ring.
constexpr int kChunk = 1024;
constexpr int kStages = 3;
constexpr int kWideCols = 32;    // gate/up column tile: one 128-byte segment a weight row
constexpr int kNarrowCols = 8;   // q/k/v, wo and wd column tile: one 32-byte sector

// Shared memory after the LUT: the norm scales.
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

// One work item: for the rows r0 .. r0 + nr (nr <= kRows) and the columns
// j = c0 .. c0 + CT of the (kdim, n) weights w1 (and w2 when kDual):
// acc[r, j] = sum_k amsim(A(r, k), w[k, j]), k in order from +0.0, then
// epi(r, j, acc1, acc2).  stage(r, k) gives A(r, k).  Every thread of the
// block calls it, after a block barrier since its previous item (the
// caller's), so that no thread still reads a buffer it overwrites.
//
// The item folds kdim / KC chunks.  Iteration i waits for weight chunk i,
// issues chunk i + kStages - 1, computes chunk i's products, adds chunk
// i - 1's and stores A of chunk i + 1, loaded into registers before the
// products.  One block barrier an iteration orders all of it.  Thread t
// stages and multiplies the chunk's elements e = t + p * kThreads (k step
// e / CT, column t % CT) for every row, rows outermost, so that the
// kElems x (1 + kDual) products of a row are independent of each other;
// past kdim and n both operands are staged as zeros, and no owner reads
// those products.  The owner of (r0 + r, c0 + j) is thread r * CT + j.
template <int CT, typename LutT, bool kSmem, bool kDual, typename Stage, typename Epi>
__device__ __forceinline__ void fold_item(int r0, int nr, int c0, int n, int kdim,
                                          const float* w1, const float* w2, Stage stage, Epi epi,
                                          const LutT* lut, int M, const FoldBufs& fb) {
  constexpr int KCN = kDual ? kChunk / 2 : kChunk;
  constexpr int KC = KCN / CT;
  constexpr int kElems = KCN / amsim::kThreads;
  constexpr int kA = (KC * kRows + amsim::kThreads - 1) / amsim::kThreads;
  static_assert(KC * CT == KCN && KCN % amsim::kThreads == 0 && KC * kRows <= kActFloats &&
                    (1 + kDual) * (KCN + CT) <= kProdFloats,
                "a chunk's elements fill the block's threads and its buffers");
  const int nchunks = (kdim + KC - 1) / KC;
  const int own_r = threadIdx.x / CT;
  const int own_j = threadIdx.x % CT;
  const int col = c0 + own_j;
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

// fold_item over the (row group, column tile) items of every row r < rows
// and column j < n, tile fastest, blocks striding over the items.
// prep(r0, nr) runs before each item of rows r0 .. r0 + nr (a block-wide
// call, or nothing).
template <int CT, typename LutT, bool kSmem, bool kDual, typename Prep, typename Stage,
          typename Epi>
__device__ void fold_cols(int rows, int n, int kdim, const float* w1, const float* w2, Prep prep,
                          Stage stage, Epi epi, const LutT* lut, int M, const FoldBufs& fb) {
  const int tiles = (n + CT - 1) / CT;
  const long long items = fold_items<CT>(rows, n);
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int c0 = static_cast<int>(it % tiles) * CT;
    const int r0 = static_cast<int>(it / tiles) * kRows;
    const int nr = min(kRows, rows - r0);
    __syncthreads();  // the previous item is done with every buffer
    prep(r0, nr);
    fold_item<CT, LutT, kSmem, kDual>(r0, nr, c0, n, kdim, w1, w2, stage, epi, lut, M, fb);
  }
}

// The shared memory of the fold_cols kernels: the LUT, the norm scales and
// fold_item's buffers (which fused_attn_out_mlp's attention phase borrows).
template <typename LutT>
struct FoldSmem {
  const LutT* lut;
  float* rinv;
  FoldBufs fb;
};

__host__ __device__ int fold_smem_bytes(bool lut_in_smem, int lut_bytes, int rows) {
  return (lut_in_smem ? amsim::align16(lut_bytes) : 0) + amsim::align16(kRinvBytes) +
         fold_bytes(rows);
}

template <typename LutT, bool kSmem>
__device__ FoldSmem<LutT> carve_fold(unsigned char* smem, const LutT* lut_g, int lut_bytes,
                                     int rows) {
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

// Work items: (row group of kRows, column tile) over the concatenated
// column tiles of wq, wk and wv, tile fastest; matrix m has its own
// ceil(n[m] / kNarrowCols) tiles.
__host__ __device__ int qkv_tiles(int n) { return (n + kNarrowCols - 1) / kNarrowCols; }

__host__ __device__ long long qkv_items(int rows, const int n[3]) {
  return static_cast<long long>((rows + kRows - 1) / kRows) *
         (qkv_tiles(n[0]) + qkv_tiles(n[1]) + qkv_tiles(n[2]));
}

template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
qkv_kernel(Qkv p, const LutT* __restrict__ lut_g, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FoldSmem<LutT> sm = carve_fold<LutT, kSmem>(smem_raw, lut_g, lut_bytes, p.rows);
  const int tq = qkv_tiles(p.n[0]), tk = qkv_tiles(p.n[1]);
  const int tiles = tq + tk + qkv_tiles(p.n[2]);
  const long long items = qkv_items(p.rows, p.n);
  int rinv_r0 = -1;   // the row group whose norm scales rinv holds
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    int t = static_cast<int>(it % tiles);
    const int r0 = static_cast<int>(it / tiles) * kRows;
    const int nr = min(kRows, p.rows - r0);
    const int m = t < tq ? 0 : t < tq + tk ? 1 : 2;
    t -= m == 0 ? 0 : m == 1 ? tq : tq + tk;
    const float* w = m == 0 ? p.w[0] : m == 1 ? p.w[1] : p.w[2];
    float* out = m == 0 ? p.out[0] : m == 1 ? p.out[1] : p.out[2];
    const int n = m == 0 ? p.n[0] : m == 1 ? p.n[1] : p.n[2];
    __syncthreads();  // the previous item is done with every buffer and rinv
    if (r0 != rinv_r0) {
      row_rinv(p.x, p.d, r0, nr, p.eps, sm.rinv);
      rinv_r0 = r0;
    }
    fold_item<kNarrowCols, LutT, kSmem, false>(
        r0, nr, t * kNarrowCols, n, p.d, w, nullptr,
        [&](int r, int k) {
          return __fmul_rn(__fmul_rn(p.x[static_cast<size_t>(r) * p.d + k], sm.rinv[r % kRows]),
                           p.g[k]);
        },
        [&](int r, int j, float acc, float) { out[static_cast<size_t>(r) * n + j] = acc; },
        sm.lut, M, sm.fb);
  }
}

// ------------------------------------------------- the back half's phases
// Phase A of the back half and of fused_wo_norm: x1 = x + (attn @ wo (+ bo)).
template <typename LutT, bool kSmem>
__device__ void wo_phase(const Chain& c, const FoldSmem<LutT>& sm, int M) {
  fold_cols<kNarrowCols, LutT, kSmem, false>(
      c.rows, c.d, c.K, c.wo, nullptr, [](int, int) {},
      [&](int r, int k) { return c.attn[static_cast<size_t>(r) * c.K + k]; },
      [&](int r, int j, float acc, float) {
        const float y = c.bo ? __fadd_rn(acc, c.bo[j]) : acc;
        const size_t i = static_cast<size_t>(r) * c.d + j;
        c.x1[i] = __fadd_rn(c.x[i], y);
      },
      sm.lut, M, sm.fb);
}

template <typename LutT, bool kSmem>
__device__ void out_mlp_phases(const Chain& c, const FoldSmem<LutT>& sm, int M) {
  cg::grid_group grid = cg::this_grid();
  auto no_prep = [](int, int) {};
  wo_phase<LutT, kSmem>(c, sm, M);
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
  const FoldSmem<LutT> sm = carve_fold<LutT, kSmem>(smem_raw, lut_g, lut_bytes, c.rows);
  out_mlp_phases<LutT, kSmem>(c, sm, M);
}

// The attention phase's tile: the G <= 4 heads of a group (b, kv-head),
// approx_attention.cu's decode tile.
constexpr int kAttnRT = 4, kAttnTM = 1, kAttnTN = 2;
using AttnPhaseTile = amsim::AttnTile<kAttnRT, kAttnTM, kAttnTN>;
constexpr int kAttnRows = AttnPhaseTile::R;

// The attention phase reads the table where the fold staged it (raw) and
// lays its tile out in fold_item's buffers (`L`, planned on the host to fit
// fold_bytes(rows)); the grid barrier separates it from the wo phase.
// Its scores are in those buffers, or (L.scores_smem = 0) in `scratch`, R x
// T floats for each of the first `scratch_blocks` blocks, which then take
// all of the phase's tiles.
template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
attn_out_mlp_kernel(Chain c, amsim::Attn a, amsim::AttnLayout L, float* attn, float* scratch,
                    int scratch_blocks, const LutT* __restrict__ lut_g, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FoldSmem<LutT> sm = carve_fold<LutT, kSmem>(smem_raw, lut_g, lut_bytes, c.rows);
  const int nblocks = L.scores_smem ? static_cast<int>(gridDim.x)
                                    : min(static_cast<int>(gridDim.x), scratch_blocks);
  amsim::attention_tiles<kAttnRT, kAttnTM, kAttnTN>(
      a, L, amsim::raw_table<LutT, kSmem>(sm.lut), M, reinterpret_cast<unsigned char*>(sm.fb.w),
      scratch, nblocks, attn);
  cg::this_grid().sync();
  out_mlp_phases<LutT, kSmem>(c, sm, M);
}

// Chain's x, attn, g (= g2), wo, bo, x1, rows, d, K, eps; `out` holds h.
template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
wo_norm_kernel(Chain c, const LutT* __restrict__ lut_g, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FoldSmem<LutT> sm = carve_fold<LutT, kSmem>(smem_raw, lut_g, lut_bytes, c.rows);
  wo_phase<LutT, kSmem>(c, sm, M);
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
  float* act;          // (E, C, F) scratch (live rows only)
  float* out;          // (E, C, d)
  int* live;           // scratch: (E, C) each expert's live slots in ascending order,
                       // then (E,) their counts
  int E, C, d, F;
};

// Work items of the expert banks: a row group of up to kMoeRows live rows
// of one expert and a column tile.  Chosen by timing on the H100
// (PERF.md): 6 rows, the most whose fold buffers leave two blocks a SM
// beside a 32 KiB LUT; gate/up tiles of 16 columns with a shared-memory
// LUT and 32 with a global one; down tiles of 32.
constexpr int kMoeRows = 6;
static_assert(kMoeRows <= kRows, "fold_item stages at most kRows rows");
constexpr int kDownCols = kWideCols;

__host__ __device__ constexpr int gate_up_cols(bool lut_in_smem) {
  return lut_in_smem ? 16 : kWideCols;
}

// Phase 0 for expert e, by the whole block: list its live capacity rows (a
// row is live when any element has a non-zero exponent field) in ascending
// order into live[e * C ...] and their count into live[E * C + e], and write
// +0.0 over every output of each dead row.  flags: 32 ints of shared memory.
__device__ void list_live_rows(const Moe& p, int e, int* flags) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* slots = p.live + static_cast<size_t>(e) * p.C;
  int count = 0;   // warp 0's
  for (int c0 = 0; c0 < p.C; c0 += 32) {
    const int nc = min(32, p.C - c0);
    for (int c = warp; c < nc; c += amsim::kWarps) {
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(p.h + (static_cast<size_t>(e) * p.C + c0 + c) * p.d);
      bool any = false;
      for (int k0 = 0; k0 < p.d && !any; k0 += 32) {
        const int k = k0 + lane;
        any = __any_sync(0xffffffffu, k < p.d && ((row[k] >> 23) & 0xFFu) != 0);
      }
      if (lane == 0) flags[c] = any;
    }
    __syncthreads();
    if (warp == 0) {
      const bool mine = lane < nc && flags[lane];
      const unsigned ballot = __ballot_sync(0xffffffffu, mine);
      if (mine) slots[count + __popc(ballot & ((1u << lane) - 1u))] = c0 + lane;
      count += __popc(ballot);
    }
    for (int c = 0; c < nc; ++c) {
      if (flags[c]) continue;
      float* o = p.out + (static_cast<size_t>(e) * p.C + c0 + c) * p.d;
      for (int j = threadIdx.x; j < p.d; j += amsim::kThreads) o[j] = 0.0f;
    }
    __syncthreads();  // flags are rewritten for the next 32 rows
  }
  if (threadIdx.x == 0) p.live[static_cast<size_t>(p.E) * p.C + e] = count;
}

// The shared memory of fused_moe_ffn: fold_cols's for a row group, then
// E + 1 ints.
__host__ __device__ int moe_group_rows(int C) { return C < kMoeRows ? C : kMoeRows; }

__host__ __device__ int moe_smem_bytes(bool lut_in_smem, int lut_bytes, int E, int C) {
  return fold_smem_bytes(lut_in_smem, lut_bytes, moe_group_rows(C)) +
         amsim::align16((E + 1) * 4);
}

template <typename LutT, bool kSmem>
__global__ void __launch_bounds__(amsim::kThreads)
moe_ffn_kernel(Moe p, const LutT* __restrict__ lut_g, int M, int lut_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int group_rows = moe_group_rows(p.C);
  const FoldSmem<LutT> sm = carve_fold<LutT, kSmem>(smem_raw, lut_g, lut_bytes, group_rows);
  // first[e]: the live row groups of the experts before e.
  int* first = reinterpret_cast<int*>(smem_raw + fold_smem_bytes(kSmem, lut_bytes, group_rows));
  cg::grid_group grid = cg::this_grid();
  for (int e = blockIdx.x; e < p.E; e += gridDim.x) {
    list_live_rows(p, e, reinterpret_cast<int*>(sm.fb.a));
  }
  grid.sync();
  const int* count = p.live + static_cast<size_t>(p.E) * p.C;
  for (int e = threadIdx.x; e < p.E; e += amsim::kThreads) {
    first[e + 1] = (count[e] + kMoeRows - 1) / kMoeRows;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    first[0] = 0;
    for (int e = 0; e < p.E; ++e) first[e + 1] += first[e];
  }
  __syncthreads();
  const long long groups = first[p.E];
  // Live row group g is rows r0 .. r0 + kMoeRows of expert e's list: e is the
  // last expert whose first group is <= g.
  auto group = [&](long long g, int& e, int& r0) {
    int lo = 0, hi = p.E;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (first[mid] <= g) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    e = lo;
    r0 = static_cast<int>(g - first[lo]) * kMoeRows;
  };
  // Phase 1: act[e, s] = silu(h[e, s] @ wg[e]) * (h[e, s] @ wu[e]) for every
  // live slot s; items (expert, live row group, column tile), tile fastest.
  constexpr int kGateUpCols = gate_up_cols(kSmem);
  const int tiles_f = (p.F + kGateUpCols - 1) / kGateUpCols;
  for (long long it = blockIdx.x; it < groups * tiles_f; it += gridDim.x) {
    int e, r0;
    group(it / tiles_f, e, r0);
    const int* slot = p.live + static_cast<size_t>(e) * p.C;
    const float* h = p.h + static_cast<size_t>(e) * p.C * p.d;
    float* act = p.act + static_cast<size_t>(e) * p.C * p.F;
    const size_t bank = static_cast<size_t>(e) * p.d * p.F;
    __syncthreads();  // the previous item is done with every buffer
    fold_item<kGateUpCols, LutT, kSmem, true>(
        r0, min(kMoeRows, count[e] - r0), static_cast<int>(it % tiles_f) * kGateUpCols, p.F,
        p.d, p.wg + bank, p.wu + bank,
        [&](int r, int k) { return h[static_cast<size_t>(slot[r]) * p.d + k]; },
        [&](int r, int j, float g, float u) {
          act[static_cast<size_t>(slot[r]) * p.F + j] = __fmul_rn(silu(g), u);
        },
        sm.lut, M, sm.fb);
  }
  grid.sync();
  // Phase 2: out[e, s] = act[e, s] @ wd[e] for every live slot s.
  const int tiles_d = (p.d + kDownCols - 1) / kDownCols;
  for (long long it = blockIdx.x; it < groups * tiles_d; it += gridDim.x) {
    int e, r0;
    group(it / tiles_d, e, r0);
    const int* slot = p.live + static_cast<size_t>(e) * p.C;
    const float* act = p.act + static_cast<size_t>(e) * p.C * p.F;
    float* out = p.out + static_cast<size_t>(e) * p.C * p.d;
    __syncthreads();  // the previous item is done with every buffer
    fold_item<kDownCols, LutT, kSmem, false>(
        r0, min(kMoeRows, count[e] - r0), static_cast<int>(it % tiles_d) * kDownCols, p.d, p.F,
        p.wd + static_cast<size_t>(e) * p.F * p.d, nullptr,
        [&](int r, int k) { return act[static_cast<size_t>(slot[r]) * p.F + k]; },
        [&](int r, int j, float acc, float) { out[static_cast<size_t>(slot[r]) * p.d + j] = acc; },
        sm.lut, M, sm.fb);
  }
}

// The gate/up and down items of an expert-bank launch over `groups` live
// row groups.
void moe_items(long long groups, int d, int F, bool lut_in_smem, long long items[2]) {
  const int gate_up = gate_up_cols(lut_in_smem);
  items[0] = groups * ((F + gate_up - 1) / gate_up);
  items[1] = groups * ((d + kDownCols - 1) / kDownCols);
}

// The grid of an expert-bank launch: sized for a full buffer (every row
// live, since the host does not know the live rows), and for phase 0's E.
long long moe_work(int E, int C, int d, int F, bool lut_in_smem) {
  long long items[2];
  moe_items(static_cast<long long>(E) * ((C + kMoeRows - 1) / kMoeRows), d, F, lut_in_smem,
            items);
  return std::max({static_cast<long long>(E), items[0], items[1]});
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
// wo, gate/up and down phases, items[3] the attention phase's tiles (a
// group of up to kAttnRows heads of a decode row); the grid is sized to
// the largest.
long long back_half_work(int rows, int d, int F, int heads, int kv_heads, long long items[4]) {
  items[0] = fold_items<kNarrowCols>(rows, d);
  items[1] = fold_items<kWideCols>(rows, F);
  items[2] = items[0];
  items[3] = 0;
  if (heads > 0) {
    const amsim::Attn a{nullptr, nullptr, nullptr, nullptr, nullptr, rows, 1, heads, kv_heads,
                        0, 0, 1, 0};
    items[3] = amsim::attn_tiles(a, kAttnRows);
  }
  return std::max({items[0], items[1], items[2], items[3]});
}

// f(kernel, shared memory bytes) of fused_attn_out_mlp (heads > 0) or
// fused_out_mlp for the LUT layout.
template <typename F>
cudaError_t with_back_half(int heads, int rows, int packed, int smem_lut, int lut_bytes, F&& f) {
  return amsim::with_lut(packed, smem_lut, [&](auto kind) {
    using LutT = typename decltype(kind)::T;
    constexpr bool kSmem = decltype(kind)::smem;
    if (heads > 0) {
      return f(attn_out_mlp_kernel<LutT, kSmem>, fold_smem_bytes(kSmem, lut_bytes, rows));
    }
    return f(out_mlp_kernel<LutT, kSmem>, fold_smem_bytes(kSmem, lut_bytes, rows));
  });
}

// The work of a fused_wo_norm launch: the wo items, and a block a row for
// the norm.
long long wo_norm_work(int rows, int d) {
  return std::max(fold_items<kNarrowCols>(rows, d), static_cast<long long>(rows));
}

// f(kernel, shared memory bytes, a null LUT pointer of the kernel's type)
// of fused_wo_norm for the LUT layout.
template <typename F>
cudaError_t with_wo_norm(int rows, int packed, int smem_lut, int lut_bytes, F&& f) {
  return amsim::with_lut(packed, smem_lut, [&](auto kind) {
    using LutT = typename decltype(kind)::T;
    constexpr bool kSmem = decltype(kind)::smem;
    return f(wo_norm_kernel<LutT, kSmem>, fold_smem_bytes(kSmem, lut_bytes, rows),
             static_cast<const LutT*>(nullptr));
  });
}

// f(kernel, shared memory bytes, a null LUT pointer of the kernel's type)
// of fused_qkv_norm and of fused_moe_ffn for the LUT layout.
template <typename F>
cudaError_t with_qkv(int rows, int packed, int smem_lut, int lut_bytes, F&& f) {
  return amsim::with_lut(packed, smem_lut, [&](auto kind) {
    using LutT = typename decltype(kind)::T;
    constexpr bool kSmem = decltype(kind)::smem;
    return f(qkv_kernel<LutT, kSmem>, fold_smem_bytes(kSmem, lut_bytes, rows),
             static_cast<const LutT*>(nullptr));
  });
}

template <typename F>
cudaError_t with_moe(int E, int C, int packed, int smem_lut, int lut_bytes, F&& f) {
  return amsim::with_lut(packed, smem_lut, [&](auto kind) {
    using LutT = typename decltype(kind)::T;
    constexpr bool kSmem = decltype(kind)::smem;
    return f(moe_ffn_kernel<LutT, kSmem>, moe_smem_bytes(kSmem, lut_bytes, E, C),
             static_cast<const LutT*>(nullptr));
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
  return static_cast<int>(
      with_qkv(rows, packed, smem_lut, lut_bytes, [&](auto kernel, int smem, auto null_lut) {
        int blocks = 0;
        cudaError_t err = amsim::grid_size(kernel, smem, qkv_items(rows, p.n), &blocks);
        if (err != cudaSuccess) return err;
        kernel<<<blocks, amsim::kThreads, smem, s>>>(
            p, static_cast<decltype(null_lut)>(lut), M, lut_bytes);
        return cudaGetLastError();
      }));
}

// The grid a fused_qkv_norm launch of these shapes takes, without
// launching: out = {blocks, work items}.
extern "C" int qkv_grid(int rows, int nq, int nk, int nv, int packed, int smem_lut,
                        int lut_bytes, long long* out, void*) {
  const int n[3] = {nq, nk, nv};
  out[1] = qkv_items(rows, n);
  return static_cast<int>(
      with_qkv(rows, packed, smem_lut, lut_bytes, [&](auto kernel, int smem, auto) {
        int blocks = 0;
        const cudaError_t err = amsim::grid_size(kernel, smem, out[1], &blocks);
        out[0] = blocks;
        return err;
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
  const long long work = back_half_work(rows, d, F, 0, 0, items);
  return static_cast<int>(
      with_back_half(0, rows, packed, smem_lut, lut_bytes, [&](auto kernel, int smem) {
        return launch_cooperative(kernel, smem, work, args, static_cast<cudaStream_t>(stream));
      }));
}

// Positions are q_pos (1,) and k_pos (T,), or with `per_row` q_pos (rows,
// 1) and k_pos (rows, T): row b of the batch reads its own.
// The attention phase's layout (cw, vkb, scores_smem: approx_attention.py
// attention_layout) must fit fold_bytes(rows); where the scores are in
// global memory, scratch holds R x T floats for each of `scratch_blocks`
// blocks.
extern "C" int fused_attn_out_mlp_f32(
    const float* x, const float* q, const float* k, const float* v, const int* q_pos,
    const int* k_pos, const float* g2, const float* wo, const float* wg, const float* wu,
    const float* wd, const float* bo, const float* bd, const void* lut, float* out, float* x1,
    float* act, float* attn, float* scratch, int H, int KV, int T, int dh, int causal,
    int window, int per_row, int cw, int vkb, int scores_smem, int scratch_blocks, int rows,
    int d, int K, int F, float eps, int M, int packed, int smem_lut, int lut_bytes,
    void* stream) {
  Chain c{x, attn, g2, wo, wg, wu, wd, bo, bd, out, x1, act, rows, d, K, F, eps};
  amsim::Attn a{q, k, v, q_pos, k_pos, rows, 1, H, KV, T, dh, causal, window,
                per_row ? 1 : 0, per_row ? T : 0};
  amsim::AttnLayout L{cw, vkb, scores_smem};
  if (cw < 1 || cw > amsim::kDimChunk || vkb < 1 || vkb > AttnPhaseTile::KB ||
      amsim::attn_smem_bytes(kAttnRows, AttnPhaseTile::KB, dh, T, L) > fold_bytes(rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int m = M, lb = lut_bytes, sb = scratch_blocks;
  void* args[] = {&c, &a, &L, &attn, &scratch, &sb, &lut, &m, &lb};
  long long items[4];
  const long long work = back_half_work(rows, d, F, H, KV, items);
  return static_cast<int>(
      with_back_half(H, rows, packed, smem_lut, lut_bytes, [&](auto kernel, int smem) {
        return launch_cooperative(kernel, smem, work, args, static_cast<cudaStream_t>(stream));
      }));
}

// The grid a back-half launch of these shapes takes, without launching:
// out = {blocks, wo items, gate/up items, down items, attention tiles}
// (heads = 0: fused_out_mlp, no attention phase).
extern "C" int back_half_grid(int rows, int d, int F, int heads, int kv_heads, int packed,
                              int smem_lut, int lut_bytes, long long* out, void*) {
  long long items[4];
  const long long work = back_half_work(rows, d, F, heads, kv_heads, items);
  for (int i = 0; i < 4; ++i) out[i + 1] = items[i];
  return static_cast<int>(
      with_back_half(heads, rows, packed, smem_lut, lut_bytes, [&](auto kernel, int smem) {
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
  return static_cast<int>(
      with_wo_norm(rows, packed, smem_lut, lut_bytes, [&](auto kernel, int smem, auto null_lut) {
        auto lut_t = static_cast<decltype(null_lut)>(lut);
        int m = M, lb = lut_bytes;
        void* args[] = {&c, &lut_t, &m, &lb};
        return launch_cooperative(kernel, smem, wo_norm_work(rows, d), args,
                                  static_cast<cudaStream_t>(stream));
      }));
}

// The grid a fused_wo_norm launch of these shapes takes, without
// launching: out = {blocks, wo work items}.
extern "C" int wo_norm_grid(int rows, int d, int packed, int smem_lut, int lut_bytes,
                            long long* out, void*) {
  out[1] = fold_items<kNarrowCols>(rows, d);
  return static_cast<int>(
      with_wo_norm(rows, packed, smem_lut, lut_bytes, [&](auto kernel, int smem, auto) {
        int blocks = 0;
        const cudaError_t err = amsim::grid_size(kernel, smem, wo_norm_work(rows, d), &blocks);
        out[0] = blocks;
        return err;
      }));
}

extern "C" int fused_moe_ffn_f32(const float* h, const float* wg, const float* wu,
                                 const float* wd, const void* lut, float* out, float* act,
                                 int* live, int E, int C, int d, int F, int M, int packed,
                                 int smem_lut, int lut_bytes, void* stream) {
  Moe p{h, wg, wu, wd, act, out, live, E, C, d, F};
  const long long work = moe_work(E, C, d, F, smem_lut);
  return static_cast<int>(
      with_moe(E, C, packed, smem_lut, lut_bytes, [&](auto kernel, int smem, auto null_lut) {
        auto lut_t = static_cast<decltype(null_lut)>(lut);
        int m = M, lb = lut_bytes;
        void* args[] = {&p, &lut_t, &m, &lb};
        return launch_cooperative(kernel, smem, work, args, static_cast<cudaStream_t>(stream));
      }));
}

// The grid an expert-bank launch of these shapes takes, without launching:
// out = {blocks, gate/up items, down items} for the live row counts
// live[0 .. E) (a host array), or for a full buffer when live is null.
extern "C" int moe_ffn_grid(int E, int C, int d, int F, const int* live, int packed,
                            int smem_lut, int lut_bytes, long long* out, void*) {
  long long groups = 0;
  for (int e = 0; e < E; ++e) groups += ((live ? live[e] : C) + kMoeRows - 1) / kMoeRows;
  moe_items(groups, d, F, smem_lut, out + 1);
  return static_cast<int>(
      with_moe(E, C, packed, smem_lut, lut_bytes, [&](auto kernel, int smem, auto) {
        int blocks = 0;
        const cudaError_t err =
            amsim::grid_size(kernel, smem, moe_work(E, C, d, F, smem_lut), &blocks);
        out[0] = blocks;
        return err;
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

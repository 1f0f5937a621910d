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
// is a third index of the blocks' walk over output tiles, so one launch
// covers the whole batch and each block stages the LUT once for every
// tile it serves.  The 2-D GEMM is the batch of one.
//
// What bounds it on the H100: operations.  A LUT product cannot use the
// tensor cores (wgmma multiplies, it does not look up), so each product
// is a gather from the table plus integer work, and the gathers, 32
// random addresses over 32 banks a warp, are what the SM issues slowest.
// The design cuts everything around the gather:
// - Operands are decoded once, not once a product: as a k-slab is stored
//   into shared memory each word becomes (sign | pre-shifted mantissa
//   index part, exponent) with a zero exponent field turned into a large
//   negative number, so AMSim's three flush tests are one compare of the
//   exponent sum; a product is then an xor (index and sign at once), the
//   gather, an add, a shift-add of the exponent onto the table entry, the
//   overflow clamp, the zero select, an or and the FADD (`product`, in
//   amsim_decoded.cuh, which the conv weight-gradient kernel shares).
// - Tiled path (m > 8): 8 warps a block, lanes along n so that the 32
//   lanes of a gather read 32 different columns' indices; each thread
//   holds a TM x TN register tile, so a decoded A word serves TN products
//   and a B word TM.  The next k-slab is loaded into registers while the
//   current one folds and is decoded into the other shared buffer: one
//   block barrier every 16 k steps.  (Registers, not a cp.async ring: each
//   word is decoded on its way into shared memory, so it passes through
//   registers anyway.)
// - Column path (m <= 8: decode heads, the router; and products too small
//   for a register tile): a thread a column with the accumulators of its
//   row group (up to 8 rows; one where the columns are too few to fill
//   the SMs, as the router's 40) in registers; A's rows are decoded into
//   shared memory 1024 words at a time (128 k steps of 8 rows, 1024 of
//   one) and read by broadcast,
//   B is streamed from global memory 16-64 k steps ahead, coalesced, with
//   no barrier inside a chunk.  At 4 rows this case is near its byte bound
//   (B is read once).
// - A row tile whose A rows hold no non-zero exponent field (an empty
//   MoE capacity row, a row of zeros or subnormals) makes every product
//   +-0 by AMSim's zero test, whatever B holds, so its sums from +0.0 are
//   +0.0: the block writes that and reads no B for the tile.  The scan
//   stops at the first live word, so a live tile costs a load or two.
// - The table sits in shared memory when it fits (kernels/common.py:
//   lut_in_smem): canonical uint32, or packed uint16 expanded to canonical
//   at staging (no unpack a product) where the fold is long, else kept
//   packed; larger tables are read from global memory through the
//   read-only cache.
// The host picks the path, the register tile and the table form
// (approx_gemm.py:gemm_plan) and passes them in; blocks walk the tiles
// grid-stride, as many as fit on the card (amsim::grid_size).
//
// Each output folds k strictly in order, acc = acc + amsim(a[i,k], b[k,j])
// from +0.0f: the chunk=1 order of the TPU kernel and of the plain version
// (kernels/ref.py:ref_amsim_gemm): no split-k, no atomics, no
// reassociation, so results are bitwise equal to both.  Built without
// fast-math flags: the sum must round, and keep denormals, as the CPU does.
#include "amsim_decoded.cuh"

namespace {

using namespace amsim;

constexpr int kWarps = 8;            // tiled path: 8 warps a block
constexpr int kTiledThreads = 32 * kWarps;
constexpr int kBK = 16;              // tiled path: k steps a slab
// Column path: A words decoded at once (k steps x rows).  8 KiB a plane, so
// that 3 blocks of 4 rows fit an SM beside a 64 KiB table (the decode heads).
constexpr int kChunkWords = 1024;
constexpr int kColumnMaxThreads = 128;

struct Args {
  const float* a;
  const float* b;
  const void* lut;
  float* out;
  int batch, m, k, n, M, packed;
};

// Whether `count` consecutive words from w hold a non-zero exponent field;
// each thread stops at its first one.
__device__ __forceinline__ bool any_live(const float* w, long long count) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(w);
  for (long long i = threadIdx.x; i < count; i += blockDim.x) {
    if (__ldg(u + i) & 0x7F800000u) return true;
  }
  return false;
}

// N consecutive words of shared memory (16-, 8- or 4-byte aligned as N).
template <int N>
__device__ __forceinline__ void lds(const uint32_t* s, uint32_t (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint4 t = reinterpret_cast<const uint4*>(s)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(s);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = s[0];
  }
}

// ------------------------------------------------------------ tiled path
// Tile BM x BN = 8 TM x 32 TN: warp w owns rows w*TM .. w*TM + TM - 1, lane
// l columns l, l + 32, ..  A slab planes [buf][kk][row] (rows padded by 4
// against bank conflicts on the decode's stores), B planes [buf][kk][col].
template <int TM, int TN>
struct Tiled {
  static constexpr int BM = kWarps * TM, BN = 32 * TN, BMP = BM + 4;
  static constexpr int LA = (BM * kBK + kTiledThreads - 1) / kTiledThreads;
  static constexpr int LB = (kBK * BN + kTiledThreads - 1) / kTiledThreads;
  static constexpr int kBufBytes = 4 * 2 * 2 * kBK * (BMP + BN);  // 2 buffers x 2 planes
};

template <int TM, int TN, int kKind>
__global__ void __launch_bounds__(kTiledThreads)
gemm_tiled_kernel(Args p) {
  using T = Tiled<TM, TN>;
  constexpr int BM = T::BM, BN = T::BN, BMP = T::BMP;
  extern __shared__ __align__(16) unsigned char smem[];
  const Table<kKind> tab = make_table<kKind>(p, smem);
  uint32_t* ai = reinterpret_cast<uint32_t*>(smem + table_smem_bytes(kKind, p.M));
  uint32_t* ae = ai + 2 * kBK * BMP;
  uint32_t* bi = ae + 2 * kBK * BMP;
  uint32_t* be = bi + 2 * kBK * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m = p.m, k = p.k, n = p.n, M = p.M;
  const int tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const long long per_batch = static_cast<long long>(tiles_m) * tiles_n;
  const int slabs = (k + kBK - 1) / kBK;

  for (long long t = blockIdx.x; t < per_batch * p.batch; t += gridDim.x) {
    const long long e = t / per_batch;
    const int rest = static_cast<int>(t % per_batch);
    const int row0 = (rest / tiles_n) * BM, col0 = (rest % tiles_n) * BN;
    const int rows = min(BM, m - row0);
    const float* a = p.a + (e * m + row0) * static_cast<long long>(k);
    const float* b = p.b + e * static_cast<long long>(k) * n;
    float* out = p.out + (e * m + row0) * static_cast<long long>(n);

    if (!__syncthreads_or(any_live(a, static_cast<long long>(rows) * k))) {
      for (int i = tid; i < rows * BN; i += kTiledThreads) {
        const int c = col0 + i % BN;
        if (c < n) out[static_cast<size_t>(i / BN) * n + c] = 0.0f;
      }
      continue;
    }

    uint32_t ra[T::LA], rb[T::LB];
    auto load = [&](int k0) {
#pragma unroll
      for (int i = 0; i < T::LA; ++i) {
        const int x = tid + i * kTiledThreads, r = x / kBK, kk = x % kBK;
        ra[i] = (x < BM * kBK && r < rows && k0 + kk < k)
                    ? __float_as_uint(__ldg(a + static_cast<size_t>(r) * k + k0 + kk))
                    : 0u;
      }
#pragma unroll
      for (int i = 0; i < T::LB; ++i) {
        const int x = tid + i * kTiledThreads, kk = x / BN, c = x % BN;
        rb[i] = (x < kBK * BN && k0 + kk < k && col0 + c < n)
                    ? __float_as_uint(__ldg(b + static_cast<size_t>(k0 + kk) * n + col0 + c))
                    : 0u;
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int i = 0; i < T::LA; ++i) {
        const int x = tid + i * kTiledThreads, r = x / kBK, kk = x % kBK;
        if (x < BM * kBK) {
          const int at = (buf * kBK + kk) * BMP + r;
          decode_a(ra[i], M, ai[at], ae[at]);
        }
      }
#pragma unroll
      for (int i = 0; i < T::LB; ++i) {
        const int x = tid + i * kTiledThreads, kk = x / BN, c = x % BN;
        if (x < kBK * BN) {
          const int at = (buf * kBK + kk) * BN + c;
          decode_b(rb[i], M, bi[at], be[at]);
        }
      }
    };

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    load(0);
    store(0);
    __syncthreads();
    for (int s = 0; s < slabs; ++s) {
      const int buf = s & 1;
      if (s + 1 < slabs) load((s + 1) * kBK);
      const uint32_t* ai_s = ai + buf * kBK * BMP + warp * TM;
      const uint32_t* ae_s = ae + buf * kBK * BMP + warp * TM;
      const uint32_t* bi_s = bi + buf * kBK * BN + lane;
      const uint32_t* be_s = be + buf * kBK * BN + lane;
      auto fold = [&](int kk) {
        uint32_t xa[TM], ya[TM], xb[TN], yb[TN];
        lds<TM>(ai_s + kk * BMP, xa);
        lds<TM>(ae_s + kk * BMP, ya);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          xb[j] = bi_s[kk * BN + 32 * j];
          yb[j] = be_s[kk * BN + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = acc[i][j] + product(xa[i], ya[i], xb[j], yb[j], tab, M);
      };
      const int kk_end = min(kBK, k - s * kBK);
      if (kk_end == kBK) {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) fold(kk);
      } else {
        for (int kk = 0; kk < kk_end; ++kk) fold(kk);
      }
      if (s + 1 < slabs) store(buf ^ 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = warp * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = col0 + lane + 32 * j;
        if (r < rows && c < n) out[static_cast<size_t>(r) * n + c] = acc[i][j];
      }
    }
  }
}

// ----------------------------------------------------------- column path
// blockDim.x threads, a column each, holding MR rows: tile t is batch t /
// (tiles of a product), row group (t % that) / tiles_n of MR rows, columns
// (t % tiles_n) * blockDim.x ..  A's rows decoded into [kk][row] planes of
// kChunkWords / MR steps.  m <= 8 is one row group of MR >= m (the small-m
// path) unless the plan splits it; it also sends here a larger m whose
// product is too small for a register tile.
constexpr int kColumnBufBytes = 4 * 2 * kChunkWords;  // two planes

template <int MR, int kKind>
__global__ void __launch_bounds__(kColumnMaxThreads)
gemm_column_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Table<kKind> tab = make_table<kKind>(p, smem);
  uint32_t* ai = reinterpret_cast<uint32_t*>(smem + table_smem_bytes(kKind, p.M));
  uint32_t* ae = ai + kChunkWords;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = p.m, k = p.k, n = p.n, M = p.M;
  const int tiles_m = (m + MR - 1) / MR, tiles_n = (n + nt - 1) / nt;
  const long long per_batch = static_cast<long long>(tiles_m) * tiles_n;

  for (long long t = blockIdx.x; t < per_batch * p.batch; t += gridDim.x) {
    const long long e = t / per_batch;
    const int rest = static_cast<int>(t % per_batch);
    const int row0 = (rest / tiles_n) * MR, rows = min(MR, m - row0);
    const int col = (rest % tiles_n) * nt + tid;
    const bool in = col < n;
    const float* a = p.a + (e * m + row0) * static_cast<long long>(k);
    const float* b = p.b + e * static_cast<long long>(k) * n + col;
    float* out = p.out + (e * m + row0) * static_cast<long long>(n) + col;

    if (!__syncthreads_or(any_live(a, static_cast<long long>(rows) * k))) {
      if (in) {
#pragma unroll
        for (int r = 0; r < MR; ++r)
          if (r < rows) out[static_cast<size_t>(r) * n] = 0.0f;
      }
      continue;
    }

    float acc[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[r] = 0.0f;
    constexpr int KC = kChunkWords / MR;  // k steps a chunk
    // B words loaded ahead: enough steps to cover a load's latency where a
    // thread has few rows to fold a step (the router: 4 blocks of one row
    // group, nothing else on their SMs to hide it).
    constexpr int kAhead = MR == 1 ? 64 : MR == 2 ? 32 : 16;
    for (int k0 = 0; k0 < k; k0 += KC) {
      const int kc = min(KC, k - k0);
      const float* bc = b + static_cast<size_t>(k0) * n;
      uint32_t next[kAhead];
      auto fetch = [&](int kk0) {
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          next[u] = (in && kk0 + u < kc)
                        ? __float_as_uint(__ldg(bc + static_cast<size_t>(kk0 + u) * n))
                        : 0u;
        }
      };
      fetch(0);         // in flight while A's chunk is decoded
      __syncthreads();  // the previous chunk's readers are done
      // Up to a whole number of kAhead steps (kAhead divides KC): the steps
      // past kc decode +0.0, a valid table index, and are not added.
      const int kc_pad = (kc + kAhead - 1) / kAhead * kAhead;
      for (int i = tid; i < MR * kc_pad; i += nt) {
        const int r = i / kc_pad, kk = i % kc_pad;
        const uint32_t u =
            r < rows && kk < kc
                ? __float_as_uint(__ldg(a + static_cast<size_t>(r) * k + k0 + kk))
                : 0u;
        decode_a(u, M, ai[kk * MR + r], ae[kk * MR + r]);
      }
      __syncthreads();
      for (int kk0 = 0; kk0 < kc; kk0 += kAhead) {
        uint32_t cur[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) cur[u] = next[u];
        if (kk0 + kAhead < kc) fetch(kk0 + kAhead);
        const int steps = min(kAhead, kc - kk0);
        // The products of G steps first (independent gathers, issued back to
        // back), then their adds in k order, the steps past kc left out.
        constexpr int G = MR >= 4 ? 32 / MR : 16;
#pragma unroll
        for (int g = 0; g < kAhead; g += G) {
          float prod[G][MR];
#pragma unroll
          for (int u = 0; u < G; ++u) {
            uint32_t xb, yb, xa[MR], ya[MR];
            decode_b(cur[g + u], M, xb, yb);
            lds<MR>(ai + (kk0 + g + u) * MR, xa);
            lds<MR>(ae + (kk0 + g + u) * MR, ya);
#pragma unroll
            for (int r = 0; r < MR; ++r) prod[u][r] = product(xa[r], ya[r], xb, yb, tab, M);
          }
#pragma unroll
          for (int u = 0; u < G; ++u) {
            if (g + u < steps) {
#pragma unroll
              for (int r = 0; r < MR; ++r) acc[r] = acc[r] + prod[u][r];
            }
          }
        }
      }
    }
    if (in) {
#pragma unroll
      for (int r = 0; r < MR; ++r)
        if (r < rows) out[static_cast<size_t>(r) * n] = acc[r];
    }
  }
}

// ---------------------------------------------------------------- launch
// Calls f(kernel, threads, shared bytes, tile rows, tile columns) with the
// kernel instance of a plan: `path` 0 tiled (`rows` x `cols` = TM x TN a
// thread), 1 column (`rows` a thread, `cols` threads a block).
template <int kKind, class F>
cudaError_t with_path(int M, int path, int rows, int cols, F&& f) {
  const int table = table_smem_bytes(kKind, M);
  if (path == 1) {
    if (cols < 1 || cols > kColumnMaxThreads) return cudaErrorInvalidValue;
    const int smem = table + kColumnBufBytes;
    switch (rows) {
      case 1: return f(gemm_column_kernel<1, kKind>, cols, smem, 1, cols);
      case 2: return f(gemm_column_kernel<2, kKind>, cols, smem, 2, cols);
      case 4: return f(gemm_column_kernel<4, kKind>, cols, smem, 4, cols);
      case 8: return f(gemm_column_kernel<8, kKind>, cols, smem, 8, cols);
      default: return cudaErrorInvalidValue;
    }
  }
  if (path != 0) return cudaErrorInvalidValue;
  auto tiled = [&](auto kernel, auto shape) {
    using T = decltype(shape);
    return f(kernel, kTiledThreads, table + T::kBufBytes, T::BM, T::BN);
  };
  if (rows == 8 && cols == 2) return tiled(gemm_tiled_kernel<8, 2, kKind>, Tiled<8, 2>{});
  if (rows == 4 && cols == 2) return tiled(gemm_tiled_kernel<4, 2, kKind>, Tiled<4, 2>{});
  if (rows == 2 && cols == 1) return tiled(gemm_tiled_kernel<2, 1, kKind>, Tiled<2, 1>{});
  if (rows == 1 && cols == 1) return tiled(gemm_tiled_kernel<1, 1, kKind>, Tiled<1, 1>{});
  return cudaErrorInvalidValue;
}

// with_path for the table form `table` (TableKind), which must suit the
// stored layout (`packed`: uint16 entries).
template <class F>
cudaError_t with_plan(int M, int packed, int table, int path, int rows, int cols, F&& f) {
  if (M < 1 || M > 12) return cudaErrorInvalidValue;
  switch (table) {
    case kSmemCanon: return with_path<kSmemCanon>(M, path, rows, cols, f);
    case kSmemPacked:
      return packed ? with_path<kSmemPacked>(M, path, rows, cols, f) : cudaErrorInvalidValue;
    case kGlobalCanon:
      return packed ? cudaErrorInvalidValue : with_path<kGlobalCanon>(M, path, rows, cols, f);
    case kGlobalPacked:
      return packed ? with_path<kGlobalPacked>(M, path, rows, cols, f) : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// Output tiles of a (batch, m, n) result in tiles of bm x bn: the work the
// blocks walk grid-stride.
long long tile_count(int batch, int m, int n, int bm, int bn) {
  return static_cast<long long>(batch) * ((m + bm - 1) / bm) * ((n + bn - 1) / bn);
}

}  // namespace

// Each returns a cudaError_t code: 0 when the launch was accepted.
// `packed` says the LUT holds uint16 entries; the rest is the plan of
// approx_gemm.py:gemm_plan: `table` (TableKind), `path` (0 tiled, 1 column),
// `rows` and `cols` (tiled: the register tile TM x TN; column: the rows a
// thread holds and the threads a block).  The grid is as many blocks as fit
// on the card (amsim::grid_size), no more than there are tiles.
extern "C" int approx_gemm_batched_f32(const float* a, const float* b, const void* lut,
                                       float* out, int batch, int m, int k, int n, int M,
                                       int packed, int table, int path, int rows, int cols,
                                       void* stream) {
  const Args args{a, b, lut, out, batch, m, k, n, M, packed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_plan(
      M, packed, table, path, rows, cols, [&](auto kernel, int threads, int smem, int bm, int bn) {
        int blocks = 0;
        const cudaError_t err =
            amsim::grid_size(kernel, smem, tile_count(batch, m, n, bm, bn), &blocks, threads);
        if (err != cudaSuccess) return err;
        kernel<<<blocks, threads, smem, s>>>(args);
        return cudaGetLastError();
      }));
}

extern "C" int approx_gemm_f32(const float* a, const float* b, const void* lut, float* out,
                               int m, int k, int n, int M, int packed, int table, int path,
                               int rows, int cols, void* stream) {
  return approx_gemm_batched_f32(a, b, lut, out, 1, m, k, n, M, packed, table, path, rows, cols,
                                 stream);
}

// The grid a launch of this plan and shape takes, without launching:
// out = {blocks, tiles, shared bytes a block}.
extern "C" int approx_gemm_grid(int batch, int m, int n, int M, int packed, int table, int path,
                                int rows, int cols, long long* out, void*) {
  return static_cast<int>(with_plan(
      M, packed, table, path, rows, cols, [&](auto kernel, int threads, int smem, int bm, int bn) {
        int blocks = 0;
        out[1] = tile_count(batch, m, n, bm, bn);
        out[2] = smem;
        const cudaError_t err = amsim::grid_size(kernel, smem, out[1], &blocks, threads);
        out[0] = blocks;
        return err;
      }));
}

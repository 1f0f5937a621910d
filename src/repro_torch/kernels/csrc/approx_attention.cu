// approx_attention: softmax(mask(q k^T / sqrt(dh))) v with both
// contractions simulated by AMSim, in one launch.
//
// Replaces the TPU kernel repro/kernels/approx_attention.py:_attn_kernel
// (launched by approx_attention_fused).  There one grid cell holds the K/V
// of a (batch, kv-head) and a (q-block x T) score tile in VMEM, so the
// q-block's rows share every K and V word.  Here a block takes the same
// unit, a tile (attention.cuh attend_tile): one group (b, kv-head), whose G
// query heads share one K and one V, and R of its S x G query rows, with
// K and V decoded once in shared memory and register tiles of rows x keys
// (scores) and rows x dims (values).  The scores stay in shared memory
// when they fit, else in a global scratch of R x T floats a block, so
// every shape is taken.
//
// What bounds it on the H100: at prefill, operations (two LUT products
// per (query row, live key, head dim), a gather from the table plus ~10
// integer instructions each); at decode, the K/V bytes of the live keys
// and the latency of a tile's few dependent stages.  The host plans the
// tile (approx_attention.py attention_plan): 64, 32 or 16 rows at prefill
// (slabs of 64 keys), the G <= 4 heads of a group at decode (slabs of 128
// keys); slabs are skipped where no row of the tile has a valid key
// (scores) or every p is +0.0 (values); the table expanded to canonical
// words in shared memory, copied there as stored (cp.async, under the
// first tile's Q staging), or read from global memory.  Blocks walk the
// tiles grid-stride, as many as fit on the card (amsim::grid_size).
// Bitwise equal to kernels/approx_attention.py:approx_attention_plain.
#include <algorithm>
#include <climits>
#include <type_traits>

#include "attention.cuh"

namespace {

using namespace amsim;

struct AttnArgs {
  Attn a;
  AttnLayout L;
  const void* lut;   // make_table reads lut, M and packed
  float* out;
  float* scratch;    // R x T floats a block when the scores are in global memory
  int M, packed;
};

// A packed table is copied as stored without waiting (copy_async): the
// copy runs under the first tile's Q staging.  Other forms are staged by
// make_table (a packed table expanded to canonical words).
template <int RT, int TM, int TN, int kKind>
__global__ void __launch_bounds__(kThreads)
attention_kernel(AttnArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Table<kKind> tab;
  if constexpr (kKind == kSmemPacked) {
    copy_async(smem, p.lut, 2 << (2 * p.M));
    tab = Table<kSmemPacked>{static_cast<uint32_t>(__cvta_generic_to_shared(smem))};
  } else {
    tab = make_table<kKind>(p, smem);
  }
  attention_tiles<RT, TM, TN>(p.a, p.L, tab, p.M, smem + table_smem_bytes(kKind, p.M),
                              p.scratch, gridDim.x, p.out);
}

// f(kernel, rows a tile, keys a K slab) of tile `tile` (approx_attention.py
// ATTN_TILES).
template <int kKind, class F>
cudaError_t with_tile(int tile, F&& f) {
  auto run = [&](auto kernel, auto t) { return f(kernel, decltype(t)::R, decltype(t)::KB); };
  switch (tile) {
    case 0: return run(attention_kernel<16, 4, 4, kKind>, AttnTile<16, 4, 4>{});
    case 1: return run(attention_kernel<16, 2, 4, kKind>, AttnTile<16, 2, 4>{});
    case 2: return run(attention_kernel<8, 2, 2, kKind>, AttnTile<8, 2, 2>{});
    case 3: return run(attention_kernel<4, 1, 2, kKind>, AttnTile<4, 1, 2>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(kernel, rows a tile, shared bytes a block) of the plan.
template <class F>
cudaError_t with_plan(const Attn& a, const AttnLayout& L, int M, int packed, int table, int tile,
                      F&& f) {
  if (M < 1 || M > 12 || L.cw < 1 || L.cw > kDimChunk || L.vkb < 1) {
    return cudaErrorInvalidValue;
  }
  auto run = [&](auto kind) {
    constexpr int kKind = decltype(kind)::value;
    return with_tile<kKind>(tile, [&](auto kernel, int R, int KB) {
      const long long smem = table_smem_bytes(kKind, M) + attn_smem_bytes(R, KB, a.dh, a.T, L);
      if (L.vkb > KB || smem > INT_MAX) return cudaErrorInvalidValue;
      return f(kernel, R, static_cast<int>(smem));
    });
  };
  switch (table) {
    case kSmemCanon: return run(std::integral_constant<int, kSmemCanon>{});
    case kSmemPacked:
      return packed ? run(std::integral_constant<int, kSmemPacked>{}) : cudaErrorInvalidValue;
    case kGlobalCanon:
      return packed ? cudaErrorInvalidValue : run(std::integral_constant<int, kGlobalCanon>{});
    case kGlobalPacked:
      return packed ? run(std::integral_constant<int, kGlobalPacked>{}) : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.  Positions
// are q_pos (S,) and k_pos (T,), or with `per_row` q_pos (B, S) and k_pos
// (B, T).  `packed`
// says the LUT holds uint16 entries; `table` (TableKind), `tile`, `cw`,
// `vkb` and `scores_smem` are the plan of approx_attention.py
// attention_plan.  Where the scores are in global memory, scratch holds
// R x T floats for each of `scratch_blocks` blocks, and the grid takes no
// more blocks than that.
extern "C" int approx_attention_f32(const float* q, const float* k, const float* v,
                                    const int* q_pos, const int* k_pos, const void* lut,
                                    float* out, float* scratch, int B, int S, int H, int KV,
                                    int T, int dh, int causal, int window, int per_row,
                                    int M, int packed, int table, int tile, int cw, int vkb,
                                    int scores_smem, int scratch_blocks, void* stream) {
  const AttnArgs args{amsim::Attn{q, k, v, q_pos, k_pos, B, S, H, KV, T, dh, causal, window,
                                  per_row ? S : 0, per_row ? T : 0},
                      amsim::AttnLayout{cw, vkb, scores_smem}, lut, out, scratch, M, packed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_plan(
      args.a, args.L, M, packed, table, tile, [&](auto kernel, int R, int smem) {
        int blocks = 0;
        const cudaError_t err =
            amsim::grid_size(kernel, smem, amsim::attn_tiles(args.a, R), &blocks);
        if (err != cudaSuccess) return err;
        if (!scores_smem) blocks = std::min(blocks, scratch_blocks);
        if (blocks <= 0) return cudaSuccess;
        kernel<<<blocks, amsim::kThreads, smem, s>>>(args);
        return cudaGetLastError();
      }));
}

// The grid a launch of this plan and shape takes, without launching:
// out = {blocks, tiles, shared bytes a block}.
extern "C" int approx_attention_grid(int B, int S, int H, int KV, int T, int dh, int M,
                                     int packed, int table, int tile, int cw, int vkb,
                                     int scores_smem, long long* out, void*) {
  const amsim::Attn a{nullptr, nullptr, nullptr, nullptr, nullptr, B, S, H, KV, T, dh, 1, 0};
  const amsim::AttnLayout L{cw, vkb, scores_smem};
  auto grid = [&](auto kernel, int R, int smem) {
    int blocks = 0;
    out[1] = amsim::attn_tiles(a, R);
    out[2] = smem;
    const cudaError_t err = amsim::grid_size(kernel, smem, out[1], &blocks);
    out[0] = blocks;
    return err;
  };
  return static_cast<int>(with_plan(a, L, M, packed, table, tile, grid));
}

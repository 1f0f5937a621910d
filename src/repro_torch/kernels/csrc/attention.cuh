// What the attention and decode-chain kernels share: the warp sums in the
// order of kernels/common.py:lane_sum, the attention core of a tile of
// query rows, and the dispatch over the four LUT layouts.
//
// The attention core is the port of the body of
// repro/kernels/approx_attention.py:_attn_kernel, whose grid cell is a
// (batch x kv-head, q-block) pair: a LUT score GEMM, the 1/sqrt(dh) scale,
// the position mask, the whole-row softmax and a LUT value GEMM.  Here a
// block takes a tile: one group (b, kv-head), whose G = H / KV query heads
// share one K and one V, and R of its S x G query rows (row s * G + g is
// position s, head kv-head * G + g).  Its 256 threads work as RT row
// threads x KT lanes (AttnTile):
// - Q of the tile is decoded once into shared memory (decode_a); K comes
//   in slabs of KB keys (64, or 128 for the decode tile), each word
//   decoded once on its way in (decode_b), dims in chunks of at most
//   kDimChunk.  A thread holds a register tile of TM rows x TN keys (keys
//   kt, kt + KT, ...: the lanes of a warp read neighbouring keys, and share
//   the q word of a gather, whose bank the key's mantissa then sets) and
//   folds each score's dh products in order from +0.0 (`product` of
//   amsim_decoded.cuh), then divides by sqrt(dh).  A masked key scores
//   kNegInf.  A slab in which no row of the
//   tile has a valid key is skipped: its scores are kNegInf and nothing is
//   multiplied (its K, which may hold any bits, is never read).
// - The scores of the tile (R x T floats) live in shared memory when they
//   fit, else in a global scratch of the block's own.
// - The softmax, a warp a row: the max (fmaxf), expf(s - max), the
//   denominator in the lane_sum order (lane l adds keys l, l + 32, ... in
//   order, then the butterfly of warp_sum), p = e / sum once per (row, key).
// - The value pass, dims in chunks of kDimChunk: a thread holds TM rows x
//   DN dims (dims kt, kt + KT, ...) and folds the keys in order from +0.0,
//   V in slabs of `vkb` keys decoded on the way in, p of the slab decoded
//   once into shared memory.  A slab is skipped only when p is exactly
//   +0.0 for every row of the tile: amsim(+0, v) is +-0 for every v (the
//   zero test), and adding +-0 to a sum that started at +0.0 never changes
//   it.  (A row with no valid key has a uniform softmax: its p is not zero
//   on masked keys, and it returns the mean of V, as the plain version.)
// No float expression here may be contracted into an FMA: the plain
// versions round each step, so the adds, subtractions and divisions are
// written as _rn intrinsics.
#pragma once

#include "amsim_decoded.cuh"

namespace amsim {

constexpr float kNegInf = -1e30f;    // kernels/common.py NEG_INF
constexpr int kWarps = kThreads / 32;
constexpr int kDimChunk = 64;        // dims of a value chunk, and of a K chunk at most

// Butterfly over the warp: lane l adds lane l ^ 16, l ^ 8, ..., l ^ 1.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Grouped-query attention operands: q (B,S,H,dh), k/v (B,T,KV,dh), all
// contiguous; positions shared by the batch, q_pos (S,) and k_pos (T,), or
// one row a batch row, q_pos (B,S) and k_pos (B,T) (the paged serving
// cache, every slot at its own position): row b's positions start at
// q_pos + b * qpos_b and k_pos + b * kpos_b, strides 0 when shared, S and
// T when per row.  A negative key position is an unwritten slot.
struct Attn {
  const float* q;
  const float* k;
  const float* v;
  const int* q_pos;
  const int* k_pos;
  int B, S, H, KV, T, dh, causal, window;
  int qpos_b = 0, kpos_b = 0;
};

// A block's threads as RT row threads x KT lanes: a tile of R = RT x TM
// rows, K slabs of KB = KT x TN keys, value chunks of KT x DN = kDimChunk
// dims.  The tiles the kernels take (kernels/approx_attention.py
// ATTN_TILES, in this order): 64, 32 and 16 rows with slabs of 64 keys
// (prefill), 4 rows with slabs of 128 (decode).
template <int RT, int TM, int TN>
struct AttnTile {
  static constexpr int KT = kThreads / RT;
  static constexpr int R = RT * TM;
  static constexpr int KB = KT * TN;
  static constexpr int DN = kDimChunk / KT;
  static_assert(KT * DN == kDimChunk, "a value chunk fills the lanes");
};

// The plan's shared-memory layout of a tile (approx_attention.py
// attention_layout): dims of a K chunk (cw <= kDimChunk), keys of a V slab
// (vkb <= KB), and whether the scores sit in shared memory.
struct AttnLayout {
  int cw, vkb, scores_smem;
};

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Row strides of the decoded planes are odd in uint2 words, so that the 16
// lanes of a half-warp that read 16 rows at one column hit 16 bank pairs.
__host__ __device__ inline int odd(int n) { return n | 1; }

// The regions: row positions (R ints); Q (R x odd(dh), at least R x KB:
// the decoded p of a V slab, R x vkb, reuses it); the K chunk (KB x
// odd(cw)) or the V slab (vkb x odd(min(dh, kDimChunk))); the scores (R x
// T floats) when in shared memory.
__host__ __device__ inline int attn_q_words(int R, int KB, int dh) {
  return R * (odd(dh) > KB ? odd(dh) : KB);
}

__host__ __device__ inline int attn_kv_words(int KB, int dh, const AttnLayout& L) {
  const int k = KB * odd(L.cw);
  const int v = L.vkb * odd(dh < kDimChunk ? dh : kDimChunk);
  return k > v ? k : v;
}

__host__ __device__ inline long long attn_smem_bytes(int R, int KB, int dh, int T,
                                                    const AttnLayout& L) {
  return align16(R * 4) + 8LL * attn_q_words(R, KB, dh) + 8LL * attn_kv_words(KB, dh, L) +
         (L.scores_smem ? (4LL * R * T + 15) / 16 * 16 : 0);
}

struct AttnSmem {
  int* qpos;
  uint2* q;       // Q of the tile, then p of a V slab
  uint2* kv;      // a K chunk or a V slab
  float* scores;  // null when the scores are in global memory
};

__device__ inline AttnSmem carve_attn(unsigned char* base, int R, int KB, int dh,
                                      const AttnLayout& L) {
  AttnSmem s;
  s.qpos = reinterpret_cast<int*>(base);
  s.q = reinterpret_cast<uint2*>(base + align16(R * 4));
  s.kv = s.q + attn_q_words(R, KB, dh);
  s.scores = L.scores_smem ? reinterpret_cast<float*>(s.kv + attn_kv_words(KB, dh, L)) : nullptr;
  return s;
}

__host__ __device__ inline long long attn_groups(const Attn& a) {
  return static_cast<long long>(a.B) * a.KV;
}

__host__ __device__ inline int attn_row_tiles(const Attn& a, int R) {
  return (a.S * (a.H / a.KV) + R - 1) / R;
}

__host__ __device__ inline long long attn_tiles(const Attn& a, int R) {
  return attn_groups(a) * attn_row_tiles(a, R);
}

__device__ __forceinline__ bool key_valid(int qp, int kp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) && (!window || kp > qp - window);
}

// Stage n rows of w floats decoded into dst[i * dstride + j]: row i read
// from src(i), or +0.0 where src(i) is null.  Every thread of the block
// takes part.
template <bool kA, typename Src>
__device__ __forceinline__ void stage_decoded(uint2* dst, int dstride, int n, int w, int M,
                                              bool vec, Src src) {
  auto put = [&](uint2* d, float f) {
    if constexpr (kA) {
      decode_a(__float_as_uint(f), M, d->x, d->y);
    } else {
      decode_b(__float_as_uint(f), M, d->x, d->y);
    }
  };
  if (vec) {  // w % 4 == 0 and 16-byte aligned rows
    const int w4 = w / 4;
    for (int e = threadIdx.x; e < n * w4; e += kThreads) {
      const int i = e / w4, j = 4 * (e % w4);
      const float* p = src(i);
      const float4 f = p ? __ldg(reinterpret_cast<const float4*>(p + j)) : make_float4(0, 0, 0, 0);
      uint2* d = dst + i * dstride + j;
      put(d, f.x);
      put(d + 1, f.y);
      put(d + 2, f.z);
      put(d + 3, f.w);
    }
  } else {
    for (int e = threadIdx.x; e < n * w; e += kThreads) {
      const int i = e / w, j = e % w;
      const float* p = src(i);
      put(dst + i * dstride + j, p ? __ldg(p + j) : 0.0f);
    }
  }
}

// One tile: rows r0 .. r0 + R of group (b, kvh) into out, a (B, S, H, dh)
// array.  Every thread of the block calls it; it starts and ends with no
// shared-memory read or write of another thread outstanding.  scores: the
// tile's R x T floats (shared or global memory).
template <int RT, int TM, int TN, class Tab>
__device__ void attend_tile(const Attn& a, const AttnLayout& L, const Tab& tab, int M,
                            const AttnSmem& sm, float* scores, int b, int kvh, int r0,
                            float* out) {
  using Tile = AttnTile<RT, TM, TN>;
  constexpr int KT = Tile::KT, R = Tile::R, KB = Tile::KB, DN = Tile::DN;
  const int tid = threadIdx.x, rt = tid / KT, kt = tid % KT;
  const int G = a.H / a.KV, dh = a.dh, T = a.T;
  const int nr = min(R, a.S * G - r0);
  const size_t kstep = static_cast<size_t>(a.KV) * dh;   // floats from key t to key t + 1
  const float* kbase = a.k + (static_cast<size_t>(b) * T * a.KV + kvh) * dh;
  const float* vbase = a.v + (static_cast<size_t>(b) * T * a.KV + kvh) * dh;
  const bool vec = (dh & 3) == 0 && ((reinterpret_cast<uintptr_t>(a.q) |
                                       reinterpret_cast<uintptr_t>(a.k) |
                                       reinterpret_cast<uintptr_t>(a.v)) & 15) == 0;
  auto row_offset = [&](int r) {   // of tile row r in q and out
    const int gr = r0 + r;
    return ((static_cast<size_t>(b) * a.S + gr / G) * a.H + kvh * G + gr % G) * dh;
  };

  // Q of the tile, decoded once; the rows' positions.
  const int qs = odd(dh);
  const int* q_pos = a.q_pos + static_cast<size_t>(b) * a.qpos_b;
  const int* k_pos = a.k_pos + static_cast<size_t>(b) * a.kpos_b;
  for (int r = tid; r < R; r += kThreads) sm.qpos[r] = r < nr ? q_pos[(r0 + r) / G] : 0;
  stage_decoded<true>(sm.q, qs, R, dh, M, vec,
                      [&](int r) { return r < nr ? a.q + row_offset(r) : nullptr; });
  asm volatile("cp.async.wait_all;\n" ::: "memory");   // a table staged by copy_async
  __syncthreads();
  int qp[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) qp[i] = sm.qpos[rt * TM + i];

  // The score pass: K slabs of KB keys, each in chunks of cw dims.
  const float scale = sqrtf(static_cast<float>(dh));
  const int ks = odd(L.cw);
  for (int t0 = 0; t0 < T; t0 += KB) {
    bool valid[TM][TN];
    bool any = false;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int t = t0 + kt + KT * j;
      const int kp = t < T ? __ldg(k_pos + t) : -1;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        valid[i][j] = rt * TM + i < nr && key_valid(qp[i], kp, a.causal, a.window);
        any |= valid[i][j];
      }
    }
    if (__syncthreads_or(any)) {
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
      const int nk = min(KB, T - t0);
      for (int c0 = 0; c0 < dh; c0 += L.cw) {
        const int cw = min(L.cw, dh - c0);
        if (c0) __syncthreads();   // the previous chunk is folded
        stage_decoded<false>(sm.kv, ks, KB, cw, M, vec && (cw & 3) == 0, [&](int i) {
          return i < nk ? kbase + (t0 + i) * kstep + c0 : nullptr;
        });
        __syncthreads();
        const uint2* qrow = sm.q + rt * TM * qs + c0;
        const uint2* krow = sm.kv + kt * ks;
#pragma unroll 4
        for (int d = 0; d < cw; ++d) {
          uint2 qa[TM], kb[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) qa[i] = qrow[i * qs + d];
#pragma unroll
          for (int j = 0; j < TN; ++j) kb[j] = krow[j * KT * ks + d];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = __fadd_rn(acc[i][j], product(qa[i].x, qa[i].y, kb[j].x, kb[j].y, tab, M));
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int t = t0 + kt + KT * j;
          if (t < T) {
            scores[static_cast<size_t>(rt * TM + i) * T + t] =
                valid[i][j] ? __fdiv_rn(acc[i][j], scale) : kNegInf;
          }
        }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int t = t0 + kt + KT * j;
          if (t < T) scores[static_cast<size_t>(rt * TM + i) * T + t] = kNegInf;
        }
    }
  }
  __syncthreads();

  // The softmax, a warp a row: p = exp(s - max) / lane_sum, once per key.
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < nr; r += kWarps) {
    float* srow = scores + static_cast<size_t>(r) * T;
    float mx = -__int_as_float(0x7f800000);
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, srow[t]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(__fsub_rn(srow[t], mx));
      srow[t] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = warp_sum(sum);
    for (int t = lane; t < T; t += 32) srow[t] = __fdiv_rn(srow[t], sum);
  }
  __syncthreads();

  // The value pass: chunks of kDimChunk dims, V slabs of vkb keys.
  const int vs = odd(min(dh, kDimChunk));
  const int vkb = L.vkb;
  for (int c0 = 0; c0 < dh; c0 += kDimChunk) {
    const int vc = min(kDimChunk, dh - c0);
    float acc[TM][DN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] = 0.0f;
    int dj[DN];   // this thread's dims in the chunk, clamped to the staged ones
#pragma unroll
    for (int j = 0; j < DN; ++j) dj[j] = min(kt + KT * j, vc - 1);
    for (int t0 = 0; t0 < T; t0 += vkb) {
      const int nk = min(vkb, T - t0);
      // p of the slab, decoded into the Q region ([r][tt], rows of vkb)
      bool any = false;
      for (int e = tid; e < R * vkb; e += kThreads) {
        const int r = e / vkb, tt = e % vkb;
        const float p = r < nr && tt < nk ? scores[static_cast<size_t>(r) * T + t0 + tt] : 0.0f;
        any |= p != 0.0f;
        uint2 d;
        decode_a(__float_as_uint(p), M, d.x, d.y);
        sm.q[e] = d;
      }
      if (!__syncthreads_or(any)) continue;
      stage_decoded<false>(sm.kv, vs, nk, vc, M, vec,
                           [&](int i) { return vbase + (t0 + i) * kstep + c0; });
      __syncthreads();
      const uint2* prow = sm.q + rt * TM * vkb;
#pragma unroll 4
      for (int tt = 0; tt < nk; ++tt) {
        uint2 pa[TM], vb[DN];
#pragma unroll
        for (int i = 0; i < TM; ++i) pa[i] = prow[i * vkb + tt];
#pragma unroll
        for (int j = 0; j < DN; ++j) vb[j] = sm.kv[tt * vs + dj[j]];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < DN; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], product(pa[i].x, pa[i].y, vb[j].x, vb[j].y, tab, M));
      }
      __syncthreads();   // the slab is folded
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = rt * TM + i;
      if (r >= nr) continue;
      float* o = out + row_offset(r) + c0;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int d = kt + KT * j;
        if (d < vc) o[d] = acc[i][j];
      }
    }
  }
}

// Every tile of `a`, blocks 0 .. nblocks - 1 striding over them (blocks
// past nblocks take none).  Tile t is row tile (row tiles - 1 - t / groups)
// of group t % groups, group g = (b, kvh) = (g / KV, g % KV): the row tiles
// of the latest positions, which hold the most live keys, go first.
// space: the block's shared memory after the table (carve_attn); scratch:
// R x T floats a block when the scores are in global memory.
template <int RT, int TM, int TN, class Tab>
__device__ void attention_tiles(const Attn& a, const AttnLayout& L, const Tab& tab, int M,
                                unsigned char* space, float* scratch, int nblocks, float* out) {
  using Tile = AttnTile<RT, TM, TN>;
  constexpr int R = Tile::R;
  if (static_cast<int>(blockIdx.x) >= nblocks) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  const AttnSmem sm = carve_attn(space, R, Tile::KB, a.dh, L);
  float* scores = L.scores_smem ? sm.scores
                                : scratch + static_cast<size_t>(blockIdx.x) * R * a.T;
  const long long groups = attn_groups(a);
  const int rtiles = attn_row_tiles(a, R);
  const long long tiles = groups * rtiles;
  for (long long t = blockIdx.x; t < tiles; t += nblocks) {
    const int g = static_cast<int>(t % groups);
    const int j = rtiles - 1 - static_cast<int>(t / groups);
    attend_tile<RT, TM, TN>(a, L, tab, M, sm, scores, g / a.KV, g % a.KV, j * R, out);
    __syncthreads();   // the next tile restages Q and rewrites the scores
  }
}

// Copy `bytes` (a multiple of 4) from global to shared memory without
// waiting: 16 bytes a cp.async where the table's words allow, 4 for the
// tail.  attend_tile waits for it before its first product.  Every thread
// of the block takes part.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const char* s = static_cast<const char*>(src);
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * i),
                 "l"(s + 16 * i));
  }
  for (int i = bytes / 16 * 4 + threadIdx.x; i < bytes / 4; i += kThreads) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4 * i),
                 "l"(s + 4 * i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// A canonical table staged raw (stage_lut), read in place: the 24-bit mask
// that make_table applies while staging is applied at the read.
struct RawCanonTable {
  Table<kSmemCanon> t;
  __device__ __forceinline__ uint32_t entry(uint32_t w, int M) const {
    return t.entry(w, M) & 0xFFFFFFu;
  }
};

// The table of a LUT that a kernel staged raw in shared memory (kSmem) or
// reads from global memory, in the form `product` reads.
template <typename LutT, bool kSmem>
__device__ __forceinline__ auto raw_table(const LutT* lut) {
  if constexpr (kSmem) {
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(lut));
    if constexpr (sizeof(LutT) == 2) {
      return Table<kSmemPacked>{base};
    } else {
      return RawCanonTable{{base}};
    }
  } else if constexpr (sizeof(LutT) == 2) {
    return Table<kGlobalPacked>{lut};
  } else {
    return Table<kGlobalCanon>{lut};
  }
}

template <typename LutT, bool kSmem>
struct LutKind {
  using T = LutT;
  static constexpr bool smem = kSmem;
};

// Calls f(LutKind<...>{}) for the table layout: uint16 entries when
// `packed`, read from shared memory when `smem_lut`.
template <typename F>
cudaError_t with_lut(int packed, int smem_lut, F&& f) {
  if (packed) {
    return smem_lut ? f(LutKind<uint16_t, true>{}) : f(LutKind<uint16_t, false>{});
  }
  return smem_lut ? f(LutKind<uint32_t, true>{}) : f(LutKind<uint32_t, false>{});
}

}  // namespace amsim

// Operands decoded once, and the AMSim product on them: the form of
// amsim::mul that the GEMM (approx_gemm.cu) and conv weight-gradient
// (approx_conv_dw.cu) kernels use, where each operand word meets many
// products.
//
// As a word is stored into shared memory it becomes (sign | pre-shifted
// mantissa index part, exponent), with a zero exponent field turned into a
// large negative number, so AMSim's three flush tests are one compare of
// the exponent sum; a product is then an xor (index and sign at once), the
// gather, an add, a shift-add of the exponent onto the table entry, the
// overflow clamp, the zero select and an or (`product`).  The table is
// read from shared memory (canonical uint32 words, or packed uint16 ones)
// or from global memory (`Table<kind>`); `make_table` stages it.  Bit for
// bit amsim::mul (its torch twin: kernels/ref.py:ref_kernel_product).
#pragma once

#include "amsim.cuh"

namespace amsim {

constexpr int kZeroExp = -1024;      // a zero exponent field: every sum with it is <= 0

// Where the table is read from, and in which form (the plan's `table`).
enum TableKind { kSmemCanon = 0, kSmemPacked = 1, kGlobalCanon = 2, kGlobalPacked = 3 };

// A word of A: sign | top-M mantissa bits << M, and its exponent - 127.
__device__ __forceinline__ void decode_a(uint32_t u, int M, uint32_t& ix, uint32_t& ex) {
  const uint32_t e = (u >> 23) & 0xFFu;
  ix = (u & 0x80000000u) | (((u >> (23 - M)) & ((1u << M) - 1u)) << M);
  ex = static_cast<uint32_t>(e ? static_cast<int>(e) - 127 : kZeroExp);
}

// A word of B: sign | top-M mantissa bits, and its exponent.
__device__ __forceinline__ void decode_b(uint32_t u, int M, uint32_t& ix, uint32_t& ex) {
  const uint32_t e = (u >> 23) & 0xFFu;
  ix = (u & 0x80000000u) | ((u >> (23 - M)) & ((1u << M) - 1u));
  ex = static_cast<uint32_t>(e ? static_cast<int>(e) : kZeroExp);
}

// The table: entry(w) is the canonical entry (carry << 23 | 23-bit
// mantissa) at the index in the low 24 bits of w; w's sign bit is ignored.
template <int kKind>
struct Table;

template <>
struct Table<kSmemCanon> {
  uint32_t base;  // shared-memory address of the table
  __device__ __forceinline__ uint32_t entry(uint32_t w, int) const {
    uint32_t v;   // w << 2 drops the sign bit: idx < 2^24
    asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(base + (w << 2)));
    return v;
  }
};

template <>
struct Table<kSmemPacked> {
  uint32_t base;
  __device__ __forceinline__ uint32_t entry(uint32_t w, int M) const {
    unsigned short v;
    asm("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(base + (w << 1)));
    // carry << M | top-M mantissa  ->  carry << 23 | mantissa
    return (static_cast<uint32_t>(v) << (23 - M)) & 0xFFFFFFu;
  }
};

template <>
struct Table<kGlobalCanon> {
  const uint32_t* lut;
  __device__ __forceinline__ uint32_t entry(uint32_t w, int) const {
    return __ldg(lut + (w & 0xFFFFFFu)) & 0xFFFFFFu;
  }
};

template <>
struct Table<kGlobalPacked> {
  const uint16_t* lut;
  __device__ __forceinline__ uint32_t entry(uint32_t w, int M) const {
    return (static_cast<uint32_t>(__ldg(lut + (w & 0xFFFFFFu))) << (23 - M)) & 0xFFFFFFu;
  }
};

// amsim(a, b) from the decoded words: bit for bit amsim::mul.
//   zero:  ea == 0 || eb == 0 || ea + eb - 127 <= 0  <=>  e0 <= 0
//   v = (e0 << 23) + (carry << 23 | mnt) = (e0 + carry) << 23 | mnt, which is
//   >= 0x7F800000 exactly when e0 + carry >= 255 (inf); e0 <= 381 so the
//   unsigned sum does not wrap.
template <class Tab>
__device__ __forceinline__ float product(uint32_t ixa, uint32_t exa, uint32_t ixb, uint32_t exb,
                                         const Tab& tab, int M) {
  const uint32_t w = ixa ^ ixb;  // index (disjoint bits) and sign
  const int e0 = static_cast<int>(exa) + static_cast<int>(exb);
  uint32_t v = min((static_cast<uint32_t>(e0) << 23) + tab.entry(w, M), 0x7F800000u);
  v = e0 > 0 ? v : 0u;
  return __uint_as_float(v | (w & 0x80000000u));
}

// Shared bytes of a table form, a multiple of 16.
__host__ __device__ inline int table_smem_bytes(int kind, int M) {
  if (kind == kSmemCanon) return ((4 << (2 * M)) + 15) & ~15;
  if (kind == kSmemPacked) return ((2 << (2 * M)) + 15) & ~15;
  return 0;
}

// carry << M | top-M mantissa (a packed entry)  ->  carry << 23 | mantissa
__device__ __forceinline__ uint32_t expand(uint32_t v, int M) {
  return (((v >> M) & 1u) << 23) | ((v & ((1u << M) - 1u)) << (23 - M));
}

// Stage the table of the launch arguments p (p.lut, p.M, p.packed: uint16
// entries) and return it; every thread of the block takes part.  16 bytes
// a load, so that a block's staging is a few rounds of loads in flight,
// not one round trip an entry.
template <int kKind, class P>
__device__ Table<kKind> make_table(const P& p, unsigned char* smem) {
  const int entries = 1 << (2 * p.M);
  const int tid = threadIdx.x, nt = blockDim.x;
  if constexpr (kKind == kSmemCanon) {
    uint32_t* t = reinterpret_cast<uint32_t*>(smem);
    uint4* t4 = reinterpret_cast<uint4*>(smem);
    if (p.packed) {  // expand 8 packed entries a load
      const uint16_t* s = static_cast<const uint16_t*>(p.lut);
      const uint4* s4 = static_cast<const uint4*>(p.lut);
#pragma unroll 4
      for (int i = tid; i < entries / 8; i += nt) {
        const uint4 q = __ldg(s4 + i);
        t4[2 * i] = make_uint4(expand(q.x & 0xFFFFu, p.M), expand(q.x >> 16, p.M),
                               expand(q.y & 0xFFFFu, p.M), expand(q.y >> 16, p.M));
        t4[2 * i + 1] = make_uint4(expand(q.z & 0xFFFFu, p.M), expand(q.z >> 16, p.M),
                                   expand(q.w & 0xFFFFu, p.M), expand(q.w >> 16, p.M));
      }
      for (int i = entries / 8 * 8 + tid; i < entries; i += nt) t[i] = expand(__ldg(s + i), p.M);
    } else {
      const uint32_t* s = static_cast<const uint32_t*>(p.lut);
      const uint4* s4 = static_cast<const uint4*>(p.lut);
#pragma unroll 4
      for (int i = tid; i < entries / 4; i += nt) {
        const uint4 q = __ldg(s4 + i);
        t4[i] = make_uint4(q.x & 0xFFFFFFu, q.y & 0xFFFFFFu, q.z & 0xFFFFFFu, q.w & 0xFFFFFFu);
      }
      for (int i = entries / 4 * 4 + tid; i < entries; i += nt) t[i] = __ldg(s + i) & 0xFFFFFFu;
    }
    __syncthreads();
    return {static_cast<uint32_t>(__cvta_generic_to_shared(smem))};
  } else if constexpr (kKind == kSmemPacked) {
    const uint16_t* s = static_cast<const uint16_t*>(p.lut);
    const uint4* s4 = static_cast<const uint4*>(p.lut);
    uint16_t* t = reinterpret_cast<uint16_t*>(smem);
#pragma unroll 4
    for (int i = tid; i < entries / 8; i += nt) reinterpret_cast<uint4*>(smem)[i] = __ldg(s4 + i);
    for (int i = entries / 8 * 8 + tid; i < entries; i += nt) t[i] = __ldg(s + i);
    __syncthreads();
    return {static_cast<uint32_t>(__cvta_generic_to_shared(smem))};
  } else if constexpr (kKind == kGlobalCanon) {
    return {static_cast<const uint32_t*>(p.lut)};
  } else {
    return {static_cast<const uint16_t*>(p.lut)};
  }
}

}  // namespace amsim

// Pieces of the causal flash-attention forward (flash_fwd.cu): tile loads
// into shared memory and the bf16 tensor-core product m16n8k16 (mma.sync,
// f32 accumulation). The backward kernels (flash_bwd.cu) are built from the
// Hopper pieces of sm90.cuh instead.
//
// Register fragments of mma.sync.m16n8k16 (PTX ISA), with g = lane / 4 and
// t = lane % 4, each 32-bit register holding two bf16 of adjacent columns
// (the lower column in the low half):
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                         a3 (g+8, 2t+8..)
//   B (16x8, k-major):    b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
//   C (16x8, f32):        c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// So the C fragments of two adjacent 8-column tiles are, once rounded to
// bf16, exactly the A fragment of one 16-deep product: a score tile never
// leaves registers between QK^T and P.V.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps, 16 rows of the tile each
constexpr int kTile = 64;      // rows of a q tile and of a kv tile
constexpr float kNegInf = -1e30f;  // the JAX kernels' mask value

// Row stride (in bf16) of a row-major [rows][D] tile in shared memory: 8
// elements of padding shift consecutive rows by 4 banks, so the eight row
// groups of a fragment load hit 32 distinct banks.
template <int D>
struct Layout {
  static constexpr int kLd = D + 8;          // [kTile][kLd] row-major tile
  static constexpr int kLdT = kTile + 8;     // [D][kLdT] transposed tile
  static constexpr int kTileElems = kTile * kLd;
  static constexpr int kTileTElems = D * kLdT;
};

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows [row0, row0+16) and columns [col0, col0+16) of a
// row-major shared tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld,
                                       int row0, int col0, int g, int t) {
  const bf16* p = s + (row0 + g) * ld + col0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment for a product against a tile stored [n][k] (k contiguous):
// B(k, n) = s[n0 + n][k0 + k].
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* s,
                                       int ld, int n0, int k0, int g, int t) {
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// C fragments of 8-column tiles 2j and 2j+1, rounded to bf16, as the A
// fragment of the 16-deep step j.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copy rows [row0, row0 + kTile) of a [seq][D] bf16 matrix into shared
// memory, row-major into `dst` (stride D + 8) and, when `dst_t` is not
// null, transposed into `dst_t` ([D][kTile + 8]). Rows at or past seq are
// zero: the ragged last tile is masked here, not by divisor-sized tiles.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, bf16* dst_t, const bf16* src,
                                          int row0, int seq) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < seq) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    if (dst != nullptr) {
      *reinterpret_cast<uint4*>(dst + r * Layout<D>::kLd + c) = val;
    }
    if (dst_t != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst_t[(c + i) * Layout<D>::kLdT + r] = e[i];
    }
  }
}

}  // namespace flash

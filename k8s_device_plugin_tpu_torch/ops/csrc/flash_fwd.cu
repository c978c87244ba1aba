// Causal flash-attention forward for Hopper (sm_90a), bf16 in, f32 math.
//
// Replaces: k8s_device_plugin_tpu/ops/attention.py::_fwd_kernel (K1), the
// Pallas TPU kernel launched by _flash_call. Computes, per (batch*head)
// and query row i,
//   s_ij = scale * q_i . k_j   (f32 accumulation of bf16 products, j <= i)
//   O_i  = sum_j exp(s_ij - m_i) v_j / l_i   with exp(.) rounded to bf16
//          before the product, as the TPU kernel casts p to v's dtype
//   lse_i = m_i + log(l_i)     (f32, stored as [batch*head][seq])
//
// What bounds it on this card: at head_dim 128 the kernel does 4*d
// operations per (query, key) pair and reads each q/k/v row once per tile
// pass, so at seq 2048 it is bound by tensor-core operations (about 500
// flops per byte of q/k/v/o), not by the 3.35 TB/s of device memory.
//
// What the design does about it: one block of four warps per (batch*head,
// 64-row q tile) keeps the online-softmax state (running max, denominator,
// output accumulator) in registers and loops over the 64-row kv tiles in
// order -- the TPU grid's sequential kv axis becomes this loop. kv tiles
// wholly above the diagonal are never loaded. The products run on the
// tensor cores through mma.sync m16n8k16 with f32 accumulators, and the
// score tile goes from the QK^T accumulators to the P.V operands without
// leaving registers. V is stored transposed in shared memory so its
// operand loads are 32-bit and bank-conflict free. This is the simple
// correct kernel; wgmma and TMA pipelining are later work.
#include "flash_common.cuh"

namespace flash {

template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int seq, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + L::kTileElems;
  bf16* s_vt = s_k + L::kTileElems;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * seq * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = warp * 16;            // first tile row of this warp
  const int row_a = q0 + wrow + g;       // this thread's two query rows
  const int row_b = row_a + 8;

  load_tile<D>(s_q, nullptr, q + base, q0, seq);

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // Causal: kv tiles starting past this q tile's last row are skipped.
  const int last_row = min(q0 + kTile, seq) - 1;
  const int n_kv = last_row / kTile + 1;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's operands are consumed
    load_tile<D>(s_k, nullptr, k + base, k0, seq);
    load_tile<D>(nullptr, s_vt, v + base, k0, seq);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, s_q, L::kLd, wrow, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, s_k, L::kLd, n * 8, kk * 16, g, t);
        mma_16816(s[n], a, b0, b1);
      }
    }

    // Scale, causal mask, and the online-softmax update of both rows.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const float x = col <= row ? scale * s[n][e] : kNegInf;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_next = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_next);
      m[r] = m_next;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e / 2]);
        s[n][e] = p;
        l[e / 2] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += bf16(P) . V, the kv axis as the 16-deep product axis.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, s_vt, L::kLdT, n * 8, kk * 16, g, t);
        mma_16816(acc[n], a, b0, b1);
      }
    }
  }

  // Finalize: reduce the denominators over the four threads of each row.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  bf16* ob = o + base;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < seq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(acc[n][0] / l[0], acc[n][1] / l[0]);
    }
    if (row_b < seq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_b * D + col) =
          __floats2bfloat162_rn(acc[n][2] / l[1], acc[n][3] / l[1]);
    }
  }
  if (t == 0) {
    if (row_a < seq) lse[(size_t)bh * seq + row_a] = m[0] + logf(l[0]);
    if (row_b < seq) lse[(size_t)bh * seq + row_b] = m[1] + logf(l[1]);
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int seq, float scale,
                       cudaStream_t stream) {
  using L = Layout<D>;
  const int smem = (2 * L::kTileElems + L::kTileTElems) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTile - 1) / kTile, bh);
  fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), seq, scale);
  return cudaGetLastError();
}

}  // namespace flash

// q, k, v, o: [bh][seq][d] bf16, contiguous; lse: [bh][seq] f32.
// head_dim d in {64, 128}. Returns the launch's cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int seq, int d, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return flash::launch_fwd<64>(q, k, v, o, lse, bh, seq, scale, s);
    case 128:
      return flash::launch_fwd<128>(q, k, v, o, lse, bh, seq, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

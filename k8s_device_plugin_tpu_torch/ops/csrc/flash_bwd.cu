// Causal flash-attention backward for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces: k8s_device_plugin_tpu/ops/attention.py::_dq_kernel (K2) with
// dq_kernel below, and ::_dkv_kernel (K3) with dkv_kernel below, the two
// Pallas TPU kernels launched by _flash_bwd. Both rebuild the probability
// tile from the saved lse instead of storing the seq x seq matrix:
//   P = exp(scale * Q K^T - lse)         (f32, causal, j <= i)
//   dP = dO V^T,  delta = rowsum(dO * O)  (f32)
//   dS = P * (dP - delta)
//   dQ = scale * bf16(dS) K,  dK = scale * bf16(dS)^T Q,  dV = bf16(P)^T dO
// with the products on bf16 operands and f32 accumulation, and P and dS
// rounded to bf16 before their products, as the TPU kernels cast them to
// the input dtype.
//
// What bounds them on this card: 6*d (dQ) and 8*d (dK/dV) operations per
// (query, key) pair against one read of q, k, v, o, dO -- at head_dim 128
// and seq 2048 both are bound by tensor-core operations, not by memory.
//
// What the design does about it: the TPU grid's sequential axis becomes a
// loop inside one block of four warps. dq_kernel: one block per
// (batch*head, 64-row q tile), looping over the kv tiles at or below the
// diagonal with the dQ accumulator in registers. dkv_kernel: one block per
// (batch*head, 64-row kv tile), looping over the q tiles at or below it
// with the dK and dV accumulators in registers. Each output row has one
// owner, so no atomics are needed. delta is computed once per q tile in
// f32. Operands that a product reads along the other axis (K for dQ, Q and
// dO for dK/dV) are also stored transposed in shared memory, so every
// fragment load is 32-bit and bank-conflict free. mma.sync m16n8k16 on the
// tensor cores; wgmma/TMA pipelining is later work.
#include "flash_common.cuh"

namespace flash {

template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ o,
              const bf16* __restrict__ d_o, const float* __restrict__ lse,
              bf16* __restrict__ dq, int seq, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_do = s_q + L::kTileElems;
  bf16* s_k = s_do + L::kTileElems;
  bf16* s_v = s_k + L::kTileElems;
  bf16* s_kt = s_v + L::kTileElems;
  float* s_delta = reinterpret_cast<float*>(s_kt + L::kTileTElems);
  float* s_lse = s_delta + kTile;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * seq * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = warp * 16;
  const int row_a = q0 + wrow + g;
  const int row_b = row_a + 8;

  load_tile<D>(s_q, nullptr, q + base, q0, seq);
  load_tile<D>(s_do, nullptr, d_o + base, q0, seq);
  __syncthreads();
  load_row_stats<D>(s_delta, s_lse, o + base, s_do, lse + (size_t)bh * seq, q0, seq);
  __syncthreads();
  const float lse_r[2] = {s_lse[wrow + g], s_lse[wrow + g + 8]};
  const float delta_r[2] = {s_delta[wrow + g], s_delta[wrow + g + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int last_row = min(q0 + kTile, seq) - 1;
  const int n_kv = last_row / kTile + 1;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    load_tile<D>(s_k, s_kt, k + base, k0, seq);
    load_tile<D>(s_v, nullptr, v + base, k0, seq);
    __syncthreads();

    float s[kTile / 8][4];
    float dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a_q[4], a_do[4];
      load_a(a_q, s_q, L::kLd, wrow, kk * 16, g, t);
      load_a(a_do, s_do, L::kLd, wrow, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, s_k, L::kLd, n * 8, kk * 16, g, t);
        mma_16816(s[n], a_q, b0, b1);
        load_b(b0, b1, s_v, L::kLd, n * 8, kk * 16, g, t);
        mma_16816(dp[n], a_do, b0, b1);
      }
    }
    // dS = P * (dP - delta), P rebuilt from lse; masked entries are 0.
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const float p = col <= row ? expf(scale * s[n][e] - lse_r[e / 2]) : 0.f;
        s[n][e] = p * (dp[n][e] - delta_r[e / 2]);
      }
    }
    // acc += bf16(dS) . K (K read transposed: the kv axis is the depth).
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, s_kt, L::kLdT, n * 8, kk * 16, g, t);
        mma_16816(acc[n], a, b0, b1);
      }
    }
  }

  bf16* out = dq + base;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < seq) {
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(scale * acc[n][0], scale * acc[n][1]);
    }
    if (row_b < seq) {
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row_b * D + col) =
          __floats2bfloat162_rn(scale * acc[n][2], scale * acc[n][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ o,
               const bf16* __restrict__ d_o, const float* __restrict__ lse,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int seq,
               float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + L::kTileElems;
  bf16* s_q = s_v + L::kTileElems;
  bf16* s_do = s_q + L::kTileElems;
  bf16* s_qt = s_do + L::kTileElems;
  bf16* s_dot = s_qt + L::kTileTElems;
  float* s_delta = reinterpret_cast<float*>(s_dot + L::kTileTElems);
  float* s_lse = s_delta + kTile;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * seq * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = warp * 16;
  const int kv_a = k0 + wrow + g;  // this thread's two key rows
  const int kv_b = kv_a + 8;

  load_tile<D>(s_k, nullptr, k + base, k0, seq);
  load_tile<D>(s_v, nullptr, v + base, k0, seq);

  float acc_k[D / 8][4];
  float acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }

  // Causal: q tiles ending before this kv tile's first row are skipped.
  const int n_q = (seq + kTile - 1) / kTile;
  for (int i = k0 / kTile; i < n_q; ++i) {
    const int q0 = i * kTile;
    __syncthreads();
    load_tile<D>(s_q, s_qt, q + base, q0, seq);
    load_tile<D>(s_do, s_dot, d_o + base, q0, seq);
    __syncthreads();
    load_row_stats<D>(s_delta, s_lse, o + base, s_do, lse + (size_t)bh * seq, q0, seq);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows.
    float st[kTile / 8][4];
    float dpt[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a_k[4], a_v[4];
      load_a(a_k, s_k, L::kLd, wrow, kk * 16, g, t);
      load_a(a_v, s_v, L::kLd, wrow, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, s_q, L::kLd, n * 8, kk * 16, g, t);
        mma_16816(st[n], a_k, b0, b1);
        load_b(b0, b1, s_do, L::kLd, n * 8, kk * 16, g, t);
        mma_16816(dpt[n], a_v, b0, b1);
      }
    }
    // P^T rebuilt from lse (columns are query rows), then dS^T.
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t + (e & 1);  // column within the q tile
        const int kv = e < 2 ? kv_a : kv_b;
        const bool live = kv <= q0 + qc && q0 + qc < seq;
        const float p = live ? expf(scale * st[n][e] - s_lse[qc]) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - s_delta[qc]);
      }
    }
    // acc_v += bf16(P^T) . dO and acc_k += bf16(dS^T) . Q, the q axis as
    // the depth (dO and Q read transposed).
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a_p[4], a_ds[4];
      c_to_a(a_p, st[2 * kk], st[2 * kk + 1]);
      c_to_a(a_ds, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, s_dot, L::kLdT, n * 8, kk * 16, g, t);
        mma_16816(acc_v[n], a_p, b0, b1);
        load_b(b0, b1, s_qt, L::kLdT, n * 8, kk * 16, g, t);
        mma_16816(acc_k[n], a_ds, b0, b1);
      }
    }
  }

  bf16* dkb = dk + base;
  bf16* dvb = dv + base;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (kv_a < seq) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)kv_a * D + col) =
          __floats2bfloat162_rn(scale * acc_k[n][0], scale * acc_k[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)kv_a * D + col) =
          __floats2bfloat162_rn(acc_v[n][0], acc_v[n][1]);
    }
    if (kv_b < seq) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)kv_b * D + col) =
          __floats2bfloat162_rn(scale * acc_k[n][2], scale * acc_k[n][3]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)kv_b * D + col) =
          __floats2bfloat162_rn(acc_v[n][2], acc_v[n][3]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* d_o, const void* lse, void* dq, int bh, int seq,
                      float scale, cudaStream_t stream) {
  using L = Layout<D>;
  const int smem = (4 * L::kTileElems + L::kTileTElems) * (int)sizeof(bf16) +
                   2 * kTile * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTile - 1) / kTile, bh);
  dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
      static_cast<bf16*>(dq), seq, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* o,
                       const void* d_o, const void* lse, void* dk, void* dv,
                       int bh, int seq, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  const int smem = (4 * L::kTileElems + 2 * L::kTileTElems) * (int)sizeof(bf16) +
                   2 * kTile * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kTile - 1) / kTile, bh);
  dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, scale);
  return cudaGetLastError();
}

}  // namespace flash

// q, k, v, o, d_o, dq: [bh][seq][d] bf16, contiguous; lse: [bh][seq] f32.
// head_dim d in {64, 128}. Returns the launch's cudaGetLastError().
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* o,
                        const void* d_o, const void* lse, void* dq, int bh,
                        int seq, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return flash::launch_dq<64>(q, k, v, o, d_o, lse, dq, bh, seq, scale, s);
    case 128:
      return flash::launch_dq<128>(q, k, v, o, d_o, lse, dq, bh, seq, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// As flash_dq, writing dk and dv ([bh][seq][d] bf16).
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* o, const void* d_o, const void* lse,
                         void* dk, void* dv, int bh, int seq, int d, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return flash::launch_dkv<64>(q, k, v, o, d_o, lse, dk, dv, bh, seq, scale, s);
    case 128:
      return flash::launch_dkv<128>(q, k, v, o, d_o, lse, dk, dv, bh, seq, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

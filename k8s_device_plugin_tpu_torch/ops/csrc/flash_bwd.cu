// Causal flash-attention backward for Hopper (sm_90a): the delta prepass,
// dQ, and dK with dV.
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
// the input dtype. The TPU kernels recompute delta inside every tile to
// save an HBM residual; bwd_delta_kernel computes it once per backward
// (the same f32 rowsum, summed in another order) into a (b*h, seq) vector
// that both kernels read.
//
// What bounds them on this card: 6*d (dQ: Q K^T, dO V^T, dS K) and 8*d
// (dK/dV: K Q^T, V dO^T, P^T dO, dS^T Q) operations per causal (query, key)
// pair against one read of q, k, v, dO, lse and delta -- at head_dim 128
// and seq 2048 both are bound by tensor-core operations. The prepass is
// bound by bytes: it reads O and dO once.
//
// What the design does about it:
//  - Warp specialisation. Three warpgroups a block: two consumer
//    warpgroups that each own 64 rows of the block's 128 resident rows and
//    one producer warpgroup, of which one thread issues TMA loads. The
//    producer gives its registers to the consumers (setmaxnreg 40 / 232), who
//    need them for the f32 accumulators (dK and dV: 2 x 64 a thread at
//    head_dim 128).
//  - Tiles arrive by TMA into shared memory, 128-byte swizzled, from 3-D
//    tensor maps over (b*h, seq, d): a box past seq is zero-filled, never
//    read from the next head. (lse and delta come through flat maps over
//    b*h*seq values; what lies past seq is the next head's and is masked.
//    A TMA box must start on a 16-byte boundary, so each of their boxes
//    starts up to three values early, at a multiple of 4, and is
//    kVecBox = 68 values long; where seq is a multiple of 4 no box starts
//    early, and the consumers read the values in pairs.)
//    dkv_kernel keeps its 128-row K and V tiles
//    resident and streams (Q, dO, lse, delta) per 64-row q tile; dq_kernel
//    keeps Q and dO resident and streams (K, V) per 64-row kv tile. The
//    streamed tiles go through a ring of kStages stages, each guarded by a
//    full mbarrier (the TMA bytes have landed) and an empty one (both
//    consumer warpgroups are done with it), so the loads of the next tiles
//    run while the tensor cores work on this one. kStages is a template
//    parameter: the C entry points take 2 or 3 and the wrapper passes 2
//    unless asked; at head_dim 128 the resident tiles take 64 KiB of
//    shared memory and each stage 32 KiB.
//  - Products on wgmma (m64nNk16 with N = 32, 64 or head_dim, f32 +=
//    bf16 x bf16).
//    S^T = K Q^T and dP^T = V dO^T (dkv), or S = Q K^T and dP = dO V^T
//    (dq), take both operands from shared memory, K-major. P and dS are
//    rounded to bf16 in registers, where the TPU kernels cast them, and are
//    the register A operand of dV += P^T dO, dK += dS^T Q and dQ += dS K;
//    their B operand (dO, Q, K) is read through the MN-major descriptor, so
//    no transposed copy of any operand is built.
//  - Causal scheduling. The blocks run the heaviest tiles first (the
//    lowest kv blocks for dK/dV, the highest q blocks for dQ): dkv_kernel's
//    grid has b*h as its fastest axis, dq_kernel's walks groups of kGroup
//    heads so that the blocks resident together share K and V in L2 (the
//    same grouping made dkv_kernel slower). A warpgroup skips a tile wholly above the
//    diagonal and applies the element mask only on a tile that straddles
//    the diagonal or runs past seq, as a select of the exponent's argument
//    (kNegInf, whose exp is 0): the loop over a tile has no branch, where
//    an exp under a condition made ptxas branch and spill per element.
//  - Registers. A dK/dV consumer holds 2 x D/2 f32 accumulators; the q
//    tile is taken in slices of kCols columns so that the score tiles and
//    the A operands made from them fit beside them. At head_dim 128 ptxas
//    still spills a little in dkv_kernel and serialises its wgmmas (the
//    build prints its report); dq_kernel does not spill. Slices of 16 or
//    64 columns, a producer of one warp (nine warps put three on one SM
//    quarter, which caps every thread at 168 registers) and a separate
//    wait for each of the two register-A products all spilled as much or
//    more.
//  - Each output row has one owner and there are no atomics: the outputs
//    are the same bits from launch to launch.
#include "sm90.cuh"

namespace flash {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kBlock = 128;     // resident rows a block (two warpgroups of 64)
constexpr int kStep = 64;       // rows of a streamed tile
constexpr int kCols = 32;       // q columns of one dK/dV slice of a q tile
constexpr int kGroup = 16;      // heads a dQ grid walks together
constexpr int kThreads = 384;   // two consumer warpgroups, then the producer
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;  // the JAX kernels' mask value: exp() gives 0
// A streamed tile's lse or delta box where seq is not a multiple of 4:
// kStep values from a 16-byte aligned start up to three values early;
// kVecPad keeps each stage 128-byte aligned.
constexpr int kVecBox = kStep + 4;
constexpr int kVecPad = 96;

template <int D, int kStages, bool kAligned>
struct DkvSmem {
  static constexpr int kPanels = D / 64;
  Panel<kBlock> k[kPanels];
  Panel<kBlock> v[kPanels];
  Panel<kStep> q[kStages][kPanels];
  Panel<kStep> d_o[kStages][kPanels];
  float lse[kStages][kAligned ? kStep : kVecPad];
  float delta[kStages][kAligned ? kStep : kVecPad];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int D, int kStages>
struct DqSmem {
  static constexpr int kPanels = D / 64;
  Panel<kBlock> q[kPanels];
  Panel<kBlock> d_o[kPanels];
  Panel<kStep> k[kStages][kPanels];
  Panel<kStep> v[kStages][kPanels];
  uint64_t qd_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// Two consecutive f32 values of shared memory, as one 8-byte read where
// they are known to be 8-byte aligned.
template <bool kAligned>
__device__ __forceinline__ void load_pair(float (&x)[2], const float* p) {
  if constexpr (kAligned) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = p[0];
    x[1] = p[1];
  }
}

// The consumer warpgroups of dkv_kernel: S^T, dP^T, then dV and dK.
// kAligned: seq is a multiple of 4, so every lse and delta box starts at
// its tile's first value.
template <int D, int kStages, bool kAligned>
__device__ __forceinline__ void dkv_consume(DkvSmem<D, kStages, kAligned>& sm,
                                            bf16* __restrict__ dk, bf16* __restrict__ dv, int bh,
                                            int k0, int i0, int n_tiles, int seq, float scale) {
  regs_alloc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kw0 = k0 + wg * 64;          // this warpgroup's first kv row
  const int kv_a = kw0 + warp * 16 + g;  // this thread's two kv rows
  const int kv_b = kv_a + 8;
  // Where a tile's lse and delta start in their boxes.
  const int vec0 = kAligned ? 0 : (bh * seq) & 3;

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  mbar_wait(&sm.kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int q0 = (i0 + it) * kStep;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    if (q0 + kStep - 1 < kw0) {  // wholly above the diagonal for these rows
      mbar_arrive(&sm.empty[s]);
      continue;
    }

    // The q tile in slices of kCols columns, so that the score
    // accumulators (2 x kCols / 2 a thread) and the A operands made from
    // them (2 x kCols / 4) fit in registers beside dK and dV (2 x 64 at
    // head_dim 128).
    const bool masked = q0 < kw0 + 64 || q0 + kStep > seq;
#pragma unroll
    for (int h = 0; h < kStep / kCols; ++h) {
      // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 kv rows.
      float st[kCols / 2], dpt[kCols / 2];
      wgmma_fence();
      product_ss<D, kCols>(st, sm.k, wg * 64, sm.q[s], kCols * h);
      wgmma_commit();
      product_ss<D, kCols>(dpt, sm.v, wg * 64, sm.d_o[s], kCols * h);
      wgmma_commit();

      // P^T (columns are q rows) from lse while dP^T is in flight; masked
      // only where the tile straddles the diagonal or runs past seq.
      wgmma_wait<1>();
      fence_regs(st);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int qc = kCols * h + 8 * j + 2 * t;
        float lse2[2];
        load_pair<kAligned>(lse2, &sm.lse[s][vec0 + qc]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + qc + (e & 1);
          const int kv = e < 2 ? kv_a : kv_b;
          const bool live = !masked || (kv <= q && q < seq);
          const float x = scale * st[4 * j + e] - lse2[e & 1];
          st[4 * j + e] = expf(live ? x : kNegInf);
        }
      }
      // dS^T = P^T * (dP^T - delta).
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        float del2[2];
        load_pair<kAligned>(del2, &sm.delta[s][vec0 + kCols * h + 8 * j + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - del2[e & 1]);
        }
      }
      uint32_t a_p[kCols / 16][4], a_ds[kCols / 16][4];
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        acc_to_a(a_p[kk], st, kk);
        acc_to_a(a_ds[kk], dpt, kk);
      }

      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q, the q rows as the depth.
      wgmma_fence();
      product_rs<D>(acc_v, a_p, sm.d_o[s], kCols * h);
      product_rs<D>(acc_k, a_ds, sm.q[s], kCols * h);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
    }
    mbar_arrive(&sm.empty[s]);
  }

  bf16* dkb = dk + (size_t)bh * seq * D;
  bf16* dvb = dv + (size_t)bh * seq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (kv_a < seq) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)kv_a * D + col) =
          __floats2bfloat162_rn(scale * acc_k[4 * j], scale * acc_k[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)kv_a * D + col) =
          __floats2bfloat162_rn(acc_v[4 * j], acc_v[4 * j + 1]);
    }
    if (kv_b < seq) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)kv_b * D + col) =
          __floats2bfloat162_rn(scale * acc_k[4 * j + 2], scale * acc_k[4 * j + 3]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)kv_b * D + col) =
          __floats2bfloat162_rn(acc_v[4 * j + 2], acc_v[4 * j + 3]);
    }
  }
}

// dK, dV for one (b*h, 128-row kv block); q tiles stream through the ring.
template <int D, int kStages, bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_lse,
               const __grid_constant__ CUtensorMap tm_delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int seq, float scale) {
  using S = DkvSmem<D, kStages, kAligned>;
  S& sm = smem_as<S>();
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;  // y = 0 is the heaviest block
  const int i0 = k0 / kStep;           // the first q tile at or below the diagonal
  const int n_tiles = (seq + kStep - 1) / kStep - i0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer warpgroup
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      mbar_arrive_expect_tx(&sm.kv_full, 2 * S::kPanels * Panel<kBlock>::kBytes);
      for (int p = 0; p < S::kPanels; ++p) {
        tma_load_3d(&sm.k[p], &tm_k, &sm.kv_full, 64 * p, k0, bh);
        tma_load_3d(&sm.v[p], &tm_v, &sm.kv_full, 64 * p, k0, bh);
      }
      const int row0 = bh * seq;  // of lse and delta
      const int vec0 = row0 & 3;   // their boxes start 16-byte aligned
      constexpr int kVecBytes = (kAligned ? kStep : kVecBox) * (int)sizeof(float);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * S::kPanels * Panel<kStep>::kBytes +
                                               2 * kVecBytes);
        const int q0 = (i0 + it) * kStep;
        for (int p = 0; p < S::kPanels; ++p) {
          tma_load_3d(&sm.q[s][p], &tm_q, &sm.full[s], 64 * p, q0, bh);
          tma_load_3d(&sm.d_o[s][p], &tm_do, &sm.full[s], 64 * p, q0, bh);
        }
        // Flat (b*h*seq) maps: a box past seq reads the next head's values,
        // which the mask of the ragged tile zeroes.
        tma_load_1d(sm.lse[s], &tm_lse, &sm.full[s], row0 + q0 - vec0);
        tma_load_1d(sm.delta[s], &tm_delta, &sm.full[s], row0 + q0 - vec0);
      }
    }
  } else {
    dkv_consume<D, kStages, kAligned>(sm, dk, dv, bh, k0, i0, n_tiles, seq, scale);
  }
}

// The consumer warpgroups of dq_kernel: S, dP, then dQ.
template <int D, int kStages>
__device__ __forceinline__ void dq_consume(DqSmem<D, kStages>& sm, const float* __restrict__ lse,
                                           const float* __restrict__ delta, bf16* __restrict__ dq,
                                           int bh, int q0, int n_tiles, int seq, float scale) {
  regs_alloc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int qw0 = q0 + wg * 64;           // this warpgroup's first q row
  const int row_a = qw0 + warp * 16 + g;  // this thread's two q rows
  const int row_b = row_a + 8;
  const float* lse_bh = lse + (size_t)bh * seq;
  const float* delta_bh = delta + (size_t)bh * seq;
  const float lse_r[2] = {row_a < seq ? lse_bh[row_a] : 0.f, row_b < seq ? lse_bh[row_b] : 0.f};
  const float delta_r[2] = {row_a < seq ? delta_bh[row_a] : 0.f,
                            row_b < seq ? delta_bh[row_b] : 0.f};

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(&sm.qd_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = it * kStep;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    if (k0 > qw0 + 63) {  // wholly above the diagonal for these rows
      mbar_arrive(&sm.empty[s]);
      continue;
    }

    // S = Q K^T and dP = dO V^T for this warpgroup's 64 q rows.
    float s_acc[32], dp[32];
    wgmma_fence();
    product_ss<D, 64>(s_acc, sm.q, wg * 64, sm.k[s], 0);
    product_ss<D, 64>(dp, sm.d_o, wg * 64, sm.v[s], 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s_acc);
    fence_regs(dp);

    // dS = P * (dP - delta), P from lse; masked only on the diagonal tile
    // (kv rows past seq lie above every q row below seq).
    const bool masked = k0 + kStep - 1 > qw0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool live = !masked || col <= row;
        const float p = expf(live ? scale * s_acc[4 * j + e] - lse_r[e / 2] : kNegInf);
        s_acc[4 * j + e] = p * (dp[4 * j + e] - delta_r[e / 2]);
      }
    }
    uint32_t a_ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(a_ds[kk], s_acc, kk);

    // dQ += bf16(dS) K, the kv rows as the depth.
    wgmma_fence();
    product_rs<D>(acc, a_ds, sm.k[s], 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&sm.empty[s]);
  }

  bf16* out = dq + (size_t)bh * seq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row_a < seq) {
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(scale * acc[4 * j], scale * acc[4 * j + 1]);
    }
    if (row_b < seq) {
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row_b * D + col) =
          __floats2bfloat162_rn(scale * acc[4 * j + 2], scale * acc[4 * j + 3]);
    }
  }
}

// dQ for one (b*h, 128-row q block); kv tiles stream through the ring.
template <int D, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int seq, float scale) {
  using S = DqSmem<D, kStages>;
  S& sm = smem_as<S>();
  // The blocks walk groups of kGroup heads, and each group's q blocks
  // heaviest first, so that the blocks resident at once share their heads'
  // K and V in L2.
  const int n_q = (seq + kBlock - 1) / kBlock;
  const int group = blockIdx.x / (kGroup * n_q);
  const int r = blockIdx.x % (kGroup * n_q);
  const int heads = min(kGroup, (int)gridDim.x / n_q - group * kGroup);
  const int bh = group * kGroup + r % heads;
  const int q0 = (n_q - 1 - r / heads) * kBlock;
  const int n_tiles = (min(q0 + kBlock, seq) - 1) / kStep + 1;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer warpgroup
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      mbar_arrive_expect_tx(&sm.qd_full, 2 * S::kPanels * Panel<kBlock>::kBytes);
      for (int p = 0; p < S::kPanels; ++p) {
        tma_load_3d(&sm.q[p], &tm_q, &sm.qd_full, 64 * p, q0, bh);
        tma_load_3d(&sm.d_o[p], &tm_do, &sm.qd_full, 64 * p, q0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[s], 2 * S::kPanels * Panel<kStep>::kBytes);
        for (int p = 0; p < S::kPanels; ++p) {
          tma_load_3d(&sm.k[s][p], &tm_k, &sm.full[s], 64 * p, it * kStep, bh);
          tma_load_3d(&sm.v[s][p], &tm_v, &sm.full[s], 64 * p, it * kStep, bh);
        }
      }
    }
  } else {
    dq_consume<D, kStages>(sm, lse, delta, dq, bh, q0, n_tiles, seq, scale);
  }
}

// delta[r] = sum_d dO[r][d] * O[r][d] in f32, D / 8 threads a row, each
// with one 16-byte load of either tensor.
template <int D>
__global__ void __launch_bounds__(256)
    bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ d_o,
                     float* __restrict__ delta, int rows) {
  constexpr int kLanes = D / 8;
  const int row = blockIdx.x * (256 / kLanes) + threadIdx.x / kLanes;
  const int col = (threadIdx.x % kLanes) * 8;
  float acc = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + (size_t)row * D + col);
    const uint4 b = *reinterpret_cast<const uint4*>(d_o + (size_t)row * D + col);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]);
      const float2 y = __bfloat1622float2(b2[i]);
      acc += x.x * y.x;
      acc += x.y * y.y;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && threadIdx.x % kLanes == 0) delta[row] = acc;
}

template <int D, int kStages>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* d_o,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int seq,
                       float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_lse, tm_delta;
  cudaError_t err;
  if ((err = map_rows_bf16(&tm_q, q, bh, seq, D, kStep)) != cudaSuccess) return err;
  if ((err = map_rows_bf16(&tm_do, d_o, bh, seq, D, kStep)) != cudaSuccess) return err;
  if ((err = map_rows_bf16(&tm_k, k, bh, seq, D, kBlock)) != cudaSuccess) return err;
  if ((err = map_rows_bf16(&tm_v, v, bh, seq, D, kBlock)) != cudaSuccess) return err;
  const bool aligned = seq % 4 == 0;
  const int vec_box = aligned ? kStep : kVecBox;
  if ((err = map_vec_f32(&tm_lse, lse, (long long)bh * seq, vec_box)) != cudaSuccess) return err;
  if ((err = map_vec_f32(&tm_delta, delta, (long long)bh * seq, vec_box)) != cudaSuccess) return err;
  const auto kernel = aligned ? dkv_kernel<D, kStages, true> : dkv_kernel<D, kStages, false>;
  const int smem = (int)(aligned ? sizeof(DkvSmem<D, kStages, true>)
                                 : sizeof(DkvSmem<D, kStages, false>)) + 1024;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, smem, stream>>>(tm_q, tm_do, tm_k, tm_v, tm_lse, tm_delta,
                                           static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq,
                                           scale);
  return cudaGetLastError();
}

template <int D, int kStages>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* d_o,
                      const void* lse, const void* delta, void* dq, int bh, int seq, float scale,
                      cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  cudaError_t err;
  if ((err = map_rows_bf16(&tm_q, q, bh, seq, D, kBlock)) != cudaSuccess) return err;
  if ((err = map_rows_bf16(&tm_do, d_o, bh, seq, D, kBlock)) != cudaSuccess) return err;
  if ((err = map_rows_bf16(&tm_k, k, bh, seq, D, kStep)) != cudaSuccess) return err;
  if ((err = map_rows_bf16(&tm_v, v, bh, seq, D, kStep)) != cudaSuccess) return err;
  const int smem = (int)sizeof(DqSmem<D, kStages>) + 1024;
  err = cudaFuncSetAttribute(dq_kernel<D, kStages>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh * ((seq + kBlock - 1) / kBlock));
  dq_kernel<D, kStages><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_do, tm_k, tm_v, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), seq, scale);
  return cudaGetLastError();
}

// The dQ and dK/dV instances of ring depth `stages`: 2 or 3.
template <int D>
cudaError_t launch_dq_stages(const void* q, const void* k, const void* v, const void* d_o,
                             const void* lse, const void* delta, void* dq, int bh, int seq,
                             int stages, float scale, cudaStream_t stream) {
  switch (stages) {
    case 2:
      return launch_dq<D, 2>(q, k, v, d_o, lse, delta, dq, bh, seq, scale, stream);
    case 3:
      return launch_dq<D, 3>(q, k, v, d_o, lse, delta, dq, bh, seq, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_dkv_stages(const void* q, const void* k, const void* v, const void* d_o,
                              const void* lse, const void* delta, void* dk, void* dv, int bh,
                              int seq, int stages, float scale, cudaStream_t stream) {
  switch (stages) {
    case 2:
      return launch_dkv<D, 2>(q, k, v, d_o, lse, delta, dk, dv, bh, seq, scale, stream);
    case 3:
      return launch_dkv<D, 3>(q, k, v, d_o, lse, delta, dk, dv, bh, seq, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_delta(const void* o, const void* d_o, void* delta, int rows,
                         cudaStream_t stream) {
  constexpr int kRowsPerBlock = 256 / (D / 8);
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  bwd_delta_kernel<D><<<blocks, 256, 0, stream>>>(static_cast<const bf16*>(o),
                                                  static_cast<const bf16*>(d_o),
                                                  static_cast<float*>(delta), rows);
  return cudaGetLastError();
}

}  // namespace flash

// q, k, v, d_o, dq: [bh][seq][d] bf16, contiguous; lse, delta: [bh][seq]
// f32 (delta from flash_bwd_delta). head_dim d in {64, 128}; stages, the
// depth of the streamed tiles' ring, in {2, 3}. Returns the launch's
// cudaGetLastError() (or the tensor-map encoding's error);
// cudaErrorInvalidValue for any other d or stages.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* d_o,
                        const void* lse, const void* delta, void* dq, int bh, int seq, int d,
                        int stages, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return flash::launch_dq_stages<64>(q, k, v, d_o, lse, delta, dq, bh, seq, stages, scale, s);
    case 128:
      return flash::launch_dq_stages<128>(q, k, v, d_o, lse, delta, dq, bh, seq, stages, scale,
                                          s);
    default:
      return cudaErrorInvalidValue;
  }
}

// As flash_dq, writing dk and dv ([bh][seq][d] bf16).
extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* d_o,
                         const void* lse, const void* delta, void* dk, void* dv, int bh, int seq,
                         int d, int stages, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return flash::launch_dkv_stages<64>(q, k, v, d_o, lse, delta, dk, dv, bh, seq, stages,
                                          scale, s);
    case 128:
      return flash::launch_dkv_stages<128>(q, k, v, d_o, lse, delta, dk, dv, bh, seq, stages,
                                           scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// delta = rowsum(d_o * o) in f32 for `rows` rows of head_dim d ([rows][d]
// bf16 in, [rows] f32 out).
extern "C" int flash_bwd_delta(const void* o, const void* d_o, void* delta, int rows, int d,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return flash::launch_delta<64>(o, d_o, delta, rows, s);
    case 128:
      return flash::launch_delta<128>(o, d_o, delta, rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}

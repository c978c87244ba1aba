// Causal flash-attention forward for Hopper (sm_90a), bf16 in, f32 math.
//
// Replaces: k8s_device_plugin_tpu/ops/attention.py::_fwd_kernel (K1), the
// Pallas TPU kernel launched by _flash_call. Computes, per (batch*head)
// and query row i,
//   s_ij = scale * q_i . k_j   (f32 accumulation of bf16 products, j <= i,
//                               masked entries -1e30)
//   O_i  = sum_j exp(s_ij - m_i) v_j / max(l_i, 1e-30)   in bf16, with
//          exp(.) rounded to bf16 before the product, as the TPU kernel
//          casts p to v's dtype, and l_i the sum of the unrounded f32 p
//   lse_i = m_i + log(l_i)     (f32, stored as [batch*head][seq])
// with the online softmax: a running row max m and denominator l in f32,
// the accumulator rescaled by exp(m_old - m_new) at every kv tile (never
// lazily, which would round P against another max). The exponentials are
// taken as exp2 of the scores times scale * log2(e), the same function.
//
// What bounds it on this card: 4*d tensor-core operations per causal
// (query, key) pair (Q K^T and P V, 2 per multiply-add) against one read of
// q, k, v and one write of o and lse; at head_dim 128 and seq 2048 that is
// about 500 operations a byte, so it is bound by the bf16 tensor-core rate,
// not by the 3.35 TB/s of device memory.
//
// What the design does about it:
//  - Warp specialisation. 384 threads a block: two consumer warpgroups
//    that each own 64 rows of a 128-row q block and take 232 registers
//    through setmaxnreg, and one producer warpgroup that gives its
//    registers back (40) and of which one thread issues the TMA loads.
//  - Persistent blocks. One block an SM walks its share of the work items
//    (b*h, 128-row q block): each head's q blocks in the order last,
//    first, second last, second, ..., taken two at a time, so that every
//    pair costs the same kv tiles, and pair p goes to block p mod the grid,
//    so that the blocks at work at once share a few heads' K and V in L2.
//    Q is double-buffered: the producer loads the next item's Q and first
//    kv tiles while the consumers finish this item and store its O, which
//    hides each item's start (see the variants below).
//  - Q arrives as one 128-row box per 64-column panel. K and V stream in
//    64-row tiles through a ring of kStages stages that runs on across the
//    items (kStages is a template parameter: the C entry point takes 2, 3
//    or 4 and the wrapper passes 4 unless asked; at head_dim 128 four
//    stages and the two Q buffers take 192 KiB of shared memory, and five
//    would leave no room beside them), each guarded by a full mbarrier
//    (the TMA bytes have landed) and an empty one (both consumer
//    warpgroups are done with it). All come
//    through 3-D tensor maps over (b*h, seq, d), 128-byte swizzled: a box
//    past seq is zero-filled, never read from the next head. kv tiles
//    wholly above a q block's diagonal are never loaded; a warpgroup
//    releases unread the one tile above its own diagonal (the other
//    warpgroup's diagonal tile).
//  - S = Q K^T on wgmma with both operands in shared memory, K-major.
//    The softmax runs on the m64n64 accumulator in registers: the row max
//    and sum over the four threads of a row by two shuffles, the mask only
//    on the diagonal tile and as a select of the exponent's argument (a
//    branch around exp made ptxas branch and spill per element in the
//    backward), each exponential one ex2 of an FFMA of the raw score (the
//    scale and log2(e) folded in). P is rounded to bf16 in registers and is
//    the register A operand of O += P V, whose B operand V is read through
//    the MN-major descriptor of the same tile: no transposed copy, no trip
//    of P through shared memory.
//  - Overlap. Each step issues the next tile's S = Q K^T, rescales O to
//    this tile's max while S runs, issues O += P V of this tile, waits for
//    S alone (wgmma wait 1) and runs the next softmax while P V is still on
//    the tensor cores; it then waits for P V, releases the stage and rounds
//    the new P. The two consumer warpgroups fill each other's gaps on the
//    SM's tensor cores.
//  - Head widths. DQK (q and k) and DV (v and o) are template parameters:
//    (64, 64) and (128, 128), and (192, 128) for multi-head latent
//    attention, whose q.k heads join 128 latent and 64 rotary dims. There
//    S = Q K^T takes 12 16-deep steps over three 64-column panels, and P V
//    and the accumulator (DV / 2 registers a thread) are as at 128. Four
//    stages and the two Q buffers would take 256 KiB of shared memory, so
//    that instance runs at most three (216 KiB).
//  - Epilogue. O = acc / l is stored as bf16 and lse by one thread a row,
//    both only for rows below seq: a ragged q block writes nothing into the
//    next head's rows. Each row has one owner and there are no atomics, so
//    a launch gives the same bits every time.
//  - Variants, timed at (8, 16, 2048, 128) bf16 on an NVIDIA H100 80GB
//    HBM3 at 700 W, each build of this file timed against the others in
//    one run (medians of 20-call windows; runs on different cards differ
//    by about 2%). This persistent kernel:
//    0.3294-0.3352 ms with 4 stages, 0.3371-0.3434 with 3, 0.3415 with 5,
//    0.4809-0.4852 with 2 (a stage is held from S to P V, so 2 leave no
//    tile in flight). Earlier builds of this file, one block per item:
//    0.3754-0.3759 ms (3 stages, the grid walking groups of 16 heads, q
//    blocks heaviest first); b*h fastest instead of head groups
//    0.4751-0.4880 (K and V of 132 heads at once leave L2); groups of 4, 8
//    or 32 heads 0.3853, 0.3789, 0.3805; 64-row kv tiles doubled to 128
//    0.4088-0.4104 (ptxas spilled 244 bytes and serialised the wgmmas);
//    ping-pong of the two consumer warpgroups in turns on mbarriers 0.3736
//    against 0.3754 in the same run, within the noise (in the persistent
//    kernel 0.3644 against 0.3400, and 1.2044 against 1.1569 ms at seq
//    8192: slower), so it is not kept;
//    the first build, with exp2f of a scaled score and O rescaled after
//    P V, 0.3997. On that build, timing probes gave 0.2808 ms with no
//    softmax arithmetic, 0.3087 with no S product and 0.3382 with no P V
//    product; at (2, 16, 8192, 128) it took 1.2136 ms against 0.3759 here,
//    so a fixed cost of about 5.6 us a block (its start and end: launch,
//    barriers, the loads of Q and the first tiles, the stores) went with
//    every one of the 2048 blocks, which the persistent blocks now hide
//    (1.1605 ms at seq 8192).
#include "sm90.cuh"

namespace flash {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kBlock = 128;    // q rows an item (two warpgroups of 64)
constexpr int kStep = 64;      // kv rows of a streamed tile
constexpr int kThreads = 384;  // two consumer warpgroups, then the producer
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;  // the JAX kernel's mask value: exp() gives 0
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// DQK: the width of a q and k head; DV: of a v (and o) head.
template <int DQK, int DV, int kStages>
struct FwdSmem {
  static constexpr int kPanels = DQK / 64;  // of a q or k row
  static constexpr int kPanelsV = DV / 64;
  Panel<kBlock> q[2][kPanels];  // this item's Q and the next one's
  Panel<kStep> k[kStages][kPanels];
  Panel<kStep> v[kStages][kPanelsV];
  uint64_t q_full[2];
  uint64_t q_empty[2];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// The persistent grid's work: items (b*h, 128-row q block), each head's in
// the order last, first, second last, second, ..., so that two consecutive
// items of a head cost together what any other such pair does; block b
// takes the pairs b, b + gridDim.x, ... and walks its items w from first()
// while w < total, by next(w).
struct Items {
  int n_q;  // q blocks a head
  int total;
  __device__ __forceinline__ int first() const { return 2 * blockIdx.x; }
  __device__ __forceinline__ int next(int w) const {
    return w + ((w & 1) ? 2 * gridDim.x - 1 : 1);
  }
  // Item w's head and first q row.
  __device__ __forceinline__ void get(int w, int& bh, int& q0) const {
    bh = w / n_q;
    const int r = w % n_q;
    q0 = ((r & 1) ? r / 2 : n_q - 1 - r / 2) * kBlock;
  }
};

// 2^x on the special-function unit (one MUFU.EX2; results below 2^-126
// flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step of one 64 x 64 score tile for this thread's two
// rows (row_a and row_a + 8), in base 2 with the scale folded in: s (the
// raw q.k, -1e30 where masked) becomes p = 2^(s * scale_log2 - m), m the
// rows' new running max of s * scale_log2, l the thread's partial
// denominators rescaled and summed, and alpha = 2^(m_old - m) the factor
// by which the rows' accumulators are to be rescaled.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, int k0,
                                             int row_a, int t) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kMasked) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        s[4 * j + e] = col <= row_a + 8 * (e / 2) ? s[4 * j + e] : kNegInf;
      }
      mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);  // the scale is positive
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(s[4 * j + e], scale_log2, -m[e / 2]));
      s[4 * j + e] = p;
      l[e / 2] += p;
    }
  }
}

// The softmax step of tile k0, masked on the diagonal tile only.
__device__ __forceinline__ void softmax_step(bool diagonal, float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], float scale_log2,
                                             int k0, int row_a, int t) {
  if (diagonal) {
    softmax_tile<true>(s, m, l, alpha, scale_log2, k0, row_a, t);
  } else {
    softmax_tile<false>(s, m, l, alpha, scale_log2, k0, row_a, t);
  }
}

// The accumulator's two rows of this thread times their factors.
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}

// The kv tiles of the item at q0: every 64-row tile that starts at or
// below its last row.
__device__ __forceinline__ int item_tiles(int q0, int seq) {
  return (min(q0 + kBlock, seq) - 1) / kStep + 1;
}

// The consumer warpgroups: for each item of this block, S, the softmax,
// then O += P V per kv tile, and the item's O and lse. `tile` counts the
// ring's tiles over the items, as the producer does.
template <int DQK, int DV, int kStages>
__device__ __forceinline__ void fwd_consume(FwdSmem<DQK, DV, kStages>& sm, Items items,
                                            bf16* __restrict__ o, float* __restrict__ lse, int seq,
                                            float scale) {
  regs_alloc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float scale_log2 = scale * kLog2e;
  // The stage of the ring's tile i and the parity of its use.
  const auto stage = [](int i) { return i % kStages; };
  const auto phase = [](int i) { return (uint32_t)(i / kStages) & 1; };
  int tile = 0;
  int n = 0;  // items done
  for (int w = items.first(); w < items.total; w = items.next(w), ++n) {
    int bh, q0;
    items.get(w, bh, q0);
    const int n_tiles = item_tiles(q0, seq);
    const int qw0 = q0 + wg * 64;           // this warpgroup's first q row
    const int row_a = qw0 + warp * 16 + g;  // this thread's two q rows
    const int row_b = row_a + 8;
    // The tiles at or below this warpgroup's diagonal; the last is the
    // diagonal tile (or, when all its rows lie past seq, one whose rows are
    // never stored).
    const int n_live = min(n_tiles, qw0 / kStep + 1);
    const Panel<kBlock>* q = sm.q[n & 1];

    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's partial sums, reduced at the end
    float alpha[2];
    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float s_acc[32];
    uint32_t a_p[4][4];

    // The first tile: S, its softmax, P.
    mbar_wait(&sm.q_full[n & 1], (n >> 1) & 1);
    mbar_wait(&sm.full[stage(tile)], phase(tile));
    wgmma_fence();
    product_ss<DQK, 64>(s_acc, q, wg * 64, sm.k[stage(tile)], 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s_acc);
    softmax_step(n_live == 1, s_acc, m, l, alpha, scale_log2, 0, row_a, t);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(a_p[kk], s_acc, kk);

    for (int it = 1; it < n_live; ++it) {
      const int s = stage(tile + it);
      const int prev = stage(tile + it - 1);
      mbar_wait(&sm.full[s], phase(tile + it));
      // S of this tile, then (O rescaled to the previous tile's max while S
      // runs) O += P V of the previous tile; the softmax of S runs while
      // P V is on the tensor cores.
      wgmma_fence();
      product_ss<DQK, 64>(s_acc, q, wg * 64, sm.k[s], 0);
      wgmma_commit();
      rescale(acc, alpha);
      wgmma_fence();
      product_rs<DV>(acc, a_p, sm.v[prev], 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s_acc);
      softmax_step(it == n_live - 1, s_acc, m, l, alpha, scale_log2, it * kStep, row_a, t);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&sm.empty[prev]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(a_p[kk], s_acc, kk);
    }
    const int last = stage(tile + n_live - 1);
    rescale(acc, alpha);
    wgmma_fence();
    product_rs<DV>(acc, a_p, sm.v[last], 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&sm.empty[last]);
    mbar_arrive(&sm.q_empty[n & 1]);
    // The tile above this warpgroup's diagonal, released unread.
    for (int it = n_live; it < n_tiles; ++it) {
      mbar_wait(&sm.full[stage(tile + it)], phase(tile + it));
      mbar_arrive(&sm.empty[stage(tile + it)]);
    }
    tile += n_tiles;

    // Reduce the denominators over the four threads of each row; store O
    // and lse for the rows below seq only. The producer meanwhile loads the
    // next item's Q and first tiles.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    bf16* ob = o + (size_t)bh * seq * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (row_a < seq) {
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_a * DV + col) =
            __floats2bfloat162_rn(acc[4 * j] / l[0], acc[4 * j + 1] / l[0]);
      }
      if (row_b < seq) {
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_b * DV + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] / l[1], acc[4 * j + 3] / l[1]);
      }
    }
    if (t == 0) {
      if (row_a < seq) lse[(size_t)bh * seq + row_a] = m[0] * kLn2 + logf(l[0]);
      if (row_b < seq) lse[(size_t)bh * seq + row_b] = m[1] * kLn2 + logf(l[1]);
    }
  }
}

// O, lse for this block's items; their kv tiles stream through the ring.
template <int DQK, int DV, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
               float* __restrict__ lse, int bh_total, int seq, float scale) {
  using S = FwdSmem<DQK, DV, kStages>;
  S& sm = smem_as<S>();
  const int n_q = (seq + kBlock - 1) / kBlock;
  const Items items{n_q, bh_total * n_q};

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.q_full[b], 1);
      mbar_init(&sm.q_empty[b], kConsumerThreads);
    }
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
      int tile = 0;
      int n = 0;
      for (int w = items.first(); w < items.total; w = items.next(w), ++n) {
        int bh, q0;
        items.get(w, bh, q0);
        const int b = n & 1;
        mbar_wait(&sm.q_empty[b], ((n >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.q_full[b], S::kPanels * Panel<kBlock>::kBytes);
        for (int p = 0; p < S::kPanels; ++p) {
          tma_load_3d(&sm.q[b][p], &tm_q, &sm.q_full[b], 64 * p, q0, bh);
        }
        const int n_tiles = item_tiles(q0, seq);
        for (int it = 0; it < n_tiles; ++it, ++tile) {
          const int s = tile % kStages;
          mbar_wait(&sm.empty[s], ((tile / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.full[s],
                                (S::kPanels + S::kPanelsV) * Panel<kStep>::kBytes);
          for (int p = 0; p < S::kPanels; ++p) {
            tma_load_3d(&sm.k[s][p], &tm_k, &sm.full[s], 64 * p, it * kStep, bh);
          }
          for (int p = 0; p < S::kPanelsV; ++p) {
            tma_load_3d(&sm.v[s][p], &tm_v, &sm.full[s], 64 * p, it * kStep, bh);
          }
        }
      }
    }
  } else {
    fwd_consume<DQK, DV, kStages>(sm, items, o, lse, seq, scale);
  }
}

// Whether the ring of kStages stages fits beside the two Q buffers in a
// block's 227 KiB of shared memory (with the alignment slack).
template <int DQK, int DV, int kStages>
constexpr bool fwd_fits() {
  return sizeof(FwdSmem<DQK, DV, kStages>) + 1024 <= 232448;
}

template <int DQK, int DV, int kStages>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int seq, float scale, cudaStream_t stream) {
  if constexpr (!fwd_fits<DQK, DV, kStages>()) {
    return cudaErrorInvalidValue;
  } else {
    CUtensorMap tm_q, tm_k, tm_v;
    cudaError_t err;
    if ((err = map_rows_bf16(&tm_q, q, bh, seq, DQK, kBlock)) != cudaSuccess) return err;
    if ((err = map_rows_bf16(&tm_k, k, bh, seq, DQK, kStep)) != cudaSuccess) return err;
    if ((err = map_rows_bf16(&tm_v, v, bh, seq, DV, kStep)) != cudaSuccess) return err;
    const int smem = (int)sizeof(FwdSmem<DQK, DV, kStages>) + 1024;
    err = cudaFuncSetAttribute(fwd_kernel<DQK, DV, kStages>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    // One block an SM (each takes most of an SM's shared memory and
    // registers), or one a pair of items where there are fewer.
    int device, sms;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const int pairs = (bh * ((seq + kBlock - 1) / kBlock) + 1) / 2;
    const dim3 grid(pairs < sms ? pairs : sms);
    fwd_kernel<DQK, DV, kStages><<<grid, kThreads, smem, stream>>>(
        tm_q, tm_k, tm_v, static_cast<bf16*>(o), static_cast<float*>(lse), bh, seq, scale);
    return cudaGetLastError();
  }
}

// The instance of ring depth `stages`: 2, 3 or 4 (4 only where it fits:
// not at q.k heads of 192).
template <int DQK, int DV>
cudaError_t launch_fwd_stages(const void* q, const void* k, const void* v, void* o, void* lse,
                              int bh, int seq, int stages, float scale, cudaStream_t stream) {
  switch (stages) {
    case 2:
      return launch_fwd<DQK, DV, 2>(q, k, v, o, lse, bh, seq, scale, stream);
    case 3:
      return launch_fwd<DQK, DV, 3>(q, k, v, o, lse, bh, seq, scale, stream);
    case 4:
      return launch_fwd<DQK, DV, 4>(q, k, v, o, lse, bh, seq, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flash

// q, k: [bh][seq][d] bf16, v, o: [bh][seq][dv] bf16, all contiguous; lse:
// [bh][seq] f32. Head widths (d, dv) in {(64, 64), (128, 128), (192, 128)};
// stages, the K/V ring's depth, in {2, 3, 4}, and in {2, 3} at (192, 128).
// Returns the launch's cudaGetLastError() (or the tensor-map encoding's
// error); cudaErrorInvalidValue for any other widths or stages.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                         int seq, int d, int dv, int stages, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && dv == 64) {
    return flash::launch_fwd_stages<64, 64>(q, k, v, o, lse, bh, seq, stages, scale, s);
  }
  if (d == 128 && dv == 128) {
    return flash::launch_fwd_stages<128, 128>(q, k, v, o, lse, bh, seq, stages, scale, s);
  }
  if (d == 192 && dv == 128) {
    return flash::launch_fwd_stages<192, 128>(q, k, v, o, lse, bh, seq, stages, scale, s);
  }
  return cudaErrorInvalidValue;
}

// The tied unembed's three f32 products for Hopper (sm_90a), f32-accurate
// on the TF32 tensor cores by the 3xTF32 split ("3xTF32" below).
//
// Replaces: no TPU kernel. The JAX `unembed` (k8s_device_plugin_tpu/
// workload/model.py) leaves its f32 einsum to XLA. On this card cuBLAS runs
// f32 products with TF32 off on the CUDA cores (SIMT FFMA, 67 TFLOP/s at
// most), and offers no f32-accurate tensor-core path; the LM head launches
// the same three large products every full-logits training step:
//   nt  logits = X . E^T   (M x V out, K = d)   forward
//   nn  dX     = G . E     (M x d out, K = V)   backward
//   tn  dE     = G^T . X   (V x d out, K = M)   backward
// with X (M, d) the final norm's rows in f32, E (V, d) the tied embedding
// and G (M, V) the logits' gradient.
//
// The split. Each f32 operand value x is cut into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (cvt.rna.tf32.f32; x - hi is exact in f32 by
// Sterbenz' lemma). hi + lo carries 22 of x's 24 significand bits, so
// |x - hi - lo| <= 2^-22 |x|. A product of two TF32 values is exact in the
// tensor core's f32 accumulator, and
//   a . b  ~  lo_a . hi_b + hi_a . lo_b + hi_a . hi_b
// leaves out lo_a . lo_b, below 2^-22 of each product; at the depths here
// (K = 1,600 to 50,257) the f32 accumulation's own rounding is larger than
// both, so the result is as accurate as the f32 product it replaces (the
// card tests measure this against f64). The two small terms are issued
// before hi . hi at every 8-deep step, so they are added while the sum is
// still small.
//
// What bounds it on this card: 3 * 2 * M * N * K tensor-core operations
// at 495 TFLOP/s (TF32, dense), against one read of each operand and one
// write of the output; at the head's shapes that is hundreds of operations
// a byte, so the bound is the three passes' arithmetic: 3 * 2MNK / 495e12 s,
// a ceiling of 165 TFLOP/s of f32 product, 2.5x the CUDA cores' peak.
//
// What the design does about it:
//  - Tiles of 128 x 128 outputs, 32 deep a stage; persistent blocks, one an
//    SM, walk them in groups of 16 tile-rows, so the blocks at work at once
//    share their operands' panels in L2, and one tile's epilogue overlaps
//    the next tile's loads. Two consumer warpgroups own 64 output rows
//    each; one producer warpgroup loads and splits.
//  - Loads by TMA wherever the operand's rows are 16-byte aligned, into a
//    ring of kRaw raw stages, kLag stages ahead of the split. A K-major
//    operand (K contiguous) lands as one box of 128 rows of 128 bytes,
//    128-byte swizzled (16-byte chunk c of row r at chunk c ^ (r % 8)): the
//    layout wgmma reads. An operand contiguous along its output axis lands
//    as four 32 x 32 panels, depth-major. A box past an edge is zero-filled.
//  - gpt2-xl's G is (8192, 50257) f32: its 201,028-byte rows are not a
//    multiple of 16 bytes, so no tensor map describes it (nor does one for
//    each class of rows 4 apart: a box whose start is not 16-byte aligned
//    never lands). There the producer loads A through registers with
//    coalesced 4-byte loads along whichever axis is contiguous (32 lanes on
//    one row's 32 depths, or 8 lanes on 8 neighbours of 4 depths), issued
//    before it waits for a free stage and splits an earlier stage's B, so
//    that those hide their latency, then stores them K-major and swizzled
//    (free of bank conflicts), zero past the edges. (A second set of
//    registers a stage ahead spilled and ran 2.5x slower.) B, X or E,
//    always has aligned rows.
//  - wgmma takes .tf32 operands only K-major (the transpose flags exist for
//    16-bit types alone), and B only from shared memory. The producer
//    splits each landed B tile into hi and lo, transposing an output-major
//    tile on the way (4-byte reads down a panel's column, 16-byte writes
//    along a K-major row; both free of bank conflicts), into a ring of
//    kSplit stages. A is read raw from its stage into registers by the
//    consumers, split there, and given to wgmma from registers, so A is
//    never written back to shared memory.
//  - Consumers: wgmma.mma_async m64n128k8 .f32.tf32.tf32 with A in
//    registers, lo.hi, hi.lo, then hi.hi at each of a stage's four 8-deep
//    steps, into a fresh f32 partial sum. The tensor core's accumulation
//    truncates, so its error leans towards zero and would grow with the
//    whole depth (on an H100, accumulated there whole: 1.1e-5 of the
//    result's RMS at depth 1,601 against cuBLAS's f32 2.7e-7); each stage's
//    partial is therefore added to the tile's sum in registers, rounded to
//    nearest, and the error stays that of 32 deep (0.3-0.8x cuBLAS's at the
//    head's shapes). While one warpgroup adds, the other's products fill
//    the tensor core.
//  - Variants, timed on an NVIDIA H100 80GB HBM3 at 700 W at the smoke
//    bench's logits (16384 x 32768 x 2048; cuBLAS f32 41.7 ms): this
//    kernel 24.1 ms; both operands split by the producer into shared
//    memory, 128 x 256 tiles, two stages, loads through registers one stage
//    at a time, 42-45 ms (latency-bound producer); every value copied by
//    4-byte cp.async, 59 ms (its consumers alone, fed neither copies nor
//    split, 15.5 ms: the products were never the limit). Five raw stages,
//    three split ones, or raster groups of 8 or 32 tile-rows: each within
//    the spread of this kernel's own repeats in one call (up to 15%) at the
//    six head shapes, none better at all of them.
//  - It allocates nothing. No split, padded or transposed copy of an
//    operand is made in device memory; the output is the caller's.
//  - Each output element has one owner and no atomics: a launch gives the
//    same bits every time.
// Finite inputs: an infinity splits into inf and NaN.
#include "sm90.cuh"

namespace head {

using namespace sm90;

constexpr int kBM = 128;        // output rows of a tile: two consumer warpgroups of 64
constexpr int kBN = 128;        // output columns of a tile
constexpr int kBK = 32;         // depth of a stage: one 128-byte swizzled row of f32
constexpr int kRaw = 4;         // raw stages (A and B as loaded, 32 KiB each)
constexpr int kSplit = 2;       // B's hi and lo for the consumers (32 KiB each)
constexpr int kLag = kRaw - 2;  // loads run this many stages ahead of the split
constexpr int kThreads = 384;   // two consumer warpgroups, then the producer
constexpr int kConsumerThreads = 256;
constexpr int kProducerThreads = 128;
// Registers a thread after setmaxnreg: 128 x 120 + 256 x 192 = 64,512, what
// the launch holds at 168 a thread; the consumers' increase waits until the
// producer's decrease has freed them.
constexpr int kProducerRegs = 120;
constexpr int kConsumerRegs = 192;
constexpr int kGroupM = 16;     // tile-rows a raster group
constexpr int kTile = kBM * kBK;  // floats of an operand's stage (kBM == kBN)

// The operand layouts: A is the M x K operand, B the N x K one, each with
// the output axis (M or N) and the depth K; K-major means K contiguous.
enum Layout { kNT = 0, kNN = 1, kTN = 2 };

// How an operand lands in its raw stage, 128-byte swizzled.
enum Mode {
  kTmaK = 0,   // by TMA, K-major: 128 rows of 32 depths
  kTmaMN = 1,  // by TMA, output-major: four 32 x 32 panels, 32 depths of 32 outputs each
  kLoadK = 2,  // through registers from a K-major A, stored K-major
  kLoadMN = 3,  // through registers from an output-major A, stored K-major
};

// A's tensor map (unused under kLoadK and kLoadMN) and B's.
struct Maps {
  CUtensorMap a;
  CUtensorMap b;
};

// A matrix operand loaded through registers: element (i, k), i along the
// output axis, at p[i * s_mn + k * s_k]; one of the two strides is 1.
struct Operand {
  const float* p;
  long long s_mn;
  long long s_k;
  int mn;  // extent along the output axis
};

struct Smem {
  float a_raw[kRaw][kTile];
  float b_raw[kRaw][kTile];
  float b_hi[kSplit][kTile];
  float b_lo[kSplit][kTile];
  uint64_t loaded[kRaw];    // the stage's A and B have landed
  uint64_t raw_free[kRaw];  // the consumers have read the stage's A
  uint64_t full[kSplit];    // the producer has stored B's hi and lo
  uint64_t empty[kSplit];   // the consumers' products from them are done
};

// The float offset of element (r, k) in a K-major 128-byte-swizzled tile.
__device__ __forceinline__ int swz(int r, int k) {
  return r * kBK + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}

// The float offset of element (r, k) in four output-major 32 x 32 panels,
// as a TMA box of 32 output values by 32 depths lands 128-byte swizzled.
__device__ __forceinline__ int swz_mn(int r, int k) {
  return (r >> 5) * (kBK * 32) + k * 32 + (((((r & 31) >> 2) ^ k) & 7) << 2) + (r & 3);
}

// A producer thread's 32 values of A's 128 x 32 stage under kLoadK (rows
// w + 4i at depth `lane`) or kLoadMN (8-row groups w + 4(i / 8), row
// 8 * group + lane % 8, at depth 4 (i % 8) + lane / 8).
template <int kMode>
struct LoadMap {
  static constexpr bool kKMajor = kMode == kLoadK;
  __device__ __forceinline__ static int row(int i, int w, int lane) {
    return kKMajor ? w + 4 * i : 8 * (w + 4 * (i >> 3)) + (lane & 7);
  }
  __device__ __forceinline__ static int depth(int i, int lane) {
    return kKMajor ? lane : 4 * (i & 7) + (lane >> 3);
  }
};

// Load this thread's values of A's stage at (mn0, k0); 0 outside A. One
// pointer walks them by fixed steps, so that few registers hold addresses.
template <int kMode>
__device__ __forceinline__ void load_a(float (&v)[kBM / 4], const Operand& op, int mn0, int k0,
                                       int depth, int w, int lane) {
  if constexpr (kMode == kLoadK) {  // rows mn0 + w + 4i at depth k0 + lane
    const int rows = op.mn - (mn0 + w);
    const bool in_depth = k0 + lane < depth;
    const float* p = op.p + (long long)(mn0 + w) * op.s_mn + (k0 + lane);
    const long long step = 4 * op.s_mn;
#pragma unroll
    for (int i = 0; i < kBM / 4; ++i, p += step) {
      v[i] = (in_depth && 4 * i < rows) ? __ldg(p) : 0.f;
    }
  } else {  // rows mn0 + 8w + lane % 8 + 32g at depths k0 + lane / 8 + 4c
    const int rows = op.mn - (mn0 + 8 * w + (lane & 7));
    const int depths = depth - (k0 + (lane >> 3));
    const float* p = op.p + (mn0 + 8 * w + (lane & 7)) + (long long)(k0 + (lane >> 3)) * op.s_k;
    const long long step = 4 * op.s_k;
#pragma unroll
    for (int g = 0; g < kBM / 32; ++g) {
      const float* q = p + 32 * g;
#pragma unroll
      for (int c = 0; c < 8; ++c, q += step) {
        v[8 * g + c] = (32 * g < rows && 4 * c < depths) ? __ldg(q) : 0.f;
      }
    }
  }
}

// Store them K-major and swizzled.
template <int kMode>
__device__ __forceinline__ void store_a(const float (&v)[kBM / 4], float* dst, int w, int lane) {
  using Map = LoadMap<kMode>;
#pragma unroll
  for (int i = 0; i < kBM / 4; ++i) dst[swz(Map::row(i, w, lane), Map::depth(i, lane))] = v[i];
}

// x rounded to TF32 (nearest, ties away), as an f32 with 13 zero low bits.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// Generic-proxy stores to shared memory made visible to wgmma (the async
// proxy), before the barrier that hands the stage over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ float4 split_hi(const float4& x) {
  return make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
}

__device__ __forceinline__ float4 split_lo(const float4& x, const float4& h) {
  return make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y), tf32_rna(x.z - h.z),
                     tf32_rna(x.w - h.w));
}

// B's hi and lo, K-major and swizzled, from its landed raw stage. A K-major
// raw tile has the same layout: 16 bytes a thread at a time. An
// output-major one is transposed: warp w takes panel w, lane l its row
// 32 w + l, and gathers each 16-byte chunk of that row from four depths.
template <int kMode>
__device__ __forceinline__ void split_b(const float* raw, float* hi, float* lo, int t, int w,
                                        int lane) {
  if constexpr (kMode == kTmaK) {
#pragma unroll
    for (int j = 0; j < kTile / 4 / kProducerThreads; ++j) {
      const int v = t + j * kProducerThreads;
      const float4 x = reinterpret_cast<const float4*>(raw)[v];
      const float4 h = split_hi(x);
      reinterpret_cast<float4*>(hi)[v] = h;
      reinterpret_cast<float4*>(lo)[v] = split_lo(x, h);
    }
  } else {
    static_assert(kMode == kTmaMN, "B is loaded by TMA");
    const int r = 32 * w + lane;
#pragma unroll
    for (int c = 0; c < kBK / 4; ++c) {
      float4 x;
      x.x = raw[swz_mn(r, 4 * c)];
      x.y = raw[swz_mn(r, 4 * c + 1)];
      x.z = raw[swz_mn(r, 4 * c + 2)];
      x.w = raw[swz_mn(r, 4 * c + 3)];
      const float4 h = split_hi(x);
      const int v = swz(r, 4 * c) / 4;
      reinterpret_cast<float4*>(hi)[v] = h;
      reinterpret_cast<float4*>(lo)[v] = split_lo(x, h);
    }
  }
}

// The persistent grid's work: tile t, in groups of kGroupM tile-rows each
// walked column by column; block b takes tiles b, b + gridDim.x, ...
struct Tiles {
  int tiles_m;
  int tiles_n;
  int total;
  __device__ __forceinline__ void get(int t, int& tm, int& tn) const {
    const int group = kGroupM * tiles_n;
    const int first = (t / group) * kGroupM;
    const int rows = min(tiles_m - first, kGroupM);
    const int r = t % group;
    tm = first + r % rows;
    tn = r / rows;
  }
};

// D(64 x 128) (+)= A(64 x 8, registers) . B(8 x 128, shared memory, K-major) in
// TF32.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// The producer warpgroup. Iteration `it` loads stage `it` (thread 0 issues
// its TMA boxes; under kLoadK and kLoadMN every thread first starts loading
// its share of A into registers), splits B of stage it - kLag, whose loads
// have had kLag stages' time to land, and then stores the A it loaded: the
// wait for a free stage and the split hide the loads' latency.
template <int kAMode, int kBMode>
__device__ __forceinline__ void produce(Smem& sm, const Tiles& tiles, const Maps& maps,
                                        const Operand& a, int depth) {
  regs_dealloc<kProducerRegs>();
  constexpr bool kTmaA = kAMode == kTmaK || kAMode == kTmaMN;
  const int t = threadIdx.x - kConsumerThreads;
  const int w = t / 32;
  const int lane = t % 32;
  const int n_k = (depth + kBK - 1) / kBK;
  const int total = (tiles.total - blockIdx.x + gridDim.x - 1) / gridDim.x * n_k;
  float va[kBM / 4];
  for (int it = 0; it < total + kLag; ++it) {
    if (it < total) {
      int tm, tn;
      tiles.get(blockIdx.x + (it / n_k) * gridDim.x, tm, tn);
      const int m0 = tm * kBM;
      const int n0 = tn * kBN;
      const int k0 = (it % n_k) * kBK;
      if constexpr (!kTmaA) load_a<kAMode>(va, a, m0, k0, depth, w, lane);
      const int r = it % kRaw;
      mbar_wait(&sm.raw_free[r], ((it / kRaw) & 1) ^ 1);
      if (t == 0) {
        mbar_arrive_expect_tx(&sm.loaded[r], (kTmaA ? 2 : 1) * kTile * 4);
        if constexpr (kAMode == kTmaK) {
          tma_load_2d(sm.a_raw[r], &maps.a, &sm.loaded[r], k0, m0);
        } else if constexpr (kAMode == kTmaMN) {
          for (int p = 0; p < kBM / 32; ++p) {
            tma_load_2d(sm.a_raw[r] + p * kBK * 32, &maps.a, &sm.loaded[r], m0 + 32 * p, k0);
          }
        }
        if constexpr (kBMode == kTmaK) {
          tma_load_2d(sm.b_raw[r], &maps.b, &sm.loaded[r], k0, n0);
        } else {
          for (int p = 0; p < kBN / 32; ++p) {
            tma_load_2d(sm.b_raw[r] + p * kBK * 32, &maps.b, &sm.loaded[r], n0 + 32 * p, k0);
          }
        }
      }
    }
    const int j = it - kLag;
    if (j >= 0) {
      const int r = j % kRaw;
      const int s = j % kSplit;
      mbar_wait(&sm.loaded[r], (j / kRaw) & 1);
      mbar_wait(&sm.empty[s], ((j / kSplit) & 1) ^ 1);
      split_b<kBMode>(sm.b_raw[r], sm.b_hi[s], sm.b_lo[s], t, w, lane);
      fence_proxy_async();
      mbar_arrive(&sm.full[s]);
    }
    if constexpr (!kTmaA) {
      if (it < total) {
        store_a<kAMode>(va, sm.a_raw[it % kRaw], w, lane);
        mbar_arrive(&sm.loaded[it % kRaw]);
      }
    }
  }
}

// The consumer warpgroups: warpgroup wg owns output rows 64 wg .. 64 wg + 63
// of each tile. Per stage: A's values for this thread's fragments, read
// raw and split in registers (then the raw stage is released, once B's
// split is done too); the three
// products of each 8-deep step (the two small ones first) into a fresh
// partial sum, added to the tile's sum in registers once the products are
// done. At a tile's end its outputs inside the matrix are stored.
template <int kAMode>
__device__ __forceinline__ void consume(Smem& sm, const Tiles& tiles, float* __restrict__ c,
                                        long long ldc, int m, int n, int depth) {
  regs_alloc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int n_k = (depth + kBK - 1) / kBK;
  // Pairs of neighbouring columns are stored as one 8-byte value where
  // every row starts 8-byte aligned.
  const bool pairs = (ldc % 2 == 0) && (reinterpret_cast<uintptr_t>(c) % 8 == 0);
  // The A fragment of an 8-deep step (as mma.sync m16n8k8's per warp):
  // register e holds row g + 8 (e % 2), depth q + 4 (e / 2) of the warp's
  // 16 rows; these are its offsets in the raw stage at step 0.
  const int row_a = wg * 64 + warp * 16 + g;
  int a_off[4][4];
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row_a + 8 * (e & 1);
      const int k = 8 * kk + q + 4 * (e >> 1);
      a_off[kk][e] = kAMode == kTmaMN ? swz_mn(r, k) : swz(r, k);
    }
  }
  float acc[kBN / 2];
  float part[kBN / 2];
  int it = 0;  // stages taken, across the tiles
  for (int t = blockIdx.x; t < tiles.total; t += gridDim.x) {
    int tm, tn;
    tiles.get(t, tm, tn);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < n_k; ++kb, ++it) {
      const int r = it % kRaw;
      const int s = it % kSplit;
      mbar_wait(&sm.loaded[r], (it / kRaw) & 1);
      uint32_t a_hi[kBK / 8][4];
      uint32_t a_lo[kBK / 8][4];
      const float* raw = sm.a_raw[r];
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = raw[a_off[kk][e]];
          const float h = tf32_rna(x);
          a_hi[kk][e] = __float_as_uint(h);
          a_lo[kk][e] = __float_as_uint(tf32_rna(x - h));
        }
      }
      // Released only once B's split of this stage is done (`full`): every
      // producer thread arrives there after reading the raw B, so no TMA of
      // a later stage overwrites it under a thread still splitting.
      mbar_wait(&sm.full[s], (it / kSplit) & 1);
      mbar_arrive(&sm.raw_free[r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const uint64_t b_hi = desc_sw128(sm.b_hi[s] + 8 * kk, 16, 1024);
        const uint64_t b_lo = desc_sw128(sm.b_lo[s] + 8 * kk, 16, 1024);
        wgmma_m64n128k8_tf32_rs(part, a_lo[kk], b_hi, kk > 0);
        wgmma_m64n128k8_tf32_rs(part, a_hi[kk], b_lo, 1);
        wgmma_m64n128k8_tf32_rs(part, a_hi[kk], b_hi, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
      mbar_arrive(&sm.empty[s]);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
    }

    // Register 4j + e holds row g + 8 (e / 2), column 8j + 2q + (e % 2) of
    // this warp's 16 rows (sm90.cuh).
    const int col0 = tn * kBN + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tm * kBM + row_a + 8 * h;
      if (row >= m) continue;
      float* out = c + (long long)row * ldc;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = col0 + 8 * j;
        const float x0 = acc[4 * j + 2 * h];
        const float x1 = acc[4 * j + 2 * h + 1];
        if (pairs && col + 1 < n) {
          *reinterpret_cast<float2*>(out + col) = make_float2(x0, x1);
        } else {
          if (col < n) out[col] = x0;
          if (col + 1 < n) out[col + 1] = x1;
        }
      }
    }
  }
}

template <int kAMode, int kBMode>
__device__ __forceinline__ void gemm_body(const Maps& maps, const Operand& a, float* c,
                                          long long ldc, int m, int n, int depth) {
  Smem& sm = smem_as<Smem>();
  Tiles tiles{(m + kBM - 1) / kBM, (n + kBN - 1) / kBN, 0};
  tiles.total = tiles.tiles_m * tiles.tiles_n;
  if (threadIdx.x == 0) {
    for (int r = 0; r < kRaw; ++r) {
      // The TMA thread's arrival, and each producer thread's where A comes
      // through registers.
      mbar_init(&sm.loaded[r], kAMode == kTmaK || kAMode == kTmaMN ? 1 : 1 + kProducerThreads);
      mbar_init(&sm.raw_free[r], kConsumerThreads);
    }
    for (int s = 0; s < kSplit; ++s) {
      mbar_init(&sm.full[s], kProducerThreads);
      mbar_init(&sm.empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumerThreads) {
    produce<kAMode, kBMode>(sm, tiles, maps, a, depth);
  } else {
    consume<kAMode>(sm, tiles, c, ldc, m, n, depth);
  }
}

// One kernel a layout, so that a trace names the product it ran; each
// carries gemm_f32f32 in its name, as the f32 products of a step are
// grouped by it. kAMode: how A reaches shared memory.
template <int kAMode>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_f32f32_3xtf32_nt(const __grid_constant__ Maps maps, const Operand a, float* c,
                          long long ldc, int m, int n, int depth) {
  gemm_body<kAMode, kTmaK>(maps, a, c, ldc, m, n, depth);
}

template <int kAMode>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_f32f32_3xtf32_nn(const __grid_constant__ Maps maps, const Operand a, float* c,
                          long long ldc, int m, int n, int depth) {
  gemm_body<kAMode, kTmaMN>(maps, a, c, ldc, m, n, depth);
}

template <int kAMode>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_f32f32_3xtf32_tn(const __grid_constant__ Maps maps, const Operand a, float* c,
                          long long ldc, int m, int n, int depth) {
  gemm_body<kAMode, kTmaMN>(maps, a, c, ldc, m, n, depth);
}

// A tensor map over an f32 matrix of `rows` rows of `cols` values, row
// stride `ld` values, in boxes of 32 values by `box_rows` rows, 128-byte
// swizzled; a box past an edge is zero-filled.
inline cudaError_t map_f32(CUtensorMap* map, const float* base, long long cols, long long rows,
                           long long ld, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether TMA can describe rows of stride `ld` values from `p`.
inline bool tma_aligned(const float* p, long long ld) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kLayout, int kAMode>
constexpr auto kernel_of() {
  if constexpr (kLayout == kNT) {
    return gemm_f32f32_3xtf32_nt<kAMode>;
  } else if constexpr (kLayout == kNN) {
    return gemm_f32f32_3xtf32_nn<kAMode>;
  } else {
    return gemm_f32f32_3xtf32_tn<kAMode>;
  }
}

template <int kLayout, int kAMode>
cudaError_t launch(const Maps& maps, const Operand& a, float* c, long long ldc, int m, int n,
                   int depth, cudaStream_t stream) {
  const auto kernel = kernel_of<kLayout, kAMode>();
  const int smem = (int)sizeof(Smem) + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles < sms ? tiles : sms));
  kernel<<<grid, kThreads, smem, stream>>>(maps, a, c, ldc, m, n, depth);
  return cudaGetLastError();
}

}  // namespace head

// C (m x n, row stride ldc) = the product `layout` of a and b, f32, all
// row-major with row strides in elements:
//   0 (nt): a (m x k, lda), b (n x k, ldb): C = a . b^T
//   1 (nn): a (m x k, lda), b (k x n, ldb): C = a . b
//   2 (tn): a (k x m, lda), b (k x n, ldb): C = a^T . b
// b and its rows start 16-byte aligned (and, for nt, a and a's rows); for
// nn and tn a's need not. Returns the launch's cudaGetLastError(),
// the tensor maps' encoding error, or cudaErrorInvalidValue for any other
// layout or alignment.
extern "C" int head_gemm(int layout, const void* a, long long lda, const void* b, long long ldb,
                         void* c, long long ldc, int m, int n, int k, void* stream) {
  using namespace head;
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* pc = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout < kNT || layout > kTN || !tma_aligned(pb, ldb)) return cudaErrorInvalidValue;
  const bool a_tma = tma_aligned(pa, lda);
  if (layout == kNT && !a_tma) return cudaErrorInvalidValue;
  Maps maps = {};
  cudaError_t err;
  if (layout == kNT) {  // b (n x k): K-major
    err = map_f32(&maps.b, pb, k, n, ldb, kBN);
  } else {  // b (k x n): output-major panels
    err = map_f32(&maps.b, pb, n, k, ldb, 32);
  }
  if (err != cudaSuccess) return err;
  if (layout == kTN) {  // a (k x m): output-major
    const Operand op{pa, 1, lda, m};
    if (!a_tma) return launch<kTN, kLoadMN>(maps, op, pc, ldc, m, n, k, s);
    if ((err = map_f32(&maps.a, pa, m, k, lda, 32)) != cudaSuccess) return err;
    return launch<kTN, kTmaMN>(maps, op, pc, ldc, m, n, k, s);
  }
  // a (m x k): K-major
  const Operand op{pa, lda, 1, m};
  if (!a_tma) return launch<kNN, kLoadK>(maps, op, pc, ldc, m, n, k, s);
  if ((err = map_f32(&maps.a, pa, k, m, lda, kBM)) != cudaSuccess) return err;
  return layout == kNT ? launch<kNT, kTmaK>(maps, op, pc, ldc, m, n, k, s)
                       : launch<kNN, kTmaK>(maps, op, pc, ldc, m, n, k, s);
}

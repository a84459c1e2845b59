// Fused pixelNeRF field MLP (ResnetFC), bf16, on Hopper tensor cores
// (sm_90a).
//
// Replaces, for bf16, the four Pallas TPU kernels of the JAX package's
// pixelnerf_yolo_tpu/ops/pallas/fused_mlp.py:
//   mode 0  full_pe         <- fused_full_pe        (_full_pe_kernel)
//   mode 1  pre_combine_pe  <- fused_pre_combine_pe (_pre_combine_pe_kernel)
//   mode 2  post_combine    <- fused_post_combine   (_post_combine_kernel)
//   mode 3  pre_combine     <- fused_pre_combine    (_pre_combine_kernel)
// (their f32 variants run on the CUDA cores in field_mlp_f32.cu).  Modes 0, 1
// and 3 run lin_in, then n_pre x (lin_z, fc_0, fc_1); modes 0 and 1 compute
// the positional encoding of [xyz, viewdirs] in the kernel, mode 3 loads
// given z-features.  Modes 0 and 2 run n_post x (fc_0, fc_1), then lin_out
// (f32 output); mode 2 starts from a given h.  The rounding points are the
// plain twins' (ops/field_mlp.py): every Dense is an f32 accumulation plus
// an f32 bias, then one cast to bf16; the residual add is bf16(f32(x) +
// f32(t)); relu where the reference applies it; lin_out is relu(x) times
// the bf16 w_out, accumulated in f32, plus the f32 b_out.  Only the order
// of summation differs.
//
// What bounds it: at H = dL = 512, n_pre = 3, a row costs 2.38 M
// multiply-adds (4.35 M at dL = 1792; 3.43 M for the whole chain of mode
// 0, 1.05 M for mode 2's two blocks) against ~2 KB of input and output,
// so the work is bound by the tensor cores (989 TFLOP/s bf16: 5.0 ms for
// 1,048,576 rows of mode 1).  The weights (4.8 MB at dL 512, 8.7 MB at dL
// 1792) stay in the 50 MB L2, but cannot sit in one SM's 227 KB, so they
// stream:
//   - The host packs them once (ops/field_mlp.py::pack_tc) as a sequence
//     of 16-deep K slices in the order the chain consumes them (lin_in,
//     pre blocks, post blocks, lin_out), each slice in wgmma's K-major
//     no-swizzle core-matrix layout (8 x 16 B core matrices; 128 B apart
//     along K, 256 B apart along N).  One ring stage is then one
//     contiguous 32 * H bytes, loaded by a 2-D TMA tensor copy (rows of
//     512 B) with mbarrier transaction counts.  lin_out's slices (16 x
//     Nout) lie H / Nout to a stage.  Mode 2 starts its walk at the first
//     post block's stage (the host offsets the stream's address).
//   - A producer warp (one thread) issues every stage as soon as its slot
//     is free; each consumer warpgroup releases a stage with an mbarrier
//     arrive on every CTA of the cluster.  There is no __syncthreads in
//     the k-loops, only a named barrier of the consumers between layers.
//   - L2 traffic: one CTA has 64 rows (one wgmma M tile; X and the fc_0
//     output of 64 x 512 bf16 take 130 KB, which leaves room for a 5-stage
//     ring and no more rows).  Fetched once per 64 rows, a NeRF launch of
//     1,048,576 rows would pull 4.76 MB x 16,384 = 78 GB out of L2: 7.8
//     TB/s at a 10 ms kernel, more than L2 delivers.  So CTAs run in
//     clusters of kCluster and each stage is multicast to every CTA of the
//     cluster (each CTA copies 1/kCluster of it): kCluster = 2 gives 128
//     rows per fetch, 39 GB per launch (~3.9 TB/s at 10 ms).
//   - The latent is streamed, not held: lin_z's A operand (64 rows x 16
//     columns) arrives in the same stage as its weight slice, by a TMA
//     tensor copy that fills rows past n_rows with zeros.  Shared memory no
//     longer grows with d_latent.  Each CTA reads its latent rows once per
//     block (n_pre times); the re-reads are microseconds apart.
//   - Two consumer warpgroups share the CTA's 64 rows and split the H
//     columns: each holds a 64 x H/2 f32 accumulator (128 registers at
//     H = 512) and, per 16-deep stage, issues H/32 wgmma.mma_async
//     m64n16k16 products with B from the ring through a matrix descriptor,
//     then waits for them before it releases the stage.
//   - Registers: ptxas gives each thread of these 9 warps at most 168
//     (with a 17th warp, 96) and, measured on the H100, did not raise that
//     for setmaxnreg.  The 128 accumulators fit only with products 16
//     columns wide: m64n32k16 and wider made ptxas spill the accumulators
//     around every product (several times slower); four consumer
//     warpgroups of 64 accumulators spilled under the 96 cap.
//   - relu(x) as fc_0's A operand: every A operand is loaded into
//     registers with ldmatrix and fed to the register-A form of wgmma, so
//     fc_0 applies relu to the fragment (4 registers per k step) and no
//     relu'd copy of x is kept (it would cost 64 KB of shared memory).
//     X and the fc_0 output are row-major with an 8-element row pad
//     (conflict-free ldmatrix and epilogue stores).
//   - lin_out (modes 0 and 2) is a small product: Nout = 8 kG columns
//     (d_out rounded up: 8 for NeRF's 4, 24 for YOLO's 21), streamed like
//     the other layers.  The two consumer warpgroups split its kG
//     8-column groups (the first takes ceil(kG / 2)) and issue one
//     m64n8k16 product per group and K slice (4 f32 accumulators each,
//     relu'd register A from X); at kG = 1 the second only releases
//     lin_out's stage.  Its 1-2 stages are 1-2% of a chain of 129-420.
// Rows past n_rows load zeros and store nothing; the tensors are not
// padded.  h is read (mode 2) and written (modes 1, 3) with 16-byte
// accesses; the f32 output of modes 0 and 2 with scalar stores (a row of
// d_out floats is not 16-byte aligned).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;            // rows per CTA: one wgmma M tile
constexpr int kBK = 16;              // depth of a ring stage: one wgmma K step
constexpr int kStages = 5;           // ring stages
// CTAs per cluster sharing each stage (scripts/bench_tc_cluster.py builds
// the kernel with another value to measure what the cluster gives)
#ifndef FIELD_MLP_TC_CLUSTER
#define FIELD_MLP_TC_CLUSTER 2
#endif
constexpr int kCluster = FIELD_MLP_TC_CLUSTER;
constexpr int kConsumerWGs = 2;      // consumer warpgroups, one per column half
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kPad = 8;              // row pad of X and A2, in bf16
constexpr int kLatBytes = kRows * kBK * 2;  // latent slice of a stage
constexpr float kHalfPi = 1.57079637050628662109375f;  // float32(pi / 2)

enum Epilogue { kSet = 0, kAdd = 1, kRelu = 2 };
enum Source { kBuf = 0, kReluBuf = 1, kLatent = 2 };

struct Params {
  const float* base;    // (n, 6) f32 [xyz, viewdirs], modes 0 and 1
  const bf16* zfeat;    // (n, d_in), mode 3
  const bf16* h;        // (n, H), mode 2
  const float* b_in;    // (H,)
  const float* bz;      // (n_pre, H)
  const float* b0;
  const float* b1;
  const float* b0p;     // (n_post, H)
  const float* b1p;
  const float* b_out;   // (d_out,)
  void* out;            // (n, H) bf16 (modes 1, 3), (n, d_out) f32 (0, 2)
  int n_rows, d_in, d_latent, n_pre, n_post, d_out, num_freqs, mode;
  float freq_factor;
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// lin_out's width Nout: d_out rounded up to a multiple of 8 up to 32, then
// to 64, 128 or 256 (one lin_out instantiation per width); 0 past 256
__host__ __device__ constexpr int out_width(int d_out) {
  return d_out <= 0    ? 0
         : d_out <= 32 ? round_up(d_out, 8)
         : d_out <= 64 ? 64
         : d_out <= 128 ? 128
         : d_out <= 256 ? 256
                        : 0;
}

// ring stages of lin_out: its H / 16 K slices of 16 x nout, H / nout to a
// stage (nout <= H)
__host__ __device__ constexpr int out_stages(int h, int nout) {
  return (h / kBK + h / nout - 1) / (h / nout);
}

// -- PTX helpers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the barrier's phase `parity` to complete.  A wait of more than
// 2^35 cycles (~17 s) means an arrival or a copy was lost: the kernel traps
// (the launch fails with an error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// arrive on the barrier at the same offset in CTA `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}"
      :: "r"(bar), "r"(cta) : "memory");
}

// one 2-D TMA box into shared memory; with kCluster > 1 it lands at the
// same offset in every CTA of the cluster and signals each CTA's barrier
__device__ __forceinline__ void tma_load_2d_all(uint32_t dst,
                                                const CUtensorMap* map, int c0,
                                                int c1, uint32_t bar) {
  if constexpr (kCluster > 1) {
    const uint16_t mask = (1u << kCluster) - 1;
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(bar), "h"(mask)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(bar)
        : "memory");
  }
}

// one 2-D TMA box (c0 innermost) into this CTA's shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t v) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&v);
  x = __hmax2(x, __float2bfloat162_rn(0.f));
  return *reinterpret_cast<uint32_t*>(&x);
}

// wgmma matrix descriptor, no swizzle: start address, LBO (between the
// two core matrices of a K step) 128 B, SBO (between 8-row groups along
// N) 256 B, all in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accesses of an accumulator register across
// the asynchronous product
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d[0, 8) += A (64 x 16, registers) * B (16 x 16, shared memory
// descriptor, K-major); the accumulator layout of PTX's m64nNk16 f32.
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[0, 4) += A (64 x 16, registers) * B (16 x 8, one 8-row group)
__device__ __forceinline__ void wgmma_n8(float* d, const uint32_t* a,
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// -- the chain ---------------------------------------------------------------

template <int kH>
__host__ __device__ constexpr int stage_bytes() {
  return kBK * kH * 2 + kLatBytes;
}

// Shared memory, from a 1024-byte-aligned base: the ring (kStages x
// (16 x H weight slice + 64 x 16 latent slice)), X (64 x (H + 8)) the
// residual stream, A2 (64 x (H + 8)) the z-features, then the relu'd fc_0
// output, and the full / empty barriers.
template <int kH>
struct Layout {
  static constexpr int kLd = kH + kPad;
  static constexpr int kX = kStages * stage_bytes<kH>();
  static constexpr int kA2 = kX + kRows * kLd * 2;
  static constexpr int kFull = kA2 + kRows * kLd * 2;
  static constexpr int kEmpty = kFull + 8 * kStages;
  static constexpr int kBytes = kEmpty + 8 * kStages;
};

// Stage t of the walk over the ring (the consumers' and the producer's):
// its slot, the parity of its use of the slot, and the shared addresses of
// the slot and its barriers.  Only the count t and the base address stay
// live across the chain.
template <int kH>
struct Stage {
  uint32_t addr, full, empty, parity;
  __device__ Stage(uint32_t base, int t) {
    const int slot = t % kStages;
    parity = (t / kStages) & 1;
    addr = base + slot * stage_bytes<kH>();
    full = base + Layout<kH>::kFull + 8 * slot;
    empty = base + Layout<kH>::kEmpty + 8 * slot;
  }
};

// The groups of modes, each with its own kernel instantiation: kPreHalf
// the pre-combine half (modes 1, 3), kWhole the whole chain (mode 0),
// kPostHalf the post-combine half (mode 2).  Measured on the H100, code of
// the other groups in one kernel slowed modes 1 and 3 by ~4%, though it
// never ran.
enum Kind { kPreHalf = 0, kWhole = 1, kPostHalf = 2 };

// Stages of a mode's walk: lin_in and n_pre x (lin_z's latent-carrying
// stages, fc_0, fc_1) before the combine (modes 0, 1, 3); n_post x (fc_0,
// fc_1) and lin_out after it (modes 0, 2).
template <int kH>
int walk_stages(const Params& p) {
  int n = 0;
  if (p.mode != 2)
    n += round_up(p.d_in, kBK) / kBK + p.n_pre * (p.d_latent + 2 * kH) / kBK;
  if (p.mode == 0 || p.mode == 2)
    n += p.n_post * 2 * kH / kBK + out_stages(kH, out_width(p.d_out));
  return n;
}

// The producer: one thread issues the copies, in the order the chain
// consumes the packed K slices (lin_in's; per pre block lin_z's, each with
// its latent slice, fc_0's and fc_1's; per post block fc_0's and fc_1's;
// lin_out's), each as soon as its slot is free, that is once every
// consumer warpgroup of the cluster has released the slot's previous use.
// Its issue is on the critical path: measured on the H100, nested loops
// over the blocks in place of these flat ones slowed modes 1 and 3 by ~1.5%.
template <int kH, int kKind>
__device__ __forceinline__ void fill(const CUtensorMap* w_map,
                                    const CUtensorMap* lat_map,
                                    const Params& p, uint32_t base) {
  constexpr uint32_t kW = kBK * kH * 2;
  constexpr uint32_t kPiece = kW / kCluster;
  constexpr int kPieceRows = kH / 16 / kCluster;  // 512-byte rows of w_map
  constexpr int kBlock = 2 * kH / kBK;             // stages of fc_0 + fc_1
  const int row0 = blockIdx.x * kRows;
  const uint32_t rank = cluster_rank();
  int t = 0;
  if constexpr (kKind != kPostHalf) {
    const int n_in = round_up(p.d_in, kBK) / kBK;
    const int n_lat = p.d_latent / kBK;
    const int per_blk = n_lat + kBlock;
    const int total = n_in + p.n_pre * per_blk;
    // u: the stage's place in its block (negative during lin_in); the
    // first n_lat places carry a latent slice
    for (int u = -n_in; t < total; ++t, u = u + 1 == per_blk ? 0 : u + 1) {
      const Stage<kH> st(base, t);
      const bool lat = u >= 0 && u < n_lat;
      mbar_wait(st.empty, st.parity ^ 1);
      mbar_expect_tx(st.full, kW + (lat ? kLatBytes : 0));
      tma_load_2d_all(st.addr + rank * kPiece, w_map, 0,
                      (t * kCluster + rank) * kPieceRows, st.full);
      if (lat) tma_load_2d(st.addr + kW, lat_map, u * kBK, row0, st.full);
    }
  }
  if constexpr (kKind != kPreHalf) {
    // the post blocks and lin_out: weights only
    const int total =
        t + p.n_post * kBlock + out_stages(kH, out_width(p.d_out));
    for (; t < total; ++t) {
      const Stage<kH> st(base, t);
      mbar_wait(st.empty, st.parity ^ 1);
      mbar_expect_tx(st.full, kW);
      tma_load_2d_all(st.addr + rank * kPiece, w_map, 0,
                      (t * kCluster + rank) * kPieceRows, st.full);
    }
  }
}

// The consumers' position: the ring's base address and the next stage.
struct Walk {
  uint32_t base;
  int t = 0;
};

// dst[64 x H] <- epilogue(A (64 x K) W (K x H) + bias) for this
// warpgroup's H / kConsumerWGs columns; W's K slices arrive through the
// ring.
template <int kH, int kSrc, int kEpi>
__device__ __forceinline__ void layer(const bf16* A, int K,
                                      const float* __restrict__ bias, bf16* dst,
                                      Walk& walk) {
  constexpr int kLd = kH + kPad;
  constexpr int kCols = kH / kConsumerWGs;  // this warpgroup's columns
  constexpr int kAcc = kCols / 2;  // f32 accumulators per thread
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part = warp / 4, quarter = warp % 4;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // this lane's ldmatrix row and 8-column chunk of the 16 x 16 A tile
  const int arow = 16 * quarter + lane % 16;
  const int achunk = lane / 16;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const Stage<kH> st(walk.base, walk.t);
    const uint32_t stage = st.addr;
    mbar_wait(st.full, st.parity);
    uint32_t a[4];
    if constexpr (kSrc == kLatent) {
      ldmatrix_x4(a, stage + kBK * kH * 2 + arow * (kBK * 2) + achunk * 16);
    } else {
      ldmatrix_x4(a, smem_u32(A + arow * kLd + k0 + 8 * achunk));
    }
    if constexpr (kSrc == kReluBuf) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = relu_bf16x2(a[i]);
    }
    // this warpgroup's columns start at 8-row group part * kCols / 8
    const uint64_t desc = make_desc(stage + part * (kCols / 8) * 256);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
    wgmma_fence();
    // 16 columns a product (two 8-row groups of 256 B): wider ones spill
#pragma unroll
    for (int j = 0; j < kCols / 16; ++j)
      wgmma_n16(acc + 8 * j, a, desc + (uint64_t)j * (512 >> 4));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
    // the warpgroup's product is complete, so all four warps have read
    // their A fragments and the stage: one release per warpgroup
    if (quarter == 0 && lane == 0) {
#pragma unroll
      for (int c = 0; c < kCluster; ++c)
        mbar_arrive_cluster(st.empty, c);
    }
    ++walk.t;
  }

  // epilogue: accumulator i of this thread sits at row
  // 16 q + lane / 4 + 8 ((i / 2) % 2), column (i / 4) * 8 + 2 (lane % 4)
  // + i % 2 of the warpgroup's block of columns
  const int r_lo = 16 * quarter + lane / 4;
  const int c_lo = part * kCols + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < kAcc; i += 2) {
    const int row = r_lo + 8 * ((i / 2) % 2);
    const int col = c_lo + (i / 4) * 8;
    const float2 b = *reinterpret_cast<const float2*>(bias + col);
    __nv_bfloat162 t = __floats2bfloat162_rn(acc[i] + b.x, acc[i + 1] + b.y);
    auto* d = reinterpret_cast<__nv_bfloat162*>(dst + row * kLd + col);
    if constexpr (kEpi == kAdd) {
      const float2 x = __bfloat1622float2(*d);
      const float2 y = __bfloat1622float2(t);
      t = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
    } else if constexpr (kEpi == kRelu) {
      const float2 y = __bfloat1622float2(t);
      t = __floats2bfloat162_rn(fmaxf(y.x, 0.f), fmaxf(y.y, 0.f));
    }
    *d = t;
  }
  consumer_sync();
}

// out[row0 + r, c] = relu(X[r]) . w_out[:, c] + b_out[c], in f32, for c <
// d_out and the CTA's valid rows, for this warpgroup's 8-column groups
// [kFirst, kFirst + kCount) of lin_out's kG.  w_out arrives as H / 16 K
// slices of 16 x kN (kN = 8 kG = out_width(d_out)), kH / kN to a ring
// stage; each slice is kCount m64n8k16 products on one relu'd A fragment.
// A warpgroup with no group only releases the stages, after their copy
// landed, so that its arrival counts toward this use of the slot.
template <int kH, int kG, int kFirst, int kCount>
__device__ __forceinline__ void lin_out_part(const bf16* X, const Params& p,
                                             int row0, Walk& walk) {
  constexpr int kLd = kH + kPad;
  constexpr int kN = 8 * kG;
  constexpr int kSlices = kH / kBK;
  constexpr int kPerStage = kH / kN;
  constexpr int kAcc = 4 * (kCount > 0 ? kCount : 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quarter = warp % 4;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const int arow = 16 * quarter + lane % 16;
  const int achunk = lane / 16;
  for (int j0 = 0; j0 < kSlices; j0 += kPerStage) {
    const Stage<kH> st(walk.base, walk.t);
    mbar_wait(st.full, st.parity);
    if constexpr (kCount > 0) {
      const int j1 = min(kSlices, j0 + kPerStage);
#pragma unroll 1
      for (int j = j0; j < j1; ++j) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(X + arow * kLd + j * kBK + 8 * achunk));
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = relu_bf16x2(a[i]);
        // the slice's first group, then groups 256 B apart
        const uint64_t desc =
            make_desc(st.addr + (j - j0) * kBK * kN * 2 + kFirst * 256);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int g = 0; g < kCount; ++g)
          wgmma_n8(acc + 4 * g, a, desc + (uint64_t)g * (256 >> 4));
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
      }
    }
    if (quarter == 0 && lane == 0) {
#pragma unroll
      for (int c = 0; c < kCluster; ++c) mbar_arrive_cluster(st.empty, c);
    }
    ++walk.t;
  }
  // accumulator i: row 16 q + lane / 4 + 8 ((i / 2) % 2), column 8 (kFirst
  // + i / 4) + 2 (lane % 4) + i % 2
  float* out = static_cast<float*>(p.out);
  const int r_lo = row0 + 16 * quarter + lane / 4;
#pragma unroll
  for (int i = 0; i < 4 * kCount; ++i) {
    const int row = r_lo + 8 * ((i / 2) % 2);
    const int col = 8 * (kFirst + i / 4) + 2 * (lane % 4) + i % 2;
    if (col < p.d_out && row < p.n_rows)
      out[(size_t)row * p.d_out + col] = acc[i] + p.b_out[col];
  }
}

// lin_out at Nout = 8 kG: the first consumer warpgroup takes the first
// ceil(kG / 2) column groups, the second the rest, so that no thread holds
// more than 64 accumulators (ptxas spilled 128 at Nout = 256)
template <int kH, int kG>
__device__ __forceinline__ void lin_out(const bf16* X, const Params& p,
                                        int row0, Walk& walk) {
  constexpr int kG0 = (kG + 1) / 2;
  if (threadIdx.x / 128 == 0)
    lin_out_part<kH, kG, 0, kG0>(X, p, row0, walk);
  else
    lin_out_part<kH, kG, kG0, kG - kG0>(X, p, row0, walk);
}

// lin_out at the width out_width(d_out) (the host checked it is <= kH)
template <int kH>
__device__ __forceinline__ void lin_out_any(const bf16* X, const Params& p,
                                            int row0, Walk& walk) {
  switch (out_width(p.d_out) / 8) {
    case 1: lin_out<kH, 1>(X, p, row0, walk); break;
    case 2: lin_out<kH, 2>(X, p, row0, walk); break;
    case 3: lin_out<kH, 3>(X, p, row0, walk); break;
    case 4: lin_out<kH, 4>(X, p, row0, walk); break;
    case 8: lin_out<kH, 8>(X, p, row0, walk); break;
    case 16:
      if constexpr (kH >= 128) lin_out<kH, 16>(X, p, row0, walk);
      break;
    case 32:
      if constexpr (kH >= 256) lin_out<kH, 32>(X, p, row0, walk);
      break;
  }
}

// Z[r, col] (row stride ld) for the CTA's rows: mode 1 the positional
// encoding [x, sin(f_0 x), cos(f_0 x), ..., vd] with cos(t) = sin(t +
// pi/2), products and sums rounded separately as in field_mlp_f32.cu; mode 3
// the given z-features.  Zero past d_in (up to dz) and on rows past n_rows.
__device__ __forceinline__ void front_end(const Params& p, int row0, int dz,
                                          int ld, bf16* Z) {
  const int n_band = 6 * p.num_freqs;
  for (int i = threadIdx.x; i < kRows * dz; i += kConsumers) {
    const int r = i / dz;
    const int col = i - r * dz;
    const size_t row = (size_t)row0 + r;
    bf16 v = __float2bfloat16_rn(0.f);
    if (row < (size_t)p.n_rows && col < p.d_in) {
      if (p.mode == 3) {
        v = p.zfeat[row * p.d_in + col];
      } else {
        const float* b = p.base + row * 6;
        float f;
        if (col < 3) {
          f = b[col];
        } else if (col < 3 + n_band) {
          const int q = (col - 3) / 3;
          const int j = (col - 3) - 3 * q;
          float t = __fmul_rn(b[j], ldexpf(p.freq_factor, q >> 1));
          if (q & 1) t = __fadd_rn(t, kHalfPi);
          f = sinf(t);
        } else {
          f = b[col - n_band];
        }
        v = __float2bfloat16_rn(f);
      }
    }
    Z[r * ld + col] = v;
  }
}

template <int kH>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + Layout<kH>::kBytes;  // + alignment slack
}

template <int kH, int kKind>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    field_mlp_tc(const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap lat_map,
                 const Params p) {
  using L = Layout<kH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + ((1024 - (raw & 1023)) & 1023);
  bf16* X = reinterpret_cast<bf16*>(sm + L::kX);
  bf16* A2 = reinterpret_cast<bf16*>(sm + L::kA2);
  Walk walk;
  walk.base = smem_u32(sm);

  const int row0 = blockIdx.x * kRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      const Stage<kH> st(walk.base, s);
      mbar_init(st.full, 1);
      // one arrive per consumer warpgroup of every CTA in the cluster
      mbar_init(st.empty, kConsumerWGs * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  if (threadIdx.x / 32 == kConsumers / 32) {
    // the producer warp: one thread walks every stage
    if (threadIdx.x % 32 == 0)
      fill<kH, kKind>(&w_map, &lat_map, p, walk.base);
  } else {
    if constexpr (kKind == kPostHalf) {
      // X <- h: 16-byte loads of the CTA's valid rows, zeros past n_rows
      for (int i = threadIdx.x; i < kRows * kH / 8; i += kConsumers) {
        const int r = i / (kH / 8);
        const int c = (i - r * (kH / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row0 + r < p.n_rows)
          v = *reinterpret_cast<const uint4*>(p.h + (size_t)(row0 + r) * kH +
                                              c);
        *reinterpret_cast<uint4*>(X + r * L::kLd + c) = v;
      }
      consumer_sync();
    } else {
      const int dz = round_up(p.d_in, kBK);
      front_end(p, row0, dz, L::kLd, A2);
      consumer_sync();
      layer<kH, kBuf, kSet>(A2, dz, p.b_in, X, walk);
    }
    if constexpr (kKind == kPreHalf) {
      for (int blk = 0; blk < p.n_pre; ++blk) {
        layer<kH, kLatent, kAdd>(nullptr, p.d_latent, p.bz + blk * kH, X,
                                 walk);
        layer<kH, kReluBuf, kRelu>(X, kH, p.b0 + blk * kH, A2, walk);
        layer<kH, kBuf, kAdd>(A2, kH, p.b1 + blk * kH, X, walk);
      }
      // h: 16-byte stores of the CTA's valid rows
      bf16* h = static_cast<bf16*>(p.out);
      for (int i = threadIdx.x; i < kRows * kH / 8; i += kConsumers) {
        const int r = i / (kH / 8);
        const int c = (i - r * (kH / 8)) * 8;
        if (row0 + r < p.n_rows)
          *reinterpret_cast<uint4*>(h + (size_t)(row0 + r) * kH + c) =
              *reinterpret_cast<const uint4*>(X + r * L::kLd + c);
      }
    } else if constexpr (kKind == kWhole) {
      // the pre blocks (lin_z, fc_0, fc_1), then the post blocks (fc_0,
      // fc_1), through one inlined copy of fc_0 and fc_1
      for (int blk = 0; blk < p.n_pre + p.n_post; ++blk) {
        const bool pre = blk < p.n_pre;
        const int i = pre ? blk : blk - p.n_pre;
        if (pre)
          layer<kH, kLatent, kAdd>(nullptr, p.d_latent, p.bz + i * kH, X,
                                   walk);
        layer<kH, kReluBuf, kRelu>(X, kH, (pre ? p.b0 : p.b0p) + i * kH, A2,
                                   walk);
        layer<kH, kBuf, kAdd>(A2, kH, (pre ? p.b1 : p.b1p) + i * kH, X, walk);
      }
      lin_out_any<kH>(X, p, row0, walk);
    } else {
      for (int blk = 0; blk < p.n_post; ++blk) {
        layer<kH, kReluBuf, kRelu>(X, kH, p.b0p + blk * kH, A2, walk);
        layer<kH, kBuf, kAdd>(A2, kH, p.b1p + blk * kH, X, walk);
      }
      lin_out_any<kH>(X, p, row0, walk);
    }
  }
  // no CTA leaves while a peer may still copy into it or arrive on it
  cluster_sync();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A 2-D bf16 tensor map: `rows` rows of `cols` elements, boxes of
// box_rows x box_cols, no swizzle; rows past the end read as zeros.
int encode_2d(CUtensorMap* map, const void* ptr, uint64_t cols, uint64_t rows,
              uint32_t box_cols, uint32_t box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

template <int kH>
int launch(const Params& p, const void* latent, const void* wpack,
           cudaStream_t stream) {
  // the packed weights of the walk as rows of 256 elements (512 B): one
  // stage is H / 16 rows, each CTA of a cluster copies (and multicasts)
  // H / 16 / kCluster
  CUtensorMap w_map, lat_map{};
  int err = encode_2d(&w_map, wpack, 256,
                      (uint64_t)walk_stages<kH>(p) * (kH / 16), 256,
                      kH / 16 / kCluster);
  // the latent as a (n_rows, d_latent) tensor, boxes of 64 rows x 16
  // columns (mode 2 has none)
  if (err == 0 && p.mode != 2)
    err = encode_2d(&lat_map, latent, p.d_latent, p.n_rows, kBK, kRows);
  if (err != 0) return err;
  constexpr int smem = smem_bytes<kH>();
  auto* kernel = p.mode == 0   ? field_mlp_tc<kH, kWhole>
                 : p.mode == 2 ? field_mlp_tc<kH, kPostHalf>
                               : field_mlp_tc<kH, kPreHalf>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const int tiles = (p.n_rows + kRows - 1) / kRows;
  const int grid = round_up(tiles, kCluster);  // whole clusters
  kernel<<<grid, kThreads, smem, stream>>>(w_map, lat_map, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tiling constants: the Python wrapper sizes its feasibility check and its
// weight packing from these and checks them when the library loads.
int field_mlp_tc_rows_per_cta() { return kRows; }
int field_mlp_tc_k_step() { return kBK; }
int field_mlp_tc_stages() { return kStages; }
int field_mlp_tc_cluster() { return kCluster; }
int field_mlp_tc_row_pad() { return kPad; }
// lin_out's width for d_out (0: none); the packing pads w_out to it
int field_mlp_tc_out_width(int d_out) { return out_width(d_out); }

const char* field_mlp_tc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one mode (0 full_pe, 1 pre_combine_pe, 2 post_combine, 3
// pre_combine) in bf16 on `stream`; returns the CUDA error code (0 = ok).
// wpack holds the weights packed by ops/field_mlp.py::pack_tc, from the
// stage the mode's walk starts at (mode 2: the first post block's);
// pointers a mode does not use may be null.
int field_mlp_tc_launch(int mode, const void* base, const void* zfeat,
                        const void* latent, const void* h, const void* wpack,
                        const void* b_in, const void* bz, const void* b0,
                        const void* b1, const void* b0p, const void* b1p,
                        const void* b_out, void* out, int n_rows, int d_in,
                        int d_latent, int hidden, int n_pre, int n_post,
                        int d_out, int num_freqs, float freq_factor,
                        void* stream) {
  const bool pre = mode != 2, post = mode == 0 || mode == 2;
  if (mode < 0 || mode > 3 ||
      (pre && (d_latent % kBK != 0 || d_latent <= 0 ||
               round_up(d_in, kBK) > hidden)) ||
      (post && (out_width(d_out) == 0 || out_width(d_out) > hidden)))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  Params p;
  p.base = static_cast<const float*>(base);
  p.zfeat = static_cast<const bf16*>(zfeat);
  p.h = static_cast<const bf16*>(h);
  p.b_in = static_cast<const float*>(b_in);
  p.bz = static_cast<const float*>(bz);
  p.b0 = static_cast<const float*>(b0);
  p.b1 = static_cast<const float*>(b1);
  p.b0p = static_cast<const float*>(b0p);
  p.b1p = static_cast<const float*>(b1p);
  p.b_out = static_cast<const float*>(b_out);
  p.out = out;
  p.n_rows = n_rows;
  p.d_in = pre ? d_in : 0;
  p.d_latent = pre ? d_latent : 0;
  p.n_pre = pre ? n_pre : 0;
  p.n_post = post ? n_post : 0;
  p.d_out = d_out;
  p.num_freqs = num_freqs;
  p.mode = mode;
  p.freq_factor = freq_factor;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 64: return launch<64>(p, latent, wpack, s);
    case 128: return launch<128>(p, latent, wpack, s);
    case 192: return launch<192>(p, latent, wpack, s);
    case 256: return launch<256>(p, latent, wpack, s);
    case 320: return launch<320>(p, latent, wpack, s);
    case 384: return launch<384>(p, latent, wpack, s);
    case 448: return launch<448>(p, latent, wpack, s);
    case 512: return launch<512>(p, latent, wpack, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

// Fused pixelNeRF field MLP (ResnetFC), f32, on Hopper CUDA cores (sm_90a).
//
// Replaces, for f32, the four Pallas TPU kernels of the JAX package's
// pixelnerf_yolo_tpu/ops/pallas/fused_mlp.py:
//   mode 0  full_pe         <- fused_full_pe         (_full_pe_kernel)
//   mode 1  pre_combine_pe  <- fused_pre_combine_pe  (_pre_combine_pe_kernel)
//   mode 2  post_combine    <- fused_post_combine    (_post_combine_kernel)
//   mode 3  pre_combine     <- fused_pre_combine     (_pre_combine_kernel)
// (bf16 runs on the tensor cores in field_mlp_tc.cu).  Modes 0, 1 and 3
// run lin_in, then n_pre x (lin_z, fc_0, fc_1): modes 0 and 1 on the
// positional encoding of [xyz, viewdirs], computed in the kernel, mode 3
// on given z-features; modes 1 and 3 write h (n, H) f32.  Mode 0 goes on,
// and mode 2 starts from a given h: n_post x (fc_0, fc_1), then lin_out
// on relu(x), written as (n, d_out) f32.  The rounding points are the
// plain twins' (ops/field_mlp.py): every Dense is an f32 accumulation plus
// an f32 bias, the residual add is f32, relu where the reference applies
// it; the PE is sin(f * x + phase) with products and sums rounded
// separately (no FMA contraction).  Only the order of summation differs.
// No TF32: it keeps about three digits, and the f32 path is the parity
// mode that holds the port to the JAX package.
//
// What bounds it: the f32 FMA rate (67 TFLOP/s) in every mode.  At H =
// dL = 512 a row costs 2.38 M multiply-adds before the combine (4.35 M at
// dL = 1792) and 1.05 M after it (two post blocks and lin_out), against
// ~4 KB of input and output.  At one render launch's rows: mode 0 107.4
// ms (1,048,576 rows), mode 1 74.5 ms (the same), mode 2 16.4 ms (524,288
// rows; 6.0 ms for 190,720 rows at d_out 21).  The weights (13.7 MB f32
// at dL 512) stay in the 50 MB L2 but cannot sit in an SM's 227 KB, so
// they stream:
//   - The walk: one sequence of ring stages per launch (walk_stages,
//     mirrored by ops/field_mlp.py::f32_schedule): lin_in's slices, per
//     pre block lin_z's, fc_0's and fc_1's; per post block fc_0's and
//     fc_1's (of w0p[b], w1p[b]); lin_out's.  Mode 2's walk starts at the
//     post blocks; modes 1 and 3 end before them.
//   - The weight slices need no packing: rows [k, k + kBK) of a row-major
//     (K, H) matrix (w_in, wz[b], w0[b], w1[b], w0p[b], w1p[b]) are one
//     contiguous block, copied by one 1-D bulk copy (cp.async.bulk) into
//     a ring stage with an mbarrier transaction count.  lin_in's last
//     slice holds the d_in % kBK rows that are left; the consumers walk
//     only those.  w_out (H, d_out) is row-major too, so a run of its rows
//     is one block: as many rows a stage as a slot's kBK x H floats hold,
//     a multiple of 8 (each CTA's piece a multiple of 16 bytes), balanced
//     over the fewest stages (out_rows): one stage of 512 rows at d_out 4
//     (8 KB), two of 256 at d_out 21.
//   - The copies run kLookahead stages ahead of the walk: as a warp starts
//     stage t, if stage t + kLookahead falls to it (the warps take the
//     stages in turn, stage s to warp s % 8), its lane 0 waits until every
//     warp of the cluster has released that slot's previous use (stage t +
//     kLookahead - kStages, behind every warp's walk by a stage) on the
//     slot's empty barrier, and issues the copies.  A warp thus issues one
//     stage in 8, and no warp waits on a global load in steady state; the
//     k-loops have no __syncthreads.  There is no producer warp: a ninth
//     warp would cut every thread to 168 registers (ptxas gives each of
//     the SM's four sub-partitions a quarter of the register file, and
//     one of them would hold three warps), where the tiles below spill;
//     with 8 warps a thread may hold 255.
//   - L2 traffic: a CTA holds 32 rows (see the shared-memory budget
//     below), so CTAs run in clusters of kCluster = 2 and each stage is
//     multicast to both (each CTA copies half of it): one fetch from L2
//     feeds 64 rows.
//   - The latent is streamed, not held: lin_z's A operand (32 rows x kBK
//     columns) arrives in the same stage as its weight slice, by a 2-D TMA
//     tensor copy that fills rows past n_rows with zeros.  Shared memory
//     does not grow with d_latent, so the YOLO width (1792) fits.
//   - Registers, not shared memory, hold the residual stream: each of the
//     8 warps owns H / 8 columns of the CTA's 32 rows, each
//     thread an 8-row x H/64-column tile of x and of the layer's
//     accumulators (64 + 64 registers at H = 512), always the same rows
//     and columns, so lin_in, lin_z and fc_1 add into x where it lies.
//     Mode 2 fills the tile straight from h with 16-byte loads (the
//     reverse of the h store), issued once the first kLookahead stages
//     are in flight, so the loads overlap the copies.
//     One k-major activation buffer A (H x 32) holds the A operand of the
//     other layers: the z-features, relu(x) before fc_0 and lin_out,
//     relu(fc_0's output) before fc_1.  At H = 512 that is 64 KB, and the
//     ring gets kStages = 4 stages of 16 x 512 weights + 32 x 16 latent
//     (34 KB).
//   - The FMAs are fed by 128-bit shared loads: lanes are 4 across rows
//     (lane % 4) x 8 across columns (lane / 4); a thread's rows 4m + rg
//     (m < 8) sit side by side in A (row r at position (r % 4) * 8 + r / 4
//     of each k-row), so its 8 A values of one k are two LDS.128 that the
//     warp serves in one wavefront each; its weight columns are groups of
//     4 (H / 64 = 8 at H = 512: two LDS.128, one wavefront each).  Four
//     wavefronts feed 64 FMAs of a warp (2,048 multiply-adds).  The
//     latent slot is row-major (as TMA writes it): a thread reads 4 k of
//     one row with one LDS.128 (two wavefronts: rows 4m..4m+3 fall on two
//     bank groups; measured, the slice as two 8-column boxes, one
//     wavefront, ran 0-2% slower).  A stage's k steps are unrolled; the operands of its
//     first k step are loaded (once its copies have landed) before the
//     previous stage's last FMAs, which cover their latency, and a layer's
//     bias is loaded before its first stage.  255 registers a thread, no
//     spill at H = 512.
//   - lin_out (d_out <= 256) reads A = relu(x) the same way: a thread
//     takes rows 4m + rg and, by lane group og = lane / 4, one column of
//     each of its warp's groups of 8 columns, and sums over all of K in
//     order (a sum split over K moved the f32 renders off plain): per k
//     one or two LDS.128 and one LDS of w_out's row (8 consecutive floats
//     across the warp, one wavefront) feed 4 or 8 FMAs a column.  With at
//     most 4 groups (d_out <= 32: NeRF's 4 and YOLO's 21) two warps share
//     a group, 4 rows a thread each; with more, warp w takes groups w + 8
//     j, j < 4.  The loop has no branch, so the loads of 8 k steps issue
//     together.
//   - One kernel instantiation per mode group (1 and 3; 0; 2) at each H:
//     code of one group does not sit in another's kernel (in
//     field_mlp_tc.cu such code slowed a kernel by ~4% where it never
//     ran).
//   - Design runs on the H100 (scripts/bench_f32_design.py, PERF.md):
//     clusters of 1 run within 1-4% of 2; copies 1 or 2 stages ahead run
//     alike, 3 ahead (the slot of the stage just read) ~10% slower; 2
//     stages 32 deep ~15% slower than 4 stages 16 deep.
// Rows past n_rows load zeros and store nothing; the tensors are not
// padded.  A CTA of the cluster past the last row still joins every
// multicast and release.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;  // rows per CTA
// depth of a ring stage (weight rows, latent columns), ring stages and
// how many stages ahead of the walk the copies are issued;
// scripts/bench_f32_design.py builds the kernel with other values
#ifndef FIELD_MLP_F32_BK
#define FIELD_MLP_F32_BK 16
#endif
#ifndef FIELD_MLP_F32_STAGES
#define FIELD_MLP_F32_STAGES 4
#endif
#ifndef FIELD_MLP_F32_LOOKAHEAD
#define FIELD_MLP_F32_LOOKAHEAD (FIELD_MLP_F32_STAGES - 2)
#endif
// CTAs per cluster sharing each stage
#ifndef FIELD_MLP_F32_CLUSTER
#define FIELD_MLP_F32_CLUSTER 2
#endif
constexpr int kBK = FIELD_MLP_F32_BK;
constexpr int kStages = FIELD_MLP_F32_STAGES;
constexpr int kCluster = FIELD_MLP_F32_CLUSTER;
constexpr int kLookahead = FIELD_MLP_F32_LOOKAHEAD;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowLanes = 4;               // lanes across rows
constexpr int kColLanes = 8;               // lanes across columns
constexpr int kTM = kRows / kRowLanes;     // rows a thread: 8
constexpr int kLatBytes = kRows * kBK * 4;
constexpr int kOutGroups = 4;              // lin_out column groups a warp
constexpr int kMaxOut = 8 * kWarps * kOutGroups;  // d_out <= 256
constexpr float kHalfPi = 1.57079637050628662109375f;  // float32(pi / 2)
static_assert(kBK % 4 == 0, "stage depth");
static_assert(0 < kLookahead && kLookahead < kStages, "lookahead");
// lin_out's stages hold a multiple of 8 rows: 32 bytes a row of d_out
static_assert(kCluster == 1 || kCluster == 2, "16-byte pieces of w_out");

struct Params {
  const float* base;   // (n, 6) [xyz, viewdirs], modes 0, 1
  const float* zfeat;  // (n, d_in), mode 3
  const float* w_in;   // (d_in, H)
  const float* b_in;   // (H,)
  const float* wz;     // (n_pre, d_latent, H)
  const float* bz;     // (n_pre, H)
  const float* w0;     // (n_pre, H, H)
  const float* b0;
  const float* w1;
  const float* b1;
  float* out;          // (n, H) modes 1, 3; (n, d_out) modes 0, 2
  int n_rows, d_in, d_latent, n_pre, num_freqs, mode;
  float freq_factor;
  const float* h;      // (n, H), mode 2
  const float* w0p;    // (n_post, H, H)
  const float* b0p;    // (n_post, H)
  const float* w1p;
  const float* b1p;
  const float* w_out;  // (H, d_out)
  const float* b_out;  // (d_out,)
  int n_post, d_out;   // modes 0, 2
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// lin_out's ring stages: the fewest that hold w_out's `hidden` rows of
// d_out floats at no more than a slot's kBK x hidden floats and a multiple
// of 8 rows each (0 without lin_out, d_out 0); and the rows of each but
// the last, balanced
__host__ __device__ inline int out_stages(int hidden, int d_out) {
  if (d_out <= 0) return 0;
  const int fit = kBK * hidden / d_out / 8 * 8;
  return (hidden + fit - 1) / fit;
}

__host__ __device__ inline int out_rows(int hidden, int d_out) {
  const int n = out_stages(hidden, d_out);
  return round_up((hidden + n - 1) / n, 8);
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

// `bytes` (a multiple of 16) from global memory into shared memory; with
// kCluster > 1 they land at the same offset in every CTA of the cluster
// and signal each CTA's barrier
__device__ __forceinline__ void bulk_load_all(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  if constexpr (kCluster > 1) {
    const uint16_t mask = (1u << kCluster) - 1;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
           "r"(bar), "h"(mask)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
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

// -- the thread tile ---------------------------------------------------------

// A thread's columns: kTN = H / 64, in kTN / kV groups of kV adjacent
// columns (kV = 4 where kTN allows, for 128-bit loads); group g of lane
// group cg of warp w starts at w H / 8 + g 8 kV + kV cg.
template <int kH>
struct Cols {
  static constexpr int kTN = kH / (kWarps * kColLanes);
  static constexpr int kV = kTN % 4 == 0 ? 4 : kTN % 2 == 0 ? 2 : 1;
  static constexpr int kG = kTN / kV;
  __device__ static int at(int warp, int cg, int i) {
    return warp * (kH / kWarps) + (i / kV) * (kColLanes * kV) + kV * cg +
           i % kV;
  }
};

// v[i] <- p[Cols::at(warp, cg, i)] for the thread's kTN columns
template <int kH>
__device__ __forceinline__ void load_cols(const float* p, int warp, int cg,
                                          float (&v)[Cols<kH>::kTN]) {
  using C = Cols<kH>;
#pragma unroll
  for (int g = 0; g < C::kG; ++g) {
    const float* q = p + C::at(warp, cg, g * C::kV);
    if constexpr (C::kV == 4) {
      const float4 t = *reinterpret_cast<const float4*>(q);
      v[4 * g] = t.x; v[4 * g + 1] = t.y; v[4 * g + 2] = t.z;
      v[4 * g + 3] = t.w;
    } else if constexpr (C::kV == 2) {
      const float2 t = *reinterpret_cast<const float2*>(q);
      v[2 * g] = t.x; v[2 * g + 1] = t.y;
    } else {
      v[g] = *q;
    }
  }
}

template <int kH>
using Tile = float[kTM][Cols<kH>::kTN];

// -- the ring ----------------------------------------------------------------

template <int kH>
__host__ __device__ constexpr int stage_bytes() {
  return kBK * kH * 4 + kLatBytes;
}

// Shared memory, from a 128-byte-aligned base: the ring (kStages x (kBK x H
// weight slice + 32 x kBK latent slice)), the activation buffer A (H k-rows
// of 32), then the full / empty barriers.
template <int kH>
struct Layout {
  static constexpr int kA = kStages * stage_bytes<kH>();
  static constexpr int kFull = kA + kH * kRows * 4;
  static constexpr int kEmpty = kFull + 8 * kStages;
  static constexpr int kBytes = kEmpty + 8 * kStages;
};

template <int kH>
__host__ __device__ constexpr int smem_bytes() {
  return 128 + Layout<kH>::kBytes;  // + alignment slack
}

// Stage t of the walk over the ring: its slot, the parity of its use of
// the slot, the shared addresses of the slot and its barriers.
template <int kH>
struct Stage {
  uint32_t addr, full, empty, parity;
  int slot;
  __device__ Stage(uint32_t base, int t) {
    slot = t % kStages;
    parity = (t / kStages) & 1;
    addr = base + slot * stage_bytes<kH>();
    full = base + Layout<kH>::kFull + 8 * slot;
    empty = base + Layout<kH>::kEmpty + 8 * slot;
  }
};

// Stages of the walk: lin_in's slices (the last may be short), per pre
// block lin_z's (each with its latent slice), fc_0's and fc_1's, per post
// block fc_0's and fc_1's, then lin_out's.
int walk_stages(int d_in, int d_latent, int hidden, int n_pre, int n_post,
                int d_out) {
  return (d_in + kBK - 1) / kBK + n_pre * (d_latent + 2 * hidden) / kBK +
         n_post * 2 * hidden / kBK + out_stages(hidden, d_out);
}

// Mode groups, one kernel instantiation each
enum Group { kWhole = 0, kPre = 1, kPost = 2 };

// Issues stage s of the walk (below) once every warp of the cluster has
// released its slot's previous use: this CTA's 1 / kCluster of the weight
// slice to every CTA of the cluster, and this CTA's rows of the latent
// slice.  One thread.  Out of line (a warp runs it once in 8 stages), so
// its arguments are the grid constants' addresses and the walk's numbers,
// by value.
template <int kH, int kGroup>
__device__ __noinline__ void issue(const CUtensorMap* lat_map,
                                   const Params* p, uint32_t base, int n_in,
                                   int n_lat, int per_blk, int pre, int s) {
  constexpr int kNH = kH / kBK;  // stages of fc_0 (and of fc_1)
  const float* src;
  int rows = kBK, width = kH, lat_col = -1;
  if (kGroup != kPre && (kGroup == kPost || s >= pre)) {
    // after the combine: per post block fc_0's, fc_1's; lin_out's
    const int q = s - pre;
    const int n_post_st = p->n_post * 2 * kNH;
    if (q < n_post_st) {
      const int blk = q / (2 * kNH);
      const int u = q - blk * 2 * kNH;
      src = (u < kNH ? p->w0p : p->w1p) +
            ((size_t)blk * kH + (u % kNH) * kBK) * kH;
    } else {
      const int step = out_rows(kH, p->d_out);
      const int first = (q - n_post_st) * step;
      src = p->w_out + (size_t)first * p->d_out;
      rows = min(step, kH - first);
      width = p->d_out;
    }
  } else if (s < n_in) {
    src = p->w_in + (size_t)s * kBK * kH;
    rows = min(kBK, p->d_in - s * kBK);
  } else {
    const int q = s - n_in;
    const int blk = q / per_blk;
    const int u = q - blk * per_blk;
    if (u < n_lat) {
      src = p->wz + ((size_t)blk * p->d_latent + u * kBK) * kH;
      lat_col = u * kBK;
    } else if (u < n_lat + kNH) {
      src = p->w0 + ((size_t)blk * kH + (u - n_lat) * kBK) * kH;
    } else {
      src = p->w1 + ((size_t)blk * kH + (u - n_lat - kNH) * kBK) * kH;
    }
  }
  const Stage<kH> st(base, s);
  const uint32_t bytes = rows * width * 4;
  const uint32_t piece = bytes / kCluster;  // a multiple of 16
  const uint32_t rank = cluster_rank();
  mbar_wait(st.empty, st.parity ^ 1);
  mbar_expect_tx(st.full, bytes + (lat_col >= 0 ? kLatBytes : 0));
  bulk_load_all(st.addr + rank * piece,
                reinterpret_cast<const char*>(src) + rank * piece, piece,
                st.full);
  if (lat_col >= 0)
    tma_load_2d(st.addr + kBK * kH * 4, lat_map, lat_col,
                blockIdx.x * kRows, st.full);
}

// The walk's schedule of group kGroup: stage s is lin_in's slice s (s <
// n_in; the last may be short), else, below pre, place u of pre block b,
// (s - n_in) = b per_blk + u: lin_z's slices (u < n_lat, each with its
// latent slice), fc_0's, fc_1's; from pre on, the post blocks' and
// lin_out's (groups 0 and 2; group 2 has no pre stages).  Also the
// consumers' position: the ring (its shared address and a generic
// pointer) and the next stage t.
template <int kH, int kGroup>
struct Walk {
  uint32_t base;
  const float* ring;
  int t = 0;
  int n_in = 0, n_lat = 0, per_blk = 0, pre = 0, total;
  __device__ Walk(const Params& p, unsigned char* sm)
      : base(smem_u32(sm)), ring(reinterpret_cast<const float*>(sm)) {
    if constexpr (kGroup != kPost) {
      n_in = (p.d_in + kBK - 1) / kBK;
      n_lat = p.d_latent / kBK;
      per_blk = n_lat + 2 * (kH / kBK);
      pre = n_in + p.n_pre * per_blk;
    }
    total = pre;
    if constexpr (kGroup != kPre)
      total += p.n_post * 2 * (kH / kBK) + out_stages(kH, p.d_out);
  }
  // issues stage s (s < total)
  __device__ void issue_stage(const CUtensorMap* lat_map, const Params* p,
                              int s) const {
    issue<kH, kGroup>(lat_map, p, base, n_in, n_lat, per_blk, pre, s);
  }
  // stage t's copies: issue stage t + kLookahead if it falls to this warp,
  // then wait for stage t; returns the slot
  __device__ __forceinline__ const float* begin(const CUtensorMap* lat_map,
                                                const Params* p, int t,
                                                int warp, int lane) const {
    const int ahead = t + kLookahead;
    if (lane == 0 && ahead % kWarps == warp && ahead < total)
      issue_stage(lat_map, p, ahead);
    const Stage<kH> st(base, t);
    mbar_wait(st.full, st.parity);
    return ring + st.slot * (stage_bytes<kH>() / 4);
  }
  // every lane of the warp has read stage t's slot: one release per warp
  // on every CTA of the cluster
  __device__ __forceinline__ void release(int t, int lane) const {
    __syncwarp();
    if (lane == 0) {
      const Stage<kH> st(base, t);
#pragma unroll
      for (int c = 0; c < kCluster; ++c) mbar_arrive_cluster(st.empty, c);
    }
  }
};

// acc[m][i] += a[m] * w[i]
template <int kH>
__device__ __forceinline__ void fma_tile(Tile<kH>& acc, const float (&a)[kTM],
                                         const float (&w)[Cols<kH>::kTN]) {
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int i = 0; i < Cols<kH>::kTN; ++i)
      acc[m][i] = fmaf(a[m], w[i], acc[m][i]);
}

// The thread's 8 rows of A's k-row `arow` (two LDS.128)
__device__ __forceinline__ void load_rows(float (&a)[kTM], const float* arow) {
  const float4 lo = reinterpret_cast<const float4*>(arow)[0];
  const float4 hi = reinterpret_cast<const float4*>(arow)[1];
  a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
  a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
}

// The operands of one k step on the k-major buffer: the thread's 8 rows
// of A's k-row and its columns of the weight slice's row.
template <int kH>
struct Step {
  float a[kTM];
  float w[Cols<kH>::kTN];
  __device__ __forceinline__ void load(const float* arow, const float* wrow,
                                       int warp, int cg) {
    load_rows(a, arow);
    load_cols<kH>(wrow, warp, cg, w);
  }
};

// the thread's rows 4m + rg of a latent slot, 4 k from column 4 kq: one
// LDS.128 a row
__device__ __forceinline__ void load_lat(float4 (&l)[kTM], const float* lat,
                                         int rg, int kq) {
  const float4* L = reinterpret_cast<const float4*>(lat);
#pragma unroll
  for (int m = 0; m < kTM; ++m) l[m] = L[(kRowLanes * m + rg) * (kBK / 4) + kq];
}

__device__ __forceinline__ float part(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc <- A (32 x K) W (K x H) + bias for the thread's tile; W's slices
// arrive through the ring.  kLatent: A is the latent slice of each stage
// (32 rows of kBK, row-major); otherwise A is the k-major buffer `abuf`.
// The bias is loaded before the first stage.  The operands of a stage's
// first k step are loaded before the previous stage's last FMAs (which
// then cover their latency), once the stage's copies have landed.
template <int kH, bool kLatent, class Walk_>
__device__ __forceinline__ void product(Tile<kH>& acc, const float* abuf,
                                        int K, const float* __restrict__ bias,
                                        Walk_& walk,
                                        const CUtensorMap* lat_map,
                                        const Params* p) {
  using C = Cols<kH>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane % kRowLanes, cg = lane / kRowLanes;
  float b[C::kTN];
  load_cols<kH>(bias, warp, cg, b);
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int i = 0; i < C::kTN; ++i) acc[m][i] = 0.f;

  const int n_st = (K + kBK - 1) / kBK;
  const float* W = walk.begin(lat_map, p, walk.t, warp, lane);
  if constexpr (kLatent) {
    float4 l[kTM];
    float w[C::kTN];
    load_lat(l, W + kBK * kH, rg, 0);
    load_cols<kH>(W, warp, cg, w);
    for (int j = 0; j < n_st; ++j, ++walk.t) {
#pragma unroll
      for (int kq = 0; kq < kBK / 4; ++kq) {
        float4 l2[kTM];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // the next k step's operands, then this one's FMAs
          float w2[C::kTN];
          if (e < 3) {
            load_cols<kH>(W + (4 * kq + e + 1) * kH, warp, cg, w2);
          } else if (kq + 1 < kBK / 4) {
            load_lat(l2, W + kBK * kH, rg, kq + 1);
            load_cols<kH>(W + (4 * kq + 4) * kH, warp, cg, w2);
          } else if (j + 1 < n_st) {
            const float* W2 = walk.begin(lat_map, p, walk.t + 1, warp, lane);
            load_lat(l2, W2 + kBK * kH, rg, 0);
            load_cols<kH>(W2, warp, cg, w2);
            W = W2;
          }
          float a[kTM];
#pragma unroll
          for (int m = 0; m < kTM; ++m) a[m] = part(l[m], e);
          fma_tile<kH>(acc, a, w);
#pragma unroll
          for (int i = 0; i < C::kTN; ++i) w[i] = w2[i];
        }
#pragma unroll
        for (int m = 0; m < kTM; ++m) l[m] = l2[m];
      }
      walk.release(walk.t, lane);
    }
  } else {
    Step<kH> cur;
    cur.load(abuf + rg * kTM, W, warp, cg);
    for (int j = 0; j < n_st; ++j, ++walk.t) {
      const float* A = abuf + j * kBK * kRows + rg * kTM;
      const int nk = min(kBK, K - j * kBK);
      if (nk == kBK) {
#pragma unroll
        for (int kk = 0; kk + 1 < kBK; ++kk) {
          Step<kH> nxt;
          nxt.load(A + (kk + 1) * kRows, W + (kk + 1) * kH, warp, cg);
          fma_tile<kH>(acc, cur.a, cur.w);
          cur = nxt;
        }
        Step<kH> nxt;
        if (j + 1 < n_st) {
          const float* W2 = walk.begin(lat_map, p, walk.t + 1, warp, lane);
          nxt.load(A + kBK * kRows, W2, warp, cg);
          W = W2;
        }
        fma_tile<kH>(acc, cur.a, cur.w);
        walk.release(walk.t, lane);
        cur = nxt;
      } else {
        // lin_in's short last slice
        fma_tile<kH>(acc, cur.a, cur.w);
#pragma unroll 1
        for (int kk = 1; kk < nk; ++kk) {
          cur.load(A + kk * kRows, W + kk * kH, warp, cg);
          fma_tile<kH>(acc, cur.a, cur.w);
        }
        walk.release(walk.t, lane);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int i = 0; i < C::kTN; ++i) acc[m][i] += b[i];
}

// acc[j][m] += A[k0 + kk][pos(4 (m0 + m) + rg)] W[kk][col[j]] for kk in
// [0, nk) (a multiple of 8), in order, with A at the thread's first row
// m0 (kTR = 8 rows from m0 = 0, or 4 from m0 = 0 or 4: one or two LDS.128
// a k) and W the lin_out stage (w_out's rows from k0): kNJ LDS a k.  No
// branch in the loop, so the loads of 8 k steps are issued together.
template <int kNJ, int kTR>
__device__ __forceinline__ void lin_out_rows(float (&acc)[kOutGroups][kTM],
                                             const float* A, const float* wst,
                                             int k0, int nk, int d_out,
                                             const int (&col)[kOutGroups]) {
#pragma unroll 1
  for (int kk = 0; kk < nk; kk += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float* arow = A + (k0 + kk + u) * kRows;
      float a[kTM];
      if constexpr (kTR == kTM) {
        load_rows(a, arow);
      } else {
        const float4 v = *reinterpret_cast<const float4*>(arow);
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      }
      const float* wrow = wst + (kk + u) * d_out;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float w = wrow[col[j]];
#pragma unroll
        for (int m = 0; m < kTR; ++m) acc[j][m] = fmaf(a[m], w, acc[j][m]);
      }
    }
  }
}

// lin_out: out[r][o] = sum_k A[k][pos(r)] w_out[k][o] + b_out[o] for the
// CTA's valid rows, with A = relu(x) in the k-major buffer and w_out's
// rows from lin_out's ring stages (row-major, d_out floats a row).  Each
// output is one thread's sum over k in order (so it is the plain twin's
// f32 value where cuBLAS sums in order too: the f32 renders agree with
// plain to the bit; a sum split over K moved them by up to 1e-4).  The
// columns come in groups of 8, one column a lane group og = lane / 4; the
// thread's rows are its tile's (4m + rg).  With at most 4 groups (d_out <=
// 32) two warps take each group, 4 of the thread's rows each (m in [0, 4)
// or [4, 8)); with more, warp w takes groups w + 8 j, j < kOutGroups, all
// 8 rows.
template <int kH, class Walk_>
__device__ __forceinline__ void lin_out(const float* abuf, Walk_& walk,
                                        const CUtensorMap* lat_map,
                                        const Params* p, int row0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane % kRowLanes, og = lane / kRowLanes;
  const int d_out = p->d_out;
  const int groups = (d_out + 7) / 8;
  const bool halves = groups <= kWarps / 2;
  // this warp's groups g0 + 8 j (j < nj) and its rows 4 (m0 + m) + rg
  const int g0 = halves ? warp / 2 : warp;
  const int m0 = halves ? warp % 2 * (kTM / 2) : 0;
  int nj = 0;
  while (nj < kOutGroups && g0 + kWarps * nj < groups &&
         (!halves || nj == 0))
    ++nj;
  float acc[kOutGroups][kTM];
#pragma unroll
  for (int j = 0; j < kOutGroups; ++j)
#pragma unroll
    for (int m = 0; m < kTM; ++m) acc[j][m] = 0.f;
  // a column past d_out reads the last one; it is never stored
  int col[kOutGroups];
#pragma unroll
  for (int j = 0; j < kOutGroups; ++j)
    col[j] = min(8 * (g0 + kWarps * j) + og, d_out - 1);
  const float* A = abuf + rg * kTM + m0;
  const int step = out_rows(kH, d_out);  // w_out rows a stage
  for (int k0 = 0; k0 < kH; k0 += step, ++walk.t) {
    const float* wst = walk.begin(lat_map, p, walk.t, warp, lane);
    const int nk = min(step, kH - k0);
    if (halves) {
      if (nj) lin_out_rows<1, kTM / 2>(acc, A, wst, k0, nk, d_out, col);
    } else {
      switch (nj) {
        case 1: lin_out_rows<1, kTM>(acc, A, wst, k0, nk, d_out, col); break;
        case 2: lin_out_rows<2, kTM>(acc, A, wst, k0, nk, d_out, col); break;
        case 3: lin_out_rows<3, kTM>(acc, A, wst, k0, nk, d_out, col); break;
        case 4: lin_out_rows<4, kTM>(acc, A, wst, k0, nk, d_out, col); break;
        default: break;
      }
    }
    walk.release(walk.t, lane);
  }
  const int rows = halves ? kTM / 2 : kTM;  // the thread's
#pragma unroll
  for (int j = 0; j < kOutGroups; ++j) {
    const int o = 8 * (g0 + kWarps * j) + og;
    if (j >= nj || o >= d_out) continue;
    const float b = p->b_out[o];
#pragma unroll
    for (int m = 0; m < kTM; ++m) {
      const int row = row0 + kRowLanes * (m0 + m) + rg;
      if (m < rows && row < p->n_rows)
        p->out[(size_t)row * d_out + o] = acc[j][m] + b;
    }
  }
}

enum Epilogue { kSet = 0, kAdd = 1 };

// x <- t (kSet) or x + t (kAdd), t a Dense's output
template <int kH, int kEpi>
__device__ __forceinline__ void to_x(Tile<kH>& x, const Tile<kH>& t) {
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int i = 0; i < Cols<kH>::kTN; ++i)
      x[m][i] = kEpi == kSet ? t[m][i] : x[m][i] + t[m][i];
}

// A[c][(r % 4) * 8 + r / 4] <- relu(v[r][c]) for the thread's tile: two
// STS.128 a column.  The caller brackets it with __syncthreads.
template <int kH>
__device__ __forceinline__ void store_relu(float* abuf, const Tile<kH>& v) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane % kRowLanes, cg = lane / kRowLanes;
#pragma unroll
  for (int i = 0; i < Cols<kH>::kTN; ++i) {
    float r[kTM];
#pragma unroll
    for (int m = 0; m < kTM; ++m) r[m] = fmaxf(v[m][i], 0.f);
    float4* d = reinterpret_cast<float4*>(
        abuf + Cols<kH>::at(warp, cg, i) * kRows + rg * kTM);
    d[0] = make_float4(r[0], r[1], r[2], r[3]);
    d[1] = make_float4(r[4], r[5], r[6], r[7]);
  }
}

// x <- h's rows for the thread's tile, by the thread's kV-wide column
// groups (the reverse of the h store); zeros on rows past n_rows, which
// read the last row so that no branch holds back the loads
template <int kH>
__device__ __forceinline__ void load_x(Tile<kH>& x, const Params& p,
                                       int row0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane % kRowLanes, cg = lane / kRowLanes;
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int row = min(row0 + kRowLanes * m + rg, p.n_rows - 1);
    load_cols<kH>(p.h + (size_t)row * kH, warp, cg, x[m]);
  }
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int i = 0; i < Cols<kH>::kTN; ++i)
      if (row0 + kRowLanes * m + rg >= p.n_rows) x[m][i] = 0.f;
}

// A[col][pos(r)] for the CTA's rows, col < dz = round_up(d_in, kBK): modes
// 0 and 1 the positional encoding [x, sin(f_0 x), cos(f_0 x), ..., vd]
// with cos(t) = sin(t + pi/2), products and sums rounded separately (the
// reference's f32 value of t); mode 3 the given z-features.  Zero past
// d_in and on rows past n_rows.
__device__ __forceinline__ void front_end(const Params& p, int row0, int dz,
                                          float* abuf) {
  const int n_band = 6 * p.num_freqs;
  for (int i = threadIdx.x; i < kRows * dz; i += kThreads) {
    const int col = i / kRows;
    const int r = i - col * kRows;
    const size_t row = (size_t)row0 + r;
    float v = 0.f;
    if (row < (size_t)p.n_rows && col < p.d_in) {
      if (p.mode == 3) {
        v = p.zfeat[row * p.d_in + col];
      } else {
        const float* b = p.base + row * 6;
        if (col < 3) {
          v = b[col];
        } else if (col < 3 + n_band) {
          const int q = (col - 3) / 3;
          const int j = (col - 3) - 3 * q;
          float t = __fmul_rn(b[j], ldexpf(p.freq_factor, q >> 1));
          if (q & 1) t = __fadd_rn(t, kHalfPi);
          v = sinf(t);
        } else {
          v = b[col - n_band];
        }
      }
    }
    abuf[col * kRows + (r % kRowLanes) * kTM + r / kRowLanes] = v;
  }
}

template <int kH, int kGroup>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    field_mlp_f32(const __grid_constant__ CUtensorMap lat_map,
                  const __grid_constant__ Params p) {
  using L = Layout<kH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + ((128 - (raw & 127)) & 127);
  float* abuf = reinterpret_cast<float*>(sm + L::kA);

  const int row0 = blockIdx.x * kRows;
  Walk<kH, kGroup> walk(p, sm);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      const Stage<kH> st(walk.base, s);
      mbar_init(st.full, 1);
      // one arrive per warp of every CTA in the cluster
      mbar_init(st.empty, kWarps * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  // the first kLookahead stages, each from the warp it falls to; the walk
  // issues the rest
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int s = warp; s < min(kLookahead, walk.total); s += kWarps)
    if (lane == 0) walk.issue_stage(&lat_map, &p, s);
  Tile<kH> x, acc;
  if constexpr (kGroup == kPost) {
    load_x<kH>(x, p, row0);
  } else {
    front_end(p, row0, round_up(p.d_in, kBK), abuf);
    __syncthreads();
    product<kH, false>(x, abuf, p.d_in, p.b_in, walk, &lat_map, &p);
    for (int blk = 0; blk < p.n_pre; ++blk) {
      product<kH, true>(acc, nullptr, p.d_latent, p.bz + blk * kH, walk,
                        &lat_map, &p);
      to_x<kH, kAdd>(x, acc);
      // A <- relu(x), once every warp has read A's last contents
      __syncthreads();
      store_relu<kH>(abuf, x);
      __syncthreads();
      product<kH, false>(acc, abuf, kH, p.b0 + blk * kH, walk, &lat_map,
                         &p);
      // A <- relu(fc_0(relu(x)))
      __syncthreads();
      store_relu<kH>(abuf, acc);
      __syncthreads();
      product<kH, false>(acc, abuf, kH, p.b1 + blk * kH, walk, &lat_map,
                         &p);
      to_x<kH, kAdd>(x, acc);
    }
  }
  if constexpr (kGroup == kPre) {
    // h: the thread's kV-wide column groups of its valid rows
    using C = Cols<kH>;
    const int rg = lane % kRowLanes, cg = lane / kRowLanes;
#pragma unroll
    for (int m = 0; m < kTM; ++m) {
      const int row = row0 + kRowLanes * m + rg;
      if (row >= p.n_rows) continue;
      float* h = p.out + (size_t)row * kH;
#pragma unroll
      for (int g = 0; g < C::kG; ++g) {
        float* d = h + C::at(warp, cg, g * C::kV);
        const float* v = &x[m][g * C::kV];
        if constexpr (C::kV == 4) {
          *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
        } else if constexpr (C::kV == 2) {
          *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
        } else {
          *d = v[0];
        }
      }
    }
  } else {
    // the post blocks, then lin_out
    for (int blk = 0; blk < p.n_post; ++blk) {
      __syncthreads();
      store_relu<kH>(abuf, x);
      __syncthreads();
      product<kH, false>(acc, abuf, kH, p.b0p + blk * kH, walk, &lat_map,
                         &p);
      __syncthreads();
      store_relu<kH>(abuf, acc);
      __syncthreads();
      product<kH, false>(acc, abuf, kH, p.b1p + blk * kH, walk, &lat_map,
                         &p);
      to_x<kH, kAdd>(x, acc);
    }
    // A <- relu(x) for lin_out
    __syncthreads();
    store_relu<kH>(abuf, x);
    __syncthreads();
    lin_out<kH>(abuf, walk, &lat_map, &p, row0);
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

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
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

// The latent as a 2-D f32 tensor map: n_rows rows of d_latent, boxes of
// 32 rows x kBK columns, no swizzle; rows past the end read as zeros.
int encode_latent(CUtensorMap* map, const void* ptr, uint64_t cols,
                  uint64_t rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 4};
  const cuuint32_t box[2] = {kBK, kRows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

template <int kH, int kGroup>
int launch(const Params& p, const void* latent, cudaStream_t stream) {
  CUtensorMap lat_map{};  // group 2 reads no latent
  int err = 0;
  if constexpr (kGroup != kPost) {
    err = encode_latent(&lat_map, latent, p.d_latent, p.n_rows);
    if (err != 0) return err;
  }
  constexpr int smem = smem_bytes<kH>();
  err = (int)cudaFuncSetAttribute(field_mlp_f32<kH, kGroup>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err != 0) return err;
  const int tiles = (p.n_rows + kRows - 1) / kRows;
  const int grid = round_up(tiles, kCluster);  // whole clusters
  field_mlp_f32<kH, kGroup><<<grid, kThreads, smem, stream>>>(lat_map, p);
  return (int)cudaGetLastError();
}

template <int kH>
int launch_mode(const Params& p, const void* latent, cudaStream_t stream) {
  switch (p.mode) {
    case 0: return launch<kH, kWhole>(p, latent, stream);
    case 2: return launch<kH, kPost>(p, latent, stream);
    default: return launch<kH, kPre>(p, latent, stream);  // modes 1, 3
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Tiling constants: the Python wrapper sizes its feasibility check from
// these and checks them when the library loads.
int field_mlp_f32_rows_per_cta() { return kRows; }
int field_mlp_f32_k_step() { return kBK; }
int field_mlp_f32_stages() { return kStages; }
int field_mlp_f32_cluster() { return kCluster; }
// the widest lin_out (modes 0, 2; also no wider than hidden)
int field_mlp_f32_max_out() { return kMaxOut; }
// dynamic shared memory of the kernel at `hidden` (0: no instantiation)
int field_mlp_f32_smem_bytes(int hidden) {
  switch (hidden) {
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    case 192: return smem_bytes<192>();
    case 256: return smem_bytes<256>();
    case 320: return smem_bytes<320>();
    case 384: return smem_bytes<384>();
    case 448: return smem_bytes<448>();
    case 512: return smem_bytes<512>();
    default: return 0;
  }
}
// ring stages a launch walks (mode 2: d_in = d_latent = n_pre = 0; modes
// 1 and 3: n_post = d_out = 0)
int field_mlp_f32_walk_stages(int d_in, int d_latent, int hidden, int n_pre,
                              int n_post, int d_out) {
  return walk_stages(d_in, d_latent, hidden, n_pre, n_post, d_out);
}
// w_out rows a lin_out stage carries (the last stage: what is left)
int field_mlp_f32_out_rows(int hidden, int d_out) {
  return out_rows(hidden, d_out);
}

const char* field_mlp_f32_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches mode 0 (full_pe), 1 (pre_combine_pe), 2 (post_combine) or 3
// (pre_combine) in f32 on `stream`; returns the CUDA error code (0 = ok).
// The tensors a mode reads with bulk, TMA or 128-bit accesses must start
// on 16-byte boundaries: before the combine (modes 0, 1, 3) the latent,
// w_in, wz, w0, w1 and their biases; after it (modes 0, 2) w0p, w1p,
// w_out and the biases of w0p and w1p; h (mode 2); out (modes 1, 3).  A
// pointer a mode does not read may be null.
int field_mlp_f32_launch(int mode, const void* base, const void* zfeat,
                         const void* h, const void* latent, const void* w_in,
                         const void* b_in, const void* wz, const void* bz,
                         const void* w0, const void* b0, const void* w1,
                         const void* b1, const void* w0p, const void* b0p,
                         const void* w1p, const void* b1p, const void* w_out,
                         const void* b_out, void* out, int n_rows, int d_in,
                         int d_latent, int hidden, int n_pre, int n_post,
                         int d_out, int num_freqs, float freq_factor,
                         void* stream) {
  const bool pre = mode != 2, post = mode == 0 || mode == 2;
  if (mode < 0 || mode > 3 || n_pre < 0 || n_post < 0 ||
      (mode == 2 && !aligned16(h)) || (!post && !aligned16(out)))
    return (int)cudaErrorInvalidValue;
  if (pre && (d_in < 0 || d_latent <= 0 || d_latent % kBK != 0 ||
              round_up(d_in, kBK) > hidden || !aligned16(latent) ||
              !aligned16(w_in) || !aligned16(wz) || !aligned16(w0) ||
              !aligned16(w1) || !aligned16(b_in) || !aligned16(bz) ||
              !aligned16(b0) || !aligned16(b1)))
    return (int)cudaErrorInvalidValue;
  if (post && (d_out <= 0 || d_out > kMaxOut || d_out > hidden ||
               !aligned16(w0p) || !aligned16(w1p) || !aligned16(w_out) ||
               !aligned16(b0p) || !aligned16(b1p)))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  Params p;
  p.base = static_cast<const float*>(base);
  p.zfeat = static_cast<const float*>(zfeat);
  p.w_in = static_cast<const float*>(w_in);
  p.b_in = static_cast<const float*>(b_in);
  p.wz = static_cast<const float*>(wz);
  p.bz = static_cast<const float*>(bz);
  p.w0 = static_cast<const float*>(w0);
  p.b0 = static_cast<const float*>(b0);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.out = static_cast<float*>(out);
  p.n_rows = n_rows;
  p.d_in = pre ? d_in : 0;
  p.d_latent = pre ? d_latent : 0;
  p.n_pre = pre ? n_pre : 0;
  p.num_freqs = num_freqs;
  p.mode = mode;
  p.freq_factor = freq_factor;
  p.h = static_cast<const float*>(h);
  p.w0p = static_cast<const float*>(w0p);
  p.b0p = static_cast<const float*>(b0p);
  p.w1p = static_cast<const float*>(w1p);
  p.b1p = static_cast<const float*>(b1p);
  p.w_out = static_cast<const float*>(w_out);
  p.b_out = static_cast<const float*>(b_out);
  p.n_post = post ? n_post : 0;
  p.d_out = post ? d_out : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 64: return launch_mode<64>(p, latent, s);
    case 128: return launch_mode<128>(p, latent, s);
    case 192: return launch_mode<192>(p, latent, s);
    case 256: return launch_mode<256>(p, latent, s);
    case 320: return launch_mode<320>(p, latent, s);
    case 384: return launch_mode<384>(p, latent, s);
    case 448: return launch_mode<448>(p, latent, s);
    case 512: return launch_mode<512>(p, latent, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

// Bilinear latent lookup: the four-corner combine of grid_sample_nhwc in
// one kernel, CUDA C++ for sm_90a.
//
// It replaces no Pallas kernel: the JAX package gathers the latent with jnp
// (pixelnerf_yolo_tpu/ops/grid_sample.py), and so did the port, in plain
// torch (ops/grid_sample.py::_corners + _combine: about 20 elementwise
// passes over the (B, N) coordinates, then per corner a row gather of the
// whole (B, N, C) rows, a product by the in-range flag, a product by the
// weight, and three adds).  ops/grid_sample.py::grid_sample_nhwc launches
// this kernel in that chain's place for a bilinear lookup of a CUDA table
// of f32, bf16 or f16 that records no gradient (inference renders).
//
// What it computes, bitwise the chain's result (NaN where the chain gives
// NaN), because it takes every rounding of the chain in the chain's order:
//   - The coordinates in f32, one rounding an op (__fadd_rn / __fmul_rn,
//     so nothing contracts into an FMA): _unnormalize, then _apply_padding
//     (zeros, border, reflection; fmodf is exact like torch.fmod), floor,
//     wx1 = gx - x0, wx0 = 1 - wx1, each weight wx * wy.  A corner is in
//     range by its unclipped index; its row is _finite_clip's.
//   - The combine in the table's type: term = (row * valid) * w, with
//     valid and w first rounded to that type, then acc = acc + term in
//     corner order (x0,y0), (x1,y0), (x0,y1), (x1,y1); each product and
//     sum rounded once to the type, to nearest even, as the chain's ops
//     (f32 arithmetic, then a cast) round it (see the element types
//     below).  A corner out of range is multiplied by 0, not skipped: an
//     inf or NaN row entry then gives NaN as in the chain.
//
// What bounds it: the output.  It writes B * N * C elements once (a
// srn_views view looks up 16,384 rays x (64 + 32) samples x 512 bf16, 1.61
// GB: 0.48 ms at 3.35 TB/s) and reads four table rows a point, from a
// table of a few MB (64 x 64 x 512 bf16: 4.2 MB; the YOLO path's 3 x 14.7
// MB) that stays in the 50 MB L2, where neighbouring samples of a ray share
// corners.  The design serves that bound (on an H100 80GB HBM3 a srn_views
// coarse lookup takes 0.450 ms against its 0.321-ms bound):
//   - One warp takes 32 points.  Each lane works out one point's corners
//     (four rows, four weights, the in-range bits) once, and the lanes hand
//     them round by shuffle, so the coordinate math costs one pass.
//   - A group of lanes takes one point: a whole warp where a row has 32 or
//     more 16-byte vectors (C >= 256 in bf16), fewer lanes and several
//     points at once below that.  Each lane loads 16-byte vectors of the
//     four rows through the read-only path, the four loads issued before
//     the arithmetic (paired bf16x2 / f16x2 instructions, no conversions),
//     and writes its vector of the result once with a streaming store, so
//     the output does not evict the table from L2.
//     Narrower vectors are taken where C or a base address does not allow
//     16 bytes; lanes past a row's last vector (a ragged C) do nothing.
//   - Offsets are 64-bit: B * N * C passes 2^31 (a YOLO render of 16,384
//     rays x 128 samples x 3 views at 1,792 channels is 1.1e10).
//   - Blocks of one table run together (blockIdx.y is the table), so one
//     table is hot in L2 at a time.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps of 32 points: 256 points a block
constexpr unsigned kFull = 0xffffffffu;

enum Padding { kZeros = 0, kBorder = 1, kReflection = 2 };

// The table's element type: its bits in memory, two elements as one pair,
// and the pair arithmetic, each product and sum rounded once to the type
// (round to nearest even).  A bf16 or f16 product or sum taken in f32 and
// rounded to the type, as the chain does, is that correctly rounded
// result: the product of two such numbers is exact in f32, and an f32 sum
// has more than 2p + 2 bits for p bits of the type, so its second rounding
// is innocuous.  So the 16-bit types take the card's paired bf16x2 / f16x2
// instructions (the _rn forms, which never contract into an FMA), and no
// conversion from f32 but the weights' once a point.
struct F32 {
  using Bits = float;
  using Pair = float2;
  static __device__ __forceinline__ float rnd(float f) { return f; }
  static __device__ __forceinline__ Pair pair(Bits lo, Bits hi) {
    return make_float2(lo, hi);
  }
  static __device__ __forceinline__ Bits low(Pair p) { return p.x; }
  static __device__ __forceinline__ Bits high(Pair p) { return p.y; }
  static __device__ __forceinline__ Pair splat(float f) {
    return make_float2(f, f);
  }
  static __device__ __forceinline__ Pair mul(Pair a, Pair b) {
    return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  }
  static __device__ __forceinline__ Pair add(Pair a, Pair b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
};

struct Bf16 {
  using Bits = unsigned short;
  using Pair = __nv_bfloat162;
  static __device__ __forceinline__ float rnd(float f) {
    return __bfloat162float(__float2bfloat16_rn(f));
  }
  static __device__ __forceinline__ Pair pair(Bits lo, Bits hi) {
    return __halves2bfloat162(__ushort_as_bfloat16(lo),
                              __ushort_as_bfloat16(hi));
  }
  static __device__ __forceinline__ Bits low(Pair p) {
    return __bfloat16_as_ushort(__low2bfloat16(p));
  }
  static __device__ __forceinline__ Bits high(Pair p) {
    return __bfloat16_as_ushort(__high2bfloat16(p));
  }
  static __device__ __forceinline__ Pair splat(float f) {
    return __float2bfloat162_rn(f);
  }
  static __device__ __forceinline__ Pair mul(Pair a, Pair b) {
    return __hmul2_rn(a, b);
  }
  static __device__ __forceinline__ Pair add(Pair a, Pair b) {
    return __hadd2_rn(a, b);
  }
};

struct F16 {
  using Bits = unsigned short;
  using Pair = __half2;
  static __device__ __forceinline__ float rnd(float f) {
    return __half2float(__float2half_rn(f));
  }
  static __device__ __forceinline__ Pair pair(Bits lo, Bits hi) {
    return __halves2half2(__ushort_as_half(lo), __ushort_as_half(hi));
  }
  static __device__ __forceinline__ Bits low(Pair p) {
    return __half_as_ushort(__low2half(p));
  }
  static __device__ __forceinline__ Bits high(Pair p) {
    return __half_as_ushort(__high2half(p));
  }
  static __device__ __forceinline__ Pair splat(float f) {
    return __float2half2_rn(f);
  }
  static __device__ __forceinline__ Pair mul(Pair a, Pair b) {
    return __hmul2_rn(a, b);
  }
  static __device__ __forceinline__ Pair add(Pair a, Pair b) {
    return __hadd2_rn(a, b);
  }
};

// one vector access of 2, 4, 8 or 16 bytes
template <int Bytes> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<2> { using T = unsigned short; };

template <class E, int V>
union Pack {
  typename Word<V * sizeof(typename E::Bits)>::T word;
  typename E::Bits v[V];
};

// ops/grid_sample.py::_unnormalize
__device__ __forceinline__ float unnormalize(float g, int size, bool align) {
  if (align)
    return __fmul_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f), (float)(size - 1));
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)size), 1.0f),
                   0.5f);
}

// _torch_clip: NaN -> 0, else clamped into [0, size - 1] (+inf to the far
// border, -inf to 0)
__device__ __forceinline__ float torch_clip(float x, int size) {
  return isnan(x) ? 0.0f : fminf(fmaxf(x, 0.0f), (float)(size - 1));
}

// _reflect into [low, low + span]
__device__ __forceinline__ float reflect(float x, float low, float span) {
  if (span <= 0.0f) return 0.0f;
  float t = fmodf(fabsf(__fsub_rn(x, low)), 2.0f * span);
  t = t > span ? __fsub_rn(2.0f * span, t) : t;
  return __fadd_rn(low, t);
}

// _apply_padding
__device__ __forceinline__ float apply_padding(float x, int size, int padding,
                                               bool align) {
  if (padding == kBorder) return torch_clip(x, size);
  if (padding == kReflection) {
    x = align ? reflect(x, 0.0f, (float)(size - 1))
              : reflect(x, -0.5f, (float)size);
    return torch_clip(x, size);
  }
  return x;
}

// _finite_clip: non-finite -> 0, then clamped into [0, size - 1]
__device__ __forceinline__ float finite_clip(float i, int size) {
  return fminf(fmaxf(isfinite(i) ? i : 0.0f, 0.0f), (float)(size - 1));
}

// _corners for one point: per corner (x0,y0), (x1,y0), (x0,y1), (x1,y1) its
// row, its weight rounded to the table's type, and its in-range bit
template <class E>
__device__ __forceinline__ void corners(float gx_in, float gy_in, int h, int w,
                                        int padding, bool align, int* row,
                                        float* wt, unsigned& valid) {
  const float gx = apply_padding(unnormalize(gx_in, w, align), w, padding,
                                 align);
  const float gy = apply_padding(unnormalize(gy_in, h, align), h, padding,
                                 align);
  const float x0 = floorf(gx), y0 = floorf(gy);
  const float x1 = __fadd_rn(x0, 1.0f), y1 = __fadd_rn(y0, 1.0f);
  const float wx1 = __fsub_rn(gx, x0), wy1 = __fsub_rn(gy, y0);
  const float wx0 = __fsub_rn(1.0f, wx1), wy0 = __fsub_rn(1.0f, wy1);
  const float xs[4] = {x0, x1, x0, x1}, ys[4] = {y0, y0, y1, y1};
  const float wxs[4] = {wx0, wx1, wx0, wx1}, wys[4] = {wy0, wy0, wy1, wy1};
  valid = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool in = xs[k] >= 0.0f && xs[k] <= (float)(w - 1) &&
                    ys[k] >= 0.0f && ys[k] <= (float)(h - 1);
    valid |= (unsigned)in << k;
    // the chain's f32 row index, then its cast to an integer
    row[k] = (int)__fadd_rn(__fmul_rn(finite_clip(ys[k], h), (float)w),
                            finite_clip(xs[k], w));
    wt[k] = E::rnd(__fmul_rn(wxs[k], wys[k]));
  }
}

// two elements of the combine: per corner (x * valid) * w, summed in corner
// order, each product and sum rounded to the type
template <class E>
__device__ __forceinline__ typename E::Pair combine(
    typename E::Pair a, typename E::Pair b, typename E::Pair c,
    typename E::Pair d, const typename E::Pair* v,
    const typename E::Pair* wt) {
  typename E::Pair acc = E::mul(E::mul(a, v[0]), wt[0]);
  acc = E::add(acc, E::mul(E::mul(b, v[1]), wt[1]));
  acc = E::add(acc, E::mul(E::mul(c, v[2]), wt[2]));
  return E::add(acc, E::mul(E::mul(d, v[3]), wt[3]));
}

template <class E, int V>
__global__ void __launch_bounds__(kThreads)
latent_gather_kernel(const typename E::Bits* __restrict__ table,
                     const float2* __restrict__ grid,
                     typename E::Bits* __restrict__ out, int rows, int n,
                     int c, int h, int w, int padding, int align, int group) {
  using Bits = typename E::Bits;
  using W = typename Word<V * sizeof(Bits)>::T;
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.y;
  const long long first =
      ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * 32;
  if (first >= n) return;  // the whole warp
  const int here = (int)min(32LL, (long long)n - first);

  int row[4] = {0, 0, 0, 0};
  float wt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  unsigned valid = 0;
  if (lane < here) {
    const float2 g = grid[b * n + first + lane];
    corners<E>(g.x, g.y, h, w, padding, align != 0, row, wt, valid);
  }

  const int vecs = c / V;
  const int per_pass = 32 / group;
  const int slot = lane / group, k0 = lane % group;
  const Bits* tab = table + b * rows * (long long)c;
  for (int base = 0; base < here; base += per_pass) {
    const int src = base + slot;  // every lane takes part in the shuffles
    const int r0 = __shfl_sync(kFull, row[0], src);
    const int r1 = __shfl_sync(kFull, row[1], src);
    const int r2 = __shfl_sync(kFull, row[2], src);
    const int r3 = __shfl_sync(kFull, row[3], src);
    const float w0 = __shfl_sync(kFull, wt[0], src);
    const float w1 = __shfl_sync(kFull, wt[1], src);
    const float w2 = __shfl_sync(kFull, wt[2], src);
    const float w3 = __shfl_sync(kFull, wt[3], src);
    const unsigned vm = __shfl_sync(kFull, valid, src);
    if (src >= here) continue;
    const typename E::Pair v[4] = {
        E::splat((vm & 1u) ? 1.0f : 0.0f), E::splat((vm & 2u) ? 1.0f : 0.0f),
        E::splat((vm & 4u) ? 1.0f : 0.0f), E::splat((vm & 8u) ? 1.0f : 0.0f)};
    const typename E::Pair ws[4] = {E::splat(w0), E::splat(w1), E::splat(w2),
                                    E::splat(w3)};
    const W* c0 = reinterpret_cast<const W*>(tab + (long long)r0 * c);
    const W* c1 = reinterpret_cast<const W*>(tab + (long long)r1 * c);
    const W* c2 = reinterpret_cast<const W*>(tab + (long long)r2 * c);
    const W* c3 = reinterpret_cast<const W*>(tab + (long long)r3 * c);
    W* o = reinterpret_cast<W*>(out + (b * n + first + src) * (long long)c);
#pragma unroll 2
    for (int k = k0; k < vecs; k += group) {
      Pack<E, V> p0, p1, p2, p3, res;
      p0.word = __ldg(c0 + k);
      p1.word = __ldg(c1 + k);
      p2.word = __ldg(c2 + k);
      p3.word = __ldg(c3 + k);
      if constexpr (V == 1) {
        res.v[0] = E::low(combine<E>(
            E::pair(p0.v[0], p0.v[0]), E::pair(p1.v[0], p1.v[0]),
            E::pair(p2.v[0], p2.v[0]), E::pair(p3.v[0], p3.v[0]), v, ws));
      } else {
#pragma unroll
        for (int e = 0; e < V; e += 2) {
          const typename E::Pair r = combine<E>(
              E::pair(p0.v[e], p0.v[e + 1]), E::pair(p1.v[e], p1.v[e + 1]),
              E::pair(p2.v[e], p2.v[e + 1]), E::pair(p3.v[e], p3.v[e + 1]),
              v, ws);
          res.v[e] = E::low(r);
          res.v[e + 1] = E::high(r);
        }
      }
      __stcs(o + k, res.word);
    }
  }
}

template <class E, int V>
int launch(const void* table, const void* grid, void* out, int batch, int rows,
           int n, int c, int h, int w, int padding, int align,
           cudaStream_t stream) {
  const int vecs = c / V;
  int group = 1;  // lanes a point: the vectors of a row, at most a warp
  while (group < vecs && group < 32) group <<= 1;
  const dim3 blocks((unsigned)(((long long)n + kThreads - 1) / kThreads),
                    (unsigned)batch);
  latent_gather_kernel<E, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const typename E::Bits*>(table),
      static_cast<const float2*>(grid), static_cast<typename E::Bits*>(out),
      rows, n, c, h, w, padding, align, group);
  return (int)cudaGetLastError();
}

// the widest vector (16 bytes down to one element) that C and both base
// addresses allow
template <class E>
int dispatch(const void* table, const void* grid, void* out, int batch,
             int rows, int n, int c, int h, int w, int padding, int align,
             cudaStream_t stream) {
  constexpr int kElt = sizeof(typename E::Bits);
  constexpr int kMax = 16 / kElt;
  const uintptr_t at =
      reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  auto fits = [&](int v) { return c % v == 0 && at % (v * kElt) == 0; };
  if (fits(kMax))
    return launch<E, kMax>(table, grid, out, batch, rows, n, c, h, w, padding,
                           align, stream);
  if (fits(kMax / 2))
    return launch<E, kMax / 2>(table, grid, out, batch, rows, n, c, h, w,
                               padding, align, stream);
  if constexpr (kMax >= 8) {
    if (fits(kMax / 4))
      return launch<E, kMax / 4>(table, grid, out, batch, rows, n, c, h, w,
                                 padding, align, stream);
  }
  return launch<E, 1>(table, grid, out, batch, rows, n, c, h, w, padding,
                      align, stream);
}

}  // namespace

extern "C" {

const char* latent_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The bilinear lookup of grid (batch, n, 2) f32, (x, y) in [-1, 1], in the
// table (batch, rows = h * w, c) of dtype 0 f32, 1 bf16, 2 f16, into out
// (batch, n, c) of the table's dtype; padding 0 zeros, 1 border, 2
// reflection.  All contiguous; grid 8-byte aligned.  Launches on `stream`
// and returns the CUDA error code (0 = ok).
int latent_gather_launch(int dtype, const void* table, const void* grid,
                         void* out, int batch, int rows, int n, int c, int h,
                         int w, int padding, int align_corners, void* stream) {
  if (dtype < 0 || dtype > 2 || padding < 0 || padding > 2 || batch < 0 ||
      batch > 65535 || n < 0 || c <= 0 || h <= 0 || w <= 0 ||
      (long long)h * w != rows || reinterpret_cast<uintptr_t>(grid) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int align = align_corners != 0;
  if (dtype == 1)
    return dispatch<Bf16>(table, grid, out, batch, rows, n, c, h, w, padding,
                          align, s);
  if (dtype == 2)
    return dispatch<F16>(table, grid, out, batch, rows, n, c, h, w, padding,
                         align, s);
  return dispatch<F32>(table, grid, out, batch, rows, n, c, h, w, padding,
                       align, s);
}

}  // extern "C"

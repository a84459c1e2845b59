// Fused pixelNeRF field MLP (ResnetFC) for Hopper (sm_90a), CUDA cores.
//
// Replaces the three Pallas TPU kernels of the JAX package's
// pixelnerf_yolo_tpu/ops/pallas/fused_mlp.py that carry the NeRF render:
//   mode 0  full_pe          <- fused_full_pe        (_full_pe_kernel)
//   mode 1  pre_combine_pe   <- fused_pre_combine_pe (_pre_combine_pe_kernel)
//   mode 2  post_combine     <- fused_post_combine   (_post_combine_kernel)
// It computes what they compute, with the same rounding points: every Dense
// is an f32 accumulation plus an f32 bias, then one cast to the compute type
// T (float or bf16); the residual stream x stays in T; lin_out takes the
// T-typed w_out and writes f32.  The positional encoding is computed
// directly as sin(f * x + phase) (the TPU kernel's base @ M + P matmul has
// one non-zero per column, so both give the same f32 value).
//
// What bounds it: at the flagship widths (H = dL = 512, 5 blocks) a row
// costs 3.43 M multiply-adds against ~1 KB of input and output, so the
// work is bound by operations, not bytes.  The TPU kernel kept the whole
// weight set resident in 16 MiB of VMEM; on Hopper the set (6.9 MB bf16,
// 13.7 MB f32) cannot sit in 227 KB of shared memory.  So each block owns
// a tile of kRows rows and keeps its activations (x, the fc_0 output and
// the latent tile) in shared memory for the whole chain, and the weights
// stream from global memory, where they stay resident in the 50 MB L2, one
// (kBK x H) tile at a time.  Each thread holds an 8 x 8 register tile of
// the (kRows x H) layer output, so every staged weight element is reused
// kRows times and every activation element H / 64 times.  This first
// version runs plain f32 FMAs on the CUDA cores (bf16 operands are widened
// on load); wgmma, TMA and warp specialisation are for later versions.
//
// Ragged row counts are handled by masking: rows past n_rows load zeros
// and store nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                            // rows per block
constexpr int kColLanes = 64;                        // threads across columns
constexpr int kRowGroups = kThreads / kColLanes;     // 4
constexpr int kRowsPerThread = kRows / kRowGroups;   // 8
constexpr int kMaxColsPerThread = 8;                 // hidden <= 512
constexpr int kBK = 16;                              // staged weight rows
constexpr float kHalfPi = 1.57079637050628662109375f;  // float32(pi / 2)

enum Epilogue { kSet = 0, kAdd = 1, kRelu = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const float* base;    // (n, 6) f32: [xyz, viewdirs]
  const void* latent;   // (n, d_latent) T
  const void* h_in;     // (n, hidden) T, post_combine only
  const void* w_in;     // (d_in, hidden) T
  const float* b_in;    // (hidden,)
  const void* wz;       // (n_pre, d_latent, hidden) T
  const float* bz;      // (n_pre, hidden)
  const void* w0;       // (n_pre, hidden, hidden) T
  const float* b0;
  const void* w1;
  const float* b1;
  const void* w0p;      // (n_post, hidden, hidden) T
  const float* b0p;
  const void* w1p;
  const float* b1p;
  const void* w_out;    // (hidden, d_out) T
  const float* b_out;   // (d_out,)
  void* out;            // (n, d_out) f32, or (n, hidden) T for pre_combine
  int n_rows, d_in, d_latent, hidden, n_pre, n_post, d_out, num_freqs;
  float freq_factor;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// dst[r, j] <- epilogue(sum_k A[r, k] W[k, j] + bias[j]) for the block's
// kRows rows and all `hidden` columns.  A is (kRows, lda) in shared memory
// and is zero in columns [K, round_up(K, kBK)).  W is (K, hidden) in
// global memory.
template <typename T, bool kReluA, int kEpi>
__device__ void dense_hidden(const T* A, int lda, int K,
                             const T* __restrict__ W,
                             const float* __restrict__ bias, int hidden,
                             T* dst, T* wtile) {
  const int tid = threadIdx.x;
  const int tx = tid % kColLanes;
  const int ty = tid / kColLanes;
  const int ncol = hidden / kColLanes;
  float acc[kRowsPerThread][kMaxColsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
    for (int c = 0; c < kMaxColsPerThread; ++c) acc[m][c] = 0.f;

  const T* arow = A + ty * kRowsPerThread * lda;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int kk = 0; kk < kBK; ++kk) {
      const int k = k0 + kk;
      for (int j = tid; j < hidden; j += kThreads)
        wtile[kk * hidden + j] =
            k < K ? W[(size_t)k * hidden + j] : from_f<T>(0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kRowsPerThread];
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const float v = to_f(arow[m * lda + k0 + kk]);
        a[m] = kReluA ? fmaxf(v, 0.f) : v;
      }
      float w[kMaxColsPerThread];
#pragma unroll
      for (int c = 0; c < kMaxColsPerThread; ++c)
        w[c] = c < ncol ? to_f(wtile[kk * hidden + tx + c * kColLanes]) : 0.f;
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
        for (int c = 0; c < kMaxColsPerThread; ++c)
          acc[m][c] = fmaf(a[m], w[c], acc[m][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int r = ty * kRowsPerThread + m;
#pragma unroll
    for (int c = 0; c < kMaxColsPerThread; ++c) {
      if (c >= ncol) continue;
      const int j = tx + c * kColLanes;
      const T t = from_f<T>(acc[m][c] + bias[j]);
      T* d = dst + r * hidden + j;
      if (kEpi == kSet) {
        *d = t;
      } else if (kEpi == kAdd) {
        *d = from_f<T>(to_f(*d) + to_f(t));
      } else {
        *d = from_f<T>(fmaxf(to_f(t), 0.f));
      }
    }
  }
  __syncthreads();
}

// out[row, o] = sum_k relu(X[r, k]) w_out[k, o] + b_out[o], in f32.
template <typename T>
__device__ void dense_out(const T* X, int hidden, const T* __restrict__ w_out,
                          const float* __restrict__ b_out, int d_out,
                          float* out, int row0, int n_rows) {
  for (int i = threadIdx.x; i < kRows * d_out; i += kThreads) {
    const int r = i / d_out;
    const int o = i - r * d_out;
    if (row0 + r >= n_rows) continue;
    float acc = 0.f;
    for (int k = 0; k < hidden; ++k)
      acc = fmaf(fmaxf(to_f(X[r * hidden + k]), 0.f),
                 to_f(w_out[k * d_out + o]), acc);
    out[(size_t)(row0 + r) * d_out + o] = acc + b_out[o];
  }
}

// Z[r, col] = [x, sin(f_0 x), cos(f_0 x), ..., sin(f_F-1 x), cos(..), vd]
// with cos(t) = sin(t + pi/2), f_i = freq_factor * 2^i; columns past d_in
// up to ldz are zero.  The products and sums are rounded separately (no
// FMA contraction) so that t matches the f32 value of the reference.
template <typename T>
__device__ void positional_encoding(const float* __restrict__ base, int row0,
                                    int n_rows, float freq_factor,
                                    int num_freqs, int d_in, int ldz, T* Z) {
  const int n_band = 6 * num_freqs;
  for (int i = threadIdx.x; i < kRows * ldz; i += kThreads) {
    const int r = i / ldz;
    const int col = i - r * ldz;
    float v = 0.f;
    if (row0 + r < n_rows && col < d_in) {
      const float* b = base + (size_t)(row0 + r) * 6;
      if (col < 3) {
        v = b[col];
      } else if (col < 3 + n_band) {
        const int q = (col - 3) / 3;
        const int j = (col - 3) - 3 * q;
        float t = __fmul_rn(b[j], ldexpf(freq_factor, q >> 1));
        if (q & 1) t = __fadd_rn(t, kHalfPi);
        v = sinf(t);
      } else {
        v = b[col - n_band];
      }
    }
    Z[i] = from_f<T>(v);
  }
}

// Shared memory: X (kRows x hidden) the residual stream, A2 (kRows x
// hidden) the relu'd fc_0 output (and the PE features before lin_in),
// L (kRows x d_latent) the latent tile (modes 0 and 1), and the staged
// weight tile (kBK x hidden).
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads) field_mlp_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = p.hidden;
  const int dL = p.d_latent;
  T* X = reinterpret_cast<T*>(smem_raw);
  T* A2 = X + kRows * H;
  T* L = A2 + kRows * H;
  T* wtile = L + (kMode == 2 ? 0 : kRows * dL);
  const int row0 = blockIdx.x * kRows;
  const int n = p.n_rows;

  if (kMode != 2) {
    const T* lat = static_cast<const T*>(p.latent);
    for (int i = threadIdx.x; i < kRows * dL; i += kThreads) {
      const int r = i / dL;
      L[i] = row0 + r < n ? lat[(size_t)row0 * dL + i] : from_f<T>(0.f);
    }
    const int ldz = round_up(p.d_in, kBK);
    positional_encoding<T>(p.base, row0, n, p.freq_factor, p.num_freqs,
                           p.d_in, ldz, A2);
    __syncthreads();
    dense_hidden<T, false, kSet>(A2, ldz, p.d_in,
                                 static_cast<const T*>(p.w_in), p.b_in, H, X,
                                 wtile);
    const T* wz = static_cast<const T*>(p.wz);
    const T* w0 = static_cast<const T*>(p.w0);
    const T* w1 = static_cast<const T*>(p.w1);
    for (int blk = 0; blk < p.n_pre; ++blk) {
      dense_hidden<T, false, kAdd>(L, dL, dL, wz + (size_t)blk * dL * H,
                                   p.bz + blk * H, H, X, wtile);
      dense_hidden<T, true, kRelu>(X, H, H, w0 + (size_t)blk * H * H,
                                   p.b0 + blk * H, H, A2, wtile);
      dense_hidden<T, false, kAdd>(A2, H, H, w1 + (size_t)blk * H * H,
                                   p.b1 + blk * H, H, X, wtile);
    }
    if (kMode == 1) {
      T* h = static_cast<T*>(p.out);
      for (int i = threadIdx.x; i < kRows * H; i += kThreads) {
        if (row0 + i / H < n) h[(size_t)row0 * H + i] = X[i];
      }
      return;
    }
  } else {
    const T* h = static_cast<const T*>(p.h_in);
    for (int i = threadIdx.x; i < kRows * H; i += kThreads) {
      X[i] = row0 + i / H < n ? h[(size_t)row0 * H + i] : from_f<T>(0.f);
    }
    __syncthreads();
  }

  const T* w0p = static_cast<const T*>(p.w0p);
  const T* w1p = static_cast<const T*>(p.w1p);
  for (int blk = 0; blk < p.n_post; ++blk) {
    dense_hidden<T, true, kRelu>(X, H, H, w0p + (size_t)blk * H * H,
                                 p.b0p + blk * H, H, A2, wtile);
    dense_hidden<T, false, kAdd>(A2, H, H, w1p + (size_t)blk * H * H,
                                 p.b1p + blk * H, H, X, wtile);
  }
  dense_out<T>(X, H, static_cast<const T*>(p.w_out), p.b_out, p.d_out,
               static_cast<float*>(p.out), row0, n);
}

size_t smem_bytes(int mode, size_t elt, int hidden, int d_latent) {
  const size_t lat = mode == 2 ? 0 : (size_t)kRows * d_latent;
  return elt * ((size_t)2 * kRows * hidden + lat + (size_t)kBK * hidden);
}

template <typename T, int kMode>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(kMode, sizeof(T), p.hidden, p.d_latent);
  cudaError_t err = cudaFuncSetAttribute(
      field_mlp_kernel<T, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (p.n_rows + kRows - 1) / kRows;
  if (grid == 0) return 0;
  field_mlp_kernel<T, kMode><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_mode(int mode, const Params& p, cudaStream_t stream) {
  switch (mode) {
    case 0: return launch<T, 0>(p, stream);
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Rows per block and staged weight rows: the Python wrapper sizes its
// feasibility check from these.
int field_mlp_rows_per_block() { return kRows; }
int field_mlp_weight_tile_rows() { return kBK; }

const char* field_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one kernel on `stream`; returns the CUDA error code (0 = ok).
// Pointers a mode does not use may be null.
int field_mlp_launch(int mode, int bf16, const void* base, const void* latent,
                     const void* h_in, const void* w_in, const void* b_in,
                     const void* wz, const void* bz, const void* w0,
                     const void* b0, const void* w1, const void* b1,
                     const void* w0p, const void* b0p, const void* w1p,
                     const void* b1p, const void* w_out, const void* b_out,
                     void* out, int n_rows, int d_in, int d_latent,
                     int hidden, int n_pre, int n_post, int d_out,
                     int num_freqs, float freq_factor, void* stream) {
  Params p;
  p.base = static_cast<const float*>(base);
  p.latent = latent;
  p.h_in = h_in;
  p.w_in = w_in;
  p.b_in = static_cast<const float*>(b_in);
  p.wz = wz;
  p.bz = static_cast<const float*>(bz);
  p.w0 = w0;
  p.b0 = static_cast<const float*>(b0);
  p.w1 = w1;
  p.b1 = static_cast<const float*>(b1);
  p.w0p = w0p;
  p.b0p = static_cast<const float*>(b0p);
  p.w1p = w1p;
  p.b1p = static_cast<const float*>(b1p);
  p.w_out = w_out;
  p.b_out = static_cast<const float*>(b_out);
  p.out = out;
  p.n_rows = n_rows;
  p.d_in = d_in;
  p.d_latent = d_latent;
  p.hidden = hidden;
  p.n_pre = n_pre;
  p.n_post = n_post;
  p.d_out = d_out;
  p.num_freqs = num_freqs;
  p.freq_factor = freq_factor;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_mode<__nv_bfloat16>(mode, p, s)
              : dispatch_mode<float>(mode, p, s);
}

}  // extern "C"

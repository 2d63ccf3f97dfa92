// Flash attention forward and backward for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py:
//   fa_forward  <- `_fwd_kernel`     (launched by `_fwd_call`)
//   fa_bwd_dkv  <- `_bwd_dkv_kernel` (first pallas_call of `_bwd_call`)
//   fa_bwd_dq   <- `_bwd_dq_kernel`  (second pallas_call of `_bwd_call`)
// and computes the same functions on flattened, contiguous inputs:
//
//   q [BH, Sq, D], k/v [BH, Sk, D], do/o [BH, Sq, D]: float32 | bfloat16
//   bias [BH, Sk] float32 or null (additive key bias)
//   lse, delta [BH, Sq] float32; o, dq, dk, dv in the input type
//
//   S = q kᵀ · sm_scale + bias, S = -1e30 where col > row (causal);
//   forward: online softmax with float32 (m, l, acc); l sums the
//     pre-dropout p, dropout scales only the numerator;
//     o = acc / l_safe, lse = m + log(l_safe), l_safe = (l == 0 ? 1 : l);
//   backward: P = exp(S - lse), Z = P∘M, dV = Zᵀ dO,
//     dS = P∘((dO Vᵀ)∘M - delta)·sm_scale, dK = dSᵀ Q, dQ = dS K.
//
// The dropout keep mask M is the reference's murmur3-finalizer hash of
// the global (row, col, bh, seed) coordinates in uint32 (`_dropout_mask`),
// so it is bit-identical to the reference's and independent of tiling.
//
// Design. The TPU kernels carry (m, l, acc) or (dk, dv) or dq in VMEM
// scratch across a sequential innermost grid axis. Blocks on Hopper run in
// no order, so each block owns its outputs and loops over the other axis
// itself: the forward and dq kernels own one (bh, 64-row q tile) and walk
// the k tiles, the dkv kernel owns one (bh, 64-row k tile) and walks the q
// tiles. No atomics, so results are the same from run to run. Under the
// causal mask a block visits only the tiles that hold a pair with
// col <= row; a skipped tile is wholly masked and would contribute exactly
// nothing. Each tile is staged into shared memory as float32, transposed
// to [D][64 + 1] (the odd stride keeps both row and column reads free of
// bank conflicts); 256 threads each compute a 4 x 4 patch of the 64 x 64
// score tile with float32 FMAs, and the probabilities go through shared
// memory into the second product. Inputs are upcast to float32 on load,
// as the TPU kernel upcasts them; there are no tensor cores in this first
// version.
//
// Bound. At the trainer's shapes (S 512, D 64) each kernel's float32
// operations dominate its bytes: this SIMT version is bound by the
// float32 FMA rate and by shared-memory bandwidth (two operand loads per
// four FMAs). wgmma on bf16 tiles, TMA staging and pipelining are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;         // q rows and k rows per tile
constexpr int kLd = kTile + 1;    // padded stride of a transposed tile
constexpr int kThreads = 256;     // a 16 x 16 grid of threads
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;  // the reference's mask constant
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

struct Dropout {
  bool on;
  uint32_t seed, thresh;
  float keep_scale;

  // The reference's `_dropout_mask` for one element.
  __device__ __forceinline__ float mask(uint32_t row, uint32_t col,
                                        uint32_t bh) const {
    uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
    x = x ^ (bh * 0xC2B2AE3Du) ^ seed;
    x = x ^ (x >> 16);
    x = x * 0x85EBCA6Bu;
    x = x ^ (x >> 13);
    x = x * 0xC2B2AE35u;
    x = x ^ (x >> 16);
    return x >= thresh ? keep_scale : 0.f;
  }
};

// Stages rows [row0, row0 + kTile) of a row-major [n, D] matrix into
// s[d * kLd + r] as float32; rows >= n and columns >= D read as 0.
template <typename T, int DP>
__device__ __forceinline__ void load_tile_t(float* s, const T* g, int row0,
                                            int n, int D) {
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    float val = 0.f;
    if (row0 + r < n && d < D) val = to_f32(g[(size_t)(row0 + r) * D + d]);
    s[d * kLd + r] = val;
  }
}

// Stages entries [row0, row0 + kTile) of a per-row float32 vector of
// length n into s; entries past n read as 0.
__device__ __forceinline__ void load_rows(float* s, const float* g, int row0,
                                          int n) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    s[r] = row0 + r < n ? g[row0 + r] : 0.f;
}

// acc[i][j] += sum_d a[d][ra + 16 i] * b[d][rb + 16 j] over transposed tiles.
template <int DP>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a,
                                         int ra, const float* b, int rb) {
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[d * kLd + ra + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[d * kLd + rb + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// Max and sum over the 16 lanes that share one row (the same ty).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The masked, scaled score of (row, col): bias added, -1e30 above the
// diagonal when causal. The caller handles col >= Sk.
__device__ __forceinline__ float score(float dot, float sm_scale,
                                       const float* bias, int row, int col,
                                       bool causal) {
  float x = dot * sm_scale;
  if (bias != nullptr) x += bias[col];
  if (causal && col > row) x = kNegInf;
  return x;
}

// ---------------------------------------------------------------------------
// Forward: one block per (bh, q tile); grid (BH, ceil(Sq / 64)).
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ bias,
                  T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk,
                  int D, float sm_scale, bool causal, Dropout drop) {
  extern __shared__ float smem[];
  float* q_s = smem;              // [DP][kLd]
  float* k_s = q_s + DP * kLd;    // [DP][kLd]
  float* v_s = k_s + DP * kLd;    // [DP][kLd]
  float* p_s = v_s + DP * kLd;    // [kTile cols][kLd rows]
  constexpr int kDc = DP / 16;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += (size_t)bh * Sq * D;
  k += (size_t)bh * Sk * D;
  v += (size_t)bh * Sk * D;
  o += (size_t)bh * Sq * D;
  lse += (size_t)bh * Sq;
  if (bias != nullptr) bias += (size_t)bh * Sk;

  load_tile_t<T, DP>(q_s, q, q0, Sq, D);

  float m[4], l[4], acc[4][kDc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = 0.f;
  }

  // Under the causal mask, keys past the tile's last row are all masked.
  const int k_end = causal ? min(Sk, q0 + kTile) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tiles are consumed
    load_tile_t<T, DP>(k_s, k, k0, Sk, D);
    load_tile_t<T, DP>(v_s, v, k0, Sk, D);
    __syncthreads();

    float s[4][4] = {};
    tile_dot<DP>(s, q_s, ty, k_s, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] = col < Sk ? score(s[i][j], sm_scale, bias, row, col, causal)
                           : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile holds the valid key k0, so the row max is finite
      const float m_next = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_next);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = col < Sk ? expf(s[i][j] - m_next) : 0.f;
        psum += p;
        s[i][j] = drop.on ? p * drop.mask(row, col, bh) : p;
      }
      l[i] = alpha * l[i] + row_sum(psum);
      m[i] = m_next;
#pragma unroll
      for (int c = 0; c < kDc; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(tx + 16 * j) * kLd + ty + 16 * i] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[c * kLd + ty + 16 * i];
#pragma unroll
      for (int jd = 0; jd < kDc; ++jd) {
        const float vv = v_s[(tx + 16 * jd) * kLd + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(p[i], vv, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jd = 0; jd < kDc; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) o[(size_t)row * D + d] = from_f32<T>(acc[i][jd] / l_safe);
    }
    if (tx == 0) lse[row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (bh, k tile); grid (BH, ceil(Sk / 64)).
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int D,
                      float sm_scale, bool causal, Dropout drop) {
  extern __shared__ float smem[];
  float* k_s = smem;                // [DP][kLd]
  float* v_s = k_s + DP * kLd;      // [DP][kLd]
  float* q_s = v_s + DP * kLd;      // [DP][kLd]
  float* do_s = q_s + DP * kLd;     // [DP][kLd]
  float* z_s = do_s + DP * kLd;     // [kTile q rows][kLd k rows]
  float* ds_s = z_s + kTile * kLd;  // [kTile q rows][kLd k rows]
  float* lse_s = ds_s + kTile * kLd;
  float* delta_s = lse_s + kTile;
  constexpr int kDc = DP / 16;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += (size_t)bh * Sq * D;
  dout += (size_t)bh * Sq * D;
  k += (size_t)bh * Sk * D;
  v += (size_t)bh * Sk * D;
  dk += (size_t)bh * Sk * D;
  dv += (size_t)bh * Sk * D;
  lse += (size_t)bh * Sq;
  delta += (size_t)bh * Sq;
  if (bias != nullptr) bias += (size_t)bh * Sk;

  load_tile_t<T, DP>(k_s, k, k0, Sk, D);
  load_tile_t<T, DP>(v_s, v, k0, Sk, D);

  // this thread's keys are k0 + ty + 16 i; its query rows q0 + tx + 16 j
  float acc_dk[4][kDc], acc_dv[4][kDc];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  // Under the causal mask, q tiles that end before k0 see only masked keys.
  for (int q0 = causal ? k0 : 0; q0 < Sq; q0 += kTile) {
    __syncthreads();  // the previous tiles are consumed
    load_tile_t<T, DP>(q_s, q, q0, Sq, D);
    load_tile_t<T, DP>(do_s, dout, q0, Sq, D);
    load_rows(lse_s, lse, q0, Sq);
    load_rows(delta_s, delta, q0, Sq);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<DP>(s, k_s, ty, q_s, tx);
    tile_dot<DP>(dp, v_s, ty, do_s, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, row = q0 + r;
        float z = 0.f, ds = 0.f;
        if (row < Sq && col < Sk) {
          const float x = score(s[i][j], sm_scale, bias, row, col, causal);
          const float p = expf(x - lse_s[r]);
          float dpm = dp[i][j];
          z = p;
          if (drop.on) {
            const float mk = drop.mask(row, col, bh);
            z = p * mk;
            dpm = dpm * mk;
          }
          ds = p * (dpm - delta_s[r]) * sm_scale;
        }
        z_s[r * kLd + ty + 16 * i] = z;
        ds_s[r * kLd + ty + 16 * i] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float z[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        z[i] = z_s[r * kLd + ty + 16 * i];
        ds[i] = ds_s[r * kLd + ty + 16 * i];
      }
#pragma unroll
      for (int jd = 0; jd < kDc; ++jd) {
        const float dov = do_s[(tx + 16 * jd) * kLd + r];
        const float qv = q_s[(tx + 16 * jd) * kLd + r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_dv[i][jd] = fmaf(z[i], dov, acc_dv[i][jd]);
          acc_dk[i][jd] = fmaf(ds[i], qv, acc_dk[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + ty + 16 * i;
    if (col >= Sk) continue;
#pragma unroll
    for (int jd = 0; jd < kDc; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) {
        dk[(size_t)col * D + d] = from_f32<T>(acc_dk[i][jd]);
        dv[(size_t)col * D + d] = from_f32<T>(acc_dv[i][jd]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (bh, q tile); grid (BH, ceil(Sq / 64)).
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int Sq, int Sk, int D, float sm_scale, bool causal,
                     Dropout drop) {
  extern __shared__ float smem[];
  float* q_s = smem;                // [DP][kLd]
  float* do_s = q_s + DP * kLd;     // [DP][kLd]
  float* k_s = do_s + DP * kLd;     // [DP][kLd]
  float* v_s = k_s + DP * kLd;      // [DP][kLd]
  float* ds_s = v_s + DP * kLd;     // [kTile k rows][kLd q rows]
  float* lse_s = ds_s + kTile * kLd;
  float* delta_s = lse_s + kTile;
  constexpr int kDc = DP / 16;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += (size_t)bh * Sq * D;
  dout += (size_t)bh * Sq * D;
  dq += (size_t)bh * Sq * D;
  k += (size_t)bh * Sk * D;
  v += (size_t)bh * Sk * D;
  lse += (size_t)bh * Sq;
  delta += (size_t)bh * Sq;
  if (bias != nullptr) bias += (size_t)bh * Sk;

  load_tile_t<T, DP>(q_s, q, q0, Sq, D);
  load_tile_t<T, DP>(do_s, dout, q0, Sq, D);
  load_rows(lse_s, lse, q0, Sq);
  load_rows(delta_s, delta, q0, Sq);

  float acc[4][kDc];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(Sk, q0 + kTile) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tiles are consumed
    load_tile_t<T, DP>(k_s, k, k0, Sk, D);
    load_tile_t<T, DP>(v_s, v, k0, Sk, D);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<DP>(s, q_s, ty, k_s, tx);
    tile_dot<DP>(dp, do_s, ty, v_s, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float ds = 0.f;
        if (row < Sq && col < Sk) {
          const float x = score(s[i][j], sm_scale, bias, row, col, causal);
          const float p = expf(x - lse_s[r]);
          float dpm = dp[i][j];
          if (drop.on) dpm = dpm * drop.mask(row, col, bh);
          ds = p * (dpm - delta_s[r]) * sm_scale;
        }
        ds_s[(tx + 16 * j) * kLd + r] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = ds_s[c * kLd + ty + 16 * i];
#pragma unroll
      for (int jd = 0; jd < kDc; ++jd) {
        const float kv = k_s[(tx + 16 * jd) * kLd + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(ds[i], kv, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int jd = 0; jd < kDc; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) dq[(size_t)row * D + d] = from_f32<T>(acc[i][jd]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  int BH, Sq, Sk, D;
  float sm_scale;
  bool causal;
  Dropout drop;
  cudaStream_t stream;
};

template <typename T, int DP>
cudaError_t launch_fwd(const Args& a, const void* q, const void* k,
                       const void* v, const void* bias, void* o, void* lse) {
  const size_t smem = sizeof(float) * (3 * DP + kTile) * kLd;
  auto kernel = fa_fwd_kernel<T, DP>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.BH, (a.Sq + kTile - 1) / kTile), kThreads, smem,
           a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), a.Sq, a.Sk, a.D,
      a.sm_scale, a.causal, a.drop);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const Args& a, const void* q, const void* k,
                       const void* v, const void* bias, const void* dout,
                       const void* lse, const void* delta, void* dk,
                       void* dv) {
  const size_t smem = sizeof(float) * ((4 * DP + 2 * kTile) * kLd + 2 * kTile);
  auto kernel = fa_bwd_dkv_kernel<T, DP>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.BH, (a.Sk + kTile - 1) / kTile), kThreads, smem,
           a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), a.Sq, a.Sk, a.D, a.sm_scale, a.causal, a.drop);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq(const Args& a, const void* q, const void* k,
                      const void* v, const void* bias, const void* dout,
                      const void* lse, const void* delta, void* dq) {
  const size_t smem = sizeof(float) * ((4 * DP + kTile) * kLd + 2 * kTile);
  auto kernel = fa_bwd_dq_kernel<T, DP>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.BH, (a.Sq + kTile - 1) / kTile), kThreads, smem,
           a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), a.Sq, a.Sk, a.D,
      a.sm_scale, a.causal, a.drop);
  return cudaGetLastError();
}

// Validates the sizes; returns cudaSuccess and fills `a` when they hold.
cudaError_t make_args(Args* a, int dtype, int causal, int dropout, int BH,
                      int Sq, int Sk, int D, float sm_scale, int seed,
                      uint32_t thresh, float keep_scale, void* stream) {
  if (dtype < 0 || dtype > 1 || BH < 0 || Sq < 0 || Sk <= 0 || D <= 0 ||
      D > kMaxD || (Sq + kTile - 1) / kTile > 65535 ||
      (Sk + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  a->BH = BH;
  a->Sq = Sq;
  a->Sk = Sk;
  a->D = D;
  a->sm_scale = sm_scale;
  a->causal = causal != 0;
  a->drop = Dropout{dropout != 0, (uint32_t)seed, thresh, keep_scale};
  a->stream = static_cast<cudaStream_t>(stream);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. seed is the int32 dropout seed, taken as
// uint32 as the reference does; thresh and keep_scale are the reference's
// min(int(p * 2^32), 2^32 - 1) and float32(1 / (1 - p)). Each function
// returns the cudaError_t of its launch (0 = launched).
#define FA_DISPATCH(CALL)                                        \
  do {                                                           \
    if (dtype == 0) {                                            \
      return (int)(D <= 64 ? CALL(float, 64) : CALL(float, 128)); \
    }                                                            \
    return (int)(D <= 64 ? CALL(__nv_bfloat16, 64)               \
                         : CALL(__nv_bfloat16, 128));            \
  } while (0)

extern "C" int fa_forward(int dtype, int causal, int dropout, int BH, int Sq,
                          int Sk, int D, float sm_scale, int seed,
                          uint32_t thresh, float keep_scale, const void* q,
                          const void* k, const void* v, const void* bias,
                          void* o, void* lse, void* stream) {
  Args a;
  const cudaError_t e = make_args(&a, dtype, causal, dropout, BH, Sq, Sk, D,
                                  sm_scale, seed, thresh, keep_scale, stream);
  if (e != cudaSuccess) return (int)e;
  if (BH == 0 || Sq == 0) return 0;
#define FA_FWD(T, DP) launch_fwd<T, DP>(a, q, k, v, bias, o, lse)
  FA_DISPATCH(FA_FWD);
#undef FA_FWD
}

extern "C" int fa_bwd_dkv(int dtype, int causal, int dropout, int BH, int Sq,
                          int Sk, int D, float sm_scale, int seed,
                          uint32_t thresh, float keep_scale, const void* q,
                          const void* k, const void* v, const void* bias,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv,
                          void* stream) {
  Args a;
  const cudaError_t e = make_args(&a, dtype, causal, dropout, BH, Sq, Sk, D,
                                  sm_scale, seed, thresh, keep_scale, stream);
  if (e != cudaSuccess) return (int)e;
  if (BH == 0) return 0;
#define FA_DKV(T, DP) \
  launch_dkv<T, DP>(a, q, k, v, bias, dout, lse, delta, dk, dv)
  FA_DISPATCH(FA_DKV);
#undef FA_DKV
}

extern "C" int fa_bwd_dq(int dtype, int causal, int dropout, int BH, int Sq,
                         int Sk, int D, float sm_scale, int seed,
                         uint32_t thresh, float keep_scale, const void* q,
                         const void* k, const void* v, const void* bias,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, void* stream) {
  Args a;
  const cudaError_t e = make_args(&a, dtype, causal, dropout, BH, Sq, Sk, D,
                                  sm_scale, seed, thresh, keep_scale, stream);
  if (e != cudaSuccess) return (int)e;
  if (BH == 0 || Sq == 0) return 0;
#define FA_DQ(T, DP) launch_dq<T, DP>(a, q, k, v, bias, dout, lse, delta, dq)
  FA_DISPATCH(FA_DQ);
#undef FA_DQ
}

#undef FA_DISPATCH

// Flash attention forward and backward for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py:
//   fa_forward  <- `_fwd_kernel`     (launched by `_fwd_call`)
//   fa_bwd_dkv  <- `_bwd_dkv_kernel` (first pallas_call of `_bwd_call`)
//   fa_bwd_dq   <- `_bwd_dq_kernel`  (second pallas_call of `_bwd_call`)
// and computes the same functions:
//
//   q, o, do, dq [B, H, Sq, D] and k, v, dk, dv [B, H, Sk, D]: float32 |
//     bfloat16 views with any batch, head and row stride (d has stride 1)
//   bias [B*H, Sk] float32 or null (additive key bias), contiguous
//   lse, delta [B*H, Sq] float32, contiguous
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
// with bh = b·H + h, so it is bit-identical to the reference's and
// independent of tiling.
//
// Blocks on Hopper run in no order, where the TPU kernels carry (m, l, acc),
// (dk, dv) or dq in VMEM scratch across a sequential innermost grid axis. So
// each block owns its outputs and loops over the other axis itself. No
// atomics: results are the same from run to run. Under the causal mask a
// block visits only the tiles that hold a pair with col <= row; a skipped
// tile is wholly masked and would contribute exactly nothing.
//
// Two designs.
//
// 1. bfloat16 forward and dQ on tensor cores (fa_fwd_tc_kernel,
//    fa_bwd_dq_tc_kernel). A block owns 64 q rows of one (b, h): one
//    consumer warpgroup (64 rows is the row count of `wgmma`) and one
//    producer warp. The producer's first thread loads the block's Q (and dO)
//    once and streams the 64-key K and V tiles through a ring of kStages
//    stages in shared memory with TMA (`cp.async.bulk.tensor`, 128-byte
//    swizzle, one `mbarrier` per stage for "full" and one for "empty"). The
//    tensor maps are encoded on the host for each call from the operands'
//    strides, so strided views are read in place; rows past S and columns
//    past D arrive as zeros. The consumers run `wgmma.m64n64k16` (bf16 in,
//    float32 accumulators in registers) on the tile that has arrived while
//    the next one is in flight:
//      forward: S = Q Kᵀ (both operands from shared memory; K stored
//        [keys, D] is already the K-major B operand), softmax on the
//        accumulator fragments, then O += P V with P rounded to bf16 in
//        registers as the A operand and V from shared memory with the
//        transpose bit (V is N-major there);
//      dQ: S = Q Kᵀ and dP = dO Vᵀ, dS on the fragments, dQ += dS K with dS
//        rounded to bf16 in registers and K read N-major (transpose bit).
//    head_dim is padded to DP = 64 · NP (NP 64-column panels of 128 bytes,
//    one swizzle row each); TMA fills the padding with zeros.
//    Accumulator layout of m64nN (what the softmax, bias, causal mask,
//    dropout hash and ragged edges are computed from): thread t of a
//    warpgroup, warp w = t / 32, lane l, holds register 4 j + 2 i + c at
//      row = 16 w + l / 4 + 8 i,   col = 8 j + 2 (l % 4) + c,
//    i, c in {0, 1}, j < N / 8. The four registers 8 kk .. 8 kk + 7 of an
//    m64n64 accumulator, packed in pairs, are exactly the A fragment of the
//    k-step kk (keys 16 kk .. 16 kk + 15) of the next product, so P and dS
//    never leave registers. The four threads of a quad share a row: row max
//    and sum are quad shuffles. Scores are kept prescaled by log2(e) and
//    exponentiated with exp2f; lse is written in natural log.
//    Causal: the grid's q-tile index is reversed, so the heaviest tiles
//    (most keys) start first; masks are applied only on edge tiles (the
//    diagonal, the ragged last key tile, the ragged last q tile).
//    Why 64-row blocks and not 128 (two consumer warpgroups sharing each
//    K/V tile): at the trainer's shape three 64-row blocks an SM, with the
//    dQ kernel's registers capped at 136 a thread to fit them, took the
//    forward from 0.043 to 0.033 ms and dQ from 0.077 to 0.058 ms on an
//    H100 (PERF.md §6). A deeper ring (3 or 4 stages) and a software
//    pipeline that issues the next tile's Q Kᵀ before this tile's P V
//    (more registers, fewer blocks an SM) measured no faster.
// 2. SIMT (float32 forward and dQ, and dK/dV in both types;
//    fa_fwd_kernel, fa_bwd_dkv_kernel, fa_bwd_dq_kernel). One block per
//    (bh, 64-row tile). Each tile is staged into shared memory as float32,
//    transposed to [D][64 + 1] (the odd stride keeps both row and column
//    reads free of bank conflicts); 256 threads each compute a 4 x 4 patch
//    of the 64 x 64 score tile with float32 FMAs. float32 stays off the
//    tensor cores: they take float32 only as TF32 (about 3 decimal digits),
//    which would not hold the reference's float32 arithmetic.
//
// Bound. At the trainer's shapes (S 512, D 64, bf16) the bytes each kernel
// must move (about 8 µs at 3.35 TB/s) outweigh its tensor-core operations
// (about 4 µs at 989 TFLOP/s); what holds the tensor-core kernels back is
// latency within a block (each warpgroup waits on its products, and its
// softmax runs between them; other blocks on the SM fill the gaps) and the
// causal tail. The SIMT kernels are bound by the float32 FMA rate and by
// shared-memory bandwidth.
#include <cuda.h>  // CUtensorMap and its enums only; nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;         // q rows and k rows per SIMT tile
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

// Element strides of a [B, H, S, D] operand's batch, head and row; d has
// stride 1.
struct View {
  long long b, h, r;
};

template <typename P>
__device__ __forceinline__ P at(P base, const View& s, int b, int h) {
  return base + (long long)b * s.b + (long long)h * s.h;
}

// Stages rows [row0, row0 + kTile) of a [n, D] matrix with row stride ld
// into s[d * kLd + r] as float32; rows >= n and columns >= D read as 0.
template <typename T, int DP>
__device__ __forceinline__ void load_tile_t(float* s, const T* g, long long ld,
                                            int row0, int n, int D) {
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    float val = 0.f;
    if (row0 + r < n && d < D) val = to_f32(g[(long long)(row0 + r) * ld + d]);
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
// SIMT forward: one block per (bh, q tile); grid (BH, ceil(Sq / 64)).
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ bias,
                  T* __restrict__ o, float* __restrict__ lse, View sq,
                  View sk, View sv, View so, int H, int Sq, int Sk, int D,
                  float sm_scale, bool causal, Dropout drop) {
  extern __shared__ float smem[];
  float* q_s = smem;              // [DP][kLd]
  float* k_s = q_s + DP * kLd;    // [DP][kLd]
  float* v_s = k_s + DP * kLd;    // [DP][kLd]
  float* p_s = v_s + DP * kLd;    // [kTile cols][kLd rows]
  constexpr int kDc = DP / 16;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q = at(q, sq, b, h);
  k = at(k, sk, b, h);
  v = at(v, sv, b, h);
  o = at(o, so, b, h);
  lse += (size_t)bh * Sq;
  if (bias != nullptr) bias += (size_t)bh * Sk;

  load_tile_t<T, DP>(q_s, q, sq.r, q0, Sq, D);

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
    load_tile_t<T, DP>(k_s, k, sk.r, k0, Sk, D);
    load_tile_t<T, DP>(v_s, v, sv.r, k0, Sk, D);
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
      if (d < D) o[(long long)row * so.r + d] = from_f32<T>(acc[i][jd] / l_safe);
    }
    if (tx == 0) lse[row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// SIMT dK, dV: one block per (bh, k tile); grid (BH, ceil(Sk / 64)).
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, View sq, View sk, View sv,
                      View sdo, View sdk, View sdv, int H, int Sq, int Sk,
                      int D, float sm_scale, bool causal, Dropout drop) {
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

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q = at(q, sq, b, h);
  dout = at(dout, sdo, b, h);
  k = at(k, sk, b, h);
  v = at(v, sv, b, h);
  dk = at(dk, sdk, b, h);
  dv = at(dv, sdv, b, h);
  lse += (size_t)bh * Sq;
  delta += (size_t)bh * Sq;
  if (bias != nullptr) bias += (size_t)bh * Sk;

  load_tile_t<T, DP>(k_s, k, sk.r, k0, Sk, D);
  load_tile_t<T, DP>(v_s, v, sv.r, k0, Sk, D);

  // this thread's keys are k0 + ty + 16 i; its query rows q0 + tx + 16 j
  float acc_dk[4][kDc], acc_dv[4][kDc];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  // Under the causal mask, q tiles that end before k0 see only masked keys.
  for (int q0 = causal ? k0 : 0; q0 < Sq; q0 += kTile) {
    __syncthreads();  // the previous tiles are consumed
    load_tile_t<T, DP>(q_s, q, sq.r, q0, Sq, D);
    load_tile_t<T, DP>(do_s, dout, sdo.r, q0, Sq, D);
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
        dk[(long long)col * sdk.r + d] = from_f32<T>(acc_dk[i][jd]);
        dv[(long long)col * sdv.r + d] = from_f32<T>(acc_dv[i][jd]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// SIMT dQ: one block per (bh, q tile); grid (BH, ceil(Sq / 64)).
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     View sq, View sk, View sv, View sdo, View sdq, int H,
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

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q = at(q, sq, b, h);
  dout = at(dout, sdo, b, h);
  dq = at(dq, sdq, b, h);
  k = at(k, sk, b, h);
  v = at(v, sv, b, h);
  lse += (size_t)bh * Sq;
  delta += (size_t)bh * Sq;
  if (bias != nullptr) bias += (size_t)bh * Sk;

  load_tile_t<T, DP>(q_s, q, sq.r, q0, Sq, D);
  load_tile_t<T, DP>(do_s, dout, sdo.r, q0, Sq, D);
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
    load_tile_t<T, DP>(k_s, k, sk.r, k0, Sk, D);
    load_tile_t<T, DP>(v_s, v, sv.r, k0, Sk, D);
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
      if (d < D) dq[(long long)row * sdq.r + d] = from_f32<T>(acc[i][jd]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path (bfloat16 forward and dQ): TMA, mbarriers, wgmma.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRowsQ = 64;  // q rows per block: one consumer warpgroup
constexpr int kRowsK = 64;  // keys per K/V tile
constexpr int kStages = 2;  // K/V ring depth
constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr int kCols = 64;   // bf16 columns in one 128-byte swizzled row
constexpr int kPanel = kRowsQ * kCols * 2;  // bytes of a 64-row panel
// Blocks each SM must hold: 3 at head_dim <= 64 caps the registers at 136
// a thread (the dQ kernel would take 164 and fit only 2 an SM; 3 blocks of
// 64 rows were the fastest layout at the trainer's shape), 2 at 128.
template <int NP>
constexpr int kBlocksPerSm = NP == 1 ? 3 : 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked2 = kNegInf * kLog2e;  // -1e30, prescaled

// Shared memory of a block holding NQ q-tile operands (Q; or Q and dO)
// in NP panels each, then the K/V ring, then the barriers: Q full, the
// stages' full, the stages' empty.
template <int NP, int NQ>
struct Layout {
  static constexpr int kStage = 2 * NP * kPanel;  // K panels, V panels
  static constexpr int kQ = NQ * NP * kPanel;
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

struct Params {
  __nv_bfloat16* out;  // o (forward) or dq
  View so;
  float* lse;           // forward: written; dQ: read
  const float* delta;   // dQ only
  const float* bias;
  int H, Sq, Sk, D;
  float sm_scale;
  bool causal;
  Dropout drop;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed. A wait
// that outlasts any copy by orders of magnitude traps (a launch error the
// wrapper raises) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a [B, H, S, D] tensor map at (col, row, h, b) into dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(h), "r"(b)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile whose 128-byte rows are
// consecutive: 8-row groups 1024 bytes apart (SBO), the leading offset
// unused (one swizzle atom spans the k16 step, or N = 64 when N-major).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// K-major operand (64 rows x DP, DP split into 64-column panels) at
// k-step kk (columns 16 kk .. 16 kk + 15).
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * kPanel + (kk & 3) * 32);
}

// N-major B operand: panel p of a 64-key tile, k-step kk (keys 16 kk ..).
__device__ __forceinline__ uint64_t nmajor_desc(const uint8_t* tile, int p,
                                                int kk) {
  return sw128_desc(tile + p * kPanel + kk * 16 * 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keeps A fragments live until the product that reads them has finished.
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" ::"r"(a[kk][r]) : "memory");
}

#define FA_WG_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FA_WG_OUT32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (+)= A B, m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FA_WG_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16, A in registers (the m16n8k16-style fragment of
// each warp's 16 rows), B N-major in shared memory (transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : FA_WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FA_WG_D32
#undef FA_WG_OUT32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of the 4 k-steps of a product over 64 keys, from the
// m64n64 accumulator over those keys, rounded to bf16.
__device__ __forceinline__ void to_a_frags(const float (&s)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// What both kernels share: the block's q tile and the thread's rows in it,
// the shared memory, the barriers, and the producer.
template <int NP, int NQ>
struct Block {
  using L = Layout<NP, NQ>;
  uint8_t* smem;
  uint64_t* q_full;
  uint64_t* full;
  uint64_t* empty;
  int bh, b, h, q0, n_tiles;
  int lane, row[2];  // consumers: lane, the thread's two rows

  __device__ __forceinline__ Block(uint8_t* raw, const Params& p) {
    smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
    full = q_full + 1;
    empty = full + kStages;
    bh = blockIdx.x;
    b = bh / p.H;
    h = bh % p.H;
    // the heaviest causal q tiles (most keys) start first
    q0 = (gridDim.y - 1 - blockIdx.y) * kRowsQ;
    const int k_end = p.causal ? min(p.Sk, q0 + kRowsQ) : p.Sk;
    n_tiles = (k_end + kRowsK - 1) / kRowsK;
    lane = threadIdx.x % 32;
    row[0] = q0 + 16 * (threadIdx.x / 32) + lane / 4;
    row[1] = row[0] + 8;
    if (threadIdx.x == 0) {
      mbar_init(q_full, 1);
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumerWarps);
      }
    }
    __syncthreads();
  }

  __device__ __forceinline__ uint8_t* q_tile(int n) const {
    return smem + n * NP * kPanel;
  }
  __device__ __forceinline__ uint8_t* k_tile(int s) const {
    return smem + L::kQ + s * L::kStage;
  }
  __device__ __forceinline__ uint8_t* v_tile(int s) const {
    return k_tile(s) + NP * kPanel;
  }

  // The producer thread: the q-tile operands once, then K and V tile by
  // tile, each into the stage its consumers have released.
  __device__ __forceinline__ void produce(const CUtensorMap* mq0,
                                          const CUtensorMap* mq1,
                                          const CUtensorMap* mk,
                                          const CUtensorMap* mv) const {
    mbar_expect_tx(q_full, NQ * NP * kPanel);
    for (int n = 0; n < NQ; ++n)
      for (int p = 0; p < NP; ++p)
        tma_load(q_tile(n) + p * kPanel, n == 0 ? mq0 : mq1, q_full,
                 p * kCols, q0, h, b);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], 2 * NP * kPanel);
      for (int p = 0; p < NP; ++p) {
        tma_load(k_tile(s) + p * kPanel, mk, &full[s], p * kCols,
                 it * kRowsK, h, b);
        tma_load(v_tile(s) + p * kPanel, mv, &full[s], p * kCols,
                 it * kRowsK, h, b);
      }
    }
  }

  // Whether the tile at k0 needs masks: the diagonal, the ragged last key
  // tile or the ragged last q tile.
  __device__ __forceinline__ bool edge(const Params& p, int k0) const {
    return (p.causal && k0 + kRowsK - 1 > q0) || k0 + kRowsK > p.Sk ||
           q0 + kRowsQ > p.Sq;
  }

  __device__ __forceinline__ void release(int s) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Writes the thread's rows of an [64 rows, DP] accumulator, times
  // 1 / div[i], as bf16 through the output's strides.
  __device__ __forceinline__ void store(const Params& p,
                                        const float (&acc)[NP][32],
                                        const float (&div)[2]) const {
    __nv_bfloat16* out = at(p.out, p.so, b, h);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= p.Sq) continue;
      __nv_bfloat16* o = out + (long long)row[i] * p.so.r;
#pragma unroll
      for (int np = 0; np < NP; ++np)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = np * kCols + 8 * j + 2 * (lane & 3);
          if (d < p.D)  // D is even, so d + 1 < D too
            *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(
                acc[np][4 * j + 2 * i] / div[i],
                acc[np][4 * j + 2 * i + 1] / div[i]);
        }
    }
  }
};

// Online softmax of the tile at k0 on its raw Q Kᵀ accumulator s: scores
// in log2 units (bias added, masks on edge tiles only), the running max m
// and this thread's part of the row sum l updated (l sums the pre-dropout
// p), alpha = the factor of the old accumulator; s becomes P with dropout
// applied. Every visited tile of a row follows tile 0, which holds its
// live key 0, so m is finite; alpha is 0 on the row's first tile.
template <class Blk>
__device__ __forceinline__ void online_softmax(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const Params& p, const Blk& blk, const float* bias, float scale2,
    int k0) {
  const int lane = blk.lane;
  const bool edge = blk.edge(p, k0);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = k0 + 8 * j + 2 * (lane & 3) + c;
      float bcol = 0.f;
      if (bias != nullptr && col < p.Sk) bcol = bias[col] * kLog2e;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x = fmaf(s[4 * j + 2 * i + c], scale2, bcol);
        if (edge) {
          if (p.causal && col > blk.row[i]) x = kMasked2;
          if (col >= p.Sk) x = -INFINITY;
        }
        s[4 * j + 2 * i + c] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
    const float m_next = fmaxf(m[i], v);
    alpha[i] = exp2f(m[i] - m_next);
    m[i] = m_next;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float pv = exp2f(s[4 * j + 2 * i + c] - m[i]);
        l[i] += pv;
        if (p.drop.on)
          pv *= p.drop.mask(blk.row[i], k0 + 8 * j + 2 * (lane & 3) + c,
                            blk.bh);
        s[4 * j + 2 * i + c] = pv;
      }
}

// o *= alpha, row by row.
template <int NP>
__device__ __forceinline__ void rescale(float (&o)[NP][32],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int np = 0; np < NP; ++np) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[np][4 * j + 2 * i] *= alpha[i];
        o[np][4 * j + 2 * i + 1] *= alpha[i];
      }
    fence_regs(o[np]);
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on tensor cores: grid (BH, ceil(Sq / 64)), kThreads.
// ---------------------------------------------------------------------------
template <int NP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<NP>)
    fa_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const Params p) {
  extern __shared__ uint8_t smem_raw[];
  Block<NP, 1> blk(smem_raw, p);
  if (threadIdx.x >= 32 * kConsumerWarps) {
    if (threadIdx.x == 32 * kConsumerWarps) blk.produce(&mq, &mq, &mk, &mv);
    return;
  }
  const float scale2 = p.sm_scale * kLog2e;
  const float* bias =
      p.bias != nullptr ? p.bias + (size_t)blk.bh * p.Sk : nullptr;
  const uint8_t* q_s = blk.q_tile(0);
  const int lane = blk.lane;

  float o[NP][32];
#pragma unroll
  for (int np = 0; np < NP; ++np)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[np][r] = 0.f;
  float m[2] = {kMasked2, kMasked2}, l[2] = {0.f, 0.f};

  mbar_wait(blk.q_full, 0);
  for (int it = 0; it < blk.n_tiles; ++it) {
    const int st = it % kStages, k0 = it * kRowsK;
    mbar_wait(&blk.full[st], (it / kStages) & 1);
    const uint8_t* k_s = blk.k_tile(st);
    float s[32], alpha[2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk)
      wgmma_ss(s, kmajor_desc(q_s, kk),
               kmajor_desc(k_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    online_softmax(s, m, l, alpha, p, blk, bias, scale2, k0);
    uint32_t pa[4][4];
    to_a_frags(s, pa);
    rescale(o, alpha);

    // O += P V
    const uint8_t* v_s = blk.v_tile(st);
    wgmma_fence();
#pragma unroll
    for (int np = 0; np < NP; ++np)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[np], pa[kk], nmajor_desc(v_s, np, kk));
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs(pa);
#pragma unroll
    for (int np = 0; np < NP; ++np) fence_regs(o[np]);
    blk.release(st);
  }

  float l_safe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    l_safe[i] = l[i] == 0.f ? 1.f : l[i];
  }
  blk.store(p, o, l_safe);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (blk.row[i] < p.Sq)
        p.lse[(size_t)blk.bh * p.Sq + blk.row[i]] =
            m[i] * kLn2 + logf(l_safe[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ on tensor cores: grid (BH, ceil(Sq / 64)), kThreads.
// ---------------------------------------------------------------------------
template <int NP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<NP>)
    fa_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mdo,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const Params p) {
  extern __shared__ uint8_t smem_raw[];
  Block<NP, 2> blk(smem_raw, p);
  if (threadIdx.x >= 32 * kConsumerWarps) {
    if (threadIdx.x == 32 * kConsumerWarps) blk.produce(&mq, &mdo, &mk, &mv);
    return;
  }
  const float scale2 = p.sm_scale * kLog2e;
  const float* bias =
      p.bias != nullptr ? p.bias + (size_t)blk.bh * p.Sk : nullptr;
  const uint8_t* q_s = blk.q_tile(0);
  const uint8_t* do_s = blk.q_tile(1);
  const int lane = blk.lane;

  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = blk.row[i] < p.Sq;
    const size_t at_row = (size_t)blk.bh * p.Sq + blk.row[i];
    lse2[i] = in ? p.lse[at_row] * kLog2e : 0.f;
    dlt[i] = in ? p.delta[at_row] : 0.f;
  }
  float dq[NP][32];
#pragma unroll
  for (int np = 0; np < NP; ++np)
#pragma unroll
    for (int r = 0; r < 32; ++r) dq[np][r] = 0.f;

  mbar_wait(blk.q_full, 0);
  for (int it = 0; it < blk.n_tiles; ++it) {
    const int st = it % kStages, k0 = it * kRowsK;
    mbar_wait(&blk.full[st], (it / kStages) & 1);
    const uint8_t* k_s = blk.k_tile(st);
    const uint8_t* v_s = blk.v_tile(st);
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk)
      wgmma_ss(s, kmajor_desc(q_s, kk),
               kmajor_desc(k_s, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk)
      wgmma_ss(dp, kmajor_desc(do_s, kk),
               kmajor_desc(v_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS = P∘(dP∘M - delta)·sm_scale with P = exp(S - lse)
    const bool edge = blk.edge(p, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = k0 + 8 * j + 2 * (lane & 3) + c;
        float bcol = 0.f;
        if (bias != nullptr && col < p.Sk) bcol = bias[col] * kLog2e;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * j + 2 * i + c;
          float x = fmaf(s[r], scale2, bcol);
          bool live = true;
          if (edge) {
            if (p.causal && col > blk.row[i]) x = kMasked2;
            live = col < p.Sk && blk.row[i] < p.Sq;
          }
          float dpm = dp[r];
          if (p.drop.on) dpm *= p.drop.mask(blk.row[i], col, blk.bh);
          s[r] = live ? exp2f(x - lse2[i]) * (dpm - dlt[i]) * p.sm_scale
                      : 0.f;
        }
      }
    uint32_t dsa[4][4];
    to_a_frags(s, dsa);
#pragma unroll
    for (int np = 0; np < NP; ++np) fence_regs(dq[np]);

    // dQ += dS K
    wgmma_fence();
#pragma unroll
    for (int np = 0; np < NP; ++np)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dq[np], dsa[kk], nmajor_desc(k_s, np, kk));
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs(dsa);
#pragma unroll
    for (int np = 0; np < NP; ++np) fence_regs(dq[np]);
    blk.release(st);
  }
  const float one[2] = {1.f, 1.f};
  blk.store(p, dq, one);
}

}  // namespace tc

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  int B, H, Sq, Sk, D;
  float sm_scale;
  bool causal;
  Dropout drop;
  cudaStream_t stream;
};

// `st` holds each operand's (batch, head, row) element strides in turn.
View view(const long long* st, int n) {
  return View{st[3 * n], st[3 * n + 1], st[3 * n + 2]};
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A TMA map over a bf16 [B, H, S, D] view with strides v: boxes of 64
// columns (128 bytes, swizzled) by `rows` rows; out-of-range reads as 0.
cudaError_t bf16_map(CUtensorMap* map, const void* ptr, const Args& a, int S,
                     const View& v, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)a.D, (cuuint64_t)S,
                              (cuuint64_t)a.H, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)v.r * 2, (cuuint64_t)v.h * 2,
                                 (cuuint64_t)v.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)tc::kCols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

tc::Params tc_params(const Args& a, void* out, const View& so, void* lse,
                     const void* delta, const void* bias) {
  return tc::Params{static_cast<__nv_bfloat16*>(out),
                    so,
                    static_cast<float*>(lse),
                    static_cast<const float*>(delta),
                    static_cast<const float*>(bias),
                    a.H,
                    a.Sq,
                    a.Sk,
                    a.D,
                    a.sm_scale,
                    a.causal,
                    a.drop};
}

template <int NP>
cudaError_t launch_fwd_tc(const Args& a, const void* q, const void* k,
                          const void* v, const void* bias, void* o, void* lse,
                          const long long* st) {
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = bf16_map(&mq, q, a, a.Sq, view(st, 0), tc::kRowsQ)) ||
      (e = bf16_map(&mk, k, a, a.Sk, view(st, 1), tc::kRowsK)) ||
      (e = bf16_map(&mv, v, a, a.Sk, view(st, 2), tc::kRowsK)))
    return e;
  constexpr size_t smem = tc::Layout<NP, 1>::kBytes;
  auto kernel = tc::fa_fwd_tc_kernel<NP>;
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;

  kernel<<<dim3(a.B * a.H, (a.Sq + tc::kRowsQ - 1) / tc::kRowsQ),
           tc::kThreads, smem, a.stream>>>(
      mq, mk, mv, tc_params(a, o, view(st, 3), lse, nullptr, bias));
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_dq_tc(const Args& a, const void* q, const void* k,
                         const void* v, const void* bias, const void* dout,
                         const void* lse, const void* delta, void* dq,
                         const long long* st) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = bf16_map(&mq, q, a, a.Sq, view(st, 0), tc::kRowsQ)) ||
      (e = bf16_map(&mk, k, a, a.Sk, view(st, 1), tc::kRowsK)) ||
      (e = bf16_map(&mv, v, a, a.Sk, view(st, 2), tc::kRowsK)) ||
      (e = bf16_map(&mdo, dout, a, a.Sq, view(st, 3), tc::kRowsQ)))
    return e;
  constexpr size_t smem = tc::Layout<NP, 2>::kBytes;
  auto kernel = tc::fa_bwd_dq_tc_kernel<NP>;
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;

  kernel<<<dim3(a.B * a.H, (a.Sq + tc::kRowsQ - 1) / tc::kRowsQ),
           tc::kThreads, smem, a.stream>>>(
      mq, mdo, mk, mv,
      tc_params(a, dq, view(st, 4), const_cast<void*>(lse), delta, bias));
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_fwd(const Args& a, const void* q, const void* k,
                       const void* v, const void* bias, void* o, void* lse,
                       const long long* st) {
  const size_t smem = sizeof(float) * (3 * DP + kTile) * kLd;
  auto kernel = fa_fwd_kernel<T, DP>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.B * a.H, (a.Sq + kTile - 1) / kTile), kThreads, smem,
           a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), view(st, 0), view(st, 1),
      view(st, 2), view(st, 3), a.H, a.Sq, a.Sk, a.D, a.sm_scale, a.causal,
      a.drop);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const Args& a, const void* q, const void* k,
                       const void* v, const void* bias, const void* dout,
                       const void* lse, const void* delta, void* dk,
                       void* dv, const long long* st) {
  const size_t smem = sizeof(float) * ((4 * DP + 2 * kTile) * kLd + 2 * kTile);
  auto kernel = fa_bwd_dkv_kernel<T, DP>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.B * a.H, (a.Sk + kTile - 1) / kTile), kThreads, smem,
           a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), view(st, 0), view(st, 1), view(st, 2),
      view(st, 3), view(st, 4), view(st, 5), a.H, a.Sq, a.Sk, a.D,
      a.sm_scale, a.causal, a.drop);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq(const Args& a, const void* q, const void* k,
                      const void* v, const void* bias, const void* dout,
                      const void* lse, const void* delta, void* dq,
                      const long long* st) {
  const size_t smem = sizeof(float) * ((4 * DP + kTile) * kLd + 2 * kTile);
  auto kernel = fa_bwd_dq_kernel<T, DP>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.B * a.H, (a.Sq + kTile - 1) / kTile), kThreads, smem,
           a.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), view(st, 0),
      view(st, 1), view(st, 2), view(st, 3), view(st, 4), a.H, a.Sq, a.Sk,
      a.D, a.sm_scale, a.causal, a.drop);
  return cudaGetLastError();
}

// Validates the sizes; returns cudaSuccess and fills `a` when they hold.
// The tensor-core kernels need an even head_dim (the wrapper pads it to a
// multiple of 8, which TMA's 16-byte strides need anyway).
cudaError_t make_args(Args* a, int dtype, int causal, int dropout, int B,
                      int H, int Sq, int Sk, int D, float sm_scale, int seed,
                      uint32_t thresh, float keep_scale, void* stream) {
  if (dtype < 0 || dtype > 1 || B < 0 || H <= 0 || Sq < 0 || Sk <= 0 ||
      D <= 0 || D > kMaxD || (dtype == 1 && D % 8 != 0) ||
      (Sq + kTile - 1) / kTile > 65535 || (Sk + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  a->B = B;
  a->H = H;
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
// min(int(p * 2^32), 2^32 - 1) and float32(1 / (1 - p)). `strides` holds
// the (batch, head, row) element strides of each [B, H, S, D] operand in
// the order of the pointer arguments, outputs last. Each function returns
// the cudaError_t of its launch (0 = launched). bfloat16 forward and dQ
// launch the tensor-core kernels, everything else the SIMT kernels; there
// is no fallback from one to the other.
extern "C" int fa_forward(int dtype, int causal, int dropout, int B, int H,
                          int Sq, int Sk, int D, float sm_scale, int seed,
                          uint32_t thresh, float keep_scale, const void* q,
                          const void* k, const void* v, const void* bias,
                          void* o, void* lse, const long long* strides,
                          void* stream) {
  Args a;
  const cudaError_t e = make_args(&a, dtype, causal, dropout, B, H, Sq, Sk, D,
                                  sm_scale, seed, thresh, keep_scale, stream);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || Sq == 0) return 0;
  if (dtype == 1)
    return (int)(D <= 64 ? launch_fwd_tc<1>(a, q, k, v, bias, o, lse, strides)
                         : launch_fwd_tc<2>(a, q, k, v, bias, o, lse, strides));
  return (int)(D <= 64
                   ? launch_fwd<float, 64>(a, q, k, v, bias, o, lse, strides)
                   : launch_fwd<float, 128>(a, q, k, v, bias, o, lse, strides));
}

extern "C" int fa_bwd_dkv(int dtype, int causal, int dropout, int B, int H,
                          int Sq, int Sk, int D, float sm_scale, int seed,
                          uint32_t thresh, float keep_scale, const void* q,
                          const void* k, const void* v, const void* bias,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv,
                          const long long* strides, void* stream) {
  Args a;
  const cudaError_t e = make_args(&a, dtype, causal, dropout, B, H, Sq, Sk, D,
                                  sm_scale, seed, thresh, keep_scale, stream);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
#define FA_DKV(T, DP) \
  launch_dkv<T, DP>(a, q, k, v, bias, dout, lse, delta, dk, dv, strides)
  if (dtype == 0)
    return (int)(D <= 64 ? FA_DKV(float, 64) : FA_DKV(float, 128));
  return (int)(D <= 64 ? FA_DKV(__nv_bfloat16, 64)
                       : FA_DKV(__nv_bfloat16, 128));
#undef FA_DKV
}

extern "C" int fa_bwd_dq(int dtype, int causal, int dropout, int B, int H,
                         int Sq, int Sk, int D, float sm_scale, int seed,
                         uint32_t thresh, float keep_scale, const void* q,
                         const void* k, const void* v, const void* bias,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, const long long* strides, void* stream) {
  Args a;
  const cudaError_t e = make_args(&a, dtype, causal, dropout, B, H, Sq, Sk, D,
                                  sm_scale, seed, thresh, keep_scale, stream);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || Sq == 0) return 0;
#define FA_DQ(KERNEL) \
  KERNEL(a, q, k, v, bias, dout, lse, delta, dq, strides)
  if (dtype == 1)
    return (int)(D <= 64 ? FA_DQ(launch_dq_tc<1>) : FA_DQ(launch_dq_tc<2>));
  return (int)(D <= 64 ? FA_DQ((launch_dq<float, 64>))
                       : FA_DQ((launch_dq<float, 128>)));
#undef FA_DQ
}

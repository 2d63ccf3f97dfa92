// Ragged paged attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_rpa_kernel` / `_rpa_kernel_quant`
// (paddle_tpu/ops/pallas/ragged_paged_attention.py, launched by
// `_rpa_call_impl`). It computes the same function: attention for a
// mixed prefill + decode batch through per-sequence block tables.
//
//   q            [S, Q, Hq, D] float32
//   k/v_pages    [P, page_size, Hkv, D] float32 | bfloat16 | float16 | int8
//   k/v_scale    [P, page_size] float32, per-slot dequant scales (int8 only)
//   block_tables [S, pages_per_seq] int32
//   context_lens [S] int32, q_lens [S] int32
//   out          [S, Q, Hq, D] float32
//
// Query head hq = h * G + g reads kv head h (G = Hq / Hkv). Packed row
// r = g * Q + i of (sequence s, kv head h) is valid iff i < q_lens[s];
// its absolute position is ctx - q_len + i and it attends every key at a
// position <= its own. Rows that are not valid, and rows that attend
// nothing, are written as exact zeros.
//
// Design. The TPU kernel walks a sequential grid axis over pages and keeps
// (m, l, acc) in VMEM scratch across grid steps. Blocks on Hopper run in
// no order, so here one block owns (s, h, kRows packed rows) and loops
// over the pages itself: grid (S, Hkv, ceil(G * Q / kRows)). The block
// reads its own block table, context length and query length from global
// memory (the TPU kernel's scalar prefetch). Each live page's K and V
// tiles for kv head h are staged into shared memory as float32 (int8
// slots multiplied by their scale right after the load), with the next
// page's 16-byte loads issued before the block computes on the current
// page, so their latency is hidden behind the arithmetic; every warp
// runs the online softmax for its rows in float32 with the reference's
// -1e30 mask constant, zeroing p while the running max is still -1e30.
// The loop stops at the last page that holds a key some row of the block
// attends: the pages past it contribute exactly nothing (alpha = 1,
// p = 0), so skipping them changes no bit. No work is split by anything
// but the row itself, so a row's result does not depend on how the batch
// was packed (the serving engine's batched == sequential contract).
//
// Bound. Decode is memory-bound: the least time is the bytes of the live
// K/V pages (plus q and out) over 3.35 TB/s. This first version uses
// float32 FMAs from shared memory and no tensor cores. A block still
// walks its sequence's pages one after another, so a decode call is bound
// by that chain's latency; a page split for long contexts, TMA staging
// and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // packed q rows per block
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;
constexpr float kNegInf = -1e30f;  // the reference's mask constant
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxVecs = 4;  // 16-byte loads in flight per thread per tensor

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// Element e of a 16-byte vector holding 16 / sizeof(T) values of type T.
template <typename T>
__device__ __forceinline__ float vec_elem(const uint4& v, int e) {
  return to_f32(reinterpret_cast<const T*>(&v)[e]);
}

// Stages the K and V tiles of one page (all slots, kv head h) into shared
// memory as float32. The fast form reads 16 bytes per load into
// registers: `issue` starts the loads of a page (and its int8 scales),
// `store` converts and writes them, so the next page's loads are in
// flight while the block computes on the current one. Tiles whose rows
// are not whole aligned 16-byte vectors, or that need more than kMaxVecs
// loads a thread, take the scalar form, which loads and stores in one pass.
template <typename T, bool kQuant>
struct TileLoader {
  static constexpr int N = 16 / sizeof(T);  // values per vector
  const T* k_pages;
  const T* v_pages;
  const float* k_scale;
  const float* v_scale;
  int Hkv, h, D, page_size;
  bool vec;
  int n_vec;  // vectors per tile
  uint4 kr[kMaxVecs], vr[kMaxVecs];
  float ksr[kMaxVecs], vsr[kMaxVecs];

  __device__ TileLoader(const T* kp, const T* vp, const float* ks,
                        const float* vs, int Hkv_, int h_, int D_, int ps)
      : k_pages(kp), v_pages(vp), k_scale(ks), v_scale(vs), Hkv(Hkv_),
        h(h_), D(D_), page_size(ps) {
    n_vec = page_size * D / N;
    vec = D % N == 0 && n_vec <= kMaxVecs * (int)blockDim.x &&
          reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  }

  __device__ size_t row(size_t page, int t) const {
    return ((page * page_size + t) * Hkv + h) * (size_t)D;
  }

  __device__ void issue(size_t page) {
    if (!vec) return;
#pragma unroll
    for (int u = 0; u < kMaxVecs; ++u) {
      const int v = threadIdx.x + u * blockDim.x;
      if (v < n_vec) {
        const int t = v / (D / N), c = v % (D / N);
        const size_t off = row(page, t) + (size_t)c * N;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(k_pages + off));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(v_pages + off));
        if (kQuant) {
          ksr[u] = __ldg(k_scale + page * page_size + t);
          vsr[u] = __ldg(v_scale + page * page_size + t);
        }
      }
    }
  }

  __device__ void store(size_t page, float* k_s, float* v_s) {
    const int k_stride = D + 1;
    if (vec) {
#pragma unroll
      for (int u = 0; u < kMaxVecs; ++u) {
        const int v = threadIdx.x + u * blockDim.x;
        if (v < n_vec) {
          const int t = v / (D / N), d0 = (v % (D / N)) * N;
          const float ks = kQuant ? ksr[u] : 1.f;
          const float vs = kQuant ? vsr[u] : 1.f;
#pragma unroll
          for (int e = 0; e < N; ++e) {
            float kv = vec_elem<T>(kr[u], e), vv = vec_elem<T>(vr[u], e);
            if (kQuant) {
              kv *= ks;
              vv *= vs;
            }
            k_s[t * k_stride + d0 + e] = kv;
            v_s[t * D + d0 + e] = vv;
          }
        }
      }
      return;
    }
    for (int idx = threadIdx.x; idx < page_size * D; idx += blockDim.x) {
      const int t = idx / D, d = idx % D;
      const size_t off = row(page, t) + d;
      float kv = to_f32(k_pages[off]);
      float vv = to_f32(v_pages[off]);
      if (kQuant) {
        kv *= k_scale[page * page_size + t];
        vv *= v_scale[page * page_size + t];
      }
      k_s[t * k_stride + d] = kv;
      v_s[t * D + d] = vv;
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T, bool kQuant>
__global__ void __launch_bounds__(kWarps * 32)
    rpa_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
               const T* __restrict__ v_pages,
               const float* __restrict__ k_scale,
               const float* __restrict__ v_scale,
               const int* __restrict__ block_tables,
               const int* __restrict__ context_lens,
               const int* __restrict__ q_lens, float* __restrict__ out, int Q,
               int Hq, int Hkv, int D, int page_size, int pages_per_seq,
               float sm_scale) {
  extern __shared__ float smem[];
  const int k_stride = D + 1;  // odd stride: lanes read distinct banks
  float* k_s = smem;                         // [page_size][D + 1]
  float* v_s = k_s + page_size * k_stride;   // [page_size][D]
  float* q_s = v_s + page_size * D;          // [kRows][D]

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int GQ = G * Q;
  const int row0 = blockIdx.z * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ctx = context_lens[s];
  const int qlen = q_lens[s];

  for (int idx = threadIdx.x; idx < kRows * D; idx += blockDim.x) {
    const int row = row0 + idx / D;
    float val = 0.f;
    if (row < GQ) {
      const int g = row / Q, i = row % Q;
      val = q[((size_t)(s * Q + i) * Hq + h * G + g) * D + idx % D];
    }
    q_s[idx] = val;
  }

  // Pages to visit: those below the context that hold a key at or before
  // the largest position among the block's valid rows.
  int max_qpos = -1;
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row < GQ && row % Q < qlen) max_qpos = max(max_qpos, ctx - qlen + row % Q);
  }
  int n_pages = 0;
  if (max_qpos >= 0) {
    n_pages = min((ctx + page_size - 1) / page_size, max_qpos / page_size + 1);
    n_pages = min(n_pages, pages_per_seq);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[rr][c] = 0.f;
  }

  const int* table = block_tables + (size_t)s * pages_per_seq;
  TileLoader<T, kQuant> tiles(k_pages, v_pages, k_scale, v_scale, Hkv, h, D,
                              page_size);
  if (n_pages > 0) tiles.issue((size_t)table[0]);
  for (int j = 0; j < n_pages; ++j) {
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    tiles.store((size_t)table[j], k_s, v_s);
    if (j + 1 < n_pages) tiles.issue((size_t)table[j + 1]);
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      const int row = row0 + r;
      const int i = row % Q;
      if (row >= GQ || i >= qlen) continue;  // uniform across the warp
      const int qpos = ctx - qlen + i;
      const float* qr = q_s + r * D;
      for (int t0 = 0; t0 < page_size; t0 += 32) {
        const int t = t0 + lane;
        float sc = kNegInf;
        if (t < page_size && j * page_size + t <= qpos) {
          float dot = 0.f;
          const float* kr = k_s + t * k_stride;
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          sc = dot * sm_scale;
        }
        const float m_next = fmaxf(m[rr], warp_max(sc));
        const float p =
            (m_next == kNegInf || t >= page_size) ? 0.f : expf(sc - m_next);
        const float alpha = expf(m[rr] - m_next);
        l[rr] = alpha * l[rr] + warp_sum(p);
        m[rr] = m_next;
#pragma unroll
        for (int c = 0; c < kDPerLane; ++c) acc[rr][c] *= alpha;
        const int nt = min(32, page_size - t0);
        for (int u = 0; u < nt; ++u) {
          const float pu = __shfl_sync(kFull, p, u);
          const float* vr = v_s + (t0 + u) * D;
#pragma unroll
          for (int c = 0; c < kDPerLane; ++c) {
            const int d = lane + 32 * c;
            if (d < D) acc[rr][c] = fmaf(pu, vr[d], acc[rr][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp + rr * kWarps;
    if (row >= GQ) continue;
    const int g = row / Q, i = row % Q;
    const float denom = (l[rr] == 0.f) ? 1.f : l[rr];
    float* o = out + ((size_t)(s * Q + i) * Hq + h * G + g) * D;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = (i < qlen) ? acc[rr][c] / denom : 0.f;
    }
  }
}

template <typename T, bool kQuant>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scale, const void* v_scale,
                   const void* block_tables, const void* context_lens,
                   const void* q_lens, void* out, int S, int Q, int Hq,
                   int Hkv, int D, int page_size, int pages_per_seq,
                   float sm_scale, cudaStream_t stream) {
  const int GQ = (Hq / Hkv) * Q;
  const dim3 grid(S, Hkv, (GQ + kRows - 1) / kRows);
  const size_t smem =
      sizeof(float) * ((size_t)page_size * (D + 1) + (size_t)page_size * D +
                       (size_t)kRows * D);
  auto kernel = rpa_kernel<T, kQuant>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<const int*>(q_lens),
      static_cast<float*>(out), Q, Hq, Hkv, D, page_size, pages_per_seq,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// page_kind: 0 float32, 1 bfloat16, 2 float16, 3 int8 with scales.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int rpa_forward(int page_kind, const void* q, const void* k_pages,
                           const void* v_pages, const void* k_scale,
                           const void* v_scale, const void* block_tables,
                           const void* context_lens, const void* q_lens,
                           void* out, int S, int Q, int Hq, int Hkv, int D,
                           int page_size, int pages_per_seq, float sm_scale,
                           void* stream) {
  if (S == 0 || Q == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > kMaxD || page_size <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPA_LAUNCH(T, QUANT)                                                  \
  launch<T, QUANT>(q, k_pages, v_pages, k_scale, v_scale, block_tables,     \
                   context_lens, q_lens, out, S, Q, Hq, Hkv, D, page_size,  \
                   pages_per_seq, sm_scale, st)
  switch (page_kind) {
    case 0: return (int)RPA_LAUNCH(float, false);
    case 1: return (int)RPA_LAUNCH(__nv_bfloat16, false);
    case 2: return (int)RPA_LAUNCH(__half, false);
    case 3: return (int)RPA_LAUNCH(int8_t, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RPA_LAUNCH
}

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
// Design: split over pages (flash-decoding). The TPU kernel walks a
// sequential grid axis over pages and carries (m, l, acc) in VMEM scratch.
// On Hopper a block that walks a sequence's pages one after another is
// bound by the latency of that chain, and a decode batch gives too few
// blocks to fill 132 SMs. So every sequence's key positions are cut into
// fixed chunks of kChunk = 128 positions (8 pages of 16 slots), and one
// block owns (s, h, a tile of up to kTileRows = 32 packed rows, one chunk):
// grid (S * Hkv * row tiles, chunks), from the call's static shapes, so
// the host never reads the context lengths. A chunk wholly past the tile's
// last attended position is skipped. A second small kernel merges each
// row's chunk partials (m, l, acc) in chunk order; it is launched as a
// programmatic dependent of the first, so its launch overlaps the first's
// run.
//
// In a block (128 threads, one a key position of the chunk):
// 1. the lengths and each thread's page (through the block table) are read
//    together; each row's position goes to shared memory, and a block whose
//    rows attend nothing of the chunk stops here;
// 2. each thread copies its key's K and V slot rows into shared memory with
//    `cp.async` (16 bytes a copy; rows padded by 16 bytes, so the reads
//    below are free of bank conflicts) as two commit groups, so the scores
//    start when K has landed while V is still in flight, and the q tile's
//    loads overlap both. Slots past the tile's last attended position are
//    zero-filled, not read;
// 3. scores: thread t computes the dot products of key t with the rows of
//    the tile, RG rows at a time in registers (independent FMA chains; RG
//    is 1, 4 or 8 as the packed rows allow), from its key's row of K
//    (converted to float32 as read; int8 times its slot's scale) and the
//    rows of q (broadcast reads); groups of rows of which none attends the
//    chunk are skipped;
// 4. the chunk's softmax, a warp four rows at a time: m = max over the 128
//    keys (the reference's -1e30 mask constant; p zeroed while m is -1e30),
//    p = exp(s - m), l = sum p;
// 5. P V: warp w owns keys 32 w .. 32 w + 31 and a lane the columns
//    d = lane + 32 c; the four warps' sums are added in a fixed order.
// The arithmetic of a row is fixed by its own position and the chunk's:
// every dot product is one float32 FMA chain over d; the row sum takes
// lane partials over keys {lane + 32 j} in order, then a butterfly over
// the lanes; P V is a chain over each warp's 32 keys in order, then
// (w0 + w1) + (w2 + w3); the merge visits chunks 0, 1, ... in order. No
// part of it depends on the other rows of the tile, the batch, the table's
// width or the number of SMs, so a row's result does not depend on how the
// batch was packed (the serving engine's batched == sequential contract),
// and two runs are bit-equal. Skipping a chunk or a zero-filled slot that
// no row attends changes no bit: its p is exactly 0.
//
// Why 32-row tiles: at the serving prefill shape (S 4, Q 64) they took
// the call from 0.055 to 0.042 ms on an H100 against 64-row tiles (more
// blocks an SM hide more latency); 16 rows were no faster. The tiling
// changes no bit of a row's result.
//
// Bound. Decode is memory-bound: the least time is the bytes of the live
// K/V slots (plus q and out) over 3.35 TB/s; what holds a call back is
// the latency of the table, page and partial round trips, which the split
// spreads over several hundred blocks, and each block's copies, which it
// waits for before computing. Arithmetic stays float32 SIMT, which keeps
// the result within 1e-6 of the plain version: decode does about 7 and
// prefill about 60 MFLOP a call.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;       // key positions a block; one thread each
constexpr int kThreads = kChunk;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = kChunk / kWarps;  // keys of one warp's P V chain
constexpr int kTileRows = 32;  // packed rows a block, at most
constexpr int kRowGroup = 8;  // rows a thread keeps in registers
constexpr int kMaxD = 128;
constexpr int kMaxDLanes = kMaxD / 32;  // P V columns a lane, at most
constexpr int kPPitch = kChunk + 4;     // floats a row of the score tile
constexpr float kNegInf = -1e30f;       // the reference's mask constant
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// Element e of a 16-byte unit of T held in four 32-bit words, as float32
// (e is a constant after unrolling, so the unit stays in registers).
template <typename T>
__device__ __forceinline__ float unit_elem(const uint32_t (&w)[4], int e);
template <>
__device__ __forceinline__ float unit_elem<float>(const uint32_t (&w)[4],
                                                  int e) {
  return __uint_as_float(w[e]);
}
template <>
__device__ __forceinline__ float unit_elem<__nv_bfloat16>(
    const uint32_t (&w)[4], int e) {
  return __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
}
template <>
__device__ __forceinline__ float unit_elem<__half>(const uint32_t (&w)[4],
                                                   int e) {
  return __half2float(
      __ushort_as_half((unsigned short)(w[e / 2] >> (16 * (e % 2)))));
}
template <>
__device__ __forceinline__ float unit_elem<int8_t>(const uint32_t (&w)[4],
                                                   int e) {
  return (float)(int8_t)(w[e / 4] >> (8 * (e % 4)));
}

template <int B>
struct Bits;
template <>
struct Bits<1> {
  using type = uint8_t;
};
template <>
struct Bits<2> {
  using type = uint16_t;
};
template <>
struct Bits<4> {
  using type = uint32_t;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; `bytes` 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes likewise (`bytes` 0 or 4).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The call's geometry, computed once on the host.
struct Geo {
  int S, Q, Hq, Hkv, G, GQ, D;
  int DP;      // D rounded up to whole 16-byte units of the page type
  int pitch;   // bytes of a staged slot row: DP elements, then 16 bytes
  int page_size, pps, kvmax, n_chunks;
  int rg;      // rows computed together: 1, 4 or kRowGroup
  int tile_rows, row_tiles;
  int vec;     // slots copied with cp.async (else synchronous loads)
  int qvec;    // q rows copied 16 bytes at a time (else 4)
  float sm_scale;
};

// Shared memory of a block, in bytes from its start.
struct Smem {
  int vs, qpos, wmax, k, v, q, p, g, m, l, bytes;
  __host__ __device__ explicit Smem(const Geo& g_) {
    vs = 0;                                        // float [kChunk]
    qpos = vs + kChunk * 4;                        // int [kTileRows]
    wmax = qpos + kTileRows * 4;                   // int [kWarps], padded
    k = wmax + 16 * 4;                             // [kChunk][pitch]
    v = k + kChunk * g_.pitch;                     // [kChunk][pitch]
    q = v + kChunk * g_.pitch;                     // float [tile][DP]
    p = q + g_.tile_rows * g_.DP * 4;              // float [tile][kPPitch]
    g = p + g_.tile_rows * kPPitch * 4;            // float [rg][kWarps][DP]
    m = g + g_.rg * kWarps * g_.DP * 4;            // float [tile]
    l = m + g_.tile_rows * 4;                      // float [tile]
    bytes = l + g_.tile_rows * 4;
  }
};

// Whether a group of RG rows from r0 holds a row that attends the chunk at
// pos0; the others' results are never read.
template <int RG>
__device__ __forceinline__ bool group_live(const int* qpos_s, int r0,
                                           int nrows, int pos0) {
  bool any = false;
#pragma unroll
  for (int rr = 0; rr < RG; ++rr)
    any |= r0 + rr < nrows && qpos_s[r0 + rr] >= pos0;
  return any;
}

// The chunk's partial attention (m, l, acc) of the rows of one (s, h, row
// tile) that attend it. NC: P V columns a lane (DP <= 32 NC); RG: rows
// computed together (the tile's rows are a multiple of RG).
template <typename T, bool kQuant, int NC, int RG>
__global__ void __launch_bounds__(kThreads)
    rpa_chunk_kernel(const float* __restrict__ q,
                     const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ block_tables,
                     const int* __restrict__ context_lens,
                     const int* __restrict__ q_lens,
                     float* __restrict__ part_acc,
                     float* __restrict__ part_ml, const Geo g) {
  constexpr int N = 16 / sizeof(T);  // elements a 16-byte unit
  using B = typename Bits<sizeof(T)>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  const Smem L(g);
  float* vs_s = reinterpret_cast<float*>(smem + L.vs);
  int* qpos_s = reinterpret_cast<int*>(smem + L.qpos);
  int* wmax_s = reinterpret_cast<int*>(smem + L.wmax);
  uint8_t* k_s = smem + L.k;
  uint8_t* v_s = smem + L.v;
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* g_s = reinterpret_cast<float*>(smem + L.g);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);

  const int rt = blockIdx.x % g.row_tiles;
  const int h = (blockIdx.x / g.row_tiles) % g.Hkv;
  const int s = blockIdx.x / (g.row_tiles * g.Hkv);
  const int pos0 = blockIdx.y * kChunk;
  const int row0 = rt * g.tile_rows;
  const int nrows = min(g.tile_rows, g.GQ - row0);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int pos = pos0 + t;  // this thread's key position
  // the merge kernel may be scheduled now; it waits for this grid's results
  asm volatile("griddepcontrol.launch_dependents;");

  // 1. the lengths and this key's page, read together (the page whatever
  // the lengths say); each row's position, -1 where it is not valid; the
  // largest of them
  const int ctx = context_lens[s];
  const int qlen = q_lens[s];
  const long long page =
      pos < g.kvmax ? block_tables[(size_t)s * g.pps + pos / g.page_size] : 0;
  int qpos = -1;
  if (t < nrows) {
    const int i = (row0 + t) % g.Q;
    if (i < qlen) qpos = ctx - qlen + i;
  }
  if (t < g.tile_rows) qpos_s[t] = qpos;
  qpos = __reduce_max_sync(kFull, qpos);
  if (lane == 0) wmax_s[warp] = qpos;
  __syncthreads();
  const int max_qpos =
      max(max(wmax_s[0], wmax_s[1]), max(wmax_s[2], wmax_s[3]));
  if (pos0 > max_qpos) return;  // no row of the tile attends this chunk

  // 2. copy this key's K and V slot rows (zeros past the last attended
  // position or the table), and load the q tile
  const bool live = pos <= max_qpos && pos < g.kvmax;
  const long long slot = page * g.page_size + pos % g.page_size;
  const long long off = live ? (slot * g.Hkv + h) * g.D : 0;
  const int units = g.DP / N;  // 16-byte units a slot
  if (g.vec) {
    for (int u = 0; u < units; ++u)
      cp_async16(k_s + t * g.pitch + u * 16, k_pages + off + u * N,
                 live ? 16 : 0);
  } else {  // slots not 16-byte aligned: element by element, zero-padded
    const B* kb = reinterpret_cast<const B*>(k_pages) + off;
    const B* vb = reinterpret_cast<const B*>(v_pages) + off;
    B* kd = reinterpret_cast<B*>(k_s + t * g.pitch);
    B* vd = reinterpret_cast<B*>(v_s + t * g.pitch);
#pragma unroll 8
    for (int d = 0; d < g.DP; ++d) {
      const bool in = live && d < g.D;
      kd[d] = in ? kb[d] : B(0);
      vd[d] = in ? vb[d] : B(0);
    }
  }
  // the q tile: 4 floats a copy where rows are 16-byte aligned, else one;
  // rows past the tile and columns past D are zeros
  const int qw = g.qvec ? 4 : 1;
  for (int idx = t; idx < g.tile_rows * (g.DP / qw); idx += kThreads) {
    const int r = idx / (g.DP / qw), d = idx % (g.DP / qw) * qw;
    const int row = row0 + r;
    const bool in = r < nrows && d < g.D;
    const float* src =
        in ? q + ((size_t)(s * g.Q + row % g.Q) * g.Hq + h * g.G + row / g.Q) *
                     g.D +
                 d
           : q;
    if (g.qvec)
      cp_async16(q_s + r * g.DP + d, src, in ? 16 : 0);
    else
      cp_async4(q_s + r * g.DP + d, src, in ? 4 : 0);
  }
  cp_async_commit();  // K and q
  if (g.vec)
    for (int u = 0; u < units; ++u)
      cp_async16(v_s + t * g.pitch + u * 16, v_pages + off + u * N,
                 live ? 16 : 0);
  cp_async_commit();  // V
  float kscale = 1.f;
  if (kQuant) {
    kscale = live ? k_scale[slot] : 0.f;
    vs_s[t] = live ? v_scale[slot] : 0.f;
  }
  cp_async_wait<1>();  // this thread's K row and q copies have landed
  __syncthreads();

  // 3. scores of key t against the rows: one FMA chain over d a row
  {
    const uint8_t* krow = k_s + t * g.pitch;
    for (int r0 = 0; r0 < nrows; r0 += RG) {
      if (!group_live<RG>(qpos_s, r0, nrows, pos0)) continue;
      float acc[RG];
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) acc[rr] = 0.f;
      const float4* q4 = reinterpret_cast<const float4*>(q_s + r0 * g.DP);
#pragma unroll 2
      for (int u = 0; u < units; ++u) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + u * 16);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
        float kv[N];
#pragma unroll
        for (int e = 0; e < N; ++e) {
          kv[e] = unit_elem<T>(w, e);
          if (kQuant) kv[e] *= kscale;
        }
#pragma unroll
        for (int e4 = 0; e4 < N / 4; ++e4) {
          float4 qv[RG];
#pragma unroll
          for (int rr = 0; rr < RG; ++rr)
            qv[rr] = q4[(rr * g.DP + u * N) / 4 + e4];
#pragma unroll
          for (int rr = 0; rr < RG; ++rr) {
            acc[rr] = fmaf(qv[rr].x, kv[4 * e4], acc[rr]);
            acc[rr] = fmaf(qv[rr].y, kv[4 * e4 + 1], acc[rr]);
            acc[rr] = fmaf(qv[rr].z, kv[4 * e4 + 2], acc[rr]);
            acc[rr] = fmaf(qv[rr].w, kv[4 * e4 + 3], acc[rr]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < RG; ++rr)
        p_s[(r0 + rr) * kPPitch + t] =
            pos <= qpos_s[r0 + rr] && pos < g.kvmax ? acc[rr] * g.sm_scale
                                                    : kNegInf;
    }
  }
  __syncthreads();

  // 4. the chunk's softmax: a warp takes four rows at a time
  for (int rb = warp; rb < nrows; rb += 4 * kWarps) {
    float sv[4][kChunk / 32], mx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rb + j * kWarps;
      const bool on = r < nrows && qpos_s[r] >= pos0;
      mx[j] = kNegInf;
#pragma unroll
      for (int c = 0; c < kChunk / 32; ++c) {
        sv[j][c] = on ? p_s[r * kPPitch + lane + 32 * c] : kNegInf;
        mx[j] = fmaxf(mx[j], sv[j][c]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(kFull, mx[j], o));
    float part[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      part[j] = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk / 32; ++c) {
        sv[j][c] = mx[j] == kNegInf ? 0.f : expf(sv[j][c] - mx[j]);
        part[j] += sv[j][c];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[j] += __shfl_xor_sync(kFull, part[j], o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rb + j * kWarps;
      if (r >= nrows || qpos_s[r] < pos0) continue;
#pragma unroll
      for (int c = 0; c < kChunk / 32; ++c)
        p_s[r * kPPitch + lane + 32 * c] = sv[j][c];
      if (lane == 0) {
        m_s[r] = mx[j];
        l_s[r] = part[j];
      }
    }
  }
  cp_async_wait<0>();  // this thread's V row has landed
  __syncthreads();

  // 5. P V: warp w's keys, a lane's columns; then the warps in order
  const int kb = warp * kGroup;
  for (int r0 = 0; r0 < nrows; r0 += RG) {
    if (!group_live<RG>(qpos_s, r0, nrows, pos0)) continue;
    float acc[RG][NC];
#pragma unroll
    for (int rr = 0; rr < RG; ++rr)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[rr][cc] = 0.f;
#pragma unroll 4
    for (int k4 = 0; k4 < kGroup; k4 += 4) {
      float4 p4[RG];
#pragma unroll
      for (int rr = 0; rr < RG; ++rr)
        p4[rr] = *reinterpret_cast<const float4*>(
            p_s + (r0 + rr) * kPPitch + kb + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int key = kb + k4 + kk;
        const T* vrow = reinterpret_cast<const T*>(v_s + key * g.pitch);
        float vv[NC];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int d = lane + 32 * cc;
          vv[cc] = d < g.DP ? to_f32(vrow[d]) : 0.f;
          if (kQuant) vv[cc] *= vs_s[key];
        }
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          const float pk = kk == 0   ? p4[rr].x
                           : kk == 1 ? p4[rr].y
                           : kk == 2 ? p4[rr].z
                                     : p4[rr].w;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc)
            acc[rr][cc] = fmaf(pk, vv[cc], acc[rr][cc]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RG; ++rr)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int d = lane + 32 * cc;
        if (d < g.DP) g_s[(rr * kWarps + warp) * g.DP + d] = acc[rr][cc];
      }
    __syncthreads();
    const int rows = min(RG, nrows - r0);
    for (int idx = t; idx < rows * g.D; idx += kThreads) {
      const int rr = idx / g.D, d = idx % g.D, r = r0 + rr;
      if (qpos_s[r] < pos0) continue;  // never read by the merge
      const float* gp = g_s + rr * kWarps * g.DP + d;
      const size_t at =
          ((size_t)(s * g.Hkv + h) * g.GQ + row0 + r) * g.n_chunks +
          blockIdx.y;
      part_acc[at * g.D + d] =
          (gp[0] + gp[g.DP]) + (gp[2 * g.DP] + gp[3 * g.DP]);
      if (d == 0) {
        part_ml[2 * at] = m_s[r];
        part_ml[2 * at + 1] = l_s[r];
      }
    }
    __syncthreads();
  }
}

// Merges each output row's chunk partials, chunk 0 first: a warp a row
// (s, i, hq), a lane the columns d = lane + 32 c.
__global__ void __launch_bounds__(kThreads)
    rpa_merge_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml,
                     const int* __restrict__ context_lens,
                     const int* __restrict__ q_lens, float* __restrict__ out,
                     const Geo g) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= g.S * g.Q * g.Hq) return;
  const int hq = w % g.Hq, i = (w / g.Hq) % g.Q, s = w / (g.Hq * g.Q);
  const int h = hq / g.G, row = (hq % g.G) * g.Q + i;
  const int qlen = q_lens[s];
  const int qpos = context_lens[s] - qlen + i;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the partials
  // the chunks the row attends, each computed by its tile's block
  int n = 0;
  if (i < qlen && qpos >= 0)
    n = min(g.n_chunks, min(qpos, g.kvmax - 1) / kChunk + 1);
  const size_t at = ((size_t)(s * g.Hkv + h) * g.GQ + row) * g.n_chunks;
  const float* ml = part_ml + 2 * at;
  float M = kNegInf;
#pragma unroll 4
  for (int c = 0; c < n; ++c) M = fmaxf(M, ml[2 * c]);
  float L = 0.f, O[kMaxDLanes] = {};
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    const float wc = expf(ml[2 * c] - M);
    L = fmaf(wc, ml[2 * c + 1], L);
    const float* acc = part_acc + (at + c) * g.D;
#pragma unroll
    for (int cc = 0; cc < kMaxDLanes; ++cc) {
      const int d = lane + 32 * cc;
      if (d < g.D) O[cc] = fmaf(wc, acc[d], O[cc]);
    }
  }
  const float den = L == 0.f ? 1.f : L;
  float* o = out + ((size_t)(s * g.Q + i) * g.Hq + hq) * g.D;
#pragma unroll
  for (int cc = 0; cc < kMaxDLanes; ++cc) {
    const int d = lane + 32 * cc;
    if (d < g.D) o[d] = O[cc] / den;
  }
}

// Fills `g` for a call; false when the kernel cannot take it.
template <typename T>
bool make_geo(Geo* g, int S, int Q, int Hq, int Hkv, int D, int page_size,
              int pps, float sm_scale) {
  constexpr int N = 16 / sizeof(T);
  if (S <= 0 || Q <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > kMaxD || page_size <= 0 || pps <= 0)
    return false;
  g->S = S;
  g->Q = Q;
  g->Hq = Hq;
  g->Hkv = Hkv;
  g->G = Hq / Hkv;
  g->GQ = g->G * Q;
  g->D = D;
  g->DP = (D + N - 1) / N * N;
  g->pitch = g->DP * (int)sizeof(T) + 16;
  g->page_size = page_size;
  g->pps = pps;
  const long long kvmax = (long long)page_size * pps;
  g->n_chunks = (int)((kvmax + kChunk - 1) / kChunk);
  if (kvmax > (1ll << 30) || g->n_chunks > 65535) return false;
  g->kvmax = (int)kvmax;
  g->rg = g->GQ == 1 ? 1 : g->GQ <= 4 ? 4 : kRowGroup;
  g->tile_rows = min(kTileRows, (g->GQ + g->rg - 1) / g->rg * g->rg);
  g->row_tiles = (g->GQ + g->tile_rows - 1) / g->tile_rows;
  g->vec = g->DP == D && (Hkv * D * (int)sizeof(T)) % 16 == 0;
  g->sm_scale = sm_scale;
  return true;
}

template <typename T, bool kQuant, int NC>
auto chunk_kernel_rg(int rg) {
  return rg == 1   ? rpa_chunk_kernel<T, kQuant, NC, 1>
         : rg == 4 ? rpa_chunk_kernel<T, kQuant, NC, 4>
                   : rpa_chunk_kernel<T, kQuant, NC, kRowGroup>;
}

template <typename T, bool kQuant>
auto chunk_kernel(const Geo& g) {
  return g.DP <= 64 ? chunk_kernel_rg<T, kQuant, 2>(g.rg)
                    : chunk_kernel_rg<T, kQuant, 4>(g.rg);
}

template <typename T, bool kQuant>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scale, const void* v_scale,
                   const void* block_tables, const void* context_lens,
                   const void* q_lens, void* out, void* workspace, Geo g,
                   cudaStream_t stream) {
  g.vec = g.vec && reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  g.qvec = g.D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const size_t smem = Smem(g).bytes;
  auto kernel = chunk_kernel<T, kQuant>(g);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  float* part_acc = static_cast<float*>(workspace);
  float* part_ml =
      part_acc + (size_t)g.S * g.Hkv * g.GQ * g.n_chunks * g.D;
  kernel<<<dim3(g.S * g.Hkv * g.row_tiles, g.n_chunks), kThreads, smem,
           stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<const int*>(q_lens),
      part_acc, part_ml, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // programmatic dependent launch: the merge's launch overlaps the chunk
  // kernel, and the merge waits for its results (griddepcontrol.wait)
  const int rows = g.S * g.Q * g.Hq;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rpa_merge_kernel,
                            static_cast<const float*>(part_acc),
                            static_cast<const float*>(part_ml),
                            static_cast<const int*>(context_lens),
                            static_cast<const int*>(q_lens),
                            static_cast<float*>(out), g);
}

bool any_geo(int page_kind, Geo* g, int S, int Q, int Hq, int Hkv, int D,
             int page_size, int pps, float sm_scale) {
  switch (page_kind) {
    case 0: return make_geo<float>(g, S, Q, Hq, Hkv, D, page_size, pps,
                                   sm_scale);
    case 1: return make_geo<__nv_bfloat16>(g, S, Q, Hq, Hkv, D, page_size,
                                           pps, sm_scale);
    case 2: return make_geo<__half>(g, S, Q, Hq, Hkv, D, page_size, pps,
                                    sm_scale);
    case 3: return make_geo<int8_t>(g, S, Q, Hq, Hkv, D, page_size, pps,
                                    sm_scale);
    default: return false;
  }
}

}  // namespace

// page_kind: 0 float32, 1 bfloat16, 2 float16, 3 int8 with scales.
// The float32 elements of workspace a call needs (the chunk partials: acc,
// then m and l), or -1 when the kernel cannot take the call.
extern "C" long long rpa_workspace_floats(int page_kind, int S, int Q, int Hq,
                                          int Hkv, int D, int page_size,
                                          int pages_per_seq) {
  if (S == 0 || Q == 0) return 0;
  Geo g;
  if (!any_geo(page_kind, &g, S, Q, Hq, Hkv, D, page_size, pages_per_seq,
               1.f))
    return -1;
  return (long long)S * Hkv * g.GQ * g.n_chunks * (D + 2);
}

// Returns the cudaError_t of the launches (0 = launched). `workspace`
// holds rpa_workspace_floats(...) float32 elements.
extern "C" int rpa_forward(int page_kind, const void* q, const void* k_pages,
                           const void* v_pages, const void* k_scale,
                           const void* v_scale, const void* block_tables,
                           const void* context_lens, const void* q_lens,
                           void* out, void* workspace, int S, int Q, int Hq,
                           int Hkv, int D, int page_size, int pages_per_seq,
                           float sm_scale, void* stream) {
  if (S == 0 || Q == 0) return 0;
  Geo g;
  if (!any_geo(page_kind, &g, S, Q, Hq, Hkv, D, page_size, pages_per_seq,
               sm_scale))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPA_LAUNCH(T, QUANT)                                                \
  launch<T, QUANT>(q, k_pages, v_pages, k_scale, v_scale, block_tables,   \
                   context_lens, q_lens, out, workspace, g, st)
  switch (page_kind) {
    case 0: return (int)RPA_LAUNCH(float, false);
    case 1: return (int)RPA_LAUNCH(__nv_bfloat16, false);
    case 2: return (int)RPA_LAUNCH(__half, false);
    case 3: return (int)RPA_LAUNCH(int8_t, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RPA_LAUNCH
}

// Flash-decode for NVIDIA Hopper (sm_90a), hand-written CUDA C++: one query
// token per slot against a dense or a paged KV cache, GQA, online softmax.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_decode.py:
//  * flash_decode (pallas_call at :163, body _decode_kernel :61-102): the
//    dense cache (B, S, K, D), validity from k_positions (-1 = invalid);
//  * flash_decode_paged (pallas_call at :354, body _paged_kernel :262-305):
//    a page pool (P, page_size, K, D) read through a page table
//    (B, pages_per_slot), -1 = unbound; a key's position is
//    page_idx * page_size + offset.
// Their plain PyTorch versions are repro_torch/kernels/flash_decode.py::
// flash_decode_ref and flash_decode_paged_ref (transcriptions of the
// reference's flash_decode_xla and flash_decode_paged_xla).
//
// What it computes, per slot b and query head hq = kh * G + g:
//   out[b, 0, hq] = sum_j p_j v[j, kh] / sum_j p_j,
//   p_j = exp(scale * q.k[j, kh] - max), over the keys j whose position kp
//   satisfies kp >= 0, kp <= q_pos[b] and, with a window, kp > q_pos - window.
// A slot with no such key writes exact zeros (l = 0 gives acc / 1e-37 = 0).
// Softmax statistics and the (G, Dv) accumulator stay in float32; the
// output is in q's type. Unlike the Pallas kernel, p is not rounded to the
// value type before the p.V product (the XLA twin does not round it either).
//
// What bounds it on this card: the bytes of valid K and V it reads, at
// 3.35 TB/s; the operations (4 * G * D per key) are far below the bf16 or
// fp32 rates at G <= 8. At the serving main path's sizes (gemma3-1b: 8
// slots, one KV head, 512 ring keys or ~700 paged keys of 256 dims) that is
// a few MB, about a microsecond of bandwidth, so launch latency and the
// serial walk over key tiles inside each of only B * K = 8 blocks rule.
//
// What the design does about it:
//  * One block per (KV head, slot): the whole GQA group of G query heads
//    rides in one block, so each K/V row is read from memory once for all
//    G heads (the TPU kernel's (G, D) tile). K and V are read in place
//    through their strides: no transposed copy of the cache.
//  * A loop inside the block walks key tiles of BLOCK_N keys (the TPU
//    grid's sequential kv axis). Each tile's K and V rows are staged in
//    shared memory with 16-byte loads where the layout allows; only valid
//    rows are read (the others are zero-filled), so bytes read are the
//    valid bytes.
//  * A tile with no valid key is skipped (pl.when(jnp.any(mask))). The dense
//    kernel with `bounded` (contiguous caches, slot index == position) and
//    the paged kernel (position == logical index by construction) stop at
//    the tile that holds q_pos, so work scales with occupancy, not capacity.
//  * p is masked explicitly: in a tile whose keys are all invalid the
//    running max would stay at NEG_INF and exp(NEG_INF - NEG_INF) = 1.
//  * Paged: each block reads its own page-table row (no scalar prefetch);
//    unbound entries are masked and never dereferenced.
// Not done here, left for later work: splitting each slot's key range over
// several blocks with a log-sum-exp merge (B * K = 8 blocks leave most of
// the 132 SMs idle at the main path's sizes), and cp.async/TMA staging
// that overlaps the next tile's loads with this tile's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK_N = 32;  // keys per tile: one per lane in the softmax
constexpr int MAX_G = 8;     // query heads per KV head
constexpr int MAX_D = 256;   // head dim of K and of V
constexpr int DV_PER_THREAD = MAX_D / THREADS;
constexpr float NEG_INF = -1e30f;
static_assert(BLOCK_N == 32, "the softmax puts one key on each lane");
static_assert(MAX_D % THREADS == 0, "each thread owns whole V columns");

struct Params {
  const void* q;      // (B, 1, K * G, Dk), contiguous
  const void* k;      // dense (B, S, K, Dk) | paged (P, page_size, K, Dk)
  const void* v;      // the same with Dv
  const int* q_pos;   // (B,)
  const int* k_pos;   // dense: (B, S), contiguous, -1 = invalid
  const int* table;   // paged: (B, n_pages), contiguous, -1 = unbound
  void* out;          // (B, 1, K * G, Dv), contiguous
  int S;              // keys per slot (paged: n_pages * page_size)
  int K, G, Dk, Dv;
  int page_size, n_pages;
  long long k_s0, k_s1, k_s2;  // element strides of k's first three axes
  long long v_s0, v_s1, v_s2;
  float scale;
  int window;   // <= 0: no window
  int bounded;  // dense: stop at the tile that holds q_pos
  int vec;      // rows may be read with 16-byte loads
};

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Dynamic shared memory: K tile, V tile (element type), q (fp32), scores /
// probabilities, per-key row offsets and validity, and the per-head m, l
// and correction of the online softmax.
struct Layout {
  size_t k, v, q, sc, koff, voff, valid, m, l, corr, total;
};

__host__ __device__ inline Layout layout(int elem, int G, int Dk, int Dv) {
  Layout L;
  size_t o = 0;
  L.k = o;     o = up16(o + static_cast<size_t>(BLOCK_N) * Dk * elem);
  L.v = o;     o = up16(o + static_cast<size_t>(BLOCK_N) * Dv * elem);
  L.q = o;     o = up16(o + static_cast<size_t>(G) * Dk * 4);
  L.sc = o;    o = up16(o + static_cast<size_t>(G) * BLOCK_N * 4);
  L.koff = o;  o += BLOCK_N * 8;
  L.voff = o;  o += BLOCK_N * 8;
  L.valid = o; o += BLOCK_N * 4;
  L.m = o;     o += MAX_G * 4;
  L.l = o;     o += MAX_G * 4;
  L.corr = o;  o += MAX_G * 4;
  L.total = up16(o);
  return L;
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Stage BLOCK_N rows of D elements; invalid rows are zero-filled, not read.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          const long long* off,
                                          const int* valid, int D, int vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = D / E;
    for (int i = threadIdx.x; i < BLOCK_N * per_row; i += THREADS) {
      const int n = i / per_row;
      const int c = i - n * per_row;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (valid[n])
        val = *reinterpret_cast<const uint4*>(src + off[n] + c * E);
      *reinterpret_cast<uint4*>(dst + n * D + c * E) = val;
    }
  } else {
    for (int i = threadIdx.x; i < BLOCK_N * D; i += THREADS) {
      const int n = i / D;
      const int d = i - n * D;
      dst[i] = valid[n] ? src[off[n] + d] : from_f<T>(0.0f);
    }
  }
}

template <typename T, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_kernel(Params p) {
  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // slot
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = p.G, Dk = p.Dk, Dv = p.Dv, S = p.S;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(sizeof(T), G, Dk, Dv);
  T* k_s = reinterpret_cast<T*>(smem + L.k);
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* sc_s = reinterpret_cast<float*>(smem + L.sc);
  long long* koff_s = reinterpret_cast<long long*>(smem + L.koff);
  long long* voff_s = reinterpret_cast<long long*>(smem + L.voff);
  int* valid_s = reinterpret_cast<int*>(smem + L.valid);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* corr_s = reinterpret_cast<float*>(smem + L.corr);

  const int qp = p.q_pos[b];
  const long long head0 = static_cast<long long>(b) * p.K * G +
                          static_cast<long long>(h) * G;
  const T* qg = static_cast<const T*>(p.q) + head0 * Dk;
  for (int i = tid; i < G * Dk; i += THREADS) q_s[i] = to_f(qg[i]);
  if (tid < MAX_G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
    corr_s[tid] = 0.0f;
  }
  float acc[MAX_G][DV_PER_THREAD];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int j = 0; j < DV_PER_THREAD; ++j) acc[g][j] = 0.0f;
  __syncthreads();

  int n_tiles = (S + BLOCK_N - 1) / BLOCK_N;
  if (PAGED || p.bounded) {
    const int live = qp < 0 ? 0 : qp / BLOCK_N + 1;
    n_tiles = min(n_tiles, live);
  }
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  for (int t = 0; t < n_tiles; ++t) {
    // 1. positions, validity and row offsets of this tile's keys
    int ok = 0;
    if (tid < BLOCK_N) {
      const int n = t * BLOCK_N + tid;
      int kp = -1;
      long long ko = 0, vo = 0;
      if (n < S) {
        if (PAGED) {
          const int page =
              p.table[static_cast<long long>(b) * p.n_pages + n / p.page_size];
          if (page >= 0) {
            const long long off = n % p.page_size;
            kp = n;
            ko = page * p.k_s0 + off * p.k_s1 + h * p.k_s2;
            vo = page * p.v_s0 + off * p.v_s1 + h * p.v_s2;
          }
        } else {
          kp = p.k_pos[static_cast<long long>(b) * S + n];
          ko = b * p.k_s0 + static_cast<long long>(n) * p.k_s1 + h * p.k_s2;
          vo = b * p.v_s0 + static_cast<long long>(n) * p.v_s1 + h * p.v_s2;
        }
      }
      ok = kp >= 0 && kp <= qp && (p.window <= 0 || kp > qp - p.window);
      valid_s[tid] = ok;
      koff_s[tid] = ko;
      voff_s[tid] = vo;
    }
    if (!__syncthreads_or(ok)) continue;  // no valid key: skip the tile

    // 2. stage the valid K and V rows
    load_rows<T>(k_s, kg, koff_s, valid_s, Dk, p.vec);
    load_rows<T>(v_s, vg, voff_s, valid_s, Dv, p.vec);
    __syncthreads();

    // 3. scores: one warp per key, lanes across the head dim
    for (int n = warp; n < BLOCK_N; n += WARPS) {
      if (!valid_s[n]) {
        if (lane < G) sc_s[lane * BLOCK_N + n] = NEG_INF;
        continue;
      }
      float part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0.0f;
      const T* kr = k_s + n * Dk;
      for (int d = lane; d < Dk; d += 32) {
        const float kv = to_f(kr[d]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) part[g] += q_s[g * Dk + d] * kv;
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const float s = warp_sum(part[g]);
          if (lane == 0) sc_s[g * BLOCK_N + n] = s * p.scale;
        }
      }
    }
    __syncthreads();

    // 4. online softmax, one warp per query head, one lane per key
    for (int g = warp; g < G; g += WARPS) {
      const float s = sc_s[g * BLOCK_N + lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float pr = valid_s[lane] ? expf(s - m_new) : 0.0f;
      const float psum = warp_sum(pr);
      sc_s[g * BLOCK_N + lane] = pr;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 5. acc = acc * corr + p . V, each thread owning DV_PER_THREAD columns
#pragma unroll
    for (int j = 0; j < DV_PER_THREAD; ++j) {
      const int d = tid + j * THREADS;
      if (d < Dv) {
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) acc[g][j] *= corr_s[g];
        for (int n = 0; n < BLOCK_N; ++n) {
          const float vv = to_f(v_s[n * Dv + d]);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) acc[g][j] += sc_s[g * BLOCK_N + n] * vv;
        }
      }
    }
    // the next tile's __syncthreads_or orders these reads before its loads
  }

  T* og = static_cast<T*>(p.out) + head0 * Dv;
#pragma unroll
  for (int j = 0; j < DV_PER_THREAD; ++j) {
    const int d = tid + j * THREADS;
    if (d < Dv) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) og[g * Dv + d] = from_f<T>(acc[g][j] / fmaxf(l_s[g], 1e-37f));
    }
  }
}

template <typename T, bool PAGED>
int launch(const Params& p, int B, void* stream) {
  const size_t smem = layout(sizeof(T), p.G, p.Dk, p.Dv).total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(p.K, B);
  decode_kernel<T, PAGED><<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int B, int S, int K, int G, int Dk, int Dv) {
  return B >= 1 && B <= 65535 && S >= 1 && K >= 1 &&
         G >= 1 && G <= MAX_G && Dk >= 1 && Dk <= MAX_D && Dv >= 1 &&
         Dv <= MAX_D;
}

template <bool PAGED>
int dispatch(int dtype, const Params& p, int B, void* stream) {
  if (dtype == 0) return launch<float, PAGED>(p, B, stream);
  if (dtype == 1) return launch<__nv_bfloat16, PAGED>(p, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out share it). Strides are in
// elements; the last axis of k and v is contiguous. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int flash_decode_launch(
    int dtype, const void* q, const void* k, const void* v, const int* q_pos,
    const int* k_pos, void* out, int B, int S, int K, int G, int Dk, int Dv,
    long long k_s0, long long k_s1, long long k_s2, long long v_s0,
    long long v_s1, long long v_s2, float scale, int window, int bounded,
    int vec, void* stream) {
  if (!shape_ok(B, S, K, G, Dk, Dv))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {q, k, v, q_pos, k_pos, nullptr, out, S, K, G, Dk, Dv, 0, 0,
              k_s0, k_s1, k_s2, v_s0, v_s1, v_s2, scale, window, bounded, vec};
  return dispatch<false>(dtype, p, B, stream);
}

extern "C" int flash_decode_paged_launch(
    int dtype, const void* q, const void* pool_k, const void* pool_v,
    const int* q_pos, const int* table, void* out, int B, int K, int G,
    int Dk, int Dv, int page_size, int n_pages, long long k_s0,
    long long k_s1, long long k_s2, long long v_s0, long long v_s1,
    long long v_s2, float scale, int window, int vec, void* stream) {
  if (page_size < 1 || n_pages < 1 ||
      static_cast<long long>(page_size) * n_pages > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = page_size * n_pages;
  if (!shape_ok(B, S, K, G, Dk, Dv))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {q, pool_k, pool_v, q_pos, nullptr, table, out, S, K, G, Dk,
              Dv, page_size, n_pages, k_s0, k_s1, k_s2, v_s0, v_s1, v_s2,
              scale, window, 1, vec};
  return dispatch<true>(dtype, p, B, stream);
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

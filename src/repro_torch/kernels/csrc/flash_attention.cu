// Flash attention (forward) for NVIDIA Hopper (sm_90a), hand-written CUDA
// C++: whole-sequence GQA attention, causal, sliding-window or
// bidirectional, with online softmax.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
// flash_attention (pallas_call at :119, body _flash_kernel :27-81). Its plain
// PyTorch version is repro_torch/kernels/flash_attention.py::
// flash_attention_plain, which is the model's own chunked_attention.
//
// What it computes, per batch row b, query position i (absolute position
// qp = q_offset + i) and query head h (KV head kh = h / G):
//   out[b, i, h] = sum_j p_j v[b, j, kh] / sum_j p_j,
//   p_j = exp(scale * q[b, i, h] . k[b, j, kh] - max), scale = 1/sqrt(D),
//   over the keys j < Sk with j <= qp when causal and j > qp - window when
//   a window is given.
// Scores, the running max, the running sum and the (rows, D) accumulator are
// float32 (q and k are widened to float32 before the products, as the
// Pallas kernel does); p is rounded to the value type before the p.V
// product, as the model's chunked_attention does (p.to(v.dtype)), while the
// running sum adds the unrounded p. A query with no valid key writes exact
// zeros (p is masked explicitly, l = 0 gives acc / 1e-37 = 0); the Pallas
// kernel and chunked_attention give an average over masked keys there.
//
// What bounds it on this card: the operations. At the training main path's
// shape (gemma3-1b global layer: B = 2, S = 4096, H = 4, K = 1, D = 256,
// causal) the two products over the live (query, key) pairs are 68.7 GFLOP
// against 42 MB of Q, K, V and O: ~69 us at the bf16 tensor-core rate,
// ~13 us of bandwidth. A local layer (window 512) is about 17 us of
// operations. This kernel does those operations as float32 FMAs on shared
// memory tiles (67 TFLOP/s peak outside the tensor cores), so it cannot come
// within 15x of that bound; tensor cores (mma.sync / wgmma on bf16 tiles)
// and TMA staging are left for later work.
//
// What the design does:
//  * One block per (q tile, KV head, batch row). A block holds ROWS = 64
//    query rows: block_m = 64 / G positions times the whole GQA group of G
//    query heads of its KV head, so each K/V tile is read once for all G
//    heads (the TPU kernel reads it once per query head).
//  * A loop inside the block walks key tiles of BN keys (the TPU grid's
//    sequential kv axis). Tiles that no (query, key) pair of the block needs
//    are never visited (the Pallas `live` predicate, :44-53): with causal
//    masking the loop stops at the tile of the block's last query, and with
//    a window it starts at the tile of its first query's first key, so a
//    local layer does O(S * window) work.
//  * Q, K and V are read in place through their strides (16-byte loads
//    when the layout allows) and widened to float32 in shared memory, rows
//    padded by 16 bytes so the products read shared memory without bank
//    conflicts. The ragged ends of Sq and Sk are masked in the kernel, never
//    padded with copies.
//  * Both products run as register micro-tiles: each of 256 threads owns 4
//    query rows x BN/16 keys of the scores and 4 rows x D/64 float4 column
//    groups of the accumulator; one warp per 8 rows does the softmax.
//  * Fixed summation order and no atomics: two runs are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 64;               // query rows (position, head) a block
constexpr int TX = 16, TY = 16;        // thread grid of the two products
constexpr int RPT = ROWS / TY;         // rows per thread
constexpr int ROWS_PER_WARP = ROWS / WARPS;
static_assert(TX * TY == THREADS, "16 x 16 threads");

struct Params {
  const void* q;     // (B, Sq, H, D), last axis contiguous
  const void* k;     // (B, Sk, K, D), last axis contiguous
  const void* v;     // (B, Sk, K, D), last axis contiguous
  void* out;         // (B, Sq, H, D), contiguous
  int B, Sq, Sk, H, K, G;
  int block_m;       // query positions a block: ROWS / G
  long long q_s0, q_s1, q_s2;   // element strides of the first three axes
  long long k_s0, k_s1, k_s2;
  long long v_s0, v_s1, v_s2;
  float scale;
  int causal;
  int window;        // <= 0: no window
  int q_offset;      // absolute position of query 0
  int vec;           // rows may be read with 16-byte loads
};

template <int D>
struct Shape {
  static constexpr int BN = D > 128 ? 32 : 64;  // keys a tile
  static constexpr int JN = BN / TX;            // score columns a thread
  static constexpr int DS = D + 4;              // fp32 row stride, Q/K/V tiles
  static constexpr int PS = BN + 16;            // row stride of the score tile
  static constexpr int NG = D / 4;              // float4 groups a row
  static constexpr int CG = (NG + TX - 1) / TX; // groups a thread in p.V
  static constexpr size_t SMEM =
      sizeof(float) * (static_cast<size_t>(ROWS) * DS +
                       2 * static_cast<size_t>(BN) * DS +
                       static_cast<size_t>(ROWS) * PS + 2 * ROWS);
  static_assert(D % 16 == 0, "head dims are multiples of 16");
};

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

// Stage `rows` rows of D elements into float32 shared memory (row stride
// D + 4). off(r) is the element offset of row r in src, or -1 for a row
// outside the tensor, which is zero-filled and not read.
template <typename T, int D, typename RowOff>
__device__ __forceinline__ void stage(float* dst, const T* src, int rows,
                                      RowOff off, int vec) {
  constexpr int DS = Shape<D>::DS;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int PER = D / E;
    for (int i = threadIdx.x; i < rows * PER; i += THREADS) {
      const int r = i / PER;
      const int c = (i - r * PER) * E;
      const long long o = off(r);
      float* d = dst + r * DS + c;
      if (o < 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) d[e] = 0.0f;
        continue;
      }
      const uint4 raw = *reinterpret_cast<const uint4*>(src + o + c);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = to_f(x[e]);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += THREADS) {
      const int r = i / D;
      const int c = i - r * D;
      const long long o = off(r);
      dst[r * DS + c] = o < 0 ? 0.0f : to_f(src[o + c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_kernel(Params p) {
  using S = Shape<D>;
  constexpr int BN = S::BN, JN = S::JN, DS = S::DS, PS = S::PS;
  constexpr int NG = S::NG, CG = S::CG;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // (ROWS, DS)
  float* k_s = q_s + ROWS * DS;       // (BN, DS)
  float* v_s = k_s + BN * DS;         // (BN, DS)
  float* p_s = v_s + BN * DS;         // (ROWS, PS): scores, then p
  float* corr_s = p_s + ROWS * PS;    // (ROWS,)
  float* l_s = corr_s + ROWS;         // (ROWS,)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int G = p.G;
  const int q0 = blockIdx.x * p.block_m;  // first query of the tile
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_pos = min(p.block_m, p.Sq - q0);
  const int n_rows = n_pos * G;           // valid rows of the tile

  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  // row r of the block is query position q0 + r / G, head kh * G + r % G
  stage<T, D>(q_s, qg, ROWS, [&](int r) -> long long {
    if (r >= n_rows) return -1;
    return b * p.q_s0 + static_cast<long long>(q0 + r / G) * p.q_s1 +
           static_cast<long long>(kh * G + r % G) * p.q_s2;
  }, p.vec);

  int row_pos[RPT];
  bool row_ok[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TY * i;
    row_ok[i] = r < n_rows;
    row_pos[i] = p.q_offset + q0 + r / G;
  }

  // the key tiles that some (query, key) pair of this block needs
  const int q_lo = p.q_offset + q0;
  const int q_hi = p.q_offset + q0 + n_pos - 1;
  int t_begin = 0;
  int t_end = (p.Sk + BN - 1) / BN;
  if (p.causal) t_end = min(t_end, q_hi / BN + 1);
  if (p.window > 0) t_begin = max(0, q_lo - p.window + 1) / BN;

  float m_run[ROWS_PER_WARP], l_run[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
  }
  float acc[RPT][CG][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the last tile's readers of k_s, v_s, p_s are done
    stage<T, D>(k_s, kg, BN, [&](int r) -> long long {
      const int n = k0 + r;
      if (n >= p.Sk) return -1;
      return b * p.k_s0 + static_cast<long long>(n) * p.k_s1 + kh * p.k_s2;
    }, p.vec);
    stage<T, D>(v_s, vg, BN, [&](int r) -> long long {
      const int n = k0 + r;
      if (n >= p.Sk) return -1;
      return b * p.v_s0 + static_cast<long long>(n) * p.v_s1 + kh * p.v_s2;
    }, p.vec);
    __syncthreads();

    // 1. scores: rows ty + 16 i, keys tx + 16 j
    float sc[RPT][JN];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RPT], kv[JN];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + TY * i) * DS + d);
#pragma unroll
      for (int j = 0; j < JN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + TX * j) * DS + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          float s = sc[i][j];
          s = fmaf(qv[i].x, kv[j].x, s);
          s = fmaf(qv[i].y, kv[j].y, s);
          s = fmaf(qv[i].z, kv[j].z, s);
          s = fmaf(qv[i].w, kv[j].w, s);
          sc[i][j] = s;
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int kp = k0 + tx + TX * j;
        const int qp = row_pos[i];
        const bool ok = row_ok[i] && kp < p.Sk && (!p.causal || kp <= qp) &&
                        (p.window <= 0 || kp > qp - p.window);
        p_s[(ty + TY * i) * PS + tx + TX * j] = ok ? sc[i][j] * p.scale
                                                   : -INFINITY;
      }
    __syncthreads();

    // 2. online softmax: warp w owns rows 8 w .. 8 w + 7
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      float s[BN / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        s[c] = p_s[r * PS + lane + 32 * c];
        mx = fmaxf(mx, s[c]);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m_run[i], mx);
      // a row that has seen no valid key keeps m = -inf, corr 1, p 0
      const float corr = m_new == -INFINITY ? 1.0f : expf(m_run[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        const float pr = s[c] == -INFINITY ? 0.0f : expf(s[c] - m_new);
        sum += pr;
        p_s[r * PS + lane + 32 * c] = to_f(from_f<T>(pr));
      }
      sum = warp_sum(sum);
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
      if (lane == 0) corr_s[r] = corr;
    }
    __syncthreads();

    // 3. acc = acc * corr + p . V: rows ty + 16 i, float4 groups tx + 16 g
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float c = corr_s[ty + TY * i];
#pragma unroll
      for (int g = 0; g < CG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= c;
    }
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pr[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = p_s[(ty + TY * i) * PS + n];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const int grp = tx + TX * g;
        if (grp < NG) {
          const float4 vv =
              *reinterpret_cast<const float4*>(v_s + n * DS + grp * 4);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            acc[i][g][0] = fmaf(pr[i], vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(pr[i], vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(pr[i], vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(pr[i], vv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i)
      l_s[warp * ROWS_PER_WARP + i] = l_run[i];
  }
  __syncthreads();

  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TY * i;
    if (r >= n_rows) continue;
    const float l = fmaxf(l_s[r], 1e-37f);
    T* o = og + ((static_cast<long long>(b) * p.Sq + q0 + r / G) * p.H +
                 kh * G + r % G) * D;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int grp = tx + TX * g;
      if (grp < NG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[grp * 4 + e] = from_f<T>(acc[i][g][e] / l);
      }
    }
  }
}

template <typename T, int D>
int launch(const Params& p, void* stream) {
  const size_t smem = Shape<D>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.Sq + p.block_m - 1) / p.block_m, p.K, p.B);
  flash_kernel<T, D><<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_dim(const Params& p, int D, void* stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out share it). D is one of 16,
// 32, 64, 80, 128, 256; G = H / K is at most 64. Strides are in elements;
// the last axis of q, k and v is contiguous, out is contiguous. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int Sq, int Sk, int H, int K, int D, long long q_s0, long long q_s1,
    long long q_s2, long long k_s0, long long k_s1, long long k_s2,
    long long v_s0, long long v_s1, long long v_s2, float scale, int causal,
    int window, int q_offset, int vec, void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || K < 1 || K > 65535 ||
      H % K != 0 || H / K > ROWS || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  Params p = {q, k, v, out, B, Sq, Sk, H, K, G, ROWS / G,
              q_s0, q_s1, q_s2, k_s0, k_s1, k_s2, v_s0, v_s1, v_s2,
              scale, causal, window, q_offset, vec};
  if (dtype == 0) return by_dim<float>(p, D, stream);
  if (dtype == 1) return by_dim<__nv_bfloat16>(p, D, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

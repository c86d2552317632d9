// Flash attention for NVIDIA Hopper (sm_90a), hand-written CUDA C++:
// whole-sequence GQA attention, causal, sliding-window or bidirectional,
// forward and backward.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
// flash_attention (pallas_call at :119, body _flash_kernel :27-81). The JAX
// package has no backward kernel: its training differentiates the model's
// chunked_attention. The plain PyTorch versions are in
// repro_torch/kernels/flash_attention.py: flash_attention_plain (the
// model's chunked_attention, the forward's output), flash_attention_lse_plain
// (the log-sum-exp the forward also writes) and flash_attention_bwd_plain
// (the backward's formula).
//
// What it computes, per batch row b, query position i (absolute position
// qp = q_offset + i) and query head h (KV head kh = h / G):
//   out[b, i, h] = sum_j p_j v[b, j, kh] / sum_j p_j,
//   p_j = exp(scale * q[b, i, h] . k[b, j, kh] - max), scale = 1/sqrt(D),
//   lse[b, h, i] = max + log(sum_j p_j),
//   over the keys j < Sk with j <= qp when causal and j > qp - window when
//   a window is given. Scores, the running max and sum and the (rows, D)
//   accumulator are float32; p is rounded to the value type before the p.V
//   product, as the model's chunked_attention does (p.to(v.dtype)), while
//   the running sum adds the unrounded p. A query with no valid key writes
//   exact zeros and lse = -inf (chunked_attention and the Pallas kernel
//   give an average over masked keys there).
// The backward, given dO: with P = exp(scale S - lse) and
// Delta = rowsum(dO o out),
//   dV = P^T dO,  dS = P o (dO V^T - Delta),  dQ = scale dS K,
//   dK = scale dS^T Q,
// each summed over the query heads of a KV head's group for dK and dV.
//
// What bounds it on this card: the operations. At the training main path's
// shape (gemma3-1b global layer: B = 2, S = 4096, H = 4, K = 1, D = 256,
// causal) the forward's two products over the live (query, key) pairs are
// 68.7 GFLOP against 42 MB of Q, K, V and O: ~69 us at the bf16
// tensor-core rate, ~13 us of bandwidth. The backward's five products are
// 10 D operations a live pair, ~174 us. A local layer (window 512) is a
// quarter of that. At hubert's encoder layer (B = 1, S = 32768, H = 16,
// D = 80, bidirectional) the forward is 5.50e12 operations, 5.56 ms at the
// bf16 rate, and 16 S^2 H = 1.7e10 exponentials, ~4.6 ms at the 16 ex2 a
// clock an SM does: at D = 80 the softmax weighs almost as much as the
// products, and the forward is bound by the two together.
//
// Design, bfloat16 forward, D <= 128 (flash_fwd_wgmma_kernel, namespace
// hop): Hopper's wgmma, fed by TMA, warp-specialised and persistent.
//  * Work items of 2 x 64 rows: row r of a warpgroup's 64 is position
//    q0 + r / G of head kh G + r % G (64 / G positions times the whole GQA
//    group), so each K/V tile is read once for all G heads and serves 128
//    rows. One block an SM walks the items; bidirectional items run
//    head-major (query tile fastest), so the blocks in flight share one
//    head's K and V in L2 (10.5 MB at S = 32768 against 50 MB); causal
//    items run longest first.
//  * A producer warp brings Q (once an item, into one of two slots, so the
//    next item's Q loads under this one) and K and V tiles of 128 keys by
//    TMA into a ring of 2-3 stages with full/empty mbarrier pairs; K and V
//    have their own barriers, so a stage's K is reloaded as soon as S has
//    read it. Rows
//    past the tensor's end arrive as zeros, and those keys are masked to
//    -inf (a zero key scores 0, not -inf). The tensor maps are built on the
//    host for each launch from the strides (cuTensorMapEncodeTiled, fetched
//    through the runtime).
//  * Layout: a tile's columns are regions of 64 (128-byte rows, 128-byte
//    swizzle) and then the rest, 16 or 32 columns (32- or 64-byte rows and
//    swizzle): D = 80 is 64 + 16, not padded to 96 or 128 (20-60% more
//    tensor work). S = Q K^T is wgmma m64n128k16 with Q and K from shared
//    memory, both K-major: D / 16 k-steps over the regions. O += P V is
//    wgmma with p in registers (rounded to bf16) as A and V MN-major, one
//    product a region (n64, n32 or n16) for each 16 keys.
//  * Two consumer warpgroups take turns on the tensor cores (named
//    barriers): each issues its S_i = Q K_i^T and O += P_{i-1} V_{i-1}
//    together, hands the turn on and runs S_i's max, ex2 and row sums
//    while its own P V and the other warpgroup's products run. setmaxnreg
//    gives the consumers 232 registers and the producer 40.
//  * Key tiles that no (query, key) pair of the item needs are never
//    loaded (the Pallas `live` predicate, :44-53): causal items stop at the
//    tile of their last query, windowed ones start at the tile of their
//    first query's first key, so a local layer does O(S * window) work.
//    Only tiles that straddle a mask edge are masked element by element.
//  * Numerics as the design below: fp32 scores, running max and sum in
//    base 2, p rounded to bf16 only as the P.V operand while the running
//    sum adds the unrounded p, a fixed summation order (two runs are
//    bit-identical).
//
// Design, bfloat16 at D = 256 (the training path of gemma3-1b), and the
// backward for every D:
//  * Tensor cores: every product is mma.sync m16n8k16 (bf16 in, fp32
//    accumulate) on fragments read with ldmatrix straight from bf16 tiles in
//    shared memory (rows padded by 16 bytes, so the 8 rows of an ldmatrix
//    fall in distinct banks). Nothing is widened to fp32 in shared memory.
//  * Forward at D = 256 (flash_tc_kernel): its 64 x 256 fp32 accumulator is
//    128 registers a thread before any score, another tiling than the
//    Hopper design's. One block of 4 warps per (64 query rows, KV head,
//    batch row), rows folded as above. A warp owns 16 rows: its scores, the
//    online softmax (max and sum) and its (16, D) accumulator stay in fp32
//    registers, and p goes from the score accumulators to the P.V product's
//    A operand in registers (rounded to bf16). K/V tiles of 32 keys (2 x 32
//    x 528 B a stage) are staged with cp.async in a 2-stage ring, so tile
//    j + 1 loads while tile j is multiplied; Q and the two stages take
//    101 KB and two blocks fit on an SM. Live tiles and edge masks as
//    above; causal q tiles launch longest first.
//  * Backward, two passes and no atomics, after a small pass that forms
//    Delta. Pass 1 (dK, dV): one block of 8 warps per (key tile, KV head,
//    batch row) loops over every query tile of all G heads of its group
//    that sees those keys (Q and dO tiles in a cp.async ring), recomputing
//    S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q. Its
//    hard part is D = 256: an fp32 (16, 256) accumulator for dK and one for
//    dV would take 256 registers a thread. So DSPLIT = D / 64 warps share
//    16 keys (D = 128: 2, D = 256: 4; none up to D = 80): each accumulates a
//    64-wide slice of dK and dV, computes its slice's partial S^T and dP^T,
//    and the partials are summed through shared memory in a fixed order, so
//    every warp of the group holds the same P and dS. Key tiles are 32 keys
//    at D = 256, 64 at D = 128, 128 below. A full causal triangle gives key
//    tile 0 every query and the last tile few, and gemma3-1b's global layer
//    at B = 2, S = 4096 has only 256 such blocks, one uneven wave: there
//    (and wherever the blocks are too few to fill the card) each key tile's
//    query range is split over several blocks, whose fp32 partials a last
//    pass sums in split order. Pass 2 (dQ): 64 folded rows a block, live
//    key tiles only, recomputes S and dP and accumulates dQ += dS K in
//    registers. Each output is summed in a fixed order: two runs are
//    bit-identical.
//  * The cost of mma.sync: a warp's 16-row tiles reload their operand
//    fragments from shared memory for every product, and the backward's
//    lock-step iterations wait on barriers; a wgmma backward is later work.
//
// Float32: the forward is the FMA kernel of the first port (flash_kernel
// below: Q, K, V in fp32 shared memory, fp32 FMA micro-tiles, key tiles of
// 32 at D = 256 and 64 below), which also serves bf16 when the launch asks
// for it, to time that design beside the others. The backward runs the same
// tiling as bf16, with each m16n8k16 product done as fp32 FMAs on the same
// fragment layout (operands gathered by warp shuffles): no TF32, so it
// agrees with the plain version to float32 round-off.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// PTX primitives: cp.async, ldmatrix and mma.sync (bf16 in, fp32 out)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, global -> shared, asynchronous
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// 4 bytes, global -> shared, asynchronous
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b, m16n8k16, A row-major, B column-major
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// common helpers
// ---------------------------------------------------------------------------

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// two adjacent outputs (an even column) in T
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
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

// over the 4 lanes of a quad (the lanes that share an mma row)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;     // (B, Sq, H, D), last axis contiguous
  const void* k;     // (B, Sk, K, D), last axis contiguous
  const void* v;     // (B, Sk, K, D), last axis contiguous
  void* out;         // (B, Sq, H, D), contiguous
  float* lse;        // (B, H, Sq), contiguous
  int B, Sq, Sk, H, K, G;
  int block_m;       // query positions a block: 64 / G
  long long q_s0, q_s1, q_s2;   // element strides of the first three axes
  long long k_s0, k_s1, k_s2;
  long long v_s0, v_s1, v_s2;
  float scale;
  int causal;
  int window;        // <= 0: no window
  int q_offset;      // absolute position of query 0
  int vec;           // rows may be read with 16-byte loads
};

struct BwdParams {
  Params f;          // q, k, v, out, lse and the shape, as in the forward
  const void* dout;  // (B, Sq, H, D), contiguous
  float* delta;      // (B, H, Sq): rowsum(dO o out)
  void* dq;          // (B, Sq, H, D), contiguous
  void* dk;          // (B, Sk, K, D), contiguous
  void* dv;          // (B, Sk, K, D), contiguous
  float* ws;         // splits > 1: (2, splits, B, Sk, K, D) partial dK, dV
  int splits;        // blocks sharing a key tile's query range
};

__device__ __forceinline__ bool key_ok(const Params& p, int key, int qp) {
  return key < p.Sk && (!p.causal || key <= qp) &&
         (p.window <= 0 || key > qp - p.window);
}

// Copy `rows` rows of D elements into shared memory (row stride RS
// elements), with 16-byte cp.async when `vec`, else element by element.
// off(r) is the element offset of row r in src, or -1 for a row outside the
// tensor, which is zero-filled.
template <typename T, int D, int RS, int NT, typename RowOff>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int rows,
                                          RowOff off, int vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int PER = D / E;
    for (int i = threadIdx.x; i < rows * PER; i += NT) {
      const int r = i / PER;
      const int c = (i - r * PER) * E;
      const long long o = off(r);
      T* d = dst + r * RS + c;
      if (o < 0)
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      else
        cp_async16(d, src + o + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += NT) {
      const int r = i / D;
      const int c = i - r * D;
      const long long o = off(r);
      dst[r * RS + c] = o < 0 ? from_f<T>(0.0f) : src[o + c];
    }
  }
}

// ---------------------------------------------------------------------------
// m16n8k16 fragments. With g = lane / 4 and c = lane % 4, a lane holds
// A (16 x 16) at (g, 2c..2c+1), (g+8, 2c..), (g, 2c+8..), (g+8, 2c+8..);
// B (16 x 8, k x n) at (k = 2c..2c+1, n = g), (k = 2c+8.., n = g); and the
// accumulator C (16 x 8) at (g, 2c..2c+1), (g+8, 2c..2c+1). A FragB holds
// two adjacent n8 tiles. bf16 fragments come from ldmatrix and feed the
// tensor cores; float32 fragments hold the same elements and their product
// is done as fp32 FMAs, the operands gathered by shuffles.
// ---------------------------------------------------------------------------

template <typename T> struct FragA;
template <> struct FragA<bf16> { uint32_t x[4]; };
template <> struct FragA<float> { float x[8]; };
template <typename T> struct FragB;
template <> struct FragB<bf16> { uint32_t x[4]; };
template <> struct FragB<float> { float x[8]; };

// A(m, k) = s[(m0 + m) * rs + k0 + k]
__device__ __forceinline__ void load_a(FragA<bf16>& f, const bf16* s, int rs,
                                       int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f.x, s + (m0 + (lane & 15)) * rs + k0 + ((lane >> 4) << 3));
}
__device__ __forceinline__ void load_a(FragA<float>& f, const float* s,
                                       int rs, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  const float* r0 = s + (m0 + (lane >> 2)) * rs + k0 + 2 * (lane & 3);
  const float* r1 = r0 + 8 * rs;
  f.x[0] = r0[0]; f.x[1] = r0[1]; f.x[2] = r1[0]; f.x[3] = r1[1];
  f.x[4] = r0[8]; f.x[5] = r0[9]; f.x[6] = r1[8]; f.x[7] = r1[9];
}

// B(k, n) = s[(n0 + n) * rs + k0 + k], n over two n8 tiles
__device__ __forceinline__ void load_b_nk(FragB<bf16>& f, const bf16* s,
                                          int rs, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f.x, s + (n0 + ((lane >> 4) << 3) + (lane & 7)) * rs + k0 +
                   (((lane >> 3) & 1) << 3));
}
__device__ __forceinline__ void load_b_nk(FragB<float>& f, const float* s,
                                          int rs, int n0, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float* r = s + (n0 + 8 * j + (lane >> 2)) * rs + k0 + 2 * (lane & 3);
    f.x[4 * j] = r[0]; f.x[4 * j + 1] = r[1];
    f.x[4 * j + 2] = r[8]; f.x[4 * j + 3] = r[9];
  }
}

// B(k, n) = s[(k0 + k) * rs + n0 + n], n over two n8 tiles
__device__ __forceinline__ void load_b_kn(FragB<bf16>& f, const bf16* s,
                                          int rs, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(f.x, s + (k0 + (((lane >> 3) & 1) << 3) + (lane & 7)) * rs +
                         n0 + ((lane >> 4) << 3));
}
__device__ __forceinline__ void load_b_kn(FragB<float>& f, const float* s,
                                          int rs, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const float* c = s + (k0 + 2 * (lane & 3)) * rs + n0 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    f.x[4 * j] = c[8 * j]; f.x[4 * j + 1] = c[rs + 8 * j];
    f.x[4 * j + 2] = c[8 * rs + 8 * j]; f.x[4 * j + 3] = c[9 * rs + 8 * j];
  }
}

// the A operand from two accumulator tiles (columns 0-7 and 8-15); bf16
// rounds each value to nearest
__device__ __forceinline__ void a_from_c(FragA<bf16>& f, const float (&c0)[4],
                                         const float (&c1)[4]) {
  f.x[0] = pack_bf16(c0[0], c0[1]);
  f.x[1] = pack_bf16(c0[2], c0[3]);
  f.x[2] = pack_bf16(c1[0], c1[1]);
  f.x[3] = pack_bf16(c1[2], c1[3]);
}
__device__ __forceinline__ void a_from_c(FragA<float>& f,
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f.x[e] = c0[e];
    f.x[4 + e] = c1[e];
  }
}

// c0 += A . B(tile 0), c1 += A . B(tile 1)
__device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4],
                                     const FragA<bf16>& a,
                                     const FragB<bf16>& b) {
  mma_bf16(c0, a.x, b.x[0], b.x[1]);
  mma_bf16(c1, a.x, b.x[2], b.x[3]);
}
__device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4],
                                     const FragA<float>& a,
                                     const FragB<float>& b) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  float* cs[2] = {c0, c1};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // A(g, k) and A(g + 8, k) for k = 2q, 2q+1, 2q+8, 2q+9: lane 4g + q
    const int src_a = 4 * g + q;
    float lo[4], hi[4];
    lo[0] = __shfl_sync(0xffffffffu, a.x[0], src_a);
    lo[1] = __shfl_sync(0xffffffffu, a.x[1], src_a);
    lo[2] = __shfl_sync(0xffffffffu, a.x[4], src_a);
    lo[3] = __shfl_sync(0xffffffffu, a.x[5], src_a);
    hi[0] = __shfl_sync(0xffffffffu, a.x[2], src_a);
    hi[1] = __shfl_sync(0xffffffffu, a.x[3], src_a);
    hi[2] = __shfl_sync(0xffffffffu, a.x[6], src_a);
    hi[3] = __shfl_sync(0xffffffffu, a.x[7], src_a);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // B(k, n = 2c + e) for the same k: lane 4 (2c + e) + q
        const int src_b = 4 * (2 * c + e) + q;
        float bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bk[i] = __shfl_sync(0xffffffffu, b.x[4 * j + i], src_b);
        float s0 = cs[j][e], s1 = cs[j][2 + e];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s0 = fmaf(lo[i], bk[i], s0);
          s1 = fmaf(hi[i], bk[i], s1);
        }
        cs[j][e] = s0;
        cs[j][2 + e] = s1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward, fp32 FMA design (float32; bf16 on request)
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 64;               // query rows (position, head) a block
constexpr int TX = 16, TY = 16;        // thread grid of the two products
constexpr int RPT = ROWS / TY;         // rows per thread
constexpr int ROWS_PER_WARP = ROWS / WARPS;
static_assert(TX * TY == THREADS, "16 x 16 threads");

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

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // (ROWS, DS)
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
        const bool ok = row_ok[i] && key_ok(p, kp, row_pos[i]);
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
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      l_s[r] = l_run[i];
      if (r < n_rows)
        p.lse[(static_cast<long long>(b) * p.H + kh * G + r % G) * p.Sq +
              q0 + r / G] =
            l_run[i] > 0.0f ? m_run[i] + logf(l_run[i]) : -INFINITY;
    }
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

// ---------------------------------------------------------------------------
// forward, tensor cores (bf16)
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;  // 16 of the 64 rows a warp

template <typename T, int D>
struct TcShape {
  static constexpr int BN = D > 128 ? 32 : 64;  // keys a tile
  static constexpr int RS = D + 16 / sizeof(T); // row stride, 16-byte pad
  static constexpr int KV = BN * RS;            // one K or V tile
  static constexpr size_t SMEM =
      sizeof(T) * (static_cast<size_t>(ROWS) * RS + 4 * KV);
};

// Row r of a block is query position q0 + r / G and head kh * G + r % G;
// a block covers ROWS / G positions. Causal blocks are ordered longest
// first.
struct RowBlock {
  int q0, kh, b, n_pos, n_rows, q_lo, q_hi;
};

__device__ __forceinline__ RowBlock row_block(const Params& p) {
  const int per = p.K * p.B;
  const int n_qt = (p.Sq + p.block_m - 1) / p.block_m;
  const int rank = blockIdx.x / per;
  const int qt = p.causal ? n_qt - 1 - rank : rank;
  RowBlock rb;
  rb.kh = (blockIdx.x % per) % p.K;
  rb.b = (blockIdx.x % per) / p.K;
  rb.q0 = qt * p.block_m;
  rb.n_pos = min(p.block_m, p.Sq - rb.q0);
  rb.n_rows = rb.n_pos * p.G;
  rb.q_lo = p.q_offset + rb.q0;
  rb.q_hi = rb.q_lo + rb.n_pos - 1;
  return rb;
}

// the key tiles of BN keys that some (query, key) pair of the block needs
__device__ __forceinline__ void live_tiles(const Params& p, const RowBlock& rb,
                                           int bn, int& t_begin, int& t_end) {
  t_begin = 0;
  t_end = (p.Sk + bn - 1) / bn;
  if (p.causal) t_end = min(t_end, rb.q_hi / bn + 1);
  if (p.window > 0) t_begin = max(0, rb.q_lo - p.window + 1) / bn;
}

// every pair of the tile is valid for every row of the block
__device__ __forceinline__ bool tile_full(const Params& p, const RowBlock& rb,
                                          int k0, int bn) {
  return k0 + bn <= p.Sk && (!p.causal || k0 + bn - 1 <= rb.q_lo) &&
         (p.window <= 0 || k0 > rb.q_hi - p.window);
}

__device__ __forceinline__ long long row_offset(const Params& p,
                                                const RowBlock& rb, int r,
                                                long long s0, long long s1,
                                                long long s2) {
  if (r >= rb.n_rows) return -1;
  return rb.b * s0 + static_cast<long long>(rb.q0 + r / p.G) * s1 +
         static_cast<long long>(rb.kh * p.G + r % p.G) * s2;
}

template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS, 2) flash_tc_kernel(Params p) {
  using S = TcShape<T, D>;
  constexpr int BN = S::BN, RS = S::RS, NT = BN / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);   // (ROWS, RS)
  T* kv_s = q_s + ROWS * RS;                 // stage s: K at 2 s KV, V next

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const RowBlock rb = row_block(p);
  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  int t_begin, t_end;
  live_tiles(p, rb, BN, t_begin, t_end);
  auto load_kv = [&](int t, int s) {
    const int k0 = t * BN;
    T* ks = kv_s + 2 * s * S::KV;
    load_rows<T, D, RS, TC_THREADS>(ks, kg, BN, [&](int r) -> long long {
      if (k0 + r >= p.Sk) return -1;
      return rb.b * p.k_s0 + static_cast<long long>(k0 + r) * p.k_s1 +
             rb.kh * p.k_s2;
    }, p.vec);
    load_rows<T, D, RS, TC_THREADS>(ks + S::KV, vg, BN,
                                    [&](int r) -> long long {
      if (k0 + r >= p.Sk) return -1;
      return rb.b * p.v_s0 + static_cast<long long>(k0 + r) * p.v_s1 +
             rb.kh * p.v_s2;
    }, p.vec);
  };
  load_rows<T, D, RS, TC_THREADS>(q_s, qg, ROWS, [&](int r) -> long long {
    return row_offset(p, rb, r, p.q_s0, p.q_s1, p.q_s2);
  }, p.vec);
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();

  // this thread's rows: r_lo = 16 warp + g and r_lo + 8
  const int r_lo = 16 * warp + g;
  const int pos_lo = rb.q_lo + r_lo / p.G;
  const int pos_hi = rb.q_lo + (r_lo + 8) / p.G;
  const float scale2 = p.scale * LOG2E;   // scores in base-2 units

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;

  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    const int s = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < t_end) {  // so its stage takes tile t + 1
      load_kv(t + 1, s ^ 1);
      cp_async_commit();
    }
    const T* ks = kv_s + 2 * s * S::KV;
    const T* vs = ks + S::KV;

    // S = Q K^T, 16 rows x BN keys a warp
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA<T> a;
      load_a(a, q_s, RS, 16 * warp, 16 * kk);
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        FragB<T> bk;
        load_b_nk(bk, ks, RS, 16 * nn, 16 * kk);
        mma2(sc[2 * nn], sc[2 * nn + 1], a, bk);
      }
    }

    // mask, online softmax (base 2), p in place of the scores
    const int k0 = t * BN;
    const bool full = tile_full(p, rb, k0, BN);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v0 = sc[j][e] * scale2, v1 = sc[j][2 + e] * scale2;
        if (!full) {
          const int key = k0 + 8 * j + 2 * c + e;
          if (!key_ok(p, key, pos_lo)) v0 = -INFINITY;
          if (!key_ok(p, key, pos_hi)) v1 = -INFINITY;
        }
        sc[j][e] = v0;
        sc[j][2 + e] = v1;
        mx_lo = fmaxf(mx_lo, v0);
        mx_hi = fmaxf(mx_hi, v1);
      }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    // a row that has seen no valid key keeps m = -inf, corr 1, p 0
    const float corr_lo = mn_lo == -INFINITY ? 1.0f : exp2f(m_lo - mn_lo);
    const float corr_hi = mn_hi == -INFINITY ? 1.0f : exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 =
            sc[j][e] == -INFINITY ? 0.0f : exp2f(sc[j][e] - mn_lo);
        const float p1 =
            sc[j][2 + e] == -INFINITY ? 0.0f : exp2f(sc[j][2 + e] - mn_hi);
        sum_lo += p0;
        sum_hi += p1;
        sc[j][e] = p0;
        sc[j][2 + e] = p1;
      }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= corr_lo;
      o[j][1] *= corr_lo;
      o[j][2] *= corr_hi;
      o[j][3] *= corr_hi;
    }

    // O += P V, p rounded to bf16 in the A operand
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      FragA<T> a;
      a_from_c(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        FragB<T> bv;
        load_b_kn(bv, vs, RS, 16 * kk, 16 * nn);
        mma2(o[2 * nn], o[2 * nn + 1], a, bv);
      }
    }
  }
  cp_async_wait<0>();

  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (r >= rb.n_rows) continue;
    const float l = half ? l_hi : l_lo;
    const float m = half ? m_hi : m_lo;
    const float inv = 1.0f / fmaxf(l, 1e-37f);
    const int h = rb.kh * p.G + r % p.G;
    const int i = rb.q0 + r / p.G;
    T* orow = og + ((static_cast<long long>(rb.b) * p.Sq + i) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store2(orow + 8 * j + 2 * c, o[j][2 * half] * inv,
             o[j][2 * half + 1] * inv);
    if (c == 0)
      p.lse[(static_cast<long long>(rb.b) * p.H + h) * p.Sq + i] =
          l > 0.0f ? (m + log2f(l)) * LN2 : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// forward, Hopper design (bf16, D <= 128): wgmma on tiles that TMA brings
// into an mbarrier ring; one producer warp, two consumer warpgroups taking
// turns on the tensor cores; one persistent block an SM
// ---------------------------------------------------------------------------

namespace hop {

constexpr int C = 2;          // consumer warpgroups
constexpr int WG_ROWS = 64;   // query rows a consumer warpgroup
constexpr int BN = 128;       // keys a tile
constexpr int THREADS = 128 * (C + 1);  // the last warpgroup loads
// registers a thread: the producer's few, the consumers' the rest of 64 K
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BAR_TURN = 1;   // named barriers 1..C: the consumers' turns

// A (rows, D) tile is stored as regions of columns: D / 64 regions of 64
// columns (rows of 128 bytes) and then the rest, 16 or 32 columns (rows of
// 32 or 64 bytes), each region (rows x its row bytes) swizzled by TMA with
// the pattern of its row width, which the wgmma descriptors name. D = 80 is
// one region of 64 and one of 16: padding it to 96 or 128 would be the same
// arithmetic with 20-60% more tensor work.
//
// Two consumer warpgroups of 232 registers a thread hold S (64), p (32)
// and O (D / 2) with room; three (192 rows, 160 registers) spilled and
// serialised their products on the card at D = 80.
template <int D>
struct Hop {
  static constexpr int NA = D / 64;  // regions of 64 columns
  static constexpr int WB = D % 64;  // the last region's columns (0: none)
  static_assert(WB == 0 || WB == 16 || WB == 32, "head dims 16..128");
  static constexpr int Q_WG = WG_ROWS * D * 2;  // a warpgroup's Q, bytes
  static constexpr int KV = BN * D * 2;         // a K or a V tile, bytes
  static_assert(Q_WG % 1024 == 0 && KV % 1024 == 0, "regions on 1024 B");
  // K/V stages: three up to D = 80 (two ran 1.6x slower at hubert's
  // D = 80); two at D = 128, where three do not fit beside two Q slots
  static constexpr int STAGES = D > 80 ? 2 : 3;
  static constexpr int BARS = 4 + 4 * STAGES;
  // Q in two slots, so that the next item's Q loads under this item
  static constexpr size_t SMEM = 1024 + 2 * C * Q_WG +
                                 2 * STAGES * static_cast<size_t>(KV) +
                                 8 * BARS;
};

struct Maps {  // TMA descriptors: Q, K and V, 64-column and last regions
  CUtensorMap q_a, q_b, k_a, k_b, v_a, v_b;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of the 4-d tensor (D, heads, positions, B) into shared memory;
// the box's bytes complete a transaction on `bar`, zeros past each end
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// every region of one tile of R rows, each from its columns of the tensor
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap& a,
                                          const CUtensorMap& b, uint32_t bar,
                                          int head, int pos, int batch) {
#pragma unroll
  for (int i = 0; i < Hop<D>::NA; ++i)
    tma_load(dst + i * R * 128, a, bar, 64 * i, head, pos, batch);
  if (Hop<D>::WB)
    tma_load(dst + Hop<D>::NA * R * 128, b, bar, 64 * Hop<D>::NA, head, pos,
             batch);
}

// wgmma's shared-memory descriptor of a region whose rows are `row_bytes`
// (128, 64 or 32: the swizzle of the same width), 8-row groups 8 rows
// apart (the stride byte offset). K-major operands (Q, K) read 16 columns
// from the start address, which steps 32 bytes a k-step inside the
// swizzled row; their leading byte offset is unused. V is read MN-major
// (`mn`), one swizzle atom across its N, stepping 16 rows a k-step; its
// leading byte offset, the step to a next atom across N, is never taken
// and is given the 8-row stride too.
__device__ __forceinline__ uint64_t desc(uint32_t addr, int row_bytes,
                                         bool mn) {
  const uint64_t groups = (8 * row_bytes) >> 4;  // 16-byte units
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return ((addr & 0x3FFFF) >> 4) | ((mn ? groups : 1) << 16) |
         (groups << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers that an asynchronous wgmma reads or writes: the compiler may
// not move their other uses across this point (placed after each wait);
// also what must be computed before a wait.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void keep(float& a, float& b, float& c, float& d) {
  asm volatile("" : "+f"(a), "+f"(b), "+f"(c), "+f"(d)::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf gives +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The warpgroups take turns issuing their products, in a ring: a
// warpgroup waits for its turn (its barrier: its own 128 threads and the
// previous warpgroup's 128), and hands the turn to the next once its
// products are issued, so one warpgroup's softmax runs while another's
// products do.
__device__ __forceinline__ void turn_begin(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(BAR_TURN + wg), "n"(256)
               : "memory");
}
__device__ __forceinline__ void turn_end(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(BAR_TURN + (wg + 1) % C), "n"(256)
               : "memory");
}

// d (64 x 128) (+)= A (64 x 16, shared, K-major) . B (128 x 16, shared,
// K-major)^T
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[OFF ..] (64 x 16) += A (64 x 16, registers) . B (16 x 16, shared,
// MN-major)
template <int OFF, int ND>
__device__ __forceinline__ void wgmma_rs_16(float (&d)[ND],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[OFF ..] (64 x 32) += A (64 x 16, registers) . B (16 x 32, shared,
// MN-major)
template <int OFF, int ND>
__device__ __forceinline__ void wgmma_rs_32(float (&d)[ND],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[OFF ..] (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared,
// MN-major)
template <int OFF, int ND>
__device__ __forceinline__ void wgmma_rs_64(float (&d)[ND],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]),
        "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// S (64 x BN) = Q (64 x D) . K (BN x D)^T over every region's k-steps
template <int D>
__device__ __forceinline__ void qk(float (&sc)[BN / 2], uint32_t q_s,
                                   uint32_t k_s) {
  constexpr int NA = Hop<D>::NA, WB = Hop<D>::WB;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const uint64_t a = desc(q_s + i * WG_ROWS * 128, 128, false);
    const uint64_t b = desc(k_s + i * BN * 128, 128, false);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(sc, a + 2 * kk, b + 2 * kk, i | kk);
  }
  if constexpr (WB > 0) {
    const uint64_t a = desc(q_s + NA * WG_ROWS * 128, 2 * WB, false);
    const uint64_t b = desc(k_s + NA * BN * 128, 2 * WB, false);
#pragma unroll
    for (int kk = 0; kk < WB / 16; ++kk)
      wgmma_ss(sc, a + 2 * kk, b + 2 * kk, NA | kk);
  }
}

// O (64 x D) += P (64 x BN, registers, bf16) . V (BN x D), one product a
// region for each 16 keys
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2],
                                   const uint32_t (&pf)[BN / 16][4],
                                   uint32_t v_s) {
  constexpr int NA = Hop<D>::NA, WB = Hop<D>::WB;
  const uint64_t a0 = desc(v_s, 128, true);
  const uint64_t a1 = desc(v_s + BN * 128, 128, true);
  const uint64_t b = desc(v_s + NA * BN * 128, WB ? 2 * WB : 32, true);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    if constexpr (NA >= 1) wgmma_rs_64<0>(o, pf[kk], a0 + kk * 128);
    if constexpr (NA >= 2) wgmma_rs_64<32>(o, pf[kk], a1 + kk * 128);
    if constexpr (WB == 16) wgmma_rs_16<32 * NA>(o, pf[kk], b + kk * 32);
    if constexpr (WB == 32) wgmma_rs_32<32 * NA>(o, pf[kk], b + kk * 64);
  }
}

// Work item `item` of the persistent grid: a block of C x 64 rows (C x
// WG_ROWS / G positions, the whole GQA group at each) of one KV head and
// batch row. Bidirectional items run head-major (query tile fastest), so
// the blocks in flight share one head's K and V in L2; causal items run
// longest first, as row_block.
__device__ __forceinline__ RowBlock hop_item(const Params& p, int item) {
  const int bm = p.block_m;
  const int n_qt = (p.Sq + bm - 1) / bm;
  int qt, rest;
  if (p.causal) {
    const int per = p.K * p.B;
    qt = n_qt - 1 - item / per;
    rest = item % per;
  } else {
    qt = item % n_qt;
    rest = item / n_qt;
  }
  RowBlock rb;
  rb.kh = rest % p.K;
  rb.b = rest / p.K;
  rb.q0 = qt * bm;
  rb.n_pos = min(bm, p.Sq - rb.q0);
  rb.n_rows = rb.n_pos * p.G;
  rb.q_lo = p.q_offset + rb.q0;
  rb.q_hi = rb.q_lo + rb.n_pos - 1;
  return rb;
}

__host__ __device__ __forceinline__ int n_items(const Params& p) {
  return ((p.Sq + p.block_m - 1) / p.block_m) * p.K * p.B;
}

// Masks the tile's scores (rows r_lo, r_lo + 8 at positions pos_lo,
// pos_hi; keys k0 + 8 j + 2 c + e) unless every pair is valid, updates the
// running max (base 2) and the thread's partial sums, and leaves p in sc;
// returns the factors that rescale the rows' earlier sums.
__device__ __forceinline__ void softmax(float (&sc)[BN / 2], const Params& p,
                                        bool full, int k0, int c, int pos_lo,
                                        int pos_hi, float scale2, float& m_lo,
                                        float& m_hi, float& l_lo, float& l_hi,
                                        float& corr_lo, float& corr_hi) {
  if (!full) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * c + e;
        if (!key_ok(p, key, pos_lo)) sc[4 * j + e] = -INFINITY;
        if (!key_ok(p, key, pos_hi)) sc[4 * j + 2 + e] = -INFINITY;
      }
  }
  // the row maxima over four independent chains (the max is exact in any
  // order)
  float mx[2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mx[0][i] = mx[1][i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[0][(2 * j + e) % 4] = fmaxf(mx[0][(2 * j + e) % 4], sc[4 * j + e]);
      mx[1][(2 * j + e) % 4] =
          fmaxf(mx[1][(2 * j + e) % 4], sc[4 * j + 2 + e]);
    }
  const float mx_lo =
      fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
  const float mx_hi =
      fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
  const float mn_lo = fmaxf(m_lo, quad_max(mx_lo) * scale2);
  const float mn_hi = fmaxf(m_hi, quad_max(mx_hi) * scale2);
  // a row that has seen no valid key keeps m = -inf and p = 0
  const float mu_lo = mn_lo == -INFINITY ? 0.0f : mn_lo;
  const float mu_hi = mn_hi == -INFINITY ? 0.0f : mn_hi;
  corr_lo = ex2(m_lo - mu_lo);
  corr_hi = ex2(m_hi - mu_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p0 = ex2(fmaf(sc[4 * j + e], scale2, -mu_lo));
      const float p1 = ex2(fmaf(sc[4 * j + 2 + e], scale2, -mu_hi));
      sc[4 * j + e] = p0;
      sc[4 * j + 2 + e] = p1;
      sum_lo += p0;
      sum_hi += p1;
    }
  l_lo = l_lo * corr_lo + sum_lo;
  l_hi = l_hi * corr_hi + sum_hi;
}

// p as the P.V product's A operand, rounded to bf16: keys 16 kk .. 16 kk
// + 15 are accumulator tiles 2 kk and 2 kk + 1
__device__ __forceinline__ void to_p(uint32_t (&pf)[BN / 16][4],
                                     const float (&sc)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pf[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ Params p,
                           const __grid_constant__ Maps maps) {
  using H = Hop<D>;
  constexpr int S = H::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // regions start on 1024-byte boundaries, where every swizzle pattern
  // starts over
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_addr(base);
  const uint32_t k_s0 = s0 + 2 * C * H::Q_WG;
  const uint32_t v_s0 = k_s0 + S * H::KV;
  const uint32_t bars = v_s0 + S * H::KV;
  auto full_q = [&](int slot) { return bars + 8 * slot; };
  auto empty_q = [&](int slot) { return bars + 16 + 8 * slot; };
  auto full_k = [&](int s) { return bars + 32 + 8 * s; };
  auto empty_k = [&](int s) { return bars + 32 + 8 * (S + s); };
  auto full_v = [&](int s) { return bars + 32 + 8 * (2 * S + s); };
  auto empty_v = [&](int s) { return bars + 32 + 8 * (3 * S + s); };

  // Q rows that no load reaches (64 % G of them) stay zero
  for (int i = threadIdx.x; i < 2 * C * H::Q_WG / 16; i += THREADS)
    reinterpret_cast<uint4*>(base)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
    for (int slot = 0; slot < 2; ++slot) {
      mbar_init(full_q(slot), 1);
      mbar_init(empty_q(slot), C);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(empty_k(s), C);
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int npos = WG_ROWS / p.G;  // positions a consumer warpgroup
  const int items = n_items(p);

  if (wg == C) {
    // the producer: one thread walks the items and keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != C * 128) return;
    const int q_bytes = C * npos * p.G * D * 2;
    int it = 0, qi = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++qi) {
      const RowBlock rb = hop_item(p, item);
      const int slot = qi & 1;  // the item's Q slot; qi >> 1 its use of it
      mbar_wait(empty_q(slot), ((qi >> 1) & 1) ^ 1);
      mbar_expect(full_q(slot), q_bytes);
#pragma unroll
      for (int w = 0; w < C; ++w)
        load_tile<D, WG_ROWS>(s0 + (slot * C + w) * H::Q_WG, maps.q_a,
                              maps.q_b, full_q(slot),
                              rb.kh * p.G, rb.q0 + w * npos, rb.b);
      int t_begin, t_end;
      live_tiles(p, rb, BN, t_begin, t_end);
      for (int t = t_begin; t < t_end; ++t, ++it) {
        const int s = it % S;
        const uint32_t ph = (it / S) & 1;
        mbar_wait(empty_k(s), ph ^ 1);
        mbar_expect(full_k(s), H::KV);
        load_tile<D, BN>(k_s0 + s * H::KV, maps.k_a, maps.k_b, full_k(s),
                         rb.kh, t * BN, rb.b);
        mbar_wait(empty_v(s), ph ^ 1);
        mbar_expect(full_v(s), H::KV);
        load_tile<D, BN>(v_s0 + s * H::KV, maps.v_a, maps.v_b, full_v(s),
                         rb.kh, t * BN, rb.b);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 rows of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r_lo = 16 * warp + g;  // this thread's rows: r_lo, r_lo + 8
  const float scale2 = p.scale * LOG2E;  // scores in base-2 units
  bf16* og = static_cast<bf16*>(p.out);
  if (wg == C - 1) turn_end(wg);  // warpgroup 0 takes the first turn

  int it = 0, qi = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++qi) {
    const RowBlock rb = hop_item(p, item);
    int t_begin, t_end;
    live_tiles(p, rb, BN, t_begin, t_end);
    const int n = t_end - t_begin;
    const int first = wg * npos;  // this warpgroup's first position
    const int pos_lo = rb.q_lo + first + r_lo / p.G;
    const int pos_hi = rb.q_lo + first + (r_lo + 8) / p.G;

    float o[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.0f;
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;
    const int slot = qi & 1;
    const uint32_t q_s = s0 + (slot * C + wg) * H::Q_WG;
    mbar_wait(full_q(slot), (qi >> 1) & 1);
    if (n > 0) {
      float sc[BN / 2];
      uint32_t pf[BN / 16][4];
      float corr_lo, corr_hi;
      int s = it % S;
      uint32_t ph = (it / S) & 1;
      // the first tile: S = Q K^T, then its softmax
      turn_begin(wg);
      mbar_wait(full_k(s), ph);
      wg_fence();
      qk<D>(sc, q_s, k_s0 + s * H::KV);
      wg_commit();
      turn_end(wg);
      wg_wait<0>();
      keep(sc);
      if (tid == 0) {
        mbar_arrive(empty_k(s));
        if (n == 1) mbar_arrive(empty_q(slot));
      }
      softmax(sc, p, tile_full(p, rb, t_begin * BN, BN), t_begin * BN, c,
                  pos_lo, pos_hi, scale2, m_lo, m_hi, l_lo, l_hi, corr_lo,
                  corr_hi);
      to_p(pf, sc);
      int ps = s;
      uint32_t pph = ph;
      ++it;
      // tile i: S_i = Q K_i^T and O += P_{i-1} V_{i-1} issued together;
      // S_i's softmax runs while P_{i-1} V_{i-1} does
      for (int i = 1; i < n; ++i, ++it) {
        s = it % S;
        ph = (it / S) & 1;
        const int k0 = (t_begin + i) * BN;
        turn_begin(wg);
        mbar_wait(full_k(s), ph);
        mbar_wait(full_v(ps), pph);  // no branch between the products
        wg_fence();
        qk<D>(sc, q_s, k_s0 + s * H::KV);
        wg_commit();
        pv<D>(o, pf, v_s0 + ps * H::KV);
        wg_commit();
        turn_end(wg);
        wg_wait<1>();
        keep(sc);
        if (tid == 0) {
          mbar_arrive(empty_k(s));
          if (i == n - 1) mbar_arrive(empty_q(slot));
        }
        softmax(sc, p, tile_full(p, rb, k0, BN), k0, c, pos_lo, pos_hi,
                    scale2, m_lo, m_hi, l_lo, l_hi, corr_lo, corr_hi);
        // the softmax is done before the wait, under the P V in flight
        keep(sc);
        keep(l_lo, l_hi, corr_lo, corr_hi);
        wg_wait<0>();
        keep(o);
        keep(pf);
        if (tid == 0) mbar_arrive(empty_v(ps));
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= corr_lo;
          o[4 * j + 1] *= corr_lo;
          o[4 * j + 2] *= corr_hi;
          o[4 * j + 3] *= corr_hi;
        }
        to_p(pf, sc);
        ps = s;
        pph = ph;
      }
      // the last tile's P V
      turn_begin(wg);
      mbar_wait(full_v(ps), pph);
      wg_fence();
      pv<D>(o, pf, v_s0 + ps * H::KV);
      wg_commit();
      turn_end(wg);
      wg_wait<0>();
      keep(o);
      keep(pf);
      if (tid == 0) mbar_arrive(empty_v(ps));
    } else if (tid == 0) {
      mbar_arrive(empty_q(slot));
    }

    // out = O / l in bf16 (exact zeros for a row with no valid key), lse
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_lo + 8 * half;
      const int pi = first + r / p.G;  // position within the block
      if (r >= npos * p.G || pi >= rb.n_pos) continue;
      const float l = half ? l_hi : l_lo;
      const float m = half ? m_hi : m_lo;
      const float inv = 1.0f / fmaxf(l, 1e-37f);
      const int h = rb.kh * p.G + r % p.G;
      const int i = rb.q0 + pi;
      bf16* orow =
          og + ((static_cast<long long>(rb.b) * p.Sq + i) * p.H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(orow + 8 * j + 2 * c, o[4 * j + 2 * half] * inv,
               o[4 * j + 2 * half + 1] * inv);
      if (c == 0)
        p.lse[(static_cast<long long>(rb.b) * p.H + h) * p.Sq + i] =
            l > 0.0f ? (m + log2f(l)) * LN2 : -INFINITY;
    }
  }
  if (wg == 0) turn_begin(wg);  // the last warpgroup's last hand-over
}

}  // namespace hop

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Delta = rowsum(dO o out): one warp per (b, i, h) row, out and dO
// contiguous (B, Sq, H, D), Delta (B, H, Sq)
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(BwdParams p) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const long long n = static_cast<long long>(p.f.B) * p.f.Sq * p.f.H;
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const T* o = static_cast<const T*>(p.f.out) + row * D;
  const T* d = static_cast<const T*>(p.dout) + row * D;
  float acc = 0.0f;
  for (int e = lane; e < D; e += 32) acc = fmaf(to_f(o[e]), to_f(d[e]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long h = row % p.f.H;
    const long long i = (row / p.f.H) % p.f.Sq;
    const long long b = row / (static_cast<long long>(p.f.H) * p.f.Sq);
    p.delta[(b * p.f.H + h) * p.f.Sq + i] = acc;
  }
}

constexpr int BW_WARPS = 8;
constexpr int BW_THREADS = 32 * BW_WARPS;

// pass 1: DSPLIT warps share 16 keys, each with a DW-wide slice of D
template <typename T, int D>
struct KvShape {
  static constexpr int DSPLIT = D <= 80 ? 1 : D / 64;
  static constexpr int DW = D / DSPLIT;
  static constexpr int BN = 16 * BW_WARPS / DSPLIT;   // keys a block
  static constexpr int RS = D + 16 / sizeof(T);
  static constexpr size_t smem(int bq) {
    return sizeof(T) * (2 * static_cast<size_t>(BN) * RS +
                        4 * static_cast<size_t>(bq) * RS) +
           sizeof(float) * ((DSPLIT > 1 ? BW_WARPS * 2 * 16 * bq : 0) +
                            4 * bq);
  }
  // query positions an iteration: 32 where two blocks fit on an SM
  static constexpr int BQ = smem(32) <= 113 * 1024 ? 32 : 16;
  static constexpr int XW = 2 * 16 * BQ;  // a warp's partial S^T, dP^T
  static constexpr int XCH = DSPLIT > 1 ? BW_WARPS * XW : 0;
  static constexpr size_t SMEM = smem(BQ);
  static_assert(DW % 16 == 0, "a warp's slice is whole k16 steps");
};

template <typename T, int D>
__global__ void __launch_bounds__(BW_THREADS, sizeof(T) == 2 ? 2 : 1)
    flash_bwd_dkdv_kernel(BwdParams bp) {
  using S = KvShape<T, D>;
  constexpr int BN = S::BN, RS = S::RS, BQ = S::BQ, DW = S::DW;
  constexpr int DSPLIT = S::DSPLIT, QN = BQ / 8;
  const Params& p = bp.f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // (BN, RS)
  T* v_s = k_s + BN * RS;                   // (BN, RS)
  T* qd_s = v_s + BN * RS;                  // stage s: Q at 2 s BQ RS, dO next
  float* xch = reinterpret_cast<float*>(qd_s + 4 * BQ * RS);
  float* ld_s = xch + S::XCH;               // stage s: lse at 2 s BQ, Delta

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int grp = warp / DSPLIT;            // its 16 keys
  const int d0 = (warp % DSPLIT) * DW;      // its slice of D
  // block: (key tile, split, KV head, batch row), key tile slowest (causal:
  // key tile 0 sees the most queries and goes first)
  const int per = p.K * p.B;
  const int kt = blockIdx.x / (bp.splits * per);
  const int split = (blockIdx.x / per) % bp.splits;
  const int kh = (blockIdx.x % per) % p.K;
  const int b = (blockIdx.x % per) / p.K;
  const int k0 = kt * BN;
  const int k_last = min(k0 + BN, p.Sk) - 1;

  // the query positions i (absolute q_offset + i) that see some key here
  const int i_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int i_hi = p.window > 0
                       ? min(p.Sq - 1, k_last + p.window - 1 - p.q_offset)
                       : p.Sq - 1;
  const int nq = i_hi >= i_lo ? (i_hi - i_lo + BQ) / BQ : 0;
  // iterations (head of the group, q tile); this block's share of them
  const int per_split = (p.G * nq + bp.splits - 1) / bp.splits;
  const int it_begin = split * per_split;
  const int it_end = min(p.G * nq, it_begin + per_split);

  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  const T* dog = static_cast<const T*>(bp.dout);
  const long long do_s1 = static_cast<long long>(p.H) * D;
  const long long do_s0 = do_s1 * p.Sq;

  auto load_q = [&](int it, int s) {
    const int h = kh * p.G + it / nq;
    const int i0 = i_lo + (it % nq) * BQ;
    T* qs = qd_s + 2 * s * BQ * RS;
    load_rows<T, D, RS, BW_THREADS>(qs, qg, BQ, [&](int r) -> long long {
      if (i0 + r > i_hi) return -1;
      return b * p.q_s0 + static_cast<long long>(i0 + r) * p.q_s1 +
             static_cast<long long>(h) * p.q_s2;
    }, p.vec);
    load_rows<T, D, RS, BW_THREADS>(qs + BQ * RS, dog, BQ,
                                    [&](int r) -> long long {
      if (i0 + r > i_hi) return -1;
      return b * do_s0 + static_cast<long long>(i0 + r) * do_s1 +
             static_cast<long long>(h) * D;
    }, p.vec);
    float* ls = ld_s + 2 * s * BQ;
    for (int r = threadIdx.x; r < 2 * BQ; r += BW_THREADS) {
      const int i = i0 + r % BQ;
      const long long o = (static_cast<long long>(b) * p.H + h) * p.Sq + i;
      if (i > i_hi)
        ls[r] = 0.0f;
      else
        cp_async4(ls + r, r < BQ ? p.lse + o : bp.delta + o);
    }
  };

  if (it_begin < it_end) {
    load_rows<T, D, RS, BW_THREADS>(k_s, kg, BN, [&](int r) -> long long {
      if (k0 + r >= p.Sk) return -1;
      return b * p.k_s0 + static_cast<long long>(k0 + r) * p.k_s1 +
             kh * p.k_s2;
    }, p.vec);
    load_rows<T, D, RS, BW_THREADS>(v_s, vg, BN, [&](int r) -> long long {
      if (k0 + r >= p.Sk) return -1;
      return b * p.v_s0 + static_cast<long long>(k0 + r) * p.v_s1 +
             kh * p.v_s2;
    }, p.vec);
    load_q(it_begin, 0);
  }
  cp_async_commit();

  float dk[DW / 8][4], dv[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[j][e] = 0.0f;
      dv[j][e] = 0.0f;
    }
  const int key_lo = k0 + 16 * grp + g;     // this thread's keys: +0, +8

  for (int it = it_begin; it < it_end; ++it) {
    const int s = (it - it_begin) & 1;
    cp_async_wait<0>();
    // the tile is in; every warp is done with the last one and with the
    // exchange, so the last tile's stage takes the next
    __syncthreads();
    if (it + 1 < it_end) {
      load_q(it + 1, s ^ 1);
      cp_async_commit();
    }
    const T* qs = qd_s + 2 * s * BQ * RS;
    const T* dos = qs + BQ * RS;
    const float* ls = ld_s + 2 * s * BQ;
    const int i0 = i_lo + (it % nq) * BQ;

    // S^T = K Q^T and dP^T = V dO^T over this warp's slice of D: 16 keys x
    // BQ query rows
    float st[QN][4], dpt[QN][4];
#pragma unroll
    for (int j = 0; j < QN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[j][e] = 0.0f;
        dpt[j][e] = 0.0f;
      }
#pragma unroll
    for (int kk = 0; kk < DW / 16; ++kk) {
      FragA<T> ak, av;
      load_a(ak, k_s, RS, 16 * grp, d0 + 16 * kk);
      load_a(av, v_s, RS, 16 * grp, d0 + 16 * kk);
#pragma unroll
      for (int nn = 0; nn < BQ / 16; ++nn) {
        FragB<T> bq, bo;
        load_b_nk(bq, qs, RS, 16 * nn, d0 + 16 * kk);
        load_b_nk(bo, dos, RS, 16 * nn, d0 + 16 * kk);
        mma2(st[2 * nn], st[2 * nn + 1], ak, bq);
        mma2(dpt[2 * nn], dpt[2 * nn + 1], av, bo);
      }
    }
    if (DSPLIT > 1) {
      // the group's partial sums, each lane's fragments as float4s at its
      // own slots, then summed by every warp of the group in the same order
      float4* mine = reinterpret_cast<float4*>(xch + warp * S::XW);
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        mine[j * 32 + lane] = make_float4(st[j][0], st[j][1], st[j][2],
                                          st[j][3]);
        mine[(QN + j) * 32 + lane] = make_float4(dpt[j][0], dpt[j][1],
                                                 dpt[j][2], dpt[j][3]);
      }
      __syncthreads();
      const float4* first =
          reinterpret_cast<const float4*>(xch + grp * DSPLIT * S::XW);
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        float4 a = first[j * 32 + lane], d = first[(QN + j) * 32 + lane];
#pragma unroll
        for (int w = 1; w < DSPLIT; ++w) {
          const float4 x = first[w * S::XW / 4 + j * 32 + lane];
          const float4 y = first[w * S::XW / 4 + (QN + j) * 32 + lane];
          a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
          d.x += y.x; d.y += y.y; d.z += y.z; d.w += y.w;
        }
        st[j][0] = a.x; st[j][1] = a.y; st[j][2] = a.z; st[j][3] = a.w;
        dpt[j][0] = d.x; dpt[j][1] = d.y; dpt[j][2] = d.z; dpt[j][3] = d.w;
      }
    }

    // P^T = exp(scale S^T - lse) where valid, dS^T = P^T o (dP^T - Delta)
#pragma unroll
    for (int j = 0; j < QN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * c + e;
        const int i = i0 + col;
        const int qp = p.q_offset + i;
        const float lse = ls[col], dl = ls[BQ + col];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const bool ok = i <= i_hi && key_ok(p, key_lo + 8 * hi, qp);
          const float pt = ok ? expf(st[j][2 * hi + e] * p.scale - lse) : 0.0f;
          dpt[j][2 * hi + e] = pt * (dpt[j][2 * hi + e] - dl);
          st[j][2 * hi + e] = pt;
        }
      }

    // dV += P^T dO, dK += dS^T Q over this warp's slice of D
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      FragA<T> ap, ads;
      a_from_c(ap, st[2 * kk], st[2 * kk + 1]);
      a_from_c(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int nn = 0; nn < DW / 16; ++nn) {
        FragB<T> bo, bq;
        load_b_kn(bo, dos, RS, 16 * kk, d0 + 16 * nn);
        load_b_kn(bq, qs, RS, 16 * kk, d0 + 16 * nn);
        mma2(dv[2 * nn], dv[2 * nn + 1], ap, bo);
        mma2(dk[2 * nn], dk[2 * nn + 1], ads, bq);
      }
    }
  }
  cp_async_wait<0>();

  // one split: dK and dV in T; several: fp32 partials, summed in order by
  // flash_bwd_reduce_kernel
  const long long n_out = static_cast<long long>(p.B) * p.Sk * p.K * D;
  float* wk = bp.splits > 1 ? bp.ws + split * n_out : nullptr;
  float* wv = bp.splits > 1 ? bp.ws + (bp.splits + split) * n_out : nullptr;
  T* dkg = static_cast<T*>(bp.dk);
  T* dvg = static_cast<T*>(bp.dv);
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int key = key_lo + 8 * hi;
    if (key >= p.Sk) continue;
    const long long o =
        ((static_cast<long long>(b) * p.Sk + key) * p.K + kh) * D + d0;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      const long long e = o + 8 * j + 2 * c;
      const float k0v = dk[j][2 * hi] * p.scale;
      const float k1v = dk[j][2 * hi + 1] * p.scale;
      if (bp.splits == 1) {
        store2(dkg + e, k0v, k1v);
        store2(dvg + e, dv[j][2 * hi], dv[j][2 * hi + 1]);
      } else {
        store2(wk + e, k0v, k1v);
        store2(wv + e, dv[j][2 * hi], dv[j][2 * hi + 1]);
      }
    }
  }
}

// dK and dV: the splits' fp32 partials summed in split order, in T
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_reduce_kernel(BwdParams bp,
                                                               long long n) {
  T* dk = static_cast<T*>(bp.dk);
  T* dv = static_cast<T*>(bp.dv);
  const long long step = static_cast<long long>(gridDim.x) * 256 * 2;
  for (long long e = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x)
                     * 2; e < n; e += step) {
    float k0 = 0.0f, k1 = 0.0f, v0 = 0.0f, v1 = 0.0f;
    for (int s = 0; s < bp.splits; ++s) {
      const float2 a = *reinterpret_cast<const float2*>(bp.ws + s * n + e);
      const float2 b = *reinterpret_cast<const float2*>(
          bp.ws + (bp.splits + s) * n + e);
      k0 += a.x;
      k1 += a.y;
      v0 += b.x;
      v1 += b.y;
    }
    store2(dk + e, k0, k1);
    store2(dv + e, v0, v1);
  }
}

// pass 2: the forward's layout, key tiles of 16 where a row is 512 bytes
template <typename T, int D>
struct DqShape {
  static constexpr int BN = D * sizeof(T) >= 512 ? 16 : 64;
  static constexpr int RS = D + 16 / sizeof(T);
  static constexpr int KV = BN * RS;
  static constexpr size_t SMEM =
      sizeof(T) * (2 * static_cast<size_t>(ROWS) * RS + 4 * KV);
};

// bf16 below D = 256 holds at most 168 registers, so three blocks fit an SM
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS,
                                  sizeof(T) == 2 ? (D < 256 ? 3 : 2) : 1)
    flash_bwd_dq_kernel(BwdParams bp) {
  using S = DqShape<T, D>;
  constexpr int BN = S::BN, RS = S::RS, NT = BN / 8, ND = D / 8;
  const Params& p = bp.f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);   // (ROWS, RS)
  T* do_s = q_s + ROWS * RS;                 // (ROWS, RS)
  T* kv_s = do_s + ROWS * RS;                // stage s: K at 2 s KV, V next

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const RowBlock rb = row_block(p);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  const long long do_s1 = static_cast<long long>(p.H) * D;

  int t_begin, t_end;
  live_tiles(p, rb, BN, t_begin, t_end);
  auto load_kv = [&](int t, int s) {
    const int k0 = t * BN;
    T* ks = kv_s + 2 * s * S::KV;
    load_rows<T, D, RS, TC_THREADS>(ks, kg, BN, [&](int r) -> long long {
      if (k0 + r >= p.Sk) return -1;
      return rb.b * p.k_s0 + static_cast<long long>(k0 + r) * p.k_s1 +
             rb.kh * p.k_s2;
    }, p.vec);
    load_rows<T, D, RS, TC_THREADS>(ks + S::KV, vg, BN,
                                    [&](int r) -> long long {
      if (k0 + r >= p.Sk) return -1;
      return rb.b * p.v_s0 + static_cast<long long>(k0 + r) * p.v_s1 +
             rb.kh * p.v_s2;
    }, p.vec);
  };
  load_rows<T, D, RS, TC_THREADS>(q_s, static_cast<const T*>(p.q), ROWS,
                                  [&](int r) -> long long {
    return row_offset(p, rb, r, p.q_s0, p.q_s1, p.q_s2);
  }, p.vec);
  load_rows<T, D, RS, TC_THREADS>(do_s, static_cast<const T*>(bp.dout), ROWS,
                                  [&](int r) -> long long {
    return row_offset(p, rb, r, do_s1 * p.Sq, do_s1, D);
  }, p.vec);
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();

  // this thread's rows, their lse and Delta
  const int r_lo = 16 * warp + g;
  int pos[2];
  bool row_ok[2];
  float lse[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    row_ok[half] = r < rb.n_rows;
    pos[half] = rb.q_lo + r / p.G;
    const long long o = (static_cast<long long>(rb.b) * p.H + rb.kh * p.G +
                         r % p.G) * p.Sq + rb.q0 + r / p.G;
    lse[half] = row_ok[half] ? p.lse[o] : 0.0f;
    dl[half] = row_ok[half] ? bp.delta[o] : 0.0f;
  }

  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;

  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    const int s = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < t_end) {  // so its stage takes tile t + 1
      load_kv(t + 1, s ^ 1);
      cp_async_commit();
    }
    const T* ks = kv_s + 2 * s * S::KV;
    const T* vs = ks + S::KV;

    // S = Q K^T and dP = dO V^T, 16 rows x BN keys a warp
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = 0.0f;
        dp[j][e] = 0.0f;
      }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA<T> aq, ao;
      load_a(aq, q_s, RS, 16 * warp, 16 * kk);
      load_a(ao, do_s, RS, 16 * warp, 16 * kk);
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        FragB<T> bk, bv;
        load_b_nk(bk, ks, RS, 16 * nn, 16 * kk);
        load_b_nk(bv, vs, RS, 16 * nn, 16 * kk);
        mma2(sc[2 * nn], sc[2 * nn + 1], aq, bk);
        mma2(dp[2 * nn], dp[2 * nn + 1], ao, bv);
      }
    }

    // dS = P o (dP - Delta), P = exp(scale S - lse) where valid
    const int k0 = t * BN;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * c + e;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const bool ok = row_ok[half] && key_ok(p, key, pos[half]);
          const float pr =
              ok ? expf(sc[j][2 * half + e] * p.scale - lse[half]) : 0.0f;
          sc[j][2 * half + e] = pr * (dp[j][2 * half + e] - dl[half]);
        }
      }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      FragA<T> a;
      a_from_c(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        FragB<T> bk;
        load_b_kn(bk, ks, RS, 16 * kk, 16 * nn);
        mma2(dq[2 * nn], dq[2 * nn + 1], a, bk);
      }
    }
  }
  cp_async_wait<0>();

  T* dqg = static_cast<T*>(bp.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (!row_ok[half]) continue;
    T* row = dqg + ((static_cast<long long>(rb.b) * p.Sq + rb.q0 + r / p.G) *
                        p.H + rb.kh * p.G + r % p.G) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store2(row + 8 * j + 2 * c, dq[j][2 * half] * p.scale,
             dq[j][2 * half + 1] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

int row_blocks(const Params& p) {
  return ((p.Sq + p.block_m - 1) / p.block_m) * p.K * p.B;
}

template <typename T, int D>
int launch_fma(const Params& p, cudaStream_t stream) {
  const size_t smem = Shape<D>::SMEM;
  if (int e = set_smem(flash_kernel<T, D>, smem)) return e;
  const dim3 grid((p.Sq + p.block_m - 1) / p.block_m, p.K, p.B);
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_tc(const Params& p, cudaStream_t stream) {
  const size_t smem = TcShape<T, D>::SMEM;
  if (int e = set_smem(flash_tc_kernel<T, D>, smem)) return e;
  flash_tc_kernel<T, D><<<row_blocks(p), TC_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled from the driver, fetched through the runtime, so
// that the library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The TMA descriptor of a bf16 (B, positions, heads, D) tensor seen as 4-d
// (D, heads, positions, B), element strides s_head, s_pos, s_b, read in
// boxes of (width, box_heads, box_pos, 1) with the swizzle of 2 x width
// bytes; past either end of an axis the box reads zeros. 0 or an error.
int tensor_map(CUtensorMap* map, const void* ptr, int D, int heads,
               int positions, int B, long long s_head, long long s_pos,
               long long s_b, int width, int box_heads, int box_pos) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(positions),
                        static_cast<cuuint64_t>(B)};
  const long long strides_el[3] = {s_head, s_pos, s_b};
  cuuint64_t strides[3];
  cuuint64_t packed = static_cast<cuuint64_t>(D) * 2;
  for (int i = 0; i < 3; ++i) {
    // an axis of one element is never stepped: give it the packed stride
    strides[i] = dims[i + 1] == 1 ? packed
                                  : static_cast<cuuint64_t>(strides_el[i]) * 2;
    packed = strides[i] * dims[i + 1];
  }
  cuuint32_t box[4] = {static_cast<cuuint32_t>(width),
                       static_cast<cuuint32_t>(box_heads),
                       static_cast<cuuint32_t>(box_pos), 1u};
  cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUtensorMapSwizzle swizzle =
      width == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  n = max(n, 1);
  if (dev < 64) cached[dev] = n;
  return n;
}

template <int D>
int launch_wgmma(const Params& p0, cudaStream_t stream) {
  using H = hop::Hop<D>;
  Params p = p0;
  const int npos = hop::WG_ROWS / p.G;
  p.block_m = hop::C * npos;
  const int wa = D >= 64 ? 64 : D;   // the 64-column regions' width
  const int wb = H::WB ? H::WB : wa;  // the last region's
  hop::Maps m;
  int e = 0;
  if (!e) e = tensor_map(&m.q_a, p.q, D, p.H, p.Sq, p.B, p.q_s2, p.q_s1,
                         p.q_s0, wa, p.G, npos);
  if (!e) e = tensor_map(&m.q_b, p.q, D, p.H, p.Sq, p.B, p.q_s2, p.q_s1,
                         p.q_s0, wb, p.G, npos);
  if (!e) e = tensor_map(&m.k_a, p.k, D, p.K, p.Sk, p.B, p.k_s2, p.k_s1,
                         p.k_s0, wa, 1, hop::BN);
  if (!e) e = tensor_map(&m.k_b, p.k, D, p.K, p.Sk, p.B, p.k_s2, p.k_s1,
                         p.k_s0, wb, 1, hop::BN);
  if (!e) e = tensor_map(&m.v_a, p.v, D, p.K, p.Sk, p.B, p.v_s2, p.v_s1,
                         p.v_s0, wa, 1, hop::BN);
  if (!e) e = tensor_map(&m.v_b, p.v, D, p.K, p.Sk, p.B, p.v_s2, p.v_s1,
                         p.v_s0, wb, 1, hop::BN);
  if (e) return e;
  if ((e = set_smem(hop::flash_fwd_wgmma_kernel<D>, H::SMEM))) return e;
  const int grid = min(hop::n_items(p), sm_count());
  hop::flash_fwd_wgmma_kernel<D>
      <<<grid, hop::THREADS, H::SMEM, stream>>>(p, m);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1 has one block per (key tile, KV head, batch row). Where that is
// fewer than SPLIT_TARGET blocks and either too few to fill the card (under
// SPLIT_TARGET / 4, about two an SM) or a full causal triangle, in which key
// tile 0 sees every query and the last tile few (gemma3-1b's global layer
// at B = 2, S = 4096: 256 blocks, one uneven wave on 132 SMs), each key
// tile's query range is split over several blocks, whose fp32 partials a
// last pass sums in order. A windowed layer's tiles do equal work and are
// not split.
constexpr int SPLIT_TARGET = 1024;
constexpr int MAX_SPLITS = 16;

template <typename T, int D>
int kv_splits(int B, int Sk, int K, int causal, int window) {
  const long long blocks =
      static_cast<long long>((Sk + KvShape<T, D>::BN - 1) /
                             KvShape<T, D>::BN) * K * B;
  const bool few = blocks < SPLIT_TARGET / 4;
  const bool triangle = causal && (window <= 0 || window >= Sk);
  if (blocks >= SPLIT_TARGET || !(few || triangle)) return 1;
  return static_cast<int>(
      min(static_cast<long long>(MAX_SPLITS),
          (SPLIT_TARGET + blocks - 1) / blocks));
}

template <typename T, int D>
int launch_bwd(BwdParams bp, cudaStream_t stream) {
  const Params& p = bp.f;
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.H;
  flash_bwd_delta_kernel<T, D>
      <<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(bp);
  if (int e = static_cast<int>(cudaGetLastError())) return e;

  using KS = KvShape<T, D>;
  bp.splits = kv_splits<T, D>(p.B, p.Sk, p.K, p.causal, p.window);
  if (bp.splits > 1 && bp.ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (int e = set_smem(flash_bwd_dkdv_kernel<T, D>, KS::SMEM)) return e;
  const int kv_blocks =
      ((p.Sk + KS::BN - 1) / KS::BN) * bp.splits * p.K * p.B;
  flash_bwd_dkdv_kernel<T, D><<<kv_blocks, BW_THREADS, KS::SMEM, stream>>>(bp);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  if (bp.splits > 1) {
    const long long n = static_cast<long long>(p.B) * p.Sk * p.K * D;
    const long long blocks = min((n / 2 + 255) / 256, 4096LL);
    flash_bwd_reduce_kernel<T><<<static_cast<unsigned>(blocks), 256, 0,
                                 stream>>>(bp, n);
    if (int e = static_cast<int>(cudaGetLastError())) return e;
  }

  const size_t smem = DqShape<T, D>::SMEM;
  if (int e = set_smem(flash_bwd_dq_kernel<T, D>, smem)) return e;
  flash_bwd_dq_kernel<T, D><<<row_blocks(p), TC_THREADS, smem, stream>>>(bp);
  return static_cast<int>(cudaGetLastError());
}

// The forward kernels by design: 0 the FMA design (float32, and bf16 on
// request), 1 mma.sync on the tensor cores (bf16, D = 256), 2 the Hopper
// design (bf16, D <= 128). A design the dtype and D do not take is refused.
constexpr int FMA = 0, MMA = 1, WGMMA = 2;

template <typename T, int D>
int forward(const Params& p, int design, cudaStream_t stream) {
  if (design == FMA) return launch_fma<T, D>(p, stream);
  if constexpr (sizeof(T) == 2 && D <= 128) {
    if (design == WGMMA) return launch_wgmma<D>(p, stream);
  } else if constexpr (sizeof(T) == 2) {
    if (design == MMA) return launch_tc<bf16, D>(p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int fwd_by_dim(const Params& p, int D, int design, cudaStream_t s) {
  switch (D) {
    case 16: return forward<T, 16>(p, design, s);
    case 32: return forward<T, 32>(p, design, s);
    case 64: return forward<T, 64>(p, design, s);
    case 80: return forward<T, 80>(p, design, s);
    case 128: return forward<T, 128>(p, design, s);
    case 256: return forward<T, 256>(p, design, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int splits_by_dim(int B, int Sk, int K, int D, int causal, int window) {
  switch (D) {
    case 16: return kv_splits<T, 16>(B, Sk, K, causal, window);
    case 32: return kv_splits<T, 32>(B, Sk, K, causal, window);
    case 64: return kv_splits<T, 64>(B, Sk, K, causal, window);
    case 80: return kv_splits<T, 80>(B, Sk, K, causal, window);
    case 128: return kv_splits<T, 128>(B, Sk, K, causal, window);
    case 256: return kv_splits<T, 256>(B, Sk, K, causal, window);
    default: return 0;
  }
}

template <typename T>
int bwd_by_dim(const BwdParams& bp, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch_bwd<T, 16>(bp, s);
    case 32: return launch_bwd<T, 32>(bp, s);
    case 64: return launch_bwd<T, 64>(bp, s);
    case 80: return launch_bwd<T, 80>(bp, s);
    case 128: return launch_bwd<T, 128>(bp, s);
    case 256: return launch_bwd<T, 256>(bp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// every grid fits gridDim.x
bool shape_ok(int B, int Sq, int Sk, int H, int K, int q_offset) {
  return B >= 1 && Sq >= 1 && Sk >= 1 && K >= 1 && H % K == 0 &&
         H / K <= ROWS && q_offset >= 0 &&
         static_cast<long long>(max(Sq, Sk)) * K * B < (1LL << 31);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out share it). D is one of 16,
// 32, 64, 80, 128, 256; G = H / K is at most 64. Strides are in elements;
// the last axis of q, k and v is contiguous, out (B, Sq, H, D) and lse
// (B, H, Sq, float32) are contiguous. design: 0 the fp32 FMA design (any
// dtype), 1 mma.sync (bf16, D = 256), 2 the Hopper design (bf16, D <= 128,
// 16-byte aligned bases and strides: TMA reads q, k and v). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    float* lse, int B, int Sq, int Sk, int H, int K, int D, long long q_s0,
    long long q_s1, long long q_s2, long long k_s0, long long k_s1,
    long long k_s2, long long v_s0, long long v_s1, long long v_s2,
    float scale, int causal, int window, int q_offset, int vec, int design,
    void* stream) {
  if (!shape_ok(B, Sq, Sk, H, K, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  Params p = {q, k, v, out, lse, B, Sq, Sk, H, K, G, ROWS / G,
              q_s0, q_s1, q_s2, k_s0, k_s1, k_s2, v_s0, v_s1, v_s2,
              scale, causal, window, q_offset, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_by_dim<float>(p, D, design, s);
  if (dtype == 1) return fwd_by_dim<bf16>(p, D, design, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Float32 elements of scratch that flash_attention_bwd_launch needs for
// these shapes (0: none), or -1 for shapes it does not take.
extern "C" long long flash_attention_bwd_workspace(int dtype, int B, int Sk,
                                                   int K, int D, int causal,
                                                   int window) {
  if (B < 1 || Sk < 1 || K < 1) return -1;
  const int splits =
      dtype == 0   ? splits_by_dim<float>(B, Sk, K, D, causal, window)
      : dtype == 1 ? splits_by_dim<bf16>(B, Sk, K, D, causal, window)
                   : 0;
  if (splits < 1) return -1;
  if (splits == 1) return 0;
  return 2LL * splits * B * Sk * K * D;
}

// The backward: dq (B, Sq, H, D), dk and dv (B, Sk, K, D), all contiguous
// in the inputs' dtype, from q, k, v (strided as in the forward), out, dout
// (B, Sq, H, D) and lse (B, H, Sq) contiguous. delta (B, H, Sq, float32) and
// ws (flash_attention_bwd_workspace floats) are scratch. Kernels on
// `stream`: Delta, dK and dV (and the sum of their partials), dQ.
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, float* ws, void* dq,
    void* dk, void* dv, int B, int Sq, int Sk, int H, int K, int D,
    long long q_s0,
    long long q_s1, long long q_s2, long long k_s0, long long k_s1,
    long long k_s2, long long v_s0, long long v_s1, long long v_s2,
    float scale, int causal, int window, int q_offset, int vec,
    void* stream) {
  if (!shape_ok(B, Sq, Sk, H, K, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  BwdParams bp = {{q, k, v, const_cast<void*>(out), const_cast<float*>(lse),
                   B, Sq, Sk, H, K, G, ROWS / G, q_s0, q_s1, q_s2, k_s0,
                   k_s1, k_s2, v_s0, v_s1, v_s2, scale, causal, window,
                   q_offset, vec},
                  dout, delta, dq, dk, dv, ws, 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_by_dim<float>(bp, D, s);
  if (dtype == 1) return bwd_by_dim<bf16>(bp, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

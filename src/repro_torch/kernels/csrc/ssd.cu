// The Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a), forward and
// backward, hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd.py: ssd_scan
// (pallas_call at :74, body _ssd_kernel :24, wrapper :62), widened to what
// the model's ssd_chunked (src/repro/models/ssd.py:54) computes around it:
// an optional initial state h0, the final state, and any sequence length.
// The JAX package has no backward kernel (its training differentiates the
// XLA ssd_chunked); the backward here is its exact gradient. The plain
// PyTorch versions are repro_torch/kernels/ssd.py::ssd_scan_plain and
// ssd_scan_bwd_plain.
//
// What it computes, for each batch row b and head h, over t = 0 .. S-1:
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T        (state (P, N), fp32)
//   y_t = h_t C_t                                      (the D skip is outside)
// in the chunked form: within a chunk of L steps, with cum the running sum
// of dt a from the chunk's start and hz the state at the chunk's start,
//   y_i = sum_{j<=i} M_ij x_j + exp(cum_i) hz C_i,
//         M_ij = (C_i.B_j) exp(cum_i - cum_j) dt_j,
//   h   = exp(cum_L) hz + sum_j coef_j x_j B_j^T,  coef_j = exp(cum_L - cum_j) dt_j.
// exp is formed only for j <= i, so no exponent above the diagonal (large
// and positive) is ever evaluated; every exponent taken is <= 0.
//
// The gradient, with gy and g_hfin the cotangents: the adjoint of the state
// at each chunk's end, Dn, runs backward over chunks like the state runs
// forward (Dn of the last chunk is g_hfin; D(start of z) = exp(cum_L) Dn +
// sum_i exp(cum_i) gy_i C_i^T, and dh0 is D at the start of chunk 0); then
// within a chunk, with dM_ij = gy_i.x_j and dCB_ij = dM_ij exp(cum_i -
// cum_j) dt_j for j <= i,
//   dx_j = sum_i M_ij gy_i + coef_j Dn B_j
//   dB_j = sum_i dCB_ij C_i + coef_j Dn^T x_j            (summed over heads)
//   dC_i = sum_j dCB_ij B_j + exp(cum_i) hz^T gy_i       (summed over heads)
// and dt through its two roles: directly (the dt_j factor of M and coef) and
// through cum, whose cotangent dcum is summed from the end of the chunk
// (dla_j = sum_{k>=j} dcum_k; ddt_j += a dla_j, da += sum dt_j dla_j).
//
// Types: x, B, C (and gy) are float32 or bfloat16, one type; dt, a, h0, the
// states and their gradients float32; y, dx, dB, dC in x's type. Sums are
// fp32, in a fixed order, with no atomics: every output is the same from
// run to run.
//
// What bounds it on this card: at mamba2-130m's training shape (B=8,
// S=2048, H=24, P=64, N=128, bf16) the forward must move ~117 MB (x and y
// 50 MB each, B and C 8 MB, dt 1.6 MB, the final state 6 MB), ~35 us at
// 3.35 TB/s, against ~20 GFLOP, ~20 us at the bf16 tensor-core rate; the
// backward ~171 MB and about twice the operations: bytes bound both.
//
// The design, simple before fast: Mamba-2's three phases, on mma.sync
// m16n8k16 tensor cores (bf16 in, fp32 accumulate) at a chunk of L = 64.
//  1. ssd_state_kernel, one block per (b, chunk, head): the chunk's own
//     state contribution sum_j w_j u_j v_j^T (forward: u = x, v = B, w =
//     coef; the backward's adjoint: u = gy, v = C, w = exp(cum)), written
//     to an fp32 workspace (B, Z, H, P, N). In bf16 the scaled operand w v
//     is split into its bf16 rounding and the remainder, two products, so
//     the states keep fp32 accuracy (the final state is held to 1e-3 of its
//     largest entry, which one bf16 rounding of every term would exhaust).
//  2. ssd_pass_kernel, four state entries a thread: the short serial pass
//     over chunks (forward from h0, or backward from g_hfin) in fp32,
//     writing the state at each chunk's start (or the adjoint at its end)
//     in x's type, which is how the next phase's tensor cores take it, and
//     the final state (or dh0) in fp32.
//  3. forward: ssd_out_kernel, one block per (b, chunk, head): C.B^T, M,
//     then y = M.X + exp(cum) C.hz^T; M goes from the accumulator straight
//     into the A operand. Backward: ssd_bwd_kernel, one block per (b,
//     chunk) that loops over the heads: C.B^T once; per head dM = gY.X^T,
//     dX = M^T.gY + coef B.Dn^T, dB += coef X.Dn, dC += exp(cum) gY.hz, and
//     the dt and a terms; dCB summed over the heads in registers and
//     applied once. dB and dC are summed over heads inside the block, and
//     da's per-chunk parts are summed by ssd_da_kernel in a fixed order: no
//     sum across blocks is racy.
// The chunk states are recomputed in the backward, not saved by the
// forward: the workspace is transient, 201 MB of fp32 contributions and
// 100 MB of bf16 states (another 100 MB of adjoints in the backward) at
// the training shape, where saving the states would hold 2.4 GB across 24
// layers. Operands that are themselves results (M, dCB, the states) are
// rounded to bf16 for the tensor cores; float32 inputs run the same
// fragment layout as fp32 FMAs, so the float32 path is exact to fp32
// rounding. The ragged last chunk is masked: rows past S load as zeros
// with dt = 0, which neither decays nor feeds the state (exactly the
// reference's zero padding), and are not written. x, B and C are read in
// place through their strides (x is a view of the conv output), with
// 16-byte cp.async copies where every row is 16-byte aligned. Loading the
// next head of the backward during this one's products did not change its
// time (measured on the H100); wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int L = 64;                 // steps per chunk
constexpr int MAX_P = 64;             // head_dim
constexpr int MAX_N = 128;            // d_state
constexpr int TS = MAX_P + 8;         // row stride of (L, P) and (L, L) tiles
constexpr int NS = MAX_N + 8;         // row stride of (L, N) and state tiles
static_assert(MAX_P == L, "(L, P) and (L, L) tiles share a row stride");

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

// wait until this thread's copies have landed (a barrier then publishes
// them to the block)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
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

template <typename T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ int pad16(int v) { return (v + 15) & ~15; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// over the 4 lanes of a quad (the lanes that share an mma row)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// over the 8 lanes that share an mma column (lane % 4)
__device__ __forceinline__ float column_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// The shape and the inputs every kernel reads.
struct Shape {
  int B, S, H, P, N, Z;       // Z = ceil(S / L) chunks
  const float* dt;            // (B, S, H)
  const float* a;             // (H,)
  long long ds0, ds1, ds2;    // dt's strides
  int vec;                    // every row of the (L, *) inputs 16-byte aligned
};

// Rows 0..L-1 of a chunk into dst (row stride ld), columns padded with
// zeros to a multiple of 16; rows at or past `valid` are zeros. With `vec`
// the copies are asynchronous: cp_async_wait_all, then a barrier.
template <typename T, int NT>
__device__ void load_tile(T* dst, int ld, const T* src, long long rs,
                          int valid, int cols, int vec) {
  const int pc = pad16(cols);
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per = pc / E;
    for (int i = threadIdx.x; i < L * per; i += NT) {
      const int r = i / per, c = (i - r * per) * E;
      T* d = dst + r * ld + c;
      if (r < valid && c < cols)
        cp_async16(d, src + r * rs + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < L * pc; i += NT) {
      const int r = i / pc, c = i - r * pc;
      dst[r * ld + c] = (r < valid && c < cols) ? src[r * rs + c]
                                                : from_f<T>(0.0f);
    }
  }
}

// A (P, N) state of T, contiguous, into dst (row stride NS), zero-padded:
// a tile of L >= P rows of which P are valid.
template <typename T, int NT>
__device__ void load_state(T* dst, const T* src, int P, int N) {
  static_assert(MAX_P <= L, "a state fits a tile");
  load_tile<T, NT>(dst, NS, src, N, P, N, (N * sizeof(T)) % 16 == 0);
}

// Warp 0 of the block: dt_s[j] = dt_j (0 at and past `valid`) and cum_s[j]
// = sum_{k<=j} dt_k a over the chunk; lane l owns rows 2l and 2l+1. The
// roundings are explicit, so every kernel gets the same bits.
__device__ void chunk_cum(const float* dtp, long long ds1, int valid,
                          float a, float* dt_s, float* cum_s) {
  const int lane = threadIdx.x & 31;
  const int j = 2 * lane;
  const float d0 = j < valid ? dtp[j * ds1] : 0.0f;
  const float d1 = j + 1 < valid ? dtp[(j + 1) * ds1] : 0.0f;
  const float l0 = __fmul_rn(d0, a);
  const float pair = __fadd_rn(l0, __fmul_rn(d1, a));
  float incl = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, v);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  cum_s[j] = __fadd_rn(excl, l0);
  cum_s[j + 1] = __fadd_rn(excl, pair);
  dt_s[j] = d0;
  dt_s[j + 1] = d1;
}

// ---------------------------------------------------------------------------
// m16n8k16 fragments. With g = lane / 4 and c = lane % 4, a lane holds
// A (16 x 16) at (g, 2c..2c+1), (g+8, 2c..), (g, 2c+8..), (g+8, 2c+8..);
// B (16 x 8, k x n) at (k = 2c..2c+1, n = g), (k = 2c+8.., n = g); and the
// accumulator C (16 x 8) at (g, 2c..2c+1), (g+8, 2c..2c+1). A FragB holds
// two adjacent n8 tiles. bf16 fragments feed the tensor cores; float32
// fragments hold the same elements and their product is done as fp32 FMAs,
// the operands gathered by shuffles.
// ---------------------------------------------------------------------------

template <typename T> struct FragA;
template <> struct FragA<bf16> { uint32_t x[4]; };
template <> struct FragA<float> { float x[8]; };
template <typename T> struct FragB;
template <> struct FragB<bf16> { uint32_t x[4]; };
template <> struct FragB<float> { float x[8]; };

// fragments from any element source: at(m, k) for A, at(k, n) for B
template <typename F>
__device__ __forceinline__ void frag_a(FragA<bf16>& f, F at) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  f.x[0] = pack_bf16(at(g, c), at(g, c + 1));
  f.x[1] = pack_bf16(at(g + 8, c), at(g + 8, c + 1));
  f.x[2] = pack_bf16(at(g, c + 8), at(g, c + 9));
  f.x[3] = pack_bf16(at(g + 8, c + 8), at(g + 8, c + 9));
}
template <typename F>
__device__ __forceinline__ void frag_a(FragA<float>& f, F at) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  f.x[0] = at(g, c);         f.x[1] = at(g, c + 1);
  f.x[2] = at(g + 8, c);     f.x[3] = at(g + 8, c + 1);
  f.x[4] = at(g, c + 8);     f.x[5] = at(g, c + 9);
  f.x[6] = at(g + 8, c + 8); f.x[7] = at(g + 8, c + 9);
}
template <typename F>
__device__ __forceinline__ void frag_b(FragB<bf16>& f, F at) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    f.x[2 * j] = pack_bf16(at(c, 8 * j + g), at(c + 1, 8 * j + g));
    f.x[2 * j + 1] = pack_bf16(at(c + 8, 8 * j + g), at(c + 9, 8 * j + g));
  }
}
template <typename F>
__device__ __forceinline__ void frag_b(FragB<float>& f, F at) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    f.x[4 * j] = at(c, 8 * j + g);
    f.x[4 * j + 1] = at(c + 1, 8 * j + g);
    f.x[4 * j + 2] = at(c + 8, 8 * j + g);
    f.x[4 * j + 3] = at(c + 9, 8 * j + g);
  }
}

// Tiles of T in shared memory. A(m, k) = s[(m0 + m) * rs + k0 + k]
__device__ __forceinline__ void tile_a(FragA<bf16>& f, const bf16* s, int rs,
                                       int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f.x, s + (m0 + (lane & 15)) * rs + k0 + ((lane >> 4) << 3));
}
__device__ __forceinline__ void tile_a(FragA<float>& f, const float* s,
                                       int rs, int m0, int k0) {
  frag_a(f, [&](int m, int k) { return s[(m0 + m) * rs + k0 + k]; });
}

// A(m, k) = s[(k0 + k) * rs + m0 + m]: the transpose of a stored tile
__device__ __forceinline__ void tile_a_t(FragA<bf16>& f, const bf16* s,
                                         int rs, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  const int q = lane >> 3;
  ldsm_x4_trans(f.x, s + (k0 + (lane & 7) + ((q >> 1) << 3)) * rs + m0 +
                         ((q & 1) << 3));
}
__device__ __forceinline__ void tile_a_t(FragA<float>& f, const float* s,
                                         int rs, int m0, int k0) {
  frag_a(f, [&](int m, int k) { return s[(k0 + k) * rs + m0 + m]; });
}

// B(k, n) = s[(n0 + n) * rs + k0 + k], n over two n8 tiles
__device__ __forceinline__ void tile_b_nk(FragB<bf16>& f, const bf16* s,
                                          int rs, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f.x, s + (n0 + ((lane >> 4) << 3) + (lane & 7)) * rs + k0 +
                   (((lane >> 3) & 1) << 3));
}
__device__ __forceinline__ void tile_b_nk(FragB<float>& f, const float* s,
                                          int rs, int n0, int k0) {
  frag_b(f, [&](int k, int n) { return s[(n0 + n) * rs + k0 + k]; });
}

// B(k, n) = s[(k0 + k) * rs + n0 + n], n over two n8 tiles
__device__ __forceinline__ void tile_b_kn(FragB<bf16>& f, const bf16* s,
                                          int rs, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(f.x, s + (k0 + (((lane >> 3) & 1) << 3) + (lane & 7)) * rs +
                         n0 + ((lane >> 4) << 3));
}
__device__ __forceinline__ void tile_b_kn(FragB<float>& f, const float* s,
                                          int rs, int k0, int n0) {
  frag_b(f, [&](int k, int n) { return s[(k0 + k) * rs + n0 + n]; });
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

// accumulator element e of n8 tile t: row g + 8 (e >> 1), column 8t + 2c +
// (e & 1), relative to the tile's origin
__device__ __forceinline__ int acc_row(int e) {
  return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int t, int e) {
  return 8 * t + 2 * (threadIdx.x & 3) + (e & 1);
}

// ---------------------------------------------------------------------------
// 1. a chunk's state contribution: out = sum_j w_j u_j v_j^T (P, N)
// ---------------------------------------------------------------------------

constexpr int STATE_THREADS = 128;

template <typename T>
constexpr size_t state_smem() {
  return (L * TS + (is_bf16<T> ? 2 : 1) * L * NS) * sizeof(T) +
         3 * L * sizeof(float);
}

// MODE 0: u = x, v = B, w_j = exp(cum_L - cum_j) dt_j; also writes the
// chunk's log decay cum_L to cl. MODE 1: u = gy, v = C, w_j = exp(cum_j).
template <typename T, int MODE>
__global__ void __launch_bounds__(STATE_THREADS)
ssd_state_kernel(Shape sh, const T* u, long long us0, long long us1,
                 long long us2, const T* v, long long vs0, long long vs1,
                 float* out, float* cl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* u_s = reinterpret_cast<T*>(smem_raw);         // (L, P)
  T* w_s = u_s + L * TS;                           // (L, N): w v rounded
  T* wl_s = w_s + L * NS;                          // bf16: the remainder
  float* dt_s = reinterpret_cast<float*>(
      w_s + (is_bf16<T> ? 2 : 1) * L * NS);
  float* cum_s = dt_s + L;
  float* wv_s = cum_s + L;

  const int tid = threadIdx.x;
  const int h = blockIdx.x % sh.H;
  const int bz = blockIdx.x / sh.H;
  const int z = bz % sh.Z, b = bz / sh.Z;
  const int c0 = z * L, valid = min(L, sh.S - c0);
  const int P = sh.P, N = sh.N;

  load_tile<T, STATE_THREADS>(u_s, TS, u + b * us0 + c0 * us1 + h * us2,
                              us1, valid, P, sh.vec);
  load_tile<T, STATE_THREADS>(w_s, NS, v + b * vs0 + c0 * vs1, vs1, valid,
                              N, sh.vec);
  if (tid < 32)
    chunk_cum(sh.dt + b * sh.ds0 + c0 * sh.ds1 + h * sh.ds2, sh.ds1, valid,
              sh.a[h], dt_s, cum_s);
  cp_async_wait_all();
  __syncthreads();
  if (tid < L)
    wv_s[tid] = MODE == 0 ? expf(cum_s[L - 1] - cum_s[tid]) * dt_s[tid]
                          : expf(cum_s[tid]);
  if (MODE == 0 && tid == 0) cl[blockIdx.x] = cum_s[L - 1];
  __syncthreads();
  const int pn = pad16(N);
  for (int i = tid; i < L * pn; i += STATE_THREADS) {
    const int r = i / pn, c = i - r * pn;
    const float val = wv_s[r] * to_f(w_s[r * NS + c]);
    const T hi = from_f<T>(val);
    w_s[r * NS + c] = hi;
    if constexpr (is_bf16<T>) wl_s[r * NS + c] = from_f<T>(val - to_f(hi));
  }
  __syncthreads();

  // out (P, N) = U^T . W; warp w owns p rows 16w .. 16w + 15
  const int m0 = 16 * (tid >> 5);
  if (m0 >= pad16(P)) return;
  const int npairs = pn / 16;
  float acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < L / 16; ++kk) {
    FragA<T> fa;
    tile_a_t(fa, u_s, TS, m0, 16 * kk);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q >= npairs) break;
      FragB<T> fb;
      tile_b_kn(fb, w_s, NS, 16 * kk, 16 * q);
      mma2(acc[2 * q], acc[2 * q + 1], fa, fb);
      if constexpr (is_bf16<T>) {
        tile_b_kn(fb, wl_s, NS, 16 * kk, 16 * q);
        mma2(acc[2 * q], acc[2 * q + 1], fa, fb);
      }
    }
  }
  float* o = out + static_cast<long long>(blockIdx.x) * P * N;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (t >= 2 * npairs) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + acc_row(e), c = acc_col(t, e);
      if (r < P && c < N) o[r * N + c] = acc[t][e];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the serial pass over chunks, one thread per state entry
// ---------------------------------------------------------------------------

constexpr int PASS_THREADS = 256;

// contrib[b, z, h] holds chunk z's contribution; out[b, z, h] gets the
// running value before chunk z is folded in (forward: the state at its
// start; reverse: the adjoint at its end), rounded to T: its readers use it
// as a tensor-core operand. run = exp(cl[b, z, h]) run + contribution, in
// fp32. The last run goes to `last` (the final state or dh0) when it is not
// null. A thread owns V adjacent entries (16-byte loads when V = 4), and
// the chunks go in batches of 8 whose loads are all issued before the
// batch's first step: one memory round trip a batch, not a chunk.
constexpr int PASS_BATCH = 8;

template <int V>
__device__ __forceinline__ void load_v(float (&v)[V], const float* src) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = src[i];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* dst, const float (&v)[V]) {
  if constexpr (V == 4 && is_bf16<T>) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = from_f<T>(v[i]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_pass_kernel(const float* __restrict__ contrib, T* __restrict__ out,
                const float* __restrict__ cl, const float* __restrict__ init,
                float* __restrict__ last, int Z, int H, int PN,
                int reverse) {
  const int e = (blockIdx.x * PASS_THREADS + threadIdx.x) * V;
  if (e >= PN) return;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  float run[V];
  if (init != nullptr) {
    load_v<V>(run, init + static_cast<long long>(bh) * PN + e);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) run[i] = 0.0f;
  }
  for (int s0 = 0; s0 < Z; s0 += PASS_BATCH) {
    long long at[PASS_BATCH];
    float add[PASS_BATCH][V], lg[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      const int step = min(s0 + k, Z - 1);
      const int z = reverse ? Z - 1 - step : step;
      at[k] = (static_cast<long long>(b) * Z + z) * H + h;
      load_v<V>(add[k], contrib + at[k] * PN + e);
      lg[k] = cl[at[k]];
    }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (s0 + k >= Z) break;
      store_v<T, V>(out + at[k] * PN + e, run);
      const float decay = expf(lg[k]);
#pragma unroll
      for (int i = 0; i < V; ++i) run[i] = decay * run[i] + add[k][i];
    }
  }
  if (last != nullptr)
    store_v<float, V>(last + static_cast<long long>(bh) * PN + e, run);
}

// ---------------------------------------------------------------------------
// 3a. forward: the chunk's output, one block per (b, chunk, head)
// ---------------------------------------------------------------------------

constexpr int OUT_THREADS = 128;     // 4 warps, 16 rows of the chunk each

template <typename T>
constexpr size_t out_smem() {
  return (2 * L * NS + L * TS + MAX_P * NS) * sizeof(T) + 3 * L * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(OUT_THREADS)
ssd_out_kernel(Shape sh, const T* x, long long xs0, long long xs1,
               long long xs2, const T* bm, long long bs0, long long bs1,
               const T* cm, long long cs0, long long cs1, const T* states,
               T* y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* c_s = reinterpret_cast<T*>(smem_raw);         // (L, N)
  T* b_s = c_s + L * NS;                           // (L, N)
  T* x_s = b_s + L * NS;                           // (L, P)
  T* h_s = x_s + L * TS;                           // (P, N): hz
  float* dt_s = reinterpret_cast<float*>(h_s + MAX_P * NS);
  float* cum_s = dt_s + L;
  float* ex_s = cum_s + L;

  const int tid = threadIdx.x;
  const int h = blockIdx.x % sh.H;
  const int bz = blockIdx.x / sh.H;
  const int z = bz % sh.Z, b = bz / sh.Z;
  const int c0 = z * L, valid = min(L, sh.S - c0);
  const int P = sh.P, N = sh.N;

  load_tile<T, OUT_THREADS>(c_s, NS, cm + b * cs0 + c0 * cs1, cs1, valid, N,
                            sh.vec);
  load_tile<T, OUT_THREADS>(b_s, NS, bm + b * bs0 + c0 * bs1, bs1, valid, N,
                            sh.vec);
  load_tile<T, OUT_THREADS>(x_s, TS, x + b * xs0 + c0 * xs1 + h * xs2, xs1,
                            valid, P, sh.vec);
  load_state<T, OUT_THREADS>(h_s, states + static_cast<long long>(
                                               blockIdx.x) * P * N, P, N);
  if (tid < 32)
    chunk_cum(sh.dt + b * sh.ds0 + c0 * sh.ds1 + h * sh.ds2, sh.ds1, valid,
              sh.a[h], dt_s, cum_s);
  cp_async_wait_all();
  __syncthreads();
  if (tid < L) ex_s[tid] = expf(cum_s[tid]);
  __syncthreads();

  const int w = tid >> 5, i0 = 16 * w;
  const int pq = pad16(P) / 16, nk = pad16(N) / 16;
  // inter-chunk: y = exp(cum_i) C_i . hz
  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
  for (int kk = 0; kk < nk; ++kk) {
    FragA<T> fa;
    tile_a(fa, c_s, NS, i0, 16 * kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= pq) break;
      FragB<T> fb;
      tile_b_nk(fb, h_s, NS, 16 * q, 16 * kk);
      mma2(acc[2 * q], acc[2 * q + 1], fa, fb);
    }
  }
  const float e0 = ex_s[i0 + acc_row(0)], e1 = ex_s[i0 + acc_row(2)];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    acc[t][0] *= e0; acc[t][1] *= e0;
    acc[t][2] *= e1; acc[t][3] *= e1;
  }
  // intra-chunk: C.B^T on the tiles at or below the diagonal, then M
  float m[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[t][e] = 0.0f;
  for (int kk = 0; kk < nk; ++kk) {
    FragA<T> fa;
    tile_a(fa, c_s, NS, i0, 16 * kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q > w) break;
      FragB<T> fb;
      tile_b_nk(fb, b_s, NS, 16 * q, 16 * kk);
      mma2(m[2 * q], m[2 * q + 1], fa, fb);
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + acc_row(e), j = acc_col(t, e);
      // the exponent is formed only where it is kept: cum_i - cum_j <= 0
      m[t][e] = j <= i ? m[t][e] * expf(cum_s[i] - cum_s[j]) * dt_s[j]
                       : 0.0f;
    }
  // y += M . X, M straight from the accumulator into the A operand
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    if (kq > w) break;
    FragA<T> fa;
    a_from_c(fa, m[2 * kq], m[2 * kq + 1]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= pq) break;
      FragB<T> fb;
      tile_b_kn(fb, x_s, TS, 16 * kq, 16 * q);
      mma2(acc[2 * q], acc[2 * q + 1], fa, fb);
    }
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + acc_row(e), p = acc_col(t, e);
      if (i < valid && p < P)
        y[((static_cast<long long>(b) * sh.S + c0 + i) * sh.H + h) * P + p] =
            from_f<T>(acc[t][e]);
    }
}

// ---------------------------------------------------------------------------
// 3b. backward: every gradient of a chunk, one block per (b, chunk)
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 256;     // 8 warps: warp w owns row tile w & 3
                                     // and column half w >> 2

template <typename T>
constexpr size_t bwd_smem() {
  return (2 * L * NS + 3 * L * TS + 2 * MAX_P * NS) * sizeof(T) +
         (15 * L + 8) * sizeof(float);
}

struct BwdArgs {
  const void* x; long long xs0, xs1, xs2;
  const void* bm; long long bs0, bs1;
  const void* cm; long long cs0, cs1;
  const void* gy; long long gs0, gs1, gs2;
  const void* states;     // (B, Z, H, P, N): the state at each chunk's start
  const void* adj;        // (B, Z, H, P, N): the adjoint at each chunk's end
  void* dx;               // (B, S, H, P) contiguous, x's type
  float* ddt;             // (B, S, H) contiguous
  float* da_part;         // (B, Z, H): each chunk's share of da
  void* db;               // (B, S, N) contiguous
  void* dc;               // (B, S, N) contiguous
};

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 1)
ssd_bwd_kernel(Shape sh, BwdArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* b_s = reinterpret_cast<T*>(smem_raw);         // (L, N)
  T* c_s = b_s + L * NS;                           // (L, N)
  T* x_s = c_s + L * NS;                           // (L, P)
  T* g_s = x_s + L * TS;                           // (L, P): gy
  T* m_s = g_s + L * TS;                           // (L, L): M
  T* st_s = m_s + L * TS;                          // (P, N): Dn
  T* hz_s = st_s + MAX_P * NS;                     // (P, N): hz
  float* dt_s = reinterpret_cast<float*>(hz_s + MAX_P * NS);
  float* cum_s = dt_s + L;
  float* ex_s = cum_s + L;                         // exp(cum_i)
  float* coef_s = ex_s + L;                        // exp(cum_L - cum_j) dt_j
  float* rp_s = coef_s + L;                        // [2][L] row sums of S
  float* qp_s = rp_s + 2 * L;                      // [4][L] column sums
  float* vp_s = qp_s + 4 * L;                      // [2][L] x_j . Dn B_j
  float* ip_s = vp_s + 2 * L;                      // [2][L] inter dcum
  float* dg_s = ip_s + 2 * L;                      // S's diagonal
  float* dot_s = dg_s + L;                         // [8] <Dn, hz>

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int rw = w & 3, ch = w >> 2;
  const int bz = blockIdx.x;
  const int z = bz % sh.Z, b = bz / sh.Z;
  const int c0 = z * L, valid = min(L, sh.S - c0);
  const int H = sh.H, P = sh.P, N = sh.N, PN = P * N;
  const int pk = pad16(P) / 16, nk = pad16(N) / 16;
  const int r0 = 16 * rw;              // this warp's row tile
  // the warp's (L, L) tile (columns 32 ch ..) reaches the diagonal or below
  const bool tri = 2 * ch <= rw;

  load_tile<T, BWD_THREADS>(b_s, NS, static_cast<const T*>(g.bm) +
                                         b * g.bs0 + c0 * g.bs1,
                            g.bs1, valid, N, sh.vec);
  load_tile<T, BWD_THREADS>(c_s, NS, static_cast<const T*>(g.cm) +
                                         b * g.cs0 + c0 * g.cs1,
                            g.cs1, valid, N, sh.vec);
  cp_async_wait_all();
  __syncthreads();

  // C.B^T on the warp's (16, 32) tile, kept in registers for every head
  float cb[4][4], dcbs[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[t][e] = dcbs[t][e] = 0.0f;
  if (tri) {
    for (int kk = 0; kk < nk; ++kk) {
      FragA<T> fa;
      tile_a(fa, c_s, NS, r0, 16 * kk);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (2 * ch + q > rw) break;
        FragB<T> fb;
        tile_b_nk(fb, b_s, NS, 32 * ch + 16 * q, 16 * kk);
        mma2(cb[2 * q], cb[2 * q + 1], fa, fb);
      }
    }
  }
  // dB and dC of the warp's (16, 64) tile (columns 64 ch ..), over heads
  float dba[8][4], dca[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dba[t][e] = dca[t][e] = 0.0f;

  for (int h = 0; h < H; ++h) {
    const long long bzh = static_cast<long long>(bz) * H + h;
    load_tile<T, BWD_THREADS>(x_s, TS, static_cast<const T*>(g.x) +
                                           b * g.xs0 + c0 * g.xs1 +
                                           h * g.xs2,
                              g.xs1, valid, P, sh.vec);
    load_tile<T, BWD_THREADS>(g_s, TS, static_cast<const T*>(g.gy) +
                                           b * g.gs0 + c0 * g.gs1 +
                                           h * g.gs2,
                              g.gs1, valid, P, sh.vec);
    load_state<T, BWD_THREADS>(st_s, static_cast<const T*>(g.adj) + bzh * PN,
                               P, N);
    load_state<T, BWD_THREADS>(hz_s, static_cast<const T*>(g.states) +
                                         bzh * PN, P, N);
    const float a = sh.a[h];
    if (tid < 32)
      chunk_cum(sh.dt + b * sh.ds0 + c0 * sh.ds1 + h * sh.ds2, sh.ds1,
                valid, a, dt_s, cum_s);
    cp_async_wait_all();
    __syncthreads();
    if (tid < L) {
      ex_s[tid] = expf(cum_s[tid]);
      coef_s[tid] = expf(cum_s[L - 1] - cum_s[tid]) * dt_s[tid];
    }
    {
      // <Dn, hz>, for the chunk decay's share of dcum
      const int pp = pad16(P), pn = pad16(N);
      float dot = 0.0f;
      for (int i = tid; i < pp * pn; i += BWD_THREADS) {
        const int r = i / pn, c = i - r * pn;
        dot += to_f(st_s[r * NS + c]) * to_f(hz_s[r * NS + c]);
      }
      dot = warp_sum(dot);
      if (lane == 0) dot_s[w] = dot;
    }
    __syncthreads();

    // dM = gY . X^T on the warp's tile; then M, dCB and S = dM o M. S
    // moves cum_i up and cum_j down by the same amount: its diagonal
    // cancels exactly in dcum and is left out of the row and column sums
    {
      float dm[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) dm[t][e] = 0.0f;
      if (tri) {
        for (int kk = 0; kk < pk; ++kk) {
          FragA<T> fa;
          tile_a(fa, g_s, TS, r0, 16 * kk);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (2 * ch + q > rw) break;
            FragB<T> fb;
            tile_b_nk(fb, x_s, TS, 32 * ch + 16 * q, 16 * kk);
            mma2(dm[2 * q], dm[2 * q + 1], fa, fb);
          }
        }
      }
      float rsum[2] = {0.0f, 0.0f}, csum[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int q = 0; q < 2; ++q) csum[t][q] = 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + acc_row(e), j = 32 * ch + acc_col(t, e);
          float mv = 0.0f, dcb = 0.0f, sv = 0.0f;
          if (j <= i) {
            const float ex = expf(cum_s[i] - cum_s[j]);
            const float cbe = cb[t][e] * ex;
            mv = cbe * dt_s[j];
            dcb = dm[t][e] * ex * dt_s[j];
            sv = dm[t][e] * cbe;
          }
          dcbs[t][e] += dcb;
          m_s[i * TS + j] = from_f<T>(mv);
          if (j < i) {
            rsum[e >> 1] += sv * dt_s[j];
            csum[t][e & 1] += sv;
          } else if (j == i) {
            dg_s[i] = sv;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float r = quad_sum(rsum[q]);
        if ((lane & 3) == 0) rp_s[ch * L + r0 + acc_row(2 * q)] = r;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float cs = column_sum(csum[t][q]);
          if (lane < 4) qp_s[rw * L + 32 * ch + acc_col(t, q)] = cs;
        }
    }
    __syncthreads();

    // dX = M^T . gY + coef o (B . Dn^T) on the warp's (16 rows j, 32 p) tile
    {
      float a1[4][4], a2[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) a1[t][e] = a2[t][e] = 0.0f;
      const int p0 = 32 * ch;
      if (p0 < 16 * pk) {
        for (int kk = rw; kk < L / 16; ++kk) {
          FragA<T> fa;
          tile_a_t(fa, m_s, TS, r0, 16 * kk);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (p0 + 16 * q >= 16 * pk) break;
            FragB<T> fb;
            tile_b_kn(fb, g_s, TS, 16 * kk, p0 + 16 * q);
            mma2(a1[2 * q], a1[2 * q + 1], fa, fb);
          }
        }
        for (int kk = 0; kk < nk; ++kk) {
          FragA<T> fa;
          tile_a(fa, b_s, NS, r0, 16 * kk);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (p0 + 16 * q >= 16 * pk) break;
            FragB<T> fb;
            tile_b_nk(fb, st_s, NS, p0 + 16 * q, 16 * kk);
            mma2(a2[2 * q], a2[2 * q + 1], fa, fb);
          }
        }
      }
      float vsum[2] = {0.0f, 0.0f};
      T* dx = static_cast<T*>(g.dx);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = r0 + acc_row(e), p = p0 + acc_col(t, e);
          if (p < P) vsum[e >> 1] += to_f(x_s[j * TS + p]) * a2[t][e];
          if (j < valid && p < P)
            dx[((static_cast<long long>(b) * sh.S + c0 + j) * H + h) * P +
               p] = from_f<T>(a1[t][e] + coef_s[j] * a2[t][e]);
        }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float v = quad_sum(vsum[q]);
        if ((lane & 3) == 0) vp_s[ch * L + r0 + acc_row(2 * q)] = v;
      }
    }

    // dB += coef o (X . Dn) on the warp's (16 rows j, 64 n) tile
    {
      float a3[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) a3[t][e] = 0.0f;
      const int n0 = 64 * ch;
      for (int kk = 0; kk < pk; ++kk) {
        FragA<T> fa;
        tile_a(fa, x_s, TS, r0, 16 * kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (n0 + 16 * q >= 16 * nk) break;
          FragB<T> fb;
          tile_b_kn(fb, st_s, NS, 16 * kk, n0 + 16 * q);
          mma2(a3[2 * q], a3[2 * q + 1], fa, fb);
        }
      }
      const float q0 = coef_s[r0 + acc_row(0)], q1 = coef_s[r0 + acc_row(2)];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        dba[t][0] += q0 * a3[t][0]; dba[t][1] += q0 * a3[t][1];
        dba[t][2] += q1 * a3[t][2]; dba[t][3] += q1 * a3[t][3];
      }
    }

    // dC += exp(cum_i) gY . hz, and the inter-chunk term of dcum
    {
      float a3[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) a3[t][e] = 0.0f;
      const int n0 = 64 * ch;
      for (int kk = 0; kk < pk; ++kk) {
        FragA<T> fa;
        tile_a(fa, g_s, TS, r0, 16 * kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (n0 + 16 * q >= 16 * nk) break;
          FragB<T> fb;
          tile_b_kn(fb, hz_s, NS, 16 * kk, n0 + 16 * q);
          mma2(a3[2 * q], a3[2 * q + 1], fa, fb);
        }
      }
      float isum[2] = {0.0f, 0.0f};
      const float q0 = ex_s[r0 + acc_row(0)], q1 = ex_s[r0 + acc_row(2)];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + acc_row(e), n = n0 + acc_col(t, e);
          if (n < N) isum[e >> 1] += to_f(c_s[i * NS + n]) * a3[t][e];
          dca[t][e] += (e < 2 ? q0 : q1) * a3[t][e];
        }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float v = quad_sum(isum[q]);
        const int i = r0 + acc_row(2 * q);
        if ((lane & 3) == 0) ip_s[ch * L + i] = ex_s[i] * v;
      }
    }
    __syncthreads();

    // dcum, its sum from the chunk's end dla, ddt and this chunk's part of
    // da. dcum_k has -t_k (t_k = coef_k x_k . Dn B_k) and the last row the
    // sum of all t, which cancel for k >= j: t enters dla_j as its sum over
    // k < j. Lane l owns rows 2l and 2l+1.
    if (w == 0) {
      float dot = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) dot += dot_s[k];
      float dc[2], tt[2], vv[2], qq[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 2 * lane + u;
        const float rr = rp_s[r] + rp_s[L + r];
        qq[u] = ((qp_s[r] + qp_s[L + r]) + qp_s[2 * L + r]) + qp_s[3 * L + r];
        vv[u] = vp_s[r] + vp_s[L + r];
        const float in = ip_s[r] + ip_s[L + r];
        tt[u] = coef_s[r] * vv[u];
        dc[u] = rr - dt_s[r] * qq[u] + in;
      }
      float suf = dc[0] + dc[1], pre = tt[0] + tt[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, suf, off);
        const float u = __shfl_up_sync(0xffffffffu, pre, off);
        if (lane + off < 32) suf += v;
        if (lane >= off) pre += u;
      }
      float after = __shfl_down_sync(0xffffffffu, suf, 1);
      float before = __shfl_up_sync(0xffffffffu, pre, 1);
      if (lane == 31) after = 0.0f;
      if (lane == 0) before = 0.0f;
      const float end = expf(cum_s[L - 1]) * dot;
      const float s1 = after + dc[1], s0 = s1 + dc[0];
      const float dla[2] = {(s0 + end) + before,
                            (s1 + end) + (before + tt[0])};
      const float dla0 = dla[0], dla1 = dla[1];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 2 * lane + u;
        if (r < valid)
          g.ddt[(static_cast<long long>(b) * sh.S + c0 + r) * H + h] =
              (qq[u] + dg_s[r]) + expf(cum_s[L - 1] - cum_s[r]) * vv[u] +
              a * dla[u];
      }
      const float dap = warp_sum(dt_s[2 * lane] * dla0 +
                                 dt_s[2 * lane + 1] * dla1);
      if (lane == 0) g.da_part[bzh] = dap;
    }
    __syncthreads();
  }

  // dC += dCB . B and dB += dCB^T . C, dCB summed over the heads
  float* dcb_s = reinterpret_cast<float*>(st_s);   // (L, L) fp32, row stride TS
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dcb_s[(r0 + acc_row(e)) * TS + 32 * ch + acc_col(t, e)] = dcbs[t][e];
  __syncthreads();
  const int n0 = 64 * ch;
  for (int kk = 0; kk <= rw; ++kk) {
    FragA<T> fa;
    const float* dr = dcb_s + r0 * TS + 16 * kk;
    frag_a(fa, [&](int m, int k) { return dr[m * TS + k]; });
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (n0 + 16 * q >= 16 * nk) break;
      FragB<T> fb;
      tile_b_kn(fb, b_s, NS, 16 * kk, n0 + 16 * q);
      mma2(dca[2 * q], dca[2 * q + 1], fa, fb);
    }
  }
  for (int kk = rw; kk < L / 16; ++kk) {
    FragA<T> fa;
    const float* dr = dcb_s + 16 * kk * TS + r0;
    frag_a(fa, [&](int m, int k) { return dr[k * TS + m]; });
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (n0 + 16 * q >= 16 * nk) break;
      FragB<T> fb;
      tile_b_kn(fb, c_s, NS, 16 * kk, n0 + 16 * q);
      mma2(dba[2 * q], dba[2 * q + 1], fa, fb);
    }
  }
  T* db = static_cast<T*>(g.db);
  T* dc = static_cast<T*>(g.dc);
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + acc_row(e), n = n0 + acc_col(t, e);
      if (r < valid && n < N) {
        const long long o = (static_cast<long long>(b) * sh.S + c0 + r) * N + n;
        db[o] = from_f<T>(dba[t][e]);
        dc[o] = from_f<T>(dca[t][e]);
      }
    }
}

// da[h] = sum over (b, chunk) of the chunks' parts, in a fixed order
__global__ void ssd_da_kernel(const float* part, float* da, int BZ, int H) {
  const int h = blockIdx.x;
  float s = 0.0f;
  for (int i = threadIdx.x; i < BZ; i += 32)
    s += part[static_cast<long long>(i) * H + h];
  s = warp_sum(s);
  if (threadIdx.x == 0) da[h] = s;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T>
int launch_pass(const Shape& sh, const float* contrib, T* out,
                const float* cl, const float* init, float* last, int reverse,
                cudaStream_t st) {
  const int pn = sh.P * sh.N;
  if (pn % 4 == 0) {
    const dim3 grid((pn / 4 + PASS_THREADS - 1) / PASS_THREADS, sh.B * sh.H);
    ssd_pass_kernel<T, 4><<<grid, PASS_THREADS, 0, st>>>(
        contrib, out, cl, init, last, sh.Z, sh.H, pn, reverse);
  } else {
    const dim3 grid((pn + PASS_THREADS - 1) / PASS_THREADS, sh.B * sh.H);
    ssd_pass_kernel<T, 1><<<grid, PASS_THREADS, 0, st>>>(
        contrib, out, cl, init, last, sh.Z, sh.H, pn, reverse);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int launch_state(const Shape& sh, const void* u, long long us0,
                 long long us1, long long us2, const void* v, long long vs0,
                 long long vs1, float* out, float* cl, cudaStream_t st) {
  const size_t smem = state_smem<T>();
  int err = set_smem(ssd_state_kernel<T, MODE>, smem);
  if (err) return err;
  const unsigned blocks = static_cast<unsigned>(sh.B) * sh.Z * sh.H;
  ssd_state_kernel<T, MODE><<<blocks, STATE_THREADS, smem, st>>>(
      sh, static_cast<const T*>(u), us0, us1, us2, static_cast<const T*>(v),
      vs0, vs1, out, cl);
  return static_cast<int>(cudaGetLastError());
}

// The workspace, in floats: the chunks' fp32 contributions, then one (or
// for the backward two) (B, Z, H, P, N) buffers of T, each rounded up to 16
// bytes, then the chunks' log decays (and da's parts).
struct Workspace {
  long long per, pn, tfloats;
  Workspace(const Shape& sh, size_t tsize)
      : per(static_cast<long long>(sh.B) * sh.Z * sh.H),
        pn(static_cast<long long>(sh.P) * sh.N),
        tfloats((per * pn * static_cast<long long>(tsize) + 15) / 16 * 4) {}
  long long floats(int backward) const {
    return per * pn + (backward ? 2 : 1) * (tfloats + per);
  }
};

template <typename T>
int forward(const Shape& sh, const void* x, long long xs0, long long xs1,
            long long xs2, const void* bm, long long bs0, long long bs1,
            const void* cm, long long cs0, long long cs1, const float* h0,
            void* y, float* h_out, float* ws, cudaStream_t st) {
  const Workspace w(sh, sizeof(T));
  float* contrib = ws;
  T* starts = reinterpret_cast<T*>(ws + w.per * w.pn);
  float* cl = ws + w.per * w.pn + w.tfloats;
  int err;
  if (sh.Z > 0) {
    err = launch_state<T, 0>(sh, x, xs0, xs1, xs2, bm, bs0, bs1, contrib, cl,
                             st);
    if (err) return err;
  }
  err = launch_pass<T>(sh, contrib, starts, cl, h0, h_out, 0, st);
  if (err || sh.Z == 0) return err;
  const size_t smem = out_smem<T>();
  err = set_smem(ssd_out_kernel<T>, smem);
  if (err) return err;
  ssd_out_kernel<T><<<static_cast<unsigned>(w.per), OUT_THREADS, smem, st>>>(
      sh, static_cast<const T*>(x), xs0, xs1, xs2,
      static_cast<const T*>(bm), bs0, bs1, static_cast<const T*>(cm), cs0,
      cs1, starts, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const Shape& sh, const BwdArgs& args, const float* h0,
             const float* gh, float* dh0, float* da, float* ws,
             cudaStream_t st) {
  const Workspace w(sh, sizeof(T));
  float* contrib = ws;                 // the states', then the adjoints'
  T* starts = reinterpret_cast<T*>(ws + w.per * w.pn);
  T* adj = reinterpret_cast<T*>(ws + w.per * w.pn + w.tfloats);
  float* cl = ws + w.per * w.pn + 2 * w.tfloats;
  BwdArgs g = args;
  g.states = starts;
  g.adj = adj;
  g.da_part = cl + w.per;
  int err;
  if (sh.Z > 0) {
    err = launch_state<T, 0>(sh, g.x, g.xs0, g.xs1, g.xs2, g.bm, g.bs0,
                             g.bs1, contrib, cl, st);
    if (err) return err;
    err = launch_pass<T>(sh, contrib, starts, cl, h0, nullptr, 0, st);
    if (err) return err;
    err = launch_state<T, 1>(sh, g.gy, g.gs0, g.gs1, g.gs2, g.cm, g.cs0,
                             g.cs1, contrib, nullptr, st);
    if (err) return err;
  }
  err = launch_pass<T>(sh, contrib, adj, cl, gh, dh0, 1, st);
  if (err) return err;
  if (sh.Z > 0) {
    const size_t smem = bwd_smem<T>();
    err = set_smem(ssd_bwd_kernel<T>, smem);
    if (err) return err;
    ssd_bwd_kernel<T><<<static_cast<unsigned>(sh.B) * sh.Z, BWD_THREADS, smem,
                        st>>>(sh, g);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  ssd_da_kernel<<<sh.H, 32, 0, st>>>(g.da_part, da, sh.B * sh.Z, sh.H);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int S, int H, int P, int N) {
  return B < 1 || H < 1 || S < 0 || P < 1 || P > MAX_P || N < 1 ||
         N > MAX_N || static_cast<long long>(B) * H > 65535 ||
         static_cast<long long>(B) * ((S + L - 1) / L) * H > 0x7fffffffLL;
}

}  // namespace

// Floats of workspace a call needs (dtype as below): the chunks' state
// contributions, the states at their starts (and for the backward the
// adjoints at their ends), their log decays (and da's parts).
extern "C" long long ssd_workspace_floats(int dtype, int B, int S, int H,
                                          int P, int N, int backward) {
  const Shape sh = {B, S, H, P, N, (S + L - 1) / L, nullptr, nullptr,
                    0, 0, 0, 0};
  return Workspace(sh, dtype == 1 ? sizeof(bf16) : sizeof(float))
      .floats(backward);
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and y share it). Strides are in
// elements; y is written contiguous (B, S, H, P). h0 may be null (a zero
// initial state). Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int ssd_scan_launch(
    int dtype, const void* x, const float* dt, const float* a, const void* bm,
    const void* cm, const float* h0, void* y, float* h_out, float* ws, int B,
    int S, int H, int P, int N, long long xs0, long long xs1, long long xs2,
    long long bs0, long long bs1, long long cs0, long long cs1,
    long long ds0, long long ds1, long long ds2, int vec, void* stream) {
  if (bad_shape(B, S, H, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = {B, S, H, P, N, (S + L - 1) / L, dt, a, ds0, ds1, ds2, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(sh, x, xs0, xs1, xs2, bm, bs0, bs1, cm, cs0, cs1,
                          h0, y, h_out, ws, st);
  if (dtype == 1)
    return forward<bf16>(sh, x, xs0, xs1, xs2, bm, bs0, bs1, cm, cs0, cs1,
                         h0, y, h_out, ws, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradient of ssd_scan_launch's (y, final state) for the cotangents gy
// (strides gs*, x's type) and gh ((B, H, P, N) contiguous, or null: zero).
// dx (B, S, H, P), dB and dC (B, S, N) are written contiguous in x's type;
// ddt (B, S, H), da (H,) and dh0 (B, H, P, N, or null: not wanted) fp32.
extern "C" int ssd_scan_bwd_launch(
    int dtype, const void* x, const float* dt, const float* a, const void* bm,
    const void* cm, const float* h0, const void* gy, const float* gh,
    void* dx, float* ddt, float* da, void* db, void* dc, float* dh0,
    float* ws, int B, int S, int H, int P, int N, long long xs0,
    long long xs1, long long xs2, long long bs0, long long bs1,
    long long cs0, long long cs1, long long ds0, long long ds1,
    long long ds2, long long gs0, long long gs1, long long gs2, int vec,
    void* stream) {
  if (bad_shape(B, S, H, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = {B, S, H, P, N, (S + L - 1) / L, dt, a, ds0, ds1, ds2, vec};
  BwdArgs g = {x,  xs0, xs1, xs2, bm, bs0, bs1, cm, cs0, cs1, gy, gs0, gs1,
               gs2, nullptr, nullptr, dx, ddt, nullptr, db, dc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return backward<float>(sh, g, h0, gh, dh0, da, ws, st);
  if (dtype == 1) return backward<bf16>(sh, g, h0, gh, dh0, da, ws, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

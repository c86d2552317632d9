// The Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/ssd.py: ssd_scan
// (pallas_call at :74, body _ssd_kernel :24, wrapper :62), widened to what
// the model's ssd_chunked (src/repro/models/ssd.py:54) computes around it:
// an optional initial state h0, the final state, and any sequence length.
// Its plain PyTorch version is repro_torch/kernels/ssd.py::ssd_scan_plain.
//
// What it computes, for each batch row b and head h, over t = 0 .. S-1:
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T        (state (P, N), fp32)
//   y_t = C_t h_t                                      (the D skip is outside)
// in the chunked form: within a chunk of L steps, with cum the running sum
// of dt a from the chunk's start,
//   y_i = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i h
//   h  <- exp(cum_L) h + sum_j exp(cum_L - cum_j) dt_j x_j B_j^T.
// exp is formed only for j <= i, so no exponent above the diagonal (large
// and positive) is ever evaluated; every exponent taken is <= 0.
// x, B and C are float32 or bfloat16 (one type), dt, a, h0 and the final
// state float32; y is in x's type. Sums are fp32, in a fixed order, with no
// atomics: the result is the same from run to run.
//
// What bounds it on this card: at mamba2-130m's training shape (B=8,
// S=2048, H=24, P=64, N=128, bf16) the bytes it must move are ~117 MB
// (x and y 50 MB each, B and C 8 MB, dt 1.6 MB, the final state 6 MB),
// ~35 us at 3.35 TB/s, and its operations, ~20 GFLOP at this kernel's
// chunk, ~20 us at the bf16 tensor-core rate: bytes bound it.
//
// What the design does, simple before fast:
//  * One block of 256 threads per (b, h): a loop over chunks inside the
//    block takes the place of the TPU grid's sequential chunk axis. The
//    (P, N) fp32 state lives in registers across chunks (32 values a
//    thread), with a copy in shared memory for the inter-chunk product.
//  * The kernel's own chunk is L = 32 steps, smaller than the model's 256
//    (a 256 x 256 fp32 tile alone is 256 KB): the output does not depend on
//    the chunk beyond rounding. x, B and C of a chunk are staged in shared
//    memory as fp32, read in place through their strides (x is a view of
//    the conv output, B and C slices of it) with 16-byte loads where every
//    row is 16-byte aligned, element loads otherwise. About 87 KB of
//    shared memory at P = 64, N = 128, so two blocks fit on an SM and the
//    192 blocks of the training shape run in one wave on 132 SMs.
//  * The ragged last chunk is masked in the kernel: rows past S load as
//    zeros with dt = 0, which neither decays nor feeds the state (exactly
//    the reference's zero padding), and are not written.
//  * The products run on the fp32 cores with small register tiles; no
//    tensor cores yet. mma/wgmma tiles, a chunk of 64 and cp.async/TMA
//    staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int L = 32;                 // steps per chunk: one per lane
constexpr int MAX_P = 64;             // head_dim
constexpr int MAX_N = 128;            // d_state
constexpr int SP = 16;                // the state tile: 16 x 16 threads,
constexpr int SI = MAX_P / SP;        //   each holding SI p-rows
constexpr int SK = MAX_N / SP;        //   x SK n-columns, strided by 16
constexpr int YA = L / 16;            // y tile: 16 x 16 threads, YA rows
constexpr int YB = MAX_P / 16;        //   x YB columns, strided by 16
constexpr int MA = L / (THREADS / L); // M tile: 8 row groups x 32 columns
static_assert(THREADS == SP * SP && THREADS == 16 * 16, "16 x 16 tiles");
static_assert(L == 32, "the chunk's cumulative sum is one warp's scan");

struct Params {
  const void* x;        // (B, S, H, P), last axis contiguous
  const float* dt;      // (B, S, H)
  const float* a;       // (H,)
  const void* bm;       // (B, S, N), last axis contiguous
  const void* cm;       // (B, S, N), last axis contiguous
  const float* h0;      // (B, H, P, N) contiguous, or null
  void* y;              // (B, S, H, P)
  float* h_out;         // (B, H, P, N) contiguous
  int B, S, H, P, N;
  long long xs0, xs1, xs2, bs0, bs1, cs0, cs1, ds0, ds1, ds2, ys0, ys1;
  int vec;              // 1: every row of x, B and C is 16-byte aligned
};

struct Layout {         // offsets in floats into dynamic shared memory
  int ldx, ldb, ldm, ldh;
  int x, b, c, m, h, cum, dt, coef, ex, total;
};

__host__ __device__ inline Layout layout(int P, int N) {
  Layout s;
  s.ldx = P;
  s.ldb = N + 1;                      // odd: column reads by lane are free
  s.ldm = L + 1;
  s.ldh = (P + 31) / 32 * 32 + 16;    // rows n, n+1 land 16 banks apart
  s.x = 0;
  s.b = s.x + L * s.ldx;
  s.c = s.b + L * s.ldb;
  s.m = s.c + L * s.ldb;
  s.h = s.m + L * s.ldm;
  s.cum = s.h + N * s.ldh;
  s.dt = s.cum + L;
  s.coef = s.dt + L;
  s.ex = s.coef + L;
  s.total = s.ex + L + 1;             // + exp(cum_L)
  return s;
}

__device__ inline float to_f(float v) { return v; }
__device__ inline float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ inline T from_f(float v);
template <> __device__ inline float from_f<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Rows 0..L-1 of a chunk into dst (fp32, row stride ld); rows at or past
// `valid` are zeros.
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, long long rs,
                          int valid, int cols, int vec, int tid) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    const int chunks = cols / PER;
    for (int idx = tid; idx < L * chunks; idx += THREADS) {
      const int r = idx / chunks, c = (idx - r * chunks) * PER;
      float* d = dst + r * ld + c;
      if (r < valid) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * rs + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int q = 0; q < PER; ++q) d[q] = to_f(e[q]);
      } else {
#pragma unroll
        for (int q = 0; q < PER; ++q) d[q] = 0.0f;
      }
    }
  } else {
    for (int idx = tid; idx < L * cols; idx += THREADS) {
      const int r = idx / cols, c = idx - r * cols;
      dst[r * ld + c] = r < valid ? to_f(src[r * rs + c]) : 0.0f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) ssd_kernel(Params p) {
  extern __shared__ float smem[];
  const Layout s = layout(p.P, p.N);
  float* x_s = smem + s.x;
  float* b_s = smem + s.b;
  float* c_s = smem + s.c;
  float* m_s = smem + s.m;
  float* h_s = smem + s.h;
  float* cum_s = smem + s.cum;
  float* dt_s = smem + s.dt;
  float* coef_s = smem + s.coef;
  float* ex_s = smem + s.ex;

  const int tid = threadIdx.x;
  const int h = blockIdx.x % p.H;
  const int b = blockIdx.x / p.H;
  const int P = p.P, N = p.N;
  const float a = p.a[h];

  // the state tile of this thread: p = sp + 16 i, n = sn + 16 k
  const int sp = tid % SP, sn = tid / SP;
  float hreg[SI][SK];
  const long long hbase = (static_cast<long long>(b) * p.H + h) * P * N;
#pragma unroll
  for (int i = 0; i < SI; ++i)
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      const int pp = sp + 16 * i, nn = sn + 16 * k;
      float v = 0.0f;
      if (p.h0 != nullptr && pp < P && nn < N) v = p.h0[hbase + pp * N + nn];
      hreg[i][k] = v;
      if (pp < P && nn < N) h_s[nn * s.ldh + pp] = v;
    }

  const T* xb = static_cast<const T*>(p.x) + b * p.xs0 + h * p.xs2;
  const T* bb = static_cast<const T*>(p.bm) + b * p.bs0;
  const T* cb = static_cast<const T*>(p.cm) + b * p.cs0;
  T* yb = static_cast<T*>(p.y) + b * p.ys0 + h * static_cast<long long>(P);
  const float* db = p.dt + b * p.ds0 + h * p.ds2;

  for (int c0 = 0; c0 < p.S; c0 += L) {
    const int valid = min(L, p.S - c0);
    // 1. stage the chunk; warp 0 scans dt * a
    load_rows<T>(x_s, s.ldx, xb + c0 * p.xs1, p.xs1, valid, P, p.vec, tid);
    load_rows<T>(b_s, s.ldb, bb + c0 * p.bs1, p.bs1, valid, N, p.vec, tid);
    load_rows<T>(c_s, s.ldb, cb + c0 * p.cs1, p.cs1, valid, N, p.vec, tid);
    if (tid < L) {
      const float dtv = tid < valid ? db[(c0 + tid) * p.ds1] : 0.0f;
      float cum = dtv * a;
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, cum, off);
        if (tid >= off) cum += v;
      }
      const float last = __shfl_sync(0xffffffffu, cum, L - 1);
      cum_s[tid] = cum;
      dt_s[tid] = dtv;
      coef_s[tid] = expf(last - cum) * dtv;   // exponent <= 0
      ex_s[tid] = expf(cum);                  // exponent <= 0
      if (tid == 0) ex_s[L] = expf(last);
    }
    __syncthreads();

    // 2. M_ij = (C_i.B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0;
    //    the lane is j, the warp holds rows w, w + 8, w + 16, w + 24
    {
      const int j = tid % L, w = tid / L;
      float acc[MA];
#pragma unroll
      for (int q = 0; q < MA; ++q) acc[q] = 0.0f;
      const float* brow = b_s + j * s.ldb;
      for (int n = 0; n < N; ++n) {
        const float bv = brow[n];
#pragma unroll
        for (int q = 0; q < MA; ++q)
          acc[q] = fmaf(c_s[(w + 8 * q) * s.ldb + n], bv, acc[q]);
      }
      const float cum_j = cum_s[j], dt_j = dt_s[j];
#pragma unroll
      for (int q = 0; q < MA; ++q) {
        const int i = w + 8 * q;
        // the exponent is formed only where it is kept: cum_i - cum_j <= 0
        m_s[i * s.ldm + j] = j <= i ? acc[q] * expf(cum_s[i] - cum_j) * dt_j
                                    : 0.0f;
      }
    }
    // 3. the state: h <- exp(cum_L) h + sum_j coef_j x_j B_j^T, in registers
    {
      const float decay = ex_s[L];
#pragma unroll
      for (int i = 0; i < SI; ++i)
#pragma unroll
        for (int k = 0; k < SK; ++k) hreg[i][k] *= decay;
      for (int j = 0; j < L; ++j) {
        const float cj = coef_s[j];
        float wv[SI], bv[SK];
#pragma unroll
        for (int i = 0; i < SI; ++i) {
          const int pp = sp + 16 * i;
          wv[i] = pp < P ? cj * x_s[j * s.ldx + pp] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < SK; ++k) {
          const int nn = sn + 16 * k;
          bv[k] = nn < N ? b_s[j * s.ldb + nn] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < SI; ++i)
#pragma unroll
          for (int k = 0; k < SK; ++k) hreg[i][k] = fmaf(wv[i], bv[k], hreg[i][k]);
      }
    }
    __syncthreads();

    // 4. y_i = exp(cum_i) C_i.h(chunk start) + sum_j M_ij x_j; the tile:
    //    rows yi + 16 a, columns yp + 16 c
    {
      const int yp = tid % 16, yi = tid / 16;
      float acc[YA][YB];
#pragma unroll
      for (int q = 0; q < YA; ++q)
#pragma unroll
        for (int c = 0; c < YB; ++c) acc[q][c] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[YA], hv[YB];
#pragma unroll
        for (int q = 0; q < YA; ++q) cv[q] = c_s[(yi + 16 * q) * s.ldb + n];
#pragma unroll
        for (int c = 0; c < YB; ++c) {
          const int pp = yp + 16 * c;
          hv[c] = pp < P ? h_s[n * s.ldh + pp] : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < YA; ++q)
#pragma unroll
          for (int c = 0; c < YB; ++c) acc[q][c] = fmaf(cv[q], hv[c], acc[q][c]);
      }
#pragma unroll
      for (int q = 0; q < YA; ++q) {
        const float e = ex_s[yi + 16 * q];
#pragma unroll
        for (int c = 0; c < YB; ++c) acc[q][c] *= e;
      }
      for (int j = 0; j < L; ++j) {
        float mv[YA], xv[YB];
#pragma unroll
        for (int q = 0; q < YA; ++q) mv[q] = m_s[(yi + 16 * q) * s.ldm + j];
#pragma unroll
        for (int c = 0; c < YB; ++c) {
          const int pp = yp + 16 * c;
          xv[c] = pp < P ? x_s[j * s.ldx + pp] : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < YA; ++q)
#pragma unroll
          for (int c = 0; c < YB; ++c) acc[q][c] = fmaf(mv[q], xv[c], acc[q][c]);
      }
#pragma unroll
      for (int q = 0; q < YA; ++q) {
        const int i = yi + 16 * q;
        if (i >= valid) continue;
        T* yrow = yb + (c0 + i) * p.ys1;
#pragma unroll
        for (int c = 0; c < YB; ++c) {
          const int pp = yp + 16 * c;
          if (pp < P) yrow[pp] = from_f<T>(acc[q][c]);
        }
      }
    }
    __syncthreads();

    // 5. the new state for the next chunk's inter-chunk product
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
      for (int k = 0; k < SK; ++k) {
        const int pp = sp + 16 * i, nn = sn + 16 * k;
        if (pp < P && nn < N) h_s[nn * s.ldh + pp] = hreg[i][k];
      }
    // the next chunk's first __syncthreads orders these writes before the
    // reads of step 4, and step 4's reads before the next staging
  }

#pragma unroll
  for (int i = 0; i < SI; ++i)
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      const int pp = sp + 16 * i, nn = sn + 16 * k;
      if (pp < P && nn < N) p.h_out[hbase + pp * N + nn] = hreg[i][k];
    }
}

template <typename T>
int launch(const Params& p, void* stream) {
  const size_t smem = layout(p.P, p.N).total * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = static_cast<long long>(p.B) * p.H;
  ssd_kernel<T><<<static_cast<unsigned>(blocks), THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C and y share it). Strides are in
// elements. h0 may be null (a zero initial state). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_scan_launch(
    int dtype, const void* x, const float* dt, const float* a, const void* bm,
    const void* cm, const float* h0, void* y, float* h_out, int B, int S,
    int H, int P, int N, long long xs0, long long xs1, long long xs2,
    long long bs0, long long bs1, long long cs0, long long cs1,
    long long ds0, long long ds1, long long ds2, long long ys0,
    long long ys1, int vec, void* stream) {
  if (B < 1 || H < 1 || S < 0 || P < 1 || P > MAX_P || N < 1 || N > MAX_N ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {x,   dt,  a,   bm,  cm,  h0,  y,   h_out, B,   S,   H,
              P,   N,   xs0, xs1, xs2, bs0, bs1, cs0,   cs1, ds0, ds1,
              ds2, ys0, ys1, vec};
  if (dtype == 0) return launch<float>(p, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Gauss-linking writhe map for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/writhe.py::writhe_map
// (pallas_call at :97, body _writhe_kernel :63, math _writhe_block :40).
// Its plain PyTorch version is repro_torch/kernels/writhe.py::writhe_map_ref,
// and writhe_sums_ref beside it is the plain version of the fused sums.
//
// What it computes: coords (B, n, 3) fp32 -> W (B, n-1, n-1) fp32, where
// W[b, i, j] is the signed solid angle of segment pair (i, j) times 2/(4 pi)
// (Klenin-Langowski method 1a), and W is 0 on the band |i - j| <= 1. The
// second entry point also writes, in the same launch, each structure's
// wr = sum(W) / 2 and acn = sum(|W|) / 2, which the knot screen reads.
//
// What bounds it on this card: the bound is the output stream, 1.25 ms to
// write the 4.2 GB of W at B=4000, n=512 at 3.35 TB/s. W is symmetric, so
// the function needs each unordered off-band pair once, 5.2e8 pairs, at 143
// fp32 operations each (OPS_PER_PAIR in chip_smoke.py: an FMA two, an asin
// or a reciprocal square root one, whatever the implementation), 7.4e10 in
// all: 1.11 ms at 67 TFLOP/s. Reads are almost nothing (the 12-byte points
// are shared by a whole tile row or column). What the kernel issues is
// well above that count: about 210 operations a pair as written below (the
// asin polynomial and its range reduction about 20 each, the normals
// scaled before their dots), the selects and the address arithmetic on
// top, and the tile's evaluation and its stores do not fully overlap.
//
// What the design does about it:
//  * One evaluation per unordered pair. The grid covers B x T(T+1)/2 tile
//    pairs (ti <= tj), T = ceil((n-1) / TILE); tile_pair() decodes a block's
//    index, and kernels/writhe.py::block_tile transcribes it for the CPU
//    tests, which check that every (ti <= tj) pair comes once. A block
//    evaluates its 32 x 32 tile (pairs i < j only, so the lower segment
//    index always comes first and W is exactly symmetric), stages it in
//    shared memory padded a column against bank conflicts, and writes it to
//    (ti, tj) and its transpose to (tj, ti). A diagonal tile keeps its
//    i < j half and mirrors it inside itself in one write.
//  * Two warps a block, each thread 16 consecutive rows of one column:
//    fewer threads a tile spread the block's fixed costs (the index decode,
//    the point loads, two barriers) over more pairs, and consecutive rows
//    share their middle point and its two differences. 32 x 8 threads with
//    4 rows each (the first design's layout) and 32 x 4 with 8 were slower
//    on the card, as were 64-wide tiles; one warp a block too.
//  * Stores: each warp writes whole rows of the staged tile, a lane a
//    column, so every store instruction covers 128 contiguous bytes, with
//    streaming (evict-first) stores. Eight threads a row writing 16 bytes
//    each (a 16-byte-aligned body, the unaligned head and tail singly: rows
//    of 511 floats are mostly unaligned) was slower on the card: its
//    address arithmetic cost more than the wider stores saved. The ragged
//    edge is masked in the kernel, so the output is written at
//    (B, n-1, n-1) directly, with no padding buffer and no slice copy.
//  * Cheaper arithmetic, the same result within the reference's round-off:
//    each normalisation is the hardware's reciprocal square root
//    (rsqrt.approx) in place of an IEEE sqrtf and division; a Newton step
//    after it moved phase 3's float64 figures both ways, inside their
//    limits, and cost time on the card.
//    The normals are still scaled before their dots: forming n_k . n_k+1
//    as dot(c_k, c_k+1) * inv_k * inv_k+1 instead saves four multiplies a
//    pair, but in a float32 numpy model of this arithmetic, on phase 3's
//    parity batch at 512 points, it put the total ACN further from the
//    plain version's than phase 3's 1e-5 allows, where the scaled form
//    stayed inside it (PERF.md, PR 18).
//  * asin is a minimax polynomial (asin_clip): asin(s) = s + s t P(t),
//    t = s^2, on [0, 1/2], and pi/2 - 2 asin(sqrt((1 - |x|) / 2)) above,
//    with P of degree 4 fitted by Lawson's iteration in float64. Its error
//    against float64 asin, evaluated in float32 as below on every float in
//    [1/2, 1] and 8e6 samples of [0, 1/2]: at most 1.7e-7 (1.9 ulp of the
//    result) with an exact square root, 3.9e-7 with the square root off by
//    2^-22 relative; tests/test_torch_writhe.py::test_asin_polynomial_error
//    holds both, from the coefficients parsed out of this file. CUDA's
//    asinf is within 2 ulp.
//  * The eps (sqrt(dot + 1e-12)) and the clip to [-1, 1] before the asin are
//    kept, so zero-length and collinear segments give 0 and never NaN; the
//    clip is taken as min(|x|, 1) with the sign put back, which is the same
//    value. The sign's triple product is the reference's expression in the
//    reference's operand order (it decides the degenerate cases of
//    tests/_writhe_cases.py), with q2 - q1 computed once a thread. The scale
//    2/(4 pi) is one multiply by 1/(2 pi) in place of a division.
//  * No --use_fast_math for the file: the two approximate instructions are
//    written out one at a time (rsqrt_approx, sqrt_approx) where phase 3's
//    checks hold. FMA contraction is left on: the tolerance (atol 6e-4,
//    rtol 1e-3) covers it.
//  * Sums: each block adds up the pairs it kept in registers and warp
//    shuffles, in a fixed tree, and writes one (sum W, sum |W|) partial per
//    (b, tile pair). Since every block keeps pairs i < j only, the partials
//    of one structure add up to wr and acn themselves (an off-diagonal tile
//    stands for itself and its mirror, a diagonal tile for both its
//    halves). The last block of each structure to finish, found by an
//    integer ticket (a fence, then atomicAdd on a per-structure counter
//    zeroed before the launch), adds that structure's partials in index
//    order in double, one warp, lanes strided then a fixed shuffle tree: the
//    same order whichever block comes last, so the sums are bit-identical
//    from run to run, with no float atomics and in the map's own launch.
//    The map-only entry point compiles the sums out.
//  * The batch is folded into gridDim.x (limit 2^31 - 1) with the tile
//    pair; output offsets are 64-bit (B * (n-1)^2 passes 2^31).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;       // outputs per tile side: one warp's lanes
constexpr int ROWS = 2;        // threadIdx.y extent, one warp each; a thread
                               // does TILE / ROWS consecutive rows
constexpr int THREADS = TILE * ROWS;
constexpr int PAD = TILE + 1;  // staged tile row, padded against bank conflicts
static_assert(TILE == 32, "a tile row is one warp");

// asin(s) = s + s t P(t), t = s^2 on [0, 1/2] (see the note above)
constexpr float ASIN_C0 = 0.16666752099990845f;
constexpr float ASIN_C1 = 0.07495299726724625f;
constexpr float ASIN_C2 = 0.04547012597322464f;
constexpr float ASIN_C3 = 0.024180714040994644f;
constexpr float ASIN_C4 = 0.042164359241724014f;
constexpr float PIO2_HI = 1.57079637050628662f;   // pi/2 rounded to float
constexpr float PIO2_LO = -4.37113900018624283e-8f;  // pi/2 - PIO2_HI
constexpr float INV_2PI = 0.159154943091895336f;  // 2 / (4 pi)

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// 1/sqrt(x) for x >= 1e-12 (never subnormal): the hardware approximation
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// sqrt(x) for x in [0, 1/2], relative error within 2^-22
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ V3 unit(V3 a) {
  const float inv = rsqrt_approx(dot(a, a) + 1e-12f);
  return {a.x * inv, a.y * inv, a.z * inv};
}

// asin(clip(x, -1, 1))
__device__ __forceinline__ float asin_clip(float x) {
  const float a = fminf(fabsf(x), 1.0f);
  const bool big = a > 0.5f;
  const float tb = fmaf(-0.5f, a, 0.5f);
  const float t = big ? tb : a * a;
  const float s = big ? sqrt_approx(tb) : a;
  const float p = fmaf(fmaf(fmaf(fmaf(ASIN_C4, t, ASIN_C3), t, ASIN_C2), t,
                            ASIN_C1), t, ASIN_C0);
  const float r = fmaf(s * t, p, s);
  const float rb = fmaf(-2.0f, r, PIO2_HI) + PIO2_LO;
  return copysignf(big ? rb : r, x);
}

// Signed contribution of segment pair (p1 -> p2, q1 -> q2), lower segment
// index first: _writhe_block. dq is q2 - q1.
__device__ __forceinline__ float pair_writhe(V3 p1, V3 p2, V3 q1, V3 q2,
                                             V3 dq) {
  const V3 r13 = sub(q1, p1);
  const V3 r14 = sub(q2, p1);
  const V3 r23 = sub(q1, p2);
  const V3 r24 = sub(q2, p2);
  const V3 n1 = unit(cross(r13, r14));
  const V3 n2 = unit(cross(r14, r24));
  const V3 n3 = unit(cross(r24, r23));
  const V3 n4 = unit(cross(r23, r13));
  const float omega = asin_clip(dot(n1, n2)) + asin_clip(dot(n2, n3)) +
                      asin_clip(dot(n3, n4)) + asin_clip(dot(n4, n1));
  const float s = dot(cross(dq, sub(p2, p1)), r13);
  const float sign = s > 0.0f ? INV_2PI : (s < 0.0f ? -INV_2PI : 0.0f);
  return omega * sign;
}

// First block index of tile row ti in the row-major upper triangle.
__device__ __forceinline__ int row_start(int ti, int tiles) {
  return ti * tiles - ti * (ti - 1) / 2;
}

// k in [0, T(T+1)/2) -> (ti, tj), ti <= tj, row-major over the upper
// triangle: the root of row_start(ti) = k in float, then corrected to the
// exact integer answer (kernels/writhe.py::block_tile transcribes it).
__device__ __forceinline__ void tile_pair(int k, int tiles, int& ti,
                                          int& tj) {
  const int64_t d = 2 * static_cast<int64_t>(tiles) + 1;
  const float disc = static_cast<float>(d * d - 8 * static_cast<int64_t>(k));
  ti = static_cast<int>((static_cast<float>(d) - sqrtf(disc)) * 0.5f);
  while (ti > 0 && row_start(ti, tiles) > k) --ti;
  while (row_start(ti + 1, tiles) <= k) ++ti;
  tj = ti + (k - row_start(ti, tiles));
}

// Writes rows row0 .. row0 + TILE - 1 and columns col0 .. col0 + TILE - 1 of
// one structure's map (those below m), value (r, c) taken from src(r, c):
// each warp writes whole rows, a lane a column, so every store instruction
// covers 128 contiguous bytes; src reads the staged tile without bank
// conflicts along a row or down a column.
template <typename Src>
__device__ __forceinline__ void store_tile(float* __restrict__ map, int m,
                                           int row0, int col0, Src src) {
  const int lane = threadIdx.x;
  if (col0 + lane >= m) return;
  float* dst = map + static_cast<int64_t>(row0 + threadIdx.y) * m + col0 + lane;
  const int64_t step = static_cast<int64_t>(ROWS) * m;
#pragma unroll
  for (int r = threadIdx.y; r < TILE; r += ROWS, dst += step)
    if (row0 + r < m) __stcs(dst, src(r, lane));
}

// One structure's partials, by warp 0 of the block that finished last: in
// index order, lanes strided, then a fixed shuffle tree, in double so that
// the order costs no accuracy. The loads go to L2, where the other blocks'
// fenced stores are.
__device__ __forceinline__ void sum_partials(const float2* __restrict__ part,
                                             int pairs, float* wr,
                                             float* acn) {
  const int lane = threadIdx.x;
  double s = 0.0, a = 0.0;
  for (int k = lane; k < pairs; k += 32) {
    const float2 p = __ldcg(part + k);
    s += p.x;
    a += p.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    a += __shfl_xor_sync(0xffffffffu, a, o);
  }
  if (lane == 0) {
    *wr = static_cast<float>(s);
    *acn = static_cast<float>(a);
  }
}

template <bool SUMS>
__global__ void __launch_bounds__(THREADS)
writhe_kernel(const float* __restrict__ coords, float* __restrict__ out,
              float2* __restrict__ partial, unsigned* __restrict__ tickets,
              float* __restrict__ wr, float* __restrict__ acn, int n, int m,
              int tiles, int pairs) {
  // blockIdx.x = b * pairs + k; k -> (ti, tj), ti <= tj
  const int64_t blk = blockIdx.x;
  const int64_t b = blk / pairs;
  int ti, tj;
  tile_pair(static_cast<int>(blk - b * pairs), tiles, ti, tj);

  // points i0 .. i0 + TILE and j0 .. j0 + TILE, one array per axis
  __shared__ float pi[3][TILE + 1];
  __shared__ float pj[3][TILE + 1];
  __shared__ float tile[TILE][PAD];
  __shared__ float2 warp_sums[ROWS];
  const float* c = coords + b * static_cast<int64_t>(n) * 3;
  const int i0 = ti * TILE;
  const int j0 = tj * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int k = tid; k < 3 * (TILE + 1); k += THREADS) {
    const int p = k / 3;
    const int d = k - 3 * p;
    pi[d][p] = i0 + p < n ? c[(i0 + p) * 3 + d] : 0.0f;
    pj[d][p] = j0 + p < n ? c[(j0 + p) * 3 + d] : 0.0f;
  }
  __syncthreads();

  // this thread's column j and its TILE / ROWS consecutive rows i, so that
  // a row's p2, q1 - p2 and q2 - p2 are the next row's p1, q1 - p1 and
  // q2 - p1 (the compiler keeps them in registers). Every pair of the tile
  // is evaluated, branch-free, and the band, the lower half of a diagonal
  // tile and the ragged edge are then set to 0 (their points are finite:
  // zero past the chain's end).
  const int jl = threadIdx.x;
  const int j = j0 + jl;
  const V3 q1 = {pj[0][jl], pj[1][jl], pj[2][jl]};
  const V3 q2 = {pj[0][jl + 1], pj[1][jl + 1], pj[2][jl + 1]};
  const V3 dq = sub(q2, q1);
  float sum = 0.0f, abs_sum = 0.0f;
#pragma unroll
  for (int r = 0; r < TILE / ROWS; ++r) {
    const int il = threadIdx.y * (TILE / ROWS) + r;
    const int i = i0 + il;
    const V3 p1 = {pi[0][il], pi[1][il], pi[2][il]};
    const V3 p2 = {pi[0][il + 1], pi[1][il + 1], pi[2][il + 1]};
    const float w_ij = pair_writhe(p1, p2, q1, q2, dq);
    // i < j always: off the band, and in a diagonal tile its upper half
    const float w = j < m && j - i > 1 ? w_ij : 0.0f;
    tile[il][jl] = w;
    if constexpr (SUMS) {
      sum += w;
      abs_sum += fabsf(w);
    }
  }
  if constexpr (SUMS) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      abs_sum += __shfl_xor_sync(0xffffffffu, abs_sum, o);
    }
    if (threadIdx.x == 0) warp_sums[threadIdx.y] = make_float2(sum, abs_sum);
  }
  __syncthreads();

  float* map = out + b * static_cast<int64_t>(m) * m;
  if (ti == tj) {
    store_tile(map, m, i0, i0, [&](int r, int c) {
      return r < c ? tile[r][c] : tile[c][r];
    });
  } else {
    store_tile(map, m, i0, j0, [&](int r, int c) { return tile[r][c]; });
    store_tile(map, m, j0, i0, [&](int r, int c) { return tile[c][r]; });
  }

  if constexpr (SUMS) {
    __shared__ bool last;
    if (tid == 0) {
      float2 total = warp_sums[0];
      for (int w = 1; w < ROWS; ++w) {
        total.x += warp_sums[w].x;
        total.y += warp_sums[w].y;
      }
      partial[blk] = total;
      __threadfence();
      last = atomicAdd(tickets + b, 1u) == static_cast<unsigned>(pairs - 1);
    }
    __syncthreads();
    if (last && threadIdx.y == 0) {
      __threadfence();
      sum_partials(partial + b * pairs, pairs, wr + b, acn + b);
    }
  }
}

// Checks the shape and launches writhe_kernel<SUMS>; 0 or a cudaError_t.
template <bool SUMS>
int launch_map(const float* coords, float* out, float2* partial,
               unsigned* tickets, float* wr, float* acn, int64_t batch, int n,
               cudaStream_t stream) {
  if (batch < 1 || n < 3) return static_cast<int>(cudaErrorInvalidValue);
  const int m = n - 1;
  const int64_t tiles = (m + TILE - 1) / TILE;
  const int64_t pairs = tiles * (tiles + 1) / 2;
  const int64_t blocks = batch * pairs;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks));
  dim3 block(TILE, ROWS);
  if (SUMS) {
    const cudaError_t err = cudaMemsetAsync(
        tickets, 0, static_cast<size_t>(batch) * sizeof(unsigned), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  writhe_kernel<SUMS><<<grid, block, 0, stream>>>(
      coords, out, partial, tickets, wr, acn, n, m, static_cast<int>(tiles),
      static_cast<int>(pairs));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coords: (batch, n, 3) fp32 contiguous on the device; out: (batch, n-1, n-1)
// fp32 contiguous. Launches on `stream` and returns cudaGetLastError(); the
// caller guarantees batch >= 1 and n >= 3 (smaller maps are all band).
extern "C" int writhe_map_launch(const float* coords, float* out,
                                 int64_t batch, int n, void* stream) {
  return launch_map<false>(coords, out, nullptr, nullptr, nullptr, nullptr,
                           batch, n, static_cast<cudaStream_t>(stream));
}

// As writhe_map_launch, and wr, acn: (batch,) fp32, each structure's
// sum(W) / 2 and sum(|W|) / 2, from the same launch. Scratch: partial,
// batch * T(T+1)/2 float2, T = ceil((n-1) / 32); tickets, batch uint32,
// zeroed here on `stream` before the launch.
extern "C" int writhe_map_sums_launch(const float* coords, float* out,
                                      float* partial, unsigned* tickets,
                                      float* wr, float* acn, int64_t batch,
                                      int n, void* stream) {
  return launch_map<true>(coords, out, reinterpret_cast<float2*>(partial),
                          tickets, wr, acn, batch, n,
                          static_cast<cudaStream_t>(stream));
}

extern "C" const char* writhe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

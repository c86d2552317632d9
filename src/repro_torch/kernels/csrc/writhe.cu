// Gauss-linking writhe map for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/writhe.py::writhe_map
// (pallas_call at :97, body _writhe_kernel :63, math _writhe_block :40).
// Its plain PyTorch version is repro_torch/kernels/writhe.py::writhe_map_ref.
//
// What it computes: coords (B, n, 3) fp32 -> W (B, n-1, n-1) fp32, where
// W[b, i, j] is the signed solid angle of segment pair (i, j) times 2/(4 pi)
// (Klenin-Langowski method 1a), and W is 0 on the band |i - j| <= 1.
//
// What bounds it on this card: the output stream, narrowly. Each off-band
// pair costs 152 fp32 operations as written below, an FMA counting two
// (12 differences, 4 cross products, 4 normalisations with sqrtf and one
// division each, 4 dots, 4 clips, 4 asinf, the sign triple product and the
// scale; the count is OPS_PER_PAIR in chip_smoke.py), and asinf, sqrtf and
// the IEEE division expand into several instructions each. W is symmetric,
// so the function needs each unordered pair once: at B=4000, n=512 that is
// 5.2e8 pairs, 7.9e10 operations, 1.18 ms at 67 TFLOP/s, against 1.25 ms
// to write the 4.2 GB of output at 3.35 TB/s. Reads are almost nothing
// (the 12-byte points are shared by a whole tile row or column). This
// kernel evaluates both triangles, every ordered pair, so it issues twice
// the operations the function needs (2.36 ms of them at the peak rate).
//
// What the design does about it:
//  * One thread per (i, j) output, TILE x TILE outputs per block, each
//    thread doing TILE/ROWS rows. The tile's TILE+1 points on each side
//    are staged once in shared memory, so global traffic is the output
//    stream plus 2 * 33 points per 1024 pairs.
//  * Threads along x walk j, so each warp writes 128 contiguous bytes of
//    one output row; the i-side reads are warp-wide shared-memory
//    broadcasts, the j-side reads are conflict-free.
//  * The band is zeroed without evaluating it; the ragged edge is masked
//    in the kernel, so the output is written at (B, n-1, n-1) directly,
//    with no padding buffer and no slice copy.
//  * The batch is folded into gridDim.x (limit 2^31 - 1) with the tile
//    indices; output offsets are 64-bit (B * (n-1)^2 passes 2^31).
//  * No --use_fast_math: sqrtf and division stay IEEE, the argument of
//    asinf is clipped to [-1, 1] first, and the norm is
//    sqrt(dot + 1e-12) as in the reference, so zero-length and collinear
//    segments give 0 and never NaN. FMA contraction is left on: the
//    tolerance (atol 6e-4, rtol 1e-3) covers it.
//  * Sign is written out by hand: jnp.sign gives 0 at 0, copysignf would
//    give +-1.
//  * Each pair is evaluated with the lower segment index first, so the map
//    is exactly symmetric. The reference evaluates (i, j) and (j, i) in two
//    operand orders, and its round-off makes them differ by up to about
//    2e-4 at 512 points; the kernel's W[j, i] stays within the comparison
//    tolerance of the reference's.
// Computing one triangle and mirroring it would halve the operations, down
// to what the function needs. That is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;  // outputs per tile side
constexpr int ROWS = 8;   // threadIdx.y extent; each thread does TILE/ROWS rows

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

__device__ __forceinline__ V3 unit(V3 a) {
  float inv = 1.0f / sqrtf(dot(a, a) + 1e-12f);
  return {a.x * inv, a.y * inv, a.z * inv};
}

__device__ __forceinline__ float asin_clip(float x) {
  return asinf(fminf(fmaxf(x, -1.0f), 1.0f));
}

// Signed contribution of segment pair (p1 -> p2, q1 -> q2): _writhe_block.
__device__ __forceinline__ float pair_writhe(V3 p1, V3 p2, V3 q1, V3 q2) {
  V3 r13 = sub(q1, p1);
  V3 r14 = sub(q2, p1);
  V3 r23 = sub(q1, p2);
  V3 r24 = sub(q2, p2);
  V3 n1 = unit(cross(r13, r14));
  V3 n2 = unit(cross(r14, r24));
  V3 n3 = unit(cross(r24, r23));
  V3 n4 = unit(cross(r23, r13));
  float omega = asin_clip(dot(n1, n2)) + asin_clip(dot(n2, n3)) +
                asin_clip(dot(n3, n4)) + asin_clip(dot(n4, n1));
  float s = dot(cross(sub(q2, q1), sub(p2, p1)), r13);
  float sign = s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : 0.0f);
  return omega * sign / 12.566370614359172f * 2.0f;
}

__global__ void __launch_bounds__(TILE * ROWS)
writhe_kernel(const float* __restrict__ coords, float* __restrict__ out,
              int n, int m, int tiles) {
  // blockIdx.x = (b * tiles + ti) * tiles + tj
  int64_t blk = blockIdx.x;
  const int tj = static_cast<int>(blk % tiles);
  blk /= tiles;
  const int ti = static_cast<int>(blk % tiles);
  const int64_t b = blk / tiles;

  // points i0 .. i0 + TILE and j0 .. j0 + TILE, one array per axis
  __shared__ float pi[3][TILE + 1];
  __shared__ float pj[3][TILE + 1];
  const float* c = coords + b * static_cast<int64_t>(n) * 3;
  const int i0 = ti * TILE;
  const int j0 = tj * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int k = tid; k < 3 * (TILE + 1); k += TILE * ROWS) {
    const int p = k / 3;
    const int d = k - 3 * p;
    pi[d][p] = i0 + p < n ? c[(i0 + p) * 3 + d] : 0.0f;
    pj[d][p] = j0 + p < n ? c[(j0 + p) * 3 + d] : 0.0f;
  }
  __syncthreads();

  const int jl = threadIdx.x;
  const int j = j0 + jl;
  if (j >= m) return;
  const V3 q1 = {pj[0][jl], pj[1][jl], pj[2][jl]};
  const V3 q2 = {pj[0][jl + 1], pj[1][jl + 1], pj[2][jl + 1]};
#pragma unroll
  for (int r = 0; r < TILE / ROWS; ++r) {
    const int il = threadIdx.y + r * ROWS;
    const int i = i0 + il;
    if (i >= m) break;
    float w = 0.0f;
    if (abs(i - j) > 1) {
      const V3 p1 = {pi[0][il], pi[1][il], pi[2][il]};
      const V3 p2 = {pi[0][il + 1], pi[1][il + 1], pi[2][il + 1]};
      // lower segment index first, so W[i, j] and W[j, i] are bitwise equal
      const bool lower = i < j;
      w = pair_writhe(lower ? p1 : q1, lower ? p2 : q2,
                      lower ? q1 : p1, lower ? q2 : p2);
    }
    out[(b * m + i) * m + j] = w;
  }
}

}  // namespace

// coords: (batch, n, 3) fp32 contiguous on the device; out: (batch, n-1, n-1)
// fp32 contiguous. Launches on `stream` and returns cudaGetLastError(); the
// caller guarantees batch >= 1 and n >= 3 (smaller maps are all band).
extern "C" int writhe_map_launch(const float* coords, float* out,
                                 int64_t batch, int n, void* stream) {
  if (batch < 1 || n < 3) return static_cast<int>(cudaErrorInvalidValue);
  const int m = n - 1;
  const int64_t tiles = (m + TILE - 1) / TILE;
  const int64_t blocks = batch * tiles * tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks));
  dim3 block(TILE, ROWS);
  writhe_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      coords, out, n, m, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* writhe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

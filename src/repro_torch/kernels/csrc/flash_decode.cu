// Flash-decode for NVIDIA Hopper (sm_90a), hand-written CUDA C++: one query
// token per slot against a dense or a paged KV cache, GQA, online softmax,
// with each slot's key range split over the blocks of a thread-block
// cluster and merged by log-sum-exp through distributed shared memory.
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
// reference's flash_decode_xla and flash_decode_paged_xla);
// split_partial_ref and merge_partials there are the plain versions of one
// split and of the merge.
//
// What it computes, per slot b and query head hq = kh * G + g:
//   out[b, 0, hq] = sum_j p_j v[j, kh] / sum_j p_j,
//   p_j = exp(scale * q.k[j, kh] - max), over the keys j whose position kp
//   satisfies kp >= 0, kp <= q_pos[b] and, with a window, kp > q_pos - window.
// A slot with no such key writes exact zeros (l = 0 gives acc / 1e-37 = 0).
// When asked (a non-null lse), the dense kernel also writes each head's
// log-sum-exp, lse[b, 0, hq] = log sum_j exp(scale * q.k[j, kh]) in float32
// natural units, -inf with no attended key: what a caller needs to merge
// the outputs of several launches over disjoint key ranges (the sequence-
// sharded decode). It is written where the output is finalised: by the
// single block when there is one split, in the cluster's merge otherwise;
// a block that attends nothing (bounded past q_pos, or every key masked)
// finalises with l = 0 like any other.
// Softmax statistics and the (G, Dv) accumulator stay in float32 (scores in
// log2 units, exp2f); the output is in q's type. Unlike the Pallas kernel,
// p is not rounded to the value type before the p.V product (the XLA twin
// does not round it either).
//
// What bounds it on this card: the bytes of valid K and V, at 3.35 TB/s.
// Each key costs 4 * G * D operations against 2 * D * elem bytes, at most
// G <= 16 operations a byte, below the fp32 CUDA-core ridge (about 20), so
// tensor cores buy nothing. At the serving main path's sizes (gemma3-1b:
// 8 slots, one KV head, 512 ring keys or ~600 paged keys of 256 dims) the
// bytes are a few MB, about a microsecond, so what rules is latency: how
// many memory requests are in flight on how many SMs, and how long the
// chain of dependent steps inside a block is (one block of 4 warps on an SM
// hides no latency, and its code runs once, from a cold instruction
// cache). One block per (KV head, slot) would be 8 blocks on 132 SMs, each
// walking its keys tile after tile.
//
// What the design does about it:
//  * Split-KV. A block takes (split, KV head and head group, slot): a
//    contiguous range of cache rows (dense) or a run of whole pages
//    (paged). The wrapper picks the split count from shapes alone (S or
//    n_pages, B, K, the head groups and the SM count; never from
//    positions, so it reads nothing back from the card): about four blocks
//    an SM, at most 16 splits, and none where the unsplit blocks already
//    fill the card. Each block keeps up to GROUP_G = 8 query heads of its KV
//    head together, so a K/V row is read once for all of them. A wider
//    group (recurrentgemma-2b: 10 query heads on one KV head) is cut into
//    ceil(G / 8) head groups of ceil(G / groups) heads, one block each,
//    which read the same rows (the second read can hit L2): a block that
//    held all 16 heads would keep 16 x 8 query and 16 x 8 accumulator
//    floats a lane at RL = 32, more than the 255 registers a thread has,
//    and spill in its inner loop. A split whose rows lie wholly past q_pos,
//    before the window or on unbound pages stops at once with an empty
//    partial (m = NEG_INF, l = 0).
//  * The merge runs in the same launch: the splits of a (slot, KV head,
//    head group) are one thread-block cluster (cudaLaunchKernelEx; more
//    than 8 blocks with the non-portable size attribute). Each block
//    leaves its partial (m, l, acc[G, Dv]) in fp32 in its shared memory;
//    after a cluster barrier, block r merges a 1/n_split slice of the
//    output from all the partials, read through distributed shared memory
//    in split order, so the result is bit-identical whatever order the
//    blocks run in. No
//    workspace, no atomics; a second barrier keeps every partial alive
//    until it is read.
//  * Loads stay in flight: K and V tiles of 32 rows are staged with 16-byte
//    cp.async.cg into a ring of 3 stages, the next tiles loading while this
//    one is computed; a block of one or two tiles issues all its loads at
//    once. A tile's positions (dense) or page-table entries (paged) come by
//    4-byte cp.async two tiles ahead of its K/V (the first two while q_pos
//    loads, where the rows do not depend on it), so each row's validity
//    and address are known when its copy is issued: invalid rows are
//    zero-filled through the source-size operand and never read. Rows that
//    are not 16-byte aligned take an element-load path.
//  * Short chains: one barrier a tile; each warp owns 8 rows of every tile,
//    in lane groups of RL lanes a row (RL = 8, 16 or 32 by head dim, so a
//    row is one 16-byte vector a lane). A lane's partial dot products for
//    all its rows and heads reduce across the group in one reduce-scatter
//    (31 shuffles for 8 rows x 4 heads at RL = 32, not 160 in 8 dependent
//    chains), then every lane reads the tile's scores back from shared
//    memory for the online softmax; the groups and then the warps merge
//    once at the end, in a fixed order. fp32 FMAs on the CUDA cores.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 32;                   // rows per tile
constexpr int WARP_ROWS = TILE / WARPS;    // rows each warp owns in a tile
constexpr int NST = 3;                     // K/V stages in the ring
constexpr int NMETA = NST + 2;             // position / page-entry tiles
constexpr int MAX_G = 16;                  // query heads per KV head
constexpr int GROUP_G = 8;                 // of them in one block
constexpr int MAX_D = 256;                 // head dim of K and of V
constexpr int MAX_SPLIT = 16;              // a cluster, as split_plan's
constexpr int PORTABLE_CLUSTER = 8;
constexpr int MAX_SMEM = 227 * 1024;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;      // (B, 1, K * G, Dk), contiguous
  const void* k;      // dense (B, S, K, Dk) | paged (P, page_size, K, Dk)
  const void* v;      // the same with Dv
  const int* q_pos;   // (B,)
  const int* meta;    // dense: k_pos (B, S) | paged: table (B, n_pages);
                      // contiguous, -1 = invalid / unbound
  void* out;          // (B, 1, K * G, Dv), contiguous
  float* lse;         // (B, 1, K * G) float32 log-sum-exp, or null
  int S;              // rows per slot (paged: n_pages * page_size)
  int K, G, Dk, Dv;  // G: query heads per KV head
  int page_size, n_pages, paged;
  int page_shift;     // log2(page_size) when it is a power of two, else -1
  int split_rows, n_split;
  long long k_s0, k_s1, k_s2;  // element strides of k's first three axes
  long long v_s0, v_s1, v_s2;
  float scale;
  int window;   // <= 0: no window
  int bounded;  // dense: row index == position, stop at q_pos
  int vec;      // rows may be read with 16-byte loads
  int nvk, nvv; // 16-byte vectors per K / V row (smem rows padded to them)
  int GH, GS;   // head groups per KV head, query heads per group
};

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Dynamic shared memory: the K/V ring, whose bytes the block's partial
// takes over after the last tile (the warps' (m, l, acc), their weights,
// the block's (m, l) and acc, which peers read); the tile's scores; the
// position / page-entry ring.
struct Layout {
  size_t score, meta, total;
  int pk, pv;          // smem row pitch of K and V, in elements
  size_t stage;        // elements of one K + V stage
};

__host__ __device__ inline Layout layout(int elem, int nvk, int nvv,
                                         int maxg) {
  Layout L;
  const int ve = 16 / elem;
  L.pk = nvk * ve;
  L.pv = nvv * ve;
  L.stage = static_cast<size_t>(TILE) * (L.pk + L.pv);
  const size_t ring = NST * L.stage * elem;
  const size_t part =
      (static_cast<size_t>(WARPS) * maxg * (3 + L.pv) + 2 * maxg +
       static_cast<size_t>(maxg) * L.pv) * 4;
  L.score = up16(ring > part ? ring : part);
  L.meta = L.score + static_cast<size_t>(TILE) * maxg * 4;
  L.total = up16(L.meta + static_cast<size_t>(NMETA) * TILE * 4);
  return L;
}

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int VE = 4;   // elements in 16 bytes
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static __forceinline__ float to_f(float x) { return x; }
  __device__ static __forceinline__ float from_f(float x) { return x; }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int VE = 8;
  // a bf16 is the top half of a float; the lower address holds the low half
  __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool read) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // source size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(read ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Position of the key in row `row` of the slot, whose entry in the meta
// array (position or page) is mv; -1 when the key does not exist.
__device__ __forceinline__ int key_pos(const Params& p, int row, int mv) {
  return p.paged ? (mv >= 0 ? row : -1) : mv;
}

__device__ __forceinline__ bool attends(const Params& p, int kp, int qp) {
  return kp >= 0 && kp <= qp && (p.window <= 0 || kp > qp - p.window);
}

// row / page_size and row % page_size, by shift and mask for the usual
// power-of-two pages
__device__ __forceinline__ int page_of(const Params& p, int row) {
  return p.page_shift >= 0 ? row >> p.page_shift : row / p.page_size;
}

__device__ __forceinline__ int in_page(const Params& p, int row) {
  return p.page_shift >= 0 ? row & (p.page_size - 1) : row % p.page_size;
}

__device__ __forceinline__ long long row_off(const Params& p, int b, int h,
                                             int row, int mv, long long s0,
                                             long long s1, long long s2) {
  return p.paged
             ? mv * s0 + static_cast<long long>(in_page(p, row)) * s1 + h * s2
             : b * s0 + static_cast<long long>(row) * s1 + h * s2;
}

// Stage the K and V rows of one tile: 16-byte cp.async where rows are
// aligned (a thread's (row, vector) pairs stepped without a division),
// element loads otherwise; rows whose key is not attended are zero-filled
// and not read.
template <typename T>
__device__ __forceinline__ void stage_tile(const Params& p, T* ks, T* vs,
                                           const T* kg, const T* vg,
                                           const int* mt, int row0, int b,
                                           int h, int qp, int pk, int pv) {
  constexpr int VE = Elem<T>::VE;
  if (p.vec) {
    const int nv = p.nvk > p.nvv ? p.nvk : p.nvv;
    const int dr = THREADS / nv, dc = THREADS - dr * nv;
    int r = threadIdx.x / nv;
    int c = threadIdx.x - r * nv;
    while (r < TILE) {
      const int row = row0 + r;
      const int mv = mt[r];
      const bool ok = attends(p, key_pos(p, row, mv), qp);
      if (c < p.nvk)
        cp_async16(ks + r * pk + c * VE,
                   ok ? kg + row_off(p, b, h, row, mv, p.k_s0, p.k_s1,
                                     p.k_s2) + c * VE
                      : kg,
                   ok);
      if (c < p.nvv)
        cp_async16(vs + r * pv + c * VE,
                   ok ? vg + row_off(p, b, h, row, mv, p.v_s0, p.v_s1,
                                     p.v_s2) + c * VE
                      : vg,
                   ok);
      r += dr;
      c += dc;
      if (c >= nv) {
        c -= nv;
        ++r;
      }
    }
  } else {
    for (int i = threadIdx.x; i < TILE * pk; i += THREADS) {
      const int r = i / pk;
      const int d = i - r * pk;
      const int row = row0 + r;
      const int mv = mt[r];
      const bool ok = d < p.Dk && attends(p, key_pos(p, row, mv), qp);
      ks[i] = ok ? kg[row_off(p, b, h, row, mv, p.k_s0, p.k_s1, p.k_s2) + d]
                 : Elem<T>::from_f(0.0f);
    }
    for (int i = threadIdx.x; i < TILE * pv; i += THREADS) {
      const int r = i / pv;
      const int d = i - r * pv;
      const int row = row0 + r;
      const int mv = mt[r];
      const bool ok = d < p.Dv && attends(p, key_pos(p, row, mv), qp);
      vs[i] = ok ? vg[row_off(p, b, h, row, mv, p.v_s0, p.v_s1, p.v_s2) + d]
                 : Elem<T>::from_f(0.0f);
    }
  }
}

// Sum each of a lane's N values over the RL lanes of its group (xor
// offsets O, O / 2, ..., 1 with O = RL / 2), halving the values a lane
// keeps at each level: afterwards lane li holds, for N >= RL, the totals of
// indices li * N / RL + i in x[i] (i < N / RL), and for N < RL the total
// of index li / (RL / N) in x[0].
template <int N, int O>
struct Scatter {
  __device__ static __forceinline__ void run(float* x, int li) {
    if constexpr (O > 0) {
      if constexpr (N >= 2) {
        const bool up = li & O;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          const float send = up ? x[i] : x[i + N / 2];
          const float keep = up ? x[i + N / 2] : x[i];
          x[i] = keep + __shfl_xor_sync(FULL, send, O);
        }
        Scatter<N / 2, O / 2>::run(x, li);
      } else {
        x[0] += __shfl_xor_sync(FULL, x[0], O);
        Scatter<1, O / 2>::run(x, li);
      }
    }
  }
};

// A head's log-sum-exp in natural units from its running max mx (in log2
// units, as the scores are kept) and its normalizer ls: mx ln 2 + ln ls,
// and -inf where no key was attended (ls = 0).
__device__ __forceinline__ float head_lse(float mx, float ls) {
  return ls > 0.0f ? fmaf(mx, LN2, logf(ls)) : -__int_as_float(0x7f800000);
}

// The merge of a cluster's n_split partials (m, l at part_ml, acc at
// part_a in each block's shared memory): after a cluster barrier, block
// `rank` writes its slice of the G * Dv outputs, each from the partials of
// all the blocks in rank (split) order; an empty split (l = 0) weighs 0. A
// second barrier keeps every block's partial until all have read it.
template <typename T>
__device__ __forceinline__ void merge_cluster(const Params& p, int G,
                                              float* part_ml, float* part_a,
                                              T* og, float* lse, int rank) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int Dv = p.Dv, GD = G * Dv, ns = p.n_split;
  const int slice = (GD + ns - 1) / ns;
  for (int k = threadIdx.x; k < slice && rank * slice + k < GD;
       k += THREADS) {
    const int i = rank * slice + k;
    const int g = i / Dv;
    float mj[MAX_SPLIT], lj[MAX_SPLIT], aj[MAX_SPLIT];
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j) {   // every load issued at once
      if (j < ns) {
        const float* ml = cluster.map_shared_rank(part_ml, j);
        mj[j] = ml[2 * g];
        lj[j] = ml[2 * g + 1];
        aj[j] = cluster.map_shared_rank(part_a, j)[i];
      }
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j)
      if (j < ns && lj[j] > 0.0f) mx = fmaxf(mx, mj[j]);
    float ls = 0.0f, a = 0.0f;
#pragma unroll
    for (int j = 0; j < MAX_SPLIT; ++j) {
      if (j < ns && lj[j] > 0.0f) {
        const float wt = exp2f(mj[j] - mx);
        ls += lj[j] * wt;
        a += aj[j] * wt;
      }
    }
    og[i] = Elem<T>::from_f(a / fmaxf(ls, 1e-37f));
    // the head's log-sum-exp, once: by the thread that holds its column 0
    if (lse != nullptr && i == g * Dv) lse[g] = head_lse(mx, ls);
  }
  cluster.sync();
}

// RL lanes share a row (one 16-byte vector each, NC vectors when RL = 32
// cannot cover the row); MAXG >= the block's query heads (its head group),
// the extra ones with q = 0.
// The register cap keeps several blocks on an SM where G is small.
template <typename T, int RL, int MAXG>
__global__ void __launch_bounds__(THREADS, MAXG == 1 ? 8
                                           : MAXG == 2 ? 4
                                           : MAXG == 4 ? 3 : 1)
    decode_kernel(const Params p) {
  using E = Elem<T>;
  constexpr int VE = E::VE;
  constexpr int KPS = 32 / RL;             // rows a warp takes at once
  constexpr int STEPS = WARP_ROWS / KPS;   // of them per tile
  constexpr int NC = RL == 32 ? MAX_D / (32 * VE) : 1;
  constexpr int N = STEPS * MAXG;          // a lane's (row, head) partials
  static_assert(WARP_ROWS % KPS == 0, "a warp's rows split into steps");
  static_assert(NC >= 1, "a lane holds at least one vector");

  // Head groups (GH > 1) come only with G > GROUP_G, whose groups of at
  // least 5 heads run the GROUP_G instantiation; the others keep one group
  // a KV head at compile time (the group's offsets would hold registers,
  // which the capped small-group instantiations spill)
  constexpr bool GROUPED = MAXG == GROUP_G;
  const int sp = blockIdx.x;   // split, the block's rank in its cluster
  const int h = GROUPED ? blockIdx.y / p.GH : blockIdx.y;  // KV head
  const int g0 = GROUPED ? (blockIdx.y - h * p.GH) * p.GS : 0;  // 1st head
  const int b = blockIdx.z;    // slot
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gi = lane / RL;    // the warp's lane group
  const int li = lane % RL;    // lane within the group
  const int G = GROUPED ? min(p.GS, p.G - g0) : p.G;   // the block's heads
  const int Dv = p.Dv;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(sizeof(T), p.nvk, p.nvv, MAXG);
  T* ring = reinterpret_cast<T*>(smem);
  float* score_s = reinterpret_cast<float*>(smem + L.score);
  int* meta_s = reinterpret_cast<int*>(smem + L.meta);
  const int pk = L.pk, pv = L.pv;

  const long long pair = static_cast<long long>(b) * p.K + h;
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  const int* mg = p.meta + static_cast<long long>(b) *
                               (p.paged ? p.n_pages : p.S);
  const int r0 = sp * p.split_rows;
  const int end = min(p.S, r0 + p.split_rows);   // the split's rows
  int lo = r0;

  // positions / page entries of tile j (rows from lo), by cp.async; -1
  // past the split. Rows past q_pos or before the window that land here
  // are masked by attends().
  auto fetch_meta = [&](int j) {
    if (tid < TILE) {
      const int row = lo + j * TILE + tid;
      int* dst = meta_s + (j % NMETA) * TILE + tid;
      if (row < end)
        cp_async4(dst, mg + (p.paged ? page_of(p, row) : row));
      else
        *dst = -1;
    }
  };
  // the first rows do not depend on q_pos unless a window moves them: then
  // the first two tiles' positions load while q_pos does
  const bool early = !(p.paged || p.bounded) || p.window <= 0;
  if (early) {
    fetch_meta(0);
    fetch_meta(1);
    cp_async_commit();
  }
  const int qp = p.q_pos[b];
  int hi = end;
  if (p.paged || p.bounded) {      // row index == position
    hi = min(hi, qp + 1);
    if (p.window > 0) lo = max(lo, qp - p.window + 1);
  }
  const int n_t = hi > lo ? (hi - lo + TILE - 1) / TILE : 0;

  float m[MAXG], l[MAXG], acc[MAXG][NC][VE];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[g][c][e] = 0.0f;
  }

  if (n_t > 0) {
    const float scale2 = p.scale * LOG2E;
    float qr[MAXG][NC][VE];
    const T* qg = static_cast<const T*>(p.q) + (pair * p.G + g0) * p.Dk;
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const int d = (c * RL + li) * VE + e;
          qr[g][c][e] = g < G && d < p.Dk ? E::to_f(qg[g * p.Dk + d]) : 0.0f;
        }
    if (!early) {
      fetch_meta(0);
      fetch_meta(1);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();

    // this lane group's scores of the tile, [STEPS][MAXG]
    float* sc = score_s + (warp * KPS + gi) * N;
    // Iteration t waits for group t (K/V(t), meta(t + 2)), then issues
    // group t + NST - 1 (meta(t + NST + 1) into tile t - 1's meta slot,
    // K/V(t + NST - 1) into its stage), then computes tile t. The first
    // NST - 1 iterations only issue. One call site each keeps the code
    // small: a block of one or two tiles runs it once, from a cold
    // instruction cache.
    for (int t = 1 - NST; t < n_t; ++t) {
      if (t >= 0) {
        cp_async_wait<NST - 2>();
        __syncthreads();
      }
      const int jm = t + NST + 1;
      if (jm < n_t) fetch_meta(jm);
      const int jk = t + NST - 1;
      if (jk < n_t) {
        T* ks = ring + (jk % NST) * L.stage;
        stage_tile<T>(p, ks, ks + TILE * pk, kg, vg,
                      meta_s + (jk % NMETA) * TILE, lo + jk * TILE, b, h,
                      qp, pk, pv);
      }
      cp_async_commit();
      if (t < 0) continue;

      const T* ks = ring + (t % NST) * L.stage;
      const T* vs = ks + TILE * pk;
      const int* mt = meta_s + (t % NMETA) * TILE;
      const int row0 = lo + t * TILE;
      // partial dot products of the group's rows, all heads
      float x[N];
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = 0.0f;
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int r = warp * WARP_ROWS + st * KPS + gi;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int vi = c * RL + li;
          if (vi < p.nvk) {
            float kf[VE];
            E::unpack(*reinterpret_cast<const uint4*>(ks + r * pk + vi * VE),
                      kf);
#pragma unroll
            for (int g = 0; g < MAXG; ++g)
#pragma unroll
              for (int e = 0; e < VE; ++e)
                x[st * MAXG + g] = fmaf(qr[g][c][e], kf[e], x[st * MAXG + g]);
          }
        }
      }
      // summed over the group's lanes, then shared with all of them
      Scatter<N, RL / 2>::run(x, li);
      if constexpr (N >= RL) {
#pragma unroll
        for (int i = 0; i < N / RL; ++i) sc[li * (N / RL) + i] = x[i];
      } else {
        if (li % (RL / N) == 0) sc[li / (RL / N)] = x[0];
      }
      __syncwarp();
      // online softmax over the tile; p is masked explicitly (with no
      // attended key yet m stays NEG_INF and exp2(NEG_INF - NEG_INF) = 1
      // would attend to a zero row)
      bool ok[STEPS];
      float pr[STEPS][MAXG];
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int r = warp * WARP_ROWS + st * KPS + gi;
        ok[st] = attends(p, key_pos(p, row0 + r, mt[r]), qp);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          pr[st][g] = ok[st] ? sc[st * MAXG + g] * scale2 : NEG_INF;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float m_new = m[g];
#pragma unroll
        for (int st = 0; st < STEPS; ++st) m_new = fmaxf(m_new, pr[st][g]);
        const float corr = exp2f(m[g] - m_new);
        float psum = 0.0f;
#pragma unroll
        for (int st = 0; st < STEPS; ++st) {
          pr[st][g] = ok[st] ? exp2f(pr[st][g] - m_new) : 0.0f;
          psum += pr[st][g];
        }
        m[g] = m_new;
        l[g] = fmaf(l[g], corr, psum);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[g][c][e] *= corr;
      }
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int r = warp * WARP_ROWS + st * KPS + gi;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int vi = c * RL + li;
          if (vi < p.nvv) {
            float vf[VE];
            E::unpack(*reinterpret_cast<const uint4*>(vs + r * pv + vi * VE),
                      vf);
#pragma unroll
            for (int g = 0; g < MAXG; ++g)
#pragma unroll
              for (int e = 0; e < VE; ++e)
                acc[g][c][e] = fmaf(pr[st][g], vf[e], acc[g][c][e]);
          }
        }
      }
    }
    cp_async_wait<0>();   // only empty groups remain; nothing writes smem
  } else if (early) {
    cp_async_wait<0>();   // the early positions, unused
  }
  __syncthreads();        // the ring is free: the partials take it over

  // merge the warp's lane groups: the lower group's term first on both
  // partners, so both hold the same sums
#pragma unroll
  for (int o = RL; o < 32; o <<= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], o);
      const float lo_ = __shfl_xor_sync(FULL, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float w_me = exp2f(m[g] - mx), w_o = exp2f(mo - mx);
      const float w0 = upper ? w_o : w_me, w1 = upper ? w_me : w_o;
      const float l0 = upper ? lo_ : l[g], l1 = upper ? l[g] : lo_;
      l[g] = l0 * w0 + l1 * w1;
      m[g] = mx;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const float ao = __shfl_xor_sync(FULL, acc[g][c][e], o);
          const float a0 = upper ? ao : acc[g][c][e];
          const float a1 = upper ? acc[g][c][e] : ao;
          acc[g][c][e] = a0 * w0 + a1 * w1;
        }
    }
  }

  // the warps' partials, merged in warp order into the block's
  float* red_m = reinterpret_cast<float*>(smem);   // [WARPS][MAXG]
  float* red_l = red_m + WARPS * MAXG;             // [WARPS][MAXG]
  float* red_w = red_l + WARPS * MAXG;             // [WARPS][MAXG]
  float* red_a = red_w + WARPS * MAXG;             // [WARPS][MAXG][pv]
  float* part_ml = red_a + WARPS * MAXG * pv;      // [MAXG][2]: m, l
  float* part_a = part_ml + 2 * MAXG;              // [G * Dv]
  if (gi == 0) {
    if (li == 0) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        red_m[warp * MAXG + g] = m[g];
        red_l[warp * MAXG + g] = l[g];
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int vi = c * RL + li;
      if (vi < p.nvv) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            red_a[(warp * MAXG + g) * pv + vi * VE + e] = acc[g][c][e];
      }
    }
  }
  __syncthreads();
  if (tid < G) {   // each (warp, head)'s weight, computed once
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red_m[w * MAXG + tid]);
    float ls = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(red_m[w * MAXG + tid] - mx);
      red_w[w * MAXG + tid] = wt;
      ls += red_l[w * MAXG + tid] * wt;
    }
    part_ml[2 * tid] = mx;
    part_ml[2 * tid + 1] = ls;
    // one split: the block's statistics are the head's (an empty one, with
    // no tile or every key masked, gives ls = 0 and -inf)
    if (p.n_split == 1 && p.lse != nullptr)
      p.lse[pair * p.G + g0 + tid] = head_lse(mx, ls);
  }
  __syncthreads();

  const int GD = G * Dv;
  T* og = static_cast<T*>(p.out) + (pair * p.G + g0) * Dv;
  for (int i = tid; i < GD; i += THREADS) {
    const int g = i / Dv;
    const int col = i - g * Dv;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      a += red_a[(w * MAXG + g) * pv + col] * red_w[w * MAXG + g];
    if (p.n_split == 1)
      og[i] = E::from_f(a / fmaxf(part_ml[2 * g + 1], 1e-37f));
    else
      part_a[i] = a;
  }
  if (p.n_split > 1)
    merge_cluster<T>(p, G, part_ml, part_a, og,
                     p.lse != nullptr ? p.lse + pair * p.G + g0 : nullptr,
                     sp);
}

// The attribute is raised once per device and kernel (a bit a device).
template <typename K>
cudaError_t raise_once(K kernel, cudaFuncAttribute attr, int value,
                       unsigned long long* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (__atomic_load_n(done, __ATOMIC_ACQUIRE) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, attr, value);
  if (e == cudaSuccess) __atomic_fetch_or(done, bit, __ATOMIC_RELEASE);
  return e;
}

template <typename T, int RL, int MAXG>
int launch(const Params& p, int B, cudaStream_t stream) {
  auto kernel = decode_kernel<T, RL, MAXG>;
  const size_t smem = layout(sizeof(T), p.nvk, p.nvv, MAXG).total;
  if (smem > static_cast<size_t>(MAX_SMEM))
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long smem_raised = 0, cluster_raised = 0;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)   // the attribute allows, it does not reserve
    e = raise_once(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   MAX_SMEM, &smem_raised);
  if (e == cudaSuccess && p.n_split > PORTABLE_CLUSTER)
    e = raise_once(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1,
                   &cluster_raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.n_split, p.K * p.GH, B);
  if (p.n_split == 1) {
    decode_kernel<T, RL, MAXG><<<grid, THREADS, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.n_split;   // a (slot, KV head, group)'s
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RL>
int by_g(const Params& p, int B, cudaStream_t stream) {
  if (p.GS <= 1) return launch<T, RL, 1>(p, B, stream);
  if (p.GS <= 2) return launch<T, RL, 2>(p, B, stream);
  if (p.GS <= 4) return launch<T, RL, 4>(p, B, stream);
  return launch<T, RL, GROUP_G>(p, B, stream);
}

template <typename T>
int by_width(Params p, int B, cudaStream_t stream) {
  constexpr int VE = Elem<T>::VE;
  p.nvk = (p.Dk + VE - 1) / VE;
  p.nvv = (p.Dv + VE - 1) / VE;
  const int nv = p.nvk > p.nvv ? p.nvk : p.nvv;
  if (p.vec && (p.Dk % VE || p.Dv % VE))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nv <= 8) return by_g<T, 8>(p, B, stream);
  if (nv <= 16) return by_g<T, 16>(p, B, stream);
  return by_g<T, 32>(p, B, stream);
}

int dispatch(int dtype, Params p, int B, void* stream) {
  // query heads in groups of at most GROUP_G, as even as they come
  p.GH = (p.G + GROUP_G - 1) / GROUP_G;
  p.GS = p.GH > 0 ? (p.G + p.GH - 1) / p.GH : 0;
  const bool shape_ok =
      B >= 1 && B <= 65535 && p.S >= 1 && p.K >= 1 &&
      static_cast<long long>(p.K) * p.GH <= 65535 &&
      p.G >= 1 && p.G <= MAX_G && p.Dk >= 1 && p.Dk <= MAX_D && p.Dv >= 1 &&
      p.Dv <= MAX_D && p.split_rows >= 1 && p.n_split >= 1 &&
      p.n_split <= MAX_SPLIT &&
      static_cast<long long>(p.split_rows) * (p.n_split - 1) < p.S;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_width<float>(p, B, s);
  if (dtype == 1) return by_width<__nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out share it). Strides are in
// elements; the last axis of k and v is contiguous. The key rows split into
// n_split <= 16 ranges of split_rows rows (the last may be shorter), one
// cluster of n_split blocks a (slot, KV head, head group of at most
// GROUP_G query heads; G <= MAX_G). Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int flash_decode_launch(
    int dtype, const void* q, const void* k, const void* v, const int* q_pos,
    const int* k_pos, void* out, float* lse, int B, int S, int K, int G,
    int Dk, int Dv,
    int split_rows, int n_split, long long k_s0, long long k_s1,
    long long k_s2, long long v_s0, long long v_s1, long long v_s2,
    float scale, int window, int bounded, int vec, void* stream) {
  Params p = {q, k, v, q_pos, k_pos, out, lse, S, K, G, Dk, Dv, 1, 0, 0, 0,
              split_rows, n_split, k_s0, k_s1, k_s2, v_s0, v_s1, v_s2,
              scale, window, bounded, vec, 0, 0, 0, 0};
  return dispatch(dtype, p, B, stream);
}

// The same over a page pool: the key rows are the logical rows
// n_pages * page_size of each slot's table row, split into runs of
// split_pages whole pages.
extern "C" int flash_decode_paged_launch(
    int dtype, const void* q, const void* pool_k, const void* pool_v,
    const int* q_pos, const int* table, void* out, int B, int K, int G,
    int Dk, int Dv, int page_size, int n_pages, int split_pages, int n_split,
    long long k_s0, long long k_s1, long long k_s2, long long v_s0,
    long long v_s1, long long v_s2, float scale, int window, int vec,
    void* stream) {
  if (page_size < 1 || n_pages < 1 || split_pages < 1 ||
      static_cast<long long>(page_size) * n_pages > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  int shift = -1;
  if ((page_size & (page_size - 1)) == 0)
    for (shift = 0; (1 << shift) < page_size; ++shift) {
    }
  Params p = {q, pool_k, pool_v, q_pos, table, out, nullptr,
              page_size * n_pages, K,
              G, Dk, Dv, page_size, n_pages, 1, shift,
              page_size * split_pages, n_split, k_s0, k_s1, k_s2, v_s0, v_s1,
              v_s2, scale, window, 1, vec, 0, 0, 0, 0};
  return dispatch(dtype, p, B, stream);
}

extern "C" const char* flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Hand-written Hopper (sm_90a) kernels of slam_dynamic_tpu_torch.
//
// Built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded through ctypes.
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() so that a refused
// launch reaches the Python wrapper as an exception.
//
// Descriptors are [rows, 8] 32-bit words (the int32 bit view of the JAX
// package's uint32 lanes): 256 bits per ORB descriptor.
//
// K1 and K2 take the Hamming distances from the binary tensor-core
// product (BMMA on sm_90a):
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
// gives popc(a & b) for a 16 x 8 tile of descriptor pairs in one
// instruction (K = 256 is exactly one descriptor), and
//   hamming(a, b) = popc(a) + popc(b) - 2 popc(a & b)
// with the per-row popcounts taken once per row, not per pair. Fragments:
// lane = 4 g + t holds A rows g and g + 8 and B column g, words 2t and
// 2t + 1 (any assignment of words to K positions serves, as long as A and
// B share it); accumulator c0, c1 are row g, columns 2t, 2t + 1, and c2,
// c3 the same columns of row g + 8.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kInvalid = 1 << 15;  // distance of a gated-out pair

// popc(a & b) of 16 A rows (a: a0..a3 as above) and 8 B columns (b).
__device__ __forceinline__ void mma_and_popc(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y),
        "r"(0));
}

// 16-byte global -> shared copy; src_bytes = 0 fills the 16 bytes with 0.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// K1: gated nearest-landmark match (replaces the Pallas kernel
// slam_dynamic_tpu/ops/pallas_match.py:83 _match_kernel).
//
// A batched launch (slam_gated_match_batched) serves B lanes of the same
// N and M, lane b in blockIdx.z with its arrays at b times their per-lane
// size: the counterpart of jax.vmap over the pallas_call, which adds a
// batch axis to its grid.
//
// Per keypoint n: over all landmarks m, the Hamming distance of
// kp_desc[n] and lm_desc[m], with a pair allowed iff
//   kp_ok[n] & lm_ok[m]
//   & du*du + dv*dv <= r[m]*r[m]      (du = kp_x - lm_u, direct form)
//   & lvl_min <= kp_lvl[n] - lm_lvl[m] <= lvl_max;
// a disallowed pair has distance kInvalid. Outputs the best distance, the
// runner-up and the index of the first landmark at the best distance.
//
// Bound on H100: per pair with both ok flags set, 6 fp32 operations (the
// radius test) and 6 on the half-rate integer pipe (the level window, the
// candidate key and its top-2 update; kernel_bench.py counts them); the
// inputs are a few hundred KB, so the kernel is bound by operations.
// Design:
// - every allowed pair is one key (dist' << 16) | m, unique per landmark,
//   where dist' = kKeyBias + popc(b) - 2 popc(a & b) is the distance less
//   the row's own popc(a) (a constant of the row, added back at the end),
//   so the key costs one multiply-add. A top-2 over keys is associative
//   and commutative and is exactly the sequential semantics: the lowest
//   key gives the best distance and the lowest index among ties, the
//   second key the runner-up, and a row with no allowed pair keeps
//   kKeyNone (distance kInvalid, index 0). A disallowed pair leaves the
//   top-2 as it is, and the landmark range can be split and merged in any
//   order;
// - a cluster of K1_S blocks shares K1_ROWS keypoints, each block takes
//   every K1_S-th 8-landmark tile and each of its warps every other
//   staged tile, so N = M = 2048 runs 512 blocks (2048 warps) on 132 SMs
//   in one wave, and the gated-out landmarks, which the path puts at the
//   tail of a landmark set, are spread evenly over the warps: the time is
//   that of the slowest warp;
// - the distances of 16 keypoints x 8 landmarks come from one BMMA; the
//   gates and the top-2 update run on the accumulator fragment in
//   registers, then the 4 lanes of a quad, the two warps of a row tile
//   and the K1_S blocks of the cluster (through distributed shared
//   memory) merge their top-2 keys;
// - work on gated-out inputs is skipped: a cluster whose keypoints are all
//   gated out (the padding at the tail of a frame's keypoints) writes its
//   rows' empty result and leaves after the first chunk's loads, and an
//   8-landmark tile with no ok landmark is skipped by the whole warp;
// - a block's tiles are staged in chunks of K1_CH landmarks, each thread
//   issuing all its loads before its first shared store; the keypoint
//   loads go out first and are used after the first chunk's loads;
// - a gated-out keypoint gets x = NaN and a gated-out landmark r^2 = -inf,
//   so the radius test alone rejects them; r^2 is __fmul_rn(r, r), the
//   bits of the plain version's r ** 2, and the radius test uses
//   explicitly rounded operations so that nvcc does not contract it into
//   an FMA and round differently from the plain version. The level window
//   is one unsigned compare of kp_lvl - lvl_min - lm_lvl against
//   lvl_max - lvl_min, exact under int32 wrap-around as the plain
//   version's subtraction is.
// ---------------------------------------------------------------------------
constexpr int K1_S = 8;          // blocks of a cluster: the landmark splits
constexpr int K1_ROWS = 32;      // keypoints of a block: two 16-row tiles
constexpr int K1_HALVES = 2;     // warps that share a row tile
constexpr int K1_THREADS = 32 * (K1_ROWS / 16) * K1_HALVES;
constexpr int K1_CH = 256;       // landmarks staged per chunk
constexpr int K1_CT = K1_CH / 8;  // 8-landmark tiles per chunk
constexpr int K1_PARTS = K1_S * K1_HALVES;   // partial top-2s of a row
constexpr int K1_MERGE_ROWS = K1_ROWS / K1_S;  // rows each block merges
constexpr uint32_t kKeyNone = 0xFFFFFFFFu;  // above every candidate key
constexpr uint32_t kKeyBias = 256;  // keeps popc(b) - 2 popc(a & b) >= 0
constexpr uint32_t kNegInf = 0xff800000u;  // bits of -inf

static_assert(K1_ROWS % K1_S == 0, "each block merges whole rows");
static_assert(K1_PARTS <= 32 && K1_ROWS * K1_HALVES <= K1_THREADS &&
                  K1_ROWS * K1_HALVES % 32 == 0,
              "the merge reduces within whole warps of the block");
static_assert(K1_CH % K1_THREADS == 0 && K1_THREADS % 8 == 0,
              "chunks split into whole thread loads of whole tiles");

__device__ __forceinline__ void top2_merge(uint32_t& b1, uint32_t& b2,
                                           uint32_t o1, uint32_t o2) {
  b2 = min(min(b2, o2), max(b1, o1));
  b1 = min(b1, o1);
}

// Stage the block's tiles [t0, t0 + cnt) into shared memory (its tile k
// is the landmark set's tile k * K1_S + rank; past the last landmark it
// is padded with gated-out ones), and mark each tile that holds an ok
// landmark. Every thread issues all its loads before its first store.
__device__ __forceinline__ void k1_stage(
    uint32_t (*s_desc)[8], float4* s_geo, uint32_t* s_key, uint8_t* s_live,
    const uint32_t* __restrict__ lm_desc, const float* __restrict__ lm_uv,
    const float* __restrict__ lm_radius, const int32_t* __restrict__ lm_lvl,
    const uint8_t* __restrict__ lm_ok, int m, int rank, int t0, int cnt) {
  constexpr int kPer = K1_CH / K1_THREADS;
  uint4 d0[kPer], d1[kPer];
  float2 uv[kPer];
  float r[kPer];
  int lv[kPer];
  bool ok[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = threadIdx.x + q * K1_THREADS;
    const int lm = (((t0 + (j >> 3)) * K1_S + rank) << 3) + (j & 7);
    d0[q] = d1[q] = make_uint4(0u, 0u, 0u, 0u);
    uv[q] = make_float2(0.f, 0.f);
    r[q] = 0.f;
    lv[q] = 0;
    ok[q] = false;
    if ((j >> 3) < cnt && lm < m) {
      d0[q] = ((const uint4*)lm_desc)[2 * lm];
      d1[q] = ((const uint4*)lm_desc)[2 * lm + 1];
      uv[q] = ((const float2*)lm_uv)[lm];
      r[q] = lm_radius[lm];
      lv[q] = lm_lvl[lm];
      ok[q] = lm_ok[lm] != 0;
    }
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = threadIdx.x + q * K1_THREADS;
    const int lm = (((t0 + (j >> 3)) * K1_S + rank) << 3) + (j & 7);
    // a warp's 32 lanes stage 4 whole tiles
    const unsigned live = __ballot_sync(0xffffffffu, ok[q]);
    if ((j >> 3) < cnt) {
      const uint32_t p = __popc(d0[q].x) + __popc(d0[q].y) + __popc(d0[q].z) +
                         __popc(d0[q].w) + __popc(d1[q].x) + __popc(d1[q].y) +
                         __popc(d1[q].z) + __popc(d1[q].w);
      ((uint4*)s_desc[j])[0] = d0[q];
      ((uint4*)s_desc[j])[1] = d1[q];
      s_geo[j] = make_float4(uv[q].x, uv[q].y,
                             ok[q] ? __fmul_rn(r[q], r[q])
                                   : __int_as_float(kNegInf),
                             __int_as_float(lv[q]));
      // a padding landmark is never allowed: its key is never read
      s_key[j] = ((kKeyBias + p) << 16) + (uint32_t)lm;
      if ((lane & 7) == 0) s_live[j >> 3] = ((live >> lane) & 0xFFu) != 0;
    }
  }
}

__global__ void __cluster_dims__(K1_S, 1, 1) __launch_bounds__(K1_THREADS)
gated_match_kernel(const uint32_t* __restrict__ kp_desc,
                   const float* __restrict__ kp_xy,
                   const int32_t* __restrict__ kp_lvl,
                   const uint8_t* __restrict__ kp_ok,
                   const uint32_t* __restrict__ lm_desc,
                   const float* __restrict__ lm_uv,
                   const float* __restrict__ lm_radius,
                   const int32_t* __restrict__ lm_lvl,
                   const uint8_t* __restrict__ lm_ok,
                   int32_t* __restrict__ out_idx,
                   int32_t* __restrict__ out_best,
                   int32_t* __restrict__ out_second,
                   int n, int m, int lvl_min, int lvl_max) {
  // batch lane blockIdx.z of a batched launch (each lane has this n and m)
  const size_t zn = (size_t)blockIdx.z * n, zm = (size_t)blockIdx.z * m;
  kp_desc += zn * 8;
  kp_xy += zn * 2;
  kp_lvl += zn;
  kp_ok += zn;
  lm_desc += zm * 8;
  lm_uv += zm * 2;
  lm_radius += zm;
  lm_lvl += zm;
  lm_ok += zm;
  out_idx += zn;
  out_best += zn;
  out_second += zn;
  __shared__ __align__(16) uint32_t s_desc[K1_CH][8];
  __shared__ float4 s_geo[K1_CH];   // u, v, r^2 (-inf: gated out), level
  __shared__ uint32_t s_key[K1_CH];  // ((kKeyBias + popc) << 16) + m
  __shared__ uint8_t s_live[K1_CH / 8];  // the tile holds an ok landmark
  __shared__ uint2 s_top[K1_HALVES][K1_ROWS];
  __shared__ int s_pa[K1_ROWS];     // popc(kp_desc) of the block's rows

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile_row = (warp % (K1_ROWS / 16)) * 16;
  const int half = warp / (K1_ROWS / 16);
  // tiles rank, rank + K1_S, ... of the landmark set
  const int n_tiles = (m + 7) >> 3;
  const int my_tiles = rank < n_tiles ? (n_tiles - rank + K1_S - 1) / K1_S
                                      : 0;

  // rows g and g + 8 of this warp's 16-keypoint tile: loaded first, used
  // after the first chunk's landmark loads have gone out
  uint2 w[2];
  float2 xy[2];
  int lvl[2];
  bool ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = blockIdx.y * K1_ROWS + tile_row + g + 8 * i;
    w[i] = make_uint2(0u, 0u);
    xy[i] = make_float2(0.f, 0.f);
    lvl[i] = 0;
    ok[i] = false;
    if (r < n) {
      w[i] = *(const uint2*)(kp_desc + (size_t)r * 8 + 2 * t);
      xy[i] = *(const float2*)(kp_xy + 2 * (size_t)r);
      lvl[i] = kp_lvl[r];
      ok[i] = kp_ok[r] != 0;
    }
  }
  k1_stage(s_desc, s_geo, s_key, s_live, lm_desc, lm_uv, lm_radius, lm_lvl,
           lm_ok, m, rank, 0, min(K1_CT, my_tiles));
  uint32_t a[4];
  float x[2];
  uint32_t kl[2];   // kp_lvl - lvl_min
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a[i] = w[i].x;
    a[2 + i] = w[i].y;
    int p = __popc(w[i].x) + __popc(w[i].y);
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    if (t == 0 && half == 0) s_pa[tile_row + g + 8 * i] = p;
    x[i] = ok[i] ? xy[i].x : __int_as_float(0x7fc00000);  // NaN: no radius
    kl[i] = (uint32_t)lvl[i] - (uint32_t)lvl_min;
  }
  const uint32_t range = (uint32_t)lvl_max - (uint32_t)lvl_min;

  // also the first chunk's barrier. Every block of the cluster has the
  // same keypoints and comes to the same decision, so with none ok (or an
  // empty level window) the whole cluster leaves without a cluster.sync.
  if (!__syncthreads_or(ok[0] || ok[1]) || lvl_max < lvl_min) {
    const int r = blockIdx.y * K1_ROWS + rank * K1_MERGE_ROWS + tid;
    if (tid < K1_MERGE_ROWS && r < n) {
      out_idx[r] = 0;
      out_best[r] = kInvalid;
      out_second[r] = kInvalid;
    }
    return;
  }

  uint32_t b1[2] = {kKeyNone, kKeyNone}, b2[2] = {kKeyNone, kKeyNone};
  for (int t0 = 0; t0 < my_tiles; t0 += K1_CT) {
    const int cnt = min(K1_CT, my_tiles - t0);
    if (t0 != 0) {
      __syncthreads();  // the previous chunk is no longer read
      k1_stage(s_desc, s_geo, s_key, s_live, lm_desc, lm_uv, lm_radius,
               lm_lvl, lm_ok, m, rank, t0, cnt);
      __syncthreads();
    }
    for (int tile = half; tile < cnt; tile += K1_HALVES) {
      if (!s_live[tile]) continue;  // no ok landmark: nothing is allowed
      const int j0 = tile * 8;
      int acc[4];
      mma_and_popc(acc, a, *(const uint2*)&s_desc[j0 + g][2 * t]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 2 * t + e;
        const float4 geo = s_geo[j];
        const uint32_t key = s_key[j];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float du = __fsub_rn(x[i], geo.x);
          const float dv = __fsub_rn(xy[i].y, geo.y);
          const float dd = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
          const uint32_t dl = kl[i] - (uint32_t)__float_as_int(geo.w);
          // ((kKeyBias + popc(b) - 2 popc(a & b)) << 16) + m
          const uint32_t k = key - ((uint32_t)acc[2 * i + e] << 17);
          if (dd <= geo.z && dl <= range) {
            b2[i] = min(b2[i], max(b1[i], k));
            b1[i] = min(b1[i], k);
          }
        }
      }
    }
  }

  // the four lanes of a quad hold disjoint landmarks of the same two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const uint32_t o1 = __shfl_xor_sync(0xffffffffu, b1[i], off);
      const uint32_t o2 = __shfl_xor_sync(0xffffffffu, b2[i], off);
      top2_merge(b1[i], b2[i], o1, o2);
    }
  }
  if (t == 0) {
    s_top[half][tile_row + g] = make_uint2(b1[0], b2[0]);
    s_top[half][tile_row + g + 8] = make_uint2(b1[1], b2[1]);
  }
  cluster.sync();

  // block `rank` merges K1_MERGE_ROWS rows over the cluster's K1_PARTS
  // partial results, one result per lane, and adds the row's popc back
  if (tid < K1_MERGE_ROWS * K1_PARTS) {
    const int row = rank * K1_MERGE_ROWS + tid / K1_PARTS;
    const int part = tid % K1_PARTS;
    const uint2* src = cluster.map_shared_rank(&s_top[0][0], part / K1_HALVES);
    uint2 v = src[(part % K1_HALVES) * K1_ROWS + row];
#pragma unroll
    for (int off = K1_PARTS / 2; off > 0; off >>= 1) {
      const uint32_t o1 = __shfl_xor_sync(0xffffffffu, v.x, off);
      const uint32_t o2 = __shfl_xor_sync(0xffffffffu, v.y, off);
      top2_merge(v.x, v.y, o1, o2);
    }
    const int r = blockIdx.y * K1_ROWS + row;
    if (part == 0 && r < n) {
      const int base = s_pa[row] - (int)kKeyBias;
      out_idx[r] = v.x == kKeyNone ? 0 : (int32_t)(v.x & 0xFFFFu);
      out_best[r] = v.x == kKeyNone ? kInvalid : (int)(v.x >> 16) + base;
      out_second[r] = v.y == kKeyNone ? kInvalid : (int)(v.y >> 16) + base;
    }
  }
  cluster.sync();  // no block exits while another reads its shared memory
}

// ---------------------------------------------------------------------------
// K2: full [N, M] int32 Hamming matrix (replaces the Pallas kernel
// slam_dynamic_tpu/ops/pallas_hamming.py:42 _hamming_kernel).
//
// Bound on H100: the 4-byte output per pair. At the mapping stage's
// 2048 x 2048 the 16.8 MB write takes 5.0 us at 3.35 TB/s, while the
// distances on the tensor cores take about 1 us. Design: the distances
// come from BMMA, so the write is the limit. A block of 8 warps owns a
// 64 x 128 output tile: its 64 A and 128 B descriptors (6 KB) arrive by
// cp.async (zero-filled past the edge), each warp computes 32 x 32 outputs
// with 8 BMMAs, and the epilogue writes the fragments to a padded shared
// tile (conflict-free) from which each warp stores whole output rows, 16
// bytes per lane. Ragged edges are masked; rows whose length is not a
// multiple of 4 words are stored a word at a time. N = M = 2048 runs 512
// blocks, one wave at 4 blocks per SM. A batched launch
// (slam_hamming_batched) puts lane b of B in blockIdx.z, as K1's does.
// ---------------------------------------------------------------------------
constexpr int K2_BM = 64;
constexpr int K2_BN = 128;
constexpr int K2_THREADS = 256;
constexpr int K2_LD = K2_BN + 8;  // padded row of the output tile (words)
constexpr int K2_WARPS_N = K2_BN / 32;  // each warp owns 32 x 32 outputs
constexpr int K2_SEGS = K2_BN / 128;    // 128-column segments of a tile row

static_assert((K2_BM / 32) * K2_WARPS_N * 32 == K2_THREADS &&
                  K2_BN % 128 == 0,
              "8 warps of 32 x 32 outputs; rows stored 128 columns a time");

__global__ void __launch_bounds__(K2_THREADS)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int n, int m) {
  // batch lane blockIdx.z of a batched launch (each lane has this n and m)
  a += (size_t)blockIdx.z * n * 8;
  b += (size_t)blockIdx.z * m * 8;
  out += (size_t)blockIdx.z * n * m;
  __shared__ __align__(16) uint32_t sa[K2_BM][8];
  __shared__ __align__(16) uint32_t sb[K2_BN][8];
  __shared__ int spa[K2_BM];
  __shared__ int spb[K2_BN];
  __shared__ __align__(16) int32_t sout[K2_BM][K2_LD];

  const int row0 = blockIdx.y * K2_BM, col0 = blockIdx.x * K2_BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  for (int i = tid; i < (K2_BM + K2_BN) * 2; i += K2_THREADS) {
    const bool is_a = i < K2_BM * 2;
    const int r = (is_a ? i : i - K2_BM * 2) >> 1, piece = i & 1;
    const int src_row = (is_a ? row0 : col0) + r;
    const bool in = src_row < (is_a ? n : m);
    const uint32_t* src =
        (is_a ? a : b) + (size_t)(in ? src_row : 0) * 8 + piece * 4;
    cp_async16((is_a ? sa[r] : sb[r]) + piece * 4, src, in ? 16 : 0);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int r = tid; r < K2_BM + K2_BN; r += K2_THREADS) {
    const uint32_t* d = r < K2_BM ? sa[r] : sb[r - K2_BM];
    int p = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) p += __popc(d[w]);
    if (r < K2_BM) spa[r] = p; else spb[r - K2_BM] = p;
  }

  // warp (wr, wc): rows wr .. wr + 31, columns wc .. wc + 31
  const int wr = (warp / K2_WARPS_N) * 32, wc = (warp % K2_WARPS_N) * 32;
  int acc[2][4][4];
  uint32_t af[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint2 lo = *(const uint2*)&sa[wr + 16 * i + g][2 * t];
    const uint2 hi = *(const uint2*)&sa[wr + 16 * i + g + 8][2 * t];
    af[i][0] = lo.x;
    af[i][1] = hi.x;
    af[i][2] = lo.y;
    af[i][3] = hi.y;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint2 bf = *(const uint2*)&sb[wc + 8 * j + g][2 * t];
#pragma unroll
    for (int i = 0; i < 2; ++i) mma_and_popc(acc[i][j], af[i], bf);
  }
  __syncthreads();  // the popcounts are in shared memory
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wr + 16 * i + g, c = wc + 8 * j + 2 * t;
      const int p0 = spb[c], p1 = spb[c + 1];
      *(int2*)&sout[r][c] = make_int2(spa[r] + p0 - 2 * acc[i][j][0],
                                      spa[r] + p1 - 2 * acc[i][j][1]);
      *(int2*)&sout[r + 8][c] = make_int2(spa[r + 8] + p0 - 2 * acc[i][j][2],
                                          spa[r + 8] + p1 - 2 * acc[i][j][3]);
    }
  }
  __syncthreads();

  const bool vec = (m & 3) == 0;  // rows start on 16-byte boundaries
  for (int i = warp; i < K2_BM * K2_SEGS; i += K2_THREADS / 32) {
    const int r = i / K2_SEGS, cs = (i % K2_SEGS) * 128 + 4 * lane;
    const int row = row0 + r, c = col0 + cs;
    if (row >= n) break;
    const int4 v = *(const int4*)&sout[r][cs];
    int32_t* dst = out + (size_t)row * m + c;
    if (vec && c < m) {
      *(int4*)dst = v;
    } else {
      if (c < m) dst[0] = v.x;
      if (c + 1 < m) dst[1] = v.y;
      if (c + 2 < m) dst[2] = v.z;
      if (c + 3 < m) dst[3] = v.w;
    }
  }
}

// ---------------------------------------------------------------------------
// K3: the tracker's motion-only pose Levenberg-Marquardt, one whole
// optimize_pose call (optim/pose_opt.py, with the terms of
// optim/residuals.py and the group operations of utils/se3.py) per block.
//
// K3 replaces no Pallas kernel: the JAX package left this loop to XLA,
// which fuses each iteration into a few ops. Op by op on this card the
// loop is about 80 small launches per evaluation of the terms, 260-280
// per LM iteration and about 17k per tracked frame, and the host's
// dispatch of them, not the card, bounded the tracker.
//
// Bound on H100: about 160 fp32 operations per observation and pass at D
// = 3 (the projection, the Jacobian rows, the 27 sums of the normal
// equations), so 2048 observations x 45 passes are about 15 M
// operations, under half a microsecond at the card's fp32 rate, and the
// inputs are 70 KB. Neither bounds it: a call is a serial chain of
// rounds x (iters + 1) + 1 passes (15 at the motion model's 2 x 6, 45 at
// the local map's 4 x 10: 75 for a tracked frame's 64 LM iterations),
// each ending in a block-wide reduction, two barriers and a 6x6 solve on
// one thread, and the latency of that chain and the launch set its time:
// about 6 us a pass on the H100 (0.094 ms at 2 x 6, 0.276 ms at 4 x 10,
// N = 2048, D = 3, kernel_bench.py --k3), the same for 16 lanes.
// Design:
// - one block of K3_THREADS threads per problem (a batched launch puts
//   lane b in blockIdx.x, its arrays at b times their per-lane size), a
//   block-stride loop over the N observations; a thread owns the same
//   observations in every pass, so the inlier flags it writes are read
//   back by itself alone;
// - the observations are staged once into shared memory when they fit
//   (33 bytes each at D = 3: 2048 take 67.6 KB, 5000 take 165 KB); above
//   K3_MAX_STAGED the passes read them where they are (L1 and L2), the
//   same code through generic pointers, with the flags in the inliers
//   output;
// - one pass over the observations per LM iteration: the pass at the
//   candidate pose accumulates the candidate's robust cost and its normal
//   equations (H's 21 upper entries and b's 6) under the round's weights.
//   On acceptance they are the next iteration's system (the plain loop
//   evaluates the terms at the accepted pose again and gets the same
//   values); on rejection the stored ones stay. Only a round's first
//   pass, after the chi2 relabelling changed the weights, is extra, and
//   the last pass relabels and writes chi2 at the orthonormalised pose;
// - an observation that is not an inlier, or carries zero information,
//   adds exact zeros to every sum of the plain loop (a zero weight and a
//   zero cost mask) and is skipped;
// - the 28 sums are reduced in a fixed order with no atomics (each
//   thread's observations in order, a shuffle tree in each warp, the
//   warps' partials in order), so the same inputs give the same bits on
//   every run and in every lane of a batched launch;
// - thread 0 keeps the accepted pose, its system and lambda in
//   registers, decides acceptance (a cost not below the stored one, NaN
//   included, rejects; lambda halves on acceptance and quadruples on
//   rejection), solves (H + lambda diag(H) + 1e-9 I) dx = b by LU with
//   partial pivoting (torch.linalg.solve_ex's method), retracts by the
//   SE(3) exponential and publishes the candidate in shared memory.
//   Everything is float32.
// ---------------------------------------------------------------------------
constexpr int K3_THREADS = 256;
constexpr int K3_WARPS = K3_THREADS / 32;
constexpr int K3_SUMS = 28;  // H's 21 upper entries, b's 6, the cost
constexpr int K3_COST = 27;
constexpr size_t K3_MAX_STAGED = 200 * 1024;  // dynamic shared memory
constexpr int K3_HUBER_ROUNDS = 2;  // rounds weighted by the Huber kernel
constexpr int K3_MAX_DEVICES = 64;
constexpr uint8_t kObsValid = 1, kObsInlier = 2;

struct K3Cam {
  float fx, fy, cx, cy, bf;
};

struct K3Obs {
  float X, Y, Z, u, v, ur, isig, urw;
};

// residuals, d r / d twist, chi2 and camera-frame depth of one observation
template <int D>
struct K3Terms {
  float r[D];
  float J[D][6];
  float chi2, z;
};

// Bytes of shared memory that stage n observations of dimension D.
template <int D>
__host__ __device__ constexpr size_t k3_staged_bytes(int n) {
  return (size_t)n * (4 * (3 + D + 1 + (D == 3 ? 1 : 0)) + 1);
}

template <int D>
__device__ __forceinline__ K3Obs k3_load(const float* xw, const float* obs,
                                         const float* isig, const float* urw,
                                         int i) {
  K3Obs o;
  o.X = xw[3 * i];
  o.Y = xw[3 * i + 1];
  o.Z = xw[3 * i + 2];
  o.u = obs[D * i];
  o.v = obs[D * i + 1];
  o.ur = D == 3 ? obs[D * i + 2] : 0.f;
  o.isig = isig[i];
  o.urw = D == 3 ? urw[i] : 1.f;
  return o;
}

// A row (p, q, s) of d project / d x_cam times [I | -hat(x_cam)].
__device__ __forceinline__ void k3_row(float* J, float p, float q, float s,
                                       float x, float y, float z) {
  J[0] = p;
  J[1] = q;
  J[2] = s;
  J[3] = q * -z + s * y;
  J[4] = p * z + s * -x;
  J[5] = p * -y + q * x;
}

// optim/residuals.py reprojection_terms at pose P (R row-major, then t).
template <int D>
__device__ __forceinline__ void k3_terms(const K3Cam& c, const float* P,
                                         const K3Obs& o, K3Terms<D>& T) {
  const float x = P[0] * o.X + P[1] * o.Y + P[2] * o.Z + P[9];
  const float y = P[3] * o.X + P[4] * o.Y + P[5] * o.Z + P[10];
  const float z = P[6] * o.X + P[7] * o.Y + P[8] * o.Z + P[11];
  const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
  const float u = c.fx * x / zs + c.cx;
  const float v = c.fy * y / zs + c.cy;
  const float zi = 1.f / zs, zi2 = zi * zi;
  T.r[0] = u - o.u;
  T.r[1] = v - o.v;
  k3_row(T.J[0], c.fx * zi, 0.f, -c.fx * x * zi2, x, y, z);
  k3_row(T.J[1], 0.f, c.fy * zi, -c.fy * y * zi2, x, y, z);
  float e = T.r[0] * T.r[0] + T.r[1] * T.r[1];
  if constexpr (D == 3) {
    T.r[2] = (u - c.bf / zs - o.ur) * o.urw;
    k3_row(T.J[2], c.fx * zi * o.urw, 0.f * o.urw,
           (-c.fx * x * zi2 + c.bf * zi2) * o.urw, x, y, z);
    e += T.r[2] * T.r[2];
  }
  T.chi2 = e * o.isig;
  T.z = z;
}

// sqrt(max(chi2, 1e-12)) with NaN kept, as torch.clamp keeps it
__device__ __forceinline__ float k3_root(float chi2) {
  return sqrtf(chi2 < 1e-12f ? 1e-12f : chi2);
}

template <int D>
__device__ __forceinline__ void k3_accumulate(float (&acc)[K3_SUMS],
                                              const K3Terms<D>& T, float w,
                                              float cost) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float jw[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) jw[i] = T.J[k][i] * w;
    int e = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) acc[e++] += jw[i] * T.J[k][j];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] += jw[i] * T.r[k];
  }
  acc[K3_COST] += cost;
}

// The block's sums of acc, in a fixed order, into s_sum (read by warp 0
// after the call: the other warps may already be past it).
__device__ __forceinline__ void k3_reduce(float (&acc)[K3_SUMS],
                                          float (*s_part)[K3_SUMS],
                                          float* s_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K3_SUMS; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K3_SUMS; ++k) s_part[warp][k] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
    if (lane < K3_SUMS) {
      float v = s_part[0][lane];
#pragma unroll
      for (int w = 1; w < K3_WARPS; ++w) v += s_part[w][lane];
      s_sum[lane] = v;
    }
    __syncwarp();
  }
}

// (H + lam diag(H) + 1e-9 I) dx = b from the sums (b = -the sums' J^T W
// r): LU with partial pivoting (the first row of largest magnitude), then
// the two triangular solves, as LAPACK's sgesv.
__device__ __forceinline__ void k3_solve(const float (&sys)[K3_SUMS],
                                         float lam, float (&dx)[6]) {
  float A[6][6], b[6];
  int e = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = sys[e];
      A[j][i] = sys[e];
      ++e;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] = (A[i][i] + lam * A[i][i]) + 1e-9f;
    b[i] = -sys[21 + i];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float s = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = s;
        }
        const float s = b[k];
        b[k] = b[i];
        b[i] = s;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      b[i] -= l * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * dx[j];
    dx[i] = s / A[i][i];
  }
}

__device__ __forceinline__ void k3_mat3(const float* A, const float* B,
                                        float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
  }
}

// utils/se3.py se3_retract: exp(dx) o P into Q.
__device__ __forceinline__ void k3_retract(const float* P,
                                           const float (&dx)[6], float* Q) {
  const float w0 = dx[3], w1 = dx[4], w2 = dx[5];
  const float th = sqrtf(w0 * w0 + w1 * w1 + w2 * w2 + 1e-24f);
  const bool small = th < 1e-4f;
  const float th2 = th * th;
  const float ths = small ? 1.f : th;
  const float sn = sinf(ths), cs = cosf(ths);
  const float sinc = small ? 1.f - th2 / 6.f : sn / ths;
  const float cosc = small ? 0.5f - th2 / 24.f : (1.f - cs) / (ths * ths);
  const float bc =
      small ? 1.f / 6.f - th2 / 120.f : (ths - sn) / (ths * ths * ths);
  const float K[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float K2[9], dR[9], J[9];
  k3_mat3(K, K, K2);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float eye = i % 4 == 0 ? 1.f : 0.f;
    dR[i] = eye + sinc * K[i] + cosc * K2[i];
    J[i] = eye + cosc * K[i] + bc * K2[i];
  }
  k3_mat3(dR, P, Q);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float dt = J[3 * i] * dx[0] + J[3 * i + 1] * dx[1] +
                     J[3 * i + 2] * dx[2];
    Q[9 + i] = dR[3 * i] * P[9] + dR[3 * i + 1] * P[10] +
               dR[3 * i + 2] * P[11] + dt;
  }
}

// utils/se3.py orthonormalize: the quaternion round trip (Shepperd's
// largest pivot, first on ties) of R into Q's rotation.
__device__ __forceinline__ void k3_orthonormalize(const float* R, float* Q) {
  const float m00 = R[0], m01 = R[1], m02 = R[2];
  const float m10 = R[3], m11 = R[4], m12 = R[5];
  const float m20 = R[6], m21 = R[7], m22 = R[8];
  const float tr = m00 + m11 + m22;
  const float piv[4] = {tr, m00 - m11 - m22, -m00 + m11 - m22,
                        -m00 - m11 + m22};
  int k = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (piv[i] > piv[k]) k = i;
  const float arg = k == 0   ? 1.f + tr
                    : k == 1 ? 1.f + m00 - m11 - m22
                    : k == 2 ? 1.f - m00 + m11 - m22
                             : 1.f - m00 - m11 + m22;
  const float r = sqrtf(arg < 1e-8f ? 1e-8f : arg) * 0.5f;
  const float f = 4.f * r;
  float q[4];
  if (k == 0) {
    q[0] = r; q[1] = (m21 - m12) / f; q[2] = (m02 - m20) / f;
    q[3] = (m10 - m01) / f;
  } else if (k == 1) {
    q[0] = (m21 - m12) / f; q[1] = r; q[2] = (m01 + m10) / f;
    q[3] = (m02 + m20) / f;
  } else if (k == 2) {
    q[0] = (m02 - m20) / f; q[1] = (m01 + m10) / f; q[2] = r;
    q[3] = (m12 + m21) / f;
  } else {
    q[0] = (m10 - m01) / f; q[1] = (m02 + m20) / f; q[2] = (m12 + m21) / f;
    q[3] = r;
  }
  // normalised, w >= 0, then normalised again by rot_from_quat
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const float nrm =
        sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
    const float sgn = pass == 0 && q[0] / nrm < 0.f ? -1.f : 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = q[i] / nrm * sgn;
  }
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  Q[0] = 1.f - 2.f * (y * y + z * z);
  Q[1] = 2.f * (x * y - w * z);
  Q[2] = 2.f * (x * z + w * y);
  Q[3] = 2.f * (x * y + w * z);
  Q[4] = 1.f - 2.f * (x * x + z * z);
  Q[5] = 2.f * (y * z - w * x);
  Q[6] = 2.f * (x * z - w * y);
  Q[7] = 2.f * (y * z + w * x);
  Q[8] = 1.f - 2.f * (x * x + y * y);
}

template <int D>
__global__ void __launch_bounds__(K3_THREADS)
pose_lm_kernel(const float* __restrict__ cam, const float* __restrict__ R0,
               const float* __restrict__ t0, const float* xw,
               const float* obs, const float* isig,
               const uint8_t* __restrict__ valid, const float* urw,
               float* __restrict__ R_out, float* __restrict__ t_out,
               uint8_t* inl_out, int32_t* __restrict__ n_inl_out,
               float* __restrict__ chi2_out, int n, int rounds, int iters,
               float chi2_th, int staged) {
  const size_t lane_b = blockIdx.x;
  cam += 5 * lane_b;
  R0 += 9 * lane_b;
  t0 += 3 * lane_b;
  xw += lane_b * n * 3;
  obs += lane_b * n * D;
  isig += lane_b * n;
  valid += lane_b * n;
  urw += lane_b * n;
  R_out += 9 * lane_b;
  t_out += 3 * lane_b;
  inl_out += lane_b * n;
  n_inl_out += lane_b;
  chi2_out += lane_b * n;

  extern __shared__ __align__(16) unsigned char k3_smem[];
  __shared__ float s_part[K3_WARPS][K3_SUMS];
  __shared__ float s_sum[K3_SUMS];
  __shared__ float s_pose[12];   // the pose the next pass evaluates
  __shared__ float s_orth[12];   // the result: R orthonormalised, t
  __shared__ int s_count[K3_WARPS];
  const int tid = threadIdx.x;

  uint8_t* flags = inl_out;
  if (staged) {
    float* f = (float*)k3_smem;
    float* s_xw = f;
    float* s_obs = s_xw + 3 * n;
    float* s_isig = s_obs + D * n;
    float* s_urw = s_isig + n;
    uint8_t* s_flags = (uint8_t*)(s_urw + (D == 3 ? n : 0));
    for (int i = tid; i < 3 * n; i += K3_THREADS) s_xw[i] = xw[i];
    for (int i = tid; i < D * n; i += K3_THREADS) s_obs[i] = obs[i];
    for (int i = tid; i < n; i += K3_THREADS) {
      s_isig[i] = isig[i];
      if (D == 3) s_urw[i] = urw[i];
    }
    xw = s_xw;
    obs = s_obs;
    isig = s_isig;
    urw = s_urw;
    flags = s_flags;
  }
  for (int i = tid; i < n; i += K3_THREADS)
    flags[i] = valid[i] ? (kObsValid | kObsInlier) : 0;

  const K3Cam c = {cam[0], cam[1], cam[2], cam[3], cam[4]};
  const float delta = sqrtf(chi2_th), d2 = delta * delta;
  // thread 0's state: the accepted pose, its system, lambda
  float P[12], sys[K3_SUMS], lam = 1e-3f;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) P[i] = R0[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) P[9 + i] = t0[i];
#pragma unroll
    for (int i = 0; i < 12; ++i) s_pose[i] = P[i];
  }
  __syncthreads();

  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < K3_HUBER_ROUNDS;
    // pass 0 at the accepted pose (relabelled first after round 0), pass
    // it > 0 at the candidate of iteration it - 1
    for (int it = 0; it <= iters; ++it) {
      const bool relabel = it == 0 && rnd > 0;
      float Q[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) Q[i] = s_pose[i];
      float acc[K3_SUMS];
#pragma unroll
      for (int k = 0; k < K3_SUMS; ++k) acc[k] = 0.f;
      for (int i = tid; i < n; i += K3_THREADS) {
        uint8_t fl = flags[i];
        if (!(fl & (relabel ? kObsValid : kObsInlier))) continue;
        const K3Obs o = k3_load<D>(xw, obs, isig, urw, i);
        K3Terms<D> T;
        k3_terms<D>(c, Q, o, T);
        if (relabel) {
          fl = T.chi2 <= chi2_th && T.z > 1e-3f ? (kObsValid | kObsInlier)
                                                 : kObsValid;
          flags[i] = fl;
          if (!(fl & kObsInlier)) continue;
        }
        if (o.isig == 0.f) continue;
        float w = o.isig * (T.z > 1e-3f ? 1.f : 0.f);
        const float e = k3_root(T.chi2);
        if (huber) w *= T.chi2 <= d2 ? 1.f : delta / e;
        const float rho = T.chi2 <= d2 ? T.chi2 : 2.f * delta * e - d2;
        k3_accumulate<D>(acc, T, w, (o.isig > 0.f ? 1.f : 0.f) * rho);
      }
      k3_reduce(acc, s_part, s_sum);
      if (tid == 0) {
        if (it == 0) {
#pragma unroll
          for (int k = 0; k < K3_SUMS; ++k) sys[k] = s_sum[k];
          lam = 1e-3f;
        } else if (s_sum[K3_COST] < sys[K3_COST]) {
#pragma unroll
          for (int k = 0; k < K3_SUMS; ++k) sys[k] = s_sum[k];
#pragma unroll
          for (int i = 0; i < 12; ++i) P[i] = Q[i];
          lam *= 0.5f;
        } else {
          lam *= 4.f;
        }
        if (it < iters) {
          float dx[6];
          k3_solve(sys, lam, dx);
          k3_retract(P, dx, s_pose);
        } else {
#pragma unroll
          for (int i = 0; i < 12; ++i) s_pose[i] = P[i];
        }
      }
      __syncthreads();
    }
  }

  // the last relabelling at the accepted pose, chi2 at the result
  if (tid == 0) {
    k3_orthonormalize(s_pose, s_orth);
#pragma unroll
    for (int i = 9; i < 12; ++i) s_orth[i] = s_pose[i];
  }
  __syncthreads();
  float Q[12], F[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    Q[i] = s_pose[i];
    F[i] = s_orth[i];
  }
  int count = 0;
  for (int i = tid; i < n; i += K3_THREADS) {
    const uint8_t fl = flags[i];
    const K3Obs o = k3_load<D>(xw, obs, isig, urw, i);
    K3Terms<D> T;
    bool inl = (fl & kObsInlier) != 0;
    if (rounds > 0) {
      inl = false;
      if (fl & kObsValid) {
        k3_terms<D>(c, Q, o, T);
        inl = T.chi2 <= chi2_th && T.z > 1e-3f;
      }
    }
    k3_terms<D>(c, F, o, T);
    chi2_out[i] = T.chi2;
    inl_out[i] = inl;
    count += inl;
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if ((tid & 31) == 0) s_count[tid >> 5] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < K3_WARPS; ++w) total += s_count[w];
    *n_inl_out = total;
#pragma unroll
    for (int i = 0; i < 9; ++i) R_out[i] = s_orth[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t_out[i] = s_orth[9 + i];
  }
}

// Lets pose_lm_kernel<D> take K3_MAX_STAGED bytes of dynamic shared
// memory on the current device: set once per device, since the attribute
// lasts; the first call returns the error if it fails.
template <int D>
cudaError_t k3_allow_staging() {
  static std::atomic<bool> done[K3_MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < K3_MAX_DEVICES && done[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  err = cudaFuncSetAttribute(pose_lm_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)K3_MAX_STAGED);
  if (err == cudaSuccess && dev < K3_MAX_DEVICES)
    done[dev].store(true, std::memory_order_relaxed);
  return err;
}

template <int D>
int k3_launch(const void* cam, const void* R0, const void* t0,
              const void* xw, const void* obs, const void* isig,
              const void* valid, const void* urw, void* R_out, void* t_out,
              void* inl_out, void* n_inl_out, void* chi2_out, int lanes,
              int n, int rounds, int iters, float chi2_th,
              cudaStream_t stream) {
  const size_t bytes = k3_staged_bytes<D>(n);
  const bool staged = bytes <= K3_MAX_STAGED;
  if (staged && bytes > 48 * 1024) {
    const cudaError_t err = k3_allow_staging<D>();
    if (err != cudaSuccess) return (int)err;
  }
  pose_lm_kernel<D><<<lanes, K3_THREADS, staged ? bytes : 0, stream>>>(
      (const float*)cam, (const float*)R0, (const float*)t0,
      (const float*)xw, (const float*)obs, (const float*)isig,
      (const uint8_t*)valid, (const float*)urw, (float*)R_out,
      (float*)t_out, (uint8_t*)inl_out, (int32_t*)n_inl_out,
      (float*)chi2_out, n, rounds, iters, chi2_th, staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B lanes of slam_gated_match in one launch: lane b's arrays start at b
// times their per-lane size.
int slam_gated_match_batched(const void* kp_desc, const void* kp_xy,
                             const void* kp_lvl, const void* kp_ok,
                             const void* lm_desc, const void* lm_uv,
                             const void* lm_radius, const void* lm_lvl,
                             const void* lm_ok, void* out_idx,
                             void* out_best, void* out_second, int lanes,
                             int n, int m, int lvl_min, int lvl_max,
                             void* stream) {
  if (lanes > 0 && n > 0) {
    const dim3 grid(K1_S, (n + K1_ROWS - 1) / K1_ROWS, lanes);
    gated_match_kernel<<<grid, K1_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)kp_desc, (const float*)kp_xy,
        (const int32_t*)kp_lvl, (const uint8_t*)kp_ok,
        (const uint32_t*)lm_desc, (const float*)lm_uv,
        (const float*)lm_radius, (const int32_t*)lm_lvl,
        (const uint8_t*)lm_ok, (int32_t*)out_idx, (int32_t*)out_best,
        (int32_t*)out_second, n, m, lvl_min, lvl_max);
  }
  return (int)cudaGetLastError();
}

// B lanes of slam_hamming_matrix in one launch: a [B, n, 8], b [B, m, 8],
// out [B, n, m].
int slam_hamming_batched(const void* a, const void* b, void* out, int lanes,
                         int n, int m, void* stream) {
  if (lanes > 0 && n > 0 && m > 0) {
    const dim3 grid((m + K2_BN - 1) / K2_BN, (n + K2_BM - 1) / K2_BM, lanes);
    hamming_kernel<<<grid, K2_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (int32_t*)out, n, m);
  }
  return (int)cudaGetLastError();
}

// One lane: the batched launch with B = 1.
int slam_gated_match(const void* kp_desc, const void* kp_xy,
                     const void* kp_lvl, const void* kp_ok,
                     const void* lm_desc, const void* lm_uv,
                     const void* lm_radius, const void* lm_lvl,
                     const void* lm_ok, void* out_idx, void* out_best,
                     void* out_second, int n, int m, int lvl_min,
                     int lvl_max, void* stream) {
  return slam_gated_match_batched(kp_desc, kp_xy, kp_lvl, kp_ok, lm_desc,
                                  lm_uv, lm_radius, lm_lvl, lm_ok, out_idx,
                                  out_best, out_second, 1, n, m, lvl_min,
                                  lvl_max, stream);
}

int slam_hamming_matrix(const void* a, const void* b, void* out, int n,
                        int m, void* stream) {
  return slam_hamming_batched(a, b, out, 1, n, m, stream);
}

// B lanes of slam_pose_lm in one launch, one block each: lane b's arrays
// start at b times their per-lane size. d = 2 (mono) or 3 (stereo).
int slam_pose_lm_batched(const void* cam, const void* R0, const void* t0,
                         const void* xw, const void* obs, const void* isig,
                         const void* valid, const void* urw, void* R_out,
                         void* t_out, void* inl_out, void* n_inl_out,
                         void* chi2_out, int lanes, int n, int d, int rounds,
                         int iters, float chi2_th, void* stream) {
  if (d != 2 && d != 3) return (int)cudaErrorInvalidValue;
  if (lanes <= 0) return (int)cudaGetLastError();
  return (d == 2 ? k3_launch<2> : k3_launch<3>)(
      cam, R0, t0, xw, obs, isig, valid, urw, R_out, t_out, inl_out,
      n_inl_out, chi2_out, lanes, n, rounds, iters, chi2_th,
      (cudaStream_t)stream);
}

// One pose problem: the batched launch with B = 1.
int slam_pose_lm(const void* cam, const void* R0, const void* t0,
                 const void* xw, const void* obs, const void* isig,
                 const void* valid, const void* urw, void* R_out,
                 void* t_out, void* inl_out, void* n_inl_out, void* chi2_out,
                 int n, int d, int rounds, int iters, float chi2_th,
                 void* stream) {
  return slam_pose_lm_batched(cam, R0, t0, xw, obs, isig, valid, urw, R_out,
                              t_out, inl_out, n_inl_out, chi2_out, 1, n, d,
                              rounds, iters, chi2_th, stream);
}

}  // extern "C"

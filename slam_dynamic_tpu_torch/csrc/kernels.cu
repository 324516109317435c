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
// Both kernels take the Hamming distances from the binary tensor-core
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

}  // extern "C"

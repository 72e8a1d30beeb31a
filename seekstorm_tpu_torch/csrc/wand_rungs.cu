// WAND phase 2 on Hopper (K6): each query's exact top-(K_SEL+1) regions at
// the three rungs of the ladder (32-, 128- and 512-doc regions).
//
// Replaces the XLA programs seekstorm_tpu/ops/wand.py::_rung_topks (368)
// and _topk_lanes (556); the port's plain versions are
// ops/wand_rungs.py::_rung_topks and _topk_lanes.
//
// A rung ranks x[Bq, L]: allub (L1 = nblk*NW buckets), or its maxima over
// 4 and 16 consecutive buckets (ub4, ub16).  With G = min(128, L) lanes a
// group and ng = L/G groups, _topk_lanes takes the top kg = min(K, L, ng)
// groups by (group max desc, group asc), then the top min(K, L) of their
// kg*G lanes laid out in group-rank order, by (value desc, position asc):
// ties follow the group's rank, then the lane within the group.  Fewer than
// K entries are padded with (-inf, id 0).
//
// One CTA a (query, rung).  Stage 1 orders the groups by their maxima
// (one warp's sort where every group is selected, else the select of
// topk_select.cuh).  Stage 2 selects keff of the selected groups' lanes,
// read straight from allub / ub4 / ub16 (no staging copy), a warp's float4
// loads a 128-lane group, under a cut: a key that at least keff lanes do
// not exceed, so a lane above it cannot be among the keff.  With kg == K
// the cut is the kg-th group maximum (each selected group holds a lane
// equal to its maximum); a rung with fewer groups than K (rungs 2 and 3
// below 17 and 65 blocks) takes it from the maxima of its 16-lane
// sub-groups, which the pass that reduces its group maxima also reduces:
// the top of the bin of the keys' first 22 bits that holds the keff-th of
// them.  Both
// hold only because the maxima are exactly the groups' maxima (K1's are,
// bitwise).  Only the groups whose maximum is not below the cut can hold
// a winner, and they come first in rank order; groups of -inf lanes only
// come last and are left out but for enough lanes to fill keff.  Under a
// finite cut one pass keeps the lanes at or under it in order, and one
// warp sorts them in its registers (up to 128; the select from that list
// up to 512); otherwise (a -inf or no cut, too many ties) the select reads
// the groups' lanes.  Where phase 1 gave the maxima
// (ub4, ub16 and g1, the rung-1 group maxima), rung 1 reads g1 and rungs
// 2 and 3 reduce their groups from ub4 and ub16; without them (the
// rank-by-key route) the kernel reduces x and the group maxima from allub
// itself.
//
// What bounds it on an H100: bytes.  A query reads g1, its 65 rung-1
// groups of allub, ub4 and ub16 once and writes 3 x 65 entries.  What
// holds the first version back is its passes, not its bytes: it staged up
// to 65 x 128 lanes in 33 KB of shared memory (6 CTAs an SM, a load never
// beside a selection) and made four to seven radix passes over every
// staged lane, rungs 2 and 3 without a cut.  This one keeps 13 KB of
// shared memory a CTA and asks for six CTAs an SM (40 registers, a few
// spilled: more CTAs to interleave beat fewer spills), reads most lanes
// once, and sorts the few under a cut in one warp.

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

#include "topk_select.cuh"

namespace {

constexpr int K = 65;              // K_SEL + 1 entries a rung
constexpr int GMAX = 128;          // lanes a group
constexpr int SUB = 16;            // lanes a sub-group
constexpr int MAX_GROUPS = K * GMAX;  // most groups a rung (L1 / 128)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = 2;          // groups a warp loads at once
constexpr int LIST = 512;          // lanes under a cut kept in order
constexpr uint32_t KEY_NEG_INF = 0xFF800000u;   // desc_key(-inf)

// x[i] of a rung: the max of src[i*xf, i*xf + xf)
__device__ __forceinline__ float rung_x(const float* src, int i, int xf) {
  if (xf == 1) return src[i];
  float m = -INFINITY;
  const float* x = src + static_cast<size_t>(i) * xf;
  for (int e = 0; e < xf; ++e) m = fmaxf(m, x[e]);
  return m;
}

// Six resident CTAs an SM: the kernel issues more than it waits, so the
// registers it gives up (to a few spills) buy more CTAs to interleave.
constexpr int MINB = 6;

__global__ void __launch_bounds__(THREADS, MINB)
rungs_kernel(const float* allub, const float* g1, const float* ub4,
             const float* ub16, int L1, int Bq, float* out_vals,
             int32_t* out_ids) {
  // reduced group maxima [ng], then sub-group maxima [L / SUB]
  extern __shared__ __align__(16) float red[];
  __shared__ topk::Scratch s;
  __shared__ int gsel[topk::KMAX];
  __shared__ int sel[topk::KMAX];
  __shared__ uint32_t lkey[LIST];    // the lanes under the cut, in order
  __shared__ int lidx[LIST];
  const int q = blockIdx.x;
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int L = L1 >> (2 * r);
  const float* src;
  const float* gmax = nullptr;
  int xf = 1;
  if (g1 != nullptr) {
    const float* rows[3] = {allub, ub4, ub16};
    src = rows[r] + static_cast<size_t>(q) * L;
    if (r == 0) gmax = g1 + static_cast<size_t>(q) * (L1 / GMAX);
  } else {
    src = allub + static_cast<size_t>(q) * L1;
    xf = 1 << (2 * r);
  }
  const int G = min(GMAX, L);
  const int ng = L / G;
  const int keff = min(K, L);
  const int kg = min(keff, ng);
  // float4 loads: the rows start on 16 bytes (the entry point takes only
  // 16-byte aligned allub, ub4 and ub16, and G % 4 == 0 makes L % 4 == 0)
  const bool vec = xf == 1 && G % 4 == 0;
  // no group cut (kg < K): the sub-groups' maxima give one
  const bool subs = gmax == nullptr && kg < keff && vec && G == GMAX &&
                    L / SUB >= keff;
  float* gm_red = red;
  float* sm = red + ng;

  // stage 1: the group maxima (and sub-group maxima), and the kg best
  // groups
  if (gmax == nullptr) {
    if (vec) {
      // G <= 128: a group is one float4 a lane, four lanes a sub-group;
      // GROUPS groups a warp in flight at once
      for (int g0 = warp; g0 < ng; g0 += GROUPS * WARPS) {
        float4 f[GROUPS];
#pragma unroll
        for (int u = 0; u < GROUPS; ++u) {
          const int g = g0 + u * WARPS;
          f[u] = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
          if (g < ng && 4 * lane < G)
            f[u] = *reinterpret_cast<const float4*>(
                src + static_cast<size_t>(g) * G + 4 * lane);
        }
#pragma unroll
        for (int u = 0; u < GROUPS; ++u) {
          const int g = g0 + u * WARPS;
          if (g >= ng) break;
          float m = fmaxf(fmaxf(f[u].x, f[u].y), fmaxf(f[u].z, f[u].w));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          if (subs && (lane & 3) == 0) sm[g * (GMAX / SUB) + (lane >> 2)] = m;
          for (int off = 4; off < 32; off <<= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
          if (lane == 0) gm_red[g] = m;
        }
      }
    } else {
      for (int g = warp; g < ng; g += WARPS) {
        float m = -INFINITY;
        for (int e = lane; e < G; e += 32)
          m = fmaxf(m, rung_x(src, g * G + e, xf));
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0) gm_red[g] = m;
      }
    }
    __syncthreads();
  }
  const float* gm = gmax != nullptr ? gmax : gm_red;
  if (kg == ng) {
    // every group, ordered by (maximum desc, group asc)
    topk::sort_first(
        [&](int g, uint32_t& key, int& idx) {
          key = topk::desc_key(gm[g]);
          idx = g;
        },
        ng, kg, gsel);
  } else {
    topk::select_topk<THREADS>(
        [&](int i0, uint32_t (&key)[4]) { topk::keys4(gm, i0, ng, key); },
        ng, kg, 0xFFFFFFFFu, gsel, s);
  }

  // the cut: a key at least keff lanes do not exceed (the kg-th group
  // maximum, or the top of the bin of 22 bits that holds the keff-th
  // sub-group maximum), else none
  uint32_t cut = 0xFFFFFFFFu;
  if (kg == keff) {
    cut = topk::desc_key(gm[gsel[kg - 1]]);
  } else if (subs) {
    const int nsub = L / SUB;
    cut = topk::bin_cut<THREADS>(
        [&](int i0, uint32_t (&key)[4]) { topk::keys4(sm, i0, nsub, key); },
        nsub, keff, s);
  }
  // the groups that can hold a winner: those whose maximum is not below
  // the cut, less those of -inf lanes only (they rank last), but enough
  // for keff lanes; a prefix of the ranks, as the maxima descend
  const uint32_t gk = tid < kg ? topk::desc_key(gm[gsel[tid]]) : 0u;
  int ngk = __syncthreads_count(tid < kg && gk <= cut && gk < KEY_NEG_INF);
  ngk = min(max(ngk, (keff + G - 1) / G), kg);

  // stage 2: those groups' lanes in rank order, and the best keff
  const int n = ngk * G;
  auto lanes = [&](int i0, uint32_t (&key)[4]) {
    if (vec) {   // G % 4 == 0: the four lanes lie in one group
      const int gr = i0 / G;
      const float4 f = *reinterpret_cast<const float4*>(
          src + gsel[gr] * G + (i0 - gr * G));
      key[0] = topk::desc_key(f.x);
      key[1] = topk::desc_key(f.y);
      key[2] = topk::desc_key(f.z);
      key[3] = topk::desc_key(f.w);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = i0 + j;
        if (c < n)
          key[j] = topk::desc_key(rung_x(src, gsel[c / G] * G + c % G, xf));
      }
    }
  };
  bool done = false;
  if (cut < KEY_NEG_INF) {
    // a finite cut leaves few lanes: one pass keeps them in order, and
    // one warp sorts them (or, past 128, a select over them in shared
    // memory)
    const int m = topk::gather<THREADS>(lanes, n, cut, lkey, lidx, LIST, s);
    if (m <= topk::KEPT) {
      topk::sort_first(
          [&](int i, uint32_t& key, int& idx) {
            key = lkey[i];
            idx = lidx[i];
          },
          m, keff, sel);
      done = true;
    } else if (m <= LIST) {
      topk::select_topk<THREADS>(
          [&](int i0, uint32_t (&key)[4]) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (i0 + j < m) key[j] = lkey[i0 + j];
          },
          m, keff, 0xFFFFFFFFu, sel, s);
      for (int i = tid; i < keff; i += THREADS) sel[i] = lidx[sel[i]];
      done = true;
    }
  }
  if (!done) topk::select_topk<THREADS>(lanes, n, keff, cut, sel, s);
  const size_t at = (static_cast<size_t>(r) * Bq + q) * K;
  for (int i = tid; i < K; i += THREADS) {
    if (i < keff) {
      const int c = sel[i];
      const int x = gsel[c / G] * G + c % G;
      out_vals[at + i] = rung_x(src, x, xf);
      out_ids[at + i] = x;
    } else {
      out_vals[at + i] = -INFINITY;
      out_ids[at + i] = 0;
    }
  }
}

}  // namespace

// allub f32[Bq, L1]; g1 f32[Bq, L1/128], ub4 f32[Bq, L1/4] and ub16
// f32[Bq, L1/16] phase 1's maxima, all three or all null (then reduced
// here); out_vals f32[3, Bq, 65] and out_ids i32[3, Bq, 65], rung-major.
// allub, ub4 and ub16 start on 16 bytes.  Returns the CUDA error of the
// launch, 0 on success, or -1 for an L1 or a pointer it does not take.
extern "C" int wand_rungs_launch(const void* allub, const void* g1,
                                 const void* ub4, const void* ub16, int L1,
                                 int Bq, void* out_vals, void* out_ids,
                                 void* stream) {
  if (L1 < 16 || L1 % 16 != 0 || L1 / GMAX > MAX_GROUPS) return -1;
  if (g1 != nullptr && (ub4 == nullptr || ub16 == nullptr || L1 % GMAX != 0))
    return -1;
  for (const void* p : {allub, ub4, ub16})
    if ((reinterpret_cast<uintptr_t>(p) & 15u) != 0u) return -1;
  // the most group and sub-group maxima a CTA reduces into shared memory
  int most = 0;
  for (int r = 0; r < 3; ++r) {
    const int L = L1 >> (2 * r);
    const int G = min(GMAX, L);
    if (L % G != 0) return -1;
    if (g1 == nullptr || r > 0)
      most = max(most, L / G + (L / G < K ? L / SUB : 0));
  }
  if (Bq == 0) return 0;
  // above 48 KB of shared memory in all a kernel must ask first; it asks
  // for the most it can ever take, the same on every call
  const size_t smem = most * sizeof(float);
  if (smem > 16 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rungs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (MAX_GROUPS + K * GMAX / SUB) * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rungs_kernel<<<dim3(Bq, 3), THREADS, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(allub), static_cast<const float*>(g1),
      static_cast<const float*>(ub4), static_cast<const float*>(ub16), L1, Bq,
      static_cast<float*>(out_vals), static_cast<int32_t*>(out_ids));
  return static_cast<int>(cudaGetLastError());
}

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
// One CTA a (query, rung).  Stage 1 loads or reduces the ng group maxima
// into shared memory and selects kg of them; stage 2 gathers the kg
// selected groups' lanes into shared memory and selects K of them; both
// with the radix select of topk_select.cuh.  With kg == K the kg-th group
// maximum m bounds the answer: each selected group holds a lane equal to
// its maximum, so at least K lanes are >= m, and a lane below m cannot be
// among the K: stage 2 skips them (the `cut`).  Where phase 1 gave the
// maxima (ub4, ub16 and g1, the rung-1 group maxima), rung 1 reads g1 and
// rungs 2 and 3 read ub4 and ub16; without them (the rank-by-key route) the
// kernel reduces x and the group maxima from allub itself.
//
// What bounds it on an H100: bytes.  A query reads g1, its 65 rung-1
// groups of allub, ub4 and ub16 once and writes 3 x 65 entries; the
// selections are shared-memory passes (four to seven over each candidate
// set), which this simple version does not overlap with the reads.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "topk_select.cuh"

namespace {

constexpr int K = 65;              // K_SEL + 1 entries a rung
constexpr int GMAX = 128;          // lanes a group
constexpr int CAND = K * GMAX;     // most candidates of stage 2
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct RungSmem {
  float buf[CAND];
  int gsel[K];
  int sel[K];
  topk::Scratch scr;
};

// x[i] of a rung: the max of src[i*xf, i*xf + xf)
__device__ __forceinline__ float rung_x(const float* src, int i, int xf) {
  if (xf == 1) return src[i];
  float m = -INFINITY;
  const float* x = src + static_cast<size_t>(i) * xf;
  for (int e = 0; e < xf; ++e) m = fmaxf(m, x[e]);
  return m;
}

__global__ void __launch_bounds__(THREADS)
rungs_kernel(const float* allub, const float* g1, const float* ub4,
             const float* ub16, int L1, int Bq, float* out_vals,
             int32_t* out_ids) {
  __shared__ RungSmem s;
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

  // stage 1: the group maxima, and the kg best groups
  if (gmax != nullptr) {
    for (int g = tid; g < ng; g += THREADS) s.buf[g] = gmax[g];
  } else {
    for (int g = warp; g < ng; g += WARPS) {
      float m = -INFINITY;
      const size_t g0 = static_cast<size_t>(g) * G * xf;
      for (int e = lane; e < G * xf; e += 32) m = fmaxf(m, src[g0 + e]);
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) s.buf[g] = m;
    }
  }
  topk::select_topk<THREADS>(
      [&](int i) { return topk::desc_key(s.buf[i]); }, ng, kg, 0xFFFFFFFFu,
      s.gsel, s.scr);
  const uint32_t cut =
      kg == keff ? topk::desc_key(s.buf[s.gsel[kg - 1]]) : 0xFFFFFFFFu;
  __syncthreads();

  // stage 2: the selected groups' lanes in rank order, and the best keff
  const int n = kg * G;
  for (int c = tid; c < n; c += THREADS)
    s.buf[c] = rung_x(src, s.gsel[c / G] * G + c % G, xf);
  topk::select_topk<THREADS>(
      [&](int i) { return topk::desc_key(s.buf[i]); }, n, keff, cut, s.sel,
      s.scr);
  const size_t at = (static_cast<size_t>(r) * Bq + q) * K;
  for (int i = tid; i < K; i += THREADS) {
    if (i < keff) {
      const int c = s.sel[i];
      out_vals[at + i] = s.buf[c];
      out_ids[at + i] = s.gsel[c / G] * G + c % G;
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
// Returns the CUDA error of the launch, 0 on success, or -1 for an L1 it
// does not take.
extern "C" int wand_rungs_launch(const void* allub, const void* g1,
                                 const void* ub4, const void* ub16, int L1,
                                 int Bq, void* out_vals, void* out_ids,
                                 void* stream) {
  if (L1 < 16 || L1 % 16 != 0 || L1 / GMAX > CAND) return -1;
  if (g1 != nullptr && (ub4 == nullptr || ub16 == nullptr || L1 % GMAX != 0))
    return -1;
  for (int r = 0; r < 3; ++r) {
    const int L = L1 >> (2 * r);
    if (L % min(GMAX, L) != 0) return -1;
  }
  if (Bq == 0) return 0;
  rungs_kernel<<<dim3(Bq, 3), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(allub), static_cast<const float*>(g1),
      static_cast<const float*>(ub4), static_cast<const float*>(ub16), L1, Bq,
      static_cast<float*>(out_vals), static_cast<int32_t*>(out_ids));
  return static_cast<int>(cudaGetLastError());
}

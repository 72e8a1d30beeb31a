// WAND phases 3-4 on Hopper (K5): the exact rescore of a query's selected
// 32-doc buckets and its device page, and in its fold mode the device exact
// scan over every bucket of the pools.
//
// Replaces the XLA programs seekstorm_tpu/ops/wand.py::_rescore_regions
// (589) and _page_topk (700), which _ladder_device (722) and
// wand_exact_scan (811) compose; the port's plain versions are
// ops/wand_rescore.py::_rescore_regions, _page_topk and exact_scan_ref.
//
// Page mode (rescore_page_launch), one CTA a query:
//   * the query's K selected bucket ids (an id whose UB is -inf is
//     unselected and sorts last as nblk*NW) are sorted ascending in shared
//     memory, so candidate index k*32 + bit is the plain version's lane
//     order;
//   * a warp takes a bucket and its lane the doc at that bit.  Lane t reads
//     column t's pool row, impact offset, presence word and rank (all
//     columns at once, not one after another), lane 31 the deleted and
//     filter words; shuffles hand them to the warp, which matches
//     AND(required) & OR(positive) & ~OR(negated) & ~deleted & ~filter.
//     A lane whose bit is present in a column reads its impact at
//     ioff + rank + popcount(word & (2^bit - 1)), so only present impacts
//     are read, and adds w_t * impact in column order with
//     __fmul_rn / __fadd_rn: the two roundings a term of the host rescore,
//     where the plain version also adds the +0 of an absent column (which
//     changes no sum).  An unmatched candidate scores -inf;
//   * the page is the top-64 of the K*32 scores by (score desc, candidate
//     asc), selected in shared memory (topk_select.cuh), with the matched
//     count and the count of matched candidates tying or beating the
//     page's last entry.
//
// Fold mode (exact_fold_launch): CTAs (query, split) walk contiguous bucket
// ranges of all nblk*NW buckets in chunks of CH, keeping a running top-64
// (the carried page) in shared memory.  A chunk is scored as above into the
// slots after the carried page, so on ties carried entries come first; a
// chunk none of whose scores beats the carried page's last entry leaves it
// as it is.  Split 0 starts from the caller's carried page, the others from
// (-inf, lane 0); a second launch (fold_merge_kernel) selects the top-64 of
// the splits' pages in split order and adds their matched counts.  Finite
// entries are so the global top-64 by (score desc, lane asc) and the rest
// keep the carried page's padding, which is what the plain loop over
// blocks (a stable sort of carried | new each block) gives.
//
// What bounds it on an H100: bytes.  Per (query, column, bucket) it reads
// the pool row and impact offset (8 bytes), the presence word and rank (8
// bytes) and one impact for each present doc; the selection is shared
// memory work that a faster version would shrink (a page rarely needs more
// than the matched candidates).  This is the simple version: one CTA a
// query in page mode, a warp's loads of a bucket in flight together.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "topk_select.cuh"

namespace {

constexpr int NW = 2048;          // u32 words (buckets) per 64K-doc block
constexpr int P = 64;             // page entries (P_PAGE)
constexpr int KMAX = 256;         // selected buckets a query in page mode
constexpr int TMAX = 8;           // columns a query
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 256;           // buckets a chunk in the fold mode
constexpr int MAX_SPLITS = 128;   // splits a query in the fold mode

struct Pools {
  const uint32_t* ppool;   // [R, NW] presence words
  const int32_t* rpool;    // [R, NW] ranks
  const float* ipool;      // [N] impacts
  const int32_t* sp_prow;  // [V, nblk] pool row of (slot row, block)
  const int32_t* sp_ioff;  // [V, nblk] impact offset of (slot row, block)
  const uint32_t* delw;    // [nblk, NW] deleted words
  const int32_t* sid;      // [nblk] shard of each block
  const uint32_t* filtw;   // [nblk, NW] disallowed words, or null
  const int32_t* slotmap;  // [Vb] slot row of each batch slot
  const int32_t* tslot;    // [Bq, T]
  const uint8_t* treq;     // [Bq, T] bool
  const uint8_t* tneg;     // [Bq, T] bool
  const float* wshard;     // [S, Bq, T]
  int nblk, n_imp, Bq, T;
};

// One query's columns: the slot-table row of each, and which are required
// (and positive), positive and negated.
struct Terms {
  int srow[TMAX];
  unsigned req, pos, neg;
};

__device__ void load_terms(const Pools& p, int q, Terms& tm) {
  tm.req = tm.pos = tm.neg = 0u;
  for (int t = 0; t < TMAX; ++t) {
    tm.srow[t] = -1;
    if (t >= p.T) continue;
    const int s = p.tslot[q * p.T + t];
    if (s < 0) continue;
    tm.srow[t] = p.slotmap[s];
    const bool neg = p.tneg[q * p.T + t] != 0;
    if (neg) {
      tm.neg |= 1u << t;
    } else {
      tm.pos |= 1u << t;
      if (p.treq[q * p.T + t] != 0) tm.req |= 1u << t;
    }
  }
}

// The doc at bit `lane` of bucket c (0 <= c < nblk*NW) for query q: its
// score, or -inf when it does not match.  Called by a whole warp with the
// query's columns in shared memory: lane t < TMAX reads column t's pool
// row, presence word and impact base, lane 31 the deleted and filter
// words, all at once, and the warp shares them by shuffles.
__device__ __forceinline__ float score_doc(const Pools& p, const Terms& tm,
                                           int q, int c, int lane) {
  const int blk = c / NW;
  const int w = c % NW;
  uint32_t word = 0u;
  int at_imp = 0;
  if (lane < TMAX) {
    const int sr = tm.srow[lane];
    if (sr >= 0) {
      const size_t r = static_cast<size_t>(sr) * p.nblk + blk;
      const int pr = p.sp_prow[r];
      if (pr >= 0) {
        const size_t at = static_cast<size_t>(pr) * NW + w;
        word = p.ppool[at];
        at_imp = max(p.sp_ioff[r], 0) + p.rpool[at];
      }
    }
  } else if (lane == 31) {
    const size_t bw = static_cast<size_t>(blk) * NW + w;
    word = ~p.delw[bw];
    if (p.filtw != nullptr) word &= ~p.filtw[bw];
  }
  uint32_t pres[TMAX];
  int base[TMAX];
  uint32_t andw = __shfl_sync(0xffffffffu, word, 31);   // not deleted
  uint32_t posw = 0u, negw = 0u;
#pragma unroll
  for (int t = 0; t < TMAX; ++t) {
    pres[t] = __shfl_sync(0xffffffffu, word, t);
    base[t] = __shfl_sync(0xffffffffu, at_imp, t);
    if ((tm.req >> t) & 1u) andw &= pres[t];
    if ((tm.pos >> t) & 1u) posw |= pres[t];
    if ((tm.neg >> t) & 1u) negw |= pres[t];
  }
  const uint32_t mw = andw & posw & ~negw;
  if (((mw >> lane) & 1u) == 0u) return -INFINITY;
  const uint32_t below = (1u << lane) - 1u;
  const float* wq =
      p.wshard + (static_cast<size_t>(p.sid[blk]) * p.Bq + q) * p.T;
  float sc = 0.0f;
#pragma unroll
  for (int t = 0; t < TMAX; ++t) {
    if ((pres[t] >> lane) & 1u) {
      int at = base[t] + __popc(pres[t] & below);
      at = min(max(at, 0), p.n_imp - 1);
      sc = __fadd_rn(sc, __fmul_rn(wq[t], p.ipool[at]));
    }
  }
  return sc;
}

struct PageSmem {
  float sc[KMAX * 32];
  int ids[KMAX];
  int sel[P];
  Terms tm;
  int found;
  int n_ge;
  topk::Scratch scr;
};

__global__ void __launch_bounds__(THREADS)
rescore_page_kernel(Pools p, const int32_t* ids, const float* vals, int K,
                    int bucket_off, float* psc, int32_t* plane,
                    int32_t* n_ge, int32_t* found) {
  __shared__ PageSmem s;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int big = p.nblk * NW;
  if (tid == 0) {
    load_terms(p, q, s.tm);
    s.found = 0;
    s.n_ge = 0;
  }
  // the selected ids, unselected ones as big, sorted ascending (rank count)
  int* key = reinterpret_cast<int*>(s.sc);
  for (int i = tid; i < K; i += THREADS) {
    const size_t at = static_cast<size_t>(q) * K + i;
    key[i] = vals[at] > -INFINITY ? ids[at] : big;
  }
  __syncthreads();
  for (int i = tid; i < K; i += THREADS) {
    const int v = key[i];
    int r = 0;
    for (int j = 0; j < K; ++j) {
      const int u = key[j];
      r += (u < v || (u == v && j < i)) ? 1 : 0;
    }
    s.ids[r] = v;
  }
  __syncthreads();
  int nf = 0;
  for (int k = warp; k < K; k += WARPS) {
    const int c = s.ids[k];
    float v = -INFINITY;
    if (c < big) v = score_doc(p, s.tm, q, c, lane);
    s.sc[k * 32 + lane] = v;
    nf += __popc(__ballot_sync(0xffffffffu, v > -INFINITY));
  }
  if (lane == 0 && nf) atomicAdd(&s.found, nf);
  const int n = K * 32;
  topk::select_topk<THREADS>(
      [&](int i) { return topk::desc_key(s.sc[i]); }, n, P, 0xFFFFFFFFu,
      s.sel, s.scr);
  const float last = s.sc[s.sel[P - 1]];
  int ge = 0;
  for (int i = tid; i < n; i += THREADS) {
    const float v = s.sc[i];
    ge += (v >= last && v > -INFINITY) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    ge += __shfl_xor_sync(0xffffffffu, ge, off);
  if (lane == 0 && ge) atomicAdd(&s.n_ge, ge);
  if (tid < P) {
    const int c = s.sel[tid];
    const int b = min(s.ids[c >> 5], big - 1);
    psc[q * P + tid] = s.sc[c];
    plane[q * P + tid] = (b + bucket_off) * 32 + (c & 31);
  }
  __syncthreads();
  if (tid == 0) {
    n_ge[q] = s.n_ge;
    found[q] = s.found;
  }
}

struct FoldSmem {
  float sc[P + CH * 32];   // the carried page, then the chunk's scores
  int lane[P];             // the carried page's lanes
  int sel[P];
  Terms tm;
  int found;
  topk::Scratch scr;
};

__global__ void __launch_bounds__(THREADS)
exact_fold_kernel(Pools p, int per, const float* c_psc, const int32_t* c_plane,
                  float* part_sc, int32_t* part_lane, int32_t* part_found) {
  __shared__ FoldSmem s;
  const int q = blockIdx.x;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = p.nblk * NW;
  const int b0 = min(split * per, nb);
  const int b1 = min(b0 + per, nb);
  if (tid == 0) {
    load_terms(p, q, s.tm);
    s.found = 0;
  }
  if (tid < P) {
    const bool given = split == 0 && c_psc != nullptr;
    s.sc[tid] = given ? c_psc[q * P + tid] : -INFINITY;
    s.lane[tid] = given ? c_plane[q * P + tid] : 0;
  }
  __syncthreads();
  int nf = 0;
  for (int cb = b0; cb < b1; cb += CH) {
    const int nk = min(CH, b1 - cb);
    for (int k = warp; k < nk; k += WARPS) {
      const float v = score_doc(p, s.tm, q, cb + k, lane);
      s.sc[P + k * 32 + lane] = v;
      nf += __popc(__ballot_sync(0xffffffffu, v > -INFINITY));
    }
    __syncthreads();
    const float theta = s.sc[P - 1];
    int beats = 0;
    for (int i = tid; i < nk * 32; i += THREADS) beats |= s.sc[P + i] > theta;
    if (__syncthreads_or(beats)) {
      topk::select_topk<THREADS>(
          [&](int i) { return topk::desc_key(s.sc[i]); }, P + nk * 32, P,
          topk::desc_key(theta), s.sel, s.scr);
      float v = 0.0f;
      int l = 0;
      if (tid < P) {
        const int c = s.sel[tid];
        v = s.sc[c];
        l = c < P ? s.lane[c] : (cb + ((c - P) >> 5)) * 32 + ((c - P) & 31);
      }
      __syncthreads();
      if (tid < P) {
        s.sc[tid] = v;
        s.lane[tid] = l;
      }
    }
    __syncthreads();
  }
  if (lane == 0 && nf) atomicAdd(&s.found, nf);
  __syncthreads();
  const size_t at = (static_cast<size_t>(q) * nsplit + split) * P;
  if (tid < P) {
    part_sc[at + tid] = s.sc[tid];
    part_lane[at + tid] = s.lane[tid];
  }
  if (tid == 0) part_found[q * nsplit + split] = s.found;
}

struct MergeSmem {
  float sc[MAX_SPLITS * P];
  int sel[P];
  int found;
  topk::Scratch scr;
};

__global__ void __launch_bounds__(THREADS)
fold_merge_kernel(const float* part_sc, const int32_t* part_lane,
                  const int32_t* part_found, int nsplit, float* psc,
                  int32_t* plane, int32_t* found) {
  __shared__ MergeSmem s;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = nsplit * P;
  const size_t at = static_cast<size_t>(q) * n;
  if (tid == 0) {
    int f = 0;
    for (int i = 0; i < nsplit; ++i) f += part_found[q * nsplit + i];
    s.found = f;
  }
  for (int i = tid; i < n; i += THREADS) s.sc[i] = part_sc[at + i];
  topk::select_topk<THREADS>(
      [&](int i) { return topk::desc_key(s.sc[i]); }, n, P, 0xFFFFFFFFu,
      s.sel, s.scr);
  if (tid < P) {
    const int c = s.sel[tid];
    psc[q * P + tid] = s.sc[c];
    plane[q * P + tid] = part_lane[at + c];
  }
  if (tid == 0) found[q] = s.found;
}

Pools make_pools(const void* ppool, const void* rpool, const void* ipool,
                 int n_imp, const void* sp_prow, const void* sp_ioff,
                 const void* delw, const void* sid, const void* filtw,
                 const void* slotmap, const void* tslot, const void* treq,
                 const void* tneg, const void* wshard, int nblk, int Bq,
                 int T) {
  Pools p;
  p.ppool = static_cast<const uint32_t*>(ppool);
  p.rpool = static_cast<const int32_t*>(rpool);
  p.ipool = static_cast<const float*>(ipool);
  p.sp_prow = static_cast<const int32_t*>(sp_prow);
  p.sp_ioff = static_cast<const int32_t*>(sp_ioff);
  p.delw = static_cast<const uint32_t*>(delw);
  p.sid = static_cast<const int32_t*>(sid);
  p.filtw = static_cast<const uint32_t*>(filtw);
  p.slotmap = static_cast<const int32_t*>(slotmap);
  p.tslot = static_cast<const int32_t*>(tslot);
  p.treq = static_cast<const uint8_t*>(treq);
  p.tneg = static_cast<const uint8_t*>(tneg);
  p.wshard = static_cast<const float*>(wshard);
  p.nblk = nblk;
  p.n_imp = n_imp;
  p.Bq = Bq;
  p.T = T;
  return p;
}

}  // namespace

// Page mode: ids i32[Bq, K] / vals f32[Bq, K] the selected buckets (local
// to the pools) and their UBs; psc f32[Bq, 64], plane i32[Bq, 64], n_ge and
// found i32[Bq] out.  filtw may be null.  Returns the CUDA error of the
// launch, 0 on success, or -1 for shapes it does not take.
extern "C" int rescore_page_launch(
    const void* ppool, const void* rpool, const void* ipool, int n_imp,
    const void* sp_prow, const void* sp_ioff, const void* delw,
    const void* sid, const void* filtw, const void* slotmap,
    const void* tslot, const void* treq, const void* tneg,
    const void* wshard, const void* ids, const void* vals, int nblk, int Bq,
    int T, int K, int bucket_off, void* psc, void* plane, void* n_ge,
    void* found, void* stream) {
  if (T < 1 || T > TMAX || K * 32 < P || K > KMAX || n_imp < 1) return -1;
  if (Bq == 0) return 0;
  const Pools p = make_pools(ppool, rpool, ipool, n_imp, sp_prow, sp_ioff,
                             delw, sid, filtw, slotmap, tslot, treq, tneg,
                             wshard, nblk, Bq, T);
  rescore_page_kernel<<<Bq, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int32_t*>(ids), static_cast<const float*>(vals), K,
      bucket_off, static_cast<float*>(psc), static_cast<int32_t*>(plane),
      static_cast<int32_t*>(n_ge), static_cast<int32_t*>(found));
  return static_cast<int>(cudaGetLastError());
}

// Fold mode over every bucket of the pools: c_psc / c_plane the carried
// page [Bq, 64] split 0 starts from (null: -inf, lane 0); part_sc /
// part_lane [Bq, nsplit, 64] and part_found [Bq, nsplit] scratch; psc,
// plane [Bq, 64] and found [Bq] out.  Two launches (the splits, then their
// merge).  Returns as rescore_page_launch.
extern "C" int exact_fold_launch(
    const void* ppool, const void* rpool, const void* ipool, int n_imp,
    const void* sp_prow, const void* sp_ioff, const void* delw,
    const void* sid, const void* filtw, const void* slotmap,
    const void* tslot, const void* treq, const void* tneg,
    const void* wshard, int nblk, int Bq, int T, int nsplit,
    const void* c_psc, const void* c_plane, void* part_sc, void* part_lane,
    void* part_found, void* psc, void* plane, void* found, void* stream) {
  if (T < 1 || T > TMAX || nsplit < 1 || nsplit > MAX_SPLITS || n_imp < 1)
    return -1;
  if (Bq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Pools p = make_pools(ppool, rpool, ipool, n_imp, sp_prow, sp_ioff,
                             delw, sid, filtw, slotmap, tslot, treq, tneg,
                             wshard, nblk, Bq, T);
  const int nb = nblk * NW;
  const int per = (nb + nsplit - 1) / nsplit;
  exact_fold_kernel<<<dim3(Bq, nsplit), THREADS, 0, st>>>(
      p, per, static_cast<const float*>(c_psc),
      static_cast<const int32_t*>(c_plane), static_cast<float*>(part_sc),
      static_cast<int32_t*>(part_lane), static_cast<int32_t*>(part_found));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_merge_kernel<<<Bq, THREADS, 0, st>>>(
      static_cast<const float*>(part_sc),
      static_cast<const int32_t*>(part_lane),
      static_cast<const int32_t*>(part_found), nsplit,
      static_cast<float*>(psc), static_cast<int32_t*>(plane),
      static_cast<int32_t*>(found));
  return static_cast<int>(cudaGetLastError());
}

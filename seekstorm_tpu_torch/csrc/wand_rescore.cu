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
//     unselected and sorts last as nblk*NW) are ordered ascending by a
//     bitonic sort in shared memory, so candidate index k*32 + bit is the
//     plain version's lane order;
//   * score_buckets loads in three rounds, each a block's loads in flight
//     together: every (column, bucket) pair's pool row and impact offset,
//     then its presence word and rank (and each bucket's delete and filter
//     words); a bucket's matched word is AND(required) & OR(positive) &
//     ~OR(negated) & ~deleted & ~filter, and an exclusive scan of their
//     popcounts over the buckets gives every matched doc a slot in
//     candidate order (found is the list's length); then a thread a
//     matched doc reads its present impacts at ioff + rank + popcount(word
//     & (2^bit - 1)) and adds w_t * impact in column order with __fmul_rn /
//     __fadd_rn: the two roundings a term of the host rescore, where the
//     plain version also adds the +0 of an absent column (which changes no
//     sum);
//   * with found <= 256 one warp sorts the matched list by (score desc,
//     slot asc) in its registers and the page is its first 64 entries,
//     then, with found < 64, the first 64 - found unmatched candidates in
//     candidate order (score -inf; an unselected bucket's lanes clamped to
//     the last bucket): no selection passes run;
//   * with found > 256 the page is the top-64 of the matched list by
//     (score desc, slot asc), selected in shared memory (topk_select.cuh);
//   * n_ge is found where found <= 64, else the count of matched docs
//     tying or beating the page's last entry.
//
// Fold mode (exact_fold_launch): CTAs (query, split) walk contiguous bucket
// ranges of all nblk*NW buckets in chunks of CH, keeping a running top-64
// (the carried page) in shared memory.  A chunk's matched docs are scored
// as above into a list placed after the carried page, so on ties carried
// entries come first; a chunk none of whose scores beats the carried
// page's last entry leaves it as it is.  An unmatched doc of a chunk
// scores -inf and comes after all 64 carried entries, so it can never
// enter the page: the selection reads the carried page and the matched
// list only.  Split 0 starts from the caller's carried page, the others
// from (-inf, lane 0); a second launch (fold_merge_kernel) selects the
// top-64 of the splits' pages in split order and adds their matched
// counts.  Finite entries are so the global top-64 by (score desc, lane
// asc) and the rest keep the carried page's padding, which is what the
// plain loop over blocks (a stable sort of carried | new each block) gives.
//
// What bounds it on an H100: bytes.  Per (query, column, bucket) it reads
// the pool row and impact offset (8 bytes), the presence word and rank (8
// bytes) and one impact for each present doc.  The first version spent its
// time elsewhere: 32 KB of static shared memory whatever K, a K^2 rank
// count to order the buckets, three dependent loads a bucket one bucket
// after another in each warp, and a selection over all K*32 candidates,
// most of them -inf, with a separate n_ge pass.  Here shared memory is
// sized to K (dynamic), a warp sorts the ids in its registers, the loads
// go in three parallel rounds, and a page sorts or selects from the
// matched docs only.  At K = 64 the kernel asks for eight CTAs an SM (32
// registers, some spilled: its loads wait more than it computes); at K =
// 256 its shared memory holds it to four, so it keeps its registers.
// Queries that share a term read its rows once each, so a kernel with one
// CTA a query cannot reach the bound, which counts each row once.

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
constexpr int CH = 256;           // buckets a chunk in the fold mode
constexpr int MAX_SPLITS = 128;   // splits a query in the fold mode
constexpr int PAIRS = TMAX * KMAX / THREADS;  // (column, bucket) pairs a thread

static_assert(KMAX <= THREADS && CH <= THREADS, "a bucket a thread");
static_assert(CH <= KMAX, "a chunk fits the page mode's buffers");

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

// Query q's columns into tm, a lane a column.  A whole warp calls it.
__device__ void load_terms(const Pools& p, int q, Terms& tm) {
  const int lane = threadIdx.x & 31;
  int srow = -1;
  bool neg = false, req = false;
  if (lane < p.T) {
    const int s = p.tslot[q * p.T + lane];
    if (s >= 0) {
      srow = p.slotmap[s];
      neg = p.tneg[q * p.T + lane] != 0;
      req = p.treq[q * p.T + lane] != 0;
    }
  }
  const bool live = srow >= 0;
  const unsigned negm = __ballot_sync(0xffffffffu, live && neg);
  const unsigned posm = __ballot_sync(0xffffffffu, live && !neg);
  const unsigned reqm = __ballot_sync(0xffffffffu, live && !neg && req);
  if (lane < TMAX) tm.srow[lane] = srow;
  if (lane == 0) {
    tm.neg = negm;
    tm.pos = posm;
    tm.req = reqm;
  }
}

// The scorer's buffers in dynamic shared memory, for nk <= KMAX buckets
// and T columns.
struct Bufs {
  float* sc;          // [nk*32] matched docs' scores in candidate order
  uint32_t* pw;       // [T*nk] presence word of (column, bucket)
  int* pb;            // [T*nk] impact base of (column, bucket)
  uint32_t* mw;       // [nk] matched word
  int* off;           // [nk + 1] matched docs before each bucket
  int* shard;         // [nk] shard of each bucket's block
  int* bucket;        // [nk] bucket ids (a caller's)
};

__host__ __device__ constexpr size_t bufs_bytes(int nk, int T) {
  return sizeof(float) * nk * 32 + 2 * sizeof(int) * T * nk +
         sizeof(int) * (4 * nk + 1);
}

__device__ Bufs carve(unsigned char* dyn, int nk, int T) {
  Bufs b;
  b.sc = reinterpret_cast<float*>(dyn);
  b.pw = reinterpret_cast<uint32_t*>(b.sc + nk * 32);
  b.pb = reinterpret_cast<int*>(b.pw + T * nk);
  b.mw = reinterpret_cast<uint32_t*>(b.pb + T * nk);
  b.shard = reinterpret_cast<int*>(b.mw + nk);
  b.bucket = b.shard + nk;
  b.off = b.bucket + nk;
  return b;
}

// The bit of w's r-th (0-based) set bit.
__device__ __forceinline__ int nth_set_bit(uint32_t w, int r) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width > 0; width >>= 1) {
    const int c = __popc((w >> pos) & ((1u << width) - 1u));
    if (r >= c) {
      r -= c;
      pos += width;
    }
  }
  return pos;
}

// The bucket (index into b.bucket) whose matched docs hold slot s.
__device__ __forceinline__ int bucket_of(const Bufs& b, int nk, int s) {
  int lo = 0, hi = nk - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (b.off[mid] <= s) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The candidate index k*32 + bit of matched slot s.
__device__ __forceinline__ int cand_of(const Bufs& b, int nk, int s) {
  const int k = bucket_of(b, nk, s);
  return k * 32 + nth_set_bit(b.mw[k], s - b.off[k]);
}

// Scores query q's docs in b.bucket[0, nk) (an id outside [0, nblk*NW) is
// no bucket): b.mw, b.off and the matched docs' scores b.sc[0, found) in
// candidate order.  Returns found.  Every thread calls it; it begins and
// ends with a barrier.
__device__ int score_buckets(const Pools& p, const Terms& tm, int q, int nk,
                             const Bufs& b, int* wsum) {
  const int tid = threadIdx.x;
  const int big = p.nblk * NW;
  const int T = p.T;
  const int npair = T * nk;
  __syncthreads();
  // round 1: the pool row and impact offset of each (column, bucket)
  int prow[PAIRS], ioff[PAIRS];
#pragma unroll
  for (int u = 0; u < PAIRS; ++u) {
    const int i = tid + u * THREADS;
    prow[u] = -1;
    ioff[u] = 0;
    if (i < npair) {
      const int t = i / nk;
      const int c = b.bucket[i - t * nk];
      const int sr = tm.srow[t];
      if (sr >= 0 && c >= 0 && c < big) {
        const size_t r = static_cast<size_t>(sr) * p.nblk + c / NW;
        prow[u] = p.sp_prow[r];
        ioff[u] = p.sp_ioff[r];
      }
    }
  }
  // round 2: the presence word and rank of each, and each bucket's
  // delete and filter words
#pragma unroll
  for (int u = 0; u < PAIRS; ++u) {
    const int i = tid + u * THREADS;
    if (i < npair) {
      uint32_t word = 0u;
      int base = 0;
      if (prow[u] >= 0) {
        const size_t at = static_cast<size_t>(prow[u]) * NW +
                          b.bucket[i % nk] % NW;
        word = p.ppool[at];
        base = max(ioff[u], 0) + p.rpool[at];
      }
      b.pw[i] = word;
      b.pb[i] = base;
    }
  }
  uint32_t live = 0u;
  if (tid < nk) {
    const int c = b.bucket[tid];
    if (c >= 0 && c < big) {
      live = ~p.delw[c];
      if (p.filtw != nullptr) live &= ~p.filtw[c];
      b.shard[tid] = p.sid[c / NW];
    }
  }
  __syncthreads();
  uint32_t mw = 0u;
  if (tid < nk) {
    uint32_t andw = live, posw = 0u, negw = 0u;
    for (int t = 0; t < T; ++t) {
      const uint32_t w = b.pw[t * nk + tid];
      if ((tm.req >> t) & 1u) andw &= w;
      if ((tm.pos >> t) & 1u) posw |= w;
      if ((tm.neg >> t) & 1u) negw |= w;
    }
    mw = andw & posw & ~negw;
  }
  int found;
  const int ex = topk::block_scan<THREADS>(__popc(mw), found, wsum);
  if (tid < nk) {
    b.mw[tid] = mw;
    b.off[tid] = ex;
  }
  if (tid == 0) b.off[nk] = found;
  __syncthreads();
  // round 3: a matched doc a thread, its present impacts in column order
  for (int s = tid; s < found; s += THREADS) {
    const int k = bucket_of(b, nk, s);
    const int bit = nth_set_bit(b.mw[k], s - b.off[k]);
    const uint32_t below = (1u << bit) - 1u;
    const float* wq =
        p.wshard + (static_cast<size_t>(b.shard[k]) * p.Bq + q) * T;
    float sc = 0.0f;
#pragma unroll
    for (int t = 0; t < TMAX; ++t) {
      if (t < T) {
        const uint32_t w = b.pw[t * nk + k];
        if ((w >> bit) & 1u) {
          int at = b.pb[t * nk + k] + __popc(w & below);
          at = min(max(at, 0), p.n_imp - 1);
          sc = __fadd_rn(sc, __fmul_rn(wq[t], p.ipool[at]));
        }
      }
    }
    b.sc[s] = sc;
  }
  __syncthreads();
  return found;
}

// Resident CTAs an SM the page kernel asks the compiler to make room for:
// many where K is small (and so is its shared memory); where K = 256 its
// 43 KB allow about four, so it keeps the registers.
constexpr int MINB_SMALL = 8;     // K <= 64
constexpr int MINB_LARGE = 1;

template <int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
rescore_page_kernel(Pools p, const int32_t* ids, const float* vals, int K,
                    int bucket_off, float* psc, int32_t* plane,
                    int32_t* n_ge, int32_t* found_out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ topk::Scratch s;
  __shared__ Terms tm;
  __shared__ int sel[P];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int big = p.nblk * NW;
  const Bufs b = carve(dyn, K, p.T);
  // warp 1 reads the query's columns while warp 0 orders its selected
  // ids ascending, unselected ones as big (a sort in registers)
  if (tid >> 5 == 1) load_terms(p, q, tm);
  if (tid == 0) s.count = 0;
  topk::sort_first(
      [&](int i, uint32_t& key, int& idx) {
        const size_t at = static_cast<size_t>(q) * K + i;
        idx = vals[at] > -INFINITY ? ids[at] : big;
        key = static_cast<uint32_t>(idx) ^ 0x80000000u;
      },
      K, K, b.bucket);
  const int found = score_buckets(p, tm, q, K, b, s.wsum[0]);
  int ge = found;
  if (found <= topk::SORT_MAX) {
    // one warp sorts the matched list (no selection passes); past its
    // end the page takes the unmatched candidates in order
    topk::sort_first(
        [&](int i, uint32_t& key, int& idx) {
          key = topk::desc_key(b.sc[i]);
          idx = i;
        },
        found, min(found, P), sel);
  } else {
    topk::select_topk<THREADS>(
        [&](int i0, uint32_t (&key)[4]) { topk::keys4(b.sc, i0, found, key); },
        found, P, 0xFFFFFFFFu, sel, s);
  }
  if (found > P) {
    // n_ge: the matched docs that tie or beat the page's last entry
    const uint32_t last = topk::desc_key(b.sc[sel[P - 1]]);
    int c = 0;
    for (int i = tid; i < found; i += THREADS)
      c += topk::desc_key(b.sc[i]) <= last ? 1 : 0;
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, off);
    if (lane == 0 && c) atomicAdd(&s.count, c);
    __syncthreads();
    ge = s.count;
  }
  if (tid < P) {
    float v = -INFINITY;
    int cand;
    if (tid < found) {
      const int slot = sel[tid];
      v = b.sc[slot];
      cand = cand_of(b, K, slot);
    } else {
      // the (tid - found)-th unmatched candidate: the last bucket k with
      // 32k - off[k] unmatched before it at most that rank
      const int j = tid - found;
      int lo = 0, hi = K - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (32 * mid - b.off[mid] <= j) lo = mid;
        else hi = mid - 1;
      }
      cand = lo * 32 + nth_set_bit(~b.mw[lo], j - (32 * lo - b.off[lo]));
    }
    const int bk = min(b.bucket[cand >> 5], big - 1);
    psc[q * P + tid] = v;
    plane[q * P + tid] = (bk + bucket_off) * 32 + (cand & 31);
  }
  if (tid == 0) {
    n_ge[q] = ge;
    found_out[q] = found;
  }
}

__global__ void __launch_bounds__(THREADS)
exact_fold_kernel(Pools p, int per, const float* c_psc, const int32_t* c_plane,
                  float* part_sc, int32_t* part_lane, int32_t* part_found) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ topk::Scratch s;
  __shared__ Terms tm;
  __shared__ __align__(16) float pg_sc[P];   // the carried page
  __shared__ int pg_lane[P];
  __shared__ int sel[P];
  const int q = blockIdx.x;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int tid = threadIdx.x;
  const int nb = p.nblk * NW;
  const int b0 = min(split * per, nb);
  const int b1 = min(b0 + per, nb);
  const Bufs b = carve(dyn, CH, p.T);
  if (tid < 32) load_terms(p, q, tm);
  if (tid < P) {
    const bool given = split == 0 && c_psc != nullptr;
    pg_sc[tid] = given ? c_psc[q * P + tid] : -INFINITY;
    pg_lane[tid] = given ? c_plane[q * P + tid] : 0;
  }
  int total = 0;
  for (int cb = b0; cb < b1; cb += CH) {
    const int nk = min(CH, b1 - cb);
    if (tid < nk) b.bucket[tid] = cb + tid;
    const int nf = score_buckets(p, tm, q, nk, b, s.wsum[0]);
    total += nf;
    const float theta = pg_sc[P - 1];
    int beats = 0;
    for (int i = tid; i < nf; i += THREADS) beats |= b.sc[i] > theta;
    if (__syncthreads_or(beats)) {
      const int n = P + nf;
      topk::select_topk<THREADS>(
          [&](int i0, uint32_t (&key)[4]) {
            if (i0 < P) topk::keys4(pg_sc, i0, P, key);
            else topk::keys4(b.sc, i0 - P, nf, key);
          },
          n, P, topk::desc_key(theta), sel, s);
      float v = 0.0f;
      int l = 0;
      if (tid < P) {
        const int c = sel[tid];
        if (c < P) {
          v = pg_sc[c];
          l = pg_lane[c];
        } else {
          v = b.sc[c - P];
          const int cand = cand_of(b, nk, c - P);
          l = (cb + (cand >> 5)) * 32 + (cand & 31);
        }
      }
      __syncthreads();
      if (tid < P) {
        pg_sc[tid] = v;
        pg_lane[tid] = l;
      }
    }
  }
  __syncthreads();
  const size_t at = (static_cast<size_t>(q) * nsplit + split) * P;
  if (tid < P) {
    part_sc[at + tid] = pg_sc[tid];
    part_lane[at + tid] = pg_lane[tid];
  }
  if (tid == 0) part_found[q * nsplit + split] = total;
}

__global__ void __launch_bounds__(THREADS)
fold_merge_kernel(const float* part_sc, const int32_t* part_lane,
                  const int32_t* part_found, int nsplit, float* psc,
                  int32_t* plane, int32_t* found) {
  __shared__ topk::Scratch s;
  __shared__ int sel[P];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = nsplit * P;
  const size_t at = static_cast<size_t>(q) * n;
  const float* row = part_sc + at;
  topk::select_topk<THREADS>(
      [&](int i0, uint32_t (&key)[4]) { topk::keys4(row, i0, n, key); }, n,
      P, 0xFFFFFFFFu, sel, s);
  if (tid < P) {
    const int c = sel[tid];
    psc[q * P + tid] = row[c];
    plane[q * P + tid] = part_lane[at + c];
  }
  if (tid == 0) {
    int f = 0;
    for (int i = 0; i < nsplit; ++i) f += part_found[q * nsplit + i];
    found[q] = f;
  }
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

// Lets `kernel` take `bytes` of dynamic shared memory: beside its static
// shared memory (under 16 KB) more than 32 KB must be asked for, and it asks
// for the most it can ever take (`most`), the same on every call.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t most) {
  if (bytes <= 32 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(most));
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
  const size_t smem = bufs_bytes(K, T);
  auto kernel = K <= 64 ? rescore_page_kernel<MINB_SMALL>
                        : rescore_page_kernel<MINB_LARGE>;
  const cudaError_t err = allow_smem(kernel, smem, bufs_bytes(KMAX, TMAX));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<Bq, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
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
  const size_t smem = bufs_bytes(CH, T);
  cudaError_t err =
      allow_smem(exact_fold_kernel, smem, bufs_bytes(CH, TMAX));
  if (err != cudaSuccess) return static_cast<int>(err);
  exact_fold_kernel<<<dim3(Bq, nsplit), THREADS, smem, st>>>(
      p, per, static_cast<const float*>(c_psc),
      static_cast<const int32_t*>(c_plane), static_cast<float*>(part_sc),
      static_cast<int32_t*>(part_lane), static_cast<int32_t*>(part_found));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_merge_kernel<<<Bq, THREADS, 0, st>>>(
      static_cast<const float*>(part_sc),
      static_cast<const int32_t*>(part_lane),
      static_cast<const int32_t*>(part_found), nsplit,
      static_cast<float*>(psc), static_cast<int32_t*>(plane),
      static_cast<int32_t*>(found));
  return static_cast<int>(cudaGetLastError());
}

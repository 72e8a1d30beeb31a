// Block-wide exact top-k selection in shared memory, shared by the WAND
// rescore-and-page kernel (wand_rescore.cu, K5) and the rung-selection
// kernel (wand_rungs.cu, K6).
//
// Every selection of phases 2-4 of the WAND route orders its candidates by
// (value desc, candidate index asc): the order of a stable descending sort,
// which is what the plain versions (torch.sort(stable=True)) and the
// reference (lax.top_k) give.  A value maps to a 32-bit key that is smaller
// for a larger float (desc_key; -0 and +0 share a key, as a float compare
// ties them), so the selection takes the k smallest (key, index) pairs.
//
// What bounds it on an H100: the passes over the candidates and the block
// barriers between them.  The first version made four 8-bit radix passes
// over every candidate, two more over the indices when the k-th key's
// class was cut, a gather pass and a k^2 rank count, each pass ending in
// three barriers.  select_topk reads each candidate twice where it can:
//   * one histogram pass over the leading 11 bits of the key (2,048 bins)
//     finds the bin of the k-th candidate and the rank r it needs there;
//   * one compaction pass keeps, in candidate order (a block-wide prefix
//     scan a tile of 4 * NT candidates, one barrier a tile), every
//     candidate below that bin (fewer than k) and the first KEPT of the
//     bin, and the bin's least and largest key;
//   * the bin is done when it and the candidates below it are at most
//     KEPT (all of them are kept), or when it holds one key (the -inf
//     class, a tie class): then the first r of it in candidate order are
//     the winners;
//   * only a bin that mixes keys and overflows refines: the same two passes
//     on the next 11 bits of the key among the bin's candidates, then on
//     the last 10 (a bin of one key);
//   * one warp orders the kept candidates (at most KEPT = 128) by a
//     bitonic sort in its registers, with shuffles and no block barrier
//     (a block-wide sort in shared memory took a barrier a stage: more
//     than the passes themselves; and a warp's sort of 256, eight entries
//     a lane, costs more than a refinement over candidates in shared
//     memory).
// A warp none of whose candidates of a tile can count (above the cut, or
// outside the bin a later pass refines) skips the tile's counting and its
// scan work.  A histogram pass counts through shared-memory atomics:
// the lanes of a warp that share the first counting lane's digit with one
// atomic, then those that share the next one's (the -inf lanes and one
// class of values, say), then one atomic a lane.  A caller may pass `cut`,
// a key that at least k candidates do not exceed: a candidate above it
// cannot be among the k and no pass counts or keeps it.  Beside the
// select, bin_cut gives a cut from two
// histogram passes (the top of the 22-bit bin that holds the k-th key) and
// gather keeps the candidates under a cut in candidate order (K6 uses both
// to sort a short list in place of a select).
//
// ops/wand_rungs.radix_topk_ref restates this procedure in numpy, pass for
// pass; the CPU tests hold it against the plain versions.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace topk {

constexpr int KMAX = 72;       // most entries a selection returns (65 used)
constexpr int BINS = 2048;     // bins of a histogram pass: an 11-bit digit
constexpr int KEPT = 128;      // most candidates a selection sorts
static_assert(KEPT >= KMAX, "a tie class's first r fit the kept");
constexpr int NONE = 1 << 30;  // the digit of a candidate a pass skips
constexpr int SORT_MAX = 256;  // most pairs one warp's sort takes

struct Scratch {
  union {
    int hist[BINS];
    struct {                   // [0, KMAX) below the bin, then the bin's
      uint32_t key[KMAX + KEPT];
      int idx[KMAX + KEPT];
    } buf;
  };
  int wsum[2][16];             // block scans' warp totals, two in turn
  int bin;                     // the digit a pass settled on
  int rem;                     // rank still needed within that digit's bin
  int eq;                      // candidates in that bin
  uint32_t bmin, bmax;         // the least and largest key in that bin
  int count;                   // a caller's counter
};

// A key that is smaller for a larger float; -0 maps to +0's key.
__device__ __forceinline__ uint32_t desc_key(float f) {
  uint32_t b = __float_as_uint(f);
  if (b == 0x80000000u) b = 0u;
  const uint32_t ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ~ord;
}

// The keys of x[i0, i0 + 4) into key (those at n or past it untouched), as
// one 16-byte load where x + i0 is aligned and all four are below n.
__device__ __forceinline__ void keys4(const float* x, int i0, int n,
                                      uint32_t (&key)[4]) {
  if (i0 + 4 <= n && (reinterpret_cast<uintptr_t>(x + i0) & 15u) == 0u) {
    const float4 v = *reinterpret_cast<const float4*>(x + i0);
    key[0] = desc_key(v.x);
    key[1] = desc_key(v.y);
    key[2] = desc_key(v.z);
    key[3] = desc_key(v.w);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i0 + j < n) key[j] = desc_key(x[i0 + j]);
  }
}

// Adds one for each lane of the warp to hist[d]; a lane with d >= BINS
// counts nothing.  The lanes that share the first counting lane's digit
// add with one atomic, then those that share the next remaining lane's
// (the -inf candidates of a rung and one class of values, say), then each
// remaining lane adds its own.  All 32 lanes must call it together.
__device__ __forceinline__ void warp_count(int* hist, int d) {
  const int lane = threadIdx.x & 31;
  unsigned act = __ballot_sync(0xffffffffu, d < BINS);
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    if (act == 0u) return;
    const int lead = __ffs(act) - 1;
    const int d0 = __shfl_sync(0xffffffffu, d, lead);
    const unsigned same =
        __ballot_sync(0xffffffffu, ((act >> lane) & 1u) && d == d0);
    if (lane == lead) atomicAdd(&hist[d0], __popc(same));
    act &= ~same;
  }
  if ((act >> lane) & 1u) atomicAdd(&hist[d], 1);
}

// The exclusive prefix of v over the block's threads in thread order, and
// the block's total.  Every thread calls it; it has one barrier, so two
// scans in a row take the two halves of Scratch::wsum in turn (a thread
// may still read one half while another writes the other).
template <int NT>
__device__ __forceinline__ int block_scan(int v, int& total, int* wsum) {
  static_assert(NT / 32 <= 16, "warp totals");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
  if (__ballot_sync(0xffffffffu, v != 0) != 0u) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const int x = wsum[w];
    if (w < warp) before += x;
    total += x;
  }
  return before + incl - v;
}

// The bin of the histogram that holds the rem-th candidate (1-based), the
// rank within it and the bin's count, into s.bin, s.rem and s.eq.  Every
// thread calls it; it ends with a barrier.
template <int NT>
__device__ __forceinline__ void pick_bin(Scratch& s, int rem, int* wsum) {
  constexpr int PER = BINS / NT;
  const int t = threadIdx.x;
  int c[PER];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    c[j] = s.hist[t * PER + j];
    sum += c[j];
  }
  int total;
  const int excl = block_scan<NT>(sum, total, wsum);
  if (excl < rem && rem <= excl + sum) {
    int r = rem - excl;
    int bin = -1, eq = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (bin < 0) {
        if (r <= c[j]) {
          bin = j;
          eq = c[j];
        } else {
          r -= c[j];
        }
      }
    }
    s.bin = t * PER + bin;
    s.rem = r;
    s.eq = eq;
  }
  __syncthreads();
}

// One bitonic stage between the E entries a lane holds: pairs (e, e ^ S).
template <int S, int E>
__device__ __forceinline__ void sort_in_lane(uint32_t (&k)[E], int (&x)[E],
                                             int size) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int f = e ^ S;
    if (f > e) {
      const bool up = ((lane * E + e) & size) == 0;
      const bool gt = k[e] > k[f] || (k[e] == k[f] && x[e] > x[f]);
      if (gt == up) {
        const uint32_t tk = k[e];
        k[e] = k[f];
        k[f] = tk;
        const int tx = x[e];
        x[e] = x[f];
        x[f] = tx;
      }
    }
  }
}

// Sorts the 32 * E pairs (k, x) a warp holds, entry lane * E + e in lane's
// k[e], x[e], ascending by k, then x: a bitonic sort in registers, across
// lanes by shuffles.  All 32 lanes call it.
template <int E>
__device__ __forceinline__ void warp_sort(uint32_t (&k)[E], int (&x)[E]) {
  static_assert(E == 1 || E == 2 || E == 4 || E == 8, "entries a lane");
  const int lane = threadIdx.x & 31;
  for (int size = 2; size <= 32 * E; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= E) {
        const int ls = stride / E;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = lane * E + e;
          const uint32_t ok = __shfl_xor_sync(0xffffffffu, k[e], ls);
          const int ox = __shfl_xor_sync(0xffffffffu, x[e], ls);
          const bool up = (i & size) == 0;
          const bool lower = (i & stride) == 0;
          const bool gt = k[e] > ok || (k[e] == ok && x[e] > ox);
          if (lower == up ? gt : !gt) {
            k[e] = ok;
            x[e] = ox;
          }
        }
      } else if (stride == 4) {
        sort_in_lane<4 % E, E>(k, x, size);
      } else if (stride == 2) {
        sort_in_lane<2 % E, E>(k, x, size);
      } else {
        sort_in_lane<1 % E, E>(k, x, size);
      }
    }
  }
}

// One warp's sort of the m <= 32 * E pairs get(i) -> (key, idx), i < m,
// into out[0, k) (k <= m): the first k indices in (key, idx) order.
template <int E, class Get>
__device__ __forceinline__ void warp_sort_first(Get get, int m, int k,
                                                int* out) {
  const int lane = threadIdx.x & 31;
  uint32_t key[E];
  int idx[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    key[e] = 0xFFFFFFFFu;
    idx[e] = 0x7FFFFFFF;
    if (i < m) get(i, key[e], idx[e]);
  }
  warp_sort<E>(key, idx);
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane * E + e < k) out[lane * E + e] = idx[e];
}

// Warp 0 sorts the m <= SORT_MAX pairs get(i) and writes the first k
// indices to out, with as few entries a lane as m allows; the other warps
// wait at the barrier it ends with.  Every thread calls it.
template <class Get>
__device__ __forceinline__ void sort_first(Get get, int m, int k, int* out) {
  if (threadIdx.x < 32) {
    if (m <= 64) warp_sort_first<2>(get, m, k, out);
    else if (m <= 128) warp_sort_first<4>(get, m, k, out);
    else warp_sort_first<8>(get, m, k, out);
  }
  __syncthreads();
}

// One histogram pass: the count of every candidate i < n whose key is at
// most cut and matches prefix under mask, by the digit (key >> shift) &
// dmask, into s.hist.  Every thread calls it; it begins and ends with a
// barrier.
template <int NT, class Load4>
__device__ void hist_pass(Load4 load4, int n, uint32_t cut, uint32_t prefix,
                          uint32_t mask, int shift, uint32_t dmask,
                          Scratch& s) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int i = tid; i < BINS; i += NT) s.hist[i] = 0;
  __syncthreads();
  for (int base = 0; base < n; base += 4 * NT) {
    const int i0 = base + 4 * tid;
    uint32_t key[4];
    if (i0 < n) load4(i0, key);
    int d[4];
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d[j] = NONE;
      if (i0 + j < n && key[j] <= cut && (key[j] & mask) == prefix) {
        d[j] = static_cast<int>((key[j] >> shift) & dmask);
        any = true;
      }
    }
    if (__ballot_sync(0xffffffffu, any) == 0u) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) warp_count(s.hist, d[j]);
  }
  __syncthreads();
}

// A cut for the k smallest keys of candidates i < n: the largest key of
// the bin of the key's first 22 bits that holds the k-th (at least k keys
// do not exceed it).  Two histogram passes, over the first 11 bits, then
// over the next 11 of that bin's keys; every thread calls it and gets the
// same key; it ends with a barrier.
template <int NT, class Load4>
__device__ uint32_t bin_cut(Load4 load4, int n, int k, Scratch& s) {
  hist_pass<NT>(load4, n, 0xFFFFFFFFu, 0u, 0u, 21, 0x7FFu, s);
  pick_bin<NT>(s, k, s.wsum[0]);
  const uint32_t prefix = static_cast<uint32_t>(s.bin) << 21;
  const int rem = s.rem;
  hist_pass<NT>(load4, n, 0xFFFFFFFFu, prefix, 0xFFE00000u, 10, 0x7FFu, s);
  pick_bin<NT>(s, rem, s.wsum[1]);
  return prefix | (static_cast<uint32_t>(s.bin) << 10) | 0x3FFu;
}

// The candidates i < n whose key is at most cut, in candidate order:
// their keys and indices into lkey / lidx, the first cap of them.
// Returns their count (all of them, past cap too).  Every thread calls it
// and gets the same count; it ends with a barrier.
template <int NT, class Load4>
__device__ int gather(Load4 load4, int n, uint32_t cut, uint32_t* lkey,
                      int* lidx, int cap, Scratch& s) {
  const int tid = threadIdx.x;
  int count = 0, half = 0;
  __syncthreads();
  for (int base = 0; base < n; base += 4 * NT) {
    const int i0 = base + 4 * tid;
    uint32_t key[4];
    if (i0 < n) load4(i0, key);
    unsigned f = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i0 + j < n && key[j] <= cut) f |= 1u << j;
    int tot;
    int at = count + block_scan<NT>(__popc(f), tot, s.wsum[half]);
    half ^= 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((f >> j) & 1u) {
        if (at < cap) {
          lkey[at] = key[j];
          lidx[at] = i0 + j;
        }
        ++at;
      }
    }
    count += tot;
  }
  __syncthreads();
  return count;
}

// The k smallest (key, i) of the candidates i in [0, n) whose key is at
// most cut, ordered, into out[0, k) (shared memory).  load4(i0, key) puts
// the keys of candidates i0 .. i0 + 3 (i0 a multiple of 4) into key; it
// may leave those at n or past it alone.  Needs 1 <= k <= KMAX and at
// least k candidates with key <= cut.  Every thread of the block calls it;
// it begins and
// ends with a barrier, so the caller's shared writes before it are visible
// and out is ready after it.
template <int NT, class Load4>
__device__ void select_topk(Load4 load4, int n, int k, uint32_t cut,
                            int* out, Scratch& s) {
  static_assert(BINS % NT == 0 && NT % 32 == 0 && NT <= 512, "block");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t prefix = 0u, mask = 0u;
  int rem = k;
  int below = 0, take = 0;
  int half = 0;                       // the half of s.wsum a scan takes
  for (int level = 0; level < 3; ++level) {
    const int shift = level == 0 ? 21 : (level == 1 ? 10 : 0);
    const uint32_t dmask = level == 2 ? 0x3FFu : 0x7FFu;
    hist_pass<NT>(load4, n, cut, prefix, mask, shift, dmask, s);
    pick_bin<NT>(s, rem, s.wsum[half]);
    half ^= 1;
    const int eq = s.eq;
    rem = s.rem;
    prefix |= static_cast<uint32_t>(s.bin) << shift;
    mask |= dmask << shift;
    const uint32_t lo = prefix, hi = prefix | ~mask;
    if (tid == 0) {
      s.bmin = 0xFFFFFFFFu;
      s.bmax = 0u;
    }
    // compaction in candidate order: below the bin into buf[0, KMAX), the
    // bin's first KEPT into buf[KMAX, KMAX + KEPT)
    int ca = 0, cb = 0;
    uint32_t bmin = 0xFFFFFFFFu, bmax = 0u;
    for (int base = 0; base < n; base += 4 * NT) {
      const int i0 = base + 4 * tid;
      uint32_t key[4];
      if (i0 < n) load4(i0, key);
      unsigned fa = 0u, fb = 0u;
      int na = 0, nb = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i0 + j < n && key[j] <= cut) {
          if (key[j] < lo) {
            fa |= 1u << j;
            ++na;
          } else if (key[j] <= hi) {
            fb |= 1u << j;
            ++nb;
            bmin = min(bmin, key[j]);
            bmax = max(bmax, key[j]);
          }
        }
      }
      int tot;
      const int ex = block_scan<NT>(na | (nb << 16), tot, s.wsum[half]);
      half ^= 1;
      int pa = ca + (ex & 0xFFFF);
      int pb = cb + (ex >> 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((fa >> j) & 1u) {
          s.buf.key[pa] = key[j];
          s.buf.idx[pa] = i0 + j;
          ++pa;
        }
        if ((fb >> j) & 1u) {
          if (pb < KEPT) {
            s.buf.key[KMAX + pb] = key[j];
            s.buf.idx[KMAX + pb] = i0 + j;
          }
          ++pb;
        }
      }
      ca += tot & 0xFFFF;
      cb += tot >> 16;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      bmin = min(bmin, __shfl_xor_sync(0xffffffffu, bmin, off));
      bmax = max(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
    }
    if (lane == 0) {
      atomicMin(&s.bmin, bmin);
      atomicMax(&s.bmax, bmax);
    }
    __syncthreads();
    below = ca;
    if (ca + eq <= KEPT || s.bmin == s.bmax) {
      take = ca + eq <= KEPT ? eq : rem;
      break;
    }
  }
  // the kept candidates: buf[0, below), then buf[KMAX, KMAX + take)
  sort_first(
      [&](int i, uint32_t& key, int& idx) {
        const int at = i < below ? i : KMAX + i - below;
        key = s.buf.key[at];
        idx = s.buf.idx[at];
      },
      below + take, k, out);
}

}  // namespace topk

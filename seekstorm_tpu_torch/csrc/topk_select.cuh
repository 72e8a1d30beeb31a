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
// select_topk finds them with an MSB-first radix select: four passes over
// the key's bytes narrow the k-th smallest key T and the rank r it needs
// among the candidates whose key equals T; when fewer than all of those are
// taken, two more passes over the index bytes find the r-th smallest index
// among them.  A final pass gathers the k winners (key < T, or key == T and
// index at most that bound) and a rank count orders them.  Each pass
// histograms 256 digits with shared-memory atomics, one for a warp whose
// counting lanes share a digit: most candidates of a page are unmatched
// and share the key of -inf, which would otherwise serialise on one
// counter.  A caller may pass `cut`, a key that at least k
// candidates do not exceed: candidates above it cannot be among the k and
// are skipped by every pass.
//
// ops/wand_rungs.radix_topk_ref restates this procedure in numpy, pass for
// pass; the CPU tests hold it against the plain versions.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace topk {

constexpr int KMAX = 72;     // most entries a selection returns (65 used)

struct Scratch {
  int hist[256];
  int bin;                   // the digit a pass settled on
  int rem;                   // rank still needed within that digit's bin
  int eq;                    // candidates in that bin
  int count;                 // winners gathered so far
  uint32_t sel_key[KMAX];
  int sel_idx[KMAX];
};

// A key that is smaller for a larger float; -0 maps to +0's key.
__device__ __forceinline__ uint32_t desc_key(float f) {
  uint32_t b = __float_as_uint(f);
  if (b == 0x80000000u) b = 0u;
  const uint32_t ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ~ord;
}

// Adds one for each lane of the warp to hist[d]; a lane with d >= 256
// counts nothing.  Where every counting lane has the same digit (the -inf
// candidates of a page, a class of ties) one atomic adds them all; else
// each lane adds its own.  All 32 lanes must call it together.
__device__ __forceinline__ void warp_count(int* hist, int d) {
  const int lane = threadIdx.x & 31;
  const bool live = d < 256;
  const unsigned act = __ballot_sync(0xffffffffu, live);
  if (act == 0u) return;
  const int lead = __ffs(act) - 1;
  const int d0 = __shfl_sync(0xffffffffu, d, lead);
  if (__ballot_sync(0xffffffffu, live && d == d0) == act) {
    if (lane == lead) atomicAdd(&hist[d0], __popc(act));
  } else if (live) {
    atomicAdd(&hist[d], 1);
  }
}

// Warp 0: the digit whose bin holds the rem-th candidate (1-based) of the
// histogram, and the rank within it.
__device__ __forceinline__ void pick_bin(Scratch& s, int rem) {
  const int lane = threadIdx.x & 31;
  int c[8];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = s.hist[lane * 8 + j];
    sum += c[j];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const int excl = incl - sum;
  if (excl < rem && rem <= incl) {
    int r = rem - excl;
    int j = 0;
    while (j < 7 && r > c[j]) {
      r -= c[j];
      ++j;
    }
    s.bin = lane * 8 + j;
    s.rem = r;
    s.eq = c[j];
  }
}

// The k smallest (key_of(i), i) of i in [0, n), ordered, into out[0, k)
// (shared memory).  Needs 1 <= k <= KMAX, k <= n <= 65536, and at least k
// candidates with key <= cut.  Every thread of the block calls it; it
// begins and ends with a barrier, so the caller's shared writes before it
// are visible and out is ready after it.
template <int NT, class KeyOf>
__device__ void select_topk(KeyOf key_of, int n, int k, uint32_t cut,
                            int* out, Scratch& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) s.count = 0;
  uint32_t prefix = 0, mask = 0;
  int rem = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += NT) s.hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += NT) {
      const int i = base + tid;
      int d = 256 + lane;
      if (i < n) {
        const uint32_t key = key_of(i);
        if (key <= cut && (key & mask) == prefix)
          d = static_cast<int>((key >> shift) & 0xFFu);
      }
      warp_count(s.hist, d);
    }
    __syncthreads();
    if (tid < 32) pick_bin(s, rem);
    __syncthreads();
    prefix |= static_cast<uint32_t>(s.bin) << shift;
    mask |= 0xFFu << shift;
    rem = s.rem;
  }
  // the largest index taken among the candidates whose key is prefix
  int ilim = 0x7FFFFFFF;
  if (rem < s.eq) {
    uint32_t ipre = 0, imask = 0;
    for (int shift = 8; shift >= 0; shift -= 8) {
      __syncthreads();
      for (int i = tid; i < 256; i += NT) s.hist[i] = 0;
      __syncthreads();
      for (int base = 0; base < n; base += NT) {
        const int i = base + tid;
        int d = 256 + lane;
        if (i < n && key_of(i) == prefix &&
            (static_cast<uint32_t>(i) & imask) == ipre)
          d = (i >> shift) & 0xFF;
        warp_count(s.hist, d);
      }
      __syncthreads();
      if (tid < 32) pick_bin(s, rem);
      __syncthreads();
      ipre |= static_cast<uint32_t>(s.bin) << shift;
      imask |= 0xFFu << shift;
      rem = s.rem;
    }
    ilim = static_cast<int>(ipre);
  }
  for (int i = tid; i < n; i += NT) {
    const uint32_t key = key_of(i);
    if (key < prefix || (key == prefix && i <= ilim)) {
      const int slot = atomicAdd(&s.count, 1);
      if (slot < KMAX) {
        s.sel_key[slot] = key;
        s.sel_idx[slot] = i;
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < k; j += NT) {
    const uint32_t kj = s.sel_key[j];
    const int ij = s.sel_idx[j];
    int r = 0;
    for (int m = 0; m < k; ++m) {
      const uint32_t km = s.sel_key[m];
      r += (km < kj || (km == kj && s.sel_idx[m] < ij)) ? 1 : 0;
    }
    out[r] = ij;
  }
  __syncthreads();
}

}  // namespace topk

// Dense impact-path block scan (K2) for Hopper.
//
// Replaces the XLA program seekstorm_tpu/ops/lexical.py::_block_step_imp
// (363-476) as lexical_scan_imp (486-565) and lexical_scan_qt (592-667) run
// it, with the per-block match count of lexical_scan_imp (530-531).  The
// reference decodes a whole 64K-doc block for the whole query batch with
// one-hot matmuls and scores it as S = W @ D, C = Mreq @ (D > 0): B * V *
// 64K multiply-adds per block and matrix, for a query's few postings.
//
// K2 works on a (block, query) pair list instead (plan.py).  For pair p
// (block b, query q) and the docs d of the block it computes, over q's
// slots t in ascending slot id,
//   S[d] = sum_t w_t * imp_t(d)  over the CSR-remainder postings
//          + (sum_t w_t over the bitmap slots with bit d set) * sat1[d]
//   R[d] = number of required slots with a posting at d
//   N[d] = some negated slot has a posting at d
//   matched = S > 0 & R >= nreq & !N & !deleted
//   out[p, d] = matched ? S : -inf,   cnt[q] += popcount(matched)
//
// What bounds it on an H100: bytes.  A pair reads its query's postings in
// the block (2 + 4 bytes each), 8 KB of delete words and 256 KB of sat1
// (shared by every pair of the block: the pair list is block-major, so L2
// serves it), and writes 256 KB of masked scores; the arithmetic is one
// fma per posting.  The design keeps the score, bitmap-weight and flag
// accumulators of a window of docs in shared memory (no [B, V, 64K] decode
// in device memory), finds the window's run of each sorted posting segment
// by binary search, reads bitmap words once per warp, and writes the masked
// scores coalesced.  The 256 KB per pair written out is the floor of this
// design until a later kernel fuses the top-k.
//
// One CTA scores one (pair, window of WIN docs).  Slots run one after
// another with a __syncthreads() between them: within one (slot, block)
// segment docids are unique, so threads never race on a doc, and the CSR
// remainder and the bitmap of a slot hold disjoint docs
// (lexindex._dev_pass).
//
// Numerics: the sums are formed as the reference forms them on the CPU:
// S = W @ D + (W_b @ E) * sat1 (lexical.py:436-458), the matmul a fused
// multiply-add chain in ascending slot id and the bitmap term one more fma.
// K2 writes each step as an explicit __fmaf_rn (and the bitmap weights as
// __fadd_rn), so nothing is left to the compiler's contraction, and it is
// bit-exact against the plain version (dense_scan_ref), which emulates fma
// exactly.  Counts are integer atomics, whose sum is order-free.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_DOCS = 65536;          // docs per 64K block
constexpr int WIN = 4096;                  // docs per CTA (36 KB smem)
constexpr int NWIN = BLOCK_DOCS / WIN;
constexpr int NWORDS = BLOCK_DOCS / 32;    // u32 words per block bitmap
constexpr int THREADS = 256;
constexpr int FLAG_REQ = 1;
constexpr int FLAG_NEG = 2;
constexpr uint8_t NEG_BIT = 0x80;          // st[d]: bit 7 negated hit,
                                           // bits 0-6 required hits

__device__ __forceinline__ int64_t lower_bound_doc(
    const uint16_t* __restrict__ docid, int64_t lo, int64_t hi, int key) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int>(docid[mid]) < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
dense_scan_kernel(const uint16_t* __restrict__ docid,   // [Pc]
                  const float* __restrict__ imp,        // [Pc]
                  const uint32_t* __restrict__ bitmaps, // [NBM, NWORDS]
                  const float* __restrict__ sat1,       // [NBLK * 64K]
                  const uint32_t* __restrict__ delw,    // [NBLK, NWORDS]
                  const int32_t* __restrict__ p_blk,    // [P] global block
                  const int32_t* __restrict__ p_q,      // [P] batch row
                  const int32_t* __restrict__ p_nreq,   // [P]
                  const int64_t* __restrict__ s_off,    // [P, T]
                  const int32_t* __restrict__ s_len,    // [P, T]
                  const int32_t* __restrict__ s_bm,     // [P, T]
                  const float* __restrict__ s_w,        // [P, T]
                  const int32_t* __restrict__ s_flag,   // [P, T]
                  int T,
                  float* __restrict__ out,              // [P, 64K]
                  int32_t* __restrict__ cnt) {          // [B], accumulated
  __shared__ float sc[WIN];       // CSR-remainder score chain
  __shared__ float wb[WIN];       // sum of the weights of bitmap hits
  __shared__ uint8_t st[WIN];
  __shared__ int64_t range[2];
  __shared__ int warp_cnt[THREADS / 32];

  const float ninf = __int_as_float(0xff800000);
  const int p = blockIdx.x;
  const int base = blockIdx.y * WIN;
  const int tid = threadIdx.x;
  const int blk = p_blk[p];

  for (int i = tid; i < WIN; i += THREADS) {
    sc[i] = 0.f;
    wb[i] = 0.f;
    st[i] = 0;
  }

  for (int t = 0; t < T; ++t) {
    const int64_t e = static_cast<int64_t>(p) * T + t;
    const int len = s_len[e];
    const int bm = s_bm[e];
    const float w = s_w[e];
    const int fl = s_flag[e];
    const uint8_t inc = (fl & FLAG_REQ) ? 1 : 0;
    const uint8_t negb = (fl & FLAG_NEG) ? NEG_BIT : 0;
    if (len > 0) {  // uniform over the CTA
      if (tid < 2) {
        const int64_t off = s_off[e];
        range[tid] = lower_bound_doc(docid, off, off + len, base + tid * WIN);
      }
      __syncthreads();  // range ready; the previous slot's updates done
      const int64_t hi = range[1];
      for (int64_t i = range[0] + tid; i < hi; i += THREADS) {
        const int d = static_cast<int>(docid[i]) - base;
        sc[d] = __fmaf_rn(w, imp[i], sc[d]);
        st[d] = static_cast<uint8_t>(st[d] + inc) | negb;
      }
    }
    if (bm >= 0) {
      __syncthreads();
      const uint32_t* row =
          bitmaps + static_cast<int64_t>(bm) * NWORDS + base / 32;
      for (int i = tid; i < WIN; i += THREADS) {
        if ((row[i >> 5] >> (i & 31)) & 1u) {  // one word per warp
          wb[i] = __fadd_rn(wb[i], w);
          st[i] = static_cast<uint8_t>(st[i] + inc) | negb;
        }
      }
    }
    __syncthreads();
  }

  const float* s1 = sat1 + static_cast<int64_t>(blk) * BLOCK_DOCS + base;
  const int nreq = p_nreq[p];
  const uint32_t* dw = delw + static_cast<int64_t>(blk) * NWORDS + base / 32;
  float* o = out + static_cast<int64_t>(p) * BLOCK_DOCS + base;
  int mine = 0;
  for (int i = tid; i < WIN; i += THREADS) {
    const float s = __fmaf_rn(wb[i], s1[i], sc[i]);
    const uint8_t f = st[i];
    const bool del = (dw[i >> 5] >> (i & 31)) & 1u;
    const bool m = s > 0.f && static_cast<int>(f & 0x7f) >= nreq &&
                   !(f & NEG_BIT) && !del;
    o[i] = m ? s : ninf;
    mine += m ? 1 : 0;
  }
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((tid & 31) == 0) warp_cnt[tid >> 5] = mine;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int i = 0; i < THREADS / 32; ++i) total += warp_cnt[i];
    if (total) atomicAdd(&cnt[p_q[p]], total);
  }
}

}  // namespace

// Scores P pairs of T slot columns.  Returns cudaGetLastError() after the
// launch (0 when P == 0 and nothing is launched).
extern "C" int dense_scan_launch(const void* docid, const void* imp,
                                 const void* bitmaps, const void* sat1,
                                 const void* delw, const void* p_blk,
                                 const void* p_q, const void* p_nreq,
                                 const void* s_off, const void* s_len,
                                 const void* s_bm, const void* s_w,
                                 const void* s_flag, int P, int T, void* out,
                                 void* cnt, void* stream) {
  if (P <= 0) return 0;
  const dim3 grid(P, NWIN);
  dense_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(docid), static_cast<const float*>(imp),
      static_cast<const uint32_t*>(bitmaps), static_cast<const float*>(sat1),
      static_cast<const uint32_t*>(delw), static_cast<const int32_t*>(p_blk),
      static_cast<const int32_t*>(p_q), static_cast<const int32_t*>(p_nreq),
      static_cast<const int64_t*>(s_off), static_cast<const int32_t*>(s_len),
      static_cast<const int32_t*>(s_bm), static_cast<const float*>(s_w),
      static_cast<const int32_t*>(s_flag), T, static_cast<float*>(out),
      static_cast<int32_t*>(cnt));
  return static_cast<int>(cudaGetLastError());
}

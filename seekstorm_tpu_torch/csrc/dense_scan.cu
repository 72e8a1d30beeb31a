// Dense impact-path block scan (K2) for Hopper, with its per-pair top-k.
//
// Replaces the XLA program seekstorm_tpu/ops/lexical.py::_block_step_imp
// (363-476) as lexical_scan_imp (486-565) and lexical_scan_qt (592-667) run
// it, with the per-block match count of lexical_scan_imp (530-531) and the
// per-block top-k of _topk_block (327-360).  The reference decodes a whole
// 64K-doc block for the whole query batch with one-hot matmuls and scores it
// as S = W @ D, C = Mreq @ (D > 0): B * V * 64K multiply-adds per block and
// matrix, for a query's few postings.
//
// K2 works on a (block, query) pair list instead (plan.py).  For pair p
// (block b, query q) and the docs d of the block it computes, over q's
// slots t in ascending slot id,
//   S[d] = sum_t w_t * imp_t(d)  over the CSR-remainder postings
//          + (sum_t w_t over the bitmap slots with bit d set) * sat1[d]
//   R[d] = number of required slots with a posting at d
//   N[d] = some negated slot has a posting at d
//   matched = S > 0 & R >= nreq & !N & !deleted,   cnt[q] += popcount(matched)
// and, by mode,
//   fused (kk <= KMAX): vals[p, :], docs[p, :] = the top-kk matched docs by
//       (S desc, doc asc), -inf / -1 past the last match;
//   unfused: out[p, d] = matched ? S : -inf for every doc (the caller takes
//       the top-k; used for kk > KMAX, deep pages, and for sorted results,
//       whose rank is a per-doc key and not S).
// In either mode it writes, on request, the packed matched words mwords
// [P, NWORDS] (bit j of word i: doc i*32 + j matched), which the facet
// histogram (csrc/facet_hist.cu) counts from: a faceted top-10 batch stays
// one launch of this kernel.
//
// What bounds it on an H100.  Unfused, the 256 KB of masked scores a pair
// writes.  Fused, nothing is written per doc: a pair reads its query's
// postings in the block (2 + 4 bytes each), the bitmap rows it names, the
// delete words and sat1 where a bitmap hit needs it, and writes kk * 12
// bytes, so the bytes are few and the time goes to the instructions and
// barriers spent per window and per occupied doc.  The design:
//
//  - Windows of WIN = 8,192 docs keep the CSR score chain and the hit flags
//    in shared memory (5 bytes a doc), with one occupancy bit a doc.  Large
//    windows matter most: each window costs every warp a fixed run of
//    loop, barrier and epilogue work (4,096- and 2,048-doc windows were
//    slower on the H100).
//  - A CTA walks its windows in doc order with one forward cursor per slot
//    into the slot's sorted posting segment; the chunk of 256 postings at
//    the cursor is applied where it lies in the window and the cursor
//    moves by __syncthreads_count.  No search per window.  The next
//    window's first chunk of slots 0-3 is loaded during the epilogue and
//    staged in shared memory.  A CTA that starts past doc 0 (split > 1)
//    finds its start by a warp-wide 32-ary search, once.
//  - The epilogue packs a warp's occupied docs (CSR occupancy OR the
//    bitmap rows' words) 32 to a step, so a doc without a posting costs
//    nothing; bitmap slots are folded in there, in slot order, straight
//    from their rows; sat1 is read only where a bitmap weight is set
//    (fma(0, sat1, c) = c); what was read is zeroed, so the accumulators
//    are cleared once per CTA.
//  - split CTAs can share one pair as a thread-block cluster (a launch
//    attribute): split = 1 is one CTA walking the 8 windows, split = 2, 4
//    or 8 spread them (for launches of few pairs, the WAND route's
//    stragglers).  Rank 0 merges the peers' candidates through distributed
//    shared memory.
//  - Selection: a matched doc's key (float bits << 16 | 65535 - doc) is
//    unique in the pair and orders as (S desc, doc asc), since S > 0.  Keys
//    above the running threshold are appended to a shared candidate buffer
//    in rounds of at most ROUND keys; when it could not take another round,
//    an exact MSB-first radix select (8-bit digits, warp-aggregated shared
//    histograms) keeps the top kk and raises the threshold below them.
//    The final <= kk keys are ranked by counting and written in order.  No
//    tie is left to chance.
//
// Slots run one after another with a barrier between them: within one
// (slot, block) segment docids are unique, so threads never race on a doc,
// and the CSR remainder and the bitmap of a slot hold disjoint docs
// (lexindex._dev_pass).
//
// Numerics: the sums are formed as the reference forms them on the CPU:
// S = W @ D + (W_b @ E) * sat1 (lexical.py:436-458), the matmul a fused
// multiply-add chain in ascending slot id and the bitmap term one more fma.
// K2 writes each step as an explicit __fmaf_rn (and the bitmap weights as
// __fadd_rn), so nothing is left to the compiler's contraction, and it is
// bit-exact against the plain versions (dense_scan_ref, dense_topk_ref),
// which emulate fma exactly.  Counts are integer atomics, whose sum is
// order-free.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCK_DOCS = 65536;          // docs per 64K block
constexpr int WIN = 8192;                  // docs per window
constexpr int NWIN = BLOCK_DOCS / WIN;
constexpr int WWORDS = WIN / 32;           // occupancy words per window
constexpr int NWORDS = BLOCK_DOCS / 32;    // u32 words per block bitmap
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SLOTS = 128;                 // slot tables (T <= 127)
constexpr int KMAX = 128;                  // the fused mode's largest kk
constexpr int CAP = 1024;                  // candidate keys a CTA holds
constexpr int ROUND = THREADS;             // keys an epilogue round adds
constexpr int PF = 4;                      // slots whose chunks are staged
constexpr int MIN_CTAS = 3;                // CTAs an SM (shared memory)
constexpr int KEY_BITS = 48;               // float bits << 16 | 65535 - doc
constexpr int UNFUSED_SPLIT = NWIN;        // CTAs a pair in the unfused mode
constexpr int FLAG_REQ = 1;
constexpr int FLAG_NEG = 2;
constexpr uint8_t NEG_BIT = 0x80;          // st[d]: bit 7 negated hit,
                                           // bits 0-6 required hits
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == 256, "one radix-select bin a thread");
constexpr int EPI = WWORDS / NWARPS;       // a window's words a warp
static_assert(WWORDS <= THREADS && EPI <= 32 && (EPI & (EPI - 1)) == 0,
              "a window's words: one a thread, a power of two <= 32 a warp");

// the dynamic shared memory of a CTA, in the order it is carved
template <bool FUSED>
constexpr size_t smem_bytes() {
  return SLOTS * (8 + 8 + 4 + 4 + 4 + 4)                   // slot tables
         + (FUSED ? CAP * 8 + KMAX * 8 + 256 * 4 : 0)      // selection
         + PF * THREADS * (4 + 2)                          // staged chunks
         + WIN * (4 + 1) + WWORDS * 4;                     // accumulators
}

struct Sel {
  uint64_t thresh;   // keys at or below it cannot reach the top kk
  int n_cand;        // keys in the candidate buffer
  int n_keep;
  int dig, above, cnt;
};

// First index in [lo, hi) of the sorted docids whose doc is >= key; the
// whole warp calls it with the same arguments.
__device__ int64_t warp_lower_bound(const uint16_t* __restrict__ docid,
                                    int64_t lo, int64_t hi, int key,
                                    int lane) {
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t piv = lo + (lane + 1) * step - 1;
    const bool less = piv < hi && static_cast<int>(docid[piv]) < key;
    const int c = __popc(__ballot_sync(FULL, less));
    const int64_t top = lo + (c + 1) * step;  // pivot c is not below key
    if (top < hi) hi = top;
    lo += c * step;
  }
  const bool less = lo + lane < hi && static_cast<int>(docid[lo + lane]) < key;
  return lo + __popc(__ballot_sync(FULL, less));
}

// The position of the n-th (from 0) set bit of w, n < popc(w).
__device__ __forceinline__ int nth_set_bit(uint32_t w, int n) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int c = __popc(w & ((1u << half) - 1u));
    if (n >= c) {
      n -= c;
      w >>= half;
      pos += half;
    }
  }
  return pos;
}

// Keeps the kk largest of the n > kk unique keys in cand[0, n), as
// cand[0, kk) in no order, and raises the threshold below them: an exact
// radix select, 8 bits a pass from the top, that stops at the first digit
// whose bin closes the top kk.  Every thread calls it.
__device__ void shrink(uint64_t* cand, uint64_t* keep, unsigned* hist,
                       Sel& sel, int kk, int tid, int lane, int warp) {
  const int n = sel.n_cand;
  uint64_t prefix = 0;
  int need = kk;
  int shift = KEY_BITS;
  for (;;) {
    shift -= 8;
    hist[tid] = 0;
    __syncthreads();
    for (int b = 0; b < n; b += THREADS) {
      const int i = b + tid;
      const uint64_t key = i < n ? cand[i] : 0;
      const bool in = i < n && (key >> (shift + 8)) == prefix;
      const unsigned dig = in ? static_cast<unsigned>(key >> shift) & 255u
                              : 256u;
      const unsigned peers = __match_any_sync(FULL, dig);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[dig], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {  // the bin holding the need-th key, from the top
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - 8 * lane - j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      int above = incl - sum;
      if (above < need && need <= incl) {
        for (int j = 0; j < 8; ++j) {
          if (above + c[j] >= need) {
            sel.dig = 255 - 8 * lane - j;
            sel.above = above;
            sel.cnt = c[j];
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
    prefix = (prefix << 8) | static_cast<uint64_t>(sel.dig);
    need -= sel.above;
    if (need == sel.cnt || shift == 0) break;
  }
  const uint64_t lower = prefix << shift;  // exactly kk keys are >= lower
  if (tid == 0) sel.n_keep = 0;
  __syncthreads();
  for (int i = tid; i < n; i += THREADS) {
    const uint64_t key = cand[i];
    if (key >= lower) {
      const int at = atomicAdd(&sel.n_keep, 1);
      if (at < KMAX) keep[at] = key;
    }
  }
  __syncthreads();
  if (tid < kk) cand[tid] = keep[tid];
  if (tid == 0) {
    sel.n_cand = kk;
    sel.thresh = lower - 1;
  }
  __syncthreads();
}

template <bool FUSED>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
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
                  int T, int split, int kk,
                  float* __restrict__ out,              // [P, 64K] unfused
                  float* __restrict__ vals,             // [P, kk] fused
                  int64_t* __restrict__ docs,           // [P, kk] fused
                  int32_t* __restrict__ cnt,            // [B], accumulated
                  uint32_t* __restrict__ mwords) {      // [P, NWORDS] or null
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Sel sel;
  __shared__ int warp_cnt[NWARPS];
  __shared__ uint32_t dws[2][WWORDS];  // delete words, a window ahead
  __shared__ int64_t stage_c[PF];      // the cursor of each staged chunk
  __shared__ int n_bms;                // slots with a bitmap row
  __shared__ uint32_t mws[WWORDS];     // the window's matched words (fused)

  int64_t* cur = reinterpret_cast<int64_t*>(smem);      // slot cursors
  int64_t* send = cur + SLOTS;                          // segment ends
  uint64_t* cand = reinterpret_cast<uint64_t*>(send + SLOTS);
  uint64_t* keep = cand + (FUSED ? CAP : 0);
  float* stage_v = reinterpret_cast<float*>(keep + (FUSED ? KMAX : 0));
  float* sw = stage_v + PF * THREADS;                   // slot weights
  int32_t* sbm = reinterpret_cast<int32_t*>(sw + SLOTS);
  int32_t* sfl = sbm + SLOTS;
  int32_t* bms = sfl + SLOTS;                           // the bitmap slots
  unsigned* hist = reinterpret_cast<unsigned*>(bms + SLOTS);
  float* sc = reinterpret_cast<float*>(hist + (FUSED ? 256 : 0));
  uint32_t* occ = reinterpret_cast<uint32_t*>(sc + WIN);
  uint16_t* stage_d = reinterpret_cast<uint16_t*>(occ + WWORDS);
  uint8_t* st = reinterpret_cast<uint8_t*>(stage_d + PF * THREADS);

  const float ninf = __int_as_float(0xff800000);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = blockIdx.x / split;
  const int rank = blockIdx.x % split;
  const int wins = NWIN / split;
  const int w0 = rank * wins;
  const int blk = p_blk[p];
  const int nreq = p_nreq[p];
  const float* s1 = sat1 + static_cast<int64_t>(blk) * BLOCK_DOCS;
  const uint32_t* dw = delw + static_cast<int64_t>(blk) * NWORDS;

  for (int t = tid; t < T; t += THREADS) {
    const int64_t e = static_cast<int64_t>(p) * T + t;
    cur[t] = s_off[e];
    send[t] = s_off[e] + s_len[e];
    sbm[t] = s_bm[e];
    sw[t] = s_w[e];
    sfl[t] = s_flag[e];
  }
  for (int i = tid; i < WIN; i += THREADS) sc[i] = 0.f;
  for (int i = tid; i < WIN / 4; i += THREADS)
    reinterpret_cast<uint32_t*>(st)[i] = 0;
  if (tid < WWORDS) {
    occ[tid] = 0;
    mws[tid] = 0;
    dws[0][tid] = dw[w0 * WWORDS + tid];
  }
  if (tid < PF) stage_c[tid] = -1;
  if (tid == 0) {
    sel.thresh = 0;
    sel.n_cand = 0;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < T; ++t)
      if (sbm[t] >= 0) bms[n++] = t;
    n_bms = n;
  }
  if (w0 > 0) {  // this CTA's first doc in each segment
    for (int t = warp; t < T; t += NWARPS) {
      const int64_t lb =
          warp_lower_bound(docid, cur[t], send[t], w0 * WIN, lane);
      __syncwarp();
      if (lane == 0) cur[t] = lb;
    }
  }
  __syncthreads();
  const int nb = n_bms;

  // The bitmap terms of doc x (word j, bit) of the window at wbase, folded
  // in slot order into the CSR chain c and flags f: S, and whether x
  // matched.
  auto score = [&](int wbase, int x, int j, int bit, float c, uint8_t f,
                   const uint32_t* dcur, float& s) {
    float wsum = 0.f;
    int req = f & 0x7f;
    bool neg = f & NEG_BIT;
    for (int q = 0; q < nb; ++q) {
      const int t = bms[q];
      const uint32_t word =
          bitmaps[static_cast<int64_t>(sbm[t]) * NWORDS + (wbase >> 5) + j];
      if ((word >> bit) & 1u) {
        wsum = __fadd_rn(wsum, sw[t]);
        req += (sfl[t] & FLAG_REQ) ? 1 : 0;
        neg |= (sfl[t] & FLAG_NEG) != 0;
      }
    }
    // fma(0, sat1, c) = c: sat1 is read only where a bitmap weight is set
    s = wsum != 0.f ? __fmaf_rn(wsum, s1[wbase + x], c) : c;
    return s > 0.f && req >= nreq && !neg && !((dcur[j] >> bit) & 1u);
  };

  int mine = 0;
  for (int wi = w0; wi < w0 + wins; ++wi) {
    const int wbase = wi * WIN;
    const int wend = wbase + WIN;
    const bool more = wi + 1 < w0 + wins;
    const uint32_t* dcur = dws[(wi - w0) & 1];
    uint32_t dnext = 0;  // the next window's delete words, stored below
    if (tid < WWORDS && more) dnext = dw[(wi + 1) * WWORDS + tid];
    for (int t = 0; t < T; ++t) {
      const float w = sw[t];
      const int fl = sfl[t];
      const uint8_t inc = (fl & FLAG_REQ) ? 1 : 0;
      const uint8_t negb = (fl & FLAG_NEG) ? NEG_BIT : 0;
      const int64_t e = send[t];
      int64_t c = cur[t];
      if (c < e) {  // uniform over the CTA
        for (;;) {
          const int64_t i = c + tid;
          int d = BLOCK_DOCS;  // past every window
          float v = 0.f;
          if (t < PF && stage_c[t] == c) {  // staged in the last window
            if (i < e) {
              d = stage_d[t * THREADS + tid];
              v = stage_v[t * THREADS + tid];
            }
          } else if (i < e) {
            d = static_cast<int>(docid[i]);
            v = imp[i];
          }
          const bool in = d < wend;
          if (in) {
            const int x = d - wbase;
            sc[x] = __fmaf_rn(w, v, sc[x]);
            st[x] = static_cast<uint8_t>(st[x] + inc) | negb;
            atomicOr(&occ[x >> 5], 1u << (x & 31));
          }
          // the segment is sorted: the docs in this window are a prefix
          const int got = __syncthreads_count(in);
          c += got;
          if (got < THREADS || c >= e) break;
        }
        cur[t] = c;  // every thread writes the same value
      }
    }

    // the first chunks of the next window, loaded now, staged below
    int pd[PF];
    float pv[PF];
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      pd[q] = 0;
      pv[q] = 0.f;
      if (more && q < T) {
        const int64_t i = cur[q] + tid;
        if (i < send[q]) {
          pd[q] = static_cast<int>(docid[i]);
          pv[q] = imp[i];
        }
      }
    }

    // epilogue: every write above was followed by a barrier
    if constexpr (FUSED) {
      // the occupied docs of the warp's EPI words, packed 32 to a step:
      // lane k < EPI holds word k, incl the occupied docs up to word k.
      // Rounds of one step a warp add at most ROUND keys; the buffer is
      // shrunk between rounds when it could not take another.
      const int j0 = warp * EPI;
      uint32_t ow = 0, oc = 0;
      if (lane < EPI) {
        oc = occ[j0 + lane];
        ow = oc;
        for (int q = 0; q < nb; ++q)
          ow |= bitmaps[static_cast<int64_t>(sbm[bms[q]]) * NWORDS +
                        (wbase >> 5) + j0 + lane];
      }
      const int pc = __popc(ow);
      int incl = pc;
#pragma unroll
      for (int o = 1; o < EPI; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      const int total = __shfl_sync(FULL, incl, EPI - 1);
      for (int r0 = 0; __syncthreads_or(r0 < total); r0 += 32) {
        const int r = r0 + lane;
        int k = 0;  // words before the one holding occupied doc r
#pragma unroll
        for (int step = EPI / 2; step >= 1; step >>= 1)
          if (__shfl_sync(FULL, incl, k + step - 1) <= r) k += step;
        const uint32_t word = __shfl_sync(FULL, ow, k);
        const int before = __shfl_sync(FULL, incl - pc, k);
        bool m = false;
        float s = 0.f;
        int x = 0;
        if (r < total) {
          const int bit = nth_set_bit(word, r - before);
          const int j = j0 + k;
          x = j * 32 + bit;
          m = score(wbase, x, j, bit, sc[x], st[x], dcur, s);
          sc[x] = 0.f;
          st[x] = 0;
        }
        mine += m ? 1 : 0;
        if (mwords != nullptr && m) atomicOr(&mws[x >> 5], 1u << (x & 31));
        const uint64_t key =
            (static_cast<uint64_t>(__float_as_uint(s)) << 16) |
            static_cast<uint64_t>(65535 - (wbase + x));
        const bool take = m && key > sel.thresh;
        const unsigned bal = __ballot_sync(FULL, take);
        if (bal) {
          int base = 0;
          if (lane == 0) base = atomicAdd(&sel.n_cand, __popc(bal));
          base = __shfl_sync(FULL, base, 0);
          if (take) cand[base + __popc(bal & ((1u << lane) - 1u))] = key;
        }
        if (__syncthreads_count(take) && sel.n_cand > CAP - ROUND)
          shrink(cand, keep, hist, sel, kk, tid, lane, warp);
      }
      if (lane < EPI && oc) occ[j0 + lane] = 0;
      // the loop's last barrier followed every atomicOr above
      if (mwords != nullptr && tid < WWORDS) {
        mwords[static_cast<int64_t>(p) * NWORDS + (wbase >> 5) + tid] =
            mws[tid];
        mws[tid] = 0;
      }
    } else {
      // every doc's masked score is written: a warp a word
#pragma unroll 1
      for (int k = 0; k < EPI; ++k) {
        const int j = warp + k * NWARPS;
        const int x = j * 32 + lane;
        const uint32_t o = occ[j];
        __syncwarp();
        bool m = false;
        float s = 0.f;
        if ((o >> lane) & 1u || nb) {
          m = score(wbase, x, j, lane, sc[x], st[x], dcur, s);
          sc[x] = 0.f;
          st[x] = 0;
        }
        if (lane == 0 && o) occ[j] = 0;
        mine += m ? 1 : 0;
        out[static_cast<int64_t>(p) * BLOCK_DOCS + wbase + x] = m ? s : ninf;
        const uint32_t mb = __ballot_sync(FULL, m);
        if (mwords != nullptr && lane == 0)
          mwords[static_cast<int64_t>(p) * NWORDS + (wbase >> 5) + j] = mb;
      }
    }
    if (tid < WWORDS) dws[(wi - w0 + 1) & 1][tid] = dnext;
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      if (more && q < T) {
        stage_d[q * THREADS + tid] = static_cast<uint16_t>(pd[q]);
        stage_v[q * THREADS + tid] = pv[q];
      }
    }
    if (tid < PF && tid < T && more) stage_c[tid] = cur[tid];
    __syncthreads();
  }

  mine = __reduce_add_sync(FULL, mine);
  if (lane == 0) warp_cnt[warp] = mine;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int i = 0; i < NWARPS; ++i) total += warp_cnt[i];
    if (total) atomicAdd(&cnt[p_q[p]], total);
  }
  if constexpr (FUSED) {
    if (sel.n_cand > kk) shrink(cand, keep, hist, sel, kk, tid, lane, warp);
    if (split > 1) {
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();  // every CTA of the pair holds its <= kk candidates
      if (rank == 0) {
        int total = sel.n_cand;
        for (int r = 1; r < split; ++r) {
          const int m = *cl.map_shared_rank(&sel.n_cand, r);
          const uint64_t* rc = cl.map_shared_rank(cand, r);
          for (int i = tid; i < m; i += THREADS) cand[total + i] = rc[i];
          total += m;
        }
        __syncthreads();
        if (tid == 0) sel.n_cand = total;
      }
      cl.sync();  // the peers' shared memory was read; they may exit
      if (rank != 0) return;
      if (sel.n_cand > kk) shrink(cand, keep, hist, sel, kk, tid, lane, warp);
    }
    const int m = sel.n_cand;  // <= kk keys, ranked by counting
    const int64_t o = static_cast<int64_t>(p) * kk;
    if (tid < m) {
      const uint64_t key = cand[tid];
      int r = 0;
      for (int j = 0; j < m; ++j) r += cand[j] > key ? 1 : 0;
      vals[o + r] = __uint_as_float(static_cast<unsigned>(key >> 16));
      docs[o + r] = 65535 - static_cast<int64_t>(key & 0xffff);
    } else if (tid < kk) {  // past the last match
      vals[o + tid] = ninf;
      docs[o + tid] = -1;
    }
  }
}

template <bool FUSED>
int launch(const void* docid, const void* imp, const void* bitmaps,
           const void* sat1, const void* delw, const void* p_blk,
           const void* p_q, const void* p_nreq, const void* s_off,
           const void* s_len, const void* s_bm, const void* s_w,
           const void* s_flag, int P, int T, int split, int kk, void* out,
           void* vals, void* docs, void* cnt, void* mwords, void* stream) {
  if (P <= 0) return 0;
  if (T > SLOTS - 1 || split < 1 || NWIN % split != 0 ||
      (FUSED && (split > 8 || kk < 1 || kk > KMAX)))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = smem_bytes<FUSED>();
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_scan_kernel<FUSED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(P) * split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = FUSED ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, dense_scan_kernel<FUSED>, static_cast<const uint16_t*>(docid),
      static_cast<const float*>(imp), static_cast<const uint32_t*>(bitmaps),
      static_cast<const float*>(sat1), static_cast<const uint32_t*>(delw),
      static_cast<const int32_t*>(p_blk), static_cast<const int32_t*>(p_q),
      static_cast<const int32_t*>(p_nreq), static_cast<const int64_t*>(s_off),
      static_cast<const int32_t*>(s_len), static_cast<const int32_t*>(s_bm),
      static_cast<const float*>(s_w), static_cast<const int32_t*>(s_flag), T,
      split, kk, static_cast<float*>(out), static_cast<float*>(vals),
      static_cast<int64_t*>(docs), static_cast<int32_t*>(cnt),
      static_cast<uint32_t*>(mwords));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Unfused mode: masked scores of P pairs of T slot columns into out
// [P, 64K], and the matched words into mwords [P, NWORDS] unless it is null.
// Returns cudaGetLastError() after the launch (0 when P == 0 and nothing is
// launched).
extern "C" int dense_scan_launch(const void* docid, const void* imp,
                                 const void* bitmaps, const void* sat1,
                                 const void* delw, const void* p_blk,
                                 const void* p_q, const void* p_nreq,
                                 const void* s_off, const void* s_len,
                                 const void* s_bm, const void* s_w,
                                 const void* s_flag, int P, int T, void* out,
                                 void* cnt, void* mwords, void* stream) {
  return launch<false>(docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq,
                       s_off, s_len, s_bm, s_w, s_flag, P, T, UNFUSED_SPLIT,
                       0, out, nullptr, nullptr, cnt, mwords, stream);
}

// Fused mode: the top-kk of each of P pairs into vals [P, kk] and docs
// [P, kk], split CTAs (a cluster) a pair, and the matched words into mwords
// [P, NWORDS] unless it is null.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a kk, split or T it does not take.
extern "C" int dense_topk_launch(const void* docid, const void* imp,
                                 const void* bitmaps, const void* sat1,
                                 const void* delw, const void* p_blk,
                                 const void* p_q, const void* p_nreq,
                                 const void* s_off, const void* s_len,
                                 const void* s_bm, const void* s_w,
                                 const void* s_flag, int P, int T, int kk,
                                 int split, void* vals, void* docs, void* cnt,
                                 void* mwords, void* stream) {
  return launch<true>(docid, imp, bitmaps, sat1, delw, p_blk, p_q, p_nreq,
                      s_off, s_len, s_bm, s_w, s_flag, P, T, split, kk,
                      nullptr, vals, docs, cnt, mwords, stream);
}

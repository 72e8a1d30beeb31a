// Facet histogram (K3) for Hopper.
//
// Replaces the facet counting of the lexical scans of the JAX package: the
// histogram step of seekstorm_tpu/ops/wand.py::_scan_local (247-273) and
// seekstorm_tpu/ops/lexical.py::_facet_update (297-324), which lexical_scan
// and lexical_scan_imp both call.  They unpack the match bits of a (query,
// block) to one 0/1 value a doc and multiply that matrix with the one-hot
// matrix of the block's facet codes on the MXU, because a scatter-add is
// slow on a TPU (they keep the scatter for code spaces above 512).  On an
// H100 the natural form is a histogram with atomics over the set bits
// alone, and the unpacked matrix ([queries, docs]) never exists.
//
// Input: the packed matched words of P (row, block) pairs, mwords
// [P, NW] (bit j of word i: doc i*32 + j of the pair's block matched), each
// pair's global block p_blk[P] and output row p_row[P], and the facet codes
// codes[NF, nblk*65536] in the global-block layout.  Output:
//   out[f, p_row[p], clip(codes[f, p_blk[p]*65536 + d], 0, fcm-1)] += 1
// for every matched doc d of every pair p and every facet f: exact integer
// counts.  Codes are clipped before counting, as both reference forms do.
// One kernel serves every producer of matched words: the WAND route hands
// it K1's viewed as [Bq*NBLK, NW], the dense route K2's and the tf scan its
// own, both with the pair list's blocks and rows.
//
// What bounds it on an H100: bytes.  The matched words are read once (8 KB
// a pair, whether or not a bit is set), then 4 bytes of code a matched doc
// and facet; the arithmetic is a bit walk and an integer add.  In a served
// batch nearly every pair matches something, but sparsely: the median pair
// of the 2,048-query faceted batch holds 96 docs in 93 of its 2,048 words,
// and 3% of the pairs hold a quarter of all docs.  So the kernel is a
// stream of 8 KB rows with one scattered code read a matched doc and facet
// behind it, and what it must not do is wait for those reads one by one.
// The design, for code spaces that fit shared memory (NF*fcm <= SH_BINS):
//   * persistent CTAs, as many as fit the card at once (the occupancy the
//     runtime reports, times the SMs; six an SM at 40 registers a thread),
//     each walking many pairs: no launch, barrier and exit of a CTA a pair;
//   * the words staged ahead: a ring of STAGES rows of 8 KB in shared
//     memory filled by cp.async 16-byte copies, the next pair's row in
//     flight while the current one is walked.  Each thread reads back only
//     the 32 bytes it copied itself, so the ring needs no barrier.  Two
//     rows are enough: with six CTAs an SM 48 KB are in flight there, and
//     a deeper ring measured no faster, while a seventh CTA an SM (36
//     registers, spills) measured much slower;
//   * a warp compacts its matched docs before it reads a code: every lane
//     counts the set bits of its 8 words, a prefix sum over the lanes
//     gives each its place, and the lanes write their docs (u16) to the
//     warp's queue in shared memory.  Then the lanes share the queue
//     evenly, two docs a lane and two facets at a time, so four code reads
//     are in flight before the first add waits on one, and one trip serves
//     64 docs: the typical warp's dozen docs cost one round trip to L2,
//     where a lane walking its own words alone pays one a word and facet.
//     A warp with more docs than its queue holds (a matching-heavy pair,
//     where most lanes hold docs anyway) walks its own words, two docs at
//     a time;
//   * the histogram in shared memory, in up to MAX_COPIES private copies
//     (one a warp, the copies an odd stride apart so that one bin of two
//     copies falls in two banks: few codes mean many adds to one address).
//     It is kept across pairs and flushed with one global atomic a
//     non-zero bin only when the output row changes and something was
//     counted.  This assumes nothing of the pair order and is right for
//     any: a CTA takes chunks of CHUNK consecutive pairs, chunk c of every
//     gridDim.x (single pairs when there are too few to fill the card
//     otherwise), so in the WAND view (row-major) a chunk flushes at most
//     twice, and in the dense and tf lists (block-major, the row changes
//     every pair) a pair flushes if it counted.
// Wider code spaces (numeric facets without ranges go up to 65,536 codes)
// keep the first design: one CTA a pair and global atomics a matched doc,
// whose time is the zeroing and the scattered update of a histogram of
// hundreds of MB, not the walk.
// Integer adds commute, so the counts are exact whatever the order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 2048;               // u32 words per 64K-doc block
constexpr int BLOCK_DOCS = 65536;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SH_BINS = 8192;          // histogram bins in shared memory
constexpr int MIN_CTAS = 6;            // CTAs an SM the registers must allow
constexpr int STAGES = 2;              // rows of matched words in the ring
constexpr int CHUNK = 4;               // consecutive pairs a CTA takes at most
constexpr int QUEUE = 256;             // docs a warp's queue holds
constexpr int QUEUE_WORDS = NWARPS * QUEUE / 2;  // the queues, in u32 words
constexpr int MAX_COPIES = 8;          // private copies of the histogram
constexpr int ROW_VEC = NW / 4;        // 16-byte vectors a row
constexpr unsigned FULL = 0xffffffffu;
static_assert(NW == 2 * 4 * THREADS, "two 16-byte copies a thread and row");
static_assert(STAGES >= 2, "one row in flight while one is walked");
static_assert(MAX_COPIES <= NWARPS && (MAX_COPIES & (MAX_COPIES - 1)) == 0,
              "at most one copy a warp, a power of two");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// doc 0 of word j of a thread: its words are 4*tid + j of the row's first
// half (j < 4), then of the second
__device__ __forceinline__ int first_doc(int tid, int j) {
  return ((j < 4 ? 0 : NW / 2) + 4 * tid + (j & 3)) * 32;
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
facet_hist_kernel(const uint32_t* __restrict__ mwords,  // [P, NW]
                  const int32_t* __restrict__ p_blk,    // [P] global block
                  const int32_t* __restrict__ p_row,    // [P] output row
                  const int32_t* __restrict__ codes,    // [NF, nblk * 64K]
                  int nblk, int P, int NF, int fcm, int R, int copies,
                  int stride, int chunk,
                  int32_t* __restrict__ out) {          // [NF, R, fcm], zeroed
  extern __shared__ __align__(16) uint32_t smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);  // [STAGES][ROW_VEC]
  uint16_t* queue = reinterpret_cast<uint16_t*>(smem + STAGES * NW);
  int* hist = reinterpret_cast<int*>(smem + STAGES * NW + QUEUE_WORDS);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int bins = NF * fcm;
  const int64_t cstride = static_cast<int64_t>(nblk) * BLOCK_DOCS;

  for (int i = tid; i < copies * stride; i += THREADS) hist[i] = 0;
  __syncthreads();

  // A CTA's pairs: `chunk` consecutive pairs from blockIdx.x * chunk, then
  // the same every gridDim.x chunks.  A cursor is the next pair and how
  // many of its chunk are left; past the last pair nothing is copied.
  const int64_t hop = static_cast<int64_t>(gridDim.x - 1) * chunk;
  auto advance = [&](int64_t& p, int& left) {
    ++p;
    if (--left == 0) {
      p += hop;
      left = chunk;
    }
  };
  int64_t p_ahead = static_cast<int64_t>(blockIdx.x) * chunk;  // to prefetch
  int left_ahead = chunk, slot_ahead = 0;
  auto prefetch = [&]() {
    if (p_ahead < P) {
      const uint4* src = reinterpret_cast<const uint4*>(mwords + p_ahead * NW);
      uint4* dst = ring + slot_ahead * ROW_VEC;
      cp_async16(dst + tid, src + tid);
      cp_async16(dst + tid + THREADS, src + tid + THREADS);
    }
    cp_async_commit();  // an empty group keeps the wait count uniform
    advance(p_ahead, left_ahead);
    slot_ahead = slot_ahead + 1 == STAGES ? 0 : slot_ahead + 1;
  };
  int* mine = hist + ((tid >> 5) & (copies - 1)) * stride;  // my warp's copy
  uint16_t* q = queue + (tid >> 5) * QUEUE;  // my warp's matched docs
  auto flush = [&](int row) {
    for (int i = tid; i < bins; i += THREADS) {
      int v = 0;
      for (int c = 0; c < copies; ++c) {
        v += hist[c * stride + i];
        hist[c * stride + i] = 0;
      }
      if (v)
        atomicAdd(&out[(static_cast<int64_t>(i / fcm) * R + row) * fcm +
                       i % fcm],
                  v);
    }
  };
  // counts two docs (d1 < 0: one) of block codes cb, two facets at a time:
  // four code reads in flight before the first add waits on one
  auto count2 = [&](const int32_t* cb, int d0, int d1) {
    for (int f = 0; f < NF; f += 2) {
      const bool two = f + 1 < NF;
      const int32_t* c0 = cb + f * cstride;
      const int32_t* c1 = two ? c0 + cstride : c0;
      const int v00 = __ldg(c0 + d0);
      const int v10 = two ? __ldg(c1 + d0) : 0;
      const int v01 = d1 >= 0 ? __ldg(c0 + d1) : 0;
      const int v11 = two && d1 >= 0 ? __ldg(c1 + d1) : 0;
      int* h0 = mine + f * fcm;
      int* h1 = h0 + fcm;
      atomicAdd(h0 + min(max(v00, 0), fcm - 1), 1);
      if (two) atomicAdd(h1 + min(max(v10, 0), fcm - 1), 1);
      if (d1 >= 0) {
        atomicAdd(h0 + min(max(v01, 0), fcm - 1), 1);
        if (two) atomicAdd(h1 + min(max(v11, 0), fcm - 1), 1);
      }
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) prefetch();
  int cur_row = -1;   // the row the shared histogram counts for
  int dirty = 0;      // this thread added to it since the last flush
  int64_t p = static_cast<int64_t>(blockIdx.x) * chunk;  // the pair walked
  int left = chunk, slot = 0;
  for (; p < P; advance(p, left), slot = slot + 1 == STAGES ? 0 : slot + 1) {
    cp_async_wait<STAGES - 2>();  // this pair's group has landed
    const uint4* row = ring + slot * ROW_VEC;
    const uint4 a = row[tid];
    const uint4 b = row[tid + THREADS];
    prefetch();                   // into the slot read one pair ago
    const int r = __ldg(p_row + p);
    if (r != cur_row) {
      if (__syncthreads_or(dirty)) {
        flush(cur_row);
        dirty = 0;
        __syncthreads();
      }
      cur_row = r;
    }
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    int n_mine = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) n_mine += __popc(w[j]);
    const int n_warp = __reduce_add_sync(FULL, n_mine);
    if (n_warp == 0) continue;  // uniform over the warp; no barrier follows
    if (n_mine) dirty = 1;
    const int32_t* cb =
        codes + static_cast<int64_t>(__ldg(p_blk + p)) * BLOCK_DOCS;
    if (n_warp > QUEUE) {
      // a matching-heavy pair: each lane walks its own words
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t word = w[j];
        const int doc0 = first_doc(tid, j);
        while (word) {
          const int d0 = doc0 + __ffs(word) - 1;
          word &= word - 1;
          const int d1 = word ? doc0 + __ffs(word) - 1 : -1;
          word &= word - 1;
          count2(cb, d0, d1);
        }
      }
      continue;
    }
    // the warp's docs go to its queue and the lanes share them evenly
    int incl = n_mine;  // inclusive prefix over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    int pos = incl - n_mine;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t word = w[j];
      const int doc0 = first_doc(tid, j);
      while (word) {
        q[pos++] = static_cast<uint16_t>(doc0 + __ffs(word) - 1);
        word &= word - 1;
      }
    }
    __syncwarp();
    for (int e = lane; e < n_warp; e += 64)
      count2(cb, q[e], e + 32 < n_warp ? q[e + 32] : -1);
    __syncwarp();  // the queue is free for the next pair
  }
  cp_async_wait<0>();
  if (__syncthreads_or(dirty)) flush(cur_row);
}

// The wide code spaces: one CTA a pair, each thread walks its 8 words and
// adds to the global histogram directly; a pair without a match leaves
// after one barrier.
__global__ void __launch_bounds__(THREADS)
facet_hist_wide_kernel(const uint32_t* __restrict__ mwords,
                       const int32_t* __restrict__ p_blk,
                       const int32_t* __restrict__ p_row,
                       const int32_t* __restrict__ codes, int nblk, int NF,
                       int fcm, int R, int32_t* __restrict__ out) {
  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  const uint4* row =
      reinterpret_cast<const uint4*>(mwords + static_cast<int64_t>(p) * NW);
  const uint4 a = row[tid];
  const uint4 b = row[tid + THREADS];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const bool any = (a.x | a.y | a.z | a.w | b.x | b.y | b.z | b.w) != 0u;
  if (!__syncthreads_or(any)) return;  // uniform over the CTA
  const int r = p_row[p];
  const int64_t cstride = static_cast<int64_t>(nblk) * BLOCK_DOCS;
  const int32_t* cb = codes + static_cast<int64_t>(p_blk[p]) * BLOCK_DOCS;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t word = w[j];
    const int doc0 = first_doc(tid, j);
    while (word) {
      const int doc = doc0 + __ffs(word) - 1;
      word &= word - 1;
      for (int f = 0; f < NF; ++f) {
        const int c = min(max(cb[f * cstride + doc], 0), fcm - 1);
        atomicAdd(&out[(static_cast<int64_t>(f) * R + r) * fcm + c], 1);
      }
    }
  }
}

}  // namespace

// Counts into out [NF, R, fcm] (zeroed by the caller) the facet codes of the
// matched docs of P pairs.  Returns cudaGetLastError() after the launch (0
// when P == 0 or NF == 0 and nothing is launched), the error of a runtime
// call that failed before it, or cudaErrorInvalidValue for a size it does
// not take.
extern "C" int facet_hist_launch(const void* mwords, const void* p_blk,
                                 const void* p_row, const void* codes,
                                 int nblk, int P, int NF, int fcm, int R,
                                 void* out, void* stream) {
  if (P <= 0 || NF <= 0) return 0;
  if (fcm < 1 || R < 1 || nblk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* mw = static_cast<const uint32_t*>(mwords);
  const int32_t* blk = static_cast<const int32_t*>(p_blk);
  const int32_t* rows = static_cast<const int32_t*>(p_row);
  const int32_t* cod = static_cast<const int32_t*>(codes);
  int32_t* o = static_cast<int32_t*>(out);
  const int64_t bins = static_cast<int64_t>(NF) * fcm;
  if (bins > SH_BINS) {
    facet_hist_wide_kernel<<<P, THREADS, 0, s>>>(mw, blk, rows, cod, nblk, NF,
                                                 fcm, R, o);
    return static_cast<int>(cudaGetLastError());
  }
  // private copies of the histogram: a power of two, an odd stride apart
  const int odd = static_cast<int>(bins) | 1;
  int copies = 1;
  while (copies * 2 <= MAX_COPIES && copies * 2 * odd <= SH_BINS) copies *= 2;
  const int stride = copies > 1 ? odd : static_cast<int>(bins);
  const size_t smem =
      sizeof(uint32_t) * (static_cast<size_t>(STAGES) * NW + QUEUE_WORDS +
                          static_cast<size_t>(copies) * stride);
  cudaError_t err = cudaFuncSetAttribute(
      facet_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, facet_hist_kernel, THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  // chunks of CHUNK pairs when that still fills the card, else single
  // pairs: a small batch's time is the pairs a CTA walks one after another
  const int slots = per_sm * sms;
  const int chunk = P >= CHUNK * slots ? CHUNK : 1;
  const int n_chunks = (P + chunk - 1) / chunk;
  const int grid = n_chunks < slots ? n_chunks : slots;
  facet_hist_kernel<<<grid, THREADS, smem, s>>>(
      mw, blk, rows, cod, nblk, P, NF, fcm, R, copies, stride, chunk, o);
  return static_cast<int>(cudaGetLastError());
}

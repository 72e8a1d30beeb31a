// Facet histogram (K3) for Hopper.
//
// Replaces the facet counting of the two lexical scans of the JAX package:
// the histogram step of seekstorm_tpu/ops/wand.py::_scan_local (247-273) and
// seekstorm_tpu/ops/lexical.py::_facet_update (297-324).  Both unpack the
// match bits of a (query, block) to one 0/1 value a doc and multiply that
// matrix with the one-hot matrix of the block's facet codes on the MXU,
// because a scatter-add is slow on a TPU (they keep the scatter for code
// spaces above 512).  On an H100 the natural form is a histogram with
// atomics over the set bits alone, and the unpacked matrix ([queries, docs])
// never exists.
//
// Input: the packed matched words of P (row, block) pairs, mwords
// [P, NW] (bit j of word i: doc i*32 + j of the pair's block matched), each
// pair's global block p_blk[P] and output row p_row[P], and the facet codes
// codes[NF, nblk*65536] in the global-block layout.  Output:
//   out[f, p_row[p], clip(codes[f, p_blk[p]*65536 + d], 0, fcm-1)] += 1
// for every matched doc d of every pair p and every facet f: exact integer
// counts.  Codes are clipped before counting, as both reference forms do.
// One kernel serves both routes: the WAND route hands it K1's matched words
// viewed as [Bq*NBLK, NW], the dense route K2's with the pair list's blocks
// and rows.
//
// What bounds it on an H100: bytes.  The matched words are read once (8 KB a
// pair, whether or not a bit is set), then 4 bytes of code a matched doc and
// facet; the arithmetic is a bit loop and an integer add.  The design is
// simple: one CTA a pair, 256 threads of 8 words each (two 16-byte loads), a
// pair without a match leaves after one barrier; a loop over the set bits of
// each word (__ffs); atomicAdd into a histogram in shared memory while
// NF*fcm fits SH_BINS, one private copy a warp while the copies fit (few
// codes mean many adds to one address), flushed to global memory with one
// atomic a non-zero bin; global atomics directly for wider code spaces
// (numeric facets without ranges go up to 65,536 codes).  Integer adds
// commute, so the counts are exact whatever the order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 2048;               // u32 words per 64K-doc block
constexpr int BLOCK_DOCS = 65536;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SH_BINS = 8192;          // histogram bins in shared memory
static_assert(NW == 2 * 4 * THREADS, "two 16-byte loads a thread");

template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
facet_hist_kernel(const uint32_t* __restrict__ mwords,  // [P, NW]
                  const int32_t* __restrict__ p_blk,    // [P] global block
                  const int32_t* __restrict__ p_row,    // [P] output row
                  const int32_t* __restrict__ codes,    // [NF, nblk * 64K]
                  int nblk, int NF, int fcm, int R,
                  int32_t* __restrict__ out) {          // [NF, R, fcm], zeroed
  __shared__ int hist[SHARED ? SH_BINS : 1];
  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  const uint4* row =
      reinterpret_cast<const uint4*>(mwords + static_cast<int64_t>(p) * NW);
  const uint4 a = row[tid];
  const uint4 b = row[tid + THREADS];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const bool any = (a.x | a.y | a.z | a.w | b.x | b.y | b.z | b.w) != 0u;
  if (!__syncthreads_or(any)) return;  // uniform over the CTA

  const int bins = NF * fcm;
  // private copies of the histogram, one a warp while they fit
  const int copies = SHARED ? max(1, min(NWARPS, SH_BINS / bins)) : 1;
  if (SHARED) {
    for (int i = tid; i < bins * copies; i += THREADS) hist[i] = 0;
    __syncthreads();
  }
  const int r = p_row[p];
  const int64_t stride = static_cast<int64_t>(nblk) * BLOCK_DOCS;
  const int32_t* cb = codes + static_cast<int64_t>(p_blk[p]) * BLOCK_DOCS;
  int* mine = hist + ((tid >> 5) % copies) * bins;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t word = w[i];
    // the thread's words: 4*tid + i of the first half, then of the second
    const int doc0 = ((i < 4 ? 0 : NW / 2) + 4 * tid + (i & 3)) * 32;
    while (word) {
      const int doc = doc0 + __ffs(word) - 1;
      word &= word - 1;
      for (int f = 0; f < NF; ++f) {
        int c = cb[f * stride + doc];
        c = min(max(c, 0), fcm - 1);
        if (SHARED)
          atomicAdd(&mine[f * fcm + c], 1);
        else
          atomicAdd(&out[(static_cast<int64_t>(f) * R + r) * fcm + c], 1);
      }
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int i = tid; i < bins; i += THREADS) {
      int v = 0;
      for (int c = 0; c < copies; ++c) v += hist[c * bins + i];
      if (v)
        atomicAdd(&out[(static_cast<int64_t>(i / fcm) * R + r) * fcm + i % fcm],
                  v);
    }
  }
}

}  // namespace

// Counts into out [NF, R, fcm] (zeroed by the caller) the facet codes of the
// matched docs of P pairs.  Returns cudaGetLastError() after the launch (0
// when P == 0 or NF == 0 and nothing is launched), or cudaErrorInvalidValue
// for a size it does not take.
extern "C" int facet_hist_launch(const void* mwords, const void* p_blk,
                                 const void* p_row, const void* codes,
                                 int nblk, int P, int NF, int fcm, int R,
                                 void* out, void* stream) {
  if (P <= 0 || NF <= 0) return 0;
  if (fcm < 1 || R < 1 || nblk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool shared = static_cast<int64_t>(NF) * fcm <= SH_BINS;
  auto kern = shared ? facet_hist_kernel<true> : facet_hist_kernel<false>;
  kern<<<P, THREADS, 0, s>>>(
      static_cast<const uint32_t*>(mwords), static_cast<const int32_t*>(p_blk),
      static_cast<const int32_t*>(p_row), static_cast<const int32_t*>(codes),
      nblk, NF, fcm, R, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Phase-1 bucket-WAND scan (K1) for Hopper.
//
// Replaces the Pallas kernel seekstorm_tpu/ops/wand_pallas.py::_kernel /
// scan_blocks (the pallas_call at wand_pallas.py:247) and its XLA twin, the
// lax.scan step of seekstorm_tpu/ops/wand.py::_scan_local, and computes the
// rung maxima that phase 2 (ops/wand.py::_rung_topks) reduces from its output.
//
// For each query q and each u32 word w (a 32-doc bucket) of each 64K-doc
// block b it computes
//   matched = AND(required) & OR(positive) & ~OR(negated) & ~deleted & ~filter
//   cnt[q] += popcount(matched)
//   allub[q, b*NW + w] = max over presence classes c of the first
//       NC = min(T, 3) positive columns of  sum_{t<NC, t in c} w_t*max_t
//       + sum_{t>=NC} w_t*max_t   (ascending column order), or -inf where
//       nothing matched.
// A class bound applies only when a doc of that class exists in the bucket
// and the class holds every required column.  From the same registers it
// writes phase 2's maxima over consecutive buckets of allub's row:
//   ub4  [Bq, L1/4]   max over 4 buckets (one thread's words),
//   ub16 [Bq, L1/16]  max over 16 (four lanes, by warp shuffles),
//   g1   [Bq, L1/128] max over 128 (the warp: a rung-1 group of
//                     _topk_lanes),
// with L1 = nblk*NW.  A max is exact, so these equal the amax chain of the
// plain version bit for bit.  On request it also writes the matched words
// themselves, mwords [Bq, L1], which it holds in registers anyway: the facet
// histogram (csrc/facet_hist.cu) counts from them and rank-by-key batches
// mask their sort-key bounds with them.  Without the request nothing more
// is written than the five outputs above.
//
// What bounds it on an H100: bytes.  Per (query, block, word) the kernel
// reads T presence words and up to T bucket-max words and writes the UB and
// its maxima (4 + 1 + 1/4 + 1/32 bytes); the arithmetic is a few dozen
// integer and float ops, which at T=8 come close to the bytes' time.  The
// design:
//   * each thread owns 4 consecutive words, so every access to ppool,
//     vpool, delw, filtw and allub is 16 bytes;
//   * a CTA of 128 threads covers 512 words of one block for a tile of 16
//     queries and stages each query's pool-row slices in shared memory
//     with cp.async, double-buffered: query q+1's rows are in flight while
//     q computes (at T=8, 2 x 8 x 512 words x 8 B = 64 KB of dynamic
//     shared memory, so three CTAs fit an SM, where 256 threads and 128 KB
//     left one).  Each thread reads back only the slots it copied, so the
//     pipeline needs no barrier;
//   * the maxima are reduced in registers and warp shuffles, so phase 2
//     never reads allub to find them; allub and ub4 are written with
//     streaming stores (phase 2 reads back only a few groups of them);
//   * the columns past the first NC are added once per bucket, after the
//     max over presence classes, not once per class (see the loop).
//
// Numerics: the UB chains are written with __fmul_rn / __fadd_rn so nvcc
// cannot contract them into fma; each term rounds twice, exactly like the
// plain PyTorch version (scan_blocks_ref) and the host rescore, so the
// kernel is bit-exact against the plain version and UB >= exact score
// holds bitwise.  Counts are integer atomics, whose sum is order-free.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 2048;               // u32 words (buckets) per 64K-doc block
constexpr int THREADS = 128;           // threads per CTA
constexpr int WPT = 4;                 // consecutive words per thread
constexpr int CHUNK = THREADS * WPT;   // words of a block per CTA
constexpr int QT = 16;                 // queries per CTA (loop inside the CTA)

// one query's pool-row slices: per column, 16 bytes of presence and 16 of
// bucket maxima per thread
template <int T>
struct Stage {
  uint4 p[T][THREADS];
  float4 v[T][THREADS];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// copy one query's slices into a stage buffer (one commit group): the
// presence words of every column it has a row for, the bucket maxima of its
// positive columns
template <int T>
__device__ __forceinline__ void fetch(Stage<T>& st, const int* rows,
                                      uint32_t negm,
                                      const uint32_t* __restrict__ ppool,
                                      const float* __restrict__ vpool, int w0,
                                      int tid) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int row = rows[t];
    if (row >= 0) {
      const size_t off = static_cast<size_t>(row) * NW + w0;
      cp_async16(&st.p[t][tid], ppool + off);
      if (!((negm >> t) & 1u)) cp_async16(&st.v[t][tid], vpool + off);
    }
  }
  cp_async_commit();
}

template <int T, bool FILTER, bool COUNTS, bool MATCHED>
__global__ void __launch_bounds__(THREADS)
wand_scan_kernel(const uint32_t* __restrict__ ppool,   // [PR, NW]
                 const float* __restrict__ vpool,      // [PR, NW]
                 const int32_t* __restrict__ prow,     // [NBLK, V]
                 int V,
                 const uint32_t* __restrict__ delw,    // [NBLK, NW]
                 const uint32_t* __restrict__ filtw,   // [NBLK, NW] or null
                 const int32_t* __restrict__ tcode,    // [Bq, T]
                 const float* __restrict__ wshard,     // [S, Bq, T]
                 const int32_t* __restrict__ sid,      // [NBLK]
                 int Bq, int nblk,
                 float* __restrict__ allub,            // [Bq, L1]
                 float* __restrict__ ub4,              // [Bq, L1/4]
                 float* __restrict__ ub16,             // [Bq, L1/16]
                 float* __restrict__ g1,               // [Bq, L1/128]
                 int32_t* __restrict__ cnt,            // [Bq], zeroed
                 uint32_t* __restrict__ mwords) {      // [Bq, L1] if MATCHED
  constexpr int NC = T < 3 ? T : 3;
  const float ninf = __int_as_float(0xff800000);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w0 = blockIdx.x * CHUNK + tid * WPT;  // first word of the thread
  const int b = blockIdx.y;
  const int q0 = blockIdx.z * QT;
  const int nq = min(QT, Bq - q0);

  __shared__ int s_row[QT][T];     // pool row of (query, column), -1 absent
  __shared__ float s_w[QT][T];     // idf weight of a scoring column
  __shared__ uint32_t s_req[QT];   // bit t: required positive column
  __shared__ uint32_t s_pos[QT];   // bit t: positive column
  __shared__ uint32_t s_neg[QT];   // bit t: negated column
  __shared__ int s_cnt[QT];
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<T>* stage = reinterpret_cast<Stage<T>*>(smem);  // [2]

  if (tid < QT) {
    const int q = q0 + tid;
    const int shard = sid[b];
    uint32_t req = 0, pos = 0, neg = 0;
    for (int t = 0; t < T; ++t) {
      // code = slot*4 | required*2 | negated; -4 marks an unused column
      const int code = q < Bq ? tcode[q * T + t] : -4;
      const int s = code >> 2;
      const bool is_neg = (code & 1) != 0;
      const bool is_req = (code & 2) != 0;
      const int row = s >= 0 ? prow[b * V + s] : -1;
      const bool okp = s >= 0 && row >= 0;
      s_row[tid][t] = okp ? row : -1;
      s_w[tid][t] = (okp && !is_neg) ? wshard[(shard * Bq + q) * T + t] : 0.f;
      if (s >= 0 && is_req && !is_neg) req |= 1u << t;
      if (s >= 0 && !is_neg) pos |= 1u << t;
      if (s >= 0 && is_neg) neg |= 1u << t;
    }
    s_req[tid] = req;
    s_pos[tid] = pos;
    s_neg[tid] = neg;
    s_cnt[tid] = 0;
  }
  __syncthreads();

  const size_t bw = static_cast<size_t>(b) * NW + w0;  // word in allub's row
  uint4 nd = *reinterpret_cast<const uint4*>(delw + bw);
  if (FILTER) {
    const uint4 f = *reinterpret_cast<const uint4*>(filtw + bw);
    nd.x |= f.x;
    nd.y |= f.y;
    nd.z |= f.z;
    nd.w |= f.w;
  }
  const uint32_t notdel[WPT] = {~nd.x, ~nd.y, ~nd.z, ~nd.w};
  const size_t L1 = static_cast<size_t>(nblk) * NW;

  fetch<T>(stage[0], s_row[0], s_neg[0], ppool, vpool, w0, tid);
  for (int qq = 0; qq < nq; ++qq) {  // nq is uniform over the CTA
    const int buf = qq & 1;
    if (qq + 1 < nq) {
      fetch<T>(stage[buf ^ 1], s_row[qq + 1], s_neg[qq + 1], ppool, vpool, w0,
               tid);
    } else {
      cp_async_commit();  // an empty group keeps the wait count uniform
    }
    cp_async_wait<1>();      // query qq's group has landed

    const uint32_t reqm = s_req[qq], posm = s_pos[qq], negm = s_neg[qq];
    uint32_t pres[T][WPT];
    float bval[T][WPT];
    uint32_t andw[WPT], posw[WPT], negw[WPT];
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      andw[i] = 0xffffffffu;
      posw[i] = 0u;
      negw[i] = 0u;
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int row = s_row[qq][t];
      const bool is_neg = (negm >> t) & 1u;
      uint4 p = make_uint4(0u, 0u, 0u, 0u);
      float bv[WPT] = {0.f, 0.f, 0.f, 0.f};
      if (row >= 0) {
        p = stage[buf].p[t][tid];
        if (!is_neg) {
          const float4 v = stage[buf].v[t][tid];
          const float wt = s_w[qq][t];
          bv[0] = __fmul_rn(wt, v.x);
          bv[1] = __fmul_rn(wt, v.y);
          bv[2] = __fmul_rn(wt, v.z);
          bv[3] = __fmul_rn(wt, v.w);
        }
      }
      const uint32_t pw[WPT] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int i = 0; i < WPT; ++i) {
        pres[t][i] = pw[i];
        bval[t][i] = bv[i];
        if ((reqm >> t) & 1u) andw[i] &= pw[i];
        if ((posm >> t) & 1u) posw[i] |= pw[i];
        if (is_neg) negw[i] |= pw[i];
      }
    }

    float ub[WPT];
    uint32_t mt[WPT];
    int c = 0;
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const uint32_t matched = andw[i] & posw[i] & ~negw[i] & notdel[i];
      mt[i] = matched;
      if (COUNTS) c += __popc(matched);
      // best over the live classes of the first NC columns' partial sums,
      // then the later columns added once: rounding is monotone, so
      // fl(max_c p_c + r) == max_c fl(p_c + r), and the sequential adds of
      // the plain version's per-class chains give the same bits
      float best = ninf;
#pragma unroll
      for (int cl = 1; cl < (1 << NC); ++cl) {
        uint32_t mm = 0xffffffffu;
        bool okc = true;
        bool first = true;
        float sc = 0.f;
#pragma unroll
        for (int t = 0; t < NC; ++t) {
          if ((cl >> t) & 1) {
            mm &= pres[t][i];
            sc = first ? bval[t][i] : __fadd_rn(sc, bval[t][i]);
            first = false;
          } else {
            mm &= ~pres[t][i];
            okc = okc && !((reqm >> t) & 1u);
          }
        }
        if (mm != 0u && okc) best = fmaxf(best, sc);
      }
#pragma unroll
      for (int t = NC; t < T; ++t) best = __fadd_rn(best, bval[t][i]);
      ub[i] = matched != 0u ? best : ninf;
    }
    if (COUNTS) {
      c = __reduce_add_sync(0xffffffffu, c);
      if (lane == 0 && c) atomicAdd(&s_cnt[qq], c);
    }

    const size_t q = static_cast<size_t>(q0 + qq);
    __stcs(reinterpret_cast<float4*>(allub + q * L1 + bw),
           make_float4(ub[0], ub[1], ub[2], ub[3]));
    if (MATCHED)
      *reinterpret_cast<uint4*>(mwords + q * L1 + bw) =
          make_uint4(mt[0], mt[1], mt[2], mt[3]);
    float m = fmaxf(fmaxf(ub[0], ub[1]), fmaxf(ub[2], ub[3]));
    __stcs(&ub4[q * (L1 / 4) + bw / 4], m);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    if ((lane & 3) == 0) ub16[q * (L1 / 16) + bw / 16] = m;
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
    if (lane == 0) g1[q * (L1 / 128) + bw / 128] = m;
  }

  if (COUNTS) {
    __syncthreads();
    if (tid < nq && s_cnt[tid]) atomicAdd(&cnt[q0 + tid], s_cnt[tid]);
  }
}

template <int T>
cudaError_t launch_t(const void* ppool, const void* vpool, const void* prow,
                     int V, const void* delw, const void* filtw,
                     const void* tcode, const void* wshard, const void* sid,
                     int Bq, int nblk, int with_counts, void* allub, void* ub4,
                     void* ub16, void* g1, void* cnt, void* mwords,
                     cudaStream_t stream) {
  const dim3 grid(NW / CHUNK, nblk, (Bq + QT - 1) / QT);
  const dim3 block(THREADS);
  constexpr int smem = 2 * static_cast<int>(sizeof(Stage<T>));
  cudaError_t err = cudaSuccess;
  auto run = [&](auto kern) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return;
    kern<<<grid, block, smem, stream>>>(
        static_cast<const uint32_t*>(ppool), static_cast<const float*>(vpool),
        static_cast<const int32_t*>(prow), V,
        static_cast<const uint32_t*>(delw), static_cast<const uint32_t*>(filtw),
        static_cast<const int32_t*>(tcode), static_cast<const float*>(wshard),
        static_cast<const int32_t*>(sid), Bq, nblk, static_cast<float*>(allub),
        static_cast<float*>(ub4), static_cast<float*>(ub16),
        static_cast<float*>(g1), static_cast<int32_t*>(cnt),
        static_cast<uint32_t*>(mwords));
    err = cudaGetLastError();
  };
  const bool filt = filtw != nullptr;
  if (mwords != nullptr) {
    if (filt && with_counts) run(wand_scan_kernel<T, true, true, true>);
    else if (filt) run(wand_scan_kernel<T, true, false, true>);
    else if (with_counts) run(wand_scan_kernel<T, false, true, true>);
    else run(wand_scan_kernel<T, false, false, true>);
  } else if (filt && with_counts) run(wand_scan_kernel<T, true, true, false>);
  else if (filt) run(wand_scan_kernel<T, true, false, false>);
  else if (with_counts) run(wand_scan_kernel<T, false, true, false>);
  else run(wand_scan_kernel<T, false, false, false>);
  return err;
}

}  // namespace

// mwords may be null: the matched words are then not written.  Returns the
// CUDA error of the attribute call or the launch, 0 on success, or -1 for an
// unsupported T.
extern "C" int wand_scan_launch(const void* ppool, const void* vpool,
                                const void* prow, int V, const void* delw,
                                const void* filtw, const void* tcode,
                                const void* wshard, const void* sid, int Bq,
                                int nblk, int T, int with_counts, void* allub,
                                void* ub4, void* ub16, void* g1, void* cnt,
                                void* mwords, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 2:
      return launch_t<2>(ppool, vpool, prow, V, delw, filtw, tcode, wshard, sid,
                         Bq, nblk, with_counts, allub, ub4, ub16, g1, cnt, mwords,
                         s);
    case 4:
      return launch_t<4>(ppool, vpool, prow, V, delw, filtw, tcode, wshard, sid,
                         Bq, nblk, with_counts, allub, ub4, ub16, g1, cnt, mwords,
                         s);
    case 8:
      return launch_t<8>(ppool, vpool, prow, V, delw, filtw, tcode, wshard, sid,
                         Bq, nblk, with_counts, allub, ub4, ub16, g1, cnt, mwords,
                         s);
    default:
      return -1;
  }
}

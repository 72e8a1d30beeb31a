// Phase-1 bucket-WAND scan (K1) for Hopper.
//
// Replaces the Pallas kernel seekstorm_tpu/ops/wand_pallas.py::_kernel /
// scan_blocks (the pallas_call at wand_pallas.py:247) and its XLA twin, the
// lax.scan step of seekstorm_tpu/ops/wand.py::_scan_local.
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
// and the class holds every required column.
//
// What bounds it on an H100: bytes.  Per (query, block, word) the kernel
// reads T presence words and T bucket-max words (8*T bytes) and writes one
// f32 UB (4 bytes); the arithmetic is a few dozen integer and float ops.
// The design keeps every per-(query, word) intermediate in registers (the
// XLA step materialises ~10 [Bq, NW] temporaries per block in HBM), reads
// the pool rows by index inside the kernel (no [NBLK, V, NW] pre-gather as
// in the Pallas wrapper), and lays one thread per word so a warp reads 128
// contiguous bytes of a row.  Queries of a tile that share a term re-read
// the same row, which the 50 MB L2 serves.
//
// Numerics: the UB chains are written with __fmul_rn / __fadd_rn so nvcc
// cannot contract them into fma; each term rounds twice, exactly like the
// plain PyTorch version (scan_blocks_ref) and the host rescore, so the
// kernel is bit-exact against the plain version and UB >= exact score
// holds bitwise.  Counts are integer atomics, whose sum is order-free.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 2048;      // u32 words (32-doc buckets) per 64K-doc block
constexpr int THREADS = 256;  // words per CTA, one thread each
constexpr int QT = 16;        // queries per CTA (loop inside the thread)

template <int T, bool FILTER, bool COUNTS>
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
                 float* __restrict__ allub,            // [Bq, NBLK*NW]
                 int32_t* __restrict__ cnt) {          // [Bq], zeroed
  constexpr int NC = T < 3 ? T : 3;
  const float ninf = __int_as_float(0xff800000);
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.z * QT;

  __shared__ int s_row[QT][T];     // pool row of (query, column), -1 absent
  __shared__ float s_w[QT][T];     // idf weight of a scoring column
  __shared__ uint32_t s_req[QT];   // bit t: required positive column
  __shared__ uint32_t s_pos[QT];   // bit t: positive column
  __shared__ uint32_t s_neg[QT];   // bit t: negated column
  __shared__ int s_cnt[QT];

  if (threadIdx.x < QT) {
    const int qq = threadIdx.x;
    const int q = q0 + qq;
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
      s_row[qq][t] = okp ? row : -1;
      s_w[qq][t] = (okp && !is_neg) ? wshard[(shard * Bq + q) * T + t] : 0.f;
      if (s >= 0 && is_req && !is_neg) req |= 1u << t;
      if (s >= 0 && !is_neg) pos |= 1u << t;
      if (s >= 0 && is_neg) neg |= 1u << t;
    }
    s_req[qq] = req;
    s_pos[qq] = pos;
    s_neg[qq] = neg;
    s_cnt[qq] = 0;
  }
  __syncthreads();

  uint32_t notdel = ~delw[b * NW + w];
  if (FILTER) notdel &= ~filtw[b * NW + w];
  const size_t row_stride = static_cast<size_t>(nblk) * NW;
  const int lane = threadIdx.x & 31;

  for (int qq = 0; qq < QT; ++qq) {
    const int q = q0 + qq;
    if (q >= Bq) break;  // uniform over the CTA
    const uint32_t reqm = s_req[qq], posm = s_pos[qq], negm = s_neg[qq];
    uint32_t pres[T];
    float bval[T];
    uint32_t andw = 0xffffffffu, posw = 0u, negw = 0u;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int row = s_row[qq][t];
      uint32_t p = 0u;
      float bv = 0.f;
      if (row >= 0) {
        const size_t off = static_cast<size_t>(row) * NW + w;
        p = ppool[off];
        if (!((negm >> t) & 1u)) bv = __fmul_rn(s_w[qq][t], vpool[off]);
      }
      pres[t] = p;
      bval[t] = bv;
      if ((reqm >> t) & 1u) andw &= p;
      if ((posm >> t) & 1u) posw |= p;
      if ((negm >> t) & 1u) negw |= p;
    }
    const uint32_t matched = andw & posw & ~negw & notdel;
    if (COUNTS) {
      const int c = __reduce_add_sync(0xffffffffu, __popc(matched));
      if (lane == 0 && c) atomicAdd(&s_cnt[qq], c);
    }
    float best = ninf;
#pragma unroll
    for (int c = 1; c < (1 << NC); ++c) {
      uint32_t mm = 0xffffffffu;
      bool okc = true;
      bool first = true;
      float sc = 0.f;
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        if ((c >> t) & 1) {
          mm &= pres[t];
          sc = first ? bval[t] : __fadd_rn(sc, bval[t]);
          first = false;
        } else {
          mm &= ~pres[t];
          okc = okc && !((reqm >> t) & 1u);
        }
      }
#pragma unroll
      for (int t = NC; t < T; ++t) sc = __fadd_rn(sc, bval[t]);
      if (mm != 0u && okc) best = fmaxf(best, sc);
    }
    allub[static_cast<size_t>(q) * row_stride + static_cast<size_t>(b) * NW + w] =
        matched != 0u ? best : ninf;
  }

  if (COUNTS) {
    __syncthreads();
    if (threadIdx.x < QT) {
      const int q = q0 + threadIdx.x;
      if (q < Bq && s_cnt[threadIdx.x]) atomicAdd(&cnt[q], s_cnt[threadIdx.x]);
    }
  }
}

template <int T>
cudaError_t launch_t(const void* ppool, const void* vpool, const void* prow,
                     int V, const void* delw, const void* filtw,
                     const void* tcode, const void* wshard, const void* sid,
                     int Bq, int nblk, int with_counts, void* allub, void* cnt,
                     cudaStream_t stream) {
  const dim3 grid(NW / THREADS, nblk, (Bq + QT - 1) / QT);
  const dim3 block(THREADS);
  auto args = [&](auto kern) {
    kern<<<grid, block, 0, stream>>>(
        static_cast<const uint32_t*>(ppool), static_cast<const float*>(vpool),
        static_cast<const int32_t*>(prow), V,
        static_cast<const uint32_t*>(delw), static_cast<const uint32_t*>(filtw),
        static_cast<const int32_t*>(tcode), static_cast<const float*>(wshard),
        static_cast<const int32_t*>(sid), Bq, nblk,
        static_cast<float*>(allub), static_cast<int32_t*>(cnt));
  };
  const bool filt = filtw != nullptr;
  if (filt && with_counts) args(wand_scan_kernel<T, true, true>);
  else if (filt) args(wand_scan_kernel<T, true, false>);
  else if (with_counts) args(wand_scan_kernel<T, false, true>);
  else args(wand_scan_kernel<T, false, false>);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch, or -1 for an unsupported T.
extern "C" int wand_scan_launch(const void* ppool, const void* vpool,
                                const void* prow, int V, const void* delw,
                                const void* filtw, const void* tcode,
                                const void* wshard, const void* sid, int Bq,
                                int nblk, int T, int with_counts, void* allub,
                                void* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 2:
      return launch_t<2>(ppool, vpool, prow, V, delw, filtw, tcode, wshard, sid,
                         Bq, nblk, with_counts, allub, cnt, s);
    case 4:
      return launch_t<4>(ppool, vpool, prow, V, delw, filtw, tcode, wshard, sid,
                         Bq, nblk, with_counts, allub, cnt, s);
    case 8:
      return launch_t<8>(ppool, vpool, prow, V, delw, filtw, tcode, wshard, sid,
                         Bq, nblk, with_counts, allub, cnt, s);
    default:
      return -1;
  }
}

// Committed vector scan (K4) for Hopper.
//
// Replaces the tiled distance scan of the JAX package,
// seekstorm_tpu/ops/vector.py::vector_scan_topk (74-157), which XLA runs
// as one program: gather the selected tiles, q[B,d] . tiles[NT*256,d]^T
// (i8 x i8 -> i32 on the MXU, or f32 at Precision.HIGHEST), the rank-1
// affine corrections, the Euclidean norm trick, the delete / field /
// threshold masks, per-query counts and lax.top_k over the whole
// [B, NT*256] score matrix.  Here the score matrix never reaches device
// memory: one CTA scores one 256-row tile against a block of QB queries
// and writes only that tile's top-kk (kk = min(k, 256)) per query,
// ordered by (score desc, row asc), as [B, NT, kk] values and global
// rows; the caller merges the tiles' lists with one stable sort, which
// keeps lax.top_k's order (the lower position first on ties).
//
// Inputs: data [n_tiles, 256, W] 32-bit words (W = d/4 packed i8, or d
// f32); per row scale, zp, qsum, norm2 (f32), docid, fieldid (i32);
// deleted[n_deleted] by docid and field_ok[n_field] by field id (bytes;
// an index past the end reads as set, jnp.take's fill for a bool array);
// tile_ids[NT] the selected tiles (-1 = padding, scored as tile 0 with
// every row invalid), or null for all tiles in order; queries [B, W] with
// scale, zp, qsum, norm2 and score_min (f32).  Counts are added to
// counts[B], which the caller zeroes.
//
// Arithmetic, in the order of the reference's CPU backend (which contracts
// the corrections into fused multiply-adds, the first one by whether its
// program gathers the tiles), so the i8 mode is bitwise equal to the plain
// version:
//   Q    = sum q*r over d           (__dp4a, i32, exact for d <= 1024)
//   core = ((Q + 128 Sa) + 128 Sb) + 16384 d
//   a    = fma(sa sb, core, (sa zb) (Sa + 128 d))    all tiles, or one
//   a    = fma(sa zb, Sa + 128 d, (sa sb) core)      2+ selected tiles
//   dot  = fma(d za, zb, fma(sb za, Sb + 128 d, a))
//   f32 mode: dot = fma(q_{d-1}, r_{d-1}, ... fma(q_0, r_0, 0)), one fixed
//              order; it differs from a matmul's only by the sum order.
//   Euclidean: score = -((|q|^2 + |r|^2) - 2 dot)
// Every product and sum is written with __fmul_rn / __fadd_rn /
// __fmaf_rn: nvcc would otherwise contract a*b+c on its own.
//
// What bounds it on an H100: bytes.  Each tile row is read once (d bytes
// i8 plus 24 bytes of stats), the queries are a few KB, and the dots at
// the serving shape (B=64, 1M rows, d=128) are 17 G int8 operations, 9 us
// at the tensor cores' 1,979 TOPS against 48 us for the 160 MB.  This
// first version is right before it is fast: one thread a row, the tile
// staged 32 words a row at a time in shared memory (a padded row stride,
// so a warp's column reads hit 32 banks), the queries' words read four at
// a time as broadcasts, __dp4a or __fmaf_rn per word and query; then the
// masked scores of each query become 64-bit keys (score order-mapped, row
// below).  For kk <= 32 (every page of up to 16 results) each warp sorts
// its 32 keys in registers (shuffles), and one warp a query folds the 8
// warps' sorted runs into the top 32 (a bitonic merge of 5 shuffle stages
// a run); deeper pages sort all 256 keys in shared memory (bitonic, 36
// stages).  The sort, not the dots, is this version's time; tensor cores
// (s8 wgmma), TMA staging and a persistent grid are the later redesign.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int T = 256;                 // rows a tile, one thread a row
constexpr int THREADS = T;
constexpr int QB = 32;                 // queries a CTA
constexpr int CW = 32;                 // words of a row staged at a time
constexpr int RS = CW + 1;             // padded row stride (words)
constexpr int STAGE_BYTES = (T * RS + QB * CW) * 4;
constexpr int KEY_BYTES = QB * T * 8;
constexpr int REGION_A = KEY_BYTES > STAGE_BYTES ? KEY_BYTES : STAGE_BYTES;
constexpr int VAL_BYTES = QB * T * 4;
constexpr int SMEM_BYTES = REGION_A + VAL_BYTES + QB * 4;

static_assert((T * RS * 4) % 16 == 0, "query words must be 16-byte aligned");

using Key = unsigned long long;

__device__ __forceinline__ Key keep(Key a, Key b, bool keep_min) {
  return (a < b) == keep_min ? a : b;
}

// Sorts one key a lane ascending across the warp (bitonic, 15 stages).
__device__ __forceinline__ Key warp_sort32(Key key, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const Key o = __shfl_xor_sync(0xffffffffu, key, stride);
      key = keep(key, o, ((lane & stride) == 0) == ((lane & size) == 0));
    }
  }
  return key;
}

// Sorts a bitonic sequence, one key a lane, ascending (5 stages).
__device__ __forceinline__ Key warp_merge32(Key key, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const Key o = __shfl_xor_sync(0xffffffffu, key, stride);
    key = keep(key, o, (lane & stride) == 0);
  }
  return key;
}

template <bool QUANT>
__global__ void __launch_bounds__(THREADS)
vector_scan_kernel(const uint32_t* __restrict__ data,
                   const float* __restrict__ scale,
                   const float* __restrict__ zp,
                   const float* __restrict__ qsum,
                   const float* __restrict__ norm2,
                   const int* __restrict__ docid,
                   const int* __restrict__ fieldid,
                   const unsigned char* __restrict__ deleted, int n_deleted,
                   const unsigned char* __restrict__ field_ok, int n_field,
                   const int* __restrict__ tile_ids, int NT,
                   const uint32_t* __restrict__ q_data,
                   const float* __restrict__ q_scale,
                   const float* __restrict__ q_zp,
                   const float* __restrict__ q_qsum,
                   const float* __restrict__ q_norm2,
                   const float* __restrict__ score_min,
                   int B, int d, int W, int kk, int euclidean, int use_ff,
                   int with_counts, float* __restrict__ out_vals,
                   int* __restrict__ out_rows, int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tile_s = reinterpret_cast<uint32_t*>(smem);       // [T][RS]
  uint32_t* q_s = tile_s + T * RS;                              // [QB][CW]
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(smem);              // [QB][T]
  float* vals = reinterpret_cast<float*>(smem + REGION_A);      // [QB][T]
  int* cnt_s = reinterpret_cast<int*>(smem + REGION_A + VAL_BYTES);

  const int t = threadIdx.x;
  const int slot = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, B - q0);
  const int tile = tile_ids ? tile_ids[slot] : slot;
  const int tc = max(tile, 0);
  const uint32_t* tile_g = data + (size_t)tc * T * W;
  if (t < QB) cnt_s[t] = 0;

  using Acc = typename std::conditional<QUANT, int, float>::type;
  Acc acc[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) acc[j] = 0;

  for (int c0 = 0; c0 < W; c0 += CW) {
    __syncthreads();                   // the last chunk is consumed
    for (int i = t; i < T * CW; i += THREADS) {
      const int r = i / CW, w = i % CW;
      tile_s[r * RS + w] = tile_g[(size_t)r * W + c0 + w];
    }
    for (int i = t; i < QB * CW; i += THREADS) {
      const int j = i / CW, w = i % CW;
      q_s[i] = j < nq ? q_data[(size_t)(q0 + j) * W + c0 + w] : 0u;
    }
    __syncthreads();
    const uint32_t* my = tile_s + t * RS;
    for (int w = 0; w < CW; w += 4) {
      const uint32_t r0 = my[w], r1 = my[w + 1], r2 = my[w + 2],
                     r3 = my[w + 3];
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        const uint4 q = *reinterpret_cast<const uint4*>(q_s + j * CW + w);
        if constexpr (QUANT) {
          acc[j] = __dp4a((int)r0, (int)q.x, acc[j]);
          acc[j] = __dp4a((int)r1, (int)q.y, acc[j]);
          acc[j] = __dp4a((int)r2, (int)q.z, acc[j]);
          acc[j] = __dp4a((int)r3, (int)q.w, acc[j]);
        } else {
          acc[j] = __fmaf_rn(__uint_as_float(q.x), __uint_as_float(r0),
                             acc[j]);
          acc[j] = __fmaf_rn(__uint_as_float(q.y), __uint_as_float(r1),
                             acc[j]);
          acc[j] = __fmaf_rn(__uint_as_float(q.z), __uint_as_float(r2),
                             acc[j]);
          acc[j] = __fmaf_rn(__uint_as_float(q.w), __uint_as_float(r3),
                             acc[j]);
        }
      }
    }
  }
  __syncthreads();                     // staging done: keys reuse it

  // the row's mask and stats
  const size_t row = (size_t)tc * T + t;
  const int doc = docid[row];
  const int dc = max(doc, 0);
  bool ok = doc >= 0 && tile >= 0 && !(dc >= n_deleted || deleted[dc]);
  if (use_ff) {
    const int fc = max(fieldid[row], 0);
    ok = ok && (fc >= n_field || field_ok[fc]);
  }
  const float sb = scale[row], zb = zp[row], Sb = qsum[row], n2 = norm2[row];
  const float fd = (float)d;
  const float c128d = __fmul_rn(128.f, fd);
  const float c16384d = __fmul_rn(16384.f, fd);
  const float Sb_c = __fadd_rn(Sb, c128d);
  const float Sb_128 = __fmul_rn(128.f, Sb);

#pragma unroll
  for (int j = 0; j < QB; ++j) {
    const int qi = min(q0 + j, B - 1);
    float s;
    if constexpr (QUANT) {
      const float sa = q_scale[qi], za = q_zp[qi], Sa = q_qsum[qi];
      const float core = __fadd_rn(
          __fadd_rn(__fadd_rn((float)acc[j], __fmul_rn(128.f, Sa)), Sb_128),
          c16384d);
      float a;
      if (tile_ids && NT > 1)
        a = __fmaf_rn(__fmul_rn(sa, zb), __fadd_rn(Sa, c128d),
                      __fmul_rn(__fmul_rn(sa, sb), core));
      else
        a = __fmaf_rn(__fmul_rn(sa, sb), core,
                      __fmul_rn(__fmul_rn(sa, zb), __fadd_rn(Sa, c128d)));
      a = __fmaf_rn(__fmul_rn(sb, za), Sb_c, a);
      s = __fmaf_rn(__fmul_rn(fd, za), zb, a);
    } else {
      s = acc[j];
    }
    if (euclidean)
      s = -__fsub_rn(__fadd_rn(q_norm2[qi], n2), __fmul_rn(2.f, s));
    const bool m = ok && j < nq && s >= score_min[qi];
    const float v = m ? s : -INFINITY;
    vals[j * T + t] = v;
    // ascending key = descending score (-0 ties +0), then ascending row
    const uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);
    const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    const Key key = ((Key)(~ord) << 32) | (unsigned)t;
    // kk <= 32: each warp's 32 rows sorted here, in registers
    keys[j * T + t] = kk <= 32 ? warp_sort32(key, t & 31) : key;
    if (with_counts) {
      const unsigned b = __ballot_sync(0xffffffffu, m);
      if ((t & 31) == 0 && b) atomicAdd(&cnt_s[j], __popc(b));
    }
  }
  __syncthreads();

  if (kk <= 32) {
    // top 32 of the 8 warps' sorted runs, a warp a query: the 32 smallest
    // of two sorted runs are min(a[i], b[31-i]), a bitonic sequence that
    // 5 shuffle stages sort
    const int lane = t & 31;
    for (int j = t >> 5; j < nq; j += THREADS / 32) {
      const Key* kj = keys + j * T;
      Key acc = kj[lane];
      for (int r = 1; r < T / 32; ++r) {
        const Key b = kj[r * 32 + 31 - lane];
        acc = warp_merge32(acc < b ? acc : b, lane);
      }
      if (lane < kk) {
        const int lt = (int)(acc & 0xffffffffu);
        const size_t o = ((size_t)(q0 + j) * NT + slot) * kk + lane;
        out_vals[o] = vals[j * T + lt];
        out_rows[o] = tc * T + lt;
      }
    }
    if (with_counts && t < nq && cnt_s[t])
      atomicAdd(&counts[q0 + t], cnt_s[t]);
    return;
  }

  // kk > 32: bitonic sort of each query's 256 keys in shared memory
  for (int size = 2; size <= T; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int c = t; c < nq * (T / 2); c += THREADS) {
        const int j = c / (T / 2), p = c % (T / 2);
        const int i = 2 * stride * (p / stride) + (p % stride);
        unsigned long long* kj = keys + j * T;
        const unsigned long long a = kj[i], b = kj[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          kj[i] = b;
          kj[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int c = t; c < nq * kk; c += THREADS) {
    const int j = c / kk, r = c % kk;
    const int lt = (int)(keys[j * T + r] & 0xffffffffu);
    const size_t o = ((size_t)(q0 + j) * NT + slot) * kk + r;
    out_vals[o] = vals[j * T + lt];
    out_rows[o] = tc * T + lt;
  }
  if (with_counts && t < nq && cnt_s[t]) atomicAdd(&counts[q0 + t], cnt_s[t]);
}

template <bool QUANT>
int launch(dim3 grid, cudaStream_t stream, const void* data,
           const float* scale, const float* zp, const float* qsum,
           const float* norm2, const int* docid, const int* fieldid,
           const unsigned char* deleted, int n_deleted,
           const unsigned char* field_ok, int n_field, const int* tile_ids,
           int NT, const void* q_data, const float* q_scale,
           const float* q_zp, const float* q_qsum, const float* q_norm2,
           const float* score_min, int B, int d, int kk, int euclidean,
           int use_ff, int with_counts, float* out_vals, int* out_rows,
           int* counts) {
  cudaError_t err = cudaFuncSetAttribute(
      vector_scan_kernel<QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int W = QUANT ? d / 4 : d;
  vector_scan_kernel<QUANT><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const uint32_t*>(data), scale, zp, qsum, norm2, docid,
      fieldid, deleted, n_deleted, field_ok, n_field, tile_ids, NT,
      static_cast<const uint32_t*>(q_data), q_scale, q_zp, q_qsum, q_norm2,
      score_min, B, d, W, kk, euclidean, use_ff, with_counts, out_vals,
      out_rows, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// d a multiple of 128, 1 <= kk <= 256, NT >= 1, B >= 1; tile_ids may be
// null (all NT tiles in order).  Returns cudaGetLastError() after the
// launch.
extern "C" int vector_scan_launch(
    const void* data, const float* scale, const float* zp, const float* qsum,
    const float* norm2, const int* docid, const int* fieldid,
    const unsigned char* deleted, int n_deleted,
    const unsigned char* field_ok, int n_field, const int* tile_ids, int NT,
    const void* q_data, const float* q_scale, const float* q_zp,
    const float* q_qsum, const float* q_norm2, const float* score_min, int B,
    int d, int kk, int quantized, int euclidean, int use_ff,
    int with_counts, float* out_vals, int* out_rows, int* counts,
    cudaStream_t stream) {
  if (d <= 0 || d % 128 || kk < 1 || kk > T || NT < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(NT, (B + QB - 1) / QB);
  if (quantized)
    return launch<true>(grid, stream, data, scale, zp, qsum, norm2, docid,
                        fieldid, deleted, n_deleted, field_ok, n_field,
                        tile_ids, NT, q_data, q_scale, q_zp, q_qsum, q_norm2,
                        score_min, B, d, kk, euclidean, use_ff, with_counts,
                        out_vals, out_rows, counts);
  return launch<false>(grid, stream, data, scale, zp, qsum, norm2, docid,
                       fieldid, deleted, n_deleted, field_ok, n_field,
                       tile_ids, NT, q_data, q_scale, q_zp, q_qsum, q_norm2,
                       score_min, B, d, kk, euclidean, use_ff, with_counts,
                       out_vals, out_rows, counts);
}

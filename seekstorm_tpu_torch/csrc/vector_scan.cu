// Committed vector scan (K4) for Hopper.
//
// Replaces the tiled distance scan of the JAX package,
// seekstorm_tpu/ops/vector.py::vector_scan_topk (74-157), which XLA runs
// as one program: gather the selected tiles, q[B,d] . tiles[NT*256,d]^T
// (i8 x i8 -> i32 on the MXU, or f32 at Precision.HIGHEST), the rank-1
// affine corrections, the Euclidean norm trick, the delete / field /
// threshold masks, per-query counts and lax.top_k over the whole
// [B, NT*256] score matrix.  The score matrix never reaches device memory.
//
// Inputs: data [n_tiles, 256, W] 32-bit words (W = d/4 packed i8, or d
// f32); per row scale, zp, qsum, norm2 (f32), docid, fieldid (i32);
// deleted[n_deleted] by docid and field_ok[n_field] by field id (bytes;
// an index past the end reads as set, jnp.take's fill for a bool array);
// tile_ids[NT] the selected tiles (-1 = padding, scored as tile 0 with
// every row invalid), or null for all tiles in order; queries [B, W] with
// scale, zp, qsum, norm2 and score_min (f32).  Counts are added to
// counts[B], which the caller zeroes.  Outputs: the top k by (score desc,
// position asc), position = slot*256 + row in the tile (lax.top_k's order,
// ties to the lower position), as scores [B, k] and global rows [B, k],
// (-inf, row 0) past kk = min(k, NT*256).
//
// Arithmetic, in the order of the reference's CPU backend (which contracts
// the corrections into fused multiply-adds, the first one by whether its
// program gathers the tiles), so the i8 mode is bitwise equal to the plain
// version:
//   Q    = sum q*r over d           (s8 tensor cores, i32, exact)
//   core = ((Q + 128 Sa) + 128 Sb) + 16384 d
//   a    = fma(sa sb, core, (sa zb) (Sa + 128 d))    all tiles, or one
//                                                   slot, or a 1-tile pool
//   a    = fma(sa zb, Sa + 128 d, (sa sb) core)      2+ selected slots of a
//                                                   pool of 2+ tiles
//   dot  = fma(d za, zb, fma(sb za, Sb + 128 d, a))
//   f32 mode: dot = fma(q_{d-1}, r_{d-1}, ... fma(q_0, r_0, 0)), one fixed
//              order on CUDA cores (TF32 would break the f32 contract);
//              it differs from a matmul's only by the sum order.
//   Euclidean: score = -((|q|^2 + |r|^2) - 2 dot)
// Every product and sum is written with __fmul_rn / __fadd_rn /
// __fmaf_rn: nvcc would otherwise contract a*b+c on its own.  Ranking
// uses 64-bit keys, ascending: the order-mapped score (-0 tied with +0)
// above the position; a key is unique within a query.
//
// What bounds it on an H100: bytes.  Each row is read once (d bytes i8
// plus 24 bytes of stats); at the serving shape (B=64, 1M rows, d=128)
// that is 160 MB, 48 us, against 17 G int8 operations, 9 us at the tensor
// cores' 1,979 TOPS.  What the design meets first is neither: the
// corrections are about 15 scalar f32 operations a (query, row) pair, and
// keeping each query's top k costs list upkeep for every row that may
// enter it; both are cut as far as they go below.
//
// 1. Pages up to 32 (kk <= 32, every page of up to 16 results): the
//    running scan, three launches.  A persistent grid of G CTAs (512
//    threads) a block of 64 queries, about one CTA an SM; CTA g walks the
//    contiguous slot range [g*NT/G, (g+1)*NT/G) once for all 64 queries:
//      - a 3-stage ring in shared memory filled by 16-byte cp.async, one
//        stage = 128 bytes of each of the tile's 256 rows (a k-chunk; d >
//        128 i8 or any f32 takes several), the queries' same 128 bytes
//        and, with a slot's first chunk, its rows' stats; each 16-byte
//        piece XORed by row & 7 so ldmatrix reads hit 32 banks; the next
//        slot's delete and field flags are gathered a slot ahead;
//      - i8: mma.sync m16n8k32 s8 x s8 -> s32; warp w takes the query
//        m16 tile w & 3 and the 64 rows of block w >> 2 (8 n8 tiles);
//        f32: the same (query, row) pairs by __fmaf_rn chains;
//      - the epilogue (specialised on the modes, no branch a pair) turns
//        each thread's 32 sums into masked scores (counted per thread) in
//        a [64][256] shared matrix and flags each query with a row that
//        beats its threshold; then a warp takes 4 queries, and a flagged
//        one's rows join its running top-32 in shared memory: up to 3 by
//        a shuffle each, up to 32 compacted into one run that is sorted
//        in registers (bitonic) and folded in, more as 8 runs sorted side
//        by side and folded pairwise.
//    A row enters only below a query's threshold, the smallest of three
//    bounds.  Each has kk distinct rows at or below it, so a row above it
//    is in no top kk, and a row equal to it is one of those kk, which
//    must still enter its list: its own list's kk-th (that row is in the
//    list already); gthr, first the kk-th smallest of the G ranges' best
//    keys over their first slot (launch 1, the probe pass, and launch 2,
//    select_threshold) plus one, lowered by atomicMin of every CTA's
//    kk-th; and the largest of kk buckets plus one, bucket b holding the
//    best row found by the ranges g = b (mod kk), which every CTA lowers
//    as it finds better rows.  So a range admits few rows from its first
//    slot on.
//    Each CTA writes its list per query, ascending (entries it skipped by
//    the shared threshold stay sentinels); counts go out once a CTA.
// 2. Deeper pages (32 < k): K4's first kernel (commit ed057dd), kept as
//    the branch for them (as K3 kept its first kernel for its wide case):
//    one CTA scores one tile against 32 queries with __dp4a and sorts the
//    tile's 256 keys in shared memory (bitonic), writing each tile's top
//    min(k, 256).
// Then the merge (both cases): one CTA a query takes the top kk of its
// sorted lists.  Up to 8,192 entries a query, in one pass: every entry at
// or below the running scan's shared threshold into shared memory, one
// bitonic sort.  More (deep pages): each thread walks its lists in order,
// copying entries whose key is below the running kk-th key into a buffer;
// the buffer is sorted and folded into the running top-P (P = kk rounded
// up to a power of two, in shared memory up to 4,096 entries, else in the
// caller's scratch), until no list has an entry left below the threshold.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int T = 256;                 // rows a tile
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

using Key = unsigned long long;
constexpr Key KEY_MAX = ~0ull;
constexpr uint32_t POS_NONE = 0xffffffffu;

// the running scan's kk buckets (section 1 above); a build with
// -DK4_BUCKETS=0 keeps only gthr and each CTA's own kk-th, which
// k1_compare.py --k4 times beside it
#ifndef K4_BUCKETS
#define K4_BUCKETS 1
#endif
constexpr bool BUCKETS = K4_BUCKETS != 0;

// ascending key = descending score (-0 ties +0), then ascending position;
// (NaN 0xffffffff, POS_NONE) is the sentinel KEY_MAX
__device__ __forceinline__ Key make_key(float v, uint32_t pos) {
  const uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((Key)(~ord) << 32) | pos;
}

__device__ __forceinline__ float sentinel_v() {
  return __uint_as_float(0xffffffffu);
}

// the score of one (query, row) from its dot (i32 sum as f32, or the f32
// chain) in the reference's order (header)
template <bool QUANT, bool GATHERED, bool EUCLID>
__device__ __forceinline__ float finish_t(float acc, float sa, float za,
                                          float Sa, float qn2, float sb,
                                          float zb, float Sb, float n2,
                                          float fd) {
  float s = acc;
  if constexpr (QUANT) {
    const float c128d = __fmul_rn(128.f, fd);
    const float core = __fadd_rn(
        __fadd_rn(__fadd_rn(acc, __fmul_rn(128.f, Sa)), __fmul_rn(128.f, Sb)),
        __fmul_rn(16384.f, fd));
    float a;
    if constexpr (GATHERED)
      a = __fmaf_rn(__fmul_rn(sa, zb), __fadd_rn(Sa, c128d),
                    __fmul_rn(__fmul_rn(sa, sb), core));
    else
      a = __fmaf_rn(__fmul_rn(sa, sb), core,
                    __fmul_rn(__fmul_rn(sa, zb), __fadd_rn(Sa, c128d)));
    a = __fmaf_rn(__fmul_rn(sb, za), __fadd_rn(Sb, c128d), a);
    s = __fmaf_rn(__fmul_rn(fd, za), zb, a);
  }
  if constexpr (EUCLID)
    s = -__fsub_rn(__fadd_rn(qn2, n2), __fmul_rn(2.f, s));
  return s;
}

template <bool QUANT>
__device__ __forceinline__ float finish(float acc, float sa, float za,
                                        float Sa, float qn2, float sb,
                                        float zb, float Sb, float n2,
                                        float fd, bool gathered,
                                        bool euclidean) {
  if (gathered)
    return euclidean ? finish_t<QUANT, true, true>(acc, sa, za, Sa, qn2, sb,
                                                   zb, Sb, n2, fd)
                     : finish_t<QUANT, true, false>(acc, sa, za, Sa, qn2,
                                                    sb, zb, Sb, n2, fd);
  return euclidean ? finish_t<QUANT, false, true>(acc, sa, za, Sa, qn2, sb,
                                                  zb, Sb, n2, fd)
                   : finish_t<QUANT, false, false>(acc, sa, za, Sa, qn2, sb,
                                                   zb, Sb, n2, fd);
}

__device__ __forceinline__ bool row_ok(int doc, int tile, int fid,
                                       const unsigned char* deleted,
                                       int n_deleted,
                                       const unsigned char* field_ok,
                                       int n_field, int use_ff) {
  const int dc = max(doc, 0);
  bool ok = doc >= 0 && tile >= 0 && !(dc >= n_deleted || deleted[dc]);
  if (use_ff) {
    const int fc = max(fid, 0);
    ok = ok && (fc >= n_field || field_ok[fc]);
  }
  return ok;
}

// ---------------------------------------------------------------------------
// warp sorts of (key, score) pairs, one pair a lane (the position is the
// key's low half)

// the pair of lane ^ stride replaces this lane's when the comparison says so
__device__ __forceinline__ void exchange(Key& k, float& v, int stride,
                                         bool keep_min) {
  const Key ok = __shfl_xor_sync(FULL, k, stride);
  const float ov = __shfl_xor_sync(FULL, v, stride);
  if ((k < ok) != keep_min) {
    k = ok;
    v = ov;
  }
}

// ascending across the warp (bitonic, 15 stages)
__device__ __forceinline__ void warp_sort32(Key& k, float& v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(k, v, stride, ((lane & stride) == 0) == ((lane & size) == 0));
  }
}

// the 32 smallest of two ascending runs, a and b: min(a[i], b[31-i]) is a
// bitonic sequence, which 5 stages sort ascending into a
__device__ __forceinline__ void fold(Key& ak, float& av, Key bk, float bv,
                                     int lane) {
  const Key rk = __shfl_sync(FULL, bk, 31 - lane);
  const float rv = __shfl_sync(FULL, bv, 31 - lane);
  if (rk < ak) {
    ak = rk;
    av = rv;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    exchange(ak, av, stride, (lane & stride) == 0);
}

// the 32 smallest keys of 8 runs of 32 (run r in k[r], v[r]), ascending
// into k[0], v[0]: the 8 runs sorted side by side (bitonic, 15 stages),
// then folded pairwise (3 rounds), each stage's 8 or fewer exchanges
// independent of each other
__device__ __forceinline__ void top32_of_runs(Key (&k)[8], float (&v)[8],
                                              int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
#pragma unroll
      for (int r = 0; r < 8; ++r) exchange(k[r], v[r], stride, keep_min);
    }
  }
#pragma unroll
  for (int hh = 1; hh < 8; hh <<= 1) {
#pragma unroll
    for (int r = 0; r < 8; r += 2 * hh) {
      const Key rk = __shfl_sync(FULL, k[r + hh], 31 - lane);
      const float rv = __shfl_sync(FULL, v[r + hh], 31 - lane);
      if (rk < k[r]) {
        k[r] = rk;
        v[r] = rv;
      }
    }
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
#pragma unroll
      for (int r = 0; r < 8; r += 2 * hh)
        exchange(k[r], v[r], stride, (lane & stride) == 0);
    }
  }
}

// a threshold key as a float test: a row (v, pos) beats it when v > ts,
// or v == ts and pos < tp; KEY_MAX (no threshold) becomes (-inf,
// POS_NONE), which every row beats
__device__ __forceinline__ void key_to_thr(Key key, float& ts, uint32_t& tp) {
  if (key == KEY_MAX) {
    ts = -INFINITY;
    tp = POS_NONE;
    return;
  }
  const uint32_t ord = ~(uint32_t)(key >> 32);
  ts = __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
  tp = (uint32_t)key;
}

// ---------------------------------------------------------------------------
// 1. the running scan (kk <= 32)

namespace run {

constexpr int QM = 64;                 // queries a CTA: four m16 tiles
constexpr int RT = 512;                // threads a CTA
constexpr int WARPS = RT / 32;
constexpr int QW = QM / WARPS;         // queries a warp in the warp pass
constexpr int NI = T / (WARPS / 4) / 8;  // n8 row tiles a warp in the dots
constexpr int KK = 32;                 // running list a query
constexpr int CB = 128;                // bytes of a row a stage
constexpr int STAGES = 3;
constexpr int TILE_B = T * CB;
constexpr int QRY_B = QM * CB;
constexpr int STAT_B = T * 4 * 5;      // scale, zp, qsum, norm2, docid
constexpr int STAGE_B = TILE_B + QRY_B + STAT_B;
constexpr int S_B = QM * T * 4;        // masked scores of a tile
constexpr int LIST_B = QM * KK * 8;    // (score, position) lists
constexpr int ROW_B = T * 16 + T;      // a slot's (scale, zp, qsum, norm2), ok
constexpr int THR_B = QM * 8 + QM * 4;  // each query's threshold key, hit
constexpr int RUN_B = WARPS * 32 * 12;  // a warp's compacted run
constexpr int SMEM_BYTES =
    STAGES * STAGE_B + S_B + LIST_B + ROW_B + THR_B + RUN_B;
constexpr int INSERT_MAX = 3;          // admitted rows inserted one at a time

static_assert(SMEM_BYTES <= 232448, "shared memory of one CTA");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte piece `piece` of row `row` in a staged block
__device__ __forceinline__ int swz(int row, int piece) {
  return row * CB + ((piece ^ (row & 7)) << 4);
}

// the masked score matrix [64][256], each query's row XORed by 8*(j & 3)
__device__ __forceinline__ int s_at(int j, int r) {
  return j * T + (r ^ ((j & 3) << 3));
}

// an i32 dot as f32, exactly: |acc| <= d*128*128 <= 2^22 for d <= 256,
// where adding 1.5*2^23 as bits is exact and cheaper than a conversion
__device__ __forceinline__ float to_f32(int acc, bool small_d) {
  return small_d ? __fsub_rn(__int_as_float(acc + 0x4B400000), 12582912.f)
                 : (float)acc;
}
__device__ __forceinline__ float to_f32(float acc, bool) { return acc; }

template <bool QUANT>
__global__ void __launch_bounds__(RT, 1)
running_scan(const unsigned char* __restrict__ data,
             const float* __restrict__ scale, const float* __restrict__ zp,
             const float* __restrict__ qsum, const float* __restrict__ norm2,
             const int* __restrict__ docid, const int* __restrict__ fieldid,
             const unsigned char* __restrict__ deleted, int n_deleted,
             const unsigned char* __restrict__ field_ok, int n_field,
             const int* __restrict__ tile_ids, int NT,
             const unsigned char* __restrict__ q_data,
             const float* __restrict__ q_scale,
             const float* __restrict__ q_zp,
             const float* __restrict__ q_qsum,
             const float* __restrict__ q_norm2,
             const float* __restrict__ score_min, int B, int d, int G,
             int kk, int euclidean, int use_ff, int with_counts, int probe,
             int gath, float* __restrict__ list_v,
             uint32_t* __restrict__ list_p,
             Key* __restrict__ gthr, Key* __restrict__ best,
             Key* __restrict__ bucket, int* __restrict__ counts) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem + STAGES * STAGE_B);
  float* lv = reinterpret_cast<float*>(smem + STAGES * STAGE_B + S_B);
  uint32_t* lp = reinterpret_cast<uint32_t*>(lv + QM * KK);
  float4* rstat = reinterpret_cast<float4*>(smem + STAGES * STAGE_B + S_B +
                                            LIST_B);
  unsigned char* rok = reinterpret_cast<unsigned char*>(rstat + T);
  Key* thr_k = reinterpret_cast<Key*>(rok + T);   // [64] threshold keys

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  Key* run_k = thr_k + QM + 32 * w;               // this warp's [32]
  float* run_v = reinterpret_cast<float*>(thr_k + QM + 32 * WARPS) + 32 * w;
  int* hit = reinterpret_cast<int*>(thr_k + QM + 32 * WARPS) + 32 * WARPS;
  const int g = lane >> 2, tq = lane & 3;
  const int mt = w & 3, h = w >> 2;    // query m16 tile, row block
  const int q0 = blockIdx.y * QM;
  const int s0 = (int)((long long)blockIdx.x * NT / G);
  const int s1 = (int)((long long)(blockIdx.x + 1) * NT / G);
  const int row_bytes = QUANT ? d : 4 * d;
  const int nchunks = row_bytes / CB;
  // the probe pass scores only each range's first slot
  const int n_it = (probe ? 1 : s1 - s0) * nchunks;
  const bool gathered = gath != 0;
  const float fd = (float)d;
  const bool live = q0 + 16 * mt < B;  // the warp's m16 tile has a query
  const bool small_d = d <= 256;

  // the running lists start empty: every key below the sentinel enters
  for (int i = lane; i < QW * KK; i += 32) {
    lv[w * QW * KK + i] = sentinel_v();
    lp[w * QW * KK + i] = POS_NONE;
  }
  if (lane < QW) {
    thr_k[QW * w + lane] = KEY_MAX;
    hit[QW * w + lane] = 0;
  }

  // this thread's two queries (rows g and g+8 of its m16 tile)
  float qsa[2], qza[2], qSa[2], qn2[2], qmin[2];
  bool qval[2];
  int qcnt[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = q0 + 16 * mt + g + 8 * e;
    const int qc = min(q, B - 1);
    qval[e] = q < B;
    qsa[e] = q_scale[qc];
    qza[e] = q_zp[qc];
    qSa[e] = q_qsum[qc];
    qn2[e] = q_norm2[qc];
    qmin[e] = score_min[qc];
  }

  auto tile_of = [&](int slot) {
    return tile_ids ? tile_ids[slot] : slot;
  };

  // stage `it` into ring buffer it % STAGES
  auto issue = [&](int it) {
    if (it < n_it) {
      unsigned char* st = smem + (it % STAGES) * STAGE_B;
      const int slot = s0 + it / nchunks, c = it % nchunks;
      const int tc = max(tile_of(slot), 0);
      const unsigned char* src =
          data + (size_t)tc * T * row_bytes + (size_t)c * CB;
#pragma unroll
      for (int i = 0; i < T * CB / 16 / RT; ++i) {
        const int piece = t + i * RT, r = piece >> 3, p = piece & 7;
        cp_async16(st + swz(r, p), src + (size_t)r * row_bytes + p * 16);
      }
#pragma unroll
      for (int i = 0; i < QM * CB / 16 / RT; ++i) {
        const int piece = t + i * RT, j = piece >> 3, p = piece & 7;
        const int qc = min(q0 + j, B - 1);
        cp_async16(st + TILE_B + swz(j, p),
                   q_data + (size_t)qc * row_bytes + (size_t)c * CB + p * 16);
      }
      if (c == 0) {
        // 5 arrays of 256 4-byte values: 320 pieces of 16 bytes
        if (t < 5 * T / 4) {
          const int a = t / (T / 4), o = (t % (T / 4)) * 4;
          const void* base = a == 0   ? (const void*)scale
                             : a == 1 ? (const void*)zp
                             : a == 2 ? (const void*)qsum
                             : a == 3 ? (const void*)norm2
                                      : (const void*)docid;
          cp_async16(st + TILE_B + QRY_B + (a * T + o) * 4,
                     static_cast<const float*>(base) + (size_t)tc * T + o);
        }
      }
    }
    cp_async_commit();
  };

  using Acc = typename std::conditional<QUANT, int, float>::type;
  Acc acc[NI][4];

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // row t's stats and mask inputs, read at a slot's first chunk
  float4 my_stat = make_float4(0.f, 0.f, 0.f, 0.f);
  int my_doc = -1, my_tile = -1;
  unsigned char my_del = 1, my_fok = 1;
  // the next slot's docid and field id, read at a slot's first chunk, and
  // its deleted and field flags, gathered at the slot's end: a slot's mask
  // waits on no load of its own
  const int s_end = probe ? s0 + 1 : s1;
  int doc_n = -1, fid_n = 0;
  unsigned char del_n = 1, fok_n = 1;
  auto gather_flags = [&]() {
    const int dc = max(doc_n, 0);
    del_n = dc >= n_deleted ? 1 : deleted[dc];
    if (use_ff) {
      const int fc = max(fid_n, 0);
      fok_n = fc >= n_field ? 1 : field_ok[fc];
    }
  };
  if (t < T) {
    const size_t row0 = (size_t)max(tile_of(s0), 0) * T + t;
    doc_n = docid[row0];
    if (use_ff) fid_n = fieldid[row0];
    gather_flags();
  }

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                   // stage it landed; it-1 consumed
    issue(it + STAGES - 1);
    const unsigned char* st = smem + (it % STAGES) * STAGE_B;
    const int slot = s0 + it / nchunks, c = it % nchunks;
    // the shared thresholds of this warp's 4 queries (8 lanes a query:
    // gthr and 4 of its kk buckets each), read now, used after the
    // epilogue
    const int jq = QW * w + (lane >> 3), part = lane & 7;
    Key g_pre = KEY_MAX, b_pre = BUCKETS ? 0 : KEY_MAX;
    if (c == nchunks - 1 && q0 + jq < B) {
      g_pre = *reinterpret_cast<volatile Key*>(gthr + q0 + jq);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (BUCKETS && 4 * part + u < kk) {
          const Key bk = *reinterpret_cast<volatile Key*>(
              bucket + (size_t)(q0 + jq) * 32 + 4 * part + u);
          b_pre = max(b_pre, bk);
        }
      }
    }

    if (c == 0) {
      if (t < T) {
        const float* sf =
            reinterpret_cast<const float*>(st + TILE_B + QRY_B);
        my_stat = make_float4(sf[t], sf[T + t], sf[2 * T + t], sf[3 * T + t]);
        my_doc = reinterpret_cast<const int*>(sf + 4 * T)[t];
        my_tile = tile_of(slot);
        my_del = del_n;
        my_fok = fok_n;
        if (slot + 1 < s_end) {
          const size_t row_n = (size_t)max(tile_of(slot + 1), 0) * T + t;
          doc_n = docid[row_n];
          if (use_ff) fid_n = fieldid[row_n];
        }
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0;
    }

    const unsigned char* tb = st;
    const unsigned char* qb = st + TILE_B;
    if (live) {
      if constexpr (QUANT) {
        uint32_t a[4][4];
        const int qrow = 16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          ldmatrix_x4(a[ks], qb + swz(qrow, 2 * ks + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int r = 8 * NI * h + 8 * i + (lane & 7);
          uint32_t b[8];
          ldmatrix_x4(b, tb + swz(r, lane >> 3));
          ldmatrix_x4(b + 4, tb + swz(r, 4 + (lane >> 3)));
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            mma_s8(acc[i], a[ks], b[2 * ks], b[2 * ks + 1]);
        }
      } else {
        const int qa = 16 * mt + g;
#pragma unroll 1
        for (int p4 = 0; p4 < 8; ++p4) {
          const float4 xa =
              *reinterpret_cast<const float4*>(qb + swz(qa, p4));
          const float4 xb =
              *reinterpret_cast<const float4*>(qb + swz(qa + 8, p4));
#pragma unroll
          for (int i = 0; i < NI; ++i) {
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              const int r = 8 * NI * h + 8 * i + 2 * tq + p;
              const float4 y =
                  *reinterpret_cast<const float4*>(tb + swz(r, p4));
              float& ca = acc[i][p];
              float& cb = acc[i][2 + p];
              ca = __fmaf_rn(xa.x, y.x, ca);
              ca = __fmaf_rn(xa.y, y.y, ca);
              ca = __fmaf_rn(xa.z, y.z, ca);
              ca = __fmaf_rn(xa.w, y.w, ca);
              cb = __fmaf_rn(xb.x, y.x, cb);
              cb = __fmaf_rn(xb.y, y.y, cb);
              cb = __fmaf_rn(xb.z, y.z, cb);
              cb = __fmaf_rn(xb.w, y.w, cb);
            }
          }
        }
      }
    }
    if (c != nchunks - 1) continue;

    // ---- the slot's epilogue: masked scores into S, counts
    if (t < T) {
      rstat[t] = my_stat;
      rok[t] = (my_doc >= 0 && my_tile >= 0 && !my_del && my_fok) ? 1 : 0;
    }
    __syncthreads();
    const uint32_t base = (uint32_t)slot * T;
    if (live) {
      // each of the thread's two queries: does a row beat its threshold
      float ts[2];
      uint32_t tp[2];
      bool beat[2] = {false, false};
#pragma unroll
      for (int e = 0; e < 2; ++e)
        key_to_thr(thr_k[16 * mt + g + 8 * e], ts[e], tp[e]);
      // the modes as constants, so the loop holds no branch
      auto epilogue = [&](auto gathered_c, auto euclid_c) {
        constexpr bool GA = decltype(gathered_c)::value;
        constexpr bool EU = decltype(euclid_c)::value;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int r = 8 * NI * h + 8 * i + 2 * tq;
          const float4 y0 = rstat[r], y1 = rstat[r + 1];
          const bool ok0 = rok[r], ok1 = rok[r + 1];
          const uint32_t p0 = base + r;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s0v = finish_t<QUANT, GA, EU>(
                to_f32(acc[i][2 * e], small_d), qsa[e], qza[e], qSa[e],
                qn2[e], y0.x, y0.y, y0.z, y0.w, fd);
            const float s1v = finish_t<QUANT, GA, EU>(
                to_f32(acc[i][2 * e + 1], small_d), qsa[e], qza[e], qSa[e],
                qn2[e], y1.x, y1.y, y1.z, y1.w, fd);
            const bool m0 = ok0 & qval[e] & (s0v >= qmin[e]);
            const bool m1 = ok1 & qval[e] & (s1v >= qmin[e]);
            qcnt[e] += (int)m0 + (int)m1;
            const float v0 = m0 ? s0v : -INFINITY;
            const float v1 = m1 ? s1v : -INFINITY;
            beat[e] |= (v0 > ts[e]) | ((v0 == ts[e]) & (p0 < tp[e])) |
                       (v1 > ts[e]) | ((v1 == ts[e]) & (p0 + 1 < tp[e]));
            *reinterpret_cast<float2*>(S + s_at(16 * mt + g + 8 * e, r)) =
                make_float2(v0, v1);
          }
        }
      };
      if (gathered) {
        if (euclidean)
          epilogue(std::true_type{}, std::true_type{});
        else
          epilogue(std::true_type{}, std::false_type{});
      } else {
        if (euclidean)
          epilogue(std::false_type{}, std::true_type{});
        else
          epilogue(std::false_type{}, std::false_type{});
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (beat[e]) hit[16 * mt + g + 8 * e] = 1;
    }
    __syncthreads();

    if (probe) {
      // each query's best key of the slot, for the shared threshold
#pragma unroll 1
      for (int jj = 0; jj < QW; ++jj) {
        const int j = QW * w + jj;
        if (q0 + j >= B) break;
        Key m = KEY_MAX;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          m = min(m, make_key(S[s_at(j, 32 * r + lane)], base + 32 * r + lane));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(FULL, m, o));
        if (lane == 0) best[(size_t)(q0 + j) * G + blockIdx.x] = m;
      }
      return;
    }

    // ---- a warp a query: the rows that beat the query's threshold join
    // its running top-32; then its threshold for the next slot is the
    // smaller of its own kk-th key and the other CTAs' (gthr)
    // the shared threshold of the lane's query: gthr, or the largest of
    // its kk buckets' keys plus one (kk distinct rows at or below it, the
    // bucket's own row among them, which must still enter its list)
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      b_pre = max(b_pre, __shfl_xor_sync(FULL, b_pre, o));
    g_pre = min(g_pre, b_pre == KEY_MAX ? KEY_MAX : b_pre + 1);
#pragma unroll 1
    for (int jj = 0; jj < QW; ++jj) {
      const int j = QW * w + jj;
      if (q0 + j >= B) break;
      const Key g_j = __shfl_sync(FULL, g_pre, 8 * jj);
      Key thr = min(thr_k[j], g_j);
      if (!hit[j]) {
        if (lane == 0) thr_k[j] = thr;
        continue;
      }
      Key k8[8];
      float v8[8];
      unsigned bal[8];
      int n = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        v8[r] = S[s_at(j, 32 * r + lane)];
        k8[r] = make_key(v8[r], base + 32 * r + lane);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        bal[r] = __ballot_sync(FULL, k8[r] < thr);
        n += __popc(bal[r]);
      }
      if (n) {
        float Lv = lv[j * KK + lane];
        Key Lk = make_key(Lv, lp[j * KK + lane]);
        if (n <= INSERT_MAX) {
          // one at a time: the keys below the new one stay, the rest move
          // up a lane
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            unsigned bl = bal[r];
            while (bl) {
              const int src = __ffs(bl) - 1;
              bl &= bl - 1;
              const Key ck = __shfl_sync(FULL, k8[r], src);
              const float cv = __shfl_sync(FULL, v8[r], src);
              if (ck >= thr) continue;
              const int at = __popc(__ballot_sync(FULL, Lk < ck));
              const Key uk = __shfl_up_sync(FULL, Lk, 1);
              const float uv = __shfl_up_sync(FULL, Lv, 1);
              if (lane == at) {
                Lk = ck;
                Lv = cv;
              } else if (lane > at) {
                Lk = uk;
                Lv = uv;
              }
              thr = min(thr, __shfl_sync(FULL, Lk, kk - 1));
            }
          }
        } else if (n <= 32) {
          // a few: compacted into one run (through this warp's scratch),
          // sorted and folded in
          int off = 0;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if ((bal[r] >> lane) & 1u) {
              const int at = off + __popc(bal[r] & ((1u << lane) - 1u));
              run_k[at] = k8[r];
              run_v[at] = v8[r];
            }
            off += __popc(bal[r]);
          }
          __syncwarp();
          Key ck = lane < n ? run_k[lane] : KEY_MAX;
          float cv = lane < n ? run_v[lane] : sentinel_v();
          __syncwarp();
          warp_sort32(ck, cv, lane);
          fold(Lk, Lv, ck, cv, lane);
        } else {
          // many (a range's first slot: all of them): the top 32 of the
          // admitted rows, folded in
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (!(k8[r] < thr)) {
              k8[r] = KEY_MAX;
              v8[r] = sentinel_v();
            }
          }
          top32_of_runs(k8, v8, lane);
          fold(Lk, Lv, k8[0], v8[0], lane);
        }
        const Key own = __shfl_sync(FULL, Lk, kk - 1);
        const Key first = __shfl_sync(FULL, Lk, 0);
        thr = min(thr, own);
        lv[j * KK + lane] = Lv;
        lp[j * KK + lane] = (uint32_t)Lk;
        if (lane == 0) {
          if (own < g_j) atomicMin(gthr + q0 + j, own);
          // this range's best row joins its bucket (ranges g = b mod kk)
          if (BUCKETS)
            atomicMin(bucket + (size_t)(q0 + j) * 32 + blockIdx.x % kk,
                      first);
        }
      }
      if (lane == 0) {
        thr_k[j] = thr;
        hit[j] = 0;
      }
    }
    if (t < T && slot + 1 < s_end) gather_flags();
  }
  cp_async_wait<0>();

  // this CTA's lists: [B][G][32], each ascending by key
  __syncwarp();
  for (int jj = 0; jj < QW; ++jj) {
    const int j = QW * w + jj;
    if (q0 + j >= B) break;
    const size_t o = ((size_t)(q0 + j) * G + blockIdx.x) * KK + lane;
    list_v[o] = lv[j * KK + lane];
    list_p[o] = lp[j * KK + lane];
  }
  if (with_counts) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int cnt = qcnt[e];
      cnt += __shfl_xor_sync(FULL, cnt, 1);
      cnt += __shfl_xor_sync(FULL, cnt, 2);
      if (tq == 0 && qval[e] && cnt)
        atomicAdd(&counts[q0 + 16 * mt + g + 8 * e], cnt);
    }
  }
}

}  // namespace run

// ---------------------------------------------------------------------------
// 2. the per-tile scan (32 < k): K4's first kernel, each tile's top
//    min(k, 256)

namespace tile {

constexpr int QB = 32;                 // queries a CTA
constexpr int CW = 32;                 // words of a row staged at a time
constexpr int RS = CW + 1;             // padded row stride (words)
constexpr int STAGE_BYTES = (T * RS + QB * CW) * 4;
constexpr int KEY_BYTES = QB * T * 8;
constexpr int REGION_A = KEY_BYTES > STAGE_BYTES ? KEY_BYTES : STAGE_BYTES;
constexpr int VAL_BYTES = QB * T * 4;
constexpr int SMEM_BYTES = REGION_A + VAL_BYTES + QB * 4;

static_assert((T * RS * 4) % 16 == 0, "query words must be 16-byte aligned");

template <bool QUANT>
__global__ void __launch_bounds__(THREADS)
tile_scan(const uint32_t* __restrict__ data, const float* __restrict__ scale,
          const float* __restrict__ zp, const float* __restrict__ qsum,
          const float* __restrict__ norm2, const int* __restrict__ docid,
          const int* __restrict__ fieldid,
          const unsigned char* __restrict__ deleted, int n_deleted,
          const unsigned char* __restrict__ field_ok, int n_field,
          const int* __restrict__ tile_ids, int NT,
          const uint32_t* __restrict__ q_data,
          const float* __restrict__ q_scale, const float* __restrict__ q_zp,
          const float* __restrict__ q_qsum,
          const float* __restrict__ q_norm2,
          const float* __restrict__ score_min, int B, int d, int W, int kk,
          int euclidean, int use_ff, int with_counts, int gath,
          float* __restrict__ list_v, uint32_t* __restrict__ list_p,
          int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tile_s = reinterpret_cast<uint32_t*>(smem);       // [T][RS]
  uint32_t* q_s = tile_s + T * RS;                              // [QB][CW]
  Key* keys = reinterpret_cast<Key*>(smem);                     // [QB][T]
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

  const size_t row = (size_t)tc * T + t;
  const bool ok = row_ok(docid[row], tile, fieldid[row], deleted, n_deleted,
                         field_ok, n_field, use_ff);
  const float sb = scale[row], zb = zp[row], Sb = qsum[row], n2 = norm2[row];
  const bool gathered = gath != 0;
  const uint32_t pos = (uint32_t)slot * T + t;

#pragma unroll
  for (int j = 0; j < QB; ++j) {
    const int qi = min(q0 + j, B - 1);
    const float s = finish<QUANT>((float)acc[j], q_scale[qi], q_zp[qi],
                                  q_qsum[qi], q_norm2[qi], sb, zb, Sb, n2,
                                  (float)d, gathered, euclidean);
    const bool m = ok && j < nq && s >= score_min[qi];
    const float v = m ? s : -INFINITY;
    vals[j * T + t] = v;
    keys[j * T + t] = make_key(v, pos);
    if (with_counts) {
      const unsigned b = __ballot_sync(FULL, m);
      if ((t & 31) == 0 && b) atomicAdd(&cnt_s[j], __popc(b));
    }
  }
  __syncthreads();

  // bitonic sort of each query's 256 keys in shared memory
  for (int size = 2; size <= T; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int c = t; c < nq * (T / 2); c += THREADS) {
        const int j = c / (T / 2), p = c % (T / 2);
        const int i = 2 * stride * (p / stride) + (p % stride);
        Key* kj = keys + j * T;
        const Key a = kj[i], b = kj[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          kj[i] = b;
          kj[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }

  // the tile's list: [B][NT][kk]
  for (int c = t; c < nq * kk; c += THREADS) {
    const int j = c / kk, r = c % kk;
    const int lt = (int)(keys[j * T + r] & 0xffu);
    const size_t o = ((size_t)(q0 + j) * NT + slot) * kk + r;
    list_v[o] = vals[j * T + lt];
    list_p[o] = (uint32_t)slot * T + lt;
  }
  if (with_counts && t < nq && cnt_s[t]) atomicAdd(&counts[q0 + t], cnt_s[t]);
}

}  // namespace tile

// ---------------------------------------------------------------------------
// the merge: one CTA a query, the top kk of L ascending lists of LK

namespace merge {

constexpr int SMEM_P = 4096;           // largest running top-P in shared memory
constexpr int FLAT_MAX = 8192;         // most entries merged in one pass
constexpr int SMEM_BYTES = 2 * SMEM_P * 8 > FLAT_MAX * 8 ? 2 * SMEM_P * 8
                                                         : FLAT_MAX * 8;

__device__ __forceinline__ Key key_at(const float* v, const uint32_t* p,
                                      int i) {
  return make_key(v[i], p[i]);
}

__device__ __forceinline__ void swap_at(float* v, uint32_t* p, int i,
                                        int j) {
  const float tv = v[i];
  v[i] = v[j];
  v[j] = tv;
  const uint32_t tp = p[i];
  p[i] = p[j];
  p[j] = tp;
}

// n (a power of two) entries ascending by key, bitonic, the whole CTA
__device__ void block_sort(float* v, uint32_t* p, int n, int t) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int c = t; c < n / 2; c += THREADS) {
        const int i = 2 * stride * (c / stride) + (c % stride);
        if ((key_at(v, p, i) > key_at(v, p, i + stride)) == ((i & size) == 0))
          swap_at(v, p, i, i + stride);
      }
      __syncthreads();
    }
  }
}

// entries of the lists needed in one pass: at most FLAT_MAX, rounded up to
// a power of two (the buffer the one-pass merge sorts)
__host__ __device__ inline int flat_cap(int M) {
  int c = 32;
  while (c < M) c <<= 1;
  return c;
}

__global__ void __launch_bounds__(THREADS)
merge_lists(const float* __restrict__ list_v,
            const uint32_t* __restrict__ list_p, int L, int LK,
            const Key* __restrict__ gthr, const Key* __restrict__ bucket,
            const int* __restrict__ tile_ids, int kk, int k, int P,
            unsigned char* __restrict__ scratch,
            float* __restrict__ out_vals, int* __restrict__ out_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_cand;
  __shared__ Key thr;
  const int t = threadIdx.x, b = blockIdx.x;
  const int M = L * LK;
  const float* lvb = list_v + (size_t)b * M;
  const uint32_t* lpb = list_p + (size_t)b * M;
  // the scan's shared threshold, where it kept one (the smaller of gthr
  // and the largest of the kk buckets): every list entry at or below it
  // can be in the top kk, none above it
  if (t == 0) {
    Key g = KEY_MAX;
    if (gthr) {
      Key bmax = BUCKETS ? 0 : KEY_MAX;
      for (int i = 0; BUCKETS && i < kk; ++i)
        bmax = max(bmax, bucket[(size_t)b * 32 + i]);
      g = min(gthr[b], bmax);
    }
    thr = g != KEY_MAX ? g + 1 : KEY_MAX;
    n_cand = 0;
  }
  float* Rv;
  uint32_t* Rp;

  if (M <= FLAT_MAX) {
    // one pass: every entry below the threshold, then one sort
    const int cap = flat_cap(M);
    Rv = reinterpret_cast<float*>(smem);
    Rp = reinterpret_cast<uint32_t*>(Rv + cap);
    __syncthreads();
    const Key th = thr;
    for (int i0 = 0; i0 < M; i0 += 4 * THREADS) {
      float v[4];
      uint32_t p[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * THREADS + t;
        v[u] = i < M ? lvb[i] : sentinel_v();
        p[u] = i < M ? lpb[i] : POS_NONE;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (make_key(v[u], p[u]) < th) {
          const int s = atomicAdd(&n_cand, 1);
          Rv[s] = v[u];
          Rp[s] = p[u];
        }
      }
    }
    __syncthreads();
    const int n = n_cand;
    int n2 = 32;
    while (n2 < n || n2 < kk) n2 <<= 1;
    for (int i = n + t; i < n2; i += THREADS) {
      Rv[i] = sentinel_v();
      Rp[i] = POS_NONE;
    }
    __syncthreads();
    block_sort(Rv, Rp, n2, t);
  } else {
    // rounds: the running top-P (R) and a candidate buffer (C), P each
    unsigned char* area = scratch ? scratch + (size_t)b * 16 * P : smem;
    Rv = reinterpret_cast<float*>(area);
    Rp = reinterpret_cast<uint32_t*>(Rv + P);
    float* Cv = reinterpret_cast<float*>(Rp + P);
    uint32_t* Cp = reinterpret_cast<uint32_t*>(Cv + P);
    for (int i = t; i < P; i += THREADS) {
      Rv[i] = sentinel_v();
      Rp[i] = POS_NONE;
    }
    int l = t, e = 0;                  // this thread's list and entry
    for (;;) {
      __syncthreads();
      const Key th = thr;
      bool more = false;
      while (l < L) {
        const float* v = lvb + (size_t)l * LK;
        const uint32_t* p = lpb + (size_t)l * LK;
        while (e < LK) {
          if (make_key(v[e], p[e]) >= th) {
            e = LK;                    // the rest of a sorted list is worse
            break;
          }
          const int s = atomicAdd(&n_cand, 1);
          if (s >= P) {
            more = true;               // the buffer is full: next round
            break;
          }
          Cv[s] = v[e];
          Cp[s] = p[e];
          ++e;
        }
        if (more) break;
        l += THREADS;
        e = 0;
      }
      const bool any_more = __syncthreads_or(more);
      const int n = min(n_cand, P);
      if (n > 0) {
        for (int i = n + t; i < P; i += THREADS) {
          Cv[i] = sentinel_v();
          Cp[i] = POS_NONE;
        }
        __syncthreads();
        block_sort(Cv, Cp, P, t);
        // the P smallest of R and C: min(R[i], C[P-1-i]), bitonic
        for (int i = t; i < P; i += THREADS) {
          if (key_at(Cv, Cp, P - 1 - i) < key_at(Rv, Rp, i)) {
            Rv[i] = Cv[P - 1 - i];
            Rp[i] = Cp[P - 1 - i];
          }
        }
        __syncthreads();
        for (int stride = P >> 1; stride > 0; stride >>= 1) {
          for (int c = t; c < P / 2; c += THREADS) {
            const int i = 2 * stride * (c / stride) + (c % stride);
            if (key_at(Rv, Rp, i) > key_at(Rv, Rp, i + stride))
              swap_at(Rv, Rp, i, i + stride);
          }
          __syncthreads();
        }
        if (t == 0) {
          thr = min(thr, key_at(Rv, Rp, kk - 1));
          n_cand = 0;
        }
      }
      if (!any_more) break;
    }
    __syncthreads();
  }

  for (int i = t; i < k; i += THREADS) {
    float v = -INFINITY;
    int row = 0;
    if (i < kk) {
      v = Rv[i];
      const uint32_t pos = Rp[i];
      const int slot = (int)(pos / T);
      const int tile = tile_ids ? tile_ids[slot] : slot;
      row = max(tile, 0) * T + (int)(pos % T);
    }
    out_vals[(size_t)b * k + i] = v;
    out_rows[(size_t)b * k + i] = row;
  }
}

// the running scan's shared threshold from its probe pass: the kk-th
// smallest of the G ranges' best keys (G distinct rows, so kk real rows
// sit at or below it), plus one, as a row equal to it must enter; all
// bits set when G < kk.  One warp a query, G <= 256.
__global__ void __launch_bounds__(32)
select_threshold(const Key* __restrict__ best, int G, int kk,
                 Key* __restrict__ gthr, Key* __restrict__ bucket) {
  const int b = blockIdx.x, lane = threadIdx.x;
  Key k8[8];
  float v8[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = 32 * r + lane;
    k8[r] = i < G ? best[(size_t)b * G + i] : KEY_MAX;
    v8[r] = 0.f;
  }
  top32_of_runs(k8, v8, lane);
  const Key kth = __shfl_sync(FULL, k8[0], kk - 1);
  if (lane == 0) gthr[b] = kth == KEY_MAX ? KEY_MAX : kth + 1;
  // bucket lane: the best of the ranges g = lane (mod kk), which the scan
  // lowers as its ranges find better rows
  Key m = KEY_MAX;
  if (lane < kk)
    for (int i = lane; i < G; i += kk) m = min(m, best[(size_t)b * G + i]);
  bucket[(size_t)b * 32 + lane] = m;
}

}  // namespace merge

template <bool QUANT>
cudaError_t scan(cudaStream_t stream, const void* data, const float* scale,
                 const float* zp, const float* qsum, const float* norm2,
                 const int* docid, const int* fieldid,
                 const unsigned char* deleted, int n_deleted,
                 const unsigned char* field_ok, int n_field,
                 const int* tile_ids, int NT, const void* q_data,
                 const float* q_scale, const float* q_zp,
                 const float* q_qsum, const float* q_norm2,
                 const float* score_min, int B, int d, int k, int kk,
                 int G, int euclidean, int use_ff, int with_counts, int gath,
                 float* list_v, uint32_t* list_p, Key* gthr, int* counts) {
  cudaError_t err;
  if (G > 0) {
    err = cudaFuncSetAttribute(run::running_scan<QUANT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               run::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const dim3 grid(G, (B + run::QM - 1) / run::QM);
    // the probe pass (each range's first slot: its best key a query), the
    // shared threshold, then the scan
    Key* best = gthr + B;
    Key* bucket = best + (size_t)B * G;
    for (int probe = 1; probe >= 0; --probe) {
      run::running_scan<QUANT><<<grid, run::RT, run::SMEM_BYTES, stream>>>(
          static_cast<const unsigned char*>(data), scale, zp, qsum, norm2,
          docid, fieldid, deleted, n_deleted, field_ok, n_field, tile_ids,
          NT, static_cast<const unsigned char*>(q_data), q_scale, q_zp,
          q_qsum, q_norm2, score_min, B, d, G, kk, euclidean, use_ff,
          with_counts, probe, gath, list_v, list_p, gthr, best, bucket,
          counts);
      if (probe)
        merge::select_threshold<<<B, 32, 0, stream>>>(best, G, kk, gthr,
                                                       bucket);
    }
    return cudaGetLastError();
  }
  err = cudaFuncSetAttribute(tile::tile_scan<QUANT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tile::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(NT, (B + tile::QB - 1) / tile::QB);
  tile::tile_scan<QUANT><<<grid, THREADS, tile::SMEM_BYTES, stream>>>(
      static_cast<const uint32_t*>(data), scale, zp, qsum, norm2, docid,
      fieldid, deleted, n_deleted, field_ok, n_field, tile_ids, NT,
      static_cast<const uint32_t*>(q_data), q_scale, q_zp, q_qsum, q_norm2,
      score_min, B, d, QUANT ? d / 4 : d, k < T ? k : T, euclidean, use_ff,
      with_counts, gath, list_v, list_p, counts);
  return cudaGetLastError();
}

}  // namespace

// d a multiple of 128, k >= 1, NT >= 1, B >= 1; tile_ids may be null (all
// NT tiles in order).  gathered != 0 takes the corrections' order of a scan
// that gathers its tiles (the reference's, for two or more slots of a pool
// of two or more tiles; ops/vector.py).  G >= 1 (k <= 32 only) takes the
// running scan over G slot ranges (G <= min(NT, 256)), whose lists are
// list_v / list_p [B, G, 32], with gthr [B + B*G + B*32] its scratch (the
// shared thresholds, the probe pass's best keys, each query's 32 buckets);
// G = 0 the per-tile scan, lists [B, NT, min(k, 256)].  The merge takes
// lists of up to 8,192 entries a query in one pass, else keeps a running
// top-P (P a power of two >= min(k, NT*256), at least 32): in shared memory
// when merge_scratch is null (P <= 4,096), else in merge_scratch (B * 16 *
// P bytes).  Writes out_vals / out_rows [B, k] and adds counts[B].  Returns
// cudaGetLastError() after the launches.
extern "C" int vector_scan_launch(
    const void* data, const float* scale, const float* zp, const float* qsum,
    const float* norm2, const int* docid, const int* fieldid,
    const unsigned char* deleted, int n_deleted,
    const unsigned char* field_ok, int n_field, const int* tile_ids, int NT,
    const void* q_data, const float* q_scale, const float* q_zp,
    const float* q_qsum, const float* q_norm2, const float* score_min, int B,
    int d, int k, int quantized, int euclidean, int use_ff, int with_counts,
    int gathered, int G, float* list_v, unsigned int* list_p,
    unsigned long long* gthr, int P, void* merge_scratch, float* out_vals,
    int* out_rows, int* counts, cudaStream_t stream) {
  const long long rows = (long long)NT * T;
  const int kk = (int)(k < rows ? k : rows);
  if (d <= 0 || d % 128 || k < 1 || NT < 1 || B < 1 || rows > 0x7fffffffLL ||
      P < kk || P < 32 || (P & (P - 1)) ||
      (!merge_scratch && P > merge::SMEM_P) ||
      G < 0 || (G > 0 && (k > run::KK || G > NT || G > 256 || !gthr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      quantized
          ? scan<true>(stream, data, scale, zp, qsum, norm2, docid, fieldid,
                       deleted, n_deleted, field_ok, n_field, tile_ids, NT,
                       q_data, q_scale, q_zp, q_qsum, q_norm2, score_min, B,
                       d, k, kk, G, euclidean, use_ff, with_counts, gathered,
                       list_v, list_p, gthr, counts)
          : scan<false>(stream, data, scale, zp, qsum, norm2, docid, fieldid,
                        deleted, n_deleted, field_ok, n_field, tile_ids, NT,
                        q_data, q_scale, q_zp, q_qsum, q_norm2, score_min, B,
                        d, k, kk, G, euclidean, use_ff, with_counts,
                        gathered, list_v, list_p, gthr, counts);
  if (err != cudaSuccess) return (int)err;
  const int L = G > 0 ? G : NT;
  const int LK = G > 0 ? run::KK : (k < T ? k : T);
  const int smem = L * LK <= merge::FLAT_MAX ? merge::flat_cap(L * LK) * 8
                   : merge_scratch       ? 0
                                         : 2 * P * 8;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(merge::merge_lists,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               merge::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
  }
  merge::merge_lists<<<B, THREADS, smem, stream>>>(
      list_v, list_p, L, LK, G > 0 ? gthr : nullptr,
      G > 0 ? gthr + B + (size_t)B * G : nullptr, tile_ids, kk, k, P,
      static_cast<unsigned char*>(merge_scratch), out_vals, out_rows);
  return (int)cudaGetLastError();
}

// Hand-written Hopper (sm_90a) kernels of the batched search path.
//
// Built by iresearch_tpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and bound with ctypes: every entry point is extern "C", launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Pools are u32 words (the torch side holds them as int32 bit-views) in
// the planar pow2 layout of formats/bitpack.py: lane j of a b-bit block
// lives in word j % (4b) at bit (j / (4b)) * b.
//
// --fmad=false keeps every a * b + c as two rounded operations, so with
// the same operation order as the plain PyTorch versions the BM25 scores
// match them bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define IRS_BLOCK 128
#define IRS_MAX_SPANS 64
#define IRS_MAX_SLICE_POOLS 4
#define IRS_FULL_MASK 0xffffffffu

enum ScoreKind {
  kBM25 = 0,        // w * f / max(f + (c0 + (kb / avgdl) * dl), 1e-9)
  kBM25NoLen = 1,   // b == 0: w * f / max(f + c0, 1e-9)
  kTFIDF = 2,       // w * sqrt(f) * rsqrt(max(dl, 1))
  kTFIDFNoNorm = 3, // w * sqrt(f)
  kBoost = 4,       // f > 0 ? w : 0
};

__device__ __forceinline__ uint32_t lane_bits(const uint32_t* row, int b,
                                              int j) {
  const int wpb = 4 * b;
  const uint32_t mask = b == 32 ? IRS_FULL_MASK : ((1u << b) - 1u);
  return (row[j % wpb] >> ((j / wpb) * b)) & mask;
}

// ---------------------------------------------------------------------------
// K1: fused dense-grid row max.
//
// Replaces iresearch_tpu/ops/dense_scan.py:dense_scan_rowmax (Pallas) and
// its XLA twin dense_scan_rowmax_xla. For query q and grid row r: unpack
// each span's 128 lanes from pool_s[starts[q, s] + r], score them against
// the row's doc lengths, sum over spans, mask lanes that do not hit (any
// span / all spans with conj / at least mm spans), and reduce to the row
// max (-inf without a hit) and its smallest lane.
//
// Bound: device memory. The pass must read Q * ndrows * sum_s 16 b_s
// bytes of pool words (the mix's two groups: 78 queries x 40,960 rows x
// 96 B = 307 MB), the norms once per call (10.5 MB) and write 8 bytes per
// (q, row): ~0.105 ms at 3.35 TB/s (chip_smoke.py's bound_ms). The f32
// work a result needs is small: 5 operations per (hit lane, span with
// f != 0), ~0.004 ms at 67 TFLOP/s. The tensor cores do not apply (no
// matrix product).
//
// A warp per (q, row) that scored every lane (the first design) was bound
// by instruction issue at ~80 GB/s: ~70 instructions per lane and span
// (run-time / and % by 4b, an IEEE divide on every lane, the norms row
// and c1 * dl + c0 per query). This design cuts the instructions:
//
// * A block owns K1_WARPS grid rows (one warp each) and a chunk of up to
//   K1_QCHUNK queries, whose starts and weights it stages in shared
//   memory. A warp loads its norms row once and keeps the span- and
//   query-independent part of the score (c1 * dl + c0, or 1/sqrt(dl)) in
//   shared memory for every span and query of the chunk: the same
//   expression in the same order as the plain version.
// * Pass 1 finds the hit lanes without scoring. b is a power of two, so
//   lane j lives in word j & (4b - 1) at bit (j >> (lb + 2)) << lb; for
//   b <= 8 the four lanes j = lane + 32 i of a thread share one word, at
//   bits s0 + 8 i, so one load, one shift and one mask give all four
//   lanes, one per byte, and the hit logic runs on the bytes (SIMD byte
//   compares). The K1_QB queries in flight issue their loads with no
//   branch between them (a row outside its pool reads k1_zero_row).
// * Pass 2 compacts the hit lanes in lane order through warp ballots, so
//   that one round of divides serves 32 of them, and scores only spans
//   with f != 0: for every score kind a span with f == 0 adds exactly
//   +-0 to a sum that starts at +0, and a lane without a hit ends at -inf
//   whatever its score, so the result is bit-identical with the plain
//   version (summation order over spans unchanged, IEEE divide,
//   --fmad=false). The query's row of every span is looked up once into
//   shared memory; the words are read again, from L1.
// * The row max and its smallest lane come from warp shuffles.
//
// What bounds it now (NVIDIA H100, chip_smoke.py and PERF.md): still
// instruction issue, ~14x its bytes bound on the mix. Scoring the hit
// lanes (pass 2) takes most of the time on the OrHighMed group, where
// most lanes hit, pass 1 with the compaction the rest. Variants that were
// slower: 4 or 8 queries in flight (more registers, fewer warps), scoring
// each thread's own lanes on dense rows, adding every span's term
// branch-free, and an approximate pass (__fdividef) leaving only the lanes
// near the row max to the exact divide: per hit lane the cost is the
// word's address, load and extraction more than the divide. Registers (nvcc -Xptxas -v, sm_90a): 40 in the any/count/all
// modes, 40 in the f32-sum mode, no spills; 17,408 B of shared memory.
//
// Pool words are loaded straight into registers: a (query, span) row is
// 32-64 B at a per-query offset, too small for a bulk copy (cp.async or
// TMA) to pay, and the loads are not what bounds the kernel.
#define K1_WARPS 8    // grid rows per block, one warp each
#define K1_QCHUNK 16  // queries per block
#define K1_QB 2       // queries in flight per warp in pass 1

enum HitMode {
  kHitAny = 0,    // f summed over spans > 0, no span of 32 bits: any f > 0
  kHitAll = 1,    // conj: min over spans of f > 0
  kHitCount = 2,  // mm > 1: count of spans with f > 0 >= mm
  kHitFSum = 3,   // the f sum > 0 in f32, when a 32-bit span can be < 0
};

// what a row outside its pool reads: the zero sentinel (never for a plan;
// the guard keeps a bad start from reading foreign memory)
__device__ const uint32_t k1_zero_row[IRS_BLOCK] = {};

struct SpanPools {
  const uint32_t* pool[IRS_MAX_SPANS];
  long long rows[IRS_MAX_SPANS];
  int bits[IRS_MAX_SPANS];
  int lbits[IRS_MAX_SPANS];  // log2(bits)
};

__device__ __forceinline__ uint32_t width_mask(int b) {
  return b == 32 ? IRS_FULL_MASK : ((1u << b) - 1u);
}

// lane j of a b-bit row, b = 1 << lb: shifts and masks only
__device__ __forceinline__ uint32_t lane_val(const uint32_t* row, int b,
                                             int lb, int j) {
  return (__ldg(row + (j & ((4 << lb) - 1))) >> ((j >> (lb + 2)) << lb)) &
         width_mask(b);
}

// Byte i is non-zero iff lane lane + 32 i has f > 0 (f = f32(int32(v))).
__device__ __forceinline__ uint32_t span_hits(const uint32_t* row, int b,
                                              int lb, int lane) {
  if (b <= 8) {
    const uint32_t w = __ldg(row + (lane & ((4 << lb) - 1)));
    return (w >> ((lane >> (lb + 2)) << lb)) & (width_mask(b) * 0x01010101u);
  }
  if (b == 16) {  // lanes i = 0, 2 in word lane, i = 1, 3 in word lane + 32
    const uint32_t a = __ldg(row + lane), c = __ldg(row + lane + 32);
    return ((a & 0xffffu) ? 0x1u : 0u) | ((c & 0xffffu) ? 0x100u : 0u) |
           ((a >> 16) ? 0x10000u : 0u) | ((c >> 16) ? 0x1000000u : 0u);
  }
  uint32_t x = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x |= ((int32_t)__ldg(row + lane + 32 * i) > 0 ? 1u : 0u) << (8 * i);
  return x;
}

// score_expr with the lane's span-independent part precomputed in `pre`
// (kBM25: c1 * dl + c0; kTFIDF: rsqrt(max(dl, 1))).
__device__ __forceinline__ float score_lane(int kind, float w, float f,
                                            float pre, float c0) {
  switch (kind) {
    case kBM25:
      return w * f / fmaxf(f + pre, 1e-9f);
    case kBM25NoLen:
      return w * f / fmaxf(f + c0, 1e-9f);
    case kTFIDF:
      return w * sqrtf(f) * pre;
    case kTFIDFNoNorm:
      return w * sqrtf(f);
    default:
      return f > 0.0f ? w : 0.0f;
  }
}

template <int MODE>
__global__ void __launch_bounds__(K1_WARPS * 32)
k1_dense_scan_rowmax(SpanPools sp, int S, const int32_t* __restrict__ starts,
                     const float* __restrict__ ws,
                     const void* __restrict__ norms, int norms_u16,
                     int ndrows, int Q, int kind, float kb, float c0,
                     float avgdl, int mm,
                     float* __restrict__ out_max,
                     int32_t* __restrict__ out_arg) {
  __shared__ int32_t s_start[K1_QCHUNK * IRS_MAX_SPANS];
  __shared__ float s_w[K1_QCHUNK * IRS_MAX_SPANS];
  __shared__ float s_pre[K1_WARPS][IRS_BLOCK];
  __shared__ uint8_t s_hit[K1_WARPS][IRS_BLOCK];
  __shared__ const uint32_t* s_row[K1_WARPS][IRS_MAX_SPANS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * K1_QCHUNK;
  const int nq = min(K1_QCHUNK, Q - q0);
  for (int t = threadIdx.x; t < nq * S; t += blockDim.x) {
    s_start[t] = starts[(long long)q0 * S + t];
    s_w[t] = ws[(long long)q0 * S + t];
  }
  __syncthreads();
  const int row = blockIdx.x * K1_WARPS + warp;
  if (row >= ndrows) return;

  float* pre = s_pre[warp];
  uint8_t* hits = s_hit[warp];
  const uint32_t** rows = s_row[warp];
  const float c1 = kb / avgdl;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long idx = (long long)row * IRS_BLOCK + lane + 32 * i;
    const float dl = norms_u16 ? (float)(int)((const uint16_t*)norms)[idx]
                               : ((const float*)norms)[idx];
    pre[lane + 32 * i] = kind == kBM25    ? c1 * dl + c0
                         : kind == kTFIDF ? rsqrtf(fmaxf(dl, 1.0f))
                                          : 0.0f;
  }
  __syncwarp();  // pass 2 reads other threads' lanes of `pre`
  const uint32_t thr = (uint32_t)min(max(mm, 0), 255) * 0x01010101u;

  for (int qa = 0; qa < nq; qa += K1_QB) {
    // ---- pass 1: hit bits of K1_QB queries (a short tail repeats the
    // last query, whose extra results are dropped)
    uint32_t acc[K1_QB];
    float fs[K1_QB][4];
#pragma unroll
    for (int u = 0; u < K1_QB; ++u) {
      acc[u] = MODE == kHitAll ? IRS_FULL_MASK : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) fs[u][i] = 0.0f;
    }
    for (int s = 0; s < S; ++s) {
      const int b = sp.bits[s], lb = sp.lbits[s];
      const uint32_t* pool = sp.pool[s];
      const long long nrows = sp.rows[s];
      const int wpb = 4 << lb;
      const uint32_t* wrow[K1_QB];
#pragma unroll
      for (int u = 0; u < K1_QB; ++u) {
        const long long r = (long long)s_start[min(qa + u, nq - 1) * S + s] + row;
        wrow[u] = r >= 0 && r < nrows ? pool + r * wpb : k1_zero_row;
      }
      if (MODE == kHitFSum) {
#pragma unroll
        for (int u = 0; u < K1_QB; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float f = (float)(int32_t)lane_val(wrow[u], b, lb, lane + 32 * i);
            fs[u][i] = s == 0 ? f : fs[u][i] + f;
          }
        continue;
      }
      uint32_t x[K1_QB];
      if (b <= 8) {
        // every load first, with no branch between them, then the bytes
        const int wi = lane & (wpb - 1);
#pragma unroll
        for (int u = 0; u < K1_QB; ++u) x[u] = __ldg(wrow[u] + wi);
        const int s0 = (lane >> (lb + 2)) << lb;
        const uint32_t rep = width_mask(b) * 0x01010101u;
#pragma unroll
        for (int u = 0; u < K1_QB; ++u) x[u] = (x[u] >> s0) & rep;
      } else {
#pragma unroll
        for (int u = 0; u < K1_QB; ++u) x[u] = span_hits(wrow[u], b, lb, lane);
      }
#pragma unroll
      for (int u = 0; u < K1_QB; ++u) {
        if (MODE == kHitAny) acc[u] |= x[u];
        if (MODE == kHitAll) acc[u] &= __vcmpne4(x[u], 0u);
        if (MODE == kHitCount) acc[u] += __vcmpne4(x[u], 0u) & 0x01010101u;
      }
    }

    // ---- pass 2, one query at a time: score the hit lanes only
#pragma unroll
    for (int u = 0; u < K1_QB; ++u) {
      if (qa + u >= nq) break;
      const int qi = qa + u;
      uint32_t hb = 0u;  // bit i: lane lane + 32 i hits
      if (MODE == kHitFSum) {
#pragma unroll
        for (int i = 0; i < 4; ++i) hb |= (fs[u][i] > 0.0f ? 1u : 0u) << i;
      } else {
        const uint32_t h = MODE == kHitAny    ? __vcmpne4(acc[u], 0u)
                           : MODE == kHitAll  ? acc[u]
                                              : __vcmpgeu4(acc[u], thr);
        hb = ((h >> 7) & 1u) | ((h >> 14) & 2u) | ((h >> 21) & 4u) |
             ((h >> 28) & 8u);
      }
      // compact the hit lanes, in ascending lane order
      int H = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned bal = __ballot_sync(IRS_FULL_MASK, (hb >> i) & 1u);
        if ((hb >> i) & 1u)
          hits[H + __popc(bal & ((1u << lane) - 1u))] = (uint8_t)(lane + 32 * i);
        H += __popc(bal);
      }
      float best = -INFINITY;
      int arg = H > 0 ? IRS_BLOCK : 0;
      if (H > 0) {
        // this query's row of every span, once per (query, row)
        for (int t = lane; t < S; t += 32) {
          const long long r = (long long)s_start[qi * S + t] + row;
          rows[t] = r >= 0 && r < sp.rows[t] ? sp.pool[t] + r * (4 << sp.lbits[t])
                                             : k1_zero_row;
        }
        __syncwarp();
        for (int k = lane; k < H; k += 32) {
          const int j = hits[k];
          const float pj = pre[j];
          float score = 0.0f;
          for (int t = 0; t < S; ++t) {
            const uint32_t v = lane_val(rows[t], sp.bits[t], sp.lbits[t], j);
            if (v != 0u)
              score = score + score_lane(kind, s_w[qi * S + t],
                                         (float)(int32_t)v, pj, c0);
          }
          if (score > best) {  // k ascends: the first max lane is kept
            best = score;
            arg = j;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(IRS_FULL_MASK, best, off);
          const int oa = __shfl_down_sync(IRS_FULL_MASK, arg, off);
          if (ov > best || (ov == best && oa < arg)) {
            best = ov;
            arg = oa;
          }
        }
        __syncwarp();  // the hit list is rewritten for the next query
      }
      if (lane == 0) {
        const long long o = (long long)(q0 + qi) * ndrows + row;
        out_max[o] = best;
        out_arg[o] = arg;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2: batched contiguous row-slice fetch.
//
// Replaces iresearch_tpu/ops/dma_gather.py:dma_row_slices (Pallas, one
// async DMA per (query, pool)). out_p[q] = pool_p[starts[q, p] :
// starts[q, p] + R]: the window is R * wpb_p contiguous words, so each
// block copies one (query, pool) window with 16-byte vector loads when
// the row width allows it.
//
// Bound: device memory (a pure copy, 2 * R * 16 * b bytes per window).
// The pools carry a DSLICE_PAD zero tail so windows never clamp; rows
// outside the pool are written as zeros (a guard, never hit by a plan).
struct SlicePools {
  const uint32_t* pool[IRS_MAX_SLICE_POOLS];
  uint32_t* out[IRS_MAX_SLICE_POOLS];
  long long rows[IRS_MAX_SLICE_POOLS];
  int wpb[IRS_MAX_SLICE_POOLS];
};

__global__ void __launch_bounds__(256)
k2_dma_row_slices(SlicePools sp, int P, const int32_t* __restrict__ starts,
                  int R) {
  const int q = blockIdx.x;
  const int p = blockIdx.y;
  const int wpb = sp.wpb[p];
  const long long st = starts[q * P + p];
  const long long n = (long long)R * wpb;
  const uint32_t* src = sp.pool[p] + st * wpb;
  uint32_t* dst = sp.out[p] + (long long)q * n;
  if (st < 0 || st + R > sp.rows[p]) {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) {
      const long long r = st + i / wpb;
      dst[i] = (r >= 0 && r < sp.rows[p]) ? src[i] : 0u;
    }
    return;
  }
  const bool vec = (wpb % 4 == 0) && ((uintptr_t)src % 16 == 0) &&
                   ((uintptr_t)dst % 16 == 0);
  if (vec) {
    const uint4* s4 = (const uint4*)src;
    uint4* d4 = (uint4*)dst;
    for (long long i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// ---------------------------------------------------------------------------
// K3: postings block decode.
//
// Replaces iresearch_tpu/ops/decode.py:decode_rows_pallas (and the XLA
// decode of exec/executor.py:_group_contrib). For output row r: unpack the
// doc-delta lanes of doc_words[rows_d[r]] and the freq lanes of
// freq_words[rows_f[r]]; docs = base[rows_d[r]] + inclusive prefix sum of
// the deltas (int32, wrapping like XLA), freqs = f32(int32(f)).
//
// Bound: device memory (16 * (bd + bf) bytes in, 1 KB out per row). One
// 128-thread block per row, one lane per thread: the scan is a warp
// shuffle scan plus one cross-warp step through 16 bytes of shared
// memory, replacing the Pallas kernel's [128, 128] masked-sum prefix.
__global__ void __launch_bounds__(IRS_BLOCK)
k3_decode_rows(const uint32_t* __restrict__ doc_words,
               const uint32_t* __restrict__ freq_words,
               const int32_t* __restrict__ base,
               const int32_t* __restrict__ rows_d,
               const int32_t* __restrict__ rows_f, long long nd_rows,
               long long nf_rows, int bd, int bf, int32_t* __restrict__ docs,
               float* __restrict__ freqs) {
  __shared__ uint32_t warp_sum[IRS_BLOCK / 32];
  const long long r = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const long long rd = rows_d[r];
  const long long rf = rows_f[r];
  // rows outside the pools decode as the zero sentinel (a guard only)
  const bool okd = rd >= 0 && rd < nd_rows;
  const bool okf = rf >= 0 && rf < nf_rows;

  uint32_t x = okd ? lane_bits(doc_words + rd * (4 * bd), bd, j) : 0u;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(IRS_FULL_MASK, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) x += warp_sum[w];
  const uint32_t b0 = okd ? (uint32_t)base[rd] : 0u;
  docs[r * IRS_BLOCK + j] = (int32_t)(b0 + x);

  const uint32_t f = okf ? lane_bits(freq_words + rf * (4 * bf), bf, j) : 0u;
  freqs[r * IRS_BLOCK + j] = (float)(int32_t)f;
}

// ---------------------------------------------------------------------------
// C entry points (ctypes).

extern "C" {

const char* irs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int irs_dense_scan_rowmax(const void* const* pools, const long long* rows,
                          const int* bits, int S, const void* starts,
                          const void* ws, const void* norms, int norms_u16,
                          int ndrows, int Q, int kind, float kb, float c0,
                          float avgdl, int conj, int mm, void* out_max,
                          void* out_arg, void* stream) {
  const int chunks = (Q + K1_QCHUNK - 1) / K1_QCHUNK;
  if (S < 1 || S > IRS_MAX_SPANS || Q < 1 || chunks > 65535 || ndrows < 1)
    return (int)cudaErrorInvalidValue;
  SpanPools sp = {};
  bool wide = false;  // a 32-bit span: f can be negative
  for (int s = 0; s < S; ++s) {
    int lb = 0;
    while (lb < 5 && (1 << lb) != bits[s]) ++lb;
    if ((1 << lb) != bits[s]) return (int)cudaErrorInvalidValue;
    sp.pool[s] = (const uint32_t*)pools[s];
    sp.rows[s] = rows[s];
    sp.bits[s] = bits[s];
    sp.lbits[s] = lb;
    wide = wide || bits[s] == 32;
  }
  // the plain version's hit rule: conj takes the min over spans of f (of
  // 0/1 hit indicators when mm > 1, which then never reach mm), otherwise
  // the sum of f, or of the indicators when mm > 1
  int mode = conj ? kHitAll : mm > 1 ? kHitCount : wide ? kHitFSum : kHitAny;
  if (conj && mm > 1) {
    mode = kHitCount;
    mm = 255;  // above any count of <= 64 spans: no lane hits
  }
  dim3 grid((ndrows + K1_WARPS - 1) / K1_WARPS, chunks);
  cudaStream_t st = (cudaStream_t)stream;
#define K1_LAUNCH(M)                                                       \
  k1_dense_scan_rowmax<M><<<grid, K1_WARPS * 32, 0, st>>>(                 \
      sp, S, (const int32_t*)starts, (const float*)ws, norms, norms_u16,  \
      ndrows, Q, kind, kb, c0, avgdl, mm, (float*)out_max,                \
      (int32_t*)out_arg)
  switch (mode) {
    case kHitAny: K1_LAUNCH(kHitAny); break;
    case kHitAll: K1_LAUNCH(kHitAll); break;
    case kHitCount: K1_LAUNCH(kHitCount); break;
    default: K1_LAUNCH(kHitFSum); break;
  }
#undef K1_LAUNCH
  return (int)cudaGetLastError();
}

int irs_dma_row_slices(const void* const* pools, void* const* outs,
                       const long long* rows, const int* wpb, int P,
                       const void* starts, int Q, int R, void* stream) {
  if (P < 1 || P > IRS_MAX_SLICE_POOLS || Q < 1 || Q > 65535 || R < 1)
    return (int)cudaErrorInvalidValue;
  SlicePools sp = {};
  for (int p = 0; p < P; ++p) {
    sp.pool[p] = (const uint32_t*)pools[p];
    sp.out[p] = (uint32_t*)outs[p];
    sp.rows[p] = rows[p];
    sp.wpb[p] = wpb[p];
  }
  dim3 grid(Q, P);
  k2_dma_row_slices<<<grid, 256, 0, (cudaStream_t)stream>>>(
      sp, P, (const int32_t*)starts, R);
  return (int)cudaGetLastError();
}

int irs_decode_rows(const void* doc_words, const void* freq_words,
                    const void* base, const void* rows_d, const void* rows_f,
                    long long nd_rows, long long nf_rows, int R, int bd,
                    int bf, void* docs, void* freqs, void* stream) {
  if (R < 1) return (int)cudaErrorInvalidValue;
  k3_decode_rows<<<R, IRS_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)doc_words, (const uint32_t*)freq_words,
      (const int32_t*)base, (const int32_t*)rows_d, (const int32_t*)rows_f,
      nd_rows, nf_rows, bd, bf, (int32_t*)docs, (float*)freqs);
  return (int)cudaGetLastError();
}

}  // extern "C"

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

// ops/dense_scan.py:_score_expr, operation for operation.
__device__ __forceinline__ float score_expr(int kind, float w, float f,
                                            float dl, float c1, float c0) {
  switch (kind) {
    case kBM25: {
      const float denom = f + (c1 * dl + c0);
      return w * f / fmaxf(denom, 1e-9f);
    }
    case kBM25NoLen:
      return w * f / fmaxf(f + c0, 1e-9f);
    case kTFIDF:
      return w * sqrtf(f) * rsqrtf(fmaxf(dl, 1.0f));
    case kTFIDFNoNorm:
      return w * sqrtf(f);
    default:
      return f > 0.0f ? w : 0.0f;
  }
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
// Bound: device memory. Each (q, r) reads S rows of 16*b bytes plus 256
// bytes of u16 norms and writes 8 bytes; the arithmetic is ~10 flops per
// lane. One warp per (q, row), four lanes per thread (j = lane + 32 i), so
// a warp's word loads are contiguous and the norms row is read in four
// coalesced 64-byte pieces; the row max and its first lane come from warp
// shuffles, with nothing in shared memory. The starts are per query, so
// no [Q, ndrows] slice of any pool is ever materialised.
struct SpanPools {
  const uint32_t* pool[IRS_MAX_SPANS];
  long long rows[IRS_MAX_SPANS];
  int bits[IRS_MAX_SPANS];
};

__global__ void __launch_bounds__(256)
k1_dense_scan_rowmax(SpanPools sp, int S, const int32_t* __restrict__ starts,
                     const float* __restrict__ ws, const void* __restrict__ norms,
                     int norms_u16, int ndrows, int kind, float kb, float c0,
                     float avgdl, int conj, int mm,
                     float* __restrict__ out_max, int32_t* __restrict__ out_arg) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int q = blockIdx.y;
  if (row >= ndrows) return;
  const float c1 = kb / avgdl;

  float dl[4], score[4], fagg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long idx = (long long)row * IRS_BLOCK + lane + 32 * i;
    dl[i] = norms_u16
                ? (float)(int)((const uint16_t*)norms)[idx]
                : ((const float*)norms)[idx];
    score[i] = 0.0f;
    fagg[i] = 0.0f;
  }
  for (int s = 0; s < S; ++s) {
    const int b = sp.bits[s];
    const long long r = (long long)starts[q * S + s] + row;
    // rows outside the pool read as the zero sentinel (never for a plan;
    // the guard keeps a bad start from reading foreign memory)
    const bool ok = r >= 0 && r < sp.rows[s];
    const uint32_t* wrow = sp.pool[s] + (ok ? r : 0) * (4 * b);
    const float w = ws[q * S + s];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = ok ? lane_bits(wrow, b, lane + 32 * i) : 0u;
      const float f = (float)(int32_t)v;
      score[i] = score[i] + score_expr(kind, w, f, dl[i], c1, c0);
      const float h = mm > 1 ? (f > 0.0f ? 1.0f : 0.0f) : f;
      fagg[i] = s == 0 ? h : (conj ? fminf(fagg[i], h) : fagg[i] + h);
    }
  }
  float best = -INFINITY;
  int arg = lane;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool hit = mm > 1 ? fagg[i] >= (float)mm : fagg[i] > 0.0f;
    const float v = hit ? score[i] : -INFINITY;
    if (i == 0 || v > best) {  // ascending lanes: first max wins
      best = v;
      arg = lane + 32 * i;
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
  if (lane == 0) {
    const long long o = (long long)q * ndrows + row;
    out_max[o] = best;
    out_arg[o] = arg;
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
  if (S < 1 || S > IRS_MAX_SPANS || Q < 1 || Q > 65535 || ndrows < 1)
    return (int)cudaErrorInvalidValue;
  SpanPools sp = {};
  for (int s = 0; s < S; ++s) {
    sp.pool[s] = (const uint32_t*)pools[s];
    sp.rows[s] = rows[s];
    sp.bits[s] = bits[s];
  }
  const int rows_per_block = 256 / 32;
  dim3 grid((ndrows + rows_per_block - 1) / rows_per_block, Q);
  k1_dense_scan_rowmax<<<grid, 256, 0, (cudaStream_t)stream>>>(
      sp, S, (const int32_t*)starts, (const float*)ws, norms, norms_u16,
      ndrows, kind, kb, c0, avgdl, conj, mm, (float*)out_max,
      (int32_t*)out_arg);
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

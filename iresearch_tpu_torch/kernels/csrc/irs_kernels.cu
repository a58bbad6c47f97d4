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
  kTFIDF = 2,       // K1: w * sqrt(f) * rsqrt(max(dl, 1)); K3: / sqrt(..)
  kTFIDFNoNorm = 3, // w * sqrt(f)
  kBoost = 4,       // f > 0 ? w : 0
};

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
// starts[q, p] + R]: window (q, p) is R * wpb_p contiguous words. The
// pools carry a DSLICE_PAD zero tail so windows never clamp; rows outside
// the pool are written as zeros (a guard, never hit by a plan).
//
// Bound: device memory in principle (a pure copy, 2 * R * 4 * wpb bytes
// per window), but the mix's two calls move 4.3 MB in all, ~1.3 us at
// 3.35 TB/s, which is less than one kernel launch takes on the device:
// what bounds it is the launch and how many SMs the copy is spread over.
// The first design ran one block per (query, pool): 20 blocks for the
// 5-query group on 132 SMs, an 8 KB window serialised in one block and a
// scalar 4-byte copy for the one-word `base` pool. This design runs a flat
// grid over K2_CHUNK-word pieces of all (pool, query) windows, found
// through a per-pool offset table in the by-value argument; each thread
// moves 16 bytes. A window is 4-byte aligned only (wpb = 1, any start row):
// where source and destination agree modulo 16 its head and tail go as
// words and its middle as uint4, else it goes as words.
//
// No bulk-copy engine (cp.async.bulk / TMA): windows are 256 B-8 KB at
// per-query offsets, so a descriptor and an mbarrier round trip per window
// would cost more than the loads they replace, and nothing is staged in
// shared memory: the data goes from registers straight back to memory.
//
// What bounds it now (NVIDIA H100, chip_smoke.py and PERF.md): latency.
// A launch takes ~2.2 us of device time replayed from a CUDA graph (~3 us
// inside a pass, inputs cold) against ~1.0 us for an empty kernel and
// 1.3 us of bytes for both calls together: one dependent chain of starts
// -> words -> store per thread, with nothing left to overlap it with. The
// host takes ten times as long to enqueue a call (enqueue_ms there). 40
// registers, an 8-byte spill (the by-value table indexed by the pool
// found at run time).
#define K2_THREADS 256
#define K2_CHUNK (K2_THREADS * 4)  // words per block: 16 bytes a thread

struct SlicePools {
  const uint32_t* pool[IRS_MAX_SLICE_POOLS];
  uint32_t* out[IRS_MAX_SLICE_POOLS];
  long long rows[IRS_MAX_SLICE_POOLS];
  int wpb[IRS_MAX_SLICE_POOLS];
  int chunks[IRS_MAX_SLICE_POOLS];     // pieces per window
  long long first[IRS_MAX_SLICE_POOLS + 1];  // first block of each pool
};

__global__ void __launch_bounds__(K2_THREADS)
k2_dma_row_slices(SlicePools sp, int P, const int32_t* __restrict__ starts,
                  int R) {
  const long long blk = blockIdx.x;
  int p = 0;
  while (p + 1 < P && blk >= sp.first[p + 1]) ++p;
  const long long local = blk - sp.first[p];
  const int q = (int)(local / sp.chunks[p]);  // once per block
  const int piece = (int)(local - (long long)q * sp.chunks[p]);
  const int wpb = sp.wpb[p];
  const long long st = starts[(long long)q * P + p];
  const long long n = (long long)R * wpb;  // words per window
  const long long lo = (long long)piece * K2_CHUNK;
  const int len = (int)min((long long)K2_CHUNK, n - lo);
  const uint32_t* src = sp.pool[p] + st * wpb + lo;
  uint32_t* dst = sp.out[p] + (long long)q * n + lo;
  const int t = threadIdx.x;
  if (st < 0 || st + R > sp.rows[p]) {
    for (int i = t; i < len; i += K2_THREADS) {
      const long long r = st + (lo + i) / wpb;
      dst[i] = (r >= 0 && r < sp.rows[p]) ? src[i] : 0u;
    }
    return;
  }
  const int ms = (int)(((uintptr_t)src >> 2) & 3);  // words past a 16 B line
  if (ms != (int)(((uintptr_t)dst >> 2) & 3)) {
    for (int i = t; i < len; i += K2_THREADS) dst[i] = __ldg(src + i);
    return;
  }
  const int head = min((4 - ms) & 3, len);
  const int nvec = (len - head) >> 2;
  const uint4* s4 = (const uint4*)(src + head);
  uint4* d4 = (uint4*)(dst + head);
  for (int i = t; i < nvec; i += K2_THREADS) d4[i] = __ldg(s4 + i);
  // head and tail words: fewer than 4 each
  const int tail0 = head + 4 * nvec;
  if (t < head) dst[t] = __ldg(src + t);
  if (t < len - tail0) dst[tail0 + t] = __ldg(src + tail0 + t);
}

// ---------------------------------------------------------------------------
// K3: postings block decode, plain and scored.
//
// Replaces iresearch_tpu/ops/decode.py:decode_rows_pallas (and the XLA
// decode of exec/executor.py:_group_contrib). For output row r: unpack the
// doc-delta lanes of doc_words[rows_d[r]] and the freq lanes of
// freq_words[rows_f[r]]; docs = base[rows_d[r]] + inclusive prefix sum of
// the deltas (int32, wrapping like XLA), freqs = f32(int32(f)). The scored
// form (k3_decode_score_rows) goes on in registers with what the JAX
// package left to XLA to fuse after the decode (_group_contrib): the doc
// lengths, from the row's inline norm block (max(f32(int32(n)), 1)) or, on
// segments without norm pools (bn == -1), from norms[clamp(doc)]; the
// score in search/scorers.py:score_block_torch's operation order (IEEE
// divide and square root, --fmad=false: bit-identical for BM25); and the
// match flag f > 0.
//
// Bound: device memory in principle (16 * (bd + bf [+ bn]) bytes in, 1 KB
// out per row; the scored form 1,152 B out, 1,664 B with dl), but a call
// decodes a few thousand rows (5-9 MB, 2-3 us at 3.35 TB/s), which is
// about what one kernel launch takes on the device: the launch bounds it,
// and folding the work of the ~10 PyTorch kernels that followed each
// decode into the same launch is what the scored form is for.
//
// Design: a warp per row, four lanes per thread, K3_WARPS rows per block.
// Thread t owns lanes 4t..4t+3. In the planar layout they are the four
// consecutive words 4 (t mod b)..+3 at the common shift (t / b) * b (b a
// power of two: shifts and masks only), so a thread's lanes are one
// 16-byte load, one shift and one mask per pool. The prefix sum is three
// adds in the thread and a five-step shuffle scan over the warp: no shared
// memory, no block barrier. A thread stores one int4 of docs, one float4
// of freqs or scores (512 B per warp, coalesced) and, in the scored form,
// its four match flags as one word. The first design ran a 128-thread
// block per row with a block barrier, a serial cross-warp add and a
// run-time % and / per lane.
//
// What bounds it now (NVIDIA H100, chip_smoke.py and PERF.md): latency, as
// K2. A launch of the plain form takes ~2.7 us of device time replayed
// from a CUDA graph, of the scored form ~4 us (~4.2 us inside a pass,
// inputs cold), against ~1.0 us for an empty kernel: row id -> words ->
// (norms at the decoded docs ->) store is two or three dependent memory
// round trips, and 600 blocks are one wave. The host takes ten times as
// long to enqueue a call (enqueue_ms there). 20 and 34 registers, no
// spills.
#define K3_WARPS 8  // rows per block, one warp each

// lanes 4t..4t+3 of a b-bit row (b = 1 << lb): one 16-byte load
__device__ __forceinline__ uint4 lanes4(const uint32_t* row, int b, int lb,
                                        int t) {
  uint4 v = __ldg((const uint4*)row + (t & (b - 1)));
  const int sh = (t >> lb) << lb;
  const uint32_t m = width_mask(b);
  v.x = (v.x >> sh) & m;
  v.y = (v.y >> sh) & m;
  v.z = (v.z >> sh) & m;
  v.w = (v.w >> sh) & m;
  return v;
}

struct DecodeArgs {
  const uint32_t* doc_words;
  const uint32_t* freq_words;
  const int32_t* base;
  const int32_t* rows_d;
  const int32_t* rows_f;
  long long nd_rows, nf_rows;
  int R, bd, lbd, bf, lbf;
};

// This thread's four docs (as the wrapping u32 sums) and freqs of output
// row r; rows outside the pools decode as zeros (a guard only).
__device__ __forceinline__ void decode_lanes(const DecodeArgs& a, long long r,
                                             int t, uint4* docs, float4* f) {
  const long long rd = a.rows_d[r];
  const long long rf = a.rows_f[r];
  const bool okd = rd >= 0 && rd < a.nd_rows;
  const bool okf = rf >= 0 && rf < a.nf_rows;
  uint4 d = make_uint4(0u, 0u, 0u, 0u);
  if (okd) d = lanes4(a.doc_words + rd * (4 << a.lbd), a.bd, a.lbd, t);
  d.y += d.x;
  d.z += d.y;
  d.w += d.z;
  uint32_t run = d.w;  // inclusive scan of the threads' sums over the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(IRS_FULL_MASK, run, off);
    if (t >= off) run += y;
  }
  const uint32_t before = (okd ? (uint32_t)a.base[rd] : 0u) + (run - d.w);
  *docs = make_uint4(before + d.x, before + d.y, before + d.z, before + d.w);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (okf) v = lanes4(a.freq_words + rf * (4 << a.lbf), a.bf, a.lbf, t);
  *f = make_float4((float)(int32_t)v.x, (float)(int32_t)v.y,
                   (float)(int32_t)v.z, (float)(int32_t)v.w);
}

__global__ void __launch_bounds__(K3_WARPS * 32)
k3_decode_rows(DecodeArgs a, int32_t* __restrict__ docs,
               float* __restrict__ freqs) {
  const int t = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * K3_WARPS + (threadIdx.x >> 5);
  if (r >= a.R) return;  // a whole warp: the shuffles stay converged
  uint4 d;
  float4 f;
  decode_lanes(a, r, t, &d, &f);
  ((uint4*)docs)[r * 32 + t] = d;
  ((float4*)freqs)[r * 32 + t] = f;
}

// score_block_torch's expression for one lane (TFIDF divides here, where
// K1's score_lane multiplies by rsqrt as the fused scan's expression does)
__device__ __forceinline__ float score_block_lane(int kind, float w, float f,
                                                  float dl, float c1,
                                                  float c0) {
  switch (kind) {
    case kBM25:
      return score_lane(kBM25, w, f, c1 * dl + c0, c0);
    case kTFIDF:
      return w * sqrtf(f) / sqrtf(fmaxf(dl, 1.0f));
    case kBoost:
      return w * (f > 0.0f ? 1.0f : 0.0f);
    default:
      return score_lane(kind, w, f, 0.0f, c0);
  }
}

struct ScoreArgs {
  const uint32_t* nrm_words;  // inline norm pool, bn >= 0
  const int32_t* rows_n;
  long long nn_rows;
  int bn, lbn;         // bn == -1: doc lengths from norms[doc]
  const float* norms;  // f32 [nd_pad], bn == -1
  int nd_pad;
  const float* w;          // f32 [R]
  const float* avgdl_dev;  // one f32 on the device, or null: avgdl
  float avgdl, kb, c0;
  int kind;
};

__global__ void __launch_bounds__(K3_WARPS * 32)
k3_decode_score_rows(DecodeArgs a, ScoreArgs s, int32_t* __restrict__ docs,
                     float* __restrict__ scores, uint8_t* __restrict__ matched,
                     float* __restrict__ dl_out) {
  const int t = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * K3_WARPS + (threadIdx.x >> 5);
  if (r >= a.R) return;
  uint4 d;
  float4 f;
  decode_lanes(a, r, t, &d, &f);
  float4 dl;
  if (s.bn >= 0) {
    const long long rn = s.rows_n[r];
    uint4 n = make_uint4(0u, 0u, 0u, 0u);
    if (rn >= 0 && rn < s.nn_rows)
      n = lanes4(s.nrm_words + rn * (4 << s.lbn), s.bn, s.lbn, t);
    // pad lanes carry norm 0: at least 1 keeps the tf math finite
    dl = make_float4(fmaxf((float)(int32_t)n.x, 1.0f),
                     fmaxf((float)(int32_t)n.y, 1.0f),
                     fmaxf((float)(int32_t)n.z, 1.0f),
                     fmaxf((float)(int32_t)n.w, 1.0f));
  } else {
    const int hi = s.nd_pad - 1;
    dl = make_float4(__ldg(s.norms + min(max((int32_t)d.x, 0), hi)),
                     __ldg(s.norms + min(max((int32_t)d.y, 0), hi)),
                     __ldg(s.norms + min(max((int32_t)d.z, 0), hi)),
                     __ldg(s.norms + min(max((int32_t)d.w, 0), hi)));
  }
  const float w = s.w[r];
  const float avgdl = s.avgdl_dev ? __ldg(s.avgdl_dev) : s.avgdl;
  const float c1 = s.kind == kBM25 ? s.kb / avgdl : 0.0f;
  ((uint4*)docs)[r * 32 + t] = d;
  ((float4*)scores)[r * 32 + t] =
      make_float4(score_block_lane(s.kind, w, f.x, dl.x, c1, s.c0),
                  score_block_lane(s.kind, w, f.y, dl.y, c1, s.c0),
                  score_block_lane(s.kind, w, f.z, dl.z, c1, s.c0),
                  score_block_lane(s.kind, w, f.w, dl.w, c1, s.c0));
  ((uint32_t*)matched)[r * 32 + t] =
      (f.x > 0.0f ? 1u : 0u) | (f.y > 0.0f ? 0x100u : 0u) |
      (f.z > 0.0f ? 0x10000u : 0u) | (f.w > 0.0f ? 0x1000000u : 0u);
  if (dl_out) ((float4*)dl_out)[r * 32 + t] = dl;
}

// An empty kernel: its device time per launch is the floor under every
// kernel above whose bytes take less than a launch does.
__global__ void irs_noop_kernel() {}

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

// Window p of query q lies at out + (the pools before it, each rounded up
// to 16 bytes) + q * R * wpb_p words: ops/dma_gather.py cuts the same views.
int irs_dma_row_slices(const void* const* pools, const long long* rows,
                       const int* wpb, int P, const void* starts, int Q,
                       int R, void* out, void* stream) {
  if (P < 1 || P > IRS_MAX_SLICE_POOLS || Q < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  SlicePools sp = {};
  long long words = 0, blocks = 0;
  for (int p = 0; p < P; ++p) {
    if (wpb[p] < 1) return (int)cudaErrorInvalidValue;
    const long long n = (long long)R * wpb[p];
    sp.pool[p] = (const uint32_t*)pools[p];
    sp.out[p] = (uint32_t*)out + words;
    sp.rows[p] = rows[p];
    sp.wpb[p] = wpb[p];
    sp.chunks[p] = (int)((n + K2_CHUNK - 1) / K2_CHUNK);
    sp.first[p] = blocks;
    words += ((long long)Q * n + 3) / 4 * 4;
    blocks += (long long)Q * sp.chunks[p];
  }
  sp.first[P] = blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k2_dma_row_slices<<<(unsigned)blocks, K2_THREADS, 0, (cudaStream_t)stream>>>(
      sp, P, (const int32_t*)starts, R);
  return (int)cudaGetLastError();
}

static int log2_width(int b) {
  for (int lb = 0; lb <= 5; ++lb)
    if ((1 << lb) == b) return lb;
  return -1;
}

static bool decode_args(DecodeArgs* a, const void* doc_words,
                        const void* freq_words, const void* base,
                        const void* rows_d, const void* rows_f,
                        long long nd_rows, long long nf_rows, int R, int bd,
                        int bf) {
  *a = DecodeArgs{(const uint32_t*)doc_words, (const uint32_t*)freq_words,
        (const int32_t*)base, (const int32_t*)rows_d, (const int32_t*)rows_f,
        nd_rows, nf_rows, R, bd, log2_width(bd), bf, log2_width(bf)};
  return R >= 1 && a->lbd >= 0 && a->lbf >= 0 &&
         (uintptr_t)doc_words % 16 == 0 && (uintptr_t)freq_words % 16 == 0;
}

int irs_decode_rows(const void* doc_words, const void* freq_words,
                    const void* base, const void* rows_d, const void* rows_f,
                    long long nd_rows, long long nf_rows, int R, int bd,
                    int bf, void* docs, void* freqs, void* stream) {
  DecodeArgs a;
  if (!decode_args(&a, doc_words, freq_words, base, rows_d, rows_f, nd_rows,
                   nf_rows, R, bd, bf) ||
      (uintptr_t)docs % 16 != 0 || (uintptr_t)freqs % 16 != 0)
    return (int)cudaErrorInvalidValue;
  k3_decode_rows<<<(R + K3_WARPS - 1) / K3_WARPS, K3_WARPS * 32, 0,
                   (cudaStream_t)stream>>>(a, (int32_t*)docs, (float*)freqs);
  return (int)cudaGetLastError();
}

// bn >= 0: doc lengths from nrm_words[rows_n]; bn == -1: from norms
// (f32 [nd_pad]) at the decoded docs. avgdl_dev, when not null, points at
// one f32 on the device and takes the place of avgdl. dl may be null.
int irs_decode_score_rows(const void* doc_words, const void* freq_words,
                          const void* base, const void* rows_d,
                          const void* rows_f, long long nd_rows,
                          long long nf_rows, int R, int bd, int bf,
                          const void* nrm_words, const void* rows_n,
                          long long nn_rows, int bn, const void* norms,
                          int nd_pad, const void* w, const void* avgdl_dev,
                          float avgdl, int kind, float kb, float c0,
                          void* docs, void* scores, void* matched, void* dl,
                          void* stream) {
  DecodeArgs a;
  if (!decode_args(&a, doc_words, freq_words, base, rows_d, rows_f, nd_rows,
                   nf_rows, R, bd, bf) ||
      (uintptr_t)docs % 16 != 0 || (uintptr_t)scores % 16 != 0 ||
      (uintptr_t)matched % 4 != 0 || (uintptr_t)dl % 16 != 0 ||
      kind < kBM25 || kind > kBoost)
    return (int)cudaErrorInvalidValue;
  ScoreArgs s = {(const uint32_t*)nrm_words, (const int32_t*)rows_n, nn_rows,
                 bn, bn >= 0 ? log2_width(bn) : 0, (const float*)norms,
                 nd_pad, (const float*)w, (const float*)avgdl_dev, avgdl, kb,
                 c0, kind};
  if (bn >= 0 ? (s.lbn < 0 || !nrm_words || !rows_n ||
                 (uintptr_t)nrm_words % 16 != 0)
              : (bn != -1 || !norms || nd_pad < 1))
    return (int)cudaErrorInvalidValue;
  k3_decode_score_rows<<<(R + K3_WARPS - 1) / K3_WARPS, K3_WARPS * 32, 0,
                         (cudaStream_t)stream>>>(
      a, s, (int32_t*)docs, (float*)scores, (uint8_t*)matched, (float*)dl);
  return (int)cudaGetLastError();
}

int irs_noop(void* stream) {
  irs_noop_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The node count of the graph being captured on stream (a fused pass's
// size: exec/batch.py counts it at capture).
int irs_capture_nodes(void* stream, long long* nodes) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status,
                                           nullptr, &graph);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return (int)cudaErrorStreamCaptureUnmatched;
  size_t n = 0;
  e = cudaGraphGetNodes(graph, nullptr, &n);
  *nodes = (long long)n;
  return (int)e;
}

}  // extern "C"

// K4: exact top-k of each row by (score desc, doc asc).
//
// Built with irs_kernels.cu into one library (kernels/build.py: the same
// flags) and bound with ctypes; the entry points launch on the caller's
// stream, allocate nothing and return cudaGetLastError().
//
// It replaces no Pallas kernel: the JAX package ranks with XLA's
// lax.top_k (iresearch_tpu/ops/topk.py:wide_top_k, its tournament) and
// fixes the tie group up in iresearch_tpu/exec/candidates.py:topk_docs.
// The port's first form (ops/topk.py:topk_docs_ref) made one int64 key per
// (score, doc) and called torch.topk(..., sorted=True) on it: with 64-bit
// keys PyTorch's multi-block radix select runs eight 8-bit passes of about
// three kernels each, and with the key's ~6 elementwise kernels, the sort
// of the k results and two gathers one call was some 30-40 graph nodes. In
// the batched pass over a 2M-doc segment that cost more device time than K1
// (1.45-1.95 ms a request against K1's 1.28 in a traced run, PERF.md).
//
// Exactness. The rank key is _order_key's, computed in registers: the f32
// score plus +0.0 (so -0.0 equals +0.0), its bits as an int32 mapped to an
// order-preserving signed int (negative bits ^ 0x7fffffff), shifted above
// INT32_MAX - doc, all in 64-bit two's complement; the sign bit flipped
// gives the same order on the unsigned key. Equal keys are equal (score,
// doc) pairs. The values written are the input's own f32 bits, read again
// at the winners' positions, so the output equals the key path's bit for
// bit.
//
// Bound: device memory. A call must read each (score, doc) once, Q * N * 8
// bytes (Q * N * 4 where docs are positions), and write Q * k * 8: at the
// batched pass's shapes (PERF.md: Q up to 115; N = 16,384 or 25,600 with
// k = 100, N = 16,384 with k = 200) 0.04-4.5 us at 3.35 TB/s, against
// about 1-2 us of each launch; the operations are a few integer ones per
// entry and pass. What bounds it on the card is the chain of dependent
// steps inside a block (a load, two or more passes each ending in a
// barrier, the compaction, the ranking, the write) and, on tiles of a wide
// row, the loads' bandwidth: 25-42 us a call at those shapes in two
// launches (PERF.md), 9.5-16x the larger of its byte bound and two
// launches, and 1.7-3.7x faster than torch.topk over the bare values.
//
// Design:
// * One block of K4_THREADS per (row, tile). A row wider than one tile
//   (ops/topk.py:_plan: 4,096 entries up to k = 1,024) is cut into `tiles`
//   equal tiles of at least 2k entries, each of which writes its own k best
//   unsorted, and the wrapper launches again on the [Q, tiles * k]
//   candidates until one tile holds a row; that launch sorts. A wide row
//   (a fold over a whole segment, the single query's Q = 1) so spreads
//   over the SMs instead of running on one.
// * A tile's keys are computed once from the input, K4_BATCH loads in
//   flight a thread, and kept in shared memory where the tile fits
//   (K4_TILE_MAX * 8 = 128 KB, every tile up to k = 4,096); the first
//   radix pass's histogram is counted as they are stored. A longer tile
//   (k above 4,096) computes them again from the input, read from L2,
//   at each pass.
// * Radix select of the k-th key, most significant digit first, in 11-,
//   11- and 10-bit digits over the score half, then the doc half: a pass
//   counts the keys whose resolved high bits equal the prefix into a
//   shared histogram with plain atomics (aggregating a warp's equal digits
//   first, by __match_any_sync or by ballots, was slower on the card);
//   one warp scans it for the k-th key's digit while the others clear the
//   second histogram for the next pass, so a pass costs two barriers. It
//   stops as soon as the k-th key's bin holds exactly the keys still
//   needed, usually after two passes; the doc half is read where ties at
//   the threshold score exceed what is left (a row with fewer than k
//   finite scores: its -inf padding).
// * The winners (keys above the prefix, and those equal to it) are
//   compacted in one pass through warp ballots. A tile of several writes
//   them as they come. A row's only tile ranks up to K4_RANK_MAX of them
//   by counting, for each, the winners that come first (no barrier
//   between steps, as a bitonic sort has), and sorts more with a bitonic
//   sort in shared memory on (key desc, position asc).
// * Above K4_MAX_K winners a row's only tile writes them unsorted too, and
//   k4_sort_runs / k4_merge order them through global memory: runs of
//   K4_MAX_K sorted by the same bitonic sort, then merged in pairs, each
//   entry's place in the merged run its own place plus the entries of the
//   other run that come first (a binary search), one launch a level.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a): k4_topk_docs 40
// registers in both forms, no spills, 32 B of static shared memory;
// dynamic 16 KB of histograms, 8 B a tile entry where the keys are kept
// and, in the sorting launch, 12 B a slot of the next power of two >= k.
// k4_sort_runs 32 registers and 48 KB (12 B a slot of a run), k4_merge 20;
// no spills.

#include <cuda_runtime.h>
#include <stdint.h>

#define K4_THREADS 512
#define K4_BATCH 8          // loads in flight a thread
#define K4_BINS 2048        // 11-bit digits
#define K4_MAX_K 4096       // ops/topk.py:K4_MAX_K
#define K4_TILE_MAX 16384   // ops/topk.py:_tile_cap for the largest k
#define K4_FULL 0xffffffffu
#define K4_RANK_MAX 256     // winners ranked by counting; more sort bitonically
#define K4_SMEM_MAX (2 * K4_BINS * 4 + K4_TILE_MAX * 8 + K4_MAX_K * 12)

enum K4Docs { kDocsPos = 0, kDocsI32 = 1, kDocsI64 = 2 };

struct K4Args {
  const float* scores;
  long long s_rs, s_cs;  // scores' row and column strides, in elements
  const void* docs;      // int32 or int64 by docs_kind; null for kDocsPos
  long long d_rs, d_cs;
  int docs_kind;
  long long n;           // row width
  int tiles, k, cap, p;  // tiles a row, winners a tile, longest tile,
                         // pow2 >= k where the launch sorts, else 0
  float* out_vals;       // [Q, tiles * k]
  void* out_docs;        // int64 for kDocsI64, else int32
};

// _order_key's int64 key with its sign bit flipped: unsigned order is the
// wanted order.
__device__ __forceinline__ unsigned long long k4_key(float s, long long doc) {
  const int bits = __float_as_int(__fadd_rn(s, 0.0f));  // -0.0 -> +0.0
  const long long hi = bits < 0 ? (long long)(bits ^ 0x7fffffff) : (long long)bits;
  const unsigned long long key =
      ((unsigned long long)hi << 32) | (0x7fffffffull - (unsigned long long)doc);
  return key ^ 0x8000000000000000ull;
}

__device__ __forceinline__ long long k4_doc(const K4Args& a, long long row,
                                            long long c) {
  if (a.docs_kind == kDocsPos) return c;
  const long long off = row * a.d_rs + c * a.d_cs;
  return a.docs_kind == kDocsI32 ? (long long)__ldg((const int32_t*)a.docs + off)
                                 : __ldg((const long long*)a.docs + off);
}

// This thread's slot among the warp's lanes with `on`, the warp's first
// slot taken from *counter (warp-uniform call).
__device__ __forceinline__ int k4_ticket(int* counter, bool on, int lane) {
  const unsigned m = __ballot_sync(K4_FULL, on);
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(K4_FULL, base, 0);
  return base + __popc(m & ((1u << lane) - 1u));
}

struct K4State {
  unsigned long long prefix;  // the k-th key's resolved high bits
  int shift;                  // bits below `shift` unresolved (64: none)
  int need;                   // keys still to take among those equal above shift
  int done;                   // every key equal above shift is taken
};

// Inclusive sum over the warp's lanes in lane order.
__device__ __forceinline__ unsigned k4_scan(unsigned x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(K4_FULL, x, o);
    if (lane >= o) x += v;
  }
  return x;
}

// The digit (bits lo .. lo + w - 1) of the k-th key among the counted
// keys: the bins above it hold fewer than `need` keys, it and those above
// at least `need`. One warp: each lane sums nb / 32 bins from the top,
// a scan finds the lane whose bins hold the k-th key, and a second scan
// over that lane's bins (two or one a lane) finds the bin.
__device__ void k4_find(const unsigned* hist, int w, int lo, K4State* st) {
  const int lane = threadIdx.x & 31;
  const int nb = 1 << w, per = nb >> 5, sub = per >> 5;
  const unsigned need = (unsigned)st->need;
  const uint4* h4 = (const uint4*)(hist + nb - per * (lane + 1));
  unsigned mine = 0;
  for (int j = 0; j < per / 4; ++j) {
    const uint4 v = h4[j];
    mine += v.x + v.y + v.z + v.w;
  }
  const unsigned incl = k4_scan(mine, lane);
  const int c = __ffs(__ballot_sync(K4_FULL, incl >= need)) - 1;
  const unsigned above = __shfl_sync(K4_FULL, incl - mine, c);
  const int top = nb - 1 - per * c - lane * sub;  // this lane's first bin
  unsigned cnt[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (j < sub) cnt[j] = hist[top - j];
  const unsigned incl2 = above + k4_scan(cnt[0] + cnt[1], lane);
  const int c2 = __ffs(__ballot_sync(K4_FULL, incl2 >= need)) - 1;
  if (lane == c2) {
    unsigned ab = incl2 - cnt[0] - cnt[1];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < sub && ab + cnt[j] >= need) {
        st->prefix |= (unsigned long long)(top - j) << lo;
        st->shift = lo;
        st->need = (int)(need - ab);
        st->done = cnt[j] == need - ab;
        break;
      }
      ab += cnt[j];
    }
  }
}

// Write the tile's entry i to out[idx]: its own f32 bits and its doc.
__device__ __forceinline__ void k4_write(const K4Args& a, long long idx,
                                         long long row, long long c0, int i,
                                         const float* srow) {
  a.out_vals[idx] = __ldg(srow + i * a.s_cs);
  const long long doc = k4_doc(a, row, c0 + i);
  if (a.docs_kind == kDocsI64)
    ((long long*)a.out_docs)[idx] = doc;
  else
    ((int32_t*)a.out_docs)[idx] = (int32_t)doc;
}

// The tile's entry i's key: kept in shared memory, or computed again.
template <bool CACHED>
__device__ __forceinline__ unsigned long long k4_key_at(
    const K4Args& a, const unsigned long long* keys, long long row,
    long long c0, int i, const float* srow) {
  if (CACHED) return keys[i];
  return k4_key(__ldg(srow + i * a.s_cs), k4_doc(a, row, c0 + i));
}

// A bitonic sort of sk / sp [0, p) in "comes first" order, on (key desc,
// position asc); the slots past the entries hold sentinels (key 0,
// position INT_MAX). Ends with the block's barrier.
__device__ void k4_bitonic(unsigned long long* sk, int* sp, int p) {
  const int tid = threadIdx.x;
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = tid; t < (p >> 1); t += K4_THREADS) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long ui = sk[i], uj = sk[j];
        const int pi = sp[i], pj = sp[j];
        const bool j_first = uj > ui || (uj == ui && pj < pi);
        const bool up = (i & size) == 0;
        if (up == j_first) {
          sk[i] = uj;
          sk[j] = ui;
          sp[i] = pj;
          sp[j] = pi;
        }
      }
    }
  }
  __syncthreads();
}

template <bool CACHED>
__global__ void __launch_bounds__(K4_THREADS) k4_topk_docs(K4Args a) {
  extern __shared__ __align__(16) unsigned char k4_smem[];
  unsigned* hist = (unsigned*)k4_smem;                      // [2][K4_BINS]
  unsigned long long* keys = (unsigned long long*)(hist + 2 * K4_BINS);  // [cap]
  unsigned long long* sk = keys + (CACHED ? a.cap : 0);     // [p]
  int* sp = (int*)(sk + a.p);                               // [p]
  __shared__ K4State st;
  __shared__ int s_cnt, s_eq;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x / a.tiles;
  const int tile = (int)(blockIdx.x % a.tiles);
  const long long c0 = (long long)tile * a.n / a.tiles;
  const int len = (int)((long long)(tile + 1) * a.n / a.tiles - c0);
  const int kout = min(a.k, len);
  const bool select = kout < len;
  const float* srow = a.scores + row * a.s_rs + c0 * a.s_cs;

  for (int b = tid; b < 2 * K4_BINS; b += K4_THREADS) hist[b] = 0u;
  if (tid == 0) {
    st.prefix = 0ull;
    st.shift = 64;
    st.need = kout;
    st.done = !select;
    s_cnt = 0;
    s_eq = 0;
  }
  __syncthreads();

  // keys into shared memory, K4_BATCH loads in flight a thread; the first
  // digit's histogram on the way
  for (int base = 0; base < len; base += K4_BATCH * K4_THREADS) {
    float s[K4_BATCH];
    long long d[K4_BATCH];
#pragma unroll
    for (int j = 0; j < K4_BATCH; ++j) {
      const int i = base + j * K4_THREADS + tid;
      if (i < len) {
        s[j] = __ldg(srow + i * a.s_cs);
        d[j] = k4_doc(a, row, c0 + i);
      }
    }
#pragma unroll
    for (int j = 0; j < K4_BATCH; ++j) {
      const int i = base + j * K4_THREADS + tid;
      if (i < len) {
        const unsigned long long u = k4_key(s[j], d[j]);
        if (CACHED) keys[i] = u;
        if (select) atomicAdd(hist + (unsigned)(u >> 53), 1u);
      }
    }
  }
  __syncthreads();

  // the passes: warp 0 finds a digit in one histogram while the others
  // clear the other one for the next pass's count
  if (select) {
    for (int pass = 0;; ++pass) {
      if (warp == 0) {
        const int lo = (pass < 3 ? 32 : 0) + (pass % 3 == 0 ? 21 : pass % 3 == 1 ? 10 : 0);
        k4_find(hist + (pass & 1) * K4_BINS, pass % 3 == 2 ? 10 : 11, lo, &st);
      } else {
        unsigned* next = hist + ((pass + 1) & 1) * K4_BINS;
        for (int b = tid - 32; b < K4_BINS; b += K4_THREADS - 32) next[b] = 0u;
      }
      __syncthreads();
      if (st.done || pass == 5) break;
      const int p1 = pass + 1;
      const int lo = (p1 < 3 ? 32 : 0) + (p1 % 3 == 0 ? 21 : p1 % 3 == 1 ? 10 : 0);
      const int w = p1 % 3 == 2 ? 10 : 11, hs = lo + w;  // hs < 64
      const unsigned long long want = st.prefix >> hs;
      unsigned* h = hist + (p1 & 1) * K4_BINS;
      for (int i = tid; i < len; i += K4_THREADS) {
        const unsigned long long u = k4_key_at<CACHED>(a, keys, row, c0, i, srow);
        if ((u >> hs) == want) atomicAdd(h + ((unsigned)(u >> lo) & ((1u << w) - 1u)), 1u);
      }
      __syncthreads();
    }
  }

  // the winners: keys above the prefix, and those equal to it (all where
  // done; else, all 64 bits resolved, `need` of the equal keys). A tile
  // of several, or of more than K4_MAX_K winners, writes them as they
  // come; else a row's only tile ranks them.
  const bool sorted = a.p > 0;
  unsigned* rank = hist;  // free now
  if (sorted && kout <= K4_RANK_MAX)
    for (int w = tid; w < kout; w += K4_THREADS) rank[w] = 0u;
  const int sh = st.shift, need = st.need, done = st.done;
  const unsigned long long pre = sh == 64 ? 0ull : st.prefix >> sh;
  const long long o = row * (long long)a.tiles * a.k + (long long)tile * a.k;
  for (int base = 0; base < len; base += K4_THREADS) {
    const int i = base + tid;
    bool take = false, eq = false;
    unsigned long long u = 0ull;
    if (i < len) {
      u = k4_key_at<CACHED>(a, keys, row, c0, i, srow);
      const unsigned long long h = sh == 64 ? 0ull : u >> sh;
      take = h > pre || (h == pre && done);
      eq = h == pre && !done;
    }
    if (__any_sync(K4_FULL, eq)) {
      const int ticket = k4_ticket(&s_eq, eq, lane);
      take |= eq && ticket < need;
    }
    const int slot = k4_ticket(&s_cnt, take, lane);
    if (take) {
      if (sorted) {
        sk[slot] = u;
        sp[slot] = i;
      } else {
        k4_write(a, o + slot, row, c0, i, srow);
      }
    }
  }
  if (!sorted) return;
  __syncthreads();

  if (kout <= K4_RANK_MAX) {
    // a winner's rank: the winners with a larger key, or an equal key
    // (the same score and doc) in a lower slot; K4_THREADS / kout threads
    // count each winner's
    const int parts = K4_THREADS / kout;
    if (tid < parts * kout) {
      const int w = tid % kout;
      const unsigned long long uw = sk[w];
      unsigned r = 0u;
#pragma unroll 4
      for (int j = tid / kout; j < kout; j += parts) {
        const unsigned long long uj = sk[j];
        r += (uj > uw) | ((uj == uw) & (j < w));
      }
      atomicAdd(rank + w, r);
    }
    __syncthreads();
    for (int w = tid; w < kout; w += K4_THREADS)
      k4_write(a, o + rank[w], row, c0, sp[w], srow);
    return;
  }

  // more winners: a bitonic sort of [0, p) in "comes first" order, on
  // (key desc, position asc), sentinels last
  for (int s = kout + tid; s < a.p; s += K4_THREADS) {
    sk[s] = 0ull;
    sp[s] = 0x7fffffff;
  }
  k4_bitonic(sk, sp, a.p);
  for (int r = tid; r < kout; r += K4_THREADS) k4_write(a, o + r, row, c0, sp[r], srow);
}

// The sort of rows of more than K4_MAX_K winners, [Q, k] vals and docs
// (int32 or int64) that a select left unsorted: keys and positions in two
// [Q, k] buffers each, runs read from `src` and written to the other.
struct K4Sort {
  const float* vals;
  const void* docs;
  int docs_kind;  // kDocsI32 or kDocsI64
  int k;
  unsigned long long* keys[2];
  int* pos[2];
  int run, src;   // k4_merge: the sorted runs' length, their buffer
  float* out_vals;
  void* out_docs;
};

__device__ __forceinline__ long long k4_sort_doc(const K4Sort& a, long long j) {
  return a.docs_kind == kDocsI32 ? (long long)((const int32_t*)a.docs)[j]
                                 : ((const long long*)a.docs)[j];
}

// Entry `at` of the sorted row (row offset `ro`) is the input's entry p.
__device__ __forceinline__ void k4_sort_write(const K4Sort& a, long long ro,
                                              long long at, int p) {
  a.out_vals[ro + at] = a.vals[ro + p];
  if (a.docs_kind == kDocsI64)
    ((long long*)a.out_docs)[ro + at] = ((const long long*)a.docs)[ro + p];
  else
    ((int32_t*)a.out_docs)[ro + at] = ((const int32_t*)a.docs)[ro + p];
}

// One block per (row, run of K4_MAX_K entries): the run sorted in shared
// memory into keys[0] / pos[0], or, where one run holds the row, out.
__global__ void __launch_bounds__(K4_THREADS) k4_sort_runs(K4Sort a) {
  extern __shared__ __align__(16) unsigned char k4_smem[];
  unsigned long long* sk = (unsigned long long*)k4_smem;  // [K4_MAX_K]
  int* sp = (int*)(sk + K4_MAX_K);                        // [K4_MAX_K]
  const int runs = (a.k + K4_MAX_K - 1) / K4_MAX_K;
  const long long ro = (long long)(blockIdx.x / runs) * a.k;
  const int r0 = (int)(blockIdx.x % runs) * K4_MAX_K;
  const int len = min(K4_MAX_K, a.k - r0);
  for (int s = threadIdx.x; s < K4_MAX_K; s += K4_THREADS) {
    if (s < len) {
      sk[s] = k4_key(a.vals[ro + r0 + s], k4_sort_doc(a, ro + r0 + s));
      sp[s] = r0 + s;
    } else {
      sk[s] = 0ull;
      sp[s] = 0x7fffffff;
    }
  }
  k4_bitonic(sk, sp, K4_MAX_K);
  for (int s = threadIdx.x; s < len; s += K4_THREADS) {
    if (runs == 1) {
      k4_sort_write(a, ro, s, sp[s]);
    } else {
      a.keys[0][ro + r0 + s] = sk[s];
      a.pos[0][ro + r0 + s] = sp[s];
    }
  }
}

// One thread per entry: runs of `run` merged in pairs, an entry's place
// its place in its run plus the entries of the other run that come first
// (key larger, or equal at a lower position: positions differ, so no two
// entries take one place). The last level writes out.
__global__ void k4_merge(K4Sort a, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long ro = e / a.k * a.k;
  const int i = (int)(e - ro), L = a.run, r = i / L;
  const int other = (r ^ 1) * L, len = max(0, min(L, a.k - other));
  // the buffers picked by a select, not an index: an indexed parameter
  // array would be copied to the stack
  const unsigned long long* K = (a.src ? a.keys[1] : a.keys[0]) + ro;
  const int* P = (a.src ? a.pos[1] : a.pos[0]) + ro;
  const unsigned long long u = K[i];
  const int p = P[i];
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const unsigned long long v = K[other + mid];
    if (v > u || (v == u && P[other + mid] < p)) lo = mid + 1;
    else hi = mid;
  }
  const int at = (r & ~1) * L + (i - r * L) + lo;
  if (2LL * L >= a.k) {
    k4_sort_write(a, ro, at, p);
  } else {
    (a.src ? a.keys[0] : a.keys[1])[ro + at] = u;
    (a.src ? a.pos[0] : a.pos[1])[ro + at] = p;
  }
}

extern "C" {

// One K4 launch over scores [Q, n] (strides in elements): each row cut
// into `tiles` tiles, tile t the columns [t * n / tiles, (t + 1) * n /
// tiles), each holding at least k entries; its k best go to out_vals /
// out_docs [Q, tiles * k] at t * k, sorted by (score desc, doc asc) where
// tiles == 1 and k <= K4_MAX_K, else in no order (irs_topk_sort sorts).
int irs_topk_docs(const void* scores, long long s_rs, long long s_cs,
                  const void* docs, long long d_rs, long long d_cs,
                  int docs_kind, long long Q, long long n, int tiles, int k,
                  void* out_vals, void* out_docs, void* stream) {
  if (Q < 1 || n < 1 || k < 1 || tiles < 1 || n / tiles < k ||
      Q * tiles > 0x7fffffffLL || docs_kind < kDocsPos ||
      docs_kind > kDocsI64 || (docs_kind != kDocsPos && docs == nullptr) ||
      !scores || !out_vals || !out_docs)
    return (int)cudaErrorInvalidValue;
  const long long cap = (n + tiles - 1) / tiles;
  if (cap > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool cached = cap <= K4_TILE_MAX;
  int p = 0;  // the sort's slots: a row's only tile sorts its winners
  if (tiles == 1 && k <= K4_MAX_K) {
    p = 1;
    while (p < k) p <<= 1;
  }
  const size_t smem =
      2 * K4_BINS * 4 + (cached ? (size_t)cap * 8 : 0) + (size_t)p * 12;
  // above 48 KB a block's shared memory must be allowed first, per card
  static int allowed[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < 64 && !allowed[dev]) {
    e = cudaFuncSetAttribute(k4_topk_docs<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K4_SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k4_topk_docs<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               2 * K4_BINS * 4 + K4_MAX_K * 12);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = 1;
  }
  K4Args a = {(const float*)scores, s_rs, s_cs, docs, d_rs, d_cs, docs_kind,
              n, tiles, k, (int)cap, p, (float*)out_vals, out_docs};
  if (cached)
    k4_topk_docs<true><<<(unsigned)(Q * tiles), K4_THREADS, smem,
                         (cudaStream_t)stream>>>(a);
  else
    k4_topk_docs<false><<<(unsigned)(Q * tiles), K4_THREADS, smem,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K4's sort of [Q, k] vals / docs (int32 or int64 by docs_kind) that a
// launch above left unsorted, for k > K4_MAX_K, into out_vals / out_docs
// [Q, k] by (score desc, doc asc): k4_sort_runs, then one k4_merge a
// level, 1 + ceil(log2(ceil(k / K4_MAX_K))) launches (ops/topk.py:
// _sort_launches). keys (uint64) and pos (int32) hold [2, Q, k] each.
int irs_topk_sort(const void* vals, const void* docs, int docs_kind,
                  long long Q, long long k, void* keys, void* pos,
                  void* out_vals, void* out_docs, void* stream) {
  const long long runs = (k + K4_MAX_K - 1) / K4_MAX_K;
  if (Q < 1 || k < 1 || k > 0x3fffffffLL || Q * runs > 0x7fffffffLL ||
      (Q * k + 255) / 256 > 0x7fffffffLL ||
      (docs_kind != kDocsI32 && docs_kind != kDocsI64) || !vals || !docs ||
      !keys || !pos || !out_vals || !out_docs)
    return (int)cudaErrorInvalidValue;
  const long long total = Q * k;
  K4Sort a = {(const float*)vals, docs, docs_kind, (int)k,
              {(unsigned long long*)keys, (unsigned long long*)keys + total},
              {(int*)pos, (int*)pos + total}, 0, 0, (float*)out_vals,
              out_docs};
  const cudaStream_t s = (cudaStream_t)stream;
  k4_sort_runs<<<(unsigned)(Q * runs), K4_THREADS, K4_MAX_K * 12, s>>>(a);
  cudaError_t e = cudaGetLastError();
  for (long long L = K4_MAX_K; e == cudaSuccess && L < k; L <<= 1) {
    a.run = (int)L;
    k4_merge<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(a, total);
    a.src ^= 1;
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // extern "C"

// minplus_structured: the O(N log N) min-plus DP transition for a batch of
// rows whose y_c vectors are non-increasing.
//
// Replaces the TPU kernel src/repro/kernels/minplus/structured.py
// (minplus_structured_pallas; pallas_call at line 165). It computes the
// same function as the dense kernel (minplus.cu): out(j) = min_i F(i) +
// T(i, j) and the first minimizer, with u = y_c of the source interval and
// v = y_c of the destination. Because u and v are non-increasing, T splits
// the source axis at i = j and at the crossing k(j) = first i with
// u(i) <= v(j) into <= 3 segments on which T(i, j) = g(i) + h(j)
// (derivation in repro.core.dp):
//
//   [0, m1)   prefix   g1 = F + (-af*i + dc*u)    h1 = af*j - dc*v
//   [m1, m2)  middle   g2 = F + (-af*i - ac*u)    (k <= j) h = af*j + ac*v
//                      g3 = F + ( df*i + dc*u)    (k >  j) h = -df*j - dc*v
//   [m2, N)   suffix   g4 = F + ( df*i - ac*u)    h4 = -df*j + ac*v
//
// with m1 = min(j, k), m2 = max(j, k). Each destination reads one
// exclusive running min of g1, one of g4 (from the right) and one range
// min of g2 or g3, and combines the three in source order with a strict <,
// which keeps the first minimizer.
//
// What bounded the first design. Its range-min was a doubling table of
// L = bit_length(N) levels of 2N (value, index) pairs a row in device
// memory: at B = 180, N = 2816, 97 MB written and about twice that read
// back a launch, more than the 50 MB L2, for a function whose inputs and
// outputs are 10 MB; and its 1024-thread blocks with 56 KB of shared
// memory ran 180 rows as 1.36 waves.
//
// Design (minplus_structured_kernel, N <= kMaxNShared = 6272). One block
// of 512 threads owns one row and keeps everything in shared memory: u,
// the g2 and g3 rows, the running (min, first index) pairs of g1 and g4,
// and a two-level range-min structure over g2 and g3: level 0 is the
// (min, first index) of each run of 16 positions (one thread a run, its
// reads staggered so a warp's hit 32 banks), and a sparse table over those
// run minima has bit_length(ceil(N/16)) levels (8 x 176 x 2 pairs, 22.5 KB,
// at N = 2816). A middle segment [m1, m2) reads the partial runs at its
// two ends position by position from the g row (at most 15 each, in
// order, strict <) and the whole runs between them from two overlapping
// table entries. At N = 2816 a block holds 101 KB (7N + 4 L ceil(N/16)
// words), so two blocks fit on an SM and the 180 rows of Fig. 2 run in one
// wave; device memory sees the inputs and the outputs only. The scans are
// block-wide: each thread scans a contiguous chunk, a warp-shuffle scan
// joins the chunks. k(j) is a branch-free binary search on u, two
// destinations' searches interleaved; the table level is 31 - __clz(runs).
// Every combine is branch-free: a branch there reconverges on every step.
// What bounds it now is latency: one row alone takes ~2/3 of the time of
// 180 (two blocks a SM), and the middle segments take over a third.
//
// Large N (minplus_structured_global_kernel, kMaxNShared < N <= kMaxN).
// Above 6272 levels the on-chip structure passes the 227 KB a block may
// hold, and the first design runs: 1024 threads, u and the g1/g4 scans in
// shared memory (5N words), the doubling table of g2/g3 in a global
// scratch buffer that the wrapper allocates (torch.empty), each level
// built from the previous one between two __syncthreads. The wrapper
// picks the variant by N alone (ops.structured_variant).
//
// Exactness. Every min/first-argmin combine is exact and associative, so
// any scan order or split of [m1, m2) gives the same (value, index) pairs;
// g and h are evaluated term for term in the plain version's order
// (repro_torch.core.dp.minplus_step_structured: base = (-af*i) + (dc*u),
// then g = F + base; the TPU kernel's F - af*i + dc*u is another order),
// each product and sum rounded on its own (__fmul_rn, __fadd_rn, never an
// FMA). Values and argmins are then bitwise the plain version's, and the
// dense transition's wherever float32 arithmetic is exact.
//
// Bound. Per row it must read F, u, v (3N words) and write the values and
// argmins (2N words): ~10 MB at the main path's B = 180, N = 2816, 3 us at
// 3.35 TB/s, so bytes bound it; the operations (g rows, two scans, the
// run table, a binary search and three queries per destination) take less.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRun = 16;                // positions per run
constexpr int kThreads = 512;           // on-chip variant
constexpr int kGlobalThreads = 1024;    // global-table variant
constexpr int kMaxN = 11264;            // 5 kMaxN words of shared memory
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// (v1, i1) <- the (min value, first index) of the two pairs. Bitwise & and
// |, not && and ||: no branch, so no reconvergence on every combine.
__device__ __forceinline__ void first_min(float& v1, int& i1, float v2, int i2) {
  const bool keep = (v1 < v2) | ((v1 == v2) & (i1 <= i2));
  v1 = keep ? v1 : v2;
  i1 = keep ? i1 : i2;
}

// (v, i) <- (x, p) where x < v: a scan in source order keeps the first.
__device__ __forceinline__ void scan_min(float& v, int& i, float x, int p) {
  const bool take = x < v;
  v = take ? x : v;
  i = take ? p : i;
}

// Shared memory of the on-chip variant for n levels, in 4-byte words.
__host__ __device__ __forceinline__ constexpr int runs_of(int n) { return (n + kRun - 1) / kRun; }
__host__ __device__ __forceinline__ constexpr int bit_length(int x) {
  int b = 0;
  while (x > 0) {
    ++b;
    x >>= 1;
  }
  return b;
}
__host__ __device__ __forceinline__ constexpr int shared_words(int n) {
  const int runs = runs_of(n);
  return 7 * n + 4 * bit_length(runs) * runs;
}
// The largest multiple of 128 levels whose on-chip structure fits the
// 227 KB (232448 bytes) a block may use beside its 128 static bytes.
constexpr int max_n_shared() {
  int n = 128;
  while (shared_words(n + 128) * 4 + 128 <= 232448) n += 128;
  return n;
}
constexpr int kMaxNShared = max_n_shared();

// In-place inclusive running (min, first index) of the pairs (val, idx)
// over logical positions 0..n-1, left to right, or right to left when
// kReverse (position p is element n-1-p). All threads of the block call it.
template <int kBlock, bool kReverse>
__device__ void block_scan(float* val, int* idx, int n, float* warp_v,
                           int* warp_i) {
  constexpr int kWarps = kBlock / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kBlock - 1) / kBlock;
  const int p0 = min(tid * per, n), p1 = min(p0 + per, n);
  // 1) each thread scans its own chunk
  float cv = CUDART_INF_F;
  int ci = INT_MAX;                         // the identity pair
  for (int p = p0; p < p1; ++p) {
    const int x = kReverse ? n - 1 - p : p;
    first_min(cv, ci, val[x], idx[x]);
    val[x] = cv;
    idx[x] = ci;
  }
  // 2) inclusive scan of the chunk totals within the warp
  float tv = cv;
  int ti = ci;
  for (int o = 1; o < 32; o <<= 1) {
    const float ov = __shfl_up_sync(kFull, tv, o);
    const int oi = __shfl_up_sync(kFull, ti, o);
    if (lane >= o) first_min(tv, ti, ov, oi);
  }
  if (lane == 31) {
    warp_v[warp] = tv;
    warp_i[warp] = ti;
  }
  __syncthreads();
  // 3) inclusive scan of the warp totals by the first warp
  if (warp == 0) {
    float wv = lane < kWarps ? warp_v[lane] : CUDART_INF_F;
    int wi = lane < kWarps ? warp_i[lane] : INT_MAX;
    for (int o = 1; o < 32; o <<= 1) {
      const float ov = __shfl_up_sync(kFull, wv, o);
      const int oi = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) first_min(wv, wi, ov, oi);
    }
    if (lane < kWarps) {
      warp_v[lane] = wv;
      warp_i[lane] = wi;
    }
  }
  __syncthreads();
  // 4) everything before this thread's chunk, folded into the chunk
  float ev = __shfl_up_sync(kFull, tv, 1);
  int ei = __shfl_up_sync(kFull, ti, 1);
  if (lane == 0) {
    ev = CUDART_INF_F;
    ei = INT_MAX;
  }
  if (warp > 0) first_min(ev, ei, warp_v[warp - 1], warp_i[warp - 1]);
  for (int p = p0; p < p1; ++p) {
    const int x = kReverse ? n - 1 - p : p;
    float v = val[x];
    int i = idx[x];
    first_min(v, i, ev, ei);
    val[x] = v;
    idx[x] = i;
  }
  __syncthreads();
}

// k(j): the first i with u(i) <= v, u non-increasing in shared memory.
__device__ __forceinline__ int crossing(const float* u, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (u[mid] <= v) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// k for two destinations at once, a fixed number of steps: the count of
// u(i) > v, u non-increasing; the two searches' loads overlap.
__device__ __forceinline__ void crossing2(const float* u, int n, float va,
                                          float vb, int& ka, int& kb) {
  ka = 0;
  kb = 0;
  for (int step = 1 << (31 - __clz(n)); step > 0; step >>= 1) {
    const bool ga = (ka + step <= n) & (u[min(ka + step, n) - 1] > va);
    const bool gb = (kb + step <= n) & (u[min(kb + step, n) - 1] > vb);
    ka += ga ? step : 0;
    kb += gb ? step : 0;
  }
}

// Prefix and suffix parts of destination j and the source-order combine
// with the middle pair (mv, mi) (before its h term): the value and the
// first argmin of the transition.
__device__ __forceinline__ void finish(const float* pv, const int* pa,
                                       const float* sv, const int* sa, int n,
                                       int j, int k, float vj, float mv, int mi,
                                       float af, float df, float ac, float dc,
                                       float* out, int* arg) {
  const float jf = static_cast<float>(j);
  const int m1 = min(j, k), m2 = max(j, k);
  // prefix [0, m1): exclusive running min of g1
  float bv = CUDART_INF_F;
  int bi = 0;
  if (m1 > 0) {
    bv = pv[m1 - 1];
    bi = pa[m1 - 1];
  }
  bv = add(bv, sub(mul(af, jf), mul(dc, vj)));
  const float h_mid = k <= j ? add(mul(af, jf), mul(ac, vj))
                             : sub(mul(-df, jf), mul(dc, vj));
  mv = add(mv, h_mid);
  // suffix [m2, N): exclusive-from-the-right running min of g4
  float xv = CUDART_INF_F;
  int xi = 0;
  if (m2 < n) {
    xv = sv[m2];
    xi = sa[m2];
  }
  xv = add(xv, add(mul(-df, jf), mul(ac, vj)));
  // source order prefix < middle < suffix; strict < keeps the first
  scan_min(bv, bi, mv, mi);
  scan_min(bv, bi, xv, xi);
  *out = bv;
  *arg = bi;
}

// The middle segment [m1, m2) of destination j with crossing k: the
// (min, first index) of g2 (k <= j) or g3 over it, (inf, 0) when empty.
// Partial runs at its ends position by position in order; the whole runs
// between them from two overlapping entries of the run table.
__device__ __forceinline__ void middle_min(const float* g23, const float* tv,
                                           const int* ti, int n, int runs,
                                           int levels, int j, int k,
                                           float& mv, int& mi) {
  const int m1 = min(j, k), m2 = max(j, k);
  mv = CUDART_INF_F;
  mi = m1;
  if (m2 <= m1) {
    mi = 0;
    return;
  }
  const int w = k <= j ? 0 : 1;
  const float* g = g23 + w * n;
  const int b1 = m1 / kRun, b2 = (m2 - 1) / kRun;
  if (b1 == b2) {                           // inside one run
#pragma unroll 4
    for (int p = m1; p < m2; ++p) scan_min(mv, mi, g[p], p);
    return;
  }
  const int lo = m1 % kRun ? b1 + 1 : b1;   // first whole run
  const int hi = m2 % kRun ? b2 - 1 : b2;   // last whole run
#pragma unroll 4
  for (int p = m1; p < lo * kRun; ++p) scan_min(mv, mi, g[p], p);
  if (lo <= hi) {
    const int s = 31 - __clz(hi - lo + 1);
    const int base = (w * levels + s) * runs;
    first_min(mv, mi, tv[base + lo], ti[base + lo]);
    const int r = hi - (1 << s) + 1;
    first_min(mv, mi, tv[base + r], ti[base + r]);
  }
#pragma unroll 4
  for (int p = (hi + 1) * kRun; p < m2; ++p) scan_min(mv, mi, g[p], p);
}

__global__ void __launch_bounds__(kThreads, 2)
minplus_structured_kernel(const float* __restrict__ F,
                          const float* __restrict__ ycp,
                          const float* __restrict__ ycc,
                          const float* __restrict__ coeffs,
                          float* __restrict__ out, int* __restrict__ arg,
                          int n) {
  extern __shared__ float smem[];
  const int runs = runs_of(n), levels = bit_length(runs);
  float* u = smem;                                    // (n) source y_c
  float* pv = u + n;                                  // (n) g1, then its scan
  int* pa = reinterpret_cast<int*>(pv + n);
  float* sv = reinterpret_cast<float*>(pa + n);       // (n) g4, then its scan
  int* sa = reinterpret_cast<int*>(sv + n);
  float* g23 = reinterpret_cast<float*>(sa + n);      // (2, n) g2, g3
  float* tv = g23 + 2 * n;                            // (2, levels, runs)
  int* ti = reinterpret_cast<int*>(tv + 2 * levels * runs);
  __shared__ float warp_v[kThreads / 32];
  __shared__ int warp_i[kThreads / 32];

  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const float af = coeffs[blockIdx.x * 4 + 0];
  const float df = coeffs[blockIdx.x * 4 + 1];
  const float ac = coeffs[blockIdx.x * 4 + 2];
  const float dc = coeffs[blockIdx.x * 4 + 3];

  // v of this thread's first destination: its load waits behind the setup
  float v_next = tid < n ? ycc[row + tid] : 0.0f;

  // 1) the four g rows, the loads of kBatch positions a thread issued
  //    together (one wait on device memory for each batch)
  constexpr int kBatch = 4;
  for (int i0 = tid; i0 < n; i0 += kBatch * kThreads) {
    float fb[kBatch], ub[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + q * kThreads;
      fb[q] = i < n ? F[row + i] : 0.0f;
      ub[q] = i < n ? ycp[row + i] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = i0 + q * kThreads;
      if (i >= n) break;
      const float fi = static_cast<float>(i);
      const float ui = ub[q], f = fb[q];
      const float naf_i = mul(-af, fi), df_i = mul(df, fi);
      const float dc_u = mul(dc, ui), ac_u = mul(ac, ui);
      u[i] = ui;
      pv[i] = add(f, add(naf_i, dc_u));
      pa[i] = i;
      g23[i] = add(f, sub(naf_i, ac_u));
      g23[n + i] = add(f, add(df_i, dc_u));
      sv[i] = add(f, sub(df_i, ac_u));
      sa[i] = i;
    }
  }
  __syncthreads();

  // 2) table level 0: each run's (min, first index), one thread a run;
  //    thread b starts at offset b/2 of its run, so a warp's 32 reads hit
  //    32 banks (the index tie-break makes the order free)
  for (int e = tid; e < 2 * runs; e += kThreads) {
    const int w = e < runs ? 0 : 1, b = e - w * runs;
    const float* g = g23 + w * n + b * kRun;
    const int len = min(kRun, n - b * kRun);
    float v = CUDART_INF_F;
    int i = INT_MAX;
#pragma unroll
    for (int q = 0; q < kRun; ++q) {       // past the row: (inf, INT_MAX)
      const int o = (q + (b >> 1)) & (kRun - 1);
      const bool real = o < len;
      const float x = g[real ? o : 0];
      first_min(v, i, real ? x : CUDART_INF_F, real ? b * kRun + o : INT_MAX);
    }
    tv[w * levels * runs + b] = v;
    ti[w * levels * runs + b] = i;
  }

  // 3) running (min, first index): g1 left to right, g4 right to left
  //    (their barriers also publish step 2)
  block_scan<kThreads, false>(pv, pa, n, warp_v, warp_i);
  block_scan<kThreads, true>(sv, sa, n, warp_v, warp_i);

  // 4) the sparse table over the runs: level s covers runs [b, b + 2^s)
  for (int s = 1; s < levels; ++s) {
    const int h = 1 << (s - 1);
    for (int e = tid; e < 2 * runs; e += kThreads) {
      const int w = e / runs, b = e - w * runs;
      const int src = (w * levels + s - 1) * runs;
      float v = tv[src + b];
      int i = ti[src + b];
      if (b + h < runs) first_min(v, i, tv[src + b + h], ti[src + b + h]);
      tv[src + runs + b] = v;
      ti[src + runs + b] = i;
    }
    __syncthreads();
  }

  // 5) per destination: crossing, the middle range-min, combine; two
  //    destinations a step, j and j + kThreads, their crossings together
  for (int j0 = tid; j0 < n; j0 += 2 * kThreads) {
    const float va = v_next;
    const float vb = j0 + kThreads < n ? ycc[row + j0 + kThreads] : va;
    if (j0 + 2 * kThreads < n) v_next = ycc[row + j0 + 2 * kThreads];
    int kk[2];
    crossing2(u, n, va, vb, kk[0], kk[1]);
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * kThreads;
      if (j >= n) break;
      float mv;
      int mi;
      middle_min(g23, tv, ti, n, runs, levels, j, kk[h], mv, mi);
      finish(pv, pa, sv, sa, n, j, kk[h], h ? vb : va, mv, mi, af, df, ac,
             dc, out + row + j, arg + row + j);
    }
  }
}

__global__ void __launch_bounds__(kGlobalThreads)
minplus_structured_global_kernel(const float* __restrict__ F,
                                 const float* __restrict__ ycp,
                                 const float* __restrict__ ycc,
                                 const float* __restrict__ coeffs,
                                 float* __restrict__ out,
                                 int* __restrict__ arg, float* tab_v,
                                 int* tab_i, int n, int levels) {
  constexpr int kWarps = kGlobalThreads / 32;
  extern __shared__ float smem[];
  float* u = smem;                                    // (n) source y_c
  float* pv = u + n;                                  // (n) g1, then its scan
  int* pa = reinterpret_cast<int*>(pv + n);
  float* sv = reinterpret_cast<float*>(pa + n);       // (n) g4, then its scan
  int* sa = reinterpret_cast<int*>(sv + n);
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];

  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const float af = coeffs[blockIdx.x * 4 + 0];
  const float df = coeffs[blockIdx.x * 4 + 1];
  const float ac = coeffs[blockIdx.x * 4 + 2];
  const float dc = coeffs[blockIdx.x * 4 + 3];
  // this row's doubling table: level s, table row w (0: g2, 1: g3) at
  // [(s * 2 + w) * n, ... + n)
  const size_t level_len = 2 * static_cast<size_t>(n);
  float* tv = tab_v + static_cast<size_t>(blockIdx.x) * levels * level_len;
  int* ti = tab_i + static_cast<size_t>(blockIdx.x) * levels * level_len;

  // 1) the four g rows: g1, g4 to shared memory, g2, g3 to table level 0
  for (int i = tid; i < n; i += kGlobalThreads) {
    const float fi = static_cast<float>(i);
    const float ui = ycp[row + i];
    const float f = F[row + i];
    const float naf_i = mul(-af, fi), df_i = mul(df, fi);
    const float dc_u = mul(dc, ui), ac_u = mul(ac, ui);
    u[i] = ui;
    pv[i] = add(f, add(naf_i, dc_u));
    pa[i] = i;
    tv[i] = add(f, sub(naf_i, ac_u));
    ti[i] = i;
    tv[n + i] = add(f, add(df_i, dc_u));
    ti[n + i] = i;
    sv[i] = add(f, sub(df_i, ac_u));
    sa[i] = i;
  }
  __syncthreads();

  // 2) running (min, first index): g1 left to right, g4 right to left
  block_scan<kGlobalThreads, false>(pv, pa, n, warp_v, warp_i);
  block_scan<kGlobalThreads, true>(sv, sa, n, warp_v, warp_i);

  // 3) the doubling table: level s covers [i, i + 2^s); past the end the
  //    reference pads with (inf, n), which never wins against a real pair
  for (int s = 1; s < levels; ++s) {
    const int h = 1 << (s - 1);
    const float* lv = tv + (s - 1) * level_len;
    const int* li = ti + (s - 1) * level_len;
    float* nv = tv + s * level_len;
    int* ni = ti + s * level_len;
    for (int x = tid; x < 2 * n; x += kGlobalThreads) {
      const int i = x < n ? x : x - n;
      float v = lv[x];
      int a = li[x];
      if (i + h < n) first_min(v, a, lv[x + h], li[x + h]);
      nv[x] = v;
      ni[x] = a;
    }
    __syncthreads();
  }

  // 4) per destination: crossing, the middle query, combine
  for (int j = tid; j < n; j += kGlobalThreads) {
    const float vj = ycc[row + j];
    const int k = crossing(u, n, vj);
    const int m1 = min(j, k), m2 = max(j, k), len = m2 - m1;
    const int s = min(31 - __clz(max(len, 1)), levels - 1);
    const int r2 = max(m2 - (1 << s), 0);
    // middle [m1, m2): two overlapping power-of-two blocks of the table
    float mv = CUDART_INF_F;
    int mi = 0;
    if (len > 0) {
      const size_t off = (s * 2 + (k <= j ? 0 : 1)) * static_cast<size_t>(n);
      mv = tv[off + m1];
      mi = ti[off + m1];
      first_min(mv, mi, tv[off + r2], ti[off + r2]);
    }
    finish(pv, pa, sv, sa, n, j, k, vj, mv, mi, af, df, ac, dc,
           out + row + j, arg + row + j);
  }
}

// Raise a kernel's dynamic shared memory limit once per device, outside
// any stream capture the caller may start later.
template <typename Kernel>
cudaError_t configure(Kernel kernel, int bytes, bool* configured) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (configured[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  configured[device] = true;
  return cudaSuccess;
}

}  // namespace

// The on-chip variant. F, ycp, ycc, out, arg: (batch, n) row-major;
// coeffs: (batch, 4) as (af, df, ac, dc); 1 <= n <= kMaxNShared. Dynamic
// shared memory is 7n + 4 L ceil(n/kRun) words. Launches on ``stream``;
// returns the CUDA error code of the set-up or the launch (0 on success).
// Does not synchronise.
extern "C" int minplus_structured_launch(const float* F, const float* ycp,
                                         const float* ycc,
                                         const float* coeffs, float* out,
                                         int* arg, int batch, int n,
                                         void* stream) {
  static bool configured[kMaxDevices] = {};
  if (n < 1 || n > kMaxNShared) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(
      minplus_structured_kernel,
      shared_words(kMaxNShared) * static_cast<int>(sizeof(float)), configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = shared_words(n) * static_cast<int>(sizeof(float));
  minplus_structured_kernel<<<batch, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      F, ycp, ycc, coeffs, out, arg, n);
  return static_cast<int>(cudaGetLastError());
}

// The global-table variant, for kMaxNShared < n <= kMaxN (it takes any
// 1 <= n <= kMaxN). Arguments as above, plus tab_v, tab_i: scratch of
// batch * levels * 2 * n words each, levels = bit_length(n). Dynamic
// shared memory is 5n words.
extern "C" int minplus_structured_global_launch(
    const float* F, const float* ycp, const float* ycc, const float* coeffs,
    float* out, int* arg, float* tab_v, int* tab_i, int batch, int n,
    int levels, void* stream) {
  static bool configured[kMaxDevices] = {};
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(minplus_structured_global_kernel,
                              5 * kMaxN * static_cast<int>(sizeof(float)),
                              configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 5 * n * static_cast<int>(sizeof(float));
  minplus_structured_global_kernel<<<batch, kGlobalThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      F, ycp, ycc, coeffs, out, arg, tab_v, tab_i, n, levels);
  return static_cast<int>(cudaGetLastError());
}

// The on-chip variant's largest level count (ops.MAX_N_SHARED).
extern "C" int minplus_structured_max_n_shared() { return kMaxNShared; }

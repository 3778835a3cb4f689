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
// with m1 = min(j, k), m2 = max(j, k). Each destination then reads one
// exclusive running min of g1, one of g4 (from the right) and one range
// min of g2 or g3 from a doubling (sparse) table, and combines the three
// in source order with a strict <, which keeps the first minimizer.
//
// Design. The TPU kernel keeps one row and all its scan tables in VMEM
// (megabytes) for one sequential grid step. Here one thread block owns one
// row. u, the g1 and g4 rows and their running (min, first index) pairs
// live in shared memory (5N words, 56 KB at N = 2816), and the scans are
// block-wide: each thread scans a contiguous chunk, a warp-shuffle scan
// joins the chunks. The doubling table of g2/g3 has L = bit_length(N)
// levels of (value, index) pairs, 540 KB at N = 2816, more than the
// 227 KB a block may hold, so it goes to a global scratch buffer that the
// wrapper allocates (torch.empty); each level is built from the previous
// one between two __syncthreads (the block's own writes are visible to it
// after the barrier; the buffer is read with ordinary, not read-only
// cache, loads). k(j) is a binary search on u in shared memory; the table
// level is 31 - __clz(max(m2 - m1, 1)), clipped to L - 1, the integer
// bit length the plain version computes too.
//
// Exactness. Every min/first-argmin combine is exact and associative, so
// any scan order gives the same (value, index) pairs; g and h are
// evaluated term for term in the plain version's order
// (repro_torch.core.dp.minplus_step_structured: base = (-af*i) + (dc*u),
// then g = F + base; the TPU kernel's F - af*i + dc*u is another order),
// each product and sum rounded on its own (__fmul_rn, __fadd_rn, never an
// FMA). Values and argmins are then bitwise the plain version's, and the
// dense transition's wherever float32 arithmetic is exact.
//
// Bound. Per row it must read F, u, v (3N words) and write the values and
// argmins (2N words): ~10 MB at the main path's B = 180, N = 2816, 3 us at
// 3.35 TB/s, against ~N*(5L + 36) operations per row (~0.8 us at 67
// TFLOP/s), so bytes bound it. The global doubling table (L x 2N pairs per
// row, ~100 MB written and read per launch) is what this simple design
// pays above that bound.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 11264;            // 5 kMaxN words of shared memory
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// (v1, i1) <- the (min value, first index) of the two pairs.
__device__ __forceinline__ void first_min(float& v1, int& i1, float v2, int i2) {
  if (!((v1 < v2) || (v1 == v2 && i1 <= i2))) {
    v1 = v2;
    i1 = i2;
  }
}

// In-place inclusive running (min, first index) of the pairs (val, idx)
// over logical positions 0..n-1, left to right, or right to left when
// kReverse (position p is element n-1-p). All threads of the block call it.
template <bool kReverse>
__device__ void block_scan(float* val, int* idx, int n, float* warp_v,
                           int* warp_i) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kThreads - 1) / kThreads;
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

__global__ void __launch_bounds__(kThreads)
minplus_structured_kernel(const float* __restrict__ F,
                          const float* __restrict__ ycp,
                          const float* __restrict__ ycc,
                          const float* __restrict__ coeffs,
                          float* __restrict__ out, int* __restrict__ arg,
                          float* tab_v, int* tab_i, int n, int levels) {
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
  for (int i = tid; i < n; i += kThreads) {
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
  block_scan<false>(pv, pa, n, warp_v, warp_i);
  block_scan<true>(sv, sa, n, warp_v, warp_i);

  // 3) the doubling table: level s covers [i, i + 2^s); past the end the
  //    reference pads with (inf, n), which never wins against a real pair
  for (int s = 1; s < levels; ++s) {
    const int h = 1 << (s - 1);
    const float* lv = tv + (s - 1) * level_len;
    const int* li = ti + (s - 1) * level_len;
    float* nv = tv + s * level_len;
    int* ni = ti + s * level_len;
    for (int x = tid; x < 2 * n; x += kThreads) {
      const int i = x < n ? x : x - n;
      float v = lv[x];
      int a = li[x];
      if (i + h < n) first_min(v, a, lv[x + h], li[x + h]);
      nv[x] = v;
      ni[x] = a;
    }
    __syncthreads();
  }

  // 4) per destination: crossing, three segment queries, combine
  for (int j = tid; j < n; j += kThreads) {
    const float vj = ycc[row + j];
    const float jf = static_cast<float>(j);
    int lo = 0, hi = n;                    // k = first i with u(i) <= v(j)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (u[mid] <= vj) hi = mid; else lo = mid + 1;
    }
    const int k = lo;
    const int m1 = min(j, k), m2 = max(j, k), len = m2 - m1;
    const int s = min(31 - __clz(max(len, 1)), levels - 1);
    const int r2 = max(m2 - (1 << s), 0);
    const bool use_g2 = k <= j;

    // prefix [0, m1): exclusive running min of g1
    float bv = CUDART_INF_F;
    int bi = 0;
    if (m1 > 0) {
      bv = pv[m1 - 1];
      bi = pa[m1 - 1];
    }
    bv = add(bv, sub(mul(af, jf), mul(dc, vj)));

    // middle [m1, m2): two overlapping power-of-two blocks of the table
    float mv = CUDART_INF_F;
    int mi = 0;
    if (len > 0) {
      const size_t off = (s * 2 + (use_g2 ? 0 : 1)) * static_cast<size_t>(n);
      mv = tv[off + m1];
      mi = ti[off + m1];
      first_min(mv, mi, tv[off + r2], ti[off + r2]);
    }
    const float h_mid = use_g2 ? add(mul(af, jf), mul(ac, vj))
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
    if (mv < bv) {
      bv = mv;
      bi = mi;
    }
    if (xv < bv) {
      bv = xv;
      bi = xi;
    }
    out[row + j] = bv;
    arg[row + j] = bi;
  }
}

}  // namespace

// F, ycp, ycc, out, arg: (batch, n) row-major; coeffs: (batch, 4) as
// (af, df, ac, dc); tab_v, tab_i: scratch of batch * levels * 2 * n words
// each, levels = bit_length(n); 1 <= n <= kMaxN. Dynamic shared memory is
// 5n words; the kernel's limit is raised to 5 kMaxN words once per device,
// outside any stream capture the caller may start later. Launches on
// ``stream``; returns the CUDA error code of the set-up or the launch (0
// on success). Does not synchronise.
extern "C" int minplus_structured_launch(const float* F, const float* ycp,
                                         const float* ycc,
                                         const float* coeffs, float* out,
                                         int* arg, float* tab_v, int* tab_i,
                                         int batch, int n, int levels,
                                         void* stream) {
  static bool configured[kMaxDevices] = {};
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    err = cudaFuncSetAttribute(minplus_structured_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               5 * kMaxN * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  const int smem = 5 * n * static_cast<int>(sizeof(float));
  minplus_structured_kernel<<<batch, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      F, ycp, ycc, coeffs, out, arg, tab_v, tab_i, n, levels);
  return static_cast<int>(cudaGetLastError());
}

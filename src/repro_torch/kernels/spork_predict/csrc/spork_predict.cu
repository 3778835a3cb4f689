// spork_predict: the Alg. 2 expected objective J(c) for a chunk of cells.
//
// Replaces the TPU kernel src/repro/kernels/spork_predict/spork_predict.py
// (spork_predict_pallas; pallas_call at line 84). For every cell and every
// candidate allocation c against the conditional histogram p(b):
//
//   J(c) = amort(c) + sum_b p(b) [ co_min*min(c,b) + co_over*(c-b)+
//                                  + co_under*(b-c)+ ]
//
// with +inf outside the observed bin range [lo, hi].
//
// Design. The TPU kernel builds the (c, b) tile from indices and contracts
// it on the MXU, carrying the sum over bin blocks from one sequential grid
// step to the next. Blocks on Hopper run in no order, so instead one thread
// block owns one cell and evaluates J in O(N) through prefix sums of p(b)
// and p(b)*b held in shared memory (2N floats; N <= 4096 stays inside the
// default 48 KB). Total mass and [lo, hi] are reduced in the block, so the
// wrapper passes only the three coefficients per cell.
//
// Summation order. The plain PyTorch version (repro_torch.core.predictor.
// expected_objective) takes its prefix sums as a blocked scan: a matmul
// against a triangular ones matrix inside blocks of 32, then a second
// matmul for the cross-block offsets (a plain cumulative sum for sizes that
// are not block-aligned). A matmul with K = 32 accumulates sequentially, so
// this kernel sums in exactly that order, and every other operation is one
// IEEE-rounded op (__fadd_rn and friends, never contracted into an FMA),
// in the plain version's order. J then agrees with the plain version to
// the last bit wherever the library matmul accumulates in order, and argmin
// choices do not flip on near-ties.
//
// Bound. Per cell it reads hist and amort (2N floats) and writes J (N
// floats); its arithmetic is ~20 flops per candidate plus the in-block
// sequential scans. At the main path's C = 32, N = 512 that is ~197 KB,
// 0.06 us at 3.35 TB/s: the kernel is bound by its launch, not by bytes
// or operations, which is why it is one launch per allocator tick for the
// whole chunk.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPfxBlock = 32;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// xs[s] + xs[s+1] + ... + xs[e], accumulated left to right (empty: 0).
__device__ __forceinline__ float seq_sum(const float* xs, int s, int e) {
  float acc = 0.0f;
  for (int i = s; i <= e; ++i) acc = add(acc, xs[i]);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
spork_predict_kernel(const float* __restrict__ hist,
                     const float* __restrict__ amort,
                     const float* __restrict__ coeffs,
                     float* __restrict__ out, int n, int blk) {
  extern __shared__ float smem[];
  const int nblk = n / blk;
  float* p = smem;              // (n) bin probabilities p(b)
  float* pb = p + n;            // (n) first-moment terms p(b) * b
  float* sum_p = pb + n;        // (nblk) prefix-block totals
  float* sum_m = sum_p + nblk;
  float* off_p = sum_m + nblk;  // (nblk) exclusive cross-block offsets
  float* off_m = off_p + nblk;
  __shared__ float warp_total[kWarps];
  __shared__ float s_total;
  __shared__ int s_lo, s_hi;

  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const float* h = hist + row;
  const float* a = amort + row;
  float* o = out + row;

  if (tid == 0) {
    s_lo = n;
    s_hi = -1;
  }
  __syncthreads();

  // 1. Total mass and the observed bin range [lo, hi].
  float part = 0.0f;
  int lo = n, hi = -1;
  for (int j = tid; j < n; j += kThreads) {
    const float v = h[j];
    part += v;
    if (v > 0.0f) {
      lo = min(lo, j);
      hi = max(hi, j);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if ((tid & 31) == 0) warp_total[tid >> 5] = part;
  if (hi >= 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  if (tid == 0) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += warp_total[w];
    s_total = t;
  }
  __syncthreads();
  const float denom = fmaxf(s_total, 1.0f);
  lo = s_lo;
  hi = s_hi;

  // 2. p(b) and p(b) * b.
  for (int j = tid; j < n; j += kThreads) {
    const float pj = __fdiv_rn(h[j], denom);
    p[j] = pj;
    pb[j] = mul(pj, static_cast<float>(j));
  }
  __syncthreads();

  // 3. Block totals: the last column of the within-block prefix.
  for (int q = tid; q < nblk; q += kThreads) {
    sum_p[q] = seq_sum(p, q * blk, q * blk + blk - 1);
    sum_m[q] = seq_sum(pb, q * blk, q * blk + blk - 1);
  }
  __syncthreads();

  // 4. Exclusive offsets: sum of the totals of the blocks before q.
  for (int q = tid; q < nblk; q += kThreads) {
    off_p[q] = seq_sum(sum_p, 0, q - 1);
    off_m[q] = seq_sum(sum_m, 0, q - 1);
  }
  __syncthreads();

  // 5. J(c) for every candidate c.
  const float p_tot = add(sum_p[nblk - 1], off_p[nblk - 1]);   // P(n-1)
  const float m_tot = add(sum_m[nblk - 1], off_m[nblk - 1]);   // M(n-1)
  const float co_min = coeffs[blockIdx.x * 3 + 0];
  const float co_over = coeffs[blockIdx.x * 3 + 1];
  const float co_under = coeffs[blockIdx.x * 3 + 2];
  for (int j = tid; j < n; j += kThreads) {
    const int q = j / blk;
    const int s = q * blk;
    float pm1 = 0.0f, mm1 = 0.0f;             // P(c-1), M(c-1)
    if (j > s) {
      pm1 = add(seq_sum(p, s, j - 1), off_p[q]);
      mm1 = add(seq_sum(pb, s, j - 1), off_m[q]);
    } else if (q > 0) {
      pm1 = add(sum_p[q - 1], off_p[q - 1]);
      mm1 = add(sum_m[q - 1], off_m[q - 1]);
    }
    const float c = static_cast<float>(j);
    const float tail = sub(p_tot, pm1);                       // P(n >= c)
    const float e_min = add(mm1, mul(c, tail));
    const float e_over = sub(mul(c, pm1), mm1);
    const float e_under = sub(sub(m_tot, mm1), mul(c, tail));
    const float jv = add(add(add(mul(co_min, e_min), mul(co_over, e_over)),
                             mul(co_under, e_under)),
                         a[j]);
    o[j] = (j >= lo && j <= hi) ? jv : CUDART_INF_F;
  }
}

}  // namespace

// hist, amort, out: (cells, n) float32, row-major, on the device; coeffs:
// (cells, 3) float32 [co_min, co_over, co_under]. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int spork_predict_launch(const float* hist, const float* amort,
                                    const float* coeffs, float* out,
                                    int cells, int n, void* stream) {
  if (cells <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blk = (n >= 2 * kPfxBlock && n % kPfxBlock == 0) ? kPfxBlock : n;
  const size_t smem = (2 * static_cast<size_t>(n) + 4 * static_cast<size_t>(n / blk))
                      * sizeof(float);
  spork_predict_kernel<<<cells, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      hist, amort, coeffs, out, n, blk);
  return static_cast<int>(cudaGetLastError());
}

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
// step to the next. Here J is evaluated in O(N) through the prefix sums
// P(c) of p(b) and M(c) of p(b)*b. A block of kWarps warps owns one cell.
// Each thread owns H float4s of the row (H = ceil(N / 4 / threads), a
// template argument), so every load of a cell is issued at once and no
// loop waits out a latency:
//   A. hist and amort, 16 bytes a thread, into registers; the three
//      coefficients beside them. The total mass is a shuffle reduction
//      (exact for the integer counts the paths feed), [lo, hi] two
//      __reduce_{min,max}_sync.
//   B. p(b) and p(b)*b into shared memory laid out 33 floats per 32-bin
//      block, so that a thread per block reads without bank conflicts.
//      An empty bin keeps its zero and divides 1 instead: the division's
//      range check (FCHK) sends a zero numerator to the slow path, which
//      half the bins of a path took (3 us of 6.6 at C = 32, N = 512).
//   C. One thread owns one (array, 32-bin block) chain and runs its 31
//      dependent adds once, in registers, writing the 32 inclusive
//      prefixes back in place.
//   D. One lane per array chains the block totals into exclusive offsets.
//   E. J for every candidate, 16 bytes a thread, stored coalesced.
// The coefficients come as a value (the serial paths' Python floats) or
// as a device pointer with a per-cell stride (0 for a one-value tensor),
// so a call is one launch and copies nothing. Where N % 4 != 0 or a
// pointer is not 16-byte aligned, the loads and stores go bin by bin
// instead (the scalar path), in the same order. The card measured one
// warp a cell 35-60 % slower than four at N = 512 and 6x slower at 4096:
// one warp's serial work (the divisions and candidates of 16 bins a lane)
// outweighs the three block barriers; one cell a block beat two or four
// (tools/kernel_variants.py predict; PERF.md).
//
// Summation order. The plain PyTorch version (repro_torch.core.predictor.
// expected_objective) on the CPU is the oracle of the allocator's choices.
// For block-aligned sizes (N >= 64, N % 32 == 0) it takes its prefix sums
// as a blocked scan: a matmul against a triangular ones matrix inside
// blocks of 32, then a second matmul for the cross-block offsets; both
// accumulate sequentially, which is the order of the chains in C and D.
// Other sizes use torch.cumsum, which on the CPU accumulates float32 in
// double and rounds each prefix: phase C then runs one double chain per
// array instead. Every other operation is one IEEE-rounded op (__fadd_rn
// and friends, never contracted into an FMA), in the plain version's
// order. J is then bitwise the CPU plain version's, and argmin choices do
// not flip on near-ties.
//
// Bound. Per cell it reads hist and amort (2N floats) and writes J (N
// floats); ~20 flops per candidate. At the main path's C = 32, N = 512
// that is ~197 KB, 0.06 us at 3.35 TB/s: far below one launch, so the
// kernel is bound by its launch and the latency of one cell's phases,
// which is why it is one launch per allocator tick for the whole chunk.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;           // warps a cell: a block is one cell
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHold = 8;         // float4s a thread holds: 4096 / 4 / 128
constexpr int kOffBatch = 4;        // block totals loaded ahead of the adds
constexpr int kMaxChains = 256;     // 2 arrays x (4096 / 32) blocks
constexpr int kStride = 33;         // a 32-bin block's floats in shared
constexpr unsigned kFull = 0xffffffffu;

struct Coeffs {
  const float* ptr[3];   // co_min, co_over, co_under: device pointer or null
  long long stride[3];   // per-cell stride in elements (0: one value)
  float value[3];        // used where the pointer is null
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// shared slot of bin j: 32-bin blocks padded to 33 floats
__device__ __forceinline__ int pad(int j) { return (j >> 5) * kStride + (j & 31); }

__device__ __forceinline__ float coeff(const Coeffs& co, int i, int cell) {
  return co.ptr[i] ? __ldg(co.ptr[i] + cell * co.stride[i]) : co.value[i];
}

// total mass and [lo, hi]
__device__ __forceinline__ void observe(float v, int j, float& part, int& lo,
                                        int& hi) {
  part += v;
  if (v > 0.0f) {
    lo = min(lo, j);
    hi = max(hi, j);
  }
}

__device__ __forceinline__ void observe4(float4 v, int j, float& part,
                                         int& lo, int& hi) {
  observe(v.x, j, part, lo, hi);
  observe(v.y, j + 1, part, lo, hi);
  observe(v.z, j + 2, part, lo, hi);
  observe(v.w, j + 3, part, lo, hi);
}

// h / d rounded once; a zero stays as it is and divides 1 instead, off
// the slow path (see the header)
__device__ __forceinline__ float divide(float h, float d) {
  const float q = __fdiv_rn(h == 0.0f ? 1.0f : h, d);
  return h == 0.0f ? h : q;
}

// p(b) and p(b) * b of the four bins from j (one 32-bin block) into the
// shared P and M rows
__device__ __forceinline__ void store_p4(float* P, float* M, int j, float4 h,
                                         float d) {
  float p[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = divide(p[k], d);
  const int s = pad(j);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    P[s + k] = p[k];
    M[s + k] = mul(p[k], static_cast<float>(j + k));
  }
}

// block `cell` computes J of that cell, each thread H float4s of its row
template <int H>
__global__ void __launch_bounds__(kThreads)
spork_predict_kernel(const float* __restrict__ hist,
                     const float* __restrict__ amort,
                     float* __restrict__ out, Coeffs co, int n, int vec) {
  constexpr int T = kThreads;
  constexpr int R = kMaxChains / T;       // chains a thread, at most
  extern __shared__ float smem[];
  __shared__ float red_part[kWarps];
  __shared__ int red_lo[kWarps], red_hi[kWarps];

  const int t = threadIdx.x;
  const int cell = blockIdx.x;
  const int nb = (n + 31) >> 5;           // 32-bin blocks
  const bool aligned = n >= 64 && (n & 31) == 0;
  const int slots = nb * kStride;
  float* P = smem;
  float* M = P + slots;                   // chain c lives at P + c * kStride
  float* off = M + slots;                 // [P offsets (nb), M offsets (nb)]
  const size_t row = static_cast<size_t>(cell) * n;
  const float4* h4 = reinterpret_cast<const float4*>(hist + row);
  const float4* a4 = reinterpret_cast<const float4*>(amort + row);
  const int n4 = vec ? n >> 2 : 0;        // float4s a row (0: scalar path)

  // A. every load of the cell issued at once
  const float co_min = coeff(co, 0, cell);
  const float co_over = coeff(co, 1, cell);
  const float co_under = coeff(co, 2, cell);
  float4 hv[H], am[H];
#pragma unroll
  for (int u = 0; u < H; ++u) {
    if (t + u * T < n4) {
      hv[u] = __ldg(h4 + t + u * T);
      am[u] = __ldg(a4 + t + u * T);
    }
  }
  float part = 0.0f;
  int lo = n, hi = -1;
#pragma unroll
  for (int u = 0; u < H; ++u)
    if (t + u * T < n4) observe4(hv[u], 4 * (t + u * T), part, lo, hi);
  if (!vec) {                             // N % 4 != 0: staged bin by bin
    for (int j = t; j < n; j += T) {
      const float v = __ldg(hist + row + j);
      P[pad(j)] = v;
      observe(v, j, part, lo, hi);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) part += __shfl_xor_sync(kFull, part, s);
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if ((t & 31) == 0) {
    red_part[t >> 5] = part;
    red_lo[t >> 5] = lo;
    red_hi[t >> 5] = hi;
  }
  __syncthreads();
  part = red_part[0];
  lo = red_lo[0];
  hi = red_hi[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    part += red_part[i];
    lo = min(lo, red_lo[i]);
    hi = max(hi, red_hi[i]);
  }
  const float denom = fmaxf(part, 1.0f);

  // B. p(b) and p(b) * b (the scalar path reads back only what this
  // thread staged)
#pragma unroll
  for (int u = 0; u < H; ++u)
    if (t + u * T < n4)
      store_p4(P, M, 4 * (t + u * T), hv[u], denom);
  if (!vec) {
    for (int j = t; j < n; j += T) {
      const int s = pad(j);
      const float pj = divide(P[s], denom);
      P[s] = pj;
      M[s] = mul(pj, static_cast<float>(j));
    }
  }
  __syncthreads();

  // C. prefixes
  if (aligned) {
    const int chains = 2 * nb;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = t + r * T;
      if (c < chains) {
        float* x = P + c * kStride;
        float v[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) v[i] = x[i];
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          acc = add(acc, v[i]);
          x[i] = acc;
        }
      }
    }
    __syncthreads();
    // D. exclusive offsets: one sequential chain per array, its block
    // totals loaded kOffBatch at a time ahead of the adds
    if (t < 2) {
      const float* tot = (t ? M : P) + 31;
      float* dst = off + t * nb;
      float run = 0.0f;
      for (int b0 = 0; b0 < nb; b0 += kOffBatch) {
        float v[kOffBatch];
#pragma unroll
        for (int i = 0; i < kOffBatch; ++i)
          if (b0 + i < nb) v[i] = tot[(b0 + i) * kStride];
#pragma unroll
        for (int i = 0; i < kOffBatch; ++i) {
          if (b0 + i < nb) {
            dst[b0 + i] = run;
            run = add(run, v[i]);
          }
        }
      }
    }
  } else if (t < 2) {                     // torch.cumsum's order on the CPU
    float* x = t ? M : P;
    double acc = 0.0;
    for (int j = 0; j < n; ++j) {
      const int s = pad(j);
      acc += static_cast<double>(x[s]);
      x[s] = static_cast<float>(acc);
    }
  }
  __syncthreads();

  // E. J(c) for every candidate c
  const int last = pad(n - 1);
  float p_tot = P[last], m_tot = M[last];                 // P(n-1), M(n-1)
  if (aligned) {
    p_tot = add(p_tot, off[nb - 1]);
    m_tot = add(m_tot, off[2 * nb - 1]);
  }
  auto objective = [&](int c, float am_c) -> float {
    float pm1 = 0.0f, mm1 = 0.0f;                           // P(c-1), M(c-1)
    if (c > 0) {
      const int s = pad(c - 1);
      pm1 = P[s];
      mm1 = M[s];
      if (aligned) {
        const int b = (c - 1) >> 5;
        pm1 = add(pm1, off[b]);
        mm1 = add(mm1, off[nb + b]);
      }
    }
    const float cf = static_cast<float>(c);
    const float tail = sub(p_tot, pm1);                     // P(n >= c)
    const float e_min = add(mm1, mul(cf, tail));
    const float e_over = sub(mul(cf, pm1), mm1);
    const float e_under = sub(sub(m_tot, mm1), mul(cf, tail));
    const float jv = add(add(add(mul(co_min, e_min), mul(co_over, e_over)),
                             mul(co_under, e_under)),
                         am_c);
    return (c >= lo && c <= hi) ? jv : CUDART_INF_F;
  };
  float4* o4 = reinterpret_cast<float4*>(out + row);
#pragma unroll
  for (int u = 0; u < H; ++u) {
    const int q = t + u * T, c = 4 * q;
    if (q < n4)
      o4[q] = make_float4(objective(c, am[u].x), objective(c + 1, am[u].y),
                          objective(c + 2, am[u].z),
                          objective(c + 3, am[u].w));
  }
  if (!vec) {
    for (int c = t; c < n; c += T)
      out[row + c] = objective(c, __ldg(amort + row + c));
  }
}

// one block a cell; shared memory: P and M padded, then the offsets
template <int H>
int launch(const float* hist, const float* amort, float* out,
           const Coeffs& co, int cells, int n, int vec, cudaStream_t stream) {
  const int nb = (n + 31) >> 5;
  const size_t bytes = (2 * nb * kStride + 2 * nb) * sizeof(float);
  spork_predict_kernel<H><<<cells, kThreads, bytes, stream>>>(
      hist, amort, out, co, n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hist, amort, out: (cells, n) float32, row-major, on the device. Each
// coefficient (co_min, co_over, co_under) is either a device pointer with
// a per-cell stride in elements (0: one value for every cell), or, where
// the pointer is null, the value given. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int spork_predict_launch(const float* hist, const float* amort,
                                    float* out, const float* co_min,
                                    const float* co_over,
                                    const float* co_under, long long s_min,
                                    long long s_over, long long s_under,
                                    float v_min, float v_over, float v_under,
                                    int cells, int n, void* stream) {
  if (cells <= 0 || n <= 0 || n > 32 * kMaxChains / 2 ||
      n > 4 * kThreads * kMaxHold)
    return static_cast<int>(cudaErrorInvalidValue);
  const Coeffs co{{co_min, co_over, co_under}, {s_min, s_over, s_under},
                  {v_min, v_over, v_under}};
  const auto st = static_cast<cudaStream_t>(stream);
  // the float4 path needs N % 4 == 0 and 16-byte aligned rows; H covers
  // the row: ceil(N / 4 / threads) float4s a thread
  const int vec = (n % 4 == 0) &&
      ((reinterpret_cast<uintptr_t>(hist) | reinterpret_cast<uintptr_t>(amort) |
        reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  const int held = vec ? (n / 4 + kThreads - 1) / kThreads : 1;
  if (held <= 1) return launch<1>(hist, amort, out, co, cells, n, vec, st);
  if (held <= 2) return launch<2>(hist, amort, out, co, cells, n, vec, st);
  if (held <= 4) return launch<4>(hist, amort, out, co, cells, n, vec, st);
  return launch<kMaxHold>(hist, amort, out, co, cells, n, vec, st);
}

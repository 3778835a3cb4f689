// minplus: the dense min-plus DP transition for a batch of rows.
//
// Replaces the TPU kernel src/repro/kernels/minplus/minplus.py
// (minplus_pallas; pallas_call at line 91). For every row b and every
// destination level j:
//
//   out(j) = min_i F(i) + T(i, j),   arg(j) = the first such i,
//   T(i, j) = af*(j-i)+ + df*(i-j)+ + ac*(v(j)-u(i))+ + dc*(u(i)-v(j))+
//
// with u = y_c of the source interval, v = y_c of the destination and
// (af, df, ac, dc) the row's churn coefficients. The (N, N) matrix T is
// generated from indices and never stored.
//
// Design. The TPU kernel walks a (j, i) grid of 128-blocks and carries the
// running minimum over i blocks from one sequential grid step to the next,
// padding the ragged source block with a large sentinel. Blocks on Hopper
// run in no order, so here one thread owns one destination j and walks
// every source i itself, in increasing order, with a strict < so the first
// minimizer wins; the loop stops at N, so nothing is padded. A block holds
// 128 destinations of one row (grid: destination blocks x rows) and stages
// F and u through shared memory 128 sources at a time; every thread then
// reads the same source entry (a broadcast).
//
// Rounding. T is evaluated in the plain version's order
// (repro_torch.core.dp.minplus_step, the port of minplus_step_jnp),
//   ((af*relu(j-i) + df*relu(i-j)) + ac*relu(v_j-u_i)) + dc*relu(u_i-v_j),
// then F_i + T, with every product and sum rounded on its own (__fmul_rn,
// __fadd_rn): nvcc would otherwise contract a*b+c into an FMA, whose
// single rounding differs from the plain version's and can flip an argmin
// at a near-tie. Values and argmins are then bitwise the plain version's.
//
// Bound. At the main path's B = 180 rows and N = 2816 levels a launch
// visits 1.43e9 (i, j) pairs at about 17 fp32 operations each, 24 GFLOP:
// 0.36 ms at the card's 67 TFLOP/s outside the tensor cores. Its bytes
// (3 inputs and 2 outputs of B x N words, ~10 MB) would take 3 us, so the
// kernel is bound by operations; the design spends none on memory traffic
// inside the loop (shared-memory broadcasts only).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;   // destinations per block = sources per tile

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

__global__ void __launch_bounds__(kThreads)
minplus_dense_kernel(const float* __restrict__ F,
                     const float* __restrict__ ycp,
                     const float* __restrict__ ycc,
                     const float* __restrict__ coeffs,
                     float* __restrict__ out, int* __restrict__ arg, int n) {
  __shared__ float tile_f[kThreads];
  __shared__ float tile_u[kThreads];
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.y) * n;
  const int j = blockIdx.x * kThreads + tid;
  const float af = coeffs[blockIdx.y * 4 + 0];
  const float df = coeffs[blockIdx.y * 4 + 1];
  const float ac = coeffs[blockIdx.y * 4 + 2];
  const float dc = coeffs[blockIdx.y * 4 + 3];
  const float jf = static_cast<float>(j);
  const float vj = j < n ? ycc[row + j] : 0.0f;

  float best = CUDART_INF_F;
  int best_i = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int count = min(kThreads, n - base);
    __syncthreads();                    // the previous tile is consumed
    if (tid < count) {
      tile_f[tid] = F[row + base + tid];
      tile_u[tid] = ycp[row + base + tid];
    }
    __syncthreads();
    if (j < n) {
      for (int t = 0; t < count; ++t) {
        const float fi = static_cast<float>(base + t);
        const float ui = tile_u[t];
        float tr = mul(af, relu(sub(jf, fi)));
        tr = add(tr, mul(df, relu(sub(fi, jf))));
        tr = add(tr, mul(ac, relu(sub(vj, ui))));
        tr = add(tr, mul(dc, relu(sub(ui, vj))));
        const float m = add(tile_f[t], tr);
        if (m < best) {                 // strict: the first minimizer wins
          best = m;
          best_i = base + t;
        }
      }
    }
  }
  if (j < n) {
    out[row + j] = best;
    arg[row + j] = best_i;
  }
}

}  // namespace

// F, ycp, ycc, out, arg: (batch, n) row-major; coeffs: (batch, 4) as
// (af, df, ac, dc). Launches on ``stream``; returns the launch's CUDA
// error code (0 on success). Does not synchronise.
extern "C" int minplus_launch(const float* F, const float* ycp,
                              const float* ycc, const float* coeffs,
                              float* out, int* arg, int batch, int n,
                              void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  minplus_dense_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      F, ycp, ycc, coeffs, out, arg, n);
  return static_cast<int>(cudaGetLastError());
}

// relax: the fluid relaxation of the fpga_dynamic / predictive control
// loop that the gradient tuner descends, forward and reverse.
//
// Port-only: the reference has no TPU kernel here. It compiles
// `relaxed_cost` (src/repro/policies/tune.py:84) into one XLA program, a
// lax.scan over the K intervals, and takes its gradient with jax.grad.
// PyTorch runs eagerly, and a torch loop over the intervals costs ~30
// launches an interval forward and ~50 backward, so the port runs each
// pass as one kernel behind a torch.autograd.Function
// (repro_torch.kernels.relax.ops); the plain torch loop (ref.py) is their
// plain version.
//
// Forward, per interval k with theta = (h, g, u), carried n, lam_prev:
//   lam      = demand[k] / (S * I)
//   lam_hat  = lam + g * (lam - lam_prev)
//   target   = lam_hat / u + h
//   delta    = target - n
//   w        = sigmoid(sharp * delta)
//   n_new    = n + (1 - (1 - alpha) * w) * delta,  alpha = I / (I + spin_up)
//   cost_k   = I_f I sp(n_new - lam) + B_f spin_up sp(delta)
//              + miss_weight sp(lam - n_new) S I,  sp(x) = softplus(sharp x)/sharp
// from n = lam_0 + h, lam_prev = lam_0; the cost is the sum over k. The
// pass saves n (before the step), delta and w of every interval.
//
// Reverse: the adjoint of n walks back over the intervals,
//   a       = nbar + dcost_k/dn_new
//   dbar    = a * dn_new/ddelta + dcost_k/ddelta
//   nbar    = a - dbar
// and dbar feeds dtheta: dh += dbar, dg += dbar (lam - lam_prev) / u,
// du -= dbar lam_hat / u^2; at the start dh += nbar (n = lam_0 + h). The
// step is affine in nbar, nbar <- p_k nbar + q_k with p_k = 1 - dn/ddelta
// and q_k = p_k dc/dn_new - dc/ddelta, and no coefficient depends on
// nbar: the reverse is a scan of affine maps, not a chain of length K.
//
// Arithmetic in the float type T of the inputs (float32 or float64); the
// cost's sum, the affine maps' composition and the three gradient sums
// are kept in double, and each result is rounded to T once. softplus is
// the exact form max(x, 0) + log1p(exp(-|x|)) (no linear cut-off).
//
// Bound and design. Forward: only the chain through n is sequential,
// delta = target - n, w = sigmoid(sharp delta), n += (1 - (1-alpha) w)
// delta; lam, the target and the three softplus terms hang off it. One
// block of kFwdThreads; per tile of kFwdTile intervals in shared memory,
// (a) all threads compute the targets, (b) one thread walks the chain
// alone, with the next target prefetched into a register, (c) all threads
// compute the costs from the staged n, delta and n_new, write the saved
// buffers coalesced and add the costs. Its bound is K times the latency of
// the shortest float32 chain that meets the contract, a fixed sequence of
// its own (`relax_chain_bench_kernel`, timed by chip_smoke.py with
// clock64): a measured floor for that instruction sequence, not an
// operation count. The kernel's float32 chain (kFastChain, `chain_step`)
// is that sequence today: five dependent operations, two of them the MUFU
// ex2 and rcp approximations; off the chain, and in float64, exp, log1p
// and IEEE division. Reverse: one block of
// kRevThreads, one interval a thread per tile (thread t takes k = end - 1
// - t, so lane order is the pass's order): (a) every thread computes its
// p_k, q_k and the partial derivatives, (b) an exclusive scan of the
// maps, in double, by __shfl_up_sync within each warp, then over the
// warps' totals, then a carry between tiles, gives the nbar that reaches
// each interval, (c) every thread forms dbar and adds its three terms;
// one block reduction at the end. Its bound is the larger of its bytes
// and the scan's depth of ~log2 K combines; a launch's own latency sets
// its time. The block sizes and the chain's form were chosen by
// tools/kernel_variants.py relax.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kFwdThreads = 256;    // forward block
constexpr int kFwdTile = 1024;      // intervals staged in shared memory
constexpr int kRevThreads = 512;    // reverse block = intervals a tile
constexpr bool kFastChain = true;   // float32 chain: MUFU ex2 and rcp
constexpr double kLog2e = 1.4426950408889634;

struct Consts {
  double interval, spin_up, S, I_f, B_f, miss_weight, sharp;
};

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ T sigmoid_t(T x) {
  return T(1) / (T(1) + exp_t(-x));
}

// softplus(x * sharp) / sharp in the exact form
__device__ __forceinline__ float softplus_t(float x, float sharp) {
  const float y = x * sharp;
  return (fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)))) / sharp;
}
__device__ __forceinline__ double softplus_t(double x, double sharp) {
  const double y = x * sharp;
  return (fmax(y, 0.0) + log1p(exp(-fabs(y)))) / sharp;
}

// The chain's constants: sharp, 1 - alpha and -sharp log2(e).
template <typename T>
struct Chain {
  T sharp, one_minus_alpha, ex2_scale;
  __device__ explicit Chain(const Consts& c) {
    const T interval = T(c.interval);
    sharp = T(c.sharp);
    one_minus_alpha = T(1) - interval / (interval + T(c.spin_up));
    ex2_scale = -sharp * T(kLog2e);
  }
};

// n_new from n, delta and w (two fused multiply-adds); the reverse
// recomputes n_new with this expression, which rounds within an ulp of
// the float32 chain's own.
template <typename T>
__device__ __forceinline__ T step_n(T n, T delta, T w, T one_minus_alpha) {
  return n + (T(1) - one_minus_alpha * w) * delta;
}

// One interval of the forward's chain: delta = target - n, w =
// sigmoid(sharp delta), and n_new returned. float with kFast, five
// dependent operations from n to n_new: the exponent target * scale - n *
// scale (scale = -sharp log2 e) by one fused multiply-add, 2^x by
// ex2.approx, 1 + e, the reciprocal by __fdividef, and n_new = target -
// ((1 - alpha) delta) w, mathematically n + (1 - (1 - alpha) w) delta;
// delta, target * scale and (1 - alpha) delta are off the path.
// Otherwise exp, an IEEE division and `step_n`.
template <bool kFast>
__device__ __forceinline__ float chain_step(float n, float tgt,
                                            const Chain<float>& ch,
                                            float& delta, float& w) {
  delta = tgt - n;
  if (kFast) {
    float e;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e)
        : "f"(fmaf(n, -ch.ex2_scale, tgt * ch.ex2_scale)));
    w = __fdividef(1.f, 1.f + e);
    return fmaf(-ch.one_minus_alpha * delta, w, tgt);
  }
  w = sigmoid_t(ch.sharp * delta);
  return step_n(n, delta, w, ch.one_minus_alpha);
}
template <bool kFast>
__device__ __forceinline__ double chain_step(double n, double tgt,
                                             const Chain<double>& ch,
                                             double& delta, double& w) {
  delta = tgt - n;
  w = sigmoid_t(ch.sharp * delta);
  return step_n(n, delta, w, ch.one_minus_alpha);
}

// The problem's other constants in T, rounded where the reference rounds.
template <typename T>
struct Params {
  T interval, sharp, SI, A, B, MW, S, h, g, u;
  __device__ Params(const Consts& c, const T* theta) {
    interval = T(c.interval);
    sharp = T(c.sharp);
    S = T(c.S);
    SI = S * interval;
    A = T(c.I_f) * interval;
    B = T(c.B_f * c.spin_up);
    MW = T(c.miss_weight);
    h = theta[0];
    g = theta[1];
    u = theta[2];
  }
  // lam_hat of interval k (lam_prev = lam for k = 0)
  __device__ T lam_hat(T lam, T lam_prev) const {
    return lam + g * (lam - lam_prev);
  }
};

__device__ __forceinline__ double warp_sum(double x) {
  for (int d = kWarp / 2; d > 0; d >>= 1) x += __shfl_xor_sync(~0u, x, d);
  return x;
}

// One affine map x -> P x + Q; (P, Q) <- (P, Q) o (Pu, Qu), the map of
// the lane `d` below applied first.
__device__ __forceinline__ void scan_maps_up(double& P, double& Q, int lane,
                                             int width) {
  for (int d = 1; d < width; d <<= 1) {
    const double Pu = __shfl_up_sync(~0u, P, d);
    const double Qu = __shfl_up_sync(~0u, Q, d);
    if (lane >= d) {
      Q = P * Qu + Q;
      P = P * Pu;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
relax_forward_kernel(const T* __restrict__ demand, const T* __restrict__ theta,
                     T* __restrict__ cost, T* __restrict__ n_out,
                     T* __restrict__ delta_out, T* __restrict__ w_out, int K,
                     Consts c) {
  __shared__ T lam_s[kFwdTile];
  __shared__ T tgt_s[kFwdTile];
  __shared__ T n_s[kFwdTile];
  __shared__ T d_s[kFwdTile];
  __shared__ T w_s[kFwdTile];
  __shared__ T n_end;                        // n after the tile
  __shared__ double part[kFwdThreads / kWarp];
  const int tid = threadIdx.x;
  const Params<T> p(c, theta);
  const Chain<T> ch(c);
  T n = demand[0] / p.SI + p.h;              // the chain's carry (thread 0)
  double total = 0.0;
  for (int t0 = 0; t0 < K; t0 += kFwdTile) {
    const int len = min(kFwdTile, K - t0);
    // (a) lam and the target of every interval of the tile
    for (int i = tid; i < len; i += kFwdThreads) {
      const int k = t0 + i;
      const T lam = demand[k] / p.SI;
      const T lam_prev = demand[max(k - 1, 0)] / p.SI;
      lam_s[i] = lam;
      tgt_s[i] = p.lam_hat(lam, lam_prev) / p.u + p.h;
    }
    __syncthreads();
    // (b) the chain through n, on one thread
    if (tid == 0) {
      T tgt_next = tgt_s[0];
#pragma unroll 8
      for (int i = 0; i < len; ++i) {
        const T tgt = tgt_next;
        tgt_next = tgt_s[min(i + 1, len - 1)];
        T delta, w;
        n_s[i] = n;
        n = chain_step<kFastChain>(n, tgt, ch, delta, w);
        d_s[i] = delta;
        w_s[i] = w;
      }
      n_end = n;
    }
    __syncthreads();
    // (c) the costs and the saved buffers; n_new is the chain's own value
    for (int i = tid; i < len; i += kFwdThreads) {
      const T lam = lam_s[i], delta = d_s[i];
      const T n_new = i + 1 < len ? n_s[i + 1] : n_end;
      const T idle = p.A * softplus_t(n_new - lam, p.sharp);
      const T spin = p.B * softplus_t(delta, p.sharp);
      const T shortfall = softplus_t(lam - n_new, p.sharp);
      const T ck = idle + spin + p.MW * shortfall * p.S * p.interval;
      total += static_cast<double>(ck);
      n_out[t0 + i] = n_s[i];
      delta_out[t0 + i] = delta;
      w_out[t0 + i] = w_s[i];
    }
    __syncthreads();                         // the next tile reuses the stage
  }
  total = warp_sum(total);
  if (tid % kWarp == 0) part[tid / kWarp] = total;
  __syncthreads();
  if (tid < kWarp) {
    total = warp_sum(tid < kFwdThreads / kWarp ? part[tid] : 0.0);
    if (tid == 0) cost[0] = T(total);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRevThreads)
relax_backward_kernel(const T* __restrict__ demand,
                      const T* __restrict__ theta,
                      const T* __restrict__ n_in,
                      const T* __restrict__ delta_in,
                      const T* __restrict__ w_in,
                      const T* __restrict__ grad_out,
                      T* __restrict__ grad_theta, int K, Consts c) {
  constexpr int kWarps = kRevThreads / kWarp;
  __shared__ double warp_P[kWarps], warp_Q[kWarps];  // maps before each warp
  __shared__ double next_carry;
  __shared__ double part[3][kWarps];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const Params<T> p(c, theta);
  const Chain<T> ch(c);
  const T cm = p.MW * p.S * p.interval;      // dcost/dshortfall
  const double u = static_cast<double>(p.u);
  double carry = 0.0;                        // nbar reaching the tile
  double gh = 0.0, gg = 0.0, gu = 0.0;
  for (int end = K; end > 0; end -= kRevThreads) {
    const int k = end - 1 - tid;
    // (a) this interval's map x -> P x + Q (the identity past interval 0)
    double P = 1.0, Q = 0.0, dc_dn = 0.0, dc_dd = 0.0, dn_dd = 0.0;
    double dlam = 0.0, lam_hat = 0.0;
    if (k >= 0) {
      const T lam = demand[k] / p.SI;
      const T lam_prev = demand[max(k - 1, 0)] / p.SI;
      const T n = n_in[k], delta = delta_in[k], w = w_in[k];
      const T m = T(1) - ch.one_minus_alpha * w;
      const T n_new = step_n(n, delta, w, ch.one_minus_alpha);
      const T dc_dn_t = p.A * sigmoid_t(p.sharp * (n_new - lam))
                        - cm * sigmoid_t(p.sharp * (lam - n_new));
      const T dc_dd_t = p.B * sigmoid_t(p.sharp * delta);
      const T dn_dd_t =
          m - delta * ch.one_minus_alpha * p.sharp * w * (T(1) - w);
      dc_dn = dc_dn_t;
      dc_dd = dc_dd_t;
      dn_dd = dn_dd_t;
      dlam = static_cast<double>(lam - lam_prev);
      lam_hat = static_cast<double>(p.lam_hat(lam, lam_prev));
      P = 1.0 - dn_dd;
      Q = P * dc_dn - dc_dd;
    }
    // (b) inclusive scan within the warp: lane l holds F_l o ... o F_0
    scan_maps_up(P, Q, lane, kWarp);
    if (lane == kWarp - 1) {
      warp_P[warp] = P;
      warp_Q[warp] = Q;
    }
    __syncthreads();
    if (warp == 0) {                         // the same over warps' totals
      double Pw = lane < kWarps ? warp_P[lane] : 1.0;
      double Qw = lane < kWarps ? warp_Q[lane] : 0.0;
      scan_maps_up(Pw, Qw, lane, kWarps);
      const double Pe = __shfl_up_sync(~0u, Pw, 1);
      const double Qe = __shfl_up_sync(~0u, Qw, 1);
      if (lane < kWarps) {                   // exclusive: the warps before
        warp_P[lane] = lane ? Pe : 1.0;
        warp_Q[lane] = lane ? Qe : 0.0;
      }
      if (lane == kWarps - 1) next_carry = Pw * carry + Qw;
    }
    __syncthreads();
    // exclusive within the warp: the lanes before this one
    double Pe = __shfl_up_sync(~0u, P, 1), Qe = __shfl_up_sync(~0u, Q, 1);
    if (lane == 0) {
      Pe = 1.0;
      Qe = 0.0;
    }
    const double at_warp = warp_P[warp] * carry + warp_Q[warp];
    const double nbar = Pe * at_warp + Qe;   // the adjoint reaching k
    // (c) this interval's terms of the three sums
    if (k >= 0) {
      const double dbar = (nbar + dc_dn) * dn_dd + dc_dd;
      gh += dbar;
      gg += dbar * dlam / u;
      gu -= dbar * lam_hat / (u * u);
    }
    carry = next_carry;
    __syncthreads();                         // the next tile rewrites them
  }
  gh = warp_sum(gh);
  gg = warp_sum(gg);
  gu = warp_sum(gu);
  if (lane == 0) {
    part[0][warp] = gh;
    part[1][warp] = gg;
    part[2][warp] = gu;
  }
  __syncthreads();
  if (warp == 0) {
    for (int j = 0; j < 3; ++j) {
      const double s = warp_sum(lane < kWarps ? part[j][lane] : 0.0);
      if (lane == 0) {
        const T go = grad_out[0];
        // nbar after interval 0 reaches n = lam_0 + h
        grad_theta[j] = T(j == 0 ? s + carry : s) * go;
      }
    }
  }
}

// The forward's bound: one thread walks, K times from registers, the
// shortest float32 sequence from n to n_new that holds the relaxation
// within rtol 1e-5, five dependent operations: the exponent -sharp
// log2(e) (target - n) by one fused multiply-add from n, ex2.approx, 1 +
// e, rcp.approx, and n_new = target - ((1 - alpha) delta) w by one fused
// multiply-add. It is written out here, apart from `chain_step`, so that
// the bound stays where it is whatever form the kernel's chain takes.
// (tanh.approx would take one operation less, but the PTX ISA gives it a
// relative error of about 2^-11, some fifty times the contract.) The
// target alternates between two values; cycles[0] = the clock64() cycles
// of the walk.
__global__ void relax_chain_bench_kernel(float target0, float target1,
                                         Consts c, int K, long long* cycles,
                                         float* sink) {
  const Chain<float> ch(c);
  float n = target0;
  const long long t0 = clock64();
  for (int i = 0; i < K; ++i) {
    const float tgt = (i & 1) ? target1 : target0;
    float e, w;
    asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(e)
                 : "f"(fmaf(n, -ch.ex2_scale, tgt * ch.ex2_scale)));
    asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=f"(w) : "f"(1.f + e));
    n = fmaf(-ch.one_minus_alpha * (tgt - n), w, tgt);
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = n;
}

template <typename T>
cudaError_t forward_t(const void* demand, const void* theta, void* cost,
                      void* n_out, void* delta_out, void* w_out, int K,
                      const Consts& c, cudaStream_t stream) {
  relax_forward_kernel<T><<<1, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(demand), static_cast<const T*>(theta),
      static_cast<T*>(cost), static_cast<T*>(n_out),
      static_cast<T*>(delta_out), static_cast<T*>(w_out), K, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward_t(const void* demand, const void* theta,
                       const void* n_in, const void* delta_in,
                       const void* w_in, const void* grad_out,
                       void* grad_theta, int K, const Consts& c,
                       cudaStream_t stream) {
  relax_backward_kernel<T><<<1, kRevThreads, 0, stream>>>(
      static_cast<const T*>(demand), static_cast<const T*>(theta),
      static_cast<const T*>(n_in), static_cast<const T*>(delta_in),
      static_cast<const T*>(w_in), static_cast<const T*>(grad_out),
      static_cast<T*>(grad_theta), K, c);
  return cudaGetLastError();
}

}  // namespace

// demand (K,), theta (3,), cost (1,), n_out, delta_out, w_out (K,): one
// type on the device (dtype 0: float32, 1: float64), K >= 1. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int relax_forward_launch(const void* demand, const void* theta,
                                    void* cost, void* n_out, void* delta_out,
                                    void* w_out, int K, int dtype,
                                    double interval, double spin_up, double S,
                                    double I_f, double B_f,
                                    double miss_weight, double sharp,
                                    void* stream) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Consts c{interval, spin_up, S, I_f, B_f, miss_weight, sharp};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  if (dtype == 0)
    rc = forward_t<float>(demand, theta, cost, n_out, delta_out, w_out, K, c,
                          st);
  else if (dtype == 1)
    rc = forward_t<double>(demand, theta, cost, n_out, delta_out, w_out, K,
                           c, st);
  return static_cast<int>(rc);
}

// The forward's inputs and saved (K,) buffers, grad_out (1,) and
// grad_theta (3,) = grad_out * dcost/dtheta, all in one type.
extern "C" int relax_backward_launch(const void* demand, const void* theta,
                                     const void* n_in, const void* delta_in,
                                     const void* w_in, const void* grad_out,
                                     void* grad_theta, int K, int dtype,
                                     double interval, double spin_up,
                                     double S, double I_f, double B_f,
                                     double miss_weight, double sharp,
                                     void* stream) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Consts c{interval, spin_up, S, I_f, B_f, miss_weight, sharp};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  if (dtype == 0)
    rc = backward_t<float>(demand, theta, n_in, delta_in, w_in, grad_out,
                           grad_theta, K, c, st);
  else if (dtype == 1)
    rc = backward_t<double>(demand, theta, n_in, delta_in, w_in, grad_out,
                            grad_theta, K, c, st);
  return static_cast<int>(rc);
}

// The bound's chain alone, for its latency: cycles (1,) int64 and sink
// (1,) float32 on the device. Not on any path.
extern "C" int relax_chain_bench_launch(void* cycles, void* sink, int K,
                                        double target0, double target1,
                                        double interval, double spin_up,
                                        double sharp, void* stream) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Consts c{interval, spin_up, 0.0, 0.0, 0.0, 0.0, sharp};
  relax_chain_bench_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      float(target0), float(target1), c, K, static_cast<long long*>(cycles),
      static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

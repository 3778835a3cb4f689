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
//   delta    = lam_hat / u + h - n
//   w        = sigmoid(sharp * delta)
//   n_new    = n + (w * alpha + (1 - w)) * delta,  alpha = I / (I + spin_up)
//   cost_k   = I_f I sp(n_new - lam) + B_f spin_up sp(delta)
//              + miss_weight sp(lam - n_new) S I,  sp(x) = softplus(sharp x)/sharp
// from n = lam_0 + h, lam_prev = lam_0; the cost is the sum over k. The
// pass saves n (before the step), delta and w of every interval. Reverse:
// the adjoint of n walks back over the intervals,
//   a       = nbar + dcost_k/dn_new
//   dbar    = a * dn_new/ddelta + dcost_k/ddelta
//   nbar    = a - dbar
// and dbar feeds dtheta: dh += dbar, dg += dbar (lam - lam_prev) / u,
// du -= dbar lam_hat / u^2; at the start dh += nbar (n = lam_0 + h).
//
// Arithmetic in the float type T of the inputs (float32 or float64); the
// cost's sum and the three gradient sums are kept in double and rounded
// to T once at the end, in interval order. softplus is the exact form
// max(x, 0) + log1p(exp(-|x|)) (no linear cut-off).
//
// Bound: the recurrence is sequential and scalar, so the latency of its
// dependent chain sets the time, not bytes or operations. Forward, the
// chain through n is 8 dependent operations an interval (subtract,
// multiply, the exponential's two, add, reciprocal, two fused
// multiply-adds); everything else (lam, the target, the three softplus
// terms) hangs off it and issues beside it. Reverse, the chain through
// nbar is 3 (add, fused multiply-add, subtract). Design: one warp a launch;
// the warp stages a tile of the inputs in shared memory with coalesced
// loads, and lane 0 walks the tile, so no step of the chain waits on
// device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 512;  // intervals staged in shared memory at a time

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

// The constants of one problem in T, rounded where the reference rounds.
template <typename T>
struct Params {
  T interval, sharp, SI, alpha, A, B, MW, S, h, g, u;
  __device__ Params(const Consts& c, const T* theta) {
    interval = T(c.interval);
    sharp = T(c.sharp);
    S = T(c.S);
    SI = S * interval;
    alpha = interval / (interval + T(c.spin_up));
    A = T(c.I_f) * interval;
    B = T(c.B_f * c.spin_up);
    MW = T(c.miss_weight);
    h = theta[0];
    g = theta[1];
    u = theta[2];
  }
};

template <typename T>
__global__ void __launch_bounds__(32)
relax_forward_kernel(const T* __restrict__ demand, const T* __restrict__ theta,
                     T* __restrict__ cost, T* __restrict__ n_out,
                     T* __restrict__ delta_out, T* __restrict__ w_out, int K,
                     Consts c) {
  __shared__ T tile[kTile];
  const int lane = threadIdx.x;
  const Params<T> p(c, theta);
  T lam_prev = demand[0] / p.SI;
  T n = lam_prev + p.h;
  double total = 0.0;
  for (int t0 = 0; t0 < K; t0 += kTile) {
    const int len = min(kTile, K - t0);
    for (int i = lane; i < len; i += 32) tile[i] = demand[t0 + i];
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < len; ++i) {
        const T lam = tile[i] / p.SI;
        const T lam_hat = lam + p.g * (lam - lam_prev);
        const T target = lam_hat / p.u + p.h;
        const T delta = target - n;
        const T w = sigmoid_t(p.sharp * delta);
        const T n_new = n + (w * p.alpha + (T(1) - w)) * delta;
        const T idle = p.A * softplus_t(n_new - lam, p.sharp);
        const T spin = p.B * softplus_t(delta, p.sharp);
        const T shortfall = softplus_t(lam - n_new, p.sharp);
        const T ck = idle + spin + p.MW * shortfall * p.S * p.interval;
        n_out[t0 + i] = n;
        delta_out[t0 + i] = delta;
        w_out[t0 + i] = w;
        total += static_cast<double>(ck);
        n = n_new;
        lam_prev = lam;
      }
    }
    __syncwarp();
  }
  if (lane == 0) cost[0] = T(total);
}

template <typename T>
__global__ void __launch_bounds__(32)
relax_backward_kernel(const T* __restrict__ demand,
                      const T* __restrict__ theta,
                      const T* __restrict__ n_in,
                      const T* __restrict__ delta_in,
                      const T* __restrict__ w_in,
                      const T* __restrict__ grad_out,
                      T* __restrict__ grad_theta, int K, Consts c) {
  // lam[t0 - 1 .. t0 + len) of the tile, and its saved n, delta, w
  __shared__ T lam_s[kTile + 1];
  __shared__ T n_s[kTile];
  __shared__ T d_s[kTile];
  __shared__ T w_s[kTile];
  const int lane = threadIdx.x;
  const Params<T> p(c, theta);
  const T cm = p.MW * p.S * p.interval;   // dcost/dshortfall
  const T one_minus_alpha = T(1) - p.alpha;
  T nbar = T(0);
  double gh = 0.0, gg = 0.0, gu = 0.0;
  for (int end = K; end > 0; end -= kTile) {
    const int t0 = max(0, end - kTile);
    const int len = end - t0;
    for (int i = lane; i <= len; i += 32) {
      const int k = t0 - 1 + i;          // k = -1 reads lam_0 (lam_prev)
      lam_s[i] = demand[max(k, 0)] / p.SI;
    }
    for (int i = lane; i < len; i += 32) {
      n_s[i] = n_in[t0 + i];
      d_s[i] = delta_in[t0 + i];
      w_s[i] = w_in[t0 + i];
    }
    __syncwarp();
    if (lane == 0) {
      for (int i = len - 1; i >= 0; --i) {
        const T lam = lam_s[i + 1], lam_prev = lam_s[i];
        const T n = n_s[i], delta = d_s[i], w = w_s[i];
        const T m = w * p.alpha + (T(1) - w);
        const T n_new = n + m * delta;
        const T lam_hat = lam + p.g * (lam - lam_prev);
        const T dc_dn = p.A * sigmoid_t(p.sharp * (n_new - lam))
                        - cm * sigmoid_t(p.sharp * (lam - n_new));
        const T dc_dd = p.B * sigmoid_t(p.sharp * delta);
        const T dn_dd = m - delta * one_minus_alpha * p.sharp * w * (T(1) - w);
        const T a = nbar + dc_dn;
        const T dbar = a * dn_dd + dc_dd;
        nbar = a - dbar;
        gh += static_cast<double>(dbar);
        gg += static_cast<double>(dbar * (lam - lam_prev) / p.u);
        gu -= static_cast<double>(dbar * lam_hat / (p.u * p.u));
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    const T go = grad_out[0];
    gh += static_cast<double>(nbar);
    grad_theta[0] = T(gh) * go;
    grad_theta[1] = T(gg) * go;
    grad_theta[2] = T(gu) * go;
  }
}

template <typename T>
cudaError_t forward_t(const void* demand, const void* theta, void* cost,
                      void* n_out, void* delta_out, void* w_out, int K,
                      const Consts& c, cudaStream_t stream) {
  relax_forward_kernel<T><<<1, 32, 0, stream>>>(
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
  relax_backward_kernel<T><<<1, 32, 0, stream>>>(
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

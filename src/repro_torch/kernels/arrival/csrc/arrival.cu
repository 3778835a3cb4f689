// arrival: one block of discrete-event arrivals for every cell of a chunk.
//
// Replaces the TPU kernel src/repro/kernels/arrival/arrival.py
// (arrival_block_pallas; pallas_call at line 139, body _kernel at line
// 101). For every cell it applies B arrivals, in order, to the cell's
// worker table: the Alg. 3 candidate search of
// repro_torch.sim.events_batched._find_candidates and the table update of
// _arrival_step, or of _arrival_fail (deadline-aware failover with spin-up
// retries, crashes, stragglers and evacuation) when the failure axis is on.
//
// Design. The TPU kernel keeps one cell's table in VMEM and runs the
// engine's own step function in a fori_loop. Here one thread block owns one
// cell and one thread owns one worker slot (W = 96 by default: three
// warps), so a slot's eleven columns and two accumulators live in that
// thread's registers for the whole block. The B arrival times sit in
// shared memory; the cell's scalar counters are kept, identically, by
// every thread (each update is computed from block-wide reductions, so all
// threads agree) and thread 0 writes them back. Each arrival is a few
// barrier-separated phases: elementwise masks; ring ranks over the FPGA
// region (thread i < w_f counts the ready wids below its own, from a
// shared array; integer counting is exact); reduction 1 (five maxima:
// the four candidate groups' availabilities and the ring size); reduction
// 2 (six maxima: wid tie-breaks, the cyclic ring key, the first free CPU
// slot); the winner one-hots and the update. Both reductions are max over
// -inf-masked values (warp shuffles, then one step across warps): max is
// exact, so any order gives the plain version's answer. The failure path
// adds one OR-reduction per failover round (served / crashed / served on
// an FPGA / missed) and stops once the request is placed (later rounds are
// no-ops in the plain version). Its hash is the uint32 finalizer of
// repro_torch.ft.failures, converted to float with round-to-nearest and
// scaled by 2^-32 exactly.
//
// Rounding. Every float product, sum and quotient is one IEEE-rounded op
// (__fadd_rn and friends, never contracted into an FMA) in the plain
// version's order, e.g. (t + deadline) - svc and A_c*(1+nf) + backoff*nf.
// With exact maxima and integer counts this makes every carry leaf, energies
// included, bitwise the plain version's.
//
// Bound. Per cell it moves its table in and out (13 words per slot each
// way plus 14 scalars) and reads B times: ~0.34 MB for a chunk of 32 cells
// at W = 96, 0.1 us at 3.35 TB/s. Its arithmetic, ~200 operations per slot
// per arrival with the shuffle steps, is 79 M operations for a full block,
// 1.2 us at the fp32 rate: operations bound it. What limits it in fact is
// the chain of B dependent arrivals, each with three or four block
// barriers, which one block per cell cannot hide (32 of 132 SMs busy).
// The design keeps that chain inside one launch per block of arrivals.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;    // largest table W (one thread per slot)
constexpr int kMaxWarps = kMaxThreads / 32;
// EventScalars float fields (repro_torch.sim.events_batched.FLOAT_FIELDS)
constexpr int kNumScalars = 31;
enum Scalar {
  kSize = 0, kDeadline = 1, kS = 2, kAcs = 10, kToF = 11, kToC = 12,
  kBc = 15, kCc = 18, kSpinP = 23, kBackoff = 24, kCrashP = 25,
  kSfrac = 26, kSfactor = 27, kEvac0 = 28, kEvac1 = 29, kEfrac = 30
};
// packed carry rows (kernels/arrival/ops.py::pack_carry)
enum FRow { kAllocT, kReadyAt, kAvail, kBusy, kCrashT, kSlow, kServ, kMiss, kNumF };
enum IRow { kWid, kLevel, kNAssign, kNFail, kAlive, kNumI };
enum SI { kNextWid, kRrPos, kOverflow, kRetries, kFailedSpins, kCrashes,
          kRecovered, kFailMisses, kDropped, kCpuSpins, kNumSI };
enum SF { kWastedJ, kExtraCost, kWorkF, kWorkC, kNumSF };
// draw purposes (repro_torch.ft.failures.DRAW_*)
constexpr uint32_t kDrawSpinup = 1, kDrawCrash = 2, kDrawStraggle = 3,
                   kDrawEvac = 4;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// failure_u01(seed, wid, counter, purpose)
__device__ __forceinline__ float u01(uint32_t seed, uint32_t wid,
                                     uint32_t counter, uint32_t purpose) {
  constexpr uint32_t kGold = 0x9E3779B9u;
  uint32_t h = mix(seed ^ (wid * kGold));
  h = mix(h ^ (counter * kGold));
  h = mix(h ^ (purpose * kGold));
  return mul(__uint2float_rn(h), __int_as_float(0x2F800000));   // 2^-32
}

// Leading failures of the spin-up attempt draws, capped at R + 1.
__device__ __forceinline__ int spin_fails(uint32_t seed, int wid, int R,
                                          float p) {
  int nf = 0;
  for (int k = 0; k <= R; ++k) {
    if (!(u01(seed, wid, k, kDrawSpinup) < p)) break;
    ++nf;
  }
  return nf;
}

// v[k] <- max over the block; scratch holds N * kMaxWarps floats.
template <int N>
__device__ __forceinline__ void block_max(float (&v)[N], float* scratch,
                                          int nwarps) {
#pragma unroll
  for (int k = 0; k < N; ++k)
    for (int o = 16; o > 0; o >>= 1)
      v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[k * kMaxWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float m = scratch[k * kMaxWarps];
    for (int w = 1; w < nwarps; ++w) m = fmaxf(m, scratch[k * kMaxWarps + w]);
    v[k] = m;
  }
}

__device__ __forceinline__ unsigned block_or(unsigned v, unsigned* scratch,
                                             int nwarps) {
  v = __reduce_or_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned m = 0;
  for (int w = 0; w < nwarps; ++w) m |= scratch[w];
  return m;
}

struct Shared {
  int rwid[kMaxThreads];            // ring member wids (-1: not in the ring)
  float r1[5 * kMaxWarps];
  float r2[6 * kMaxWarps];
  unsigned flags[kMaxWarps];
};

// One slot's view of the candidate search of one arrival.
struct Pick {
  bool found;        // the cell's policy found a feasible worker
  bool oh;           // ... and it is this slot
  bool rr_found;
  int n_ring;
  int rank_win;      // meaningful only where rr_found
  bool any_free;
  float slot_idx;    // first free CPU slot (+inf: none)
};

__device__ __forceinline__ Pick find_candidates(
    Shared& sh, int nwarps, int code, int w_f, bool slot, bool is_f,
    float idx_f, int wid, bool alive, float avail, float ready_at,
    float svc_w, bool live, bool ok, float t, float dl, int rr_pos) {
  const int i = threadIdx.x;
  const bool ready = live && (ready_at < t);
  const bool pend = live && !ready;
  const float widf = static_cast<float>(wid);
  const bool ringf = is_f && ready;
  if (i < w_f) sh.rwid[i] = ringf ? wid : -1;
  __syncthreads();
  int rank = 0;
  if (ringf)
    for (int j = 0; j < w_f; ++j) {
      const int wj = sh.rwid[j];
      rank += (wj >= 0 && wj < wid) ? 1 : 0;
    }
  const float slack = sub(dl, svc_w);
  const bool feas_rr = ringf && ok && (fmaxf(avail, t) <= slack);

  // reduction 1: candidate availabilities (4 groups) + ring size
  const bool g_fr = ready && is_f && ok && (avail <= slack);
  const bool g_cr = ready && !is_f && ok && (avail <= slack);
  const bool arrive_ok = add(avail, svc_w) <= dl;
  const bool g_fp = pend && is_f && ok && arrive_ok;
  const bool g_cp = pend && !is_f && ok && arrive_ok;
  const float neg = -CUDART_INF_F;
  float r1[5] = {g_fr ? avail : neg, g_cr ? avail : neg, g_fp ? avail : neg,
                 g_cp ? avail : neg,
                 ringf ? static_cast<float>(rank + 1) : neg};
  block_max(r1, sh.r1, nwarps);
  const bool any_fr = r1[0] > neg, any_cr = r1[1] > neg;
  Pick pk;
  pk.n_ring = static_cast<int>(fmaxf(r1[4], 1.0f));

  // reduction 2: wid tie-breaks, cyclic ring priority, first free slot
  const int s = rr_pos % pk.n_ring;
  const int key = rank < s ? rank + w_f : rank;
  const bool t_fr = g_fr && avail == r1[0], t_cr = g_cr && avail == r1[1];
  const bool t_fp = g_fp && avail == r1[2], t_cp = g_cp && avail == r1[3];
  float r2[6] = {t_fr ? widf : neg, t_cr ? widf : neg, t_fp ? -widf : neg,
                 t_cp ? -widf : neg,
                 feas_rr ? -static_cast<float>(key) : neg,
                 (slot && !alive && !is_f) ? -idx_f : neg};
  block_max(r2, sh.r2, nwarps);
  const float kmin = -r2[4];
  pk.rr_found = r2[4] > neg;
  pk.slot_idx = -r2[5];
  pk.any_free = r2[5] > neg;
  pk.rank_win = pk.rr_found ? static_cast<int>(kmin) % w_f : 0;

  // winner one-hots and the policy select (codes: 0 spork, 1
  // index_packing, any other round_robin, as dispatch_select folds them)
  const bool oh_f = any_fr ? (t_fr && widf == r2[0]) : (t_fp && widf == -r2[2]);
  const bool oh_c = any_cr ? (t_cr && widf == r2[1]) : (t_cp && widf == -r2[3]);
  const bool oh_rr = feas_rr && static_cast<float>(key) == kmin;
  const bool f_found = any_fr || r1[2] > neg;
  const bool c_found = any_cr || r1[3] > neg;
  if (code == 0) {
    pk.found = f_found || c_found;
    pk.oh = f_found ? oh_f : oh_c;
  } else if (code == 1) {
    const float av_f = any_fr ? r1[0] : r1[2];
    const float av_c = any_cr ? r1[1] : r1[3];
    const bool pick_f = (f_found && c_found) ? (av_f >= av_c) : f_found;
    pk.found = f_found || c_found;
    pk.oh = pick_f ? oh_f : oh_c;
  } else {
    pk.found = pk.rr_found || c_found;
    pk.oh = pk.rr_found ? oh_rr : oh_c;
  }
  return pk;
}

template <bool kFail>
__global__ void __launch_bounds__(kMaxThreads)
arrival_kernel(const float* __restrict__ esf, const int* __restrict__ seeds,
               const int* __restrict__ codes,
               const float* __restrict__ times,
               const float* __restrict__ wf_in, const int* __restrict__ wi_in,
               const int* __restrict__ si_in, const float* __restrict__ sf_in,
               float* __restrict__ wf_out, int* __restrict__ wi_out,
               int* __restrict__ si_out, float* __restrict__ sf_out,
               int W, int w_f, int B, int R, int F) {
  extern __shared__ float s_times[];
  __shared__ Shared sh;
  const int cell = blockIdx.x, i = threadIdx.x;
  const int nwarps = blockDim.x >> 5;
  const bool slot = i < W;
  const bool is_f = i < w_f;
  const float idx_f = static_cast<float>(i);

  const float* es = esf + static_cast<size_t>(cell) * kNumScalars;
  const float size = es[kSize], deadline = es[kDeadline];
  const float A_c_s = es[kAcs];
  const uint32_t seed = static_cast<uint32_t>(seeds[cell]);
  const int code = codes[cell];
  for (int k = i; k < B; k += blockDim.x)
    s_times[k] = times[static_cast<size_t>(cell) * B + k];

  const float* wf = wf_in + static_cast<size_t>(cell) * kNumF * W;
  const int* wi = wi_in + static_cast<size_t>(cell) * kNumI * W;
  float alloc_t = 0.f, ready_at = 0.f, avail = 0.f, busy = 0.f;
  float crash_t = CUDART_INF_F, slow = 1.f, serv = 0.f, miss = 0.f;
  int wid = 0, level = 0, n_assign = 0, nfail = 0;
  bool alive = false;
  if (slot) {
    alloc_t = wf[kAllocT * W + i]; ready_at = wf[kReadyAt * W + i];
    avail = wf[kAvail * W + i]; busy = wf[kBusy * W + i];
    crash_t = wf[kCrashT * W + i]; slow = wf[kSlow * W + i];
    serv = wf[kServ * W + i]; miss = wf[kMiss * W + i];
    wid = wi[kWid * W + i]; level = wi[kLevel * W + i];
    n_assign = wi[kNAssign * W + i]; nfail = wi[kNFail * W + i];
    alive = wi[kAlive * W + i] != 0;
  }
  const int* si = si_in + static_cast<size_t>(cell) * kNumSI;
  const float* sf = sf_in + static_cast<size_t>(cell) * kNumSF;
  int next_wid = si[kNextWid], rr_pos = si[kRrPos], overflow = si[kOverflow];
  int retries = si[kRetries], failed_spins = si[kFailedSpins];
  int crashes = si[kCrashes], recovered = si[kRecovered];
  int fail_misses = si[kFailMisses], dropped = si[kDropped];
  int cpu_spins = si[kCpuSpins];
  float wasted_j = sf[kWastedJ], extra_cost = sf[kExtraCost];
  float work_f = sf[kWorkF], work_c = sf[kWorkC];
  __syncthreads();

  const float base_svc = is_f ? __fdiv_rn(size, es[kS]) : size;
  const float timeout = is_f ? es[kToF] : es[kToC];
  for (int a = 0; a < B; ++a) {
    const float t = s_times[a];
    if (!isfinite(t)) continue;                 // padding: a no-op
    const float dl = add(t, deadline);
    const float dl_miss = add(dl, 1e-9f);
    if constexpr (!kFail) {
      const float svc_w = base_svc;
      const bool live = slot && alive
          && (add(fmaxf(ready_at, avail), timeout) >= t);
      const Pick pk = find_candidates(sh, nwarps, code, w_f, slot, is_f,
                                      idx_f, wid, alive, avail, ready_at,
                                      svc_w, live, true, t, dl, rr_pos);
      if (code == 2 && pk.rr_found) rr_pos = (pk.rank_win + 1) % pk.n_ring;
      const bool spin = !pk.found && pk.any_free;
      const bool oh_spin = slot && idx_f == pk.slot_idx && spin;
      const bool oh_do = pk.found ? pk.oh : oh_spin;
      const float t_ready = add(t, A_c_s);
      const float new_av = add(fmaxf(oh_spin ? t_ready : avail, t), svc_w);
      if (oh_spin) {
        wid = next_wid + 1;
        alive = true;
        alloc_t = t;
        ready_at = t_ready;
      }
      if (oh_do) {
        if (new_av > dl_miss) miss = add(miss, 1.0f);
        avail = new_av;
        busy = add(oh_spin ? 0.0f : busy, svc_w);
        serv = add(serv, svc_w);
      }
      next_wid += spin ? 1 : 0;
      overflow += (!pk.found && !pk.any_free) ? 1 : 0;
    } else {
      const float spin_p = es[kSpinP], backoff = es[kBackoff];
      bool act = true, crashed_any = false;
      for (int r = 0; r <= F && act; ++r) {
        const float svc_w = mul(base_svc, slow);
        const bool live = slot && alive
            && (add(fmaxf(ready_at, avail), timeout) >= t)
            && crash_t == CUDART_INF_F;
        const bool member = u01(seed, wid, 0, kDrawEvac) < es[kEfrac];
        const bool ok = !(member && es[kEvac0] <= t && t < es[kEvac1]);
        const Pick pk = find_candidates(sh, nwarps, code, w_f, slot, is_f,
                                        idx_f, wid, alive, avail, ready_at,
                                        svc_w, live, ok, t, dl, rr_pos);
        if (code == 2 && pk.rr_found) rr_pos = (pk.rank_win + 1) % pk.n_ring;

        // burst CPU spin-up with bounded retries
        const bool spin = !pk.found && pk.any_free;
        const bool oh_spin = slot && idx_f == pk.slot_idx && spin;
        const int new_wid = next_wid + 1;
        const int nf_new = spin_fails(seed, new_wid, R, spin_p);
        const bool still = nf_new > R;
        const bool spin_ok = spin && !still, spin_still = spin && still;
        const bool oh_occ = oh_spin && spin_ok;
        const float nf_f = static_cast<float>(nf_new);
        const float a_c_eff = add(mul(A_c_s, add(1.0f, nf_f)),
                                  mul(backoff, nf_f));
        const float slow_new =
            u01(seed, new_wid, 0, kDrawStraggle) < es[kSfrac] ? es[kSfactor]
                                                              : 1.0f;
        if (spin) {
          failed_spins += nf_new;
          retries += nf_new < R ? nf_new : R;
          wasted_j = add(wasted_j, mul(nf_f, mul(A_c_s, es[kBc])));
        }
        if (spin_still)
          extra_cost = add(extra_cost,
                           mul(add(mul(static_cast<float>(R + 1), A_c_s),
                                   mul(static_cast<float>(R), backoff)),
                               es[kCc]));
        cpu_spins += spin_ok ? 1 : 0;

        // crash draw per assignment, keyed (wid, n_assigned)
        const bool oh_do = pk.found ? pk.oh : (oh_spin && spin_ok);
        bool crashed = false;
        if (oh_do)
          crashed = u01(seed, oh_spin ? new_wid : wid,
                        oh_spin ? 0 : n_assign, kDrawCrash) < es[kCrashP];
        const float svc_used = oh_spin ? mul(size, slow_new) : svc_w;
        const float t_occ = add(t, a_c_eff);
        const float start = fmaxf(oh_spin ? t_occ : avail, t);
        const float new_av = add(start, svc_used);
        const float half = mul(svc_used, 0.5f);
        const bool served = oh_do && !crashed;
        const bool missed = served && new_av > dl_miss;
        const float used = crashed ? half : svc_used;
        if (oh_occ) {
          wid = new_wid;
          alive = true;
          alloc_t = t;
          ready_at = t_occ;
          slow = slow_new;
          nfail = nf_new;
        }
        if (served) avail = new_av;
        else if (oh_occ) avail = t_occ;
        if (oh_do) {
          busy = add(oh_occ ? 0.0f : busy, used);
          n_assign = (oh_occ ? 0 : n_assign) + 1;
          serv = add(serv, used);
        }
        if (crashed) crash_t = add(start, half);
        else if (oh_occ) crash_t = CUDART_INF_F;
        if (missed) miss = add(miss, 1.0f);

        const unsigned bits = block_or(
            (served ? 1u : 0u) | (crashed ? 2u : 0u)
                | ((served && is_f) ? 4u : 0u) | (missed ? 8u : 0u),
            sh.flags, nwarps);
        const bool served_s = bits & 1u, crash_s = bits & 2u;
        const bool win_f = bits & 4u;
        crashes += crash_s ? 1 : 0;
        recovered += (served_s && crashed_any) ? 1 : 0;
        if (win_f) work_f = add(work_f, size);
        if (served_s && !win_f) work_c = add(work_c, size);
        if (r > 0 && (bits & 8u)) ++fail_misses;
        next_wid += spin ? 1 : 0;
        overflow += (!pk.found && !pk.any_free) ? 1 : 0;
        crashed_any = crashed_any || crash_s;
        act = spin_still || crash_s;
      }
      if (act) {               // failover rounds exhausted: dropped
        ++dropped;
        ++fail_misses;
      }
    }
  }

  if (slot) {
    float* wo = wf_out + static_cast<size_t>(cell) * kNumF * W;
    int* io = wi_out + static_cast<size_t>(cell) * kNumI * W;
    wo[kAllocT * W + i] = alloc_t; wo[kReadyAt * W + i] = ready_at;
    wo[kAvail * W + i] = avail; wo[kBusy * W + i] = busy;
    wo[kCrashT * W + i] = crash_t; wo[kSlow * W + i] = slow;
    wo[kServ * W + i] = serv; wo[kMiss * W + i] = miss;
    io[kWid * W + i] = wid; io[kLevel * W + i] = level;
    io[kNAssign * W + i] = n_assign; io[kNFail * W + i] = nfail;
    io[kAlive * W + i] = alive ? 1 : 0;
  }
  if (i == 0) {
    int* so = si_out + static_cast<size_t>(cell) * kNumSI;
    float* fo = sf_out + static_cast<size_t>(cell) * kNumSF;
    so[kNextWid] = next_wid; so[kRrPos] = rr_pos; so[kOverflow] = overflow;
    so[kRetries] = retries; so[kFailedSpins] = failed_spins;
    so[kCrashes] = crashes; so[kRecovered] = recovered;
    so[kFailMisses] = fail_misses; so[kDropped] = dropped;
    so[kCpuSpins] = cpu_spins;
    fo[kWastedJ] = wasted_j; fo[kExtraCost] = extra_cost;
    fo[kWorkF] = work_f; fo[kWorkC] = work_c;
  }
}

}  // namespace

// One launch per arrival block for a chunk of `cells` cells. esf: (cells,
// 31) float32 EventScalars rows; seeds, codes: (cells,) int32 (the uint32
// hash seed's bits, the dispatch policy code); times: (cells, B) float32,
// +inf-padded; the carry in (wf_in, wi_in, si_in, sf_in) and out
// (wf_out, ...): (cells, 8, W) float32, (cells, 5, W) int32, (cells, 10)
// int32, (cells, 4) float32. fail selects the failure-aware path, with
// max_retries / max_failover as loop bounds. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int arrival_launch(const float* esf, const int* seeds,
                              const int* codes, const float* times,
                              const float* wf_in, const int* wi_in,
                              const int* si_in, const float* sf_in,
                              float* wf_out, int* wi_out, int* si_out,
                              float* sf_out, int cells, int W, int w_f, int B,
                              int fail, int max_retries, int max_failover,
                              void* stream) {
  if (cells <= 0 || W <= 0 || W > kMaxThreads || w_f < 1 || w_f > W
      || B < 0 || max_retries < 0 || max_failover < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (W + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(B > 0 ? B : 1) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fail)
    arrival_kernel<true><<<cells, threads, smem, s>>>(
        esf, seeds, codes, times, wf_in, wi_in, si_in, sf_in, wf_out, wi_out,
        si_out, sf_out, W, w_f, B, max_retries, max_failover);
  else
    arrival_kernel<false><<<cells, threads, smem, s>>>(
        esf, seeds, codes, times, wf_in, wi_in, si_in, sf_in, wf_out, wi_out,
        si_out, sf_out, W, w_f, B, max_retries, max_failover);
  return static_cast<int>(cudaGetLastError());
}

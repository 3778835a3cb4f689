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
// engine's own step function in a fori_loop. Here one warp owns one cell,
// and a block packs kCellsPerBlock cells that share nothing but the block
// (one warp to each of the SM's four schedulers). Lane l holds slots l,
// l + 32, l + 64, ... (K = ceil(W / 32) slots a lane, 3 at the default W =
// 96), with each slot's eleven columns and two accumulators in registers
// for the whole block of arrivals. The cell's scalar counters are kept,
// identically, by every lane (each update is computed from warp-wide
// reductions, so all lanes agree) and lane 0 writes them back. An arrival
// is: elementwise masks; the ring ranks over the FPGA region (round robin
// only, and counted again only when the ring's membership, one ballot per
// slot row, changed: the ring's wids go to a shared array of the warp's
// own and, after a __syncwarp, each lane counts those below its slots'
// wids with 16-byte broadcast reads; the ring size comes with them);
// reduction 1, four maxima (the candidate groups' availabilities);
// reduction 2, of only what the cell's policy reads (the lowest cyclic
// ring key for round robin, else the winning group's wid tie-break; the
// first free CPU slot only where no worker was found), usually one
// reduction; the winner one-hots and the update. A reduction is a max or
// min over the lane's slots, then one __reduce_max_sync or
// __reduce_min_sync (a float on its bits mapped to an int of the same
// order): maxima, minima and integer counts are exact, so any order gives
// the plain version's answer. The failure path adds one __reduce_or_sync
// per failover round (served / crashed / served on an FPGA / missed) and
// stops once the request is placed (later rounds are no-ops in the plain
// version). Its hash is the uint32 finalizer of repro_torch.ft.failures,
// converted to float with round-to-nearest and scaled by 2^-32 exactly. A
// slot's evacuation draw (keyed by its wid) and the crash draw of its next
// assignment (wid and assignment count) are drawn again only when those
// change, off the arrival's dependent chain, and the spin-up draws only
// when a spin-up happens. No block-wide barrier is left in the loop over
// the arrivals.
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
// per arrival, is 79 M operations for a full block, 2.5 us at the card's
// fp32 and int32 rates: operations bound it. What limits it in fact is the
// chain of B dependent arrivals of one cell on one warp, each a few
// hundred dependent instructions and two or three warp reductions: a chunk
// of 32 cells is 32 warps, one to a warp scheduler, on 8 of the 132 SMs.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlotsPerLane = 8;           // W <= 256
constexpr int kMaxW = 32 * kMaxSlotsPerLane;
constexpr int kCellsPerBlock = 4;             // one warp per cell
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff, kIntMin = -kIntMax - 1;
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

// A float's bits as an int of the same order (-0 just below +0), and
// back: the map is its own inverse.
__device__ __forceinline__ int ordered(float x) {
  const int i = __float_as_int(x);
  return i ^ ((i >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

// Maxima and minima over the warp, one redux.sync each; the float one on
// the order-preserving ints, so its result is one of the inputs, exactly.
__device__ __forceinline__ float warp_max(float x) {
  return unordered(__reduce_max_sync(kFull, ordered(x)));
}
__device__ __forceinline__ int warp_max(int x) {
  return __reduce_max_sync(kFull, x);
}
__device__ __forceinline__ int warp_min(int x) {
  return __reduce_min_sync(kFull, x);
}

// The slots one lane holds: slot k * 32 + lane.
template <int K>
struct Table {
  float alloc_t[K], ready_at[K], avail[K], busy[K], crash_t[K], slow[K];
  float serv[K], miss[K];
  int wid[K], level[K], n_assign[K], nfail[K];
  bool alive[K];
};

// The ring ranks of the FPGA slot rows (ranks of slots outside the ring are
// unused) and the ring size, kept from one candidate search to the next
// while the ring's membership (one ballot per row) is unchanged: an FPGA
// slot's wid never changes inside the kernel (spin-ups fill CPU slots).
template <int K>
struct RingRanks {
  bool valid = false;
  unsigned mask[K] = {};
  int rank[K] = {};
  int n_ring = 1;
};

// What the candidate search of one arrival decided, the same on every lane;
// the winner's one-hot comes back per slot.
struct Pick {
  bool found;        // the cell's policy found a feasible worker
  bool rr_found;
  int n_ring;
  int rank_win;      // meaningful only where rr_found
  bool any_free;
  int slot_idx;      // first free CPU slot (kIntMax: none)
};

// The plain version's float maxima of wids, -wids, -keys and -slot indices
// are taken here as int maxima and minima of the same integers: exact,
// since wids, keys and indices stay far below 2^24.
template <int K>
__device__ __forceinline__ Pick find_candidates(
    int code, int w_f, const bool (&slot)[K], const bool (&is_f)[K],
    const int (&idx)[K], const Table<K>& tb, const float (&svc_w)[K],
    const bool (&live)[K], const bool (&ok)[K], float t, float dl,
    int rr_pos, int* ring, RingRanks<K>& rk, bool (&oh)[K]) {
  const float neg = -CUDART_INF_F;
  bool ready[K], pend[K], ringf[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ready[k] = live[k] && (tb.ready_at[k] < t);
    pend[k] = live[k] && !ready[k];
    ringf[k] = is_f[k] && ready[k];
  }
  // ring ranks (the ready FPGA wids below one's own), read by the
  // round-robin policy only, and counted again only when the ring's
  // membership changed: the ring's wids go to this warp's shared array
  // (kIntMax for a slot outside the ring), then each lane counts
  const bool rr = code != 0 && code != 1;
  const int kf = (w_f + 31) / 32;           // slot rows that hold FPGAs
  if (rr) {
    bool same = rk.valid;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k >= kf) break;
      const unsigned m = __ballot_sync(kFull, ringf[k]);
      same = same && m == rk.mask[k];
      rk.mask[k] = m;
    }
    if (!same) {
      __syncwarp();                         // the last count's reads
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k < kf) ring[k * 32 + (threadIdx.x & 31)] =
            ringf[k] ? tb.wid[k] : kIntMax;
      __syncwarp();
      const int4* ring4 = reinterpret_cast<const int4*>(ring);
      int n_ring = 1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        rk.rank[k] = 0;
        if (k >= kf) continue;
#pragma unroll
        for (int q = 0; q < 8 * K; ++q) {
          if (q >= 8 * kf) break;
          const int4 w = ring4[q];
          rk.rank[k] += (w.x < tb.wid[k]) + (w.y < tb.wid[k])
                        + (w.z < tb.wid[k]) + (w.w < tb.wid[k]);
        }
        if (ringf[k]) n_ring = max(n_ring, rk.rank[k] + 1);
      }
      rk.n_ring = warp_max(n_ring);
      rk.valid = true;
    }
  }

  // reduction 1: candidate availabilities (4 groups)
  bool g_fr[K], g_cr[K], g_fp[K], g_cp[K], feas_rr[K];
  float r1[4] = {neg, neg, neg, neg};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float avail = tb.avail[k];
    const float slack = sub(dl, svc_w[k]);
    feas_rr[k] = ringf[k] && ok[k] && (fmaxf(avail, t) <= slack);
    g_fr[k] = ready[k] && is_f[k] && ok[k] && (avail <= slack);
    g_cr[k] = ready[k] && !is_f[k] && ok[k] && (avail <= slack);
    const bool arrive_ok = add(avail, svc_w[k]) <= dl;
    g_fp[k] = pend[k] && is_f[k] && ok[k] && arrive_ok;
    g_cp[k] = pend[k] && !is_f[k] && ok[k] && arrive_ok;
    r1[0] = fmaxf(r1[0], g_fr[k] ? avail : neg);
    r1[1] = fmaxf(r1[1], g_cr[k] ? avail : neg);
    r1[2] = fmaxf(r1[2], g_fp[k] ? avail : neg);
    r1[3] = fmaxf(r1[3], g_cp[k] ? avail : neg);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) r1[j] = warp_max(r1[j]);
  Pick pk;
  pk.n_ring = rr ? rk.n_ring : 1;
  const bool any_fr = r1[0] > neg, any_cr = r1[1] > neg;

  // reduction 2, only what the cell's policy reads: the lowest cyclic ring
  // key (round robin); else the winning group's wid tie-break (the highest
  // wid of the busiest ready candidates, or the lowest of the most loaded
  // pending ones: a max over -wid); the first free CPU slot only where no
  // worker was found
  const bool f_found = any_fr || r1[2] > neg;
  const bool c_found = any_cr || r1[3] > neg;
  int kmin = kIntMax;
  if (rr) {
    // rr_pos % n_ring (rr_pos is below the ring size unless it shrank)
    const int s = rr_pos < pk.n_ring ? rr_pos : rr_pos % pk.n_ring;
    int key[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      key[k] = rk.rank[k] < s ? rk.rank[k] + w_f : rk.rank[k];
      if (feas_rr[k]) kmin = min(kmin, key[k]);
    }
    kmin = warp_min(kmin);
#pragma unroll
    for (int k = 0; k < K; ++k) oh[k] = feas_rr[k] && key[k] == kmin;
  }
  pk.rr_found = kmin != kIntMax;
  // key < 2 * w_f (a rank is below w_f), so key % w_f is one subtraction
  pk.rank_win = !pk.rr_found ? 0 : kmin >= w_f ? kmin - w_f : kmin;
  bool pick_f = f_found;                    // spork: FPGAs first
  if (code == 1) {
    const float av_f = any_fr ? r1[0] : r1[2];
    const float av_c = any_cr ? r1[1] : r1[3];
    pick_f = (f_found && c_found) ? (av_f >= av_c) : f_found;
  }
  pk.found = rr ? (pk.rr_found || c_found) : (f_found || c_found);
  if (!(rr && pk.rr_found)) {
    const bool grp_f = !rr && pick_f;
    const bool grp_ready = grp_f ? any_fr : any_cr;
    const float best = grp_f ? (any_fr ? r1[0] : r1[2])
                             : (any_cr ? r1[1] : r1[3]);
    bool tie[K];
    int top = kIntMin;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool cand = grp_f ? (any_fr ? g_fr[k] : g_fp[k])
                              : (any_cr ? g_cr[k] : g_cp[k]);
      tie[k] = cand && tb.avail[k] == best;
      if (tie[k]) top = max(top, grp_ready ? tb.wid[k] : -tb.wid[k]);
    }
    top = warp_max(top);
#pragma unroll
    for (int k = 0; k < K; ++k)
      oh[k] = tie[k] && (grp_ready ? tb.wid[k] : -tb.wid[k]) == top;
  }
  int free_idx = kIntMax;
  if (!pk.found) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (slot[k] && !tb.alive[k] && !is_f[k]) free_idx = min(free_idx, idx[k]);
    free_idx = warp_min(free_idx);
  }
  pk.slot_idx = free_idx;
  pk.any_free = free_idx != kIntMax;
  return pk;
}

// (rank_win + 1) % n_ring: the winner is in the ring, so rank_win + 1 <=
// n_ring and the remainder is one comparison.
__device__ __forceinline__ int next_ring_pos(const Pick& pk) {
  return pk.rank_win + 1 < pk.n_ring ? pk.rank_win + 1 : 0;
}

template <int K, bool kFail>
__global__ void __launch_bounds__(kCellsPerBlock * 32)
arrival_kernel(const float* __restrict__ esf, const int* __restrict__ seeds,
               const int* __restrict__ codes,
               const float* __restrict__ times,
               const float* __restrict__ wf_in, const int* __restrict__ wi_in,
               const int* __restrict__ si_in, const float* __restrict__ sf_in,
               float* __restrict__ wf_out, int* __restrict__ wi_out,
               int* __restrict__ si_out, float* __restrict__ sf_out,
               int cells, int W, int w_f, int B, int R, int F) {
  __shared__ __align__(16) int s_ring[kCellsPerBlock][kMaxW];
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kCellsPerBlock + (threadIdx.x >> 5);
  if (cell >= cells) return;          // the warps share no barrier
  int* ring = s_ring[threadIdx.x >> 5];

  const float* es = esf + static_cast<size_t>(cell) * kNumScalars;
  const float size = es[kSize], deadline = es[kDeadline];
  const float A_c_s = es[kAcs];
  const uint32_t seed = static_cast<uint32_t>(seeds[cell]);
  const int code = codes[cell];

  bool slot[K], is_f[K];
  int idx[K];
  float base_svc[K], timeout[K];
  Table<K> tb;
  const float* wf = wf_in + static_cast<size_t>(cell) * kNumF * W;
  const int* wi = wi_in + static_cast<size_t>(cell) * kNumI * W;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * 32 + lane;
    slot[k] = i < W;
    is_f[k] = i < w_f;
    idx[k] = i;
    base_svc[k] = is_f[k] ? __fdiv_rn(size, es[kS]) : size;
    timeout[k] = is_f[k] ? es[kToF] : es[kToC];
    tb.alloc_t[k] = 0.f; tb.ready_at[k] = 0.f; tb.avail[k] = 0.f;
    tb.busy[k] = 0.f; tb.crash_t[k] = CUDART_INF_F; tb.slow[k] = 1.f;
    tb.serv[k] = 0.f; tb.miss[k] = 0.f;
    tb.wid[k] = 0; tb.level[k] = 0; tb.n_assign[k] = 0; tb.nfail[k] = 0;
    tb.alive[k] = false;
    if (slot[k]) {
      tb.alloc_t[k] = wf[kAllocT * W + i]; tb.ready_at[k] = wf[kReadyAt * W + i];
      tb.avail[k] = wf[kAvail * W + i]; tb.busy[k] = wf[kBusy * W + i];
      tb.crash_t[k] = wf[kCrashT * W + i]; tb.slow[k] = wf[kSlow * W + i];
      tb.serv[k] = wf[kServ * W + i]; tb.miss[k] = wf[kMiss * W + i];
      tb.wid[k] = wi[kWid * W + i]; tb.level[k] = wi[kLevel * W + i];
      tb.n_assign[k] = wi[kNAssign * W + i]; tb.nfail[k] = wi[kNFail * W + i];
      tb.alive[k] = wi[kAlive * W + i] != 0;
    }
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

  // failure-aware constants; each slot's evacuation membership (a draw
  // keyed by its wid) and the crash draw of its next assignment (keyed by
  // wid and n_assign), drawn again only when those change
  float spin_p = 0.f, backoff = 0.f, crash_p = 0.f, s_frac = 0.f;
  float s_factor = 1.f, evac0 = 0.f, evac1 = 0.f, e_frac = 0.f;
  float B_c = 0.f, C_c = 0.f;
  bool member[K], crash_next[K];
#pragma unroll
  for (int k = 0; k < K; ++k) member[k] = crash_next[k] = false;
  if constexpr (kFail) {
    spin_p = es[kSpinP]; backoff = es[kBackoff]; crash_p = es[kCrashP];
    s_frac = es[kSfrac]; s_factor = es[kSfactor];
    evac0 = es[kEvac0]; evac1 = es[kEvac1]; e_frac = es[kEfrac];
    B_c = es[kBc]; C_c = es[kCc];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      member[k] = u01(seed, tb.wid[k], 0, kDrawEvac) < e_frac;
      crash_next[k] = u01(seed, tb.wid[k], tb.n_assign[k], kDrawCrash)
                      < crash_p;
    }
  }
  RingRanks<K> rk;

  const float* tc = times + static_cast<size_t>(cell) * B;
  float t_next = B > 0 ? tc[0] : 0.f;
  for (int a = 0; a < B; ++a) {
    const float t = t_next;
    if (a + 1 < B) t_next = tc[a + 1];        // in flight during this one
    if (!isfinite(t)) continue;               // padding: a no-op
    const float dl = add(t, deadline);
    const float dl_miss = add(dl, 1e-9f);
    if constexpr (!kFail) {
      bool live[K], ok[K], oh[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        live[k] = slot[k] && tb.alive[k]
            && (add(fmaxf(tb.ready_at[k], tb.avail[k]), timeout[k]) >= t);
        ok[k] = true;
      }
      const Pick pk = find_candidates(code, w_f, slot, is_f, idx, tb,
                                      base_svc, live, ok, t, dl, rr_pos, ring,
                                      rk, oh);
      if (code == 2 && pk.rr_found) rr_pos = next_ring_pos(pk);
      const bool spin = !pk.found && pk.any_free;
      const float t_ready = add(t, A_c_s);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float svc_w = base_svc[k];
        const bool oh_spin = slot[k] && idx[k] == pk.slot_idx && spin;
        const bool oh_do = pk.found ? oh[k] : oh_spin;
        const float new_av =
            add(fmaxf(oh_spin ? t_ready : tb.avail[k], t), svc_w);
        if (oh_spin) {
          tb.wid[k] = next_wid + 1;
          tb.alive[k] = true;
          tb.alloc_t[k] = t;
          tb.ready_at[k] = t_ready;
        }
        if (oh_do) {
          if (new_av > dl_miss) tb.miss[k] = add(tb.miss[k], 1.0f);
          tb.avail[k] = new_av;
          tb.busy[k] = add(oh_spin ? 0.0f : tb.busy[k], svc_w);
          tb.serv[k] = add(tb.serv[k], svc_w);
        }
      }
      next_wid += spin ? 1 : 0;
      overflow += (!pk.found && !pk.any_free) ? 1 : 0;
    } else {
      bool act = true, crashed_any = false;
      for (int r = 0; r <= F && act; ++r) {
        bool live[K], ok[K], oh[K];
        float svc_w[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          svc_w[k] = mul(base_svc[k], tb.slow[k]);
          live[k] = slot[k] && tb.alive[k]
              && (add(fmaxf(tb.ready_at[k], tb.avail[k]), timeout[k]) >= t)
              && tb.crash_t[k] == CUDART_INF_F;
          ok[k] = !(member[k] && evac0 <= t && t < evac1);
        }
        const Pick pk = find_candidates(code, w_f, slot, is_f, idx, tb,
                                        svc_w, live, ok, t, dl, rr_pos, ring,
                                        rk, oh);
        if (code == 2 && pk.rr_found) rr_pos = next_ring_pos(pk);

        // burst CPU spin-up with bounded retries (the draws only matter
        // where a spin-up happens)
        const bool spin = !pk.found && pk.any_free;
        const int new_wid = next_wid + 1;
        int nf_new = 0;
        float slow_new = 1.0f;
        bool crash_new = false;             // the new worker's first draw
        if (spin) {
          nf_new = spin_fails(seed, new_wid, R, spin_p);
          slow_new = u01(seed, new_wid, 0, kDrawStraggle) < s_frac ? s_factor
                                                                   : 1.0f;
          crash_new = u01(seed, new_wid, 0, kDrawCrash) < crash_p;
        }
        const bool still = nf_new > R;
        const bool spin_ok = spin && !still, spin_still = spin && still;
        const float nf_f = static_cast<float>(nf_new);
        const float a_c_eff = add(mul(A_c_s, add(1.0f, nf_f)),
                                  mul(backoff, nf_f));
        if (spin) {
          failed_spins += nf_new;
          retries += nf_new < R ? nf_new : R;
          wasted_j = add(wasted_j, mul(nf_f, mul(A_c_s, B_c)));
        }
        if (spin_still)
          extra_cost = add(extra_cost,
                           mul(add(mul(static_cast<float>(R + 1), A_c_s),
                                   mul(static_cast<float>(R), backoff)),
                               C_c));
        cpu_spins += spin_ok ? 1 : 0;

        // crash draw per assignment, keyed (wid, n_assigned)
        const float t_occ = add(t, a_c_eff);
        unsigned bits = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool oh_spin = slot[k] && idx[k] == pk.slot_idx && spin;
          const bool oh_occ = oh_spin && spin_ok;
          const bool oh_do = pk.found ? oh[k] : oh_occ;
          const bool crashed = oh_do && (oh_spin ? crash_new : crash_next[k]);
          const float svc_used = oh_spin ? mul(size, slow_new) : svc_w[k];
          const float start = fmaxf(oh_spin ? t_occ : tb.avail[k], t);
          const float new_av = add(start, svc_used);
          const float half = mul(svc_used, 0.5f);
          const bool served = oh_do && !crashed;
          const bool missed = served && new_av > dl_miss;
          const float used = crashed ? half : svc_used;
          if (oh_occ) {
            tb.wid[k] = new_wid;
            tb.alive[k] = true;
            tb.alloc_t[k] = t;
            tb.ready_at[k] = t_occ;
            tb.slow[k] = slow_new;
            tb.nfail[k] = nf_new;
            member[k] = u01(seed, new_wid, 0, kDrawEvac) < e_frac;
          }
          if (served) tb.avail[k] = new_av;
          else if (oh_occ) tb.avail[k] = t_occ;
          if (oh_do) {
            tb.busy[k] = add(oh_occ ? 0.0f : tb.busy[k], used);
            tb.n_assign[k] = (oh_occ ? 0 : tb.n_assign[k]) + 1;
            tb.serv[k] = add(tb.serv[k], used);
            crash_next[k] = u01(seed, tb.wid[k], tb.n_assign[k],
                                kDrawCrash) < crash_p;
          }
          if (crashed) tb.crash_t[k] = add(start, half);
          else if (oh_occ) tb.crash_t[k] = CUDART_INF_F;
          if (missed) tb.miss[k] = add(tb.miss[k], 1.0f);
          bits |= (served ? 1u : 0u) | (crashed ? 2u : 0u)
                  | ((served && is_f[k]) ? 4u : 0u) | (missed ? 8u : 0u);
      }
        bits = __reduce_or_sync(kFull, bits);
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

  float* wo = wf_out + static_cast<size_t>(cell) * kNumF * W;
  int* io = wi_out + static_cast<size_t>(cell) * kNumI * W;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!slot[k]) continue;
    const int i = k * 32 + lane;
    wo[kAllocT * W + i] = tb.alloc_t[k]; wo[kReadyAt * W + i] = tb.ready_at[k];
    wo[kAvail * W + i] = tb.avail[k]; wo[kBusy * W + i] = tb.busy[k];
    wo[kCrashT * W + i] = tb.crash_t[k]; wo[kSlow * W + i] = tb.slow[k];
    wo[kServ * W + i] = tb.serv[k]; wo[kMiss * W + i] = tb.miss[k];
    io[kWid * W + i] = tb.wid[k]; io[kLevel * W + i] = tb.level[k];
    io[kNAssign * W + i] = tb.n_assign[k]; io[kNFail * W + i] = tb.nfail[k];
    io[kAlive * W + i] = tb.alive[k] ? 1 : 0;
  }
  if (lane == 0) {
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

template <int K>
cudaError_t launch_k(const float* esf, const int* seeds, const int* codes,
                     const float* times, const float* wf_in, const int* wi_in,
                     const int* si_in, const float* sf_in, float* wf_out,
                     int* wi_out, int* si_out, float* sf_out, int cells,
                     int W, int w_f, int B, int fail, int R, int F,
                     cudaStream_t s) {
  const int blocks = (cells + kCellsPerBlock - 1) / kCellsPerBlock;
  const int threads = kCellsPerBlock * 32;
  if (fail)
    arrival_kernel<K, true><<<blocks, threads, 0, s>>>(
        esf, seeds, codes, times, wf_in, wi_in, si_in, sf_in, wf_out, wi_out,
        si_out, sf_out, cells, W, w_f, B, R, F);
  else
    arrival_kernel<K, false><<<blocks, threads, 0, s>>>(
        esf, seeds, codes, times, wf_in, wi_in, si_in, sf_in, wf_out, wi_out,
        si_out, sf_out, cells, W, w_f, B, R, F);
  return cudaGetLastError();
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
  if (cells <= 0 || W <= 0 || W > kMaxW || w_f < 1 || w_f > W || B < 0
      || max_retries < 0 || max_failover < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARRIVAL_LAUNCH(K)                                                    \
  return static_cast<int>(launch_k<K>(                                       \
      esf, seeds, codes, times, wf_in, wi_in, si_in, sf_in, wf_out, wi_out,  \
      si_out, sf_out, cells, W, w_f, B, fail, max_retries, max_failover, s))
  switch ((W + 31) / 32) {
    case 1: ARRIVAL_LAUNCH(1);
    case 2: ARRIVAL_LAUNCH(2);
    case 3: ARRIVAL_LAUNCH(3);
    case 4: ARRIVAL_LAUNCH(4);
    case 5: ARRIVAL_LAUNCH(5);
    case 6: ARRIVAL_LAUNCH(6);
    case 7: ARRIVAL_LAUNCH(7);
    default: ARRIVAL_LAUNCH(8);
  }
#undef ARRIVAL_LAUNCH
}

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
// What bounded the first design. One thread per destination walked every
// source, in a grid of ceil(N/128) x B blocks. The DP's dense run launches
// it at 21 (B, N) buckets with B from 2 to 120: 8 to 238 blocks, fewer than
// the card's 132 SMs in all but one bucket, one warp per scheduler or less,
// so every dependent instruction's latency showed and the time grew with N
// alone.
//
// Design. The source axis is split into contiguous slices of slice_len
// sources, a multiple of 8. One warp scans one slice for 32 x D
// destinations (D = 1, 2 or 4 consecutive destinations a lane); a block is
// W <= 32 warps on W consecutive slices of one destination tile, and a
// thread block cluster of C <= 8 blocks (Hopper) covers the tile's next
// W x C slices. ops.dense_split picks (D, W, C, slice_len) from (B, N)
// alone: of the splits that put at least 8 warps on each of the 132 SMs,
// the one a cost model fitted on the card rates fastest. Each warp stages
// up to 256 sources at a time, (F, u) interleaved, in its own shared memory
// (all loads issued before the first is used, no block barrier in the
// loop), with each group of 8's range of u, and walks the groups: one
// 4 x 16-byte broadcast read feeds 8 x D pairs, D independent chains a
// source.
//
// Combine, exactly. A warp keeps, per destination, the running minimum of
// each group (fminf) and the first group whose minimum is strictly below
// the best so far; at the end it evaluates that group again, in order
// (from the stage when the slice was one tile), and takes the first source
// whose value equals the minimum: this is (value, first argmin) of a
// sequential scan with a strict <. The warps' pairs then meet in slice
// order with a strict < through shared memory, and the cluster's blocks'
// pairs in block-rank order through distributed shared memory: any split
// gives the unsplit scan's pairs bit for bit. No atomics, no scratch in
// device memory, one launch. A cluster costs its barriers (~0.3 us a
// block), so the split takes one only where one block of 32 warps cannot
// reach 8 warps a SM.
//
// Fewer instructions per pair, exactly. For a row whose four coefficients
// have the sign bit clear and are finite (the DP's rows: _churn_coeffs
// builds them from weighted energies and costs), exactly one of (j-i)+ and
// (i-j)+ is nonzero, and likewise for v-u; c*(+0) = +0 and x + (+0) = x for
// x >= +0, so the plain version's four-term sum equals, bit for bit,
//   T = c_I*|j-i| + c_Y*|v-u|,  c_I = j > i ? af : df,  c_Y = v > u ? ac : dc.
// The index term depends on j - i alone: a lane's D x 8 pairs of one group
// have D + 7 distinct differences, and it computes that many products, with
// c_I fixed for a group wholly below or above the warp's destinations.
// c_Y is fixed for a lane whose v all lie on one side of the group's u
// range (the monotone y_c of the DP: most lane-groups): then a pair costs
// v - u, a product, two sums and a minimum. A row with a negative, -0 or
// non-finite coefficient keeps the four-term form in the plain version's
// order; the choice is per row, so per block.
//
// Rounding. Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn): nvcc would otherwise contract a*b+c into an FMA, whose single
// rounding differs from the plain version's (repro_torch.core.dp.
// minplus_step, the port of minplus_step_jnp) and can flip an argmin at a
// near-tie. Values and argmins are bitwise the plain version's.
//
// Bound. Per pair the two-term form needs 5 fp32 operations where c_Y is
// fixed and 7 where a compare and a select pick it; the four-term form 10
// (two differences, two relus, two products, three sums, a minimum).
// Bytes are 5 words per (row, level), so operations bound it. The kernel
// issues ~6.5 instructions a pair on fixed-sign groups (D = 4) and ~8.4
// elsewhere, at ~1.5 cycles an instruction a scheduler when the SMs are
// full.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 8;          // sources a warp takes per step
constexpr int kTile = 256;         // sources a warp stages at a time
constexpr int kMaxWarps = 32;      // slices per block, one warp each
constexpr int kMaxCluster = 8;     // blocks per cluster (the portable limit)
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

struct Coeffs {
  float af, df, ac, dc;
};

// The index part of T for d = j - i and e = i - j (exact integers): the
// plain version's af*(d)+ + df*(e)+, or c_I*|d| on the two-term form.
template <bool kFast>
__device__ __forceinline__ float index_term(float d, float e, const Coeffs& c) {
  if (kFast) return mul(d > 0.0f ? c.af : c.df, fabsf(d));
  return add(mul(c.af, relu(d)), mul(c.df, relu(e)));
}

// F(i) + T(i, j) given the index part a of T.
template <bool kFast>
__device__ __forceinline__ float pair_value(float f, float u, float v, float a,
                                            const Coeffs& c) {
  if (kFast) {
    const float dv = sub(v, u);
    return add(f, add(a, mul(dv > 0.0f ? c.ac : c.dc, fabsf(dv))));
  }
  float t = add(a, mul(c.ac, relu(sub(v, u))));
  t = add(t, mul(c.dc, relu(sub(u, v))));
  return add(f, t);
}

// Stage sources [base, min(base + len, s1)) of a row as (F, u) pairs, and
// (+inf, 0), which is never a minimum, up to the next multiple of 8; and
// each group of 8's (min u, max u) over its real sources in meta. Every
// load of the tile goes out before the first is used: one wait on device
// memory a tile.
__device__ __forceinline__ void stage_tile(float2* stage, float2* meta,
                                           const float* __restrict__ Frow,
                                           const float* __restrict__ urow,
                                           int base, int s1, int len) {
  constexpr int kRounds = kTile / 32;
  const int lane = threadIdx.x & 31;
  const int padded = (min(len, s1 - base) + kGroup - 1) / kGroup * kGroup;
  float f[kRounds], u[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = base + r * 32 + lane;
    f[r] = CUDART_INF_F;
    u[r] = 0.0f;
    if (r * 32 < padded && i < s1) {
      f[r] = Frow[i];
      u[r] = urow[i];
    }
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (r * 32 >= padded) break;          // warp-uniform
    const int q = r * 32 + lane;
    const bool real = base + q < s1;
    float lo = real ? u[r] : CUDART_INF_F, hi = real ? u[r] : -CUDART_INF_F;
    if (q < padded) stage[q] = make_float2(f[r], u[r]);
#pragma unroll
    for (int o = 1; o < kGroup; o <<= 1) {
      lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
    }
    if (q < padded && lane % kGroup == 0) meta[q / kGroup] = make_float2(lo, hi);
  }
}

// The 8 x D pairs of one group, given their index parts a: each
// destination's group minimum and, where it is strictly below the running
// one, the group's first source. Sources outer, destinations inner: D
// independent chains a source. kYFixed: every pair's v - u has one sign
// (the lane checked), and cy is its coefficient.
template <int D, bool kFast, bool kYFixed>
__device__ __forceinline__ void group_pairs(
    const float (&fu)[2 * kGroup], const float* a, const float (&vj)[D],
    const Coeffs& c, float cy, int i0, float (&best)[D], int (&bg)[D]) {
  float gm[D];
#pragma unroll
  for (int t = 0; t < kGroup; ++t) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float av = a[k - t + kGroup - 1];
      const float m =
          kYFixed ? add(fu[2 * t],
                        add(av, mul(cy, fabsf(sub(vj[k], fu[2 * t + 1])))))
                  : pair_value<kFast>(fu[2 * t], fu[2 * t + 1], vj[k], av, c);
      gm[k] = t == 0 ? m : fminf(gm[k], m);
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (gm[k] < best[k]) {                // strict: the first group wins
      best[k] = gm[k];
      bg[k] = i0;
    }
  }
}

// One warp's slice [s0, s1) of sources for its lane's D destinations
// j0 .. j0+D-1, whose first tile of stage_len sources is staged: returns
// each destination's (value, first argmin) over the slice, or (+inf, s0)
// where no source is below +inf.
template <int D, bool kFast>
__device__ __forceinline__ void scan_slice(
    float2* stage, float2* meta, int stage_len, const float* __restrict__ Frow,
    const float* __restrict__ urow, int s0, int s1, int tile_base, int j0,
    const float (&vj)[D], float vmin, float vmax, const Coeffs& c,
    float (&rv)[D], int (&ri)[D]) {
  const int jmin = tile_base, jmax = tile_base + 32 * D - 1;
  const float jf0 = static_cast<float>(j0);
  float best[D];
  int bg[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    best[k] = CUDART_INF_F;
    bg[k] = -1;
  }
  for (int base = s0; base < s1; base += stage_len) {
    if (base != s0) {
      __syncwarp();                       // the previous tile is consumed
      stage_tile(stage, meta, Frow, urow, base, s1, stage_len);
    }
    __syncwarp();
    const int count = min(stage_len, s1 - base);
    for (int g = 0; g < count; g += kGroup) {
      const int i0 = base + g;
      float fu[2 * kGroup];
      const float4* s4 = reinterpret_cast<const float4*>(stage + g);
#pragma unroll
      for (int q = 0; q < kGroup / 2; ++q) {
        const float4 x = s4[q];
        fu[4 * q + 0] = x.x;
        fu[4 * q + 1] = x.y;
        fu[4 * q + 2] = x.z;
        fu[4 * q + 3] = x.w;
      }
      // a[x]: index part for j - i = dj + x - 7, x = k - t + 7
      constexpr int kDiffs = D + kGroup - 1;
      const float dj = sub(jf0, static_cast<float>(i0));
      float a[kDiffs];
      if (kFast) {
        // c_I is one coefficient for a group wholly below (j > i) or
        // above (j < i) the warp's destinations (warp-uniform), and c_Y for
        // a lane whose v are all on one side of the group's u
        const float2 ur = meta[g / kGroup];
        const bool y_up = vmin >= ur.y;
        const bool y_fixed = y_up | (vmax <= ur.x);
        const float cy = y_up ? c.ac : c.dc;
        if (i0 + kGroup - 1 < jmin || i0 > jmax) {
          const float ci = i0 > jmax ? c.df : c.af;
#pragma unroll
          for (int x = 0; x < kDiffs; ++x)
            a[x] = mul(ci, fabsf(add(dj, static_cast<float>(x - kGroup + 1))));
        } else {
#pragma unroll
          for (int x = 0; x < kDiffs; ++x)
            a[x] = index_term<true>(
                add(dj, static_cast<float>(x - kGroup + 1)), 0.0f, c);
        }
        if (y_fixed)
          group_pairs<D, true, true>(fu, a, vj, c, cy, i0, best, bg);
        else
          group_pairs<D, true, false>(fu, a, vj, c, cy, i0, best, bg);
      } else {
        const float ei = sub(static_cast<float>(i0), jf0);
#pragma unroll
        for (int x = 0; x < kDiffs; ++x) {
          const float off = static_cast<float>(x - kGroup + 1);
          a[x] = index_term<false>(add(dj, off), sub(ei, off), c);
        }
        group_pairs<D, false, false>(fu, a, vj, c, 0.0f, i0, best, bg);
      }
    }
  }
  // the first source of the recorded group whose value is the minimum:
  // from the stage when the slice was one tile, else from device memory
  const bool staged = s1 - s0 <= stage_len;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    rv[k] = CUDART_INF_F;
    ri[k] = s0;
    if (bg[k] >= 0) {
      const float jf = static_cast<float>(j0 + k);
      float m[kGroup];
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        const int i = bg[k] + t;
        float2 x;
        if (staged)
          x = stage[i - s0];
        else
          x = i < s1 ? make_float2(Frow[i], urow[i])
                     : make_float2(CUDART_INF_F, 0.0f);
        const float fi = static_cast<float>(i);
        m[t] = pair_value<kFast>(x.x, x.y, vj[k],
                                 index_term<kFast>(sub(jf, fi), sub(fi, jf), c),
                                 c);
      }
#pragma unroll
      for (int t = kGroup - 1; t >= 0; --t) {
        if (m[t] == best[k]) {
          rv[k] = m[t];
          ri[k] = bg[k] + t;
        }
      }
    }
  }
}

// grid (destination tiles x cluster, rows), cluster (cluster, 1, 1),
// 32 x warps threads: block rank r of a tile's cluster scans slices
// r*warps .. r*warps + warps - 1, one a warp. Dynamic shared memory (the
// same layout in every block, which distributed shared memory relies
// on): each warp's stage of min(slice_len, kTile) (F, u) pairs, its
// groups' u ranges, then the warps' (value, index) pairs, then the
// block's.
template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
minplus_dense_kernel(const float* __restrict__ F,
                     const float* __restrict__ ycp,
                     const float* __restrict__ ycc,
                     const float* __restrict__ coeffs,
                     float* __restrict__ out, int* __restrict__ arg, int n,
                     int slice_len, int cluster) {
  extern __shared__ __align__(16) float2 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int stage_len = min(slice_len, kTile);
  float2* stage = smem + warp * stage_len;
  float2* meta = smem + warps * stage_len + warp * (stage_len / kGroup);
  float* part_v = reinterpret_cast<float*>(
      smem + warps * (stage_len + stage_len / kGroup));
  int* part_i = reinterpret_cast<int*>(part_v + warps * 32 * D);
  float* blk_v = reinterpret_cast<float*>(part_i + warps * 32 * D);
  int* blk_i = reinterpret_cast<int*>(blk_v + 32 * D);

  const int rank = blockIdx.x % cluster;
  const int tile_base = blockIdx.x / cluster * 32 * D;
  const size_t row = static_cast<size_t>(blockIdx.y) * n;
  const int slice = rank * warps + warp;
  const int s0 = min(slice * slice_len, n), s1 = min(s0 + slice_len, n);
  // the first tile's loads go out with the coefficients' and v's
  stage_tile(stage, meta, F + row, ycp + row, s0, s1, stage_len);
  const float* cr = coeffs + 4 * static_cast<size_t>(blockIdx.y);
  const Coeffs c = {cr[0], cr[1], cr[2], cr[3]};
  // sign bit clear and finite: the two-term form is exact
  const bool fast = (__float_as_uint(c.af) < 0x7f800000u)
      & (__float_as_uint(c.df) < 0x7f800000u)
      & (__float_as_uint(c.ac) < 0x7f800000u)
      & (__float_as_uint(c.dc) < 0x7f800000u);
  const int j0 = tile_base + lane * D;
  float vj[D];
  float vmin = CUDART_INF_F, vmax = -CUDART_INF_F;  // over real destinations
#pragma unroll
  for (int k = 0; k < D; ++k) {
    vj[k] = j0 + k < n ? ycc[row + j0 + k] : 0.0f;
    if (j0 + k < n) {
      vmin = fminf(vmin, vj[k]);
      vmax = fmaxf(vmax, vj[k]);
    }
  }

  float rv[D];
  int ri[D];
  if (fast)
    scan_slice<D, true>(stage, meta, stage_len, F + row, ycp + row, s0, s1,
                        tile_base, j0, vj, vmin, vmax, c, rv, ri);
  else
    scan_slice<D, false>(stage, meta, stage_len, F + row, ycp + row, s0,
                         s1, tile_base, j0, vj, vmin, vmax, c, rv, ri);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    part_v[warp * 32 * D + lane * D + k] = rv[k];
    part_i[warp * 32 * D + lane * D + k] = ri[k];
  }
  __syncthreads();

  // the block's slices in order; strict < keeps the first minimizer
  for (int d = threadIdx.x; d < 32 * D; d += blockDim.x) {
    float v = part_v[d];
    int i = part_i[d];
    for (int w = 1; w < warps; ++w) {
      if (part_v[w * 32 * D + d] < v) {
        v = part_v[w * 32 * D + d];
        i = part_i[w * 32 * D + d];
      }
    }
    const int j = tile_base + d;
    if (cluster == 1) {
      if (j < n) {
        out[row + j] = v;
        arg[row + j] = i;
      }
    } else {
      blk_v[d] = v;
      blk_i[d] = i;
    }
  }
  if (cluster == 1) return;

  // the cluster's blocks in rank order, through distributed shared memory;
  // block r writes the destinations d = r mod cluster
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  for (int d = rank + cluster * static_cast<int>(threadIdx.x); d < 32 * D;
       d += cluster * blockDim.x) {
    float vs[kMaxCluster];
    int is[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < cluster) {
        vs[q] = cl.map_shared_rank(blk_v, q)[d];
        is[q] = cl.map_shared_rank(blk_i, q)[d];
      }
    }
    float v = vs[0];
    int i = is[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) {
      if (q < cluster && vs[q] < v) {
        v = vs[q];
        i = is[q];
      }
    }
    const int j = tile_base + d;
    if (j < n) {
      out[row + j] = v;
      arg[row + j] = i;
    }
  }
  cl.sync();                  // no block leaves while its memory is read
}

template <int D>
cudaError_t launch(cudaLaunchConfig_t cfg, const float* F, const float* ycp,
                   const float* ycc, const float* coeffs, float* out, int* arg,
                   int n, int slice_len, int cluster) {
  static bool configured[kMaxDevices] = {};
  const int warps = static_cast<int>(cfg.blockDim.x) / 32;
  const int stage_len = min(slice_len, kTile);
  cfg.dynamicSmemBytes = sizeof(float2) * (
      warps * (stage_len + stage_len / kGroup) + (warps + 1) * 32 * D);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device]) {              // outside any stream capture
    err = cudaFuncSetAttribute(minplus_dense_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        minplus_dense_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float2)) * (kMaxWarps * (kTile + kTile / kGroup)
                                            + (kMaxWarps + 1) * 32 * D));
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  return cudaLaunchKernelEx(&cfg, minplus_dense_kernel<D>, F, ycp, ycc,
                            coeffs, out, arg, n, slice_len, cluster);
}

}  // namespace

// F, ycp, ycc, out, arg: (batch, n) row-major; coeffs: (batch, 4) as
// (af, df, ac, dc). The split (ops.dense_split): dests
// destinations a lane (1, 2 or 4), warps slices a block (1..32), cluster
// blocks a cluster (1..8), slice_len sources a slice (a positive multiple
// of 8), warps x cluster x slice_len >= n. Launches on ``stream``; returns
// the CUDA error code of the launch (0 on success). Does not synchronise.
extern "C" int minplus_launch(const float* F, const float* ycp,
                              const float* ycc, const float* coeffs,
                              float* out, int* arg, int batch, int n,
                              int dests, int warps, int cluster, int slice_len,
                              void* stream) {
  if (n < 1 || batch < 1 || warps < 1 || warps > kMaxWarps || cluster < 1
      || cluster > kMaxCluster || slice_len < kGroup
      || slice_len % kGroup != 0
      || static_cast<long long>(warps) * cluster * slice_len < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + 32 * dests - 1) / (32 * dests);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster, batch, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  switch (dests) {
    case 1: err = launch<1>(cfg, F, ycp, ycc, coeffs, out, arg, n, slice_len, cluster); break;
    case 2: err = launch<2>(cfg, F, ycp, ycc, coeffs, out, arg, n, slice_len, cluster); break;
    case 4: err = launch<4>(cfg, F, ycp, ycc, coeffs, out, arg, n, slice_len, cluster); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

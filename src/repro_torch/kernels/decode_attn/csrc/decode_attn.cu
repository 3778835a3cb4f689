// decode_attn: GQA flash-decode, one query token per row against a KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn/decode_attn.py
// (decode_attention_pallas; pallas_call at line 92). For every row b and
// every query head of the G that share KV head h:
//
//   out[b, h*G + g] = softmax_s( (q[b, h*G + g] * D^-0.5) . k[b, s, h] )
//                     @ v[b, s, h],     over the positions s < lengths[b]
//
// in float32 whatever the storage type, written back in q's type. A row of
// length 0 gives exact zeros; lengths above S count as S. When the caller
// passes an lse buffer (B, Hq) float32, the kernel that finishes a row also
// writes lse[b, h*G + g] = m + log(l), the log-sum-exp of the row's scaled
// scores (its running max m and normalizer l), or -inf for a row of length
// 0: the weight by which the tensor-parallel decode combines the outputs of
// the pieces of a sequence-sharded cache. It costs one float per row and
// head; with a null lse nothing else changes.
//
// Design (split-sequence flash-decoding). The TPU kernel walks a
// sequential grid axis over sequence blocks and carries the running max,
// normalizer and accumulator in VMEM scratch from one grid step to the
// next. Blocks on Hopper run in no order, so the positions of each (row, KV
// head) are cut into chunks of kChunk positions and one thread block owns
// one chunk: the grid is (B * Hkv) x ceil(S / kChunk) x ceil(G / GB), and
// a block whose chunk starts at or past its row's length exits at once.
// Inside a block each of its 16 warps (8 for float32 at D = 256) takes
// every 16th group of 4 positions of the chunk and keeps an online softmax
// of its own in registers. A warp stages its groups' key and value rows in
// a ring of shared memory of its own with cp.async (16 bytes a lane, 2 to
// 8 stages of 4 KB or less): the next stages' loads are in flight while it
// reduces the current one, and only __syncwarp orders the ring. A position
// past the chunk's valid end stages the last valid row (in bounds) and is
// masked. Lane l holds elements [l*DV, (l+1)*DV) of each key, value, query
// and accumulator row (DV = D/32 at D = 64, 128, 256; 2 at D = 56, on 28
// lanes; 1 below D = 32, the other lanes holding zeros). The G query rows
// are held in registers, up to 4 at a time (GB); a larger G is split over
// the grid's third axis. The 4 x GB dot products of a group are summed
// over the warp together (warp_sums: 2N - 1 + log2(32/N) shuffles for N
// sums, not 5N), and the softmax uses the fast exponential (ex2.approx
// with a multiply). At the end the warps' partial results are combined
// through shared memory (over the rings) in warp order. When S <= kChunk
// there is one chunk and the block writes out directly. Otherwise each
// block writes its chunk's (max, normalizer, accumulator) in float32 to a
// workspace, and a second kernel combines a row's valid chunks in chunk
// order and writes out. The chunking depends on S alone and every order is
// fixed, so a row's result depends only on its own q, K, V and length.
//
// kChunk = 1024: the serving engine's caches (S = 1024 at the serve shape)
// stay one pass with no combine and no workspace, and a 32k cache still
// gives 32 chunks a row (2048 blocks at B = 8, Hkv = 8). Ring, warps and
// chunk were chosen by timing variants at the serve shape, S = 4096 and S
// = 32768 on the card (PERF.md).
//
// Bound. The work is bytes: each valid K and V element is read once (2
// flops per element and query head, G = 2 at the main shape, against the
// card's ~20 flops per byte of float32 balance), plus the workspace (G *
// (D + 2) floats per chunk and query head, written and read once: 0.8 % of
// the cache bytes at D = 128, G = 2, bf16). At D = 128 in bf16 a block's
// rings take 64 KB, so an SM holds several blocks, and the chunks give
// every SM blocks to run: the loads in flight, not the issue of one warp,
// set the rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kChunk = 1024;                // positions of a row per block
constexpr int kGroup = 4;                   // positions a warp takes at once
constexpr int kRingBytes = 4096;            // a warp's staging ring
constexpr int kBlockRing = 128 * 1024;      // a block's rings, at most
constexpr int kCombineThreads = 256;

// Elements of a row per lane: the fewest (1, 2, 4 or 8) that divide D and
// leave at most 32 lanes.
constexpr int lane_elems(int d) {
  return d <= 32 ? 1 : (d % 2 == 0 && d / 2 <= 32) ? 2
       : (d % 4 == 0 && d / 4 <= 32) ? 4 : 8;
}

template <typename T, int D>
struct Layout {
  static constexpr int kDV = lane_elems(D);
  static constexpr int kLanes = D / kDV;    // lanes that hold a row
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kPieces = kRowBytes / 16;      // 16-byte copies a row
  static constexpr int kStageBytes = 2 * kGroup * kRowBytes;
  static constexpr int kStages = kRingBytes / kStageBytes < 2 ? 2
                               : kRingBytes / kStageBytes > 8 ? 8
                               : kRingBytes / kStageBytes;
  // 16 warps a block, or 8 where 16 rings of two stages do not fit
  static constexpr int kWarps =
      16 * kStages * kStageBytes <= kBlockRing ? 16 : 8;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kSmem = kWarps * kStages * kStageBytes;
  static_assert(D % kDV == 0 && kLanes <= 32, "D/DV lanes, at most 32");
  static_assert(kRowBytes % 16 == 0, "rows of whole 16-byte pieces");
};

// v[j] <- its sum over the warp, for N (a power of two up to 32) values at
// once: halving exchanges (lane bit 32h/N decides which half of the h-wide
// window a lane keeps) leave lane l with the sum of value l / (32 / N) over
// its 32 / N-lane group, then a butterfly over that group and one shuffle
// a value bring every sum to every lane: 2N - 1 + log2(32 / N) shuffles in
// place of 5N.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N: 1 .. 32");
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = N / 2; h >= 1; h >>= 1) {
    const bool upper = lane & (32 * h / N);
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float send = upper ? v[j] : v[j + h];
      const float keep = upper ? v[j + h] : v[j];
      v[j] = keep + __shfl_xor_sync(kAll, send, 32 * h / N);
    }
  }
#pragma unroll
  for (int o = 16 / N; o >= 1; o >>= 1) v[0] += __shfl_xor_sync(kAll, v[0], o);
  const float mine = v[0];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = __shfl_sync(kAll, mine, j * (32 / N));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// N consecutive elements at p (aligned to N elements) as floats.
template <int N>
__device__ __forceinline__ void load(const float* p, float (&out)[N]) {
  static_assert(N == 1 || N == 2 || N == 4 || N == 8, "1, 2, 4 or 8");
  if constexpr (N == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

// bfloat16 is the upper half of a float32: widening is a shift, exact.
__device__ __forceinline__ float lo_bf16(unsigned int w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&out)[N]) {
  static_assert(N == 1 || N == 2 || N == 4 || N == 8, "1, 2, 4 or 8");
  if constexpr (N == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    out[0] = lo_bf16(t.x); out[1] = hi_bf16(t.x);
    out[2] = lo_bf16(t.y); out[3] = hi_bf16(t.y);
    out[4] = lo_bf16(t.z); out[5] = hi_bf16(t.z);
    out[6] = lo_bf16(t.w); out[7] = hi_bf16(t.w);
  } else if constexpr (N == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    out[0] = lo_bf16(t.x); out[1] = hi_bf16(t.x);
    out[2] = lo_bf16(t.y); out[3] = hi_bf16(t.y);
  } else if constexpr (N == 2) {
    const unsigned int t = *reinterpret_cast<const unsigned int*>(p);
    out[0] = lo_bf16(t); out[1] = hi_bf16(t);
  } else {
    out[0] = lo_bf16(*reinterpret_cast<const unsigned short*>(p));
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);              // round to nearest even, as torch
}

template <typename T, int D, int GB>
__global__ void __launch_bounds__(Layout<T, D>::kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ out, float* __restrict__ lse,
                   float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                   int s_len, int hkv, int g_size, int n_chunks,
                   float scale) {
  using L = Layout<T, D>;
  constexpr int DV = L::kDV;
  constexpr int kWarps = L::kWarps;
  extern __shared__ __align__(16) unsigned char s_ring[];
  __shared__ float s_m[kWarps][GB];         // each warp's running max,
  __shared__ float s_l[kWarps][GB];         // normalizer
  // and accumulator, over the rings once every warp is done with its own
  float (*s_acc)[GB][D] = reinterpret_cast<float (*)[GB][D]>(s_ring);
  static_assert(kWarps * GB * D * 4 <= Layout<T, D>::kSmem, "fits the ring");

  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x - b * hkv;
  const int chunk = blockIdx.y;
  const int n = min(max(lengths[b], 0), s_len);
  const int start = chunk * kChunk;
  if (n_chunks > 1 && start >= n) return;   // past the row: the combine
                                            // reads only valid chunks
  const int end = min(start + kChunk, n);   // one chunk: may be 0
  const int groups = (max(end - start, 0) + kGroup - 1) / kGroup;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = lane < L::kLanes;
  const int hq = hkv * g_size;
  const size_t row = static_cast<size_t>(hkv) * D;    // elements a position
  const size_t kv0 = static_cast<size_t>(b) * s_len * row
                     + static_cast<size_t>(h) * D;
  const int mine = warp < groups ? (groups - warp + kWarps - 1) / kWarps : 0;
  unsigned char* ring = s_ring + warp * L::kStages * L::kStageBytes;

  // this warp's i-th group (positions s0 .. s0 + 3 of the chunk) into stage
  // i % kStages: its 4 key rows, then its 4 value rows
  auto stage_group = [&](int i) {
    const int s0 = start + (warp + i * kWarps) * kGroup;
    unsigned char* st = ring + (i % L::kStages) * L::kStageBytes;
#pragma unroll
    for (int c = lane; c < 2 * kGroup * L::kPieces; c += 32) {
      const int which = c / (kGroup * L::kPieces);
      const int u = (c - which * kGroup * L::kPieces) / L::kPieces;
      const int piece = c - (which * kGroup + u) * L::kPieces;
      const int pos = min(s0 + u, end - 1);
      const T* src = (which ? v : k) + kv0 + static_cast<size_t>(pos) * row
                     + piece * (16 / static_cast<int>(sizeof(T)));
      cp_async16(st + c * 16, src);
    }
  };

  const int g0 = blockIdx.z * GB;
  const int gn = min(GB, g_size - g0);
  const size_t q0 = (static_cast<size_t>(b) * hq + h * g_size + g0) * D;
  float qr[GB][DV];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < gn && active) {
      load(q + q0 + g * D + lane * DV, qr[g]);
#pragma unroll
      for (int i = 0; i < DV; ++i) qr[g][i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < DV; ++i) qr[g][i] = 0.0f;
    }
  }
  float m[GB], l[GB], acc[GB][DV];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < DV; ++i) acc[g][i] = 0.0f;
  }

#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < mine) stage_group(i);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    if (i + L::kStages - 1 < mine) stage_group(i + L::kStages - 1);
    cp_async_commit();
    cp_async_wait<L::kStages - 1>();      // group i has landed
    __syncwarp();
    const T* ks = reinterpret_cast<const T*>(
        ring + (i % L::kStages) * L::kStageBytes);
    const T* vs = ks + kGroup * D;
    const int s0 = start + (warp + i * kWarps) * kGroup;
    float sc[GB * kGroup];                // score of (g, u) at g * 4 + u
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      float kr[DV];
      if (active) load(ks + u * D + lane * DV, kr);
      else {
#pragma unroll
        for (int e = 0; e < DV; ++e) kr[e] = 0.0f;
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < DV; ++e) part = fmaf(qr[g][e], kr[e], part);
        sc[g * kGroup + u] = part;
      }
    }
    warp_sums(sc);
    float p[GB][kGroup];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];                    // position s0 < end is valid
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (s0 + u < end) mx = fmaxf(mx, sc[g * kGroup + u]);
      const float alpha = __expf(m[g] - mx);        // 0 on the first step
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        p[g][u] = (s0 + u < end) ? __expf(sc[g * kGroup + u] - mx) : 0.0f;
        psum += p[g][u];
      }
      l[g] = fmaf(l[g], alpha, psum);
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[g][e] *= alpha;
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      float vr[DV];
      if (active) load(vs + u * D + lane * DV, vr);
      else {
#pragma unroll
        for (int e = 0; e < DV; ++e) vr[e] = 0.0f;
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
#pragma unroll
        for (int e = 0; e < DV; ++e)
          acc[g][e] = fmaf(p[g][u], vr[e], acc[g][e]);
      }
    }
    __syncwarp();                         // the stage may be refilled
  }
  cp_async_wait<0>();                     // (empty groups)
  __syncthreads();                        // every ring is free

  // combine the warps' partial softmaxes, in warp order
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
    if (active) {
#pragma unroll
      for (int e = 0; e < DV; ++e) s_acc[warp][g][lane * DV + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * D; idx += L::kThreads) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_m[w][g] != -CUDART_INF_F) {   // the warp saw a position
        const float f = expf(s_m[w][g] - mx);
        den = fmaf(s_l[w][g], f, den);
        num = fmaf(s_acc[w][g][d], f, num);
      }
    }
    if (n_chunks == 1) {
      store(out + q0 + idx, num / fmaxf(den, 1e-30f));
      if (lse != nullptr && d == 0)
        lse[q0 / D + g] = den > 0.0f ? mx + logf(den) : -CUDART_INF_F;
    } else {                              // this chunk's partial result
      const size_t part =
          (static_cast<size_t>(b) * hq + h * g_size + g0 + g) * n_chunks
          + chunk;
      ws_acc[part * D + d] = num;
      if (d == 0) {
        ws_ml[2 * part] = mx;
        ws_ml[2 * part + 1] = den;
      }
    }
  }
}

// out[b, j, d] from the valid chunks of row b (those that start below its
// length), in chunk order; a row of length 0 has none and gives 0.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_attn_combine(const float* __restrict__ ws_acc,
                    const float* __restrict__ ws_ml,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ lse, int hq, int d, int s_len,
                    int n_chunks, int total) {
  const int idx = blockIdx.x * kCombineThreads + threadIdx.x;
  if (idx >= total) return;
  const int bh = idx / d;
  const int e = idx - bh * d;
  const int n = min(max(lengths[bh / hq], 0), s_len);
  const int valid = (n + kChunk - 1) / kChunk;
  const float* ml = ws_ml + static_cast<size_t>(bh) * n_chunks * 2;
  const float* acc = ws_acc + static_cast<size_t>(bh) * n_chunks * d + e;
  float mx = -CUDART_INF_F;
  for (int c = 0; c < valid; ++c) mx = fmaxf(mx, ml[2 * c]);
  float den = 0.0f, num = 0.0f;
  for (int c = 0; c < valid; ++c) {
    const float f = expf(ml[2 * c] - mx);
    den = fmaf(ml[2 * c + 1], f, den);
    num = fmaf(acc[static_cast<size_t>(c) * d], f, num);
  }
  store(out + idx, num / fmaxf(den, 1e-30f));
  if (lse != nullptr && e == 0)
    lse[bh] = den > 0.0f ? mx + logf(den) : -CUDART_INF_F;
}

template <typename T, int D, int GB>
cudaError_t launch_gb(const T* q, const T* k, const T* v, const int* lengths,
                      T* out, float* lse, float* ws_acc, float* ws_ml,
                      int batch, int s_len, int hkv, int g_size,
                      int n_chunks, float scale, cudaStream_t stream) {
  constexpr int smem = Layout<T, D>::kSmem;
  const auto kernel = decode_attn_kernel<T, D, GB>;
  // the ring beside the static arrays may pass the default 48 KB
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  kernel<<<dim3(batch * hkv, n_chunks, (g_size + GB - 1) / GB),
           Layout<T, D>::kThreads,
           smem, stream>>>(
      q, k, v, lengths, out, lse, ws_acc, ws_ml, s_len, hkv, g_size,
      n_chunks, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, float* lse,
                     float* ws_acc, float* ws_ml, int batch, int s_len,
                     int hkv, int g_size, float scale, cudaStream_t stream) {
  const int n_chunks = s_len > kChunk ? (s_len + kChunk - 1) / kChunk : 1;
  if (n_chunks > 1 && (ws_acc == nullptr || ws_ml == nullptr))
    return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  cudaError_t rc;
  if (g_size == 1)
    rc = launch_gb<T, D, 1>(qt, kt, vt, lengths, ot, lse, ws_acc, ws_ml,
                            batch, s_len, hkv, g_size, n_chunks, scale,
                            stream);
  else if (g_size == 2)
    rc = launch_gb<T, D, 2>(qt, kt, vt, lengths, ot, lse, ws_acc, ws_ml,
                            batch, s_len, hkv, g_size, n_chunks, scale,
                            stream);
  else
    rc = launch_gb<T, D, 4>(qt, kt, vt, lengths, ot, lse, ws_acc, ws_ml,
                            batch, s_len, hkv, g_size, n_chunks, scale,
                            stream);
  if (rc != cudaSuccess || n_chunks == 1) return rc;
  const int total = batch * hkv * g_size * D;
  decode_attn_combine<T>
      <<<(total + kCombineThreads - 1) / kCombineThreads, kCombineThreads, 0,
         stream>>>(ws_acc, ws_ml, lengths, ot, lse, hkv * g_size, D, s_len,
                   n_chunks, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, float* lse,
                     float* ws_acc, float* ws_ml, int batch, int s_len,
                     int hkv, int g_size, int d, float scale,
                     cudaStream_t stream) {
#define DECODE_ATTN_D(D)                                                     \
  if (d == D)                                                                \
    return launch_d<T, D>(q, k, v, lengths, out, lse, ws_acc, ws_ml, batch,  \
                          s_len, hkv, g_size, scale, stream);
  DECODE_ATTN_D(16)
  DECODE_ATTN_D(56)
  DECODE_ATTN_D(64)
  DECODE_ATTN_D(128)
  DECODE_ATTN_D(256)
#undef DECODE_ATTN_D
  return cudaErrorInvalidValue;
}

}  // namespace

// Positions of a row that one block takes: a call with S above this
// launches a second, combining kernel and needs the workspace.
extern "C" int decode_attn_chunk(void) { return kChunk; }

// q, out: (batch, hkv * g_size, d); k, v: (batch, s_len, hkv, d), all
// row-major on the device in one type (dtype 0: float32, 1: bfloat16),
// 16-byte aligned; lengths: (batch,) int32; d in {16, 56, 64, 128, 256}.
// lse: null, or (batch, hkv * g_size) float32 for each row's log-sum-exp.
// ws_acc (batch, hkv * g_size, C, d) and ws_ml (batch, hkv * g_size, C, 2)
// float32, C = ceil(s_len / decode_attn_chunk()): the workspace, used (and
// required) only when C > 1. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const int* lengths, void* out,
                                  float* lse, float* ws_acc, float* ws_ml,
                                  int batch, int s_len, int hkv, int g_size,
                                  int d, int dtype, float scale,
                                  void* stream) {
  if (batch <= 0 || s_len < 0 || hkv <= 0 || g_size <= 0
      || s_len > 65535 * kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  if (dtype == 0)
    rc = launch_t<float>(q, k, v, lengths, out, lse, ws_acc, ws_ml, batch,
                         s_len, hkv, g_size, d, scale, st);
  else if (dtype == 1)
    rc = launch_t<__nv_bfloat16>(q, k, v, lengths, out, lse, ws_acc, ws_ml,
                                 batch, s_len, hkv, g_size, d, scale, st);
  return static_cast<int>(rc);
}

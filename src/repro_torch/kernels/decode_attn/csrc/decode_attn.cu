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
// length 0 gives exact zeros; lengths above S count as S.
//
// Design. The TPU kernel walks a sequential grid axis over sequence blocks
// and carries the running max, normalizer and accumulator in VMEM scratch
// from one grid step to the next. Blocks on Hopper run in no order, so one
// thread block owns one (row, KV head) pair and the carry lives in
// registers: each of its 8 warps takes every 8th group of 4 positions, up
// to the row's own length (the Pallas grid walks every block to the padded
// end; stopping at the length changes no result), and keeps an online
// softmax of its own. A warp issues the loads of its next group before the
// arithmetic of the current one, so 8 rows are in flight while it
// computes. Lane l holds elements [l*D/32, (l+1)*D/32) of each key, value,
// query and accumulator row, so a key or value row of the cache is read by
// one warp in one coalesced access (16 bytes a lane in float32 at D = 128,
// 8 in bf16; below D = 32 a lane holds one element and the lanes past D
// hold zeros). The G query rows are held in registers, up to 4 at a time
// (GB); a larger G takes several passes over the cache.
// At the end the 8 warps' partial results are combined through shared
// memory in warp order, so a result does not depend on timing.
//
// Bound. The work is bytes: each valid K and V element is read once (2
// flops per element and query head, G = 2 at the main shape, against the
// card's ~20 flops per byte of float32 balance). At the main path's shape
// (B = 8, Hkv = 8, D = 128, bf16) one launch moves ~0.5 MB per 128 cached
// positions of each row. Beyond the one group loaded ahead, the design does
// nothing yet about load latency, nor about the 64 blocks on 132 SMs that
// this shape gives: splitting the sequence across blocks with a combine
// pass (flash-decoding), and cp.async/TMA staging, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;                  // positions per warp per step

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// N consecutive elements at p (aligned to N elements) as floats, one access.
template <int N>
__device__ __forceinline__ void load(const float* p, float (&out)[N]) {
  static_assert(N == 1 || N == 2 || N == 4, "1, 2 or 4 elements a lane");
  if constexpr (N == 4) {
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
  static_assert(N == 1 || N == 2 || N == 4, "1, 2 or 4 elements a lane");
  if constexpr (N == 4) {
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

// The key and value rows of positions s0 .. s0 + kUnroll - 1 (each active
// lane its DV elements, an idle lane zeros), all loads issued together: a
// position at or past n reads row n - 1 instead (n >= 1).
template <typename T, int DV>
__device__ __forceinline__ void load_rows(const T* __restrict__ k,
                                          const T* __restrict__ v, size_t kv0,
                                          size_t row, int s0, int n,
                                          bool active,
                                          float (&kr)[kUnroll][DV],
                                          float (&vr)[kUnroll][DV]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const size_t at = kv0 + static_cast<size_t>(min(s0 + u, n - 1)) * row;
    if (active) {
      load(k + at, kr[u]);
      load(v + at, vr[u]);
    } else {
#pragma unroll
      for (int i = 0; i < DV; ++i) kr[u][i] = vr[u][i] = 0.0f;
    }
  }
}

template <typename T, int D, int GB>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ out, int s_len, int hkv, int g_size,
                   float scale) {
  constexpr int DV = D >= 32 ? D / 32 : 1;  // elements of a row per lane
  constexpr int kLanes = D / DV;            // lanes that hold a row (D < 32:
                                            // the others hold zeros)
  __shared__ float s_m[kWarps][GB];         // each warp's running max,
  __shared__ float s_l[kWarps][GB];         // normalizer
  __shared__ float s_acc[kWarps][GB][D];    // and accumulator

  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x - b * hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = lane < kLanes;
  const int hq = hkv * g_size;
  const int n = min(max(lengths[b], 0), s_len);
  const size_t row = static_cast<size_t>(hkv) * D;    // elements a position
  const size_t kv0 = static_cast<size_t>(b) * s_len * row
                     + static_cast<size_t>(h) * D + (active ? lane * DV : 0);

  for (int g0 = 0; g0 < g_size; g0 += GB) {
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

    // positions s0 .. s0 + kUnroll - 1 of this warp, the next group's rows
    // loaded before this group's arithmetic; a position past the length
    // reads the last valid row (in bounds) and is masked below
    constexpr int kStride = kWarps * kUnroll;
    float kr[kUnroll][DV], vr[kUnroll][DV];
    int s0 = warp * kUnroll;
    if (s0 < n) load_rows(k, v, kv0, row, s0, n, active, kr, vr);
    for (; s0 < n; s0 += kStride) {
      const bool more = s0 + kStride < n;
      float kn[kUnroll][DV], vn[kUnroll][DV];
      if (more) load_rows(k, v, kv0, row, s0 + kStride, n, active, kn, vn);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float sc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float part = 0.0f;
#pragma unroll
          for (int i = 0; i < DV; ++i) part = fmaf(qr[g][i], kr[u][i], part);
          sc[u] = warp_sum(part);
        }
        float mx = m[g];                    // position s0 < n is valid
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (s0 + u < n) mx = fmaxf(mx, sc[u]);
        const float alpha = expf(m[g] - mx);          // 0 on the first step
        float p[kUnroll];
        float psum = 0.0f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = (s0 + u < n) ? expf(sc[u] - mx) : 0.0f;
          psum += p[u];
        }
        l[g] = fmaf(l[g], alpha, psum);
#pragma unroll
        for (int i = 0; i < DV; ++i) {
          float a = acc[g][i] * alpha;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vr[u][i], a);
          acc[g][i] = a;
        }
        m[g] = mx;
      }
      if (more) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int i = 0; i < DV; ++i) {
            kr[u][i] = kn[u][i];
            vr[u][i] = vn[u][i];
          }
        }
      }
    }

    // combine the warps' partial softmaxes, in warp order
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (lane == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < DV; ++i) s_acc[warp][g][lane * DV + i] = acc[g][i];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < gn * D; idx += kThreads) {
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
      store(out + q0 + idx, num / fmaxf(den, 1e-30f));
    }
    __syncthreads();                        // s_* are reused by the next pass
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, int batch, int s_len,
                     int hkv, int g_size, float scale, cudaStream_t stream) {
  const dim3 grid(batch * hkv);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (g_size == 1) {
    decode_attn_kernel<T, D, 1><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, lengths, ot, s_len, hkv, g_size, scale);
  } else if (g_size == 2) {
    decode_attn_kernel<T, D, 2><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, lengths, ot, s_len, hkv, g_size, scale);
  } else {
    decode_attn_kernel<T, D, 4><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, lengths, ot, s_len, hkv, g_size, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* lengths, void* out, int batch, int s_len,
                     int hkv, int g_size, int d, float scale,
                     cudaStream_t stream) {
  if (d == 16)
    return launch_d<T, 16>(q, k, v, lengths, out, batch, s_len, hkv, g_size,
                           scale, stream);
  if (d == 64)
    return launch_d<T, 64>(q, k, v, lengths, out, batch, s_len, hkv, g_size,
                           scale, stream);
  if (d == 128)
    return launch_d<T, 128>(q, k, v, lengths, out, batch, s_len, hkv, g_size,
                            scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (batch, hkv * g_size, d); k, v: (batch, s_len, hkv, d), all
// row-major on the device in one type (dtype 0: float32, 1: bfloat16),
// 16-byte aligned; lengths: (batch,) int32; d in {16, 64, 128}.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const int* lengths, void* out, int batch,
                                  int s_len, int hkv, int g_size, int d,
                                  int dtype, float scale, void* stream) {
  if (batch <= 0 || s_len < 0 || hkv <= 0 || g_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  if (dtype == 0)
    rc = launch_t<float>(q, k, v, lengths, out, batch, s_len, hkv, g_size, d,
                         scale, st);
  else if (dtype == 1)
    rc = launch_t<__nv_bfloat16>(q, k, v, lengths, out, batch, s_len, hkv,
                                 g_size, d, scale, st);
  return static_cast<int>(rc);
}

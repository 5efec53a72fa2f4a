// Causal (optionally sliding-window) flash attention forward for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas, the
// Pallas TPU kernel of the prefill attention.
//
// What bounds it on the H100: operations. At gemma3-1b's prefill shapes
// (q 4x4x1024x256, k/v 4x1x1024x256, bf16) the causal product pairs need
// ~8.6 GFLOP against ~21 MB of inputs and output, about 400 FLOP per byte,
// above the card's ~295 FLOP/byte ridge for bf16 tensor cores.
//
// What this first version does about it: the simple, right design. One
// block of 128 threads per (query tile of 32 rows, head, batch). Q, K and V
// tiles live in shared memory as f32 (rows padded to an odd pitch so the 32
// lanes of a warp read 32 different K rows without bank conflicts). Scores
// and P @ V are scalar FMAs in f32; the online softmax keeps the running max
// and sum in f32, masks with -1e30 as the Pallas kernel does, and sets a
// masked probability to exactly 0. The block visits only the key tiles that
// its queries' causal window reaches; the Pallas kernel masks the others
// instead, which gives the same numbers because their probabilities are 0.
// GQA maps query head h to kv head h / (Hq / Hkv). The ragged edge (S not a
// multiple of 32) is masked; nothing is padded by the caller. A 32-row K
// plus V tile at head_dim 256 is 64 KB in f32, so the ~100 KB of shared
// memory is dynamic and raised with cudaFuncSetAttribute. Tensor cores
// (mma.sync / wgmma) and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;  // one key per lane in the softmax
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
struct Layout {
  static constexpr int kPitchQK = D + 1;
  static constexpr int kPitchP = kBlockK + 1;
  // P @ V: kColThreads threads across head_dim, kRowThreads groups down rows
  static constexpr int kColThreads = D < kThreads ? D : kThreads;
  static constexpr int kRowThreads = kThreads / kColThreads;
  static constexpr int kCols = D / kColThreads;        // columns per thread
  static constexpr int kRows = kBlockQ / kRowThreads;  // rows per thread
  static constexpr int kSRows = kBlockQ / kWarps;      // score rows per warp
  static constexpr int kFloats =
      (kBlockQ + kBlockK) * kPitchQK + kBlockK * D + kBlockQ * kPitchP + 2 * kBlockQ;
  static constexpr size_t kSmemBytes = sizeof(float) * kFloats;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                     int s, int window, float sm_scale) {
  using L = Layout<D>;
  static_assert(kBlockK == 32, "the softmax gives one key to each lane");
  static_assert(D % L::kColThreads == 0 && kBlockQ % L::kRowThreads == 0, "layout");

  extern __shared__ float smem[];
  float* qs = smem;                          // kBlockQ x kPitchQK
  float* ks = qs + kBlockQ * L::kPitchQK;    // kBlockK x kPitchQK
  float* vs = ks + kBlockK * L::kPitchQK;    // kBlockK x D
  float* ps = vs + kBlockK * D;              // kBlockQ x kPitchP
  float* corr_s = ps + kBlockQ * L::kPitchP; // kBlockQ
  float* l_s = corr_s + kBlockQ;             // kBlockQ

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const size_t q_off = ((size_t)b * hq + h) * (size_t)s * D;
  const size_t kv_off = ((size_t)b * hkv + hk) * (size_t)s * D;

  // Q tile, pre-scaled by sm_scale as the Pallas kernel does
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qp = q0 + r;
    qs[r * L::kPitchQK + c] = qp < s ? to_f32(q[q_off + (size_t)qp * D + c]) * sm_scale : 0.f;
  }

  float m_run[L::kSRows], l_run[L::kSRows];
#pragma unroll
  for (int i = 0; i < L::kSRows; ++i) {
    m_run[i] = kNeg;
    l_run[i] = 0.f;
  }
  float acc[L::kRows][L::kCols];
#pragma unroll
  for (int r = 0; r < L::kRows; ++r)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[r][c] = 0.f;

  const int col_t = tid % L::kColThreads;
  const int row_t = tid / L::kColThreads;

  // key tiles the block's causal (windowed) range reaches
  const int q_last = min(q0 + kBlockQ, s) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kBlockK;
  const int t_hi = q_last / kBlockK;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kp = k0 + r;
      const bool ok = kp < s;
      const size_t g = kv_off + (size_t)kp * D + c;
      ks[r * L::kPitchQK + c] = ok ? to_f32(k[g]) : 0.f;
      vs[r * D + c] = ok ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    // scores: warp w owns rows w, w + kWarps, ...; lane owns key k0 + lane
    float sc[L::kSRows];
#pragma unroll
    for (int i = 0; i < L::kSRows; ++i) sc[i] = 0.f;
    const float* krow = ks + lane * L::kPitchQK;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < L::kSRows; ++i)
        sc[i] = fmaf(qs[(warp + kWarps * i) * L::kPitchQK + d], kd, sc[i]);
    }

    // online softmax, one row at a time across the warp
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < L::kSRows; ++i) {
      const int row = warp + kWarps * i;
      const int qp = q0 + row;
      const bool vis = kp < s && kp <= qp && (window <= 0 || kp > qp - window);
      const float x = vis ? sc[i] : kNeg;
      const float m_new = fmaxf(m_run[i], warp_max(x));
      const float p = vis ? expf(x - m_new) : 0.f;
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = corr * l_run[i] + warp_sum(p);
      m_run[i] = m_new;
      ps[row * L::kPitchP + lane] = p;
      if (lane == 0) corr_s[row] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P @ V
#pragma unroll
    for (int r = 0; r < L::kRows; ++r) {
      const float cf = corr_s[row_t + L::kRowThreads * r];
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) acc[r][c] *= cf;
    }
    for (int j = 0; j < kBlockK; ++j) {
      float vv[L::kCols];
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) vv[c] = vs[j * D + col_t + L::kColThreads * c];
#pragma unroll
      for (int r = 0; r < L::kRows; ++r) {
        const float p = ps[(row_t + L::kRowThreads * r) * L::kPitchP + j];
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < L::kSRows; ++i) l_s[warp + kWarps * i] = l_run[i];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < L::kRows; ++r) {
    const int row = row_t + L::kRowThreads * r;
    const int qp = q0 + row;
    if (qp >= s) continue;
    const float l = l_s[row];
    const float safe_l = l > 0.f ? l : 1.f;
#pragma unroll
    for (int c = 0; c < L::kCols; ++c)
      store_as(&o[q_off + (size_t)qp * D + col_t + L::kColThreads * c], acc[r][c] / safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
                   int hkv, int s, int window, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kSmemBytes;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((s + kBlockQ - 1) / kBlockQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hkv, s, window, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
                       int hq, int hkv, int s, int d, int window, float sm_scale,
                       cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, s, window, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, s, window, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, s, window, sm_scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, b, hq, hkv, s, window, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, hq, s, d); k, v: (b, hkv, s, d); o: (b, hq, s, d); all contiguous,
// f32 (is_bf16 = 0) or bf16 (is_bf16 = 1). window <= 0 means no window.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int b, int hq, int hkv, int s, int d, int window,
                                   float sm_scale, int is_bf16, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || s <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, s, d,
                                                      window, sm_scale, st)
                          : dispatch_d<float>(q, k, v, o, b, hq, hkv, s, d, window,
                                              sm_scale, st);
  return (int)e;
}

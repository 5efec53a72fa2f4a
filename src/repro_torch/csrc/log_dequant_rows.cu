// Row-scaled log-quant dequant of the KV-cache read, as a table lookup.
//
// Replaces: src/repro/kernels/log_quant.py::log_dequantize_rows_pallas.
// (R, nbytes) int8 codes and (R, 1) f32 scales -> (R, d) f32 values
// sign(q) * expm1(|q| log1p(alpha)) / alpha * scale[row], q = code / L, with
// d = 2 nbytes for nibble-packed b <= 4 (byte i = code 2i | code 2i+1 << 4)
// and d = nbytes for one code a byte (b <= 8).
//
// What bounds it on the H100: bytes. Each code byte is read once and 4
// (one code) or 8 (two nibbles) bytes are written, against a handful of
// operations a value: far below the card's ~20 f32 FLOP/byte ridge. At a
// gemma3-1b decode layer (4224 rows) that is ~5.4 MB: 1.6 us at 3.35 TB/s.
//
// What the design does about it: a code takes only 256 byte values, so
// nothing transcendental runs per element. Each block fills a shared table
// with the value of every byte: one f32 at b > 4, and at b <= 4 a float2 of
// the byte's two nibbles (from the 16 nibble values), so one lookup gives
// both. An entry is computed with the operations, in the order, of the plain
// version and of the Triton kernel this one replaced (an IEEE division,
// expm1f, a multiply, an IEEE division), so every entry is the value that
// per-element code computed. Each thread loads 16 code bytes as one uint4,
// issued before the table is built so that the load's latency hides behind
// it, and parks them in shared memory. Then the warp turns its 512 code
// bytes into f32 in steps in which lane l takes 4 bytes (b > 4) or 2 bytes
// (b <= 4) at 4 l or 2 l: it looks them up, multiplies by their row's scale
// and writes one float4, so that each store instruction of the warp covers
// 512 contiguous bytes. Blocks are small (128 threads, 2 KB of codes) so
// that several share an SM. A row width that is a multiple of 16 bytes gives
// one row a vector, its scale read once; any other width finds the row of
// each byte, and the last n % 16 bytes of the array go one by one, in the
// same kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 16;  // code bytes a thread

__device__ __forceinline__ float log_value(int code, float alpha, float log1p_alpha,
                                           float levels) {
  const float q = __fdiv_rn((float)code, levels);
  const float mag = __fdiv_rn(expm1f(fabsf(q) * log1p_alpha), alpha);
  return q > 0.f ? mag : (q < 0.f ? -mag : 0.f);
}

__device__ __forceinline__ int nibble(int byte, int shift) {
  return (((byte >> shift) & 0xF) ^ 8) - 8;  // sign-extended 4-bit code
}

// Write the value(s) of byte `c` at flat byte index `idx`, scaled.
template <bool kPacked>
__device__ __forceinline__ void put_one(float* __restrict__ out, long long idx,
                                        const float* table, int c, float scale) {
  if (kPacked) {
    const float2 e = reinterpret_cast<const float2*>(table)[c];
    *reinterpret_cast<float2*>(out + 2 * idx) = make_float2(e.x * scale, e.y * scale);
  } else {
    out[idx] = table[c] * scale;
  }
}

template <bool kPacked, bool kRow16>
__global__ void __launch_bounds__(kThreads)
    log_dequant_rows_kernel(const uint8_t* __restrict__ codes,
                            const float* __restrict__ scales, float* __restrict__ out,
                            long long n, int nb, float alpha, float log1p_alpha,
                            float levels) {
  // byte value -> value (b > 4) or (low nibble, high nibble) values (b <= 4)
  __shared__ __align__(16) float table[kPacked ? 512 : 256];
  __shared__ float nibbles[16];
  __shared__ uint4 stage[kThreads];        // the block's code vectors
  __shared__ float stage_scale[kThreads];  // each vector's row scale (kRow16)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long v = (long long)blockIdx.x * kThreads + tid;
  const long long n_vec = n / kVec;

  // the loads first: their latency hides behind the table
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  float row_scale = 0.f;
  if (v < n_vec) {
    w = reinterpret_cast<const uint4*>(codes)[v];
    if (kRow16) row_scale = scales[v * kVec / nb];
  }
  if (kPacked) {
    if (tid < 16) nibbles[tid] = log_value(nibble(tid, 0), alpha, log1p_alpha, levels);
    __syncthreads();
    for (int c = tid; c < 256; c += kThreads) {
      table[2 * c] = nibbles[c & 0xF];
      table[2 * c + 1] = nibbles[c >> 4];
    }
  } else {
    for (int c = tid; c < 256; c += kThreads)
      table[c] = log_value((int)(int8_t)c, alpha, log1p_alpha, levels);
  }
  stage[tid] = w;
  stage_scale[tid] = row_scale;
  __syncthreads();

  // the warp's 32 vectors, 512 bytes from flat byte `wbase`; a step's bytes
  // lie wholly below or wholly past the last whole vector
  const long long n16 = n_vec * kVec;
  const long long wbase = (v - lane) * kVec;
  const float* wscale = stage_scale + warp * 32;
  if (kPacked) {
    const uint16_t* pairs = reinterpret_cast<const uint16_t*>(stage + warp * 32);
    const float2* table2 = reinterpret_cast<const float2*>(table);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int off = 64 * j + 2 * lane;
      const long long flat = wbase + off;
      if (flat >= n16) break;
      const int two = pairs[32 * j + lane];
      const float2 e0 = table2[two & 0xFF], e1 = table2[two >> 8];
      const float s0 = kRow16 ? wscale[off >> 4] : scales[flat / nb];
      const float s1 = kRow16 ? s0 : scales[(flat + 1) / nb];
      *reinterpret_cast<float4*>(out + 2 * flat) =
          make_float4(e0.x * s0, e0.y * s0, e1.x * s1, e1.y * s1);
    }
  } else {
    const uint32_t* quads = reinterpret_cast<const uint32_t*>(stage + warp * 32);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int off = 128 * j + 4 * lane;
      const long long flat = wbase + off;
      if (flat >= n16) break;
      const uint32_t four = quads[32 * j + lane];
      float val[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float s = kRow16 ? wscale[off >> 4] : scales[(flat + b) / nb];
        val[b] = table[(four >> (8 * b)) & 0xFF] * s;
      }
      *reinterpret_cast<float4*>(out + flat) = make_float4(val[0], val[1], val[2], val[3]);
    }
  }
  if (v == n_vec) {
    // the scalar tail: the last n % 16 bytes
    for (long long i = n16; i < n; ++i)
      put_one<kPacked>(out, i, table, codes[i], scales[i / nb]);
  }
}

template <bool kPacked, bool kRow16>
cudaError_t launch(const void* codes, const float* scales, float* out, long long n, int nb,
                   float alpha, float log1p_alpha, float levels, cudaStream_t stream) {
  // one thread a 16-byte vector, plus one for the tail
  const long long threads = n / kVec + 1;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  log_dequant_rows_kernel<kPacked, kRow16><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(codes), scales, out, n, nb, alpha, log1p_alpha, levels);
  return cudaGetLastError();
}

}  // namespace

// codes: (rows, nb) int8, contiguous, 16-byte aligned; scales: (rows,) f32;
// out: (rows, 2 nb) f32 if packed (b <= 4), else (rows, nb) f32.
extern "C" int log_dequant_rows(const void* codes, const void* scales, void* out,
                                long long rows, int nb, int packed, float alpha,
                                float log1p_alpha, float levels, void* stream) {
  if (rows <= 0 || nb <= 0 || (reinterpret_cast<uintptr_t>(codes) & 15))
    return (int)cudaErrorInvalidValue;
  const long long n = rows * nb;
  const float* s = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool row16 = nb % kVec == 0;
  cudaError_t e;
  if (packed)
    e = row16 ? launch<true, true>(codes, s, o, n, nb, alpha, log1p_alpha, levels, st)
              : launch<true, false>(codes, s, o, n, nb, alpha, log1p_alpha, levels, st);
  else
    e = row16 ? launch<false, true>(codes, s, o, n, nb, alpha, log1p_alpha, levels, st)
              : launch<false, false>(codes, s, o, n, nb, alpha, log1p_alpha, levels, st);
  return (int)e;
}

// Causal (optionally sliding-window) flash attention forward for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas, the
// Pallas TPU kernel of the prefill attention.
//
// What bounds it on the H100: operations. At gemma3-1b's prefill shapes
// (q 4x4x1024x256, k/v 4x1x1024x256, bf16) the causal product pairs need
// ~8.6 GFLOP against ~21 MB of inputs and output, about 400 FLOP per byte,
// above the card's ~295 FLOP/byte ridge for bf16 tensor cores. So the
// products belong on the tensor cores, fed from shared memory fast enough
// that they do not wait for the copies.
//
// What the bf16 kernel does about it. A block of 4 warps takes 64 query rows
// of one (batch, head); each warp owns 16 of them. The block's Q tile and a
// ring of two K/V stages live in shared memory in bf16, each row padded by
// 16 bytes so that the 8 rows one ldmatrix reads fall in 8 different bank
// groups. K/V tiles come in by cp.async, 16 bytes a thread, one tile ahead:
// tile t+1's copy is in flight while tile t is computed. S = Q K^T and
// O += P V are mma.sync m16n8k16 (bf16 in, f32 accumulate), the operands
// loaded with ldmatrix (V with ldmatrix.trans). The online softmax runs in
// f32 on the S fragments in registers: a row's max and sum span the four
// lanes of a quad (__shfl_xor_sync). P is rounded to bf16 for the P V
// product, and the row sum l adds the same rounded values, so numerator and
// denominator agree. Masked scores are -1e30 and their probability exactly
// 0; only the tiles on the diagonal, at the window's lower edge or past the
// ragged end need the element mask. The block visits only the key tiles its
// queries' causal window reaches (the Pallas kernel masks the others, which
// gives the same numbers). Key tiles are 64 rows at every head_dim: at
// head_dim 256 a warp holds 128 f32 of O and 32 of S a thread, and the ~165
// KB of shared memory (Q, two K and two V stages) is dynamic, raised with
// cudaFuncSetAttribute. MLA's prefill (deepseek-v3) runs at head_dim 192 =
// 12 x 16 (128 nope + 64 rope, V zero-padded to it): 96 f32 of O a thread
// and ~125 KB of shared memory. The last query tiles, which walk the most key
// tiles, are launched first, so the causal tail does not run alone in the
// last wave. GQA maps query head h to kv head h / (Hq / Hkv). The ragged edge
// (S not a multiple of 64) is zero-filled by cp.async and masked; nothing is
// padded by the caller. wgmma with TMA and warp specialisation is later
// work.
//
// The f32 instantiation, which no serving path runs, keeps the first
// version's scalar design: one block of 128 threads per 32-row query tile,
// Q, K and V in f32 shared memory, scores and P V by scalar FMA. Its P V
// step spreads head_dim over at most 128 threads, a split that divides it:
// all of it up to 128, 128 columns at 256, 64 at 192 (3 a thread).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

// ------------------------------------------------------------ bf16, mma.sync

constexpr int kBlockM = 64;  // query rows a block: 16 a warp
constexpr int kBlockN = 64;  // key rows a tile
constexpr int kStages = 2;

template <int D>
struct MmaLayout {
  static constexpr int kPitch = D + 8;  // bf16 a row: 16 bytes of padding
  static constexpr int kTileQ = kBlockM * kPitch;
  static constexpr int kTileKV = kBlockN * kPitch;
  static constexpr size_t kSmemBytes =
      sizeof(__nv_bfloat16) * (kTileQ + 2 * kStages * kTileKV);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-fills where !ok
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy rows [row0, row0 + rows) of a (s, D) bf16 matrix into a padded tile;
// rows at or past s are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int rows, int s) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = row0 + r < s;
    cp_async_16(dst + r * MmaLayout<D>::kPitch + c,
                src + (size_t)(ok ? row0 + r : 0) * D + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int hq, int hkv, int s, int window,
                         float scale_log2) {
  using L = MmaLayout<D>;
  constexpr int kP = L::kPitch;
  constexpr int kNS = kBlockN / 8;  // 8-key column blocks of S a warp holds
  constexpr int kNO = D / 8;        // 8-column blocks of O a warp holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + L::kTileQ;           // kStages x kBlockN x kP
  __nv_bfloat16* vs = ks + kStages * L::kTileKV;  // kStages x kBlockN x kP

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the fragment row (and row + 8) this lane holds
  const int t4 = lane & 3;  // ... and its column pair 2 t4, 2 t4 + 1
  const int h = blockIdx.x % hq;
  const int b = blockIdx.x / hq;
  const int m0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kBlockM;  // heaviest first
  const int hk = h / (hq / hkv);
  const size_t q_off = ((size_t)b * hq + h) * (size_t)s * D;
  const size_t kv_off = ((size_t)b * hkv + hk) * (size_t)s * D;
  const __nv_bfloat16* kg = k + kv_off;
  const __nv_bfloat16* vg = v + kv_off;

  // key tiles the block's causal (windowed) range reaches
  const int q_last = min(m0 + kBlockM, s) - 1;
  const int k_lo = window > 0 ? max(0, m0 - window + 1) : 0;
  const int t_lo = k_lo / kBlockN;
  const int n_tiles = q_last / kBlockN - t_lo + 1;

  // group 0: Q and the first K/V tile; group 1: the second K/V tile (or none)
  load_tile<D>(qs, q + q_off, m0, kBlockM, s);
  load_tile<D>(ks, kg, t_lo * kBlockN, kBlockN, s);
  load_tile<D>(vs, vg, t_lo * kBlockN, kBlockN, s);
  cp_async_commit();
  if (n_tiles > 1) {
    load_tile<D>(ks + L::kTileKV, kg, (t_lo + 1) * kBlockN, kBlockN, s);
    load_tile<D>(vs + L::kTileKV, vg, (t_lo + 1) * kBlockN, kBlockN, s);
  }
  cp_async_commit();

  float acc[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {kNeg, kNeg};  // rows g and g + 8 of the warp's 16
  float l_run[2] = {0.f, 0.f};    // this lane's part of the row sums
  const int row0 = m0 + warp * 16 + g;

  // ldmatrix row addresses of this lane: Q (A, x4 = the four 8x8 quarters of
  // a 16x16 block), K (B of S: keys 0-7 / 8-15 x d 0-7 / 8-15), V (B of O,
  // transposed: keys 0-7 / 8-15 x d 0-7 / 8-15)
  const __nv_bfloat16* q_frag = qs + (warp * 16 + (lane & 15)) * kP + (lane >> 4) * 8;
  const int k_frag = ((lane & 7) + ((lane >> 4) << 3)) * kP + ((lane >> 3) & 1) * 8;
  const int v_frag = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kP + (lane >> 4) * 8;

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (t_lo + i) * kBlockN;
    const int stage = i % kStages;
    const __nv_bfloat16* kt = ks + stage * L::kTileKV;
    const __nv_bfloat16* vt = vs + stage * L::kTileKV;
    cp_async_wait_one();
    __syncthreads();  // tile i (and Q) have landed for every thread

    // S = Q K^T, 16 x kBlockN a warp
    float sc[kNS][4];
#pragma unroll
    for (int j = 0; j < kNS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t a[4];
      ldsm_x4(a, q_frag + kd * 16);
#pragma unroll
      for (int nb = 0; nb < kBlockN / 16; ++nb) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + nb * 16 * kP + k_frag + kd * 16);
        mma_bf16(sc[2 * nb], a, bk[0], bk[1]);
        mma_bf16(sc[2 * nb + 1], a, bk[2], bk[3]);
      }
    }

    // the element mask, on the tiles that have invisible pairs
    const bool edge = k0 + kBlockN - 1 > m0 || k0 + kBlockN > s ||
                      (window > 0 && k0 <= m0 + kBlockM - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = row0 + (e >> 1) * 8;
          const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
          const bool vis = kp < s && kp <= qp && (window <= 0 || kp > qp - window);
          if (!vis) sc[j][e] = kNeg;
        }
    }

    // online softmax in f32: new row max, rescale of O and l
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int j = 0; j < kNS; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = quad_max(mx);
      const float corr = exp2f((m_run[r] - mx) * scale_log2);
      m_run[r] = mx;
      mc[r] = mx * scale_log2;
      l_run[r] *= corr;
#pragma unroll
      for (int j = 0; j < kNO; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }

    // O += P V: P from the S fragments (two 8-key blocks make one 16-key A
    // fragment), rounded to bf16; l sums the rounded values
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float* x = &sc[2 * kk + (f >> 1)][2 * (f & 1)];
        const int r = f & 1;
        const float p0 = x[0] == kNeg ? 0.f : exp2f(fmaf(x[0], scale_log2, -mc[r]));
        const float p1 = x[1] == kNeg ? 0.f : exp2f(fmaf(x[1], scale_log2, -mc[r]));
        const __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
        l_run[r] += __low2float(pb) + __high2float(pb);
        pa[f] = *reinterpret_cast<const uint32_t*>(&pb);
      }
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vt + kk * 16 * kP + v_frag + dn * 16);
        mma_bf16(acc[2 * dn], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dn + 1], pa, bv[2], bv[3]);
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (i + kStages < n_tiles) {
      const int next = (t_lo + i + kStages) * kBlockN;
      load_tile<D>(ks + stage * L::kTileKV, kg, next, kBlockN, s);
      load_tile<D>(vs + stage * L::kTileKV, vg, next, kBlockN, s);
    }
    cp_async_commit();  // possibly empty, so one group per tile
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    const float l = quad_sum(l_run[r]);
    if (qp >= s) continue;
    const float safe_l = l > 0.f ? l : 1.f;
    __nv_bfloat16* orow = o + q_off + (size_t)qp * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < kNO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r] / safe_l, acc[j][2 * r + 1] / safe_l);
  }
}

// --------------------------------------------------------- f32, scalar FMA

constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;  // one key per lane in the softmax

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
  static constexpr int kColThreads =
      D <= kThreads ? D : (D % kThreads == 0 ? kThreads : kThreads / 2);
  static constexpr int kRowThreads = kThreads / kColThreads;
  static constexpr int kCols = D / kColThreads;        // columns per thread
  static constexpr int kRows = kBlockQ / kRowThreads;  // rows per thread
  static constexpr int kSRows = kBlockQ / kWarps;      // score rows per warp
  static constexpr int kFloats =
      (kBlockQ + kBlockK) * kPitchQK + kBlockK * D + kBlockQ * kPitchP + 2 * kBlockQ;
  static constexpr size_t kSmemBytes = sizeof(float) * kFloats;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int hq,
                         int hkv, int s, int window, float sm_scale) {
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
    qs[r * L::kPitchQK + c] = qp < s ? q[q_off + (size_t)qp * D + c] * sm_scale : 0.f;
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
      ks[r * L::kPitchQK + c] = ok ? k[g] : 0.f;
      vs[r * D + c] = ok ? v[g] : 0.f;
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
      o[q_off + (size_t)qp * D + col_t + L::kColThreads * c] = acc[r][c] / safe_l;
  }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, size_t smem, bool* configured) {
  if (*configured) return cudaSuccess;  // one attribute call per instantiation
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *configured = true;
  return e;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                        int hq, int hkv, int s, int window, float sm_scale,
                        cudaStream_t stream) {
  constexpr size_t smem = MmaLayout<D>::kSmemBytes;
  static bool configured = false;
  cudaError_t e = raise_smem_limit(flash_fwd_mma_kernel<D>, smem, &configured);
  if (e != cudaSuccess) return e;
  // x: every (batch, head); y: query tiles, the last (heaviest) first
  dim3 grid(b * hq, (s + kBlockM - 1) / kBlockM);
  const float scale_log2 = sm_scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  flash_fwd_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), hq, hkv, s,
      window, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b,
                       int hq, int hkv, int s, int window, float sm_scale,
                       cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kSmemBytes;
  static bool configured = false;
  cudaError_t e = raise_smem_limit(flash_fwd_f32_kernel<D>, smem, &configured);
  if (e != cudaSuccess) return e;
  dim3 grid((s + kBlockQ - 1) / kBlockQ, hq, b);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, s, window, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int hq,
                   int hkv, int s, int window, float sm_scale, int is_bf16,
                   cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(q, k, v, o, b, hq, hkv, s, window, sm_scale, stream)
                 : launch_f32<D>(q, k, v, o, b, hq, hkv, s, window, sm_scale, stream);
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
  switch (d) {
    case 32: return (int)launch<32>(q, k, v, o, b, hq, hkv, s, window, sm_scale, is_bf16, st);
    case 64: return (int)launch<64>(q, k, v, o, b, hq, hkv, s, window, sm_scale, is_bf16, st);
    case 128:
      return (int)launch<128>(q, k, v, o, b, hq, hkv, s, window, sm_scale, is_bf16, st);
    case 192:
      return (int)launch<192>(q, k, v, o, b, hq, hkv, s, window, sm_scale, is_bf16, st);
    case 256:
      return (int)launch<256>(q, k, v, o, b, hq, hkv, s, window, sm_scale, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

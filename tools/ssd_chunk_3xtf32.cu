// The SSD intra-chunk term on tensor cores: a measured alternative to
// src/repro_torch/csrc/ssd_chunk.cu, kept for tools/ssd_chunk_variants.py
// and not built into the package. The same C interface, grid, head slabs,
// shared S rows and cp.async stages as that kernel, but both products by
// mma.sync m16n8k8 with TF32 operands at f32 accuracy ("3xTF32": each f32
// operand split into a TF32 high part and the TF32 rounding of the
// remainder, summing lo*hi + hi*lo + hi*hi; the rounding done on the bits
// with two integer operations, which give what cvt.rna.tf32.f32 gives
// without the SM's slower conversion unit). Each of 4 warps owns 16 rows of
// the i tile; M = S * L is formed in registers straight in the A-operand
// layout. Two blocks fit an SM (102 KB of shared memory at Q = 256).
//
// It is within about 2e-6 of max |Y| of the plain version, but sums in the
// tensor cores' order, not the plain version's, and that moves mamba2-370m's
// prefill logits by about 5% against reference mode, over the bound the
// serving checks hold the kernel path to (tools/mamba_logit_sensitivity.py
// tools/ssd_chunk_3xtf32.cu measures it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps, 16 rows of the i tile each
constexpr int kTile = 64;      // rows of an i tile; rows of a j tile
constexpr int kMaxQ = 256;
constexpr int kMaxN = 256;
constexpr int kMaxP = 64;
constexpr int kSliceN = 32;            // state columns of an S stage
constexpr int kPitchN = kSliceN + 4;   // 36 = 4 x odd: conflict-free fragments
constexpr int kPitchX = kMaxP + 8;     // 72 = 8 x odd: conflict-free fragments
constexpr int kStageData = 2 * kTile * kPitchN;  // C_i and B_j slices, or X_h,j
constexpr int kStage = kStageData + 2 * kTile;   // + a_cum of the j and i rows
static_assert(kStageData == kTile * kPitchX, "an S stage and an X stage coincide");

// element strides of x (B, H, NC, Q, P), a_cum (B, H, NC, Q),
// bm / cm (B, G, NC, Q, N)
struct Params {
  const float* x;
  const float* a;
  const float* bm;
  const float* cm;
  float* y;
  int h, g, nc, q, p, n;
  int slab;   // heads a block walks
  int nslab;  // slabs a group
  int tiles;  // i tiles a chunk
  int vec;    // 16-byte copies: bit 0 x, bit 1 bm, bit 2 cm
  long long sx[5], sa[4], sb[5], sc[5];
};

// floats a row of S: the column tiles of a chunk, + 4 (4 x odd)
__host__ __device__ constexpr int s_pitch(int q) {
  return (q + kTile - 1) / kTile * kTile + 4;
}

__host__ __device__ constexpr size_t smem_bytes(int q) {
  return sizeof(float) * ((size_t)kTile * s_pitch(q) + 2 * (size_t)kStage);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared, asynchronously; zero-fills where !ok
__device__ __forceinline__ void cp_async_16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// half of the 13 dropped bits added to the magnitude, then cleared; for
// finite x the bits cvt.rna.tf32.f32 gives
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi its TF32 rounding, lo the TF32 rounding of the remainder
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at f32 accuracy: the two small cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi[0], bhi[1]);
  mma_tf32(d, ahi, blo[0], blo[1]);
  mma_tf32(d, ahi, bhi[0], bhi[1]);
}

// Copy rows [row0, row0 + 64) x columns [col0, col0 + kWidth) of a strided
// matrix into a tile of row pitch `pitch`; rows at or past `rows` and
// columns at or past `cols` are zero-filled. `vec`: the row stride and
// col0 are multiples of 4 floats, the column stride is 1, `cols` is a
// multiple of 4 and `src` is 16-byte aligned.
template <int kWidth>
__device__ __forceinline__ void copy_tile(float* dst, int pitch, const float* src,
                                          long long rs, long long cs, int row0,
                                          int rows, int col0, int cols, bool vec) {
  if (vec) {
    constexpr int kVecs = kWidth / 4;
#pragma unroll
    for (int k = 0; k < kTile * kVecs / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int r = i / kVecs, c = (i % kVecs) * 4;
      const bool ok = row0 + r < rows && col0 + c < cols;
      cp_async_16(dst + r * pitch + c, ok ? src + (row0 + r) * rs + col0 + c : src, ok);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < kTile * kWidth / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int r = i / kWidth, c = i % kWidth;
      const bool ok = row0 + r < rows && col0 + c < cols;
      cp_async_4(dst + r * pitch + c, ok ? src + (row0 + r) * rs + (col0 + c) * cs : src,
                 ok);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_kernel(const Params pr) {
  extern __shared__ __align__(16) float smem[];
  const int pitch_s = s_pitch(pr.q);
  float* s_rows = smem;                           // 64 x pitch_s: S_i,j for j <= i
  float* stages = smem + (size_t)kTile * pitch_s;  // 2 x kStage

  // block -> (i tile, batch, group, chunk, slab); the heaviest tiles first
  const int per_tile = gridDim.x / pr.tiles;
  const int ti = pr.tiles - 1 - (int)blockIdx.x / per_tile;
  int rest = (int)blockIdx.x % per_tile;
  const int slab = rest % pr.nslab;
  rest /= pr.nslab;
  const int grp = rest % pr.g;
  rest /= pr.g;
  const int chunk = rest % pr.nc;
  const int b = rest / pr.nc;
  const int rep = pr.h / pr.g;
  const int head0 = grp * rep + slab * pr.slab;
  const int heads = min(pr.slab, rep - slab * pr.slab);
  const int i0 = ti * kTile;
  const int jtiles = ti + 1;
  const int slices = (pr.n + kSliceN - 1) / kSliceN;
  const int n_s = jtiles * slices;            // stages of the S phase
  const int n_all = n_s + heads * jtiles;     // + stages of the head walk
  const bool vec_x = pr.vec & 1, vec_b = pr.vec & 2, vec_c = pr.vec & 4;

  const float* cb = pr.cm + b * pr.sc[0] + grp * pr.sc[1] + chunk * pr.sc[2];
  const float* bb = pr.bm + b * pr.sb[0] + grp * pr.sb[1] + chunk * pr.sb[2];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, column
  const int r0 = warp * 16 + gq;           // this thread's rows: r0, r0 + 8

  // stage k into buffer k % 2, as one cp.async group
  auto load_stage = [&](int k) {
    float* st = stages + (k & 1) * kStage;
    if (k < n_s) {
      const int tj = k / slices, col0 = (k % slices) * kSliceN;
      copy_tile<kSliceN>(st, kPitchN, cb, pr.sc[3], pr.sc[4], i0, pr.q, col0, pr.n,
                         vec_c);
      copy_tile<kSliceN>(st + kTile * kPitchN, kPitchN, bb, pr.sb[3], pr.sb[4],
                         tj * kTile, pr.q, col0, pr.n, vec_b);
    } else {
      const int w = k - n_s;
      const int hd = head0 + w / jtiles, tj = w % jtiles;
      const float* xb = pr.x + b * pr.sx[0] + hd * pr.sx[1] + chunk * pr.sx[2];
      copy_tile<kMaxP>(st, kPitchX, xb, pr.sx[3], pr.sx[4], tj * kTile, pr.q, 0, pr.p,
                       vec_x);
      // a_cum of the j rows, then of the i rows: one value a thread
      const float* ab = pr.a + b * pr.sa[0] + hd * pr.sa[1] + chunk * pr.sa[2];
      const int r = tid % kTile;
      const int row = (tid < kTile ? tj * kTile : i0) + r;
      const bool ok = row < pr.q;
      cp_async_4(st + kStageData + tid, ok ? ab + row * pr.sa[3] : ab, ok);
    }
    cp_async_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  load_stage(0);
  for (int k = 0; k < n_all; ++k) {
    cp_async_wait_all();
    __syncthreads();  // stage k has landed, and stage k - 1 is no longer read
    if (k + 1 < n_all) load_stage(k + 1);
    const float* st = stages + (k & 1) * kStage;

    if (k < n_s) {
      // ---- S_i,j += C_i B_j^T over one 32-column slice of the state
      const int tj = k / slices;
      const float* cs = st;
      const float* bs = st + kTile * kPitchN;
#pragma unroll
      for (int ks = 0; ks < kSliceN / 8; ++ks) {
        const int c = ks * 8 + tq;
        uint32_t ahi[4], alo[4];
        split_tf32(cs[r0 * kPitchN + c], ahi[0], alo[0]);
        split_tf32(cs[(r0 + 8) * kPitchN + c], ahi[1], alo[1]);
        split_tf32(cs[r0 * kPitchN + c + 4], ahi[2], alo[2]);
        split_tf32(cs[(r0 + 8) * kPitchN + c + 4], ahi[3], alo[3]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* brow = bs + (nt * 8 + gq) * kPitchN + c;
          uint32_t bhi[2], blo[2];
          split_tf32(brow[0], bhi[0], blo[0]);
          split_tf32(brow[4], bhi[1], blo[1]);
          mma_3xtf32(acc[nt], ahi, alo, bhi, blo);
        }
      }
      if (k % slices == slices - 1) {
        // S_i,j complete: park this warp's rows in shared memory
        float* srow = s_rows + tj * kTile + 2 * tq;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          *reinterpret_cast<float2*>(srow + r0 * pitch_s + nt * 8) =
              make_float2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<float2*>(srow + (r0 + 8) * pitch_s + nt * 8) =
              make_float2(acc[nt][2], acc[nt][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
        }
      }
    } else {
      // ---- Y_h,i += M X_h,j with M = S_i,j * L, for one head and one j tile
      const int w = k - n_s;
      const int hd = head0 + w / jtiles, tj = w % jtiles;
      const float* xs = st;
      const float* aj = st + kStageData;
      const float* ai = aj + kTile;
      const float ai0 = ai[r0], ai1 = ai[r0 + 8];
      const int qi0 = i0 + r0, qi1 = qi0 + 8;
      const float* srow0 = s_rows + r0 * pitch_s + tj * kTile;
      const float* srow1 = srow0 + 8 * pitch_s;
#pragma unroll
      for (int ks = 0; ks < kTile / 8; ++ks) {
        const int c = ks * 8 + tq;  // columns c and c + 4 of the j tile
        const int qj0 = tj * kTile + c, qj1 = qj0 + 4;
        const float aj0 = aj[c], aj1 = aj[c + 4];
        const float m0 = qj0 <= qi0 && qi0 < pr.q ? srow0[c] * expf(ai0 - aj0) : 0.f;
        const float m1 = qj0 <= qi1 && qi1 < pr.q ? srow1[c] * expf(ai1 - aj0) : 0.f;
        const float m2 = qj1 <= qi0 && qi0 < pr.q ? srow0[c + 4] * expf(ai0 - aj1) : 0.f;
        const float m3 = qj1 <= qi1 && qi1 < pr.q ? srow1[c + 4] * expf(ai1 - aj1) : 0.f;
        uint32_t ahi[4], alo[4];
        split_tf32(m0, ahi[0], alo[0]);
        split_tf32(m1, ahi[1], alo[1]);
        split_tf32(m2, ahi[2], alo[2]);
        split_tf32(m3, ahi[3], alo[3]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* xcol = xs + c * kPitchX + nt * 8 + gq;
          uint32_t bhi[2], blo[2];
          split_tf32(xcol[0], bhi[0], blo[0]);
          split_tf32(xcol[4 * kPitchX], bhi[1], blo[1]);
          mma_3xtf32(acc[nt], ahi, alo, bhi, blo);
        }
      }
      if (tj == jtiles - 1) {
        // Y_h,i complete: y is contiguous (B, H, NC, Q, P)
        float* yb = pr.y + (((size_t)b * pr.h + hd) * pr.nc + chunk) * pr.q * pr.p;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = nt * 8 + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int qi = half ? qi1 : qi0;
            if (qi < pr.q && col < pr.p) {
              float* dst = yb + (size_t)qi * pr.p + col;
              if ((pr.p & 1) == 0) {
                *reinterpret_cast<float2*>(dst) =
                    make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
              } else {
                dst[0] = acc[nt][2 * half];
                if (col + 1 < pr.p) dst[1] = acc[nt][2 * half + 1];
              }
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) acc[nt][2 * half + e] = 0.f;
          }
        }
      }
    }
  }
}

// rows of `rank` strides whose last is 1, `dim` a multiple of 4, every other
// stride a multiple of 4 floats and the base 16-byte aligned
bool rows_align(const float* p, const long long* s, int rank, int dim) {
  if (s[rank - 1] != 1 || dim % 4 || reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < rank - 1; ++i)
    if (s[i] % 4) return false;
  return true;
}

}  // namespace

// x (B, H, NC, Q, P), a_cum (B, H, NC, Q), bm / cm (B, G, NC, Q, N): float32,
// any element strides (``strides``: x's 5, a_cum's 4, bm's 5, cm's 5), H % G
// == 0; ``slab``: heads of a group one block walks, 1 <= slab <= H / G.
// y: contiguous float32 (B, H, NC, Q, P).
extern "C" int ssd_chunk_fwd(const float* x, const float* a_cum, const float* bm,
                             const float* cm, float* y, int b, int h, int g, int nc,
                             int q, int p, int n, int slab, const long long* strides,
                             void* stream) {
  if (b <= 0 || h <= 0 || g <= 0 || h % g != 0 || nc <= 0 || q <= 0 || q > kMaxQ ||
      p <= 0 || p > kMaxP || n <= 0 || n > kMaxN || slab <= 0 || slab > h / g)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;  // one attribute call, at the largest size
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(ssd_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(kMaxQ));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  Params pr;
  pr.x = x;
  pr.a = a_cum;
  pr.bm = bm;
  pr.cm = cm;
  pr.y = y;
  pr.h = h;
  pr.g = g;
  pr.nc = nc;
  pr.q = q;
  pr.p = p;
  pr.n = n;
  pr.slab = slab;
  pr.nslab = (h / g + slab - 1) / slab;
  pr.tiles = (q + kTile - 1) / kTile;
  for (int i = 0; i < 5; ++i) pr.sx[i] = strides[i];
  for (int i = 0; i < 4; ++i) pr.sa[i] = strides[5 + i];
  for (int i = 0; i < 5; ++i) pr.sb[i] = strides[9 + i];
  for (int i = 0; i < 5; ++i) pr.sc[i] = strides[14 + i];
  pr.vec = (rows_align(x, pr.sx, 5, p) ? 1 : 0) | (rows_align(bm, pr.sb, 5, n) ? 2 : 0) |
           (rows_align(cm, pr.sc, 5, n) ? 4 : 0);
  const long long blocks = (long long)pr.tiles * nc * b * g * pr.nslab;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  ssd_chunk_kernel<<<(unsigned)blocks, kThreads, smem_bytes(q),
                     static_cast<cudaStream_t>(stream)>>>(pr);
  return (int)cudaGetLastError();
}

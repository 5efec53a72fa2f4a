// Mamba-2 SSD intra-chunk term for Hopper: Y = (C B^T * L) X per chunk.
//
// Replaces: src/repro/kernels/ssd_chunk.py::ssd_chunk_pallas, the Pallas TPU
// kernel of the quadratic-within-chunk term of state-space duality. For each
// (batch, head, chunk) cell of Q positions:
//
//   S = C B^T                      (Q x Q)
//   L[i, j] = exp(a_cum[i] - a_cum[j]) for i >= j, else 0
//   Y = (S * L) X                  (Q x P), all in f32
//
// What bounds it on the H100. B and C come per group, so S is the same for
// every head of a group: the function needs S once per (batch, group,
// chunk) and M X per head. At mamba2-370m's prefill layer (batch 4 x 1024
// tokens: Q 256, N 128, P 64, 32 heads, 1 group, 4 chunks) that is 2.29
// GFLOP over the causal pairs, 0.034 ms at the 67 TFLOP/s f32 rate, against
// 72 MB of bytes (x in, Y out, B/C once per group, a_cum), 0.021 ms at
// 3.35 TB/s: operations, by a little.
//
// What the design does about it:
//
// * S is shared across a slab of a group's heads. A block takes one 64-row
//   tile i of one chunk, for one batch element, one group and `slab` of that
//   group's heads (the wrapper picks the slab so the grid still fills the
//   card; the last slab of a group may be narrower). It forms S_ij = C_i
//   B_j^T for every column tile j <= i once and keeps the row of tiles in
//   shared memory (64 x Q f32: 65 KB at Q = 256). Then it walks its heads,
//   32 columns of S at a time: M = S * exp(a_i - a_j) on and below the
//   diagonal (expf, taken only where i >= j, where it cannot overflow) is
//   formed once into shared memory, and Y_i += M X_j. Tiles above the
//   diagonal are zero and skipped.
// * Products by f32 FMA, in the order of the plain version's f32 GEMMs:
//   every S entry is one fmaf chain over the state index ascending, every Y
//   entry one chain over the position ascending, from 0. So the kernel
//   equals its plain version bit for bit, and the served model's logits
//   equal reference mode's. That is a requirement here, not a nicety: with
//   seeded random weights, 48 bf16 layers carry any last-bit difference in
//   this term to about 5% of the logits (noise of a relative 1e-6 on the
//   plain version alone moves them 5.3%), the bound the serving checks hold
//   the kernel path to. The tensor cores cannot keep that order: a 3xTF32
//   mma.sync version (tools/ssd_chunk_3xtf32.cu), within 2e-6 of max |Y|
//   and faster, moved the logits 5.4%.
// * Each of 256 threads holds a 4 x 4 block of the 64 x 64 output tile and
//   takes four k at a time: float4 loads of 4 rows of one operand and 4
//   rows (or columns) of the other feed 64 FMAs. A warp is 8 x 4 threads,
//   so each of its float4 loads fetches at most 8 distinct 16-byte pieces;
//   row pitches are 4 times an odd number of floats, so those fall in
//   distinct banks and every load is one pass of shared memory.
// * Copies are in flight while the block computes: one sequence of stages
//   (C_i and B_j in 16-column slices of the state for S, then X_h,j in
//   halves of 32 rows, with their a_cum and the i rows', for each head and
//   column tile) runs through two shared buffers by cp.async, stage k+1
//   loading while stage k computes.
//   Rows past Q and columns past N or P are zero-filled, so padding is 0,
//   never NaN. Operands whose rows are 16-byte aligned go by 16-byte
//   copies, others by 4-byte copies through their element strides.
// * Deterministic: no atomics; every sum runs in one fixed order. Blocks of
//   the last i tiles, which walk the most column tiles, are launched first.
//
// Budget: 256 threads a block; shared memory 64 x (Q + 4) floats for S, 64
// x 36 for M and two stages of 2688 floats: 95 KB at Q = 256, so two
// blocks fit an SM (the 228 KB of an SM bounds it; the half-width steps are
// what make two fit). Registers: 16 f32 accumulators a thread and two
// float4 x 4 operand sets, the 128 that __launch_bounds__(256, 2) allows
// and no spill (ptxas reports both at build).
//
// Layouts go through element strides, not copies: the caller's x is a
// permuted view of (B, NC, Q, H, P), and B/C come per group (B, G, NC, Q, N),
// head h reading group h / (H / G) (jnp.repeat's order), so the groups are
// never broadcast to heads in device memory. Q, N and P need not be
// multiples of anything: edges are masked. Q <= 256, N <= 256, P <= 64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads over a 64 x 64 tile
constexpr int kTile = 64;      // rows of an i tile; rows of a j tile
constexpr int kSide = 16;      // threads along each side of the tile
constexpr int kMicro = 4;      // 4 x 4 outputs a thread
constexpr int kMaxQ = 256;
constexpr int kMaxN = 256;
constexpr int kMaxP = 64;
constexpr int kHalf = kTile / 2;       // rows of X (columns of M) a head-walk stage
constexpr int kSliceN = 16;            // state columns of an S stage
constexpr int kPitchN = kSliceN + 4;   // 20: C_i / B_j slice rows
constexpr int kPitchX = kMaxP + 4;     // 68: X_j rows
constexpr int kPitchM = kHalf + 4;     // 36: M rows
constexpr int kStageData = 2 * kTile * kPitchN;  // C_i and B_j slices, or X_h,j
constexpr int kStage = kStageData + 2 * kTile;   // + a_cum of the j and i rows
static_assert(kHalf * kPitchX <= kStageData, "an X stage fits an S stage");

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
  return sizeof(float) *
         ((size_t)kTile * s_pitch(q) + (size_t)kTile * kPitchM + 2 * (size_t)kStage);
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

// Copy rows [row0, row0 + kRows) x columns [col0, col0 + kWidth) of a strided
// matrix into a tile of row pitch `pitch`; rows at or past `rows` and
// columns at or past `cols` are zero-filled. `vec`: the row stride and
// col0 are multiples of 4 floats, the column stride is 1, `cols` is a
// multiple of 4 and `src` is 16-byte aligned.
template <int kRows, int kWidth>
__device__ __forceinline__ void copy_tile(float* dst, int pitch, const float* src,
                                          long long rs, long long cs, int row0,
                                          int rows, int col0, int cols, bool vec) {
  if (vec) {
    constexpr int kVecs = kWidth / 4;
#pragma unroll
    for (int k = 0; k < kRows * kVecs / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int r = i / kVecs, c = (i % kVecs) * 4;
      const bool ok = row0 + r < rows && col0 + c < cols;
      cp_async_16(dst + r * pitch + c, ok ? src + (row0 + r) * rs + col0 + c : src, ok);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < kRows * kWidth / kThreads; ++k) {
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
  float* s_rows = smem;                            // 64 x pitch_s: S_i,j for j <= i
  float* m_tile = s_rows + (size_t)kTile * pitch_s;  // 64 x kPitchM: M of a half tile
  float* stages = m_tile + kTile * kPitchM;        // 2 x kStage

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
  const int n_s = jtiles * slices;         // stages of the S phase
  const int n_all = n_s + heads * jtiles * 2;  // + head-walk stages: half tiles
  const bool vec_x = pr.vec & 1, vec_b = pr.vec & 2, vec_c = pr.vec & 4;

  const float* cb = pr.cm + b * pr.sc[0] + grp * pr.sc[1] + chunk * pr.sc[2];
  const float* bb = pr.bm + b * pr.sb[0] + grp * pr.sb[1] + chunk * pr.sb[2];

  // a warp is 8 x 4 threads of the 16 x 16: its float4 loads fetch 8 rows
  // of one operand and 4 of the other, each in one pass of the banks
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 4) * 8 + lane / 4, tx = (warp % 4) * 4 + lane % 4;

  // stage k into buffer k % 2, as one cp.async group
  auto load_stage = [&](int k) {
    float* st = stages + (k & 1) * kStage;
    if (k < n_s) {
      const int tj = k / slices, col0 = (k % slices) * kSliceN;
      copy_tile<kTile, kSliceN>(st, kPitchN, cb, pr.sc[3], pr.sc[4], i0, pr.q, col0,
                                pr.n, vec_c);
      copy_tile<kTile, kSliceN>(st + kTile * kPitchN, kPitchN, bb, pr.sb[3], pr.sb[4],
                                tj * kTile, pr.q, col0, pr.n, vec_b);
    } else {
      const int w = k - n_s;
      const int hd = head0 + w / (2 * jtiles);
      const int j0 = (w % (2 * jtiles)) * kHalf;  // first row of the half tile
      const float* xb = pr.x + b * pr.sx[0] + hd * pr.sx[1] + chunk * pr.sx[2];
      copy_tile<kHalf, kMaxP>(st, kPitchX, xb, pr.sx[3], pr.sx[4], j0, pr.q, 0, pr.p,
                              vec_x);
      // a_cum of the half tile's rows, then of the i rows: a value a thread
      if (tid < kHalf || (tid >= kTile && tid < 2 * kTile)) {
        const float* ab = pr.a + b * pr.sa[0] + hd * pr.sa[1] + chunk * pr.sa[2];
        const int row = tid < kTile ? j0 + tid : i0 + tid - kTile;
        const bool ok = row < pr.q;
        cp_async_4(st + kStageData + tid, ok ? ab + row * pr.sa[3] : ab, ok);
      }
    }
    cp_async_commit();
  };

  // S phase: rows ty + 16 r of the i tile, columns tx + 16 c of a j tile.
  // Head walk: rows ty + 16 r, output columns 4 tx + c.
  float acc[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[r][c] = 0.f;

  load_stage(0);
  for (int k = 0; k < n_all; ++k) {
    cp_async_wait_all();
    __syncthreads();  // stage k has landed, and stage k - 1 is no longer read
    if (k + 1 < n_all) load_stage(k + 1);
    const float* st = stages + (k & 1) * kStage;

    if (k < n_s) {
      // ---- S_i,j += C_i B_j^T over one 16-column slice of the state, one
      // fmaf chain an entry over the state index ascending
      const int tj = k / slices;
      const float* cs = st;
      const float* bs = st + kTile * kPitchN;
#pragma unroll 2
      for (int n4 = 0; n4 < kSliceN; n4 += 4) {
        float4 cv[kMicro], bv[kMicro];
#pragma unroll
        for (int r = 0; r < kMicro; ++r)
          cv[r] = *reinterpret_cast<const float4*>(cs + (ty + kSide * r) * kPitchN + n4);
#pragma unroll
        for (int c = 0; c < kMicro; ++c)
          bv[c] = *reinterpret_cast<const float4*>(bs + (tx + kSide * c) * kPitchN + n4);
#pragma unroll
        for (int r = 0; r < kMicro; ++r)
#pragma unroll
          for (int c = 0; c < kMicro; ++c) {
            acc[r][c] = fmaf(cv[r].x, bv[c].x, acc[r][c]);
            acc[r][c] = fmaf(cv[r].y, bv[c].y, acc[r][c]);
            acc[r][c] = fmaf(cv[r].z, bv[c].z, acc[r][c]);
            acc[r][c] = fmaf(cv[r].w, bv[c].w, acc[r][c]);
          }
      }
      if (k % slices == slices - 1) {
        // S_i,j complete: park it in the row of tiles
#pragma unroll
        for (int r = 0; r < kMicro; ++r)
#pragma unroll
          for (int c = 0; c < kMicro; ++c) {
            s_rows[(ty + kSide * r) * pitch_s + tj * kTile + tx + kSide * c] = acc[r][c];
            acc[r][c] = 0.f;
          }
      }
    } else {
      // ---- Y_h,i += M X_h,j with M = S_i,j * L, for one head and one half
      // of a j tile (rows j0 .. j0 + 31)
      const int w = k - n_s;
      const int hd = head0 + w / (2 * jtiles);
      const int j0 = (w % (2 * jtiles)) * kHalf;
      const float* xs = st;
      const float* aj = st + kStageData;
      const float* ai = aj + kTile;
      // M, once for the block: each thread 8 entries, a warp along a row
#pragma unroll 4
      for (int e = tid; e < kTile * kHalf; e += kThreads) {
        const int i = e / kHalf, j = e % kHalf;
        const int qi = i0 + i, qj = j0 + j;
        m_tile[i * kPitchM + j] =
            qj <= qi && qi < pr.q ? s_rows[i * pitch_s + qj] * expf(ai[i] - aj[j]) : 0.f;
      }
      __syncthreads();
      // one fmaf chain an entry over the position ascending
#pragma unroll 2
      for (int j4 = 0; j4 < kHalf; j4 += 4) {
        float4 mv[kMicro], xv[4];
#pragma unroll
        for (int r = 0; r < kMicro; ++r)
          mv[r] = *reinterpret_cast<const float4*>(m_tile + (ty + kSide * r) * kPitchM + j4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xv[e] = *reinterpret_cast<const float4*>(xs + (j4 + e) * kPitchX + 4 * tx);
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
          const float m[4] = {mv[r].x, mv[r].y, mv[r].z, mv[r].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[r][0] = fmaf(m[e], xv[e].x, acc[r][0]);
            acc[r][1] = fmaf(m[e], xv[e].y, acc[r][1]);
            acc[r][2] = fmaf(m[e], xv[e].z, acc[r][2]);
            acc[r][3] = fmaf(m[e], xv[e].w, acc[r][3]);
          }
        }
      }
      if (j0 + kHalf == jtiles * kTile) {
        // Y_h,i complete: y is contiguous (B, H, NC, Q, P)
        float* yb = pr.y + (((size_t)b * pr.h + hd) * pr.nc + chunk) * pr.q * pr.p;
        const int col = 4 * tx;
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
          const int qi = i0 + ty + kSide * r;
          if (qi < pr.q && col < pr.p) {
            float* dst = yb + (size_t)qi * pr.p + col;
            if (pr.p % 4 == 0) {
              *reinterpret_cast<float4*>(dst) =
                  make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
            } else {
#pragma unroll
              for (int c = 0; c < kMicro; ++c)
                if (col + c < pr.p) dst[c] = acc[r][c];
            }
          }
#pragma unroll
          for (int c = 0; c < kMicro; ++c) acc[r][c] = 0.f;
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

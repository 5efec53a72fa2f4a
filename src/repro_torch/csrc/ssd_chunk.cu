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
// What bounds it on the H100: operations. At mamba2-370m's prefill layer
// (batch 4 x 1024 tokens: 512 cells, Q 256, N 128, P 64) the causal pairs
// need Q(Q+1)/2 * (2N + 2P) flops a cell, 6.47 GFLOP in all: 0.097 ms at
// the 67 TFLOP/s f32 rate. The bytes (x in, Y out, B/C once per group,
// a_cum) are about 72 MB: 0.021 ms at 3.35 TB/s.
//
// What this first version does about it: the simple, right design. The
// Pallas kernel keeps a whole Q x Q tile in VMEM; at Q = 256 in f32 that is
// 256 KB, over the 227 KB of shared memory a block may have. So one block
// of 256 threads takes one 64-row tile i of one cell: it loads C_i once and
// walks the 64-column tiles j <= i (tiles above the diagonal are all zero
// and skipped). For each j it loads B_j, X_j and a_cum's slice into shared
// memory, forms S = C_i B_j^T by scalar f32 FMA (each thread a 4 x 4
// micro-tile of strided rows and columns, rows padded to an odd pitch so
// the 16 columns a warp reads sit in 16 banks), applies the decay with
// expf (not __expf) only where i >= j, stores M in shared memory and adds
// M X_j into a 4 x 4 register accumulator. Blocks of the last tiles, which
// walk the most j tiles, are launched first. No TF32 and no tensor cores:
// mma.sync / wgmma are later work with a tolerance of their own.
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

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // rows of an i tile, columns of a j tile
constexpr int kSide = 16;  // threads along each side of the 64 x 64 tile
constexpr int kMicro = kTile / kSide;  // 4 x 4 entries a thread
constexpr int kMaxQ = 256;
constexpr int kMaxN = 256;
constexpr int kMaxP = kSide * kMicro;  // 64 output columns a block
constexpr int kPitchM = kTile + 1;

// element strides of x (B, H, NC, Q, P), a_cum (B, H, NC, Q),
// bm / cm (B, G, NC, Q, N)
struct Strides {
  long long x[5];
  long long a[4];
  long long b[5];
  long long c[5];
};

__host__ __device__ constexpr size_t smem_floats(int n, int p) {
  return 2 * (size_t)kTile * (n + 1) + (size_t)kTile * p + (size_t)kTile * kPitchM +
         2 * kTile;
}

__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ a_cum,
                     const float* __restrict__ bm, const float* __restrict__ cm,
                     float* __restrict__ y, int h_count, int g_count, int nc, int q_len,
                     int p_dim, int n_dim, Strides st) {
  extern __shared__ float smem[];
  const int pitch = n_dim + 1;
  float* cs = smem;                   // kTile x pitch: C_i
  float* bs = cs + kTile * pitch;     // kTile x pitch: B_j
  float* xs = bs + kTile * pitch;     // kTile x p_dim: X_j
  float* ms = xs + kTile * p_dim;     // kTile x kPitchM: M = S * L
  float* ai = ms + kTile * kPitchM;   // kTile: a_cum of the i rows
  float* aj = ai + kTile;             // kTile: a_cum of the j columns

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int tiles = (q_len + kTile - 1) / kTile;
  const int ti = tiles - 1 - (int)blockIdx.x;  // the heaviest tiles first
  const int chunk = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / h_count;
  const int h = bh % h_count;
  const int g = h / (h_count / g_count);
  const int i0 = ti * kTile;

  const float* xb = x + b * st.x[0] + h * st.x[1] + chunk * st.x[2];
  const float* ab = a_cum + b * st.a[0] + h * st.a[1] + chunk * st.a[2];
  const float* bb = bm + b * st.b[0] + g * st.b[1] + chunk * st.b[2];
  const float* cb = cm + b * st.c[0] + g * st.c[1] + chunk * st.c[2];

  for (int i = tid; i < kTile * n_dim; i += kThreads) {
    const int r = i / n_dim, n = i % n_dim;
    const int qp = i0 + r;
    cs[r * pitch + n] = qp < q_len ? cb[qp * st.c[3] + n * st.c[4]] : 0.f;
  }
  if (tid < kTile) ai[tid] = i0 + tid < q_len ? ab[(i0 + tid) * st.a[3]] : 0.f;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[r][c] = 0.f;

  for (int tj = 0; tj <= ti; ++tj) {
    const int j0 = tj * kTile;
    __syncthreads();  // the previous tile's bs / xs / ms are no longer read
    for (int i = tid; i < kTile * n_dim; i += kThreads) {
      const int r = i / n_dim, n = i % n_dim;
      const int qp = j0 + r;
      bs[r * pitch + n] = qp < q_len ? bb[qp * st.b[3] + n * st.b[4]] : 0.f;
    }
    for (int i = tid; i < kTile * p_dim; i += kThreads) {
      const int r = i / p_dim, p = i % p_dim;
      const int qp = j0 + r;
      xs[i] = qp < q_len ? xb[qp * st.x[3] + p * st.x[4]] : 0.f;
    }
    if (tid < kTile) aj[tid] = j0 + tid < q_len ? ab[(j0 + tid) * st.a[3]] : 0.f;
    __syncthreads();

    // S = C_i B_j^T: rows ty + 16 r, columns tx + 16 c
    float s[kMicro][kMicro];
#pragma unroll
    for (int r = 0; r < kMicro; ++r)
#pragma unroll
      for (int c = 0; c < kMicro; ++c) s[r][c] = 0.f;
    for (int n = 0; n < n_dim; ++n) {
      float cv[kMicro], bv[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) cv[r] = cs[(ty + kSide * r) * pitch + n];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) bv[c] = bs[(tx + kSide * c) * pitch + n];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) s[r][c] = fmaf(cv[r], bv[c], s[r][c]);
    }

    // M = S * exp(a_cum_i - a_cum_j) on and below the diagonal, else 0
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
      const int row = ty + kSide * r;
      const int qi = i0 + row;
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        const int col = tx + kSide * c;
        const int qj = j0 + col;
        const bool live = qj <= qi && qi < q_len;
        ms[row * kPitchM + col] = live ? s[r][c] * expf(ai[row] - aj[col]) : 0.f;
      }
    }
    __syncthreads();

    // Y_i += M X_j: rows ty + 16 r, output columns tx + 16 c < P
    for (int k = 0; k < kTile; ++k) {
      float mv[kMicro], xv[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) mv[r] = ms[(ty + kSide * r) * kPitchM + k];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        const int col = tx + kSide * c;
        xv[c] = col < p_dim ? xs[k * p_dim + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) acc[r][c] = fmaf(mv[r], xv[c], acc[r][c]);
    }
  }

  // Y is contiguous (B, H, NC, Q, P)
  float* yb = y + (((size_t)bh * nc + chunk) * q_len) * p_dim;
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int qi = i0 + ty + kSide * r;
    if (qi >= q_len) continue;
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int col = tx + kSide * c;
      if (col < p_dim) yb[(size_t)qi * p_dim + col] = acc[r][c];
    }
  }
}

}  // namespace

// x (B, H, NC, Q, P), a_cum (B, H, NC, Q), bm / cm (B, G, NC, Q, N): float32,
// any element strides (``strides``: x's 5, a_cum's 4, bm's 5, cm's 5), H % G
// == 0. y: contiguous float32 (B, H, NC, Q, P).
extern "C" int ssd_chunk_fwd(const float* x, const float* a_cum, const float* bm,
                             const float* cm, float* y, int b, int h, int g, int nc,
                             int q, int p, int n, const long long* strides,
                             void* stream) {
  if (b <= 0 || h <= 0 || g <= 0 || h % g != 0 || nc <= 0 || nc > 65535 || q <= 0 ||
      q > kMaxQ || p <= 0 || p > kMaxP || n <= 0 || n > kMaxN || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;  // one attribute call, at the largest size
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(ssd_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(smem_floats(kMaxN, kMaxP) * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  Strides st;
  for (int i = 0; i < 5; ++i) st.x[i] = strides[i];
  for (int i = 0; i < 4; ++i) st.a[i] = strides[5 + i];
  for (int i = 0; i < 5; ++i) st.b[i] = strides[9 + i];
  for (int i = 0; i < 5; ++i) st.c[i] = strides[14 + i];
  const size_t smem = smem_floats(n, p) * sizeof(float);
  dim3 grid((q + kTile - 1) / kTile, nc, b * h);
  ssd_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, a_cum, bm, cm, y, h, g, nc, q, p, n, st);
  return (int)cudaGetLastError();
}

// Fused vademecum sweep for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel pgdrome_tpu/ops/pallas_kernels.py::make_fused_sweep
// (Pallas body :116-152, launch :164-179).  For samples s (B, NP), per
// parameter dim j a uniform 1D grid (x0, 1/h, ncell, degree 1 or 2) with a
// mode table T_j (ndof_j, K), and a dim-0 table M0 (K, n0):
//
//   F[b, k]   = [k < n_modes] * prod_j sum_l phi_l(xi_bj) T_j[deg_j*c_bj + l, k]
//   out[b, :] = sum_k F[b, k] M0[k, :]
//
// with c = clip(floor((s - x0)/h), 0, ncell-1) and xi = (s - x0)/h - c,
// exactly the TPU kernel's arithmetic.  Two entry points:
//
//   pgd_sweep_tile     fields and sensors: (B, n0) output, any n0 >= 1;
//                      f32 or bf16 store
//   pgd_sweep_factors  moments: (B, K) output = F itself (the identity M0 of
//                      the TPU wiring is skipped)
//
// What bounds it on an H100: the field wiring does 2*K*n0 true-f32 FLOPs per
// sample (2.62 MFLOP at K=640, n0=2049) against a 4*n0-byte output write,
// ~320 FLOP/byte, far above the f32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s = 20), so it is compute-bound on the FP32 pipes.  Tensor cores
// are not used: TF32 would lose the 1e-6 accuracy gate.  The design:
//
//  * one block owns ROWS = 8*RPW samples; it locates their cells once and
//    builds the factor tile F (K x ROWS, in shared memory) once, gathering
//    the 2-3 table rows of each dim directly from L2 (the TPU's two-hot
//    matmul and 128-padding exist only because TPU gathers are slow);
//  * it then loops over n0 in tiles of 256 columns inside the block (the
//    TPU grid recomputed F for every n0 tile); M0 is staged through shared
//    memory 16 rows at a time, double-buffered with a register prefetch;
//  * each warp owns RPW rows and each lane 8 columns (two float4 groups,
//    128 apart), so one k step reads RPW/4 broadcast float4s of F and two
//    float4s of M0 for 8*RPW FMAs.  A last tile of at most 128 columns runs
//    the first group only.  On an H100 at K=640 this reaches about 37 % of
//    the f32 FMA peak; shared-memory bandwidth does not explain the rest
//    (two layouts with fewer loads per FMA measured slower);
//  * each 16-k step accumulates into its own partial sum (blocked
//    summation), which keeps the f32 rounding error of a K=640 sum near
//    that of a pairwise sum;
//  * ragged edges (B, n0, K) are masked; nothing but the output is written
//    to device memory.  The tables (NP*ndof*K*4 = 1.65 MB at K=640) stay in
//    L2; M0 (5.2 MB) is re-read from L2 by every block.
//
// The sensor wiring (n0 = 8) runs the same kernel: one n0 tile whose
// single 128-column group is masked past n0, so its time is the factor
// stage plus a 128-column product.  At K=640 a block holds 207 KiB of
// shared memory, one block (8 warps) per SM, and the factor stage's L2
// gathers run at that occupancy.  The factor wiring is elementwise over
// (b, k) at full occupancy.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kTileN = 256;    // output columns per n0 tile: 8 per lane
constexpr int kHalfN = 128;    // the second float4 group of a lane
constexpr int kTileK = 16;     // M0 rows staged per step
constexpr int kMaxNP = 16;     // parameter dims per sample
constexpr int kMaxSmem = 232448;  // 227 KB per block on sm_90

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory layout, in 4-byte words (keep in step with the wrapper's
// _smem_bytes in pgdrome_tpu_torch/ops/fused_sweep.py):
//   Fs    Kp * (ROWS + 4)    factor tile, k-major; +4 pads the row stride
//                            so stores along k hit 8 banks, not 1
//   Ms    2 * kTileK * kTileN    double-buffered M0 tile
//   w     ROWS * NP * 3      basis weights per (row, dim)
//   base  ROWS * NP          first dof per (row, dim)
//   grid  4 * kMaxNP         x0, 1/h, ncell, degree per dim
__host__ __device__ inline int fs_stride(int rpw) { return 8 * rpw + 4; }

__host__ __device__ inline long long smem_words(int K, int rpw, int NP) {
  const int Kp = round_up(K, kTileK);
  const int rows = 8 * rpw;
  return (long long)Kp * fs_stride(rpw) + 2 * kTileK * kTileN + (long long)rows * NP * 4 +
         4 * kMaxNP;
}

// Cell locate + Lagrange basis on a uniform grid, in f32, in the TPU
// kernel's order of operations.  A NaN sample yields cell 0 and NaN weights
// (so a NaN output), never an out-of-range dof.
__device__ inline void locate(float x, float x0, float inv_h, float ncell, int deg,
                              int* base, float* w0, float* w1, float* w2) {
  const float t = (x - x0) * inv_h;
  const float c = fminf(fmaxf(floorf(t), 0.0f), ncell - 1.0f);
  const float xi = t - c;
  *base = deg * (int)c;
  if (deg == 1) {
    *w0 = 1.0f - xi;
    *w1 = xi;
    *w2 = 0.0f;
  } else {
    *w0 = (1.0f - xi) * (1.0f - 2.0f * xi);
    *w1 = 4.0f * xi * (1.0f - xi);
    *w2 = xi * (2.0f * xi - 1.0f);
  }
}

// One factor value from the located rows: prod_j sum_l w_l T_j[base+l, k].
// base/w hold the row's (first dof, 3 weights) per dim; degf the degrees.
__device__ inline float factor_value(const float* __restrict__ tabs, int ndofp, int K,
                                     int k, int NP, const int* base, const float* w,
                                     const float* degf) {
  float f = 1.0f;
  for (int j = 0; j < NP; ++j) {
    const float* T = tabs + ((size_t)j * ndofp + base[j]) * K + k;
    float v = w[3 * j] * __ldg(T) + w[3 * j + 1] * __ldg(T + K);
    if (degf[j] == 2.0f) v += w[3 * j + 2] * __ldg(T + 2 * K);
    f *= v;
  }
  return f;
}

// The tile kernel's first phases: load the grid, locate the block's ROWS
// samples, and fill the factor tile Fs (Kp x ROWS, stride FS).
// Ends with a barrier.
template <int RPW>
__device__ inline void build_factor_tile(const float* __restrict__ samples,
                                         const float* __restrict__ grid,
                                         const float* __restrict__ tabs, long long B,
                                         int NP, int ndofp, int K, int n_modes,
                                         long long row0, float* Fs, float* s_w,
                                         int* s_base, float* s_grid) {
  constexpr int ROWS = 8 * RPW;
  constexpr int FS = 8 * RPW + 4;
  const int tid = threadIdx.x;
  const int Kp = round_up(K, kTileK);
  for (int i = tid; i < 4 * NP; i += kThreads) s_grid[i] = grid[i];
  __syncthreads();
  for (int i = tid; i < ROWS * NP; i += kThreads) {
    const int r = i / NP, j = i - r * NP;
    const long long b = row0 + r;
    // rows past B are located at 0 (a valid cell) and masked below
    const float x = b < B ? samples[b * NP + j] : 0.0f;
    locate(x, s_grid[j], s_grid[NP + j], s_grid[2 * NP + j], (int)s_grid[3 * NP + j],
           &s_base[i], &s_w[3 * i], &s_w[3 * i + 1], &s_w[3 * i + 2]);
  }
  __syncthreads();
  for (int i = tid; i < ROWS * Kp; i += kThreads) {
    const int r = i / Kp, k = i - r * Kp;  // k fastest: coalesced table rows
    float f = 0.0f;
    if (k < n_modes && row0 + r < B)
      f = factor_value(tabs, ndofp, K, k, NP, s_base + r * NP, s_w + 3 * r * NP,
                       s_grid + 3 * NP);
    Fs[k * FS + r] = f;
  }
  __syncthreads();
}

template <typename T>
__device__ inline void store(T* p, float v);
template <>
__device__ inline void store<float>(float* p, float v) { *p = v; }
template <>
__device__ inline void store<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The product over one staged 16-k tile: part[i][c] += F[k, row i] *
// M0[k, col c] for the warp's RPW rows and the lane's 4*GROUPS columns.
template <int RPW, int GROUPS>
__device__ inline void tile_product(const float* Fs, const float* Mb, int kt, int warp,
                                    int lane, float (&part)[RPW][8]) {
  constexpr int FS = 8 * RPW + 4;
#pragma unroll 4
  for (int kk = 0; kk < kTileK; ++kk) {
    const float* frow = Fs + (size_t)(kt + kk) * FS + warp * RPW;
    float a[RPW];
    if constexpr (RPW % 4 == 0) {
#pragma unroll
      for (int q = 0; q < RPW / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(frow)[q];
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < RPW; ++i) a[i] = frow[i];
    }
    float bcol[8];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const float4 v = reinterpret_cast<const float4*>(Mb + kk * kTileN + g * kHalfN)[lane];
      bcol[4 * g] = v.x;
      bcol[4 * g + 1] = v.y;
      bcol[4 * g + 2] = v.z;
      bcol[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 4 * GROUPS; ++j) part[i][j] = fmaf(a[i], bcol[j], part[i][j]);
  }
}

template <int RPW, typename OutT>
__global__ void __launch_bounds__(kThreads)
sweep_tile_kernel(const float* __restrict__ samples, const float* __restrict__ grid,
                  const float* __restrict__ tabs, const float* __restrict__ m0,
                  OutT* __restrict__ out, long long B, int NP, int ndofp, int K,
                  int n_modes, int n0) {
  constexpr int ROWS = 8 * RPW;
  constexpr int FS = 8 * RPW + 4;
  constexpr int kLoads = kTileK * kTileN / kThreads;  // 16 M0 words per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Kp = round_up(K, kTileK);
  float* Fs = smem;
  float* Ms = Fs + (size_t)Kp * FS;
  float* s_w = Ms + 2 * kTileK * kTileN;
  int* s_base = reinterpret_cast<int*>(s_w + ROWS * NP * 3);
  float* s_grid = reinterpret_cast<float*>(s_base + ROWS * NP);

  const long long row0 = (long long)blockIdx.x * ROWS;
  build_factor_tile<RPW>(samples, grid, tabs, B, NP, ndofp, K, n_modes, row0, Fs, s_w,
                         s_base, s_grid);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Thread tid stages column tid of the tile for each of the 16 k rows.
  // M0 rows at or past n_modes are read as 0: padded-buffer rows never
  // contribute, even when they hold non-finite values.
  auto load_m0 = [&](int kt, int n_base, float* regs) {
    const int col = n_base + tid;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int k = kt + i;
      regs[i] = (k < n_modes && col < n0) ? __ldg(m0 + (size_t)k * n0 + col) : 0.0f;
    }
  };
  auto store_m0 = [&](float* dst, const float* regs) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) dst[i * kTileN + tid] = regs[i];
  };

  for (int n_base = 0; n_base < n0; n_base += kTileN) {
    const bool both = n_base + kHalfN < n0;  // block-uniform
    float acc[RPW][8];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    float regs[kLoads];
    load_m0(0, n_base, regs);
    store_m0(Ms, regs);
    __syncthreads();
    int buf = 0;
    for (int kt = 0; kt < Kp; kt += kTileK) {
      const bool has_next = kt + kTileK < Kp;
      if (has_next) load_m0(kt + kTileK, n_base, regs);
      const float* Mb = Ms + buf * kTileK * kTileN;
      // blocked summation: each 16-k step sums into its own partial, then
      // into acc — the rounding error grows with 16 + K/16, not K
      float part[RPW][8];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = 0.0f;
      if (both)
        tile_product<RPW, 2>(Fs, Mb, kt, warp, lane, part);
      else
        tile_product<RPW, 1>(Fs, Mb, kt, warp, lane, part);
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
      if (has_next) store_m0(Ms + (buf ^ 1) * kTileK * kTileN, regs);
      buf ^= 1;
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const long long b = row0 + warp * RPW + i;
      if (b >= B) continue;
      OutT* orow = out + b * n0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n_base + (j / 4) * kHalfN + 4 * lane + (j % 4);
        if (col < n0) store<OutT>(orow + col, acc[i][j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_factors_kernel(const float* __restrict__ samples, const float* __restrict__ grid,
                     const float* __restrict__ tabs, float* __restrict__ out,
                     long long B, int NP, int ndofp, int K, int n_modes) {
  __shared__ float s_grid[4 * kMaxNP];
  for (int i = threadIdx.x; i < 4 * NP; i += kThreads) s_grid[i] = grid[i];
  __syncthreads();
  const long long total = B * (long long)K;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const long long b = e / K;
    const int k = (int)(e - b * K);
    float f = 0.0f;
    if (k < n_modes) {
      f = 1.0f;
      for (int j = 0; j < NP; ++j) {
        int base;
        float w0, w1, w2;
        const int deg = (int)s_grid[3 * NP + j];
        locate(samples[b * NP + j], s_grid[j], s_grid[NP + j], s_grid[2 * NP + j], deg,
               &base, &w0, &w1, &w2);
        const float* T = tabs + ((size_t)j * ndofp + base) * K + k;
        float v = w0 * __ldg(T) + w1 * __ldg(T + K);
        if (deg == 2) v += w2 * __ldg(T + 2 * K);
        f *= v;
      }
    }
    out[e] = f;
  }
}

bool args_ok(long long B, int NP, int ndofp, int K, int n_modes, int rpw) {
  return B >= 0 && NP >= 1 && NP <= kMaxNP && ndofp >= 2 && K >= 1 && n_modes >= 0 &&
         n_modes <= K && (rpw == 1 || rpw == 2 || rpw == 4 || rpw == 8);
}

template <int RPW, typename OutT>
int launch_rows(const float* samples, const float* grid, const float* tabs,
                const float* m0, void* out, long long B, int NP, int ndofp, int K,
                int n_modes, int n0, cudaStream_t stream) {
  const long long words = smem_words(K, RPW, NP);
  if (words * 4 > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int smem = (int)(words * 4);
  auto kernel = sweep_tile_kernel<RPW, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (B + 8 * RPW - 1) / (8 * RPW);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0)
    kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
        samples, grid, tabs, m0, static_cast<OutT*>(out), B, NP, ndofp, K, n_modes, n0);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(const float* samples, const float* grid, const float* tabs, const float* m0,
           void* out, long long B, int NP, int ndofp, int K, int n_modes, int n0,
           int rpw, cudaStream_t stream) {
  switch (rpw) {
    case 8:
      return launch_rows<8, OutT>(samples, grid, tabs, m0, out, B, NP, ndofp, K, n_modes,
                                  n0, stream);
    case 4:
      return launch_rows<4, OutT>(samples, grid, tabs, m0, out, B, NP, ndofp, K, n_modes,
                                  n0, stream);
    case 2:
      return launch_rows<2, OutT>(samples, grid, tabs, m0, out, B, NP, ndofp, K, n_modes,
                                  n0, stream);
    default:
      return launch_rows<1, OutT>(samples, grid, tabs, m0, out, B, NP, ndofp, K, n_modes,
                                  n0, stream);
  }
}

}  // namespace

extern "C" {

// samples (B, NP) f32; grid (4, NP) f32 rows x0, 1/h, ncell, degree; tabs
// (NP, ndofp, K) f32; m0 (K, n0) f32; out (B, n0) f32 (out_bf16 == 0) or
// bf16; rpw rows per warp (1, 2, 4 or 8).  All pointers on the current
// device, all arrays C-contiguous.
int pgd_sweep_tile(const void* samples, const void* grid, const void* tabs,
                   const void* m0, void* out, long long B, int NP, int ndofp, int K,
                   int n_modes, int n0, int out_bf16, int rpw, void* stream) {
  if (!args_ok(B, NP, ndofp, K, n_modes, rpw) || n0 < 1) return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const float*>(samples);
  const auto* g = static_cast<const float*>(grid);
  const auto* t = static_cast<const float*>(tabs);
  const auto* m = static_cast<const float*>(m0);
  auto st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(s, g, t, m, out, B, NP, ndofp, K, n_modes, n0,
                                          rpw, st)
                  : launch<float>(s, g, t, m, out, B, NP, ndofp, K, n_modes, n0, rpw, st);
}

// The masked factors themselves: out (B, K) f32.
int pgd_sweep_factors(const void* samples, const void* grid, const void* tabs, void* out,
                      long long B, int NP, int ndofp, int K, int n_modes, void* stream) {
  if (!args_ok(B, NP, ndofp, K, n_modes, 1)) return (int)cudaErrorInvalidValue;
  const long long total = B * (long long)K;
  if (total > 0) {
    const long long want = (total + kThreads - 1) / kThreads;
    const unsigned blocks = (unsigned)(want < 132LL * 64 ? want : 132LL * 64);
    sweep_factors_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(samples), static_cast<const float*>(grid),
        static_cast<const float*>(tabs), static_cast<float*>(out), B, NP, ndofp, K,
        n_modes);
  }
  return (int)cudaGetLastError();
}

const char* pgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Vademecum sweep for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel pgdrome_tpu/ops/pallas_kernels.py::make_fused_sweep
// (:44; Pallas body :116-152, launch :164-179).  For samples s (B, NP), per
// parameter dim j a uniform 1D grid (x0, 1/h, ncell, degree 1 or 2) with a
// mode table T_j (ndof_j, K), and a dim-0 table M0 (K, n0):
//
//   F[b, k]   = [k < n_modes] * prod_j sum_l phi_l(xi_bj) T_j[deg_j*c_bj + l, k]
//   out[b, :] = sum_k F[b, k] M0[k, :]
//
// with c = clip(floor((s - x0)/h), 0, ncell-1) and xi = (s - x0)/h - c,
// exactly the TPU kernel's arithmetic.  The TPU kernel fused both lines to
// keep F out of HBM; here they are two kernels, because a round trip of F
// through HBM costs less on this card than what the fusion costs (a factor
// stage held to the product's occupancy, a product held off the tensor
// cores).  Entry points:
//
//   pgd_sweep_factors  stage 1: F split into tf32 hi/lo halves in two
//                      (B, ldf) buffers, ldf >= K, columns past n_modes
//                      zero; or F itself (B, K): the factor wiring behind
//                      moments (the TPU wiring's identity M0 is skipped).
//   pgd_sweep_gemm     stage 2: out (rows, n0) = F (rows, Kp) . M0 from the
//                      split F and a split, transposed, masked M0 table
//                      (n0, Kp); f32 or bf16 store.
//
// What bounds each stage on an H100.  Stage 1 is elementwise over (b, k):
// NP cell locates and 2-3 table-row gathers per element from L2 (the
// tables, NP*ndof*K*4 = 1.65 MB at K=640, stay there) and the F write; it
// runs at full occupancy (no shared memory, ~32 registers), so the gathers
// overlap.  Stage 2 is a GEMM of 2*K*n0 FLOPs per sample (2.62 MFLOP at
// K=640, n0=2049), bound by tensor-core FLOPs at the field width and by
// the F read at the sensor width (n0 = 8).  Its 128 x 128 tile rereads the
// split F and M0 from L2 once per output tile: ~48 FLOP (3 passes) per L2
// byte, so at the tf32 peak it would need ~10 TB/s of L2 (not measured
// on this card; one suspect for the GEMM's 58 % of the tf32 peak, with the
// wait per 16-k group below); larger tiles or multicast clusters would
// cut it.
//
// Stage 2 runs on the tensor cores in split TF32 (3xTF32): each f32 operand
// x is held as hi = rn_tf32(x) and lo = rn_tf32(x - hi), so
// |x - hi - lo| <= 2^-22 |x|, and F.M0 = hi.hi + hi.lo + lo.hi up to a
// dropped lo.lo of 2^-22 per product.  The tf32 wgmma's f32 accumulation is
// not assumed to round to nearest (published measurements of NVIDIA MMA
// units found truncating alignment of addends), so its reach is cut short:
// every 16-k group (kGroupK) starts a fresh accumulator (scale_d = 0), and
// the group partials are summed into a register total with ordinary
// round-to-nearest FADDs (blocked summation).  Within a group the cross
// terms go first, while the partial sum is small.  Measured on an H100
// with chip_smoke.py (PERF.md 6.1): every output stays within 4.5 % of its
// f32 rounding bound at 16, 32 or 64 k per fresh accumulator, but the
// served d=5 fields' error against FEM at the 32 inset corners (6.93e-7
// for an f64 product, 7.14e-7 for the f32 FMA kernel this one replaced)
// was 8.25e-7 at 16 k, 1.02e-6 at 32 k and 1.10e-6 at 64 k: the sum
// cancels heavily, so a biased accumulator error shows where a rounding
// bound does not.  Hence 16 k.
// The rounding of hi/lo is the integer form of cvt.rna.tf32.f32 (ties
// away from zero), bit for bit the plain split_tf32 in ops/fused_sweep.py,
// except that a value that would round to infinity is truncated instead.
//
// Stage 2's shape is Hopper's: a block of three warpgroups owns a 128 x BN
// output tile (BN = 128, or 8 for outputs of at most 32 columns).  One
// producer thread keeps a ring of shared-memory stages filled by TMA (each
// stage: A hi/lo 128 x 32 tf32, B hi/lo BN x 32, 128-byte swizzle,
// completed on an mbarrier); the two consumer warpgroups wait on a stage
// and issue its wgmma m64nBNk8 on their 64 rows in two commit groups of
// 16 k (3 passes x 2 k-steps each), each waited for before the next; a
// stage is released when both its groups are done.
// setmaxnreg gives the producer 40 registers and the consumers 232.  A
// version with a second accumulator set, to keep one group in flight while
// folding, compiled to 168 registers with 540 bytes of spills and ran the
// GEMM 2.6x slower; hence one accumulator and a wait per group.  The
// epilogue stores straight from the accumulator layout, masked at the
// ragged edges (n0 = 2049 rows are 8196 B apart, so no TMA store).  TMA's
// zero fill covers rows past the batch and k past Kp; M0 rows at or past
// n_modes are zero in the table (the wrapper builds it), as the TPU kernel
// folds its mask into m0.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns 0 on success, a CUDA error code, or
// kEncodeError + a CUresult when a tensor map cannot be encoded.  Tensor
// maps are encoded per call (the pointers change) through
// cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint, so the
// library links only the CUDA runtime.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // factor kernel block
constexpr int kMaxNP = 16;     // parameter dims per sample
constexpr int kMaxSmem = 232448;  // 227 KB per block on sm_90
constexpr int kEncodeError = 100000;

// ------------------------------------------------------------- stage 1

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

// Round a finite f32 to tf32 (10 stored mantissa bits), nearest, ties away
// from zero; a value that would round to infinity is truncated.
__device__ __forceinline__ float round_tf32(float x) {
  const uint32_t u = __float_as_uint(x);
  uint32_t h = (u + 0x1000u) & 0xffffe000u;
  if ((h & 0x7f800000u) == 0x7f800000u) h = u & 0xffffe000u;
  return __uint_as_float(h);
}

__device__ __forceinline__ void split_tf32(float x, float* hi, float* lo) {
  if (!isfinite(x)) {
    *hi = x;
    *lo = 0.0f;
    return;
  }
  *hi = round_tf32(x);
  *lo = round_tf32(x - *hi);  // x - hi is exact
}

// kSplit: store the tf32 halves of F in out and out_lo, rows ldf apart
// (the GEMM's A operand); otherwise F itself in out, rows K apart (the
// factor wiring, in the TPU kernel's arithmetic and layout).
template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
sweep_factors_kernel(const float* __restrict__ samples, const float* __restrict__ grid,
                     const float* __restrict__ tabs, float* __restrict__ out,
                     float* __restrict__ out_lo, long long B, int NP, int ndofp, int K,
                     int n_modes, int ldf) {
  __shared__ float s_grid[4 * kMaxNP];
  for (int i = threadIdx.x; i < 4 * NP; i += kThreads) s_grid[i] = grid[i];
  __syncthreads();
  const int row = kSplit ? ldf : K;
  const long long total = B * (long long)row;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kThreads) {
    const long long b = e / row;
    const int k = (int)(e - b * row);
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
    if constexpr (kSplit) {
      float hi, lo;
      split_tf32(f, &hi, &lo);
      out[e] = hi;
      out_lo[e] = lo;
    } else {
      out[e] = f;
    }
  }
}

// ------------------------------------------------------------- stage 2

constexpr int kBM = 128;               // output rows per block: 2 x 64
constexpr int kBoxK = 32;              // k per stage: one 128-byte swizzle row
constexpr int kGemmThreads = 384;      // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kATileBytes = kBM * kBoxK * 4;  // 16 KiB
constexpr int kGroupK = 16;            // k per fresh accumulator (see the header)
constexpr int kGroups = kBoxK / kGroupK;  // groups per stage
static_assert(kGroupK == 16, "issue_group issues two k8 steps per group");
constexpr long long kHangCycles = 20000000000LL;  // ~10 s: a lost barrier traps

template <int BN>
struct GemmShape {
  static constexpr int kBTileBytes = BN * kBoxK * 4;
  static constexpr int kStageBytes = 2 * kATileBytes + 2 * kBTileBytes;
  static constexpr int kStages = BN >= 64 ? 3 : 6;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
  static_assert(kSmem <= kMaxSmem, "stage ring exceeds shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the phase of the given parity to complete.  A barrier that never
// completes (a fault in the pipeline) traps after ~10 s instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 B, 8-row groups 1024 B apart (SBO); LBO is unused.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32, in registers) = [D +] A (64 x 8 tf32) . B (N x 8 tf32)^T
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// One 16-k group of a stage (`half` 0 or 1) into a fresh accumulator: the
// cross passes hi.lo and lo.hi first, while the sum is small, then hi.hi;
// two k8 steps each, a k8 step being 32 bytes along the swizzled row (+2 in
// a descriptor).
template <int BN, int R>
__device__ __forceinline__ void issue_group(float (&acc)[R], uint64_t ahi, uint64_t alo,
                                            uint64_t bhi, uint64_t blo, int half) {
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int o = 2 * (2 * half + ks);
    Wgmma<BN>::mma(acc, ahi + o, blo + o, ks == 0 ? 0 : 1);
    Wgmma<BN>::mma(acc, alo + o, bhi + o, 1);
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int o = 2 * (2 * half + ks);
    Wgmma<BN>::mma(acc, ahi + o, bhi + o, 1);
  }
  wgmma_commit();
}

// Add a finished group into the total, in round-to-nearest FADDs.
template <int R>
__device__ __forceinline__ void fold(float (&tot)[R], float (&acc)[R]) {
  fence_operands(acc);
#pragma unroll
  for (int i = 0; i < R; ++i) tot[i] += acc[i];
}

template <typename T>
__device__ inline void store(T* p, float v);
template <>
__device__ inline void store<float>(float* p, float v) { *p = v; }
template <>
__device__ inline void store<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// out (rows, n0) = F (rows, Kp) . M0 (Kp, n0), from a_hi/a_lo over F's
// halves (box 32 x 128 rows) and b_hi/b_lo over M0^T's (n0, Kp) halves (box
// 32 x BN).  Block x = m_tile * n_tiles + n_tile, so neighbouring blocks
// share an F tile in L2.
template <int BN, typename OutT>
__global__ void __launch_bounds__(kGemmThreads, 1)
sweep_gemm_kernel(const __grid_constant__ CUtensorMap a_hi,
                  const __grid_constant__ CUtensorMap a_lo,
                  const __grid_constant__ CUtensorMap b_hi,
                  const __grid_constant__ CUtensorMap b_lo, OutT* __restrict__ out,
                  long long rows, int n0, int n_kb, int n_tiles) {
  using G = GemmShape<BN>;
  constexpr int S = G::kStages;
  constexpr int R = BN / 2;  // accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + S * G::kStageBytes;  // full[S], then empty[S]
  const int tid = threadIdx.x, wg = tid / 128;
  const int m_tile = blockIdx.x / n_tiles, n_tile = blockIdx.x - m_tile * n_tiles;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % S;
        if (kb >= S) mbar_wait(bars + 8 * (S + s), ((kb / S) - 1) & 1);
        const uint32_t st = base + s * G::kStageBytes, full = bars + 8 * s;
        mbar_expect_tx(full, G::kStageBytes);
        const int k = kb * kBoxK, ra = m_tile * kBM, rb = n_tile * BN;
        tma_load_2d(st, &a_hi, full, k, ra);
        tma_load_2d(st + kATileBytes, &a_lo, full, k, ra);
        tma_load_2d(st + 2 * kATileBytes, &b_hi, full, k, rb);
        tma_load_2d(st + 2 * kATileBytes + G::kBTileBytes, &b_lo, full, k, rb);
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64c .. 64c+63 of the tile.  Each
  // 16-k group is one commit group, waited for before the next is issued
  // (the other warpgroup keeps the tensor cores busy meanwhile), then
  // folded into the total.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int c = wg - 1;
  float acc[R], tot[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = tot[i] = 0.0f;
  const int n_groups = n_kb * kGroups;
  for (int g = 0; g < n_groups; ++g) {
    const int kb = g / kGroups, half = g % kGroups, s = kb % S;
    if (half == 0) mbar_wait(bars + 8 * s, (kb / S) & 1);
    const uint32_t st = base + s * G::kStageBytes;
    const uint64_t ahi = smem_desc(st + c * 64 * 128);
    const uint64_t alo = smem_desc(st + kATileBytes + c * 64 * 128);
    const uint64_t bhi = smem_desc(st + 2 * kATileBytes);
    const uint64_t blo = smem_desc(st + 2 * kATileBytes + G::kBTileBytes);
    issue_group<BN>(acc, ahi, alo, bhi, blo, half);
    wgmma_wait<0>();
    fold(tot, acc);
    if (half == kGroups - 1) mbar_arrive(bars + 8 * (S + s));
  }

  // accumulator layout: warp w of the group holds rows 16w + lane/4 (+8),
  // columns 8j + 2(lane%4) (+1) in registers 4j (+1), (+2, +3 for row+8)
  const int w = (tid % 128) / 32, lane = tid % 32;
  const long long r0 = (long long)m_tile * kBM + c * 64 + 16 * w + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n_tile * BN + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = r0 + 8 * h;
      if (row >= rows) continue;
      OutT* orow = out + row * n0;
      if (col < n0) store<OutT>(orow + col, tot[4 * j + 2 * h]);
      if (col + 1 < n0) store<OutT>(orow + col + 1, tot[4 * j + 2 * h + 1]);
    }
  }
}

// -------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return (int)cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A (rows, Kp) row-major f32 array seen as tiles of box_rows x 32,
// 128-byte swizzled; out-of-range reads fill zeros.
int tile_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, long long rows, int Kp,
             int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int BN, typename OutT>
int launch_gemm(const void* f_hi, const void* f_lo, const void* t_hi, const void* t_lo,
                void* out, long long rows, int Kp, int n0, cudaStream_t stream) {
  EncodeTiled encode;
  int rc = encoder(&encode);
  if (rc != 0) return rc;
  CUtensorMap a_hi, a_lo, b_hi, b_lo;
  if ((rc = tile_map(encode, &a_hi, f_hi, rows, Kp, kBM)) != 0) return rc;
  if ((rc = tile_map(encode, &a_lo, f_lo, rows, Kp, kBM)) != 0) return rc;
  if ((rc = tile_map(encode, &b_hi, t_hi, n0, Kp, BN)) != 0) return rc;
  if ((rc = tile_map(encode, &b_lo, t_lo, n0, Kp, BN)) != 0) return rc;
  auto kernel = sweep_gemm_kernel<BN, OutT>;
  const int smem = GemmShape<BN>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n0 + BN - 1) / BN;
  const long long blocks = (rows + kBM - 1) / kBM * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_kb = (Kp + kBoxK - 1) / kBoxK;
  kernel<<<(unsigned)blocks, kGemmThreads, smem, stream>>>(
      a_hi, a_lo, b_hi, b_lo, static_cast<OutT*>(out), rows, n0, n_kb, n_tiles);
  return (int)cudaGetLastError();
}

template <typename OutT>
int gemm_for_width(const void* f_hi, const void* f_lo, const void* t_hi, const void* t_lo,
                   void* out, long long rows, int Kp, int n0, cudaStream_t stream) {
  if (n0 <= 32) return launch_gemm<8, OutT>(f_hi, f_lo, t_hi, t_lo, out, rows, Kp, n0, stream);
  return launch_gemm<128, OutT>(f_hi, f_lo, t_hi, t_lo, out, rows, Kp, n0, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Stage 1.  samples (B, NP) f32; grid (4, NP) f32 rows x0, 1/h, ncell,
// degree; tabs (NP, ndofp, K) f32; out (B, K) f32: F; or, when out_lo is
// not null, out and out_lo (B, ldf), ldf >= K: F's tf32 hi and lo halves.
// Columns k >= n_modes are zero.  All pointers on the current device, all
// arrays C-contiguous.
int pgd_sweep_factors(const void* samples, const void* grid, const void* tabs, void* out,
                      void* out_lo, long long B, int NP, int ndofp, int K, int n_modes,
                      int ldf, void* stream) {
  if (B < 0 || NP < 1 || NP > kMaxNP || ndofp < 2 || K < 1 || n_modes < 0 || n_modes > K ||
      ldf < K || (out_lo == nullptr && ldf != K))
    return (int)cudaErrorInvalidValue;
  const long long total = B * (long long)ldf;
  if (total > 0) {
    const long long want = (total + kThreads - 1) / kThreads;
    const unsigned blocks = (unsigned)(want < 132LL * 64 ? want : 132LL * 64);
    auto kernel = out_lo ? sweep_factors_kernel<true> : sweep_factors_kernel<false>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(samples), static_cast<const float*>(grid),
        static_cast<const float*>(tabs), static_cast<float*>(out),
        static_cast<float*>(out_lo), B, NP, ndofp, K, n_modes, ldf);
  }
  return (int)cudaGetLastError();
}

// Stage 2.  f_hi, f_lo (rows, Kp) f32: the split factors; t_hi, t_lo
// (n0, Kp) f32: the split M0^T with rows k >= n_modes zero; out (rows, n0)
// f32 (out_bf16 == 0) or bf16.  Kp is a multiple of 8.
int pgd_sweep_gemm(const void* f_hi, const void* f_lo, const void* t_hi, const void* t_lo,
                   void* out, long long rows, int Kp, int n0, int out_bf16, void* stream) {
  if (rows < 0 || Kp < 8 || Kp % 8 != 0 || n0 < 1 || rows > 0xffffffffLL || !aligned16(f_hi) || !aligned16(f_lo) || !aligned16(t_hi) ||
      !aligned16(t_lo))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  auto st = static_cast<cudaStream_t>(stream);
  return out_bf16
             ? gemm_for_width<__nv_bfloat16>(f_hi, f_lo, t_hi, t_lo, out, rows, Kp, n0, st)
             : gemm_for_width<float>(f_hi, f_lo, t_hi, t_lo, out, rows, Kp, n0, st);
}

// Dynamic shared memory of a GEMM launch for outputs n0 wide, in bytes
// (ptxas -v reports static shared memory only).
int pgd_sweep_gemm_smem(int n0) {
  return n0 <= 32 ? GemmShape<8>::kSmem : GemmShape<128>::kSmem;
}

const char* pgd_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed (code - 100000 is the CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

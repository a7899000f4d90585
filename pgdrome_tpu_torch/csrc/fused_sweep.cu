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
// with c = clip(floor((s - x0)/h), 0, ncell-1) and xi = (s - x0)/h - c.
// The factors are computed in the plain version's order of operations
// (ops/fused_sweep.py::fused_sweep_plain), every operation rounded on its
// own (__fmul_rn, __fadd_rn, __fsub_rn: no FMA contraction), so F equals
// the plain f32 factors bit for bit.  Entry points:
//
//   pgd_sweep_factors  stage 1, three modes: F itself (B, K), the factor
//                      wiring behind moments (the TPU wiring's identity M0
//                      is skipped); F split into tf32 hi/lo halves in two
//                      (B, ldf) buffers for the GEMM (fields), the first
//                      kHead columns held whole in hi (lo zero); or the narrow
//                      product out (B, n0 <= 32) = F . M0 fused in
//                      (sweep_narrow_kernel; sensors: F never reaches HBM,
//                      as in the TPU kernel).
//   pgd_sweep_gemm     stage 2: out (rows, n0) = F (rows, Kp) . M0 from the
//                      split F and a split, transposed, masked M0 table
//                      (n0, Kp) for k >= kHead, plus the head k < kHead
//                      in f32 FMAs from the whole F columns and an f32
//                      (kHead, round4(n0)) table; f32 or bf16 store
//                      (fields, n0 > 32).
//
// Stage 1's design.  Per element it gathers 2-3 table values per dim, so
// its limit is where the gathers land and how many warps hide their
// latency.  A block owns a tile of S sample rows (a multiple of its
// threads, up to 2048) and walks the K columns in slices of KS (32, 16, 8
// or 4): the wrapper lays the tables out as (n_slices, NP*ndofp, KS), so
// one slice of all NP tables is one contiguous block, copied into a ring
// of two shared-memory stages by one cp.async.bulk, completed on an
// mbarrier; the next-but-one slice is in flight while a stage is read.
// Every gather then reads shared memory (at the d=5 widths a stage is
// 5*129*32*4 = 82.6 KB, and each tile streams the 1.65 MB of tables once
// from L2).  The tile's samples are read once, coalesced, into shared
// memory.  Within a slice a sample row is owned by KS/4 neighbouring
// lanes, each with 4 columns (a float4 of each table row: a quarter-warp
// reads contiguous bytes, so no bank conflicts at KS = 32); the lanes
// share the cell locates of the row's NP dims (lane g locates dims g,
// g + KS/4, ... and hands them round by shuffle), so a locate runs once
// per (sample, dim, slice), and a tile index, not a division, finds the
// row.  F is stored with 16-byte streaming stores (__stcs: written once,
// read once); columns at or past n_modes are zero without a gather.  A
// block that stores F has 1024 threads (32 registers each): measured on
// an H100 (PERF.md 6.1), 256-thread blocks ran the d=5 factor wiring at
// 13.9 ms and 1024-thread ones at 7.1 ms, with the same arithmetic.  The
// wrapper picks KS and S from the shared memory they need
// (ops/fused_sweep.py::factor_plan); tables too wide for two stages even
// at KS = 4 take the global route, the same kernel reading its gathers
// from the sliced tables in global memory (L2) instead of a stage --
// chosen by shape before launch, never on a failure.
//
// The grid is 2D: row tiles (blockIdx.x) x k-ranges (blockIdx.y), each
// block staging only its own range's slices through the same ring.  A
// launch of at least one tile an SM (pgd_sm_count: 132 on an H100 SXM)
// keeps one range, the launch of the 1D design, which was built for
// 0.5-4 M-row batches.  A smaller one -- the d=10 corners (1,024 rows of
// K = 2717 ran as one block on one SM, 2.35 ms: PERF.md 6.1), the dual's
// 1,360 samples, the posterior's 64 chains, a call's last row chunk --
// shortens its tiles, down to one pass of the block's threads, towards
// two blocks an SM, then splits the slices into k-ranges until there are
// about two blocks an SM (ops/fused_sweep.py::factor_grid, from the
// launch's own rows and slices).
// F's columns are disjoint, so F and its split are bit for bit the same
// on any grid.
//
// The narrow product (sensors: n0 <= 32; sweep_narrow_kernel) keeps F and
// its sums in registers.  Its limit is the gathers: at the d=5 widths each
// (sample, mode) reads 2 table rows x NP dims x 4 bytes = 40 bytes of
// shared memory, 107 GB for 4,194,304 samples x 640 modes, about 3.2 ms at
// 128 bytes a clock an SM (a data-sheet rate; the arithmetic is under 1 ms
// at the f32 peak).  So it spends shared memory on the gathers alone:
//  - a block of 16 warps walks its tile's k-slices through the same
//    two-stage ring, the slice of the split M0 table staged beside the
//    tables; each warp keeps the accumulators of its m16 x n8 output tiles
//    in registers (4 a tile a thread, 8 tiles a warp: up to 2048 rows at
//    n0 <= 8, 1024 at 16, 512 at 32);
//  - each lane computes exactly the F values of its tensor-core A
//    fragments (two rows, four columns of each 16-k group; the k order
//    inside a group is permuted to match, and the wrapper lays M0's rows
//    out the same way), so F goes from the gathers to mma.sync m16n8k8
//    TF32 without leaving registers;
//  - each (row, dim)'s cell is located once a tile (its table-row offset
//    and xi, 8 bytes in shared memory), not once a slice;
//  - the last warp done with a stage refills it (a count in shared
//    memory), so no block barrier stops the warps between slices;
//  - at ks = 32 the lanes of odd rows gather the slice's second group
//    first, so a quarter-warp's two rows read both halves of their
//    128-byte table rows (no bank conflict); ks = 16 only where 32 does
//    not fit.
// Measured on an H100 (PERF.md 6.1, d=5 sensors, seeded tables, ms): the
// first version (shared F tile and accumulator, two barriers a 512-row
// chunk) 15.68; registers, a barrier a slice, a locate a slice 6.78;
// cells located once a tile 5.39-5.57; the tf32 split in integer
// operations instead of cvt.rna 5.03-5.20; no barrier 4.81-4.83
// (torch.matmul on a ready F: 4.86).  ks = 16 ran 6.4-7.9 at any tile
// height; a split that truncates hi and hands lo to the tensor cores
// unrounded saved 0.2 more, for 4x the error a product, and was not taken.
// The arithmetic contract is the GEMM's (below): 3xTF32 (both halves
// rounded to nearest) into a fresh accumulator a 16-k group, added to the
// total in round-to-nearest f32, and the first kHead modes in f32 FMAs
// from an f32 head table.  The head comes first here (the total starts as
// its FMA sum, k = kHead-1 down to 0), since the lanes hold F's head
// columns only while slice 0 is read.  Σ_l φ_l T_l is an FMA chain (one
// rounding fewer a term than the plain version).  F never reaches HBM.
// Its k splits into ranges (blockIdx.y) when the batch is small, as above,
// and on any batch whose modes pass K = 1024; a range is a power of two of
// slices, at most one 512-k chunk and never across a chunk boundary.  On
// more than one range each block stores its total as an f32 partial, and
// partial_sum_kernel adds the ranges in f64, rounding once.  One range
// stores the output itself.

// Stage 2 is a GEMM of 2*K*n0 FLOPs per sample (2.62 MFLOP at K=640,
// n0=2049), bound by tensor-core FLOPs at the field width.  Its 128 x 128
// tile rereads the split F and M0 from L2 once per output tile: ~48 FLOP
// (3 passes) per L2 byte, so at the tf32 peak it would need ~10 TB/s of L2
// (not measured on this card; one suspect for the GEMM's 58 % of the tf32
// peak, with the wait per 16-k group below); larger tiles or multicast
// clusters would cut it.
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
// for an f64 product, 7.14e-7 for an f32 FMA kernel) was 8.25e-7 at 16 k,
// 1.02e-6 at 32 k and 1.10e-6 at 64 k: the sum cancels heavily, so a
// biased accumulator error shows where a rounding bound does not.  Hence
// 16 k.  The group partials are summed in f32 over at most K_CHUNK = 512 k
// (16 stages): above K = 1024 each block sums one 512-k chunk
// (blockIdx.y), stores its f32 partial tile to a scratch buffer, and
// partial_sum_kernel adds the chunks in f64, rounding once.  A linear f32
// sum over all 170 groups of the d=10 vademecum (K = 2717) served 1.127e-6
// against FEM at its inset corners, where the f64 product of the same f32
// tables gives 8.88e-7 (PERF.md 6.1): the sum's reach, not the split, set
// the error.  At K <= 1024 there is one chunk and the kernel stores the
// total as before, bit for bit.  The narrow product (stage 1) does the
// same by k-ranges: above K = 1024 each range is at most one 512-k chunk.
//
// The head.  The first kHead = 8 modes do not go through the tensor
// cores: the factor kernel stores their F columns whole (hi = F, lo = 0),
// their rows of the split M0 table are zero, and the GEMM's epilogue adds
// F[r, k] M0[k, c] for k = kHead-1 down to 0 to the tensor-core total in
// round-to-nearest FMAs (in the blocks of the first k-chunk only).  The
// producer loads the tile's head operands, F (128 x kHead) and an f32 M0
// head table (kHead x 128), by TMA into shared memory before the first
// stage, so the epilogue reads them there.  The wrapper binds the modes
// with the kHead largest first (ops/fused_sweep.py::head_order; PGD modes
// mostly come so already), so the terms that set an output's rounding are
// summed as an f32 FMA sum sums them, largest last, and the split's 2^-22
// per product and the truncating accumulator touch only the tail.
// Without the head the served elasticity flagship (rank 32, no
// cancellation in its sum) sat 1.21x above the plain f32 version's error
// against FEM on an H100 (PERF.md 6.1, ROADMAP C3); with its 8 largest
// modes bound last, 1.49x (ROADMAP C4).  A 16-mode head read through the L1 in the epilogue added
// 18 % to the d=5 field GEMM (PERF.md 6.1).
// The rounding of hi/lo is the integer form of cvt.rna.tf32.f32 (ties
// away from zero), bit for bit the plain split_tf32 in ops/fused_sweep.py,
// except that a value that would round to infinity is truncated instead.
//
// Stage 2's shape is Hopper's: a block of three warpgroups owns a 128 x 128
// output tile.  One producer thread keeps a ring of shared-memory stages
// filled by TMA (each stage: A hi/lo 128 x 32 tf32, B hi/lo 128 x 32,
// 128-byte swizzle, completed on an mbarrier); the two consumer warpgroups
// wait on a stage and issue its wgmma m64n128k8 on their 64 rows in two
// commit groups of 16 k (3 passes x 2 k-steps each), each waited for
// before the next; a stage is released when both its groups are done.
// setmaxnreg gives the producer 40 registers and the consumers 232.  A
// version with a second accumulator set, to keep one group in flight while
// folding, compiled to 168 registers with 540 bytes of spills and ran the
// GEMM 2.6x slower; hence one accumulator and a wait per group.  TMA's
// zero fill covers rows past the batch and k past Kp; M0 rows at or past
// n_modes are zero in the table (the wrapper builds it), as the TPU kernel
// folds its mask into m0.
//
// The blocks are persistent, one an SM: block b walks the work items b,
// b + gridDim.x, .. of (k-chunk, m-tile, n-tile), the stage ring running
// on across items, so the producer loads the next item's stages (and its
// head tiles, once the epilogue has read the last) while the consumers
// fold, add the head and store.  At K = 30-32 (the elasticity flagship,
// its strain, the 3D vademecum) an item is one 32-k stage and the time is
// the store: the one-tile-a-block kernel wrote it straight from the
// fragment layout, 8 rows x 32 B an instruction on rows 8196-20736 B apart
// (no 16-byte multiple), 3.88 ms for a 2.54 GB batch whose byte bound is
// 0.76 ms (PERF.md 6.1).  The epilogue now stages each warpgroup's 64 x 128
// result through a 64 x 32 shared tile, rows swizzled as TMA's 128-byte
// swizzle (conflict-free fragment writes and row reads), four passes an
// item, each warp writing its 16 rows in stores as wide as the rows allow:
// 16 bytes a lane (4 rows x 32 columns an instruction) where the rows are
// 16-byte multiples (f32, n0 % 4 == 0), 8 bytes where they are 8-byte
// multiples (n0 even), else 4 (32 neighbouring columns of one row, 128
// contiguous bytes an instruction; a bf16 output too); the chunk partials
// go the same way (store_pass, the width a template argument: a loop over a
// run-time width cost the 3D and strain GEMMs ~18 % on an H100).  A TMA store
// a pass was tried for the aligned rows and lost: each pass must wait for
// the bulk copy to have read the staging before the next overwrites it,
// and there is no shared memory left for a second staging (H100, PERF.md
// 6.1: the n0 = 2048 GEMM 12.45 ms with TMA stores, 11.33 with 16-byte
// ones).  The arithmetic of an output is the one-tile kernel's: the same
// 16-k groups, 512-k chunks and head, so its bits are too (the served d=5
// and d=10 fields equal the one-tile kernel's bit for bit).
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns 0 on success, a CUDA error code, or
// kEncodeError + a CUresult when a tensor map cannot be encoded.  Tensor
// maps are encoded through cuTensorMapEncodeTiled, found with
// cudaGetDriverEntryPoint, so the library links only the CUDA runtime:
// the M0 table's three once per table (pgd_gemm_table_maps), F's and the
// store's per call (the pointers change); cudaFuncSetAttribute runs once
// per kernel instance and device.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxNP = 16;           // parameter dims per sample
constexpr int kMaxN0 = 32;           // widest output of the fused narrow product
constexpr int kHead = 8;             // leading modes summed in f32 FMAs (see the header)
static_assert(kHead % 4 == 0 && kHead <= 8, "the head is whole float4s of F rows, Kp >= 8");
constexpr int kMaxSmem = 232448;     // 227 KB per block on sm_90
constexpr int kFactorSmemMax = kMaxSmem - 1024;  // a factor launch's dynamic share
constexpr int kEncodeError = 100000;
constexpr long long kHangCycles = 20000000000LL;  // ~10 s: a lost barrier traps

// ------------------------------------------------------- barriers, copies

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

// Contiguous global -> shared copy of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completed on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------- stage 1

enum Mode { kFactors = 0, kSplit = 1 };

// Threads of a factor-kernel block writing F or its split: 32 warps (32
// registers a thread).
constexpr int kFactorThreads = 1024;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// The narrow product's block: 16 warps, each holding the accumulators of
// up to kNarrowTiles m16 x n8 output tiles (4 registers a thread each).
// A tile of rows is one m16 tile a warp (kNarrowPass = 256 rows) or a
// multiple of it, up to narrow_rows_max(n0).
constexpr int kNarrowThreads = 512;
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kNarrowPass = 16 * kNarrowWarps;
constexpr int kNarrowTiles = 8;
// Bytes after the narrow product's stages and cells: the two stage
// barriers and the two stages' counts of warps done reading them.
constexpr int kNarrowTail = 32;

// n8 column tiles of a narrow output n0 <= kMaxN0 wide (8, 16 or 32
// columns; a 24-wide output takes 32).
__host__ __device__ constexpr int narrow_nt(int n0) { return n0 <= 8 ? 1 : n0 <= 16 ? 2 : 4; }
__host__ __device__ constexpr int narrow_rows_max(int n0) {
  return kNarrowPass * (kNarrowTiles / narrow_nt(n0));
}

// Dynamic shared memory of a factor launch, in bytes.  F or its split
// (n0 = 0): two table stages (each NP*ndofp*ks floats) when staged, then
// the tile's samples.  The narrow product (n0 > 0): two stages of the
// tables and the slice's split M0 (2*ks*8*narrow_nt(n0) floats) when
// staged, the tile's located cells (rows*NP of (table row, xi), 8 bytes),
// then kNarrowTail bytes.  ops/fused_sweep.py::factor_smem is the same
// formula.
__host__ __device__ constexpr long long factor_smem(int NP, int ndofp, int ks, int rows, int n0,
                                                    bool staged) {
  return (staged ? 2LL * ((long long)NP * ndofp * ks +
                          (n0 > 0 ? 2LL * ks * 8 * narrow_nt(n0) : 0)) * 4
                 : 0) +
         (n0 > 0 ? 8LL * rows * NP + kNarrowTail : round4(rows * NP) * 4LL);
}

// Cell locate + Lagrange basis on a uniform grid, in f32, in the plain
// version's order of operations, each rounded on its own.  A NaN sample
// yields cell 0 and NaN weights (so a NaN output), never an out-of-range
// dof.
__device__ __forceinline__ void cell_of(float x, float x0, float inv_h, float ncell, int deg,
                                        int* base, float* xi) {
  const float t = __fmul_rn(__fsub_rn(x, x0), inv_h);
  const float c = fminf(fmaxf(floorf(t), 0.0f), ncell - 1.0f);
  *xi = __fsub_rn(t, c);
  *base = deg * (int)c;
}

__device__ __forceinline__ void basis_of(float xi, int deg, float* w0, float* w1, float* w2) {
  const float omx = __fsub_rn(1.0f, xi);
  if (deg == 1) {
    *w0 = omx;
    *w1 = xi;
    *w2 = 0.0f;
  } else {
    const float two_xi = __fmul_rn(2.0f, xi);
    *w0 = __fmul_rn(omx, __fsub_rn(1.0f, two_xi));
    *w1 = __fmul_rn(__fmul_rn(4.0f, xi), omx);
    *w2 = __fmul_rn(xi, __fsub_rn(two_xi, 1.0f));
  }
}

__device__ __forceinline__ void locate(float x, float x0, float inv_h, float ncell, int deg,
                                       int* base, float* w0, float* w1, float* w2) {
  float xi;
  cell_of(x, x0, inv_h, ncell, deg, base, &xi);
  basis_of(xi, deg, w0, w1, w2);
}

__device__ __forceinline__ float4 scale4(float a, float4 t) {
  return make_float4(__fmul_rn(a, t.x), __fmul_rn(a, t.y), __fmul_rn(a, t.z),
                     __fmul_rn(a, t.w));
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}
// a t + b, one rounding a column
__device__ __forceinline__ float4 fma4(float a, float4 t, float4 b) {
  return make_float4(__fmaf_rn(a, t.x, b.x), __fmaf_rn(a, t.y, b.y), __fmaf_rn(a, t.z, b.z),
                     __fmaf_rn(a, t.w, b.w));
}

template <bool kStaged>
__device__ __forceinline__ float4 load4(const float* p) {
  if constexpr (kStaged) return *reinterpret_cast<const float4*>(p);
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Columns k .. k+3 of one sample row's factors from one k-slice `tab`
// (NP*ndofp rows of KS floats, in shared memory or, off the staged route,
// global), the row's samples `samp`, and this lane's place g among the
// row's KS/4 lanes.  Every lane of the warp must call it (shuffles).
template <int KS, bool kStaged>
__device__ __forceinline__ float4 factor4(const float* samp, const float* s_grid,
                                          const float* tab, int NP, int ndofp, int g, int k,
                                          int n_modes) {
  constexpr int L = KS / 4;  // lanes per sample row
  float4 f = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  for (int j0 = 0; j0 < NP; j0 += L) {
    int base = 0;
    float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
    const int jj = j0 + g;
    if (jj < NP)
      locate(samp[jj], s_grid[jj], s_grid[NP + jj], s_grid[2 * NP + jj],
             (int)s_grid[3 * NP + jj], &base, &w0, &w1, &w2);
#pragma unroll
    for (int t = 0; t < L; ++t) {
      const int j = j0 + t;
      if (j >= NP) break;  // uniform across the warp
      const int b = __shfl_sync(0xffffffffu, base, t, L);
      const float a0 = __shfl_sync(0xffffffffu, w0, t, L);
      const float a1 = __shfl_sync(0xffffffffu, w1, t, L);
      const float a2 = __shfl_sync(0xffffffffu, w2, t, L);
      const float* T = tab + (j * ndofp + b) * KS + 4 * g;
      // Σ_l φ_l T_l in l order, then the product over dims in j order
      float4 v = add4(scale4(a0, load4<kStaged>(T)), scale4(a1, load4<kStaged>(T + KS)));
      if ((int)s_grid[3 * NP + j] == 2) v = add4(v, scale4(a2, load4<kStaged>(T + 2 * KS)));
      f = mul4(f, v);
    }
  }
  if (k + 0 >= n_modes) f.x = 0.0f;
  if (k + 1 >= n_modes) f.y = 0.0f;
  if (k + 2 >= n_modes) f.z = 0.0f;
  if (k + 3 >= n_modes) f.w = 0.0f;
  return f;
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
  *lo = round_tf32(__fsub_rn(x, *hi));  // x - hi is exact
}

// Columns k .. k+3 of F's row `row` into out (and out_lo), rows ld apart;
// columns at or past ld are not stored.  vec: 16-byte stores are aligned.
template <int kMode>
__device__ __forceinline__ void store_factors(float* out, float* out_lo, long long row, int ld,
                                              int k, float4 f, bool vec) {
  if (k >= ld) return;
  const long long at = row * ld + k;
  if constexpr (kMode == kSplit) {  // ld and k are multiples of 4
    float4 hi = f, lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k < kHead) {  // the head: whole, for the GEMM's FMA epilogue
      __stcs(reinterpret_cast<float4*>(out + at), hi);
      __stcs(reinterpret_cast<float4*>(out_lo + at), lo);
      return;
    }
    split_tf32(f.x, &hi.x, &lo.x);
    split_tf32(f.y, &hi.y, &lo.y);
    split_tf32(f.z, &hi.z, &lo.z);
    split_tf32(f.w, &hi.w, &lo.w);
    __stcs(reinterpret_cast<float4*>(out + at), hi);
    __stcs(reinterpret_cast<float4*>(out_lo + at), lo);
  } else if (vec && k + 4 <= ld) {
    __stcs(reinterpret_cast<float4*>(out + at), f);
  } else {
    const float v[4] = {f.x, f.y, f.z, f.w};
    for (int e = 0; e < 4 && k + e < ld; ++e) __stcs(out + at + e, v[e]);
  }
}

// One block per (tile of `S` sample rows, range of `range_slices` k-slices):
// blockIdx.x the tile, blockIdx.y the range (slices y*range_slices ..,
// clipped to the ceil(ld / KS) slices of F).  S is a multiple of the rows
// one pass of the block's threads covers.  tslices (n_slices, NP*ndofp,
// KS): the tables by k-slice, zero past K.  out: F (B, ld = K) or F's hi
// half (B, ld = ldf, out_lo the lo half).
template <int KS, int kMode, bool kStaged>
__global__ void __launch_bounds__(kFactorThreads)
sweep_factors_kernel(const float* __restrict__ samples, const float* __restrict__ grid,
                     const float* __restrict__ tslices, float* __restrict__ out,
                     float* __restrict__ out_lo, long long B, int NP, int ndofp, int n_modes,
                     int ld, int S, int vec, int range_slices) {
  constexpr int L = KS / 4;             // lanes per sample row
  constexpr int kRowsPerPass = kFactorThreads / L;
  extern __shared__ __align__(128) float smem[];
  __shared__ float s_grid[4 * kMaxNP];
  __shared__ __align__(8) uint64_t s_bar[2];

  const int tid = threadIdx.x, g = tid % L, lr = tid / L;
  const long long tile0 = (long long)blockIdx.x * S;
  const int rows = (int)(B - tile0 < S ? B - tile0 : S);
  const int tab_floats = NP * ndofp * KS;
  float* s_samp = smem + (kStaged ? 2 * tab_floats : 0);
  const int n_active = (n_modes + KS - 1) / KS;  // slices holding a mode
  const int n_slices = (ld + KS - 1) / KS;
  // this block's slices q0 .. q_end - 1; those that hold a mode end at a_end
  const int q0 = blockIdx.y * range_slices;
  const int q_end = min(q0 + range_slices, n_slices);
  const int a_end = min(q_end, n_active);
  const uint32_t bar0 = smem_u32(&s_bar[0]);

  if (kStaged && tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < 4 * NP; i += kFactorThreads) s_grid[i] = grid[i];
  const float* src = samples + tile0 * NP;
  for (int i = tid; i < S * NP; i += kFactorThreads) s_samp[i] = i < rows * NP ? src[i] : 0.0f;
  __syncthreads();

  // the block's i-th slice q0 + i goes to stage i % 2, its (i / 2)-th fill
  auto fill = [&](int q) {
    const int i = q - q0;
    const uint32_t bar = bar0 + 8 * (i & 1);
    mbar_expect_tx(bar, tab_floats * 4);
    bulk_load(smem_u32(smem + (i & 1) * tab_floats), tslices + (size_t)q * tab_floats,
              tab_floats * 4, bar);
  };
  if (kStaged && tid == 0)
    for (int q = q0; q < q0 + 2 && q < a_end; ++q) fill(q);

  for (int q = q0; q < q_end; ++q) {
    const int k = q * KS + 4 * g;  // this lane's first column
    if (q >= n_active) {           // every column at or past n_modes
      for (int p = 0; p < rows; p += kRowsPerPass)
        if (p + lr < rows)
          store_factors<kMode>(out, out_lo, tile0 + p + lr, ld, k, make_float4(0, 0, 0, 0),
                               vec);
      continue;
    }
    const float* tab;
    if constexpr (kStaged) {
      const int i = q - q0;
      mbar_wait(bar0 + 8 * (i & 1), (i >> 1) & 1);
      tab = smem + (i & 1) * tab_floats;
    } else {
      tab = tslices + (size_t)q * tab_floats;
    }
    for (int p = 0; p < rows; p += kRowsPerPass) {
      const int r = p + lr;
      const float4 f = factor4<KS, kStaged>(s_samp + r * NP, s_grid, tab, NP, ndofp, g, k,
                                            n_modes);
      if (r < rows) store_factors<kMode>(out, out_lo, tile0 + r, ld, k, f, vec);
    }
    if constexpr (kStaged) {
      __syncthreads();  // every thread is done with this stage
      if (tid == 0 && q + 2 < a_end) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        fill(q + 2);
      }
    }
  }
}

// ---------------------------------------------------- the narrow product

// Finite x rounded to tf32, nearest, ties away from zero (the integer
// form of cvt.rna, two integer operations; a value that would round past
// the largest f32 becomes infinity): the bits the tensor cores read.
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// D (16 x 8, f32) += A (16 x 8, tf32, row) . B (8 x 8, tf32, col) on the
// tensor cores, one warp.  Fragments (g = lane / 4, t = lane % 4): a0..a3
// hold A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b0, b1 hold B[t][g],
// B[t+4][g]; d0..d3 hold D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], float b0,
                                         float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// Columns 16i + 4t .. 16i + 4t + 3 of the factors of two sample rows (f0
// of the row whose located cells are loc0, f1 of loc1's), for each of the
// slice's KS/16 groups i, from the k-slice `tab` (NP*ndofp rows of KS
// floats).  loc: a row's (offset of its cell's first table row in a slice,
// as an int; xi) a dim, located once a tile; bit j of p2 marks a P2 dim.  The basis is the plain version's (basis_of);
// Σ_l φ_l T_l is an FMA chain (l ascending), the product over dims in j
// order; the two rows' chains are independent, interleaved for the
// latency.  With two groups, lanes of odd rows (swap = 1) gather group 1
// first, so the two rows of a quarter-warp read the two 64-byte halves of
// their 128-byte table rows at once (no bank conflict); f[i] is group i.
template <int KS, bool kStaged>
__device__ __forceinline__ void narrow_factors(const float2* loc0, const float2* loc1,
                                               uint32_t p2, const float* tab, int NP, int t,
                                               int swap,
                                               float4 (&f0)[KS / 16], float4 (&f1)[KS / 16]) {
  constexpr int G = KS / 16;
  float4 a0[G], a1[G];
#pragma unroll
  for (int i = 0; i < G; ++i) a0[i] = a1[i] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  for (int j = 0; j < NP; ++j) {
    const int deg = 1 + ((p2 >> j) & 1);
    const float2 l0 = loc0[j], l1 = loc1[j];
    float u0, u1, u2, v0, v1, v2;
    basis_of(l0.y, deg, &u0, &u1, &u2);
    basis_of(l1.y, deg, &v0, &v1, &v2);
    const float* T0 = tab + __float_as_int(l0.x) + 4 * t;
    const float* T1 = tab + __float_as_int(l1.x) + 4 * t;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float* P = T0 + 16 * (i ^ swap);
      const float* Q = T1 + 16 * (i ^ swap);
      float4 x = fma4(u1, load4<kStaged>(P + KS), scale4(u0, load4<kStaged>(P)));
      float4 y = fma4(v1, load4<kStaged>(Q + KS), scale4(v0, load4<kStaged>(Q)));
      if (deg == 2) {
        x = fma4(u2, load4<kStaged>(P + 2 * KS), x);
        y = fma4(v2, load4<kStaged>(Q + 2 * KS), y);
      }
      a0[i] = mul4(a0[i], x);
      a1[i] = mul4(a1[i], y);
    }
  }
  if constexpr (G == 2) {
    f0[0] = swap ? a0[1] : a0[0];
    f0[1] = swap ? a0[0] : a0[1];
    f1[0] = swap ? a1[1] : a1[0];
    f1[1] = swap ? a1[0] : a1[1];
  } else {
    f0[0] = a0[0];
    f1[0] = a1[0];
  }
}

// The head: tot += F[r, k] M0[k, c] for k = kHead-1 down to 0, in
// round-to-nearest FMAs, for this lane's outputs of one m16 x n8 tile
// (rows g, g + 8; the lane's column pair): h0, h1 are F[g, 0..kHead) and
// F[g + 8, 0..kHead).  `head` points at the lane's column pair in row 0 of
// the f32 head table (kHead, n8) in global memory, zero past n_modes and
// n0.
__device__ __forceinline__ void narrow_head(float (&tot)[4], const float (&h0)[kHead],
                                            const float (&h1)[kHead], const float* head,
                                            int n8) {
#pragma unroll
  for (int k = kHead - 1; k >= 0; --k) {
    const float2 m = __ldg(reinterpret_cast<const float2*>(head + k * n8));
    tot[0] = __fmaf_rn(h0[k], m.x, tot[0]);
    tot[1] = __fmaf_rn(h0[k], m.y, tot[1]);
    tot[2] = __fmaf_rn(h1[k], m.x, tot[2]);
    tot[3] = __fmaf_rn(h1[k], m.y, tot[3]);
  }
}

// The fused narrow product out (B, n0 <= kMaxN0) = F . M0; F never leaves
// the SM.  One block per (tile of S sample rows, range of range_slices
// k-slices), as the factor kernel's grid.  Warp w owns the m16 tiles
// mt * kNarrowWarps + w (mt < S / kNarrowPass) of the tile's rows and keeps
// their (16 x 8n) accumulators in registers over its slices.  In a slice,
// each lane computes, for its two rows g and g + 8 of an m16 tile and each
// k16 group of the slice, the four columns 16i + 4t .. +3 of F
// (narrow_factors): exactly its A fragments of the group's two k8 steps,
// with the k order permuted inside the group (step s, fragment column p
// holds k = 4 (p % 4) + 2s + p / 4); the wrapper lays M0's slice out in the
// same order (ops/fused_sweep.py::narrow_table), so the B fragments are one
// float4 of hi and one of lo a lane.  A group's product is 3xTF32 into a
// fresh accumulator (the cross terms, then hi.hi: six mma.sync m16n8k8),
// added to the tile's total in a round-to-nearest FADD.  The first kHead
// modes skip the tensor cores (their rows of the split M0 are zero) and
// start the total, in FMAs from the f32 head table (narrow_head).
// mslices: per slice the split M0 hi then lo, each (KS/16, n8, 16), then
// the head (kHead, n8); chunk_out as the factor kernel's.
template <int KS, int NT, bool kStaged>
__global__ void __launch_bounds__(kNarrowThreads, 1)
sweep_narrow_kernel(const float* __restrict__ samples, const float* __restrict__ grid,
                    const float* __restrict__ tslices, const float* __restrict__ mslices,
                    const float* __restrict__ head, void* __restrict__ out,
                    float* __restrict__ chunk_out, long long B, int NP, int ndofp, int n_modes,
                    int n0, int S, int out_bf16, int range_slices) {
  constexpr int G = KS / 16;                  // k16 groups a slice
  constexpr int MT = kNarrowTiles / NT;       // m16 tiles a warp, at most
  constexpr int N8 = 8 * NT;                  // the table's padded width
  constexpr int kMFloats = 2 * KS * N8;       // a slice of the split M0
  extern __shared__ __align__(128) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  const long long tile0 = (long long)blockIdx.x * S;
  const int rows = (int)(B - tile0 < S ? B - tile0 : S);
  const int mt_n = S / kNarrowPass;
  const int tab_floats = NP * ndofp * KS;
  const int stage_floats = tab_floats + kMFloats;
  float2* s_loc = reinterpret_cast<float2*>(smem + (kStaged ? 2 * stage_floats : 0));
  const uint32_t bar0 = smem_u32(s_loc + S * NP);
  int* s_done = reinterpret_cast<int*>(s_loc + S * NP + 2);  // warps done with stage 0, 1
  const int n_active = (n_modes + KS - 1) / KS;  // slices holding a mode
  const int q0 = blockIdx.y * range_slices;
  const int q_end = min(q0 + range_slices, n_active);
  const int swap = G == 2 ? (g & 1) : 0;

  if (kStaged && tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    s_done[0] = s_done[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the P2 dims, and each (row, dim)'s cell located once for all slices
  // (rows past the batch locate 0)
  uint32_t p2 = 0;
  for (int j = 0; j < NP; ++j) p2 |= (__ldg(grid + 3 * NP + j) == 2.0f ? 1u : 0u) << j;
  const float* src = samples + tile0 * NP;
  for (int i = tid; i < S * NP; i += kNarrowThreads) {
    const int j = i % NP;
    int base;
    float xi;
    cell_of(i < rows * NP ? src[i] : 0.0f, __ldg(grid + j), __ldg(grid + NP + j),
            __ldg(grid + 2 * NP + j), 1 + ((p2 >> j) & 1), &base, &xi);
    s_loc[i] = make_float2(__int_as_float((j * ndofp + base) * KS), xi);
  }
  __syncthreads();

  auto fill = [&](int q) {
    const int i = q - q0;
    const uint32_t bar = bar0 + 8 * (i & 1);
    const uint32_t dst = smem_u32(smem + (i & 1) * stage_floats);
    mbar_expect_tx(bar, stage_floats * 4);
    bulk_load(dst, tslices + (size_t)q * tab_floats, tab_floats * 4, bar);
    bulk_load(dst + tab_floats * 4, mslices + (size_t)q * kMFloats, kMFloats * 4, bar);
  };
  if (kStaged && tid == 0)
    for (int q = q0; q < q0 + 2 && q < q_end; ++q) fill(q);

  float tot[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mt][nt][e] = 0.0f;

  for (int q = q0; q < q_end; ++q) {
    const float* tab;
    const float* ms;
    if constexpr (kStaged) {
      const int i = q - q0;
      mbar_wait(bar0 + 8 * (i & 1), (i >> 1) & 1);
      tab = smem + (i & 1) * stage_floats;
      ms = tab + tab_floats;
    } else {
      tab = tslices + (size_t)q * tab_floats;
      ms = mslices + (size_t)q * kMFloats;
    }
    const int kq = q * KS;
    // this lane's B fragments of group i, n-tile nt: M0 rows 16i + 4t .. +3
    // (split hi, lo) at column 8nt + g
    auto b_frag = [&](int i, int nt, float4* bh, float4* bl) {
      const float* p = ms + ((i * N8 + 8 * nt + g) * 16 + 4 * t);
      *bh = load4<kStaged>(p);
      *bl = load4<kStaged>(p + KS * N8);
    };
    float4 bh1[G], bl1[G];  // NT = 1: the slice's fragments, loaded once
    if constexpr (NT == 1) {
#pragma unroll
      for (int i = 0; i < G; ++i) b_frag(i, 0, &bh1[i], &bl1[i]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt >= mt_n) break;  // uniform across the block
      const int r0 = (mt * kNarrowWarps + w) * 16 + g;
      float4 f0[G], f1[G];
      narrow_factors<KS, kStaged>(s_loc + r0 * NP, s_loc + (r0 + 8) * NP, p2, tab, NP, t,
                                  swap, f0, f1);
      if (kq + KS > n_modes) {  // columns at or past n_modes are zero
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const int k = kq + 16 * i + 4 * t;
          if (k + 0 >= n_modes) f0[i].x = f1[i].x = 0.0f;
          if (k + 1 >= n_modes) f0[i].y = f1[i].y = 0.0f;
          if (k + 2 >= n_modes) f0[i].z = f1[i].z = 0.0f;
          if (k + 3 >= n_modes) f0[i].w = f1[i].w = 0.0f;
        }
      }
      if (q == 0) {  // the head starts the total (range 0 only)
        // F[row, 0..7]: columns 0-3 from the row's lane t = 0, 4-7 from t = 1
        const int src = lane & ~3;
        const float h0[kHead] = {
            __shfl_sync(0xffffffffu, f0[0].x, src), __shfl_sync(0xffffffffu, f0[0].y, src),
            __shfl_sync(0xffffffffu, f0[0].z, src), __shfl_sync(0xffffffffu, f0[0].w, src),
            __shfl_sync(0xffffffffu, f0[0].x, src + 1), __shfl_sync(0xffffffffu, f0[0].y, src + 1),
            __shfl_sync(0xffffffffu, f0[0].z, src + 1), __shfl_sync(0xffffffffu, f0[0].w, src + 1)};
        const float h1[kHead] = {
            __shfl_sync(0xffffffffu, f1[0].x, src), __shfl_sync(0xffffffffu, f1[0].y, src),
            __shfl_sync(0xffffffffu, f1[0].z, src), __shfl_sync(0xffffffffu, f1[0].w, src),
            __shfl_sync(0xffffffffu, f1[0].x, src + 1), __shfl_sync(0xffffffffu, f1[0].y, src + 1),
            __shfl_sync(0xffffffffu, f1[0].z, src + 1), __shfl_sync(0xffffffffu, f1[0].w, src + 1)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) narrow_head(tot[mt][nt], h0, h1, head + 8 * nt + 2 * t, N8);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        // A fragments of the group's k8 steps s = 0, 1: (f.x, f.y) then
        // (f.z, f.w), split into tf32 hi and lo
        const float a[2][4] = {{f0[i].x, f1[i].x, f0[i].y, f1[i].y},
                               {f0[i].z, f1[i].z, f0[i].w, f1[i].w}};
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ahi[s][e] = tf32_rn(a[s][e]);
            alo[s][e] = tf32_rn(__fsub_rn(a[s][e], __uint_as_float(ahi[s][e])));
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float4 bh, bl;
          if constexpr (NT == 1) {
            bh = bh1[i];
            bl = bl1[i];
          } else {
            b_frag(i, nt, &bh, &bl);
          }
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(d, ahi[0], bl.x, bl.y);  // the cross terms first
          mma_tf32(d, alo[0], bh.x, bh.y);
          mma_tf32(d, ahi[1], bl.z, bl.w);
          mma_tf32(d, alo[1], bh.z, bh.w);
          mma_tf32(d, ahi[0], bh.x, bh.y);
          mma_tf32(d, ahi[1], bh.z, bh.w);
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[mt][nt][e] = __fadd_rn(tot[mt][nt][e], d[e]);
        }
      }
    }
    if constexpr (kStaged) {
      // the last warp done reading this stage refills it with slice q + 2;
      // the others go on to slice q + 1 without waiting
      __syncwarp();
      if (lane == 0) {
        const int st = (q - q0) & 1;
        __threadfence_block();
        if (atomicAdd(s_done + st, 1) == kNarrowWarps - 1) {
          atomicExch(s_done + st, 0);
          if (q + 2 < q_end) {
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            fill(q + 2);
          }
        }
      }
    }
  }

  // each output once: this lane's rows g, g + 8 and columns 8nt + 2t, +1
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= mt_n) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (mt * kNarrowWarps + w) * 16 + g + 8 * h;
      if (r >= rows) continue;
      const long long at = (tile0 + r) * n0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * nt + 2 * t + e;
          if (c >= n0) continue;
          const float v = tot[mt][nt][2 * h + e];
          if (chunk_out != nullptr)
            chunk_out[blockIdx.y * B * n0 + at + c] = v;
          else if (out_bf16)
            static_cast<__nv_bfloat16*>(out)[at + c] = __float2bfloat16_rn(v);
          else
            static_cast<float*>(out)[at + c] = v;
        }
      }
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
constexpr int kBN = 128;               // output columns per block
constexpr int kBTileBytes = kBN * kBoxK * 4;
constexpr int kStageBytes = 2 * kATileBytes + 2 * kBTileBytes;
constexpr int kStages = 3;
constexpr int kHeadBytes = kBM * kHead * 4 + kHead * kBN * 4;  // F and M0 head tiles
constexpr int kEpiCols = 32;  // output columns per epilogue pass: one 128-byte swizzle row
constexpr int kEpiBytes = (kBM / 2) * kEpiCols * 4;  // a consumer warpgroup's staging, 8 KiB
// the ring, two head buffers, two epilogue stagings, then full[S],
// empty[S], head full[2] and head empty[2]; 1024 bytes to align the base
constexpr int kGemmSmem =
    kStages * kStageBytes + 2 * kHeadBytes + 2 * kEpiBytes + (2 * kStages + 4) * 8 + 1024;
static_assert(kGemmSmem <= kMaxSmem, "stage ring exceeds shared memory");
static_assert((kStages * kStageBytes + 2 * kHeadBytes) % 1024 == 0,
              "staging off its swizzle alignment");


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

// D (64 x 128, f32, in registers) = [D +] A (64 x 8 tf32) . B (128 x 8 tf32)^T
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// One 16-k group of a stage (`half` 0 or 1) into a fresh accumulator: the
// cross passes hi.lo and lo.hi first, while the sum is small, then hi.hi;
// two k8 steps each, a k8 step being 32 bytes along the swizzled row (+2 in
// a descriptor).
__device__ __forceinline__ void issue_group(float (&acc)[64], uint64_t ahi, uint64_t alo,
                                            uint64_t bhi, uint64_t blo, int half) {
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int o = 2 * (2 * half + ks);
    wgmma_tf32(acc, ahi + o, blo + o, ks == 0 ? 0 : 1);
    wgmma_tf32(acc, alo + o, bhi + o, 1);
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int o = 2 * (2 * half + ks);
    wgmma_tf32(acc, ahi + o, bhi + o, 1);
  }
  wgmma_commit();
}

// The head (see the header): tot += F[r, k] M0[k, c] for k = kHead-1 down
// to 0, in round-to-nearest FMAs, for this thread's tile rows rl and
// rl + 8 and tile columns cl + 8j (+1), from the tile's head operands in
// shared memory: sf (kBM, kHead) F columns, sm (kHead, kBN) M0 rows (TMA
// fills rows past the batch and columns past n0 with zeros).
template <int R>
__device__ __forceinline__ void add_head(float (&tot)[R], const float* sf, const float* sm,
                                         int rl, int cl) {
  float fr[2][kHead];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int q = 0; q < kHead / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(sf + (rl + 8 * h) * kHead)[q];
      fr[h][4 * q] = v.x;
      fr[h][4 * q + 1] = v.y;
      fr[h][4 * q + 2] = v.z;
      fr[h][4 * q + 3] = v.w;
    }
  }
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    float a0 = tot[4 * j], a1 = tot[4 * j + 1], b0 = tot[4 * j + 2], b1 = tot[4 * j + 3];
#pragma unroll
    for (int k = kHead - 1; k >= 0; --k) {
      const float2 m = *reinterpret_cast<const float2*>(sm + k * kBN + cl + 8 * j);
      a0 = fmaf(fr[0][k], m.x, a0);
      a1 = fmaf(fr[0][k], m.y, a1);
      b0 = fmaf(fr[1][k], m.x, b0);
      b1 = fmaf(fr[1][k], m.y, b1);
    }
    tot[4 * j] = a0;
    tot[4 * j + 1] = a1;
    tot[4 * j + 2] = b0;
    tot[4 * j + 3] = b1;
  }
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

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// Byte offset of element (r, c) of a 64 x 32 f32 staging tile, 128-byte
// rows swizzled as TMA's SWIZZLE_128B: row r's 16-byte chunk q sits at
// chunk q ^ (r % 8), so the fragment's float2 writes (8 rows, one column
// pair) and the stores' row reads both hit 32 distinct banks.
__device__ __forceinline__ int epi_offset(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
}

// Store one staged pass of a consumer warpgroup: warp w's 16 rows of the
// 32 columns from col0, VW floats a lane (a row's 32 / VW lanes, VW rows an
// instruction) to the chunk partial prows or, without one, to out.
template <int VW, typename OutT>
__device__ __forceinline__ void store_pass(const uint8_t* epi_ptr, OutT* out, float* prows,
                                           long long row0, long long rows, int n0, int col0,
                                           int w, int lane) {
  constexpr int kPerRow = kEpiCols / VW;
  const int cl = VW * (lane % kPerRow), col = col0 + cl;
  if (col >= n0) return;
  float* dst = prows != nullptr ? prows : reinterpret_cast<float*>(out);
#pragma unroll 4
  for (int i = 0; i < 16 / VW; ++i) {
    const int r = 16 * w + VW * i + lane / kPerRow;
    const long long row = row0 + r;
    if (row >= rows) return;
    const uint8_t* src = epi_ptr + epi_offset(r, cl);
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(dst + row * n0 + col) = *reinterpret_cast<const float4*>(src);
    } else if constexpr (VW == 2) {
      *reinterpret_cast<float2*>(dst + row * n0 + col) = *reinterpret_cast<const float2*>(src);
    } else {
      const float v = *reinterpret_cast<const float*>(src);
      if (prows != nullptr)
        prows[row * n0 + col] = v;
      else
        store<OutT>(out + row * n0 + col, v);
    }
  }
}

// out (rows, n0) = F (rows, Kp) . M0 (Kp, n0), from a_hi/a_lo over F's
// halves (box 32 x 128 rows) and b_hi/b_lo over M0^T's (n0, Kp) halves (box
// 32 x 128).  Persistent: block b walks the work items b, b + gridDim.x, ..
// of the n_items = n_chunks x m_tiles x n_tiles space, item =
// (chunk * m_tiles + m_tile) * n_tiles + n_tile, so the blocks at work at
// one time share F tiles in L2.  The stage ring and its barriers run on
// across items: the producer loads the next items' stages (and, for a
// chunk-0 item, its head tiles into the head buffer the epilogue two
// items back has read) while the consumers finish and store the current
// one.  The epilogue stages each warpgroup's 64 x 128 result in four
// 64 x 32 passes through a swizzled shared tile and stores it
// row-contiguous in stores of vw floats (4 for f32 rows 16-byte aligned,
// 2 for 8-byte aligned, else 1; 1 for a bf16 output), a warp writing vw
// rows x 32 columns an instruction.
template <typename OutT>
__global__ void __launch_bounds__(kGemmThreads, 1)
sweep_gemm_kernel(const __grid_constant__ CUtensorMap a_hi,
                  const __grid_constant__ CUtensorMap a_lo,
                  const __grid_constant__ CUtensorMap b_hi,
                  const __grid_constant__ CUtensorMap b_lo,
                  const __grid_constant__ CUtensorMap f_head,
                  const __grid_constant__ CUtensorMap m_head, OutT* __restrict__ out,
                  float* __restrict__ part, long long rows, int n0, int n_kb, int kb_chunk,
                  int m_tiles, int n_tiles, long long n_items, int vw) {
  constexpr int S = kStages;
  constexpr int R = kBN / 2;  // accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // two head buffers, each F head (kBM, kHead) then M0 head (kHead, kBN)
  const uint32_t head = base + S * kStageBytes;
  const uint32_t epi0 = head + 2 * kHeadBytes;   // the two warpgroups' stagings
  const uint32_t bars = epi0 + 2 * kEpiBytes;    // full[S], empty[S], head full[2], empty[2]
  const uint32_t head_full = bars + 16 * S, head_empty = head_full + 16;
  const int tid = threadIdx.x, wg = tid / 128;
  const long long tiles = (long long)m_tiles * n_tiles;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kConsumerThreads);
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(head_full + 8 * h, 1);
      mbar_init(head_empty + 8 * h, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      int ip = 0, hc = 0;  // k-blocks and head tiles loaded so far
      for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int chunk = (int)(item / tiles);
        const long long t = item - chunk * tiles;
        const int m_tile = (int)(t / n_tiles), n_tile = (int)(t - (long long)m_tile * n_tiles);
        const int kb0 = chunk * kb_chunk, n_local = min(n_kb - kb0, kb_chunk);
        const int ra = m_tile * kBM, rb = n_tile * kBN;
        for (int kb = 0; kb < n_local; ++kb, ++ip) {
          const int s = ip % S;
          if (ip >= S) mbar_wait(bars + 8 * (S + s), ((ip / S) - 1) & 1);
          const uint32_t st = base + s * kStageBytes, full = bars + 8 * s;
          mbar_expect_tx(full, kStageBytes);
          const int k = (kb0 + kb) * kBoxK;
          tma_load_2d(st, &a_hi, full, k, ra);
          tma_load_2d(st + kATileBytes, &a_lo, full, k, ra);
          tma_load_2d(st + 2 * kATileBytes, &b_hi, full, k, rb);
          tma_load_2d(st + 2 * kATileBytes + kBTileBytes, &b_lo, full, k, rb);
        }
        if (chunk == 0) {  // the head's operands, read in the epilogue
          const int h = hc & 1;  // buffer h's (hc / 2)-th fill
          const uint32_t hb = head + h * kHeadBytes, full = head_full + 8 * h;
          if (hc >= 2) mbar_wait(head_empty + 8 * h, ((hc >> 1) - 1) & 1);
          mbar_expect_tx(full, kHeadBytes);
          tma_load_2d(hb, &f_head, full, 0, ra);
          tma_load_2d(hb + kBM * kHead * 4, &m_head, full, rb, 0);
          ++hc;
        }
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
  // accumulator layout: warp w of the group holds rows 16w + lane/4 (+8),
  // columns 8j + 2(lane%4) (+1) in registers 4j (+1), (+2, +3 for row+8)
  const int w = (tid % 128) / 32, lane = tid % 32;
  const uint32_t epi = epi0 + c * kEpiBytes;
  uint8_t* epi_ptr = smem_raw + (epi - smem_u32(smem_raw));
  const float* sf0 = reinterpret_cast<const float*>(smem_raw + (head - smem_u32(smem_raw)));
  float acc[R], tot[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  int ic = 0, hc = 0;  // k-blocks and head tiles consumed so far
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int chunk = (int)(item / tiles);
    const long long t = item - chunk * tiles;
    const int m_tile = (int)(t / n_tiles), n_tile = (int)(t - (long long)m_tile * n_tiles);
    const int n_local = min(n_kb - chunk * kb_chunk, kb_chunk);
#pragma unroll
    for (int i = 0; i < R; ++i) tot[i] = 0.0f;
    const int n_groups = n_local * kGroups;
    for (int g = 0; g < n_groups; ++g) {
      const int kb = g / kGroups, half = g % kGroups, s = (ic + kb) % S;
      if (half == 0) mbar_wait(bars + 8 * s, ((ic + kb) / S) & 1);
      const uint32_t st = base + s * kStageBytes;
      const uint64_t ahi = smem_desc(st + c * 64 * 128);
      const uint64_t alo = smem_desc(st + kATileBytes + c * 64 * 128);
      const uint64_t bhi = smem_desc(st + 2 * kATileBytes);
      const uint64_t blo = smem_desc(st + 2 * kATileBytes + kBTileBytes);
      issue_group(acc, ahi, alo, bhi, blo, half);
      wgmma_wait<0>();
      fold(tot, acc);
      if (half == kGroups - 1) mbar_arrive(bars + 8 * (S + s));
    }
    ic += n_local;
    if (chunk == 0) {
      const int h = hc & 1;
      const float* sf = sf0 + h * (kHeadBytes / 4);
      mbar_wait(head_full + 8 * h, (hc >> 1) & 1);
      add_head(tot, sf, sf + kBM * kHead, c * 64 + 16 * w + lane / 4, 2 * (lane % 4));
      mbar_arrive(head_empty + 8 * h);
      ++hc;
    }

    const long long row0 = (long long)m_tile * kBM + c * 64;
    float* prows = part == nullptr ? nullptr : part + (long long)chunk * rows * n0;
#pragma unroll
    for (int p = 0; p < kBN / kEpiCols; ++p) {
      named_sync(1 + c);  // the last pass's stores have read the staging
#pragma unroll
      for (int jj = 0; jj < kEpiCols / 8; ++jj) {
        const int j = p * (kEpiCols / 8) + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * w + lane / 4 + 8 * h;
          *reinterpret_cast<float2*>(epi_ptr + epi_offset(r, 8 * jj + 2 * (lane % 4))) =
              make_float2(tot[4 * j + 2 * h], tot[4 * j + 2 * h + 1]);
        }
      }
      named_sync(1 + c);
      const int col0 = n_tile * kBN + p * kEpiCols;
      if (vw == 4)
        store_pass<4>(epi_ptr, out, prows, row0, rows, n0, col0, w, lane);
      else if (vw == 2)
        store_pass<2>(epi_ptr, out, prows, row0, rows, n0, col0, w, lane);
      else
        store_pass<1>(epi_ptr, out, prows, row0, rows, n0, col0, w, lane);
    }
  }
}

// out[i] = sum over c of part[c, i], c ascending, in f64, rounded once to
// OutT (through f32, as the plain version rounds): the chunk partials of
// the GEMM or of the narrow product.
template <typename OutT>
__global__ void __launch_bounds__(256)
partial_sum_kernel(const float* __restrict__ part, OutT* __restrict__ out, int n_chunks,
                   long long count) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    double s = 0.0;
    for (int c = 0; c < n_chunks; ++c) s += (double)part[c * count + i];
    store<OutT>(out + i, (float)s);
  }
}

// -------------------------------------------------------------- host side

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// cudaFuncSetAttribute once per kernel instantiation and device (an API
// call per launch otherwise): `bytes` is the most any launch of it takes;
// `done` is the instantiation's own mask of devices.
template <typename Kernel>
int set_smem_once(Kernel kernel, int bytes, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  *done |= bit;
  return 0;
}

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

// A (rows, cols) row-major f32 array, rows ld elements apart, seen as
// unswizzled tiles of box_rows x box_cols; out-of-range reads fill zeros.
int plain_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, long long rows, int cols,
              int ld, int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// The M0 side's maps, made once per table: b_hi, b_lo, m_head.
struct TableMaps {
  CUtensorMap b_hi, b_lo, m_head;
};

// Streaming multiprocessors of the current device (asked once per device).
int sm_count(int* n) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (cached[dev & 63] == 0) {
    int v = 0;
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    cached[dev & 63] = v;
  }
  *n = cached[dev & 63];
  return 0;
}

template <typename OutT>
int launch_gemm(const void* f_hi, const void* f_lo, const TableMaps& tm, void* out, void* part,
                long long rows, int Kp, int n0, int k_chunk, long long* launched,
                cudaStream_t stream) {
  EncodeTiled encode;
  int rc = encoder(&encode);
  if (rc != 0) return rc;
  CUtensorMap a_hi, a_lo, f_head;
  if ((rc = tile_map(encode, &a_hi, f_hi, rows, Kp, kBM)) != 0) return rc;
  if ((rc = tile_map(encode, &a_lo, f_lo, rows, Kp, kBM)) != 0) return rc;
  if ((rc = plain_map(encode, &f_head, f_hi, rows, Kp, Kp, kHead, kBM)) != 0) return rc;
  const int n_kb = (Kp + kBoxK - 1) / kBoxK;
  const int kb_chunk = part == nullptr ? n_kb : k_chunk / kBoxK;
  const int n_chunks = (n_kb + kb_chunk - 1) / kb_chunk;
  // the widest f32 store the rows' alignment allows (partials are f32; a
  // bf16 output stores one value at a time)
  const void* dst = part != nullptr ? part : out;
  const bool f32 = part != nullptr || sizeof(OutT) == 4;
  const int vw = !f32 ? 1 : n0 % 4 == 0 && aligned16(dst) ? 4
                 : n0 % 2 == 0 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0 ? 2 : 1;
  auto kernel = sweep_gemm_kernel<OutT>;
  static unsigned long long done = 0;
  if ((rc = set_smem_once(kernel, kGemmSmem, &done)) != 0) return rc;
  int n_sm = 0;
  if ((rc = sm_count(&n_sm)) != 0) return rc;
  const long long m_tiles = (rows + kBM - 1) / kBM;
  const int n_tiles = (n0 + kBN - 1) / kBN;
  if (m_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long n_items = m_tiles * n_tiles * n_chunks;
  const unsigned blocks = (unsigned)(n_items < n_sm ? n_items : n_sm);
  kernel<<<blocks, kGemmThreads, kGemmSmem, stream>>>(
      a_hi, a_lo, tm.b_hi, tm.b_lo, f_head, tm.m_head, static_cast<OutT*>(out),
      static_cast<float*>(part), rows, n0, n_kb, kb_chunk, (int)m_tiles, n_tiles, n_items,
      vw);
  if (launched != nullptr) {
    launched[0] = n_items;
    launched[1] = blocks;
  }
  return (int)cudaGetLastError();
}

struct FactorArgs {
  const float* samples;
  const float* grid;
  const float* tslices;
  const float* mslices;
  const float* head;
  float* out;
  float* out_lo;
  float* chunk_out;
  long long B;
  int NP, ndofp, n_modes, ld, S, vec, out_bf16, range_slices, n_ranges;
};

template <int KS, int kMode, bool kStaged>
int launch_factors(const FactorArgs& a, int smem, cudaStream_t stream) {
  auto kernel = sweep_factors_kernel<KS, kMode, kStaged>;
  static unsigned long long done = 0;
  const int rc = set_smem_once(kernel, kFactorSmemMax, &done);
  if (rc != 0) return rc;
  const long long blocks = (a.B + a.S - 1) / a.S;
  const dim3 grid((unsigned)blocks, (unsigned)a.n_ranges);
  kernel<<<grid, kFactorThreads, smem, stream>>>(a.samples, a.grid, a.tslices, a.out, a.out_lo,
                                                 a.B, a.NP, a.ndofp, a.n_modes, a.ld, a.S,
                                                 a.vec, a.range_slices);
  return (int)cudaGetLastError();
}

template <int kMode>
int factors_for_mode(const FactorArgs& a, int ks, bool staged, int smem, cudaStream_t st) {
  if (!staged) return ks == 32 ? launch_factors<32, kMode, false>(a, smem, st)
                               : (int)cudaErrorInvalidValue;
  switch (ks) {
    case 32: return launch_factors<32, kMode, true>(a, smem, st);
    case 16: return launch_factors<16, kMode, true>(a, smem, st);
    case 8: return launch_factors<8, kMode, true>(a, smem, st);
    case 4: return launch_factors<4, kMode, true>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int KS, int NT, bool kStaged>
int launch_narrow(const FactorArgs& a, int smem, cudaStream_t stream) {
  auto kernel = sweep_narrow_kernel<KS, NT, kStaged>;
  static unsigned long long done = 0;
  const int rc = set_smem_once(kernel, kFactorSmemMax, &done);
  if (rc != 0) return rc;
  const long long blocks = (a.B + a.S - 1) / a.S;
  const dim3 grid((unsigned)blocks, (unsigned)a.n_ranges);
  kernel<<<grid, kNarrowThreads, smem, stream>>>(
      a.samples, a.grid, a.tslices, a.mslices, a.head, a.out, a.chunk_out, a.B, a.NP, a.ndofp,
      a.n_modes, a.ld, a.S, a.out_bf16, a.range_slices);
  return (int)cudaGetLastError();
}

template <int NT>
int narrow_for_nt(const FactorArgs& a, int ks, bool staged, int smem, cudaStream_t st) {
  if (!staged) return ks == 32 ? launch_narrow<32, NT, false>(a, smem, st)
                               : (int)cudaErrorInvalidValue;
  switch (ks) {
    case 32: return launch_narrow<32, NT, true>(a, smem, st);
    case 16: return launch_narrow<16, NT, true>(a, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Stage 1.  samples (B, NP) f32; grid (4, NP) f32 rows x0, 1/h, ncell,
// degree; tslices (n_slices, NP*ndofp, ks) f32: the (NP, ndofp, K) tables
// cut into k-slices of ks columns, zero past K.  Three modes:
//   mslices null, out_lo null: out (B, ld = K) f32, F itself;
//   mslices null, out_lo set:  out, out_lo (B, ld >= K, ld % 4 == 0): F's
//                              tf32 hi and lo halves, zero past K; the
//                              first kHead columns F itself and zero;
//   mslices set:               the narrow product (sweep_narrow_kernel),
//                              out (B, ld = n0 <= 32), F . M0, f32 or
//                              (out_bf16) bf16; ks 32 or 16 (32 off the
//                              staged route); mslices the table of
//                              ops/fused_sweep.py::narrow_table: per slice
//                              the split M0 (2, ks/16, n8, 16), rows below
//                              kHead and at or past n_modes zero, then the
//                              f32 head (kHead, n8), n8 = 8 * narrow_nt(n0).
//                              On more than one k-range the product goes
//                              as range r's f32 partial to chunk_out
//                              (n_ranges, B, n0) [r], and out is not
//                              written (pgd_partial_sum adds them).
// Columns k >= n_modes of F are zero.  The grid is ceil(B / rows) row tiles
// x n_ranges k-ranges of range_slices slices each, together covering every
// slice the mode walks (ceil(ld / ks) for F and its split, ceil(n_modes /
// ks) for the narrow product); in narrow mode chunk_out is set exactly
// when n_ranges > 1.
// rows: sample rows per block, a multiple of one pass of the block's
// threads (1024 / (ks / 4) rows; kNarrowPass = 256 for the narrow product,
// at most narrow_rows_max(n0)); staged: the tables go through shared
// memory (else ks must be 32 and the gathers read tslices in global
// memory).  All arrays C-contiguous on the current device, tslices and
// mslices 16-byte aligned.
int pgd_sweep_factors(const void* samples, const void* grid, const void* tslices,
                      const void* mslices, void* out, void* out_lo, void* chunk_out, long long B,
                      int NP, int ndofp, int K, int n_modes, int ld, int ks, int rows,
                      int staged, int out_bf16, int range_slices, int n_ranges,
                      void* stream) {
  const bool narrow = mslices != nullptr;
  const int mode = out_lo ? kSplit : kFactors;
  if (ks != 4 && ks != 8 && ks != 16 && ks != 32) return (int)cudaErrorInvalidValue;
  // rows one pass of the block covers
  const int pass = narrow ? kNarrowPass : kFactorThreads / (ks / 4);
  // the slices the mode walks, all covered by the ranges
  const int walked = narrow ? (n_modes + ks - 1) / ks : (ld + ks - 1) / ks;
  if (B < 0 || NP < 1 || NP > kMaxNP || ndofp < 2 || K < 1 || n_modes < 0 || n_modes > K ||
      rows < pass || rows % pass != 0 || !aligned16(tslices) || range_slices < 1 ||
      n_ranges < 1 || n_ranges > 65535 || (long long)range_slices * n_ranges < walked ||
      (chunk_out != nullptr) != (narrow && n_ranges > 1))
    return (int)cudaErrorInvalidValue;
  if (narrow ? (ld < 1 || ld > kMaxN0 || ks < 16 || rows > narrow_rows_max(ld) ||
                out_lo != nullptr || !aligned16(mslices))
             : ((mode == kFactors && ld != K) ||
                (mode == kSplit && (ld < K || ld % 4 != 0 || !aligned16(out) ||
                                    !aligned16(out_lo)))))
    return (int)cudaErrorInvalidValue;
  const long long smem = factor_smem(NP, ndofp, ks, rows, narrow ? ld : 0, staged);
  if (smem > kFactorSmemMax) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  if ((B + rows - 1) / rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int nt = narrow ? narrow_nt(ld) : 0;
  // the head table follows the slices of the split M0
  const float* head = narrow ? static_cast<const float*>(mslices) +
                                   (size_t)((K + ks - 1) / ks) * 2 * ks * 8 * nt
                             : nullptr;
  const FactorArgs a = {static_cast<const float*>(samples), static_cast<const float*>(grid),
                        static_cast<const float*>(tslices), static_cast<const float*>(mslices),
                        head, static_cast<float*>(out), static_cast<float*>(out_lo),
                        static_cast<float*>(chunk_out), B, NP, ndofp, n_modes, ld, rows,
                        ld % 4 == 0 && aligned16(out), out_bf16, range_slices, n_ranges};
  auto st = static_cast<cudaStream_t>(stream);
  if (narrow) {
    switch (nt) {
      case 1: return narrow_for_nt<1>(a, ks, staged, (int)smem, st);
      case 2: return narrow_for_nt<2>(a, ks, staged, (int)smem, st);
      default: return narrow_for_nt<4>(a, ks, staged, (int)smem, st);
    }
  }
  return mode == kSplit ? factors_for_mode<kSplit>(a, ks, staged, (int)smem, st)
                        : factors_for_mode<kFactors>(a, ks, staged, (int)smem, st);
}

// Dynamic shared memory of a factor launch, in bytes (n0 = 0: no narrow
// product); ops/fused_sweep.py::factor_smem must agree.
long long pgd_factor_smem(int NP, int ndofp, int ks, int rows, int n0, int staged) {
  return factor_smem(NP, ndofp, ks, rows, n0, staged != 0);
}

// The M0 side of stage 2, encoded once per table: t_hi, t_lo (n0, Kp) f32,
// the split M0^T with rows k < kHead and k >= n_modes zero; head (kHead,
// round4(n0)) f32: M0's first kHead rows, zero at or past n_modes and past
// n0.  Writes pgd_gemm_maps_bytes() bytes to `maps` (any alignment); the
// tables must outlive every launch given them.
int pgd_gemm_table_maps(const void* t_hi, const void* t_lo, const void* head, int Kp, int n0,
                        void* maps) {
  if (Kp < 8 || Kp % 8 != 0 || n0 < 1 || !aligned16(t_hi) || !aligned16(t_lo) ||
      !aligned16(head) || maps == nullptr)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode;
  int rc = encoder(&encode);
  if (rc != 0) return rc;
  TableMaps tm;
  if ((rc = tile_map(encode, &tm.b_hi, t_hi, n0, Kp, kBN)) != 0) return rc;
  if ((rc = tile_map(encode, &tm.b_lo, t_lo, n0, Kp, kBN)) != 0) return rc;
  if ((rc = plain_map(encode, &tm.m_head, head, kHead, n0, (n0 + 3) / 4 * 4, kBN, kHead)) != 0)
    return rc;
  memcpy(maps, &tm, sizeof(tm));
  return 0;
}

int pgd_gemm_maps_bytes(void) { return (int)sizeof(TableMaps); }

// Stage 2.  f_hi, f_lo (rows, Kp) f32: the split factors, the first kHead
// columns whole in f_hi; maps: the table's from pgd_gemm_table_maps, made
// for the same Kp and n0; out (rows, n0) f32 (out_bf16 == 0) or bf16.  Kp
// is a multiple of 8.  With part set, the work items of chunk c sum k in
// [c k_chunk, (c + 1) k_chunk) only (k_chunk a multiple of 32) and store
// their f32 partials to part (ceil(Kp / k_chunk), rows, n0) instead of out
// (pgd_partial_sum adds them).  At most one block per SM, persistent;
// `launched`, when set, gets the work items and the blocks launched.
int pgd_sweep_gemm(const void* f_hi, const void* f_lo, const void* maps, void* out, void* part,
                   long long rows, int Kp, int n0, int k_chunk, int out_bf16,
                   long long* launched, void* stream) {
  if (rows < 0 || Kp < 8 || Kp % 8 != 0 || n0 < 1 || rows > 0xffffffffLL ||
      !aligned16(f_hi) || !aligned16(f_lo) || maps == nullptr ||
      (part != nullptr && (k_chunk < kBoxK || k_chunk % kBoxK != 0)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  TableMaps tm;
  memcpy(&tm, maps, sizeof(tm));
  auto st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_gemm<__nv_bfloat16>(f_hi, f_lo, tm, out, part, rows, Kp, n0, k_chunk,
                                               launched, st)
                  : launch_gemm<float>(f_hi, f_lo, tm, out, part, rows, Kp, n0, k_chunk,
                                       launched, st);
}

// The f64 sum of chunk partials.  part (n_chunks, count) f32; out (count)
// f32 (out_bf16 == 0) or bf16: out[i] = sum_c part[c, i], c ascending.
// A grid-stride loop of 256-thread blocks, at most 16 an SM; `blocks_out`,
// when set, gets the blocks launched.
int pgd_partial_sum(const void* part, void* out, int n_chunks, long long count, int out_bf16,
                    int* blocks_out, void* stream) {
  if (n_chunks < 1 || count < 0) return (int)cudaErrorInvalidValue;
  if (count == 0) return (int)cudaGetLastError();
  int n_sm = 0;
  const int rc = sm_count(&n_sm);
  if (rc != 0) return rc;
  const long long want = (count + 255) / 256;
  const unsigned blocks = (unsigned)(want < 16LL * n_sm ? want : 16LL * n_sm);
  if (blocks_out != nullptr) *blocks_out = (int)blocks;
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const float*>(part);
  if (out_bf16)
    partial_sum_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        p, static_cast<__nv_bfloat16*>(out), n_chunks, count);
  else
    partial_sum_kernel<float><<<blocks, 256, 0, st>>>(p, static_cast<float*>(out), n_chunks,
                                                      count);
  return (int)cudaGetLastError();
}

// Streaming multiprocessors of the current device: the one count the
// GEMM's and the partial sum's grids and ops/fused_sweep.py::factor_grid
// take.  Negative: a CUDA error code, negated.
int pgd_sm_count(void) {
  int n = 0;
  const int rc = sm_count(&n);
  return rc != 0 ? -rc : n;
}

// Dynamic shared memory of a GEMM launch, in bytes (ptxas -v reports
// static shared memory only).
int pgd_sweep_gemm_smem(void) { return kGemmSmem; }

// The head's width: modes summed in f32 FMAs by the GEMM's epilogue
// (ops/fused_sweep.py::K_HEAD must agree).
int pgd_k_head(void) { return kHead; }

const char* pgd_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed (code - 100000 is the CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

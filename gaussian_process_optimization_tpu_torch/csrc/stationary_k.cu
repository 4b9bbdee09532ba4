// Stationary covariance K(X, Z) and its backward, lane-batched, for sm_90a.
//
// Replaces, in the JAX package, ops/pallas_kernels.py:
//   * _pallas_K / _make_tile_kernel (forward, K build): k_build_kernel;
//   * _pallas_K_bwd / _make_bwd_tile_kernel (backward: dX, dZ, dvariance,
//     dlengthscale, dpower): k_bwd_rows_kernel (parameter gradients and dX)
//     and k_bwd_cols_kernel (dZ).
// The kernels are templates in stationary_k_kernels.cuh, instantiated one
// family per source (stationary_k_<family>.cu) so that nvcc builds the families
// side by side; this file holds the entry points and the fixed-order sums.
//
// What bounds them on this card. The forward writes B*N*M floats and the
// backward reads as many (335 MB at B=5, N=M=4096: 0.10 ms at 3.35 TB/s), and
// the arithmetic is O(D) per entry, so the bound is bytes. But an entry costs
// tens of instructions against 4 bytes, and a first version that spent 120
// (forward) and 230 (backward) instructions per entry was bound by the
// instruction rate at 6x and 16x the memory time. The design is about
// instructions per entry:
//   * The family, the ARD flag and the dimension bucket are template
//     arguments: no switch per entry, every loop over dimensions unrolled, all
//     per-dimension values in registers. The buckets are Dp = 4, 6 and 8
//     dimensions held in registers, and chunks of 8 for 9 <= D <= 64. X and Z
//     come padded with zeros to the bucket's width (the wrapper pads; D = 4, 6
//     and 8 need none); padded dimensions get a zero inverse lengthscale,
//     add exactly 0 and need no predicate. The chunked forward sums r^2 over
//     the chunks; the chunked backward sweeps G once per chunk of lengthscale
//     or coordinate gradients and recomputes r^2 over all chunks each time
//     (right, and slow in proportion: the paths run D = 6).
//   * One IEEE reciprocal per lengthscale per block, then u = (x - z) * inv_l
//     per entry and dimension: <= 1.5 ulp from (x - z) / l. The difference is
//     still taken first, as the TPU tile does, so there is no cancellation;
//     the coordinates are never pre-scaled. Non-ARD multiplies the sum by
//     inv_l^2 once. The backward's row pass goes one step further: it keeps
//     d = x - z and q = d^2, forms r^2 = sum q inv_l^2, accumulates sum W q and
//     sum W d with one FMA each and scales the sums once at the end.
//   * The radial profile uses the one-instruction special functions and one
//     exponential per entry (stationary_family.cuh states what each costs).
//   * Register tiles. A thread owns 4 consecutive columns and 4 rows (forward:
//     8 rows in two steps); a warp covers 128 consecutive columns of its rows.
//     The thread's z values are read once per tile (16 bytes a load, through
//     the read-only cache: X and Z are ~100 KB and stay in L1 / L2), its x
//     values once per row step. Shared memory holds only the reciprocals and
//     the final reductions.
//   * K is stored, and G loaded, 16 bytes a thread with the streaming
//     qualifier (.cs): each is 335 MB, touched once, and should not evict X
//     and Z from L2. A row that is not 16-byte aligned, a G view whose last
//     stride is not 1, and the ragged last columns take the scalar path. The
//     backward loads the next tile's G before it works on this one's.
//
// K(X, X) is bitwise symmetric: (x_i - x_j) * c is the exact negative of
// (x_j - x_i) * c, its square is the same number with or without FMA
// contraction, the sum runs over the dimensions in the same order, and the
// profile is a function of r^2 alone. So the wrapper needs no (K + K^T) / 2.
//
// Backward. The TPU kernel adds its dX rows and scalar sums into its output
// across grid steps with `+=`, which is right only because a TPU runs its grid
// in order. Here a block of k_bwd_rows_kernel owns a strip of rows of one lane
// and sweeps every column itself; each thread keeps its sums (dl_0..dl_7,
// dvariance, dpower, and its rows' dx when asked) in registers for the whole
// sweep. They are reduced once at the end: a butterfly of warp shuffles, then
// the 8 warps in order through shared memory, then one row of a (B, T, W)
// buffer that gpo_sum_partials adds in order. Equal blocks finish in waves of
// two per SM, so without dX the columns are also split between 1 to 4 blocks,
// whichever count fills the last wave best (5 x 128 strips are 2.4 waves on
// 132 SMs, two splits 4.85); T = strips x splits. k_bwd_cols_kernel turns the
// roles for dZ: a thread owns 4 columns and walks down rows, so G is still read
// along its rows and a column's sum needs no shuffle; the 8 warps of a block
// and then the row strips are added in order. No atomics: two runs give the
// same bits.
//
// Params row per lane: [variance, power, lengthscale_0 .. lengthscale_{n-1}]
// padded to W >= 8 (n = D when ARD, else 1), as pallas_kernels._params_row.

#include <cuda_runtime.h>

#include <cstdint>

#include "stationary_k_kernels.cuh"

namespace gpo {
extern const FamilyKernels kernels_of_family_0, kernels_of_family_1, kernels_of_family_3,
    kernels_of_family_4, kernels_of_family_5, kernels_of_family_6;
}

using namespace gpo;

namespace {

// out[b, w] = sum over t of partials[b, t, w], t in increasing order.
__global__ void sum_partials_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                    int B, int T, long long W) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * W) return;
  const long long b = e / W, w = e % W;
  float s = 0.0f;
  for (int t = 0; t < T; ++t) s += partials[(b * T + t) * W + w];
  out[e] = s;
}

// A family's kernels, or null; ou shares exponential's.
const FamilyKernels* family_kernels(int family) {
  switch (family) {
    case kRbf: return &kernels_of_family_0;
    case kExponential:
    case kOu: return &kernels_of_family_1;
    case kMatern32: return &kernels_of_family_3;
    case kMatern52: return &kernels_of_family_4;
    case kCosine: return &kernels_of_family_5;
    case kRatquad: return &kernels_of_family_6;
    default: return nullptr;
  }
}

// The padded width the kernels take for D input dimensions (4, 6 or 8 for
// D <= 8, else the next multiple of 8), or 0.
int padded_width(int D) {
  if (D < 1 || D > kMaxD) return 0;
  if (D <= kChunk) return D <= 4 ? 4 : (D + 1) / 2 * 2;
  return (D + kChunk - 1) / kChunk * kChunk;
}

// The bucket of the padded width Dp for D input dimensions, or -1 when Dp is
// not that width.
int bucket_of(int D, int Dp) {
  if (Dp == 0 || Dp != padded_width(D)) return -1;
  return Dp <= kChunk ? Dp / 2 - 2 : kBuckets - 1;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether G can be read 16 bytes at a time from any column that is a multiple of 4.
int g_is_vector(const float* G, long long sgb, long long sgn, long long sgm) {
  return sgm == 1 && sgn % 4 == 0 && sgb % 4 == 0 && aligned16(G);
}

// Column splits of the row pass: the count in 1..4 whose blocks fill whole
// waves of two blocks per SM best. dX sums over all columns in one block.
int column_splits(int B, int N, int M, int need_dx) {
  if (need_dx) return 1;
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const double slots = 2.0 * sms;
  const long long strips = (long long)B * ((N + kBwdRowsParams - 1) / kBwdRowsParams);
  const int col_tiles = (M + kCols - 1) / kCols;
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= 4 && s <= col_tiles; ++s) {
    const double waves = strips * s / slots;
    const double fill = waves / (double)(long long)(waves + 0.999999);
    if (fill > best_fill + 0.02) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

}  // namespace

extern "C" {

// The width X and Z are padded to for D input dimensions, 0 outside 1..64.
int gpo_padded_width(int D) { return padded_width(D); }

// Rows of `partials` per lane that the row pass writes for this shape.
int gpo_bwd_partial_rows(int B, int N, int M, int need_dx) {
  const int tile = need_dx ? kBwdRowsDx : kBwdRowsParams;
  return (N + tile - 1) / tile * column_splits(B, N, M, need_dx);
}

// Rows of one strip of the dZ pass (the number of `scratch` strips is N over it).
int gpo_bwd_col_strip() { return kColRows; }

// X and Z padded to Dp = gpo_padded_width(D), 16-byte aligned.
int gpo_stationary_k(const float* Xp, const float* Zp, const float* params, float* out, int B,
                     int N, int M, int D, int Dp, int W, long long sxb, long long szb,
                     int family, int ard, void* stream) {
  const FamilyKernels* f = family_kernels(family);
  const int bucket = bucket_of(D, Dp);
  if (f == nullptr || bucket < 0 || !aligned16(Xp) || !aligned16(Zp))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kCols - 1) / kCols, (N + kFwdRows - 1) / kFwdRows, B);
  f->build[ard != 0][bucket]<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Xp, Zp, params, out, N, M, D, Dp, W, sxb, szb);
  return static_cast<int>(cudaGetLastError());
}

// Parameter gradients into `partials` (B, gpo_bwd_partial_rows, W) unless it is
// null, and dX (B, N, D) unless it is null.
int gpo_stationary_k_bwd_rows(const float* Xp, const float* Zp, const float* params,
                              const float* G, float* dX, float* partials, int B, int N, int M,
                              int D, int Dp, int W, long long sxb, long long szb,
                              long long sgb, long long sgn, long long sgm, int family, int ard,
                              void* stream) {
  const FamilyKernels* f = family_kernels(family);
  const int bucket = bucket_of(D, Dp);
  if (f == nullptr || bucket < 0 || !aligned16(Xp) || !aligned16(Zp))
    return static_cast<int>(cudaErrorInvalidValue);
  const int need_dx = dX != nullptr;
  const int tile = need_dx ? kBwdRowsDx : kBwdRowsParams;
  const dim3 grid((N + tile - 1) / tile, B, column_splits(B, N, M, need_dx));
  f->rows[ard != 0][bucket][need_dx]<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Xp, Zp, params, G, dX, partials, N, M, D, Dp, W, sxb, szb, sgb, sgn, sgm,
      g_is_vector(G, sgb, sgn, sgm));
  return static_cast<int>(cudaGetLastError());
}

// dZ pieces into `scratch` (B, strips, M, D), strips = ceil(N / gpo_bwd_col_strip()).
int gpo_stationary_k_bwd_cols(const float* Xp, const float* Zp, const float* params,
                              const float* G, float* scratch, int B, int N, int M, int D,
                              int Dp, int W, long long sxb, long long szb, long long sgb,
                              long long sgn, long long sgm, int family, int ard,
                              void* stream) {
  const FamilyKernels* f = family_kernels(family);
  const int bucket = bucket_of(D, Dp);
  if (f == nullptr || bucket < 0 || !aligned16(Xp) || !aligned16(Zp))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kCols - 1) / kCols, (N + kColRows - 1) / kColRows, B);
  f->cols[ard != 0][bucket]<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Xp, Zp, params, G, scratch, N, M, D, Dp, W, sxb, szb, sgb, sgn, sgm,
      g_is_vector(G, sgb, sgn, sgm));
  return static_cast<int>(cudaGetLastError());
}

// out (B, W) = the sum of partials (B, T, W) over T, in increasing order.
int gpo_sum_partials(const float* partials, float* out, int B, int T, long long W,
                     void* stream) {
  const long long n = B * W;
  sum_partials_kernel<<<static_cast<unsigned>((n + 127) / 128), 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(partials, out, B, T, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

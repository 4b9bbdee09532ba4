// Batched Cholesky of symmetric positive-definite (G, nb, nb) blocks, for sm_90a.
//
// Replaces, in the JAX package, ops/pallas_linalg.py: cholesky_blocks, built by
// _make_entry, launched by _run_blocks, body _make_chol_kernel.
//
// Bound. Per lane the function reads the lower triangle of one nb x nb block
// (nb (nb + 1) / 2 floats: the upper triangle is never read), writes one whole
// block (nb^2 floats), 394 KB in all at nb = 256, and does nb^3 / 3 flops
// (5.6 MFLOP): at G = 5 that is 0.59 us of memory time at 3.35 TB/s against
// 0.42 us of f32 FMA time at 67 TFLOP/s. Neither is what limits a
// one-block-per-lane factorization: its dependency chain is. Done column by
// column, that chain is nb steps with two block-wide barriers each (512
// barriers at nb = 256).
//
// Design: a tiled right-looking factorization in one block of 8 warps per
// lane. The lane's lower triangle lives in shared memory as 32 x 32 tiles,
// each column-major with a swizzle (see at()): 36 tiles, 144 KB at nb = 256.
// It is loaded once and L stored once, with 16-byte accesses along the rows of
// the block; A's upper triangle is never used, L's is written as exact zeros,
// and each panel of L is stored as soon as it is final. For each 32-wide
// panel k:
//   - one warp factors the diagonal tile in registers (lane r holds row r; the
//     column passes by __shfl_sync; no block barrier inside);
//   - the warps below solve their panel tiles against it by substitution over
//     the columns (X L_kk^T = A_ik), one tile per warp, in parallel;
//   - six warps apply the rank-32 trailing update, C -= A B^T on pairs of
//     32 x 32 tiles along a row, as register-tiled FFMA: each lane keeps 8 x 4
//     entries of each tile of the pair in registers and reads 16 panel values
//     per k-step with four 16-byte broadcast loads: a sixteenth of a load
//     instruction per multiply-add, where the column algorithm spends two
//     shared-memory loads and a store on each;
//   - lookahead: warp 0 and warp 4 (the warps of one scheduler) update the next
//     diagonal tile first, then warp 0 factors it while warp 4 stores panel k
//     and the six others update the rest of the trailing triangle. The
//     diagonal factors (32 dependent square roots each) are the critical path,
//     so no update shares their scheduler.
// So a lane takes 2 barriers per panel (about 18 in all), not 2 per column.
// Every entry's updates are subtracted in the column algorithm's order (p
// ascending), with no atomics, so two launches give the same bits. Full f32
// FFMA and no tensor cores: wgmma on f32 operands runs in TF32, which the
// port has turned off.
//
// Rounding. An entry of column j (1-based) is one chain of j - 1 fmaf, one
// rounding each, and then its pivot step, which is not IEEE: r_j, the pivot
// p_j's reciprocal square root, is rsqrtf (within 2 ulp) refined by one Newton
// step, so within 2.5 u + O(u^2) of 1 / sqrt(p_j) (u = 2^-24: the Newton step
// squares rsqrtf's error, its three roundings add u / 2 + u + u), and
// l_jj = fl(p_j r_j), l_ij = fl(s_ij r_j). So p_j = l_jj^2 and s_ij = l_ij l_jj
// hold to a relative 7 u + O(u^2), where IEEE sqrt and division give 2 u and
// u. Carried through Higham's proof (Accuracy and Stability of Numerical
// Algorithms, Lemma 8.4 and Thm 10.3) with these counts, the backward error is
// |L L^T - A| <= gamma_{nb+7} |L| |L^T|; the column algorithm with IEEE
// operations has gamma_{nb+1}. The checks (chip_smoke.py, the card tests)
// hold the kernel to gamma_{nb+1}, 2.3% below what is proved here at
// nb = 256; it reads 12-15x under that (PERF.md).
//
// A pivot that is not positive (or is NaN) stops the lane's factorization and
// its whole output block is NaN; other lanes are untouched. That is the
// failure signal the jitter ladder reads (finiteness per lane).

#include <cuda_runtime.h>

#include "block_smem.cuh"
#include "chol_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads, 1)
chol_blocks_kernel(const float* __restrict__ A, float* __restrict__ out, int nb) {
  extern __shared__ __align__(16) float tiles[];
  const int nt = nb / kT;
  float* invd = tiles + tri(nt) * kTile;  // 1 / L_kk's diagonal, panel k
  int* failed = reinterpret_cast<int*>(invd + kT);
  const long long base = (long long)blockIdx.x * nb * nb;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q = lane % 8;  // loads as store_tile stores: 16-byte pieces along rows

  // Load the lower tiles; the diagonal tiles' upper halves become 0.
  for (int t = warp; t < tri(nt); t += kWarps) {
    int i = 0;
    while (tri(i + 1) <= t) ++i;
    const int j = t - tri(i);
    float* dst = tiles + t * kTile;
#pragma unroll
    for (int pass = 0; pass < 8; ++pass) {
      const int r = 4 * pass + lane / 8;
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          A + base + (long long)(kT * i + r) * nb + kT * j + 4 * q));
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 4 * q + u;
        dst[at(r, c)] = (i == j && c > r) ? 0.0f : e[u];
      }
    }
  }
  if (threadIdx.x == 0) *failed = 0;
  __syncthreads();
  float* const lane_out = out + base;
  auto out_tile = [&](int i, int j) { return lane_out + (long long)kT * i * nb + kT * j; };
  // Warp 0 factors the diagonal tiles. Warp 4 shares its scheduler: with it
  // it updates the next diagonal tile, half each, then stores the finished
  // panel while warp 0 factors, and takes no part of the trailing update, so
  // the diagonal chain runs at full issue rate. The other 6 warps take the
  // trailing update's tiles in turn.
  const bool chain = warp % 4 == 0;
  const int updater = warp - 1 - (warp > 4);  // 0 .. 5 for the other warps
  if (warp == 0) {
    if (!factor_diag(tiles, invd, lane) && lane == 0) *failed = 1;
  } else if (!chain) {  // the zero tiles above the diagonal, meanwhile
    for (int t = updater; t < nt * nt; t += kWarps - 2) {
      if (t / nt < t % nt) store_tile(out_tile(t / nt, t % nt), nb, nullptr, false, 0.0f, lane);
    }
  }
  __syncthreads();

  // *failed is read right after a barrier and written only between the next
  // two, so every thread sees the same value and leaves the loop together.
  for (int k = 0; k < nt && !*failed; ++k) {
    const float* Lkk = tile(tiles, k, k);
    for (int i = k + 1 + warp; i < nt; i += kWarps) solve_panel(tile(tiles, i, k), Lkk, invd, lane);
    __syncthreads();
    if (k + 1 == nt) break;
    if (chain) {
      float* D = tile(tiles, k + 1, k + 1);
      const float* Lk = tile(tiles, k + 1, k);
      update_cols(D, Lk, Lk, 4 * warp, lane);
      asm volatile("bar.sync 1, 64;" ::: "memory");  // warps 0 and 4
      if (warp == 0) {
        if (!factor_diag(D, invd, lane) && lane == 0) *failed = 1;
      } else {  // panel k is final: store it
        for (int i = k; i < nt; ++i)
          store_tile(out_tile(i, k), nb, tile(tiles, i, k), i == k, 0.0f, lane);
      }
    } else {
      // The other trailing tiles, rows k + 2 .. in pairs along the row (a
      // lone last tile of a row alone), the pairs first, in turn.
      int idx = 0;
      for (int w = 2; w >= 1; --w) {
        for (int i = k + 2; i < nt; ++i) {
          for (int j = k + 1; j + w - 1 <= i; j += 2) {
            if ((j + 1 <= i ? 2 : 1) != w || idx++ % (kWarps - 2) != updater) continue;
            const float* A = tile(tiles, i, k);
            if (w == 2) {
              float* const C[2] = {tile(tiles, i, j), tile(tiles, i, j + 1)};
              const float* const B[2] = {tile(tiles, j, k), tile(tiles, j + 1, k)};
              update_tiles<2>(C, A, B, lane);
            } else {
              float* const C[1] = {tile(tiles, i, j)};
              const float* const B[1] = {tile(tiles, j, k)};
              update_tiles<1>(C, A, B, lane);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // The last diagonal tile, or, for a lane that failed, NaN over every tile
  // written so far (the barriers order those writes before these).
  if (*failed) {
    const float nan = __int_as_float(0x7fc00000);
    for (int t = warp; t < nt * nt; t += kWarps)
      store_tile(out_tile(t / nt, t % nt), nb, nullptr, false, nan, lane);
  } else if (warp == 0) {
    store_tile(out_tile(nt - 1, nt - 1), nb, tile(tiles, nt - 1, nt - 1), true, 0.0f, lane);
  }
}

// Dynamic shared memory of one launch: the lower triangle's tiles, the
// panel's reciprocal pivots and the failure flag (up to nb = 320 on Hopper).
size_t chol_smem(int nb) {
  const size_t nt = nb / kT;
  return sizeof(float) * (nt * (nt + 1) / 2 * kTile + kT + 1);
}

}  // namespace

extern "C" {

// Returns kSmemDoesNotFit, launching nothing, when the tiles of one lane do
// not fit a block's shared memory.
int gpo_cholesky_blocks(const float* A, float* out, int G, int nb, void* stream) {
  const size_t smem = chol_smem(nb);
  const int err = opt_in_smem(chol_blocks_kernel, smem);
  if (err != 0) return err;
  chol_blocks_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, out, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Batched full-size Cholesky (B5) of symmetric positive-definite (G, n, n)
// float32 matrices, in place, for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves the jitter ladder's full-size
// factorization to XLA's Cholesky. On the card that was cuSOLVER's batched
// potrf (torch.linalg.cholesky_ex), which is built for many small matrices.
//
// Bound. A lane takes n^3 / 3 flops and reads and writes its lower triangle
// once: at (5, 4096, 4096) 1.145e11 flops, 1.71 ms of f32 FMA at 67 TFLOP/s,
// against 0.20 ms for its 671 MB at 3.35 TB/s. The flops bound it, and all
// but a few percent of them are the trailing updates.
//
// Design: a right-looking blocked factorization over panels of kNB = 128
// columns. The host (ops/cuda_linalg.py: chol_full) launches per panel:
//   1. chol_full_diag_kernel, one block a lane, factors the Schur-updated
//      diagonal block in shared memory with B4's tile machinery
//      (chol_tiles.cuh) and, in the same pass, inverts it: the block is
//      factored as the top of the tall matrix [A_kk; I], whose bottom rows
//      become I L_kk^-T under the same panel solves and trailing updates. So
//      the inverse adds parallel tile work beside the factorization and no
//      step to its chain of dependent pivots. It writes L_kk in place (zeros
//      above its diagonal) and L_kk^-1 to a workspace.
//   2. the host's batched float32 product W = L_kk^-1 A_21^T, the panel L_21
//      transposed: (G, 128, m), 2 m 128^2 flops a lane, at the "highest"
//      float32 matmul precision the package sets (no TF32).
//   3. chol_full_syrk_kernel: A_22 -= L_21 L_21^T on the 128 x 128 tiles on or
//      below the diagonal only, half the flops of a full-square product. Each
//      tile is a block of 256 threads holding 8 x 8 entries in registers; W's
//      rows come in as k-slices of 16 by 16-byte cp.async copies, three
//      slices in flight in shared memory (on an H100 a ladder call at
//      (5, 4096, 4096) took 5.6 ms, against 6.3 with two slices staged
//      through registers). The blocks of the diagonal tiles also write L_21
//      into the factor (transposing W's slices from shared memory) and zero
//      the strict upper triangle right of the diagonal block. It runs in two
//      launches: the first tile column, which the next panel needs, and the
//      rest. Steps 1, 2 and the first column go to a high-priority stream, the
//      rest to the caller's: the next diagonal block (the serial part, 128
//      dependent pivots on one SM a lane) is factored while the bulk of the
//      update runs (on an H100 at (5, 4096, 4096): 5.3 ms against 5.8).
// Last, chol_full_nan_kernel fills a failed lane with NaN. No atomics and no
// host synchronisation; two calls give the same bits.
//
// Rounding. Float32 FMA throughout, no tensor cores (wgmma on f32 operands
// runs in TF32). The diagonal blocks round as B4 does (chol_blocks.cu); an
// entry of A_22 accumulates kFlush = 64 products in a register and is then
// subtracted once, twice a panel. Sums of 128 products read a normwise
// backward error ||L L^T - A|| / ||A|| 1.45-1.64x cholesky_ex's on the ladder's
// (5, 4096, 4096) Matern52 and (10, 4096, 4096) RBF Grams; sums of 64
// 1.04-1.08x, for 4% more time.
//
// Verdict. A pivot fails the lane unless it is finite and above its floor,
// 8 sqrt(n) u times the same column's diagonal entry of A (the host's
// ``floors``, ops/cuda_linalg.py: pivot_floors): a pivot below it is within
// the rounding of the sum it is left from, and cuSOLVER's potrf, whose test is
// LAPACK's (positive), passes or fails such pivots by its rounding on Grams
// that float32 cannot hold (a conditioning above 1 / u). The lane's diagonal
// block and inverse come out NaN, which the product and the update carry to
// every later block, and chol_full_nan_kernel fills the rest of the lane. So a
// lane holds a non-finite entry exactly when it failed.

#include <cuda_runtime.h>

#include "block_smem.cuh"
#include "chol_tiles.cuh"

namespace {

constexpr int kNB = 128;       // panel width, and the trailing update's tile edge
constexpr int kNT = kNB / kT;  // 32 x 32 tiles along a diagonal block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 16;        // k-slice of the trailing update
constexpr int kStages = 3;     // k-slices in flight in shared memory (48 KB)
constexpr int kFlush = 64;     // products a trailing entry sums before it takes them

// Tile (i, j), i <= j, of the tall matrix's bottom rows, R = L_kk^-T (upper
// triangular): after the diagonal block's lower triangle.
__device__ __forceinline__ float* rtile(float* tiles, int i, int j) {
  return tiles + (tri(kNT) + tri(j) + i) * kTile;
}

// Write the transpose of a shared-memory tile: dst (r, c) = src (c, r), with
// 16-byte stores along dst's rows.
__device__ __forceinline__ void store_tile_t(float* dst, int ld, const float* src, int lane) {
  const int q = lane % 8;
#pragma unroll
  for (int pass = 0; pass < 8; ++pass) {
    const int r = 4 * pass + lane / 8;
    float e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) e[u] = src[at(4 * q + u, r)];
    *reinterpret_cast<float4*>(dst + (long long)r * ld + 4 * q) =
        make_float4(e[0], e[1], e[2], e[3]);
  }
}

// 16 bytes from device memory to shared memory, asynchronously (cp.async,
// through L2 only), and the group and wait around such copies.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// C0 (and C1 when w == 2) -= A B_w^T: one or two tiles side by side in a row.
// Out of line, and the loops that call it rolled: inlined and unrolled, the
// diagonal kernel spilled in its trailing updates and took 20% longer.
__device__ __noinline__ void update_row(int w, float* C0, float* C1, const float* A,
                                           const float* B0, const float* B1, int lane) {
  if (w == 2) {
    float* const C[2] = {C0, C1};
    const float* const B[2] = {B0, B1};
    update_tiles<2>(C, A, B, lane);
  } else {
    float* const C[1] = {C0};
    const float* const B[1] = {B0};
    update_tiles<1>(C, A, B, lane);
  }
}

// Block g factors the diagonal block at (k0, k0) of lane g of A in place and
// writes L_kk^-1 to Linv[g]; floors (G, lda) holds each column's pivot floor.
// failed[g] becomes whether the lane failed (at k0 = 0) or turns 1 when it
// fails. Warps as in B4: warp 0 factors each
// diagonal tile; with warp 4 (the same scheduler) it updates the next one
// first, and warp 4 stores the finished panel while warp 0 factors; the other
// six take the trailing tiles, of L's triangle and of R's rows, in turn.
__global__ void __launch_bounds__(kThreads, 1)
chol_full_diag_kernel(float* A, long long lane_stride, int lda, int k0, float* Linv,
                      const float* __restrict__ floors, int* failed_out) {
  extern __shared__ __align__(16) float tiles[];
  float* invd = tiles + 2 * tri(kNT) * kTile;  // 1 / L_kk's diagonal, panel k
  float* floor_s = invd + kT;                  // the block's kNB pivot floors
  int* failed = reinterpret_cast<int*>(floor_s + kNB);
  float* const blk = A + blockIdx.x * lane_stride + (long long)k0 * lda + k0;
  float* const inv = Linv + (long long)blockIdx.x * kNB * kNB;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q = lane % 8;

  // The lower tiles (the diagonal tiles' upper halves become 0), and the
  // identity in R's tiles.
  for (int t = warp; t < tri(kNT); t += kWarps) {
    int i = 0;
    while (tri(i + 1) <= t) ++i;
    const int j = t - tri(i);
    float* dst = tiles + t * kTile;
#pragma unroll
    for (int pass = 0; pass < 8; ++pass) {
      const int r = 4 * pass + lane / 8;
      const float4 v = *reinterpret_cast<const float4*>(
          blk + (long long)(kT * i + r) * lda + kT * j + 4 * q);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 4 * q + u;
        dst[at(r, c)] = (i == j && c > r) ? 0.0f : e[u];
      }
    }
    int jr = 0;  // R's tile t is (t - tri(jr), jr)
    while (tri(jr + 1) <= t) ++jr;
    float* rt = tiles + (tri(kNT) + t) * kTile;
    for (int s = 0; s < kT; ++s)  // at(r, c) is on the diagonal when its offset is c kT
      rt[s * kT + lane] = (lane == 0 && t - tri(jr) == jr) ? 1.0f : 0.0f;
  }
  if (threadIdx.x < kNB)
    floor_s[threadIdx.x] = floors[(long long)blockIdx.x * lda + k0 + threadIdx.x];
  if (threadIdx.x == 0) *failed = 0;
  __syncthreads();
  auto out_tile = [&](int i, int j) { return blk + (long long)kT * i * lda + kT * j; };
  auto inv_tile = [&](int i, int j) { return inv + kT * i * kNB + kT * j; };
  const bool chain = warp % 4 == 0;
  const int updater = warp - 1 - (warp > 4);  // 0 .. 5 for the other warps
  if (warp == 0) {
    if (!factor_diag(tiles, invd, lane, floor_s) && lane == 0) *failed = 1;
  } else if (!chain) {  // the zero tiles above the diagonals of L_kk and L_kk^-1
    for (int t = updater; t < kNT * kNT; t += kWarps - 2) {
      if (t / kNT >= t % kNT) continue;
      store_tile(out_tile(t / kNT, t % kNT), lda, nullptr, false, 0.0f, lane);
      store_tile(inv_tile(t / kNT, t % kNT), kNB, nullptr, false, 0.0f, lane);
    }
  }
  __syncthreads();

  // *failed is read right after a barrier and written only between the next
  // two, so every thread sees the same value and leaves the loop together.
#pragma unroll 1
  for (int k = 0; k < kNT && !*failed; ++k) {
    // Panel k: L's tiles below the diagonal, then R's tiles (i, k), i <= k.
    if (warp < kNT) {
      const int below = kNT - 1 - k;
      solve_panel(warp < below ? tile(tiles, k + 1 + warp, k) : rtile(tiles, warp - below, k),
                  tile(tiles, k, k), invd, lane);
    }
    __syncthreads();
    if (k + 1 == kNT) break;
    if (chain) {
      float* D = tile(tiles, k + 1, k + 1);
      const float* Lk = tile(tiles, k + 1, k);
      update_cols(D, Lk, Lk, 4 * warp, lane);
      asm volatile("bar.sync 1, 64;" ::: "memory");  // warps 0 and 4
      if (warp == 0) {
        if (!factor_diag(D, invd, lane, floor_s + kT * (k + 1)) && lane == 0) *failed = 1;
      } else {  // panel k of L and row k of L_kk^-1 = R^T are final: store them
        for (int i = k; i < kNT; ++i)
          store_tile(out_tile(i, k), lda, tile(tiles, i, k), i == k, 0.0f, lane);
        for (int i = 0; i <= k; ++i) store_tile_t(inv_tile(k, i), kNB, rtile(tiles, i, k), lane);
      }
    } else {
      // The trailing tiles in pairs along a row (a lone last tile alone), the
      // pairs first: L's rows k + 2 .. (row k + 1 is the chain's), then R's
      // rows 0 .. k, whose columns k + 1 .. all take the update.
      int idx = 0;
      #pragma unroll 1
      for (int w = 2; w >= 1; --w) {
        #pragma unroll 1
        for (int i = k + 2; i < kNT; ++i) {
          #pragma unroll 1
          for (int j = k + 1; j + w - 1 <= i; j += 2) {
            if ((j + 1 <= i ? 2 : 1) != w || idx++ % (kWarps - 2) != updater) continue;
            update_row(w, tile(tiles, i, j), w == 2 ? tile(tiles, i, j + 1) : nullptr,
                       tile(tiles, i, k), tile(tiles, j, k),
                       w == 2 ? tile(tiles, j + 1, k) : nullptr, lane);
          }
        }
        #pragma unroll 1
        for (int i = 0; i <= k; ++i) {
          #pragma unroll 1
          for (int j = k + 1; j + w - 1 < kNT; j += 2) {
            if ((j + 1 < kNT ? 2 : 1) != w || idx++ % (kWarps - 2) != updater) continue;
            update_row(w, rtile(tiles, i, j), w == 2 ? rtile(tiles, i, j + 1) : nullptr,
                       rtile(tiles, i, k), tile(tiles, j, k),
                       w == 2 ? tile(tiles, j + 1, k) : nullptr, lane);
          }
        }
      }
    }
    __syncthreads();
  }

  // The last diagonal tile and the last row of L_kk^-1, or, for a lane that
  // failed, NaN over both blocks (the barriers order the earlier writes
  // before these).
  if (*failed) {
    const float nan = __int_as_float(0x7fc00000);
    for (int t = warp; t < kNT * kNT; t += kWarps) {
      store_tile(out_tile(t / kNT, t % kNT), lda, nullptr, false, nan, lane);
      store_tile(inv_tile(t / kNT, t % kNT), kNB, nullptr, false, nan, lane);
    }
  } else if (warp == 0) {
    store_tile(out_tile(kNT - 1, kNT - 1), lda, tile(tiles, kNT - 1, kNT - 1), true, 0.0f, lane);
  } else if (warp <= kNT) {
    store_tile_t(inv_tile(kNT - 1, warp - 1), kNB, rtile(tiles, warp - 1, kNT - 1), lane);
  }
  if (threadIdx.x == 0 && (k0 == 0 || *failed)) failed_out[blockIdx.x] = *failed;
}

// A_22 -= L_21 L_21^T for the panel of width nb at column k0 of every lane,
// from W = L_21^T (G, nb, m), on the 128 x 128 tiles on or below the diagonal
// of lane g's trailing matrix (m x m, m a multiple of 128): with ``head`` block
// (x, g) takes tile (x, 0), the next panel's column; else the x-th tile (i, j)
// with 1 <= j <= i.
// Thread (tx, ty) holds rows 4 ty .. + 3 and 64 + 4 ty .. + 3 and columns
// 4 tx .. + 3 and 64 + 4 tx .. + 3 of the tile: per k it reads four 16-byte
// vectors from shared memory for 64 FMAs.
__global__ void __launch_bounds__(kThreads, 2)
chol_full_syrk_kernel(float* A, long long lane_stride, int lda, int k0, int nb,
                      const float* __restrict__ W, int m, bool head) {
  __shared__ __align__(16) float sa[kStages][kBK][kNB];
  __shared__ __align__(16) float sb[kStages][kBK][kNB];
  const int x = blockIdx.x;
  int ti = static_cast<int>((sqrtf(8.0f * x + 1.0f) - 1.0f) * 0.5f);
  while (tri(ti + 1) <= x) ++ti;
  while (tri(ti) > x) --ti;
  const int tj = head ? 0 : x - tri(ti) + 1;
  ti = head ? x : ti + 1;
  const int r0 = kNB * ti, c0 = kNB * tj, k1 = k0 + nb;
  const bool diag = ti == tj;
  float* const lane_a = A + blockIdx.y * lane_stride;
  const float* const w = W + (long long)blockIdx.y * nb * m;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  if (diag) {  // the strict upper triangle of the panel's rows, above this tile
    float* z = lane_a + (long long)k0 * lda + k1 + c0;
    for (int f = tid; f < nb * (kNB / 4); f += kThreads)
      *reinterpret_cast<float4*>(z + (long long)(f / (kNB / 4)) * lda + 4 * (f % (kNB / 4))) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // Thread tid copies 16 bytes of rows f / 32 of a k-slice into stage st,
  // f = tid, tid + 256, with cp.async: the copies land while the slices
  // before them are multiplied.
  auto prefetch = [&](int st, int kk) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int f = tid + kThreads * p;
      const float* row = w + (long long)(kk + f / 32) * m + 4 * (f % 32);
      cp_async16(&sa[st][f / 32][4 * (f % 32)], row + r0);
      cp_async16(&sb[st][f / 32][4 * (f % 32)], row + c0);
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  // C -= acc, then acc = 0: the tile's entries take the sum of every
  // kFlush products of a panel in one subtraction.
  float* const c = lane_a + (long long)(k1 + r0) * lda + k1 + c0;
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 4 * ty + (i & 3) + 64 * (i >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4* p = reinterpret_cast<float4*>(c + (long long)row * lda + 64 * h + 4 * tx);
        float4 v = *p;
        v.x -= acc[i][4 * h];
        v.y -= acc[i][4 * h + 1];
        v.z -= acc[i][4 * h + 2];
        v.w -= acc[i][4 * h + 3];
        *p = v;
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][4 * h + u] = 0.0f;
      }
    }
  };

  const int slices = nb / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < slices) prefetch(st, st * kBK);
    cp_async_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    // slice sl has landed, and every thread is done with slice sl - 1,
    // whose stage the next prefetch overwrites
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = sl + kStages - 1;
    if (next < slices) prefetch(next % kStages, next * kBK);
    cp_async_commit();
    const int buf = sl % kStages, kk = sl * kBK;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[buf][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sa[buf][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[buf][k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sb[buf][k][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (diag) {  // L_21's rows r0 .. r0 + 127, columns k0 + kk .. + 15, into the factor
      const int r = tid % kNB, h = tid / kNB;
      float e[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = sa[buf][8 * h + u][r];
      float* dst = lane_a + (long long)(k1 + r0 + r) * lda + k0 + kk + 8 * h;
      *reinterpret_cast<float4*>(dst) = make_float4(e[0], e[1], e[2], e[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(e[4], e[5], e[6], e[7]);
    }
    if ((kk + kBK) % kFlush == 0) flush();
  }
}

__global__ void chol_full_nan_kernel(float* A, long long lane_stride,
                                     const int* __restrict__ failed) {
  if (!failed[blockIdx.y]) return;
  float4* p = reinterpret_cast<float4*>(A + blockIdx.y * lane_stride);
  const float nan = __int_as_float(0x7fc00000);
  for (long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x; f < lane_stride / 4;
       f += (long long)gridDim.x * blockDim.x)
    p[f] = make_float4(nan, nan, nan, nan);
}

}  // namespace

extern "C" {

// Dynamic shared memory: L_kk's and R's triangles of tiles, the reciprocal
// pivots, the pivot floors and the failure flag (82 KB).
int gpo_chol_full_diag(float* A, long long lane_stride, int lda, int k0, float* Linv,
                       const float* floors, int* failed, int G, void* stream) {
  const size_t smem = sizeof(float) * (2 * kNT * (kNT + 1) / 2 * kTile + kT + kNB + 1);
  const int err = opt_in_smem(chol_full_diag_kernel, smem);
  if (err != 0) return err;
  chol_full_diag_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, lane_stride, lda, k0, Linv, floors, failed);
  return static_cast<int>(cudaGetLastError());
}

// ``head``: the trailing matrix's first tile column, else the other tiles
// (none when m = 128).
int gpo_chol_full_syrk(float* A, long long lane_stride, int lda, int k0, int nb,
                       const float* W, int m, int head, int G, void* stream) {
  const int t = m / kNB, blocks = head ? t : t * (t - 1) / 2;
  if (blocks == 0) return 0;
  chol_full_syrk_kernel<<<dim3(blocks, G), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, lane_stride, lda, k0, nb, W, m, head != 0);
  return static_cast<int>(cudaGetLastError());
}

int gpo_chol_full_nan(float* A, long long lane_stride, const int* failed, int G, void* stream) {
  chol_full_nan_kernel<<<dim3(64, G), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, lane_stride, failed);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

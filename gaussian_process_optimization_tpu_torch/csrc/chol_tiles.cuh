// The tile machinery of the shared-memory Cholesky factorizations: B4's
// batched blocks (chol_blocks.cu) and B5's diagonal blocks (chol_full.cu). A
// lower triangle lives in shared memory as 32 x 32 tiles; one warp factors a
// diagonal tile in registers, warps solve the panel tiles below it and update
// the trailing tiles. chol_blocks.cu's header gives the design, the rounding
// and what bounds it.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;          // tile edge
constexpr int kTile = kT * kT;  // floats per tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// Tile (i, j), i >= j, of the lane's lower triangle.
__device__ __forceinline__ float* tile(float* tiles, int i, int j) {
  return tiles + (tri(i) + j) * kTile;
}

// Entry (r, c) of a tile: column-major, the row index XOR-swizzled by the
// column, so that lanes reading one row (over columns) or one column (over
// rows) hit 32 different banks. Aligned runs of 4 or 8 rows of a column stay
// contiguous (permuted inside by the column's low bits), so a column is read
// with 16-byte loads.
__device__ __forceinline__ int at(int r, int c) { return c * kT + (r ^ c); }

// One warp factors the diagonal tile D in place (lane r holds row r) and
// writes the reciprocals of L's diagonal to invd. Entries above the diagonal
// take no part (their multiplier is 0) and are never read. Returns false if a
// pivot failed: without ``floors`` (B4) a pivot that is not positive (or is
// NaN); with them (B5, the 32 pivots' floors) one that is not above its floor
// or is not finite. Every lane also keeps the whole diagonal, updated
// from the same broadcasts with the same operations, so the next pivot is at
// hand without a shuffle. The pivot's reciprocal square root is the hardware
// approximation refined by one Newton step (within 2.5 u, see the header;
// the IEEE square root and division are branches around a slow path, which keep
// the compiler from overlapping one column's work with the next and made the
// tile twice as slow): a column's chain is that, one product, one shuffle and
// one multiply-add.
__device__ __forceinline__ bool factor_diag(float* D, float* invd, int lane,
                                            const float* floors = nullptr) {
  float a[kT], dg[kT];
#pragma unroll
  for (int c = 0; c < kT; ++c) {
    a[c] = D[at(lane, c)];
    dg[c] = D[at(c, c)];
  }
  bool ok = true;
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    const float piv = dg[j];
    // false for NaN; 0x7f800000 is +inf
    ok = ok && (floors ? piv > floors[j] && piv < __int_as_float(0x7f800000) : piv > 0.0f);
    const float y = rsqrtf(piv);
    const float inv = y * fmaf(-0.5f * piv * y, y, 1.5f);
    const float l = lane > j ? a[j] * inv : 0.0f;
    a[j] = lane == j ? piv * inv : l;
    if (lane == j) invd[j] = inv;
#pragma unroll
    for (int c = j + 1; c < kT; ++c) {
      const float lc = __shfl_sync(kFull, l, c);
      a[c] = fmaf(-l, lc, a[c]);
      dg[c] = fmaf(-lc, lc, dg[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kT; ++c) D[at(lane, c)] = a[c];
  return ok;
}

// One warp solves X L_kk^T = B for the panel tile B in place (lane r holds row
// r): x_c = (b_c - sum_{p<c} x_p L_kk[c][p]) / L_kk[c][c], right-looking over p.
__device__ __forceinline__ void solve_panel(float* B, const float* Lkk, const float* invd, int lane) {
  float x[kT];
#pragma unroll
  for (int c = 0; c < kT; ++c) x[c] = B[at(lane, c)];
#pragma unroll
  for (int p = 0; p < kT; ++p) {
    x[p] *= invd[p];
    const float4* col = reinterpret_cast<const float4*>(Lkk + p * kT);  // column p
#pragma unroll
    for (int q = 0; q < kT / 4; ++q) {
      if (4 * q + 3 <= p) continue;
      const float4 v = col[q ^ (p >> 2)];  // rows 4q .. 4q + 3, permuted by p % 4
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = 4 * q + t;
        if (c > p) x[c] = fmaf(-x[p], e[t ^ (p & 3)], x[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kT; ++c) B[at(lane, c)] = x[c];
}

// C_w -= A B_w^T for W side-by-side 32 x 32 tiles of one tile row: C_w tile
// (i, j + w), A tile (i, k), B_w tile (j + w, k). Lane (rg, cg) = (lane % 4,
// lane / 4) owns rows 8 rg .. 8 rg + 7 and columns 4 cg .. 4 cg + 3 of each
// C_w in registers; per p it loads 8 values of A's column p and 4 of each
// B_w's, 16-byte loads that lanes sharing rg (or cg) broadcast. At W = 2 a
// lane does 64 multiply-adds per 64 bytes read, which keeps the FMA units,
// not shared memory, the limit.
template <int W>
__device__ __forceinline__ void update_tiles(float* const (&C)[W], const float* A,
                                             const float* const (&B)[W], int lane) {
  const int r0 = 8 * (lane & 3), c0 = 4 * (lane >> 2);
  float acc[W][4][8];
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int m = 0; m < 8; ++m) acc[w][n][m] = C[w][at(r0 + m, c0 + n)];
    }
  }
#pragma unroll
  for (int p = 0; p < kT; ++p) {
    // rows r0 .. r0 + 7 of column p: an aligned run of 8, row r0 + m at m ^ (p % 8);
    // rows c0 .. c0 + 3 of B_w's column p: a run of 4, row c0 + n at n ^ (p % 4)
    const float* ap = A + p * kT + (r0 ^ (p & 24));
    const float4 alo = *reinterpret_cast<const float4*>(ap);
    const float4 ahi = *reinterpret_cast<const float4*>(ap + 4);
    const float a8[8] = {alo.x, alo.y, alo.z, alo.w, ahi.x, ahi.y, ahi.z, ahi.w};
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float4 bv = *reinterpret_cast<const float4*>(B[w] + p * kT + (c0 ^ (p & 28)));
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int m = 0; m < 8; ++m)
          acc[w][n][m] = fmaf(-a8[m ^ (p & 7)], b4[n ^ (p & 3)], acc[w][n][m]);
      }
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int m = 0; m < 8; ++m) C[w][at(r0 + m, c0 + n)] = acc[w][n][m];
    }
  }
}

// Columns cb .. cb + 15 of C -= A B^T: one of two warps' share of the next
// diagonal tile's update. The lane owns rows 8 (lane % 4) .. + 7 of columns
// cb + 2 (lane / 4) and the one after.
__device__ __forceinline__ void update_cols(float* C, const float* A, const float* B, int cb,
                                            int lane) {
  const int r0 = 8 * (lane & 3), c = cb + 2 * (lane >> 2);
  float acc[2][8];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[n][m] = C[at(r0 + m, c + n)];
  }
  for (int p0 = 0; p0 < kT; p0 += 8) {
#pragma unroll
    for (int pi = 0; pi < 8; ++pi) {
      const int p = p0 + pi;
      const float* ap = A + p * kT + (r0 ^ p0);
      const float4 alo = *reinterpret_cast<const float4*>(ap);
      const float4 ahi = *reinterpret_cast<const float4*>(ap + 4);
      const float a8[8] = {alo.x, alo.y, alo.z, alo.w, ahi.x, ahi.y, ahi.z, ahi.w};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float b = B[at(c + n, p)];
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[n][m] = fmaf(-a8[m ^ pi], b, acc[n][m]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int m = 0; m < 8; ++m) C[at(r0 + m, c + n)] = acc[n][m];
  }
}

// Write one 32 x 32 tile of the output (dst: its first entry): a tile of L
// from shared memory, with zeros above the diagonal if it is a diagonal tile,
// or, with src null, the constant fill. Rows 4 pass + lane / 8, columns
// 4 q .. 4 q + 3: 8 lanes cover a row with 16-byte stores.
__device__ __forceinline__ void store_tile(float* dst, int nb, const float* src, bool diag, float fill,
                           int lane) {
  const int q = lane % 8;
#pragma unroll
  for (int pass = 0; pass < 8; ++pass) {
    const int r = 4 * pass + lane / 8;
    float e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 4 * q + u;
      e[u] = src == nullptr ? fill : (diag && c > r) ? 0.0f : src[at(r, c)];
    }
    *reinterpret_cast<float4*>(dst + (long long)r * nb + 4 * q) =
        make_float4(e[0], e[1], e[2], e[3]);
  }
}

}  // namespace

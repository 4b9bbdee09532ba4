// The kernels of stationary_k.cu (its header has the design), as templates over
// <family, ARD, dimension bucket, chunked>, and one family's instantiations.
//
// A source that defines GPO_FAMILY before including this file compiles that
// family's kernels and defines its three tables of kernel pointers; the
// families are separate sources so that nvcc builds them side by side.
// stationary_k.cu includes it without GPO_FAMILY and gets the declarations.
#pragma once

#include <cuda_runtime.h>

#include "stationary_family.cuh"

namespace gpo {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;              // dimensions per chunk when D > 8
constexpr int kMaxD = 64;
constexpr int kCols = 128;             // columns a warp covers: 4 per lane
constexpr int kFwdRows = 8 * kWarps;   // forward block: 64 rows x 128 columns
constexpr int kBwdRowsParams = 4 * kWarps;  // backward row strip without dX
constexpr int kBwdRowsDx = 2 * kWarps;      // and with dX (fewer rows: registers)
constexpr int kColRows = 128;          // rows per block of the dZ pass
constexpr int kBuckets = 4;            // Dp = 4, 6, 8 in registers; chunks of 8

using BuildFn = void (*)(const float*, const float*, const float*, float*, int, int, int, int,
                         int, long long, long long);
using RowsFn = void (*)(const float*, const float*, const float*, const float*, float*, float*,
                        int, int, int, int, int, long long, long long, long long, long long,
                        long long, int);
using ColsFn = void (*)(const float*, const float*, const float*, const float*, float*, int,
                        int, int, int, int, long long, long long, long long, long long,
                        long long, int);

// One family's kernels: [ard][bucket], and [ard][bucket][need_dx].
struct FamilyKernels {
  BuildFn build[2][kBuckets];
  RowsFn rows[2][kBuckets][2];
  ColsFn cols[2][kBuckets];
};

#define GPO_CAT2(a, b) a##b
#define GPO_CAT(a, b) GPO_CAT2(a, b)
// gpo::kernels_of_family_<id>
#define GPO_FAMILY_KERNELS(F) GPO_CAT(kernels_of_family_, F)

}  // namespace gpo

#ifdef GPO_FAMILY

namespace gpo {
namespace {

// DP values of a padded row (16-byte aligned when DP % 4 == 0, else 8), or zeros.
template <int DP>
__device__ __forceinline__ void load_row(const float* __restrict__ p, bool valid,
                                         float (&v)[DP]) {
  if (DP % 4 == 0) {
#pragma unroll
    for (int q = 0; q < DP / 4; ++q) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) a = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = a.x; v[4 * q + 1] = a.y; v[4 * q + 2] = a.z; v[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < DP / 2; ++q) {
      float2 a = make_float2(0.f, 0.f);
      if (valid) a = __ldg(reinterpret_cast<const float2*>(p) + q);
      v[2 * q] = a.x; v[2 * q + 1] = a.y;
    }
  }
}

// u_k = (x_k - z_k) * inv_k (ARD) or x_k - z_k (non-ARD); returns r2 + sum u_k^2.
template <bool ARD, int DP>
__device__ __forceinline__ float diffs(const float (&x)[DP], const float (&z)[DP],
                                       const float (&inv)[DP], float (&u)[DP], float r2) {
#pragma unroll
  for (int k = 0; k < DP; ++k) {
    u[k] = x[k] - z[k];
    if (ARD) u[k] *= inv[k];
    r2 = fmaf(u[k], u[k], r2);
  }
  return r2;
}

// The row pass's form: d_k = x_k - z_k, q_k = d_k^2, and returns r2 + sum q_k
// inv2_k (ARD, inv2_k = inv_k^2) or r2 + sum q_k (non-ARD). The gradients then
// take one FMA per dimension, sum W q_k and sum W d_k, and are scaled once at
// the end (dl_k by -inv_k^3, dx_k by inv_k^2): an instruction less per
// dimension and entry than through u_k = d_k inv_k, and still no cancellation.
template <bool ARD, int DP>
__device__ __forceinline__ float sq_diffs(const float (&x)[DP], const float (&z)[DP],
                                          const float (&inv2)[DP], float (&d)[DP],
                                          float (&q)[DP], float r2) {
#pragma unroll
  for (int k = 0; k < DP; ++k) {
    d[k] = x[k] - z[k];
    q[k] = d[k] * d[k];
    r2 = ARD ? fmaf(q[k], inv2[k], r2) : r2 + q[k];
  }
  return r2;
}

// r^2 of one (row, column) pair over every chunk, from the padded rows. Not
// inlined: the chunked backward calls it once per entry and is slow by design,
// and sixteen inlined copies per kernel would triple the build's time.
template <bool ARD>
__device__ __noinline__ float r2_all_chunks(const float* __restrict__ xrow,
                                               const float* __restrict__ zrow,
                                               const float* inv_s, int Dp) {
  float r2 = 0.0f;
  for (int j = 0; j < Dp; j += kChunk) {
    float xj[kChunk], zj[kChunk], invj[kChunk], uj[kChunk];
    load_row<kChunk>(xrow + j, true, xj);
    load_row<kChunk>(zrow + j, true, zj);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) invj[k] = inv_s[j + k];
    r2 = diffs<ARD, kChunk>(xj, zj, invj, uj, r2);
  }
  return r2;
}

// inv_s[k] = 1 / lengthscale_k for k < D (ARD) or 1 / lengthscale (non-ARD),
// 0 on the padded dimensions; one IEEE division each, once per block.
template <bool ARD>
__device__ __forceinline__ void reciprocals(const float* __restrict__ ps, int D, int Dp,
                                            float* inv_s) {
  const int k = threadIdx.x;
  if (k < Dp) inv_s[k] = ARD ? (k < D ? 1.0f / ps[2 + k] : 0.0f) : 1.0f / ps[2];
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------------------ forward
template <int FAMILY, bool ARD, int DP, bool CHUNKED>
__global__ void __launch_bounds__(kThreads, 2)
k_build_kernel(const float* __restrict__ Xp, const float* __restrict__ Zp,
               const float* __restrict__ params, float* __restrict__ out, int N, int M,
               int D, int Dp, int W, long long sxb, long long szb) {
  __shared__ float inv_s[kMaxD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.z;
  const float* ps = params + (long long)b * W;
  reciprocals<ARD>(ps, D, Dp, inv_s);
  const float variance = ps[0], power = ps[1];
  const float scale = ARD ? 1.0f : inv_s[0] * inv_s[0];
  const float* Xb = Xp + b * sxb;
  const float* Zb = Zp + b * szb;
  const int col0 = blockIdx.x * kCols + lane * 4;
  const int row0 = blockIdx.y * kFwdRows + warp * 8;
  const bool vec = (M & 3) == 0;  // every row of `out` 16-byte aligned

  float inv[DP], z[4][DP], u[DP];
  if (!CHUNKED) {
#pragma unroll
    for (int k = 0; k < DP; ++k) inv[k] = inv_s[k];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      load_row<DP>(Zb + (long long)(col0 + c) * Dp, col0 + c < M, z[c]);
  }
#pragma unroll
  for (int step = 0; step < 2; ++step) {
    const int r = row0 + step * 4;
    if (r >= N) break;  // uniform across the warp
    float r2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) r2[i][c] = 0.0f;
    const int chunks = CHUNKED ? Dp / DP : 1;
    for (int kc = 0; kc < chunks; ++kc) {
      if (CHUNKED) {
#pragma unroll
        for (int k = 0; k < DP; ++k) inv[k] = inv_s[kc * DP + k];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          load_row<DP>(Zb + (long long)(col0 + c) * Dp + kc * DP, col0 + c < M, z[c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x[DP];
        load_row<DP>(Xb + (long long)(r + i) * Dp + kc * DP, r + i < N, x);
#pragma unroll
        for (int c = 0; c < 4; ++c) r2[i][c] = diffs<ARD, DP>(x, z[c], inv, u, r2[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r + i >= N) break;
      float kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float k, dk, log1;
        profile<FAMILY>(r2[i][c] * scale, variance, power, k, dk, log1);
        kv[c] = variance * k;
      }
      float* o = out + ((long long)b * N + r + i) * M + col0;
      if (vec && col0 + 3 < M) {
        __stcs(reinterpret_cast<float4*>(o), make_float4(kv[0], kv[1], kv[2], kv[3]));
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col0 + c < M) __stcs(o + c, kv[c]);
      }
    }
  }
}

// ------------------------------------------------------------------ backward
// G[row, col .. col + 3] of R rows, 0 outside rows < N and columns < M.
template <int R>
__device__ __forceinline__ void load_g(const float* __restrict__ Gb, int row0, int col, int N,
                                       int M, long long sgn, long long sgm, bool vec,
                                       float (&g)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + i;
    const float* p = Gb + row * sgn;
    if (row < N && vec && col + 3 < M) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(p + col));
      g[i][0] = v.x; g[i][1] = v.y; g[i][2] = v.z; g[i][3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        g[i][c] = (row < N && col + c < M) ? __ldcs(p + (col + c) * sgm) : 0.0f;
    }
  }
}

// Parameter gradients (one row of `partials` per block, when it is not null)
// and dX (NEED_DX). One block per (row strip, lane, column split); warp w owns
// R rows and sweeps the split's columns. dX needs one split.
template <int FAMILY, bool ARD, int DP, bool CHUNKED, bool NEED_DX>
__global__ void __launch_bounds__(kThreads, 2)
k_bwd_rows_kernel(const float* __restrict__ Xp, const float* __restrict__ Zp,
                  const float* __restrict__ params, const float* __restrict__ G,
                  float* __restrict__ dX, float* __restrict__ partials, int N, int M, int D,
                  int Dp, int W, long long sxb, long long szb, long long sgb, long long sgn,
                  long long sgm, int vec) {
  constexpr int R = NEED_DX ? kBwdRowsDx / kWarps : kBwdRowsParams / kWarps;
  __shared__ float inv_s[kMaxD];
  __shared__ float red[kWarps][2 + DP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.y;
  const float* ps = params + (long long)b * W;
  reciprocals<ARD>(ps, D, Dp, inv_s);
  const float variance = ps[0], power = ps[1];
  const float scale = ARD ? 1.0f : inv_s[0] * inv_s[0];
  const float* Xb = Xp + b * sxb;
  const float* Zb = Zp + b * szb;
  const float* Gb = G + b * sgb;
  const int row0 = blockIdx.x * (kWarps * R) + warp * R;
  const int col_tiles = (M + kCols - 1) / kCols;
  const int col_beg = (int)((long long)blockIdx.z * col_tiles / gridDim.z) * kCols + lane * 4;
  const int col_end =
      min(M, (int)((long long)(blockIdx.z + 1) * col_tiles / gridDim.z) * kCols);
  float* po = partials
                  ? partials + (((long long)b * gridDim.x + blockIdx.x) * gridDim.z + blockIdx.z) * W
                  : nullptr;

  const int chunks = CHUNKED ? Dp / DP : 1;
  for (int kc = 0; kc < chunks; ++kc) {
    float inv2[DP], x[R][DP], dl[DP], dx[R][DP];
    float dvar = 0.0f, dpow = 0.0f, dliso = 0.0f;
#pragma unroll
    for (int k = 0; k < DP; ++k) {
      inv2[k] = inv_s[kc * DP + k] * inv_s[kc * DP + k];
      dl[k] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      load_row<DP>(Xb + (long long)(row0 + i) * Dp + kc * DP, row0 + i < N, x[i]);
#pragma unroll
      for (int k = 0; k < DP; ++k) dx[i][k] = 0.0f;
    }
    if (row0 < N) {  // uniform across the warp
      float g[R][4], gn[R][4];
      load_g<R>(Gb, row0, col_beg, N, col_end, sgn, sgm, vec, g);
      for (int col0 = col_beg; col0 < col_end; col0 += kCols) {
        load_g<R>(Gb, row0, col0 + kCols, N, col_end, sgn, sgm, vec, gn);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool zvalid = col0 + c < col_end;
          const float* zrow = Zb + (long long)(col0 + c) * Dp;
          float z[DP];
          load_row<DP>(zrow + kc * DP, zvalid, z);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            float d[DP], q[DP];
            float r2 = sq_diffs<ARD, DP>(x[i], z, inv2, d, q, 0.0f);
            if (CHUNKED)
              r2 = (zvalid && row0 + i < N)
                       ? r2_all_chunks<ARD>(Xb + (long long)(row0 + i) * Dp, zrow, inv_s, Dp)
                       : 0.0f;
            r2 *= scale;
            float k, dk, log1;
            profile<FAMILY>(r2, variance, power, k, dk, log1);
            const float gv = g[i][c];
            const float wv = gv * dk;
            dvar = fmaf(gv, k, dvar);
            if (FAMILY == kRatquad) dpow = fmaf(gv * (variance * k), log1, dpow);
            if (!ARD) dliso = fmaf(wv, r2, dliso);
#pragma unroll
            for (int kk = 0; kk < DP; ++kk) {
              if (ARD) dl[kk] = fmaf(wv, q[kk], dl[kk]);
              if (NEED_DX) dx[i][kk] = fmaf(wv, d[kk], dx[i][kk]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[i][c] = gn[i][c];
      }
    }
    if (NEED_DX) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < DP; ++k) {
          const float s = warp_sum(dx[i][k]);
          const int dim = kc * DP + k;
          if (lane == 0 && row0 + i < N && dim < D)
            dX[((long long)b * N + row0 + i) * D + dim] = s * (ARD ? inv2[k] : scale);
        }
    }
    if (po != nullptr) {  // uniform across the block
      if (!ARD) dl[0] = dliso;
      const float s_var = warp_sum(dvar), s_pow = warp_sum(dpow);
      float s_dl[DP];
#pragma unroll
      for (int k = 0; k < DP; ++k) s_dl[k] = warp_sum(dl[k]);
      if (lane == 0) {
        red[warp][0] = s_var;
        red[warp][1] = s_pow;
#pragma unroll
        for (int k = 0; k < DP; ++k) red[warp][2 + k] = s_dl[k];
      }
      __syncthreads();
      if (tid < 2 + DP) {
        float s = 0.0f;
        for (int w = 0; w < kWarps; ++w) s += red[w][tid];
        if (tid == 0) {
          if (kc == 0) po[0] = s;
        } else if (tid == 1) {
          if (kc == 0) po[1] = FAMILY == kRatquad ? -s : 0.0f;
        } else if (ARD) {
          const int dim = kc * DP + tid - 2;
          if (dim < D) po[2 + dim] = -s * (inv_s[dim] * inv_s[dim] * inv_s[dim]);
        } else if (tid == 2 && kc == 0) {
          po[2] = -s * inv_s[0];
        }
      }
      if (kc == 0)
        for (int e = 2 + (ARD ? D : 1) + tid; e < W; e += kThreads) po[e] = 0.0f;
      __syncthreads();
    }
  }
}

// dZ. One block per (128 columns, strip of kColRows rows, lane): a thread owns
// 4 columns, warp w walks rows w, w + 8, ... of the strip. The block writes
// one (128, D) piece of `scratch` (B, strips, M, D); gpo_sum_partials adds the
// strips in order.
template <int FAMILY, bool ARD, int DP, bool CHUNKED>
__global__ void __launch_bounds__(kThreads, 2)
k_bwd_cols_kernel(const float* __restrict__ Xp, const float* __restrict__ Zp,
                  const float* __restrict__ params, const float* __restrict__ G,
                  float* __restrict__ scratch, int N, int M, int D, int Dp, int W,
                  long long sxb, long long szb, long long sgb, long long sgn, long long sgm,
                  int vec) {
  __shared__ float inv_s[kMaxD];
  __shared__ float4 red[kWarps][DP][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.z;
  const float* ps = params + (long long)b * W;
  reciprocals<ARD>(ps, D, Dp, inv_s);
  const float variance = ps[0], power = ps[1];
  const float scale = ARD ? 1.0f : inv_s[0] * inv_s[0];
  const float* Xb = Xp + b * sxb;
  const float* Zb = Zp + b * szb;
  const float* Gb = G + b * sgb;
  const int col0 = blockIdx.x * kCols + lane * 4;
  const int rbeg = blockIdx.y * kColRows + warp;
  const int rend = min(N, (int)(blockIdx.y + 1) * kColRows);
  float* so = scratch + (((long long)b * gridDim.y + blockIdx.y) * M) * D;

  const int chunks = CHUNKED ? Dp / DP : 1;
  for (int kc = 0; kc < chunks; ++kc) {
    float inv[DP], z[4][DP], dz[4][DP];
#pragma unroll
    for (int k = 0; k < DP; ++k) inv[k] = inv_s[kc * DP + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      load_row<DP>(Zb + (long long)(col0 + c) * Dp + kc * DP, col0 + c < M, z[c]);
#pragma unroll
      for (int k = 0; k < DP; ++k) dz[c][k] = 0.0f;
    }
    if (col0 < M && rbeg < rend) {
      float g[1][4], gn[1][4];
      load_g<1>(Gb, rbeg, col0, N, M, sgn, sgm, vec, g);
      for (int r = rbeg; r < rend; r += kWarps) {
        load_g<1>(Gb, r + kWarps, col0, rend, M, sgn, sgm, vec, gn);
        const float* xrow = Xb + (long long)r * Dp;
        float x[DP];
        load_row<DP>(xrow + kc * DP, true, x);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float u[DP];
          float r2 = diffs<ARD, DP>(x, z[c], inv, u, 0.0f);
          if (CHUNKED)
            r2 = col0 + c < M
                     ? r2_all_chunks<ARD>(xrow, Zb + (long long)(col0 + c) * Dp, inv_s, Dp)
                     : 0.0f;
          float k, dk, log1;
          profile<FAMILY>(r2 * scale, variance, power, k, dk, log1);
          const float wv = g[0][c] * dk;
#pragma unroll
          for (int kk = 0; kk < DP; ++kk) dz[c][kk] = fmaf(wv, u[kk], dz[c][kk]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) g[0][c] = gn[0][c];
      }
    }
#pragma unroll
    for (int k = 0; k < DP; ++k)
      red[warp][k][lane] = make_float4(dz[0][k], dz[1][k], dz[2][k], dz[3][k]);
    __syncthreads();
    for (int e = tid; e < DP * kCols; e += kThreads) {
      const int k = e / kCols, cl = e % kCols;
      const int col = blockIdx.x * kCols + cl, dim = kc * DP + k;
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += reinterpret_cast<const float*>(red[w][k])[cl];
      if (col < M && dim < D) so[(long long)col * D + dim] = -s * (ARD ? inv_s[dim] : scale);
    }
    __syncthreads();
  }
}

}  // namespace

// buckets: Dp = 4, 6, 8 held in registers, then chunks of 8
#define GPO_BUCKETS(K, ...) \
  {K<__VA_ARGS__, 4, false>, K<__VA_ARGS__, 6, false>, K<__VA_ARGS__, 8, false>, \
   K<__VA_ARGS__, kChunk, true>}
#define GPO_ROWS_BUCKET(A, DP, C) \
  {k_bwd_rows_kernel<GPO_FAMILY, A, DP, C, false>, k_bwd_rows_kernel<GPO_FAMILY, A, DP, C, true>}
#define GPO_ROWS_BUCKETS(A) \
  {GPO_ROWS_BUCKET(A, 4, false), GPO_ROWS_BUCKET(A, 6, false), GPO_ROWS_BUCKET(A, 8, false), \
   GPO_ROWS_BUCKET(A, kChunk, true)}

extern const FamilyKernels GPO_FAMILY_KERNELS(GPO_FAMILY);
const FamilyKernels GPO_FAMILY_KERNELS(GPO_FAMILY) = {
    {GPO_BUCKETS(k_build_kernel, GPO_FAMILY, false), GPO_BUCKETS(k_build_kernel, GPO_FAMILY, true)},
    {GPO_ROWS_BUCKETS(false), GPO_ROWS_BUCKETS(true)},
    {GPO_BUCKETS(k_bwd_cols_kernel, GPO_FAMILY, false),
     GPO_BUCKETS(k_bwd_cols_kernel, GPO_FAMILY, true)},
};

}  // namespace gpo

#endif  // GPO_FAMILY

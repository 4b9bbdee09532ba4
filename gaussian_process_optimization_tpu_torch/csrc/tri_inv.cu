// Batched inverse of lower-triangular (G, nb, nb) blocks, for sm_90a.
//
// Replaces, in the JAX package, ops/pallas_linalg.py: tri_inv_blocks, built by
// _make_entry, launched by _run_blocks, body _make_triinv_kernel.
//
// Bound. Per lane the function reads the lower triangle of one nb x nb block
// (nb (nb + 1) / 2 floats), writes one whole block (nb^2 floats) and does
// nb^3 / 3 flops: at G = 80, nb = 256 that is 31.5 MB, 9.4 us at 3.35 TB/s,
// against 6.7 us of f32 FMA time at 67 TFLOP/s. What limits a
// substitution done row by row is its chain instead: nb steps, each with two
// block-wide barriers and a cross-warp sum.
//
// Design: blocked forward substitution per strip. One block owns one (lane,
// strip of 32 columns) of the inverse, 8 x G blocks at nb = 256, enough to
// fill the card at G = 16 and G = 80. The strip's nb x 32 floats live in shared
// memory as 32 x 32 tiles X_k. The block walks the strip in tile rows i, not
// rows. Two warps form the right-hand side R_i = E_i - sum_{k<i} L_ik X_k
// (E = I on the strip's own tile row, 0 below) as register-tiled FFMA, 4 x 4
// entries per thread, while the L_ik tiles stream from device memory into a
// three-tile ring in shared memory by cp.async, two tiles ahead. A third warp
// solves L_ii X_i = R_i by substitution in registers (lane c holds column c),
// with L_ii fetched on its own, and hands X_i back through named barriers: the
// product warps go on with the next tile row's products meanwhile and wait for
// X_i only at its last one. That is nb / 32 tile steps instead of nb row steps,
// with the solves off the product warps' path.
// Every entry's sum is taken in forward substitution's order (k ascending);
// multiplying by inverted diagonal tiles, or the TPU's divide-and-conquer
// merge, would lose the residual bound below. Full f32 FFMA, no tensor cores
// (wgmma on f32 operands runs in TF32, which the port has turned off), no
// atomics: two launches give the same bits. The strict upper triangle is
// written as exact zeros.
//
// Rounding. Entry (r, c) of X below the diagonal is one chain of fmaf (the
// product warps' accumulator, which the solver's substitution continues): its
// m = r - c terms L_rj x_jc, j = c .. r - 1, take at most m roundings (terms
// with j < c multiply an exact 0 and round nothing), and the last step
// multiplies by the pivot's correctly rounded reciprocal (__frcp_rn), two
// roundings where IEEE division takes one. That row of L X = I has an exactly
// 0 right-hand side, so nothing has to be divided out of it, and
// L_rr x_rc (1 + theta_2) + sum_j L_rj x_jc (1 + theta_{r-j}) = 0 with
// |theta_k| <= gamma_k (Higham, Accuracy and Stability of Numerical
// Algorithms, Lemma 3.1). On the diagonal x_cc = fl(1 / L_cc), one rounding;
// above it x = 0 exactly. So |L X - I| <= gamma_{max(2, nb-1)} |L| |X|, inside
// the gamma_nb of forward substitution with IEEE division (Thm 8.5), the bound
// the checks (chip_smoke.py, the card tests) hold it to.

#include <cuda_runtime.h>

#include "block_smem.cuh"

namespace {

constexpr int kT = 32;          // tile edge, strip width
constexpr int kTile = kT * kT;  // floats per tile
constexpr int kProd = 64;       // the two product warps' threads
constexpr int kThreads = kProd + 32;  // and the solver warp
constexpr int kStages = 3;      // L tiles in the ring: kStages - 1 in flight
constexpr unsigned kFull = 0xffffffffu;
// Named barriers: R_i written (product warps arrive, the solver waits), X_i
// written (the solver arrives, the product warps wait), and the ring (product
// warps only).
constexpr int kBarR = 1, kBarX = 2, kBarRing = 3;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A ring tile holds L_ik row-major with its 16-byte pieces XOR-swizzled by the
// row, so the product threads' reads of four consecutive rows hit four bank
// groups: the piece of row r holding columns 4q .. 4q + 3 sits at at(r, q).
__device__ __forceinline__ int at(int r, int q) { return r * kT + 4 * (q ^ (r & 7)); }

// The off-diagonal tiles of L a strip s needs, in the order it uses them:
// (s+1, s); (s+2, s), (s+2, s+1); (s+3, s), ...
__device__ __forceinline__ void next_tile(int& i, int& k, int s) {
  if (++k >= i) {
    ++i;
    k = s;
  }
}

// Product thread t starts copying ring tile (i, k) into buf, unless the
// stream has ended (i == nt); either way one commit group.
__device__ __forceinline__ void fetch_ring(float* buf, const float* Lg, int nb, int nt, int i,
                                           int k, int t) {
  if (i < nt) {
    for (int e = t; e < kTile / 4; e += kProd)
      copy16(buf + at(e >> 3, e & 7), Lg + (long long)(kT * i + (e >> 3)) * nb + kT * k + 4 * (e & 7));
  }
  commit();
}

// The solver starts copying the diagonal tile (i, i), plain row-major, into buf.
__device__ __forceinline__ void fetch_diag(float* buf, const float* Lg, int nb, int i, int lane) {
  for (int e = lane; e < kTile / 4; e += 32)
    copy16(buf + 4 * e, Lg + (long long)(kT * i + (e >> 3)) * nb + kT * i + 4 * (e & 7));
  commit();
}

// acc[m][n] -= sum_p L_ik[r0 + 4 m][p] X_k[p][c0 + n], p ascending. The rows a
// load reads across a warp are consecutive, and its columns one row of X_k.
__device__ __forceinline__ void sub_product(float (&acc)[4][4], const float* Lt, const float* Xk,
                                            int r0, int c0) {
#pragma unroll
  for (int q = 0; q < kT / 4; ++q) {
    float l[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(Lt + at(r0 + 4 * m, q));
      l[m][0] = v.x; l[m][1] = v.y; l[m][2] = v.z; l[m][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 x = *reinterpret_cast<const float4*>(Xk + (4 * q + u) * kT + c0);
      const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(-l[m][u], xv[n], acc[m][n]);
      }
    }
  }
}

// The solver warp solves L_ii Y = R in place for the tile Xi (row-major, lane
// c owns column c): y_r = (r_r - sum_{p<r} L_ii[r][p] y_p) / L_ii[r][r],
// right-looking over p, so each y_r's sum is subtracted in p order.
__device__ __forceinline__ void solve_diag(float* Xi, const float* Lii, int lane) {
  float y[kT];
#pragma unroll
  for (int r = 0; r < kT; ++r) y[r] = Xi[r * kT + lane];
  const float inv = __frcp_rn(Lii[lane * kT + lane]);
#pragma unroll
  for (int p = 0; p < kT; ++p) {
    y[p] *= __shfl_sync(kFull, inv, p);
#pragma unroll
    for (int r = p + 1; r < kT; ++r) y[r] = fmaf(-Lii[r * kT + p], y[p], y[r]);
  }
#pragma unroll
  for (int r = 0; r < kT; ++r) Xi[r * kT + lane] = y[r];
}

__global__ void __launch_bounds__(kThreads)
tri_inv_kernel(const float* __restrict__ L, float* __restrict__ out, int nb) {
  extern __shared__ __align__(16) float smem[];
  const int nt = nb / kT, s = blockIdx.y;
  float* xs = smem;                       // X_k at xs + k * kTile, row-major; k >= s
  float* ring = smem + nt * kTile;        // kStages tiles L_ik
  float* diag = ring + kStages * kTile;   // two tiles L_ii, the solver's
  const long long base = (long long)blockIdx.x * nb * nb;
  const float* Lg = L + base;
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid < kProd) {
    // Thread (w, rg, cg): rows 16 w + rg + 4 m, columns 4 cg .. 4 cg + 3.
    const int r0 = 16 * (tid >> 5) + (lane & 3), c0 = 4 * (lane >> 2);
    int fi = s + 1, fk = s;  // the next tile to fetch
    for (int st = 0; st < kStages - 1; ++st) {
      fetch_ring(ring + st * kTile, Lg, nb, nt, fi, fk, tid);
      next_tile(fi, fk, s);
    }
    int slot = 0;
    for (int i = s; i < nt; ++i) {
      float acc[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = (i == s && r0 + 4 * m == c0 + n) ? 1.0f : 0.0f;
      }
      for (int k = s; k < i; ++k) {
        // Tile (i, k) has landed for every product thread, and every one is
        // done with the slot of the previous step, which the next copy refills.
        wait_copies<kStages - 2>();
        bar_sync(kBarRing, kProd);
        fetch_ring(ring + (slot + kStages - 1) % kStages * kTile, Lg, nb, nt, fi, fk, tid);
        next_tile(fi, fk, s);
        if (k == i - 1) bar_sync(kBarX, kThreads);  // X_{i-1} from the solver
        sub_product(acc, ring + slot * kTile, xs + k * kTile, r0, c0);
        slot = (slot + 1) % kStages;
      }
      float* Ri = xs + i * kTile;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        *reinterpret_cast<float4*>(Ri + (r0 + 4 * m) * kT + c0) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      bar_arrive(kBarR, kThreads);
    }
    bar_sync(kBarX, kThreads);  // the last X_i
  } else {
    fetch_diag(diag, Lg, nb, s, lane);
    for (int i = s; i < nt; ++i) {
      const float* Lii = diag + (i - s) % 2 * kTile;
      wait_copies<0>();
      __syncwarp();
      if (i + 1 < nt) fetch_diag(diag + (i + 1 - s) % 2 * kTile, Lg, nb, i + 1, lane);
      bar_sync(kBarR, kThreads);  // R_i from the product warps
      solve_diag(xs + i * kTile, Lii, lane);
      __syncwarp();
      bar_arrive(kBarX, kThreads);
    }
  }
  __syncthreads();

  // Store the strip: zero above row 32 s and above the diagonal of X_s.
  float* Og = out + base + kT * s;
  for (int e = tid; e < nb * (kT / 4); e += kThreads) {
    const int row = e >> 3, q = e & 7, i = row / kT, r = row % kT;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i >= s) {
      v = *reinterpret_cast<const float4*>(xs + i * kTile + r * kT + 4 * q);
      if (i == s) {
        v.x = 4 * q > r ? 0.0f : v.x;
        v.y = 4 * q + 1 > r ? 0.0f : v.y;
        v.z = 4 * q + 2 > r ? 0.0f : v.z;
        v.w = 4 * q + 3 > r ? 0.0f : v.w;
      }
    }
    *reinterpret_cast<float4*>(Og + (long long)row * nb + 4 * q) = v;
  }
}

// Dynamic shared memory of one launch: the strip, the ring and the two
// diagonal tiles (up to nb = 1632 on Hopper).
size_t tri_inv_smem(int nb) { return sizeof(float) * ((size_t)nb * kT + (kStages + 2) * kTile); }

}  // namespace

extern "C" {

// Returns kSmemDoesNotFit, launching nothing, when one strip does not fit a
// block's shared memory.
int gpo_tri_inv_blocks(const float* L, float* out, int G, int nb, void* stream) {
  const size_t smem = tri_inv_smem(nb);
  const int err = opt_in_smem(tri_inv_kernel, smem);
  if (err != 0) return err;
  const dim3 grid(G, nb / kT);  // every lane's strip 0, the longest, first
  tri_inv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(L, out, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

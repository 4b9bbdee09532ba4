// Batched Cholesky of symmetric positive-definite (G, nb, nb) blocks, for sm_90a.
//
// Replaces, in the JAX package, ops/pallas_linalg.py: cholesky_blocks, built by
// _make_entry, launched by _run_blocks, body _make_chol_kernel.
//
// The TPU kernel keeps eight whole lanes of blocks in VMEM and runs a
// right-looking factorization over 32-column micro-panels, vectorized across
// lanes. A 256x256 f32 block is 256 KB, more than the 227 KB of shared memory
// a Hopper block can use, but its lower triangle packed by rows is
// nb (nb + 1) / 2 floats, 128.5 KB at nb = 256. So here one block owns one
// lane: it loads the lower triangle once into shared memory, factors it there
// column by column (right-looking: scale the column by its pivot's square
// root, then subtract its rank-1 update from the trailing triangle), and
// stores L once, with exact zeros above the diagonal. The current column is
// also kept in a separate vector, so the update reads it without bank
// conflicts. One warp updates one packed row at a time, its lanes on
// consecutive columns. Each entry's updates run in one fixed order, so two
// launches give the same bits.
//
// A pivot that is not positive (or is NaN) stops the lane's factorization and
// its whole output block is NaN; other lanes are untouched. That is the
// failure signal the jitter ladder reads (finiteness per lane).
//
// Bound: the column recursion (nb steps, two barriers each) and shared-memory
// latency: nb^3/6 multiply-adds per lane over one block of 16 warps. The bytes
// (one nb^2 read and one nb^2 write per lane) are small. A blocked, wgmma form
// of the trailing update is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

__global__ void chol_blocks_kernel(const float* __restrict__ A, float* __restrict__ out,
                                   int nb) {
  extern __shared__ float smem[];
  float* a = smem;                  // packed lower triangle, row i at a[tri(i)]
  float* col = smem + tri(nb);      // column j of L, rows j+1..nb-1
  const long long base = (long long)blockIdx.x * nb * nb;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  for (int i = warp; i < nb; i += kWarps) {
    const float* src = A + base + (long long)i * nb;
    for (int k = lane; k <= i; k += 32) a[tri(i) + k] = src[k];
  }
  __syncthreads();

  bool ok = true;
  for (int j = 0; j < nb; ++j) {
    // The pivot was last written before the barrier that ended column j-1, and
    // is overwritten with its square root only after the next barrier, so every
    // thread reads the same pivot here: the branch is uniform.
    const float piv = a[tri(j) + j];
    if (!(piv > 0.0f)) {
      ok = false;
      break;
    }
    const float d = sqrtf(piv);
    for (int i = j + 1 + tid; i < nb; i += kThreads) {
      const float v = a[tri(i) + j] / d;
      a[tri(i) + j] = v;
      col[i] = v;
    }
    __syncthreads();
    // the trailing update below touches columns > j only
    if (tid == 0) a[tri(j) + j] = d;
    for (int i = j + 1 + warp; i < nb; i += kWarps) {
      const float ci = col[i];
      float* row = a + tri(i);
      for (int k = j + 1 + lane; k <= i; k += 32) row[k] -= ci * col[k];
    }
    __syncthreads();
  }

  const float nan = __int_as_float(0x7fc00000);
  for (int i = warp; i < nb; i += kWarps) {
    float* dst = out + base + (long long)i * nb;
    for (int k = lane; k < nb; k += 32)
      dst[k] = !ok ? nan : (k <= i ? a[tri(i) + k] : 0.0f);
  }
}

}  // namespace

extern "C" {

// The wrapper (ops/cuda_linalg.py) checks that this shared-memory size fits.
int gpo_cholesky_blocks(const float* A, float* out, int G, int nb, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)nb * (nb + 1) / 2 + nb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chol_blocks_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, out, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Fixed-iteration Jacobi-preconditioned CG for batched linear Darcy solves.
//
// Replaces pde_surrogate_tpu/ops/kernels/cg_darcy.py::solve_darcy_pallas
// (body _cg_kernel).  Computes, for each field K (n x n, f32), the pressure
// u of div(K grad u) = 0 on the node-centred 5-point finite-volume grid:
// harmonic-mean face conductivities, zero flux through the top and bottom
// walls, Dirichlet columns u = 1 (left) and u = 0 (right) eliminated, right
// hand side b = kW on column 1, then n_iter PCG iterations with per-field
// dot products and the same +1e-30 guards.  Output u = u_d + v * mask.
//
// What bounds it on Hopper: not bytes (K in, u out: 8 bytes per cell) and
// not FP32 throughput (~23 flop per cell per iteration), but the latency
// of n_iter dependent iterations, each a stencil plus two block-wide
// reductions.  Design: one CTA per field (the whole solve stays on one SM,
// no grid-wide synchronisation), up to 1024 threads with CPT cells each.
// p and the two face arrays that define the operator (east and south; west
// of (i,j) is east of (i,j-1), north is south of (i-1,j)) live in dynamic
// shared memory: 3 n^2 floats, 48 KB at 64^2 and 192 KB at 128^2.  v, r and
// Ap stay in registers; the Jacobi inverse diagonal is recomputed from the
// shared faces when needed so that 128^2 fits 64 registers per thread.
// Each iteration has three barriers: after the p.Ap reduction, after the
// r.z reduction and after the p update.  Reductions are warp shuffles then
// one shared-memory pass that every thread sums in the same order, so all
// threads see bit-identical alpha and beta.
//
// Build without --use_fast_math: the CG runs into denormal r.z once it has
// converged to the f32 floor, and flushing them or approximating the
// division changes the iterates.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float harm(float a, float b) {
  return 2.0f * a * b / (a + b);
}

// Sum of v over the block.  Every thread returns the same value.  The
// caller alternates `red` buffers between consecutive reductions.
__device__ __forceinline__ float block_sum(float v, float* red, int nwarps) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < nwarps; ++w) s += red[w];
  return s;
}

template <int CPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
cg_darcy_kernel(const float* __restrict__ k_all, float* __restrict__ u_all,
                int n, int n_iter) {
  extern __shared__ float smem[];
  __shared__ float red_a[32];
  __shared__ float red_b[32];
  const int nn = n * n;
  float* p = smem;
  float* kE = smem + nn;
  float* kS = smem + 2 * nn;
  const float* K = k_all + static_cast<size_t>(blockIdx.x) * nn;
  float* u = u_all + static_cast<size_t>(blockIdx.x) * nn;
  const int nwarps = blockDim.x >> 5;

  for (int c = 0; c < CPT; ++c) {
    const int idx = threadIdx.x + c * blockDim.x;
    if (idx < nn) {
      const int row = idx / n, col = idx - row * n;
      const float k = K[idx];
      kE[idx] = col < n - 1 ? harm(k, K[idx + 1]) : 0.0f;
      kS[idx] = row < n - 1 ? harm(k, K[idx + n]) : 0.0f;
    }
  }
  __syncthreads();

  // Jacobi inverse diagonal of an interior cell: mask / max(diag, 1e-30)
  auto inv_diag = [&](int idx, int row) -> float {
    const float kn = row > 0 ? kS[idx - n] : 0.0f;
    const float d = kE[idx] + kE[idx - 1] + kn + kS[idx];
    return 1.0f / fmaxf(d, 1e-30f);
  };

  float v[CPT], r[CPT], ap[CPT];
  float part = 0.0f;
  for (int c = 0; c < CPT; ++c) {
    const int idx = threadIdx.x + c * blockDim.x;
    v[c] = 0.0f;
    r[c] = 0.0f;
    ap[c] = 0.0f;
    if (idx < nn) {
      const int row = idx / n, col = idx - row * n;
      float z = 0.0f;
      if (col > 0 && col < n - 1) {
        r[c] = col == 1 ? kE[idx - 1] : 0.0f;  // b = kW on column 1
        z = r[c] * inv_diag(idx, row);
      }
      p[idx] = z;
      part += r[c] * z;
    }
  }
  float rz = block_sum(part, red_b, nwarps);  // its barrier also publishes p

  for (int it = 0; it < n_iter; ++it) {
    part = 0.0f;
    for (int c = 0; c < CPT; ++c) {
      const int idx = threadIdx.x + c * blockDim.x;
      if (idx < nn) {
        const int row = idx / n, col = idx - row * n;
        float a = 0.0f;
        const float pc = p[idx];
        if (col > 0 && col < n - 1) {
          const float pN = row > 0 ? p[idx - n] : pc;
          const float pS = row < n - 1 ? p[idx + n] : pc;
          const float kn = row > 0 ? kS[idx - n] : 0.0f;
          const float lap = kE[idx] * (p[idx + 1] - pc)
                            + kE[idx - 1] * (p[idx - 1] - pc)
                            + kn * (pN - pc) + kS[idx] * (pS - pc);
          a = -lap;
        }
        ap[c] = a;
        part += pc * a;
      }
    }
    const float pap = block_sum(part, red_a, nwarps);
    const float alpha = rz / (pap + 1e-30f);

    part = 0.0f;
    for (int c = 0; c < CPT; ++c) {
      const int idx = threadIdx.x + c * blockDim.x;
      if (idx < nn) {
        const int row = idx / n, col = idx - row * n;
        v[c] += alpha * p[idx];
        r[c] -= alpha * ap[c];
        const float z = (col > 0 && col < n - 1) ? r[c] * inv_diag(idx, row)
                                                 : 0.0f;
        ap[c] = z;  // Ap is spent; the slot now holds z
        part += r[c] * z;
      }
    }
    const float rz_new = block_sum(part, red_b, nwarps);
    const float beta = rz_new / (rz + 1e-30f);
    rz = rz_new;
    for (int c = 0; c < CPT; ++c) {
      const int idx = threadIdx.x + c * blockDim.x;
      if (idx < nn) p[idx] = ap[c] + beta * p[idx];
    }
    __syncthreads();
  }

  for (int c = 0; c < CPT; ++c) {
    const int idx = threadIdx.x + c * blockDim.x;
    if (idx < nn) {
      const int col = idx % n;
      u[idx] = col == 0 ? 1.0f : (col == n - 1 ? 0.0f : v[c]);
    }
  }
}

template <int CPT>
cudaError_t launch(const float* k, float* u, int batch, int n, int n_iter,
                   int threads, cudaStream_t stream) {
  const size_t smem = 3 * static_cast<size_t>(n) * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cg_darcy_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cg_darcy_kernel<CPT><<<batch, threads, smem, stream>>>(k, u, n, n_iter);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Solves `batch` fields of n x n; K and u are contiguous (batch, n, n) f32
// device buffers.  Returns a cudaError_t (0 on success); launches on
// `stream` and does not synchronise.
int cg_darcy_launch(const float* k, float* u, int batch, int n, int n_iter,
                    void* stream) {
  if (batch <= 0) return 0;
  if (n < 3 || n_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nn = n * n;
  const int threads = nn < kMaxThreads ? (nn + 31) / 32 * 32 : kMaxThreads;
  const int cpt = (nn + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cpt <= 1) err = launch<1>(k, u, batch, n, n_iter, threads, s);
  else if (cpt <= 2) err = launch<2>(k, u, batch, n, n_iter, threads, s);
  else if (cpt <= 4) err = launch<4>(k, u, batch, n, n_iter, threads, s);
  else if (cpt <= 8) err = launch<8>(k, u, batch, n, n_iter, threads, s);
  else if (cpt <= 16) err = launch<16>(k, u, batch, n, n_iter, threads, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* cg_darcy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

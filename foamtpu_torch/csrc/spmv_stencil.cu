// Offset-stencil SpMV for Hopper (sm_90a), bound to PyTorch with ctypes.
//
//   y[c,k] = (diag[c,k] * x[c,k] if diag) + sum_m soff[c,m] * x[(c + d_m) mod n, k]
//
// x, diag and y are [n] or [n, C] row-major; soff is [n, ldm] row-major
// with ldm >= M. The coefficients already carry the st_valid mask, so a
// wrapped neighbour multiplies an in-range value by exactly 0 (the
// jnp.roll / torch.roll semantics of the reference's roll chain).
//
// Replaces openfoam-2.2.x_tpu/ops/pallas_spmv.py::spmv_fused, the one
// Pallas kernel of the JAX package (its pallas_call), and also serves the
// no-diagonal apply_off form and multi-column operands.
//
// What bounds it: bytes. Each cell reads M coefficients, one diagonal,
// its own x and M neighbour values, and writes one y: about (M + 2)
// values per cell from device memory, with the neighbour reads of x
// reused through L1/L2 (the +-1 neighbours share cache lines, the +-nx
// rows were read by nearby blocks shortly before). At 400^2 cells and
// M = 4 in float32 one call moves about 4.5 MB, which the card streams in
// a few microseconds: the same order as one kernel launch. So the design's
// gain over the plain roll chain is one launch instead of about 2M + 1,
// with no [n]-sized temporaries. The TPU tiling of the Pallas kernel
// (128-lane rows, row shifts done outside the kernel, lane rolls inside
// it) is dropped: on Hopper one thread per (cell, column) reads
// x[c + d_m] directly, and neighbouring threads read neighbouring
// addresses.
//
// Deltas travel by value in a small struct, already wrapped to [0, n) by
// the host entry; M is checked against SPMV_MAX_OFFSETS. Making the
// kernel fast (vectorised loads, fused Jacobi/Chebyshev sweeps) is later
// work.

#include <cuda_runtime.h>

#define SPMV_MAX_OFFSETS 16

struct Deltas {
  int m;
  long long d[SPMV_MAX_OFFSETS];  // each in [0, n)
};

template <typename T, bool VEC>
__global__ void spmv_stencil_kernel(const T* __restrict__ diag,
                                    const T* __restrict__ x,
                                    const T* __restrict__ soff,
                                    T* __restrict__ y, long long n, int ncols,
                                    int ldm, Deltas dl) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * ncols) return;
  long long c = t;
  int k = 0;
  if (VEC) {
    c = t / ncols;
    k = (int)(t - c * ncols);
  }
  const T* s = soff + c * ldm;
  T acc = T(0);
#pragma unroll
  for (int m = 0; m < SPMV_MAX_OFFSETS; ++m) {
    if (m >= dl.m) break;
    long long j = c + dl.d[m];
    if (j >= n) j -= n;
    acc += s[m] * x[VEC ? j * ncols + k : j];
  }
  if (diag != nullptr) acc = diag[t] * x[t] + acc;
  y[t] = acc;
}

template <typename T>
static int launch(const T* diag, const T* x, const T* soff, T* y, long long n,
                  int ncols, int ldm, const long long* deltas, int m,
                  void* stream) {
  if (m < 0 || m > SPMV_MAX_OFFSETS || ncols < 1 || ldm < m || n < 0)
    return (int)cudaErrorInvalidValue;
  Deltas dl;
  dl.m = m;
  for (int i = 0; i < SPMV_MAX_OFFSETS; ++i) {
    long long d = i < m ? deltas[i] % (n > 0 ? n : 1) : 0;
    dl.d[i] = d < 0 ? d + n : d;
  }
  const long long total = n * ncols;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ncols == 1)
    spmv_stencil_kernel<T, false>
        <<<(unsigned)blocks, threads, 0, s>>>(diag, x, soff, y, n, 1, ldm, dl);
  else
    spmv_stencil_kernel<T, true>
        <<<(unsigned)blocks, threads, 0, s>>>(diag, x, soff, y, n, ncols, ldm,
                                              dl);
  return (int)cudaGetLastError();
}

extern "C" int spmv_stencil_f32(const float* diag, const float* x,
                                const float* soff, float* y, long long n,
                                int ncols, int ldm, const long long* deltas,
                                int m, void* stream) {
  return launch<float>(diag, x, soff, y, n, ncols, ldm, deltas, m, stream);
}

extern "C" int spmv_stencil_f64(const double* diag, const double* x,
                                const double* soff, double* y, long long n,
                                int ncols, int ldm, const long long* deltas,
                                int m, void* stream) {
  return launch<double>(diag, x, soff, y, n, ncols, ldm, deltas, m, stream);
}

extern "C" int spmv_stencil_max_offsets() { return SPMV_MAX_OFFSETS; }

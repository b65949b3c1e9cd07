// Offset-stencil SpMV with its COO remainder fused, for Hopper (sm_90a),
// bound to PyTorch with ctypes.
//
//   y[c,k] = (diag[c,k] * x[c,k] if diag)
//            + sum_m soff[c,m] * x[(c + d_m) mod n, k]
//            + sum_{e = rowptr[c]}^{rowptr[c+1]-1} val[e] * x[col[e], k]
//
// x, diag and y are [n] or [n, C] row-major; soff is [n, ldm] row-major
// with ldm >= M. The coefficients already carry the st_valid mask, so a
// wrapped neighbour multiplies an in-range value by exactly 0 (the
// jnp.roll / torch.roll semantics of the reference's roll chain). The
// remainder (the incidences no slot covers) comes in a row layout: int32
// rowptr [n + 1], int32 col and val [nfb] in row order; rowptr == nullptr
// means no remainder.
//
// Replaces openfoam-2.2.x_tpu/ops/pallas_spmv.py::spmv_fused (the one
// Pallas kernel of the JAX package, its pallas_call at :109) together with
// the XLA scatter the reference adds after it for the remainder
// (openfoam-2.2.x_tpu/ops/stencil.py:85-87). One launch computes the whole
// operator, with no atomics and no temporaries; it also serves the
// no-diagonal apply_off form and multi-column operands (the [n, 3]
// momentum matrix, the coarsest GAMG level's dense assembly with C = n).
//
// What bounds it: bytes. Per cell it must read one soff row, diag and x,
// one rowptr entry and, per remainder entry, a coefficient and an int32
// column, and write y; the neighbour reads of x hit L1/L2 (the +-1
// neighbours share cache lines, farther rows were read by nearby blocks
// shortly before). What each design point does about that:
// - M is a template parameter (0..8; a generic body serves 9..16), so
//   every soff and neighbour load of a cell is issued before the first
//   FMA and no loop exit is tested per slot.
// - One thread per cell for C <= 4 (C a template parameter too): the
//   soff row is read once for all columns and no thread divides by C. A
//   (cell, column)-parallel kernel serves C > 4.
// - The soff row is read with 16-byte loads (float4 / double2) where the
//   base and ldm * sizeof(T) allow it, else 8-byte float2 loads, else
//   scalar loads; x, diag, soff and the remainder go through the
//   read-only path (__ldg).
// - For C == 1 each thread takes two cells, blockDim apart (coalesced),
//   with all their loads issued together, to keep bytes in flight on the
//   small cavity operands.
// - The remainder loop runs over the cell's own rows of the layout in
//   the same thread, after the slot sum: diag*x + slots, then the
//   remainder, the reference's order. No atomics: each row has one owner.
// The TPU tiling of the Pallas kernel (128-lane rows, row shifts done
// outside the kernel, lane rolls inside it) is dropped.
//
// Deltas travel by value in the argument struct, already wrapped to
// [0, n) by the host entry; n < 2^31 (int32 row pointers).

#include <cuda_runtime.h>
#include <stdint.h>

#define SPMV_MAX_OFFSETS 16
#define SPMV_THREADS 256

template <typename T>
struct Args {
  const T* diag;      // [n, C] or nullptr
  const T* x;         // [n, C]
  const T* soff;      // [n, ldm]
  T* y;               // [n, C]
  const int* rowptr;  // [n + 1] or nullptr (no remainder)
  const int* col;     // [nfb], row order
  const T* val;       // [nfb], row order
  int n;
  int ncols;
  int ldm;
  int m;
  int vec;            // soff row loads: 2 = 16-byte, 1 = 8-byte, 0 = scalar
  int d[SPMV_MAX_OFFSETS];  // each in [0, n)
};

template <int NC>
__host__ __device__ constexpr int cells_per_thread() {
  return NC == 1 ? 2 : 1;
}

__device__ __forceinline__ void unpack(const float4& v, float* e) {
  e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* e) {
  e[0] = v.x; e[1] = v.y;
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { typedef float4 type; };
template <> struct Vec16<double> { typedef double2 type; };

// The first M entries of one soff row into s.
template <typename T, int M>
__device__ __forceinline__ void load_row(T* s, const T* __restrict__ row,
                                         int vec) {
  if (vec == 2) {
    constexpr int V = 16 / sizeof(T);
    constexpr int NV = (M + V - 1) / V;
    const typename Vec16<T>::type* r =
        reinterpret_cast<const typename Vec16<T>::type*>(row);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      T e[V];
      unpack(__ldg(r + i), e);
#pragma unroll
      for (int t = 0; t < V; ++t)
        if (i * V + t < M) s[i * V + t] = e[t];
    }
    return;
  }
  if constexpr (sizeof(T) == 4) {
    if (vec == 1) {
      const float2* r = reinterpret_cast<const float2*>(row);
#pragma unroll
      for (int i = 0; i < (M + 1) / 2; ++i) {
        const float2 v = __ldg(r + i);
        s[2 * i] = v.x;
        if (2 * i + 1 < M) s[2 * i + 1] = v.y;
      }
      return;
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) s[m] = __ldg(row + m);
}

// One thread per cell (CPT cells per thread), all C <= 4 columns. M < 0
// is the generic body: the call's a.m (<= SPMV_MAX_OFFSETS) offsets.
template <typename T, int M, int NC>
__global__ void __launch_bounds__(SPMV_THREADS)
    spmv_stencil_kernel_cell(const Args<T> a) {
  constexpr int CPT = cells_per_thread<NC>();
  constexpr int ML = M < 0 ? SPMV_MAX_OFFSETS : M;  // slots unrolled
  constexpr int MS = ML > 0 ? ML : 1;               // storage
  const int mm = M < 0 ? a.m : M;
  const int base = blockIdx.x * (SPMV_THREADS * CPT) + threadIdx.x;

  T s[CPT][MS];
  T xn[CPT][MS][NC];
  T xs[CPT][NC];
  T dg[CPT][NC];
  int e0[CPT], e1[CPT];

  // every load of the thread's cells first
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int c = base + u * SPMV_THREADS;
    e0[u] = 0;
    e1[u] = 0;
    if (c >= a.n) continue;
    const T* row = a.soff + (long long)c * a.ldm;
    if constexpr (M > 0) {
      load_row<T, M>(s[u], row, a.vec);
    } else if constexpr (M < 0) {
#pragma unroll
      for (int m = 0; m < ML; ++m)
        if (m < mm) s[u][m] = __ldg(row + m);
    }
#pragma unroll
    for (int m = 0; m < ML; ++m) {
      if (M < 0 && m >= mm) continue;
      int j = c + a.d[m];
      if (j >= a.n) j -= a.n;
#pragma unroll
      for (int k = 0; k < NC; ++k)
        xn[u][m][k] = __ldg(a.x + (long long)j * NC + k);
    }
    if (a.diag != nullptr) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        dg[u][k] = __ldg(a.diag + (long long)c * NC + k);
        xs[u][k] = __ldg(a.x + (long long)c * NC + k);
      }
    }
    if (a.rowptr != nullptr) {
      e0[u] = __ldg(a.rowptr + c);
      e1[u] = __ldg(a.rowptr + c + 1);
    }
  }

#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int c = base + u * SPMV_THREADS;
    if (c >= a.n) continue;
    T acc[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[k] = T(0);
#pragma unroll
    for (int m = 0; m < ML; ++m) {
      if (M < 0 && m >= mm) continue;
#pragma unroll
      for (int k = 0; k < NC; ++k) acc[k] += s[u][m] * xn[u][m][k];
    }
    if (a.diag != nullptr) {
#pragma unroll
      for (int k = 0; k < NC; ++k) acc[k] = dg[u][k] * xs[u][k] + acc[k];
    }
    for (int e = e0[u]; e < e1[u]; ++e) {
      const int j = __ldg(a.col + e);
      const T v = __ldg(a.val + e);
#pragma unroll
      for (int k = 0; k < NC; ++k)
        acc[k] += v * __ldg(a.x + (long long)j * NC + k);
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) a.y[(long long)c * NC + k] = acc[k];
  }
}

// One thread per (cell, column), for C > 4 (the coarsest GAMG level's
// dense assembly applies the operator to the identity, C = n).
template <typename T>
__global__ void __launch_bounds__(SPMV_THREADS)
    spmv_stencil_kernel_cols(const Args<T> a) {
  const long long t = (long long)blockIdx.x * SPMV_THREADS + threadIdx.x;
  if (t >= (long long)a.n * a.ncols) return;
  const int c = (int)(t / a.ncols);
  const int k = (int)(t - (long long)c * a.ncols);
  const T* row = a.soff + (long long)c * a.ldm;
  T acc = T(0);
#pragma unroll
  for (int m = 0; m < SPMV_MAX_OFFSETS; ++m) {
    if (m >= a.m) break;
    int j = c + a.d[m];
    if (j >= a.n) j -= a.n;
    acc += __ldg(row + m) * __ldg(a.x + (long long)j * a.ncols + k);
  }
  if (a.diag != nullptr) acc = __ldg(a.diag + t) * __ldg(a.x + t) + acc;
  if (a.rowptr != nullptr) {
    const int e1 = __ldg(a.rowptr + c + 1);
    for (int e = __ldg(a.rowptr + c); e < e1; ++e)
      acc += __ldg(a.val + e) *
             __ldg(a.x + (long long)__ldg(a.col + e) * a.ncols + k);
  }
  a.y[t] = acc;
}

template <typename T, int M, int NC>
static void launch_cell(const Args<T>& a, cudaStream_t s) {
  const long long per_block = SPMV_THREADS * cells_per_thread<NC>();
  const unsigned blocks = (unsigned)((a.n + per_block - 1) / per_block);
  spmv_stencil_kernel_cell<T, M, NC><<<blocks, SPMV_THREADS, 0, s>>>(a);
}

template <typename T, int NC>
static void dispatch_m(const Args<T>& a, cudaStream_t s) {
  switch (a.m) {
    case 0: launch_cell<T, 0, NC>(a, s); break;
    case 1: launch_cell<T, 1, NC>(a, s); break;
    case 2: launch_cell<T, 2, NC>(a, s); break;
    case 3: launch_cell<T, 3, NC>(a, s); break;
    case 4: launch_cell<T, 4, NC>(a, s); break;
    case 5: launch_cell<T, 5, NC>(a, s); break;
    case 6: launch_cell<T, 6, NC>(a, s); break;
    case 7: launch_cell<T, 7, NC>(a, s); break;
    case 8: launch_cell<T, 8, NC>(a, s); break;
    default: launch_cell<T, -1, NC>(a, s); break;
  }
}

template <typename T>
static int launch(const T* diag, const T* x, const T* soff, T* y, long long n,
                  int ncols, int ldm, const long long* deltas, int m,
                  const int* rowptr, const int* col, const T* val,
                  void* stream) {
  if (m < 0 || m > SPMV_MAX_OFFSETS || ncols < 1 || ldm < m || n < 0 ||
      n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Args<T> a;
  a.diag = diag;
  a.x = x;
  a.soff = soff;
  a.y = y;
  a.rowptr = rowptr;
  a.col = col;
  a.val = val;
  a.n = (int)n;
  a.ncols = ncols;
  a.ldm = ldm;
  a.m = m;
  for (int i = 0; i < SPMV_MAX_OFFSETS; ++i) {
    long long d = i < m ? deltas[i] % n : 0;
    a.d[i] = (int)(d < 0 ? d + n : d);
  }
  const uintptr_t p = reinterpret_cast<uintptr_t>(soff);
  const size_t row_bytes = (size_t)ldm * sizeof(T);
  a.vec = (p % 16 == 0 && row_bytes % 16 == 0) ? 2
          : (sizeof(T) == 4 && p % 8 == 0 && row_bytes % 8 == 0) ? 1
                                                                 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ncols) {
    case 1: dispatch_m<T, 1>(a, s); break;
    case 2: dispatch_m<T, 2>(a, s); break;
    case 3: dispatch_m<T, 3>(a, s); break;
    case 4: dispatch_m<T, 4>(a, s); break;
    default: {
      const long long blocks = (n * ncols + SPMV_THREADS - 1) / SPMV_THREADS;
      spmv_stencil_kernel_cols<T>
          <<<(unsigned)blocks, SPMV_THREADS, 0, s>>>(a);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int spmv_stencil_f32(const float* diag, const float* x,
                                const float* soff, float* y, long long n,
                                int ncols, int ldm, const long long* deltas,
                                int m, const int* rowptr, const int* col,
                                const float* val, void* stream) {
  return launch<float>(diag, x, soff, y, n, ncols, ldm, deltas, m, rowptr,
                       col, val, stream);
}

extern "C" int spmv_stencil_f64(const double* diag, const double* x,
                                const double* soff, double* y, long long n,
                                int ncols, int ldm, const long long* deltas,
                                int m, const int* rowptr, const int* col,
                                const double* val, void* stream) {
  return launch<double>(diag, x, soff, y, n, ncols, ldm, deltas, m, rowptr,
                        col, val, stream);
}

extern "C" int spmv_stencil_max_offsets() { return SPMV_MAX_OFFSETS; }

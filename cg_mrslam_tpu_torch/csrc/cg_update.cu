// The PCG loop's vector updates for NVIDIA Hopper, sm_90a: two updates a
// CG iteration, each one kernel (or, for a system too long for one block,
// a short fixed sequence of kernels), over every system still iterating.
//
// Replaces no Pallas kernel: the JAX package leaves the CG body to XLA
// (cg_mrslam_tpu/solver/pcg.py, the bodies of its lax.scans, which XLA
// fuses). In the port its plain PyTorch form (ops/cg_update.py,
// update_a_plain and update_b_plain; solver/pcg.py, _masked_pcg) is some
// thirty launches an iteration: three dot products, three axpys, four
// vector selects and the scalars between them, about 38 passes over the
// CG vectors. For S systems (a graph, or one column of a graph's
// marginal solves) of L = 3N floats each, with hp = H p (the HVP kernel
// pair) and z = M^-1 r (the preconditioner's kernel) between them:
//
//   update A, per active system s:
//     hps = hp + (sigma p) free            (sigma: the marginals' jitter)
//     alpha = rz[s] / max(p . hps, 1e-30)
//     r2 = r - alpha hps
//     done = (new_residual ? r2 . r2 : r . r) < tol
//     done: active[s] = 0, nothing written; else x += alpha p, r = r2
//   update B, per active system s:
//     rz2 = r . z;  beta = rz2 / max(rz[s], 1e-30)
//     p = z + beta p;  rz[s] = rz2
//
// A system that is not active is skipped: its state never changes once it
// froze, so its done test would give the same answer on every later
// iteration, and skipping it is exactly the plain loop's select.
//
// Every product, sum and quotient is one IEEE operation rounded to nearest
// (the __f*_rn / __d*_rn intrinsics: no contraction into FMAs), so that
// elementwise results equal the plain version's for the same scalars and
// the CPU tests can rehearse the kernels bit for bit. The dot products are
// summed in one fixed order: each thread its items in order of k, each
// warp's lanes by a shuffle tree (offsets 16, 8, 4, 2, 1), then the warps
// in order; a system split over G blocks sums the blocks' partials in
// order of g in a later launch. No atomics: a repeat is bit-identical and
// a system's result does not depend on the others.
//
// What bounds it on this card: bytes. Per element update A does about 8
// operations on 4 vectors read and 2 written, update B 4 on 3 read and 1
// written: 10 passes over a CG vector an iteration (the plain loop made
// ~38). At fleet_pcg's 2048 graphs of 1024 slots (25.2 MB a vector) that
// is 0.075 ms at 3.35 TB/s, at the star's 49,152 columns (604 MB) 1.8 ms.
//
// What the design does about it:
// * One block of 256 threads a system of L <= 3072 floats (the benchmark's
//   1024-slot graphs; ITEMS 8 for the 512-slot ones): the block holds its system's p, hp and r in
//   registers (ITEMS a thread, element k * 256 + thread, so that a warp's
//   loads are contiguous), reduces in shared memory, and writes x and r
//   once. Every load of a thread is issued before its first sum.
// * A longer system (a batch-1 graph of 65,536 poses) splits into chunks
//   of 3072 floats, one block each: update A in three launches (partials
//   of p.hps and r.r; alpha and the partials of r2.r2; the done test and
//   the commit, r2 recomputed), two where the test reads the old residual;
//   update B in three (partials of r.z; beta and p; rz). Every block of a
//   system sums the partials itself, in order of g, so all agree.
// * A frozen system's blocks read one byte and return.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitItems = 12;
constexpr int kChunk = kThreads * kSplitItems;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// torch.clamp(v, min=1e-30): NaN stays NaN
template <typename T>
__device__ __forceinline__ T floor30(T v) {
  const T lo = static_cast<T>(1e-30);
  return v < lo ? lo : v;
}

// The sum of each v[j] over the block in one fixed order (see the note at
// the top); every thread gets the totals. buf holds NV * kWarps values.
// The first barrier keeps a previous call's readers ahead of the writes.
template <typename T, int NV>
__device__ __forceinline__ void block_sum(T (&v)[NV], T* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[j] = add_rn(v[j], __shfl_down_sync(0xffffffffu, v[j], o));
  }
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) buf[j * kWarps + warp] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    T a = buf[j * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a = add_rn(a, buf[j * kWarps + w]);
    v[j] = a;
  }
}

// The sum of one system's G partials (stride apart) in order of g
template <typename T>
__device__ __forceinline__ T ordered_sum(const T* part, int G, int stride) {
  T a = part[0];
  for (int g = 1; g < G; ++g) a = add_rn(a, part[g * stride]);
  return a;
}

// Update A's loads over one chunk (elements lo + k * kThreads + thread
// below L): p, hps = hp + (sigma p) free, r; the thread's sums of p.hps and
// r.r in order of k. fr: the system's graph's free flags, or null (no
// jitter).
template <typename T, int ITEMS>
__device__ __forceinline__ void load_a(const T* __restrict__ p,
                                       const T* __restrict__ hp,
                                       const T* __restrict__ r,
                                       const unsigned char* __restrict__ fr,
                                       T sigma, long long off, int lo, int L,
                                       T (&pv)[ITEMS], T (&hv)[ITEMS],
                                       T (&rv)[ITEMS], T (&sums)[2]) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = lo + k * kThreads + threadIdx.x;
    const bool in = i < L;
    pv[k] = in ? p[off + i] : T(0);
    hv[k] = in ? hp[off + i] : T(0);
    rv[k] = in ? r[off + i] : T(0);
  }
  sums[0] = sums[1] = T(0);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = lo + k * kThreads + threadIdx.x;
    if (i < L) {
      if (fr != nullptr) {
        const T f = fr[i / 3] ? T(1) : T(0);
        hv[k] = add_rn(hv[k], mul_rn(mul_rn(sigma, pv[k]), f));
      }
      sums[0] = add_rn(sums[0], mul_rn(pv[k], hv[k]));
      sums[1] = add_rn(sums[1], mul_rn(rv[k], rv[k]));
    }
  }
}

// r2 = r - alpha hps over the chunk, in rv; returns the thread's r2.r2
template <typename T, int ITEMS>
__device__ __forceinline__ T step_r(T alpha, int lo, int L,
                                    const T (&hv)[ITEMS], T (&rv)[ITEMS]) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = lo + k * kThreads + threadIdx.x;
    if (i < L) {
      rv[k] = sub_rn(rv[k], mul_rn(alpha, hv[k]));
      acc = add_rn(acc, mul_rn(rv[k], rv[k]));
    }
  }
  return acc;
}

// x += alpha p and r = r2 over the chunk
template <typename T, int ITEMS>
__device__ __forceinline__ void commit(T* __restrict__ x, T* __restrict__ r,
                                       T alpha, long long off, int lo, int L,
                                       const T (&pv)[ITEMS],
                                       const T (&rv)[ITEMS]) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = lo + k * kThreads + threadIdx.x;
    if (i < L) {
      x[off + i] = add_rn(x[off + i], mul_rn(alpha, pv[k]));
      r[off + i] = rv[k];
    }
  }
}

// the free flags of system s's graph (C systems a graph), or null
__device__ __forceinline__ const unsigned char* graph_free(
    const unsigned char* is_free, int s, int C, int N) {
  return is_free == nullptr ? nullptr
                            : is_free + static_cast<long long>(s / C) * N;
}

// ---- one block a system ----------------------------------------------

template <typename T, int ITEMS>
__global__ void __launch_bounds__(kThreads)
update_a(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
         const T* __restrict__ hp, const T* __restrict__ rz,
         unsigned char* __restrict__ active,
         const unsigned char* __restrict__ is_free, T sigma, T tol, int L,
         int C, int N, int new_residual) {
  __shared__ T buf[2 * kWarps];
  const int s = blockIdx.x;
  if (!active[s]) return;
  const long long off = static_cast<long long>(s) * L;
  T pv[ITEMS], hv[ITEMS], rv[ITEMS], sums[2];
  load_a<T, ITEMS>(p, hp, r, graph_free(is_free, s, C, N), sigma, off,
                   0, L, pv, hv, rv, sums);
  block_sum<T, 2>(sums, buf);
  const T alpha = div_rn(rz[s], floor30(sums[0]));
  T rr2[1] = {step_r<T, ITEMS>(alpha, 0, L, hv, rv)};
  T test = sums[1];
  if (new_residual) {
    block_sum<T, 1>(rr2, buf);
    test = rr2[0];
  }
  if (test < tol) {
    if (threadIdx.x == 0) active[s] = 0;
    return;
  }
  commit<T, ITEMS>(x, r, alpha, off, 0, L, pv, rv);
}

template <typename T, int ITEMS>
__global__ void __launch_bounds__(kThreads)
update_b(const T* __restrict__ r, const T* __restrict__ z, T* __restrict__ p,
         T* __restrict__ rz, const unsigned char* __restrict__ active,
         int L) {
  __shared__ T buf[kWarps];
  const int s = blockIdx.x;
  if (!active[s]) return;
  const long long off = static_cast<long long>(s) * L;
  T rv[ITEMS], zv[ITEMS], pv[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const bool in = i < L;
    rv[k] = in ? r[off + i] : T(0);
    zv[k] = in ? z[off + i] : T(0);
    pv[k] = in ? p[off + i] : T(0);
  }
  T acc[1] = {T(0)};
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (k * kThreads + threadIdx.x < L)
      acc[0] = add_rn(acc[0], mul_rn(rv[k], zv[k]));
  const T rz_old = rz[s];  // read by every thread before block_sum's barriers
  block_sum<T, 1>(acc, buf);
  const T beta = div_rn(acc[0], floor30(rz_old));
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < L) p[off + i] = add_rn(zv[k], mul_rn(beta, pv[k]));
  }
  if (threadIdx.x == 0) rz[s] = acc[0];
}

// ---- a system split over G blocks of kChunk floats ---------------------
// part [S, G, 2]: p.hps, then r.r (old residual) or r2.r2; skip [S]: the
// system was frozen when update A began (written by A1 only, read by A2
// and A3, so that A3 may write active); partb [S, G]: r.z.

template <typename T>
__global__ void __launch_bounds__(kThreads)
split_a1(const T* __restrict__ p, const T* __restrict__ hp,
         const T* __restrict__ r, const unsigned char* __restrict__ active,
         const unsigned char* __restrict__ is_free, T sigma,
         T* __restrict__ part, unsigned char* __restrict__ skip, int L,
         int C, int N, int G) {
  __shared__ T buf[2 * kWarps];
  const int s = blockIdx.x / G, g = blockIdx.x - s * G;
  const bool act = active[s] != 0;
  if (g == 0 && threadIdx.x == 0) skip[s] = act ? 0 : 1;
  if (!act) return;
  const long long off = static_cast<long long>(s) * L;
  T pv[kSplitItems], hv[kSplitItems], rv[kSplitItems], sums[2];
  load_a<T, kSplitItems>(p, hp, r, graph_free(is_free, s, C, N), sigma,
                         off, g * kChunk, L, pv, hv, rv, sums);
  block_sum<T, 2>(sums, buf);
  if (threadIdx.x == 0) {
    part[(static_cast<long long>(s) * G + g) * 2] = sums[0];
    part[(static_cast<long long>(s) * G + g) * 2 + 1] = sums[1];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
split_a2(const T* __restrict__ p, const T* __restrict__ hp,
         const T* __restrict__ r, const T* __restrict__ rz,
         const unsigned char* __restrict__ skip,
         const unsigned char* __restrict__ is_free, T sigma,
         T* __restrict__ part, int L, int C, int N, int G) {
  __shared__ T buf[kWarps];
  const int s = blockIdx.x / G, g = blockIdx.x - s * G;
  if (skip[s]) return;
  const long long off = static_cast<long long>(s) * L;
  T* ps = part + static_cast<long long>(s) * G * 2;
  const T alpha = div_rn(rz[s], floor30(ordered_sum(ps, G, 2)));
  T pv[kSplitItems], hv[kSplitItems], rv[kSplitItems], sums[2];
  load_a<T, kSplitItems>(p, hp, r, graph_free(is_free, s, C, N), sigma,
                         off, g * kChunk, L, pv, hv, rv, sums);
  T rr2[1] = {step_r<T, kSplitItems>(alpha, g * kChunk, L, hv, rv)};
  block_sum<T, 1>(rr2, buf);
  if (threadIdx.x == 0) ps[g * 2 + 1] = rr2[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
split_a3(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
         const T* __restrict__ hp, const T* __restrict__ rz,
         unsigned char* __restrict__ active,
         const unsigned char* __restrict__ skip,
         const unsigned char* __restrict__ is_free, T sigma, T tol,
         const T* __restrict__ part, int L, int C, int N, int G) {
  const int s = blockIdx.x / G, g = blockIdx.x - s * G;
  if (skip[s]) return;
  const long long off = static_cast<long long>(s) * L;
  const T* ps = part + static_cast<long long>(s) * G * 2;
  const T alpha = div_rn(rz[s], floor30(ordered_sum(ps, G, 2)));
  const bool done = ordered_sum(ps + 1, G, 2) < tol;
  if (g == 0 && threadIdx.x == 0) active[s] = done ? 0 : 1;
  if (done) return;
  T pv[kSplitItems], hv[kSplitItems], rv[kSplitItems], sums[2];
  load_a<T, kSplitItems>(p, hp, r, graph_free(is_free, s, C, N), sigma,
                         off, g * kChunk, L, pv, hv, rv, sums);
  step_r<T, kSplitItems>(alpha, g * kChunk, L, hv, rv);
  commit<T, kSplitItems>(x, r, alpha, off, g * kChunk, L, pv, rv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
split_b1(const T* __restrict__ r, const T* __restrict__ z,
         const unsigned char* __restrict__ active, T* __restrict__ partb,
         int L, int G) {
  __shared__ T buf[kWarps];
  const int s = blockIdx.x / G, g = blockIdx.x - s * G;
  if (!active[s]) return;
  const long long off = static_cast<long long>(s) * L;
  T rv[kSplitItems], zv[kSplitItems];
#pragma unroll
  for (int k = 0; k < kSplitItems; ++k) {
    const int i = g * kChunk + k * kThreads + threadIdx.x;
    const bool in = i < L;
    rv[k] = in ? r[off + i] : T(0);
    zv[k] = in ? z[off + i] : T(0);
  }
  T acc[1] = {T(0)};
#pragma unroll
  for (int k = 0; k < kSplitItems; ++k)
    if (g * kChunk + k * kThreads + threadIdx.x < L)
      acc[0] = add_rn(acc[0], mul_rn(rv[k], zv[k]));
  block_sum<T, 1>(acc, buf);
  if (threadIdx.x == 0) partb[static_cast<long long>(s) * G + g] = acc[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
split_b2(const T* __restrict__ z, T* __restrict__ p, const T* __restrict__ rz,
         const unsigned char* __restrict__ active,
         const T* __restrict__ partb, int L, int G) {
  const int s = blockIdx.x / G, g = blockIdx.x - s * G;
  if (!active[s]) return;
  const long long off = static_cast<long long>(s) * L;
  const T beta = div_rn(ordered_sum(partb + static_cast<long long>(s) * G,
                                    G, 1),
                        floor30(rz[s]));
#pragma unroll
  for (int k = 0; k < kSplitItems; ++k) {
    const int i = g * kChunk + k * kThreads + threadIdx.x;
    if (i < L) p[off + i] = add_rn(z[off + i], mul_rn(beta, p[off + i]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
split_b3(T* __restrict__ rz, const unsigned char* __restrict__ active,
         const T* __restrict__ partb, int S, int G) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s < S && active[s])
    rz[s] = ordered_sum(partb + static_cast<long long>(s) * G, G, 1);
}

template <typename T, int ITEMS>
void launch_a1(T* x, T* r, const T* p, const T* hp, const T* rz,
               unsigned char* active, const unsigned char* is_free, T sigma,
               T tol, int S, int L, int C, int N, int new_residual,
               cudaStream_t st) {
  update_a<T, ITEMS><<<S, kThreads, 0, st>>>(x, r, p, hp, rz, active,
                                             is_free, sigma, tol, L, C, N,
                                             new_residual);
}

template <typename T, int ITEMS>
void launch_b1(const T* r, const T* z, T* p, T* rz,
               const unsigned char* active, int S, int L, cudaStream_t st) {
  update_b<T, ITEMS><<<S, kThreads, 0, st>>>(r, z, p, rz, active, L);
}

template <typename T>
int launch_a(T* x, T* r, const T* p, const T* hp, const T* rz,
             unsigned char* active, const unsigned char* is_free, T* part,
             unsigned char* skip, double sigma, double tol, int S, int L,
             int C, int N, int new_residual, int items, int G,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T sg = static_cast<T>(sigma), tl = static_cast<T>(tol);
  if (G == 1) {
    switch (items) {
      case 8: launch_a1<T, 8>(x, r, p, hp, rz, active, is_free, sg, tl, S, L,
                              C, N, new_residual, st); break;
      case 12: launch_a1<T, 12>(x, r, p, hp, rz, active, is_free, sg, tl, S,
                                L, C, N, new_residual, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int blocks = S * G;
  split_a1<T><<<blocks, kThreads, 0, st>>>(p, hp, r, active, is_free, sg,
                                           part, skip, L, C, N, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (new_residual) {
    split_a2<T><<<blocks, kThreads, 0, st>>>(p, hp, r, rz, skip, is_free, sg,
                                             part, L, C, N, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  split_a3<T><<<blocks, kThreads, 0, st>>>(x, r, p, hp, rz, active, skip,
                                           is_free, sg, tl, part, L, C, N,
                                           G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_b(const T* r, const T* z, T* p, T* rz, const unsigned char* active,
             T* partb, int S, int L, int items, int G, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G == 1) {
    switch (items) {
      case 8: launch_b1<T, 8>(r, z, p, rz, active, S, L, st); break;
      case 12: launch_b1<T, 12>(r, z, p, rz, active, S, L, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int blocks = S * G;
  split_b1<T><<<blocks, kThreads, 0, st>>>(r, z, active, partb, L, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_b2<T><<<blocks, kThreads, 0, st>>>(z, p, rz, active, partb, L, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_b3<T><<<(S + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      rz, active, partb, S, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch update A or B on `stream` (a cudaStream_t passed as void*). All
// vectors [S, L] contiguous (x, r, p, hp, z), rz [S], active [S] u8 (the
// CG loop's bool flags), is_free [S / C, N] u8 or null (no jitter); items
// 8 or 12 with L <= 256 * items when G == 1; otherwise items 12 and
// G = ceil(L / 3072) blocks a system, with the scratch part [S, G,
// 2] and skip [S] (update A) or partb [S, G] (update B). S * G below
// 2^31 (the wrapper checks). Each returns the cudaError_t of its launches
// (0 on success).
extern "C" int cg_update_a_f32(float* x, float* r, const float* p,
                               const float* hp, const float* rz,
                               unsigned char* active,
                               const unsigned char* is_free, float* part,
                               unsigned char* skip, double sigma, double tol,
                               int S, int L, int C, int N, int new_residual,
                               int items, int G, void* stream) {
  return launch_a<float>(x, r, p, hp, rz, active, is_free, part, skip, sigma,
                         tol, S, L, C, N, new_residual, items, G, stream);
}

extern "C" int cg_update_a_f64(double* x, double* r, const double* p,
                               const double* hp, const double* rz,
                               unsigned char* active,
                               const unsigned char* is_free, double* part,
                               unsigned char* skip, double sigma, double tol,
                               int S, int L, int C, int N, int new_residual,
                               int items, int G, void* stream) {
  return launch_a<double>(x, r, p, hp, rz, active, is_free, part, skip,
                          sigma, tol, S, L, C, N, new_residual, items, G,
                          stream);
}

extern "C" int cg_update_b_f32(const float* r, const float* z, float* p,
                               float* rz, const unsigned char* active,
                               float* partb, int S, int L, int items, int G,
                               void* stream) {
  return launch_b<float>(r, z, p, rz, active, partb, S, L, items, G, stream);
}

extern "C" int cg_update_b_f64(const double* r, const double* z, double* p,
                               double* rz, const unsigned char* active,
                               double* partb, int S, int L, int items, int G,
                               void* stream) {
  return launch_b<double>(r, z, p, rz, active, partb, S, L, items, G,
                          stream);
}

// The PCG band's Hessian-vector product for NVIDIA Hopper, sm_90a: a pair
// of kernels, one pass over the edges and one over the vertices.
//
// Replaces no Pallas kernel: the JAX package leaves the product to XLA
// (cg_mrslam_tpu/solver/pcg.py, _hvp, gathers and a scatter-add). In the
// port its plain PyTorch form (solver/pcg.py, _hvp_plain) is a handful of
// gathers, batched 3 x 3 products and a fixed-order sum through the
// solve's segment table; on the card each CG iteration of every PCG solve
// spends most of its time there. For a batch of B graphs, C columns, N
// vertex slots and E edge slots it computes
//
//   y[b, c, n] = free[b, n] * sum over n's edge ends (e, end) of
//                J_end(b, e)^T w[b, c, e],
//   w[b, c, e] = Omega(b, e) (J_i(b, e) x[b, c, vi] + J_j(b, e) x[b, c, vj])
//
// in that association (J^T (Omega (J x))), in the order the segment table
// fixes: row b * N + n of the compressed rows (offsets, entries) lists the
// contributions k of that vertex, where k < B * E is the i end of edge
// k (flattened over the batch, b * E + e) and B * E + k' the j end of edge
// k'. No atomics: each sum is one thread's, in that order, so a repeat is
// bit-identical and a graph's result does not depend on its batch-mates.
//
// What bounds it on this card: bytes. Per (edge, column) it does about 90
// float operations on 108 bytes of J_i, J_j and Omega; per (vertex,
// column) a few adds. The function's least traffic is every input read
// once (the three 3 x 3 blocks, the edges' ends, x, the compressed rows,
// free) and y written once: about 0.29 GB at the benchmark's 2048 graphs
// of 1024 slots, 0.086 ms at 3.35 TB/s. This design's split into two
// passes adds its intermediate (one 3-vector per edge end, written and
// the listed ones read back once): 0.087 GB more, 0.026 ms. The form it
// replaced read a [B*N, width, 3, 3] gather of the Jacobians (width 16,
// most of it zero padding: 1.2 GB) on every call.
//
// What the design does about it:
// * The edge pass reads each edge's blocks once for all its columns
//   (thread = (b, e, c), c fastest, so a warp's threads of one edge share
//   the loads) and writes each end's 3-vector once; the vertex pass reads
//   only the listed entries of the compressed rows (a vertex's degree, 2
//   on average, not the table's width) and writes y once. Nothing is
//   padded and nothing is gathered twice.
// * Neighbouring threads take neighbouring edges and vertices, so the
//   blocks' loads, the intermediate's writes and y's writes are
//   contiguous across a warp; x and the intermediate are gathered through
//   L2 (the graphs' chain order puts most ends next to each other).
// * A grid-stride loop of 256-thread blocks; no shared memory, no
//   synchronization, no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

int blocks_for(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

// x[b, c, v, :] at the vertex and component strides sn, sk (zeros for an
// index outside the graph's N slots)
template <typename T>
__device__ __forceinline__ void load3(const T* __restrict__ xbc, int v, int N,
                                      long long sn, long long sk, T* out) {
  if (static_cast<unsigned>(v) < static_cast<unsigned>(N)) {
    const T* p = xbc + v * sn;
    out[0] = p[0];
    out[1] = p[sk];
    out[2] = p[2 * sk];
  } else {
    out[0] = out[1] = out[2] = T(0);
  }
}

// M v for a row-major 3 x 3 M
template <typename T>
__device__ __forceinline__ void mv(const T* __restrict__ M, const T* v,
                                   T* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    out[r] = M[3 * r] * v[0] + M[3 * r + 1] * v[1] + M[3 * r + 2] * v[2];
}

// M^T v for a row-major 3 x 3 M
template <typename T>
__device__ __forceinline__ void mtv(const T* __restrict__ M, const T* v,
                                    T* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    out[r] = M[r] * v[0] + M[3 + r] * v[1] + M[6 + r] * v[2];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hvp_edges(const int* __restrict__ e_ij, const T* __restrict__ Ji,
          const T* __restrict__ Jj, const T* __restrict__ omega,
          const T* __restrict__ x, T* __restrict__ contrib, int B, int C,
          int N, int E, int sb, int se, int sk, long long xb, long long xc,
          long long xn, long long xk) {
  const int total = B * E * C;
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < total;
       t += gridDim.x * kThreads) {
    const int c = t % C;
    const int be = t / C;            // b * E + e
    const int b = be / E;
    const T* xbc = x + b * xb + c * xc;
    const int* ends = e_ij + static_cast<long long>(b) * sb
                      + static_cast<long long>(be - b * E) * se;
    T xi[3], xj[3], u[3], uj[3], w[3], yi[3], yj[3];
    load3(xbc, ends[0], N, xn, xk, xi);
    load3(xbc, ends[sk], N, xn, xk, xj);
    const long long m = static_cast<long long>(be) * 9;
    mv(Ji + m, xi, u);
    mv(Jj + m, xj, uj);
#pragma unroll
    for (int r = 0; r < 3; ++r) u[r] += uj[r];
    mv(omega + m, u, w);
    mtv(Ji + m, w, yi);
    mtv(Jj + m, w, yj);
    T* ci = contrib + (static_cast<long long>(be) * C + c) * 3;
    T* cj = contrib + ((static_cast<long long>(B) * E + be) * C + c) * 3;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      ci[r] = yi[r];
      cj[r] = yj[r];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hvp_vertices(const T* __restrict__ contrib, const int* __restrict__ entries,
             const int* __restrict__ offsets,
             const unsigned char* __restrict__ is_free, T* __restrict__ y,
             int B, int C, int N) {
  const int total = B * C * N;
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < total;
       t += gridDim.x * kThreads) {
    const int n = t % N;
    const int bc = t / N;            // b * C + c
    const int c = bc % C;
    const int row = (bc / C) * N + n;
    T a0 = T(0), a1 = T(0), a2 = T(0);
    const int end = offsets[row + 1];
    for (int p = offsets[row]; p < end; ++p) {
      const T* v = contrib + (static_cast<long long>(entries[p]) * C + c) * 3;
      a0 += v[0];
      a1 += v[1];
      a2 += v[2];
    }
    const T f = is_free[row] ? T(1) : T(0);
    T* out = y + static_cast<long long>(t) * 3;
    out[0] = a0 * f;
    out[1] = a1 * f;
    out[2] = a2 * f;
  }
}

template <typename T>
int launch(const int* e_ij, const T* Ji, const T* Jj, const T* omega,
           const int* entries, const int* offsets,
           const unsigned char* is_free, const T* x, T* contrib, T* y,
           int B, int C, int N, int E, int sb, int se, int sk, long long xb,
           long long xc, long long xn, long long xk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hvp_edges<T><<<blocks_for(static_cast<long long>(B) * E * C), kThreads, 0,
                 s>>>(e_ij, Ji, Jj, omega, x, contrib, B, C, N, E, sb, se,
                      sk, xb, xc, xn, xk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hvp_vertices<T><<<blocks_for(static_cast<long long>(B) * C * N), kThreads,
                    0, s>>>(contrib, entries, offsets, is_free, y, B, C, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch both passes on `stream` (a cudaStream_t passed as void*). Shapes:
// e_ij [B, E, 2] i32 at element strides (sb, se, sk) (the batch builders
// and the slot permutation leave it strided); x [B, C, N, 3] at element
// strides (xb, xc, xn, xk) (a caller's column view may be strided); the
// rest contiguous: Ji, Jj, omega [B, E, 3, 3];
// entries [2 * B * E] i32; offsets [B * N + 1] i32; is_free [B, N] u8; y
// [B, C, N, 3]; contrib [2 * B * E, C, 3] (scratch). B * E * C, B * C * N and 2 * B * E below 2^30 (the wrapper
// checks). Each returns the cudaError_t of the launches (0 on success).
extern "C" int cg_pcg_hvp_f32(const int* e_ij, const float* Ji,
                              const float* Jj, const float* omega,
                              const int* entries, const int* offsets,
                              const unsigned char* is_free, const float* x,
                              float* contrib, float* y, int B, int C, int N,
                              int E, int sb, int se, int sk, long long xb,
                              long long xc, long long xn, long long xk,
                              void* stream) {
  return launch<float>(e_ij, Ji, Jj, omega, entries, offsets, is_free, x,
                       contrib, y, B, C, N, E, sb, se, sk, xb, xc, xn, xk,
                       stream);
}

extern "C" int cg_pcg_hvp_f64(const int* e_ij, const double* Ji,
                              const double* Jj, const double* omega,
                              const int* entries, const int* offsets,
                              const unsigned char* is_free, const double* x,
                              double* contrib, double* y, int B, int C, int N,
                              int E, int sb, int se, int sk, long long xb,
                              long long xc, long long xn, long long xk,
                              void* stream) {
  return launch<double>(e_ij, Ji, Jj, omega, entries, offsets, is_free, x,
                        contrib, y, B, C, N, E, sb, se, sk, xb, xc, xn, xk,
                        stream);
}

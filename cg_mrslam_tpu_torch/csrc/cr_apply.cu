// The chain-tridiagonal preconditioner's cyclic-reduction solve for NVIDIA
// Hopper, sm_90a: one kernel, one launch per solve.
//
// Replaces no Pallas kernel: the JAX package leaves the solve to XLA
// (cg_mrslam_tpu/solver/chain.py, _cr_apply, batched dense products of
// the 48 x 48 super-blocks). The port's PCG band solves T z = r once per
// CG iteration (the preconditioner of solver/pcg.py, and the chain band's
// Woodbury solve in solver/chain.py). T is block-tridiagonal over
// super-blocks of 16 poses (48 rows), padded to m super-blocks, m a power
// of two; its factor (solver/chain.py, _cr_factor) eliminates the odd
// super-blocks level by level. The factor arrives compact
// (ops/cr_apply.py, layout): per level and pair t the dense inverse
// D^-1 (48 x 48), rows 0:3 of A and rows 45:48 of B (3 x 48 each), the
// 3 x 3 corners of the couplings Le and Lo (rows 0:3, columns 45:48), and
// the root inverse. Everything else of the dense levels is exactly zero.
// For graph b and column c of r [B, C, N, 3] (any strides):
//
//   forward, level l (stride s = 2^l, pairs t < P = m / 2^(l+1)), on the
//   super-blocks e = 2t s (even) and o = (2t+1) s (odd):
//     v[e][0:3]   -= A_t[0:3]   . v[(2t-1) s]      (t > 0)
//     v[e][45:48] -= B_t[45:48] . v[o]
//   root: v[0] = R^-1 v[0]
//   back, level l from the coarsest down:
//     v[o][0:3]   -= Le_t  v[o - s][45:48]
//     v[o][45:48] -= Lo_t^T v[o + s][0:3]         (o + s < m)
//     v[o] = D^-1_t v[o]
//
// with the rows of frozen vertices (free[b, pose] false) zero on read and
// on write, and poses beyond N read as zero and never written. Every sum
// runs in one fixed order (the dot products over the 48 columns in order,
// the corners' three terms in order): no atomics, a repeat is bit-equal,
// and a graph's result does not depend on its batch-mates.
//
// What bounds it on this card: bytes. At the benchmark's 2048 graphs of
// 1024 poses (m = 64, one column) the factor is 667 KB a graph, 1.37 GB a
// solve, 0.41 ms at 3.35 TB/s; the vectors add 25 MB. The dense form it
// replaced read 2.9 MB a graph through batched gemvs and copies. At 384
// columns (the exchange's marginals) the dense products, 2 x 48 x 48 per
// odd super-block and column, are 14.5 GFLOP for 128 graphs, 0.22 ms at
// 67 TFLOP/s, beside 1.2 GB of vectors in and out.
//
// What the design does about it:
// * One block per (graph, tile of CT columns, CT 1 or 2: a wider tile
//   takes more registers and shared memory than its shared factor reads
//   save, ops/cr_apply.py, plan); the tiles of a graph have
//   neighbouring block indices, so they run together and share its factor
//   through L2. The block keeps its columns' m super-blocks in shared
//   memory (each padded to 49 rows, so that the super-blocks of
//   neighbouring pairs sit in other banks) and walks every level there,
//   with a __syncthreads between phases: the factor is read once per
//   block, the vectors once in and once out.
// * Each D^-1 product gives a thread four rows of one pair for all CT
//   columns: per column j of D^-1 one 16-byte load, neighbouring threads on
//   neighbouring rows (the layout stores D^-1 column-major over the level's
//   pairs), so the loads are coalesced; CT columns share each load. The
//   loads are issued eight columns of D^-1 at a time ahead of their
//   products, so a thread keeps eight in flight. The back-substitution's
//   corner terms are computed by each thread for its own pair (six short
//   sums a column), inside the same phase.
// * The forward rows of A and B are read the same way, one entry per
//   thread and step, eight steps ahead; r's columns come in four entries
//   a thread at a time (one H100, the star's shapes: 3.50 ms a solve
//   against 3.88 one at a time, whose mask gated its value's load).
// * A level's results above level 0 stay in registers until a barrier,
//   then replace the super-blocks they solve (the threads of one barrier
//   interval hold whole pairs: the block has a multiple of 12 threads);
//   level 0's results, and the even super-blocks, go straight to z in the
//   caller's layout.
// * A graph too long for one column's buffer in shared memory (m of 2048
//   and more in float32, 32,768 poses) keeps the buffer in device memory,
//   allocated by the wrapper: the same walk, through L2.
// * The shared-memory ceiling is raised once when the library loads
//   (cg_cr_apply_init), never at a launch, so a captured CUDA graph
//   replays the launch as it is.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 48;           // a super-block: 16 poses x 3
constexpr int kPitch = 49;          // its rows' pitch in the block's buffer
constexpr int kQuads = kRows / 4;   // a thread's four rows of a D^-1 product
constexpr int kAhead = 8;           // factor loads a thread keeps in flight
constexpr int kLoads = 4;           // r's loads a thread keeps in flight
constexpr int kMaxThreads = 384;    // a multiple of kQuads

// a graph's packed factor (ops/cr_apply.py, layout): level l's sections
// at P = m >> (l + 1) pairs
__device__ __forceinline__ long long doi_at(int m, int P) {
  return static_cast<long long>(kRows) * kRows * (m - 2 * P);
}
__device__ __forceinline__ long long root_at(int m) {
  return static_cast<long long>(kRows) * kRows * (m - 1);
}
__device__ __forceinline__ long long ab_at(int m, int P) {
  return static_cast<long long>(kRows) * kRows * m
         + 6LL * kRows * (m - 2 * P);
}
__device__ __forceinline__ long long corner_at(int m, int P) {
  return static_cast<long long>(kRows) * kRows * m + 6LL * kRows * (m - 1)
         + 18LL * (m - 2 * P);
}

__device__ __forceinline__ float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return fma(a, b, c);
}

__device__ __forceinline__ void load4(const float* p, float* a) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  a[0] = q.x;
  a[1] = q.y;
  a[2] = q.z;
  a[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double* a) {
  const double2 q0 = __ldg(reinterpret_cast<const double2*>(p));
  const double2 q1 = __ldg(reinterpret_cast<const double2*>(p) + 1);
  a[0] = q0.x;
  a[1] = q0.y;
  a[2] = q1.x;
  a[3] = q1.y;
}

// The solved rows of a D^-1 product (or the root's): acc[i][c] = sum over
// j of M[j][i] x_c[j] for the four rows i of a column-major 48 x 48 block
// M (column j at M + j * ld) and the super-block x_c of each of the CT
// columns (column c at x + c * xs, rows at pitch 1). x_c's rows 0:3 and
// 45:48 are taken from top[c] and bottom[c] when `corners` is set: the
// super-block less its coupling terms, which the caller computed.
template <typename T, int CT>
__device__ __forceinline__ void product4(const T* __restrict__ M,
                                         long long ld, const T* x, int xs,
                                         bool corners, const T (&top)[CT][3],
                                         const T (&bottom)[CT][3],
                                         T (&acc)[4][CT]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = T(0);
#pragma unroll
  for (int j0 = 0; j0 < kRows; j0 += kAhead) {
    T a[kAhead][4];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) load4(M + (j0 + u) * ld, a[u]);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        T xj = x[c * xs + j];
        if (corners && j < 3) xj = top[c][j];
        if (corners && j >= kRows - 3) xj = bottom[c][j - (kRows - 3)];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = madd(a[u][i], xj, acc[i][c]);
      }
    }
  }
}

template <typename T, int CT>
__global__ void __launch_bounds__(kMaxThreads)
cr_apply(const T* __restrict__ fac, long long F, const T* __restrict__ r,
         const unsigned char* __restrict__ is_free, T* __restrict__ z,
         T* __restrict__ scratch, int C, int N, int m, int tiles,
         long long rb, long long rc, long long rn, long long rk,
         long long zb, long long zc, long long zn, long long zk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - b * tiles) * CT;
  const int vlen = m * kPitch;                       // a column's buffer
  T* v = scratch != nullptr
             ? scratch + static_cast<long long>(blockIdx.x) * vlen * CT
             : reinterpret_cast<T*>(smem);
  const T* f = fac + b * F;
  const unsigned char* fr =
      is_free != nullptr ? is_free + static_cast<long long>(b) * N : nullptr;
  const int tid = threadIdx.x, nt = blockDim.x;
  int levels = 0;
  while ((1 << levels) < m) ++levels;

  // z at row q (pose q / 3, component q % 3) of column c0 + c
  auto put = [&](int c, int q, T val) {
    const int pose = q / 3;
    if (c0 + c < C && pose < N)
      z[b * zb + (c0 + c) * zc + pose * zn + (q - 3 * pose) * zk] =
          (fr == nullptr || fr[pose]) ? val : T(0);
  };

  // r's columns, masked, into the buffer: v[c][p * 49 + row] holds pose
  // p * 16 + row / 3, component row % 3. Four entries a thread in flight,
  // each value read beside its mask (not after it)
  const int total = m * kRows * CT;
  for (int i0 = tid; i0 < total; i0 += kLoads * nt) {
    T val[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * nt;
      const int c = i / (m * kRows), q = i - c * m * kRows;
      const int pose = q / 3;
      const bool in = i < total && c0 + c < C && pose < N;
      val[u] = in ? r[b * rb + (c0 + c) * rc + pose * rn + (q - 3 * pose) * rk]
                  : T(0);
      if (in && fr != nullptr && !fr[pose]) val[u] = T(0);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * nt;
      const int c = i / (m * kRows), q = i - c * m * kRows;
      if (i < total) v[c * vlen + q / kRows * kPitch + q % kRows] = val[u];
    }
  }
  __syncthreads();

  for (int l = 0; l < levels; ++l) {
    const int s = 1 << l, P = m >> (l + 1);
    const T* ab = f + ab_at(m, P);                 // [48 j][P * 6]
    for (int it = tid; it < 6 * P; it += nt) {
      const int t = it / 6, k = it - 6 * t;
      if (k < 3 && t == 0) continue;               // A_0 = 0: no odd before
      const int src = (k < 3 ? 2 * t - 1 : 2 * t + 1) * s * kPitch;
      const int dst = 2 * t * s * kPitch + (k < 3 ? k : kRows - 6 + k);
      T acc[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[c] = T(0);
#pragma unroll
      for (int j0 = 0; j0 < kRows; j0 += kAhead) {
        T a[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          a[u] = __ldg(ab + (j0 + u) * 6 * P + it);
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
#pragma unroll
          for (int c = 0; c < CT; ++c)
            acc[c] = madd(a[u], v[c * vlen + src + j0 + u], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) v[c * vlen + dst] -= acc[c];
    }
    __syncthreads();
  }

  T top[CT][3], bottom[CT][3], acc[4][CT];
  // the root: R^-1 v[0], held until every thread has read v[0]
  if (tid < kQuads)
    product4<T, CT>(f + root_at(m) + 4 * tid, kRows, v, vlen, false, top,
                    bottom, acc);
  __syncthreads();
  if (tid < kQuads)
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[c * vlen + 4 * tid + i] = acc[i][c];
  __syncthreads();

  for (int l = levels - 1; l >= 0; --l) {
    const int s = 1 << l, P = m >> (l + 1);
    const T* cn = f + corner_at(m, P);             // [P][2][3][3]
    const T* D = f + doi_at(m, P);                 // [48 j][P * 48]
    // whole pairs per barrier interval (nt is a multiple of 12)
    for (int base = 0; base < kQuads * P; base += nt) {
      const int it = base + tid;
      const bool live = it < kQuads * P;
      const int t = it / kQuads, r0 = 4 * (it - kQuads * t);
      const int o = (2 * t + 1) * s;
      if (live) {
        // the odd super-block less Le v[o - s] (rows 0:3) and
        // Lo^T v[o + s] (rows 45:48), per column
        const T* le = cn + 18 * t;                 // row-major 3 x 3
        const T* lo = le + 9;
        const bool next = o + s < m;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const T* xo = v + c * vlen + o * kPitch;
          const T* xp = v + c * vlen + (o - s) * kPitch + kRows - 3;
          const T* xn = v + c * vlen + (o + s) * kPitch;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            T e = le[3 * k] * xp[0];
            e = madd(le[3 * k + 1], xp[1], e);
            e = madd(le[3 * k + 2], xp[2], e);
            top[c][k] = xo[k] - e;
            bottom[c][k] = xo[kRows - 3 + k];
            if (next) {
              T u = lo[k] * xn[0];
              u = madd(lo[3 + k], xn[1], u);
              u = madd(lo[6 + k], xn[2], u);
              bottom[c][k] -= u;
            }
          }
        }
        product4<T, CT>(D + t * kRows + r0, static_cast<long long>(P) * kRows,
                        v + o * kPitch, vlen, true, top, bottom, acc);
        if (l == 0)
#pragma unroll
          for (int c = 0; c < CT; ++c)
#pragma unroll
            for (int i = 0; i < 4; ++i) put(c, o * kRows + r0 + i, acc[i][c]);
      }
      if (l > 0) {
        __syncthreads();
        if (live)
#pragma unroll
          for (int c = 0; c < CT; ++c)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[c * vlen + o * kPitch + r0 + i] = acc[i][c];
        __syncthreads();
      }
    }
  }

  // the even super-blocks of level 0 (the root alone when m is 1)
  const int len = (m + 1) / 2 * kRows;
  for (int i = tid; i < len * CT; i += nt) {
    const int c = i / len, q = i - c * len;
    const int t = q / kRows, row = q - t * kRows;
    put(c, 2 * t * kRows + row, v[c * vlen + 2 * t * kPitch + row]);
  }
}

template <typename T, int CT>
int launch_tile(const T* fac, long long F, const T* r,
                const unsigned char* is_free, T* z, T* scratch, int B, int C,
                int N, int m, int threads, int smem, long long rb,
                long long rc, long long rn, long long rk, long long zb,
                long long zc, long long zn, long long zk, void* stream) {
  const int tiles = (C + CT - 1) / CT;
  cr_apply<T, CT><<<B * tiles, threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      fac, F, r, is_free, z, scratch, C, N, m, tiles, rb, rc, rn, rk, zb, zc,
      zn, zk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* fac, const T* r, const unsigned char* is_free, T* z,
           T* scratch, long long F, int B, int C, int N, int m, int tile,
           int threads, int smem, long long rb, long long rc, long long rn,
           long long rk, long long zb, long long zc, long long zn,
           long long zk, void* stream) {
  switch (tile) {
    case 1:
      return launch_tile<T, 1>(fac, F, r, is_free, z, scratch, B, C, N, m,
                               threads, smem, rb, rc, rn, rk, zb, zc, zn, zk,
                               stream);
    case 2:
      return launch_tile<T, 2>(fac, F, r, is_free, z, scratch, B, C, N, m,
                               threads, smem, rb, rc, rn, rk, zb, zc, zn, zk,
                               stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int CT>
cudaError_t raise_smem(int bytes) {
  return cudaFuncSetAttribute(cr_apply<T, CT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// Raise every instance's dynamic shared memory ceiling to the device's
// opt-in maximum, once, when the library loads; *limit receives it.
// Returns the cudaError_t (0 on success).
extern "C" int cg_cr_apply_init(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaError_t raised[] = {
      raise_smem<float, 1>(*limit), raise_smem<float, 2>(*limit),
      raise_smem<double, 1>(*limit), raise_smem<double, 2>(*limit)};
  for (cudaError_t e : raised)
    if (err == cudaSuccess) err = e;
  return static_cast<int>(err);
}

// Launch the solve on `stream` (a cudaStream_t passed as void*): fac
// [B, F] (the packed factor, 16-byte aligned, F a multiple of 4), r
// [B, C, N, 3] at element strides (rb, rc, rn, rk), is_free [B, N] u8 or
// null, z [B, C, N, 3] at strides (zb, zc, zn, zk), scratch null or
// B * ceil(C / tile) * m * 49 * tile elements (the blocks' buffers when
// smem is 0); tile 1 or 2; m a power of
// two; B * ceil(C / tile) and the buffer's elements below 2^31 (the
// wrapper checks). Each returns the cudaError_t of the launch.
extern "C" int cg_cr_apply_f32(const float* fac, const float* r,
                               const unsigned char* is_free, float* z,
                               float* scratch, long long F, int B, int C,
                               int N, int m, int tile, int threads, int smem,
                               long long rb, long long rc, long long rn,
                               long long rk, long long zb, long long zc,
                               long long zn, long long zk, void* stream) {
  return launch<float>(fac, r, is_free, z, scratch, F, B, C, N, m, tile,
                       threads, smem, rb, rc, rn, rk, zb, zc, zn, zk, stream);
}

extern "C" int cg_cr_apply_f64(const double* fac, const double* r,
                               const unsigned char* is_free, double* z,
                               double* scratch, long long F, int B, int C,
                               int N, int m, int tile, int threads, int smem,
                               long long rb, long long rc, long long rn,
                               long long rk, long long zb, long long zc,
                               long long zn, long long zk, void* stream) {
  return launch<double>(fac, r, is_free, z, scratch, F, B, C, N, m, tile,
                        threads, smem, rb, rc, rn, rk, zb, zc, zn, zk, stream);
}

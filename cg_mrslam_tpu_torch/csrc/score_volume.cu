// Correlative scan-match score volumes (kernels K1 and K2) for NVIDIA
// Hopper, sm_90a.
//
// Replaces the TPU Pallas kernels of cg_mrslam_tpu/ops/correlate.py:
//   K1  pallas_score_volume          (contiguous +-ry x +-rx lattice)
//   K2  pallas_score_volume_strided  (symmetric lattice of stride sy, sx)
// both reached through _pallas_volume with the body _make_kernel_v3.
// Computes, for a batch of (grid, base) pairs b and rotations t,
//
//   out[b, t, i, j] = sum_p keep[b,t,p] * G_b(iy[b,t,p] + (i - ny) * sy,
//                                            ix[b,t,p] + (j - nx) * sx)
//                     / count[b, t]
//
// where G_b is grid gidx[b] and a cell outside the C x C grid reads 0 (it
// still counts: count[] is computed by the caller together with the cell
// indices and the keep mask, by the same torch code the plain version
// uses, so kernel and plain version see identical integer cells and
// differ only in summation order). K1 is the case sy = sx = 1.
//
// What bounds it on this card: every (b, t, point, offset) is one gathered
// 4-byte load, T*Dy*Dx*P per volume (about 14.6M for the close match at
// 65 x 25 x 25 x 360) — random-access loads served from L2, since a close
// grid (1200^2 floats, 5.8 MB) or a keyframe's four LC grids (700^2 floats,
// 2 MB each) fit the 50 MB L2 many times over. The bytes a volume must
// move (grid read once, volume written once) take microseconds; the
// gathers are the cost.
//
// What the design does about it: one block per (b, t) stages that
// rotation's cells in shared memory once (8 bytes a point), then one
// thread per (i, j) offset walks the points, so the 32 threads of a warp
// read 32 neighbouring offsets of one lattice row. K2 computes only the
// kept offsets of its strided lattice: the TPU kernel accumulated the full
// contiguous span and sliced it (its tile fetch covered the span either
// way), which here would cost sy * sx times the gathers. With a stride
// a warp's loads spread over sx times as many sectors. No padded tiles,
// phase planes or transposes: those were TPU layout choices. A point that
// is not kept is staged with a cell far outside the grid, so it adds 0
// without a branch of its own. Summing a point's contribution for all
// offsets at once from a shared-memory tile of the grid (and tensor-core
// formulations) is later work.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kSkip = INT_MIN / 2;  // staged cell of a dropped point

__global__ void score_volume_kernel(const float* __restrict__ grids,
                                    const int* __restrict__ gidx,
                                    const int* __restrict__ ix,
                                    const int* __restrict__ iy,
                                    const unsigned char* __restrict__ keep,
                                    const float* __restrict__ count,
                                    float* __restrict__ out, int n_grids,
                                    int T, int P, int C, int ny, int nx,
                                    int sy, int sx) {
  extern __shared__ int staged[];  // [2 * P]: (iy, ix) per point
  int* cy = staged;
  int* cx = staged + P;

  const int bt = blockIdx.x;  // b * T + t
  const int b = bt / T;
  const int dx = 2 * nx + 1;
  const int n_off = (2 * ny + 1) * dx;
  float* vol = out + static_cast<size_t>(bt) * n_off;

  const int g = gidx[b];
  if (g < 0 || g >= n_grids) {  // bad grid index: poison the volume
    for (int o = threadIdx.x; o < n_off; o += blockDim.x) {
      vol[o] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const float* grid = grids + static_cast<size_t>(g) * C * C;

  const size_t base = static_cast<size_t>(bt) * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const bool k = keep[base + p] != 0;
    cy[p] = k ? iy[base + p] : kSkip;
    cx[p] = k ? ix[base + p] : kSkip;
  }
  __syncthreads();

  const float n_kept = count[bt];
  for (int o = threadIdx.x; o < n_off; o += blockDim.x) {
    const int ty = (o / dx - ny) * sy;
    const int tx = (o % dx - nx) * sx;
    float acc = 0.0f;
    for (int p = 0; p < P; ++p) {
      const int y = cy[p] + ty;
      const int x = cx[p] + tx;
      if (static_cast<unsigned>(y) < static_cast<unsigned>(C) &&
          static_cast<unsigned>(x) < static_cast<unsigned>(C)) {
        acc += __ldg(grid + static_cast<size_t>(y) * C + x);
      }
    }
    vol[o] = acc / n_kept;
  }
}

int launch(const float* grids, const int* gidx, const int* ix, const int* iy,
           const unsigned char* keep, const float* count, float* out,
           int n_grids, int B, int T, int P, int C, int ny, int nx, int sy,
           int sx, void* stream) {
  if (B * T == 0) return 0;
  const int n_off = (2 * ny + 1) * (2 * nx + 1);
  int threads = ((n_off + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = 2 * static_cast<size_t>(P) * sizeof(int);
  score_volume_kernel<<<B * T, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      grids, gidx, ix, iy, keep, count, out, n_grids, T, P, C, ny, nx, sy,
      sx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*). Shapes: grids
// [n_grids, C, C] f32; gidx [B] i32; ix, iy [B, T, P] i32; keep [B, T, P]
// u8; count [B, T] f32; out [B, T, Dy, Dx] f32. All contiguous. Each
// returns the cudaError_t of the launch (0 on success).

// K1: contiguous lattice, Dy = 2ry+1, Dx = 2rx+1.
extern "C" int cg_score_volume(const float* grids, const int* gidx,
                               const int* ix, const int* iy,
                               const unsigned char* keep, const float* count,
                               float* out, int n_grids, int B, int T, int P,
                               int C, int ry, int rx, void* stream) {
  return launch(grids, gidx, ix, iy, keep, count, out, n_grids, B, T, P, C,
                ry, rx, 1, 1, stream);
}

// K2: strided lattice (i - ny) * sy, (j - nx) * sx; Dy = 2ny+1,
// Dx = 2nx+1.
extern "C" int cg_score_volume_strided(const float* grids, const int* gidx,
                                       const int* ix, const int* iy,
                                       const unsigned char* keep,
                                       const float* count, float* out,
                                       int n_grids, int B, int T, int P,
                                       int C, int ny, int nx, int sy, int sx,
                                       void* stream) {
  return launch(grids, gidx, ix, iy, keep, count, out, n_grids, B, T, P, C,
                ny, nx, sy, sx, stream);
}

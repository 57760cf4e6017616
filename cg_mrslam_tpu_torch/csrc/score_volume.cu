// Correlative scan-match score volumes (kernels K1 and K2) for NVIDIA
// Hopper, sm_90a.
//
// Replaces the TPU Pallas kernels of cg_mrslam_tpu/ops/correlate.py:
//   K1  pallas_score_volume          (contiguous +-ry x +-rx lattice)
//   K2  pallas_score_volume_strided  (symmetric lattice of stride sy, sx)
// both reached through _pallas_volume with the body _make_kernel_v3, and
// the timing probes _make_kernel_x1 / _make_kernel_x2 (as the probe modes
// below). Computes, for a batch of (grid, base) pairs b and rotations t,
//
//   out[b, t, i, j] = sum_p keep[b,t,p] * G_b(iy[b,t,p] + (i - ny) * sy,
//                                            ix[b,t,p] + (j - nx) * sx)
//                     / count[b, t]
//
// where G_b is grid gidx[b] and a cell outside the C x C grid reads 0 (it
// still counts: count[] is computed by the caller together with the cell
// indices and the keep mask, by the same torch code the plain version
// uses, so kernel and plain version see identical integer cells and
// differ only in summation order). K1 is the case sy = sx = 1. K2's
// known_cap pair (mode kPair) reads each cell v once and sums both v * k
// and k, k = (v < cap), into out[b, 0] and out[b, 1]: the volumes of
// grid * known and of known that the reference scores as two grids.
//
// What bounds it on this card: every (b, t, point, offset) is one gathered
// 4-byte load, T*Dy*Dx*P per volume (about 14.6M for the close match at
// 65 x 25 x 25 x 360), served from L1/L2: a close grid (1200^2 floats,
// 5.8 MB) or a keyframe's four LC grids (700^2 floats, 2 MB each) fit the
// 50 MB L2 many times over. The bytes a volume must move (grid read once,
// volume written once) take about 2 us; the loads are the cost. At most
// one warp-wide load issues per clock per SM, so the design's issue floor
// is T*Dy*Dx*P / (132 * 32) clocks. On the main path's shapes (1-96
// volumes, 360 points) there is little work per launch, so what sets the
// time is how long the longest dependent chain of loads takes — latency —
// unless enough independent loads are in flight on every SM. Measured
// with the probes (PERF.md): once latency is hidden, the small shapes sit
// at a few microseconds of launch and block overhead, and the large ones
// (close, loop) are bound by the instructions per (point, offset) and by
// the L1's address stage — a warp-wide load whose 32 offsets span 2-3
// grid rows touches several lines — not by L2 or HBM.
//
// What the design does about it:
// * A block is one (b, t) and one tile of 32 consecutive flat offsets
//   (lane = offset, row-major; blockIdx = (tile, t, b), no division), so
//   B*T*ceil(Dy*Dx/32) blocks share the card instead of B*T. Small
//   windows (Dx = 5, 7, 11) pack several lattice rows into one warp;
//   neighbouring lanes read neighbouring cells of one grid row where the
//   lattice is contiguous.
// * The W warps of a block split the points into W contiguous slices, and
//   each thread walks its slice four points at a time with four
//   accumulators, so four independent loads are in flight per thread. W
//   (4, 8 or 16) is picked from the number of blocks so that every shape
//   puts enough warps on every SM. Splitting offsets across blocks fills
//   132 SMs at every main-path shape (the fewest blocks are near's 136 and
//   level 0's 143), so no cross-block reduction (cluster or second pass)
//   is needed.
// * Few instructions per (point, offset): with little work per launch, a
//   per-offset bounds check, two coordinates and the address cost more
//   than the load (the no-gather probe showed it). So each block stages
//   one code per point in shared memory: the cell y * C + x when every
//   offset of its tile lands on the grid, kSkip when none does (or the
//   point is dropped), kSlow when the tile straddles the grid's edge.
//   Four codes come in one 16-byte broadcast load; a group of four with
//   no kSlow costs one add to the lane's shifted base pointer, a
//   predicated load and a float add per point; a group with one checks
//   bounds per offset. The branch is the same for every lane of a warp.
// * The order of the float32 sums depends only on the point index and the
//   split (the value a point adds does not depend on the path that read
//   it): accumulator u of a warp takes the points slice_start + 4m + u,
//   the four are added as (a0 + a1) + (a2 + a3), and the W warp partials
//   in warp order through shared memory. No atomics. Two launches on the
//   same inputs give the same bits, and offsets that see the same values
//   in the same order (a corridor) keep their exact ties.
// * A dropped point and an off-grid cell add nothing (not even +0). A bad
//   grid index poisons the volume with NaN.
// * The probes (wrong results by design; only timing tools launch them)
//   are the same body with the grid read changed: kNoGather computes the
//   value from the cell index and reads no memory (loop, addressing,
//   reduction and store stay); kConstCells stages every point at one cell
//   so every load hits one L1 line.

#include <cuda_runtime.h>

#include <climits>

namespace {

// Staged codes of a point for one block: its cell y * C + x when every
// offset of the block's tile lands on the grid, or one of these two.
constexpr int kSkip = INT_MIN;      // dropped, or off the grid for the tile
constexpr int kSlow = INT_MIN + 1;  // straddles the grid's edge for the tile
constexpr int kWarp = 32;
constexpr int kMaxWarps = 16;
constexpr int kUnroll = 4;  // points per step, one accumulator each
constexpr int kSms = 132;
constexpr int kWarpsPerSm = 48;  // target of resident warps per SM

enum Mode { kScore = 0, kNoGather = 1, kConstCells = 2, kPair = 3 };

// The no-gather probe's value of cell idx: a float in [1, 2) made from the
// index's bits by one logic operation (idx < 2^23), so the probe costs no
// more than a load would in issue slots (an int-to-float conversion runs
// at a quarter of the rate).
__device__ __forceinline__ float index_value(int idx) {
  return __int_as_float(idx | 0x3f800000);
}

// The value of cell idx: the grid's, or the no-gather probe's.
template <int M>
__device__ __forceinline__ float read(const float* __restrict__ grid,
                                      int idx) {
  if (M == kNoGather) return index_value(idx);
  return __ldg(grid + idx);
}

// The value of staged cell c at this lane's offset toff = ty * C + tx
// (shifted = grid + toff).
template <int M>
__device__ __forceinline__ float read_shifted(
    const float* __restrict__ shifted, int c, int toff) {
  if (M == kNoGather) return index_value(c + toff);
  return __ldg(shifted + c);
}

// Adds one (point, offset) cell of value v, on the grid iff `in`.
template <int M>
__device__ __forceinline__ void add(bool in, float v, float cap, float& a,
                                    float& k) {
  if (M == kPair) {
    const float known = (in && v < cap) ? 1.0f : 0.0f;
    if (in) a += v * known;
    k += known;
  } else if (in) {
    a += v;
  }
}

template <int M>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
    score_volume_kernel(const float* __restrict__ grids,
                        const int* __restrict__ gidx,
                        const int* __restrict__ ix,
                        const int* __restrict__ iy,
                        const unsigned char* __restrict__ keep,
                        const float* __restrict__ count,
                        float* __restrict__ out, int n_grids, int T, int P,
                        int C, int ny, int nx, int sy, int sx, float cap) {
  constexpr int kCh = M == kPair ? 2 : 1;  // output channels
  // [Pp] staged codes (P rounded up to kUnroll), then [kCh][W][32] sums
  extern __shared__ int4 smem4[];
  int* code = reinterpret_cast<int*>(smem4);
  float* part = reinterpret_cast<float*>(smem4);

  const int tile = blockIdx.x;  // 32 consecutive flat offsets
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int bt = b * T + t;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int W = blockDim.y;
  const int tid = warp * kWarp + lane;

  const int dx = 2 * nx + 1;
  const int n_off = (2 * ny + 1) * dx;
  const int o_lo = tile * kWarp;
  const int o_hi = min(n_off, o_lo + kWarp) - 1;
  const int o = o_lo + lane;
  const bool live = o < n_off;
  const int oo = live ? o : o_hi;  // idle lanes shadow a live one
  const int ty = (oo / dx - ny) * sy;
  const int tx = (oo % dx - nx) * sx;
  const int toff = ty * C + tx;  // this lane's offset as a cell index
  // channel c of (b, t) starts at vol + c * T * n_off
  float* vol = out + (static_cast<size_t>(b) * kCh * T + t) * n_off;

  const int g = gidx[b];
  if (g < 0 || g >= n_grids) {  // bad grid index: poison the volume
    if (warp == 0 && live) {
      for (int c = 0; c < kCh; ++c) {
        vol[static_cast<size_t>(c) * T * n_off + o] =
            __int_as_float(0x7fc00000);
      }
    }
    return;
  }
  const float* grid = grids + static_cast<size_t>(g) * C * C;
  const float* shifted = grid + toff;

  // the offsets' bounding box over the tile's live lanes
  const int i_lo = o_lo / dx;
  const int i_hi = o_hi / dx;
  const int ty_lo = (i_lo - ny) * sy;
  const int ty_hi = (i_hi - ny) * sy;
  const bool one_row = i_lo == i_hi;
  const int tx_lo = one_row ? (o_lo - i_lo * dx - nx) * sx : -nx * sx;
  const int tx_hi = one_row ? (o_hi - i_hi * dx - nx) * sx : nx * sx;

  const size_t base = static_cast<size_t>(bt) * P;
  const int Pp = (P + kUnroll - 1) / kUnroll * kUnroll;
  for (int p = tid; p < Pp; p += W * kWarp) {
    int c = kSkip;
    if (p < P) {
      const bool kept = M == kConstCells || keep[base + p] != 0;
      const int y = M == kConstCells ? C / 2 : iy[base + p];
      const int x = M == kConstCells ? C / 2 : ix[base + p];
      const bool all_in = y + ty_lo >= 0 && y + ty_hi < C &&
                          x + tx_lo >= 0 && x + tx_hi < C;
      const bool all_out = y + ty_hi < 0 || y + ty_lo >= C ||
                           x + tx_hi < 0 || x + tx_lo >= C;
      if (kept && all_in) {
        c = y * C + x;
      } else if (kept && !all_out) {
        c = kSlow;
      }
    }
    code[p] = c;
  }
  __syncthreads();

  // warp `warp` walks the points [p0, p1), kUnroll at a time; accumulator
  // u takes the points p0 + kUnroll * m + u
  const int chunk = ((Pp / kUnroll + W - 1) / W) * kUnroll;
  const int p0 = min(Pp, warp * chunk);
  const int p1 = min(Pp, p0 + chunk);
  float a[kUnroll] = {};
  float k[kUnroll] = {};
  for (int p = p0; p < p1; p += kUnroll) {
    const int4 c4 = smem4[p / kUnroll];
    const int cs[kUnroll] = {c4.x, c4.y, c4.z, c4.w};
    if (cs[0] == kSlow || cs[1] == kSlow || cs[2] == kSlow ||
        cs[3] == kSlow) {  // the same for every lane: no divergence
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        bool in = cs[u] != kSkip;
        float v = 0.0f;
        if (cs[u] == kSlow) {
          const int q = p + u;
          const int y = (M == kConstCells ? C / 2 : iy[base + q]) + ty;
          const int x = (M == kConstCells ? C / 2 : ix[base + q]) + tx;
          in = static_cast<unsigned>(y) < static_cast<unsigned>(C) &&
               static_cast<unsigned>(x) < static_cast<unsigned>(C);
          if (in) v = read<M>(grid, y * C + x);
        } else if (in) {
          v = read_shifted<M>(shifted, cs[u], toff);
        }
        add<M>(in, v, cap, a[u], k[u]);
      }
    } else {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = 0.0f;
        if (cs[u] != kSkip) v[u] = read_shifted<M>(shifted, cs[u], toff);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        add<M>(cs[u] != kSkip, v[u], cap, a[u], k[u]);
      }
    }
  }
  __syncthreads();  // every warp is done with the staged codes
  part[warp * kWarp + lane] = (a[0] + a[1]) + (a[2] + a[3]);
  if (M == kPair) {
    part[(W + warp) * kWarp + lane] = (k[0] + k[1]) + (k[2] + k[3]);
  }
  __syncthreads();

  if (warp < kCh && live) {  // warp c sums channel c in warp order
    const float* sums = part + warp * W * kWarp + lane;
    float s = sums[0];
    for (int w = 1; w < W; ++w) s += sums[w * kWarp];
    vol[static_cast<size_t>(warp) * T * n_off + o] = s / count[bt];
  }
}

// W warps share a block's points: 4, or more until the card holds
// kWarpsPerSm warps per SM. W depends on the shape only, so the summation
// order does too.
template <int M>
int launch(const float* grids, const int* gidx, const int* ix, const int* iy,
           const unsigned char* keep, const float* count, float* out,
           int n_grids, int B, int T, int P, int C, int ny, int nx, int sy,
           int sx, float cap, void* stream) {
  if (B * T == 0) return 0;
  if (B > 65535 || T > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kCh = M == kPair ? 2 : 1;
  const int n_off = (2 * ny + 1) * (2 * nx + 1);
  const int n_tiles = (n_off + kWarp - 1) / kWarp;
  const long long n_blocks = static_cast<long long>(B) * T * n_tiles;
  int W = 4;
  while (W < kMaxWarps && n_blocks * W < kSms * kWarpsPerSm) W *= 2;
  const int Pp = (P + kUnroll - 1) / kUnroll * kUnroll;
  size_t smem = static_cast<size_t>(Pp) * sizeof(int);
  const size_t sums = static_cast<size_t>(kCh) * W * kWarp * sizeof(float);
  if (smem < sums) smem = sums;
  score_volume_kernel<M><<<dim3(n_tiles, T, B), dim3(kWarp, W), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      grids, gidx, ix, iy, keep, count, out, n_grids, T, P, C, ny, nx, sy,
      sx, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*). Shapes: grids
// [n_grids, C, C] f32; gidx [B] i32; ix, iy [B, T, P] i32; keep [B, T, P]
// u8; count [B, T] f32; out [B, T, Dy, Dx] f32 ([B, 2, T, Dy, Dx] for the
// pair). All contiguous; P at most 6144 (the wrapper's limit: the staged
// codes take 4 bytes a point of shared memory). Each returns the
// cudaError_t of the launch (0 on success).

// K1: contiguous lattice, Dy = 2ry+1, Dx = 2rx+1.
extern "C" int cg_score_volume(const float* grids, const int* gidx,
                               const int* ix, const int* iy,
                               const unsigned char* keep, const float* count,
                               float* out, int n_grids, int B, int T, int P,
                               int C, int ry, int rx, void* stream) {
  return launch<kScore>(grids, gidx, ix, iy, keep, count, out, n_grids, B, T,
                        P, C, ry, rx, 1, 1, 0.0f, stream);
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
  return launch<kScore>(grids, gidx, ix, iy, keep, count, out, n_grids, B, T,
                        P, C, ny, nx, sy, sx, 0.0f, stream);
}

// K2's known_cap pair on K2's lattice: out[b, 0] sums v * (v < cap),
// out[b, 1] sums (v < cap).
extern "C" int cg_score_volume_pair(const float* grids, const int* gidx,
                                    const int* ix, const int* iy,
                                    const unsigned char* keep,
                                    const float* count, float* out,
                                    int n_grids, int B, int T, int P, int C,
                                    int ny, int nx, int sy, int sx,
                                    float cap, void* stream) {
  return launch<kPair>(grids, gidx, ix, iy, keep, count, out, n_grids, B, T,
                       P, C, ny, nx, sy, sx, cap, stream);
}

// Timing probes on K2's lattice (WRONG RESULTS BY DESIGN): mode 1 =
// no gather, mode 2 = constant cells.
extern "C" int cg_score_volume_probe(int mode, const float* grids,
                                     const int* gidx, const int* ix,
                                     const int* iy, const unsigned char* keep,
                                     const float* count, float* out,
                                     int n_grids, int B, int T, int P, int C,
                                     int ny, int nx, int sy, int sx,
                                     void* stream) {
  if (mode == kNoGather) {
    return launch<kNoGather>(grids, gidx, ix, iy, keep, count, out, n_grids,
                             B, T, P, C, ny, nx, sy, sx, 0.0f, stream);
  }
  if (mode == kConstCells) {
    return launch<kConstCells>(grids, gidx, ix, iy, keep, count, out,
                               n_grids, B, T, P, C, ny, nx, sy, sx, 0.0f,
                               stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The CDEF stage of the device filter program, for Hopper (sm_90a): the
// direction search, the strength sweep and the apply, as three kernels.
//
// Replaces: rav1e_tpu/device/filters.py `cdef_stage_core` (:333), run by
// `cdef_stage_jit` (:484) for the standalone stage and fused into the
// chain's filter program `_filters_program` (rav1e_tpu/device/chain.py:830,
// jitted in `chain_stages_jit` :954), with its direction search
// `cdef_dirs_cells` (filters.py:85).  On the TPU these are one XLA program
// over whole planes: every 8x8 cell filtered at every candidate strength
// into (ncand, nby, nbx, 8, 8) tensors, the per-superblock argmin over them,
// then a gather of the chosen candidate.
//
// What bounds it on this card: integer operations.  Each sample of the
// reconstruction and the source is read once and each output written once
// (about 3.1 M samples at 1080p 4:2:0), but each filtered sample costs 12
// taps with a constrain() of about 8 operations each, for each of the four
// candidates and once more for the chosen one: about 10^2 operations a
// sample a candidate, against a few bytes.
//
// Design: no candidate plane is written.
// - cdef_dirs: one thread per 8x8 luma cell.  The cell's 64 samples go to
//   registers, the 8 x 15 partial sums are accumulated at compile-time
//   indices (the buckets of ops/cdef.py `_partial_matrices`), and the eight
//   direction costs are formed in 64-bit integers, as the plain version does
//   (for samples in [0, 2^bd) they peak at 880,803,840, below 2^31; 64 bits
//   keep any int32 input exact).
// - cdef_search: one thread per (candidate, cell).  It filters the cell's
//   samples of every plane from the reconstruction grid (read through L1:
//   neighbouring cells and candidates share the taps) and sums the squared
//   error against the source over the visible samples in 64 bits (a cell's
//   three 12-bit planes reach 192 * 4095^2 > 2^31).  Writes only the
//   (ncand, nby, nbx) SSE.
// - cdef_apply: one thread per cell.  It sums its superblock's SSE per
//   candidate (each thread of a superblock repeats the 64 x ncand loads,
//   from L2, instead of a second pass), takes the first minimum, writes the
//   superblock's index from the superblock's first cell, and filters its own
//   cell again at that candidate (a skip cell is copied from the
//   reconstruction).
// The CDEF_VERY_LARGE ring is not materialised: a tap that falls in the
// 2-sample border on a side without a neighbour (have_top/left/right/bottom)
// reads as CDEF_VERY_LARGE, which the max envelope skips and the min
// envelope takes (filters.py `cdef_tap_precompute`).
//
// Exactness: integer throughout, the same operations as the plain version;
// the sums are of integers, so their order does not matter.

#include <cuda_runtime.h>

// Arguments of the three kernels, filled by rav1e_tpu_torch/device/filters.py
// (`_build.CdefArgs` mirrors this layout); a kernel reads what it needs.
struct R1tCdefArgs {
  const int* rec[3];           // (nby*ys + 4, nbx*xs + 4): cells + 2px ring
  const int* src[3];           // (nby*ys, nbx*xs)
  long long* out[3];           // (nby*ys, nbx*xs)
  const unsigned char* filt;   // (nby, nbx) bool: non-skip cells
  int* dirs;                   // (nby, nbx)
  int* var;                    // (nby, nbx)
  long long* sse;              // (ncand, nby, nbx)
  long long* idx;              // (sb_rows, sb_cols)
  int ys[3], xs[3], vh[3], vw[3];
  int nplanes, nby, nbx, sb_rows, sb_cols, crop_w, crop_h;
  int damping, bd, ncand;
  int y_str[4], uv_str[4];     // packed strengths: pri * 4 + sec
};

namespace {

constexpr int kThreads = 128;
constexpr int kVeryLarge = 0x8000;  // ops/cdef.py CDEF_VERY_LARGE
constexpr int kSecStrengths = 4;    // ops/cdef.py CDEF_SEC_STRENGTHS

// (dy, dx) per direction and tap distance (ops/cdef.py CDEF_DIRECTIONS)
__constant__ int kDirs[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}},
};
// the chroma direction of a luma direction at 4:2:2 (CDEF_UV_DIR_422)
__constant__ int kUvDir422[8] = {7, 0, 2, 4, 5, 6, 6, 6};

__device__ __forceinline__ int msb(int v) { return 31 - __clz(v); }  // v >= 1

// A cell's filter window in one plane: (ys + 4) x (xs + 4) samples from
// row by*ys, column bx*xs of the plane's grid.
struct Win {
  const int* p;
  int stride, ys, xs;
  bool t, l, r, b;
};

__device__ __forceinline__ Win window(const R1tCdefArgs& a, int pi, int by,
                                      int bx) {
  Win w;
  w.ys = a.ys[pi];
  w.xs = a.xs[pi];
  w.stride = a.nbx * w.xs + 4;
  w.p = a.rec[pi] + (long long)(by * w.ys) * w.stride + bx * w.xs;
  w.t = by > 0;
  w.l = bx > 0;
  w.r = (bx + 2) * 8 <= a.crop_w;
  w.b = (by + 2) * 8 <= a.crop_h;
  return w;
}

__device__ __forceinline__ int tap(const Win& w, int wy, int wx) {
  if ((wy < 2 && !w.t) || (wx < 2 && !w.l) || (wx >= w.xs + 2 && !w.r) ||
      (wy >= w.ys + 2 && !w.b))
    return kVeryLarge;
  return w.p[wy * w.stride + wx];
}

// One candidate's filter parameters for one plane of one cell.
struct Strength {
  int dir, pri, sec, pri_shift, sec_shift, pri_t0, pri_t1;
};

__device__ __forceinline__ Strength strength(const R1tCdefArgs& a, int pi,
                                             int ci, int dir, int var) {
  const int cs = a.bd - 8;
  const int v = pi == 0 ? a.y_str[ci] : a.uv_str[ci];
  const int pri_u = v / kSecStrengths;
  int sec_u = v % kSecStrengths;
  sec_u += sec_u == 3;
  const int damp = a.damping + cs - (pi == 0 ? 0 : 1);
  Strength s;
  if (pri_u == 0) {
    // no primary: the direction-0 taps (filters.py `taps_0`)
    s.pri = 0;
    s.dir = 0;
  } else if (pi == 0) {
    // luma: the primary strength adjusted by the direction variance
    const int var6 = var >> 6;
    const int var_idx = var6 != 0 ? min(msb(var6), 12) : 0;
    s.pri = var != 0 ? ((pri_u << cs) * (4 + var_idx) + 8) >> 4 : 0;
    s.dir = dir;
  } else {
    s.pri = pri_u << cs;
    s.dir = a.ys[pi] != a.xs[pi] ? kUvDir422[dir] : dir;
  }
  s.sec = sec_u << cs;
  const int pri_bit = (s.pri >> cs) & 1;
  s.pri_t0 = pri_bit ? 3 : 4;
  s.pri_t1 = pri_bit ? 3 : 2;
  s.pri_shift = max(0, damp - msb(max(s.pri, 1)));
  s.sec_shift = max(0, damp - msb(max(s.sec, 1)));
  return s;
}

__device__ __forceinline__ int constrain(int diff, int strength, int shift) {
  if (strength == 0) return 0;
  const int ad = abs(diff);
  const int mag = min(max(strength - (ad >> shift), 0), ad);
  return diff < 0 ? -mag : mag;
}

// The filtered sample (y, x) of a cell (filters.py `cdef_filter_from_taps`).
__device__ int filter_px(const Win& w, int y, int x, const Strength& s) {
  const int cy = y + 2, cx = x + 2;
  const int xv = w.p[cy * w.stride + cx];
  int mn = xv, mx = xv, total = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      const int d = which == 0 ? s.dir
                    : which == 1 ? (s.dir + 2) & 7
                                 : (s.dir + 6) & 7;
      const int dy = kDirs[d][k][0], dx = kDirs[d][k][1];
#pragma unroll
      for (int sgn = 1; sgn >= -1; sgn -= 2) {
        const int p = tap(w, cy + sgn * dy, cx + sgn * dx);
        if (p != kVeryLarge) mx = max(p, mx);
        mn = min(p, mn);
        if (which == 0)
          total += (k == 0 ? s.pri_t0 : s.pri_t1) *
                   constrain(p - xv, s.pri, s.pri_shift);
        else
          total += (k == 0 ? 2 : 1) * constrain(p - xv, s.sec, s.sec_shift);
      }
    }
  }
  const int v = xv + ((8 + total - (total < 0)) >> 4);
  return min(max(v, mn), mx);
}

__device__ __forceinline__ long long sq(int v) {
  return (long long)v * v;
}

__global__ void __launch_bounds__(kThreads)
cdef_dirs_kernel(R1tCdefArgs a) {
  const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (cell >= (long long)a.nby * a.nbx) return;
  const int by = (int)(cell / a.nbx), bx = (int)(cell % a.nbx);
  const int stride = a.nbx * 8 + 4;
  const int* p = a.rec[0] + (long long)(by * 8 + 2) * stride + bx * 8 + 2;
  const int shift = a.bd - 8;
  int part[8][15];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int k = 0; k < 15; ++k) part[d][k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int v = (p[i * stride + j] >> shift) - 128;
      part[0][i + j] += v;
      part[1][i + j / 2] += v;
      part[2][i] += v;
      part[3][3 + i - j / 2] += v;
      part[4][7 + i - j] += v;
      part[5][3 - i / 2 + j] += v;
      part[6][j] += v;
      part[7][i / 2 + j] += v;
    }
  }
  const long long kDiv[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
  long long cost[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    long long c = 0;
    if (d == 2 || d == 6) {
#pragma unroll
      for (int k = 0; k < 8; ++k) c += sq(part[d][k]) * kDiv[8];
    } else if (d == 0 || d == 4) {
      c = sq(part[d][7]) * kDiv[8];
#pragma unroll
      for (int i = 0; i < 7; ++i)
        c += (sq(part[d][i]) + sq(part[d][14 - i])) * kDiv[i + 1];
    } else {
#pragma unroll
      for (int k = 3; k < 8; ++k) c += sq(part[d][k]) * kDiv[8];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        c += (sq(part[d][j]) + sq(part[d][10 - j])) * kDiv[2 * j + 2];
    }
    cost[d] = c;
  }
  // argmax, ties to the first direction
  int best = 0;
#pragma unroll
  for (int d = 1; d < 8; ++d)
    if (cost[d] > cost[best]) best = d;
  a.dirs[cell] = best;
  a.var[cell] = (int)((cost[best] - cost[(best + 4) & 7]) >> 10);
}

__global__ void __launch_bounds__(kThreads)
cdef_search_kernel(R1tCdefArgs a) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long ncell = (long long)a.nby * a.nbx;
  if (t >= a.ncand * ncell) return;
  const int ci = (int)(t / ncell);
  const long long cell = t - ci * ncell;
  const int by = (int)(cell / a.nbx), bx = (int)(cell % a.nbx);
  long long sse = 0;
  if (a.filt[cell]) {
    const int dir = a.dirs[cell], var = a.var[cell];
    for (int pi = 0; pi < a.nplanes; ++pi) {
      const Win w = window(a, pi, by, bx);
      const Strength s = strength(a, pi, ci, dir, var);
      const int sstride = a.nbx * w.xs;
      const int* src = a.src[pi] + (long long)(by * w.ys) * sstride + bx * w.xs;
      const int rows = min(w.ys, a.vh[pi] - by * w.ys);
      const int cols = min(w.xs, a.vw[pi] - bx * w.xs);
      for (int y = 0; y < rows; ++y)
        for (int x = 0; x < cols; ++x) {
          const int d = filter_px(w, y, x, s) - src[y * sstride + x];
          sse += d * d;
        }
    }
  }
  a.sse[t] = sse;
}

// Threads cover max(nby, 8*sb_rows) x max(nbx, 8*sb_cols) cells, so that
// every superblock has its first cell and every cell its superblock.
__global__ void __launch_bounds__(kThreads)
cdef_apply_kernel(R1tCdefArgs a, int ny, int nx) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)ny * nx) return;
  const int by = (int)(t / nx), bx = (int)(t % nx);
  const int sr = min(by >> 3, a.sb_rows - 1);
  const int sc = min(bx >> 3, a.sb_cols - 1);
  const int y0 = sr * 8, y1 = min(y0 + 8, a.nby);
  const int x0 = sc * 8, x1 = min(x0 + 8, a.nbx);
  int best = 0;
  long long best_sse = 0;
  for (int c = 0; c < a.ncand; ++c) {
    const long long* s = a.sse + (long long)c * a.nby * a.nbx;
    long long sum = 0;
    for (int yy = y0; yy < y1; ++yy)
      for (int xx = x0; xx < x1; ++xx) sum += s[(long long)yy * a.nbx + xx];
    if (c == 0 || sum < best_sse) {  // ties to the lowest index
      best = c;
      best_sse = sum;
    }
  }
  if ((by & 7) == 0 && (bx & 7) == 0 && (by >> 3) < a.sb_rows &&
      (bx >> 3) < a.sb_cols)
    a.idx[sr * a.sb_cols + sc] = best;
  if (by >= a.nby || bx >= a.nbx) return;
  const long long cell = (long long)by * a.nbx + bx;
  const bool filt = a.filt[cell];
  for (int pi = 0; pi < a.nplanes; ++pi) {
    const Win w = window(a, pi, by, bx);
    const int ostride = a.nbx * w.xs;
    long long* out = a.out[pi] + (long long)(by * w.ys) * ostride + bx * w.xs;
    if (filt) {
      const Strength s = strength(a, pi, best, a.dirs[cell], a.var[cell]);
      for (int y = 0; y < w.ys; ++y)
        for (int x = 0; x < w.xs; ++x)
          out[y * ostride + x] = filter_px(w, y, x, s);
    } else {
      for (int y = 0; y < w.ys; ++y)
        for (int x = 0; x < w.xs; ++x)
          out[y * ostride + x] = w.p[(y + 2) * w.stride + x + 2];
    }
  }
}

unsigned blocks(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError().
extern "C" int r1t_cdef_dirs(const R1tCdefArgs* a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cdef_dirs_kernel<<<blocks((long long)a->nby * a->nbx), kThreads, 0,
                     (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int r1t_cdef_search(const R1tCdefArgs* a, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cdef_search_kernel<<<blocks((long long)a->ncand * a->nby * a->nbx),
                       kThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int r1t_cdef_apply(const R1tCdefArgs* a, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int ny = a->nby > 8 * a->sb_rows ? a->nby : 8 * a->sb_rows;
  const int nx = a->nbx > 8 * a->sb_cols ? a->nbx : 8 * a->sb_cols;
  cdef_apply_kernel<<<blocks((long long)ny * nx), kThreads, 0,
                      (cudaStream_t)stream>>>(*a, ny, nx);
  return (int)cudaGetLastError();
}

// The first pass over each input luma, for Hopper (sm_90a): the scene
// detector's 2x downsample and its integer sums, and the temporal-RDO
// lookahead's per-8x8 intra costs and its 16x16 diamond motion search with
// the per-8x8 inter costs fused in.
//
// Replaces no TPU kernel.  The JAX package runs this work on the host:
// scene detection in NumPy (rav1e_tpu/api/context.py `_detect_keyframe`,
// `_downsample_luma`, `shifted_mad`), the lookahead's grids in C++
// (native/enc.cc `enc_la_intra_costs`, `enc_lookahead_me`,
// `enc_inter_costs_8x8`, called from rav1e_tpu/encoder/lookahead.py).  On
// the card those are one host core's work while the card waits; here each
// frame's luma is already on the card from intake
// (rav1e_tpu_torch/device/firstpass.py) and the host only compares a few
// sums or runs the importance propagation.  Every result is an exact
// integer or an exact double, equal bit for bit to the host functions.
//
// What bounds them on this card: integer operations, and in practice the
// launch.  Scene detection compares a 960x540 plane with each earlier
// plane under 49 shifts (25 M differences of 3 operations a plane, 4.6 us
// at 132 SMs x 64 INT32 lanes x 1.98 GHz) and reads 3 MB; a 1080p motion
// search takes about 24 SADs of 256 samples for each of 8040 blocks.  On
// an H100 each kernel runs in 0.03-0.13 ms a call (PERF.md, section 6).
//
// Design:
// - downsample_kernel: one thread per output sample, (a + b + c + d) >> 2,
//   which is the float mean truncated to uint16 that the host computes.
// - scene_sums_kernel: a CTA takes a 64x16 tile of the current downsampled
//   plane, 4 rows a thread, and stages each earlier plane's tile with a
//   halo of r into shared memory; for every shift (dy, dx) a thread sums
//   |cur(y, x) - prev(y - dy, x - dx)| over its samples whose partner lies
//   in the plane (the host's sliced overlap), a warp-wide __reduce_add_sync
//   and a shared 32-bit atomic per warp gather the tile's sum, and one
//   64-bit global atomic per CTA and shift adds it up.  Integer sums in any
//   order are exact.  The gradient sums |dx| and |dy| of the current plane
//   ride along.
// - la_intra_kernel: one thread per 8x8 cell; the DC, row-mean and
//   column-mean residuals scaled by 64, 8 and 8 are integers, so the
//   double result equals enc_la_intra_costs's, whose doubles are exact.
// - la_motion_kernel: one warp per 16x16 block, the source block in
//   registers (lane l holds 8 samples of row l / 2).  Candidates are
//   evaluated one after another in enc_lookahead_me's order, each a
//   warp-wide SAD (8 samples a lane and a reduction), with its strict <
//   acceptance and its out-of-frame rejection; every lane holds the sum,
//   so the search's control flow is uniform.  The block's 8x8 inter costs
//   (enc_inter_costs_8x8's clamped positions) follow in the same warp, the
//   last block row and column taking the cells past the 16x16 grid.
// - A context's scene detection is one call (r1t_fp_scene: the downsample,
//   the sums and their copy to pinned memory) on a stream of the context's
//   own (r1t_fp_stream_create), and one wait (r1t_fp_sync).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 64;   // scene tile width (one sample a thread)
constexpr int kRows = 4;     // scene tile rows a thread
constexpr int kThreads = 256;
constexpr int kTileH = kThreads / kTileW * kRows;  // 16
constexpr int kMeWarps = 8;  // 16x16 blocks a CTA

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  return __reduce_add_sync(0xffffffffu, v);
}

template <typename T>
__global__ void downsample_kernel(const T* __restrict__ y,
                                  uint16_t* __restrict__ ds, int w, int h2,
                                  int w2) {
  const int n = h2 * w2;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int r = i / w2, c = i - r * w2;
    const T* p = y + (long long)(2 * r) * w + 2 * c;
    ds[i] = (uint16_t)(((unsigned)p[0] + p[1] + p[w] + p[w + 1]) >> 2);
  }
}

// a plane a side of which is 1: the downsampled plane is the plane itself
template <typename T>
__global__ void widen_kernel(const T* __restrict__ y,
                             uint16_t* __restrict__ ds, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    ds[i] = y[i];
  }
}

// sums: [sum |dx|, sum |dy|, (2R+1)^2 shift sums against prev, as many
// against prev2], shifts in (dy, dx) row-major order from (-R, -R)
template <int R>
__global__ void __launch_bounds__(kThreads)
scene_sums_kernel(const uint16_t* __restrict__ cur,
                  const uint16_t* __restrict__ prev,
                  const uint16_t* __restrict__ prev2, int h, int w,
                  int grads, unsigned long long* __restrict__ sums) {
  constexpr int S = 2 * R + 1;
  constexpr int NS = S * S;
  constexpr int PH = kTileH + 2 * R;
  constexpr int PW = kTileW + 2 * R;
  __shared__ uint16_t s_prev[2][PH][PW];
  __shared__ unsigned s_acc[2 + 2 * NS];
  const int nref = prev2 != nullptr ? 2 : 1;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < 2 + 2 * NS; i += kThreads) s_acc[i] = 0;
  for (int k = 0; k < nref; ++k) {
    const uint16_t* p = k ? prev2 : prev;
    for (int i = tid; i < PH * PW; i += kThreads) {
      const int ly = i / PW, lx = i - ly * PW;
      const int gy = y0 - R + ly, gx = x0 - R + lx;
      s_prev[k][ly][lx] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                              ? p[(long long)gy * w + gx]
                              : 0;
    }
  }
  __syncthreads();

  const int lx = tid % kTileW, ly0 = tid / kTileW * kRows;
  const int x = x0 + lx;
  int c[kRows];
  bool in[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + ly0 + r;
    in[r] = y < h && x < w;
    c[r] = in[r] ? cur[(long long)y * w + x] : 0;
  }
  if (grads) {
    unsigned gx = 0, gy = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int y = y0 + ly0 + r;
      if (in[r] && x + 1 < w) gx += abs((int)cur[(long long)y * w + x + 1] - c[r]);
      if (in[r] && y + 1 < h) gy += abs((int)cur[(long long)(y + 1) * w + x] - c[r]);
    }
    gx = warp_sum(gx);
    gy = warp_sum(gy);
    if (lane == 0) {
      atomicAdd(&s_acc[0], gx);
      atomicAdd(&s_acc[1], gy);
    }
  }
  for (int k = 0; k < nref; ++k) {
    for (int dy = -R; dy <= R; ++dy) {
      for (int dx = -R; dx <= R; ++dx) {
        unsigned acc = 0;
        const int sx = x - dx;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int sy = y0 + ly0 + r - dy;
          if (in[r] && sy >= 0 && sy < h && sx >= 0 && sx < w) {
            acc += abs(c[r] - (int)s_prev[k][ly0 + r - dy + R][lx - dx + R]);
          }
        }
        acc = warp_sum(acc);
        if (lane == 0 && acc) {
          atomicAdd(&s_acc[2 + k * NS + (dy + R) * S + dx + R], acc);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 + nref * NS; i += kThreads) {
    if (s_acc[i]) atomicAdd(&sums[i], (unsigned long long)s_acc[i]);
  }
}

template <typename T>
__global__ void la_intra_kernel(const T* __restrict__ y, int w, int nby,
                                int nbx, double norm,
                                double* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nby * nbx) return;
  const int by = i / nbx, bx = i - by * nbx;
  const T* p = y + (long long)by * 8 * w + bx * 8;
  int v[8][8], rows[8], cols[8] = {0, 0, 0, 0, 0, 0, 0, 0}, total = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    rows[r] = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      v[r][c] = p[(long long)r * w + c];
      rows[r] += v[r][c];
      cols[c] += v[r][c];
    }
    total += rows[r];
  }
  // |v - total / 64| * 64, |v - row / 8| * 8, |v - col / 8| * 8
  int sdc = 0, srow = 0, scol = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      sdc += abs(64 * v[r][c] - total);
      srow += abs(8 * v[r][c] - rows[r]);
      scol += abs(8 * v[r][c] - cols[c]);
    }
  }
  const double best = fmin(sdc / 64.0, fmin(srow / 8.0, scol / 8.0));
  const double o = best / norm;
  out[i] = o > 1.0 ? o : 1.0;
}

template <typename T>
__global__ void __launch_bounds__(kMeWarps * 32)
la_motion_kernel(const T* __restrict__ src, const T* __restrict__ ref, int h,
                 int w, int mby, int mbx, int nby8, int nbx8, double norm,
                 int* __restrict__ mvs, double* __restrict__ inter) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kMeWarps + (threadIdx.x >> 5);
  if (b >= mby * mbx) return;  // whole warps only: no CTA-wide barrier
  const int by = b / mbx, bx = b - by * mbx;
  const int py = by * 16, px = bx * 16;
  const int bh = min(16, h - py), bw = min(16, w - px);
  const int row = lane >> 1, c0 = (lane & 1) * 8;
  const bool rok = row < bh;
  int s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = (rok && c0 + j < bw) ? src[(long long)(py + row) * w + px + c0 + j]
                                : 0;
  }
  // SAD at a full-pel offset, -1 when the block leaves the frame; every
  // lane returns the same value
  auto sad_at = [&](int dy, int dx) -> int {
    const int ry = py + dy, rx = px + dx;
    if (ry < 0 || rx < 0 || ry + bh > h || rx + bw > w) return -1;
    unsigned acc = 0;
    if (rok) {
      const T* rp = ref + (long long)(ry + row) * w + rx + c0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (c0 + j < bw) acc += abs(s[j] - (int)rp[j]);
      }
    }
    return (int)warp_sum(acc);
  };
  int best_r = 0, best_c = 0;
  int best = sad_at(0, 0);
  const int dirs[4][2] = {{-1, 0}, {1, 0}, {0, -1}, {0, 1}};
  for (int step = 8; step >= 1; step >>= 1) {
    bool improved = true;
    while (improved) {
      improved = false;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int r = best_r + dirs[d][0] * step;
        const int c = best_c + dirs[d][1] * step;
        const int sv = sad_at(r, c);
        if (sv >= 0 && sv < best) {
          best = sv;
          best_r = r;
          best_c = c;
          improved = true;
        }
      }
    }
  }
  if (lane == 0) {
    mvs[2 * b] = best_r;
    mvs[2 * b + 1] = best_c;
  }
  // the 8x8 cells this block's MV serves: its quadrants, and in the last
  // block row / column the cells past the 16x16 grid
  const int cy1 = by == mby - 1 ? nby8 : min(2 * by + 2, nby8);
  const int cx1 = bx == mbx - 1 ? nbx8 : min(2 * bx + 2, nbx8);
  const int r8 = lane >> 2, q8 = (lane & 3) * 2;
  for (int cy = 2 * by; cy < cy1; ++cy) {
    for (int cx = 2 * bx; cx < cx1; ++cx) {
      const int py8 = cy * 8, px8 = cx * 8;
      const int bh8 = min(8, h - py8), bw8 = min(8, w - px8);
      const int ry = min(max(py8 + best_r, 0), h - bh8);
      const int rx = min(max(px8 + best_c, 0), w - bw8);
      unsigned acc = 0;
      if (r8 < bh8) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (q8 + j < bw8) {
            acc += abs((int)src[(long long)(py8 + r8) * w + px8 + q8 + j] -
                       (int)ref[(long long)(ry + r8) * w + rx + q8 + j]);
          }
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        const double v = (double)acc / norm;
        inter[cy * nbx8 + cx] = v > 1.0 ? v : 1.0;
      }
    }
  }
}

int grid_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace

// y: (h, w) samples, 1 or 2 bytes each; ds: (h / 2, w / 2) uint16, or
// (h, w) when h or w is 1.
extern "C" int r1t_fp_downsample(const void* y, void* ds, int h, int w,
                                 int bytespp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int h2 = h / 2, w2 = w / 2;
  if (h2 == 0 || w2 == 0) {
    const int n = h * w;
    if (n == 0) return 0;
    if (bytespp == 1) {
      widen_kernel<uint8_t><<<grid_for(n, kThreads), kThreads, 0,
                              (cudaStream_t)stream>>>(
          static_cast<const uint8_t*>(y), static_cast<uint16_t*>(ds), n);
    } else {
      widen_kernel<uint16_t><<<grid_for(n, kThreads), kThreads, 0,
                               (cudaStream_t)stream>>>(
          static_cast<const uint16_t*>(y), static_cast<uint16_t*>(ds), n);
    }
    return (int)cudaGetLastError();
  }
  const int grid = grid_for((long long)h2 * w2, kThreads);
  if (bytespp == 1) {
    downsample_kernel<uint8_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(y), static_cast<uint16_t*>(ds), w, h2,
        w2);
  } else {
    downsample_kernel<uint16_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint16_t*>(y), static_cast<uint16_t*>(ds), w, h2,
        w2);
  }
  return (int)cudaGetLastError();
}

// cur, prev, prev2 (or null): (h, w) uint16 downsampled planes; r: 3 or 0;
// sums: 2 + 2 (2r+1)^2 uint64, zeroed here, filled as scene_sums_kernel
// says (the prev2 half stays 0 without prev2, the gradient sums without
// grads).
extern "C" int r1t_fp_scene_sums(const void* cur, const void* prev,
                                 const void* prev2, void* sums, int h, int w,
                                 int r, int grads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (r != 0 && r != 3) return (int)cudaErrorInvalidValue;
  const int ns = (2 * r + 1) * (2 * r + 1);
  err = cudaMemsetAsync(sums, 0, (2 + 2 * ns) * sizeof(unsigned long long),
                        (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  auto* c = static_cast<const uint16_t*>(cur);
  auto* p = static_cast<const uint16_t*>(prev);
  auto* p2 = static_cast<const uint16_t*>(prev2);
  auto* s = static_cast<unsigned long long*>(sums);
  if (r == 3) {
    scene_sums_kernel<3><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        c, p, p2, h, w, grads, s);
  } else {
    scene_sums_kernel<0><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        c, p, p2, h, w, grads, s);
  }
  return (int)cudaGetLastError();
}

// y: (h, w) samples, 1 or 2 bytes each; out: (h / 8, w / 8) float64.
extern "C" int r1t_fp_la_intra(const void* y, void* out, int h, int w,
                               int bytespp, int bd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nby = h / 8, nbx = w / 8;
  if (nby == 0 || nbx == 0) return 0;
  const double norm = (double)(1 << (bd - 8));
  const int grid = grid_for((long long)nby * nbx, 128);
  if (bytespp == 1) {
    la_intra_kernel<uint8_t><<<grid, 128, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(y), w, nby, nbx, norm,
        static_cast<double*>(out));
  } else {
    la_intra_kernel<uint16_t><<<grid, 128, 0, (cudaStream_t)stream>>>(
        static_cast<const uint16_t*>(y), w, nby, nbx, norm,
        static_cast<double*>(out));
  }
  return (int)cudaGetLastError();
}

// src, ref: (h, w) samples, 1 or 2 bytes each; mvs: (max(h/16, 1),
// max(w/16, 1), 2) int32 full-pel MVs; inter: (max(h/8, 1), max(w/8, 1))
// float64 inter costs.
extern "C" int r1t_fp_la_motion(const void* src, const void* ref, void* mvs,
                                void* inter, int h, int w, int bytespp,
                                int bd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int mby = h / 16 > 0 ? h / 16 : 1, mbx = w / 16 > 0 ? w / 16 : 1;
  const int nby8 = h / 8 > 0 ? h / 8 : 1, nbx8 = w / 8 > 0 ? w / 8 : 1;
  const double norm = (double)(1 << (bd - 8));
  const int grid = grid_for((long long)mby * mbx, kMeWarps);
  if (bytespp == 1) {
    la_motion_kernel<uint8_t>
        <<<grid, kMeWarps * 32, 0, (cudaStream_t)stream>>>(
            static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(ref),
            h, w, mby, mbx, nby8, nbx8, norm, static_cast<int*>(mvs),
            static_cast<double*>(inter));
  } else {
    la_motion_kernel<uint16_t>
        <<<grid, kMeWarps * 32, 0, (cudaStream_t)stream>>>(
            static_cast<const uint16_t*>(src),
            static_cast<const uint16_t*>(ref), h, w, mby, mbx, nby8, nbx8,
            norm, static_cast<int*>(mvs), static_cast<double*>(inter));
  }
  return (int)cudaGetLastError();
}

// A non-blocking stream of the card's greatest priority, for a context's
// first pass: made here, not taken from PyTorch's stream pool, whose
// high-priority streams the graph captures draw from.
extern "C" int r1t_fp_stream_create(void** out, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int least = 0, greatest = 0;
  err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = nullptr;
  err = cudaStreamCreateWithPriority(&s, cudaStreamNonBlocking, greatest);
  *out = s;
  return (int)err;
}

// A context's luma, `nbytes` from pinned `host` to `dev`, on `stream`.
extern "C" int r1t_fp_upload(const void* host, void* dev, long long nbytes,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyAsync(dev, host, (size_t)nbytes,
                              cudaMemcpyHostToDevice, (cudaStream_t)stream);
}

// A scene detection in one call: `luma` (h, w) downsampled into `ds`, and
// with an earlier plane `prev` (and `prev2`, or null) the sums of
// r1t_fp_scene_sums into `sums` and copied to pinned `sums_host`; the
// caller waits on the stream (r1t_fp_sync) before it reads them.
extern "C" int r1t_fp_scene(const void* luma, void* ds, const void* prev,
                            const void* prev2, void* sums, void* sums_host,
                            int h, int w, int bytespp, int r, int grads,
                            int device, void* stream) {
  int err = r1t_fp_downsample(luma, ds, h, w, bytespp, device, stream);
  if (err != 0 || prev == nullptr) return err;
  const bool flat = h / 2 == 0 || w / 2 == 0;
  const int h2 = flat ? h : h / 2, w2 = flat ? w : w / 2;
  err = r1t_fp_scene_sums(ds, prev, prev2, sums, h2, w2, r, grads, device,
                          stream);
  if (err != 0) return err;
  const int ns = (2 * r + 1) * (2 * r + 1);
  return (int)cudaMemcpyAsync(sums_host, sums,
                              (2 + 2 * ns) * sizeof(unsigned long long),
                              cudaMemcpyDeviceToHost, (cudaStream_t)stream);
}

// Wait until `stream` has run all it was given.
extern "C" int r1t_fp_sync(void* stream) {
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}

// One full-pel candidate-grid round of the motion search, for Hopper (sm_90a).
//
// Replaces: rav1e_tpu/device/pallas_kernels.py, the Pallas kernel built by
// `_sad_kernel_factory` behind `_sad_call` / `sad_grid`, as
// rav1e_tpu/device/me.py `_grid_search` uses it: the window gather before it
// and the `sad * 64 + tie + seed` argmin after it are fused in, so a round is
// one launch.  On the TPU the kernel holds 32 materialised search windows in
// VMEM and unrolls the (2R+1)^2 candidate loop; the gather and the argmin are
// separate XLA ops.
//
// What bounds it on this card: bytes.  Each round reads the source blocks
// (n * 16 * 16 int32), the part of the padded reference plane its windows
// cover, the seeds and the block origins, and writes n MVs: 18 MB at 1080p
// L0 (n = 8160), 5.3 us at 3.35 TB/s.  Counting each block's windows apart
// (n * nseeds * W^2 int32, neighbouring windows overlap) gives 34.5 MB,
// 10.3 us.  The SADs themselves are 3 integer operations per pixel pair,
// n * nseeds * (2R+1)^2 * 256 of them: 313 M at L0, 4.7 us at 67 Tops.
//
// Design: one warp per ME block, 8 warps per CTA.  The warp stages its source
// block and each seed's W x W window (W = 16 + 2*R*step <= 28, at most 3.1 KB)
// straight from the padded reference plane into its own shared memory with
// cp.async (4-byte copies, since a window row starts at any column), so no
// (n, W, W) window tensor is ever written.  Lanes split the work over
// (candidate, row band): lane l takes row band l % 4 (4 rows) of candidate
// 8*it + l / 4, so 8 candidates are in flight per step and all 32 lanes are
// busy at 9, 25 or 49 candidates a seed; the band's 64 source pixels stay in
// registers across steps.  Two xor-shuffles sum the bands, and a five-step
// shuffle reduction on (key, flat index) pairs takes the first minimum of
// key = sad * 64 + (|oy - R| + |ox - R|) + seed_index over [seed 0's
// candidates, seed 1's], the torch.argmin / jnp.argmin rule.  The key fits
// int32: 4095 * 256 * 64 + 7 < 2^31.

#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 16;          // ME block side
constexpr int kWarps = 8;         // ME blocks per CTA
constexpr int kBands = 4;         // row bands per candidate
constexpr int kBandRows = kBlk / kBands;
constexpr int kCandsPerStep = 32 / kBands;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kWarps * 32)
grid_search_kernel(const int* __restrict__ src, const int* __restrict__ ref,
                   const int* __restrict__ base_y,
                   const int* __restrict__ base_x,
                   const int* __restrict__ seed0,
                   const int* __restrict__ seed1, int* __restrict__ out, int n,
                   int ref_h, int ref_w, int nseeds, int R, int step,
                   int pad_off, int clip_mv) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= n) return;  // whole warps only: no CTA-wide barrier below

  const int side = 2 * R + 1;
  const int ncand = side * side;
  const int W = kBlk + 2 * R * step;
  // per warp: source block, then nseeds windows; W is even, so every
  // warp's s_src stays 16-byte aligned for the 16-byte copies
  int* s_src = smem + warp * (kBlk * kBlk + nseeds * W * W);
  int* s_win = s_src + kBlk * kBlk;

  // source block: 1 KB, 16-byte copies, two per lane
  const int* g_src = src + (long long)b * kBlk * kBlk;
#pragma unroll
  for (int i = lane; i < kBlk * kBlk / 4; i += 32) {
    cp_async16(s_src + 4 * i, g_src + 4 * i);
  }

  // each seed, clipped, and its window origin in the padded plane; the
  // clamp only matters for origins outside the plane, which the pyramid's
  // padding rules out (and the plain version would refuse)
  int sy[2], sx[2];
  const int by = base_y[b], bx = base_x[b];
#pragma unroll
  for (int si = 0; si < 2; ++si) {
    const int* sd = si == 0 ? seed0 : seed1;
    sy[si] = si < nseeds ? clampi(sd[2 * b], -clip_mv, clip_mv) : 0;
    sx[si] = si < nseeds ? clampi(sd[2 * b + 1], -clip_mv, clip_mv) : 0;
    if (si < nseeds) {
      const int ty = clampi(by + sy[si] - R * step + pad_off, 0, ref_h - W);
      const int tx = clampi(bx + sx[si] - R * step + pad_off, 0, ref_w - W);
      const int* g = ref + (long long)ty * ref_w + tx;
      int* w = s_win + si * W * W;
      for (int i = lane; i < W * W; i += 32) {
        const int r = i / W;
        cp_async4(w + i, g + (long long)r * ref_w + (i - r * W));
      }
    }
  }
  cp_async_wait_all();
  __syncwarp();

  // this lane's row band of the source block, in registers
  const int band = lane % kBands;
  int sv[kBandRows][kBlk];
#pragma unroll
  for (int r = 0; r < kBandRows; ++r) {
#pragma unroll
    for (int x = 0; x < kBlk; ++x) {
      sv[r][x] = s_src[(band * kBandRows + r) * kBlk + x];
    }
  }

  const int total = nseeds * ncand;
  int best_key = 0x7fffffff;
  int best_k = 0x7fffffff;
  for (int k0 = 0; k0 < total; k0 += kCandsPerStep) {
    const int k = k0 + lane / kBands;
    const int kc = k < total ? k : 0;  // idle lanes read a valid candidate
    const int si = kc / ncand;
    const int c = kc - si * ncand;
    const int oy = c / side;
    const int ox = c - oy * side;
    const int* w = s_win + si * W * W + (oy * step + band * kBandRows) * W +
                   ox * step;
    unsigned acc = 0;
#pragma unroll
    for (int r = 0; r < kBandRows; ++r) {
#pragma unroll
      for (int x = 0; x < kBlk; ++x) acc = __sad(w[r * W + x], sv[r][x], acc);
    }
    // sum the 4 bands: lanes 4j .. 4j+3 hold one candidate
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (k < total) {
      const int key = (int)acc * 64 + abs(oy - R) + abs(ox - R) + si;
      // a lane sees its candidates in rising k: the first minimum wins
      if (key < best_key) {
        best_key = key;
        best_k = k;
      }
    }
  }
  // first minimum over the warp: least key, then least flat index
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ok = __shfl_xor_sync(0xffffffffu, best_key, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_k, off);
    if (ok < best_key || (ok == best_key && oi < best_k)) {
      best_key = ok;
      best_k = oi;
    }
  }
  if (lane == 0) {
    const int si = best_k / ncand;
    const int c = best_k - si * ncand;
    const int oy = c / side - R;
    const int ox = c % side - R;
    out[2 * b] = (si == 0 ? sy[0] : sy[1]) + step * oy;
    out[2 * b + 1] = (si == 0 ? sx[0] : sx[1]) + step * ox;
  }
}

}  // namespace

// src: (n, 16, 16) int32, 16-byte aligned; ref: (ref_h, ref_w) int32, the
// edge-padded reference plane; base_y, base_x: (n,) int32 block origins;
// seed0, seed1: (n, 2) int32 px seeds (seed1 unused when nseeds == 1);
// out: (n, 2) int32 MVs.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int r1t_grid_search(const void* src, const void* ref,
                               const void* base_y, const void* base_x,
                               const void* seed0, const void* seed1,
                               void* out, int n, int ref_h, int ref_w,
                               int nseeds, int R, int step, int pad_off,
                               int clip_mv, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int W = kBlk + 2 * R * step;
  const size_t smem =
      (size_t)kWarps * (kBlk * kBlk + nseeds * W * W) * sizeof(int);
  const int grid = (n + kWarps - 1) / kWarps;
  grid_search_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(src), static_cast<const int*>(ref),
      static_cast<const int*>(base_y), static_cast<const int*>(base_x),
      static_cast<const int*>(seed0), static_cast<const int*>(seed1),
      static_cast<int*>(out), n, ref_h, ref_w, nseeds, R, step, pad_off,
      clip_mv);
  return (int)cudaGetLastError();
}

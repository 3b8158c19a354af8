// Full-pel SAD over a step-spaced candidate grid, for Hopper (sm_90a).
//
// Replaces: rav1e_tpu/device/pallas_kernels.py, the Pallas kernel built by
// `_sad_kernel_factory` behind `_sad_call` / `sad_grid`.  On the TPU that
// kernel holds a tile of 32 search windows resident in VMEM and unrolls the
// (2R+1)^2 candidate loop, so each window is read from HBM once instead of
// once per candidate.
//
// What bounds it on this card: bytes, then shared-memory traffic.  Each
// source block (blk^2 int32) and window (W^2 int32, W = blk + 2*R*step) is
// read from device memory once; every candidate then reads blk^2 window and
// source values again, which is why they must come from shared memory and
// not from HBM.
//
// Design: one CUDA block per ME block.  Its threads copy the source block
// and the window into shared memory (W <= 28 on the encoder's path: 28^2 *
// 4 B = 3 KB, with the 1 KB source), then stride over the candidates, one
// candidate per thread, accumulating |win - src| in a register.  R, step and
// blk are runtime ints and any n works, ragged or not.  The `*64 + tie +
// seed` argmin of me._grid_search stays in PyTorch for now.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
sad_grid_kernel(const int* __restrict__ src, const int* __restrict__ win,
                int* __restrict__ out, int blk, int W, int R, int step) {
  extern __shared__ int smem[];
  int* s_src = smem;
  int* s_win = smem + blk * blk;
  const long long b = blockIdx.x;
  const int* g_src = src + b * blk * blk;
  const int* g_win = win + b * W * W;
  for (int i = threadIdx.x; i < blk * blk; i += kThreads) s_src[i] = g_src[i];
  for (int i = threadIdx.x; i < W * W; i += kThreads) s_win[i] = g_win[i];
  __syncthreads();

  const int side = 2 * R + 1;
  const int ncand = side * side;
  for (int c = threadIdx.x; c < ncand; c += kThreads) {
    const int oy = c / side;
    const int ox = c - oy * side;
    const int* w0 = s_win + oy * step * W + ox * step;
    int acc = 0;
    for (int y = 0; y < blk; ++y) {
      const int* wr = w0 + y * W;
      const int* sr = s_src + y * blk;
#pragma unroll 8
      for (int x = 0; x < blk; ++x) acc += abs(wr[x] - sr[x]);
    }
    out[b * ncand + c] = acc;
  }
}

}  // namespace

// src: (n, blk, blk) int32; win: (n, W, W) int32 with W = blk + 2*R*step;
// out: (n, (2R+1)^2) int32.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int r1t_sad_grid(const void* src, const void* win, void* out,
                            int n, int blk, int R, int step, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int W = blk + 2 * R * step;
  const size_t smem = (size_t)(blk * blk + W * W) * sizeof(int);
  sad_grid_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(src), static_cast<const int*>(win),
      static_cast<int*>(out), blk, W, R, step);
  return (int)cudaGetLastError();
}

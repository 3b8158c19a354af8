// Hadamard SATD of the 8x8 cells of s x s blocks, for Hopper (sm_90a).
//
// Replaces: rav1e_tpu/device/pallas_kernels.py, the Pallas kernel
// `_satd_kernel` behind `_satd_call` / `satd_cells` / `satd8`.  On the TPU
// that kernel packs two 64-lane cells per 128-lane row and runs one
// 128x128 Kronecker (I2 x H8 x H8) matmul per 256-row tile on the MXU, forced
// to Precision.HIGHEST so that 10/12-bit diffs stay exact.
//
// What bounds it on this card: bytes.  Each int32 diff is read once and
// costs about 12 integer operations (two 8-point butterflies and the |.|
// sum), far below what the SMs can do per byte of HBM bandwidth.
//
// Design: one thread per 8x8 cell.  The thread loads its cell with 16-byte
// vector loads into registers and runs the row and column 8-point
// Walsh-Hadamard butterflies in int32 registers, then forms
// (sum |coeff| + 4) >> 3, the ops/dist get_satd normalisation.  The cells of
// one s x s block are consecutive threads of one CUDA block (256 threads hold
// 256 / (s/8)^2 whole blocks, s in {8, 16, 32, 64}), so the block sum is a
// segmented tree reduction in shared memory, in int32, converted to float
// once.  No matmul: the TPU needed one to reach its matrix unit; here the
// butterfly is cheaper and exact by construction.
//
// Exactness: integer throughout.  For |d| <= 4095 (12-bit) a cell's
// coefficient sum stays below 2^24 and a 64x64 block's sum below 2^28, both
// exact in int32.  The float result equals the reference's f32 path whenever
// the block sum is below 2^24: every block at 8 bit, and blocks up to 16x16
// at 12 bit.  Above that (64x64 blocks of high-bit-depth diffs) the
// reference's f32 sum over cells can round; this kernel's exact integer sum
// is then the better number, and the two can differ.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void wht8(int v[8]) {
#pragma unroll
  for (int h = 1; h < 8; h <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; i += 2 * h) {
#pragma unroll
      for (int j = i; j < i + h; ++j) {
        const int a = v[j];
        const int b = v[j + h];
        v[j] = a + b;
        v[j + h] = a - b;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
satd8_kernel(const int* __restrict__ diff, float* __restrict__ out,
             long long nblocks, int s) {
  __shared__ int part[kThreads];
  const int cpr = s >> 3;      // cells per block row
  const int cpb = cpr * cpr;   // cells per block; divides kThreads
  const int tid = threadIdx.x;
  const long long cell = (long long)blockIdx.x * kThreads + tid;
  const long long total = nblocks * cpb;

  int val = 0;
  if (cell < total) {
    const long long b = cell / cpb;
    const int c = (int)(cell - b * cpb);
    const int cy = c / cpr;
    const int cx = c - cy * cpr;
    const int* p = diff + b * s * s + (long long)(cy * 8) * s + cx * 8;
    int m[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int4 lo = *reinterpret_cast<const int4*>(p + r * s);
      const int4 hi = *reinterpret_cast<const int4*>(p + r * s + 4);
      m[r][0] = lo.x; m[r][1] = lo.y; m[r][2] = lo.z; m[r][3] = lo.w;
      m[r][4] = hi.x; m[r][5] = hi.y; m[r][6] = hi.z; m[r][7] = hi.w;
      wht8(m[r]);
    }
    int sum = 0;
#pragma unroll
    for (int col = 0; col < 8; ++col) {
      int v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = m[r][col];
      wht8(v);
#pragma unroll
      for (int r = 0; r < 8; ++r) sum += abs(v[r]);
    }
    val = (sum + 4) >> 3;
  }
  part[tid] = val;
  __syncthreads();
  // segments of cpb threads start at multiples of cpb, and total is a
  // multiple of cpb, so a segment is either wholly valid or wholly padding
  for (int off = cpb >> 1; off > 0; off >>= 1) {
    if ((tid % cpb) < off) part[tid] += part[tid + off];
    __syncthreads();
  }
  if (cell < total && (tid % cpb) == 0) out[cell / cpb] = (float)part[tid];
}

}  // namespace

// diff: (nblocks, s, s) int32, 16-byte aligned; out: (nblocks,) float32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int r1t_satd8(const void* diff, void* out, long long nblocks,
                         int s, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long cells = nblocks * (s / 8) * (s / 8);
  const long long grid = (cells + kThreads - 1) / kThreads;
  satd8_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(diff), static_cast<float*>(out), nblocks, s);
  return (int)cudaGetLastError();
}

extern "C" const char* r1t_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

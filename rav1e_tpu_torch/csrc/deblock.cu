// One deblocking pass (one orientation of one plane), for Hopper (sm_90a).
//
// Replaces: rav1e_tpu/device/dsp.py `deblock_pass_device` (:568), which the
// chain's filter program `_filters_program` (rav1e_tpu/device/chain.py:830,
// jitted in `chain_stages_jit` :954) runs six times a frame.  On the TPU it
// is part of that one XLA program: each of the 14 taps p6..q6 a whole-plane
// stride-4 slice, the 4/6/8/14-tap filters evaluated for every edge line
// and selected elementwise, and the 12 deltas added back by strided
// scatters.
//
// What bounds it on this card: bytes.  A pass reads the plane once and its
// edge-size grid, writes the plane once (the copy the wrapper makes, then
// the changed samples), and each edge line costs about 10^2 integer
// operations for its 14 samples: about 7 a sample.
//
// Design: one thread per edge line, (row, edge) for vertical edges and
// (edge row, column) for horizontal ones, column fastest, so that the
// threads of a warp read neighbouring addresses.  The thread reads its 14
// taps from the unfiltered input plane into registers, skips lines whose
// edge size is 0, evaluates only the filter its size selects (with the
// level from its 0-d device tensor, so a graph replay reads the frame's
// level), and adds each changed tap's delta into the output, a copy of the
// input.  Taps k and k+4 of neighbouring edges are the same samples; AV1's
// filter-size caps keep the samples two edges of one orientation change
// apart (ops/deblock.py module doc), and the adds are atomic, so the output
// is the plain version's sum of deltas whatever the order.
//
// Exactness: integer throughout, the plain version's operations
// (dsp.py `deblock_taps14`); Python's floor division of a negative number
// is written out where it occurs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 8;  // the plane's padding on each side

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int ceil_shift(int v, int shift) {
  return shift ? (v + (1 << shift) - 1) >> shift : v;
}

// floor(v / 3) for v >= -2
__device__ __forceinline__ int floor_div3(int v) {
  return v >= 0 ? v / 3 : -1;
}

// the filter level a mask of these sample differences needs
__device__ __forceinline__ int mask_level(int m, int p1, int p0, int q0,
                                          int q1, int shift) {
  const int blimit = abs(p0 - q0) * 2 + abs(p1 - q1) / 2;
  return max(ceil_shift(m, shift), floor_div3(ceil_shift(blimit, shift) - 2));
}

// The 12 filtered taps p5..q5 of the 14 taps c = p6..q6 of one edge line,
// at filter size fs (dsp.py `deblock_taps14`).
__device__ void filter14(const int c[14], int level, int bd, int fs,
                         int o[12]) {
  const int shift = bd - 8;
  const int flat_t = 1 << shift;
  const int p6 = c[0], p5 = c[1], p4 = c[2], p3 = c[3], p2 = c[4], p1 = c[5],
            p0 = c[6], q0 = c[7], q1 = c[8], q2 = c[9], q3 = c[10],
            q4 = c[11], q5 = c[12], q6 = c[13];
#pragma unroll
  for (int i = 0; i < 12; ++i) o[i] = c[i + 1];

  const int d10 = abs(p1 - p0), e10 = abs(q1 - q0);
  const int d21 = abs(p2 - p1), e21 = abs(q2 - q1);
  const int d32 = abs(p3 - p2), e32 = abs(q3 - q2);
  bool on;
  if (fs == 4) {
    on = mask_level(max(d10, e10), p1, p0, q0, q1, shift) <= level;
  } else if (fs == 6) {
    on = mask_level(max(max(d21, d10), max(e21, e10)), p1, p0, q0, q1,
                    shift) <= level;
  } else if (fs == 8 || fs == 14) {
    on = mask_level(max(max(max(d32, d21), d10), max(max(e32, e21), e10)),
                    p1, p0, q0, q1, shift) <= level;
  } else {
    return;
  }
  if (!on) return;

  // the narrow filter's p1, p0, q0, q1
  const int lo = -(128 << shift), hi = (128 << shift) - 1;
  const int pix_hi = (256 << shift) - 1;
  int nar[4];
  const bool use4 = (ceil_shift(max(d10, e10), shift) << 4) <= level;
  if (use4) {
    const int base4 = 3 * (q0 - p0);
    const int f1 = clampi(base4 + 4, lo, hi) >> 3;
    const int f2 = clampi(base4 + 3, lo, hi) >> 3;
    const int f3 = (f1 + 1) >> 1;
    nar[0] = clampi(p1 + f3, 0, pix_hi);
    nar[1] = clampi(p0 + f2, 0, pix_hi);
    nar[2] = clampi(q0 - f1, 0, pix_hi);
    nar[3] = clampi(q1 - f3, 0, pix_hi);
  } else {
    const int base2 = clampi(p1 - q1, lo, hi) + 3 * (q0 - p0);
    const int f1 = clampi(base2 + 4, lo, hi) >> 3;
    const int f2 = clampi(base2 + 3, lo, hi) >> 3;
    nar[0] = p1;
    nar[1] = clampi(p0 + f2, 0, pix_hi);
    nar[2] = clampi(q0 - f1, 0, pix_hi);
    nar[3] = q1;
  }
  const int flat6m = max(max(d10, e10), max(abs(p2 - p0), abs(q2 - q0)));
  const bool flat6 = flat6m <= flat_t;
  const bool flat8 = max(flat6m, max(abs(p3 - p0), abs(q3 - q0))) <= flat_t;

  if (fs == 4 || (fs == 6 && !flat6) || ((fs == 8 || fs == 14) && !flat8)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[4 + i] = nar[i];
    return;
  }
  if (fs == 6) {
    o[4] = (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3;
    o[5] = (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3;
    o[6] = (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3;
    o[7] = (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3;
    return;
  }
  const bool flat_out =
      max(max(max(abs(p4 - p0), abs(q4 - q0)), max(abs(p5 - p0), abs(q5 - q0))),
          max(abs(p6 - p0), abs(q6 - q0))) <= flat_t;
  if (fs == 8 || !flat_out) {
    o[3] = (p3 * 3 + p2 * 2 + p1 + p0 + q0 + 4) >> 3;
    o[4] = (p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1 + 4) >> 3;
    o[5] = (p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2 + 4) >> 3;
    o[6] = (p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3 + 4) >> 3;
    o[7] = (p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2 + 4) >> 3;
    o[8] = (p0 + q0 + q1 + q2 * 2 + q3 * 3 + 4) >> 3;
    return;
  }
  o[0] = (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4;
  o[1] = (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + 8) >> 4;
  o[2] = (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2 +
          8) >> 4;
  o[3] = (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 +
          q3 + 8) >> 4;
  o[4] = (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 +
          q3 + q4 + 8) >> 4;
  o[5] = (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 +
          q4 + q5 + 8) >> 4;
  o[6] = (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 +
          q5 + q6 + 8) >> 4;
  o[7] = (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 +
          q6 * 2 + 8) >> 4;
  o[8] = (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 +
          q6 * 3 + 8) >> 4;
  o[9] = (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4 +
          8) >> 4;
  o[10] = (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 + 8) >> 4;
  o[11] = (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4;
}

// rec, out: (hp, wp) int32 planes padded by kPad; fsize: (rows_p, cols_p)
// int32 edge sizes per 4x4 cell; the level at *level_ptr, or level_val when
// level_ptr is null.
__global__ void __launch_bounds__(kThreads)
deblock_edges_kernel(const int* __restrict__ rec, int* __restrict__ out,
                     const int* __restrict__ fsize,
                     const int* __restrict__ level_ptr, int level_val, int wp,
                     int rows_p, int cols_p, int bd, int vertical) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long base;
  int step, fs;
  if (vertical) {
    // (row r, edge i): tap k at column kPad + 4i + k - 7
    if (t >= 4LL * rows_p * cols_p) return;
    const int r = (int)(t / cols_p), i = (int)(t % cols_p);
    fs = fsize[(r >> 2) * cols_p + i];
    base = (long long)(kPad + r) * wp + kPad + 4 * i - 7;
    step = 1;
  } else {
    // (edge row i, column c): tap k at row kPad + 4i + k - 7
    const int pw = 4 * cols_p;
    if (t >= (long long)rows_p * pw) return;
    const int i = (int)(t / pw), c = (int)(t % pw);
    fs = fsize[i * cols_p + (c >> 2)];
    base = (long long)(kPad + 4 * i - 7) * wp + kPad + c;
    step = wp;
  }
  if (fs == 0) return;
  const int level = level_ptr ? *level_ptr : level_val;
  int c[14];
#pragma unroll
  for (int k = 0; k < 14; ++k) c[k] = rec[base + (long long)k * step];
  int o[12];
  filter14(c, level, bd, fs, o);
#pragma unroll
  for (int k = 1; k < 13; ++k) {
    const int d = o[k - 1] - c[k];
    if (d != 0) atomicAdd(out + base + (long long)k * step, d);
  }
}

}  // namespace

// One pass into `out`, which holds a copy of `rec`.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int r1t_deblock_edges(const void* rec, void* out, const void* fsize,
                                 const void* level_ptr, int level_val, int wp,
                                 int rows_p, int cols_p, int bd, int vertical,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long lines = 4LL * rows_p * cols_p;
  deblock_edges_kernel<<<(unsigned)((lines + kThreads - 1) / kThreads),
                         kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(rec), static_cast<int*>(out),
      static_cast<const int*>(fsize), static_cast<const int*>(level_ptr),
      level_val, wp, rows_p, cols_p, bd, vertical);
  return (int)cudaGetLastError();
}

// Disparity-sweep stereo warp for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   metric_depth_video_toolbox_tpu/ops/warp_pallas.py
//   _make_sweep_kernel / disparity_sweep
// and computes the same function: for every target pixel of a row, sweep
// the depth planes front to back; at plane p the source sample is the
// padded source row read at x + disp_int[p] + pad_left with a linear blend
// of that pixel and its right neighbour by disp_frac[p]. The first plane
// whose blended depth d satisfies |d - z_p| < tol_p and d > 1e-3 wins; its
// depth and blended payload channels are written, with found = 1. A plane
// whose (64-row tile, plane) activity bit is 0 is skipped.
//
// What bounds it on the H100. It writes z, C payload floats and a flag
// per pixel (35 MB per 1080p frame-eye for the main sweep, C = 3; 60 MB
// for the anchor sweep, C = 6) and needs to read only the depth columns
// its tests reach and the payload columns its hits blend: on
// chip_smoke.py's 1080p inputs ~66 and ~85 MB per frame-eye in all, 20
// and 26 us at 3.35 TB/s (chip_smoke.py::sweep_work counts this for the
// inputs it is given). The plane loop is ALU work: per (pixel, active
// plane) test 6 float32 and 2 float64 operations (the blend's rounding,
// below), up to the pixel's first hit. At full activity and 128 planes
// that is ~50 us per frame-eye at the card's 67 (float32) and 34
// (float64) TFLOP/s; on piecewise-smooth depth the activity bitmap leaves
// a few planes per tile and the bytes bound it.
//
// What the design does about that. One block per (batch element, row):
// the depth row and the per-plane constants are staged in shared memory
// once, so the plane loop reads no device memory at all. Threads stride
// over x (neighbouring threads read neighbouring shared words, no bank
// conflicts). A pixel stops at its first hit, which is exact because a
// later plane can never overwrite a hit; only then are its C payload
// channels read from device memory. The TPU kernel's 128-lane alignment
// trick (aligned slice + roll) is not needed: a shifted read is an offset
// read here.
//
// Rounding. The blend (1 - f) * a + f * b is rounded as one fused
// multiply-add, fma(1 - f, a, f * b), which is how XLA evaluates the JAX
// kernel's lerp: 1 - f and f * b in float32, then (1 - f) * a (exact in
// float64) plus f * b in float64, rounded once to float32. The plain
// PyTorch version (warp_sweep.blend) runs the same float64 expression as
// separate elementwise ops, and every other operation here is rounded on
// its own (__*_rn intrinsics, -fmad=false), so the kernel equals the plain
// version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInfDepth = 3.0e38f;
constexpr int kThreads = 256;

__device__ __forceinline__ float blend(float a, float b, float f) {
  const double prod = __dmul_rn(static_cast<double>(__fsub_rn(1.0f, f)),
                                static_cast<double>(a));
  return __double2float_rn(
      __dadd_rn(prod, static_cast<double>(__fmul_rn(f, b))));
}

__device__ __forceinline__ float read_or_zero(const float* row, int i,
                                              int n) {
  return (i >= 0 && i < n) ? row[i] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ depth_pad,
             const float* __restrict__ color_pad,
             const int* __restrict__ disp_int,
             const float* __restrict__ disp_frac,
             const float* __restrict__ plane_z,
             const float* __restrict__ plane_tol,
             const int* __restrict__ active,
             float* __restrict__ out_z,
             float* __restrict__ out_color,
             uint8_t* __restrict__ out_found,
             int H, int W, int WP, int C, int P, int pad_left, int ntiles,
             int block_rows) {
  extern __shared__ float smem[];
  float* row = smem;                                   // WP
  int* s_d0 = reinterpret_cast<int*>(row + WP);        // P
  float* s_f = reinterpret_cast<float*>(s_d0 + P);     // P
  float* s_z = s_f + P;                                // P
  float* s_tol = s_z + P;                              // P
  int* s_act = reinterpret_cast<int*>(s_tol + P);      // P

  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = y / block_rows;
  const float* drow = depth_pad + (static_cast<size_t>(b) * H + y) * WP;
  for (int i = threadIdx.x; i < WP; i += blockDim.x) row[i] = drow[i];
  const size_t pb = static_cast<size_t>(b) * P;
  const size_t ab = (static_cast<size_t>(b) * ntiles + tile) * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    s_d0[p] = disp_int[pb + p] + pad_left;
    s_f[p] = disp_frac[pb + p];
    s_z[p] = plane_z[pb + p];
    s_tol[p] = plane_tol[pb + p];
    s_act[p] = active[ab + p];
  }
  __syncthreads();

  const size_t out_row = (static_cast<size_t>(b) * H + y) * W;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    float best = kInfDepth;
    int hit = -1;
    for (int p = 0; p < P; ++p) {
      if (s_act[p] == 0) continue;
      const int s = x + s_d0[p];
      const float d = blend(read_or_zero(row, s, WP),
                            read_or_zero(row, s + 1, WP), s_f[p]);
      if (fabsf(__fsub_rn(d, s_z[p])) < s_tol[p] && d > 1e-3f) {
        best = d;
        hit = p;
        break;
      }
    }
    const size_t o = out_row + x;
    out_z[o] = best;
    out_found[o] = hit >= 0 ? 1 : 0;
    float* oc = out_color + o * C;
    if (hit < 0) {
      for (int ch = 0; ch < C; ++ch) oc[ch] = 0.0f;
      continue;
    }
    const int s = x + s_d0[hit];
    const float f = s_f[hit];
    for (int ch = 0; ch < C; ++ch) {
      const float* crow =
          color_pad + ((static_cast<size_t>(b) * C + ch) * H + y) * WP;
      oc[ch] = blend(read_or_zero(crow, s, WP), read_or_zero(crow, s + 1, WP),
                     f);
    }
  }
}

}  // namespace

// depth_pad (B, H, WP) f32; color_pad (B, C, H, WP) f32; disp_int (B, P)
// i32; disp_frac, plane_z, plane_tol (B, P) f32; active (B, ntiles, P) i32.
// Outputs: out_z (B, H, W) f32, out_color (B, H, W, C) f32, out_found
// (B, H, W) u8. Launches on `stream`; returns cudaGetLastError().
extern "C" int mdvt_disparity_sweep(
    const float* depth_pad, const float* color_pad, const int* disp_int,
    const float* disp_frac, const float* plane_z, const float* plane_tol,
    const int* active, float* out_z, float* out_color, uint8_t* out_found,
    int B, int H, int W, int WP, int C, int P, int pad_left, int ntiles,
    int block_rows, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const size_t smem = static_cast<size_t>(WP) * sizeof(float) +
                      static_cast<size_t>(P) * 5 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(H, B);
  sweep_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      depth_pad, color_pad, disp_int, disp_frac, plane_z, plane_tol, active,
      out_z, out_color, out_found, H, W, WP, C, P, pad_left, ntiles,
      block_rows);
  return static_cast<int>(cudaGetLastError());
}

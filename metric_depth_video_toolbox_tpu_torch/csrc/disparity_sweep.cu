// Disparity-sweep stereo warp (B1) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   metric_depth_video_toolbox_tpu/ops/warp_pallas.py
//   _make_sweep_kernel / disparity_sweep
// and computes the same function: one depth stream swept front to back
// over P disparity planes, the first plane whose blended depth d has
// |d - z_p| < tol_p and d > 1e-3 giving z, the C payload channels blended
// at the same column, and found = 1; a plane whose (64-row tile, plane)
// activity bit is 0 is skipped. It runs on the sweep core of
// sweep_sm90.cuh, which says what bounds it on the H100 and what the
// design does about that; this file gives the core its stream layout.

#include "sweep_sm90.cuh"

// depth_pad (B, H, WP) f32; color_pad (B, C, H, WP) f32; disp_int (B, P)
// i32; disp_frac, plane_z, plane_tol (B, P) f32; active (B, ntiles, P) i32.
// Outputs: out_z (B, H, W) f32, out_color (B, H, W, C) f32, out_found
// (B, H, W) u8. Launches on `stream`; returns cudaGetLastError() (or
// cudaErrorInvalidValue when a row ring does not fit in shared memory).
extern "C" int mdvt_disparity_sweep(
    const float* depth_pad, const float* color_pad, const int* disp_int,
    const float* disp_frac, const float* plane_z, const float* plane_tol,
    const int* active, float* out_z, float* out_color, uint8_t* out_found,
    int B, int H, int W, int WP, int C, int P, int pad_left, int ntiles,
    int block_rows, void* stream) {
  mdvt_sweep::Params p = {};
  p.B = B;
  p.H = H;
  p.W = W;
  p.WP = WP;
  p.P = P;
  p.pad_left = pad_left;
  p.ntiles = ntiles;
  p.block_rows = block_rows;
  p.disp_int = disp_int;
  p.disp_frac = disp_frac;
  p.plane_z = plane_z;
  p.plane_tol = plane_tol;
  p.payload[0] = color_pad;
  p.payload_n[0] = C;
  p.s[0].depth = depth_pad;
  p.s[0].active = active;
  p.s[0].out_z = out_z;
  p.s[0].out_found = out_found;
  p.s[0].out_pay[0] = C > 0 ? out_color : nullptr;
  return mdvt_sweep::launch<1>(p, static_cast<cudaStream_t>(stream));
}

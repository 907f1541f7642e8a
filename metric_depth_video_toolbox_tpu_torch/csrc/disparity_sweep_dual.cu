// Fused main + edge-anchor disparity sweep (B2) for Hopper (sm_90a), plain
// C interface.
//
// Replaces the Pallas TPU kernel
//   metric_depth_video_toolbox_tpu/ops/warp_pallas.py
//   _make_dual_sweep_kernel / disparity_sweep_dual
// and computes the same function: two depth streams (the edge-culled main
// depth and the edge-only depth) share one plane set and one disparity per
// plane. Main surface: the first plane whose blended main depth d has
// |d - z_p| < tol_p and d > 1e-3 gives z and the S shared payload
// channels. Anchor surface: the first plane whose blended edge depth passes
// the same test gives the S shared and the E extra payload channels. Each
// stream has its own (32-row tile, plane) activity bitmap. A stream's first
// hit does not depend on the other's, so on the sweep core of
// sweep_sm90.cuh (which says what bounds it and what the design does about
// that) each stream sweeps its own plane list over the same staged rows;
// this file gives the core its stream layout.

#include "sweep_sm90.cuh"

// depth_pad, edepth_pad (B, H, WP) f32; shared_pad (B, S, H, WP) and
// extra_pad (B, E, H, WP) f32; disp_int (B, P) i32; disp_frac, plane_z,
// plane_tol (B, P) f32; active_main, active_edge (B, ntiles, P) i32 over
// row tiles of block_rows rows. Outputs: out_z (B, H, W) f32, out_main
// (B, H, W, S) f32, out_found (B, H, W) u8, out_eshared (B, H, W, S) f32,
// out_eextra (B, H, W, E) f32, out_efound (B, H, W) u8. Launches on
// `stream`; returns cudaGetLastError() (or cudaErrorInvalidValue when a
// row ring does not fit in shared memory).
extern "C" int mdvt_disparity_sweep_dual(
    const float* depth_pad, const float* edepth_pad, const float* shared_pad,
    const float* extra_pad, const int* disp_int, const float* disp_frac,
    const float* plane_z, const float* plane_tol, const int* active_main,
    const int* active_edge, float* out_z, float* out_main,
    uint8_t* out_found, float* out_eshared, float* out_eextra,
    uint8_t* out_efound, int B, int H, int W, int WP, int S, int E, int P,
    int pad_left, int ntiles, int block_rows, void* stream) {
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
  p.payload[0] = shared_pad;
  p.payload_n[0] = S;
  p.payload[1] = extra_pad;
  p.payload_n[1] = E;
  // the main stream: z, found, the shared payload
  p.s[0].depth = depth_pad;
  p.s[0].active = active_main;
  p.s[0].out_z = out_z;
  p.s[0].out_found = out_found;
  p.s[0].out_pay[0] = S > 0 ? out_main : nullptr;
  // the edge stream: found, the shared and the extra payload
  p.s[1].depth = edepth_pad;
  p.s[1].active = active_edge;
  p.s[1].out_found = out_efound;
  p.s[1].out_pay[0] = S > 0 ? out_eshared : nullptr;
  p.s[1].out_pay[1] = E > 0 ? out_eextra : nullptr;
  return mdvt_sweep::launch<2>(p, static_cast<cudaStream_t>(stream));
}

// Fused main + edge-anchor disparity sweep for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel
//   metric_depth_video_toolbox_tpu/ops/warp_pallas.py
//   _make_dual_sweep_kernel / disparity_sweep_dual
// and computes the same function: two depth streams (the edge-culled main
// depth and the edge-only depth) share one plane set and one disparity per
// plane. For every target pixel the planes are swept front to back; at
// plane p a stream's sample is its padded source row read at
// x + disp_int[p] + pad_left, blended with its right neighbour by
// disp_frac[p]. Main surface: the first plane whose blended main depth d
// has |d - z_p| < tol_p and d > 1e-3 gives z and the S shared payload
// channels. Anchor surface: the first plane whose blended edge depth passes
// the same test gives the S shared and the E extra payload channels. Each
// stream has its own (row tile, plane) activity bitmap; a plane whose bit is
// 0 is not tested for that stream.
//
// What bounds it on the H100. It writes z, 2 S + E payload floats and two
// flags per pixel and needs to read only the depth columns its tests reach
// and the payload columns its hits blend (chip_smoke.py::sweep_work counts
// both streams on the inputs it is given); the plane loop is ALU work, 6
// float32 and 2 float64 operations per (pixel, stream, active plane) test
// up to that stream's first hit. On piecewise-smooth depth the bitmaps
// leave a few planes per tile and the bytes bound it, as for the single
// sweep.
//
// What the design does about that. One block per (batch element, row), as
// in disparity_sweep.cu: both depth rows and the per-plane constants are
// staged in shared memory once, the two bitmaps packed into one word per
// plane, so the plane loop reads no device memory. Each stream of a pixel
// stops at its own first hit (exact: a hit is never overwritten), the loop
// ends when both have hit, and only then are the hit planes' payload
// channels read. The TPU kernel's 32-row blocks are a VMEM budget; here the
// bitmap's row tile is an argument and the blocking is a row.
//
// Rounding: the blend is disparity_sweep.cu's, fma(1 - f, a, f * b)
// evaluated as float64 and rounded once, every other operation rounded on
// its own (-fmad=false), so the main surface equals the single sweep's and
// the whole equals the plain PyTorch version (warp_sweep.
// disparity_sweep_dual_plain) bit for bit.

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

// the payload channels of one hit: C planes of src (B, C, H, WP) blended at
// column s, written to dst[0..C)
__device__ __forceinline__ void blend_payload(const float* __restrict__ src,
                                              float* __restrict__ dst, int b,
                                              int C, int H, int y, int WP,
                                              int s, float f) {
  for (int ch = 0; ch < C; ++ch) {
    const float* crow = src + ((static_cast<size_t>(b) * C + ch) * H + y) * WP;
    dst[ch] = blend(read_or_zero(crow, s, WP), read_or_zero(crow, s + 1, WP),
                    f);
  }
}

__global__ void __launch_bounds__(kThreads)
dual_sweep_kernel(const float* __restrict__ depth_pad,
                  const float* __restrict__ edepth_pad,
                  const float* __restrict__ shared_pad,
                  const float* __restrict__ extra_pad,
                  const int* __restrict__ disp_int,
                  const float* __restrict__ disp_frac,
                  const float* __restrict__ plane_z,
                  const float* __restrict__ plane_tol,
                  const int* __restrict__ active_main,
                  const int* __restrict__ active_edge,
                  float* __restrict__ out_z, float* __restrict__ out_main,
                  uint8_t* __restrict__ out_found,
                  float* __restrict__ out_eshared,
                  float* __restrict__ out_eextra,
                  uint8_t* __restrict__ out_efound,
                  int H, int W, int WP, int S, int E, int P, int pad_left,
                  int ntiles, int block_rows) {
  extern __shared__ float smem[];
  float* row_m = smem;                                 // WP
  float* row_e = row_m + WP;                           // WP
  int* s_d0 = reinterpret_cast<int*>(row_e + WP);      // P
  float* s_f = reinterpret_cast<float*>(s_d0 + P);     // P
  float* s_z = s_f + P;                                // P
  float* s_tol = s_z + P;                              // P
  int* s_act = reinterpret_cast<int*>(s_tol + P);      // P: bit 0 main, 1 edge

  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = y / block_rows;
  const size_t in_row = (static_cast<size_t>(b) * H + y) * WP;
  for (int i = threadIdx.x; i < WP; i += blockDim.x) {
    row_m[i] = depth_pad[in_row + i];
    row_e[i] = edepth_pad[in_row + i];
  }
  const size_t pb = static_cast<size_t>(b) * P;
  const size_t ab = (static_cast<size_t>(b) * ntiles + tile) * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    s_d0[p] = disp_int[pb + p] + pad_left;
    s_f[p] = disp_frac[pb + p];
    s_z[p] = plane_z[pb + p];
    s_tol[p] = plane_tol[pb + p];
    s_act[p] = (active_main[ab + p] != 0 ? 1 : 0) |
               (active_edge[ab + p] != 0 ? 2 : 0);
  }
  __syncthreads();

  const size_t out_row = (static_cast<size_t>(b) * H + y) * W;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    float best = kInfDepth;
    int hit_m = -1, hit_e = -1;
    for (int p = 0; p < P; ++p) {
      // streams still looking for their first hit on this active plane
      const int todo = s_act[p] & ((hit_m < 0 ? 1 : 0) | (hit_e < 0 ? 2 : 0));
      if (todo == 0) continue;
      const int s = x + s_d0[p];
      const float f = s_f[p];
      if (todo & 1) {
        const float d = blend(read_or_zero(row_m, s, WP),
                              read_or_zero(row_m, s + 1, WP), f);
        if (fabsf(__fsub_rn(d, s_z[p])) < s_tol[p] && d > 1e-3f) {
          best = d;
          hit_m = p;
        }
      }
      if (todo & 2) {
        const float d = blend(read_or_zero(row_e, s, WP),
                              read_or_zero(row_e, s + 1, WP), f);
        if (fabsf(__fsub_rn(d, s_z[p])) < s_tol[p] && d > 1e-3f) hit_e = p;
      }
      if (hit_m >= 0 && hit_e >= 0) break;
    }
    const size_t o = out_row + x;
    out_z[o] = best;
    out_found[o] = hit_m >= 0 ? 1 : 0;
    out_efound[o] = hit_e >= 0 ? 1 : 0;
    float* om = out_main + o * S;
    float* oes = out_eshared + o * S;
    float* oee = out_eextra + o * E;
    if (hit_m >= 0) {
      blend_payload(shared_pad, om, b, S, H, y, WP, x + s_d0[hit_m],
                    s_f[hit_m]);
    } else {
      for (int ch = 0; ch < S; ++ch) om[ch] = 0.0f;
    }
    if (hit_e >= 0) {
      const int s = x + s_d0[hit_e];
      const float f = s_f[hit_e];
      blend_payload(shared_pad, oes, b, S, H, y, WP, s, f);
      blend_payload(extra_pad, oee, b, E, H, y, WP, s, f);
    } else {
      for (int ch = 0; ch < S; ++ch) oes[ch] = 0.0f;
      for (int ch = 0; ch < E; ++ch) oee[ch] = 0.0f;
    }
  }
}

}  // namespace

// depth_pad, edepth_pad (B, H, WP) f32; shared_pad (B, S, H, WP) and
// extra_pad (B, E, H, WP) f32; disp_int (B, P) i32; disp_frac, plane_z,
// plane_tol (B, P) f32; active_main, active_edge (B, ntiles, P) i32 over
// row tiles of block_rows rows. Outputs: out_z (B, H, W) f32, out_main
// (B, H, W, S) f32, out_found (B, H, W) u8, out_eshared (B, H, W, S) f32,
// out_eextra (B, H, W, E) f32, out_efound (B, H, W) u8. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int mdvt_disparity_sweep_dual(
    const float* depth_pad, const float* edepth_pad, const float* shared_pad,
    const float* extra_pad, const int* disp_int, const float* disp_frac,
    const float* plane_z, const float* plane_tol, const int* active_main,
    const int* active_edge, float* out_z, float* out_main,
    uint8_t* out_found, float* out_eshared, float* out_eextra,
    uint8_t* out_efound, int B, int H, int W, int WP, int S, int E, int P,
    int pad_left, int ntiles, int block_rows, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const size_t smem = static_cast<size_t>(WP) * 2 * sizeof(float) +
                      static_cast<size_t>(P) * 5 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dual_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(H, B);
  dual_sweep_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      depth_pad, edepth_pad, shared_pad, extra_pad, disp_int, disp_frac,
      plane_z, plane_tol, active_main, active_edge, out_z, out_main,
      out_found, out_eshared, out_eextra, out_efound, H, W, WP, S, E, P,
      pad_left, ntiles, block_rows);
  return static_cast<int>(cudaGetLastError());
}

// The disparity-sweep core for Hopper (sm_90a) that both sweep kernels of
// this directory run on: disparity_sweep.cu (B1, one depth stream) and
// disparity_sweep_dual.cu (B2, a main and an edge-anchor stream that share
// the planes and the payload). CUDA headers and PTX only.
//
// What it computes. For every target pixel x of a row and every stream:
// the planes are swept front to back; at plane p the sample is the stream's
// padded depth row read at s = x + disp_int[p] + pad_left and s + 1 (zero
// outside [0, WP)), blended by f = disp_frac[p] (`blend`, below). The first
// plane whose blended depth d has |d - z_p| < tol_p and d > 1e-3 wins: the
// stream writes d (B1 and B2's main stream), found = 1 and its payload
// channels blended at the same column. A plane whose (row tile, plane)
// activity bit is 0 is not tested for that stream. No hit: z = 3e38,
// found = 0, payload 0.
//
// What bounds it on the H100. On the stereo step's 1080p frames the bytes:
// 17 bytes of output per pixel for the main sweep, the depth rows once and
// the payload columns that hits blend. The plane loop is what kept the
// per-row kernels this replaces far from that bound (PERF.md, section 6): each
// pixel walked all P planes to find the active ones, and every active
// test ran the float64 blend (four F2F conversions at 16 a clock per SM).
// The design does this about it:
//
// - Compacted plane lists. For each work unit (batch element, band of
//   kBand rows inside one bitmap tile) and stream, the producer warp builds
//   the list of active planes once, in shared memory, with warp ballots,
//   and with each entry its column offset, f and pre-test thresholds. A
//   pixel loops over its stream's list only, software-pipelined (entry
//   k + 1's samples and entry k + 2's constants load while entry k is
//   tested). Lists are double-buffered, so the producer builds unit
//   u + 1's while the consumers sweep unit u. Each stream of B2 sweeps its
//   own list over the same staged rows: a stream's first hit does not
//   depend on the other's.
// - An exact float32 pre-test before the float64 blend. With f in [0, 1],
//   e = fma(f, f32(b - a), a) differs from the blend by at most 5.5 * 2^-24
//   M, M = max(|a|, |b|): b - a rounds by 2^-23 M, the FMA once more by
//   2^-24 M; the blend itself (1 - f rounded by 2^-25, f * b by 2^-24, the
//   float64 sum and the final rounding) by 2.5 * 2^-24 M. With m = 2^-19 M
//   (16 * 2^-24 M), L = fma(-2^-19, M, e) and U = fma(2^-19, M, e), each
//   rounded once (2^-24 M more), bound the blend to within subnormal
//   rounding (a few 2^-150). A plane is rejected without the blend when
//   L >= hiZ or U <= lowZ, where hiZ = (z + tol rounded up) + 2^-120
//   rounded up and lowZ = max(z - tol rounded down, 1e-3f) - 2^-120 rounded
//   down, once per entry: then d >= hiZ - 2^-120 + (margin left) >= z +
//   tol, so d - z >= tol and |fl(d - z)| >= tol (rounding is monotone and
//   tol a float); the same from below, and d <= 1e-3f fails d > 1e-3f.
//   NaN and infinity only make L and U NaN or wider, which rejects
//   nothing. A plane with f
//   outside [0, 1] (or NaN) gets hiZ = +inf, lowZ = -inf. Every plane that
//   passes goes through the unchanged float64 blend and test, so the
//   kernels equal their plain versions bit for bit
//   (ops/warp_sweep.py::sweep_pretest is the predicate's twin). An
//   interval test on [min(a, b), max(a, b)] alone would pass every nearer
//   plane wherever a sample's neighbour is a culled (zero) pixel; this
//   estimate passes little more than the hits.
// - The float64 blend with three conversions: (1 - f) as a double is
//   stored per entry, and (1 - f) a + f b is one DFMA, whose product is
//   exact in float64, so it rounds as the DMUL + DADD of the plain version.
// - Persistent blocks, bulk-copied rows. One producer warp and
//   kConsumerWarps consumer warps per block; the block walks work units
//   blockIdx.x, + gridDim.x, .... For every image row the producer copies
//   the stream depth rows into a ring of kStages stages by cp.async.bulk,
//   one per row, completing on the stage's "full" mbarrier; consumers
//   release a stage on its "empty" mbarrier, one arrival per warp. Rows
//   whose width or address is not a multiple of 16 bytes are copied by the
//   producer's lanes.
// - Consumer warps take 32-pixel chunks of a row from a counter in shared
//   memory (reset by the producer with the row), so a row's cost is spread
//   over the warps whatever its chunks ask; no block-wide barrier after
//   setup.
// - Payload: a hit blends its C channels from device memory at its column
//   (neighbouring pixels on one surface read neighbouring columns); whole
//   payload rows are not staged: on the stereo step's frames the hits
//   need far fewer columns than WP (under half for the anchor sweep), and
//   staging them cost more than it saved in development runs. A lane
//   issues the loads of kPayBatch channels before it blends any.
// - Stores: z and found one coalesced word or byte per lane; the payload
//   channels of a chunk are staged per warp and written as one contiguous
//   run of 4-byte stores (the (W, C) interleaved layout).
// - Bounds: when every entry of a unit's list keeps s and s + 1 inside the
//   padded row for all x (the stereo step's padding guarantees it), the
//   loop reads the staged row with no test; otherwise a checked variant
//   of the same loop runs for that unit.
//
// Rounding: the blend is fma(1 - f, a, f * b) evaluated in float64 and
// rounded once, as XLA rounds the JAX kernel's lerp; every other operation
// is rounded on its own (__*_rn, built with -fmad=false).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mdvt_sweep {

constexpr float kInfDepth = 3.0e38f;
constexpr int kConsumerWarps = 15;
constexpr int kMinBlocks = 2;         // per SM, for ptxas's register budget
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kBand = 4;              // rows per work unit
constexpr int kStages = 2;            // rows in flight per block
constexpr int kMaxStreams = 2;
constexpr int kPayBatch = 3;          // payload channels loaded at once
constexpr float kPreMargin = 0x1p-19f;
constexpr float kPreSlack = 0x1p-120f;
constexpr int kSmemLimit = 232448;    // what one block may use

// One depth stream: its rows, bitmap and outputs. Output j blends the
// channels of payload tensor j.
struct Stream {
  const float* depth;       // (B, H, WP)
  const int* active;        // (B, ntiles, P)
  float* out_z;             // (B, H, W), or null
  uint8_t* out_found;       // (B, H, W)
  float* out_pay[2];        // (B, H, W, payload_n[j]), or null
};

struct Params {
  int B, H, W, WP, P, pad_left, ntiles, block_rows;
  const int* disp_int;      // (B, P)
  const float* disp_frac;   // (B, P)
  const float* plane_z;     // (B, P)
  const float* plane_tol;   // (B, P)
  const float* payload[2];  // (B, n, H, WP) channel-planar, or null
  int payload_n[2];
  Stream s[kMaxStreams];
  // set by launch()
  int pitch;                // floats per staged row (WP rounded up to 4)
  int max_pay;
  int bulk;
  int units_per_tile;
  int units;
};

// the exact test's constants of a list entry: (1 - f) as a double, z, tol
struct __align__(16) Exact {
  double g;
  float z, tol;
};

// Shared memory: mbarriers (full, empty: kStages each; list full, list
// empty: two each), list headers (n, checked) per (slot, stream), the
// chunk counters, the lists
// (pre-test entries and exact constants, P + 2 each: two zero entries end
// a list), the per-warp payload staging, the ring.
struct Layout {
  int hdr, counter, pre, exact, staging, rows, bytes;
  __host__ __device__ Layout(const Params& p, int streams) {
    hdr = (8 * (2 * kStages + 4) + 15) / 16 * 16;
    counter = hdr + 8 * 2 * kMaxStreams;
    pre = (counter + 4 * kStages + 15) / 16 * 16;
    const int lists = 2 * streams * (p.P + 2) * 16;
    exact = pre + lists;
    staging = exact + lists;
    rows = staging + kConsumerWarps * 32 * p.max_pay * 4;
    rows = (rows + 127) / 128 * 128;
    bytes = rows + kStages * streams * p.pitch * 4;
  }
};

// ------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// --------------------------------------------------------- arithmetic ----

// (1 - f) a + f b rounded as fma(1 - f, a, f * b): g = (double)(1 - f)
// rounded in float32; g * a is exact in float64, so one DFMA rounds the
// sum as the plain version's DMUL + DADD
__device__ __forceinline__ float blend(float a, float b, float f, double g) {
  return __double2float_rn(__fma_rn(g, static_cast<double>(a),
                                    static_cast<double>(__fmul_rn(f, b))));
}

// false only where blend(a, b, f) cannot pass the plane's test (above);
// e = {column offset, hiZ, lowZ, f}
__device__ __forceinline__ bool may_hit(float a, float b, int4 e) {
  const float est = __fmaf_rn(__int_as_float(e.w), __fsub_rn(b, a), a);
  const float M = fmaxf(fabsf(a), fabsf(b));
  return !((__fmaf_rn(-kPreMargin, M, est) >= __int_as_float(e.y)) |
           (__fmaf_rn(kPreMargin, M, est) <= __int_as_float(e.z)));
}

__device__ __forceinline__ bool exact_hit(float a, float b, int4 e,
                                          const Exact& c, float& d) {
  d = blend(a, b, __int_as_float(e.w), c.g);
  return fabsf(__fsub_rn(d, c.z)) < c.tol && d > 1e-3f;
}

// the row's samples at s = x + off and s + 1 (rx = row + x), zero
// outside [0, WP) when checked
template <bool kChecked>
__device__ __forceinline__ void load2(const float* row, const float* rx,
                                      int x, int off, int wp, float& a,
                                      float& b) {
  if (kChecked) {
    const int s = x + off;
    a = static_cast<unsigned>(s) < static_cast<unsigned>(wp) ? row[s] : 0.0f;
    b = static_cast<unsigned>(s + 1) < static_cast<unsigned>(wp) ? row[s + 1]
                                                                 : 0.0f;
  } else {
    a = rx[off];
    b = rx[off + 1];
  }
}

// The first entry of the list (pre, exact, n) whose plane the pixel at x
// hits on `row`; -1 if none (or if the lane is not `live`). `best` gets
// the hit's depth. Software-pipelined: entry k + 1's samples and entry
// k + 2's constants are loaded before entry k is tested, so shared-memory
// latency overlaps the pre-test.
template <bool kChecked>
__device__ __forceinline__ int find_hit(const int4* pre, const Exact* exact,
                                        int n, const float* row, int x,
                                        int wp, bool live, float& best) {
  if (!live) return -1;
  const float* rx = row + x;
  int4 e = pre[0], en = pre[1];   // pre[n], pre[n + 1] are zero entries
  float a, b;
  load2<kChecked>(row, rx, x, e.x, wp, a, b);
  const int4* next = pre + 2;
#pragma unroll 4
  for (int k = 0; k < n; ++k, ++next) {
    const int4 enn = *next;
    float an, bn, d;
    load2<kChecked>(row, rx, x, en.x, wp, an, bn);
    if (may_hit(a, b, e) && exact_hit(a, b, e, exact[k], d)) {
      best = d;
      return k;
    }
    e = en;
    en = enn;
    a = an;
    b = bn;
  }
  return -1;
}

// ------------------------------------------------------------ kernel ----

__device__ __forceinline__ bool unit_rows(const Params& p, int u, int& b,
                                          int& tile, int& y0, int& y1) {
  const int per_b = p.ntiles * p.units_per_tile;
  b = u / per_b;
  const int r = u - b * per_b;
  tile = r / p.units_per_tile;
  y0 = tile * p.block_rows + (r - tile * p.units_per_tile) * kBand;
  y1 = min(min(y0 + kBand, (tile + 1) * p.block_rows), p.H);
  return y0 < y1;
}

// the producer warp's lists of unit (b, tile) into `slot`. Planes go in
// blocks of 4 x 32, every load of a block issued before any is used.
template <int kStreams>
__device__ __forceinline__ void build_lists(const Params& p, unsigned char* sm,
                                            const Layout& L, int slot, int b,
                                            int tile, int lane) {
  const size_t pb = static_cast<size_t>(b) * p.P;
  const size_t ab = (static_cast<size_t>(b) * p.ntiles + tile) * p.P;
  const float inf = __int_as_float(0x7f800000);
  int n[kStreams];
  bool checked[kStreams];
#pragma unroll
  for (int st = 0; st < kStreams; ++st) {
    n[st] = 0;
    checked[st] = false;
  }
  for (int base = 0; base < p.P; base += 128) {
    int di[4], act[kStreams][4];
    float f[4], z[4], tol[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = base + 32 * j + lane;
      const bool in = q < p.P;
      di[j] = in ? p.disp_int[pb + q] : 0;
      f[j] = in ? p.disp_frac[pb + q] : 0.0f;
      z[j] = in ? p.plane_z[pb + q] : 0.0f;
      tol[j] = in ? p.plane_tol[pb + q] : 0.0f;
#pragma unroll
      for (int st = 0; st < kStreams; ++st)
        act[st][j] = in ? p.s[st].active[ab + q] : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long off = static_cast<long long>(di[j]) + p.pad_left;
      const bool unit_f = f[j] >= 0.0f && f[j] <= 1.0f;
      const float hiz =
          unit_f ? __fadd_ru(__fadd_ru(z[j], tol[j]), kPreSlack) : inf;
      const float lowz =
          unit_f ? __fsub_rd(fmaxf(__fsub_rd(z[j], tol[j]), 1e-3f),
                             kPreSlack)
                 : -inf;
      const bool out = off < 0 || off + p.W > p.WP - 1;
#pragma unroll
      for (int st = 0; st < kStreams; ++st) {
        const int list = slot * kStreams + st;
        int4* pre = reinterpret_cast<int4*>(sm + L.pre) + list * (p.P + 2);
        Exact* exact =
            reinterpret_cast<Exact*>(sm + L.exact) + list * (p.P + 2);
        const bool on = act[st][j] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, on);
        if (on) {
          const int pos = n[st] + __popc(m & ((1u << lane) - 1u));
          pre[pos] = make_int4(static_cast<int>(off), __float_as_int(hiz),
                               __float_as_int(lowz), __float_as_int(f[j]));
          exact[pos].g = static_cast<double>(__fsub_rn(1.0f, f[j]));
          exact[pos].z = z[j];
          exact[pos].tol = tol[j];
          checked[st] |= out;
        }
        n[st] += __popc(m);
      }
    }
  }
#pragma unroll
  for (int st = 0; st < kStreams; ++st) {
    const int list = slot * kStreams + st;
    const bool any_out = __any_sync(0xffffffffu, checked[st]);
    if (lane == 0) {
      int4* pre = reinterpret_cast<int4*>(sm + L.pre) + list * (p.P + 2);
      pre[n[st]] = pre[n[st] + 1] = make_int4(0, 0, 0, 0);
      reinterpret_cast<int2*>(sm + L.hdr)[list] = make_int2(n[st], any_out);
    }
  }
}

// One warp's 32-pixel chunk (from x0) of image row (b, y), every stream.
template <int kStreams>
__device__ __forceinline__ void sweep_chunk(const Params& p, unsigned char* sm,
                                            const Layout& L, const float* rows,
                                            int slot, int b, int y, int x0,
                                            int warp, int lane) {
  const int x = x0 + lane;
  const bool valid = x < p.W;
  const size_t pix = (static_cast<size_t>(b) * p.H + y) * p.W;
  float* stage = reinterpret_cast<float*>(sm + L.staging) +
                 warp * 32 * p.max_pay;
  const int npx = min(32, p.W - x0);
#pragma unroll
  for (int s = 0; s < kStreams; ++s) {
    const int ls = s;  // the stream's own list
    const int list = slot * kStreams + ls;
    const int4* pre = reinterpret_cast<const int4*>(sm + L.pre) +
                      list * (p.P + 2);
    const Exact* exact = reinterpret_cast<const Exact*>(sm + L.exact) +
                         list * (p.P + 2);
    const int2 hdr = reinterpret_cast<const int2*>(sm + L.hdr)[list];
    const int n = hdr.x;
    const float* drow = rows + s * p.pitch;
    const int xs = min(x, p.W - 1);   // lanes past the end read in bounds
    float best = kInfDepth;
    int k = -1;
    if (hdr.y)   // an offset leaves the row: bounds-checked loads
      k = find_hit<true>(pre, exact, n, drow, xs, p.WP, valid, best);
    else
      k = find_hit<false>(pre, exact, n, drow, xs, p.WP, valid, best);
    const Stream& S = p.s[s];
    if (valid) {
      if (S.out_z != nullptr) S.out_z[pix + x] = best;
      S.out_found[pix + x] = k >= 0 ? 1 : 0;
    }
    int col = 0;
    float f = 0.0f;
    double g = 0.0;
    if (k >= 0) {
      const int4 e = pre[k];
      col = x + e.x;
      f = __int_as_float(e.w);
      g = exact[k].g;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* out = S.out_pay[j];
      if (out == nullptr) continue;
      const int nc = p.payload_n[j];
      if (valid) {
        const float* src =
            p.payload[j] + (static_cast<size_t>(b) * nc * p.H + y) * p.WP;
        const bool in0 = static_cast<unsigned>(col) <
                         static_cast<unsigned>(p.WP);
        const bool in1 = static_cast<unsigned>(col + 1) <
                         static_cast<unsigned>(p.WP);
        for (int c0 = 0; c0 < nc; c0 += kPayBatch) {
          float va[kPayBatch], vb[kPayBatch];   // all loads, then blends
#pragma unroll
          for (int i = 0; i < kPayBatch; ++i) {
            const float* prow =
                src + static_cast<size_t>(c0 + i) * p.H * p.WP + col;
            const bool ld = k >= 0 && c0 + i < nc;
            va[i] = ld && in0 ? __ldg(prow) : 0.0f;
            vb[i] = ld && in1 ? __ldg(prow + 1) : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < kPayBatch; ++i)
            if (c0 + i < nc)
              stage[lane * nc + c0 + i] =
                  k >= 0 ? blend(va[i], vb[i], f, g) : 0.0f;
        }
      }
      __syncwarp();
      float* dst = out + (pix + x0) * nc;
      for (int i = lane; i < npx * nc; i += 32) dst[i] = stage[i];
      __syncwarp();
    }
  }
}

template <int kStreams>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sweep_sm90(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout L(p, kStreams);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);   // at offset 0
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + kStages),
                 lfull = smem_u32(bars + 2 * kStages),
                 lempty = smem_u32(bars + 2 * kStages + 2);
  int* counter = reinterpret_cast<int*>(sm + L.counter);
  float* ring = reinterpret_cast<float*>(sm + L.rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 32);
      mbar_init(empty + 8 * i, kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(lfull + 8 * i, 32);
      mbar_init(lempty + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int stage_floats = kStreams * p.pitch;

  if (warp == kConsumerWarps) {   // the producer: lists and row copies
    int it_unit = 0, it_row = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      int b, tile, y0, y1;
      if (!unit_rows(p, u, b, tile, y0, y1)) continue;
      const int slot = it_unit & 1;
      mbar_wait(lempty + 8 * slot, ((it_unit >> 1) & 1) ^ 1);
      build_lists<kStreams>(p, sm, L, slot, b, tile, lane);
      mbar_arrive(lfull + 8 * slot);
      ++it_unit;
      for (int y = y0; y < y1; ++y, ++it_row) {
        const int st = it_row % kStages;
        const uint32_t bar = full + 8 * st;
        mbar_wait(empty + 8 * st, ((it_row / kStages) & 1) ^ 1);
        float* dst = ring + st * stage_floats;
        if (lane == 0) counter[st] = 0;
        if (p.bulk) {
          if (lane == 0) mbar_expect_tx(bar, kStreams * p.WP * 4);
          __syncwarp();
          if (lane < kStreams)
            bulk_load(smem_u32(dst + lane * p.pitch),
                      p.s[lane].depth +
                          (static_cast<size_t>(b) * p.H + y) * p.WP,
                      p.WP * 4, bar);
          if (lane != 0) mbar_arrive(bar);
        } else {
          for (int i = 0; i < kStreams; ++i) {
            const float* src =
                p.s[i].depth + (static_cast<size_t>(b) * p.H + y) * p.WP;
            for (int j = lane; j < p.WP; j += 32) dst[i * p.pitch + j] = src[j];
          }
          mbar_arrive(bar);
        }
      }
    }
    return;
  }

  // the consumers: 32-pixel chunks of each staged row, from its counter
  const int nchunks = (p.W + 31) / 32;
  int it_unit = 0, it_row = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    int b, tile, y0, y1;
    if (!unit_rows(p, u, b, tile, y0, y1)) continue;
    const int slot = it_unit & 1;
    mbar_wait(lfull + 8 * slot, (it_unit >> 1) & 1);
    ++it_unit;
    for (int y = y0; y < y1; ++y, ++it_row) {
      const int st = it_row % kStages;
      mbar_wait(full + 8 * st, (it_row / kStages) & 1);
      const float* rows = ring + st * stage_floats;
      while (true) {
        int c = 0;
        if (lane == 0) c = atomicAdd(counter + st, 1);
        c = __shfl_sync(0xffffffffu, c, 0);
        if (c >= nchunks) break;
        sweep_chunk<kStreams>(p, sm, L, rows, slot, b, y, 32 * c, warp, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(lempty + 8 * slot);
  }
}

// ------------------------------------------------------------ host ----

// Fills the derived fields of `p` and launches the core on `stream`: as
// many persistent blocks as fit on the card, at most one per work unit.
// Returns a cudaError_t as int (cudaErrorInvalidValue when the ring does
// not fit in a block's shared memory).
template <int kStreams>
int launch(Params p, cudaStream_t stream) {
  if (p.B == 0 || p.H == 0 || p.W == 0) return 0;
  p.pitch = (p.WP + 3) / 4 * 4;
  p.max_pay = 1;
  for (int s = 0; s < kStreams; ++s)
    for (int j = 0; j < 2; ++j)
      if (p.s[s].out_pay[j] != nullptr && p.payload_n[j] > p.max_pay)
        p.max_pay = p.payload_n[j];
  bool aligned = p.WP % 4 == 0 &&
                 static_cast<long long>(kStreams) * p.WP * 4 < (1 << 20);
  for (int s = 0; s < kStreams; ++s)
    aligned &= reinterpret_cast<uintptr_t>(p.s[s].depth) % 16 == 0;
  p.bulk = aligned ? 1 : 0;
  const int smem = Layout(p, kStreams).bytes;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  p.units_per_tile = (p.block_rows + kBand - 1) / kBand;
  const long long units =
      static_cast<long long>(p.B) * p.ntiles * p.units_per_tile;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.units = static_cast<int>(units);

  cudaError_t e = cudaFuncSetAttribute(
      sweep_sm90<kStreams>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sweep_sm90<kStreams>, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(units < slots ? units : slots);
  sweep_sm90<kStreams><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mdvt_sweep

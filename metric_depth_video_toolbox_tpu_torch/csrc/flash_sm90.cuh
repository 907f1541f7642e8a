// The bf16 flash-attention forward core for Hopper (sm_90a) that both
// attention kernels of this directory run on: packed_flash_attention.cu
// (B4) and block_causal_attention.cu (B3). Raw PTX and the CUDA headers
// only; no CUTLASS or CuTe.
//
// What it computes. For each (b, h) and each query row: the online-softmax
// recurrence in float32 over the key tiles its mask policy gives it (running
// max m and sum l in the exp2 domain, accumulator o), P rounded to bf16
// before P V, out = o / l rounded to bf16. A row whose keys so far are all
// masked keeps m = -1e30, p = 0 and l = 0, so nothing of a masked key
// reaches a later tile, and a row with no visible key comes out as zeros.
//
// What bounds it on the H100: operations (4 D per visible (query, key)
// pair on the bf16 tensor cores). So the design keeps the tensor cores fed:
//
// - Warp specialisation. A block is one producer warpgroup, in which a
//   single thread issues TMA loads (after setmaxnreg.dec), and consumer
//   warpgroups (after setmaxnreg.inc) that own 64 query rows each: three
//   at D = 64 (192-query work tiles, 160 registers each), two at D = 128
//   (128 queries, 232 registers each, for the wider accumulator). Every
//   K/V tile serves the whole work tile.
// - Loads. Q once per work tile (64-row boxes) and K/V tiles of 128 keys
//   into a ring of kStages stages (6 at D = 64, 3 at D = 128), all by TMA
//   with SWIZZLE_128B: rows of 64 head dims (128 bytes) per box, two boxes
//   ("panels") at D = 128. Keys and queries past N load as zeros (TMA's
//   out-of-bounds fill), so N needs no padding. "Full" mbarriers (TMA
//   bytes) and "empty" mbarriers (one arrival per consumer warp) per
//   stage, and a pair for Q, are the only synchronisation of the key loop:
//   no block-wide barrier. Q is released after a work tile's last S
//   product, so the next tile's Q loads under its last softmax.
// - S = Q K^T: wgmma m64n128k16, bf16 in, f32 accumulate, both operands
//   from shared memory. O += P V: wgmma m64nDk16 with P converted to bf16
//   in registers as the A operand (the RS form) and V read from shared
//   memory through the transpose bit.
// - Softmax on the accumulator layout: the max on the raw scores in four
//   partial maxima per row, p = exp2(s * scale2 - m) as one FFMA and one
//   MUFU.EX2 (ex2.approx.ftz), the row sums kept per lane until the end.
//   The consumers run unsynchronised with each other, so one warpgroup's
//   softmax overlaps another's products.
// - Persistent grid: one block per SM walks work tiles (query tile, b * h)
//   in the order its mask policy gives (B3: longest key range first). No
//   grid dimension is bounded by B * H.
// - Epilogue: 1 / l, bf16, stored from registers through the output
//   strides; rows >= N are never written.
//
// The two kernels differ only in their layout (the TMA maps and output
// strides their host code builds) and their mask policy, a struct `Mask`
// with these static members:
//   `tile(p, nqt, t, qt, bh)`: the t-th work tile, in the policy's order;
//   `tile_end(p, qt)`: key tiles [0, end) may hold a visible key;
//   `next_live(p, qt, bh, kt, end)`: the first key tile >= kt to take;
//   `masked(p, qt, kt)`: whether the tile needs the per-element test;
//   `row_ctx(p, row)`, `tile_bits(p, kt, t4)`, `visible(p, bits, key, bit,
//   ctx)`: that test, from what is read once per row and once per masked
//   tile (no load per element): `key` the key, `bit` = 2 j + e for the
//   thread's columns 8 j + 2 t4 + e of the tile.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace mdvt_attn {

constexpr int kBK = 128;        // keys per key tile
constexpr int kQRows = 64;      // query rows per consumer warpgroup
constexpr int kPanelCols = 64;  // head dims per TMA box: one 128-byte row
constexpr int kPanelBytes = kBK * 128;  // a key tile's 64-dim panel

// Work-tile parameters of both kernels; each mask policy reads its own.
struct FlashParams {
  int n;                        // tokens
  int heads;                    // H: heads per batch entry
  int bh;                       // B * H
  int q_head, k_head, v_head;   // head index of h = 0 in the q, k, v maps
  __nv_bfloat16* out;
  long long o_b, o_h, o_n;      // out strides in elements (last dim 1)
  float scale2;                 // sm_scale * log2(e)
  const signed char* tile_class;  // B4: per key tile 0 skip, 1 all, 2 mixed
  const uint32_t* valid_bits;     // B4: key validity, a bit per key
  const int* row_end;             // B3: per query, the keys it sees
  const int* key_end;             // B3: per query tile, keys with id <=
  const int* full_end;            //     the id of its last / first query
};

// Per head dim: D = 64 runs three consumer warpgroups (192-query work
// tiles, so each K/V tile serves 192 queries; 160 registers each), D = 128
// two (128 queries, 232 registers each, for the larger accumulator).
template <int D>
struct FlashConfig {
  static_assert(D == 64 || D == 128, "the core takes head dims 64 and 128");
  static constexpr int kConsumers = D == 64 ? 3 : 2;
  static constexpr int kBQ = kQRows * kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kConsumerWarps = 4 * kConsumers;
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kStages = D == 64 ? 6 : 3;
  static constexpr int kTileBytes = kPanels * kPanelBytes;   // K or V
  static constexpr int kQPanelBytes = kBQ * 128;
  static constexpr int kQ = 0;
  static constexpr int kK = kPanels * kQPanelBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // full[kStages], empty[kStages], q_full, q_empty; 1024 bytes of slack
  // to align the base for the 128-byte swizzle
  static constexpr int kSmemBytes = kBar + (2 * kStages + 2) * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
};

// ------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// one box of a 4-d map (D, rows, heads, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// 2^x on the MUFU unit, subnormal results flushed to 0; exp2(-inf) = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of wgmma's registers above the
// wait, or reusing them while a product is in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: 8-row
// groups 1024 bytes apart (SBO); `lbo` the byte distance between panels
// along the contiguous dimension (used by the transposed V operand).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// ------------------------------------------------------------ wgmma ----

// S (+)= A B: m64n128k16, A and B from shared memory (descriptors)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O += P V: m64n64k16, A (P) from registers, B (V) from shared memory
// read through the transpose bit (V is stored key-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V: m64n128k16, A (P) from registers, B (V) from shared memory
// read through the transpose bit (V is stored key-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V over a 128-key tile whose V starts at `v`: k-step kk takes keys
// 16 kk .. 16 kk + 15 (2048 bytes of V rows); the two 64-dim panels of
// D = 128 are kPanelBytes apart (the descriptor's leading byte offset).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kBK / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t db = sw128_desc(v + kk * 2048, kPanelBytes);
    if constexpr (D == 64) wgmma_rs_n64(o, pa[kk], db);
    else wgmma_rs_n128(o, pa[kk], db);
  }
}

// The online softmax of one S tile (64 rows x 128 keys of a warpgroup) on
// the accumulator layout: a row's 128 scores sit on 4 lanes, rows a and b
// (g and g + 8 of the warp's 16). Masks (kMasked: -inf where the policy
// hides a key), updates the running max m and sum l, returns the rescale
// factors of O and l and P rounded to bf16 as the A operand of P V. A
// masked score is -inf and the running max starts at -1e30, so a row
// whose keys so far are all masked keeps m = -1e30, p = 0 and l = 0. The
// max is taken on the raw scores (sm_scale > 0 commutes with it), in four
// partial maxima per row for instruction-level parallelism; m lives in the
// scaled log2 domain, so p = exp2(s * scale2 - m) is one FFMA and one
// MUFU.EX2.
template <class Mask, bool kMasked>
__device__ __forceinline__ void softmax_tile(
    const FlashParams& p, float (&s)[64], uint32_t (&pa)[kBK / 16][4],
    float& m_a, float& m_b, float& l_a, float& l_b, float& al_a,
    float& al_b, int kt, int t4, int ctx_a, int ctx_b) {
  if constexpr (kMasked) {
    const uint32_t bits = Mask::tile_bits(p, kt, t4);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!Mask::visible(p, bits, kt * kBK + 8 * j + 2 * t4 + (e & 1),
                           2 * j + (e & 1), e < 2 ? ctx_a : ctx_b))
          s[4 * j + e] = neg_inf();
  }
  float ra[4], rb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ra[i] = fmaxf(s[4 * i], s[4 * i + 1]);
    rb[i] = fmaxf(s[4 * i + 2], s[4 * i + 3]);
  }
#pragma unroll
  for (int j = 4; j < kBK / 8; ++j) {
    ra[j % 4] = fmaxf(ra[j % 4], fmaxf(s[4 * j], s[4 * j + 1]));
    rb[j % 4] = fmaxf(rb[j % 4], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float mx_a = fmaxf(fmaxf(ra[0], ra[1]), fmaxf(ra[2], ra[3]));
  float mx_b = fmaxf(fmaxf(rb[0], rb[1]), fmaxf(rb[2], rb[3]));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(m_a, mx_a * p.scale2);
  const float mn_b = fmaxf(m_b, mx_b * p.scale2);
  al_a = fast_exp2(m_a - mn_a);
  al_b = fast_exp2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float sa[2] = {0.0f, 0.0f}, sb[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    // exp2(-inf) = 0 when masked
    const float p0 = fast_exp2(fmaf(s[4 * j], p.scale2, -mn_a));
    const float p1 = fast_exp2(fmaf(s[4 * j + 1], p.scale2, -mn_a));
    const float p2 = fast_exp2(fmaf(s[4 * j + 2], p.scale2, -mn_b));
    const float p3 = fast_exp2(fmaf(s[4 * j + 3], p.scale2, -mn_b));
    sa[j % 2] += p0 + p1;
    sb[j % 2] += p2 + p3;
    pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
  l_a = l_a * al_a + sa[0] + sa[1];   // this lane's share
  l_b = l_b * al_b + sb[0] + sb[1];
}

// ---------------------------------------------------------- kernel ----

template <int D, class Mask>
__global__ void __launch_bounds__(FlashConfig<D>::kThreads, 1)
flash_sm90(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const FlashParams p) {
  using C = FlashConfig<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base + C::kQ;
  const uint32_t sk = base + C::kK;
  const uint32_t sv = base + C::kV;
  const uint32_t full = base + C::kBar;           // + 8 * stage
  const uint32_t empty = full + 8 * C::kStages;   // + 8 * stage
  const uint32_t q_full = empty + 8 * C::kStages;
  const uint32_t q_empty = q_full + 8;

  const int nqt = (p.n + C::kBQ - 1) / C::kBQ;
  const int ntiles = nqt * p.bh;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, C::kConsumerWarps);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, C::kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load of the block ----
    if constexpr (C::kConsumers == 3)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int qt, bh;
      Mask::tile(p, nqt, t, qt, bh);
      const int b = bh / p.heads, h = bh - b * p.heads;
      mbar_wait(q_empty, q_phase ^ 1);   // the last tile's S products done
      q_phase ^= 1;
      mbar_expect_tx(q_full, C::kPanels * C::kQPanelBytes);
#pragma unroll
      for (int c = 0; c < C::kPanels; ++c)
#pragma unroll
        for (int w = 0; w < C::kConsumers; ++w)
          tma_load(sq + c * C::kQPanelBytes + w * kQRows * 128, &tq, q_full,
                   c * kPanelCols, qt * C::kBQ + w * kQRows, p.q_head + h, b);
      const int end = Mask::tile_end(p, qt);
      for (int kt = Mask::next_live(p, qt, bh, 0, end); kt < end;
           kt = Mask::next_live(p, qt, bh, kt + 1, end)) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, 2 * C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c) {
          tma_load(sk + stage * C::kTileBytes + c * kPanelBytes, &tk, bar,
                   c * kPanelCols, kt * kBK, p.k_head + h, b);
          tma_load(sv + stage * C::kTileBytes + c * kPanelBytes, &tv, bar,
                   c * kPanelCols, kt * kBK, p.v_head + h, b);
        }
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    if constexpr (C::kConsumers == 3)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;     // row within the warp's 8-row group
    const int t4 = lane % 4;    // column pair
    const uint32_t sq_mine = sq + cw * kQRows * 128;
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int qt, bh;
      Mask::tile(p, nqt, t, qt, bh);
      const int row_a = qt * C::kBQ + cw * kQRows + warp * 16 + g;
      const int row_b = row_a + 8;
      const int ctx_a = Mask::row_ctx(p, row_a);
      const int ctx_b = Mask::row_ctx(p, row_b);
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
      float m_a = kNegInit, m_b = kNegInit, l_a = 0.0f, l_b = 0.0f;
      mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      bool q_released = false;
      const int end = Mask::tile_end(p, qt);
      int kt = Mask::next_live(p, qt, bh, 0, end);
      while (kt < end) {
        const int nxt = Mask::next_live(p, qt, bh, kt + 1, end);
        mbar_wait(full + 8 * stage, phase);

        // S = Q K^T (this warpgroup's 64 rows x 128 keys)
        float s[64];   // the first k-step overwrites it (scale-d 0)
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          wgmma_ss_n128(
              s, sw128_desc(sq_mine + (ks / 4) * C::kQPanelBytes +
                                (ks % 4) * 32, 16),
              sw128_desc(sk + stage * C::kTileBytes + (ks / 4) * kPanelBytes +
                             (ks % 4) * 32, 16),
              ks > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        if (nxt >= end) {            // Q is free for the next work tile
          if (lane == 0) mbar_arrive(q_empty);
          q_released = true;
        }

        // the tile's softmax, in a copy of its own for the masked tiles so
        // that the others carry no per-element select
        uint32_t pa[kBK / 16][4];   // P in bf16: the A operand of P V
        float al_a, al_b;           // rescale of O and l
        if (Mask::masked(p, qt, kt))
          softmax_tile<Mask, true>(p, s, pa, m_a, m_b, l_a, l_b, al_a, al_b,
                                   kt, t4, ctx_a, ctx_b);
        else
          softmax_tile<Mask, false>(p, s, pa, m_a, m_b, l_a, l_b, al_a, al_b,
                                    kt, t4, ctx_a, ctx_b);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= al_a;
          o[4 * j + 1] *= al_a;
          o[4 * j + 2] *= al_b;
          o[4 * j + 3] *= al_b;
        }

        // O += P V
        wgmma_fence();
        issue_pv<D>(o, pa, sv + stage * C::kTileBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(empty + 8 * stage);   // stage free
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
        kt = nxt;
      }
      if (!q_released && lane == 0) mbar_arrive(q_empty);

      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
      const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
      const int b = bh / p.heads, h = bh - b * p.heads;
      __nv_bfloat16* ob = p.out + b * p.o_b + h * p.o_h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (row_a < p.n)
          *reinterpret_cast<uint32_t*>(ob + row_a * p.o_n + col) =
              pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
        if (row_b < p.n)
          *reinterpret_cast<uint32_t*>(ob + row_b * p.o_n + col) =
              pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
      }
    }
  }
}

// ------------------------------------------------------------ host ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 operand (batch, heads, rows, D) at element strides (sb, sh, sn),
// last dim contiguous, as a TMA map over (D, rows, heads, batch) with boxes
// of 64 head dims x `box_rows` rows (kQRows for Q, kBK for K and V).
// Strides must be multiples of 8 elements (16 bytes) and the base 16-byte
// aligned; rows past `rows` read as zeros.
inline int encode_operand(CUtensorMap* map, const void* ptr, int d, int rows,
                          int heads, int batch, long long sb, long long sh,
                          long long sn, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kPanelCols, static_cast<cuuint32_t>(box_rows),
                             1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// One launch of the core over every (b, h) and query tile: one block per
// SM (fewer if there are fewer work tiles). Returns cudaGetLastError().
template <int D, class Mask>
int launch_flash(const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, const FlashParams& p,
                 cudaStream_t stream) {
  using C = FlashConfig<D>;
  constexpr int smem = C::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_sm90<D, Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles =
      static_cast<long long>((p.n + C::kBQ - 1) / C::kBQ) * p.bh;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  flash_sm90<D, Mask><<<grid, C::kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mdvt_attn

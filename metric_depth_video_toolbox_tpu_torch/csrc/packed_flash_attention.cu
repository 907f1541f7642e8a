// Flash attention over the packed qkv projection for Hopper (sm_90a), plain
// C interface.
//
// Replaces the Pallas TPU kernel
//   metric_depth_video_toolbox_tpu/ops/attention_pallas.py
//   _kernel / packed_flash_attention
// and computes the same function: qkv (B, N, 3H, D), the qkv projection's
// output seen through a free reshape (index along dim 2 = role * H + head,
// role 0/1/2 = q/k/v); valid (N,) int32, shared by the batch: a key j with
// valid[j] == 0 is left out of every softmax; queries are not masked (a pad
// query's row is computed like any other and is finite; a row with no valid
// key at all comes out as zeros). out (B, N, H, D), which the output
// projection reads through a free reshape. Softmax scaled by sm_scale, the
// online-softmax recurrence in float32 (running max m, running sum l,
// accumulator o), P rounded to the input type before P V as the Pallas
// kernel does. Keys j >= N are never read and queries i >= N never written,
// so N needs no padding; a key tile without a valid key is skipped whole.
//
// What bounds it on the H100. 4 * D operations per (query, valid key) pair:
// 5.9e13 for one cross-view attention of the DA3 window (1 x 52 views x 2305
// real tokens, 16 heads of 64), 60 ms at the 989 TFLOP/s of the bf16 tensor
// cores; qkv and out are 1.3 GB there, 0.4 ms at 3.35 TB/s. So it is bound
// by operations, and only a tensor-core kernel comes near.
//
// What the design does about that (bf16). The point of the kernel is the
// strided read: q, k and v rows of one head are D contiguous elements at a
// row stride of 3 * H * D inside the projection's output, so no (B, H, N, D)
// copy of q, k or v is ever made; the output goes straight to (B, N, H, D).
// The TPU kernel's 8-head groups and its in-memory transpose exist for
// Mosaic's (8, 128) tiles and have no counterpart: one block of 4 warps
// takes one (b, h, 64-query tile), one grid launch covers every (b, h).
// Each warp owns 16 query rows, holds its Q fragments in registers for the
// whole key loop, and runs both products on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulate). K and V tiles of 64 keys arrive in
// shared memory by cp.async (16-byte pieces of the strided rows), two stages
// deep; ldmatrix (.trans for V) feeds the B operands. The validity vector is
// per key only, so a tile is either skipped (no valid key), taken without a
// mask (every key valid) or masked per column; the mask costs nothing on
// the unmasked tiles, which are all but one per view in DA3's cross-view
// sequence. wgmma, TMA and warp specialisation are later work.
//
// float32 path: plain FMAs (no TF32), for holding the kernel against the
// CPU. 8 threads share a query row of a 16-query tile.

#include <climits>

#include "attention_common.cuh"

namespace {

using namespace mdvt_attn;

// Where one head's rows lie inside the packed tensors (in elements).
struct Layout {
  size_t in_row;    // 3 * H * D: stride between tokens of qkv
  size_t out_row;   // H * D: stride between tokens of out
  size_t q, k, v;   // offsets of this (b, h)'s first q, k, v row
  size_t o;         // offset of its first output row
};

__device__ __forceinline__ Layout layout_of(int bh, int H, int N, int D) {
  const int b = bh / H, h = bh % H;
  Layout L;
  L.in_row = static_cast<size_t>(3) * H * D;
  L.out_row = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * N * L.in_row;
  L.q = base + static_cast<size_t>(h) * D;
  L.k = base + static_cast<size_t>(H + h) * D;
  L.v = base + static_cast<size_t>(2 * H + h) * D;
  L.o = static_cast<size_t>(b) * N * L.out_row + static_cast<size_t>(h) * D;
  return L;
}

// ---------------------------------------------------------------- bf16 ----

constexpr int kBQ = 64;   // queries per block (16 per warp)
constexpr int kBK = 64;   // keys per tile
constexpr int kWarps = 4;
constexpr int kPad = 8;   // bf16 elements of row padding in shared memory

// Shared memory of the bf16 kernel: two stages of (K, V) tiles, each
// 64 x (D + 8) bf16, and two stages of the tile's key validity.
template <int D>
constexpr size_t bf16_smem_bytes() {
  return 2 * 2 * kBK * (D + kPad) * sizeof(__nv_bfloat16) +
         2 * kBK * sizeof(int);
}

// First key tile at or after `tile` that holds a valid key; ntiles if none.
// Uniform across the block (it is a block-wide vote).
template <int TILE>
__device__ __forceinline__ int next_live_tile(const int* __restrict__ valid,
                                              int tile, int ntiles, int N) {
  for (; tile < ntiles; ++tile) {
    const int j = tile * TILE + threadIdx.x;
    const bool live = threadIdx.x < TILE && j < N && valid[j] != 0;
    if (__syncthreads_or(live)) break;
  }
  return tile;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
packed_attn_bf16(const __nv_bfloat16* __restrict__ qkv,
                 const int* __restrict__ valid,
                 __nv_bfloat16* __restrict__ out, int H, int N,
                 float sm_scale) {
  constexpr int KS = D / 16;   // k-steps of the QK^T product
  constexpr int DN = D / 8;    // n-tiles of the PV product
  constexpr int ROW = D + kPad;
  constexpr int STAGE = kBK * ROW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + 2 * STAGE;
  int* s_ok = reinterpret_cast<int*>(Vs + 2 * STAGE);   // [2][kBK]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;      // row within the 8-row group
  const int t = lane % 4;      // column pair
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (N + kBK - 1) / kBK;
  const Layout L = layout_of(blockIdx.y, H, N, D);
  const __nv_bfloat16* qb = qkv + L.q;
  const __nv_bfloat16* kb = qkv + L.k;
  const __nv_bfloat16* vb = qkv + L.v;

  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const bool ok_a = row_a < N;
  const bool ok_b = row_b < N;

  // Q fragments (A operand, row-major 16x16 per k-step), kept in registers
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c0 = ks * 16 + 2 * t;
    const __nv_bfloat16* pa = qb + static_cast<size_t>(row_a) * L.in_row + c0;
    const __nv_bfloat16* pb = qb + static_cast<size_t>(row_b) * L.in_row + c0;
    qa[ks][0] = ok_a ? *reinterpret_cast<const uint32_t*>(pa) : 0u;
    qa[ks][1] = ok_b ? *reinterpret_cast<const uint32_t*>(pb) : 0u;
    qa[ks][2] = ok_a ? *reinterpret_cast<const uint32_t*>(pa + 8) : 0u;
    qa[ks][3] = ok_b ? *reinterpret_cast<const uint32_t*>(pb + 8) : 0u;
  }
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.0f;
  // running max in the log2 domain: scores are scaled by sm_scale*log2(e)
  // so that exp(s - m) becomes exp2(s2 - m2)
  const float scale2 = sm_scale * 1.4426950408889634f;
  float m_a = kNegInit, m_b = kNegInit, l_a = 0.0f, l_b = 0.0f;

  // stage a tile's K, V (cp.async, zero past the tail) and its validity
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    __nv_bfloat16* ks_ = Ks + stage * STAGE;
    __nv_bfloat16* vs_ = Vs + stage * STAGE;
    for (int c = tid; c < kBK * (D / 8); c += kWarps * 32) {
      const int j = c / (D / 8);
      const int d0 = (c % (D / 8)) * 8;
      const bool in = k0 + j < N;
      const size_t off = in ? static_cast<size_t>(k0 + j) * L.in_row + d0 : 0;
      cp_async16(ks_ + j * ROW + d0, kb + off, in);
      cp_async16(vs_ + j * ROW + d0, vb + off, in);
    }
    if (tid < kBK) {
      const int j = k0 + tid;
      s_ok[stage * kBK + tid] = j < N && valid[j] != 0;
    }
  };

  int cur = next_live_tile<kBK>(valid, 0, ntiles, N);
  if (cur < ntiles) load_tile(cur, 0);
  cp_async_commit();
  for (int stage = 0; cur < ntiles; stage ^= 1) {
    const int nxt = next_live_tile<kBK>(valid, cur + 1, ntiles, N);
    if (nxt < ntiles) load_tile(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait_one();       // this tile's copies have landed
    // every key of the tile valid: no per-column mask
    const int* kok = s_ok + stage * kBK;
    const bool full = __syncthreads_and(tid >= kBK || kok[tid] != 0);
    const __nv_bfloat16* ks_ = Ks + stage * STAGE;
    const __nv_bfloat16* vs_ = Vs + stage * STAGE;

    // S = Q K^T: 8 n-tiles of 8 keys; ldmatrix feeds two n-tiles at once
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    const int mi = lane >> 3;  // matrix this lane addresses
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; nt += 2) {
        uint32_t b[4];
        ldsm_x4(b, ks_ + ((nt + (mi >> 1)) * 8 + (lane & 7)) * ROW +
                       ks * 16 + (mi & 1) * 8);
        mma_bf16(s[nt], qa[ks], b[0], b[1]);
        mma_bf16(s[nt + 1], qa[ks], b[2], b[3]);
      }
    }

    // mask, scale, row max (a row's 64 scores sit on 4 lanes). A masked
    // score is -inf and the running max starts at -1e30, so a row whose
    // keys so far are all masked keeps m = -1e30, p = 0 and l = 0: nothing
    // of a masked key survives into a later tile.
    float mx_a = kNegInit, mx_b = kNegInit;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[nt][e] * scale2;
        if (!full && kok[nt * 8 + 2 * t + (e & 1)] == 0) val = neg_inf();
        s[nt][e] = val;
        if (e < 2) mx_a = fmaxf(mx_a, val); else mx_b = fmaxf(mx_b, val);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a);
    const float al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn_a);   // exp2(-inf) = 0 when masked
      s[nt][1] = exp2f(s[nt][1] - mn_a);
      s[nt][2] = exp2f(s[nt][2] - mn_b);
      s[nt][3] = exp2f(s[nt][3] - mn_b);
      sum_a += s[nt][0] + s[nt][1];
      sum_b += s[nt][2] + s[nt][3];
    }
    l_a = l_a * al_a + sum_a;   // this lane's share; summed over lanes last
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o[dn][0] *= al_a;
      o[dn][1] *= al_a;
      o[dn][2] *= al_b;
      o[dn][3] *= al_b;
    }

    // O += P V: the S accumulators of n-tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk; ldmatrix.trans reads V (key-major) as the
    // B operand, two n-tiles of 8 head dims at once
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs_ + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * ROW +
                             (dn + (mi >> 1)) * 8);
        mma_bf16(o[dn], pa, b[0], b[1]);
        mma_bf16(o[dn + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();           // this stage is free for the tile after next
    cur = nxt;
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = out + L.o;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int c0 = dn * 8 + 2 * t;
    if (ok_a)
      *reinterpret_cast<uint32_t*>(
          ob + static_cast<size_t>(row_a) * L.out_row + c0) =
          pack_bf16(o[dn][0] * inv_a, o[dn][1] * inv_a);
    if (ok_b)
      *reinterpret_cast<uint32_t*>(
          ob + static_cast<size_t>(row_b) * L.out_row + c0) =
          pack_bf16(o[dn][2] * inv_b, o[dn][3] * inv_b);
  }
}

// ------------------------------------------------------------- float32 ----

constexpr int kFQ = 16;        // queries per block
constexpr int kFK = 32;        // keys per tile
constexpr int kFThreads = 128; // 8 threads per query row

template <int D>
__global__ void __launch_bounds__(kFThreads)
packed_attn_f32(const float* __restrict__ qkv, const int* __restrict__ valid,
                float* __restrict__ out, int H, int N, float sm_scale) {
  constexpr int DR = D + 1;    // padded rows: distinct banks per row
  constexpr int PER = D / 8;   // output columns per thread
  __shared__ float Qs[kFQ * DR];
  __shared__ float Ks[kFK * DR];
  __shared__ float Vs[kFK * D];
  __shared__ float Ps[kFQ * (kFK + 1)];
  __shared__ int s_ok[kFK];

  const int tid = threadIdx.x;
  const int r = tid / 8;       // query row of the tile
  const int c = tid % 8;       // lane within the row's 8 threads
  const int q0 = blockIdx.x * kFQ;
  const Layout L = layout_of(blockIdx.y, H, N, D);
  const int row = q0 + r;
  const bool ok = row < N;
  for (int e = tid; e < kFQ * D; e += kFThreads) {
    const int rr = e / D, d = e % D;
    Qs[rr * DR + d] =
        q0 + rr < N ? qkv[L.q + static_cast<size_t>(q0 + rr) * L.in_row + d]
                    : 0.0f;
  }
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.0f;
  float m = kNegInit, l = 0.0f;
  const int ntiles = (N + kFK - 1) / kFK;

  for (int tile = next_live_tile<kFK>(valid, 0, ntiles, N); tile < ntiles;
       tile = next_live_tile<kFK>(valid, tile + 1, ntiles, N)) {
    const int k0 = tile * kFK;
    if (tid < kFK) s_ok[tid] = k0 + tid < N && valid[k0 + tid] != 0;
    for (int e = tid; e < kFK * D; e += kFThreads) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < N;
      const size_t off = static_cast<size_t>(k0 + j) * L.in_row + d;
      Ks[j * DR + d] = in ? qkv[L.k + off] : 0.0f;
      Vs[j * D + d] = in ? qkv[L.v + off] : 0.0f;
    }
    __syncthreads();

    float sc[kFK / 8];
    float mx = kNegInit;
#pragma unroll
    for (int i = 0; i < kFK / 8; ++i) {
      const int j = c + 8 * i;
      float dot = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[r * DR + d], Ks[j * DR + d], dot);
      sc[i] = s_ok[j] ? dot * sm_scale : neg_inf();
      mx = fmaxf(mx, sc[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kFK / 8; ++i) {
      const float p = expf(sc[i] - mn);
      Ps[r * (kFK + 1) + c + 8 * i] = p;
      sum += p;
    }
    l = l * alpha + sum;       // this thread's share; summed over 8 last
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= alpha;
    for (int j = 0; j < kFK; ++j) {
      const float p = Ps[r * (kFK + 1) + j];
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] = fmaf(p, Vs[j * D + c + 8 * i], acc[i]);
    }
    __syncthreads();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l += __shfl_xor_sync(0xffffffffu, l, 4);
  if (!ok) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  float* orow = out + L.o + static_cast<size_t>(row) * L.out_row;
#pragma unroll
  for (int i = 0; i < PER; ++i) orow[c + 8 * i] = acc[i] * inv;
}

template <int D>
int launch(const void* qkv, const int* valid, void* out, int B, int H, int N,
           float sm_scale, int bf16, cudaStream_t stream) {
  if (bf16) {
    constexpr size_t smem = bf16_smem_bytes<D>();
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          packed_attn_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    dim3 grid((N + kBQ - 1) / kBQ, B * H);
    packed_attn_bf16<D><<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv), valid,
        static_cast<__nv_bfloat16*>(out), H, N, sm_scale);
  } else {
    dim3 grid((N + kFQ - 1) / kFQ, B * H);
    packed_attn_f32<D><<<grid, kFThreads, 0, stream>>>(
        static_cast<const float*>(qkv), valid, static_cast<float*>(out), H,
        N, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv (B, N, 3H, D) and out (B, N, H, D) contiguous, bf16 (dtype 1) or
// float32 (dtype 0), 16-byte aligned; valid (N,) int32. D in {16, 32, ...,
// 128}; B * H at most 65535 (the grid's y extent). Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported D
// or B * H).
extern "C" int mdvt_packed_flash_attention(const void* qkv, const int* valid,
                                           void* out, int B, int N, int H,
                                           int D, float sm_scale, int dtype,
                                           void* stream) {
  if (B == 0 || H == 0 || N == 0) return 0;
  if (static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(qkv, valid, out, B, H, N, sm_scale, dtype, s);
    case 32: return launch<32>(qkv, valid, out, B, H, N, sm_scale, dtype, s);
    case 48: return launch<48>(qkv, valid, out, B, H, N, sm_scale, dtype, s);
    case 64: return launch<64>(qkv, valid, out, B, H, N, sm_scale, dtype, s);
    case 80: return launch<80>(qkv, valid, out, B, H, N, sm_scale, dtype, s);
    case 96: return launch<96>(qkv, valid, out, B, H, N, sm_scale, dtype, s);
    case 112: return launch<112>(qkv, valid, out, B, H, N, sm_scale, dtype, s);
    case 128: return launch<128>(qkv, valid, out, B, H, N, sm_scale, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

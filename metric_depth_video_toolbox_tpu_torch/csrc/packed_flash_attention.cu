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
// online-softmax recurrence in float32, P rounded to the input type before
// P V as the Pallas kernel does. Keys j >= N are never used and queries
// i >= N never written, so N needs no padding.
//
// What bounds it on the H100. 4 * D operations per (query, valid key) pair:
// 5.9e13 for one cross-view attention of the DA3 window (1 x 52 views x 2305
// real tokens, 16 heads of 64), 60 ms at the 989 TFLOP/s of the bf16 tensor
// cores; qkv and out are 1.0 GB there, 0.3 ms at 3.35 TB/s. So it is bound
// by operations.
//
// What the design does about that (bf16): the warp-specialised wgmma + TMA
// core of flash_sm90.cuh, with this kernel's two policies.
// - Layout: one TMA map over qkv as (D, N, 3H, B) at the projection's own
//   strides (row 3 H D, head D), so q, k and v are read in place at head
//   indices h, H + h and 2H + h; no (B, H, N, D) copy exists. The output
//   goes to (B, N, H, D) through its strides.
// - Mask: validity is per key, so the wrapper classes each 128-key tile
//   once per launch (0 = no valid key, 1 = all valid, 2 = mixed; a tile
//   reaching past N is mixed) and packs the validity into a bitmap. A
//   class-0 tile is never loaded, a class-1 tile takes no mask, a mixed
//   tile is masked by column from its four bitmap words, read once. The
//   ViT pads each view to 64 tokens, so a cross-view sequence has about one
//   mixed tile per view.
//
// float32 path: plain FMAs (no TF32), for holding the kernel against the
// CPU. 8 threads share a query row of a 16-query tile.

#include <climits>

#include "flash_sm90.cuh"

namespace {

using namespace mdvt_attn;

// B4's mask policy for the core: every query tile takes the same key
// tiles, the tiles of a (b, h) in turn (query tile fastest, so the blocks
// that run together share their K/V tiles in L2).
struct PackedMask {
  __device__ static void tile(const FlashParams& p, int nqt, int t, int& qt,
                              int& bh) {
    bh = t / nqt;
    qt = t - bh * nqt;
  }
  __device__ static int tile_end(const FlashParams& p, int qt) {
    return (p.n + kBK - 1) / kBK;
  }
  __device__ static int next_live(const FlashParams& p, int qt, int bh,
                                  int kt, int end) {
    while (kt < end && p.tile_class[kt] == 0) ++kt;
    return kt;
  }
  __device__ static bool masked(const FlashParams& p, int qt, int kt) {
    return p.tile_class[kt] == 2;
  }
  __device__ static int row_ctx(const FlashParams& p, int row) { return 0; }
  // bit 2 j + e: the validity of this thread's key 8 j + 2 t4 + e of the
  // tile, from the tile's four words of the bitmap
  __device__ static uint32_t tile_bits(const FlashParams& p, int kt, int t4) {
    const uint32_t* words = p.valid_bits + kt * (kBK / 32);
    uint32_t w[kBK / 32], bits = 0;
#pragma unroll
    for (int i = 0; i < kBK / 32; ++i) w[i] = words[i];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bits |= ((w[j / 4] >> (8 * (j % 4) + 2 * t4 + e)) & 1u)
                << (2 * j + e);
    return bits;
  }
  __device__ static bool visible(const FlashParams& p, uint32_t bits, int key,
                                 int bit, int ctx) {
    return (bits >> bit) & 1u;   // 0 past N: the bitmap is padded with 0
  }
};

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
  const int q0 = blockIdx.y * kFQ;
  const Layout L = layout_of(blockIdx.x, H, N, D);
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
int launch_f32(const void* qkv, const int* valid, void* out, int B, int H,
               int N, float sm_scale, cudaStream_t stream) {
  dim3 grid(B * H, (N + kFQ - 1) / kFQ);
  packed_attn_f32<D><<<grid, kFThreads, 0, stream>>>(
      static_cast<const float*>(qkv), valid, static_cast<float*>(out), H, N,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* qkv, const void* valid_bits,
                const signed char* tile_class, void* out, int B, int H,
                int N, float sm_scale, cudaStream_t stream) {
  const long long row = 3LL * H * D;
  CUtensorMap qmap, kvmap;   // one tensor, two box heights
  int rc = encode_operand(&qmap, qkv, D, N, 3 * H, B, N * row, D, row,
                          kQRows);
  if (rc == 0)
    rc = encode_operand(&kvmap, qkv, D, N, 3 * H, B, N * row, D, row, kBK);
  if (rc != 0) return rc;
  FlashParams p = {};
  p.n = N;
  p.heads = H;
  p.bh = B * H;
  p.q_head = 0;
  p.k_head = H;
  p.v_head = 2 * H;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.o_b = static_cast<long long>(N) * H * D;
  p.o_h = D;
  p.o_n = static_cast<long long>(H) * D;
  p.scale2 = sm_scale * 1.4426950408889634f;
  p.tile_class = tile_class;
  p.valid_bits = static_cast<const uint32_t*>(valid_bits);
  return launch_flash<D, PackedMask>(qmap, kvmap, kvmap, p, stream);
}

}  // namespace

// qkv (B, N, 3H, D) and out (B, N, H, D) contiguous, 16-byte aligned.
// bf16 (dtype 1): D 64 or 128; valid_bits the key validity as a bitmap
// (bit b of byte i = key 8 i + b), zero-padded to whole 128-key tiles, 4-byte
// aligned; tile_class the (ceil(N / 128),) int8 classes of the 128-key
// tiles (0 no valid key, 1 all valid, 2 mixed); valid unused. float32
// (dtype 0): valid (N,) int32, D in {16, 32, ..., 128}, N at most
// 65535 * 16; valid_bits and tile_class unused. Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported
// shape).
extern "C" int mdvt_packed_flash_attention(const void* qkv, const int* valid,
                                           const void* valid_bits,
                                           const signed char* tile_class,
                                           void* out, int B, int N, int H,
                                           int D, float sm_scale, int dtype,
                                           void* stream) {
  if (B == 0 || H == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 64:
        return launch_bf16<64>(qkv, valid_bits, tile_class, out, B, H, N,
                               sm_scale, s);
      case 128:
        return launch_bf16<128>(qkv, valid_bits, tile_class, out, B, H, N,
                                sm_scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if ((N + kFQ - 1) / kFQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch_f32<16>(qkv, valid, out, B, H, N, sm_scale, s);
    case 32: return launch_f32<32>(qkv, valid, out, B, H, N, sm_scale, s);
    case 48: return launch_f32<48>(qkv, valid, out, B, H, N, sm_scale, s);
    case 64: return launch_f32<64>(qkv, valid, out, B, H, N, sm_scale, s);
    case 80: return launch_f32<80>(qkv, valid, out, B, H, N, sm_scale, s);
    case 96: return launch_f32<96>(qkv, valid, out, B, H, N, sm_scale, s);
    case 112: return launch_f32<112>(qkv, valid, out, B, H, N, sm_scale, s);
    case 128: return launch_f32<128>(qkv, valid, out, B, H, N, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

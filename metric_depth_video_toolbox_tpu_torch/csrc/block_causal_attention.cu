// Block-causal flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   metric_depth_video_toolbox_tpu/ops/blockcausal_pallas.py
//   _kernel / block_causal_flash_attention
// and computes the same function: q, k, v (B, H, N, D); query i attends key
// j iff ids[j] <= ids[i] (ids (N,) int32, nondecreasing, shared by every
// (b, h)); softmax scaled by sm_scale, accumulated with the online-softmax
// recurrence in float32. The ragged tail is bounded in the kernel (keys
// j >= N are never used, queries i >= N never written), so callers need no
// padding; a caller that pads with the JAX package's convention (pad
// queries id max, pad keys id max + 1) gets the same real rows.
//
// What bounds it on the H100. The work is the visible part of QK^T and PV:
// 4 * D flops per visible (query, key) pair, ~1.35e12 at the Wan phase's
// (1, 12, 18720, 128) with 4 causal blocks, 1.36 ms at the 989 TFLOP/s of
// the bf16 tensor cores; q, k, v and out are ~230 MB, 0.07 ms at 3.35 TB/s.
// So it is bound by operations.
//
// What the design does about that (bf16): the warp-specialised wgmma + TMA
// core of flash_sm90.cuh, with this kernel's two policies.
// - Layout: one TMA map per operand at the strides of the tensors given
//   (last dim contiguous, 16-byte rows), so the DiT's (B, N, H, D)
//   projections come in as transposed views without a copy; the output
//   goes out through its strides the same way.
// - Mask: the ids are nondecreasing, so the keys a query tile sees are a
//   prefix. The wrapper computes per query tile, once per launch,
//   key_end (keys with id <= the id of its last query) and full_end (keys
//   with id <= the id of its first query), and per query row_end (keys
//   with id <= its id). Key tiles wholly below full_end take no mask, the
//   tiles up to key_end the per-element test ids[j] <= ids[i], which on a
//   prefix is j < row_end[i] (read once per row), and nothing beyond
//   key_end is loaded. Work tiles run longest key range first, so the
//   causal tail does not straggle.
//
// float32 path: plain FMAs (no TF32), for holding the kernel against the
// CPU. 8 threads share a query row of a 16-query tile; scores, softmax and
// P V run from shared memory.

#include <climits>

#include "flash_sm90.cuh"

namespace {

using namespace mdvt_attn;

// B3's mask policy for the core.
struct CausalMask {
  // the last query tile (the longest key range) first, every (b, h) of a
  // query tile in turn
  __device__ static void tile(const FlashParams& p, int nqt, int t, int& qt,
                              int& bh) {
    const int rank = t / p.bh;
    bh = t - rank * p.bh;
    qt = nqt - 1 - rank;
  }
  __device__ static int tile_end(const FlashParams& p, int qt) {
    return (p.key_end[qt] + kBK - 1) / kBK;
  }
  __device__ static int next_live(const FlashParams& p, int qt, int bh,
                                  int kt, int end) {
    return kt;   // every tile below key_end holds a key the last query sees
  }
  __device__ static bool masked(const FlashParams& p, int qt, int kt) {
    return (kt + 1) * kBK > p.full_end[qt];
  }
  // ids nondecreasing: the keys with ids[j] <= ids[i] are the prefix
  // [0, row_end[i]), so the per-element test kid <= qid is key < row_end
  __device__ static int row_ctx(const FlashParams& p, int row) {
    return row < p.n ? p.row_end[row] : 0;
  }
  __device__ static uint32_t tile_bits(const FlashParams& p, int kt, int t4) {
    return 0;
  }
  __device__ static bool visible(const FlashParams& p, uint32_t bits, int key,
                                 int bit, int ctx) {
    return key < ctx;
  }
};

// ------------------------------------------------------------- float32 ----

constexpr int kFQ = 16;        // queries per block
constexpr int kFK = 32;        // keys per tile
constexpr int kFThreads = 128; // 8 threads per query row

template <int D>
__global__ void __launch_bounds__(kFThreads)
bc_attn_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int* __restrict__ ids,
            float* __restrict__ out, int N, float sm_scale) {
  constexpr int DR = D + 1;    // padded rows: distinct banks per row
  constexpr int PER = D / 8;   // output columns per thread
  __shared__ float Qs[kFQ * DR];
  __shared__ float Ks[kFK * DR];
  __shared__ float Vs[kFK * D];
  __shared__ float Ps[kFQ * (kFK + 1)];
  __shared__ int s_kid[kFK];
  __shared__ int s_qmax;

  const int tid = threadIdx.x;
  const int r = tid / 8;       // query row of the tile
  const int c = tid % 8;       // lane within the row's 8 threads
  const int q0 = blockIdx.y * kFQ;
  const size_t base = static_cast<size_t>(blockIdx.x) * N * D;
  const int row = q0 + r;
  const bool ok = row < N;
  const int qid = ok ? ids[row] : INT_MIN;
  if (tid == 0) s_qmax = INT_MIN;
  for (int e = tid; e < kFQ * D; e += kFThreads) {
    const int rr = e / D, d = e % D;
    Qs[rr * DR + d] = q0 + rr < N ? q[base + static_cast<size_t>(q0 + rr) * D
                                       + d] : 0.0f;
  }
  __syncthreads();
  if (c == 0 && ok) atomicMax(&s_qmax, qid);
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.0f;
  float m = kNegInit, l = 0.0f;
  __syncthreads();
  const int qmax = s_qmax;

  for (int k0 = 0; k0 < N; k0 += kFK) {
    bool vis = false;
    if (tid < kFK) {
      const int j = k0 + tid;
      const int kid = j < N ? ids[j] : INT_MAX;
      s_kid[tid] = kid;
      vis = j < N && kid <= qmax;
    }
    if (!__syncthreads_or(vis)) continue;
    for (int e = tid; e < kFK * D; e += kFThreads) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < N;
      const size_t off = base + static_cast<size_t>(k0 + j) * D + d;
      Ks[j * DR + d] = in ? k[off] : 0.0f;
      Vs[j * D + d] = in ? v[off] : 0.0f;
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
      const bool keep = k0 + j < N && s_kid[j] <= qid;
      sc[i] = keep ? dot * sm_scale : neg_inf();
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
  float* orow = out + base + static_cast<size_t>(row) * D;
#pragma unroll
  for (int i = 0; i < PER; ++i) orow[c + 8 * i] = acc[i] * inv;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const int* ids,
               void* out, int BH, int N, float sm_scale, cudaStream_t stream) {
  dim3 grid(BH, (N + kFQ - 1) / kFQ);
  bc_attn_f32<D><<<grid, kFThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), ids, static_cast<float*>(out), N,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const int* row_end, const int* key_end, const int* full_end,
                void* out, int B, int H, int N, const long long* st,
                float sm_scale, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int rc = encode_operand(&maps[i], ptrs[i], D, N, H, B, st[3 * i],
                                  st[3 * i + 1], st[3 * i + 2],
                                  i == 0 ? kQRows : kBK);
    if (rc != 0) return rc;
  }
  FlashParams p = {};
  p.n = N;
  p.heads = H;
  p.bh = B * H;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.o_b = st[9];
  p.o_h = st[10];
  p.o_n = st[11];
  p.scale2 = sm_scale * 1.4426950408889634f;
  p.row_end = row_end;
  p.key_end = key_end;
  p.full_end = full_end;
  return launch_flash<D, CausalMask>(maps[0], maps[1], maps[2], p, stream);
}

}  // namespace

// q, k, v, out (B, H, N, D); ids (N,) int32, nondecreasing. bf16 (dtype 1):
// D 64 or 128; row_end (N,) int32 the keys each query sees (ids <= its
// id); `strides` holds the (b, h, n) element strides of q, k, v and
// out in that order (last dims contiguous; q, k, v strides multiples of 8
// and bases 16-byte aligned); key_end and full_end are the key counts of
// the core's query tiles (FlashConfig<D>::kBQ rows: 192 at D = 64, 128 at
// D = 128), ids <= the id of the tile's last and first query. float32
// (dtype 0): contiguous tensors, D in {16, 32, ..., 128}, N at most
// 65535 * 16; strides, row_end, key_end and full_end unused.
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for an unsupported shape).
extern "C" int mdvt_block_causal_attention(const void* q, const void* k,
                                           const void* v, const int* ids,
                                           const int* row_end,
                                           const int* key_end,
                                           const int* full_end, void* out,
                                           int B, int H, int N, int D,
                                           const long long* strides,
                                           float sm_scale, int dtype,
                                           void* stream) {
  if (B == 0 || H == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 64:
        return launch_bf16<64>(q, k, v, row_end, key_end, full_end, out, B,
                               H, N, strides, sm_scale, s);
      case 128:
        return launch_bf16<128>(q, k, v, row_end, key_end, full_end, out, B,
                                H, N, strides, sm_scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if ((N + kFQ - 1) / kFQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int BH = B * H;
  switch (D) {
    case 16: return launch_f32<16>(q, k, v, ids, out, BH, N, sm_scale, s);
    case 32: return launch_f32<32>(q, k, v, ids, out, BH, N, sm_scale, s);
    case 48: return launch_f32<48>(q, k, v, ids, out, BH, N, sm_scale, s);
    case 64: return launch_f32<64>(q, k, v, ids, out, BH, N, sm_scale, s);
    case 80: return launch_f32<80>(q, k, v, ids, out, BH, N, sm_scale, s);
    case 96: return launch_f32<96>(q, k, v, ids, out, BH, N, sm_scale, s);
    case 112: return launch_f32<112>(q, k, v, ids, out, BH, N, sm_scale, s);
    case 128: return launch_f32<128>(q, k, v, ids, out, BH, N, sm_scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Block-causal flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel
//   metric_depth_video_toolbox_tpu/ops/blockcausal_pallas.py
//   _kernel / block_causal_flash_attention
// and computes the same function: q, k, v (B, H, N, D); query i attends key
// j iff ids[j] <= ids[i] (ids (N,) int32, shared by every (b, h)); softmax
// scaled by sm_scale, accumulated with the online-softmax recurrence in
// float32 (running max m, running sum l, accumulator o). A key tile is
// skipped when no key in it is visible to any query of the block's tile,
// i.e. min(kid) > max(qid), the Pallas kernel's test. The ragged tail is
// bounded in the kernel (keys j >= N are never read, queries i >= N never
// written), so callers need no padding; a caller that pads with the JAX
// package's convention (pad queries id max, pad keys id max + 1) gets the
// same real rows.
//
// What bounds it on the H100. The work is the visible part of QK^T and PV:
// 4 * D flops per visible (query, key) pair, ~1.35e12 at the Wan phase's
// (1, 12, 18720, 128) with 4 causal blocks, 1.36 ms at the 989 TFLOP/s of
// the bf16 tensor cores; q, k, v and out are ~230 MB, 0.07 ms at 3.35 TB/s.
// So it is bound by operations, and only a tensor-core kernel comes near.
//
// What the design does about that (bf16). One block of 4 warps per (b, h,
// 64-query tile), one grid launch for every (b, h). Each warp owns 16 query
// rows, holds its Q fragments in registers for the whole key loop, and runs
// both products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate): S = Q K^T for a 64-key tile, then the mask (skipped for a
// tile every query of the block sees whole), the online softmax in
// registers in the exp2 domain (row max and sum across the 4 lanes that
// share a row), P rounded to bf16 as the A operand (the Pallas kernel's
// p.astype(v.dtype)), and O += P V. K and V tiles are copied into shared
// memory with cp.async, two stages deep, so the next live tile loads while
// this one computes; ldmatrix (and ldmatrix.trans for V) feeds the B
// operands, with rows padded by 8 elements so its 8 row reads hit 32
// distinct banks. This is the simple form; wgmma, TMA and warp
// specialisation are later work.
//
// float32 path: plain FMAs (no TF32), for holding the kernel against the
// CPU. 8 threads share a query row of a 16-query tile; scores, softmax and
// P V run from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr float kNegInit = -1e30f;   // running max before any visible key

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// ---------------------------------------------------------------- bf16 ----

constexpr int kBQ = 64;   // queries per block (16 per warp)
constexpr int kBK = 64;   // keys per tile
constexpr int kWarps = 4;
constexpr int kPad = 8;   // bf16 elements of row padding in shared memory

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros (keys past the tail)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 address the
// rows of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Shared memory of the bf16 kernel: two stages of (K, V) tiles, each
// 64 x (D + 8) bf16, and two stages of the tile's key ids.
template <int D>
constexpr size_t bf16_smem_bytes() {
  return 2 * 2 * kBK * (D + kPad) * sizeof(__nv_bfloat16) +
         2 * kBK * sizeof(int);
}

// First key tile at or after `tile` that some query of the block sees
// (min kid <= qmax, as the Pallas kernel's skip test); ntiles if none.
// Uniform across the block (it is a block-wide vote).
__device__ __forceinline__ int next_live_tile(const int* __restrict__ ids,
                                              int tile, int ntiles, int N,
                                              int qmax) {
  for (; tile < ntiles; ++tile) {
    const int j = tile * kBK + threadIdx.x;
    const bool vis = threadIdx.x < kBK && j < N && ids[j] <= qmax;
    if (__syncthreads_or(vis)) break;
  }
  return tile;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
bc_attn_bf16(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const int* __restrict__ ids, __nv_bfloat16* __restrict__ out,
             int N, float sm_scale) {
  constexpr int KS = D / 16;   // k-steps of the QK^T product
  constexpr int DN = D / 8;    // n-tiles of the PV product
  constexpr int ROW = D + kPad;
  constexpr int STAGE = kBK * ROW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + 2 * STAGE;
  int* s_kid = reinterpret_cast<int*>(Vs + 2 * STAGE);   // [2][kBK]
  __shared__ int s_qmax, s_qmin;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;      // row within the 8-row group
  const int t = lane % 4;      // column pair
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (N + kBK - 1) / kBK;
  const size_t base = static_cast<size_t>(blockIdx.y) * N * D;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const bool ok_a = row_a < N;
  const bool ok_b = row_b < N;
  const int qid_a = ok_a ? ids[row_a] : INT_MIN;
  const int qid_b = ok_b ? ids[row_b] : INT_MIN;
  if (tid == 0) {
    s_qmax = INT_MIN;
    s_qmin = INT_MAX;
  }
  __syncthreads();
  if (t == 0) {
    if (ok_a) { atomicMax(&s_qmax, qid_a); atomicMin(&s_qmin, qid_a); }
    if (ok_b) { atomicMax(&s_qmax, qid_b); atomicMin(&s_qmin, qid_b); }
  }

  // Q fragments (A operand, row-major 16x16 per k-step), kept in registers
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c0 = ks * 16 + 2 * t;
    qa[ks][0] = ok_a ? *reinterpret_cast<const uint32_t*>(
                           qb + static_cast<size_t>(row_a) * D + c0) : 0u;
    qa[ks][1] = ok_b ? *reinterpret_cast<const uint32_t*>(
                           qb + static_cast<size_t>(row_b) * D + c0) : 0u;
    qa[ks][2] = ok_a ? *reinterpret_cast<const uint32_t*>(
                           qb + static_cast<size_t>(row_a) * D + c0 + 8) : 0u;
    qa[ks][3] = ok_b ? *reinterpret_cast<const uint32_t*>(
                           qb + static_cast<size_t>(row_b) * D + c0 + 8) : 0u;
  }
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.0f;
  // running max in the log2 domain: scores are scaled by sm_scale*log2(e)
  // so that exp(s - m) becomes exp2(s2 - m2)
  const float scale2 = sm_scale * 1.4426950408889634f;
  float m_a = kNegInit, m_b = kNegInit, l_a = 0.0f, l_b = 0.0f;
  __syncthreads();
  const int qmax = s_qmax;
  const int qmin = s_qmin;

  // stage a tile's K, V (cp.async, zero past the tail) and its ids
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    __nv_bfloat16* ks_ = Ks + stage * STAGE;
    __nv_bfloat16* vs_ = Vs + stage * STAGE;
    for (int c = tid; c < kBK * (D / 8); c += kWarps * 32) {
      const int j = c / (D / 8);
      const int d0 = (c % (D / 8)) * 8;
      const bool in = k0 + j < N;
      const size_t off = in ? static_cast<size_t>(k0 + j) * D + d0 : 0;
      cp_async16(ks_ + j * ROW + d0, kb + off, in);
      cp_async16(vs_ + j * ROW + d0, vb + off, in);
    }
    if (tid < kBK) {
      const int j = k0 + tid;
      s_kid[stage * kBK + tid] = j < N ? ids[j] : INT_MAX;
    }
  };

  int cur = next_live_tile(ids, 0, ntiles, N, qmax);
  if (cur < ntiles) load_tile(cur, 0);
  cp_async_commit();
  for (int stage = 0; cur < ntiles; stage ^= 1) {
    const int nxt = next_live_tile(ids, cur + 1, ntiles, N, qmax);
    if (nxt < ntiles) load_tile(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait_one();       // this tile's copies have landed
    // keys all visible to every query of the block: no per-element mask
    const int k0 = cur * kBK;
    const int* kid = s_kid + stage * kBK;
    const bool full = __syncthreads_and(
        tid >= kBK || (k0 + tid < N && kid[tid] <= qmin));
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

    // mask, scale, row max (a row's 64 scores sit on 4 lanes)
    float mx_a = kNegInit, mx_b = kNegInit;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[nt][e] * scale2;
        if (!full) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const int qid = e < 2 ? qid_a : qid_b;
          if (!(k0 + col < N && kid[col] <= qid)) val = neg_inf();
        }
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
  __nv_bfloat16* ob = out + base;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int c0 = dn * 8 + 2 * t;
    if (ok_a)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row_a) * D + c0) =
          pack_bf16(o[dn][0] * inv_a, o[dn][1] * inv_a);
    if (ok_b)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row_b) * D + c0) =
          pack_bf16(o[dn][2] * inv_b, o[dn][3] * inv_b);
  }
}

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
  const int q0 = blockIdx.x * kFQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * N * D;
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
int launch(const void* q, const void* k, const void* v, const int* ids,
           void* out, int BH, int N, float sm_scale, int bf16,
           cudaStream_t stream) {
  if (bf16) {
    constexpr size_t smem = bf16_smem_bytes<D>();
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          bc_attn_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    dim3 grid((N + kBQ - 1) / kBQ, BH);
    bc_attn_bf16<D><<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), ids,
        static_cast<__nv_bfloat16*>(out), N, sm_scale);
  } else {
    dim3 grid((N + kFQ - 1) / kFQ, BH);
    bc_attn_f32<D><<<grid, kFThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), ids, static_cast<float*>(out), N,
        sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out (B, H, N, D) contiguous, bf16 (dtype 1) or float32 (dtype
// 0), 16-byte aligned; ids (N,) int32. D in {16, 32, ..., 128}. Launches
// on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported D).
extern "C" int mdvt_block_causal_attention(const void* q, const void* k,
                                           const void* v, const int* ids,
                                           void* out, int B, int H, int N,
                                           int D, float sm_scale, int dtype,
                                           void* stream) {
  if (B == 0 || H == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  switch (D) {
    case 16: return launch<16>(q, k, v, ids, out, BH, N, sm_scale, dtype, s);
    case 32: return launch<32>(q, k, v, ids, out, BH, N, sm_scale, dtype, s);
    case 48: return launch<48>(q, k, v, ids, out, BH, N, sm_scale, dtype, s);
    case 64: return launch<64>(q, k, v, ids, out, BH, N, sm_scale, dtype, s);
    case 80: return launch<80>(q, k, v, ids, out, BH, N, sm_scale, dtype, s);
    case 96: return launch<96>(q, k, v, ids, out, BH, N, sm_scale, dtype, s);
    case 112: return launch<112>(q, k, v, ids, out, BH, N, sm_scale, dtype, s);
    case 128: return launch<128>(q, k, v, ids, out, BH, N, sm_scale, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

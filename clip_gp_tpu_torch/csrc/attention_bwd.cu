// Attention-core backward of K3: the per-head loop of _ln_attn_bwd_kernel
// (clip_gp_tpu/ops/flash_attention.py) for head width 64 and sequences of
// at most 256 tokens, all in fp32.
//
// In:  qkv [B, N, 3D] fp32, recomputed (LN(x)·Wqkv + bqkv, gemm_bwd.cu);
//      d_attn [B, N, D] fp32 = dout·Woutᵀ, the gradient at every head's
//      output (the Pallas kernel forms it per head); optional additive
//      fp32 mask [N, N].
// Out: dqkv [B, N, 3D] fp32 (dq | dk | dv); optionally attn [B, N, D], the
//      recomputed head outputs, for dWout = attnᵀ·dout.
// Per head, as the Pallas kernel: q_s = q/8, P = softmax(q_s·kᵀ + mask)
// (max-subtracted exp over exactly the N keys, divided by the row sum),
// out = P·v, dP = d_out·vᵀ, dS = P∘(dP − δ) with δ_i = Σ_j dP_ij P_ij,
// dq = dS·k/8, dk = dSᵀ·q_s, dv = Pᵀ·d_out. δ_i is taken as
// d_out_i·out_i, the same sum regrouped.
//
// Two kernels, the FlashAttention-2 split: attn_bwd_q runs one block per
// (64-query tile, head, batch element) with the head's K and V in shared
// memory, and writes dq, the head outputs and each query row's softmax max,
// sum and δ; attn_bwd_kv runs one block per (64-key tile, head, batch
// element) with the head's scaled Q and d_out in shared memory, recomputes
// P and dS for its keys from those row statistics, and writes dk and dv.
// Every sum has one owner: no atomics, and the bits repeat run to run. The
// scores are formed with the same FMA order in both kernels, so P is the
// same in both. The [N, N] matrices never reach device memory. Keys are
// exactly the N real tokens (no padding keys at -inf), so with a causal
// mask no query row is masked throughout.
//
// What bounds it on an H100: operations, 12·B·N²·D FLOPs (the two kernels
// do 16, forming the scores and dP twice) for B·N·5D fp32 inputs and
// outputs. It is a small part of K3 at N = 24 and a tenth at N = 77. This
// first version runs on the CUDA cores: a warp walks one query (or key)
// row at a time, each lane holds up to 8 keys (or queries), and each lane
// owns 2 of the 64 output columns of the row's dq (or dk, dv).
#include "common.cuh"

using namespace cgt;

namespace {

constexpr int DH = 64;        // head width
constexpr int TILE = 64;      // query or key rows per block
constexpr int WARPS = 8;      // 256 threads
constexpr int MAX_N = 256;    // 8 rows per lane
constexpr int SLOTS = MAX_N / 32;
constexpr int LD = DH + 1;    // padded rows: lanes reading distinct rows
                              // hit distinct banks

__host__ __device__ inline int padded(int n) { return (n + 31) / 32 * 32; }

// shared memory of either kernel: two [N][LD] operands, two [TILE][DH]
// tiles, per-warp P and dS rows, (kv kernel) three [N] statistics
size_t smem_bytes(int n) {
  return sizeof(float) * ((size_t)2 * n * LD + 2 * TILE * DH +
                          2 * WARPS * padded(n) + 3 * padded(n));
}

__global__ void __launch_bounds__(WARPS * 32)
    attn_bwd_q_kernel(const float* __restrict__ qkv,
                      const float* __restrict__ d_attn,
                      const float* __restrict__ mask,
                      float* __restrict__ dqkv, float* __restrict__ attn,
                      float* __restrict__ row_stats, int N, int H, int D) {
  extern __shared__ float smem[];
  const int np = padded(N);
  float* Ks = smem;                        // [N][LD]
  float* Vs = Ks + (size_t)N * LD;         // [N][LD]
  float* Qs = Vs + (size_t)N * LD;         // [TILE][DH], scaled q
  float* Os = Qs + TILE * DH;              // [TILE][DH], d_out
  float* Pw = Os + TILE * DH;              // [WARPS][np]
  float* Sw = Pw + WARPS * np;             // [WARPS][np]
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const size_t stride = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * N * stride;
  const float scale = 1.f / sqrtf((float)DH);  // exactly 0.125

  for (int idx = threadIdx.x; idx < N * DH; idx += blockDim.x) {
    const int j = idx / DH, d = idx % DH;
    const float* row = base + j * stride + h * DH + d;
    Ks[j * LD + d] = row[D];
    Vs[j * LD + d] = row[2 * D];
  }
  for (int idx = threadIdx.x; idx < TILE * DH; idx += blockDim.x) {
    const int i = idx / DH, d = idx % DH, qi = q0 + i;
    const bool in = qi < N;
    Qs[idx] = in ? base[qi * stride + h * DH + d] * scale : 0.f;
    Os[idx] = in ? d_attn[((size_t)b * N + qi) * D + h * DH + d] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* P = Pw + warp * np;
  float* S = Sw + warp * np;
  const int slots = (N + 31) / 32;
  for (int i = warp; i < TILE; i += WARPS) {
    const int qi = q0 + i;
    if (qi >= N) break;  // uniform across the warp
    const float* q = Qs + i * DH;
    const float* o = Os + i * DH;
    float s[SLOTS], dp[SLOTS];
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) s[t] = dp[t] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float qd = q[d], od = o[d];
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        if (t < slots) {
          const int j = min(lane + 32 * t, N - 1);  // clamped; discarded below
          s[t] = fmaf(qd, Ks[j * LD + d], s[t]);
          dp[t] = fmaf(od, Vs[j * LD + d], dp[t]);
        }
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int j = lane + 32 * t;
      if (t < slots && j < N) {
        if (mask != nullptr) s[t] += mask[(size_t)qi * N + j];
        mx = fmaxf(mx, s[t]);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int j = lane + 32 * t;
      s[t] = (t < slots && j < N) ? expf(s[t] - mx) : 0.f;
      sum += s[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int j = lane + 32 * t;
      s[t] /= sum;  // P
      if (t < slots && j < N) P[j] = s[t];
    }
    __syncwarp();
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < N; ++j) {
      const float p = P[j];
      o0 = fmaf(p, Vs[j * LD + lane], o0);
      o1 = fmaf(p, Vs[j * LD + lane + 32], o1);
    }
    const float delta = warp_sum(o0 * o[lane] + o1 * o[lane + 32]);
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int j = lane + 32 * t;
      if (t < slots && j < N) S[j] = s[t] * (dp[t] - delta);
    }
    __syncwarp();
    float g0 = 0.f, g1 = 0.f;
    for (int j = 0; j < N; ++j) {
      const float ds = S[j];
      g0 = fmaf(ds, Ks[j * LD + lane], g0);
      g1 = fmaf(ds, Ks[j * LD + lane + 32], g1);
    }
    float* drow = dqkv + ((size_t)b * N + qi) * stride + h * DH;
    drow[lane] = g0 * scale;
    drow[lane + 32] = g1 * scale;
    if (attn != nullptr) {
      float* arow = attn + ((size_t)b * N + qi) * D + h * DH;
      arow[lane] = o0;
      arow[lane + 32] = o1;
    }
    if (lane == 0) {
      float* st = row_stats + (((size_t)b * H + h) * N + qi) * 3;
      st[0] = mx;
      st[1] = sum;
      st[2] = delta;
    }
    __syncwarp();  // P and S are rewritten by the warp's next query
  }
}

__global__ void __launch_bounds__(WARPS * 32)
    attn_bwd_kv_kernel(const float* __restrict__ qkv,
                       const float* __restrict__ d_attn,
                       const float* __restrict__ mask,
                       const float* __restrict__ row_stats,
                       float* __restrict__ dqkv, int N, int H, int D) {
  extern __shared__ float smem[];
  const int np = padded(N);
  float* Qs = smem;                        // [N][LD], scaled q
  float* Os = Qs + (size_t)N * LD;         // [N][LD], d_out
  float* Kt = Os + (size_t)N * LD;         // [TILE][DH]
  float* Vt = Kt + TILE * DH;              // [TILE][DH]
  float* Pw = Vt + TILE * DH;              // [WARPS][np]
  float* Sw = Pw + WARPS * np;             // [WARPS][np]
  float* Mx = Sw + WARPS * np;             // [np] row max
  float* Sm = Mx + np;                     // [np] row sum
  float* Dl = Sm + np;                     // [np] row delta
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const size_t stride = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * N * stride;
  const float scale = 1.f / sqrtf((float)DH);

  for (int idx = threadIdx.x; idx < N * DH; idx += blockDim.x) {
    const int i = idx / DH, d = idx % DH;
    Qs[i * LD + d] = base[i * stride + h * DH + d] * scale;
    Os[i * LD + d] = d_attn[((size_t)b * N + i) * D + h * DH + d];
  }
  for (int idx = threadIdx.x; idx < TILE * DH; idx += blockDim.x) {
    const int j = idx / DH, d = idx % DH, kj = k0 + j;
    const bool in = kj < N;
    Kt[idx] = in ? base[kj * stride + D + h * DH + d] : 0.f;
    Vt[idx] = in ? base[kj * stride + 2 * D + h * DH + d] : 0.f;
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float* st = row_stats + (((size_t)b * H + h) * N + i) * 3;
    Mx[i] = st[0];
    Sm[i] = st[1];
    Dl[i] = st[2];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* P = Pw + warp * np;
  float* S = Sw + warp * np;
  const int slots = (N + 31) / 32;
  for (int jj = warp; jj < TILE; jj += WARPS) {
    const int kj = k0 + jj;
    if (kj >= N) break;  // uniform across the warp
    const float* k = Kt + jj * DH;
    const float* v = Vt + jj * DH;
    float s[SLOTS], dp[SLOTS];
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) s[t] = dp[t] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float kd = k[d], vd = v[d];
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        if (t < slots) {
          const int i = min(lane + 32 * t, N - 1);  // clamped; discarded below
          s[t] = fmaf(Qs[i * LD + d], kd, s[t]);
          dp[t] = fmaf(Os[i * LD + d], vd, dp[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int i = lane + 32 * t;
      if (t < slots && i < N) {
        float sc = s[t];
        if (mask != nullptr) sc += mask[(size_t)i * N + kj];
        const float p = expf(sc - Mx[i]) / Sm[i];
        P[i] = p;
        S[i] = p * (dp[t] - Dl[i]);
      }
    }
    __syncwarp();
    float v0 = 0.f, v1 = 0.f, k0s = 0.f, k1s = 0.f;
    for (int i = 0; i < N; ++i) {
      const float p = P[i], ds = S[i];
      v0 = fmaf(p, Os[i * LD + lane], v0);
      v1 = fmaf(p, Os[i * LD + lane + 32], v1);
      k0s = fmaf(ds, Qs[i * LD + lane], k0s);
      k1s = fmaf(ds, Qs[i * LD + lane + 32], k1s);
    }
    float* drow = dqkv + ((size_t)b * N + kj) * stride + h * DH;
    drow[D + lane] = k0s;
    drow[D + lane + 32] = k1s;
    drow[2 * D + lane] = v0;
    drow[2 * D + lane + 32] = v1;
    __syncwarp();  // P and S are rewritten by the warp's next key
  }
}

// the shared-memory opt-in is a property of a function on a device: set it
// once per device, not on every launch
int opt_in_smem() {
  static unsigned long long opted_in = 0;  // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && ((opted_in >> dev) & 1ull)) return 0;
  const int bytes = (int)smem_bytes(MAX_N);
  err = cudaFuncSetAttribute(attn_bwd_q_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_kv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) opted_in |= 1ull << dev;
  return 0;
}

}  // namespace

// row_stats: fp32 scratch of B·H·N·3 floats; attn may be null (no dWout)
extern "C" int cgt_attention_bwd(const void* qkv, const void* d_attn,
                                 const void* mask, void* dqkv, void* attn,
                                 void* row_stats, int B, int N, int H, int D,
                                 void* stream) {
  if (N < 1 || N > MAX_N || D != H * DH) return (int)cudaErrorInvalidValue;
  const int rc = opt_in_smem();
  if (rc != 0) return rc;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((N + TILE - 1) / TILE, H, B), block(WARPS * 32);
  const size_t bytes = smem_bytes(N);
  attn_bwd_q_kernel<<<grid, block, bytes, s>>>(
      (const float*)qkv, (const float*)d_attn, (const float*)mask,
      (float*)dqkv, (float*)attn, (float*)row_stats, N, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_kv_kernel<<<grid, block, bytes, s>>>(
      (const float*)qkv, (const float*)d_attn, (const float*)mask,
      (const float*)row_stats, (float*)dqkv, N, H, D);
  return (int)cudaGetLastError();
}

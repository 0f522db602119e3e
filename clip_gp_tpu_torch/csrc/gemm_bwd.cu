// fp32 matrix products of the backward kernels K3 and K4: the dot_generals
// inside _ln_attn_bwd_kernel and _ln_mlp_bwd_kernel of
// clip_gp_tpu/ops/flash_attention.py, which run every product in fp32
// (the weights upcast, the block recomputed from x).
//
//   out[M,N] = epilogue( sum_k prologue(A)(m,k) * B(k,n) )
//
// A and B are each read as stored ("N": A [M,K], B [K,N]) or transposed
// ("T": A stored [K,M], B stored [N,K]), all contiguous. The products:
//   kOpLnNNBias    qkv / hid_pre = LN(x)·W + b         A = x (T), LN prologue
//   kOpNT          d_attn = dout·Woutᵀ, dh = dqkv·Wqkvᵀ, dh = dhid·Wfcᵀ
//   kOpNTGeluBwd   dhid = (dout·Wprojᵀ) * QuickGELU'(hid_pre)
//   kOpLnTN        dWqkv = LN(x)ᵀ·dqkv, dWfc = LN(x)ᵀ·dhid
//   kOpTN          dWout = attnᵀ·dout
//   kOpGeluTN      dWproj = QuickGELU(hid_pre)ᵀ·dout
// One operand ("io": A of the first four, B of the last two) is x or dout,
// read in the working type (fp32 or bf16) and upcast; every other operand
// is fp32. The LN prologue is the backward kernels' fp32 recompute,
// ((x - mean)·rstd)·γ + β, from fp32 row statistics (ln_stats_kernel); the
// normalised activation never goes to device memory. Output is fp32.
//
// The weight gradients sum over all T = B·N rows. On the TPU they
// accumulate in a constant output block across the sequential grid; here a
// T·N product may split its K (= T) rows into `splits` ranges (blockIdx.z),
// each writing its own [M,N] part, and cgt_sum_parts (ln_bwd.cu) adds the
// parts in a fixed order: no atomics, the same bits on every run.
//
// What bounds it on an H100: operations. K4 with every gradient at
// B=256, N=24, D=512 is 6.4e10 FLOPs on 25 MB of inputs and outputs
// (x, dout, weights, gradients), about 2,500 FLOPs per byte against the
// fp32 CUDA cores' ridge of 20. This first version is the simple tiled
// kernel of ln_gemm.cu's fp32 path: 128x128 output tiles, each thread an
// 8x8 block of fp32 FMAs from shared memory, the prologue applied while a
// tile is loaded and the epilogue in registers before the one store. Not
// yet done: tensor cores (3xTF32 or bf16 with fp32 accumulation would not
// hold the 1e-4 contract as is), cp.async pipelining.
#include "common.cuh"

using namespace cgt;

namespace {

enum Op {
  kOpLnNNBias = 0,
  kOpNT = 1,
  kOpNTGeluBwd = 2,
  kOpLnTN = 3,
  kOpTN = 4,
  kOpGeluTN = 5,
};
enum Prologue { kProNone, kProLn, kProGelu };
enum Epi { kEpiNone, kEpiBias, kEpiGeluBwd };

constexpr int BM = 128, BN = 128, BK = 8;

__device__ __forceinline__ float quick_gelu_sigmoid(float h) {
  return 1.f / (1.f + expf(-1.702f * h));
}

// A element of the source at (row r, col c) after the prologue
template <int PRO, typename TA>
__device__ __forceinline__ float prologue(const TA* A, int ld, int r, int c,
                                          const float2* stats,
                                          const float* gamma,
                                          const float* beta) {
  const float v = to_f32(A[(size_t)r * ld + c]);
  if constexpr (PRO == kProLn) {
    const float2 st = stats[r];
    return (v - st.x) * st.y * gamma[c] + beta[c];
  } else if constexpr (PRO == kProGelu) {
    return v * quick_gelu_sigmoid(v);
  } else {
    return v;
  }
}

template <int PRO, int EPI, bool TRANS_A, bool TRANS_B, typename TA,
          typename TB>
__global__ void __launch_bounds__(256)
    gemm_bwd_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
                    const float* __restrict__ bias,
                    const float* __restrict__ aux,
                    const float2* __restrict__ stats,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ out,
                    int M, int N, int K, int k_chunk) {
  __shared__ __align__(16) float As[BK][BM + 4];  // As[k][m]
  __shared__ __align__(16) float Bs[BK][BN + 4];  // Bs[k][n]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  out += (size_t)blockIdx.z * M * N;  // this split's part
  const int tx = tid & 15, ty = tid >> 4;
  // loader coordinates: "row-major" tiles are 128 rows x 8 k (two threads
  // a row, 4 k each); "k-major" tiles are 8 k x 128 columns (32 threads a k
  // row, 4 columns each)
  const int r_row = tid >> 1, r_k = (tid & 1) * 4;
  const int c_k = tid >> 5, c_col = (tid & 31) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    if constexpr (!TRANS_A) {  // source [M, K]
      const int m = m0 + r_row;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + r_k + i;
        As[r_k + i][r_row] =
            (m < M && k < k_end)
                ? prologue<PRO>(A, K, m, k, stats, gamma, beta)
                : 0.f;
      }
    } else {  // source [K, M]
      const int k = k0 + c_k;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + c_col + i;
        As[c_k][c_col + i] =
            (m < M && k < k_end)
                ? prologue<PRO>(A, M, k, m, stats, gamma, beta)
                : 0.f;
      }
    }
    if constexpr (!TRANS_B) {  // source [K, N]
      const int k = k0 + c_k;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + c_col + i;
        Bs[c_k][c_col + i] =
            (n < N && k < k_end) ? to_f32(B[(size_t)k * N + n]) : 0.f;
      }
    } else {  // source [N, K]
      const int n = n0 + r_row;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + r_k + i;
        Bs[r_k + i][r_row] =
            (n < N && k < k_end) ? to_f32(B[(size_t)n * K + k]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      const size_t idx = (size_t)m * N + n;
      float v = acc[i][j];
      if constexpr (EPI == kEpiBias) {
        v += bias[n];
      } else if constexpr (EPI == kEpiGeluBwd) {
        // d/dh [h·s(1.702h)] = s + 1.702·h·s·(1 - s), as the Pallas kernel
        const float h = aux[idx];
        const float s = quick_gelu_sigmoid(h);
        v *= s + 1.702f * h * s * (1.f - s);
      }
      out[idx] = v;
    }
  }
}

template <int PRO, int EPI, bool TRANS_A, bool TRANS_B, typename TA,
          typename TB>
int launch(const void* a, const void* b, const void* bias, const void* aux,
           const void* stats, const void* gamma, const void* beta, void* out,
           int M, int N, int K, int splits, cudaStream_t s) {
  // each split's K range is a whole number of BK tiles
  const int per = (K + splits - 1) / splits;
  const int k_chunk = (per + BK - 1) / BK * BK;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_bwd_kernel<PRO, EPI, TRANS_A, TRANS_B, TA, TB><<<grid, 256, 0, s>>>(
      (const TA*)a, (const TB*)b, (const float*)bias, (const float*)aux,
      (const float2*)stats, (const float*)gamma, (const float*)beta,
      (float*)out, M, N, K, k_chunk);
  return (int)cudaGetLastError();
}

// T: the working type of the io operand
template <typename T>
int dispatch(int op, const void* a, const void* b, const void* bias,
             const void* aux, const void* stats, const void* gamma,
             const void* beta, void* out, int M, int N, int K, int splits,
             cudaStream_t s) {
  switch (op) {
    case kOpLnNNBias:
      return launch<kProLn, kEpiBias, false, false, T, float>(
          a, b, bias, aux, stats, gamma, beta, out, M, N, K, splits, s);
    case kOpNT:
      return launch<kProNone, kEpiNone, false, true, T, float>(
          a, b, bias, aux, stats, gamma, beta, out, M, N, K, splits, s);
    case kOpNTGeluBwd:
      return launch<kProNone, kEpiGeluBwd, false, true, T, float>(
          a, b, bias, aux, stats, gamma, beta, out, M, N, K, splits, s);
    case kOpLnTN:
      return launch<kProLn, kEpiNone, true, false, T, float>(
          a, b, bias, aux, stats, gamma, beta, out, M, N, K, splits, s);
    case kOpTN:
      return launch<kProNone, kEpiNone, true, false, float, T>(
          a, b, bias, aux, stats, gamma, beta, out, M, N, K, splits, s);
    case kOpGeluTN:
      return launch<kProGelu, kEpiNone, true, false, float, T>(
          a, b, bias, aux, stats, gamma, beta, out, M, N, K, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out holds `splits` parts of [M, N] (one unless a T·N product splits K);
// bias is read by kOpLnNNBias only, aux by kOpNTGeluBwd only, stats/gamma/
// beta by the LN prologues only; the others may be null
extern "C" int cgt_gemm_bwd(const void* a, const void* b, const void* bias,
                            const void* aux, const void* stats,
                            const void* gamma, const void* beta, void* out,
                            int M, int N, int K, int splits, int dtype, int op,
                            void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || splits > 64)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return dispatch<float>(op, a, b, bias, aux, stats, gamma, beta, out, M,
                           N, K, splits, s);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(op, a, b, bias, aux, stats, gamma, beta,
                                   out, M, N, K, splits, s);
  return (int)cudaErrorInvalidValue;
}

// LN-prologue GEMM with a fused epilogue: the four matrix products inside
// the Pallas kernels _fused_ln_block_kernel (K1) and _fused_mlp_kernel (K2)
// of clip_gp_tpu/ops/flash_attention.py, the two of _fused_block_kernel (K8)
// of the same file, plus the LayerNorm row statistics they need.
//
//   out[M,N] = epilogue( prologue(A)[M,K] @ W[K,N] )
//
// prologue: LayerNorm of each A row (fp32 mean/rstd from ln_stats_kernel,
//           fp32 gamma/beta), rounded to the working type as the Pallas
//           kernel rounds ``h.astype(x.dtype)``; used by the qkv projection
//           (K1) and c_fc (K2). The out-projection and c_proj read A as is.
// epilogue: K1 qkv:      T(T(acc) + b)       (the kernel rounds the product
//                                             before adding b_qkv)
//           K8 qkv and out-proj: T(T(acc) + b), the same without the LN
//                                prologue (b_out is added after the sum is
//                                rounded, in T: the wrapper passes b rounded)
//           K2 c_fc:     T(gelu(acc + b))    (QuickGELU in fp32)
//           K1 out-proj: T((r + acc) + b)    (residual + bias in fp32)
//           K2 c_proj:   T(r + (acc + b))
//
// What bounds it on an H100: operations. At ViT-B/16 batch 32 the K1 and K2
// blocks must move some 24 and 29 MB in bf16 for 34 and 60 GFLOP, about
// 1,400 and 2,000 FLOPs per byte (half that in fp32), above the card's ridge
// of about 295 FLOPs per byte for bf16 tensor cores and 20 for fp32 CUDA
// cores. This first version does
// what a simple kernel can: 128x128 output tiles so each A/W element read
// from device memory feeds 128 multiply-adds, LayerNorm applied while the A
// tile is loaded (the normalised activation never goes to device memory),
// and the epilogue applied in registers before the single store. fp32 runs on
// the CUDA cores (8x8 outer products per thread); bf16 runs on the tensor
// cores through WMMA (mma.sync) with fp32 accumulation. Not yet done, and
// left for the PRs that make it fast: wgmma and TMA, multi-stage cp.async
// pipelining, and keeping the qkv/hidden intermediates on chip.
#include <mma.h>

#include "common.cuh"

using namespace cgt;

namespace {

enum Epilogue {
  kEpiQkv = 0,
  kEpiGelu = 1,
  kEpiResidAttn = 2,
  kEpiResidMlp = 3,
  kEpiBias = 4,
};

// the qkv and c_fc products normalise their input rows
template <int EPI>
constexpr bool kHasLn = (EPI == kEpiQkv || EPI == kEpiGelu);

template <int EPI, typename T>
__device__ __forceinline__ T apply_epilogue(float acc, float b, const T* resid,
                                            size_t idx) {
  if constexpr (EPI == kEpiQkv || EPI == kEpiBias) {
    return from_f32<T>(round_to<T>(acc) + b);
  } else if constexpr (EPI == kEpiGelu) {
    const float h = acc + b;
    return from_f32<T>(h * (1.f / (1.f + expf(-1.702f * h))));
  } else if constexpr (EPI == kEpiResidAttn) {
    return from_f32<T>((to_f32(resid[idx]) + acc) + b);
  } else {
    return from_f32<T>(to_f32(resid[idx]) + (acc + b));
  }
}

// one warp per row: two-pass fp32 mean and variance (eps 1e-5), as the
// Pallas kernel computes them
template <typename T>
__global__ void __launch_bounds__(256)
    ln_stats_kernel(const T* __restrict__ x, float2* __restrict__ stats,
                    int rows, int cols) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const T* xr = x + (size_t)row * cols;
  float s = 0.f;
  for (int c = lane; c < cols; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / (float)cols;
  float v = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_f32(xr[c]) - mean;
    v += d * d;
  }
  const float var = warp_sum(v) / (float)cols;
  if (lane == 0) stats[row] = make_float2(mean, rsqrtf(var + 1e-5f));
}

// ---------------------------------------------------------------- fp32 ----
constexpr int F_BM = 128, F_BN = 128, F_BK = 8;

template <int EPI>
__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                    const float* __restrict__ bias,
                    const float* __restrict__ resid,
                    const float2* __restrict__ stats,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ out,
                    int M, int N, int K) {
  __shared__ __align__(16) float As[F_BK][F_BM + 4];  // A tile, transposed
  __shared__ __align__(16) float Bs[F_BK][F_BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  const int tx = tid & 15, ty = tid >> 4;  // thread owns rows ty*4+{0..3},
                                           // 64+ty*4+{0..3}; same for cols
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_col = (tid & 31) * 4;
  const int gm = m0 + a_row;
  float2 st = make_float2(0.f, 1.f);
  if (kHasLn<EPI> && gm < M) st = stats[gm];

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + a_k + i;
      float v = 0.f;
      if (gm < M && k < K) {
        v = A[(size_t)gm * K + k];
        if (kHasLn<EPI>) v = (v - st.x) * st.y * gamma[k] + beta[k];
      }
      As[a_k + i][a_row] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + b_k, n = n0 + b_col + i;
      Bs[b_k][b_col + i] = (k < K && n < N) ? W[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
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
      if (n < N) {
        const size_t idx = (size_t)m * N + n;
        out[idx] = apply_epilogue<EPI, float>(acc[i][j], bias[n], resid, idx);
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 ----
constexpr int H_BM = 128, H_BN = 128, H_BK = 32;
constexpr int H_LDA = H_BK + 8;  // padded smem rows (elements)
constexpr int H_LDB = H_BN + 8;

// 8 warps as 2 (rows) x 4 (cols); each warp owns a 64x32 output block of
// 4x2 WMMA 16x16 fp32 accumulators. Requires K % 8 == 0, N % 8 == 0 and
// 16-byte aligned A/W/out (checked by the Python wrapper).
template <int EPI>
__global__ void __launch_bounds__(256)
    gemm_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                     const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ resid,
                     const float2* __restrict__ stats,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[H_BM * H_LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[H_BK * H_LDB];
  __shared__ __align__(128) float stage[8][16 * 16];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * H_BM, n0 = blockIdx.x * H_BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += H_BK) {
    // A tile: 128 rows x 32 k = 512 chunks of 8 elements (16 bytes)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = tid + r * 256;
      const int row = c >> 2, kc = (c & 3) * 8;
      const int gm = m0 + row, gk = k0 + kc;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M && gk < K) {
        packed = *reinterpret_cast<const uint4*>(A + (size_t)gm * K + gk);
        if (kHasLn<EPI>) {
          const float2 st = stats[gm];
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float v = (__bfloat162float(e[t]) - st.x) * st.y *
                                gamma[gk + t] +
                            beta[gk + t];
            e[t] = __float2bfloat16_rn(v);
          }
        }
      }
      *reinterpret_cast<uint4*>(&As[row * H_LDA + kc]) = packed;
    }
    // W tile: 32 k x 128 cols = 512 chunks of 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = tid + r * 256;
      const int row = c >> 4, nc = (c & 15) * 8;
      const int gk = k0 + row, gn = n0 + nc;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (gk < K && gn < N)
        packed = *reinterpret_cast<const uint4*>(W + (size_t)gk * N + gn);
      *reinterpret_cast<uint4*>(&Bs[row * H_LDB + nc]) = packed;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < H_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm + i * 16) * H_LDA + kk], H_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk * H_LDB + wn + j * 16], H_LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each 16x16 accumulator goes through the warp's staging tile
  // so every lane knows the (row, col) of the 8 values it finishes
  float* st = stage[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm + i * 16 + r;
      if (m < M) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int n = n0 + wn + j * 16 + c0 + t;
          if (n < N) {
            const size_t idx = (size_t)m * N + n;
            out[idx] = apply_epilogue<EPI, __nv_bfloat16>(
                st[r * 16 + c0 + t], bias[n], resid, idx);
          }
        }
      }
      __syncwarp();
    }
  }
}

template <int EPI>
int launch_gemm(const void* a, const void* w, const void* bias,
                const void* resid, const void* stats, const void* gamma,
                const void* beta, void* out, int M, int N, int K, int dtype,
                cudaStream_t s) {
  const dim3 block(256);
  if (dtype == kF32) {
    const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
    gemm_f32_kernel<EPI><<<grid, block, 0, s>>>(
        (const float*)a, (const float*)w, (const float*)bias,
        (const float*)resid, (const float2*)stats, (const float*)gamma,
        (const float*)beta, (float*)out, M, N, K);
  } else if (dtype == kBF16) {
    const dim3 grid((N + H_BN - 1) / H_BN, (M + H_BM - 1) / H_BM);
    gemm_bf16_kernel<EPI><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)w, (const float*)bias,
        (const __nv_bfloat16*)resid, (const float2*)stats, (const float*)gamma,
        (const float*)beta, (__nv_bfloat16*)out, M, N, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cgt_ln_stats(const void* x, void* stats, int rows, int cols,
                            int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((rows + 7) / 8), block(256);
  if (dtype == kF32) {
    ln_stats_kernel<float><<<grid, block, 0, s>>>((const float*)x,
                                                  (float2*)stats, rows, cols);
  } else if (dtype == kBF16) {
    ln_stats_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (float2*)stats, rows, cols);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// stats/gamma/beta are read by the LN epilogues (K1 qkv, c_fc) only, resid
// by the residual ones (out-proj, c_proj) only; the others may be null
extern "C" int cgt_gemm(const void* a, const void* w, const void* bias,
                        const void* resid, const void* stats,
                        const void* gamma, const void* beta, void* out, int M,
                        int N, int K, int dtype, int epilogue, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case kEpiQkv:
      return launch_gemm<kEpiQkv>(a, w, bias, resid, stats, gamma, beta, out,
                                  M, N, K, dtype, s);
    case kEpiGelu:
      return launch_gemm<kEpiGelu>(a, w, bias, resid, stats, gamma, beta, out,
                                   M, N, K, dtype, s);
    case kEpiResidAttn:
      return launch_gemm<kEpiResidAttn>(a, w, bias, resid, stats, gamma, beta,
                                        out, M, N, K, dtype, s);
    case kEpiResidMlp:
      return launch_gemm<kEpiResidMlp>(a, w, bias, resid, stats, gamma, beta,
                                       out, M, N, K, dtype, s);
    case kEpiBias:
      return launch_gemm<kEpiBias>(a, w, bias, resid, stats, gamma, beta, out,
                                   M, N, K, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

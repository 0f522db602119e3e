// The int8 parts of K5 and K6: _q8_ln_block_kernel and _q8_mlp_kernel of
// clip_gp_tpu/ops/int8_block.py (the int8 ViT image tower of serving). The
// attention core of K5, with its quantize epilogue, is in attention.cu.
//
//   quantize: (optional LayerNorm, fp32 gamma/beta) then per-row symmetric
//             int8: scale = max(absmax / 127, 1e-12), q = clip(rint(v /
//             scale), ±127). Rows of the working type T (LN of x) or of fp32
//             (the QuickGELU hidden). IEEE division and rintf (round half to
//             even, as jnp.round): CUDA's roundf rounds half away from zero.
//   gemm:     out[M,N] = epilogue(Σ_g (A·W)_g · row_scale[m, g] ·
//             col_scale[n]) with A int8 [M,K], W int8 [K,N] (the JAX
//             right-multiply layout), the products exact in int32 and the
//             sum over groups of `group_k` columns of K in fp32. One group
//             (group_k = K) for qkv, c_fc and c_proj; one group per 64-wide
//             head for K5's out-projection, whose activation scale changes
//             every head, so a single int8 sum over all of D would be wrong.
//             Epilogues, in fp32 with the Pallas kernels' order:
//               K5 qkv:      T(acc + b)
//               K6 c_fc:     fp32 QuickGELU(acc + b)   (the [T,4D] hidden)
//               K5 out-proj: T((x + acc) + b)
//               K6 c_proj:   T(x + (acc + b))
//             Multiplies and adds are __fmul_rn/__fadd_rn, so nvcc cannot
//             contract them into FMAs the plain version does not make.
//
// What bounds it on an H100: operations. At ViT-B/16 batch 512 K5 does
// 8·T·D² int8 operations (and the attention core 4·B·N²·D bf16 FLOPs) and K6
// 16·T·D², against some 0.3 and 0.5 GB moved. This first version does what a
// simple kernel can: 128x128 output tiles of mma.sync.m16n8k32 (int8 tensor
// cores, int32 accumulation) from 32-deep shared-memory tiles, W's tile
// transposed in registers (__byte_perm) on its way into shared memory so both
// operands are K-contiguous, and every epilogue applied in registers before
// the single store. Not yet done, and left for the PRs that make it fast:
// wgmma and TMA, cp.async pipelining, and keeping the fp32 [T,4D] hidden
// (1.24 GB at B=512) out of device memory.
#include <type_traits>

#include "common.cuh"

using namespace cgt;

namespace {

enum Epilogue {  // as ln_gemm.cu
  kEpiQkv = 0,
  kEpiGelu = 1,
  kEpiResidAttn = 2,
  kEpiResidMlp = 3,
};

// one warp per row, lanes on neighbouring columns; with gamma, the row is
// LayerNormed first (two-pass fp32 mean and variance, eps 1e-5) and the
// normalised value recomputed in each later pass (the same ops, the same
// bits)
template <typename T>
__global__ void __launch_bounds__(256)
    quantize_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, int8_t* __restrict__ q,
                    float* __restrict__ scale, int rows, int cols) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const T* xr = x + (size_t)row * cols;
  float mean = 0.f, rstd = 1.f;
  if (gamma != nullptr) {
    float s = 0.f;
    for (int c = lane; c < cols; c += 32) s += to_f32(xr[c]);
    mean = warp_sum(s) / (float)cols;
    float v = 0.f;
    for (int c = lane; c < cols; c += 32) {
      const float d = to_f32(xr[c]) - mean;
      v += d * d;
    }
    rstd = rsqrtf(warp_sum(v) / (float)cols + 1e-5f);
  }
  auto value = [&](int c) {
    const float v = to_f32(xr[c]);
    if (gamma == nullptr) return v;
    const float xhat = __fmul_rn(__fsub_rn(v, mean), rstd);
    return __fadd_rn(__fmul_rn(xhat, gamma[c]), beta[c]);
  };
  float amax = 0.f;
  for (int c = lane; c < cols; c += 32) amax = fmaxf(amax, fabsf(value(c)));
  const float sc = fmaxf(__fdiv_rn(warp_max(amax), 127.f), kQuantEps);
  int8_t* qr = q + (size_t)row * cols;
  for (int c = lane; c < cols; c += 32) qr[c] = quantize_code(value(c), sc);
  if (lane == 0) scale[row] = sc;
}

// ----------------------------------------------------------------- gemm ----
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 16;  // shared-memory row stride in bytes: the
                              // fragment loads of a warp hit distinct banks

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int EPI, typename T, typename OutT>
__device__ __forceinline__ OutT epilogue(float acc, float b, const T* resid,
                                         size_t idx) {
  if constexpr (EPI == kEpiQkv) {
    return from_f32<OutT>(__fadd_rn(acc, b));
  } else if constexpr (EPI == kEpiGelu) {
    const float h = __fadd_rn(acc, b);
    const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, h))));
    return __fmul_rn(h, s);
  } else if constexpr (EPI == kEpiResidAttn) {
    return from_f32<OutT>(__fadd_rn(__fadd_rn(to_f32(resid[idx]), acc), b));
  } else {
    return from_f32<OutT>(__fadd_rn(to_f32(resid[idx]), __fadd_rn(acc, b)));
  }
}

// 8 warps as 2 (rows) x 4 (cols); each warp owns a 64x32 block of the
// 128x128 output tile: 4x4 m16n8 int32 accumulators, flushed into fp32 ones
// at the end of every group. Requires K % 32 == 0, group_k % 32 == 0,
// N % 4 == 0 and 16-byte aligned A rows (checked below).
template <int EPI, typename T, typename OutT>
__global__ void __launch_bounds__(256)
    q8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                   const float* __restrict__ row_scale,
                   const float* __restrict__ col_scale,
                   const float* __restrict__ bias, const T* __restrict__ resid,
                   OutT* __restrict__ out, int M, int N, int K, int group_k) {
  __shared__ __align__(16) int8_t As[BM * LDS];  // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * LDS];  // [n][k]: W transposed
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int groups = K / group_k;

  int acc[4][4][4];
  float facc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][j][c] = 0;
        facc[i][j][c] = 0.f;
      }

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // A tile: 128 rows x 32 bytes, 16 bytes a thread
      const int row = tid >> 1, kc = (tid & 1) * 16, gm = m0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M) v = *reinterpret_cast<const uint4*>(A + (size_t)gm * K + k0 + kc);
      *reinterpret_cast<uint4*>(As + row * LDS + kc) = v;
    }
    {  // W tile: 32 k x 128 n; a thread reads 4 k-rows of 4 columns and
       // writes them transposed, 4 k-contiguous bytes per column
      const int kq = tid & 7, nq = tid >> 3, gn = n0 + nq * 4;
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = gn < N ? *reinterpret_cast<const uint32_t*>(
                            W + (size_t)(k0 + kq * 4 + j) * N + gn)
                      : 0u;
      const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
      const uint32_t cols[4] = {
          __byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
          __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(Bs + (nq * 4 + c) * LDS + kq * 4) = cols[c];
    }
    __syncthreads();
    uint32_t fa[4][4], fb[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int8_t* p = As + (wm + i * 16 + g) * LDS + t4 * 4;
      fa[i][0] = *reinterpret_cast<const uint32_t*>(p);
      fa[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
      fa[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      fa[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* p = Bs + (wn + j * 8 + g) * LDS + t4 * 4;
      fb[j][0] = *reinterpret_cast<const uint32_t*>(p);
      fb[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
    __syncthreads();

    if ((k0 + BK) % group_k == 0) {  // end of a group: scale into fp32
      const int grp = (k0 + BK) / group_k - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = m0 + wm + i * 16 + g + (c >= 2 ? 8 : 0);
          const float rs = m < M ? row_scale[(size_t)m * groups + grp] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + wn + j * 8 + t4 * 2 + (c & 1);
            const float cs = n < N ? col_scale[n] : 0.f;
            facc[i][j][c] = __fadd_rn(
                facc[i][j][c], __fmul_rn(__fmul_rn((float)acc[i][j][c], rs), cs));
            acc[i][j][c] = 0;
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m0 + wm + i * 16 + g + (c >= 2 ? 8 : 0);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + t4 * 2 + (c & 1);
        if (n < N) {
          const size_t idx = (size_t)m * N + n;
          out[idx] = epilogue<EPI, T, OutT>(facc[i][j][c], bias[n], resid, idx);
        }
      }
    }
}

template <int EPI, typename T>
int launch_gemm(const void* a, const void* w, const void* rs, const void* cs,
                const void* bias, const void* resid, void* out, int M, int N,
                int K, int group_k, cudaStream_t s) {
  using OutT = typename std::conditional<EPI == kEpiGelu, float, T>::type;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM), block(256);
  q8_gemm_kernel<EPI, T, OutT><<<grid, block, 0, s>>>(
      (const int8_t*)a, (const int8_t*)w, (const float*)rs, (const float*)cs,
      (const float*)bias, (const T*)resid, (OutT*)out, M, N, K, group_k);
  return (int)cudaGetLastError();
}

template <int EPI>
int dispatch_gemm(const void* a, const void* w, const void* rs, const void* cs,
                  const void* bias, const void* resid, void* out, int M, int N,
                  int K, int group_k, int dtype, cudaStream_t s) {
  if (dtype == kF32)
    return launch_gemm<EPI, float>(a, w, rs, cs, bias, resid, out, M, N, K,
                                   group_k, s);
  if constexpr (EPI != kEpiGelu) {  // the hidden is fp32 in either type
    if (dtype == kBF16)
      return launch_gemm<EPI, __nv_bfloat16>(a, w, rs, cs, bias, resid, out, M,
                                             N, K, group_k, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// gamma/beta null: quantize the rows as they are (fp32 only here)
extern "C" int cgt_q8_quantize(const void* x, const void* gamma,
                               const void* beta, void* q, void* scale,
                               int rows, int cols, int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((rows + 7) / 8), block(256);
  if ((gamma == nullptr) != (beta == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) {
    quantize_kernel<float><<<grid, block, 0, s>>>(
        (const float*)x, (const float*)gamma, (const float*)beta, (int8_t*)q,
        (float*)scale, rows, cols);
  } else if (dtype == kBF16 && gamma != nullptr) {
    quantize_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)gamma, (const float*)beta,
        (int8_t*)q, (float*)scale, rows, cols);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// row_scale is [M, K / group_k]; resid is read by the residual epilogues
// only and may be null for the others; dtype is out's type (fp32 for c_fc)
extern "C" int cgt_q8_gemm(const void* a, const void* w, const void* row_scale,
                           const void* col_scale, const void* bias,
                           const void* resid, void* out, int M, int N, int K,
                           int group_k, int dtype, int epilogue, void* stream) {
  if (K % BK || group_k < BK || group_k % BK || K % group_k || N % 4)
    return (int)cudaErrorInvalidValue;
  const bool has_resid = epilogue == kEpiResidAttn || epilogue == kEpiResidMlp;
  if (has_resid != (resid != nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case kEpiQkv:
      return dispatch_gemm<kEpiQkv>(a, w, row_scale, col_scale, bias, resid,
                                    out, M, N, K, group_k, dtype, s);
    case kEpiGelu:
      return dispatch_gemm<kEpiGelu>(a, w, row_scale, col_scale, bias, resid,
                                     out, M, N, K, group_k, dtype, s);
    case kEpiResidAttn:
      return dispatch_gemm<kEpiResidAttn>(a, w, row_scale, col_scale, bias,
                                          resid, out, M, N, K, group_k, dtype,
                                          s);
    case kEpiResidMlp:
      return dispatch_gemm<kEpiResidMlp>(a, w, row_scale, col_scale, bias,
                                         resid, out, M, N, K, group_k, dtype,
                                         s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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
//           (K1) and c_fc (K2), inside the fp32 GEMM and as a pass of its
//           own before the bf16 one. The out-projection and c_proj read A
//           as is.
// epilogue: K1 qkv:      T(T(acc) + b)       (the kernel rounds the product
//                                             before adding b_qkv)
//           K8 qkv and out-proj: T(T(acc) + b), the same without the LN
//                                prologue (b_out is added after the sum is
//                                rounded, in T: the wrapper passes b rounded)
//           K2 c_fc:     T(gelu(acc + b))    (QuickGELU in fp32)
//           K1 out-proj: T((r + acc) + b)    (residual + bias in fp32)
//           K2 c_proj:   T(r + (acc + b))
//
// The Pallas kernels it serves: K1 _fused_ln_block_kernel
// (flash_attention.py:845: qkv with the LN prologue, epilogue 0, and the
// out-projection, 2), K2 _fused_mlp_kernel (:329: c_fc with the LN prologue,
// 1, and c_proj, 3) and K8 _fused_block_kernel (:174: qkv and out-projection,
// both 4).
//
// What bounds it on an H100: operations. K1's qkv product at ViT-B/16 batch
// 512 (M = 100,864 rows, K = 768, N = 2,304) is 357 GFLOP for about 624 MB
// of bf16 moved (x read, qkv written), some 570 FLOPs per byte, above the
// card's ridge of about 295 FLOPs per byte for bf16 tensor cores (20 for the
// fp32 CUDA cores); K2's c_fc and c_proj and the out-projections lie higher
// or near it. So the design keeps the tensor cores fed:
// - fp32 runs on the CUDA cores (8x8 outer products per thread, 128x128
//   tiles), unchanged since the first version.
// - bf16: mma.sync.m16n8k16 (bf16 in, fp32 accumulators) on 128x128 output
//   tiles, 4 warps each holding a 64x64 block of accumulators in registers
//   (128 floats a thread), so each operand fragment an ldmatrix brings feeds
//   8 (A) or 4 (W) products. A and W k-tiles of depth 64 stream through a
//   ring of 3 shared-memory stages filled by 16-byte cp.async (rows past M,
//   columns past N and a K tail zero-filled by the src-size form), so the
//   copies of tiles k+1 and k+2 overlap the products of tile k, with one
//   __syncthreads per k-tile (128 mma.sync a warp between two). Shared rows
//   are padded by 8 elements, so the 8 rows an ldmatrix phase reads fall in
//   8 distinct bank groups. A [M,K] is read by ldmatrix.x4; W [K,N] is the
//   .col operand, read by ldmatrix.x4.trans. 105 KB of ring a block
//   (dynamic shared memory) and at most 255 registers a thread: two blocks
//   an SM.
// - the LN prologue (the qkv and c_fc products) runs as a pass of its own
//   for bf16 (ln_apply_kernel: h = LN(x) rounded once to bf16, 2 x T x D
//   x 2 bytes, 0.10 ms at ViT-B/16 batch 512 on an H100), and the GEMM reads
//   h as is. Normalising the landed stage in shared memory inside the GEMM
//   was measured first: the qkv product took 1.80 ms with it against 1.12
//   without, c_fc 2.97 against 2.00, because each of the N / 128 column
//   blocks (18 for qkv, 24 for c_fc) normalises the same rows again;
//   normalising the fragments after ldmatrix repeats that work once more per
//   warp. The rounding point is unchanged: LN in fp32, rounded once to bf16
//   before the product. The fp32 kernel keeps its prologue.
// - the epilogue: after the last k-tile the ring becomes staging; each warp
//   writes its fp32 accumulators there, then each lane finishes 8 adjacent
//   columns of a row (bias, residual and QuickGELU per element as
//   apply_epilogue says, in fp32) with 16-byte reads of the residual and
//   16-byte writes of the output.
// - no split-K and no atomics: every output element is summed by one thread
//   in a fixed k order, so two calls agree bit for bit.
// Left for wgmma and TMA: mma.sync reaches about two thirds of the card's
// bf16 peak at best and every operand passes through registers by ldmatrix,
// which makes shared-memory bandwidth the next wall; warpgroup products
// reading both operands from shared memory, TMA copies and a persistent
// grid whose epilogue overlaps the next tile's products are the next step
// (c_fc, whose epilogue runs QuickGELU, takes 2.00 ms against c_proj's 1.51
// for the same FLOPs at batch 512), then keeping the qkv/hidden
// intermediates on chip.
#include "common.cuh"
#include "mma.cuh"

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

// the bf16 GEMM's LN prologue as a pass of its own: h = bf16((x - mean) *
// rstd * gamma + beta), computed in fp32, one thread per 8 adjacent
// columns (cols % 8 == 0), 16-byte reads and writes
__global__ void __launch_bounds__(256)
    ln_apply_kernel(const __nv_bfloat16* __restrict__ x,
                    const float2* __restrict__ stats,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    __nv_bfloat16* __restrict__ h, int rows, int cols) {
  const int chunks = cols / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * chunks) return;
  const int row = (int)(idx / chunks), c = (int)(idx % chunks) * 8;
  const float2 st = stats[row];
  const float4 g0 = *reinterpret_cast<const float4*>(gamma + c);
  const float4 g1 = *reinterpret_cast<const float4*>(gamma + c + 4);
  const float4 b0 = *reinterpret_cast<const float4*>(beta + c);
  const float4 b1 = *reinterpret_cast<const float4*>(beta + c + 4);
  const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const size_t off = (size_t)row * cols + c;
  uint4 packed = *reinterpret_cast<const uint4*>(x + off);
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
  for (int u = 0; u < 8; ++u)
    e[u] = __float2bfloat16_rn((__bfloat162float(e[u]) - st.x) * st.y * gv[u] +
                               bv[u]);
  *reinterpret_cast<uint4*>(h + off) = packed;
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
constexpr int H_BM = 128, H_BN = 128, H_BK = 64;
constexpr int H_STAGES = 3;
constexpr int H_THREADS = 128;   // 4 warps as 2 (rows) x 2 (cols) of 64x64
constexpr int H_LDA = H_BK + 8;  // padded smem rows (elements): the 8 rows
constexpr int H_LDB = H_BN + 8;  // an ldmatrix phase reads hit 8 bank groups
constexpr int H_A_STAGE = H_BM * H_LDA, H_B_STAGE = H_BK * H_LDB;
constexpr size_t H_SMEM_BYTES =
    sizeof(__nv_bfloat16) * (size_t)H_STAGES * (H_A_STAGE + H_B_STAGE);
// 16-byte chunks of one stage each thread copies
constexpr int H_A_CHUNKS = H_BM * H_BK / 8 / H_THREADS;  // 8
constexpr int H_B_CHUNKS = H_BK * H_BN / 8 / H_THREADS;  // 8
// fp32 rows of a warp's 64x64 block staged for the epilogue (72 = 8 mod
// 32: the 4 rows of a half-warp's float2 stores hit distinct bank groups)
constexpr int H_LDC = 72;
static_assert(H_THREADS / 32 * 64 * H_LDC * sizeof(float) <= H_SMEM_BYTES,
              "the epilogue staging reuses the ring");

// A is read as is: for the LN epilogues (qkv, c_fc) it is the normalised
// activation ln_apply_kernel wrote. Requires K % 8 == 0, N % 8 == 0 and
// 16-byte aligned A/W/out/resid/bias (checked by the Python wrapper), so a
// 16-byte chunk of A or W, and an 8-column chunk of the output, lies wholly
// inside or wholly outside the matrix.
template <int EPI>
__global__ void __launch_bounds__(H_THREADS, 2)
    gemm_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                     const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ resid,
                     __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + H_STAGES * H_A_STAGE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * H_BM, n0 = blockIdx.x * H_BN;
  constexpr int WARPS_N = H_BN / 64;  // warps side by side along N
  const int wm = (warp / WARPS_N) * 64, wn = (warp % WARPS_N) * 64;
  const int ktiles = (K + H_BK - 1) / H_BK;

  // the chunks this thread copies: A rows a_row + A_STEP i at k offset a_k,
  // W rows b_row + B_STEP i at column offset b_n
  constexpr int A_STEP = H_THREADS / (H_BK / 8), B_STEP = H_THREADS / (H_BN / 8);
  const int a_row = tid / (H_BK / 8), a_k = tid % (H_BK / 8) * 8;
  const int b_row = tid / (H_BN / 8), b_n = tid % (H_BN / 8) * 8;

  auto load_tile = [&](int kt) {
    const int k0 = kt * H_BK, slot = kt % H_STAGES;
    __nv_bfloat16* as = As + slot * H_A_STAGE;
    __nv_bfloat16* bs = Bs + slot * H_B_STAGE;
#pragma unroll
    for (int i = 0; i < H_A_CHUNKS; ++i) {
      const int row = a_row + A_STEP * i, gm = m0 + row, gk = k0 + a_k;
      const bool ok = gm < M && gk < K;
      cp_async16_zfill(as + row * H_LDA + a_k,
                       ok ? A + (size_t)gm * K + gk : A, ok);
    }
#pragma unroll
    for (int i = 0; i < H_B_CHUNKS; ++i) {
      const int row = b_row + B_STEP * i, gk = k0 + row, gn = n0 + b_n;
      const bool ok = gk < K && gn < N;
      cp_async16_zfill(bs + row * H_LDB + b_n,
                       ok ? W + (size_t)gk * N + gn : W, ok);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix addresses of this lane within a stage: A (x4: rows 0-15 at k
  // 0 and 8 of a 16x16 tile), W (x4.trans: k rows 0-15 at columns 0 and 8,
  // the B fragments of two n-tiles of 8)
  const int a_ld = (wm + (lane & 15)) * H_LDA + (lane >> 4) * 8;
  const int b_ld = ((lane & 7) + ((lane >> 3) & 1) * 8) * H_LDB + wn + (lane >> 4) * 8;

  // the ring: tiles kt + 1 and kt + 2 are in flight while tile kt is
  // multiplied; one commit group per tile (empty past the last)
#pragma unroll
  for (int s = 0; s < H_STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s);
    cp_async_commit();
  }
  cp_async_wait<H_STAGES - 2>();  // this thread's chunks of tile 0 landed

  for (int kt = 0; kt < ktiles; ++kt) {
    // tile kt visible to every warp, and every warp done with tile kt - 1,
    // whose slot the next copy refills
    __syncthreads();
    if (kt + H_STAGES - 1 < ktiles) load_tile(kt + H_STAGES - 1);
    cp_async_commit();

    const int slot = kt % H_STAGES;
    const __nv_bfloat16* as = As + slot * H_A_STAGE + a_ld;
    const __nv_bfloat16* bs = Bs + slot * H_B_STAGE + b_ld;
#pragma unroll
    for (int kk = 0; kk < H_BK; kk += 16) {
      uint32_t a[4][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], as + i * 16 * H_LDA + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldmatrix_x4_trans(b[j], bs + kk * H_LDB + j * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          mma_bf16(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
    cp_async_wait<H_STAGES - 2>();  // this thread's chunks of tile kt + 1
  }
  cp_async_wait<0>();  // no copy outlives the ring (the groups left are empty)
  __syncthreads();     // every warp done with the ring: it becomes staging

  // epilogue: each warp stages its fp32 64x64 block (element e of n-tile j
  // of m-tile i is row 16 i + g + 8 (e >> 1), column 8 j + 2 t + (e & 1)),
  // then each lane finishes 8 adjacent columns of a row: 16-byte reads of
  // the residual and writes of the output
  float* stage = reinterpret_cast<float*>(smem) + warp * 64 * H_LDC;
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(stage + (16 * i + g + 8 * r) * H_LDC + 8 * j +
                                     2 * t) =
              make_float2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
  }
  __syncwarp();
  const int c = (lane & 7) * 8, n = n0 + wn + c;
  if (n >= N) return;  // N % 8 == 0: the chunk is wholly past N
  const float4 b0 = *reinterpret_cast<const float4*>(bias + n);
  const float4 b1 = *reinterpret_cast<const float4*>(bias + n + 4);
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll 4
  for (int row = lane >> 3; row < 64; row += 4) {
    const int m = m0 + wm + row;
    if (m >= M) break;
    const size_t idx = (size_t)m * N + n;
    const float4 v0 = *reinterpret_cast<const float4*>(stage + row * H_LDC + c);
    const float4 v1 = *reinterpret_cast<const float4*>(stage + row * H_LDC + c + 4);
    const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    uint4 r8 = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (EPI == kEpiResidAttn || EPI == kEpiResidMlp)
      r8 = *reinterpret_cast<const uint4*>(resid + idx);
    const __nv_bfloat16* rv = reinterpret_cast<const __nv_bfloat16*>(&r8);
    uint4 o8;
    __nv_bfloat16* ov = reinterpret_cast<__nv_bfloat16*>(&o8);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      ov[u] = apply_epilogue<EPI, __nv_bfloat16>(v[u], bv[u], rv, u);
    *reinterpret_cast<uint4*>(out + idx) = o8;
  }
}

// the dynamic shared-memory opt-in (above 48 KB) is a property of the
// function on a device: set once per epilogue instantiation and device
template <int EPI>
int opt_in_bf16_smem() {
  static unsigned long long opted_in = 0;  // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && ((opted_in >> dev) & 1ull)) return 0;
  err = cudaFuncSetAttribute(gemm_bf16_kernel<EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)H_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  // two blocks of an SM hold 2 x 105 KB
  err = cudaFuncSetAttribute(gemm_bf16_kernel<EPI>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) opted_in |= 1ull << dev;
  return 0;
}

template <int EPI>
int launch_gemm(const void* a, const void* w, const void* bias,
                const void* resid, const void* stats, const void* gamma,
                const void* beta, void* out, int M, int N, int K, int dtype,
                cudaStream_t s) {
  if (dtype == kF32) {
    const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
    gemm_f32_kernel<EPI><<<grid, 256, 0, s>>>(
        (const float*)a, (const float*)w, (const float*)bias,
        (const float*)resid, (const float2*)stats, (const float*)gamma,
        (const float*)beta, (float*)out, M, N, K);
  } else if (dtype == kBF16) {
    const int err = opt_in_bf16_smem<EPI>();
    if (err != 0) return err;
    const dim3 grid((N + H_BN - 1) / H_BN, (M + H_BM - 1) / H_BM);
    gemm_bf16_kernel<EPI><<<grid, H_THREADS, H_SMEM_BYTES, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)w, (const float*)bias,
        (const __nv_bfloat16*)resid, (__nv_bfloat16*)out, M, N, K);
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

// the normalised bf16 activation h [rows, cols] that the bf16 GEMM's LN
// epilogues read as A; stats from cgt_ln_stats, gamma/beta fp32
extern "C" int cgt_ln_apply(const void* x, const void* stats, const void* gamma,
                            const void* beta, void* h, int rows, int cols,
                            void* stream) {
  if (rows < 1 || cols < 8 || cols % 8) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)rows * (cols / 8);
  ln_apply_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                    (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float2*)stats, (const float*)gamma,
      (const float*)beta, (__nv_bfloat16*)h, rows, cols);
  return (int)cudaGetLastError();
}

// resid is read by the residual epilogues (out-proj, c_proj) only; stats,
// gamma and beta by the fp32 kernel's LN epilogues (K1 qkv, c_fc) only (in
// bf16 those take A normalised by cgt_ln_apply); the others may be null
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

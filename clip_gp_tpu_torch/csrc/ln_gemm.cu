// The GEMM with a fused epilogue of the Pallas kernels _fused_ln_block_kernel
// (K1) and _fused_mlp_kernel (K2) of clip_gp_tpu/ops/flash_attention.py, and
// of _fused_block_kernel (K8) of the same file: their four matrix products,
// plus the LayerNorm pass that the bf16 products read.
//
//   out[M,N] = epilogue( A[M,K] @ W[K,N] )
//
// A is read as is. The qkv projection (K1) and c_fc (K2) take A = LN(x),
// written by a pass of its own and rounded to the working type as the Pallas
// kernel rounds ``h.astype(x.dtype)``: in bf16 ln_stats_kernel then
// ln_apply_kernel below, in fp32 gemm_bwd.cu's ln_f32_kernel, the one pass
// that K3 and K4 run (((x - mean)·rstd)·γ + β, the same expression). The
// out-projection and c_proj read A as the block hands it over.
// epilogue: K1 qkv:      T(T(acc) + b)       (the kernel rounds the product
//                                             before adding b_qkv)
//           K8 qkv and out-proj: T(T(acc) + b), the same (b_out is added
//                                after the sum is rounded, in T: the wrapper
//                                passes b rounded)
//           K2 c_fc:     T(gelu(acc + b))    (QuickGELU in fp32)
//           K1 out-proj: T((r + acc) + b)    (residual + bias in fp32)
//           K2 c_proj:   T(r + (acc + b))
//
// The Pallas kernels it serves: K1 _fused_ln_block_kernel
// (flash_attention.py:845: qkv, epilogue 0, and the out-projection, 2), K2
// _fused_mlp_kernel (:329: c_fc, 1, and c_proj, 3) and K8 _fused_block_kernel
// (:174: qkv and out-projection, both 4).
//
// What bounds it on an H100: operations. K1's qkv product at ViT-B/16 batch
// 512 (M = 100,864 rows, K = 768, N = 2,304) is 357 GFLOP. In bf16 it moves
// about 624 MB (x read, qkv written), some 570 FLOPs per byte, above the
// card's ridge of about 295 for bf16 tensor cores. In fp32 it moves 1.25 GB,
// or 1.87 GB with the LN pass's write and read of LN(x): 190 to 290 FLOPs
// per byte, above the ridge of 3xTF32 on the tensor cores (165 TFLOP/s of
// fp32 products over 3.35 TB/s, about 50). K2's c_fc and c_proj and the
// out-projections lie higher or near it. So the design keeps the tensor
// cores fed:
// - fp32 runs the 3xTF32 mma.sync core of gemm_tf32.cuh, as K3's and K4's
//   products do: its 4-stage 16-byte cp.async ring of 16-deep k-tiles, the
//   hi/lo split of each fragment as it leaves shared memory with lo·hi +
//   hi·lo + hi·hi summed in that order for each 8-deep k-step and added to
//   the fp32 accumulators rounding to nearest (gemm_tf32.cuh says why the
//   tensor cores do not chain the accumulators), and one of three tile shapes
//   (128x128, 128x64, 64x64) that the wrapper picks per product from the
//   card's SM count. The epilogues run on the accumulators (QuickGELU
//   writes the activation alone; the residual is an fp32 [M,N] read through
//   the core's aux pointer). Three TF32 passes, not one: at K = 768 to
//   3,072 one pass puts K1, K2 and K8 4.5 to 10.5 times past the fp32
//   tolerance (1e-4 + 1e-4·|plain|), and three stay 50 to 130 times inside
//   it (tests/test_torch_gemm_fwd_numerics.py emulates both in the plain
//   versions at ViT-B/16's widths).
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
// - the LN as a pass of its own, in both types (for bf16 ln_apply_kernel: h
//   = LN(x) rounded once to bf16, 2 x T x D x 2 bytes, 0.10 ms at ViT-B/16
//   batch 512 on an H100), because cp.async cannot transform what it copies
//   and normalising the landed stage in shared memory inside the GEMM was
//   measured slower: the bf16 qkv product took 1.80 ms with it against 1.12
//   without, c_fc 2.97 against 2.00, because each of the N / 128 column
//   blocks (18 for qkv, 24 for c_fc) normalises the same rows again. The
//   rounding point is unchanged: LN in fp32, rounded once to T before the
//   product.
// - the bf16 epilogue: after the last k-tile the ring becomes staging; each
//   warp writes its fp32 accumulators there, then each lane finishes 8
//   adjacent columns of a row (bias, residual and QuickGELU per element as
//   apply_epilogue says, in fp32) with 16-byte reads of the residual and
//   16-byte writes of the output.
// - no split-K and no atomics in either type: every output element is
//   summed by one thread in a fixed k order, so two calls agree bit for bit.
// Left for wgmma and TMA: mma.sync reaches about two thirds of the card's
// bf16 peak at best and every operand passes through registers, which makes
// shared-memory bandwidth the next wall; warpgroup products reading both
// operands from shared memory, TMA copies and a persistent grid whose
// epilogue overlaps the next tile's products are the next step (c_fc, whose
// epilogue runs QuickGELU, takes 2.00 ms against c_proj's 1.51 for the same
// FLOPs at batch 512 in bf16), then keeping the qkv/hidden intermediates on
// chip.
#include "common.cuh"
#include "gemm_tf32.cuh"
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

// one warp per row of a bf16 x: two-pass fp32 mean and variance (eps 1e-5),
// as the Pallas kernel computes them
__global__ void __launch_bounds__(256)
    ln_stats_kernel(const __nv_bfloat16* __restrict__ x,
                    float2* __restrict__ stats, int rows, int cols) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const __nv_bfloat16* xr = x + (size_t)row * cols;
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
  // bit d: device d; atomic, as several host threads may launch
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && ((opted_in.load() >> dev) & 1ull)) return 0;
  err = cudaFuncSetAttribute(gemm_bf16_kernel<EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)H_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  // two blocks of an SM hold 2 x 105 KB
  err = cudaFuncSetAttribute(gemm_bf16_kernel<EPI>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) opted_in.fetch_or(1ull << dev);
  return 0;
}

// ---------------------------------------------------------------- fp32 ----
// the core's epilogue for each of ours: in fp32 the qkv and bias epilogues'
// rounding to T is the identity
constexpr int f32_epilogue(int epi) {
  return epi == kEpiGelu        ? kGemmEpiGelu
         : epi == kEpiResidAttn ? kGemmEpiResidAttn
         : epi == kEpiResidMlp  ? kGemmEpiResidMlp
                                : kGemmEpiBias;
}

template <int EPI>
int launch_gemm(const void* a, const void* w, const void* bias,
                const void* resid, void* out, int M, int N, int K, int dtype,
                int tile, cudaStream_t s) {
  if (dtype == kF32) {
    // the core's layout rules for A [M,K] and W [K,N] in fp32
    if (N % 4 || K % 4) return (int)cudaErrorInvalidValue;
    return launch_gemm_tf32_tile<false, false, float, float, f32_epilogue(EPI)>(
        tile, a, w, bias, resid, out, nullptr, M, N, K, 1, s);
  }
  if (dtype != kBF16 || N % 8 || K % 8) return (int)cudaErrorInvalidValue;
  const int err = opt_in_bf16_smem<EPI>();
  if (err != 0) return err;
  const dim3 grid((N + H_BN - 1) / H_BN, (M + H_BM - 1) / H_BM);
  gemm_bf16_kernel<EPI><<<grid, H_THREADS, H_SMEM_BYTES, s>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)w, (const float*)bias,
      (const __nv_bfloat16*)resid, (__nv_bfloat16*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// stats [rows] (mean, rstd) of a bf16 x [rows, cols], for cgt_ln_apply
extern "C" int cgt_ln_stats(const void* x, void* stats, int rows, int cols,
                            void* stream) {
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  ln_stats_kernel<<<(rows + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (float2*)stats, rows, cols);
  return (int)cudaGetLastError();
}

// the normalised bf16 activation h [rows, cols] that the bf16 qkv and c_fc
// products read as A; stats from cgt_ln_stats, gamma/beta fp32
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

// out[M,N] = epilogue(a[M,K] @ w[K,N]) in the working type ``dtype``; bias
// fp32 [N]; resid [M,N] in that type, read by the residual epilogues
// (out-proj, c_proj) only, else may be null. tile: the GemmTile of the fp32
// product (gemm_tf32.cuh); bf16 has one tile shape and ignores it. Returns
// cudaErrorInvalidValue for a shape outside the kernels' layout rules (N and
// K multiples of 4 in fp32, of 8 in bf16; the K1, K2 and K8 wrappers' checks
// on D and the hidden width keep every call of theirs inside them).
extern "C" int cgt_gemm(const void* a, const void* w, const void* bias,
                        const void* resid, void* out, int M, int N, int K,
                        int dtype, int epilogue, int tile, void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case kEpiQkv:
      return launch_gemm<kEpiQkv>(a, w, bias, resid, out, M, N, K, dtype, tile, s);
    case kEpiGelu:
      return launch_gemm<kEpiGelu>(a, w, bias, resid, out, M, N, K, dtype, tile, s);
    case kEpiResidAttn:
      return launch_gemm<kEpiResidAttn>(a, w, bias, resid, out, M, N, K, dtype,
                                        tile, s);
    case kEpiResidMlp:
      return launch_gemm<kEpiResidMlp>(a, w, bias, resid, out, M, N, K, dtype,
                                       tile, s);
    case kEpiBias:
      return launch_gemm<kEpiBias>(a, w, bias, resid, out, M, N, K, dtype, tile, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

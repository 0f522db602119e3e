// fp32 matrix products of the backward kernels K3 and K4: the dot_generals
// inside _ln_attn_bwd_kernel and _ln_mlp_bwd_kernel of
// clip_gp_tpu/ops/flash_attention.py, which run every product in fp32
// (the weights upcast, the block recomputed from x).
//
//   out[M,N] = epilogue( sum_k A(m,k) * B(k,n) )
//
// A and B are each read as stored ("N": A [M,K], B [K,N]) or transposed
// ("T": A stored [K,M], B stored [N,K]), all contiguous. The six products of
// K3 and K4 are four kinds here:
//   kNNBias     qkv / hid_pre = LN(x)·W + b; K4's hid_pre may also write
//               QuickGELU(hid_pre) as a second output (kGemmEpiBiasGelu)
//   kNT         d_attn = dout·Woutᵀ, dh = dqkv·Wqkvᵀ, dh = dhid·Wfcᵀ
//   kNTGeluBwd  dhid = (dout·Wprojᵀ) * QuickGELU'(hid_pre)
//   kTN         dWqkv = LN(x)ᵀ·dqkv, dWfc = LN(x)ᵀ·dhid, dWout = attnᵀ·dout,
//               dWproj = QuickGELU(hid_pre)ᵀ·dout
// The operand that is x's or dout's ("io": A of kNT and kNTGeluBwd, B of
// kTN) is read in the working type (fp32 or bf16); every other operand is
// fp32. LN(x) is not a prologue of the products: cgt_ln_f32 writes it once
// per call in fp32, ((x - mean)·rstd)·γ + β, beside the row statistics that
// the LN backward reads, and both products that need it read it as is, as
// K4's dWproj reads the QuickGELU(hid_pre) its hid_pre product wrote.
// Normalising inside the GEMM would repeat the same work in every column
// block (measured for ln_gemm.cu's bf16 GEMM, whose LN is also a pass of
// its own). Output is fp32.
//
// The weight gradients sum over all T = B·N rows. On the TPU they
// accumulate in a constant output block across the sequential grid; here a
// kTN product may split its K (= T) rows into `splits` ranges (blockIdx.z),
// each writing its own [M,N] part, and cgt_sum_parts (ln_bwd.cu) adds the
// parts in a fixed order: no atomics, the same bits on every run.
//
// What bounds it on an H100: operations. K4 with every gradient at
// B=256, N=24, D=512 is 6.4e10 FLOPs on 25 MB of inputs and outputs
// (x, dout, weights, gradients), about 2,500 FLOPs per byte, far above the
// ridge of the fp32 CUDA cores (20) and of 3xTF32 on the tensor cores (about
// 50). So every product runs the 3xTF32 mma.sync core of gemm_tf32.cuh (its
// header says how): one TF32 pass errs by about 1e-3 of a product, past the
// backward tolerance of 1e-4, and three hold it
// (tests/test_torch_gemm_bwd_numerics.py emulates both at the text tower's
// widths). Three tile shapes, each a block of 4 warps: 128x128 (64x64
// accumulators a warp, two blocks an SM), 128x64 (three) and 64x64 (four),
// so that an output of few 128x128 tiles still fills the card; the wrapper
// picks the shape and the split from the card's SM count.
#include "common.cuh"
#include "gemm_tf32.cuh"

using namespace cgt;

namespace {

enum Op { kNNBias = 0, kNT = 1, kNTGeluBwd = 2, kTN = 3 };

// LN(x) in fp32 and its row statistics, one warp a row: the two-pass fp32
// mean and variance (eps 1e-5) of ln_gemm.cu's ln_stats_kernel, then
// ((x - mean)·rstd)·γ + β. K3 and K4 read both; the fp32 K1 and K2 read
// LN(x) as the A of their qkv and c_fc products.
template <typename T>
__global__ void __launch_bounds__(256)
    ln_f32_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, float2* __restrict__ stats,
                  float* __restrict__ h, int rows, int cols) {
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
  const float rstd = rsqrtf(warp_sum(v) / (float)cols + 1e-5f);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
  float* hr = h + (size_t)row * cols;
  for (int c = lane; c < cols; c += 32)
    hr[c] = (to_f32(xr[c]) - mean) * rstd * gamma[c] + beta[c];
}

// T: the working type of the io operand
template <typename T>
int dispatch(int op, int tile, const void* a, const void* b, const void* bias,
             const void* aux, void* out, void* act, int M, int N, int K,
             int splits, cudaStream_t s) {
  switch (op) {
    case kNNBias:  // A = LN(x), fp32
      if constexpr (!std::is_same<T, float>::value) return (int)cudaErrorInvalidValue;
      return act ? launch_gemm_tf32_tile<false, false, float, float, kGemmEpiBiasGelu>(
                       tile, a, b, bias, aux, out, act, M, N, K, splits, s)
                 : launch_gemm_tf32_tile<false, false, float, float, kGemmEpiBias>(
                       tile, a, b, bias, aux, out, act, M, N, K, splits, s);
    case kNT:
      return launch_gemm_tf32_tile<false, true, T, float, kGemmEpiNone>(
          tile, a, b, bias, aux, out, act, M, N, K, splits, s);
    case kNTGeluBwd:
      return launch_gemm_tf32_tile<false, true, T, float, kGemmEpiGeluBwd>(
          tile, a, b, bias, aux, out, act, M, N, K, splits, s);
    case kTN:
      return launch_gemm_tf32_tile<true, false, float, T, kGemmEpiNone>(
          tile, a, b, bias, aux, out, act, M, N, K, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the layout rules of launch_gemm_tf32 for this op and io type
bool layout_ok(int op, int N, int K, int splits, bool bf16, bool act) {
  if (N % 4 || (act && op != kNNBias)) return false;
  if (splits > 1 && op != kNT && op != kTN) return false;  // no split epilogue
  if (op == kTN) return !bf16 || N % 8 == 0;                // B [K, N] io
  return K % (bf16 ? 8 : 4) == 0;                           // A [M, K] io
}

}  // namespace

// out holds `splits` parts of [M, N] (one unless an epilogue-free product
// splits K); bias is read by kNNBias only, aux by kNTGeluBwd only; act
// (kNNBias only, may be null) receives QuickGELU(out); tile: a GemmTile
// (gemm_tf32.cuh).
// Returns cudaErrorInvalidValue for a shape the layout rules of
// gemm_tf32.cuh refuse (the K3/K4 wrappers' checks on D and the hidden
// width keep every call of theirs inside them).
extern "C" int cgt_gemm_bwd(const void* a, const void* b, const void* bias,
                            const void* aux, void* out, void* act, int M,
                            int N, int K, int splits, int dtype, int op,
                            int tile, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || splits > 64 ||
      (dtype != kF32 && dtype != kBF16) ||
      !layout_ok(op, N, K, splits, dtype == kBF16, act != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return dtype == kBF16
             ? dispatch<__nv_bfloat16>(op, tile, a, b, bias, aux, out, act, M,
                                       N, K, splits, s)
             : dispatch<float>(op, tile, a, b, bias, aux, out, act, M, N, K,
                               splits, s);
}

// h [rows, cols] fp32 = LN(x) and stats [rows] (mean, rstd) for x fp32 or
// bf16 (dtype); gamma/beta fp32
extern "C" int cgt_ln_f32(const void* x, const void* gamma, const void* beta,
                          void* stats, void* h, int rows, int cols, int dtype,
                          void* stream) {
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + 7) / 8), block(256);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    ln_f32_kernel<float><<<grid, block, 0, s>>>(
        (const float*)x, (const float*)gamma, (const float*)beta,
        (float2*)stats, (float*)h, rows, cols);
  else if (dtype == kBF16)
    ln_f32_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)gamma, (const float*)beta,
        (float2*)stats, (float*)h, rows, cols);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

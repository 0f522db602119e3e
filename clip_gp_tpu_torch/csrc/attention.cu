// Multi-head attention core of K1: the per-head loop of _qkv_heads_accumulate
// inside _fused_ln_block_kernel (clip_gp_tpu/ops/flash_attention.py), for
// head width 64 and sequences of at most 256 tokens (every CLIP tower here:
// ViT-B/16 197, ViT-B/32 50, text 77).
//
// In:  qkv [B, N, 3D] in the working type T (q | k | v, heads contiguous
//      within each third), optional additive fp32 mask [N, N].
// Out: attn [B, N, D] in T, head h at columns [64h, 64h + 64).
// Per head, as the Pallas kernel: q is scaled by 1/sqrt(64) and rounded to
// T, scores q.k accumulate in fp32, the mask is added, softmax runs in fp32
// (max-subtracted exp, divided by the row sum), the probabilities round to T,
// p.v accumulates in fp32 and rounds to T.
//
// The same kernel with QUANT is the attention core of K5
// (_q8_ln_block_kernel, clip_gp_tpu/ops/int8_block.py): there each head's
// fp32 output is not rounded to T but quantized per (row, head), as that
// kernel's quantize_rows(out_h) does: the warp that holds a query row's 64
// outputs takes their absmax, scale = max(absmax / 127, 1e-12), and writes
// int8 codes clip(rint(o / scale), ±127) at [B, N, D] plus the scale at
// [B, N, H], for the int8 out-projection of int8_block.cu.
//
// One block per (query tile of 64 rows, head, batch element): the head's K
// and V for the whole sequence sit in shared memory as fp32 (about 100 KB at
// N = 197), each warp walks 8 query rows, each lane scores up to 8 keys, and
// the [N, N] scores never reach device memory. Keys are exactly the N real
// tokens (no padding), so no row is ever masked throughout by the kernel
// itself.
//
// What bounds it on an H100: operations, at 4*B*N^2*D FLOPs for B*N*3D
// inputs read once; the attention core is about a tenth of K1's work. This
// first version runs on the CUDA cores in fp32 for both working types;
// moving the two products onto the tensor cores is later work.
#include "common.cuh"

using namespace cgt;

namespace {

constexpr int DH = 64;        // head width
constexpr int QT = 64;        // query rows per block
constexpr int WARPS = 8;      // 256 threads
constexpr int MAX_N = 256;    // 8 keys per lane
constexpr int KS_LD = DH + 1; // padded K rows: lanes read distinct banks

size_t smem_bytes(int n) {
  return sizeof(float) *
         ((size_t)n * KS_LD + (size_t)n * DH + QT * DH + WARPS * MAX_N);
}

template <typename T, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32)
    attention_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                     T* __restrict__ out, int8_t* __restrict__ q_out,
                     float* __restrict__ q_scale, int N, int D) {
  extern __shared__ float smem[];
  float* Ks = smem;                  // [N][KS_LD]
  float* Vs = Ks + (size_t)N * KS_LD;  // [N][DH]
  float* Qs = Vs + (size_t)N * DH;     // [QT][DH]
  float* Ps = Qs + QT * DH;          // [WARPS][MAX_N]
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const size_t row_stride = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * N * row_stride;
  const float scale = 1.f / sqrtf((float)DH);  // exactly 0.125

  for (int idx = threadIdx.x; idx < N * DH; idx += blockDim.x) {
    const int j = idx / DH, d = idx % DH;
    const T* row = base + j * row_stride + h * DH + d;
    Ks[j * KS_LD + d] = to_f32(row[D]);
    Vs[j * DH + d] = to_f32(row[2 * D]);
  }
  for (int idx = threadIdx.x; idx < QT * DH; idx += blockDim.x) {
    const int i = idx / DH, d = idx % DH, qi = q0 + i;
    Qs[idx] = qi < N
                  ? round_to<T>(to_f32(base[qi * row_stride + h * DH + d]) * scale)
                  : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* P = Ps + warp * MAX_N;
  const int slots = (N + 31) / 32;  // key slots per lane, uniform in the warp
  for (int i = warp; i < QT; i += WARPS) {
    const int qi = q0 + i;
    if (qi >= N) break;  // uniform across the warp
    const float* q = Qs + i * DH;
    float s[MAX_N / 32];
#pragma unroll
    for (int t = 0; t < MAX_N / 32; ++t) s[t] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float qd = q[d];
#pragma unroll
      for (int t = 0; t < MAX_N / 32; ++t) {
        if (t < slots) {
          const int j = min(lane + 32 * t, N - 1);  // clamped; discarded below
          s[t] = fmaf(qd, Ks[j * KS_LD + d], s[t]);
        }
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < MAX_N / 32; ++t) {
      const int j = lane + 32 * t;
      if (t < slots && j < N) {
        if (mask != nullptr) s[t] += mask[(size_t)qi * N + j];
        mx = fmaxf(mx, s[t]);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < MAX_N / 32; ++t) {
      const int j = lane + 32 * t;
      s[t] = (t < slots && j < N) ? expf(s[t] - mx) : 0.f;
      sum += s[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < MAX_N / 32; ++t) {
      const int j = lane + 32 * t;
      if (t < slots && j < N) P[j] = round_to<T>(s[t] / sum);
    }
    __syncwarp();
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < N; ++j) {
      const float p = P[j];
      o0 = fmaf(p, Vs[j * DH + lane], o0);
      o1 = fmaf(p, Vs[j * DH + lane + 32], o1);
    }
    const size_t row = (size_t)b * N + qi;
    if constexpr (QUANT) {
      const float amax = warp_max(fmaxf(fabsf(o0), fabsf(o1)));
      const float sc = fmaxf(__fdiv_rn(amax, 127.f), kQuantEps);
      int8_t* qrow = q_out + row * D + h * DH;
      qrow[lane] = quantize_code(o0, sc);
      qrow[lane + 32] = quantize_code(o1, sc);
      if (lane == 0) q_scale[row * gridDim.y + h] = sc;
    } else {
      T* orow = out + row * D + h * DH;
      orow[lane] = from_f32<T>(o0);
      orow[lane + 32] = from_f32<T>(o1);
    }
    __syncwarp();  // P is rewritten by the warp's next query
  }
}

template <typename T, bool QUANT>
int launch(const void* qkv, const void* mask, void* out, void* q_scale, int B,
           int N, int H, int D, cudaStream_t s) {
  const size_t bytes = smem_bytes(N);
  // the shared-memory opt-in is a property of the function on a device: set
  // it once per working type and device, not on every launch
  static unsigned long long opted_in = 0;  // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !((opted_in >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(attention_kernel<T, QUANT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(MAX_N));
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted_in |= 1ull << dev;
  }
  const dim3 grid((N + QT - 1) / QT, H, B), block(WARPS * 32);
  attention_kernel<T, QUANT><<<grid, block, bytes, s>>>(
      (const T*)qkv, (const float*)mask, QUANT ? nullptr : (T*)out,
      QUANT ? (int8_t*)out : nullptr, (float*)q_scale, N, D);
  return (int)cudaGetLastError();
}

}  // namespace

// head width 64 and N <= 256 are checked by the Python wrapper; refused here
// too so a bad call fails loudly instead of reading out of bounds
extern "C" int cgt_attention(const void* qkv, const void* mask, void* out,
                             int B, int N, int H, int D, int dtype,
                             void* stream) {
  if (N < 1 || N > MAX_N || D != H * DH) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch<float, false>(qkv, mask, out, nullptr, B, N, H, D, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, false>(qkv, mask, out, nullptr, B, N, H, D, s);
  return (int)cudaErrorInvalidValue;
}

// K5's attention core: int8 codes q_out [B, N, D] and fp32 scales
// q_scale [B, N, H] in place of attn
extern "C" int cgt_attention_q8(const void* qkv, const void* mask, void* q_out,
                                void* q_scale, int B, int N, int H, int D,
                                int dtype, void* stream) {
  if (N < 1 || N > MAX_N || D != H * DH) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch<float, true>(qkv, mask, q_out, q_scale, B, N, H, D, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, true>(qkv, mask, q_out, q_scale, B, N, H, D,
                                       s);
  return (int)cudaErrorInvalidValue;
}

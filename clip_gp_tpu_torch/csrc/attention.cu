// Multi-head attention cores, one kernel for three callers:
// - K1's: the per-head loop of _qkv_heads_accumulate inside
//   _fused_ln_block_kernel (clip_gp_tpu/ops/flash_attention.py), also the
//   core of K8 (_fused_block_kernel, the same loop without LN): q|k|v read at
//   column offsets of qkv [B, N, 3D] (heads contiguous within each third),
//   the output written to attn [B, N, D], head h at columns [64h, 64h + 64);
// - K7's: _attention_kernel of the same file, standalone attention on
//   contiguous q, k, v [B, H, N, Dh] with the output [B, H, N, Dh];
// - K5's (below).
// The kernel takes each operand's batch, head and row strides, so the two
// layouts differ only in the strides the entry points pass. Head width 32 or
// 64 and sequences of at most 256 tokens (every CLIP tower here: ViT-B/16
// 197, ViT-B/32 50, text 77; the JAX tests' heads of 32).
//
// Per head, as the Pallas kernels: q is scaled by 1/sqrt(Dh) in the working
// type T (the factor itself rounded to T, as JAX casts a Python scalar to the
// array's type; exactly 0.125 at Dh = 64), scores q.k accumulate in fp32,
// the optional additive fp32 mask [N, N] is added, softmax runs in fp32
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
// N = 197, Dh = 64), loaded with 16-byte vector loads; each warp walks 8
// query rows, each lane scores up to 8 keys, reading 4 values of a key row
// per shared-memory load (one load feeds 4 FMAs, taken in the order of d, so
// the sums are those of a scalar loop), and the [N, N] scores never reach
// device memory. Keys are exactly the N real tokens (no padding, which the
// Pallas kernels mask at -inf), so no row is ever masked throughout by the
// kernel itself. The 16-byte loads need 16-byte aligned operands and row,
// head and batch strides that are multiples of 16 bytes, which both layouts
// give at head widths 32 and 64 (the wrappers check the base pointers).
//
// What bounds it on an H100: for K7 in bf16, bytes (4*B*H*N^2*Dh FLOPs for
// 4*B*H*N*Dh values moved, about 100 FLOPs a byte at N = 197, under the
// tensor cores' ridge of about 295); in fp32, operations on the CUDA cores.
// Inside K1/K8 the core is about a tenth of the block's work. This first
// version runs on the CUDA cores in fp32 for both working types and reads
// each head's K and V once per query tile; moving the two products onto the
// tensor cores is later work.
#include "common.cuh"

using namespace cgt;

namespace {

constexpr int QT = 64;        // query rows per block
constexpr int WARPS = 8;      // 256 threads
constexpr int MAX_N = 256;    // 8 keys per lane

// element offsets of one operand: batch element, head, token row (a row
// offset within one head stays far below 2^31)
struct Strides {
  long long batch, head;
  int row;
};

// K rows padded to DH + 4 floats: 16-byte aligned for float4 reads, and the
// 8 lanes of each quarter-warp phase of a 16-byte read hit distinct banks
template <int DH>
constexpr int kKsLd = DH + 4;

template <int DH>
size_t smem_bytes(int n) {
  return sizeof(float) * ((size_t)n * kKsLd<DH> + (size_t)n * DH + QT * DH +
                          WARPS * MAX_N);
}

// the 16 / sizeof(T) elements at a 16-byte aligned src, as fp32
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) dst[i] = to_f32(e[i]);
}

// n floats (a multiple of 4) to a 16-byte aligned dst
template <int n>
__device__ __forceinline__ void store_f32(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
}

template <typename T, int DH, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, int8_t* __restrict__ q_out,
                     float* __restrict__ q_scale, int N, Strides in,
                     Strides os) {
  constexpr int KS_LD = kKsLd<DH>;
  constexpr int OUTS = DH / 32;               // outputs per lane
  constexpr int VEC = 16 / sizeof(T);         // elements per 16-byte load
  constexpr int CHUNKS = DH / VEC;            // 16-byte loads per row
  extern __shared__ float smem[];
  float* Ks = smem;                    // [N][KS_LD]
  float* Vs = Ks + (size_t)N * KS_LD;  // [N][DH]
  float* Qs = Vs + (size_t)N * DH;     // [QT][DH]
  float* Ps = Qs + QT * DH;            // [WARPS][MAX_N]
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const long long in_off = b * in.batch + h * in.head;
  const T* qb = q + in_off;
  const T* kb = k + in_off;
  const T* vb = v + in_off;
  // 1/sqrt(Dh) in the working type
  const float scale = round_to<T>((float)(1.0 / sqrt((double)DH)));

  for (int idx = threadIdx.x; idx < N * CHUNKS; idx += blockDim.x) {
    const int j = idx / CHUNKS, d = idx % CHUNKS * VEC;
    float kv[VEC], vv[VEC];
    load16(kb + j * in.row + d, kv);
    load16(vb + j * in.row + d, vv);
    store_f32<VEC>(Ks + j * KS_LD + d, kv);
    store_f32<VEC>(Vs + j * DH + d, vv);
  }
  for (int idx = threadIdx.x; idx < QT * CHUNKS; idx += blockDim.x) {
    const int i = idx / CHUNKS, d = idx % CHUNKS * VEC, qi = q0 + i;
    float qv[VEC];
    if (qi < N) {
      load16(qb + qi * in.row + d, qv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[e] = round_to<T>(qv[e] * scale);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[e] = 0.f;
    }
    store_f32<VEC>(Qs + i * DH + d, qv);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* P = Ps + warp * MAX_N;
  const int slots = (N + 31) / 32;  // key slots per lane, uniform in the warp
  for (int i = warp; i < QT; i += WARPS) {
    const int qi = q0 + i;
    if (qi >= N) break;  // uniform across the warp
    const float* qr = Qs + i * DH;
    float s[MAX_N / 32];
#pragma unroll
    for (int t = 0; t < MAX_N / 32; ++t) s[t] = 0.f;
    for (int d = 0; d < DH; d += 4) {
      const float4 qd = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
      for (int t = 0; t < MAX_N / 32; ++t) {
        if (t < slots) {
          const int j = min(lane + 32 * t, N - 1);  // clamped; discarded below
          const float4 kd = *reinterpret_cast<const float4*>(Ks + j * KS_LD + d);
          s[t] = fmaf(qd.x, kd.x, s[t]);
          s[t] = fmaf(qd.y, kd.y, s[t]);
          s[t] = fmaf(qd.z, kd.z, s[t]);
          s[t] = fmaf(qd.w, kd.w, s[t]);
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
    float o[OUTS];
#pragma unroll
    for (int c = 0; c < OUTS; ++c) o[c] = 0.f;
    for (int j = 0; j < N; ++j) {
      const float p = P[j];
#pragma unroll
      for (int c = 0; c < OUTS; ++c) o[c] = fmaf(p, Vs[j * DH + lane + 32 * c], o[c]);
    }
    const long long orow = b * os.batch + h * os.head + qi * os.row;
    if constexpr (QUANT) {
      float amax = 0.f;
#pragma unroll
      for (int c = 0; c < OUTS; ++c) amax = fmaxf(amax, fabsf(o[c]));
      amax = warp_max(amax);
      const float sc = fmaxf(__fdiv_rn(amax, 127.f), kQuantEps);
#pragma unroll
      for (int c = 0; c < OUTS; ++c) q_out[orow + lane + 32 * c] = quantize_code(o[c], sc);
      if (lane == 0) q_scale[((size_t)b * N + qi) * gridDim.y + h] = sc;
    } else {
#pragma unroll
      for (int c = 0; c < OUTS; ++c) out[orow + lane + 32 * c] = from_f32<T>(o[c]);
    }
    __syncwarp();  // P is rewritten by the warp's next query
  }
}

template <typename T, int DH, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* q_scale, int B, int N, int H, Strides in,
           Strides os, cudaStream_t s) {
  // the shared-memory opt-in is a property of the function on a device: set
  // it once per instantiation and device, not on every launch
  static unsigned long long opted_in = 0;  // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !((opted_in >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(attention_kernel<T, DH, QUANT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<DH>(MAX_N));
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted_in |= 1ull << dev;
  }
  const dim3 grid((N + QT - 1) / QT, H, B), block(WARPS * 32);
  attention_kernel<T, DH, QUANT><<<grid, block, smem_bytes<DH>(N), s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask,
      QUANT ? nullptr : (T*)out, QUANT ? (int8_t*)out : nullptr,
      (float*)q_scale, N, in, os);
  return (int)cudaGetLastError();
}

// qkv [B, N, 3D] -> [B, N, D], head width 64 (K1, K8 and K5)
template <typename T, bool QUANT>
int launch_packed(const void* qkv, const void* mask, void* out, void* q_scale,
                  int B, int N, int H, int D, cudaStream_t s) {
  constexpr int DH = 64;
  const Strides in{(long long)N * 3 * D, DH, 3 * D};
  const Strides os{(long long)N * D, DH, D};
  const T* base = (const T*)qkv;
  return launch<T, DH, QUANT>(base, base + D, base + 2 * D, mask, out, q_scale,
                              B, N, H, in, os, s);
}

// q, k, v, out [B, H, N, DH] (K7)
template <typename T, int DH>
int launch_bhnd(const void* q, const void* k, const void* v, const void* mask,
                void* out, int B, int N, int H, cudaStream_t s) {
  const Strides st{(long long)H * N * DH, (long long)N * DH, DH};
  return launch<T, DH, false>(q, k, v, mask, out, nullptr, B, N, H, st, st, s);
}

}  // namespace

// head widths and N <= 256 are checked by the Python wrappers; refused here
// too so a bad call fails loudly instead of reading out of bounds
extern "C" int cgt_attention(const void* qkv, const void* mask, void* out,
                             int B, int N, int H, int D, int dtype,
                             void* stream) {
  if (N < 1 || N > MAX_N || D != H * 64) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_packed<float, false>(qkv, mask, out, nullptr, B, N, H, D, s);
  if (dtype == kBF16)
    return launch_packed<__nv_bfloat16, false>(qkv, mask, out, nullptr, B, N,
                                               H, D, s);
  return (int)cudaErrorInvalidValue;
}

// K5's attention core: int8 codes q_out [B, N, D] and fp32 scales
// q_scale [B, N, H] in place of attn
extern "C" int cgt_attention_q8(const void* qkv, const void* mask, void* q_out,
                                void* q_scale, int B, int N, int H, int D,
                                int dtype, void* stream) {
  if (N < 1 || N > MAX_N || D != H * 64) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_packed<float, true>(qkv, mask, q_out, q_scale, B, N, H, D, s);
  if (dtype == kBF16)
    return launch_packed<__nv_bfloat16, true>(qkv, mask, q_out, q_scale, B, N,
                                              H, D, s);
  return (int)cudaErrorInvalidValue;
}

// K7: standalone attention on contiguous q, k, v, out [B, H, N, Dh],
// Dh 32 or 64
extern "C" int cgt_attention_bhnd(const void* q, const void* k, const void* v,
                                  const void* mask, void* out, int B, int N,
                                  int H, int Dh, int dtype, void* stream) {
  if (N < 1 || N > MAX_N || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32 && Dh == 32)
    return launch_bhnd<float, 32>(q, k, v, mask, out, B, N, H, s);
  if (dtype == kF32 && Dh == 64)
    return launch_bhnd<float, 64>(q, k, v, mask, out, B, N, H, s);
  if (dtype == kBF16 && Dh == 32)
    return launch_bhnd<__nv_bfloat16, 32>(q, k, v, mask, out, B, N, H, s);
  if (dtype == kBF16 && Dh == 64)
    return launch_bhnd<__nv_bfloat16, 64>(q, k, v, mask, out, B, N, H, s);
  return (int)cudaErrorInvalidValue;
}

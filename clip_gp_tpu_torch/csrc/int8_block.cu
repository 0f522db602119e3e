// The int8 parts of K5 and K6: _q8_ln_block_kernel and _q8_mlp_kernel of
// clip_gp_tpu/ops/int8_block.py (the int8 ViT image tower of serving). The
// attention core of K5, with its quantize epilogue, is in attention.cu.
//
//   quantize: (optional LayerNorm, fp32 gamma/beta) then per-row symmetric
//             int8: scale = max(absmax / 127, 1e-12), q = clip(rint(v /
//             scale), ±127). Rows of the working type T (LN of x) or of fp32
//             (the QuickGELU hidden). IEEE division and rintf (round half to
//             even, as jnp.round): CUDA's roundf rounds half away from zero.
//   gemm:     out[M,N] = epilogue(Σ_g (A·Wᵀ)_g · row_scale[m, g] ·
//             col_scale[n]) with A int8 [M,K] and Wt int8 [N,K] (the JAX
//             right-multiply weight [K,N] transposed: both operands
//             K-major), the products exact in int32 and the sum over groups
//             of `group_k` columns of K in fp32. One group (group_k = K) for
//             qkv, c_fc and c_proj; one group per 64-wide head for K5's
//             out-projection, whose activation scale changes every head, so
//             a single int8 sum over all of D would be wrong.
//             Epilogues, in fp32 with the Pallas kernels' order:
//               K5 qkv:      T(acc + b)
//               K6 c_fc:     fp32 QuickGELU(acc + b)   (the [T,4D] hidden)
//               K5 out-proj: T((x + acc) + b)
//               K6 c_proj:   T(x + (acc + b))
//             Multiplies and adds are __fmul_rn/__fadd_rn, so nvcc cannot
//             contract them into FMAs the plain version does not make.
//
// What bounds it on an H100: operations for qkv and c_proj (357 and 476 G
// int8 operations at ViT-B/16 batch 512, 0.18 and 0.24 ms at 1,979 TOP/s),
// bytes for the out-projection (the residual read and the output written,
// 0.12 ms at 3.35 TB/s) and for c_fc (its fp32 [T,4D] hidden, 1.24 GB: 0.39
// ms). The design feeds Hopper's int8 tensor cores the way they are fed
// fastest: wgmma.m64nNk32 reads both operands from shared memory, K-major
// (the only layout s8 wgmma takes, so W arrives as [N,K]), where TMA writes
// them with the 128-byte swizzle; one producer warp keeps a ring of 3-4
// stages in flight on mbarriers, and two consumer warpgroups multiply, so
// no thread spends registers or instructions on the copies. The products
// are issued on no divergent path (ptxas serializes every wgmma of a kernel
// that has one). What is left over the bound:
// - K5's out-projection must scale each 64-byte head's int32 sums into the
//   fp32 ones: five instructions per element per head (the exact
//   int-to-float by two adds, both multiplies, the add), twelve times a
//   tile, behind a wgmma.wait_group 0 each. At ViT-B/16 batch 512 that
//   work alone adds about 0.16 ms to the product's 0.30 (measured without
//   it; the waits cost nothing measurable). Two int32 sets in one
//   warpgroup, to scale one head while the next one's products run, made
//   ptxas serialize the products and spill (PERF.md).
// - qkv, c_fc and c_proj run 128x128 tiles, two blocks an SM, so one
//   block's epilogue overlaps the other's products; each block is one tile
//   (no persistent grid), and c_fc writes its fp32 hidden from registers.
// The fp32 hidden stays in device memory (why: ROADMAP, queue 2).
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

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
constexpr int BM = 128;
constexpr int BK = 128;       // k-tile bytes: the 128-byte swizzle's row,
                              // four k32 steps of wgmma
constexpr int KSTEPS = BK / 32;
constexpr int CONSUMERS = 2;  // warpgroups, 64 rows of the tile each
constexpr int THREADS = 128 * CONSUMERS + 32;  // and one producer warp
constexpr int A_STAGE = BM * BK;               // 16 KB
constexpr int MAX_SMEM = 232448;               // an sm_90 block's most

// The kernel's three shapes, by GK, the group's width in k32 steps:
// - GK = 0, one group over all of K (qkv, c_fc, c_proj): 128x128 tiles, a
//   consumer thread holds 64 int32 sums (ptxas gives 96 registers and
//   spills a few dozen bytes), two blocks an SM
//   (3 stages each, 97 KB), so one block's epilogue runs beside the other's
//   products;
// - GK = 2, 64-byte groups (K5's out-projection, a head each): 128x64
//   tiles, 32 int32 and 32 fp32 sums a thread, two blocks an SM (4 stages of
//   24 KB each), so one block's products run while the other scales a group;
// - GK = -1, any other group_k (no caller sends one): 128x128 tiles, the
//   group ends found at run time, so its products sit on a divergent path
//   and ptxas serializes them; one block an SM.
template <int GK>
struct Shape {
  static constexpr int bn = GK == 2 ? 64 : 128;
  static constexpr int stages = GK == 2 ? 4 : 3;
  static constexpr int blocks = GK < 0 ? 1 : 2;
};

template <int DT>
using WorkT = typename std::conditional<DT == kBF16, __nv_bfloat16, float>::type;

// two adjacent residual values (n even, N % 4 == 0: both inside the row)
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// two adjacent outputs of one epilogue from their sums v, biases b and
// residuals r, in fp32 with the Pallas kernels' order; one 8-byte (fp32) or
// 4-byte (bf16) store
template <int EPI, typename OutT>
__device__ __forceinline__ void store_pair(OutT* out, float v0, float v1, float b0,
                                           float b1, float2 r) {
  float o0, o1;
  if constexpr (EPI == kEpiQkv) {
    o0 = __fadd_rn(v0, b0);
    o1 = __fadd_rn(v1, b1);
  } else if constexpr (EPI == kEpiGelu) {
    const float h0 = __fadd_rn(v0, b0), h1 = __fadd_rn(v1, b1);
    o0 = __fmul_rn(h0, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, h0)))));
    o1 = __fmul_rn(h1, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, h1)))));
  } else if constexpr (EPI == kEpiResidAttn) {
    o0 = __fadd_rn(__fadd_rn(r.x, v0), b0);
    o1 = __fadd_rn(__fadd_rn(r.y, v1), b1);
  } else {
    o0 = __fadd_rn(r.x, __fadd_rn(v0, b0));
    o1 = __fadd_rn(r.y, __fadd_rn(v1, b1));
  }
  if constexpr (std::is_same<OutT, float>::value) {
    *reinterpret_cast<float2*>(out) = make_float2(o0, o1);
  } else {
    *reinterpret_cast<uint32_t*>(out) = pack_bf16(o0, o1);
  }
}

// facc (+)= (sums · row scale) · column scale, fp32 rounding to nearest at
// each step; element i of a thread's wgmma m64nN fragment is row row0 + 8
// ((i >> 1) & 1) and column 8 (i >> 2) + 2 t4 + (i & 1). SMALL: every sum
// is at most 2^22 in magnitude, so its float is (2^23 + 2^22 + v as the
// bits' integer) - (2^23 + 2^22), exact, two adds in place of the slower
// conversion instruction.
template <bool SMALL, bool ADD, int NA>
__device__ __forceinline__ void scale_sums(float (&facc)[NA], const int (&sums)[NA],
                                           float rs0, float rs1,
                                           const float* cs_s, int t4) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const float2 c = *reinterpret_cast<const float2*>(cs_s + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v = sums[4 * j + e];
      const float f = SMALL ? __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.f)
                            : (float)v;
      const float x = __fmul_rn(__fmul_rn(f, e & 2 ? rs1 : rs0), e & 1 ? c.y : c.x);
      facc[4 * j + e] = ADD ? __fadd_rn(facc[4 * j + e], x) : x;
    }
  }
}

// out[M,N] = epilogue(Σ_g (A·Wᵀ)_g · row_scale[m, g] · col_scale[n]) with A
// int8 [M,K] and Wt int8 [N,K], both K-major, read by TMA (tm_a, tm_w: boxes
// of 128 k-bytes by 128 (A) or BN (Wt) rows, 128-byte swizzle, zeros past
// M, N and K). A 128xBN output tile a block: one producer warp keeps the
// ring of k-tiles full (one thread issues both TMA loads of a stage onto
// its "full" mbarrier once the consumers have released it on its "empty"
// one); two consumer warpgroups each run wgmma.m64nBNk32 on 64 rows of each
// landed stage, the int32 sums in registers. Every k-tile issues its four
// products, the zero-filled tail past K included (it adds zeros), so no
// product sits on a divergent path, where ptxas would serialize them all.
// Ungrouped, a warpgroup commits a k-tile's products and waits for the tile
// before it (wait_group 1), so it frees that stage while the next one's
// products run; the sums are scaled into fp32 once, after the last tile.
// Grouped, each group's int32 sum is complete only after wait_group 0; it
// is then scaled into the fp32 sums, and the group's first product starts
// the next one from zero (scale-d 0). A phantom group past K (K % 128 ==
// 64) sums zeros and meets a zero row scale. The consumers stage the
// block's column scales, bias and row scales [BM, groups + 1] in shared
// memory while the first tiles land; each thread finishes its outputs from
// registers.
template <int EPI, int DT, int GK>
__global__ void __launch_bounds__(THREADS, Shape<GK>::blocks)
    q8_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_w,
                   const float* __restrict__ row_scale,
                   const float* __restrict__ col_scale,
                   const float* __restrict__ bias,
                   const WorkT<DT>* __restrict__ resid,
                   typename std::conditional<EPI == kEpiGelu, float, WorkT<DT>>::type*
                       __restrict__ out,
                   int M, int N, int K, int group_k) {
  using OutT = typename std::conditional<EPI == kEpiGelu, float, WorkT<DT>>::type;
  constexpr int BN = Shape<GK>::bn, S = Shape<GK>::stages;
  constexpr int B_STAGE = BN * BK, STAGE_BYTES = A_STAGE + B_STAGE;
  constexpr int NA = BN / 2;  // int32 sums a thread
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles start on a 1,024-byte boundary (the swizzle's period)
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + S * A_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + S * B_STAGE);
  uint64_t* empty = full + S;
  float* cs_s = reinterpret_cast<float*>(empty + S);  // [BN]
  float* b_s = cs_s + BN;                              // [BN]
  float* rs_s = b_s + BN;                              // [BM][groups + 1]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int groups = K / group_k, rs_ld = groups + 1;
  const int ktiles = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);               // the producer's arrival + bytes
      mbar_init(empty + s, CONSUMERS * 4);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  if (warp == CONSUMERS * 4) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(empty + s, ((kt / S) - 1) & 1);
        mbar_arrive_expect_tx(full + s, STAGE_BYTES);
        tma_load_2d(As + s * A_STAGE, &tm_a, full + s, kt * BK, m0);
        tma_load_2d(Bs + s * B_STAGE, &tm_w, full + s, kt * BK, n0);
      }
    }
    return;
  }

  // the consumers stage the scales and bias while the first tiles land
  constexpr int CT = 128 * CONSUMERS;
  for (int i = tid; i < BN; i += CT) {
    const int n = n0 + i;
    cs_s[i] = n < N ? col_scale[n] : 0.f;
    b_s[i] = n < N ? bias[n] : 0.f;
  }
  for (int i = tid; i < BM * rs_ld; i += CT) {
    const int m = m0 + i / rs_ld, grp = i % rs_ld;
    rs_s[i] = m < M && grp < groups ? row_scale[(size_t)m * groups + grp] : 0.f;
  }
  consumers_sync<CT>();

  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int row0 = wg * 64 + w4 * 16 + g;  // this thread's rows: row0, row0 + 8
  int acc[NA];
  float facc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    acc[i] = 0;
    facc[i] = 0.f;
  }
  auto fence_acc = [&]() {
#pragma unroll
    for (int i = 0; i < NA; ++i) fence_operand(acc[i]);
  };
  // group grp's sums, scaled into the fp32 ones (group widths of at most
  // 256 bytes sum to at most 2^22 in magnitude)
  auto flush = [&](int grp) {
    const float rs0 = rs_s[row0 * rs_ld + grp], rs1 = rs_s[(row0 + 8) * rs_ld + grp];
    if (GK > 0 || (GK < 0 && group_k <= 256))
      scale_sums<true, GK != 0>(facc, acc, rs0, rs1, cs_s, t4);
    else
      scale_sums<false, GK != 0>(facc, acc, rs0, rs1, cs_s, t4);
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  };
  // wait for the products issued, then scale group grp
  auto end_group = [&](int grp) {
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();
    flush(grp);
    wgmma_fence();
  };

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % S;
    mbar_wait(full + s, (kt / S) & 1);
    const uint64_t da = desc_sw128(As + s * A_STAGE + wg * 64 * BK);
    const uint64_t db = desc_sw128(Bs + s * B_STAGE);
    fence_acc();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if constexpr (GK == 0) {
        wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      } else if constexpr (GK > 0) {  // a group's first product restarts it
        wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, kk % GK != 0);
        if ((kk + 1) % GK == 0) end_group((kt * KSTEPS + kk) / GK);
      } else {
        const int k0 = kt * BK + kk * 32;
        if (k0 < K) {
          wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, k0 % group_k != 0);
          if ((k0 + 32) % group_k == 0) end_group((k0 + 32) / group_k - 1);
        }
      }
    }
    if constexpr (GK == 0) {
      wgmma_commit();
      wgmma_wait<1>();  // tile kt - 1's products completed: free its stage
      if (kt > 0) release((kt - 1) % S);
    } else if constexpr (GK > 0) {
      release(s);  // the tile ended on a group's end: its products completed
    } else {
      wgmma_commit();  // a group may run on into the next tile
      wgmma_wait<0>();
      release(s);
    }
  }
  if constexpr (GK == 0) {
    wgmma_wait<0>();
    fence_acc();
    flush(0);
  }

  // the epilogue, 8 column pairs at a time: their residuals are all loaded
  // before the first store, so the loads' latencies overlap
  constexpr bool kResid = EPI == kEpiResidAttn || EPI == kEpiResidMlp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + row0 + 8 * r;
    if (m >= M) continue;
    const size_t row = (size_t)m * N;
#pragma unroll
    for (int jb = 0; jb < NA / 4; jb += 8) {
      float2 rv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 8 * (jb + j) + 2 * t4;
        rv[j] = kResid && n < N ? load_pair(resid + row + n) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * (jb + j) + 2 * r, nl = 8 * (jb + j) + 2 * t4;
        if (n0 + nl < N)
          store_pair<EPI, OutT>(out + row + n0 + nl, facc[i], facc[i + 1], b_s[nl],
                                b_s[nl + 1], rv[j]);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time, so the library
// links without -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a K-major int8 [rows, k] matrix in boxes of BK bytes by
// box_rows rows, 128-byte swizzle, zeros outside it
int encode_k_major(CUtensorMap* map, const void* ptr, int rows, int k, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1u, 1u};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the dynamic shared-memory opt-in (above 48 KB) is a property of the
// function on a device: set once per instantiation and device
template <int EPI, int DT, int GK>
int opt_in_smem() {
  // bit d: device d; atomic, as several host threads may launch
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && ((opted_in.load() >> dev) & 1ull)) return 0;
  err = cudaFuncSetAttribute(q8_gemm_kernel<EPI, DT, GK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) opted_in.fetch_or(1ull << dev);
  return 0;
}

template <int EPI, int DT, int GK>
int launch_gemm(const void* a, const void* w, const void* rs, const void* cs,
                const void* bias, const void* resid, void* out, int M, int N,
                int K, int group_k, cudaStream_t s) {
  using T = WorkT<DT>;
  using OutT = typename std::conditional<EPI == kEpiGelu, float, T>::type;
  constexpr int BN = Shape<GK>::bn, S = Shape<GK>::stages;
  const size_t smem = 1024 + (size_t)S * (A_STAGE + BN * BK + 2 * sizeof(uint64_t)) +
                      sizeof(float) * (2 * BN + (size_t)BM * (K / group_k + 1));
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = opt_in_smem<EPI, DT, GK>();
  if (err != 0) return err;
  CUtensorMap tm_a, tm_w;
  if ((err = encode_k_major(&tm_a, a, M, K, BM)) != 0) return err;
  if ((err = encode_k_major(&tm_w, w, N, K, BN)) != 0) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  q8_gemm_kernel<EPI, DT, GK><<<grid, THREADS, smem, s>>>(
      tm_a, tm_w, (const float*)rs, (const float*)cs, (const float*)bias,
      (const T*)resid, (OutT*)out, M, N, K, group_k);
  return (int)cudaGetLastError();
}

template <int EPI, int GK>
int dispatch_dtype(const void* a, const void* w, const void* rs, const void* cs,
                   const void* bias, const void* resid, void* out, int M, int N,
                   int K, int group_k, int dtype, cudaStream_t s) {
  if (dtype == kF32)
    return launch_gemm<EPI, kF32, GK>(a, w, rs, cs, bias, resid, out, M, N, K,
                                      group_k, s);
  if constexpr (EPI != kEpiGelu) {  // the hidden is fp32 in either type
    if (dtype == kBF16)
      return launch_gemm<EPI, kBF16, GK>(a, w, rs, cs, bias, resid, out, M, N, K,
                                         group_k, s);
  }
  return (int)cudaErrorInvalidValue;
}

// one group: GK 0; K5's heads (64-byte groups, its residual epilogue): GK 2;
// any other grouping: GK -1
template <int EPI>
int dispatch_gemm(const void* a, const void* w, const void* rs, const void* cs,
                  const void* bias, const void* resid, void* out, int M, int N,
                  int K, int group_k, int dtype, cudaStream_t s) {
  if (group_k == K)
    return dispatch_dtype<EPI, 0>(a, w, rs, cs, bias, resid, out, M, N, K,
                                  group_k, dtype, s);
  if constexpr (EPI == kEpiResidAttn) {
    if (group_k == 64)
      return dispatch_dtype<EPI, 2>(a, w, rs, cs, bias, resid, out, M, N, K,
                                    group_k, dtype, s);
  }
  return dispatch_dtype<EPI, -1>(a, w, rs, cs, bias, resid, out, M, N, K, group_k,
                                 dtype, s);
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

// a int8 [M,K] and w int8 [N,K] (the JAX weight [K,N] transposed: both
// operands K-major), 16-byte aligned; row_scale is [M, K / group_k]; resid
// is read by the residual epilogues only and may be null for the others;
// dtype is out's type (fp32 for c_fc). K and group_k are multiples of 32,
// group_k divides K, N % 4 == 0.
extern "C" int cgt_q8_gemm(const void* a, const void* w, const void* row_scale,
                           const void* col_scale, const void* bias,
                           const void* resid, void* out, int M, int N, int K,
                           int group_k, int dtype, int epilogue, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 32 || group_k < 32 || group_k % 32 ||
      K % group_k || N % 4 || (((uintptr_t)a | (uintptr_t)w) & 15))
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

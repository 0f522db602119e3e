// The fp32 GEMM core on Hopper's tensor cores: out[M,N] = epilogue(A·B) at
// about fp32 accuracy as 3xTF32 on mma.sync.m16n8k8, fed by a cp.async
// ring. Every fp32 matrix product of the port outside the attention cores
// runs through it: gemm_bwd.cu's (the products of K3 and K4) and the fp32
// products of ln_gemm.cu (K1, K2 and K8).
//
// Template parameters:
// - Tiles: the block's output tile (BM x BN), its warps (WARPS_M x WARPS_N,
//   each holding a (BM / WARPS_M) x (BN / WARPS_N) block of fp32
//   accumulators) and the blocks an SM should hold (register cap).
// - TRANS_A / TRANS_B: how A and B are stored. A is [M,K] ("N", K
//   contiguous) or [K,M] ("T"); B is [K,N] ("N") or [N,K] ("T"). All four
//   occur in the backward products.
// - TA / TB: float, or __nv_bfloat16 for the operand that holds x or dout
//   in the working type. A bf16 tile is copied raw and widened when its
//   fragment is loaded; a bf16 value is exact in TF32, so it needs no lo
//   part and the pass that would multiply that lo (exact zeros) is skipped.
// - EPI: what happens to the fp32 sum before its one store: nothing, + bias
//   [N], + bias with QuickGELU(out) written as a second output,
//   × QuickGELU'(aux[M,N]) (the backward products); QuickGELU(acc + bias)
//   written alone, (r + acc) + bias or r + (acc + bias) with the residual r
//   = aux[M,N] (the forward products, each sum in the order of the Pallas
//   kernel).
//
// The arithmetic: each fp32 operand splits into hi = tf32(x) (cvt.rna) and
// lo = tf32(x - hi) as its fragment is loaded from shared memory, and each
// 8-deep k-step sums lo·hi + hi·lo + hi·hi, the small terms first, as the
// attention core does (tests/test_torch_gemm_bwd_numerics.py and
// tests/test_torch_gemm_fwd_numerics.py emulate the operands' rounding bit
// for bit and hold K3's and K4's gradients and the fp32 K1, K2 and K8 so
// computed to their tolerances, which one TF32 pass misses). The three
// products of a k-step are summed on the tensor cores from zero, and that
// sum is added to the fp32 accumulator by an ordinary fp32 add, rounding to
// nearest. Chaining every k-step into the accumulator on the tensor cores
// instead errs about ten times more on an H100, and the error grows with K:
// the tensor cores' sums keep fewer bits than a rounded fp32 add, so each
// mma.sync that takes the accumulator as its addend can lose up to a unit
// in its last place, some 3K/8 times over a product of depth K. With
// ViT-B/16's c_proj (K = 3,072) that put K2's fp32 output 1.1e-4 from the
// plain version's, against 1.2e-5 with each k-step summed from zero, which
// keeps every fp32 cell of chip_smoke.py under a tenth of its tolerance
// for about 15% more time.
//
// The pipeline: k-tiles of depth BK = 16 stream through a ring of STAGES =
// 4 shared-memory stages, filled by 16-byte cp.async whose src-size form
// zero-fills rows past M or N and columns past the K range (each 16-byte
// chunk lies wholly inside or outside, since the contiguous dimension of a
// 16-byte row chunk is a multiple of 4 floats or 8 bf16; A stored [K,M]
// with M % 4 != 0 falls back to 4-byte copies). Copies of tiles kt + 1 to
// kt + 3 overlap the products of tile kt, with one __syncthreads per
// k-tile. Within each 8-deep k-step A and B permute k alike (slot t reads
// element 2t, slot t + 4 element 2t + 1), so an operand stored with k
// contiguous gives both of a lane's values in one 64-bit (fp32) or 32-bit
// (bf16) read. Shared rows are padded so that the fragment reads of a warp
// hit distinct banks in all four layouts: k-contiguous rows by 8 elements,
// [k][m] / [k][n] rows by 4 floats or 8 bf16.
//
// Split K: blockIdx.z takes the k range [z·k_chunk, (z+1)·k_chunk) and
// writes its own [M,N] part at out + z·M·N (a caller adds the parts in a
// fixed order); only the epilogue-free products split. No atomics: every
// output element is summed by one thread in a fixed k order, so a call
// gives the same bits on every run.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace cgt {

// 4 bytes when ``valid``, else 4 zero bytes (the fallback for rows whose
// length is not a multiple of 16 bytes)
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

enum GemmEpi {
  kGemmEpiNone = 0,
  kGemmEpiBias = 1,
  kGemmEpiBiasGelu = 2,
  kGemmEpiGeluBwd = 3,
  kGemmEpiGelu = 4,       // QuickGELU(acc + b), the activation alone
  kGemmEpiResidAttn = 5,  // (r + acc) + b
  kGemmEpiResidMlp = 6,   // r + (acc + b)
};

template <int EPI>
constexpr bool kGemmEpiAddsBias = EPI != kGemmEpiNone && EPI != kGemmEpiGeluBwd;

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int MIN_BLOCKS_>
struct GemmTiles {
  static constexpr int BM = BM_, BN = BN_, BK = 16, STAGES = 4;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's block
  static constexpr int MT = WM / 16, NT = WN / 8;              // its mma tiles
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp block of whole mma tiles");
};

// The three tile shapes the wrappers pick from (the ``tile`` argument of
// cgt_gemm and cgt_gemm_bwd), each a block of 4 warps: 128x128 (64x64
// accumulators a warp, two blocks an SM), 64x64 (32x32, four) and 128x64
// (64x32, three), so that an output of few 128x128 tiles still fills the
// card.
enum GemmTile { kTile128 = 0, kTile64 = 1, kTile128x64 = 2 };
using Tiles128 = GemmTiles<128, 128, 2, 2, 2>;
using Tiles64 = GemmTiles<64, 64, 2, 2, 4>;
using Tiles128x64 = GemmTiles<128, 64, 2, 2, 3>;

__device__ __forceinline__ float quick_gelu_sigmoid(float h) {
  return 1.f / (1.f + expf(-1.702f * h));
}

namespace gemm_tf32 {

// One operand's stage in shared memory. K_CONTIG: stored with k contiguous
// (A [M,K], B [N,K]): MN rows of BK; else BK rows of MN.
template <typename T, bool K_CONTIG, int MN, int BK>
struct Stage {
  static constexpr int ROWS = K_CONTIG ? MN : BK;
  static constexpr int COLS = K_CONTIG ? BK : MN;
  static constexpr int LD =
      COLS + ((K_CONTIG || sizeof(T) == 2) ? 8 : 4);  // elements
  static constexpr int SIZE = ROWS * LD;
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements a chunk
  static constexpr int CHUNKS = ROWS * COLS / VEC;
  static_assert((LD * sizeof(T)) % 16 == 0, "16-byte aligned shared rows");
};

// copy one stage: rows [row0, row0 + ROWS) x columns [col0, col0 + COLS)
// of a row-major source with ``ld`` elements a row; rows at or past
// row_lim and columns at or past col_lim read as zero. ``vec``: col_lim and
// ld are multiples of VEC (else 4-byte copies; fp32 only).
template <typename T, class S, int THREADS>
__device__ __forceinline__ void load_stage(T* dst, const T* src, int ld,
                                           int row0, int row_lim, int col0,
                                           int col_lim, bool vec, int tid) {
  static_assert(S::CHUNKS % THREADS == 0, "whole chunks a thread");
  constexpr int PER_ROW = S::COLS / S::VEC;
#pragma unroll
  for (int i = 0; i < S::CHUNKS / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / PER_ROW, col = c % PER_ROW * S::VEC;
    const int gr = row0 + r, gc = col0 + col;
    T* d = dst + r * S::LD + col;
    const T* s = src + (size_t)gr * ld + gc;
    if constexpr (std::is_same<T, float>::value) {
      if (!vec) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gr < row_lim && gc + e < col_lim;
          cp_async4_zfill(d + e, ok ? s + e : src, ok);
        }
        continue;
      }
    }
    const bool ok = gr < row_lim && gc < col_lim;
    cp_async16_zfill(d, ok ? s : src, ok);
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __uint_as_float((uint32_t)__bfloat16_as_ushort(v) << 16);
}

// the values at k and k + 1 (k even) of row/column ``mn`` of a stage
template <typename T, class S, bool K_CONTIG>
__device__ __forceinline__ float2 frag_pair(const T* s, int mn, int k) {
  if constexpr (K_CONTIG) {
    if constexpr (std::is_same<T, float>::value) {
      return *reinterpret_cast<const float2*>(s + mn * S::LD + k);
    } else {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(s + mn * S::LD + k);
      return make_float2(__uint_as_float(w << 16),
                         __uint_as_float(w & 0xffff0000u));
    }
  } else {
    return make_float2(widen(s[k * S::LD + mn]), widen(s[(k + 1) * S::LD + mn]));
  }
}

// hi (and, for an fp32 operand, lo) of a fragment value
template <bool LO>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (LO) {
    split_tf32(x, hi, lo);
  } else {
    hi = __float_as_uint(x);  // a widened bf16: exact in TF32
  }
}

template <class Tl, bool TRANS_A, bool TRANS_B, typename TA, typename TB,
          int EPI>
__global__ void __launch_bounds__(Tl::THREADS, Tl::MIN_BLOCKS)
    gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
                const float* __restrict__ bias, const float* __restrict__ aux,
                float* __restrict__ out, float* __restrict__ out2, int M,
                int N, int K, int k_chunk, bool a_vec) {
  using SA = Stage<TA, !TRANS_A, Tl::BM, Tl::BK>;
  using SB = Stage<TB, TRANS_B, Tl::BN, Tl::BK>;
  constexpr bool A_LO = std::is_same<TA, float>::value;
  constexpr bool B_LO = std::is_same<TB, float>::value;
  constexpr int BK = Tl::BK, STAGES = Tl::STAGES, MT = Tl::MT, NT = Tl::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  TA* As = reinterpret_cast<TA*>(smem);
  TB* Bs = reinterpret_cast<TB*>(smem + sizeof(TA) * STAGES * SA::SIZE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * Tl::BM, n0 = blockIdx.x * Tl::BN;
  const int wm = warp / Tl::WARPS_N * Tl::WM, wn = warp % Tl::WARPS_N * Tl::WN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int ktiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  out += (size_t)blockIdx.z * M * N;  // this split's part

  auto load_tile = [&](int kt) {
    const int k0 = k_begin + kt * BK, slot = kt % STAGES;
    if constexpr (!TRANS_A)  // [M, K]
      load_stage<TA, SA, Tl::THREADS>(As + slot * SA::SIZE, A, K, m0, M, k0,
                                      k_end, true, tid);
    else  // [K, M]
      load_stage<TA, SA, Tl::THREADS>(As + slot * SA::SIZE, A, M, k0, k_end,
                                      m0, M, a_vec, tid);
    if constexpr (!TRANS_B)  // [K, N]
      load_stage<TB, SB, Tl::THREADS>(Bs + slot * SB::SIZE, B, N, k0, k_end,
                                      n0, N, true, tid);
    else  // [N, K]
      load_stage<TB, SB, Tl::THREADS>(Bs + slot * SB::SIZE, B, K, n0, N, k0,
                                      k_end, true, tid);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the ring: tiles kt + 1 .. kt + STAGES - 1 are in flight while tile kt
  // is multiplied; one commit group per tile (empty past the last)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();  // this thread's chunks of tile 0 landed

  for (int kt = 0; kt < ktiles; ++kt) {
    // tile kt visible to every warp, and every warp done with tile kt - 1,
    // whose slot the next copy refills
    __syncthreads();
    if (kt + STAGES - 1 < ktiles) load_tile(kt + STAGES - 1);
    cp_async_commit();

    const int slot = kt % STAGES;
    const TA* as = As + slot * SA::SIZE;
    const TB* bs = Bs + slot * SB::SIZE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      const int k = kk + 2 * t;  // slot t: element 2t, slot t + 4: 2t + 1
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 v = frag_pair<TB, SB, TRANS_B>(bs, wn + 8 * j + g, k);
        split<B_LO>(v.x, bh[j][0], bl[j][0]);
        split<B_LO>(v.y, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm + 16 * i + g;
        const float2 v0 = frag_pair<TA, SA, !TRANS_A>(as, r, k);
        const float2 v1 = frag_pair<TA, SA, !TRANS_A>(as, r + 8, k);
        uint32_t ah[4], al[4];
        split<A_LO>(v0.x, ah[0], al[0]);  // (row g, slot t)
        split<A_LO>(v1.x, ah[1], al[1]);  // (row g + 8, slot t)
        split<A_LO>(v0.y, ah[2], al[2]);  // (row g, slot t + 4)
        split<A_LO>(v1.y, ah[3], al[3]);  // (row g + 8, slot t + 4)
        // the k-step's lo·hi, hi·lo, then hi·hi, summed on the tensor cores
        // from zero (the NT independent sums of a pass go between two
        // dependent products), then added to the accumulators in fp32
        float d[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
        if constexpr (A_LO) {
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(d[j], al, bh[j][0], bh[j][1]);
        }
        if constexpr (B_LO) {
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(d[j], ah, bl[j][0], bl[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_tf32(d[j], ah, bh[j][0], bh[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += d[j][e];
        }
      }
    }
    cp_async_wait<STAGES - 2>();  // this thread's chunks of tile kt + 1
  }
  cp_async_wait<0>();  // no copy outlives the block (the groups left are empty)

  // epilogue from the accumulators: element e of mma tile (i, j) is row
  // 16i + g + 8(e >> 1), column 8j + 2t + (e & 1); N % 4 == 0, so a
  // lane's column pair lies wholly inside or outside
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t;
        if (n >= N) continue;
        const size_t idx = (size_t)m * N + n;
        float2 v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        float2 r = make_float2(0.f, 0.f);  // the residual
        if constexpr (EPI == kGemmEpiResidAttn || EPI == kGemmEpiResidMlp)
          r = *reinterpret_cast<const float2*>(aux + idx);
        if constexpr (EPI == kGemmEpiResidAttn) {
          v.x += r.x;
          v.y += r.y;
        }
        if constexpr (kGemmEpiAddsBias<EPI>) {
          const float2 b = *reinterpret_cast<const float2*>(bias + n);
          v.x += b.x;
          v.y += b.y;
        }
        if constexpr (EPI == kGemmEpiResidMlp) {
          v.x = r.x + v.x;
          v.y = r.y + v.y;
        }
        if constexpr (EPI == kGemmEpiBiasGelu) {
          *reinterpret_cast<float2*>(out2 + idx) =
              make_float2(v.x * quick_gelu_sigmoid(v.x),
                          v.y * quick_gelu_sigmoid(v.y));
        }
        if constexpr (EPI == kGemmEpiGelu) {
          v.x *= quick_gelu_sigmoid(v.x);
          v.y *= quick_gelu_sigmoid(v.y);
        }
        if constexpr (EPI == kGemmEpiGeluBwd) {
          // d/dh [h·s(1.702h)] = s + 1.702·h·s·(1 - s), as the Pallas kernel
          const float2 hh = *reinterpret_cast<const float2*>(aux + idx);
          const float s0 = quick_gelu_sigmoid(hh.x), s1 = quick_gelu_sigmoid(hh.y);
          v.x *= s0 + 1.702f * hh.x * s0 * (1.f - s0);
          v.y *= s1 + 1.702f * hh.y * s1 * (1.f - s1);
        }
        *reinterpret_cast<float2*>(out + idx) = v;
      }
    }
}

}  // namespace gemm_tf32

// Launch one product (out holds ``splits`` parts when splits > 1). The
// caller checks the layout rules: N % 4 == 0; K % 4 (fp32) or % 8 (bf16)
// for an operand stored with k contiguous; N % 8 for a bf16 B stored
// [K,N]; 16-byte aligned pointers; a bf16 operand never stored [K,M].
template <class Tl, bool TRANS_A, bool TRANS_B, typename TA, typename TB,
          int EPI>
int launch_gemm_tf32(const void* a, const void* b, const void* bias,
                     const void* aux, void* out, void* out2, int M, int N,
                     int K, int splits, cudaStream_t s) {
  using SA = gemm_tf32::Stage<TA, !TRANS_A, Tl::BM, Tl::BK>;
  using SB = gemm_tf32::Stage<TB, TRANS_B, Tl::BN, Tl::BK>;
  constexpr size_t smem =
      Tl::STAGES * (sizeof(TA) * SA::SIZE + sizeof(TB) * SB::SIZE);
  auto* kernel = gemm_tf32::gemm_kernel<Tl, TRANS_A, TRANS_B, TA, TB, EPI>;
  // the opt-in above 48 KB is a property of the function on a device: set
  // once per instantiation and device
  static unsigned long long opted_in = 0;  // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !((opted_in >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted_in |= 1ull << dev;
  }
  // each split's K range is a whole number of k-tiles
  const int per = (K + splits - 1) / splits;
  const int k_chunk = (per + Tl::BK - 1) / Tl::BK * Tl::BK;
  const dim3 grid((N + Tl::BN - 1) / Tl::BN, (M + Tl::BM - 1) / Tl::BM, splits);
  gemm_tf32::gemm_kernel<Tl, TRANS_A, TRANS_B, TA, TB, EPI>
      <<<grid, Tl::THREADS, smem, s>>>(
      (const TA*)a, (const TB*)b, (const float*)bias, (const float*)aux,
      (float*)out, (float*)out2, M, N, K, k_chunk, M % 4 == 0);
  return (int)cudaGetLastError();
}

// launch_gemm_tf32 with the tile shape of the GemmTile ``tile``
template <bool TRANS_A, bool TRANS_B, typename TA, typename TB, int EPI>
int launch_gemm_tf32_tile(int tile, const void* a, const void* b,
                          const void* bias, const void* aux, void* out,
                          void* out2, int M, int N, int K, int splits,
                          cudaStream_t s) {
  switch (tile) {
    case kTile128:
      return launch_gemm_tf32<Tiles128, TRANS_A, TRANS_B, TA, TB, EPI>(
          a, b, bias, aux, out, out2, M, N, K, splits, s);
    case kTile64:
      return launch_gemm_tf32<Tiles64, TRANS_A, TRANS_B, TA, TB, EPI>(
          a, b, bias, aux, out, out2, M, N, K, splits, s);
    case kTile128x64:
      return launch_gemm_tf32<Tiles128x64, TRANS_A, TRANS_B, TA, TB, EPI>(
          a, b, bias, aux, out, out2, M, N, K, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cgt

// Multi-head attention cores on the tensor cores, one kernel for four
// callers:
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
// 64 and sequences of at most 256 tokens (ViT-B/16 197, ViT-B/32 50, text 77;
// the JAX tests' heads of 32). Longer sequences (ViT-L/14@336px's 577) take
// the key-tiled core at the end of this file, in K1's packed layout and fp32.
//
// Per head, as the Pallas kernels: q is scaled by 1/sqrt(Dh) in the working
// type T (the factor itself rounded to T, as JAX casts a Python scalar to the
// array's type; exactly 0.125 at Dh = 64), scores q.k accumulate in fp32,
// the optional additive fp32 mask [N, N] is added, softmax runs in fp32
// (max-subtracted exp, divided by the row sum), the probabilities round to T,
// p.v accumulates in fp32 and rounds to T. The softmax is exact, not online:
// a warp holds a 16-row strip of scores over all keys in registers (at most
// 128 fp32 values a thread at N = 256), so the probabilities round where the
// Pallas kernels round them.
//
// The same kernel with QUANT is the attention core of K5
// (_q8_ln_block_kernel, clip_gp_tpu/ops/int8_block.py): there each head's
// fp32 output is not rounded to T but quantized per (row, head), as that
// kernel's quantize_rows(out_h) does: scale = max(absmax / 127, 1e-12) over
// the row's 64 outputs, int8 codes clip(rint(o / scale), ±127) at [B, N, D]
// plus the scale at [B, N, H], for the int8 out-projection of int8_block.cu.
//
// What bounds it on an H100: for bf16, bytes (4*B*H*N^2*Dh FLOPs for
// 4*B*H*N*Dh values moved, about 100 FLOPs a byte at N = 197, under the
// tensor cores' ridge of about 295), so mma.sync can reach the bound and
// neither wgmma nor TMA is needed; for fp32, operations at the 3xTF32 rate
// (a third of the 495 TFLOP/s TF32 peak, above the 67 TFLOP/s of the CUDA
// cores), the least time at fp32 accuracy on this card.
//
// The design: one block of four warps per (batch element, head). The head's
// K and V are read from device memory once, by 16-byte cp.async (K first, so
// the first strip's scores overlap V's copy), and stay in shared memory in
// T: bf16 rows of Dh + 8 elements, so the 8 rows an ldmatrix phase reads
// fall in 8 distinct 16-byte bank groups; fp32 K rows of Dh + 8 and V rows
// of Dh + 4 floats, for the conflict-free float2 and scalar reads below.
// The warps walk the ceil(N/16) query strips of 16 rows, so at most 15
// padded query rows per head (11 at N = 197). Per strip:
// - bf16: S = Q.K^T by mma.sync.m16n8k16 (bf16 in, fp32 accumulators over
//   the bucket's n-tiles of 8 keys), Q's fragments loaded from device memory
//   and scaled in registers, K's by ldmatrix; the mask read at each fragment
//   element's (row, key), keys past N at -inf; row max and sum by shuffles
//   within each quad; P rounded to bf16 and repacked from the accumulator
//   layout into A fragments in registers (the m16n8k16 C layout is the next
//   product's A layout); O = P.V by m16n8k16 with V's fragments by
//   ldmatrix.trans.
// - fp32: the same structure on mma.sync.m16n8k8 TF32 as 3xTF32: every
//   operand splits into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and
//   each product is lo.hi + hi.lo + hi.hi with fp32 accumulation (one pass
//   of TF32 errs by ~1e-3, past the fp32 tolerance). Both products permute
//   their k index the same way on A and B (k = t reads element 2t, k = t + 4
//   element 2t + 1), so Q and K fragments are float2 reads and P's A
//   fragment is the score accumulator as it stands, with no shuffle.
// - the epilogue rounds O (fp32: float2 stores straight from the
//   fragments) or quantizes it with the absmax over the quad's lanes; bf16
//   and int8 outputs are staged through a per-warp shared-memory tile so
//   their stores are 16-byte and coalesced.
// What limits this structure is the size of its code, not the tensor cores:
// the score strip lives in registers, so every loop over it is unrolled and
// a kernel runs to 50-70 KB of SASS, streamed through the instruction caches
// once per strip. So the kernel spends as few instructions per score as it
// can: the loops over key tiles have compile-time bounds (a template bucket
// NT of 8-key tiles, 4, 10, 16, 25 or 26, 32, with K and V zero-padded to
// it) and no per-tile branch, and the division by the row sum is the
// Markstein sequence q = x.r, q += (x - q.s).r with r the correctly rounded
// reciprocal, IEEE division's result at a third of its instructions.
// Occupancy (per SM: 228 KB of shared memory, 64K registers): at ViT-B/16's
// N = 197 a bf16 block (NT 26) holds 60 KB of K and V plus 9 KB of staging
// and about 170 registers a thread, so three fit an SM; an fp32 block (NT
// 25) holds 109 KB, so two fit. Registers are printed by the build (-Xptxas
// -v). No atomics: every output element is summed by one thread in a fixed
// order, so the output repeats bit for bit.
#include <climits>

#include "common.cuh"
#include "mma.cuh"

using namespace cgt;

namespace {

constexpr int WARPS = 4;      // 128 threads
constexpr int STRIP = 16;     // query rows of a warp's strip (the mma's m)
constexpr int MAX_N = 256;

// element offsets of one operand: batch element, head, token row (a row
// offset within one head stays far below 2^31)
struct Strides {
  long long batch, head;
  int row;
};

// shared-memory layout of one block, in elements of T unless named bytes:
// K and V of NT tiles of 8 keys (the bucket: rows past N are zero), then the
// warps' output staging
template <typename T, int DH, int NT, bool QUANT>
struct Layout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static_assert(!kBf16 || NT % 2 == 0, "bf16 keys come in chunks of 16");
  static constexpr int ROWS = NT * 8;
  static constexpr int K_LD = DH + 8;
  static constexpr int V_LD = kBf16 ? DH + 8 : DH + 4;
  // per-warp output staging of bf16 or int8 rows: 16 rows of STAGE_LD bytes
  static constexpr bool kStage = kBf16 || QUANT;
  static constexpr int STAGE_LD = QUANT ? DH + 16 : (DH + 8) * 2;
  static constexpr size_t bytes = sizeof(T) * (size_t)ROWS * (K_LD + V_LD) +
                                  (kStage ? WARPS * STRIP * STAGE_LD : 0);
};

// ---------------------------------------------------------------------------
// shuffles within a quad of lanes (one row of an mma fragment)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// the block's pieces
// ---------------------------------------------------------------------------

// rows [0, n) of a head's operand into shared-memory rows of ld elements by
// 16-byte cp.async; rows [n, rows) zeroed
template <typename T, int DH>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int row_stride, int n, int rows) {
  constexpr int VEC = 16 / sizeof(T), CH = DH / VEC;
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int j = idx / CH, c = idx % CH * VEC;
    T* d = dst + j * ld + c;
    if (j < n)
      cp_async16(d, src + (long long)j * row_stride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// S = (q scaled, rounded to T).K^T for the strip at row r0, the mask added,
// keys >= N at -inf, then the softmax: s holds each row's probabilities in
// fp32 (not yet rounded to T). Fragment element e of n-tile nt is row
// r0 + g + 8 * (e >> 1), key 8 * nt + 2t + (e & 1), g = lane / 4, t = lane % 4.
template <typename T, int DH, int NT, bool QUANT>
__device__ __forceinline__ void scores_softmax(float (&s)[NT][4], const T* Ks,
                                               const T* qb, int q_row,
                                               const float* mask, int N, int r0,
                                               float scale, int lane) {
  using L = Layout<T, DH, NT, QUANT>;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = r0 + g, row1 = r0 + g + 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;

  if constexpr (L::kBf16) {
    // ldmatrix.x4 of a 16-key chunk: lane l gives the address of row
    // (l & 7) + 8 * (l >> 4), column 8 * ((l >> 3) & 1): registers 0, 1 are
    // n-tile 2c's b0, b1 and 2, 3 n-tile 2c + 1's
    const int m = lane >> 3, i = lane & 7;
    const T* kfrag = Ks + (i + (m >> 1) * 8) * L::K_LD + (m & 1) * 8;
    auto q2 = [&](int row, int d) -> uint32_t {  // q[row, d:d+2] scaled, packed
      if (row >= N) return 0u;
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(qb + (long long)row * q_row + d);
      return pack_bf16(__bfloat162float(v.x) * scale, __bfloat162float(v.y) * scale);
    };
#pragma unroll 1
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int d = kk * 16 + 2 * t;
      const uint32_t a[4] = {q2(row0, d), q2(row1, d), q2(row0, d + 8),
                             q2(row1, d + 8)};
#pragma unroll
      for (int c = 0; c < NT / 2; ++c) {
        uint32_t r[4];
        ldmatrix_x4(r, kfrag + c * 16 * L::K_LD + kk * 16);
        mma_bf16(s[2 * c], a, r[0], r[1]);
        mma_bf16(s[2 * c + 1], a, r[2], r[3]);
      }
    }
  } else {
    // k = t reads column d + 2t, k = t + 4 column d + 2t + 1, on A and B
    auto q2 = [&](int row, int d) -> float2 {
      if (row >= N) return make_float2(0.f, 0.f);
      const float2 v =
          *reinterpret_cast<const float2*>(qb + (long long)row * q_row + d);
      return make_float2(v.x * scale, v.y * scale);
    };
#pragma unroll 1
    for (int kk = 0; kk < DH / 8; ++kk) {
      const int d = kk * 8 + 2 * t;
      const float2 qa = q2(row0, d), qc = q2(row1, d);
      uint32_t ah[4], al[4];
      split_tf32(qa.x, ah[0], al[0]);
      split_tf32(qc.x, ah[1], al[1]);
      split_tf32(qa.y, ah[2], al[2]);
      split_tf32(qc.y, ah[3], al[3]);
      const float* kr = reinterpret_cast<const float*>(Ks) + g * L::K_LD + d;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 kv = *reinterpret_cast<const float2*>(kr + nt * 8 * L::K_LD);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kv.x, bh0, bl0);
        split_tf32(kv.y, bh1, bl1);
        mma_3xtf32(s[nt], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }

  if (mask != nullptr) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1, key = nt * 8 + 2 * t + (e & 1);
        if (row < N && key < N) s[nt][e] += mask[(size_t)row * N + key];
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (nt * 8 + 2 * t + (e & 1) >= N) s[nt][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
      sum[e >> 1] += s[nt][e];
    }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  // s / sum, correctly rounded: q = s.r, then one FMA residual correction
  // with r the correctly rounded reciprocal (Markstein)
  const float rc[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float q = s[nt][e] * rc[e >> 1];
      s[nt][e] = fmaf(fmaf(-q, sum[e >> 1], s[nt][e]), rc[e >> 1], q);
    }
}

// O = P.V for the strip whose probabilities s holds; o[dt] is the n-tile of
// columns [8 dt, 8 dt + 8), in the accumulator layout of scores_softmax
template <typename T, int DH, int NT, bool QUANT>
__device__ __forceinline__ void pv(float (&o)[DH / 8][4], const float (&s)[NT][4],
                                   const T* Vs, int lane) {
  using L = Layout<T, DH, NT, QUANT>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  if constexpr (L::kBf16) {
    // ldmatrix.x4.trans of a 16-key chunk: lane l gives the address of key
    // row (l & 7) + 8 * ((l >> 3) & 1), column 8 * (l >> 4): registers 0, 1
    // are d-tile 2p's b0, b1 and 2, 3 d-tile 2p + 1's
    const int m = lane >> 3, i = lane & 7;
    const T* vfrag = Vs + (i + (m & 1) * 8) * L::V_LD + (m >> 1) * 8;
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) {
      // P rounded to bf16: the accumulators of n-tiles 2c, 2c + 1 are the
      // A fragment of keys [16c, 16c + 16)
      const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                             pack_bf16(s[2 * c][2], s[2 * c][3]),
                             pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int p = 0; p < DH / 16; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vfrag + c * 16 * L::V_LD + p * 16);
        mma_bf16(o[2 * p], a, r[0], r[1]);
        mma_bf16(o[2 * p + 1], a, r[2], r[3]);
      }
    }
  } else {
    // k = t is key 8nt + 2t, k = t + 4 key 8nt + 2t + 1, so n-tile nt's
    // accumulators (c0, c2, c1, c3) are the A fragment as they stand
    const float* vr = reinterpret_cast<const float*>(Vs) + 2 * t * L::V_LD + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t ah[4], al[4];
      split_tf32(s[nt][0], ah[0], al[0]);
      split_tf32(s[nt][2], ah[1], al[1]);
      split_tf32(s[nt][1], ah[2], al[2]);
      split_tf32(s[nt][3], ah[3], al[3]);
      const float* v0 = vr + nt * 8 * L::V_LD;
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v0[dt * 8], bh0, bl0);
        split_tf32(v0[L::V_LD + dt * 8], bh1, bl1);
        mma_3xtf32(o[dt], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// the warp's staged rows [r0, r0 + 16) of ROW_BYTES each to device memory,
// 16 bytes a store; rows >= N are dropped
template <int ROW_BYTES>
__device__ __forceinline__ void store_staged(const unsigned char* st, int ld,
                                             unsigned char* dst,
                                             long long row_stride_bytes,
                                             int r0, int N, int lane) {
  constexpr int CH = ROW_BYTES / 16;
  __syncwarp();
  for (int idx = lane; idx < STRIP * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH * 16;
    if (r0 + r < N)
      *reinterpret_cast<uint4*>(dst + (r0 + r) * row_stride_bytes + c) =
          *reinterpret_cast<const uint4*>(st + r * ld + c);
  }
  __syncwarp();  // the tile is rewritten by the warp's next strip
}

template <typename T, int DH, int NT, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, int8_t* __restrict__ q_out,
                     float* __restrict__ q_scale, int N, int H, Strides in,
                     Strides os) {
  using L = Layout<T, DH, NT, QUANT>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + L::ROWS * L::K_LD;
  unsigned char* stage = reinterpret_cast<unsigned char*>(Vs + L::ROWS * L::V_LD);
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const long long in_off = b * in.batch + h * in.head;
  const T* qb = q + in_off;
  load_rows<T, DH>(Ks, L::K_LD, k + in_off, in.row, N, L::ROWS);
  cp_async_commit();
  load_rows<T, DH>(Vs, L::V_LD, v + in_off, in.row, N, L::ROWS);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nstrips = (N + STRIP - 1) / STRIP;
  // 1/sqrt(Dh) in the working type
  const float scale = round_to<T>((float)(1.0 / sqrt((double)DH)));
  float s[NT][4];

  cp_async_wait<1>();  // K has landed
  __syncthreads();
  // the same number of rounds in every warp, so all reach the barrier
  const int rounds = (nstrips + WARPS - 1) / WARPS;
  for (int round = 0; round < rounds; ++round) {
    const int strip = warp + round * WARPS, r0 = strip * STRIP;
    if (strip < nstrips)
      scores_softmax<T, DH, NT, QUANT>(s, Ks, qb, in.row, mask, N, r0, scale,
                                       lane);
    if (round == 0) {
      cp_async_wait<0>();  // V has landed
      __syncthreads();
    }
    if (strip >= nstrips) break;
    float o[DH / 8][4];
    pv<T, DH, NT, QUANT>(o, s, Vs, lane);
    const int rows[2] = {r0 + g, r0 + g + 8};
    unsigned char* st = stage + warp * STRIP * L::STAGE_LD;
    if constexpr (QUANT) {
      // per (row, head): absmax over the quad's 4 lanes x 16 values
      float amax[2] = {0.f, 0.f};
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) amax[e >> 1] = fmaxf(amax[e >> 1], fabsf(o[dt][e]));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sc = fmaxf(__fdiv_rn(quad_max(amax[r]), 127.f), kQuantEps);
        if (t == 0 && rows[r] < N)
          q_scale[((size_t)b * N + rows[r]) * H + h] = sc;
#pragma unroll
        for (int dt = 0; dt < DH / 8; ++dt) {
          char2 c2;
          c2.x = quantize_code(o[dt][2 * r], sc);
          c2.y = quantize_code(o[dt][2 * r + 1], sc);
          *reinterpret_cast<char2*>(st + (g + 8 * r) * L::STAGE_LD + dt * 8 + 2 * t) = c2;
        }
      }
      store_staged<DH>(st, L::STAGE_LD,
                       reinterpret_cast<unsigned char*>(q_out + b * os.batch + h * os.head),
                       os.row, r0, N, lane);
    } else if constexpr (L::kBf16) {
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(st + (g + 8 * r) * L::STAGE_LD +
                                       (dt * 8 + 2 * t) * 2) =
              pack_bf16(o[dt][2 * r], o[dt][2 * r + 1]);
      store_staged<DH * 2>(st, L::STAGE_LD,
                           reinterpret_cast<unsigned char*>(out + b * os.batch + h * os.head),
                           (long long)os.row * 2, r0, N, lane);
    } else {
      T* ob = out + b * os.batch + h * os.head;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < N) {
#pragma unroll
          for (int dt = 0; dt < DH / 8; ++dt)
            *reinterpret_cast<float2*>(ob + (long long)rows[r] * os.row + dt * 8 + 2 * t) =
                make_float2(o[dt][2 * r], o[dt][2 * r + 1]);
        }
      }
    }
  }
}

// the shared-memory opt-in is a property of the function on a device: set it
// once per function and device, not on every launch (bit d of ``opted_in``:
// device d; atomic, as several host threads may launch)
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes,
                   std::atomic<unsigned long long>& opted_in) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((opted_in.load() >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in.fetch_or(1ull << dev);
  }
  return cudaSuccess;
}

template <typename T, int DH, int NT, bool QUANT>
int launch_nt(const void* q, const void* k, const void* v, const void* mask,
              void* out, void* q_scale, int B, int N, int H, Strides in,
              Strides os, cudaStream_t s) {
  constexpr size_t bytes = Layout<T, DH, NT, QUANT>::bytes;
  static std::atomic<unsigned long long> opted_in{0};
  const cudaError_t err = opt_in(attention_kernel<T, DH, NT, QUANT>, bytes, opted_in);
  if (err != cudaSuccess) return (int)err;
  attention_kernel<T, DH, NT, QUANT><<<B * H, WARPS * 32, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask,
      QUANT ? nullptr : (T*)out, QUANT ? (int8_t*)out : nullptr,
      (float*)q_scale, N, H, in, os);
  return (int)cudaGetLastError();
}

// the smallest bucket of 8-key tiles that holds N keys (the text tower's 77
// and ViT-B/16's 197 tokens each fill theirs); bf16 takes an even count, its
// keys coming in chunks of 16
template <typename T, int DH, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* q_scale, int B, int N, int H, Strides in,
           Strides os, cudaStream_t s) {
  constexpr int NT_197 = sizeof(T) == 2 ? 26 : 25;
  const int tiles = (N + 7) / 8;
  if (tiles <= 4)
    return launch_nt<T, DH, 4, QUANT>(q, k, v, mask, out, q_scale, B, N, H, in, os, s);
  if (tiles <= 10)
    return launch_nt<T, DH, 10, QUANT>(q, k, v, mask, out, q_scale, B, N, H, in, os, s);
  if (tiles <= 16)
    return launch_nt<T, DH, 16, QUANT>(q, k, v, mask, out, q_scale, B, N, H, in, os, s);
  if (tiles <= NT_197)
    return launch_nt<T, DH, NT_197, QUANT>(q, k, v, mask, out, q_scale, B, N, H, in, os, s);
  return launch_nt<T, DH, 32, QUANT>(q, k, v, mask, out, q_scale, B, N, H, in, os, s);
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

// ---------------------------------------------------------------------------
// The key-tiled core: K1's packed path above 256 tokens, in fp32
// ---------------------------------------------------------------------------
//
// Past 256 tokens a strip's scores no longer fit in registers (289 fp32
// values a thread at ViT-L/14@336px's N = 577), so this core streams each
// head's K and V through shared memory in tiles of TK keys and keeps an
// online softmax per query row (FlashAttention-2's loop): a running max m, a
// running sum l and fp32 accumulators O, rescaled by exp(m_old - m_new) as
// each tile arrives (0 while every key so far is masked), divided by l once
// at the end with the strip kernel's Markstein division. In fp32, rounding P
// to the working type is the identity, so this differs from the exact
// softmax only in rounding: the order of the sums and the factor that each
// tile's exponentials carry. It takes no bf16 (P would round before it is
// normalised, where the Pallas kernel rounds the normalised P) and no int8
// output (K5): the Python wrappers refuse both past 256 tokens.
//
// What bounds it on an H100: at N = 577 a head's 4·N²·Dh operations and
// 16·N·Dh bytes meet at the TF32 ridge (bytes bound it by 2%), and the
// 3xTF32 products run at a third of the TF32 rate, so operations bound it.
//
// The tiles: a block of four warps holds TQ = 64 query rows, a 16-row strip
// a warp (the mma's m), so each K and V tile in shared memory feeds four
// strips. TK = 64 keys, eight n-tiles of 8: a thread holds 32 scores, 32
// output accumulators and Q's TF32 hi and lo fragments (64 registers, split
// once, as every tile reuses them); ptxas gives the kernel 202 registers, so
// two blocks fit an SM. Two stages of K and V (36 KB each, in the strip
// kernel's padded rows) take 72 KB a block, which would let three fit; 128
// keys a tile would take 143 KB and leave one block an SM. The stages are
// filled by 16-byte cp.async, the next tile's copy overlapping this tile's
// products.
// The products are the strip kernel's 3xTF32 mma.sync.m16n8k8 with its k
// permutation, so S's accumulator is P's A fragment as it stands. The last
// tile runs only the n-tiles that hold keys (at N = 577 one of eight).
// One block per (query tile, head, batch element), query tiles fastest, so
// the blocks of one head run together and read its K and V through L2. No
// atomics: the output repeats bit for bit.

constexpr int TQ = WARPS * STRIP;  // query rows of a block
constexpr int TK = 64;             // keys of a tile
constexpr int TK_NT = TK / 8;      // its n-tiles of 8 keys
constexpr int TILED_DH = 64;

struct TiledLayout {
  static constexpr int K_LD = TILED_DH + 8;
  static constexpr int V_LD = TILED_DH + 4;
  static constexpr int STAGE = TK * (K_LD + V_LD);  // floats
  static constexpr size_t bytes = sizeof(float) * 2 * STAGE;
};

// one tile of keys [k0, k0 + TK) for the warp's strip (rows row0 and row0 +
// 8 of each fragment): S = Q.K^T, the mask added, keys >= N at -inf, the
// online update of m, l and O, then O += P.V. FULL: every key of the tile is
// < N; else only the first ``nta`` n-tiles are run. l is this thread's part
// of the row sum (its quad's lanes are summed at the end).
template <bool FULL>
__device__ __forceinline__ void tiled_step(float (&o)[TILED_DH / 8][4],
                                           float (&m)[2], float (&l)[2],
                                           const uint32_t (&qh)[TILED_DH / 8][4],
                                           const uint32_t (&ql)[TILED_DH / 8][4],
                                           const float* Ks, const float* Vs,
                                           const float* mask, int N, int row0,
                                           int k0, int nta, int lane) {
  using L = TiledLayout;
  const int g = lane >> 2, t = lane & 3;
  float s[TK_NT][4];
#pragma unroll
  for (int nt = 0; nt < TK_NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < TILED_DH / 8; ++kk) {
    const float* kr = Ks + g * L::K_LD + kk * 8 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < TK_NT; ++nt) {
      if (FULL || nt < nta) {
        const float2 kv = *reinterpret_cast<const float2*>(kr + nt * 8 * L::K_LD);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kv.x, bh0, bl0);
        split_tf32(kv.y, bh1, bl1);
        mma_3xtf32(s[nt], qh[kk], ql[kk], bh0, bh1, bl0, bl1);
      }
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < TK_NT; ++nt) {
    if (FULL || nt < nta) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1), key = k0 + nt * 8 + 2 * t + (e & 1);
        if (mask != nullptr && row < N && key < N) s[nt][e] += mask[(size_t)row * N + key];
        if (!FULL && key >= N) s[nt][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
  }
  float base[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    base[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = expf(m[r] - base[r]);
    m[r] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < TK_NT; ++nt) {
    if (FULL || nt < nta) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - base[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int dt = 0; dt < TILED_DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];

  // O += P.V as the strip kernel's pv: n-tile nt's accumulators (c0, c2,
  // c1, c3) are the A fragment of keys [8 nt, 8 nt + 8)
  const float* vr = Vs + 2 * t * L::V_LD + g;
#pragma unroll
  for (int nt = 0; nt < TK_NT; ++nt) {
    if (FULL || nt < nta) {
      uint32_t ah[4], al[4];
      split_tf32(s[nt][0], ah[0], al[0]);
      split_tf32(s[nt][2], ah[1], al[1]);
      split_tf32(s[nt][1], ah[2], al[2]);
      split_tf32(s[nt][3], ah[3], al[3]);
      const float* v0 = vr + nt * 8 * L::V_LD;
#pragma unroll
      for (int dt = 0; dt < TILED_DH / 8; ++dt) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v0[dt * 8], bh0, bl0);
        split_tf32(v0[L::V_LD + dt * 8], bh1, bl1);
        mma_3xtf32(o[dt], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32, 2)
    attention_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ mask,
                           float* __restrict__ out, int N, int H, int nq,
                           Strides in, Strides os) {
  using L = TiledLayout;
  constexpr int DH = TILED_DH;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  const int qt = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int h = bh % H, b = bh / H;
  const long long in_off = b * in.batch + h * in.head;
  const float* kb = k + in_off;
  const float* vb = v + in_off;
  const int ntiles = (N + TK - 1) / TK;

  // K and V of tile j into stage j % 2, rows past N zeroed
  auto load_tile = [&](int j) {
    float* Ks = stages + (j & 1) * L::STAGE;
    const int k0 = j * TK, n = min(TK, N - k0);
    load_rows<float, DH>(Ks, L::K_LD, kb + (long long)k0 * in.row, in.row, n, TK);
    load_rows<float, DH>(Ks + TK * L::K_LD, L::V_LD, vb + (long long)k0 * in.row,
                         in.row, n, TK);
    cp_async_commit();
  };
  load_tile(0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qt * TQ + warp * STRIP, row0 = r0 + g;
  // a warp past the last row still loads tiles and meets the barriers
  const bool active = r0 < N;
  // Q's fragments scaled by 1/sqrt(Dh) (0.125, exact) and split once, while
  // the first tile is in flight; k = t reads column 8 kk + 2t, k = t + 4
  // column 8 kk + 2t + 1
  const float scale = (float)(1.0 / sqrt((double)DH));
  const float* qb = q + in_off;
  uint32_t qh[DH / 8][4], ql[DH / 8][4];
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    float2 qa = make_float2(0.f, 0.f), qc = qa;
    const int d = kk * 8 + 2 * t;
    if (row0 < N) qa = *reinterpret_cast<const float2*>(qb + (long long)row0 * in.row + d);
    if (row0 + 8 < N)
      qc = *reinterpret_cast<const float2*>(qb + (long long)(row0 + 8) * in.row + d);
    split_tf32(qa.x * scale, qh[kk][0], ql[kk][0]);
    split_tf32(qc.x * scale, qh[kk][1], ql[kk][1]);
    split_tf32(qa.y * scale, qh[kk][2], ql[kk][2]);
    split_tf32(qc.y * scale, qh[kk][3], ql[kk][3]);
  }
  float o[DH / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      load_tile(j + 1);
      cp_async_wait<1>();  // tile j has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = stages + (j & 1) * L::STAGE;
    const float* Vs = Ks + TK * L::K_LD;
    const int k0 = j * TK;
    if (active) {
      if (k0 + TK <= N)
        tiled_step<true>(o, m, l, qh, ql, Ks, Vs, mask, N, row0, k0, TK_NT, lane);
      else
        tiled_step<false>(o, m, l, qh, ql, Ks, Vs, mask, N, row0, k0,
                          (N - k0 + 7) / 8, lane);
    }
    __syncthreads();  // stage j % 2 is refilled in the next round
  }
  if (!active) return;

  float* ob = out + b * os.batch + h * os.head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const float rc = __frcp_rn(sum);
    const int row = row0 + 8 * r;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      float2 val;
      float qv = o[dt][2 * r] * rc;
      val.x = fmaf(fmaf(-qv, sum, o[dt][2 * r]), rc, qv);
      qv = o[dt][2 * r + 1] * rc;
      val.y = fmaf(fmaf(-qv, sum, o[dt][2 * r + 1]), rc, qv);
      if (row < N)
        *reinterpret_cast<float2*>(ob + (long long)row * os.row + dt * 8 + 2 * t) = val;
    }
  }
}

// qkv [B, N, 3D] fp32 -> attn [B, N, D], head width 64, any N
int launch_tiled(const void* qkv, const void* mask, void* out, int B, int N,
                 int H, int D, cudaStream_t s) {
  constexpr int DH = TILED_DH;
  const Strides in{(long long)N * 3 * D, DH, 3 * D};
  const Strides os{(long long)N * D, DH, D};
  const int nq = (N + TQ - 1) / TQ;
  const long long blocks = (long long)B * H * nq;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> opted_in{0};
  const cudaError_t err = opt_in(attention_tiled_kernel, TiledLayout::bytes, opted_in);
  if (err != cudaSuccess) return (int)err;
  const float* base = (const float*)qkv;
  attention_tiled_kernel<<<(unsigned)blocks, WARPS * 32, TiledLayout::bytes, s>>>(
      base, base + D, base + 2 * D, (const float*)mask, (float*)out, N, H, nq, in, os);
  return (int)cudaGetLastError();
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

// K1's attention core past 256 tokens: fp32 qkv [B, N, 3D] -> attn [B, N, D]
// by the key-tiled core (the wrapper routes by N)
extern "C" int cgt_attention_tiled(const void* qkv, const void* mask, void* out,
                                   int B, int N, int H, int D, int dtype,
                                   void* stream) {
  if (N < 1 || B < 1 || H < 1 || D != H * 64 || dtype != kF32)
    return (int)cudaErrorInvalidValue;
  return launch_tiled(qkv, mask, out, B, N, H, D, (cudaStream_t)stream);
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

// Attention-core backward of K3 on the tensor cores: the per-head loop of
// _ln_attn_bwd_kernel (clip_gp_tpu/ops/flash_attention.py) for head width 64
// and sequences of at most 256 tokens, all in fp32.
//
// In:  qkv [B, N, 3D] fp32, recomputed (LN(x)·Wqkv + bqkv, gemm_bwd.cu);
//      d_attn [B, N, D] fp32 = dout·Woutᵀ, the gradient at every head's
//      output (the Pallas kernel forms it per head); optional additive
//      fp32 mask [N, N].
// Out: dqkv [B, N, 3D] fp32 (dq | dk | dv); optionally attn [B, N, D], the
//      recomputed head outputs, for dWout = attnᵀ·dout.
// Per head, as the Pallas kernel: q_s = q/8, P = softmax(q_s·kᵀ + mask)
// (max-subtracted exp over exactly the N keys, divided by the row sum),
// out = P·v, dP = d_out·vᵀ, dS = P∘(dP − δ) with δ_i = Σ_j dP_ij P_ij,
// dq = dS·k/8, dk = dSᵀ·q_s, dv = Pᵀ·d_out. δ_i is taken as
// d_out_i·out_i, the same sum regrouped.
//
// What bounds it on an H100: bytes. It reads q, k, v and d_out and writes
// dq, dk, dv (and the head outputs, with parameter gradients): 7D to 8D
// fp32 values a token, 88-101 MB at the text tower's B = 256, N = 24, or
// 26-30 µs at 3.35 TB/s. Its 12·B·N²·D FLOPs take 5.5 µs there at the
// 3xTF32 rate, and stay under the bytes up to N of about 100.
//
// The arithmetic: all six products (S, O, dP, dq, dk, dv) run on
// mma.sync.m16n8k8 as 3xTF32, the scheme of attention.cu and gemm_tf32.cuh:
// each operand splits into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna),
// and each 8-deep k-step sums lo·hi + hi·lo + hi·hi on the tensor cores
// from zero, then adds that to the fp32 accumulators by an ordinary fp32
// add (chaining the k-steps through the tensor cores loses up to an ulp a
// step; one TF32 pass misses the fp32 tolerance). The k of S, dP, Sᵀ and
// dPᵀ is the head width (8 steps); of O and dq the keys, of dk and dv the
// queries, one step per 8-row tile. Products whose A and B both come from
// shared rows take k in its natural order; products whose A is an
// accumulator tile (P, dS, Pᵀ, dSᵀ) permute k on A and B alike (slot t is
// element 2t, slot t + 4 element 2t + 1), so the accumulators are the A
// fragment as they stand.
//
// The design: a block holds one head's q, k, v and d_out (16-byte
// cp.async, rows past N zero-filled), rows of 68 floats so that both
// fragment patterns, a row's k = t (lanes 4g + t) and a column's 8-row
// reads (lanes 8t + g), hit distinct banks. Then
// - the q side: a warp per 16-query strip forms S and the softmax in
//   registers (keys past N at -inf), O = P·V with P's accumulators as the
//   A fragment, δ = rowsum(d_out∘O), then dq = dS·K/8 one 8-key tile at a
//   time (dS tile = P∘(dP − δ), dq += dS_tile·K_tile). In the one-launch
//   buckets dP's strip is formed beside S's in one pass over the head
//   width, so d_out's fragments are read once; in the split launch the
//   registers hold no second strip and each dP tile is formed where it is
//   used. It writes dq, O and the row statistics (max, sum, 1/sum, δ).
// - the kv side: a warp per 16-key strip streams the 8-query tiles: Sᵀ
//   tile → Pᵀ from the row statistics → dPᵀ tile → dSᵀ tile, then
//   dk += dSᵀ·q_s and dv += Pᵀ·d_out. Its registers do not grow with N.
//   Query rows past N give Pᵀ = dSᵀ = 0 by a select, never exp(s − m) of
//   statistics no strip wrote.
// Up to N = 80 (the text tower's 77 tokens, trimmed or not) one block per
// (head, batch element) runs both sides, a warp per strip (2 to 5), the
// statistics in shared memory between them: the inputs are read once and
// no [N, N] matrix or statistic reaches device memory. At the text tower's
// N = 24 a block of 2 warps holds 35 KB, six an SM. The key tiles are a
// compile-time bucket (3, 4 or 10 tiles of 8), since the q side's strip of
// scores lives in registers. Past 80 tokens, up to the 256 of the
// contract (no path of the port sends them; at 256 the four operands would
// need 278 KB of shared memory), the sides split into two launches of four
// warps per 64-row tile, with 32 key tiles: the q side holds the head's k and v and its
// tile's q and d_out, and writes the statistics to row_stats; the kv side
// holds q and d_out and its tile's k and v. Every output element is summed
// by one thread in a fixed order, with no atomics, so the bits repeat run
// to run. The kv side recomputes the scores from the same operands, but
// the tensor cores' sum of a k-step is not specified, so its P may differ
// from the q side's in the last bit; no result depends on the two
// agreeing. Registers and spills of each instantiation are printed by the
// build (-Xptxas -v) and by chip_smoke.py.
#include "common.cuh"
#include "mma.cuh"

using namespace cgt;

namespace {

constexpr int DH = 64;           // head width
constexpr int LD = DH + 4;       // floats a shared row
constexpr int STRIP = 16;        // rows of a warp's strip (the mma's m)
constexpr int TILE = 64;         // rows of one side a split block takes
constexpr int MAX_N = 256;
constexpr int FUSED_MAX_N = 80;  // one launch up to 10 key tiles
constexpr float SCALE = 0.125f;  // 1/sqrt(64), exact

// kBoth: one block runs both sides of a head; kQ / kKV: one side of a
// 64-row tile
enum Mode { kBoth = 0, kQ = 1, kKV = 2 };

template <int NT, int MODE>
struct Layout {
  static constexpr int ROWS = (NT * 8 + STRIP - 1) / STRIP * STRIP;
  static constexpr int Q_ROWS = MODE == kQ ? TILE : ROWS;   // q and d_out
  static constexpr int K_ROWS = MODE == kKV ? TILE : ROWS;  // k and v
  // a warp per 16-row strip of a side
  static constexpr int WARPS = (MODE == kBoth ? ROWS : TILE) / STRIP;
  // max | sum | 1/sum | δ of every query row
  static constexpr int STATS = MODE == kQ ? 0 : 4 * ROWS;
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)2 * LD * (Q_ROWS + K_ROWS) + STATS);
  // the blocks an SM holds by shared memory (232,448 bytes, 1 KB reserved
  // a block): the register cap of __launch_bounds__
  static constexpr int MIN_BLOCKS = (int)(232448 / (bytes + 1024));
};

// rows [r0, r0 + rows) of one head's operand (``stride`` floats a row) into
// shared rows of LD floats by 16-byte cp.async; rows at or past N zeroed
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int r0, int rows,
                                          int N) {
  constexpr int CH = DH / 4;
  for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
    const int j = idx / CH, c = idx % CH * 4;
    float* d = dst + j * LD + c;
    if (r0 + j < N)
      cp_async16(d, src + (long long)(r0 + j) * stride + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ---------------------------------------------------------------------------
// fragments (g = lane / 4, t = lane % 4)
// ---------------------------------------------------------------------------

// A of rows g, g + 8 and k = t, t + 4 from shared rows: p = &X[g][t]
__device__ __forceinline__ void frag_a_rows(uint32_t (&h)[4], uint32_t (&l)[4],
                                            const float* p, float sc) {
  split_tf32(p[0] * sc, h[0], l[0]);
  split_tf32(p[8 * LD] * sc, h[1], l[1]);
  split_tf32(p[4] * sc, h[2], l[2]);
  split_tf32(p[8 * LD + 4] * sc, h[3], l[3]);
}

// B = Xᵀ, column n = g of k = t, t + 4, from shared rows: p = &X[g][t]
__device__ __forceinline__ void frag_b_rows(uint32_t (&h)[2], uint32_t (&l)[2],
                                            const float* p, float sc) {
  split_tf32(p[0] * sc, h[0], l[0]);
  split_tf32(p[4] * sc, h[1], l[1]);
}

// B = X, column n = g, k permuted (slot t row 2t, slot t + 4 row 2t + 1):
// p = &X[2t][g]
__device__ __forceinline__ void frag_b_cols(uint32_t (&h)[2], uint32_t (&l)[2],
                                            const float* p, float sc) {
  split_tf32(p[0] * sc, h[0], l[0]);
  split_tf32(p[LD] * sc, h[1], l[1]);
}

// A from a 16x8 accumulator tile with k permuted: (c0, c2, c1, c3)
__device__ __forceinline__ void frag_a_acc(uint32_t (&h)[4], uint32_t (&l)[4],
                                           const float (&c)[4]) {
  split_tf32(c[0], h[0], l[0]);
  split_tf32(c[2], h[1], l[1]);
  split_tf32(c[1], h[2], l[2]);
  split_tf32(c[3], h[3], l[3]);
}

// d = a.b with a zero addend (the first product of a k-step)
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// one k-step: the three products summed from zero, then added in fp32
__device__ __forceinline__ void kstep(float (&acc)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4],
                                      const uint32_t (&bh)[2],
                                      const uint32_t (&bl)[2]) {
  float d[4];
  mma_tf32_first(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// x / s, correctly rounded: q = x·r, then one FMA residual correction with
// r the correctly rounded reciprocal (Markstein), as attention.cu divides
__device__ __forceinline__ float div_rn(float x, float s, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, s, x), r, q);
}

// the head's pointers: rows of qkv (stride 3D) and of d_attn, dqkv, attn
struct Head {
  const float *q, *k, *v, *dout;
  float *dq, *dk, *dv, *attn;  // attn may be null
  float* stats;                // [N][3] of row_stats (split only)
  long long stride, dstride;   // 3D, D
};

// ---------------------------------------------------------------------------
// the q side: one 16-query strip, rows [r0, r0 + 16); its q and d_out are
// shared rows row0.. of Qs, Os; K and V hold every key from 0
// ---------------------------------------------------------------------------
template <int NT>
__device__ __forceinline__ void q_strip(const Head& hd, const float* Qs,
                                        const float* Os, const float* Ks,
                                        const float* Vs, int row0, int r0,
                                        const float* mask, int N, float* sm,
                                        int rows_sm, int lane) {
  // in the one-launch buckets dP's strip is held beside S's (at most 40
  // more registers), so d_out's fragments are read once; in the split
  // launch dP streams a tile at a time below
  constexpr bool kDpStrip = NT * 8 <= FUSED_MAX_N;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {r0 + g, r0 + g + 8};
  uint32_t ah[4], al[4], bh[2], bl[2];
  const float* qa = Qs + (row0 + g) * LD + t;  // q_s, d_out as A rows
  const float* oa = Os + (row0 + g) * LD + t;
  const float* kb = Ks + g * LD + t;           // K, V as B = Xᵀ
  const float* vb = Vs + g * LD + t;
  const float* kc = Ks + 2 * t * LD + g;       // K, V as B = X
  const float* vc = Vs + 2 * t * LD + g;

  // S = q_s·Kᵀ (and dP = d_out·Vᵀ), element e of n-tile nt: row
  // rows[e >> 1], key 8nt + 2t + (e & 1)
  float s[NT][4], dp[kDpStrip ? NT : 1][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[kDpStrip ? nt : 0][e] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < DH; kk += 8) {
    uint32_t oh[4], ol[4];
    frag_a_rows(ah, al, qa + kk, SCALE);
    if (kDpStrip) frag_a_rows(oh, ol, oa + kk, 1.f);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      frag_b_rows(bh, bl, kb + nt * 8 * LD + kk, 1.f);
      kstep(s[nt], ah, al, bh, bl);
      if (kDpStrip) {
        frag_b_rows(bh, bl, vb + nt * 8 * LD + kk, 1.f);
        kstep(dp[kDpStrip ? nt : 0], oh, ol, bh, bl);
      }
    }
  }

  // the mask, keys past N at -inf, then the softmax in place
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rows[e >> 1], key = nt * 8 + 2 * t + (e & 1);
      if (key >= N)
        s[nt][e] = -INFINITY;
      else if (mask != nullptr && row < N)
        s[nt][e] += mask[(size_t)row * N + key];
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
  const float rc[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[nt][e] = div_rn(s[nt][e], sum[e >> 1], rc[e >> 1]);

  // O = P·V, then δ = rowsum(d_out∘O) and the head outputs
  float delta[2] = {0.f, 0.f};
  {
    float o[DH / 8][4];
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      frag_a_acc(ah, al, s[nt]);
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        frag_b_cols(bh, bl, vc + nt * 8 * LD + dt * 8, 1.f);
        kstep(o[dt], ah, al, bh, bl);
      }
    }
    const float* orow = Os + (row0 + g) * LD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 d2 = *reinterpret_cast<const float2*>(orow + r * 8 * LD + dt * 8);
        delta[r] = fmaf(o[dt][2 * r], d2.x, delta[r]);
        delta[r] = fmaf(o[dt][2 * r + 1], d2.y, delta[r]);
      }
    delta[0] = quad_sum(delta[0]);
    delta[1] = quad_sum(delta[1]);
    if (hd.attn != nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < N) {
#pragma unroll
          for (int dt = 0; dt < DH / 8; ++dt)
            *reinterpret_cast<float2*>(hd.attn + rows[r] * hd.dstride + dt * 8 + 2 * t) =
                make_float2(o[dt][2 * r], o[dt][2 * r + 1]);
        }
    }
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (sm != nullptr) {  // both sides in this block
        sm[rows[r]] = mx[r];
        sm[rows_sm + rows[r]] = sum[r];
        sm[2 * rows_sm + rows[r]] = rc[r];
        sm[3 * rows_sm + rows[r]] = delta[r];
      } else if (rows[r] < N) {
        float* st = hd.stats + (size_t)rows[r] * 3;
        st[0] = mx[r];
        st[1] = sum[r];
        st[2] = delta[r];
      }
    }
  }

  // dq = dS·K/8, one 8-key tile at a time: dS tile = P∘(dP − δ), dq +=
  // dS_tile·K_tile (streaming, the dP tile = d_out·V_tileᵀ first)
  float dq[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float ds[4] = {0.f, 0.f, 0.f, 0.f};
    if (kDpStrip) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e] = dp[kDpStrip ? nt : 0][e];
    } else {
#pragma unroll 1
      for (int kk = 0; kk < DH; kk += 8) {
        frag_a_rows(ah, al, oa + kk, 1.f);
        frag_b_rows(bh, bl, vb + nt * 8 * LD + kk, 1.f);
        kstep(ds, ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[e] = s[nt][e] * (ds[e] - delta[e >> 1]);
    frag_a_acc(ah, al, ds);
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      frag_b_cols(bh, bl, kc + nt * 8 * LD + dt * 8, 1.f);
      kstep(dq[dt], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (rows[r] < N) {
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt)
        *reinterpret_cast<float2*>(hd.dq + rows[r] * hd.stride + dt * 8 + 2 * t) =
            make_float2(dq[dt][2 * r] * SCALE, dq[dt][2 * r + 1] * SCALE);
    }
}

// ---------------------------------------------------------------------------
// the kv side: one 16-key strip, keys [c0, c0 + 16); its k and v are shared
// rows row0.. of Ks, Vs; Qs, Os hold every query from 0, sm the statistics
// of every query (max | sum | 1/sum | δ, rows_sm apart)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void kv_strip(const Head& hd, const float* Qs,
                                         const float* Os, const float* Ks,
                                         const float* Vs, int row0, int c0,
                                         const float* mask, int N,
                                         const float* sm, int rows_sm, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int keys[2] = {c0 + g, c0 + g + 8};
  uint32_t ah[4], al[4], bh[2], bl[2];
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  const float* ka = Ks + (row0 + g) * LD + t;
  const float* va = Vs + (row0 + g) * LD + t;
  const int qtiles = (N + 7) / 8;
#pragma unroll 1
  for (int it = 0; it < qtiles; ++it) {
    // Sᵀ = K·q_sᵀ and dPᵀ = V·d_outᵀ for queries [8it, 8it + 8): element e
    // is key keys[e >> 1], query 8it + 2t + (e & 1)
    float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qb = Qs + (it * 8 + g) * LD + t;
    const float* ob = Os + (it * 8 + g) * LD + t;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 8) {
      frag_a_rows(ah, al, ka + kk, 1.f);
      frag_b_rows(bh, bl, qb + kk, SCALE);
      kstep(st, ah, al, bh, bl);
      frag_a_rows(ah, al, va + kk, 1.f);
      frag_b_rows(bh, bl, ob + kk, 1.f);
      kstep(dpt, ah, al, bh, bl);
    }
    // Pᵀ and dSᵀ from the row statistics; 0 for queries past N
    float pt[4], dst[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int query = it * 8 + 2 * t + (e & 1), key = keys[e >> 1];
      pt[e] = dst[e] = 0.f;
      if (query < N) {
        float x = st[e];
        if (mask != nullptr && key < N) x += mask[(size_t)query * N + key];
        const float p = div_rn(expf(x - sm[query]), sm[rows_sm + query],
                               sm[2 * rows_sm + query]);
        pt[e] = p;
        dst[e] = p * (dpt[e] - sm[3 * rows_sm + query]);
      }
    }
    // dv += Pᵀ·d_out and dk += dSᵀ·q_s over the tile's 8 queries
    uint32_t sh[4], sl[4];
    frag_a_acc(ah, al, pt);
    frag_a_acc(sh, sl, dst);
    const float* oc = Os + (it * 8 + 2 * t) * LD + g;
    const float* qc = Qs + (it * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      frag_b_cols(bh, bl, oc + dt * 8, 1.f);
      kstep(dv[dt], ah, al, bh, bl);
      frag_b_cols(bh, bl, qc + dt * 8, SCALE);
      kstep(dk[dt], sh, sl, bh, bl);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (keys[r] < N) {
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        const long long off = keys[r] * hd.stride + dt * 8 + 2 * t;
        *reinterpret_cast<float2*>(hd.dk + off) =
            make_float2(dk[dt][2 * r], dk[dt][2 * r + 1]);
        *reinterpret_cast<float2*>(hd.dv + off) =
            make_float2(dv[dt][2 * r], dv[dt][2 * r + 1]);
      }
    }
}

template <int NT, int MODE>
__global__ void __launch_bounds__(Layout<NT, MODE>::WARPS * 32,
                                  Layout<NT, MODE>::MIN_BLOCKS)
    attn_bwd_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ d_attn,
                    const float* __restrict__ mask, float* __restrict__ dqkv,
                    float* __restrict__ attn, float* __restrict__ row_stats,
                    int N, int H, int D) {
  using L = Layout<NT, MODE>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [Q_ROWS][LD], q (unscaled)
  float* Os = Qs + L::Q_ROWS * LD;   // [Q_ROWS][LD], d_out
  float* Ks = Os + L::Q_ROWS * LD;   // [K_ROWS][LD]
  float* Vs = Ks + L::K_ROWS * LD;   // [K_ROWS][LD]
  float* sm = Vs + L::K_ROWS * LD;   // [4][ROWS] (kBoth, kKV)
  int tile = 0, h, b;
  if (MODE == kBoth) {
    h = blockIdx.x % H;
    b = blockIdx.x / H;
  } else {
    tile = blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
  }
  Head hd;
  hd.stride = 3LL * D;
  hd.dstride = D;
  const long long row_off = (long long)b * N;
  hd.q = qkv + row_off * hd.stride + h * DH;
  hd.k = hd.q + D;
  hd.v = hd.q + 2 * D;
  hd.dout = d_attn + row_off * D + h * DH;
  hd.dq = dqkv + row_off * hd.stride + h * DH;
  hd.dk = hd.dq + D;
  hd.dv = hd.dq + 2 * D;
  hd.attn = attn == nullptr ? nullptr : attn + row_off * D + h * DH;
  hd.stats = MODE == kBoth ? nullptr : row_stats + ((size_t)b * H + h) * N * 3;
  const int qbase = MODE == kQ ? tile * TILE : 0;
  const int kbase = MODE == kKV ? tile * TILE : 0;

  load_rows(Qs, hd.q, hd.stride, qbase, L::Q_ROWS, N);
  load_rows(Os, hd.dout, hd.dstride, qbase, L::Q_ROWS, N);
  load_rows(Ks, hd.k, hd.stride, kbase, L::K_ROWS, N);
  load_rows(Vs, hd.v, hd.stride, kbase, L::K_ROWS, N);
  cp_async_commit();
  if (MODE == kKV) {
    for (int i = threadIdx.x; i < L::ROWS; i += blockDim.x) {
      const bool in = i < N;
      const float l = in ? hd.stats[i * 3 + 1] : 1.f;
      sm[i] = in ? hd.stats[i * 3] : 0.f;
      sm[L::ROWS + i] = l;
      sm[2 * L::ROWS + i] = __frcp_rn(l);
      sm[3 * L::ROWS + i] = in ? hd.stats[i * 3 + 2] : 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (MODE != kKV) {
    const int strips = (min(N - qbase, L::Q_ROWS) + STRIP - 1) / STRIP;
    for (int s = warp; s < strips; s += L::WARPS)
      q_strip<NT>(hd, Qs, Os, Ks, Vs, s * STRIP, qbase + s * STRIP, mask, N,
                  MODE == kBoth ? sm : nullptr, L::ROWS, lane);
  }
  if (MODE == kBoth) __syncthreads();  // every query's statistics written
  if (MODE != kQ) {
    const int strips = (min(N - kbase, L::K_ROWS) + STRIP - 1) / STRIP;
    for (int s = warp; s < strips; s += L::WARPS)
      kv_strip(hd, Qs, Os, Ks, Vs, s * STRIP, kbase + s * STRIP, mask, N, sm,
               L::ROWS, lane);
  }
}

template <int NT, int MODE>
int launch_mode(dim3 grid, const void* qkv, const void* d_attn,
                const void* mask, void* dqkv, void* attn, void* row_stats,
                int N, int H, int D, cudaStream_t s) {
  using L = Layout<NT, MODE>;
  // the shared-memory opt-in is a property of the function on a device: set
  // it once per instantiation and device, not on every launch
  // bit d: device d; atomic, as several host threads may launch
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !((opted_in.load() >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(attn_bwd_kernel<NT, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted_in.fetch_or(1ull << dev);
  }
  attn_bwd_kernel<NT, MODE><<<grid, L::WARPS * 32, L::bytes, s>>>(
      (const float*)qkv, (const float*)d_attn, (const float*)mask,
      (float*)dqkv, (float*)attn, (float*)row_stats, N, H, D);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_fused(const void* qkv, const void* d_attn, const void* mask,
                 void* dqkv, void* attn, void* row_stats, int B, int N, int H,
                 int D, cudaStream_t s) {
  return launch_mode<NT, kBoth>(dim3(B * H), qkv, d_attn, mask, dqkv, attn,
                                row_stats, N, H, D, s);
}

template <int NT>
int launch_split(const void* qkv, const void* d_attn, const void* mask,
                 void* dqkv, void* attn, void* row_stats, int B, int N, int H,
                 int D, cudaStream_t s) {
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  const int rc = launch_mode<NT, kQ>(grid, qkv, d_attn, mask, dqkv, attn,
                                     row_stats, N, H, D, s);
  if (rc != 0) return rc;
  return launch_mode<NT, kKV>(grid, qkv, d_attn, mask, dqkv, attn, row_stats,
                              N, H, D, s);
}

}  // namespace

// row_stats: fp32 scratch of B·H·N·3 floats, written and read only past
// 80 tokens (may be null up to there); attn may be null (no dWout)
extern "C" int cgt_attention_bwd(const void* qkv, const void* d_attn,
                                 const void* mask, void* dqkv, void* attn,
                                 void* row_stats, int B, int N, int H, int D,
                                 void* stream) {
  if (N < 1 || N > MAX_N || B < 1 || H < 1 || D != H * DH)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (N + 7) / 8;  // the smallest bucket of 8-key tiles
  if (tiles <= 3)
    return launch_fused<3>(qkv, d_attn, mask, dqkv, attn, row_stats, B, N, H, D, s);
  if (tiles <= 4)
    return launch_fused<4>(qkv, d_attn, mask, dqkv, attn, row_stats, B, N, H, D, s);
  if (N <= FUSED_MAX_N)
    return launch_fused<10>(qkv, d_attn, mask, dqkv, attn, row_stats, B, N, H, D, s);
  if (row_stats == nullptr) return (int)cudaErrorInvalidValue;
  return launch_split<MAX_N / 8>(qkv, d_attn, mask, dqkv, attn, row_stats, B, N, H,
                                 D, s);
}

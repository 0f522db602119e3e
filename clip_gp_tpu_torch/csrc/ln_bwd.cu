// LayerNorm backward and the column sums of the backward kernels K3 and K4
// (_ln_attn_bwd_kernel and _ln_mlp_bwd_kernel of
// clip_gp_tpu/ops/flash_attention.py), in fp32:
//
//   dx = dout + rstd·(dxhat − mean(dxhat) − xhat·mean(dxhat·xhat)),
//   dxhat = dh·γ,   dγ = Σ_rows dh·xhat,   dβ = Σ_rows dh,
//
// and the bias gradients Σ_rows dqkv, dout, dhid. x and dout are read in the
// working type (fp32 or bf16), dh is fp32, dx is written in the working
// type; xhat is recomputed from x and the fp32 row statistics of
// ln_stats_kernel (ln_gemm.cu).
//
// On the TPU the column sums accumulate in a constant output block across
// the sequential grid. Here they take two passes: a first kernel sums
// blocks of `rows_per_chunk` rows (one thread a column, neighbouring
// threads on neighbouring columns), a second adds the per-block partials
// in a fixed order. No atomics: the sums are the same bits on every run.
// cgt_sum_parts is that second pass on its own, for the split-K parts of
// gemm_bwd.cu.
//
// What bounds it on an H100: bytes. The row kernel reads x, dout and dh
// once and writes dx (at B=256, N=24, D=512 in fp32: 25 MB, 7.5 us at
// 3.35 TB/s) for about 10 FLOPs an element; one warp walks a row, D/32
// elements a lane, twice (the two row means, then dx).
#include "common.cuh"

using namespace cgt;

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                  const float* __restrict__ dh,
                  const float2* __restrict__ stats,
                  const float* __restrict__ gamma, T* __restrict__ dx,
                  int rows, int cols) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const size_t off = (size_t)row * cols;
  const float2 st = stats[row];
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float xhat = (to_f32(x[off + c]) - st.x) * st.y;
    const float dxhat = dh[off + c] * gamma[c];
    s1 += dxhat;
    s2 += dxhat * xhat;
  }
  const float m1 = warp_sum(s1) / (float)cols;
  const float m2 = warp_sum(s2) / (float)cols;
  for (int c = lane; c < cols; c += 32) {
    const float xhat = (to_f32(x[off + c]) - st.x) * st.y;
    const float dxhat = dh[off + c] * gamma[c];
    dx[off + c] =
        from_f32<T>(to_f32(dout[off + c]) + st.y * (dxhat - m1 - xhat * m2));
  }
}

// first pass of a column sum: partial[chunk][c] = Σ src[r][c] over the
// chunk's rows
template <typename T>
__global__ void __launch_bounds__(256)
    colsum_partial_kernel(const T* __restrict__ src,
                          float* __restrict__ partial, int rows, int cols,
                          int rows_per_chunk) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += to_f32(src[(size_t)r * cols + c]);
  partial[(size_t)blockIdx.y * cols + c] = s;
}

// first pass of dγ and dβ: Σ dh·xhat and Σ dh over the chunk's rows
template <typename T>
__global__ void __launch_bounds__(256)
    ln_param_partial_kernel(const float* __restrict__ dh,
                            const T* __restrict__ x,
                            const float2* __restrict__ stats,
                            float* __restrict__ partial_g,
                            float* __restrict__ partial_b, int rows, int cols,
                            int rows_per_chunk) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  float sg = 0.f, sb = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float2 st = stats[r];
    const size_t idx = (size_t)r * cols + c;
    const float g = dh[idx];
    sg += g * ((to_f32(x[idx]) - st.x) * st.y);
    sb += g;
  }
  partial_g[(size_t)blockIdx.y * cols + c] = sg;
  partial_b[(size_t)blockIdx.y * cols + c] = sb;
}

// second pass: out[i] = Σ_p parts[p][i], p in order
__global__ void __launch_bounds__(256)
    sum_parts_kernel(const float* __restrict__ parts, float* __restrict__ out,
                     int n_parts, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += parts[(size_t)p * n + i];
  out[i] = s;
}

int sum_parts(const float* parts, float* out, int n_parts, int n,
              cudaStream_t s) {
  sum_parts_kernel<<<(n + 255) / 256, 256, 0, s>>>(parts, out, n_parts, n);
  return (int)cudaGetLastError();
}

template <typename T>
int ln_bwd(const void* x, const void* dout, const void* dh, const void* stats,
           const void* gamma, void* dx, int rows, int cols, cudaStream_t s) {
  ln_bwd_kernel<T><<<(rows + 7) / 8, 256, 0, s>>>(
      (const T*)x, (const T*)dout, (const float*)dh, (const float2*)stats,
      (const float*)gamma, (T*)dx, rows, cols);
  return (int)cudaGetLastError();
}

template <typename T>
int colsum(const void* src, float* partial, float* out, int rows, int cols,
           int rows_per_chunk, cudaStream_t s) {
  const int chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  const dim3 grid((cols + 255) / 256, chunks);
  colsum_partial_kernel<T><<<grid, 256, 0, s>>>((const T*)src, partial, rows,
                                                cols, rows_per_chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_parts(partial, out, chunks, cols, s);
}

template <typename T>
int ln_param_grads(const void* dh, const void* x, const void* stats,
                   float* partial, float* dgamma, float* dbeta, int rows,
                   int cols, int rows_per_chunk, cudaStream_t s) {
  const int chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  float* partial_b = partial + (size_t)chunks * cols;
  const dim3 grid((cols + 255) / 256, chunks);
  ln_param_partial_kernel<T><<<grid, 256, 0, s>>>(
      (const float*)dh, (const T*)x, (const float2*)stats, partial, partial_b,
      rows, cols, rows_per_chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rc = sum_parts(partial, dgamma, chunks, cols, s);
  if (rc != 0) return rc;
  return sum_parts(partial_b, dbeta, chunks, cols, s);
}

}  // namespace

extern "C" int cgt_ln_bwd(const void* x, const void* dout, const void* dh,
                          const void* stats, const void* gamma, void* dx,
                          int rows, int cols, int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return ln_bwd<float>(x, dout, dh, stats, gamma, dx, rows, cols, s);
  if (dtype == kBF16)
    return ln_bwd<__nv_bfloat16>(x, dout, dh, stats, gamma, dx, rows, cols, s);
  return (int)cudaErrorInvalidValue;
}

// partial: fp32 scratch of 2·ceil(rows / rows_per_chunk)·cols floats
extern "C" int cgt_ln_param_grads(const void* dh, const void* x,
                                  const void* stats, void* partial,
                                  void* dgamma, void* dbeta, int rows,
                                  int cols, int rows_per_chunk, int dtype,
                                  void* stream) {
  if (rows_per_chunk < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return ln_param_grads<float>(dh, x, stats, (float*)partial,
                                 (float*)dgamma, (float*)dbeta, rows, cols,
                                 rows_per_chunk, s);
  if (dtype == kBF16)
    return ln_param_grads<__nv_bfloat16>(dh, x, stats, (float*)partial,
                                         (float*)dgamma, (float*)dbeta, rows,
                                         cols, rows_per_chunk, s);
  return (int)cudaErrorInvalidValue;
}

// partial: fp32 scratch of ceil(rows / rows_per_chunk)·cols floats
extern "C" int cgt_colsum(const void* src, void* partial, void* out, int rows,
                          int cols, int rows_per_chunk, int dtype,
                          void* stream) {
  if (rows_per_chunk < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return colsum<float>(src, (float*)partial, (float*)out, rows, cols,
                         rows_per_chunk, s);
  if (dtype == kBF16)
    return colsum<__nv_bfloat16>(src, (float*)partial, (float*)out, rows,
                                 cols, rows_per_chunk, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int cgt_sum_parts(const void* parts, void* out, int n_parts, int n,
                             void* stream) {
  if (n_parts < 1 || n < 1) return (int)cudaErrorInvalidValue;
  return sum_parts((const float*)parts, (float*)out, n_parts, n,
                   (cudaStream_t)stream);
}

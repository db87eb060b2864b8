// Chunk Top-K kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of grace_tpu/ops/pallas_topk.py:
//   * grace_chunk_compress_feedback <- chunk_compress_feedback (:132, call :169)
//   * grace_chunk_aggregate_dense   <- chunk_aggregate_dense   (:237, call :263)
// and must equal them bit for bit (their plain PyTorch versions live in
// grace_tpu_torch/ops/chunk_topk.py and are the oracle).
//
// Layout: the flat n-element buffer is viewed as (main_rows, k) row-major,
// main_rows = n / k, plus one tail row holding flat[main_rows*k + c] for
// c < rem = n - main_rows*k and 0.0 elsewhere. Column c of that view is
// chunk c of the Top-K wire format. The tail is read in place: no padded
// copy of the buffer is ever made.
//
// What bounds them on this card: bytes. Compress reads the gradient and the
// residual and writes the residual (12 bytes an element) plus 8 bytes a
// kept element; the aggregate writes the dense output (4 bytes an element)
// and reads 8 bytes a kept element for each of the W ranks. Both do a few
// operations a byte, far below the card's ratio of ~20 fp32 FLOP/byte.
//
// What the design does about it: one thread owns one column and walks its
// rows, so the 32 threads of a warp touch 32 neighbouring floats of a row
// at each step: every load and store is coalesced. Compress makes two
// passes over its column (select, then write the residual); the second
// pass mostly hits L2 for the short columns of this model (<= 129 rows).
// The aggregate writes each output element once and touches only the
// winning rows a second time. This is the simple, correct first design;
// the launches per leaf, not the bytes, set its time at ResNet-50's sizes.
//
// Bit-exactness rules (see the plain versions):
//   * comp = g*gamma + r*beta with each product rounded before the add:
//     __fmul_rn/__fadd_rn are never contracted into an FMA by nvcc.
//   * The column max propagates NaN: a NaN anywhere in the column (tail
//     included) makes the winner row 0, as jnp.max + equality tests do.
//   * The winner is the first main row reaching the max, else the tail.
//   * vals = comp[win] + 0.0f (the masked sum of the reference turns a
//     -0.0 winner into +0.0); bf16 wire values round to nearest even.
//   * The aggregate adds the ranks' values in rank order starting from
//     +0.0; the mean multiplies by float(1/W), correctly rounded, as XLA
//     compiles the reference's division by the constant W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool HAS_R>
__device__ __forceinline__ float compensate(const float* g, const float* r,
                                            int64_t i, float beta,
                                            float gamma) {
  float c = __fmul_rn(g[i], gamma);
  if (HAS_R) c = __fadd_rn(c, __fmul_rn(r[i], beta));
  return c;
}

// g: gradient, r: residual (nullptr when !HAS_R), out_r: new residual.
// out_r may alias r: each element is read and then written by the same
// thread, in that order, so the in-place update is safe.
template <bool HAS_R, bool BF16>
__global__ void chunk_compress_feedback_kernel(
    const float* g, const float* r, float* out_r, void* vals, int32_t* win,
    int64_t k, int64_t main_rows, int64_t rem, float beta, float gamma) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= k) return;

  // Pass 1: first row reaching the column max of |comp|, NaN-propagating.
  float m = -1.0f;            // below every |comp|: row 0 always takes it
  int32_t w = 0;
  float wv = 0.0f, v0 = 0.0f;
  bool nan = false;
  for (int64_t row = 0; row < main_rows; ++row) {
    const float cv = compensate<HAS_R>(g, r, row * k + c, beta, gamma);
    const float a = fabsf(cv);
    if (row == 0) v0 = cv;
    if (isnan(a)) {
      nan = true;
    } else if (a > m) {       // strict: ties keep the earlier row
      m = a;
      w = static_cast<int32_t>(row);
      wv = cv;
    }
  }
  const bool tail_real = c < rem;
  float tc;
  if (tail_real) {
    tc = compensate<HAS_R>(g, r, main_rows * k + c, beta, gamma);
  } else {                    // zero padding, compensated like real lanes
    tc = __fmul_rn(0.0f, gamma);
    if (HAS_R) tc = __fadd_rn(tc, __fmul_rn(0.0f, beta));
  }
  const float at = fabsf(tc);
  if (isnan(at)) {
    nan = true;
  } else if (at > m) {        // the tail wins only past every main row
    w = static_cast<int32_t>(main_rows);
    wv = tc;
  }
  if (nan) {                  // no equality fires against a NaN max
    w = 0;
    wv = v0;
  }

  const float v = __fadd_rn(wv, 0.0f);
  float dense;
  if (BF16) {
    const __nv_bfloat16 b = __float2bfloat16_rn(v);
    static_cast<__nv_bfloat16*>(vals)[c] = b;
    dense = __bfloat162float(b);    // the residual absorbs the rounding
  } else {
    static_cast<float*>(vals)[c] = v;
    dense = v;
  }
  win[c] = w;

  // Pass 2: the new residual, comp everywhere but comp - dense at the winner.
  for (int64_t row = 0; row < main_rows; ++row) {
    const int64_t i = row * k + c;
    const float cv = compensate<HAS_R>(g, r, i, beta, gamma);
    out_r[i] = (row == w) ? __fsub_rn(cv, dense) : cv;
  }
  if (tail_real) {
    const int64_t i = main_rows * k + c;
    const float cv = compensate<HAS_R>(g, r, i, beta, gamma);
    out_r[i] = (w == main_rows) ? __fsub_rn(cv, dense) : cv;
  }
}

template <bool BF16>
__device__ __forceinline__ float load_val(const void* vals, int64_t i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(vals)[i]);
  return static_cast<const float*>(vals)[i];
}

// vals/win: (world, k) row-major. out: n floats.
template <bool BF16>
__global__ void chunk_aggregate_dense_kernel(const void* vals,
                                             const int32_t* win, float* out,
                                             int64_t world, int64_t k,
                                             int64_t main_rows, int64_t rem,
                                             int average) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= k) return;
  const int64_t rows = main_rows + (c < rem ? 1 : 0);   // real rows of column c
  // The mean multiplies by the correctly rounded float reciprocal of W:
  // that is what XLA compiles the reference's `acc / world` to.
  const float inv_world = __fdiv_rn(1.0f, static_cast<float>(world));
  for (int64_t row = 0; row < rows; ++row) out[row * k + c] = 0.0f;
  // Each distinct winning row is summed once, at its first rank, over the
  // ranks that chose it, in rank order. Ranks that did not choose it add
  // +0.0 in the reference, which changes no partial sum that starts at
  // +0.0, so skipping them is exact.
  for (int64_t i = 0; i < world; ++i) {
    const int32_t row = win[i * k + c];
    if (row < 0 || row >= rows) continue;   // padding lane or out of range
    bool seen = false;
    for (int64_t j = 0; j < i; ++j) {
      if (win[j * k + c] == row) { seen = true; break; }
    }
    if (seen) continue;
    float acc = 0.0f;
    for (int64_t j = i; j < world; ++j) {
      if (win[j * k + c] == row) acc = __fadd_rn(acc, load_val<BF16>(vals, j * k + c));
    }
    if (average) acc = __fmul_rn(acc, inv_world);
    out[row * k + c] = acc;
  }
}

inline unsigned int blocks_for(int64_t k) {
  return static_cast<unsigned int>((k + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = success) of the launch.
int grace_chunk_compress_feedback(const float* g, const float* r, float* out_r,
                                  void* vals, int32_t* win, int64_t n,
                                  int64_t k, float beta, float gamma,
                                  int wire_bf16, void* stream) {
  if (k <= 0 || n < 2 * k) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t main_rows = n / k;
  const int64_t rem = n - main_rows * k;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = blocks_for(k);
  if (r != nullptr && wire_bf16) {
    chunk_compress_feedback_kernel<true, true><<<blocks, kThreads, 0, s>>>(
        g, r, out_r, vals, win, k, main_rows, rem, beta, gamma);
  } else if (r != nullptr) {
    chunk_compress_feedback_kernel<true, false><<<blocks, kThreads, 0, s>>>(
        g, r, out_r, vals, win, k, main_rows, rem, beta, gamma);
  } else if (wire_bf16) {
    chunk_compress_feedback_kernel<false, true><<<blocks, kThreads, 0, s>>>(
        g, r, out_r, vals, win, k, main_rows, rem, beta, gamma);
  } else {
    chunk_compress_feedback_kernel<false, false><<<blocks, kThreads, 0, s>>>(
        g, r, out_r, vals, win, k, main_rows, rem, beta, gamma);
  }
  return static_cast<int>(cudaGetLastError());
}

int grace_chunk_aggregate_dense(const void* vals, const int32_t* win,
                                float* out, int64_t world, int64_t k,
                                int64_t n, int vals_bf16, int average,
                                void* stream) {
  if (k <= 0 || world <= 0 || n < k) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t main_rows = n / k;
  const int64_t rem = n - main_rows * k;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = blocks_for(k);
  if (vals_bf16) {
    chunk_aggregate_dense_kernel<true><<<blocks, kThreads, 0, s>>>(
        vals, win, out, world, k, main_rows, rem, average);
  } else {
    chunk_aggregate_dense_kernel<false><<<blocks, kThreads, 0, s>>>(
        vals, win, out, world, k, main_rows, rem, average);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

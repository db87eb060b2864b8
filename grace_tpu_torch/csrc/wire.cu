// Fused decode->accumulate kernel for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel grace_tpu/ops/pallas_wire.py
// decode_accumulate (:180, call :208): K packed payloads (a ring hop: K=2,
// recv then own) -> one float32 partial, and must equal its plain PyTorch
// version (grace_tpu_torch/ops/wire.py) bit for bit.
//
// What bounds it on this card: bytes. It reads K * width/8 bytes and writes
// 4 bytes an element; the decode is a handful of integer operations and one
// multiply-add per payload.
//
// What the design does about it: one thread owns one output element, reads
// its code from each of the K payloads (neighbouring threads read
// neighbouring bits of each payload) and writes its sum once, in a
// grid-stride loop. Nothing full-width is staged: the unpacked codes and the
// decoded payloads never reach device memory.
//
// Bit-exactness rules (the staged sequential decode's):
//   * width 1, 2 or 4: code g is bits width*(g % (8/width)) .. of byte
//     g / (8/width); width 3: bits 3g .. 3g+2 of the LSB-first stream, read
//     across a byte boundary where the code straddles one;
//   * level = code - 2^width * (code >= 2^(width-1)) (two's complement);
//   * acc = scale_0 * level_0, then acc += scale_k * level_k in stack order,
//     each product and sum rounded on its own (__fmul_rn/__fadd_rn: no FMA,
//     whatever nvcc's contraction setting);
//   * sign: the value is 2*code - 1 (scales unused); vote re-signs the sum,
//     (acc >= 0) * 2 - 1, ties to +1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

template <int W>
__device__ __forceinline__ uint32_t read_code(const uint8_t* p, int64_t g) {
  if (W == 3) {
    const int64_t bit = 3 * g;
    const int shift = static_cast<int>(bit & 7);
    uint32_t v = p[bit >> 3];
    if (shift > 5) v |= static_cast<uint32_t>(p[(bit >> 3) + 1]) << 8;
    return (v >> shift) & 7u;
  }
  constexpr int kPer = 8 / W;
  return (static_cast<uint32_t>(p[g / kPer]) >> (W * (g % kPer))) &
         ((1u << W) - 1u);
}

template <int W, bool SIGN, bool VOTE>
__global__ void decode_accumulate_kernel(const uint8_t* stacked,
                                         const float* scales, float* out,
                                         int64_t k_payloads, int64_t row_bytes,
                                         int64_t numel) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < numel; g += stride) {
    float acc = 0.0f;
    for (int64_t k = 0; k < k_payloads; ++k) {
      const uint32_t code = read_code<W>(stacked + k * row_bytes, g);
      float val;
      if (SIGN) {
        val = __fsub_rn(__fmul_rn(static_cast<float>(code), 2.0f), 1.0f);
      } else {
        const int level = static_cast<int>(code) -
                          (code >= (1u << (W - 1)) ? (1 << W) : 0);
        val = __fmul_rn(scales[k], static_cast<float>(level));
      }
      acc = k == 0 ? val : __fadd_rn(acc, val);
    }
    if (VOTE) acc = acc >= 0.0f ? 1.0f : -1.0f;
    out[g] = acc;
  }
}

template <int W, bool SIGN, bool VOTE>
void launch(const uint8_t* stacked, const float* scales, float* out,
            int64_t k, int64_t row_bytes, int64_t numel, cudaStream_t s) {
  int64_t blocks = (numel + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;   // grid-stride covers the rest
  decode_accumulate_kernel<W, SIGN, VOTE>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
          stacked, scales, out, k, row_bytes, numel);
}

}  // namespace

extern "C" {

// stacked: (k, row_bytes) uint8 row-major, row_bytes >= ceil(numel*width/8);
// scales: k floats on the device. Returns the launch's cudaError_t.
int grace_decode_accumulate(const uint8_t* stacked, const float* scales,
                            float* out, int64_t k, int64_t row_bytes,
                            int64_t numel, int width, int sign, int vote,
                            void* stream) {
  if (k <= 0 || numel <= 0 || row_bytes < (numel * width + 7) / 8 ||
      (sign && width != 1) || (vote && !sign)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sign && vote) {
    launch<1, true, true>(stacked, scales, out, k, row_bytes, numel, s);
  } else if (sign) {
    launch<1, true, false>(stacked, scales, out, k, row_bytes, numel, s);
  } else if (width == 1) {
    launch<1, false, false>(stacked, scales, out, k, row_bytes, numel, s);
  } else if (width == 2) {
    launch<2, false, false>(stacked, scales, out, k, row_bytes, numel, s);
  } else if (width == 3) {
    launch<3, false, false>(stacked, scales, out, k, row_bytes, numel, s);
  } else if (width == 4) {
    launch<4, false, false>(stacked, scales, out, k, row_bytes, numel, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

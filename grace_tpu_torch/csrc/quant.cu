// QSGD quantize, QSGD quantize-and-pack and signSGD sign-pack kernels for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three Pallas TPU kernels of grace_tpu/ops/pallas_quant.py:
//   * grace_quantize_stochastic      <- quantize_stochastic      (:111, call :128)
//   * grace_quantize_pack_stochastic <- quantize_pack_stochastic (:247, call :289)
//   * grace_sign_pack                <- sign_pack                (:316, call :333)
// and must equal their plain PyTorch versions (grace_tpu_torch/ops/quant.py)
// bit for bit; those equal the Pallas kernels in interpret mode.
//
// What bounds them on this card: bytes. Quantize reads 4 bytes and writes 1
// (int8) or 2 (int16) an element; quantize-and-pack reads 4 and writes
// width/8; sign-pack reads 2 or 4 and writes 1/8. A few dozen integer and
// float operations an element (the hash, the level, the pack) stay well
// under the card's operations-per-byte ratio.
//
// What the design does about it: one thread owns one output unit (an
// element, a packed byte, or at width 3 a group of 8 codes = 3 bytes) and
// reads its inputs once, neighbouring threads on neighbouring addresses, in
// a grid-stride loop. No padded copy of the input is made: lanes past n are
// code 0 (sign bit 0) through a guard, exactly as the Pallas kernels' zero
// (sign: -1.0) padding gives. This is the simple, correct first design.
//
// The random bits are the counter hash of pallas_quant._hash_bits over the
// Pallas (64, 256) blocks: element g hashes local counter g % 16384 with
// seed + g / 16384, in uint32 arithmetic (the bits of XLA's int32 wrap).
//
// Bit-exactness rules (see the plain versions):
//   * scale = norm > 0 ? q / norm : 0, read from the device norm, with an
//     IEEE division (__fdiv_rn);
//   * level = floor(|x|*scale) + (u < |x|*scale - floor(|x|*scale)), with
//     u = (bits >> 8) * 2^-24, every rounding spelled __fmul_rn/__fsub_rn/
//     __fadd_rn so that nvcc contracts nothing into an FMA;
//   * int8/int16 levels saturate, as XLA's float-to-int conversion does;
//   * packed levels clamp to +-q and fold negatives into two's complement
//     (code + 2^width), LSB-first; 3-bit codes form one bitstream;
//   * sign bit = x >= 0 (-0.0 gives 1, NaN gives 0).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kHashBlock = 64 * 256;
constexpr int64_t kMaxBlocks = 1 << 20;

__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, int64_t g) {
  uint32_t h = static_cast<uint32_t>(g % kHashBlock) * 2654435761u;
  h += seed + static_cast<uint32_t>(g / kHashBlock);
  h ^= h >> 16;
  h *= 0x45D9F3Bu;
  h ^= h >> 16;
  h *= 0x45D9F3Bu;
  return h ^ (h >> 16);
}

__device__ __forceinline__ float encode_scale(const float* norm, int q) {
  const float n = *norm;
  return n > 0.0f ? __fdiv_rn(static_cast<float>(q), n) : 0.0f;
}

// The signed QSGD level of x (a float holding an integer).
__device__ __forceinline__ float signed_level(float x, float scale,
                                              uint32_t bits) {
  const float lf = __fmul_rn(fabsf(x), scale);
  const float prev = floorf(lf);
  const float u = __fmul_rn(static_cast<float>(static_cast<int32_t>(bits >> 8)),
                            5.9604644775390625e-08f);   // 2^-24, exact
  const float level = __fadd_rn(prev, u < __fsub_rn(lf, prev) ? 1.0f : 0.0f);
  const float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return __fmul_rn(level, sgn);
}

template <typename T>
__global__ void quantize_stochastic_kernel(const float* x, const float* norm,
                                           T* out, int64_t n, int q,
                                           uint32_t seed, float lo, float hi) {
  const float scale = encode_scale(norm, q);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < n; g += stride) {
    const float s = signed_level(x[g], scale, hash_bits(seed, g));
    out[g] = static_cast<T>(static_cast<int>(fminf(fmaxf(s, lo), hi)));
  }
}

// The width-bit two's-complement code of element g (0 past n).
__device__ __forceinline__ uint32_t packed_code(const float* x, int64_t n,
                                                int64_t g, float scale,
                                                float qf, uint32_t seed,
                                                int width) {
  if (g >= n) return 0u;
  float s = signed_level(x[g], scale, hash_bits(seed, g));
  s = fminf(fmaxf(s, -qf), qf);
  const int level = static_cast<int>(s);
  return static_cast<uint32_t>(level < 0 ? level + (1 << width) : level);
}

// Widths 2 and 4: one thread per output byte of 8/width codes.
__global__ void quantize_pack_kernel(const float* x, const float* norm,
                                     uint8_t* out, int64_t n, int64_t nbytes,
                                     int q, uint32_t seed, int width) {
  const float scale = encode_scale(norm, q);
  const float qf = static_cast<float>(q);
  const int per = 8 / width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       b < nbytes; b += stride) {
    uint32_t byte = 0;
    for (int j = 0; j < per; ++j) {
      byte |= packed_code(x, n, b * per + j, scale, qf, seed, width)
              << (width * j);
    }
    out[b] = static_cast<uint8_t>(byte);
  }
}

// Width 3: one thread per group of 8 codes, i.e. 24 bits = 3 bytes of the
// LSB-first bitstream (bit b of code g is stream bit 3g + b).
__global__ void quantize_pack3_kernel(const float* x, const float* norm,
                                      uint8_t* out, int64_t n, int64_t nbytes,
                                      int q, uint32_t seed) {
  const float scale = encode_scale(norm, q);
  const float qf = static_cast<float>(q);
  const int64_t groups = (nbytes + 2) / 3;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < groups; t += stride) {
    uint32_t bits = 0;
    for (int j = 0; j < 8; ++j) {
      bits |= packed_code(x, n, t * 8 + j, scale, qf, seed, 3) << (3 * j);
    }
    for (int j = 0; j < 3; ++j) {
      const int64_t b = t * 3 + j;
      if (b < nbytes) out[b] = static_cast<uint8_t>(bits >> (8 * j));
    }
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// One thread per output byte: the sign bits of 8 inputs, LSB first.
template <typename T>
__global__ void sign_pack_kernel(const T* x, uint8_t* out, int64_t n,
                                 int64_t nbytes) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       b < nbytes; b += stride) {
    uint32_t byte = 0;
    for (int j = 0; j < 8; ++j) {
      const int64_t g = b * 8 + j;
      if (g < n && to_float(x[g]) >= 0.0f) byte |= 1u << j;
    }
    out[b] = static_cast<uint8_t>(byte);
  }
}

inline unsigned int blocks_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;   // grid-stride covers the rest
  return static_cast<unsigned int>(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t (0 = success) of its launch.
int grace_quantize_stochastic(const float* x, const float* norm, void* out,
                              int64_t n, int q, uint32_t seed, int out_int16,
                              void* stream) {
  if (n <= 0 || q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_int16) {
    quantize_stochastic_kernel<int16_t><<<blocks_for(n), kThreads, 0, s>>>(
        x, norm, static_cast<int16_t*>(out), n, q, seed, -32768.0f, 32767.0f);
  } else {
    quantize_stochastic_kernel<int8_t><<<blocks_for(n), kThreads, 0, s>>>(
        x, norm, static_cast<int8_t*>(out), n, q, seed, -128.0f, 127.0f);
  }
  return static_cast<int>(cudaGetLastError());
}

int grace_quantize_pack_stochastic(const float* x, const float* norm,
                                   uint8_t* out, int64_t n, int q,
                                   uint32_t seed, int width, void* stream) {
  if (n <= 0 || width < 2 || width > 4 || q < 1 ||
      q > (1 << (width - 1)) - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nbytes = (n * width + 7) / 8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 3) {
    quantize_pack3_kernel<<<blocks_for((nbytes + 2) / 3), kThreads, 0, s>>>(
        x, norm, out, n, nbytes, q, seed);
  } else if (width == 2 || width == 4) {
    quantize_pack_kernel<<<blocks_for(nbytes), kThreads, 0, s>>>(
        x, norm, out, n, nbytes, q, seed, width);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
int grace_sign_pack(const void* x, uint8_t* out, int64_t n, int dtype,
                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nbytes = (n + 7) / 8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = blocks_for(nbytes);
  if (dtype == 0) {
    sign_pack_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), out, n, nbytes);
  } else if (dtype == 1) {
    sign_pack_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), out, n, nbytes);
  } else if (dtype == 2) {
    sign_pack_kernel<__half><<<blocks, kThreads, 0, s>>>(
        static_cast<const __half*>(x), out, n, nbytes);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

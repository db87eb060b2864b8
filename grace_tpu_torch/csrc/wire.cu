// The wire path's hop kernels for Hopper (sm_90a), plain C interface for
// ctypes: decode->accumulate and the packed integer accumulate (below).
//
// decode_accumulate replaces the Pallas TPU kernel
// grace_tpu/ops/pallas_wire.py decode_accumulate (:180, call :208): K packed
// payloads (a ring hop: K=2, recv then own) -> one float32 partial, and must
// equal its plain PyTorch version (grace_tpu_torch/ops/wire.py) bit for bit.
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

// The packed integer accumulate.
//
// Replaces the Pallas TPU kernel grace_tpu/ops/pallas_wire.py
// packed_int_accumulate (:254, call :270): K payloads of W-bit two's-
// complement levels (homoqsgd's packed wire, W in {2, 3, 4}), each
// row_bytes long -> one payload of their integer sums, row_bytes long. It
// must equal its plain PyTorch version (grace_tpu_torch/ops/wire.py), which
// is homoqsgd's staged unpack -> add -> repack, byte for byte.
//
// What bounds it on this card: bytes. It reads K * row_bytes and writes
// row_bytes; each code costs a shift, a mask, a sign extension and an add.
//
// What the design does about it: one thread owns one group of G bytes of
// the output, G = 4 for widths 2 and 4 (16 or 8 whole codes) and G = 3 for
// width 3 (8 codes, which straddle the byte boundaries inside the group
// but never leave it). The thread reads its group from each of the K
// payloads (one 32-bit load where the rows are 4-byte aligned), keeps the
// per-code sums in registers and writes its group once; nothing unpacked
// reaches device memory. A trailing partial group reads zeros past the
// row's end and writes only the bytes that exist.
//
// Exactness: integers only. level = code - 2^W * (code >= 2^(W-1)); the
// int32 sum folds back to a code with & (2^W - 1), which is the floored
// mod 2^W of the staged path (torch.remainder) for negative sums as well,
// so the two agree even where a sum leaves the field. Code slots from
// numel on are written as 0, as the staged repack of numel codes leaves
// them.

template <int W>
__global__ void packed_int_accumulate_kernel(const uint8_t* stacked,
                                             uint8_t* out, int64_t k_payloads,
                                             int64_t row_bytes, int64_t numel,
                                             bool aligned) {
  constexpr int G = W == 3 ? 3 : 4;       // bytes a thread
  constexpr int C = G * 8 / W;            // whole codes in those bytes
  constexpr uint32_t kMask = (1u << W) - 1u;
  const int64_t groups = (row_bytes + G - 1) / G;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t b0 = g * G;
    const int nb = row_bytes - b0 < G ? static_cast<int>(row_bytes - b0) : G;
    const bool word = W != 3 && aligned && nb == G;
    int acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0;
    for (int64_t k = 0; k < k_payloads; ++k) {
      const uint8_t* p = stacked + k * row_bytes + b0;
      uint32_t bits = 0;
      if (word) {
        bits = *reinterpret_cast<const uint32_t*>(p);
      } else {
        for (int i = 0; i < nb; ++i) bits |= static_cast<uint32_t>(p[i]) << (8 * i);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int code = static_cast<int>((bits >> (W * c)) & kMask);
        acc[c] += code - ((code >> (W - 1)) << W);
      }
    }
    const int64_t slot0 = b0 * 8 / W;     // b0 is a multiple of G
    uint32_t packed = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (slot0 + c < numel) {
        packed |= (static_cast<uint32_t>(acc[c]) & kMask) << (W * c);
      }
    }
    if (word) {
      *reinterpret_cast<uint32_t*>(out + b0) = packed;
    } else {
      for (int i = 0; i < nb; ++i) out[b0 + i] = static_cast<uint8_t>(packed >> (8 * i));
    }
  }
}

template <int W>
void launch_accumulate(const uint8_t* stacked, uint8_t* out, int64_t k,
                       int64_t row_bytes, int64_t numel, bool aligned,
                       cudaStream_t s) {
  constexpr int G = W == 3 ? 3 : 4;
  int64_t blocks = ((row_bytes + G - 1) / G + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;   // grid-stride covers the rest
  packed_int_accumulate_kernel<W>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
          stacked, out, k, row_bytes, numel, aligned);
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

// stacked: (k, row_bytes) uint8 row-major; out: row_bytes uint8; numel: the
// code slots summed, ceil(numel*width/8) <= row_bytes; aligned: stacked
// and out start on 4-byte boundaries and row_bytes % 4 == 0. Returns the
// launch's cudaError_t.
int grace_packed_int_accumulate(const uint8_t* stacked, uint8_t* out,
                                int64_t k, int64_t row_bytes, int64_t numel,
                                int width, int aligned, void* stream) {
  if (k <= 0 || row_bytes <= 0 || numel < 0 ||
      row_bytes < (numel * width + 7) / 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 2) {
    launch_accumulate<2>(stacked, out, k, row_bytes, numel, aligned != 0, s);
  } else if (width == 3) {
    launch_accumulate<3>(stacked, out, k, row_bytes, numel, aligned != 0, s);
  } else if (width == 4) {
    launch_accumulate<4>(stacked, out, k, row_bytes, numel, aligned != 0, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

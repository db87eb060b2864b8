// The wire path's hop kernels for Hopper (sm_90a), plain C interface for
// ctypes: decode->accumulate and the packed integer accumulate (below).
//
// decode_accumulate replaces the Pallas TPU kernel
// grace_tpu/ops/pallas_wire.py decode_accumulate (:180, call :208): K packed
// payloads (a ring hop: K=2, recv then own; the grouped signSGD vote: K=1
// over the whole concatenated payload; a gathered boundary: K=W) -> one
// float32 partial, and must equal its plain PyTorch version
// (grace_tpu_torch/ops/wire.py) bit for bit.
//
// What bounds it on this card: bytes. It reads K * width/8 bytes and writes
// 4 bytes an element, so the write dominates (the vote's K=1 sign decode
// writes 32 bytes for each byte it reads); the decode is a handful of
// integer operations and one multiply-add a payload.
//
// What the design does about it (the mirror of quant.cu's
// quantize-and-pack): a warp takes rows of 128 output elements, kDecodeRows
// rows an iteration, lane l the four elements 4l..4l+3 of each, which it
// writes as one float4 (a warp's store covers 512 contiguous bytes; a
// ragged tail takes guarded scalar stores). The iteration's rows fill
// 16 * width * kDecodeRows contiguous bytes of each payload row; lanes
// 0..width*kDecodeRows-1 bring them in with one 16-byte load each (guarded
// byte loads where the payload rows do not start on 16 bytes, or at the end
// of a row), the next payload's load issued before this one is decoded,
// and stage them in the warp's slice of shared memory, from which each lane
// reads the word (two at width 3, where a piece straddles words) holding
// its 4*width-bit piece. The K scales are staged in shared memory once a
// block, kScaleTile at a time, so any K runs. The grid holds as many
// blocks as the SMs keep resident (resident.cuh) and strides over the
// rest; index math is 32-bit below 2^31 elements. Nothing full-width is
// staged: the unpacked codes and the decoded payloads never reach device
// memory.
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
//     (acc >= 0) * 2 - 1, ties to +1;
//   * codes from numel on are never decoded into the output, whatever the
//     payload bytes past ceil(numel*width/8) hold.

#include <cuda_runtime.h>
#include <stdint.h>

#include "resident.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr int kDecodeRows = 8;        // decode: rows of 128 outputs a warp iteration
constexpr int kScaleTile = 32;        // decode: scales staged at a time

// Bytes b..b+15 of a payload row, 0 from `limit` on: one 16-byte load where
// the row starts on 16 bytes and all 16 lie below `limit`, else byte loads.
template <typename Idx>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ row, Idx b,
                                        Idx limit, bool aligned) {
  if (aligned && b + 16 <= limit) {
    return *reinterpret_cast<const uint4*>(row + b);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (b + i < limit) w[i / 4] |= static_cast<uint32_t>(row[b + i]) << (8 * (i % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Code i (0..3) of a lane's piece, decoded: +-1 for the sign mask, else the
// sign-extended level times `scale`.
template <int W, bool SIGN>
__device__ __forceinline__ float decode(uint32_t piece, int i, float scale) {
  const uint32_t code = (piece >> (W * i)) & ((1u << W) - 1u);
  if (SIGN) return __fsub_rn(__fmul_rn(static_cast<float>(code), 2.0f), 1.0f);
  const int level =
      static_cast<int>(code) - (code >= (1u << (W - 1)) ? (1 << W) : 0);
  return __fmul_rn(scale, static_cast<float>(level));
}

// stacked: k_payloads rows, row k at stacked + k * row_stride, of which
// bytes [0, row_bytes) are read; out: numel floats, 16-byte aligned.
template <int W, bool SIGN, bool VOTE, typename Idx>
__global__ void __launch_bounds__(kThreads)
decode_accumulate_kernel(const uint8_t* __restrict__ stacked,
                         int64_t row_stride, const float* __restrict__ scales,
                         float* __restrict__ out, int k_payloads,
                         Idx row_bytes, Idx numel, int aligned) {
  constexpr int kVecs = W * kDecodeRows;         // 16-byte loads a chunk
  static_assert(kVecs <= 32, "a chunk is one 16-byte load a lane at most");
  __shared__ float s_scale[kScaleTile];
  // A warp's chunk, and one vector past it that the last width-3 piece's
  // second word may touch (its bits are shifted out).
  __shared__ uint4 s_chunk[kWarps][kVecs + 1];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const uint32_t* chunk = reinterpret_cast<const uint32_t*>(s_chunk[warp]);
  if (lane == 0) s_chunk[warp][kVecs] = make_uint4(0u, 0u, 0u, 0u);
  // Lane l's piece: 4W bits at bit 4W*l of a row, in word W*l/8 of it.
  const int word = (W * lane) / 8;
  const int shift = (4 * W * lane) % 32;
  const Idx rows = (numel + 127) / 128;
  const Idx groups = (rows + kDecodeRows - 1) / kDecodeRows;
  const Idx block_groups = (groups + kWarps - 1) / kWarps;
  const int tile = SIGN ? k_payloads : kScaleTile;   // sign: no scales
  const int tiles = (k_payloads + tile - 1) / tile;
  if (!SIGN && tiles == 1 && threadIdx.x < k_payloads) {
    s_scale[threadIdx.x] = scales[threadIdx.x];
  }
  __syncthreads();
  // The loop runs alike for every warp of the block (its barriers need it).
  for (Idx bg = blockIdx.x; bg < block_groups; bg += gridDim.x) {
    const Idx r0 = (bg * kWarps + warp) * kDecodeRows;
    const bool live = r0 < rows;                 // the same for the warp
    const Idx b0 = r0 * (16 * W) + 16 * lane;    // this lane's chunk bytes
    float4 acc[kDecodeRows];
    for (int t = 0; t < tiles; ++t) {
      const int k0 = t * tile;
      const int kn = k_payloads - k0 < tile ? k_payloads - k0 : tile;
      if (tiles > 1) {
        __syncthreads();                         // the last tile is read
        if (threadIdx.x < kn) s_scale[threadIdx.x] = scales[k0 + threadIdx.x];
        __syncthreads();
      }
      if (!live) continue;
      uint4 next = make_uint4(0u, 0u, 0u, 0u);
      if (lane < kVecs) {
        next = load16(stacked + k0 * row_stride, b0, row_bytes, aligned != 0);
      }
      for (int kk = 0; kk < kn; ++kk) {
        const uint4 cur = next;
        if (kk + 1 < kn && lane < kVecs) {
          next = load16(stacked + (k0 + kk + 1) * row_stride, b0, row_bytes,
                        aligned != 0);
        }
        if (lane < kVecs) s_chunk[warp][lane] = cur;
        __syncwarp();
        const float scale = SIGN ? 1.0f : s_scale[kk];
        const bool first = k0 + kk == 0;
#pragma unroll
        for (int j = 0; j < kDecodeRows; ++j) {
          const int g = 4 * W * j + word;
          const uint32_t piece =
              W == 3 ? __funnelshift_r(chunk[g], chunk[g + 1], shift)
                     : chunk[g] >> shift;
          const float4 v = make_float4(decode<W, SIGN>(piece, 0, scale),
                                       decode<W, SIGN>(piece, 1, scale),
                                       decode<W, SIGN>(piece, 2, scale),
                                       decode<W, SIGN>(piece, 3, scale));
          acc[j] = first ? v
                         : make_float4(__fadd_rn(acc[j].x, v.x),
                                       __fadd_rn(acc[j].y, v.y),
                                       __fadd_rn(acc[j].z, v.z),
                                       __fadd_rn(acc[j].w, v.w));
        }
        __syncwarp();                            // the chunk is read
      }
    }
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < kDecodeRows; ++j) {
      const Idx e = (r0 + j) * 128 + 4 * lane;
      if (e >= numel) break;                     // later rows are past it too
      float4 a = acc[j];
      if (VOTE) {
        a = make_float4(a.x >= 0.0f ? 1.0f : -1.0f, a.y >= 0.0f ? 1.0f : -1.0f,
                        a.z >= 0.0f ? 1.0f : -1.0f, a.w >= 0.0f ? 1.0f : -1.0f);
      }
      if (e + 4 <= numel) {
        *reinterpret_cast<float4*>(out + e) = a;
      } else {
        out[e] = a.x;
        if (e + 1 < numel) out[e + 1] = a.y;
        if (e + 2 < numel) out[e + 2] = a.z;
      }
    }
  }
}

template <int W, bool SIGN, bool VOTE, typename Idx>
cudaError_t launch_decode(const uint8_t* stacked, int64_t row_stride,
                          const float* scales, float* out, int k,
                          int64_t row_bytes, int64_t numel, cudaStream_t s) {
  static unsigned int cache[resident::kDevices] = {};   // this kernel's
  const int64_t rows = (numel + 127) / 128;
  const int64_t groups = (rows + kDecodeRows - 1) / kDecodeRows;
  unsigned int grid = 0;
  const cudaError_t err = resident::grid(
      decode_accumulate_kernel<W, SIGN, VOTE, Idx>, kThreads, cache,
      (groups + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return err;
  // Bytes past the rows' last whole row of codes are never decoded.
  const int64_t limit = row_bytes < rows * 16 * W ? row_bytes : rows * 16 * W;
  const int aligned = reinterpret_cast<uintptr_t>(stacked) % 16 == 0 &&
                      (k == 1 || row_stride % 16 == 0);
  decode_accumulate_kernel<W, SIGN, VOTE, Idx><<<grid, kThreads, 0, s>>>(
      stacked, row_stride, scales, out, k, static_cast<Idx>(limit),
      static_cast<Idx>(numel), aligned);
  return cudaGetLastError();
}

template <int W, bool SIGN, bool VOTE>
cudaError_t launch(const uint8_t* stacked, int64_t row_stride,
                   const float* scales, float* out, int k, int64_t row_bytes,
                   int64_t numel, cudaStream_t s) {
  if (numel < (int64_t{1} << 31)) {
    return launch_decode<W, SIGN, VOTE, uint32_t>(stacked, row_stride, scales,
                                                  out, k, row_bytes, numel, s);
  }
  return launch_decode<W, SIGN, VOTE, uint64_t>(stacked, row_stride, scales,
                                                out, k, row_bytes, numel, s);
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

// stacked: k rows of row_bytes >= ceil(numel*width/8) uint8, row i at
// stacked + i * row_stride (rows may overlap: they are only read); scales: k
// floats on the device; out: numel floats, 16-byte aligned. Returns the
// launch's cudaError_t.
int grace_decode_accumulate(const uint8_t* stacked, int64_t row_stride,
                            const float* scales, float* out, int64_t k,
                            int64_t row_bytes, int64_t numel, int width,
                            int sign, int vote, void* stream) {
  if (k <= 0 || k > INT32_MAX || numel <= 0 ||
      row_bytes < (numel * width + 7) / 8 || row_stride < 0 ||
      (sign && width != 1) ||
      (vote && !sign) || reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  cudaError_t err;
  if (sign && vote) {
    err = launch<1, true, true>(stacked, row_stride, scales, out, kk,
                                row_bytes, numel, s);
  } else if (sign) {
    err = launch<1, true, false>(stacked, row_stride, scales, out, kk,
                                 row_bytes, numel, s);
  } else if (width == 1) {
    err = launch<1, false, false>(stacked, row_stride, scales, out, kk,
                                  row_bytes, numel, s);
  } else if (width == 2) {
    err = launch<2, false, false>(stacked, row_stride, scales, out, kk,
                                  row_bytes, numel, s);
  } else if (width == 3) {
    err = launch<3, false, false>(stacked, row_stride, scales, out, kk,
                                  row_bytes, numel, s);
  } else if (width == 4) {
    err = launch<4, false, false>(stacked, row_stride, scales, out, kk,
                                  row_bytes, numel, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
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

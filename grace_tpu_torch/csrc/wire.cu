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
// The arithmetic. A field's two's-complement level is its code mod 2^W, and
// the plain version folds the integer sum with a floored mod 2^W, so the
// output is the per-field sum of the codes mod 2^W, wraps included: no
// unpack, no sign extension, no repack. With H the mask of every field's
// top bit, two bit streams add field by field as
//     s = ((a & ~H) + (b & ~H)) ^ ((a ^ b) & H),
// where the low W-1 bits of a field sum to at most 2^W - 2, so the one
// carry they make lands on the (cleared) top bit and never leaves the
// field. Code g is bits W*g .. W*g+W-1 of the row's little-endian stream
// at every width, so at W = 2 and 4 the fields tile each 32-bit word and the
// add is four operations a word. At W = 3 a field may straddle a word: the
// carry into word g is the carry out of word g-1's masked sum alone (the
// carry into word g-1 stays in its lowest field), so every word still adds
// on its own once it knows that bit, which a lane takes from the word
// below it in its vector, or with one shuffle from the lane below. After
// the last payload the bits from numel*W on are cleared (code slots from
// numel on, and bytes past ceil(numel*W/8), come out 0).
//
// What bounds it on this card: bytes. It reads K * row_bytes and writes
// row_bytes, at a few integer operations a word a payload.
//
// What the design does about it (the streaming design of decode_accumulate
// and quant.cu): a warp takes a chunk of V * 512 bytes of the output, lane
// l the 16-byte vectors l, l+32, ... of it (each load and store
// instruction of a warp covers 512 contiguous bytes): V = 1 at widths 2
// and 4, where more chunks keep more warps busy on a short row (a sweep of
// V = 1..4 on the H100 found 1 the fastest), and V = 3 at width 3, whose
// chunk of 1536 bytes holds whole fields. The K rows come as a table of row
// pointers passed by value as a __grid_constant__ parameter (as
// chunk_topk.cu's leaf table), so the callers' payloads are read where
// they lie, with no stacking copy; more than kMaxRows rows run as tiles
// that chain through the output (the modular sum is associative). Each
// lane loads a row's vectors before it adds the previous row's. A row that
// starts off the 16-byte grid (a reduce-scatter's rows lie row_bytes apart)
// is read with aligned 16-byte loads of the vectors that cover it, each
// lane's vector joined with the next lane's (a shuffle) and shifted into
// place with __funnelshift_r; lane 31 loads the one vector past the warp's
// chunk. An aligned load reads no byte outside the 16-byte block of a byte
// of the row, so it never leaves the row's allocation. The bytes it brings
// in from before the row are shifted out; those past the row's end reach
// only output bytes past it, which are never stored (a carry only moves
// up), and the one field that straddles the row's end lies past numel. The
// grid holds as many blocks as the SMs keep resident (resident.cuh) and
// strides over the rest; index math is 32-bit below 2^31 bytes.

constexpr int kMaxRows = 32;          // accumulate: rows a launch (a tile)
constexpr int kAccumVecs = 1;         // accumulate: 16-byte vectors a lane a
                                      // chunk at widths 2 and 4 (3 at width 3)

struct AccumRows {
  const uint8_t* row[kMaxRows];
};

// The mask of the fields' top bits in word g of a row's stream; at width 3
// it depends on g % 3 (bit 0 of word g is stream bit 32g = 2g mod 3).
template <int W>
__device__ __forceinline__ uint32_t top_bits(int g3) {
  if (W == 2) return 0xAAAAAAAAu;
  if (W == 4) return 0x88888888u;
  return g3 == 0 ? 0x24924924u : g3 == 1 ? 0x49249249u : 0x92492492u;
}

// The 16 bytes of (a, b) that start 4Q + s/8 bytes into a.
template <int Q>
__device__ __forceinline__ uint4 shift_down(const uint4& a, const uint4& b,
                                            int s) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  return make_uint4(__funnelshift_r(w[Q], w[Q + 1], s),
                    __funnelshift_r(w[Q + 1], w[Q + 2], s),
                    __funnelshift_r(w[Q + 2], w[Q + 3], s),
                    __funnelshift_r(w[Q + 3], w[Q + 4], s));
}

__device__ __forceinline__ uint4 realign(const uint4& a, const uint4& b,
                                         int m) {
  const int s = 8 * (m & 3);
  switch (m >> 2) {
    case 0: return shift_down<0>(a, b, s);
    case 1: return shift_down<1>(a, b, s);
    case 2: return shift_down<2>(a, b, s);
    default: return shift_down<3>(a, b, s);
  }
}

__device__ __forceinline__ uint4 shfl_vec(const uint4& v, int src) {
  return make_uint4(__shfl_sync(0xffffffffu, v.x, src),
                    __shfl_sync(0xffffffffu, v.y, src),
                    __shfl_sync(0xffffffffu, v.z, src),
                    __shfl_sync(0xffffffffu, v.w, src));
}

__device__ __forceinline__ uint4 shfl_down_vec(const uint4& v) {
  return make_uint4(__shfl_down_sync(0xffffffffu, v.x, 1),
                    __shfl_down_sync(0xffffffffu, v.y, 1),
                    __shfl_down_sync(0xffffffffu, v.z, 1),
                    __shfl_down_sync(0xffffffffu, v.w, 1));
}

// The 16-byte block at aligned address `at`, zeros where the block holds no
// byte of the row (it starts at or past `end`).
__device__ __forceinline__ uint4 load_block(const uint8_t* at,
                                            const uint8_t* end) {
  return at < end ? *reinterpret_cast<const uint4*>(at)
                  : make_uint4(0u, 0u, 0u, 0u);
}

// Row p's raw blocks for a lane whose first vector is at byte b0 of the
// chunk: the aligned blocks at the lane's V vectors of the row's aligned
// base and, for lane 31 of a row off the 16-byte grid, the block past the
// chunk. Returns the row's offset from the grid, p % 16.
template <int V, typename Idx>
__device__ __forceinline__ int load_row(const uint8_t* p, Idx b0, Idx row_bytes,
                                        int lane, uint4 (&raw)[V + 1]) {
  const int m = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const uint8_t* base = p - m;
  const uint8_t* end = p + row_bytes;
#pragma unroll
  for (int j = 0; j < V; ++j) raw[j] = load_block(base + b0 + 512 * j, end);
  raw[V] = m != 0 && lane == 31 ? load_block(base + b0 + 512 * V - 496, end)
                                : make_uint4(0u, 0u, 0u, 0u);
  return m;
}

// A warp's chunk is V * 512 bytes; lane l owns its 16-byte vectors l,
// l + 32, ..., l + 32(V-1).
template <int W, int V, typename Idx>
__global__ void __launch_bounds__(kThreads)
packed_int_accumulate_kernel(const __grid_constant__ AccumRows tab,
                             int k_rows, uint8_t* out, Idx row_bytes,
                             Idx keep_bytes, int keep_tail) {
  constexpr int kChunk = 512 * V;
  static_assert(W != 3 || V % 3 == 0, "a chunk holds whole 3-bit fields");
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const Idx chunks = (row_bytes + kChunk - 1) / kChunk;
  // The fields' top bits of the lane's words: vector v = 32Vc + l + 32j
  // holds words 4v..4v+3, and 4v + i = l + 2j + i (mod 3) when 3 | V.
  uint32_t h[V][4];
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) h[j][i] = top_bits<W>((lane + 2 * j + i) % 3);
  }
  for (Idx c = static_cast<Idx>(blockIdx.x) * kWarps + warp; c < chunks;
       c += static_cast<Idx>(gridDim.x) * kWarps) {
    const Idx b0 = c * kChunk + 16 * lane;
    uint4 raw[V + 1];
    uint4 acc[V];
    int m = load_row<V>(tab.row[0], b0, row_bytes, lane, raw);
    for (int r = 0; r < k_rows; ++r) {
      uint4 cur[V + 1];
#pragma unroll
      for (int j = 0; j <= V; ++j) cur[j] = raw[j];
      const int mr = m;
      if (r + 1 < k_rows) {                        // in flight while we add
        m = load_row<V>(tab.row[r + 1], b0, row_bytes, lane, raw);
      }
      uint4 v[V];
      if (mr == 0) {                               // the same for the warp
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = cur[j];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          // The block after lane l's vector j: lane l+1's, or for lane 31
          // lane 0's vector j+1 (the block past the chunk after the last).
          const uint4 down = shfl_down_vec(cur[j]);
          const uint4 wrap = j + 1 < V ? shfl_vec(cur[j + 1 < V ? j + 1 : j], 0)
                                       : cur[V];
          v[j] = realign(cur[j], lane == 31 ? wrap : down, mr);
        }
      }
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = v[j];
        continue;
      }
      uint32_t t[V][4], x[V][4], cout[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const uint32_t a[4] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
        const uint32_t b[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
        uint32_t co[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t la = a[i] & ~h[j][i];
          t[j][i] = la + (b[i] & ~h[j][i]);
          co[i] = W == 3 ? static_cast<uint32_t>(t[j][i] < la) : 0u;
          x[j][i] = (a[i] ^ b[i]) & h[j][i];
        }
        // A word's carry out needs no carry in (see above), so the carries
        // into the words above come after.
#pragma unroll
        for (int i = 1; i < 4; ++i) t[j][i] += co[i - 1];
        cout[j] = co[3];
      }
      if (W == 3) {
        // The carry into each vector's word 0: lane l-1's top word, or for
        // lane 0 lane 31's previous vector (0 at the chunk's start, which
        // lies on a field boundary).
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const uint32_t up = __shfl_up_sync(0xffffffffu, cout[j], 1);
          const uint32_t wrap =
              __shfl_sync(0xffffffffu, cout[j > 0 ? j - 1 : 0], 31);
          t[j][0] += lane != 0 ? up : j > 0 ? wrap : 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[j] = make_uint4(t[j][0] ^ x[j][0], t[j][1] ^ x[j][1],
                            t[j][2] ^ x[j][2], t[j][3] ^ x[j][3]);
      }
    }
    // Clear the bits from numel*W on and store: a 16-byte store a vector,
    // guarded byte stores at a ragged end.
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const Idx b = b0 + 512 * j;
      if (b >= row_bytes) break;                  // later vectors are past it
      uint32_t a[4] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Idx wb = b + 4 * i;
        if (wb + 4 > keep_bytes) {
          const int bits = wb > keep_bytes
                               ? 0
                               : 8 * static_cast<int>(keep_bytes - wb) +
                                     keep_tail;
          a[i] &= (1u << bits) - 1u;              // bits <= 31 here
        }
      }
      if (b + 16 <= row_bytes) {
        *reinterpret_cast<uint4*>(out + b) = make_uint4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (b + i < row_bytes) {
            out[b + i] = static_cast<uint8_t>(a[i / 4] >> (8 * (i % 4)));
          }
        }
      }
    }
  }
}

template <int W, int V, typename Idx>
cudaError_t launch_accumulate(const AccumRows& tab, int k, uint8_t* out,
                              int64_t row_bytes, int64_t numel,
                              cudaStream_t s) {
  static unsigned int cache[resident::kDevices] = {};   // this kernel's
  const int64_t chunks = (row_bytes + 512 * V - 1) / (512 * V);
  unsigned int grid = 0;
  const cudaError_t err = resident::grid(
      packed_int_accumulate_kernel<W, V, Idx>, kThreads, cache,
      (chunks + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return err;
  const int64_t keep_bits = numel * W;
  packed_int_accumulate_kernel<W, V, Idx><<<grid, kThreads, 0, s>>>(
      tab, k, out, static_cast<Idx>(row_bytes),
      static_cast<Idx>(keep_bits / 8), static_cast<int>(keep_bits % 8));
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_accumulate(const AccumRows& tab, int k, uint8_t* out,
                              int64_t row_bytes, int64_t numel,
                              cudaStream_t s) {
  constexpr int V = W == 3 ? 3 : kAccumVecs;
  // 32-bit offsets while every lane's vector offset stays below 2^31.
  if (row_bytes < (int64_t{1} << 31) - 2 * 512 * V) {
    return launch_accumulate<W, V, uint32_t>(tab, k, out, row_bytes, numel,
                                             s);
  }
  return launch_accumulate<W, V, uint64_t>(tab, k, out, row_bytes, numel, s);
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

// rows: a host array of k <= kMaxRows device pointers, each to row_bytes
// uint8 at any alignment (rows may overlap one another, and rows[0] may be
// out itself: a lane reads its own bytes of it before it writes them); out:
// row_bytes uint8, 16-byte aligned; numel: the code slots summed,
// ceil(numel*width/8) <= row_bytes. One launch. Returns the launch's
// cudaError_t.
int grace_packed_int_accumulate(const uint8_t* const* rows, int64_t k,
                                uint8_t* out, int64_t row_bytes,
                                int64_t numel, int width, void* stream) {
  if (k <= 0 || k > kMaxRows || row_bytes <= 0 || numel < 0 ||
      row_bytes < (numel * width + 7) / 8 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AccumRows tab = {};
  for (int64_t i = 0; i < k; ++i) tab.row[i] = rows[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  cudaError_t err;
  if (width == 2) {
    err = launch_accumulate<2>(tab, kk, out, row_bytes, numel, s);
  } else if (width == 3) {
    err = launch_accumulate<3>(tab, kk, out, row_bytes, numel, s);
  } else if (width == 4) {
    err = launch_accumulate<4>(tab, kk, out, row_bytes, numel, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"

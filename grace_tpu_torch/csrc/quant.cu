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
// width/8; sign-pack reads 2 or 4 and writes 1/8, and with error feedback
// also reads and writes a float32 residual (12.125 bytes an element). A few
// dozen integer and float operations an element (the hash, the level, the
// pack) stay under the card's operations-per-byte ratio, but not by much
// for quantize-and-pack, so its packing costs few instructions.
//
// What the designs do about it:
//   * quantize and quantize-and-pack share one loop: a warp takes rows of
//     128 elements, lane l the four elements 4l..4l+3 of a row through one
//     16-byte load (four guarded scalar loads where the input does not
//     start on a 16-byte boundary, as a ring shard view at any element
//     offset may not, or past n). Each warp iteration loads kPackRows rows
//     before it uses any, so 64 bytes a lane are in flight; the grid holds
//     as many blocks as the SMs keep resident (resident.cuh) and strides
//     over the rest. Index math is 32-bit below 2^31 elements, the hash
//     block split by shift and mask, and the encode scale is computed once
//     a block into shared memory.
//   * quantize stores lane l's four levels as one 4-byte (int8) or 8-byte
//     (int16) word, so a warp's store covers 128 or 256 contiguous bytes;
//     a ragged tail takes guarded scalar stores.
//   * quantize-and-pack: a lane packs its 4 codes into 4*width bits; a
//     row's 4*width words are then assembled by lanes 0..4*width-1 from
//     their neighbours' bits with warp shuffles and stored as whole 32-bit
//     words (at width 3 a code may straddle two words).
//   * sign-pack: one launch over a table of up to kMaxLeaves leaves, passed
//     by value as a __grid_constant__ parameter, with a tile prefix and a
//     binary-search leaf lookup (as csrc/chunk_topk.cu does). A block takes
//     kSignTileWords 32-bit words of one leaf, a warp kSignWarpWords of
//     them: lane l reads element 32w + l of word w (a warp reads 128
//     consecutive bytes of float32), all of the warp's loads issued before
//     any is used, and one __ballot_sync forms the word (bit l is lane l's
//     element: the LSB-first layout). Lanes 0..kSignWarpWords-1 store the
//     words. With a residual the same pass compensates, packs and writes the
//     new residual, so linear error feedback costs no pass of its own.
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
//     (code + 2^width), LSB-first; 3-bit codes form one bitstream; codes
//     past n are 0 (the Pallas kernel's zero padding);
//   * sign: comp = beta*r + gamma*g with each product rounded before the add
//     (ResidualMemory.compensate), comp = g without a residual; the bit is
//     comp >= 0 (-0.0 gives 1, NaN gives 0); the new residual is
//     comp - (bit ? 1 : -1) (ResidualMemory.update: NaN stays NaN, -0.0
//     gives -1); bits past n are 0.
//
// Payload layout of the grouped sign-pack: leaf l's bits start at its byte
// offset, a multiple of 16, and fill ceil(n/128) * 16 bytes; its wire
// payload is the first ceil(n/8) of them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "resident.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kHashBlock = 64 * 256;
constexpr int kHashShift = 14;                // kHashBlock = 1 << kHashShift
constexpr int kPackRows = 4;                  // quantize(-and-pack): rows a warp iteration
constexpr int kMaxLeaves = 256;               // sign-pack: leaves a launch
constexpr int kSignWarpWords = 16;            // sign-pack: words a warp
constexpr int kSignTileWords = kWarps * kSignWarpWords;   // words a block
constexpr int kSignWords = 7;                 // host table row: int64 words

__device__ __forceinline__ uint32_t hash_mix(uint32_t seed, uint32_t local,
                                             uint32_t block) {
  uint32_t h = local * 2654435761u;
  h += seed + block;
  h ^= h >> 16;
  h *= 0x45D9F3Bu;
  h ^= h >> 16;
  h *= 0x45D9F3Bu;
  return h ^ (h >> 16);
}

// The random bits of flat element e: its local counter in the Pallas
// (64, 256) hash block and the block's index, by mask and shift.
template <typename Idx>
__device__ __forceinline__ uint32_t element_bits(uint32_t seed, Idx e) {
  return hash_mix(
      seed, static_cast<uint32_t>(e) & static_cast<uint32_t>(kHashBlock - 1),
      static_cast<uint32_t>(e >> kHashShift));
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

// Elements e..e+3 (0.0 past n): one 16-byte load where x is 16-byte aligned
// and all four are real, else four guarded scalar loads.
template <typename Idx>
__device__ __forceinline__ float4 load4(const float* __restrict__ x, Idx e,
                                        Idx n, bool aligned) {
  if (aligned && e + 4 <= n) return *reinterpret_cast<const float4*>(x + e);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (e < n) v.x = x[e];
  if (e + 1 < n) v.y = x[e + 1];
  if (e + 2 < n) v.z = x[e + 2];
  if (e + 3 < n) v.w = x[e + 3];
  return v;
}

// -- quantize -----------------------------------------------------------------

// The saturated int level of element e holding v.
template <typename Idx>
__device__ __forceinline__ int quantize_level(float v, Idx e, float scale,
                                              uint32_t seed, float lo,
                                              float hi) {
  const float s = signed_level(v, scale, element_bits(seed, e));
  return static_cast<int>(fminf(fmaxf(s, lo), hi));
}

// Levels of elements e..e+3 to out: one 4-byte (int8) or 8-byte (int16)
// store where all four are real (out is aligned to the word; e is a
// multiple of 4), else guarded scalar stores.
template <typename T, typename Idx>
__device__ __forceinline__ void store4(T* __restrict__ out, Idx e, Idx n,
                                       int a, int b, int c, int d) {
  if (e + 4 <= n) {
    if (sizeof(T) == 1) {
      *reinterpret_cast<uint32_t*>(out + e) =
          (static_cast<uint32_t>(a) & 0xFFu) |
          (static_cast<uint32_t>(b) & 0xFFu) << 8 |
          (static_cast<uint32_t>(c) & 0xFFu) << 16 |
          static_cast<uint32_t>(d) << 24;
    } else {
      *reinterpret_cast<uint2*>(out + e) = make_uint2(
          (static_cast<uint32_t>(a) & 0xFFFFu) | static_cast<uint32_t>(b) << 16,
          (static_cast<uint32_t>(c) & 0xFFFFu) | static_cast<uint32_t>(d) << 16);
    }
    return;
  }
  if (e < n) out[e] = static_cast<T>(a);
  if (e + 1 < n) out[e + 1] = static_cast<T>(b);
  if (e + 2 < n) out[e + 2] = static_cast<T>(c);
}

// out: n levels of type T, its start aligned to 4 * sizeof(T) bytes.
template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
quantize_stochastic_kernel(const float* __restrict__ x, const float* norm,
                           T* __restrict__ out, Idx n, int q, uint32_t seed,
                           float lo, float hi, int aligned) {
  __shared__ float s_scale;
  if (threadIdx.x == 0) s_scale = encode_scale(norm, q);
  __syncthreads();
  const float scale = s_scale;
  const int lane = threadIdx.x & 31;
  const Idx rows = (n + 127) / 128;
  const Idx groups = (rows + kPackRows - 1) / kPackRows;
  const Idx warps = static_cast<Idx>(gridDim.x) * kWarps;
  for (Idx gi = static_cast<Idx>(blockIdx.x) * kWarps + threadIdx.x / 32;
       gi < groups; gi += warps) {
    const Idx r0 = gi * kPackRows;
    float4 v[kPackRows];
#pragma unroll
    for (int k = 0; k < kPackRows; ++k) {
      v[k] = load4(x, (r0 + k) * 128 + 4 * lane, n, aligned != 0);
    }
#pragma unroll
    for (int k = 0; k < kPackRows; ++k) {
      const Idx e = (r0 + k) * 128 + 4 * lane;
      if (e >= n) break;                         // later rows are past n too
      store4(out, e, n, quantize_level(v[k].x, e, scale, seed, lo, hi),
             quantize_level(v[k].y, e + 1, scale, seed, lo, hi),
             quantize_level(v[k].z, e + 2, scale, seed, lo, hi),
             quantize_level(v[k].w, e + 3, scale, seed, lo, hi));
    }
  }
}

// Launches `kernel`, a kernel of the rows of 128 elements of x (quantize,
// quantize-and-pack), over n elements on a resident grid; `cache` holds
// its resident blocks by device.
template <typename Kernel, typename... Args>
cudaError_t launch_rows(Kernel kernel, unsigned int* cache, int64_t n,
                        cudaStream_t s, Args... args) {
  const int64_t groups = ((n + 127) / 128 + kPackRows - 1) / kPackRows;
  unsigned int grid = 0;
  const cudaError_t err = resident::grid(kernel, kThreads, cache,
                                         (groups + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, 0, s>>>(args...);
  return cudaGetLastError();
}

inline int aligned16(const float* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <typename T, typename Idx>
cudaError_t launch_quantize(const float* x, const float* norm, T* out,
                            int64_t n, int q, uint32_t seed, float lo,
                            float hi, cudaStream_t s) {
  static unsigned int cache[resident::kDevices] = {};   // this kernel's
  return launch_rows(quantize_stochastic_kernel<T, Idx>, cache, n, s, x, norm,
                     out, static_cast<Idx>(n), q, seed, lo, hi, aligned16(x));
}

template <typename T>
cudaError_t launch_quantize_type(const float* x, const float* norm, T* out,
                                 int64_t n, int q, uint32_t seed, float lo,
                                 float hi, cudaStream_t s) {
  if (n < (int64_t{1} << 31)) {
    return launch_quantize<T, uint32_t>(x, norm, out, n, q, seed, lo, hi, s);
  }
  return launch_quantize<T, uint64_t>(x, norm, out, n, q, seed, lo, hi, s);
}

// -- quantize-and-pack --------------------------------------------------------

// The W-bit two's-complement code of element e holding v (0 past n).
template <int W, typename Idx>
__device__ __forceinline__ uint32_t pack_code(float v, Idx e, Idx n,
                                              float scale, float qf,
                                              uint32_t seed) {
  const float s =
      fminf(fmaxf(signed_level(v, scale, element_bits(seed, e)), -qf), qf);
  // Masking the int's two's complement is code + 2^W for a negative level.
  const uint32_t code = static_cast<uint32_t>(static_cast<int>(s)) &
                        ((1u << W) - 1u);
  return e < n ? code : 0u;
}

// Word `lane` of a 128-code row (lanes 0..4W-1; the others get a word they
// do not store), from every lane's 4W-bit piece at bit 4W*lane of the row.
template <int W>
__device__ __forceinline__ uint32_t row_word(uint32_t piece, int lane) {
  constexpr int P = 4 * W;                       // bits a lane
  constexpr int kSources = P == 12 ? 4 : 32 / P; // lanes a word touches
  const int j = lane < 4 * W ? lane : 0;
  const int first = (32 * j) / P;
  uint32_t word = 0;
#pragma unroll
  for (int s = 0; s < kSources; ++s) {
    const int src = first + s;
    const uint32_t p = __shfl_sync(0xffffffffu, piece, src & 31);
    const int off = P * src - 32 * j;            // its bit in the word
    if (src < 32 && off < 32) word |= off >= 0 ? p << off : p >> -off;
  }
  return word;
}

// out: rows * 4W words (rows = ceil(n / 128)), row r's at 4W*r.
template <int W, typename Idx>
__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ x, const float* norm,
                     uint32_t* __restrict__ out, Idx n, int q, uint32_t seed,
                     int aligned) {
  __shared__ float s_scale;
  if (threadIdx.x == 0) s_scale = encode_scale(norm, q);
  __syncthreads();
  const float scale = s_scale;
  const float qf = static_cast<float>(q);
  const int lane = threadIdx.x & 31;
  const Idx rows = (n + 127) / 128;
  const Idx groups = (rows + kPackRows - 1) / kPackRows;
  const Idx warps = static_cast<Idx>(gridDim.x) * kWarps;
  for (Idx gi = static_cast<Idx>(blockIdx.x) * kWarps + threadIdx.x / 32;
       gi < groups; gi += warps) {
    const Idx r0 = gi * kPackRows;
    float4 v[kPackRows];
#pragma unroll
    for (int k = 0; k < kPackRows; ++k) {
      v[k] = load4(x, (r0 + k) * 128 + 4 * lane, n, aligned != 0);
    }
#pragma unroll
    for (int k = 0; k < kPackRows; ++k) {
      const Idx r = r0 + k;
      if (r >= rows) break;                      // the same for the warp
      const Idx e = r * 128 + 4 * lane;
      const uint32_t piece =
          pack_code<W>(v[k].x, e, n, scale, qf, seed) |
          pack_code<W>(v[k].y, e + 1, n, scale, qf, seed) << W |
          pack_code<W>(v[k].z, e + 2, n, scale, qf, seed) << (2 * W) |
          pack_code<W>(v[k].w, e + 3, n, scale, qf, seed) << (3 * W);
      const uint32_t word = row_word<W>(piece, lane);
      if (lane < 4 * W) out[r * (4 * W) + lane] = word;
    }
  }
}

template <int W, typename Idx>
cudaError_t launch_pack(const float* x, const float* norm, uint32_t* out,
                        int64_t n, int q, uint32_t seed, cudaStream_t s) {
  static unsigned int cache[resident::kDevices] = {};   // this kernel's
  return launch_rows(quantize_pack_kernel<W, Idx>, cache, n, s, x, norm, out,
                     static_cast<Idx>(n), q, seed, aligned16(x));
}

template <int W>
cudaError_t launch_pack_width(const float* x, const float* norm, uint32_t* out,
                              int64_t n, int q, uint32_t seed,
                              cudaStream_t s) {
  if (n < (int64_t{1} << 31)) {
    return launch_pack<W, uint32_t>(x, norm, out, n, q, seed, s);
  }
  return launch_pack<W, uint64_t>(x, norm, out, n, q, seed, s);
}

// -- sign-pack ---------------------------------------------------------------

struct SignLeaf {
  const void* g;
  const float* r;        // nullptr: no error feedback, comp = g
  float* out_r;          // the new residual; may alias r
  int64_t n;
  int64_t word0;         // its first payload word
  int32_t dtype;         // 0 = float32, 1 = bfloat16, 2 = float16
  int32_t pad;
};

struct SignTable {
  int32_t tile0[kMaxLeaves + 1];
  int32_t num_leaves;
  SignLeaf leaf[kMaxLeaves];
};

// The leaf whose tiles hold `tile`: the last l with tile0[l] <= tile.
__device__ __forceinline__ int find_leaf(const int32_t* tile0, int num_leaves,
                                         int tile) {
  int lo = 0, hi = num_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile0[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float load_as_float(const void* p, int64_t e,
                                               int dtype) {
  if (dtype == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[e]);
  if (dtype == 2) return __half2float(static_cast<const __half*>(p)[e]);
  return static_cast<const float*>(p)[e];
}

__global__ void __launch_bounds__(kThreads)
sign_pack_kernel(const __grid_constant__ SignTable tab,
                 uint32_t* __restrict__ payload, float beta, float gamma) {
  const int tile = blockIdx.x;
  const int li = find_leaf(tab.tile0, tab.num_leaves, tile);
  const SignLeaf& L = tab.leaf[li];
  const int lane = threadIdx.x & 31;
  const int64_t n = L.n;
  const int64_t words = (n + 127) / 128 * 4;     // the segment, to 16 bytes
  const int64_t w0 = static_cast<int64_t>(tile - tab.tile0[li]) *
                     kSignTileWords + (threadIdx.x / 32) * kSignWarpWords;
  if (w0 >= words) return;                       // the whole warp
  float c[kSignWarpWords];
#pragma unroll
  for (int j = 0; j < kSignWarpWords; ++j) {
    const int64_t e = (w0 + j) * 32 + lane;
    c[j] = e < n ? load_as_float(L.g, e, L.dtype) : 0.0f;
  }
  const float* r = L.r;
  if (r != nullptr) {
    float rv[kSignWarpWords];
#pragma unroll
    for (int j = 0; j < kSignWarpWords; ++j) {
      const int64_t e = (w0 + j) * 32 + lane;
      rv[j] = e < n ? r[e] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kSignWarpWords; ++j) {
      c[j] = __fadd_rn(__fmul_rn(beta, rv[j]), __fmul_rn(gamma, c[j]));
    }
  }
  uint32_t mine = 0;
#pragma unroll
  for (int j = 0; j < kSignWarpWords; ++j) {
    if (w0 + j >= words) break;                  // the same for the warp
    const int64_t e = (w0 + j) * 32 + lane;
    const bool live = e < n;
    const bool bit = live && c[j] >= 0.0f;
    const uint32_t word = __ballot_sync(0xffffffffu, bit);
    if (lane == j) mine = word;
    if (r != nullptr && live) {
      L.out_r[e] = __fsub_rn(c[j], bit ? 1.0f : -1.0f);
    }
  }
  if (lane < kSignWarpWords && w0 + lane < words) {
    payload[L.word0 + w0 + lane] = mine;
  }
}

}  // namespace

extern "C" {

// Each returns the cudaError_t (0 = success) of its launch.
// out: n int8 (out_int16 = 0) or int16 levels, 4-byte or 8-byte aligned.
int grace_quantize_stochastic(const float* x, const float* norm, void* out,
                              int64_t n, int q, uint32_t seed, int out_int16,
                              void* stream) {
  if (n <= 0 || q < 1 ||
      reinterpret_cast<uintptr_t>(out) % (out_int16 ? 8 : 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_int16) {
    err = launch_quantize_type(x, norm, static_cast<int16_t*>(out), n, q,
                               seed, -32768.0f, 32767.0f, s);
  } else {
    err = launch_quantize_type(x, norm, static_cast<int8_t*>(out), n, q, seed,
                               -128.0f, 127.0f, s);
  }
  return static_cast<int>(err);
}

// out: ceil(n / 128) * 16 * width bytes, 4-byte aligned (whole words of
// whole rows; the wire payload is the first ceil(n * width / 8) of them).
int grace_quantize_pack_stochastic(const float* x, const float* norm,
                                   uint8_t* out, int64_t n, int q,
                                   uint32_t seed, int width, void* stream) {
  if (n <= 0 || width < 2 || width > 4 || q < 1 ||
      q > (1 << (width - 1)) - 1 || reinterpret_cast<uintptr_t>(out) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* words = reinterpret_cast<uint32_t*>(out);
  cudaError_t err;
  if (width == 2) {
    err = launch_pack_width<2>(x, norm, words, n, q, seed, s);
  } else if (width == 3) {
    err = launch_pack_width<3>(x, norm, words, n, q, seed, s);
  } else {
    err = launch_pack_width<4>(x, norm, words, n, q, seed, s);
  }
  return static_cast<int>(err);
}

// leaves: num_leaves rows of kSignWords int64 words
//   (g, r or 0, out_r or 0, n, dtype, byte offset, first tile);
// a residual needs a float32 gradient; byte offsets are multiples of 16.
int grace_sign_pack(const int64_t* leaves, int num_leaves, uint8_t* payload,
                    float beta, float gamma, void* stream) {
  if (num_leaves < 1 || num_leaves > kMaxLeaves ||
      reinterpret_cast<uintptr_t>(payload) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SignTable tab;                   // copied into the launch's parameters
  tab.num_leaves = num_leaves;
  int64_t tiles = 0;
  for (int l = 0; l < num_leaves; ++l) {
    const int64_t* w = leaves + static_cast<int64_t>(l) * kSignWords;
    const int64_t n = w[3], dtype = w[4], boff = w[5];
    if (n < 1 || dtype < 0 || dtype > 2 || boff < 0 || boff % 16 ||
        w[6] != tiles || ((w[1] != 0) != (w[2] != 0)) ||
        (w[1] != 0 && dtype != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    SignLeaf& leaf = tab.leaf[l];
    leaf.g = reinterpret_cast<const void*>(w[0]);
    leaf.r = reinterpret_cast<const float*>(w[1]);
    leaf.out_r = reinterpret_cast<float*>(w[2]);
    leaf.n = n;
    leaf.word0 = boff / 4;
    leaf.dtype = static_cast<int32_t>(dtype);
    leaf.pad = 0;
    tab.tile0[l] = static_cast<int32_t>(tiles);
    tiles += ((n + 127) / 128 * 4 + kSignTileWords - 1) / kSignTileWords;
    if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  tab.tile0[num_leaves] = static_cast<int32_t>(tiles);
  sign_pack_kernel<<<static_cast<unsigned int>(tiles), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      tab, reinterpret_cast<uint32_t*>(payload), beta, gamma);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

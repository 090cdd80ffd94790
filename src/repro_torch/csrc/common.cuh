// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every source exposes plain C entry points (no PyTorch headers) that the
// Python wrappers load with ctypes. Each entry launches on the stream it is
// given, allocates nothing and returns cudaGetLastError() after its launches,
// so a refused launch (too many threads, too much shared memory) reaches the
// wrapper, which raises.
//
// Packed layout (core/packing.py): plane i of a (P, k/8, o) uint8 tensor
// holds bit i of every code; bit j of byte (c, col) is row 8c + j, LSB first.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with the Python wrappers (kernels/_common.py::DTYPE_CODES)
enum DTypeCode : int { kF32 = 0, kBF16 = 1 };

constexpr int kMaxQ = 8;  // code planes the kernels take
constexpr int kCols = 4;  // adjacent output columns a thread owns

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Smallest batch-row tile in {1, 2, 4, 8} that covers min(B, 8) rows.
inline int row_tile(int B) {
  if (B >= 5) return 8;
  if (B >= 3) return 4;
  if (B >= 2) return 2;
  return 1;
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls f(Tag<A>{}, Tag<B>{}) for the element types named by two dtype
// codes; false if either code is unknown.
template <typename F>
bool dispatch_dtypes(int a, int b, F&& f) {
  if (a == kF32 && b == kF32) f(Tag<float>{}, Tag<float>{});
  else if (a == kF32 && b == kBF16) f(Tag<float>{}, Tag<__nv_bfloat16>{});
  else if (a == kBF16 && b == kF32) f(Tag<__nv_bfloat16>{}, Tag<float>{});
  else if (a == kBF16 && b == kBF16) f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
  else return false;
  return true;
}

// kCols group parameters at p as f32 (0 past the ragged edge).
__device__ __forceinline__ void load_scales4(const float* p, int valid, bool vec, float* s) {
  if (vec && valid == kCols) {
    float4 v = *reinterpret_cast<const float4*>(p);
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
    return;
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) s[c] = c < valid ? p[c] : 0.f;
}

__device__ __forceinline__ void load_scales4(const __nv_bfloat16* p, int valid, bool vec, float* s) {
  if (vec && valid == kCols) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = __bfloat162float(h[c]);
    return;
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) s[c] = c < valid ? __bfloat162float(p[c]) : 0.f;
}

// 16-byte copies from device to shared memory that complete in the
// background (cp.async), in commit groups; src_bytes < 16 zero-fills the
// rest of the 16 bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// Waits until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// By the kThreads threads of a block: `lines` rows of `width` elements,
// line i from src + src_off(i) to dst + i * width, zero past `valid`
// elements; 16-byte cp.async copies when vec.
template <int kThreads, typename T, typename F>
__device__ __forceinline__ void copy_lines(T* dst, const T* src, int lines, int width, int valid, bool vec,
                                           F src_off) {
  constexpr int kPer = 16 / sizeof(T);
  if (vec) {  // valid == width, every line 16-byte aligned
    const int per_line = width / kPer;
    for (int e = threadIdx.x; e < lines * per_line; e += kThreads) {
      const int i = e / per_line, c = (e % per_line) * kPer;
      cp_async16(dst + i * width + c, src + src_off(i) + c, 16);
    }
  } else {
    for (int e = threadIdx.x; e < lines * width; e += kThreads) {
      const int i = e / width, c = e % width;
      dst[i * width + c] = c < valid ? src[src_off(i) + c] : T(0.f);
    }
  }
}

// By the kThreads threads of a block: byte rows r0 .. r0 + nr - 1 (8 k
// each) of x rows b0 .. b0 + BT - 1 of x (B, k), xb bytes an element, to
// dst as [BT][stride_rows * 8] elements, zero past B; 16-byte pieces,
// cp.async copies when x is 16-byte aligned (k xb is a multiple of 16).
template <int kThreads, int BT>
__device__ __forceinline__ void copy_x_rows(uint8_t* dst, const void* x, int xb, int B, int b0, int k, int r0,
                                            int nr, int stride_rows) {
  const int xw = nr * 8 * xb / 16;  // 16-byte pieces of a row
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const uint8_t* const xg = static_cast<const uint8_t*>(x);
  for (int e = threadIdx.x; e < BT * xw; e += kThreads) {
    const int b = e / xw, c = e % xw;
    uint8_t* const d = dst + b * stride_rows * 8 * xb + c * 16;
    const bool in = b0 + b < B;
    const uint8_t* const src = xg + (static_cast<size_t>(in ? b0 + b : 0) * k + r0 * 8) * xb + c * 16;
    if (vec) {
      cp_async16(d, src, in ? 16 : 0);
    } else {
      for (int u = 0; u < 16; ++u) d[u] = in ? src[u] : 0;
    }
  }
}

// By the kThreads threads of a block whose kWarps warps wrote their sums to
// red as [warp][BT][BC] f32 and then met at a barrier: the sums in warp
// order go to out (B, o) at rows b0.., columns o0.. (valid of them), or, with
// more than one k-chunk (gridDim.z), to this chunk's (B, o) slab of scratch;
// then the last block of the column tile to arrive (an atomic ticket, one a
// (column tile, batch tile)) adds the chunks' partials in chunk order, writes
// out and resets its ticket. Nothing of that order depends on B, the row
// tile or the block that arrives last, so the result is bitwise the same
// run to run and a row equals the row called alone.
template <int kThreads, int kWarps, int BT, int BC>
__device__ __forceinline__ void finish_split(const float* red, float* __restrict__ out, float* __restrict__ scratch,
                                             unsigned* __restrict__ tickets, int B, int o, int b0, int o0,
                                             int valid) {
  __shared__ int s_last;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int splits = gridDim.z;
  float* const dst = splits > 1 ? scratch + static_cast<size_t>(blockIdx.z) * B * o : out;
  for (int e = threadIdx.x; e < BT * BC; e += kThreads) {
    const int b = e / BC, cl = e % BC;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[(w * BT + b) * BC + cl];
    if (b0 + b < B && cl < valid) dst[static_cast<size_t>(b0 + b) * o + o0 + cl] = sum;
  }
  if (splits == 1) return;

  // the last block of this column tile adds the chunks' partials in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&tickets[tile], 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = threadIdx.x; e < BT * BC; e += kThreads) {
    const int b = e / BC, cl = e % BC;
    if (b0 + b >= B || cl >= valid) continue;
    const size_t at = static_cast<size_t>(b0 + b) * o + o0 + cl;
    float sum = 0.f;
    for (int sp0 = 0; sp0 < splits; sp0 += 8) {  // 8 loads in flight, added in split order
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = sp0 + u < splits ? __ldcg(scratch + static_cast<size_t>(sp0 + u) * B * o + at) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (sp0 + u < splits) sum += v[u];
    }
    out[at] = sum;
  }
  if (threadIdx.x == 0) tickets[tile] = 0;  // ready for the next launch
}

// The q-bit code at bit position `shift` of q plane words: sum_i 2^i bit_i.
__device__ __forceinline__ uint32_t plane_code(const uint32_t* bits, int q, int shift) {
  uint32_t code = 0;
#pragma unroll
  for (int i = 0; i < kMaxQ; ++i)
    if (i < q) code |= ((bits[i] >> shift) & 1u) << i;
  return code;
}

// The uniform format's weight code * s + z in f32, rounded as the reference
// and the plain version round it: a product, then a sum (no fused FMA).
__device__ __forceinline__ float affine(uint32_t code, float s, float z) {
  return __fadd_rn(__fmul_rn(static_cast<float>(code), s), z);
}

}  // namespace repro

#define REPRO_EXPORT_ERROR_STRING                                \
  extern "C" const char* repro_cuda_error_string(int code) {     \
    return cudaGetErrorString(static_cast<cudaError_t>(code));   \
  }

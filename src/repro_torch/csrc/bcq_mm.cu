// bcq_mm: y (B, o) f32 = x (B, k) @ sum_i alpha_i * b_i, consumed packed.
//
// Replaces the TPU kernel src/repro/kernels/bcq_mm.py::bcq_mm_call
// (_bcq_mm_kernel, _unpack_block), which also serves bcq_mm_fused: the fused
// QKV / gate-up leaves are the same function over output-concatenated planes.
//
// What bounds it: at decode batch sizes (B <= 8) the packed planes and the
// group scales are read once and every byte feeds only 8*(q + B) flops per
// column, so the bound is the weight bytes over the card's memory rate
// (3.35 TB/s on an H100 SXM). At prefill row counts it turns compute bound
// (f32 FMAs on the CUDA cores).
//
// Design:
//  - A block owns 32 adjacent output columns and up to BT (<= 8) batch rows
//    and loops over all of k itself, so no two blocks write one output and
//    no atomics are needed (the deterministic stand-in for the paper's
//    atomicAdd, as in the TPU kernel's sequential accumulator).
//  - 8 column threads x 32 k-slices: a column thread owns 4 adjacent columns
//    and reads the 4 packed bytes of one byte row as one 32-bit load, so each
//    byte row of a slice is one 32-byte sector. Byte rows are dealt to the 32
//    slices round robin, which keeps 32 independent loads in flight per
//    column group at B = 1, when there are few blocks.
//  - x rows for a 1024-row k tile are staged in shared memory as f32.
//  - Bits expand to +-alpha in registers; w_eff is summed over the q planes
//    and accumulated into x * w_eff in f32 registers, never written out.
//  - The 32 slices' partial sums meet in shared memory and are added in a
//    fixed order, so results are bitwise reproducible run to run.
//  - Ragged o and B are masked in the kernel; no padding is needed.
#include "common.cuh"

namespace {

constexpr int TX = 8;               // column threads
constexpr int TY = 32;              // k slices
constexpr int COLS = 4;             // adjacent columns per column thread
constexpr int BLOCK_O = TX * COLS;  // output columns per block
constexpr int TILE_C = 128;         // byte rows (8 k each) per staged x tile
constexpr int MAXQ = 8;

__device__ __forceinline__ uint32_t load_bytes4(const uint8_t* p, int valid, bool vec) {
  if (vec && valid == COLS) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
  for (int c = 0; c < valid; ++c) v |= static_cast<uint32_t>(p[c]) << (8 * c);
  return v;
}

__device__ __forceinline__ void load_scales4(const float* p, int valid, bool vec, float* s) {
  if (vec && valid == COLS) {
    float4 v = *reinterpret_cast<const float4*>(p);
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
    return;
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) s[c] = c < valid ? p[c] : 0.f;
}

__device__ __forceinline__ void load_scales4(const __nv_bfloat16* p, int valid, bool vec, float* s) {
  if (vec && valid == COLS) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int c = 0; c < COLS; ++c) s[c] = __bfloat162float(h[c]);
    return;
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) s[c] = c < valid ? __bfloat162float(p[c]) : 0.f;
}

template <typename XT, typename ST, int BT>
__global__ void __launch_bounds__(TX * TY)
bcq_mm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
              const ST* __restrict__ scales, float* __restrict__ out,
              int B, int k, int o, int q, int g, int vec) {
  constexpr int XS = BT * TILE_C * 8;    // staged x tile (f32)
  constexpr int RS = TY * BT * BLOCK_O;  // per-slice partial sums (f32)
  __shared__ float smem[XS > RS ? XS : RS];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int o0 = blockIdx.x * BLOCK_O;
  const int col0 = o0 + tx * COLS;
  const int valid = min(COLS, o - col0);  // <= 0 for threads past the edge
  const int b0 = blockIdx.y * BT;
  const int kc = k / 8;
  const int G = k / g;

  float acc[BT][COLS];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[b][c] = 0.f;

  for (int tc0 = 0; tc0 < kc; tc0 += TILE_C) {
    const int nrows = min(TILE_C, kc - tc0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < XS; e += TX * TY) {
      const int b = e / (TILE_C * 8), kk = e % (TILE_C * 8);
      const int gb = b0 + b;
      smem[e] = (gb < B && kk < nrows * 8)
                    ? repro::to_f32(x[static_cast<size_t>(gb) * k + tc0 * 8 + kk])
                    : 0.f;
    }
    __syncthreads();
    if (valid <= 0) continue;

    for (int r = ty; r < nrows; r += TY) {
      const int c = tc0 + r;
      const int grp = (c * 8) / g;
      uint32_t bits[MAXQ];
      float s[MAXQ][COLS];
#pragma unroll
      for (int i = 0; i < MAXQ; ++i) {
        if (i < q) {
          bits[i] = load_bytes4(packed + (static_cast<size_t>(i) * kc + c) * o + col0, valid, vec);
          load_scales4(scales + (static_cast<size_t>(i) * G + grp) * o + col0, valid, vec, s[i]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float w[COLS];
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc) {
          float acc_w = 0.f;
#pragma unroll
          for (int i = 0; i < MAXQ; ++i) {
            if (i < q) {
              const bool bit = (bits[i] >> (8 * cc + j)) & 1u;
              acc_w += bit ? s[i][cc] : -s[i][cc];
            }
          }
          w[cc] = acc_w;
        }
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float xv = smem[b * TILE_C * 8 + r * 8 + j];
#pragma unroll
          for (int cc = 0; cc < COLS; ++cc) acc[b][cc] = fmaf(xv, w[cc], acc[b][cc]);
        }
      }
    }
  }

  __syncthreads();  // done with the x tile; reuse shared memory for partials
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int cc = 0; cc < COLS; ++cc)
      smem[(ty * BT + b) * BLOCK_O + tx * COLS + cc] = acc[b][cc];
  __syncthreads();
  for (int e = tid; e < BT * BLOCK_O; e += TX * TY) {
    const int b = e / BLOCK_O, col = e % BLOCK_O;
    float sum = 0.f;
    for (int t = 0; t < TY; ++t) sum += smem[(t * BT + b) * BLOCK_O + col];
    const int gb = b0 + b, gcol = o0 + col;
    if (gb < B && gcol < o) out[static_cast<size_t>(gb) * o + gcol] = sum;
  }
}

template <typename XT, typename ST>
void launch(const void* x, const void* packed, const void* scales, float* out,
            int B, int k, int o, int q, int g, cudaStream_t stream) {
  // 4-column vector loads need o % 4 == 0 and aligned base pointers
  const int vec = o % COLS == 0 && reinterpret_cast<uintptr_t>(packed) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(scales) % (COLS * sizeof(ST)) == 0;
  const int bt = repro::row_tile(B);
  const dim3 block(TX, TY);
  const dim3 grid((o + BLOCK_O - 1) / BLOCK_O, (B + bt - 1) / bt);
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const ST* sp = static_cast<const ST*>(scales);
  switch (bt) {
    case 1: bcq_mm_kernel<XT, ST, 1><<<grid, block, 0, stream>>>(xp, pp, sp, out, B, k, o, q, g, vec); break;
    case 2: bcq_mm_kernel<XT, ST, 2><<<grid, block, 0, stream>>>(xp, pp, sp, out, B, k, o, q, g, vec); break;
    case 4: bcq_mm_kernel<XT, ST, 4><<<grid, block, 0, stream>>>(xp, pp, sp, out, B, k, o, q, g, vec); break;
    default: bcq_mm_kernel<XT, ST, 8><<<grid, block, 0, stream>>>(xp, pp, sp, out, B, k, o, q, g, vec); break;
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (B, k) f32/bf16; packed (q, k/8, o) u8; scales (q, k/g, o) f32/bf16;
// out (B, o) f32. All contiguous.
extern "C" int bcq_mm_launch(const void* x, int x_dtype, const void* packed,
                             const void* scales, int s_dtype, void* out,
                             int B, int k, int o, int q, int g, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (q < 1 || q > MAXQ || g % 8 != 0 || k % g != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* y = static_cast<float*>(out);
  if (x_dtype == repro::kBF16 && s_dtype == repro::kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, packed, scales, y, B, k, o, q, g, s);
  else if (x_dtype == repro::kBF16 && s_dtype == repro::kF32)
    launch<__nv_bfloat16, float>(x, packed, scales, y, B, k, o, q, g, s);
  else if (x_dtype == repro::kF32 && s_dtype == repro::kBF16)
    launch<float, __nv_bfloat16>(x, packed, scales, y, B, k, o, q, g, s);
  else if (x_dtype == repro::kF32 && s_dtype == repro::kF32)
    launch<float, float>(x, packed, scales, y, B, k, o, q, g, s);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

// The column-block matvec skeleton of ternary_mm (K4), its only user:
// y (B, o) f32 = x (B, k) @ W, with W decoded from its packed planes in
// registers and never written out. (bcq_mm and uniform_mm, which began on
// it, moved to grouptable.cuh; codebook_mm to its own kernel.)
//
// Layout:
//  - A block owns 32 adjacent output columns and up to BT (<= 8) batch rows
//    and loops over all of k itself, so no two blocks write one output and
//    no atomics are needed.
//  - 8 column threads x 32 k-slices: a column thread owns 4 adjacent columns
//    and reads the 4 packed bytes of one byte row (8 k) as one 32-bit load.
//    Byte rows are dealt to the 32 slices round robin.
//  - x rows for a k tile are staged in shared memory as f32.
//  - The slices' partial sums meet in shared memory and are added in a fixed
//    order, so results are bitwise reproducible run to run.
//  - Ragged o and B are masked in the kernel; no padding is needed.
//
// A decoder type Dec supplies the format:
//   kTileC          byte rows per staged x tile
//   Row             per-thread state of one byte row
//   load(row, c, grp, col0, valid)   read byte row c (group grp)
//   weight(row, j, cc)               weight of bit j of column cc
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kTX = 8;                // column threads
constexpr int kTY = 32;               // k slices
constexpr int kBlockO = kTX * kCols;  // output columns per block

template <typename XT, int BT, typename Dec>
__global__ void __launch_bounds__(kTX * kTY)
colblock_kernel(const XT* __restrict__ x, const Dec dec, float* __restrict__ out,
                int B, int k, int o, int g) {
  constexpr int TILE_C = Dec::kTileC;
  constexpr int XS = BT * TILE_C * 8;    // staged x tile (f32)
  constexpr int RS = kTY * BT * kBlockO; // per-slice partial sums (f32)
  constexpr int SM = XS > RS ? XS : RS;
  __shared__ float smem[SM];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int o0 = blockIdx.x * kBlockO;
  const int col0 = o0 + tx * kCols;
  const int valid = min(kCols, o - col0);  // <= 0 for threads past the edge
  const int b0 = blockIdx.y * BT;
  const int kc = k / 8;
  const int rows_per_group = g / 8;
  typename Dec::Row row;

  float acc[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

  for (int tc0 = 0; tc0 < kc; tc0 += TILE_C) {
    const int nrows = min(TILE_C, kc - tc0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < XS; e += kTX * kTY) {
      const int b = e / (TILE_C * 8), kk = e % (TILE_C * 8);
      const int gb = b0 + b;
      smem[e] = (gb < B && kk < nrows * 8)
                    ? to_f32(x[static_cast<size_t>(gb) * k + tc0 * 8 + kk])
                    : 0.f;
    }
    __syncthreads();

    if (valid > 0) {
      for (int r = ty; r < nrows; r += kTY) {
        const int c = tc0 + r;
        dec.load(row, c, c / rows_per_group, col0, valid);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float w[kCols];
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) w[cc] = dec.weight(row, j, cc);
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            const float xv = smem[b * TILE_C * 8 + r * 8 + j];
#pragma unroll
            for (int cc = 0; cc < kCols; ++cc) acc[b][cc] = fmaf(xv, w[cc], acc[b][cc]);
          }
        }
      }
    }
  }

  __syncthreads();  // done with the tiles; reuse shared memory for partials
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      smem[(ty * BT + b) * kBlockO + tx * kCols + cc] = acc[b][cc];
  __syncthreads();
  for (int e = tid; e < BT * kBlockO; e += kTX * kTY) {
    const int b = e / kBlockO, col = e % kBlockO;
    float sum = 0.f;
    for (int t = 0; t < kTY; ++t) sum += smem[(t * BT + b) * kBlockO + col];
    const int gb = b0 + b, gcol = o0 + col;
    if (gb < B && gcol < o) out[static_cast<size_t>(gb) * o + gcol] = sum;
  }
}

// 4-column vector loads need o % 4 == 0 and aligned base pointers.
template <typename ST>
bool vector_loads(const void* packed, const void* scales, int o) {
  return o % kCols == 0 && reinterpret_cast<uintptr_t>(packed) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(scales) % (kCols * sizeof(ST)) == 0;
}

template <typename XT, typename Dec>
void colblock_launch(const void* x, const Dec& dec, float* out, int B, int k, int o, int g,
                     cudaStream_t stream) {
  const int bt = row_tile(B);
  const dim3 block(kTX, kTY);
  const dim3 grid((o + kBlockO - 1) / kBlockO, (B + bt - 1) / bt);
  const XT* xp = static_cast<const XT*>(x);
  switch (bt) {
    case 1: colblock_kernel<XT, 1, Dec><<<grid, block, 0, stream>>>(xp, dec, out, B, k, o, g); break;
    case 2: colblock_kernel<XT, 2, Dec><<<grid, block, 0, stream>>>(xp, dec, out, B, k, o, g); break;
    case 4: colblock_kernel<XT, 4, Dec><<<grid, block, 0, stream>>>(xp, dec, out, B, k, o, g); break;
    default: colblock_kernel<XT, 8, Dec><<<grid, block, 0, stream>>>(xp, dec, out, B, k, o, g); break;
  }
}

// What every decoder reads: packed (q, kc, o) planes and scales (S, G, o).
template <typename ST>
struct Planes {
  const uint8_t* packed;
  const ST* scales;
  int kc, o, q, G;
  bool vec;

  // The 4 bytes of byte row c of plane i at columns col0..col0+3.
  __device__ __forceinline__ uint32_t bytes(int i, int c, int col0, int valid) const {
    return load_bytes4(packed + (static_cast<size_t>(i) * kc + c) * o + col0, valid, vec);
  }
  // Scale plane i of group grp at columns col0..col0+3, as f32.
  __device__ __forceinline__ void params(int i, int grp, int col0, int valid, float* s) const {
    load_scales4(scales + (static_cast<size_t>(i) * G + grp) * o + col0, valid, vec, s);
  }
};

// The shared C entry: checks, then launches colblock_kernel with
// Dec<ST>{Planes<ST>{...}} for the dtypes of x and the scales.
template <template <typename> class Dec>
int colblock_entry(const void* x, int x_dtype, const void* packed, const void* scales,
                   int s_dtype, void* out, int B, int k, int o, int q, int g, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (q < 1 || q > kMaxQ || g <= 0 || g % 8 != 0 || k % g != 0) return cudaErrorInvalidValue;
  const bool ok = dispatch_dtypes(x_dtype, s_dtype, [&](auto xt, auto st) {
    using XT = typename decltype(xt)::type;
    using ST = typename decltype(st)::type;
    const Dec<ST> dec{{static_cast<const uint8_t*>(packed), static_cast<const ST*>(scales),
                       k / 8, o, q, k / g, vector_loads<ST>(packed, scales, o)}};
    colblock_launch<XT>(x, dec, static_cast<float*>(out), B, k, o, g,
                        static_cast<cudaStream_t>(stream));
  });
  if (!ok) return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

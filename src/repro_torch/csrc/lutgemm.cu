// lutgemm: the paper's LUT-based quantized matmul (LUT-GEMM, §III.B-C).
// y (B, o) f32 = x (B, k) @ sum_i alpha_i * b_i with packed sign planes.
//
// Replaces the TPU kernel src/repro/kernels/lutgemm.py::lutgemm
// (_lutgemm_kernel, _sign_patterns).
//
// Algorithm, per 128-row k tile (16 chunks of mu = 8 activations):
//  1. Build, in shared memory, LUT[b][c][key] = sum_j pattern[key, j] *
//     x[b, 8c + j] for every batch row b of the block, chunk c and all 256
//     sign patterns (16 KB per batch row). Thread t builds key t.
//  2. Each thread owns one output column. For each plane i it walks the
//     column's packed bytes; a byte IS the table key, so one shared-memory
//     lookup replaces 8 sign-multiply-adds per batch row. Lookups are summed
//     per scale group (g / 8 chunks), multiplied by the group's alpha and
//     summed over the planes, all in f32 registers.
//
// What bounds it: at decode batch sizes, the packed weight bytes over the
// memory rate, as for bcq_mm. The table build costs 16 * 256 * 8 adds per
// batch row per tile and is shared by the block's 256 columns; the lookups
// are data-dependent shared-memory reads whose bank conflicts are inherent to
// the paper's design (random keys across a warp).
//
// Design against that: a block covers 256 columns so one table serves many
// columns. Wide-k, narrow-o leaves would then leave most SMs idle at B = 1
// (o = 3072 is 12 blocks), so the launcher splits k across blockIdx.z into
// contiguous runs of tiles (split_plan: about two blocks per SM, at most
// MAX_SPLITS runs). Each split writes its own (B, o) partial, and a second
// launch adds the partials in split order: deterministic, no atomics.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // one output column per thread; also 256 keys
constexpr int TILE_CH = 16;   // 8-activation chunks per k tile (128 rows)
constexpr int NKEY = 256;
constexpr int MAX_SPLITS = 64;  // bounds the partials buffer and the reduction's reads

struct SplitPlan {
  int splits, tiles_per_split;
};

// Split k into contiguous runs of 128-row tiles until the grid holds about two
// blocks per SM of the current device.
SplitPlan split_plan(int B, int k, int o) {
  int dev = 0, n_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = (k / 8 + TILE_CH - 1) / TILE_CH;
  const int bt = repro::row_tile(B);
  const int blocks = ((o + THREADS - 1) / THREADS) * ((B + bt - 1) / bt);
  const int want = std::max(1, std::min({n_tiles, MAX_SPLITS, (2 * n_sm + blocks - 1) / blocks}));
  const int per = std::max(1, (n_tiles + want - 1) / want);
  return {std::max(1, (n_tiles + per - 1) / per), per};
}

template <typename XT, typename ST, int BT>
__global__ void __launch_bounds__(THREADS)
lutgemm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
               const ST* __restrict__ scales, float* __restrict__ out,
               int B, int k, int o, int q, int g, int tiles_per_split) {
  extern __shared__ float lut[];  // [BT][TILE_CH][NKEY]
  __shared__ float xs[BT][TILE_CH * 8];

  const int tid = threadIdx.x;
  const int col = blockIdx.x * THREADS + tid;
  const int b0 = blockIdx.y * BT;
  const int split = blockIdx.z;
  const int kc = k / 8, G = k / g, cpg = g / 8;
  const int n_tiles = (kc + TILE_CH - 1) / TILE_CH;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  float acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * TILE_CH;
    const int nch = min(TILE_CH, kc - c0);
    __syncthreads();  // the previous tile's table is no longer read
    for (int e = tid; e < BT * TILE_CH * 8; e += THREADS) {
      const int b = e / (TILE_CH * 8), kk = e % (TILE_CH * 8);
      const int gb = b0 + b;
      xs[b][kk] = (gb < B && kk < nch * 8)
                      ? repro::to_f32(x[static_cast<size_t>(gb) * k + c0 * 8 + kk])
                      : 0.f;
    }
    __syncthreads();
    // 1. table build: thread tid computes key tid of every (row, chunk)
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      for (int c = 0; c < TILE_CH; ++c) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xv = xs[b][c * 8 + j];
          v += ((tid >> j) & 1) ? xv : -xv;
        }
        lut[(b * TILE_CH + c) * NKEY + tid] = v;
      }
    }
    __syncthreads();
    if (col >= o) continue;
    // 2. retrieve by packed byte, sum per group, scale, sum over planes
    for (int i = 0; i < q; ++i) {
      const uint8_t* prow = packed + static_cast<size_t>(i) * kc * o + col;
      const ST* srow = scales + static_cast<size_t>(i) * G * o + col;
      float p[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) p[b] = 0.f;
      int grp = c0 / cpg;
      for (int c = 0; c < nch; ++c) {
        const int cg = c0 + c;
        const int gi = cg / cpg;
        if (gi != grp) {
          const float s = repro::to_f32(srow[static_cast<size_t>(grp) * o]);
#pragma unroll
          for (int b = 0; b < BT; ++b) { acc[b] = fmaf(s, p[b], acc[b]); p[b] = 0.f; }
          grp = gi;
        }
        const int key = prow[static_cast<size_t>(cg) * o];
#pragma unroll
        for (int b = 0; b < BT; ++b) p[b] += lut[(b * TILE_CH + c) * NKEY + key];
      }
      const float s = repro::to_f32(srow[static_cast<size_t>(grp) * o]);
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = fmaf(s, p[b], acc[b]);
    }
  }

  if (col < o) {
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const int gb = b0 + b;
      if (gb < B) out[(static_cast<size_t>(split) * B + gb) * o + col] = acc[b];
    }
  }
}

// out[n] = sum over s of part[s][n], in split order.
__global__ void splitk_reduce(const float* __restrict__ part, float* __restrict__ out,
                              size_t n, int splits) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += part[static_cast<size_t>(s) * n + idx];
  out[idx] = sum;
}

template <typename XT, typename ST, int BT>
cudaError_t launch_bt(const void* x, const void* packed, const void* scales, float* dst,
                      int B, int k, int o, int q, int g, int splits, int tiles_per_split,
                      cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(BT) * TILE_CH * NKEY * sizeof(float);
  static bool attr_set = false;  // per instantiation; above 48 KB needs opt-in
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(lutgemm_kernel<XT, ST, BT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((o + THREADS - 1) / THREADS, (B + BT - 1) / BT, splits);
  lutgemm_kernel<XT, ST, BT><<<grid, THREADS, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const ST*>(scales), dst, B, k, o, q, g, tiles_per_split);
  return cudaGetLastError();
}

template <typename XT, typename ST>
cudaError_t launch(const void* x, const void* packed, const void* scales, float* dst,
                   int B, int k, int o, int q, int g, int splits, int tiles_per_split,
                   cudaStream_t stream) {
  switch (repro::row_tile(B)) {
    case 1: return launch_bt<XT, ST, 1>(x, packed, scales, dst, B, k, o, q, g, splits, tiles_per_split, stream);
    case 2: return launch_bt<XT, ST, 2>(x, packed, scales, dst, B, k, o, q, g, splits, tiles_per_split, stream);
    case 4: return launch_bt<XT, ST, 4>(x, packed, scales, dst, B, k, o, q, g, splits, tiles_per_split, stream);
    default: return launch_bt<XT, ST, 8>(x, packed, scales, dst, B, k, o, q, g, splits, tiles_per_split, stream);
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// Bytes of scratch lutgemm_launch needs for (B, k, o) on the current device:
// the (splits, B, o) f32 partials when k is split, else 0.
extern "C" size_t lutgemm_workspace_bytes(int B, int k, int o) {
  const SplitPlan p = split_plan(B, k, o);
  return p.splits > 1 ? static_cast<size_t>(p.splits) * B * o * sizeof(float) : 0;
}

// x (B, k) f32/bf16; packed (q, k/8, o) u8; scales (q, k/g, o) f32/bf16;
// out (B, o) f32; workspace of at least lutgemm_workspace_bytes(B, k, o).
extern "C" int lutgemm_launch(const void* x, int x_dtype, const void* packed,
                              const void* scales, int s_dtype, void* out, void* workspace,
                              size_t workspace_bytes, int B, int k, int o, int q, int g,
                              void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (g % 8 != 0 || k % g != 0 || workspace_bytes < lutgemm_workspace_bytes(B, k, o))
    return cudaErrorInvalidValue;
  const SplitPlan plan = split_plan(B, k, o);
  const int splits = plan.splits, tiles_per_split = plan.tiles_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits > 1 ? workspace : out);
  cudaError_t err;
  if (x_dtype == repro::kBF16 && s_dtype == repro::kBF16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, packed, scales, dst, B, k, o, q, g, splits, tiles_per_split, s);
  else if (x_dtype == repro::kBF16 && s_dtype == repro::kF32)
    err = launch<__nv_bfloat16, float>(x, packed, scales, dst, B, k, o, q, g, splits, tiles_per_split, s);
  else if (x_dtype == repro::kF32 && s_dtype == repro::kBF16)
    err = launch<float, __nv_bfloat16>(x, packed, scales, dst, B, k, o, q, g, splits, tiles_per_split, s);
  else if (x_dtype == repro::kF32 && s_dtype == repro::kF32)
    err = launch<float, float>(x, packed, scales, dst, B, k, o, q, g, splits, tiles_per_split, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const size_t n = static_cast<size_t>(B) * o;
    const int threads = 256;
    splitk_reduce<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, s>>>(
        static_cast<const float*>(workspace), static_cast<float*>(out), n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

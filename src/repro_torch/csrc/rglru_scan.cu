// rglru_scan: the RG-LRU recurrence h_t = a_t * h_{t-1} + g_t over a
// sequence, for every (batch row, channel), with the whole trajectory kept.
//
// It has no pallas_call in the reference: it is the counterpart of the
// lax.scan at src/repro/models/recurrent.py:83-92 (rglru_scan's step), which
// on the card would otherwise be S steps of two elementwise launches a layer.
//
// What bounds it: bytes. It reads a and g once and writes hs once, 3*B*S*W
// f32 values (plus h0 and h_last, B*W each); 147 MB at B = 1, S = 3000,
// W = 4096, ~44 us at 3.35 TB/s on an H100 SXM. The arithmetic is a chain of
// two dependent f32 operations a step, so what keeps the card from its bound
// is the latency of each step's loads, unless they are issued well ahead.
//
// Design (kernels/rglru_scan.py::plan picks the path, the stages and the
// shared memory; the entry checks them):
// - the ring (S above the plan's `short`): one block per (row, slice of 32
//   channels), so W = 4096 at B = 1 gives 128 blocks. A producer warp keeps
//   a ring of [32 steps x 32 channels] tiles of a and g in shared memory
//   filled ahead (TMA boxes of a 3-d tensor map over (B, S, W) when rows are
//   16-byte multiples, zero past S and W; else per-element cp.async copies
//   tracked by the same mbarriers); the compute warp walks its channel's
//   steps from the ring, lane l channel 32 * slice + l, each step's hs one
//   coalesced 128-byte store;
// - short sequences (a decode step, a verify): one thread per (b, w) walking
//   t in order straight from device memory, 256-thread blocks.
// Both round the product and the sum separately (__fmul_rn, then
// __fadd_rn), which keeps the compiler from contracting them into an FMA,
// so every h_t equals the plain version's (h = a * h; h = h + g, two rounded
// torch ops) bit for bit whichever path runs, and a scan of S steps equals
// S calls at S = 1 (the decode step).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int kShortThreads = 256;
constexpr int kSlice = 32;  // channels a ring block: one warp's lanes
constexpr int kSteps = 32;  // steps a ring stage holds
constexpr int kMaxStages = 16;
constexpr int kStageBytes = 2 * kSteps * kSlice * 4;  // a and g

__host__ __device__ constexpr int ring_smem(int stages) { return stages * (kStageBytes + 16); }  // + full, empty

__global__ void __launch_bounds__(kShortThreads)
rglru_scan_kernel_short(const float* __restrict__ a, const float* __restrict__ g,
                        const float* __restrict__ h0, float* __restrict__ hs,
                        float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * kShortThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const size_t row = static_cast<size_t>(b) * S * W + w;
  float h = h0[static_cast<size_t>(b) * W + w];
  for (int t = 0; t < S; ++t) {
    const size_t e = row + static_cast<size_t>(t) * W;
    h = __fadd_rn(__fmul_rn(a[e], h), g[e]);
    hs[e] = h;
  }
  h_last[static_cast<size_t>(b) * W + w] = h;
}

// Warp 0 computes, warp 1 fills the ring. `tma`: the maps cover a and g as
// (B, S, W) with boxes of [kSteps][kSlice]; else cp.async from a and g.
__global__ void __launch_bounds__(64)
rglru_scan_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_g,
                  const float* __restrict__ a, const float* __restrict__ g, const float* __restrict__ h0,
                  float* __restrict__ hs, float* __restrict__ h_last, int S, int W, int stages, int tma) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* const ring = reinterpret_cast<float*>(smem);  // [stages][a, g][kSteps][kSlice]
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(stages) * kStageBytes);
  uint64_t* const empty = full + stages;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * kSlice, b = blockIdx.y;
  const int chunks = (S + kSteps - 1) / kSteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], tma ? 1 : 32);  // the TMA's expect_tx, or every producer lane's copies
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 1) {  // producer
    for (int k = 0; k < chunks; ++k) {
      const int s = k % stages, t0 = k * kSteps;
      if (k >= stages) mbar_wait(&empty[s], ((k / stages) - 1) & 1);
      float* const sa = ring + static_cast<size_t>(s) * 2 * kSteps * kSlice;
      float* const sg = sa + kSteps * kSlice;
      if (tma) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_3d(sa, &map_a, &full[s], w0, t0, b);
          tma_load_3d(sg, &map_g, &full[s], w0, t0, b);
        }
      } else {
        const int w = w0 + lane, nt = min(kSteps, S - t0);
        if (w < W) {
          for (int j = 0; j < nt; ++j) {
            const size_t e = (static_cast<size_t>(b) * S + t0 + j) * W + w;
            cp_async4(sa + j * kSlice + lane, a + e);
            cp_async4(sg + j * kSlice + lane, g + e);
          }
        }
        cp_async_mbar_arrive(&full[s]);
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int w = w0 + lane;
  const bool ok = w < W;
  float h = ok ? h0[static_cast<size_t>(b) * W + w] : 0.f;
  for (int k = 0; k < chunks; ++k) {
    const int s = k % stages, t0 = k * kSteps;
    mbar_wait(&full[s], (k / stages) & 1);
    const float* const sa = ring + static_cast<size_t>(s) * 2 * kSteps * kSlice;
    const float* const sg = sa + kSteps * kSlice;
    float* const out = hs + (static_cast<size_t>(b) * S + t0) * W + w;
    const int nt = min(kSteps, S - t0);
    if (nt == kSteps) {
#pragma unroll
      for (int j0 = 0; j0 < kSteps; j0 += 8) {  // eight steps' loads ahead of their chain
        float av[8], gv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          av[u] = sa[(j0 + u) * kSlice + lane];
          gv[u] = sg[(j0 + u) * kSlice + lane];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          h = __fadd_rn(__fmul_rn(av[u], h), gv[u]);
          if (ok) out[static_cast<size_t>(j0 + u) * W] = h;
        }
      }
    } else {
      for (int j = 0; j < nt; ++j) {
        h = __fadd_rn(__fmul_rn(sa[j * kSlice + lane], h), sg[j * kSlice + lane]);
        if (ok) out[static_cast<size_t>(j) * W] = h;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (ok) h_last[static_cast<size_t>(b) * W + w] = h;
}

// x (B, S, W) f32 as a 3-d tensor map of [kSteps][kSlice] boxes, zero past
// the edges.
bool make_map(CUtensorMap* map, const void* x, int B, int S, int W) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * 4, static_cast<cuuint64_t>(S) * W * 4};
  const cuuint32_t box[3] = {kSlice, kSteps, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(x), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// a, g, hs (B, S, W) f32; h0, h_last (B, W) f32. All contiguous; h_last may
// be h0 (each thread reads its h0 before it writes its h_last). The plan
// (kernels/rglru_scan.py::plan): S <= short runs the short kernel; else the
// ring of `stages` stages in `smem` bytes (ring_smem(stages)), filled by TMA
// when `tma` (W a multiple of 4, a and g 16-byte aligned), else by cp.async.
extern "C" int rglru_scan_launch(const void* a, const void* g, const void* h0, void* hs, void* h_last, int B,
                                 int S, int W, int short_max, int stages, int tma, int smem, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (B < 0 || S < 0 || W < 0 || B > 65535) return cudaErrorInvalidValue;
  if (B == 0 || W == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (S <= short_max) {
    const dim3 grid((W + kShortThreads - 1) / kShortThreads, B);
    rglru_scan_kernel_short<<<grid, kShortThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(g), static_cast<const float*>(h0),
        static_cast<float*>(hs), static_cast<float*>(h_last), S, W);
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned = W % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (stages < 2 || stages > kMaxStages || smem != ring_smem(stages) || (tma && !aligned))
    return cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;  // above 48 KB needs the opt-in
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(rglru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  CUtensorMap ma{}, mg{};
  if (tma && (!make_map(&ma, a, B, S, W) || !make_map(&mg, g, B, S, W))) return cudaErrorInvalidValue;
  const dim3 grid((W + kSlice - 1) / kSlice, B);
  rglru_scan_kernel<<<grid, 64, smem, st>>>(ma, mg, static_cast<const float*>(a), static_cast<const float*>(g),
                                            static_cast<const float*>(h0), static_cast<float*>(hs),
                                            static_cast<float*>(h_last), S, W, stages, tma);
  return static_cast<int>(cudaGetLastError());
}

// rglru_scan: the RG-LRU recurrence h_t = a_t * h_{t-1} + g_t over a
// sequence, for every (batch row, channel), with the whole trajectory kept.
//
// It has no pallas_call in the reference: it is the counterpart of the
// lax.scan at src/repro/models/recurrent.py:83-92 (rglru_scan's step), which
// on the card would otherwise be S steps of two elementwise launches a layer.
//
// What bounds it: bytes. It reads a and g once and writes hs once, 3*B*S*W
// f32 values (plus h0 and h_last, B*W each); 147 MB at B = 1, S = 3000,
// W = 4096, ~44 us at 3.35 TB/s on an H100 SXM.
//
// Design: one thread per (b, w) channel, adjacent threads on adjacent w, so
// every load and store of a warp is one coalesced 128-byte line; each thread
// walks t = 0 .. S-1 in order, carrying h in a register. The product and the
// sum are rounded separately (__fmul_rn, then __fadd_rn), which keeps the
// compiler from contracting them into an FMA, so every h_t equals the plain
// version's (h = a * h; h = h + g, two rounded torch ops) bit for bit, and a
// scan of S steps equals S calls at S = 1 (the decode step).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ g,
                  const float* __restrict__ h0, float* __restrict__ hs,
                  float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
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

}  // namespace

REPRO_EXPORT_ERROR_STRING

// a, g, hs (B, S, W) f32; h0, h_last (B, W) f32. All contiguous; h_last may
// be h0 (each thread reads its h0 before it writes its h_last).
extern "C" int rglru_scan_launch(const void* a, const void* g, const void* h0, void* hs,
                                 void* h_last, int B, int S, int W, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (B < 0 || S < 0 || W < 0 || B > 65535) return cudaErrorInvalidValue;
  if (B == 0 || W == 0) return 0;
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(g), static_cast<const float*>(h0),
      static_cast<float*>(hs), static_cast<float*>(h_last), S, W);
  return static_cast<int>(cudaGetLastError());
}

// dequant_materialize: the dense (k, o) weight code * s + z, written to
// device memory from uniform planes: the first half of the paper's
// dequantize-then-GEMM baseline (kernels/dequant_mm.py runs the GEMM).
//
// Replaces the TPU kernel src/repro/kernels/dequant_mm.py::dequant_materialize
// (_dequant_kernel).
//
// What bounds it: bytes. It reads q/8 bytes a weight and two parameters a
// group, and writes 4 bytes a weight (f32), so the write dominates: 1.58 GB
// for llama3.2-3b's lm_head, ~0.47 ms at 3.35 TB/s on an H100 SXM.
//
// Design: an elementwise pass over (k/8, o). One thread per packed byte
// column reads its q plane bytes and the group's (s, z), reassembles the 8
// codes with the shared plane_code helper and writes 8 values down its
// column; adjacent threads own adjacent columns, so every load and each of
// the 8 stores of a warp is coalesced along o. code * s + z is a product
// and a sum rounded separately, so the result equals the plain version bit
// for bit (in f32; bf16 output rounds that to nearest even).
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename ST, typename OT>
__global__ void __launch_bounds__(THREADS)
dequant_kernel(const uint8_t* __restrict__ packed, const ST* __restrict__ scales,
               OT* __restrict__ out, int kc, int o, int q, int g) {
  const size_t n = static_cast<size_t>(kc) * o;
  const size_t e = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= n) return;
  const int c = static_cast<int>(e / o), col = static_cast<int>(e % o);
  const int G = kc * 8 / g, grp = c / (g / 8);
  uint32_t bits[kMaxQ];
#pragma unroll
  for (int i = 0; i < kMaxQ; ++i)
    if (i < q) bits[i] = packed[static_cast<size_t>(i) * n + e];
  const float s = to_f32(scales[static_cast<size_t>(grp) * o + col]);
  const float z = to_f32(scales[(static_cast<size_t>(G) + grp) * o + col]);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    store(out + (static_cast<size_t>(c) * 8 + j) * o + col, affine(plane_code(bits, q, j), s, z));
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// packed (q, kc, o) u8; scales (2, kc*8/g, o) f32/bf16 (scale, zero);
// out (kc*8, o) f32/bf16. All contiguous.
extern "C" int dequant_materialize_launch(const void* packed, const void* scales, int s_dtype,
                                          void* out, int out_dtype, int kc, int o, int q, int g,
                                          void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (q < 1 || q > repro::kMaxQ || g <= 0 || g % 8 != 0 || (kc * 8) % g != 0) return cudaErrorInvalidValue;
  const size_t n = static_cast<size_t>(kc) * o;
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = repro::dispatch_dtypes(s_dtype, out_dtype, [&](auto st, auto ot) {
    using ST = typename decltype(st)::type;
    using OT = typename decltype(ot)::type;
    dequant_kernel<ST, OT><<<blocks, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(packed), static_cast<const ST*>(scales),
        static_cast<OT*>(out), kc, o, q, g);
  });
  if (!ok) return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

// ternary_mm: y (B, o) f32 = x (B, k) @ (alpha * t), t in {-1, 0, +1}, consumed packed.
//
// Replaces the TPU kernel src/repro/kernels/ternary_mm.py::ternary_mm_call
// (_ternary_mm_kernel, _decode_ternary_block).
//
// What bounds it: two bit planes (a quarter byte a weight) and one alpha per
// group are read once, so at decode batch sizes the bound is those bytes
// over the card's memory rate (3.35 TB/s on an H100 SXM); the decode is two
// bit tests and a select per weight.
//
// Design: the column-block skeleton of colblock.cuh (a block owns 32 output
// columns and loops over all of k; fixed-order reduction, no atomics). Plane
// 0 is the sign bit (1 -> +1), plane 1 the nonzero mask; each weight becomes
// mask ? (sign ? +alpha : -alpha) : 0 in registers, exactly the plain
// version's (2 sign - 1) * mask * alpha, and x * w is accumulated in f32.
// The entry refuses any plane count other than 2.
#include "colblock.cuh"

namespace {

using namespace repro;

template <typename ST>
struct TernaryDec : Planes<ST> {
  static constexpr int kTileC = 128;
  struct Row {
    uint32_t sign, mask;
    float alpha[kCols];
  };

  __device__ __forceinline__ void load(Row& r, int c, int grp, int col0, int valid) const {
    r.sign = this->bytes(0, c, col0, valid);
    r.mask = this->bytes(1, c, col0, valid);
    this->params(0, grp, col0, valid, r.alpha);
  }

  __device__ __forceinline__ float weight(const Row& r, int j, int cc) const {
    const int sh = 8 * cc + j;
    const float a = (r.sign >> sh) & 1u ? r.alpha[cc] : -r.alpha[cc];
    return (r.mask >> sh) & 1u ? a : 0.f;
  }
};

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (B, k) f32/bf16; packed (2, k/8, o) u8 (sign, mask); scales (1, k/g, o)
// f32/bf16 (alpha); out (B, o) f32. All contiguous.
extern "C" int ternary_mm_launch(const void* x, int x_dtype, const void* packed,
                                 const void* scales, int s_dtype, void* out,
                                 int B, int k, int o, int q, int g, void* stream) {
  if (q != 2) {
    cudaGetLastError();
    return cudaErrorInvalidValue;
  }
  return repro::colblock_entry<TernaryDec>(x, x_dtype, packed, scales, s_dtype, out, B, k, o, q,
                                           g, stream);
}

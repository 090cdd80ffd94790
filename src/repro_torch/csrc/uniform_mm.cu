// uniform_mm: y (B, o) f32 = x (B, k) @ (s * code + z), consumed packed.
//
// Replaces the TPU kernel src/repro/kernels/uniform_mm.py::uniform_mm_call
// (_uniform_mm_kernel, _unpack_codes_block).
//
// What bounds it: at decode batch sizes (B <= 8) the q code planes (q/8
// bytes a weight) and the (s, z) pair of each group are read once and feed
// a few flops each, so the bound is those bytes over the card's memory rate
// (3.35 TB/s on an H100 SXM). In practice the code reassembly (a shift, a
// mask and an or per plane and weight) costs more issue slots than the
// bytes cost time, as K1's sign expansion does.
//
// Design: the column-block skeleton of colblock.cuh (a block owns 32 output
// columns and loops over all of k; fixed-order reduction, no atomics). Each
// thread reads the q plane bytes of a byte row for its 4 columns as 32-bit
// loads, reassembles every weight's code as sum_i 2^i bit_i in registers
// and applies code * s + z in f32 with the product and the sum rounded
// separately, so every weight equals the plain version's bit for bit and
// only the order of the k summation differs. (Accumulating sum x * code and
// sum x per group and applying s and z once per group would save work but
// round differently; not done here.)
#include "colblock.cuh"

namespace {

using namespace repro;

template <typename ST>
struct UniformDec : Planes<ST> {
  static constexpr int kTileC = 128;
  struct Row {
    uint32_t bits[kMaxQ];
    float s[kCols], z[kCols];
  };

  __device__ __forceinline__ void load(Row& r, int c, int grp, int col0, int valid) const {
#pragma unroll
    for (int i = 0; i < kMaxQ; ++i)
      if (i < this->q) r.bits[i] = this->bytes(i, c, col0, valid);
    this->params(0, grp, col0, valid, r.s);
    this->params(1, grp, col0, valid, r.z);
  }

  __device__ __forceinline__ float weight(const Row& r, int j, int cc) const {
    return affine(plane_code(r.bits, this->q, 8 * cc + j), r.s[cc], r.z[cc]);
  }
};

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (B, k) f32/bf16; packed (q, k/8, o) u8; scales (2, k/g, o) f32/bf16
// (scale, zero); out (B, o) f32. All contiguous.
extern "C" int uniform_mm_launch(const void* x, int x_dtype, const void* packed,
                                 const void* scales, int s_dtype, void* out,
                                 int B, int k, int o, int q, int g, void* stream) {
  return repro::colblock_entry<UniformDec>(x, x_dtype, packed, scales, s_dtype, out, B, k, o, q,
                                           g, stream);
}

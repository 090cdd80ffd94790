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
// Design (the column-block skeleton of colblock.cuh, which the uniform,
// ternary and codebook kernels share):
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
//  - Bits expand to +-alpha in registers (BCQDec below); w_eff is summed
//    over the q planes and accumulated into x * w_eff in f32 registers,
//    never written out.
//  - The 32 slices' partial sums meet in shared memory and are added in a
//    fixed order, so results are bitwise reproducible run to run.
//  - Ragged o and B are masked in the kernel; no padding is needed.
#include "colblock.cuh"

namespace {

using namespace repro;

// q sign planes, q scale planes: w = sum_i (bit_i ? +alpha_i : -alpha_i).
template <typename ST>
struct BCQDec : Planes<ST> {
  static constexpr int kTileC = 128;
  struct Row {
    uint32_t bits[kMaxQ];
    float s[kMaxQ][kCols];
  };

  __device__ __forceinline__ void load(Row& r, int c, int grp, int col0, int valid) const {
#pragma unroll
    for (int i = 0; i < kMaxQ; ++i) {
      if (i < this->q) {
        r.bits[i] = this->bytes(i, c, col0, valid);
        this->params(i, grp, col0, valid, r.s[i]);
      }
    }
  }

  __device__ __forceinline__ float weight(const Row& r, int j, int cc) const {
    float w = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxQ; ++i) {
      if (i < this->q) {
        const bool bit = (r.bits[i] >> (8 * cc + j)) & 1u;
        w += bit ? r.s[i][cc] : -r.s[i][cc];
      }
    }
    return w;
  }
};

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (B, k) f32/bf16; packed (q, k/8, o) u8; scales (q, k/g, o) f32/bf16;
// out (B, o) f32. All contiguous.
extern "C" int bcq_mm_launch(const void* x, int x_dtype, const void* packed,
                             const void* scales, int s_dtype, void* out,
                             int B, int k, int o, int q, int g, void* stream) {
  return repro::colblock_entry<BCQDec>(x, x_dtype, packed, scales, s_dtype, out, B, k, o, q, g,
                                       stream);
}

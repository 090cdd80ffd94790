// uniform_mm: y (B, o) f32 = x (B, k) @ (s * code + z), consumed packed.
//
// Replaces the TPU kernel src/repro/kernels/uniform_mm.py::uniform_mm_call
// (_uniform_mm_kernel, _unpack_codes_block).
//
// What bounds it: at decode batch sizes (B <= 8) the q code planes (q/8
// bytes a weight) and the (s, z) pair of each group are read once, so the
// bound is those bytes over the card's memory rate (3.35 TB/s on an H100
// SXM).
//
// Design: the group-table skeleton of grouptable.cuh (its header says how
// blocks, stages, the k-split and the sum order go). A (group, column) pair
// takes 2^q weights: entry c is c * s + z in f32 with the product and the
// sum rounded apart (common.cuh::affine), as the reference and the plain
// version (formats.uniform_dequantize) round each weight, so a looked-up
// weight equals the plain version's bit for bit and only the order of the
// k summation differs. Above the plan's table limit each weight is made
// from its code in registers the same way.
#include "grouptable.cuh"

namespace {

using namespace repro;

struct UniformGroups {
  static constexpr int kQ = 0;  // any q
  static __host__ __device__ constexpr int scale_planes(int) { return 2; }  // scale, zero

  template <int Q, typename ST>
  static __device__ __forceinline__ void build(float* T, int stride, const ST* s, int sstride, int q) {
    if constexpr (Q > 0) q = Q;
    const float sc = to_f32(s[0]), z = to_f32(s[sstride]);
#pragma unroll 4
    for (int e = 0; e < (1 << q); ++e) T[e * stride] = affine(e, sc, z);
  }

  struct Params {
    float s, z;
  };

  template <typename ST>
  static __device__ __forceinline__ void load(Params& P, const ST* s, int sstride, int) {
    P.s = to_f32(s[0]);
    P.z = to_f32(s[sstride]);
  }

  static __device__ __forceinline__ float weight(const Params& P, uint32_t code, int) {
    return affine(code, P.s, P.z);
  }
};

}  // namespace

REPRO_EXPORT_ERROR_STRING

REPRO_GROUPTABLE_ENTRY(uniform_mm_launch, UniformGroups)

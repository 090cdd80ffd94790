// bcq_mm: y (B, o) f32 = x (B, k) @ sum_i alpha_i * b_i, consumed packed.
//
// Replaces the TPU kernel src/repro/kernels/bcq_mm.py::bcq_mm_call
// (_bcq_mm_kernel, _unpack_block), which also serves bcq_mm_fused: the fused
// QKV / gate-up leaves are the same function over output-concatenated planes.
//
// What bounds it: at decode batch sizes (B <= 8) the packed planes and the
// group scales are read once (q/8 bytes a weight and q scales a group), so
// the bound is those bytes over the card's memory rate (3.35 TB/s on an
// H100 SXM); at prefill row counts it turns compute bound (f32 FMAs on the
// CUDA cores).
//
// Design: the group-table skeleton of grouptable.cuh (its header says how
// blocks, stages, the k-split and the sum order go). A (group, column) pair
// of BCQ weights takes 2^q values: entry e is ((+-a0 +- a1) +- a2) +- ...,
// bit i of e set meaning +a_i, folded in plane order exactly as the plain
// version sums its planes (kernels/bcq_mm.py::bcq_weight_plain). The table
// shares prefixes: level i doubles the entries of level i - 1 with one add
// each, 2^(q+1) - 2 adds for 2^q entries. Above the plan's table limit each
// weight is folded in registers from its code instead.
#include "grouptable.cuh"

namespace {

using namespace repro;

struct BCQGroups {
  static constexpr int kQ = 0;  // any q
  static __host__ __device__ constexpr int scale_planes(int q) { return q; }

  template <int Q, typename ST>
  static __device__ __forceinline__ void build(float* T, int stride, const ST* s, int sstride, int q) {
    if constexpr (Q > 0) {
      float v[1 << Q];
      const float a0 = to_f32(s[0]);
      v[0] = -a0;
      v[1] = a0;
#pragma unroll
      for (int i = 1; i < Q; ++i) {
        const float a = to_f32(s[i * sstride]);
#pragma unroll
        for (int e = 0; e < (1 << i); ++e) {
          v[e + (1 << i)] = v[e] + a;
          v[e] = v[e] - a;  // == v[e] + (-a): the plain version's sum with a -1 sign
        }
      }
#pragma unroll
      for (int e = 0; e < (1 << Q); ++e) T[e * stride] = v[e];
    } else {  // the same fold, level by level in the table itself
      const float a0 = to_f32(s[0]);
      T[0] = -a0;
      T[stride] = a0;
      for (int i = 1; i < q; ++i) {
        const float a = to_f32(s[i * sstride]);
        for (int e = 0; e < (1 << i); ++e) {
          const float v = T[e * stride];
          T[(e + (1 << i)) * stride] = v + a;
          T[e * stride] = v - a;
        }
      }
    }
  }

  struct Params {
    float a[kMaxQ];
  };

  template <typename ST>
  static __device__ __forceinline__ void load(Params& P, const ST* s, int sstride, int q) {
#pragma unroll
    for (int i = 0; i < kMaxQ; ++i) P.a[i] = i < q ? to_f32(s[i * sstride]) : 0.f;
  }

  static __device__ __forceinline__ float weight(const Params& P, uint32_t code, int q) {
    float w = code & 1u ? P.a[0] : -P.a[0];
#pragma unroll
    for (int i = 1; i < kMaxQ; ++i)
      if (i < q) w = w + ((code >> i) & 1u ? P.a[i] : -P.a[i]);
    return w;
  }
};

}  // namespace

REPRO_EXPORT_ERROR_STRING

REPRO_GROUPTABLE_ENTRY(bcq_mm_launch, BCQGroups)
REPRO_GROUPTABLE_GROUPED_ENTRY(bcq_mm_grouped_launch, BCQGroups)

// codebook_mm: y (B, o) f32 = x (B, k) @ W, W[r, c] = T[idx[r, c], r / g, c],
// consumed packed.
//
// Replaces the TPU kernel src/repro/kernels/codebook_mm.py::codebook_mm_call
// (_codebook_mm_kernel, _unpack_indices_block).
//
// What bounds it: the q index planes (q/8 bytes a weight) and the table of
// 2^q centroids per group and column (at q = 4, g = 128 and bf16 another
// quarter byte a weight) are read once, so at decode batch sizes the bound
// is those bytes over the card's memory rate (3.35 TB/s on an H100 SXM).
//
// Design: the column-block skeleton of colblock.cuh (a block owns 32 output
// columns and loops over all of k; fixed-order reduction, no atomics), with
// the block's slice of the centroid table staged in shared memory as f32:
// 2^q centroids x 32 columns per group (2 KB at q = 4, 32 KB at q = 8), as
// many groups at a time as 32 KB holds (16 at q = 4, one at q = 8). Each
// thread reassembles a weight's index from the planes in registers and
// reads the centroid from the staged table: the runtime index never indexes
// a per-thread array, which nvcc would place in local memory. The x tile is
// 512 k (16 KB at 8 rows), so x tile and table fit the 48 KB of static
// shared memory. Weights equal the plain version's bit for bit; only the
// order of the k summation differs.
#include "colblock.cuh"

namespace {

using namespace repro;

template <typename ST>
struct CodebookDec : Planes<ST> {
  static constexpr int kTileC = 64;
  static constexpr int kTableFloats = 256 * kBlockO;  // one group at q = 8
  struct Row {
    uint32_t bits[kMaxQ];
  };

  __device__ __forceinline__ int groups_per_stage() const {
    return kTableFloats / ((1 << this->q) * kBlockO);
  }

  // table[(gl * 2^q + cent) * 32 + col] = T[cent, grp0 + gl, o0 + col]
  __device__ __forceinline__ void stage(float* table, int grp0, int ngrp, int o0, int o,
                                        int tid) const {
    const int ncent = 1 << this->q;
    const int n = ngrp * ncent * kBlockO;
    for (int e = tid; e < n; e += kTX * kTY) {
      const int col = e % kBlockO, rest = e / kBlockO;
      const int cent = rest % ncent, gl = rest / ncent;
      const int gcol = o0 + col;
      table[e] = gcol < o
                     ? to_f32(this->scales[(static_cast<size_t>(cent) * this->G + grp0 + gl) * o + gcol])
                     : 0.f;
    }
  }

  __device__ __forceinline__ void load(Row& r, int c, int, int col0, int valid) const {
#pragma unroll
    for (int i = 0; i < kMaxQ; ++i)
      if (i < this->q) r.bits[i] = this->bytes(i, c, col0, valid);
  }

  __device__ __forceinline__ float weight(const Row& r, const float* table, int gl, int lc, int j,
                                          int cc) const {
    const uint32_t idx = plane_code(r.bits, this->q, 8 * cc + j);
    return table[((gl << this->q) + idx) * kBlockO + lc];
  }
};

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (B, k) f32/bf16; packed (q, k/8, o) u8 (index planes); scales
// (2^q, k/g, o) f32/bf16 (centroids); out (B, o) f32. All contiguous.
extern "C" int codebook_mm_launch(const void* x, int x_dtype, const void* packed,
                                  const void* scales, int s_dtype, void* out,
                                  int B, int k, int o, int q, int g, void* stream) {
  return repro::colblock_entry<CodebookDec>(x, x_dtype, packed, scales, s_dtype, out, B, k, o,
                                            q, g, stream);
}

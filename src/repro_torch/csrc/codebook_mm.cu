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
// What held the first, column-block version (a block of 32 columns over
// all of k) at 15-45x that bound: a lookup's shared-memory bank depended on
// the column only (a 4-way conflict), each index was rebuilt bit by bit
// (~2q operations a weight), the table was re-staged behind barriers with
// nothing in flight, and the narrow leaves filled 96 of 132 SMs.
//
// Design:
//  - A block owns 32 NS output columns (NS = 4 up to q = 5, else 1), up to
//    BT <= 8 batch rows and one k-chunk of `chunk` byte rows (8 k each);
//    the wrapper's plan (kernels/codebook_mm.py::plan) splits k so that
//    every leaf puts at least two blocks of 8 warps on each of 132 SMs.
//    The plan does not depend on B, so a row sums in the same order
//    whatever the batch.
//  - Lane l owns the NS columns c 32 + l (c < NS), so the staged table
//    keeps the tensor's own column order and lane is its fastest index:
//    with f32 entries every lookup of a warp lands in bank l whatever the
//    index. With bf16 entries two lanes share a word; odd lanes visit their
//    columns rotated by one (slot c -> column (c + 1) mod NS), which puts
//    the two halves of a warp 16 banks apart: no conflict either.
//  - The planes' bytes, the table slice of the rows' groups and the x rows
//    of one stage (stage_rows byte rows) are copied into a 3-stage ring of
//    shared memory with 16-byte cp.async copies (element copies at a ragged
//    or misaligned edge), so two stages are in flight while one is used;
//    the table is staged with its stage, never behind extra barriers.
//  - Indices are built 8 at a time: one multiply spreads a nibble of a
//    plane byte into 4 bytes (bit j to bit 8 j), so q planes give the
//    8 q-bit indices of a byte row in two words with 3 operations a plane
//    and nibble.
//  - Warps take a stage's byte rows round robin; their sums meet in shared
//    memory in warp order. With more than one k-chunk, each block writes
//    its partial sums to scratch, and the last block of a column tile to
//    arrive (an atomic ticket) adds the chunks' partials in chunk order,
//    writes the output and resets the ticket: one launch, bitwise the same
//    run to run. Scratch and tickets come from the wrapper.
// Weights equal the plain version's bit for bit; only the order of the k
// summation differs.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 3;  // stages in flight

// The wrapper's plan (kernels/codebook_mm.py::plan); byte offsets within a
// stage of the ring.
struct Plan {
  int ns, splits, chunk, stage_rows, stage_bytes, off_x, off_t, smem;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Q > 0 fixes q at compile time (the main path's q = 4: no predicated
// planes in the index build); Q = 0 takes q at run time.
template <typename TT, int NS, int BT, int Q>
__global__ void __launch_bounds__(kThreads, 2)
codebook_kernel(const void* __restrict__ xv, int x_bf16, const uint8_t* __restrict__ packed,
                const TT* __restrict__ table, float* __restrict__ out, float* __restrict__ scratch,
                unsigned* __restrict__ tickets, int B, int k, int o, int q, int g, Plan p) {
  constexpr int BC = 32 * NS;  // columns of a block
  extern __shared__ __align__(16) uint8_t smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o0 = blockIdx.x * BC, b0 = blockIdx.y * BT;
  if constexpr (Q > 0) q = Q;
  const int kc = k / 8, G = k / g, ncent = 1 << q;
  const int c0 = blockIdx.z * p.chunk, c1 = min(kc, c0 + p.chunk);
  const int SR = p.stage_rows;
  const int nstage = (c1 - c0 + SR - 1) / SR;
  const int xb = x_bf16 ? 2 : 4;
  const int valid = min(BC, o - o0);
  const bool full = valid == BC;
  const bool vec_p = full && o % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool vec_t = full && (o * sizeof(TT)) % 16 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;

  // slot c of this lane: column ((c + (lane & 1)) % NS) * 32 + lane of the block
  int col[NS];
#pragma unroll
  for (int c = 0; c < NS; ++c) col[c] = ((c + (lane & 1)) % NS) * 32 + lane;

  // Stage s of the block's chunk into ring buffer buf: rows [r0, r1).
  auto stage = [&](int s) {
    uint8_t* const buf = smem + (s % kRing) * p.stage_bytes;
    const int r0 = c0 + s * SR, nr = min(SR, c1 - r0);
    copy_lines<kThreads>(buf, packed, q * nr, BC, valid, vec_p,
                         [&](int i) { return (static_cast<size_t>(i / nr) * kc + r0 + i % nr) * o + o0; });
    const int ga = r0 * 8 / g, ngrp = ((r0 + nr) * 8 - 1) / g - ga + 1;
    copy_lines<kThreads>(reinterpret_cast<TT*>(buf + p.off_t), table, ngrp * ncent, BC, valid, vec_t,
                         [&](int i) { return (static_cast<size_t>(i % ncent) * G + ga + i / ncent) * o + o0; });
    copy_x_rows<kThreads, BT>(buf + p.off_x, xv, xb, B, b0, k, r0, nr, SR);  // zero past B
  };

  float acc[BT][NS];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < NS; ++c) acc[b][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < nstage) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < nstage; ++s) {
    if (s + kRing - 1 < nstage) stage(s + kRing - 1);
    cp_async_commit();
    cp_async_wait<kRing - 1>();
    __syncthreads();

    const uint8_t* const buf = smem + (s % kRing) * p.stage_bytes;
    const TT* const ts = reinterpret_cast<const TT*>(buf + p.off_t);
    const uint8_t* const xs = buf + p.off_x;
    const int r0 = c0 + s * SR, nr = min(SR, c1 - r0);
    const int ga = r0 * 8 / g;
    for (int rr = warp; rr < nr; rr += kWarps) {
      // x of the byte row's 8 k, as f32
      float x8[BT][8];
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (x_bf16) {
          const uint4 w = *reinterpret_cast<const uint4*>(xs + (b * SR * 8 + rr * 8) * 2);
          x8[b][0] = bf16_lo(w.x); x8[b][1] = bf16_hi(w.x);
          x8[b][2] = bf16_lo(w.y); x8[b][3] = bf16_hi(w.y);
          x8[b][4] = bf16_lo(w.z); x8[b][5] = bf16_hi(w.z);
          x8[b][6] = bf16_lo(w.w); x8[b][7] = bf16_hi(w.w);
        } else {
          const float4* f = reinterpret_cast<const float4*>(xs + (b * SR * 8 + rr * 8) * 4);
          const float4 u = f[0], v = f[1];
          x8[b][0] = u.x; x8[b][1] = u.y; x8[b][2] = u.z; x8[b][3] = u.w;
          x8[b][4] = v.x; x8[b][5] = v.y; x8[b][6] = v.z; x8[b][7] = v.w;
        }
      }
      const TT* const tg = ts + ((r0 + rr) * 8 / g - ga) * ncent * BC;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        // the 8 q-bit indices of this byte row: byte j of lo (rows 0-3) and
        // hi (rows 4-7); (n * 0x204081) & 0x01010101 moves bit j of a
        // nibble n to bit 8 j, shifted by i for plane i
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int i = 0; i < (Q > 0 ? Q : kMaxQ); ++i) {
          if (Q > 0 || i < q) {
            const uint32_t byte = buf[(i * nr + rr) * BC + col[c]];
            lo |= ((byte & 0xfu) * (0x204081u << i)) & (0x01010101u << i);
            hi |= ((byte >> 4) * (0x204081u << i)) & (0x01010101u << i);
          }
        }
        const TT* const tc = tg + col[c];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t idx = ((j < 4 ? lo : hi) >> (8 * (j & 3))) & 0xffu;
          const float w = to_f32(tc[idx * BC]);
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b][c] = fmaf(x8[b][j], w, acc[b][c]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled next
  }
  cp_async_wait<0>();

  // the warps' sums, then the k-chunks' partials, in order
  float* const red = reinterpret_cast<float*>(smem);  // [warp][BT][BC]
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < NS; ++c) red[(warp * BT + b) * BC + col[c]] = acc[b][c];
  __syncthreads();
  finish_split<kThreads, kWarps, BT, BC>(red, out, scratch, tickets, B, o, b0, o0, valid);
}

template <typename TT, int NS, int BT, int Q>
cudaError_t launch(const void* x, int x_bf16, const void* packed, const void* table, float* out,
                   float* scratch, unsigned* tickets, int B, int k, int o, int q, int g, const Plan& p,
                   cudaStream_t stream) {
  static int attr = 0;  // per instantiation: the largest opt-in made so far
  if (p.smem > attr) {
    cudaError_t err = cudaFuncSetAttribute(codebook_kernel<TT, NS, BT, Q>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    attr = p.smem;
  }
  constexpr int BC = 32 * NS;
  const dim3 grid((o + BC - 1) / BC, (B + BT - 1) / BT, p.splits);
  codebook_kernel<TT, NS, BT, Q><<<grid, kThreads, p.smem, stream>>>(
      x, x_bf16, static_cast<const uint8_t*>(packed), static_cast<const TT*>(table), out, scratch,
      tickets, B, k, o, q, g, p);
  return cudaGetLastError();
}

template <typename TT, int NS, int Q>
cudaError_t launch_bt(int bt, const void* x, int x_bf16, const void* packed, const void* table, float* out,
                      float* scratch, unsigned* tickets, int B, int k, int o, int q, int g, const Plan& p,
                      cudaStream_t st) {
  switch (bt) {
    case 1: return launch<TT, NS, 1, Q>(x, x_bf16, packed, table, out, scratch, tickets, B, k, o, q, g, p, st);
    case 2: return launch<TT, NS, 2, Q>(x, x_bf16, packed, table, out, scratch, tickets, B, k, o, q, g, p, st);
    case 4: return launch<TT, NS, 4, Q>(x, x_bf16, packed, table, out, scratch, tickets, B, k, o, q, g, p, st);
    default: return launch<TT, NS, 8, Q>(x, x_bf16, packed, table, out, scratch, tickets, B, k, o, q, g, p, st);
  }
}

template <typename TT>
cudaError_t launch_ns(const void* x, int x_bf16, const void* packed, const void* table, float* out,
                      float* scratch, unsigned* tickets, int B, int k, int o, int q, int g, const Plan& p,
                      cudaStream_t st) {
  const int bt = row_tile(B);
  if (p.ns == 4 && q == 4)
    return launch_bt<TT, 4, 4>(bt, x, x_bf16, packed, table, out, scratch, tickets, B, k, o, q, g, p, st);
  if (p.ns == 4) return launch_bt<TT, 4, 0>(bt, x, x_bf16, packed, table, out, scratch, tickets, B, k, o, q, g, p, st);
  return launch_bt<TT, 1, 0>(bt, x, x_bf16, packed, table, out, scratch, tickets, B, k, o, q, g, p, st);
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (B, k) f32/bf16; packed (q, k/8, o) u8 (index planes); scales
// (2^q, k/g, o) f32/bf16 (centroids); out (B, o) f32. All contiguous.
// The plan's fields (kernels/codebook_mm.py::plan): ns columns a lane,
// splits k-chunks of chunk byte rows, stage_rows byte rows a stage of
// stage_bytes (x at off_x, the table at off_t), smem bytes in all.
// scratch holds splits * B * o floats and tickets one zeroed counter per
// (column tile, batch tile) when splits > 1.
extern "C" int codebook_mm_launch(const void* x, int x_dtype, const void* packed, const void* scales,
                                  int s_dtype, void* out, void* scratch, void* tickets, int B, int k,
                                  int o, int q, int g, int ns, int splits, int chunk, int stage_rows,
                                  int stage_bytes, int off_x, int off_t, int smem, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  const int kc = k / 8;
  if (q < 1 || q > kMaxQ || g <= 0 || g % 8 != 0 || k % g != 0 || (ns != 1 && ns != 4) || splits < 1 ||
      chunk < 1 || static_cast<long long>(chunk) * splits < kc || chunk * (splits - 1) >= kc ||
      stage_rows < 1 || stage_bytes % 16 || off_x % 16 || off_t % 16 ||
      (splits > 1 && (scratch == nullptr || tickets == nullptr)) ||
      (x_dtype != kF32 && x_dtype != kBF16))
    return cudaErrorInvalidValue;
  if (B <= 0 || o <= 0) return cudaSuccess;
  const Plan p{ns, splits, chunk, stage_rows, stage_bytes, off_x, off_t, smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const o32 = static_cast<float*>(out);
  float* const sc = static_cast<float*>(scratch);
  unsigned* const tk = static_cast<unsigned*>(tickets);
  const int xbf = x_dtype == kBF16;
  cudaError_t err;
  if (s_dtype == kF32)
    err = launch_ns<float>(x, xbf, packed, scales, o32, sc, tk, B, k, o, q, g, p, st);
  else if (s_dtype == kBF16)
    err = launch_ns<__nv_bfloat16>(x, xbf, packed, scales, o32, sc, tk, B, k, o, q, g, p, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// The group-table skeleton shared by bcq_mm (K1/K2), uniform_mm (K5), the
// CUDA-core path of ternary_mm (K4) and, over a bank of MoE experts in one
// launch, expert_mm (K12: expert_grouptable_kernel below):
// y (B, o) f32 = x (B, k) @ W, where W[r, c] is a function of the q-bit code
// of (r, c), read from q packed planes, and of the scales of the group r / g
// of column c. A (group, column) pair can take only 2^q weight values.
//
// What bounds it: at decode batch sizes the q planes (q/8 bytes a weight)
// and a few scales a group are read once, so the bound is those bytes over
// the card's memory rate (3.35 TB/s on an H100 SXM); in practice the
// instructions spent a weight (code build, lookup, B FMAs) bound it. What held
// the first, column-block version (32 columns a block over all of k) at
// 20-30x that bound: each weight rebuilt bit by bit (~17 instructions at
// q = 4 for BCQ), the group's scales reloaded for every byte row, nothing
// in flight while x was staged, and 96 blocks on 132 SMs at o = 3072.
//
// Design (K7 codebook_mm's shape, with the table built on the chip):
//  - A block owns 32 NS output columns (NS = 4, or 1 where a q > 5 table
//    would not fit), up to BT <= 8 batch rows and one k-chunk of `chunk`
//    byte rows (8 k each). The wrapper's plan (kernels/grouptable.py::plan)
//    splits k so that every llama3.2-3b leaf puts at least two blocks of 8
//    warps on each of 132 SMs; it does not depend on B.
//  - Lane l owns the NS columns c 32 + l, so with f32 entries laid out
//    [group][entry][column] every lookup of a warp lands in bank l whatever
//    the code: no conflict.
//  - The chunk is cut into stages of stage_rows byte rows (the plan
//    balances them: a 35-row chunk takes two stages of 18 and 17 rows). A
//    stage's plane bytes, the scales of the groups it touches and its x
//    rows are copied into a 3-stage ring of shared memory with 16-byte
//    cp.async copies (element copies at a ragged or misaligned edge).
//  - The table path (TABLE): the 2^q weights of each (group, column) of
//    stage t + 1 are built from its staged scales while stage t is used, in
//    a second pair of buffers, so one __syncthreads a stage serves the
//    ring and the tables alike. The format's Dec::build makes them exactly
//    as the plain version makes each weight, so a looked-up weight equals
//    it bit for bit.
//  - The direct path (!TABLE, for q above the plan's table limit): each
//    weight is expanded from its code and the group's scales in registers
//    (Dec::weight), again exactly as the plain version makes it.
//  - Codes are built 8 at a time: one multiply spreads a nibble of a plane
//    byte into 4 bytes (bit j to bit 8 j), so q planes give the 8 q-bit
//    codes of a byte row in two words with 3 operations a plane and nibble.
//  - Row r of the chunk goes to warp r mod 8, which walks its rows in
//    order; the warps' sums meet in shared memory in warp order. With more
//    than one k-chunk, each block writes its partial sums to scratch, and
//    the last block of a column tile to arrive (an atomic ticket) adds the
//    chunks' partials in chunk order, writes the output and resets the
//    ticket: one launch, bitwise the same run to run. Nothing of that
//    order depends on B, the row tile or the stage size, so row r of a
//    B-row call equals the row called alone, bit for bit.
//
// A format supplies Dec:
//   kQ                            0, or the one q the format stores (ternary: 2)
//   scale_planes(q)               scale planes S of the (S, k/g, o) tensor
//   build(T, stride, s, sstride, q)  the 2^q weights of one (group, column)
//                                 into T[e * stride], from its scales at
//                                 s[i * sstride] (Q > 0 fixes q)
//   Params / load(P, s, sstride, q) / weight(P, code, q)
//                                 the direct path's per-(group, column)
//                                 registers and the weight of one code
#pragma once

#include "common.cuh"

namespace repro {
namespace grouptable {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 3;  // stages of the cp.async ring
constexpr int kMaxBT = 8;

// The wrapper's plan (kernels/grouptable.py::plan). Within a ring stage of
// stage_bytes: the planes' bytes at 0, the scales of stage_groups groups at
// off_s, x (kMaxBT rows of stage_rows * 8) at off_x. Two table buffers of
// table_bytes follow the ring at off_t; smem bytes in all.
struct Plan {
  int splits, chunk, stage_rows, stage_bytes, off_s, off_x, stage_groups, off_t, table_bytes, smem;
};

// Groups of g rows that one stage touches at most, over the stages of
// `rows` byte rows into which every k-chunk of `chunk` byte rows is cut.
inline int stage_groups(int kc, int chunk, int rows, int g) {
  int most = 0;
  for (int c0 = 0; c0 < kc; c0 += chunk) {
    const int c1 = c0 + chunk < kc ? c0 + chunk : kc;
    for (int r0 = c0; r0 < c1; r0 += rows) {
      const int r1 = r0 + rows < c1 ? r0 + rows : c1;
      const int n = (r1 * 8 - 1) / g - r0 * 8 / g + 1;
      most = n > most ? n : most;
    }
  }
  return most;
}

// x[b][4h .. 4h + 3] of one byte row as f32: 4 bf16 or 4 f32 at p.
__device__ __forceinline__ void load_x4(const uint8_t* p, bool bf16, float (&v)[4]) {
  if (bf16) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(w.x << 16); v[1] = __uint_as_float(w.x & 0xffff0000u);
    v[2] = __uint_as_float(w.y << 16); v[3] = __uint_as_float(w.y & 0xffff0000u);
  } else {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
}

// One block's work: columns blockIdx.x, rows blockIdx.y and k-chunk `split`
// of `splits`, of one (x, planes, scales) product. Q > 0 fixes q at compile
// time (the main path's q = 4); Q = 0 takes q at run time.
template <typename ST, typename Dec, int NS, int BT, int Q, bool TABLE>
__device__ __forceinline__ void grouptable_block(const void* __restrict__ xv, int x_bf16,
                                                 const uint8_t* __restrict__ packed, const ST* __restrict__ scales,
                                                 float* __restrict__ out, float* __restrict__ scratch,
                                                 unsigned* __restrict__ tickets, int B, int k, int o, int q, int g,
                                                 Plan p, int split, int splits) {
  constexpr int BC = 32 * NS;  // columns of a block
  extern __shared__ __align__(16) uint8_t smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o0 = blockIdx.x * BC, b0 = blockIdx.y * BT;
  if constexpr (Q > 0) q = Q;
  const int kc = k / 8, G = k / g, S = Dec::scale_planes(q), E = 1 << q;
  const int c0 = split * p.chunk, c1 = min(kc, c0 + p.chunk);
  const int SR = p.stage_rows;
  const int nstage = (c1 - c0 + SR - 1) / SR;
  const int xb = x_bf16 ? 2 : 4;
  const int valid = min(BC, o - o0);
  const bool full = valid == BC;
  const bool vec_p = full && o % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool vec_s = full && (o * sizeof(ST)) % 16 == 0 && reinterpret_cast<uintptr_t>(scales) % 16 == 0;

  // Stage t covers byte rows [r0, r1).
  auto rows_of = [&](int t, int& r0, int& r1) {
    r0 = c0 + t * SR;
    r1 = min(c1, r0 + SR);
  };
  auto ring = [&](int t) { return smem + (t % kRing) * p.stage_bytes; };
  auto table = [&](int t) { return reinterpret_cast<float*>(smem + p.off_t + (t & 1) * p.table_bytes); };

  // Stage t into its ring buffer: the q planes' bytes as [plane][nr][BC],
  // the scales of its groups as [plane][ngrp][BC], x rows b0 .. b0 + BT - 1
  // (zero past B) as [BT][SR * 8].
  auto stage = [&](int t) {
    uint8_t* const buf = ring(t);
    int r0, r1;
    rows_of(t, r0, r1);
    const int nr = r1 - r0;
    copy_lines<kThreads>(buf, packed, q * nr, BC, valid, vec_p,
                         [&](int i) { return (static_cast<size_t>(i / nr) * kc + r0 + i % nr) * o + o0; });
    const int ga = r0 * 8 / g, ngrp = (r1 * 8 - 1) / g - ga + 1;
    copy_lines<kThreads>(reinterpret_cast<ST*>(buf + p.off_s), scales, S * ngrp, BC, valid, vec_s,
                         [&](int i) { return (static_cast<size_t>(i / ngrp) * G + ga + i % ngrp) * o + o0; });
    copy_x_rows<kThreads, BT>(buf + p.off_x, xv, xb, B, b0, k, r0, nr, SR);
  };

  // The tables of stage t's groups, [group][entry][column], one
  // (group, column) pair a thread.
  auto build = [&](int t) {
    int r0, r1;
    rows_of(t, r0, r1);
    const int ngrp = (r1 * 8 - 1) / g - r0 * 8 / g + 1;
    const ST* const ss = reinterpret_cast<const ST*>(ring(t) + p.off_s);
    float* const tab = table(t);
    for (int e = threadIdx.x; e < ngrp * BC; e += kThreads) {
      const int gl = e / BC, col = e % BC;
      Dec::template build<Q>(tab + gl * E * BC + col, BC, ss + gl * BC + col, ngrp * BC, q);
    }
  };

  float acc[BT][NS];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < NS; ++c) acc[b][c] = 0.f;

  stage(0);
  cp_async_commit();
  if (nstage > 1) stage(1);
  cp_async_commit();
  if constexpr (TABLE) {
    cp_async_wait<1>();
    __syncthreads();
    build(0);
  }
  for (int t = 0; t < nstage; ++t) {
    cp_async_wait<0>();  // stages t and t + 1 have landed
    __syncthreads();      // ... for every thread; table t is built; stage t - 1 is no longer read
    if (t + 2 < nstage) stage(t + 2);  // into the buffer of stage t - 1
    cp_async_commit();
    if constexpr (TABLE) {
      if (t + 1 < nstage) build(t + 1);  // into the buffer of table t - 1
    }

    const uint8_t* const buf = ring(t);
    const ST* const ss = reinterpret_cast<const ST*>(buf + p.off_s);
    const uint8_t* const xs = buf + p.off_x;
    const float* const tab = table(t);
    int r0, r1;
    rows_of(t, r0, r1);
    const int nr = r1 - r0, ga = r0 * 8 / g, ngrp = (r1 * 8 - 1) / g - ga + 1;
    for (int r = r0 + (warp - r0 % kWarps + kWarps) % kWarps; r < r1; r += kWarps) {
      const int gl = r * 8 / g - ga;
      const int rr = r - r0;
      // the 8 q-bit codes of this byte row and column: byte j of lo (rows
      // 0-3) and hi (rows 4-7); (n * 0x204081) & 0x01010101 moves bit j of
      // a nibble n to bit 8 j, shifted by i for plane i
      uint32_t lo[NS], hi[NS];
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        lo[c] = 0;
        hi[c] = 0;
#pragma unroll
        for (int i = 0; i < (Q > 0 ? Q : kMaxQ); ++i) {
          if (Q > 0 || i < q) {
            const uint32_t byte = buf[(i * nr + rr) * BC + c * 32 + lane];
            lo[c] |= ((byte & 0xfu) * (0x204081u << i)) & (0x01010101u << i);
            hi[c] |= ((byte >> 4) * (0x204081u << i)) & (0x01010101u << i);
          }
        }
      }
      typename Dec::Params par[TABLE ? 1 : NS];
      if constexpr (!TABLE) {
#pragma unroll
        for (int c = 0; c < NS; ++c) Dec::load(par[c], ss + gl * BC + c * 32 + lane, ngrp * BC, q);
      }
      const float* const tg = tab + gl * E * BC + lane;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float xr[BT][4];
#pragma unroll
        for (int b = 0; b < BT; ++b) load_x4(xs + (b * SR * 8 + rr * 8 + 4 * h) * xb, x_bf16, xr[b]);
#pragma unroll
        for (int c = 0; c < NS; ++c) {
          const uint32_t codes = h ? hi[c] : lo[c];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t code = (codes >> (8 * j)) & 0xffu;
            float w;
            if constexpr (TABLE) {
              w = tg[code * BC + c * 32];
            } else {
              w = Dec::weight(par[c], code, q);
            }
#pragma unroll
            for (int b = 0; b < BT; ++b) acc[b][c] = fmaf(xr[b][j], w, acc[b][c]);
          }
        }
      }
    }
  }
  __syncthreads();  // the ring and the tables are no longer read

  // the warps' sums, then the k-chunks' partials, in order
  float* const red = reinterpret_cast<float*>(smem);  // [warp][BT][BC]
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < NS; ++c) red[(warp * BT + b) * BC + c * 32 + lane] = acc[b][c];
  __syncthreads();
  finish_split_at<kThreads, kWarps, BT, BC>(red, out, scratch, tickets, B, o, b0, o0, valid, split, splits);
}

// K1 / K2, K5 and K4's CUDA-core path: one product, the k-chunk in blockIdx.z.
template <typename ST, typename Dec, int NS, int BT, int Q, bool TABLE>
__global__ void __launch_bounds__(kThreads, 2)
grouptable_kernel(const void* __restrict__ xv, int x_bf16, const uint8_t* __restrict__ packed,
                  const ST* __restrict__ scales, float* __restrict__ out, float* __restrict__ scratch,
                  unsigned* __restrict__ tickets, int B, int k, int o, int q, int g, Plan p) {
  grouptable_block<ST, Dec, NS, BT, Q, TABLE>(xv, x_bf16, packed, scales, out, scratch, tickets, B, k, o, q, g, p,
                                              blockIdx.z, gridDim.z);
}

// K12 (kernels/expert_mm.py): every expert of a bank in one launch.
// blockIdx.z = expert * splits + chunk; each block offsets x (B rows of
// expert e start at e * x_estride elements), the planes, the scales, out
// (e * out_estride floats), the split's scratch (splits * B * o floats an
// expert) and its tickets (one an expert's (column tile, batch tile)) by its
// expert, then runs the single-product block on that expert with the same
// plan: each expert's rows get the bits of the kernel called on it alone.
template <typename ST, typename Dec, int NS, int BT, int Q, bool TABLE>
__global__ void __launch_bounds__(kThreads, 2)
expert_grouptable_kernel(const void* __restrict__ xv, int x_bf16, const uint8_t* __restrict__ packed,
                         const ST* __restrict__ scales, float* __restrict__ out, float* __restrict__ scratch,
                         unsigned* __restrict__ tickets, int B, int k, int o, int q, int g, Plan p,
                         long long x_estride, long long out_estride) {
  const int e = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int qq = Q > 0 ? Q : q;
  const size_t pe = static_cast<size_t>(qq) * (k / 8) * o, se = static_cast<size_t>(Dec::scale_planes(qq)) * (k / g) * o;
  const uint8_t* const xe = static_cast<const uint8_t*>(xv) + e * x_estride * (x_bf16 ? 2 : 4);
  grouptable_block<ST, Dec, NS, BT, Q, TABLE>(
      xe, x_bf16, packed + e * pe, scales + e * se, out + e * out_estride,
      scratch == nullptr ? nullptr : scratch + static_cast<size_t>(e) * p.splits * B * o,
      tickets == nullptr ? nullptr : tickets + static_cast<size_t>(e) * gridDim.x * gridDim.y, B, k, o, q, g, p,
      split, p.splits);
}

struct Args {
  const void* x;
  int x_bf16;
  const void* packed;
  const void* scales;
  float* out;
  float* scratch;
  unsigned* tickets;
  int B, k, o, q, g;
  Plan p;
  int experts;  // 0: one product (grouptable_kernel); else a bank (expert_grouptable_kernel)
  long long x_estride, out_estride;
};

// Opts `kernel` in to `smem` bytes of dynamic shared memory, once per size
// grown to (attr: the largest opt-in made so far for this kernel).
template <typename K>
cudaError_t opt_in(K kernel, int smem, int& attr) {
  if (smem > attr) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr = smem;
  }
  return cudaSuccess;
}

template <typename ST, typename Dec, int NS, int BT, int Q, bool TABLE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int BC = 32 * NS;
  auto kernel = grouptable_kernel<ST, Dec, NS, BT, Q, TABLE>;
  static int attr = 0;  // per instantiation
  cudaError_t err = opt_in(kernel, a.p.smem, attr);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.o + BC - 1) / BC, (a.B + BT - 1) / BT, a.p.splits);
  kernel<<<grid, kThreads, a.p.smem, stream>>>(a.x, a.x_bf16, static_cast<const uint8_t*>(a.packed),
                                               static_cast<const ST*>(a.scales), a.out, a.scratch, a.tickets, a.B,
                                               a.k, a.o, a.q, a.g, a.p);
  return cudaGetLastError();
}

// K12 takes row tiles of 8 only: an MoE buffer's capacity is a multiple of 8
// (and a shorter call's missing rows are zeros that nothing writes back), so
// one instantiation a path serves every bank, and the row tile changes no
// row's sum.
template <typename ST, typename Dec, int NS, int Q, bool TABLE>
cudaError_t launch_grouped(const Args& a, cudaStream_t stream) {
  constexpr int BC = 32 * NS, BT = kMaxBT;
  auto kernel = expert_grouptable_kernel<ST, Dec, NS, BT, Q, TABLE>;
  static int attr = 0;
  cudaError_t err = opt_in(kernel, a.p.smem, attr);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.o + BC - 1) / BC, (a.B + BT - 1) / BT, a.p.splits * a.experts);
  kernel<<<grid, kThreads, a.p.smem, stream>>>(a.x, a.x_bf16, static_cast<const uint8_t*>(a.packed),
                                               static_cast<const ST*>(a.scales), a.out, a.scratch, a.tickets, a.B,
                                               a.k, a.o, a.q, a.g, a.p, a.x_estride, a.out_estride);
  return cudaGetLastError();
}

template <typename ST, typename Dec, int NS, int Q, bool TABLE>
cudaError_t launch_bt(const Args& a, cudaStream_t st) {
  if (a.experts > 0) return launch_grouped<ST, Dec, NS, Q, TABLE>(a, st);
  switch (row_tile(a.B)) {
    case 1: return launch<ST, Dec, NS, 1, Q, TABLE>(a, st);
    case 2: return launch<ST, Dec, NS, 2, Q, TABLE>(a, st);
    case 4: return launch<ST, Dec, NS, 4, Q, TABLE>(a, st);
    default: return launch<ST, Dec, NS, 8, Q, TABLE>(a, st);
  }
}

// The table path at q = 4 with 4 columns a lane (the main path), at any
// other q with 4 or 1 columns a lane; the direct path with 4. A format of
// one q (Dec::kQ) fixes it at compile time on both paths.
template <typename ST, typename Dec>
cudaError_t launch_path(const Args& a, int table, int ns, cudaStream_t st) {
  if constexpr (Dec::kQ > 0) {
    if (table) return launch_bt<ST, Dec, 4, Dec::kQ, true>(a, st);
    return launch_bt<ST, Dec, 4, Dec::kQ, false>(a, st);
  } else {
    if (!table) return launch_bt<ST, Dec, 4, 0, false>(a, st);
    if (ns == 1) return launch_bt<ST, Dec, 1, 0, true>(a, st);
    if (a.q == 4) return launch_bt<ST, Dec, 4, 4, true>(a, st);
    return launch_bt<ST, Dec, 4, 0, true>(a, st);
  }
}

// The C entry of a format: checks the plan against the shapes, then
// launches. scratch holds splits * B * o floats and tickets one zeroed
// counter per (column tile, batch tile) when splits > 1, each E times over
// for a bank of E = experts (experts = 0: one product).
template <typename Dec>
int entry(const void* x, int x_dtype, const void* packed, const void* scales, int s_dtype, void* out,
          void* scratch, void* tickets, int B, int k, int o, int q, int g, int table, int ns, const Plan& p,
          void* stream, int experts = 0, long long x_estride = 0, long long out_estride = 0) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  const int kc = k / 8;
  if (experts < 0 || (experts > 0 && (static_cast<long long>(experts) * p.splits > 65535 || x_estride < 1LL * B * k ||
                                      out_estride < 1LL * B * o)))
    return cudaErrorInvalidValue;
  if (q < 1 || q > kMaxQ || (Dec::kQ > 0 && (q != Dec::kQ || ns != 4)) || g <= 0 || g % 8 != 0 ||
      k % g != 0 || (ns != 1 && ns != 4) || (ns == 1 && !table) || p.splits < 1 || p.chunk < 1 ||
      static_cast<long long>(p.chunk) * p.splits < kc || p.chunk * (p.splits - 1) >= kc ||
      (x_dtype != kF32 && x_dtype != kBF16) || (s_dtype != kF32 && s_dtype != kBF16) ||
      (p.splits > 1 && (scratch == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const long long bc = 32 * ns, sr = p.stage_rows, xb = x_dtype == kBF16 ? 2 : 4,
                  sb = s_dtype == kBF16 ? 2 : 4;
  if (sr < 1 || p.stage_groups < stage_groups(kc, p.chunk, p.stage_rows, g) || p.stage_bytes % 16 ||
      p.off_s % 16 || p.off_x % 16 || p.off_t % 16 || p.table_bytes % 16 || p.off_s < q * sr * bc ||
      p.off_x < p.off_s + Dec::scale_planes(q) * p.stage_groups * bc * sb ||
      p.stage_bytes < p.off_x + kMaxBT * sr * 8 * xb || p.off_t < kRing * static_cast<long long>(p.stage_bytes) ||
      (table && p.table_bytes < p.stage_groups * (1LL << q) * bc * 4) ||
      p.smem < p.off_t + 2LL * p.table_bytes || p.smem < kWarps * kMaxBT * bc * 4)
    return cudaErrorInvalidValue;
  if (B <= 0 || o <= 0) return cudaSuccess;
  const Args a{x,    x_dtype == kBF16, packed, scales, static_cast<float*>(out), static_cast<float*>(scratch),
               static_cast<unsigned*>(tickets), B, k, o, q, g, p, experts, x_estride, out_estride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = s_dtype == kF32 ? launch_path<float, Dec>(a, table, ns, st)
                                          : launch_path<__nv_bfloat16, Dec>(a, table, ns, st);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace grouptable
}  // namespace repro

// The exported C entry of a format's kernel: x (B, k) f32/bf16; packed
// (q, k/8, o) u8; scales (S, k/g, o) f32/bf16; out (B, o) f32, all
// contiguous; the plan's fields (kernels/grouptable.py::plan) after g.
#define REPRO_GROUPTABLE_ENTRY(NAME, DEC)                                                            \
  extern "C" int NAME(const void* x, int x_dtype, const void* packed, const void* scales, int s_dtype, \
                      void* out, void* scratch, void* tickets, int B, int k, int o, int q, int g,      \
                      int table, int ns, int splits, int chunk, int stage_rows, int stage_bytes,      \
                      int off_s, int off_x, int stage_groups, int off_t, int table_bytes, int smem,   \
                      void* stream) {                                                                \
    const repro::grouptable::Plan p{splits, chunk,        stage_rows, stage_bytes, off_s,            \
                                    off_x,  stage_groups, off_t,      table_bytes, smem};            \
    return repro::grouptable::entry<DEC>(x, x_dtype, packed, scales, s_dtype, out, scratch, tickets, B, \
                                         k, o, q, g, table, ns, p, stream);                           \
  }

// K12's C entry of a format: the same, over a bank of `experts` experts:
// x (E, ..., k) whose expert e's B rows start at e * x_estride elements;
// packed (E, q, k/8, o); scales (E, S, k/g, o); out's expert e at
// e * out_estride floats.
#define REPRO_GROUPTABLE_GROUPED_ENTRY(NAME, DEC)                                                    \
  extern "C" int NAME(const void* x, int x_dtype, const void* packed, const void* scales, int s_dtype, \
                      void* out, void* scratch, void* tickets, int B, int k, int o, int q, int g,      \
                      int table, int ns, int splits, int chunk, int stage_rows, int stage_bytes,      \
                      int off_s, int off_x, int stage_groups, int off_t, int table_bytes, int smem,   \
                      int experts, long long x_estride, long long out_estride, void* stream) {         \
    const repro::grouptable::Plan p{splits, chunk,        stage_rows, stage_bytes, off_s,            \
                                    off_x,  stage_groups, off_t,      table_bytes, smem};            \
    if (experts < 1) return cudaErrorInvalidValue;                                                   \
    return repro::grouptable::entry<DEC>(x, x_dtype, packed, scales, s_dtype, out, scratch, tickets, B, \
                                         k, o, q, g, table, ns, p, stream, experts, x_estride,        \
                                         out_estride);                                                \
  }

// The group-table skeleton shared by bcq_mm (K1/K2), uniform_mm (K5), the
// CUDA-core path of ternary_mm (K4) and, over a bank of MoE experts in one
// launch, expert_mm (K12: expert_block and expert_grouptable_kernel below):
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
// K12, a bank of E experts (x (E, C, k), one or two banks over it):
//  - What held the first version (K1's block with the expert in grid z) at
//    15.5x its byte bound at an olmoe-1b-7b decode step (NVIDIA H100 80GB
//    HBM3, 700 W): K1's one-expert plan splits k into chunks of 8 byte rows
//    (32 at k = 2048), so a bank was 16 384 blocks of one byte row a warp
//    writing 64 MB of split scratch that the last block of each tile read
//    back; every expert was computed though at B = 4 with top-8 at most 32
//    of 64 hold a token; gate and up were two launches over one buffer;
//    prefill capacities went in slabs.
//  - A block owns a column tile, a row tile of 8 and one expert of one
//    bank, and walks all of k in the k-chunks of K1's one-expert plan,
//    adding a row's sums in finish_split_at's order (each chunk's warp sums
//    in warp order from 0.f, the chunks' partials in chunk order from 0.f)
//    in registers: an expert's rows are K1's bits on that expert, with no
//    scratch, no tickets, one launch a bank at any capacity. Two walks:
//  - The column walk (expert_cols_block), where the chunks are 8 byte rows
//    (olmoe-1b-7b's banks, any bank whose one-expert plan needs no coarser
//    split): warp w of K1 then holds row c0 + w of a chunk alone, so the
//    warp-order sum is a row-order sum and one thread can make it. 4 warps
//    own 32 columns each, one a thread, and walk the rows of k in order,
//    stages of 8-16 rows over all of k in K1's ring: one barrier a stage,
//    nothing in shared memory but the ring and the tables. (Rings of 4 and
//    6 stages and 32-row stages measured no faster, NVIDIA H100 80GB HBM3,
//    700 W: each row's ~95 instructions pace it, not the copies.)
//  - The chunk walk (expert_block), for chunks of other sizes: K1's block
//    (8 warps share 32 NS columns, warp w the rows = w mod 8) over every
//    chunk in turn, its warps' sums meeting in shared memory after the
//    tables at each chunk's end (32 KB more; two barriers a chunk).
//  - The column tile: 128 columns. A B = 4 olmoe step has at most 32 live
//    experts: gate + up in one launch give 32 x 8 column tiles x 2 banks =
//    512 blocks, down 32 x 16 = 512, at least two blocks on each of 132
//    SMs (264); the column walk's ~50 KB a block lets four share an SM, so
//    each launch is one wave. The chunk walk at 8-row chunks measured ~3 us
//    a chunk a block, paced by its one-stage lookahead and two barriers a
//    chunk (NVIDIA H100 80GB HBM3, 700 W).
//  - rows[e] (the dispatch's counts, on the device): a row tile at or past
//    it exits before it reads a byte; the others pick the smallest row tile
//    of {1, 2, 4, 8} covering their live rows, so a lone token does one
//    FMA a weight, not eight. No row's sum depends on the tile.
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

#include <type_traits>

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

// Warp `warp`'s share of one staged stage of byte rows [r0, r1) (its ring
// buffer buf: planes at 0, scales at ss, x at xs; its tables at tab): the
// rows r = warp (mod kWarps) in order, each row's 8 k in order, added into
// acc with fmaf. K1's block and K12's walk their stages through it alike.
template <typename ST, typename Dec, int NS, int BT, int Q, bool TABLE>
__device__ __forceinline__ void stage_fma(float (&acc)[BT][NS], const uint8_t* __restrict__ buf,
                                          const ST* __restrict__ ss, const uint8_t* __restrict__ xs,
                                          const float* __restrict__ tab, int r0, int r1, int g, int q, int SR,
                                          int x_bf16) {
  constexpr int BC = 32 * NS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int E = 1 << q, xb = x_bf16 ? 2 : 4;
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

    int r0, r1;
    rows_of(t, r0, r1);
    const uint8_t* const buf = ring(t);
    stage_fma<ST, Dec, NS, BT, Q, TABLE>(acc, buf, reinterpret_cast<const ST*>(buf + p.off_s), buf + p.off_x, table(t),
                                         r0, r1, g, q, SR, x_bf16);
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

// K12's chunk walk (kernels/expert_mm.py): rows b0 .. b0 + BT - 1 (live
// of them are computed, the rest of the tile is neither read nor written)
// and the columns blockIdx.x of one expert's product, over all of k: the
// block walks every k-chunk of the one-expert plan in chunk order, each
// chunk's stages as K1's block walks them (stage_fma: warp w the rows = w
// mod 8), and at a chunk's end adds the warps' sums in warp order (from
// 0.f, in red) and that chunk's partial into its running total (from 0.f),
// in registers. That is finish_split_at's order, so each expert's rows get
// the bits of K1 on that expert alone; nothing goes through scratch.
template <typename ST, typename Dec, int NS, int BT, int Q, bool TABLE>
__device__ __forceinline__ void expert_block(const void* __restrict__ xv, int x_bf16,
                                             const uint8_t* __restrict__ packed, const ST* __restrict__ scales,
                                             float* __restrict__ out, int b0, int live, int k, int o, int q, int g,
                                             const Plan& p) {
  constexpr int BC = 32 * NS;
  constexpr int PER = (BT * BC + kThreads - 1) / kThreads;  // outputs a thread adds up
  extern __shared__ __align__(16) uint8_t smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o0 = blockIdx.x * BC;
  if constexpr (Q > 0) q = Q;
  const int kc = k / 8, G = k / g, S = Dec::scale_planes(q), E = 1 << q;
  const int SR = p.stage_rows, per_chunk = (p.chunk + SR - 1) / SR;
  const int last = kc - (p.splits - 1) * p.chunk;
  const int nstage = (p.splits - 1) * per_chunk + (last + SR - 1) / SR;
  const int xb = x_bf16 ? 2 : 4, rows = b0 + live;
  const int valid = min(BC, o - o0);
  const bool full = valid == BC;
  const bool vec_p = full && o % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool vec_s = full && (o * sizeof(ST)) % 16 == 0 && reinterpret_cast<uintptr_t>(scales) % 16 == 0;

  // Stage t covers byte rows [r0, r1) of chunk t / per_chunk; it is that chunk's last when r1 == c1.
  auto rows_of = [&](int t, int& r0, int& r1, int& c1) {
    const int c0 = t / per_chunk * p.chunk;
    c1 = min(kc, c0 + p.chunk);
    r0 = c0 + t % per_chunk * SR;
    r1 = min(c1, r0 + SR);
  };
  auto ring = [&](int t) { return smem + (t % kRing) * p.stage_bytes; };
  auto table = [&](int t) { return reinterpret_cast<float*>(smem + p.off_t + (t & 1) * p.table_bytes); };
  float* const red = reinterpret_cast<float*>(smem + p.off_t + 2 * p.table_bytes);  // [warp][BT][BC]

  auto stage = [&](int t) {
    uint8_t* const buf = ring(t);
    int r0, r1, c1;
    rows_of(t, r0, r1, c1);
    const int nr = r1 - r0;
    copy_lines<kThreads>(buf, packed, q * nr, BC, valid, vec_p,
                         [&](int i) { return (static_cast<size_t>(i / nr) * kc + r0 + i % nr) * o + o0; });
    const int ga = r0 * 8 / g, ngrp = (r1 * 8 - 1) / g - ga + 1;
    copy_lines<kThreads>(reinterpret_cast<ST*>(buf + p.off_s), scales, S * ngrp, BC, valid, vec_s,
                         [&](int i) { return (static_cast<size_t>(i / ngrp) * G + ga + i % ngrp) * o + o0; });
    copy_x_rows<kThreads, BT>(buf + p.off_x, xv, xb, rows, b0, k, r0, nr, SR);
  };
  auto build = [&](int t) {
    int r0, r1, c1;
    rows_of(t, r0, r1, c1);
    const int ngrp = (r1 * 8 - 1) / g - r0 * 8 / g + 1;
    const ST* const ss = reinterpret_cast<const ST*>(ring(t) + p.off_s);
    float* const tab = table(t);
    for (int e = threadIdx.x; e < ngrp * BC; e += kThreads) {
      const int gl = e / BC, col = e % BC;
      Dec::template build<Q>(tab + gl * E * BC + col, BC, ss + gl * BC + col, ngrp * BC, q);
    }
  };

  float acc[BT][NS], total[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) total[i] = 0.f;
  auto clear = [&]() {
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int c = 0; c < NS; ++c) acc[b][c] = 0.f;
  };
  clear();

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
    __syncthreads();      // ... for every thread; table t is built; stage t - 1 and red are no longer read
    if (t + 2 < nstage) stage(t + 2);
    cp_async_commit();
    if constexpr (TABLE) {
      if (t + 1 < nstage) build(t + 1);
    }
    int r0, r1, c1;
    rows_of(t, r0, r1, c1);
    const uint8_t* const buf = ring(t);
    stage_fma<ST, Dec, NS, BT, Q, TABLE>(acc, buf, reinterpret_cast<const ST*>(buf + p.off_s), buf + p.off_x,
                                         table(t), r0, r1, g, q, SR, x_bf16);
    if (r1 == c1) {  // the chunk's last stage: its warps' sums in warp order, then into the total
#pragma unroll
      for (int b = 0; b < BT; ++b)
#pragma unroll
        for (int c = 0; c < NS; ++c) red[(warp * BT + b) * BC + c * 32 + lane] = acc[b][c];
      clear();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = threadIdx.x + i * kThreads;
        if (e < BT * BC) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) sum += red[w * BT * BC + e];
          total[i] += sum;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * kThreads, b = e / BC, cl = e % BC;
    if (e < BT * BC && b < live && cl < valid) out[static_cast<size_t>(b0 + b) * o + o0 + cl] = total[i];
  }
}

// K12's column walk, for one-expert plans whose k-chunks are 8 byte rows
// starting at multiples of 8 (or one chunk of at most 8): then warp w of
// K1's block sums exactly row c0 + w of a chunk, so a chunk's warp-order
// sum is its rows' sums in row order. kColWarps warps each own 32 columns
// (lane l of warp w column w 32 + l) and walk every row of k in order, one
// thread per column: a row's 8 k from 0.f with fmaf, added into the chunk's
// sum, which joins the total at the chunk's last row. No warp waits for
// another's sums: one barrier a stage, stages of any rows
// (plan.stage_rows, over all of k), no shared memory for sums.
constexpr int kColWarps = 4;
constexpr int kColThreads = 32 * kColWarps;

template <typename ST, typename Dec, int BT, int Q, bool TABLE>
__device__ __forceinline__ void expert_cols_block(const void* __restrict__ xv, int x_bf16,
                                                  const uint8_t* __restrict__ packed, const ST* __restrict__ scales,
                                                  float* __restrict__ out, int b0, int live, int k, int o, int q,
                                                  int g, const Plan& p) {
  constexpr int BC = kColThreads;  // columns of a block
  extern __shared__ __align__(16) uint8_t smem[];

  const int col = threadIdx.x;
  const int o0 = blockIdx.x * BC;
  if constexpr (Q > 0) q = Q;
  const int kc = k / 8, G = k / g, S = Dec::scale_planes(q), E = 1 << q;
  const int SR = p.stage_rows, nstage = (kc + SR - 1) / SR;
  const int xb = x_bf16 ? 2 : 4, rows = b0 + live;
  const int valid = min(BC, o - o0);
  const bool full = valid == BC;
  const bool vec_p = full && o % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool vec_s = full && (o * sizeof(ST)) % 16 == 0 && reinterpret_cast<uintptr_t>(scales) % 16 == 0;

  auto rows_of = [&](int t, int& r0, int& r1) {
    r0 = t * SR;
    r1 = min(kc, r0 + SR);
  };
  auto ring = [&](int t) { return smem + (t % kRing) * p.stage_bytes; };
  auto table = [&](int t) { return reinterpret_cast<float*>(smem + p.off_t + (t & 1) * p.table_bytes); };
  // stage t: planes [plane][row][BC], scales [plane][group][BC], x [BT][SR * 8]; copies addressed by
  // loops over (plane, row) and (row, piece), with no division by a run-time count
  auto stage = [&](int t) {
    uint8_t* const buf = ring(t);
    int r0, r1;
    rows_of(t, r0, r1);
    const int nr = r1 - r0, ga = r0 * 8 / g, ngrp = (r1 * 8 - 1) / g - ga + 1;
    constexpr int PP = BC / 16;  // 16-byte pieces of a plane row
    const int pc = threadIdx.x % PP, r_first = threadIdx.x / PP;
    for (int i = 0; i < q; ++i)
      for (int r = r_first; r < nr; r += kColThreads / PP) {
        uint8_t* const dst = buf + (i * nr + r) * BC + pc * 16;
        const uint8_t* const src = packed + (static_cast<size_t>(i) * kc + r0 + r) * o + o0 + pc * 16;
        if (vec_p) {
          cp_async16(dst, src, 16);
        } else {
          for (int u = 0; u < 16; ++u) dst[u] = pc * 16 + u < valid ? src[u] : 0;
        }
      }
    constexpr int SP = BC * sizeof(ST) / 16;  // 16-byte pieces of a scale row
    for (int i = 0; i < S; ++i)
      for (int e = threadIdx.x; e < ngrp * SP; e += kColThreads) {
        const int gl = e / SP, piece = e % SP;
        ST* const dst = reinterpret_cast<ST*>(buf + p.off_s) + (i * ngrp + gl) * BC + piece * (16 / sizeof(ST));
        const ST* const src = scales + (static_cast<size_t>(i) * G + ga + gl) * o + o0 + piece * (16 / sizeof(ST));
        if (vec_s) {
          cp_async16(dst, src, 16);
        } else {
          for (int u = 0; u < static_cast<int>(16 / sizeof(ST)); ++u)
            dst[u] = piece * (16 / sizeof(ST)) + u < valid ? src[u] : ST(0.f);
        }
      }
    copy_x_rows<kColThreads, BT>(buf + p.off_x, xv, xb, rows, b0, k, r0, nr, SR);
  };
  auto build = [&](int t) {
    int r0, r1;
    rows_of(t, r0, r1);
    const int ngrp = (r1 * 8 - 1) / g - r0 * 8 / g + 1;
    const ST* const ss = reinterpret_cast<const ST*>(ring(t) + p.off_s);
    float* const tab = table(t);
    for (int e = threadIdx.x; e < ngrp * BC; e += kColThreads) {
      const int gl = e / BC, c = e % BC;
      Dec::template build<Q>(tab + gl * E * BC + c, BC, ss + gl * BC + c, ngrp * BC, q);
    }
  };

  float chunk[BT], total[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) chunk[b] = total[b] = 0.f;

  for (int t = 0; t < kRing - 1; ++t) {  // one commit group a stage, empty past the last
    if (t < nstage) stage(t);
    cp_async_commit();
  }
  if constexpr (TABLE) {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    build(0);
  }
  for (int t = 0; t < nstage; ++t) {
    cp_async_wait<kRing - 3>();  // stages t and t + 1 have landed
    __syncthreads();                 // ... for every thread; table t is built; stage t - 1 is no longer read
    if (t + kRing - 1 < nstage) stage(t + kRing - 1);  // into the buffer of stage t - 1
    cp_async_commit();
    if constexpr (TABLE) {
      if (t + 1 < nstage) build(t + 1);
    }
    const uint8_t* const buf = ring(t);
    const ST* const ss = reinterpret_cast<const ST*>(buf + p.off_s);
    const uint8_t* const xs = buf + p.off_x;
    int r0, r1;
    rows_of(t, r0, r1);
    const int nr = r1 - r0, ga = r0 * 8 / g;
    const int rpg = g / 8;  // byte rows a group
    int gl = 0, next_group = (ga + 1) * rpg;  // the row's group in the stage, and the row that starts the next
    const char* tg = reinterpret_cast<const char*>(table(t) + col);
#pragma unroll 2
    for (int r = r0; r < r1; ++r) {
      if (r == next_group) {
        ++gl;
        next_group += rpg;
        tg += E * BC * sizeof(float);
      }
      const int rr = r - r0;
      uint32_t lo = 0, hi = 0;  // the 8 codes of the row, as in stage_fma
#pragma unroll
      for (int i = 0; i < (Q > 0 ? Q : kMaxQ); ++i) {
        if (Q > 0 || i < q) {
          const uint32_t byte = buf[(i * nr + rr) * BC + col];
          lo |= ((byte & 0xfu) * (0x204081u << i)) & (0x01010101u << i);
          hi |= ((byte >> 4) * (0x204081u << i)) & (0x01010101u << i);
        }
      }
      typename Dec::Params par[1];
      if constexpr (!TABLE) Dec::load(par[0], ss + gl * BC + col, ((r1 * 8 - 1) / g - ga + 1) * BC, q);
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float xr[BT][4];
#pragma unroll
        for (int b = 0; b < BT; ++b) load_x4(xs + (b * SR * 8 + rr * 8 + 4 * h) * xb, x_bf16, xr[b]);
        const uint32_t codes = h ? hi : lo;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float w;
          if constexpr (TABLE) {  // entry `code` of the (group, column): code * BC floats on
            const uint32_t off = ((codes >> (8 * j)) & 0xffu) * (BC * sizeof(float));
            w = *reinterpret_cast<const float*>(tg + off);
          } else {
            w = Dec::weight(par[0], (codes >> (8 * j)) & 0xffu, q);
          }
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b] = fmaf(xr[b][j], w, acc[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) chunk[b] += acc[b];
      if ((r & 7) == 7 || r == kc - 1) {  // the chunk's last row
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          total[b] += chunk[b];
          chunk[b] = 0.f;
        }
      }
    }
  }
  if (col < valid) {
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (b < live) out[static_cast<size_t>(b0 + b) * o + o0 + col] = total[b];
  }
}

// One bank, or two over the same x (gate and up): blockIdx.z = expert *
// banks + bank, blockIdx.y the row tile of 8. A tile at or past rows[e]
// (C where rows is null) exits before it reads a byte; the others take the
// smallest row tile of {1, 2, 4, 8} that covers their live rows.
struct Bank {
  const uint8_t* packed;
  const void* scales;
  float* out;
};

// COLS: the column walk (expert_cols_block, kColThreads threads); else the
// chunk walk (expert_block, kThreads).
template <typename ST, typename Dec, int NS, int Q, bool TABLE, bool COLS>
__global__ void __launch_bounds__(COLS ? kColThreads : kThreads, COLS ? 4 : 2)
expert_grouptable_kernel(const void* __restrict__ xv, int x_bf16, Bank bank_a, Bank bank_b, int banks,
                         const int* __restrict__ rows, int C, int k, int o, int q, int g, Plan p) {
  const int e = blockIdx.z / banks, bank = blockIdx.z % banks;
  const int b0 = blockIdx.y * kMaxBT;
  const int n = rows == nullptr ? C : min(C, rows[e]);
  const int live = min(kMaxBT, n - b0);
  if (live <= 0) return;
  const Bank& bk = bank == 0 ? bank_a : bank_b;
  const int qq = Q > 0 ? Q : q;
  const size_t pe = static_cast<size_t>(qq) * (k / 8) * o, se = static_cast<size_t>(Dec::scale_planes(qq)) * (k / g) * o;
  const uint8_t* const xe = static_cast<const uint8_t*>(xv) + static_cast<size_t>(e) * C * k * (x_bf16 ? 2 : 4);
  const uint8_t* const pk = bk.packed + e * pe;
  const ST* const sc = static_cast<const ST*>(bk.scales) + e * se;
  float* const out = bk.out + static_cast<size_t>(e) * C * o;
  auto run = [&](auto bt) {
    constexpr int BT = decltype(bt)::value;
    if constexpr (COLS) {
      expert_cols_block<ST, Dec, BT, Q, TABLE>(xe, x_bf16, pk, sc, out, b0, live, k, o, q, g, p);
    } else {
      expert_block<ST, Dec, NS, BT, Q, TABLE>(xe, x_bf16, pk, sc, out, b0, live, k, o, q, g, p);
    }
  };
  switch (row_tile(live)) {
    case 1: run(std::integral_constant<int, 1>{}); break;
    case 2: run(std::integral_constant<int, 2>{}); break;
    case 4: run(std::integral_constant<int, 4>{}); break;
    default: run(std::integral_constant<int, 8>{});
  }
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
};

// K12's launch: x (E, C, k), one bank or two (gate and up) of E experts.
struct GroupedArgs {
  const void* x;
  int x_bf16;
  Bank bank[2];
  int banks;
  const int* rows;
  int E, C, k, o, q, g;
  Plan p;
  bool cols;  // the column walk
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

template <typename ST, typename Dec, int NS, int Q, bool TABLE>
cudaError_t launch_bt(const Args& a, cudaStream_t st) {
  switch (row_tile(a.B)) {
    case 1: return launch<ST, Dec, NS, 1, Q, TABLE>(a, st);
    case 2: return launch<ST, Dec, NS, 2, Q, TABLE>(a, st);
    case 4: return launch<ST, Dec, NS, 4, Q, TABLE>(a, st);
    default: return launch<ST, Dec, NS, 8, Q, TABLE>(a, st);
  }
}

// K12: one launch a bank (or pair), a block per (column tile, row tile of
// 8, expert and bank); each block picks its row tile by its live rows.
template <typename ST, typename Dec, int NS, int Q, bool TABLE, bool COLS>
cudaError_t launch_walk(const GroupedArgs& a, cudaStream_t stream) {
  constexpr int BC = COLS ? kColThreads : 32 * NS, NT = COLS ? kColThreads : kThreads;
  auto kernel = expert_grouptable_kernel<ST, Dec, NS, Q, TABLE, COLS>;
  static int attr = 0;
  cudaError_t err = opt_in(kernel, a.p.smem, attr);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.o + BC - 1) / BC, (a.C + kMaxBT - 1) / kMaxBT, a.E * a.banks);
  kernel<<<grid, NT, a.p.smem, stream>>>(a.x, a.x_bf16, a.bank[0], a.bank[1], a.banks, a.rows, a.C, a.k, a.o, a.q,
                                         a.g, a.p);
  return cudaGetLastError();
}

template <typename ST, typename Dec, int NS, int Q, bool TABLE>
cudaError_t launch_bt(const GroupedArgs& a, cudaStream_t st) {
  if (a.cols) return launch_walk<ST, Dec, 1, Q, TABLE, true>(a, st);
  return launch_walk<ST, Dec, NS, Q, TABLE, false>(a, st);
}

// The table path at q = 4 with 4 columns a lane (the main path), at any
// other q with 4 or 1 columns a lane; the direct path with 4. A format of
// one q (Dec::kQ) fixes it at compile time on both paths. K12's column walk
// takes one column a thread whatever NS says.
inline bool column_walk(const Args&) { return false; }
inline bool column_walk(const GroupedArgs& a) { return a.cols; }

template <typename ST, typename Dec, typename A>
cudaError_t launch_path(const A& a, int table, int ns, cudaStream_t st) {
  if constexpr (Dec::kQ > 0) {
    if (table) return launch_bt<ST, Dec, 4, Dec::kQ, true>(a, st);
    return launch_bt<ST, Dec, 4, Dec::kQ, false>(a, st);
  } else {
    if (!table) return launch_bt<ST, Dec, 4, 0, false>(a, st);
    if (ns == 1 && !column_walk(a)) return launch_bt<ST, Dec, 1, 0, true>(a, st);
    if (a.q == 4) return launch_bt<ST, Dec, 4, 4, true>(a, st);
    return launch_bt<ST, Dec, 4, 0, true>(a, st);
  }
}

// The checks of a plan against the shapes that K1's entry and K12's share.
// A plan of K12's column walk (cols) takes kColThreads columns a block, one
// a thread, and stages over all of k; its chunks must be 8 byte rows (or one
// of at most 8).
template <typename Dec>
bool plan_ok(int x_dtype, int s_dtype, int k, int q, int g, int table, int ns, const Plan& p, bool cols = false) {
  const int kc = k / 8;
  if (q < 1 || q > kMaxQ || (Dec::kQ > 0 && (q != Dec::kQ || (ns != 4 && !cols))) || g <= 0 || g % 8 != 0 ||
      k % g != 0 || (ns != 1 && ns != 4) || (ns == 1 && !table && !cols) || (cols && ns != 1) || p.splits < 1 ||
      p.chunk < 1 || static_cast<long long>(p.chunk) * p.splits < kc || p.chunk * (p.splits - 1) >= kc ||
      (cols && p.chunk != 8 && p.splits != 1) || (cols && p.chunk > 8) ||
      (x_dtype != kF32 && x_dtype != kBF16) || (s_dtype != kF32 && s_dtype != kBF16))
    return false;
  const long long bc = cols ? kColThreads : 32 * ns, sr = p.stage_rows, xb = x_dtype == kBF16 ? 2 : 4,
                  sb = s_dtype == kBF16 ? 2 : 4;
  return !(sr < 1 || p.stage_groups < stage_groups(kc, cols ? kc : p.chunk, p.stage_rows, g) || p.stage_bytes % 16 ||
           p.off_s % 16 || p.off_x % 16 || p.off_t % 16 || p.table_bytes % 16 || p.off_s < q * sr * bc ||
           p.off_x < p.off_s + Dec::scale_planes(q) * p.stage_groups * bc * sb ||
           p.stage_bytes < p.off_x + kMaxBT * sr * 8 * xb || p.off_t < kRing * static_cast<long long>(p.stage_bytes) ||
           (table && p.table_bytes < p.stage_groups * (1LL << q) * bc * 4) || p.smem < p.off_t + 2LL * p.table_bytes);
}

// The C entry of a format: checks the plan against the shapes, then
// launches. scratch holds splits * B * o floats and tickets one zeroed
// counter per (column tile, batch tile) when splits > 1.
template <typename Dec>
int entry(const void* x, int x_dtype, const void* packed, const void* scales, int s_dtype, void* out,
          void* scratch, void* tickets, int B, int k, int o, int q, int g, int table, int ns, const Plan& p,
          void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (!plan_ok<Dec>(x_dtype, s_dtype, k, q, g, table, ns, p) || p.smem < kWarps * kMaxBT * 32LL * ns * 4 ||
      (p.splits > 1 && (scratch == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  if (B <= 0 || o <= 0) return cudaSuccess;
  const Args a{x, x_dtype == kBF16, packed, scales, static_cast<float*>(out), static_cast<float*>(scratch),
               static_cast<unsigned*>(tickets), B, k, o, q, g, p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = s_dtype == kF32 ? launch_path<float, Dec>(a, table, ns, st)
                                          : launch_path<__nv_bfloat16, Dec>(a, table, ns, st);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// K12's C entry of a format: the same plan checks, plus room for the warps'
// sums after the tables; packed_b / scales_b / out_b null for one bank.
template <typename Dec>
int grouped_entry(const void* x, int x_dtype, const void* packed_a, const void* scales_a, void* out_a,
                  const void* packed_b, const void* scales_b, void* out_b, int s_dtype, const void* rows, int E,
                  int C, int k, int o, int q, int g, int table, int ns, const Plan& p, int col_warps, void* stream) {
  cudaGetLastError();
  const int banks = packed_b == nullptr ? 1 : 2;
  const bool cols = col_warps == kColWarps;
  if ((col_warps != 1 && !cols) || !plan_ok<Dec>(x_dtype, s_dtype, k, q, g, table, ns, p, cols) ||
      (!cols && p.smem < p.off_t + 2LL * p.table_bytes + kWarps * kMaxBT * 32LL * ns * 4) || E < 1 ||
      static_cast<long long>(E) * banks > 65535 || (banks == 2 && (scales_b == nullptr || out_b == nullptr)))
    return cudaErrorInvalidValue;
  if (C <= 0 || o <= 0) return cudaSuccess;
  const GroupedArgs a{x, x_dtype == kBF16,
                      {Bank{static_cast<const uint8_t*>(packed_a), scales_a, static_cast<float*>(out_a)},
                       Bank{static_cast<const uint8_t*>(packed_b), scales_b, static_cast<float*>(out_b)}},
                      banks, static_cast<const int*>(rows), E, C, k, o, q, g, p, cols};
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

// K12's C entry of a format: x (E, C, k) f32/bf16; bank a (and b, or
// null): packed (E, q, k/8, o) u8, scales (E, S, k/g, o), out (E, C, o)
// f32; rows (E,) device int32, or null for all C rows: expert e's rows at
// or past rows[e] are left as they are; the plan's fields after g, then
// its col_warps (1: the chunk walk; kColWarps: the column walk).
#define REPRO_GROUPTABLE_GROUPED_ENTRY(NAME, DEC)                                                        \
  extern "C" int NAME(const void* x, int x_dtype, const void* packed_a, const void* scales_a, void* out_a, \
                      const void* packed_b, const void* scales_b, void* out_b, int s_dtype,               \
                      const void* rows, int E, int C, int k, int o, int q, int g, int table, int ns,      \
                      int splits, int chunk, int stage_rows, int stage_bytes, int off_s, int off_x,       \
                      int stage_groups, int off_t, int table_bytes, int smem, int col_warps,              \
                      void* stream) {                                                                     \
    const repro::grouptable::Plan p{splits, chunk,        stage_rows, stage_bytes, off_s,                \
                                    off_x,  stage_groups, off_t,      table_bytes, smem};                \
    return repro::grouptable::grouped_entry<DEC>(x, x_dtype, packed_a, scales_a, out_a, packed_b,       \
                                                 scales_b, out_b, s_dtype, rows, E, C, k, o, q, g, table, \
                                                 ns, p, col_warps, stream);                               \
  }

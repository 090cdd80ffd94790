// lutgemm: the paper's LUT-based quantized matmul (LUT-GEMM, §III.B-C).
// y (B, o) f32 = x (B, k) @ sum_i alpha_i * b_i with packed sign planes.
//
// Replaces the TPU kernel src/repro/kernels/lutgemm.py::lutgemm
// (_lutgemm_kernel, _sign_patterns).
//
// Algorithm (the paper's, mu = 8): for every 8-activation chunk and batch
// row, a table of all 256 signed sums of the chunk's x, bit j of the key
// (LSB first) set meaning +x[8c + j]. A packed plane byte IS the key, so one
// table read replaces 8 sign-multiply-adds; each read is scaled by its
// group's alpha and summed over chunks and planes in f32.
//
// What bounds it: at B = 1 the plane bytes over the memory rate (q/8 bytes a
// weight: 0.545 ms for a llama3.2-3b decode step at q = 4 on an H100 SXM at
// 3.35 TB/s). From B ~ 2 up, the shared-memory lookups: each is a read at a
// data-dependent address, where a warp's 32 random keys meet in their
// busiest bank ~3.5 times (a 16-byte read, 8 lanes a pass: ~2.6 times),
// against one 128-byte pass a clock an SM.
//
// Design against that:
//  1. Tables at one add an entry, half of them stored. Lanes 0-15 of a warp
//     sum the half table L of activations 0-3 (bit j of the lane: +x), lanes
//     16-23 the 8 entries of H (activations 4-7) that keys < 128 need; two
//     shuffles give each lane T[key] = L[key & 15] + H[key >> 4] for 4 keys.
//     Only keys < 128 are stored: T[255 - key] = -T[key] exactly, so a key
//     >= 128 reads entry key ^ 0xff with alpha negated.
//  2. Each warp builds the table of its own chunk and reads only that one,
//     so no block-wide barrier separates building from lookups: one
//     __syncthreads a ring stage (its data landed, the oldest buffer free),
//     two __syncwarp a chunk.
//  3. Keys loaded wide and ahead of use. A block owns 128 adjacent columns,
//     4 a lane, so one 32-bit shared read gives a lane the keys of one chunk
//     and plane for its 4 columns. The planes' bytes, the scales of the
//     groups they touch and the x rows of a stage of `stage_chunks` chunks
//     stream into a 3-stage ring of shared memory with 16-byte cp.async
//     copies (element copies at a ragged or misaligned edge), so two stages
//     are in flight while one is used; a block reads each (group, column)
//     scale from device memory once. q = 4, the main path's, is fixed at
//     compile time, which unrolls the planes' lookups of a chunk.
//  4. One lookup for all of a block's batch rows: a table is laid out
//     [key][row] for a row tile BT in {1, 2, 4, 8}, so one 4-, 8- or 16-byte
//     read (two at BT = 8) returns a key's entry for all BT rows.
//  5. A plan that does not depend on B, summed in one launch. The wrapper's
//     plan (kernels/lutgemm.py::plan) fixes the k-split from (k, o, q) alone
//     so that every llama3.2-3b leaf puts two blocks of 8 warps on each of
//     132 SMs, with the split's partial sums under a quarter of the planes'
//     bytes at B = 4. Chunk c of a block's k-range goes to warp c mod 8
//     whatever the stage size, and a lane sums its chunks in order and each
//     chunk's planes in order; the warps' sums meet in warp order; with more
//     than one k-chunk, the last block of a column tile to arrive (an atomic
//     ticket) adds the chunks' partials in chunk order and resets the
//     ticket. So a row sums in one order at every B: row r of a B-row call
//     equals the row called alone, bit for bit, run to run.
//  6. Shared memory for two blocks an SM at every BT (three at BT <= 2 with
//     bf16 x, where registers allow 85 a thread): the plan halves a stage
//     until the ring and the warps' tables fit 112 KB.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 128;      // table entries kept a chunk: T[255 - key] = -T[key]
constexpr int kBlockCols = 128;  // output columns of a block, kCols (4) a lane
constexpr int kRing = 3;        // stages in flight
static_assert(kBlockCols == 32 * kCols, "a lane owns kCols adjacent columns");

// The wrapper's plan (kernels/lutgemm.py::plan) at this call's row tile:
// splits k-chunks of `chunk` byte rows; a ring stage of `stage_chunks` byte
// rows is `stage_bytes` long (planes, then the scales at off_s and x at
// off_x); the warps' tables ([kKeys][BT] f32 each) at off_t follow the
// ring; smem bytes in all.
struct Plan {
  int splits, chunk, stage_chunks, stage_bytes, off_s, off_x, off_t, smem;
};

// Groups of g rows that a window of `chunks` byte rows can touch (it starts
// at a multiple of 8 rows, anywhere in a group).
int stage_groups(int chunks, int g, int k) {
  const int n = (g - 8 + chunks * 8 - 1) / g + 1;
  return n < k / g ? n : k / g;
}

// BT consecutive floats at p (aligned to 4 BT bytes, 16 at most).
template <int BT>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[BT]) {
  if constexpr (BT == 1) {
    v[0] = p[0];
  } else if constexpr (BT == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x; v[1] = u.y;
  } else {
#pragma unroll
    for (int h = 0; h < BT; h += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + h);
      v[h] = u.x; v[h + 1] = u.y; v[h + 2] = u.z; v[h + 3] = u.w;
    }
  }
}

template <int BT>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[BT]) {
  if constexpr (BT == 1) {
    p[0] = v[0];
  } else if constexpr (BT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int h = 0; h < BT; h += 4)
      *reinterpret_cast<float4*>(p + h) = make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]);
  }
}

// Q > 0 fixes q at compile time (the main path's q = 4: the planes' lookups
// unrolled); Q = 0 takes q at run time.
template <typename ST, int BT, int Q>
__global__ void __launch_bounds__(kThreads, BT <= 2 ? 3 : 2)
lutgemm_kernel(const void* __restrict__ xv, int x_bf16, const uint8_t* __restrict__ packed,
               const ST* __restrict__ scales, float* __restrict__ out, float* __restrict__ scratch,
               unsigned* __restrict__ tickets, int B, int k, int o, int q, int g, Plan p) {
  extern __shared__ __align__(16) uint8_t smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o0 = blockIdx.x * kBlockCols, b0 = blockIdx.y * BT;
  if constexpr (Q > 0) q = Q;
  const int kc = k / 8, G = k / g, cpg = g / 8;
  const int c0 = blockIdx.z * p.chunk, c1 = min(kc, c0 + p.chunk);
  const int SC = p.stage_chunks;
  const int nstage = (c1 - c0 + SC - 1) / SC;
  const int xb = x_bf16 ? 2 : 4;
  const int valid = min(kBlockCols, o - o0);
  const bool vec_p = valid == kBlockCols && o % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool vec_s = valid == kBlockCols && (o * sizeof(ST)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  float* const wtable = reinterpret_cast<float*>(smem + p.off_t) + warp * kKeys * BT;  // [kKeys][BT]

  // Stage s of the block's chunk into ring buffer s % kRing: the q planes'
  // bytes of chunks [r0, r0 + nr) as [plane][SC][kBlockCols], the scales of
  // the groups they touch as [plane][group][kBlockCols], then x rows
  // b0 .. b0 + BT - 1 (zero past B) as [BT][SC * 8].
  auto stage = [&](int s) {
    uint8_t* const buf = smem + (s % kRing) * p.stage_bytes;
    const int r0 = c0 + s * SC, nr = min(SC, c1 - r0);
    const int ga = r0 / cpg, ngrp = (r0 + nr - 1) / cpg - ga + 1;
    ST* const ss = reinterpret_cast<ST*>(buf + p.off_s);
    if (vec_s) {
      constexpr int kPer = 16 / sizeof(ST), kPieces = kBlockCols / kPer;
      for (int e = threadIdx.x; e < q * ngrp * kPieces; e += kThreads) {
        const int line = e / kPieces, piece = e % kPieces, i = line / ngrp, gg = line % ngrp;
        cp_async16(ss + line * kBlockCols + piece * kPer,
                   scales + (static_cast<size_t>(i) * G + ga + gg) * o + o0 + piece * kPer, 16);
      }
    } else {
      for (int e = threadIdx.x; e < q * ngrp * kBlockCols; e += kThreads) {
        const int line = e / kBlockCols, col = e % kBlockCols, i = line / ngrp, gg = line % ngrp;
        ss[line * kBlockCols + col] =
            col < valid ? scales[(static_cast<size_t>(i) * G + ga + gg) * o + o0 + col] : ST(0.f);
      }
    }
    if (vec_p) {
      constexpr int kPieces = kBlockCols / 16;
      for (int e = threadIdx.x; e < q * nr * kPieces; e += kThreads) {
        const int line = e / kPieces, piece = e % kPieces, i = line / nr, c = line % nr;
        cp_async16(buf + (i * SC + c) * kBlockCols + piece * 16,
                   packed + (static_cast<size_t>(i) * kc + r0 + c) * o + o0 + piece * 16, 16);
      }
    } else {
      for (int e = threadIdx.x; e < q * nr * kBlockCols; e += kThreads) {
        const int line = e / kBlockCols, col = e % kBlockCols, i = line / nr, c = line % nr;
        buf[(i * SC + c) * kBlockCols + col] =
            col < valid ? packed[(static_cast<size_t>(i) * kc + r0 + c) * o + o0 + col] : 0;
      }
    }
    copy_x_rows<kThreads, BT>(buf + p.off_x, xv, xb, B, b0, k, r0, nr, SC);
  };

  float acc[BT][kCols];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < nstage) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // stage s has landed; every warp is done with stage s - 1
    if (s + kRing - 1 < nstage) stage(s + kRing - 1);  // into the buffer of stage s - 1
    cp_async_commit();

    const uint8_t* const buf = smem + (s % kRing) * p.stage_bytes;
    const int r0 = c0 + s * SC, nr = min(SC, c1 - r0);
    const int ga = r0 / cpg, ngrp = (r0 + nr - 1) / cpg - ga + 1;
    const ST* const ss = reinterpret_cast<const ST*>(buf + p.off_s);
    const uint8_t* const xs = buf + p.off_x;

    // chunk r0 + c goes to warp (r0 - c0 + c) mod kWarps, whatever the stage size
    for (int c = ((warp - (r0 - c0)) % kWarps + kWarps) % kWarps; c < nr; c += kWarps) {
      // 1. the chunk's table for this warp's own use. Lane l < 16 sums L[l] of
      //    x[8c .. 8c + 3], lane 16 + h sums H[h] of x[8c + 4 .. 8c + 7] (bit j
      //    of l or h set: +x, else -x; h < 8, so x[8c + 7] enters H negated);
      //    lane l then holds the entries of keys l + 32 m, m < 4:
      //    T[key] = L[key & 15] + H[key >> 4] = L[l & 15] + H[(l >> 4) + 2 m].
      float t[4][BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const int at = b * SC * 8 + c * 8 + (lane & 16) / 4;
        float xj[4];
        if (x_bf16) {
          const uint2 w = *reinterpret_cast<const uint2*>(xs + at * 2);
          xj[0] = __uint_as_float(w.x << 16); xj[1] = __uint_as_float(w.x & 0xffff0000u);
          xj[2] = __uint_as_float(w.y << 16); xj[3] = __uint_as_float(w.y & 0xffff0000u);
        } else {
          const float4 w = *reinterpret_cast<const float4*>(xs + at * 4);
          xj[0] = w.x; xj[1] = w.y; xj[2] = w.z; xj[3] = w.w;
        }
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) v += ((lane >> j) & 1) ? xj[j] : -xj[j];
        const float lo = __shfl_sync(0xffffffffu, v, lane & 15);
#pragma unroll
        for (int m = 0; m < 4; ++m) t[m][b] = lo + __shfl_sync(0xffffffffu, v, 16 + (lane >> 4) + 2 * m);
      }
      __syncwarp();  // the warp's lookups of its previous chunk are done
#pragma unroll
      for (int m = 0; m < 4; ++m) store_rows<BT>(wtable + (lane + 32 * m) * BT, t[m]);
      __syncwarp();

      // 2. lookups of the chunk's q planes, in plane order
      const int gl = (r0 + c) / cpg - ga;
#pragma unroll
      for (int i = 0; i < (Q > 0 ? Q : kMaxQ); ++i) {
        if (Q == 0 && i >= q) break;
        const uint32_t keys = *reinterpret_cast<const uint32_t*>(buf + (i * SC + c) * kBlockCols + kCols * lane);
        float alpha[kCols];
        load_scales4(ss + (i * ngrp + gl) * kBlockCols + kCols * lane, kCols, true, alpha);
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          // key >= 128 reads T[255 - key] = -T[key ^ 0xff] with alpha negated
          const uint32_t key = (keys >> (8 * cc)) & 0xffu, neg = key >> 7;
          const float a = neg ? -alpha[cc] : alpha[cc];
          float e[BT];
          load_rows<BT>(wtable + ((key ^ (0u - neg)) & 0x7fu) * BT, e);
#pragma unroll
          for (int b = 0; b < BT; ++b) acc[b][cc] = fmaf(a, e[b], acc[b][cc]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and tables are no longer read

  // the warps' sums, then the k-chunks' partials, in order
  float* const red = reinterpret_cast<float*>(smem);  // [warp][BT][kBlockCols]
#pragma unroll
  for (int b = 0; b < BT; ++b)
    *reinterpret_cast<float4*>(red + (warp * BT + b) * kBlockCols + kCols * lane) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  __syncthreads();
  finish_split<kThreads, kWarps, BT, kBlockCols>(red, out, scratch, tickets, B, o, b0, o0, valid);
}

template <typename ST, int BT, int Q>
cudaError_t launch(const void* x, int x_bf16, const void* packed, const void* scales, float* out,
                   float* scratch, unsigned* tickets, int B, int k, int o, int q, int g, const Plan& p,
                   cudaStream_t stream) {
  static int attr = 0;  // per instantiation: the largest opt-in made so far
  if (p.smem > attr) {
    cudaError_t err = cudaFuncSetAttribute(lutgemm_kernel<ST, BT, Q>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    attr = p.smem;
  }
  const dim3 grid((o + kBlockCols - 1) / kBlockCols, (B + BT - 1) / BT, p.splits);
  lutgemm_kernel<ST, BT, Q><<<grid, kThreads, p.smem, stream>>>(
      x, x_bf16, static_cast<const uint8_t*>(packed), static_cast<const ST*>(scales), out, scratch,
      tickets, B, k, o, q, g, p);
  return cudaGetLastError();
}

template <typename ST, int Q>
cudaError_t launch_bt(const void* x, int x_bf16, const void* packed, const void* scales, float* out,
                      float* scratch, unsigned* tickets, int B, int k, int o, int q, int g, const Plan& p,
                      cudaStream_t st) {
  switch (row_tile(B)) {
    case 1: return launch<ST, 1, Q>(x, x_bf16, packed, scales, out, scratch, tickets, B, k, o, q, g, p, st);
    case 2: return launch<ST, 2, Q>(x, x_bf16, packed, scales, out, scratch, tickets, B, k, o, q, g, p, st);
    case 4: return launch<ST, 4, Q>(x, x_bf16, packed, scales, out, scratch, tickets, B, k, o, q, g, p, st);
    default: return launch<ST, 8, Q>(x, x_bf16, packed, scales, out, scratch, tickets, B, k, o, q, g, p, st);
  }
}

template <typename ST>
cudaError_t launch_q(const void* x, int x_bf16, const void* packed, const void* scales, float* out,
                     float* scratch, unsigned* tickets, int B, int k, int o, int q, int g, const Plan& p,
                     cudaStream_t st) {
  if (q == 4) return launch_bt<ST, 4>(x, x_bf16, packed, scales, out, scratch, tickets, B, k, o, q, g, p, st);
  return launch_bt<ST, 0>(x, x_bf16, packed, scales, out, scratch, tickets, B, k, o, q, g, p, st);
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x (B, k) f32/bf16; packed (q, k/8, o) u8; scales (q, k/g, o) f32/bf16;
// out (B, o) f32. All contiguous. The plan's fields
// (kernels/lutgemm.py::plan, its stage for row_tile(B)): splits k-chunks of
// chunk byte rows; stage_chunks byte rows a ring stage of stage_bytes (the
// scales at off_s, x at off_x); the warps' tables at off_t; smem bytes in
// all. scratch holds splits * B * o floats and tickets one zeroed counter
// per (column tile, batch tile) when splits > 1.
extern "C" int lutgemm_launch(const void* x, int x_dtype, const void* packed, const void* scales,
                              int s_dtype, void* out, void* scratch, void* tickets, int B, int k, int o,
                              int q, int g, int splits, int chunk, int stage_chunks, int stage_bytes,
                              int off_s, int off_x, int off_t, int smem, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  const int kc = k / 8;
  const long long bt = row_tile(B), xb = x_dtype == kBF16 ? 2 : 4, sb = s_dtype == kBF16 ? 2 : 4;
  const long long sc = stage_chunks;
  if (q < 1 || q > kMaxQ || g <= 0 || g % 8 != 0 || k % g != 0 || splits < 1 || chunk < 1 ||
      static_cast<long long>(chunk) * splits < kc || chunk * (splits - 1) >= kc || sc < 1 ||
      stage_bytes % 16 || off_s % 16 || off_x % 16 || off_t % 16 || off_s < q * sc * kBlockCols ||
      off_x < off_s + q * stage_groups(stage_chunks, g, k) * kBlockCols * sb ||
      stage_bytes < off_x + bt * sc * 8 * xb || off_t < kRing * static_cast<long long>(stage_bytes) ||
      smem < off_t + kWarps * kKeys * bt * 4 ||
      smem < kWarps * bt * kBlockCols * 4 || (splits > 1 && (scratch == nullptr || tickets == nullptr)) ||
      (x_dtype != kF32 && x_dtype != kBF16))
    return cudaErrorInvalidValue;
  if (B <= 0 || o <= 0) return cudaSuccess;
  const Plan p{splits, chunk, stage_chunks, stage_bytes, off_s, off_x, off_t, smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const o32 = static_cast<float*>(out);
  float* const sc32 = static_cast<float*>(scratch);
  unsigned* const tk = static_cast<unsigned*>(tickets);
  const int xbf = x_dtype == kBF16;
  cudaError_t err;
  if (s_dtype == kF32)
    err = launch_q<float>(x, xbf, packed, scales, o32, sc32, tk, B, k, o, q, g, p, st);
  else if (s_dtype == kBF16)
    err = launch_q<__nv_bfloat16>(x, xbf, packed, scales, o32, sc32, tk, B, k, o, q, g, p, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

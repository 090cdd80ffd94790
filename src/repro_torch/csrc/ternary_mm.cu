// ternary_mm: y (B, o) f32 = x (B, k) @ (alpha * t), t in {-1, 0, +1}, consumed packed.
//
// Replaces the TPU kernel src/repro/kernels/ternary_mm.py::ternary_mm_call
// (_ternary_mm_kernel, _decode_ternary_block).
//
// What bounds it: two bit planes (a quarter byte a weight) and one alpha a
// group are read once, so at decode batch sizes the bound is those bytes
// over the card's memory rate (3.35 TB/s on an H100 SXM); at prefill widths
// (64 rows and up) the products, 2 B k o operations at the tensor cores'
// bf16 rate. What held the first, column-block version (32 columns a
// block over all of k) at 1.3x the bf16 library call at B = 4 and 8-12x at
// B = 64: each weight decoded and multiplied on the CUDA cores once for
// every 8 batch rows, and 96 blocks on 132 SMs at o = 3072.
//
// Two paths, chosen by the dtypes alone (never by B), so that a slot batch
// and a solo decode of one model take the same path and the same sum order:
//
// (a) bf16 x and bf16 alpha: the tensor cores (ternary_tc_launch).
//  - "Swap AB": y^T (o x B) = W^T (o x k) x^T (k x B), so the weights are
//    the M side of mma.sync.m16n8k16 (bf16 in, f32 sums) and batch rows the
//    N side, any B padded to n-tiles of 8.
//  - Every weight is +alpha, -alpha or 0: exact in bf16, and each product
//    x w exact in f32, so the tensor cores sum the plain version's own terms
//    and only the order differs; no per-group rescale, and g = 8 works.
//  - A fragments are decoded in registers straight from the staged plane
//    bytes: one byte perm a bf16x2 (decode_byte). The source word of a
//    column holds (0, alpha_lo, alpha_hi ^ 0x80, alpha_hi); the selector of
//    a weight's low byte is its mask bit, of its high byte 2 mask + (sign &
//    mask), spread from the byte's nibbles by one multiply each.
//  - A k-permutation shared by A and B: in a 32-k tile, lane t of a quad
//    owns byte row t (8 k) of its columns; its A halves of k-step s are bits
//    4s .. 4s + 3 of that byte, and its B halves x[8t + 4s .. 8t + 4s + 3],
//    one 16-byte read of x for both k-steps. The 8 columns of a quad are
//    adjacent (A rows gid and gid + 8 of m-tile mt are columns 8 gid + 2 mt
//    and 8 gid + 2 mt + 1), so one 8-byte read a plane gives their bytes.
//  - A block owns 64 columns (4 m-tiles), up to 32 batch rows (4 n-tiles;
//    8 or 16 for B <= 8 or 16) and one k-chunk of whole 32-k tiles; tile j
//    of the chunk goes to warp j mod 8. The planes and alpha come through a
//    cp.async ring of large stages (byte rows padded so that the fragment
//    reads hit distinct banks), so many bytes are in flight on every SM: a
//    ring that also staged x held too few (x read straight from global
//    memory, where every block finds it in L2, was 15% faster a B = 4 step
//    and 17% at B = 64 on the H100). Planes past k and x past k or B read
//    as zero.
//  - The plan (kernels/ternary_mm.py::tc_plan) depends on (k, o, g) only;
//    the warps' sums meet in shared memory in warp order, and the k-chunks'
//    partials are added in chunk order by the last block of a column tile
//    (an atomic ticket), as on the group-table skeleton. So row r of a
//    B-row call equals the row called alone, bit for bit.
//
// (b) every other dtype pair (f32 x, or f32 alpha): the CUDA cores, on the
//    group-table skeleton of grouptable.cuh (ternary_mm_launch), whose
//    header says how blocks, stages, the k-split and the sum order go. The
//    2-bit code (sign = bit 0, mask = bit 1) takes 4 weights {0, 0, -alpha,
//    +alpha}: from a table in shared memory, or made in registers, as the
//    plan's measured table limit says. f32 x cannot hold 2e-4 on the tensor
//    cores (TF32), so it never takes (a).
//
// Both equal the plain version's (2 sign - 1) * mask * alpha weight for
// weight, so only the order of the k sum differs.
#include "grouptable.cuh"

namespace {

using namespace repro;

struct TernaryGroups {
  static constexpr int kQ = 2;  // sign plane (code bit 0), mask plane (code bit 1)
  static __host__ __device__ constexpr int scale_planes(int) { return 1; }  // alpha

  template <int Q, typename ST>
  static __device__ __forceinline__ void build(float* T, int stride, const ST* s, int, int) {
    const float a = to_f32(s[0]);
    T[0] = 0.f;
    T[stride] = 0.f;
    T[2 * stride] = -a;
    T[3 * stride] = a;
  }

  struct Params {
    float a;
  };

  template <typename ST>
  static __device__ __forceinline__ void load(Params& P, const ST* s, int, int) {
    P.a = to_f32(s[0]);
  }

  static __device__ __forceinline__ float weight(const Params& P, uint32_t code, int) {
    return code & 2u ? (code & 1u ? P.a : -P.a) : 0.f;
  }
};

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 3;           // stages of the cp.async ring
constexpr int kCols = 64;          // output columns of a block: 4 m16 tiles
constexpr int kPlaneStride = 96;   // bytes between staged byte rows (64 columns, padded)
constexpr int kMaxRows = 32;       // batch rows of a block at most: 4 n8 tiles

// The wrapper's plan (kernels/ternary_mm.py::tc_plan). Within a ring stage
// of stage_bytes: the two planes' byte rows as [plane][stage_rows][96] at 0,
// alpha of stage_groups groups (and 3 of margin) as [group][64] bf16 at
// off_s; smem bytes in all (also the warps' sums after the last stage).
struct Plan {
  int splits, chunk, stage_rows, stage_bytes, off_s, stage_groups, smem;
};

__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Bit j of a nibble n to bit 8 j.
__device__ __forceinline__ uint32_t spread4(uint32_t n) { return (n * 0x204081u) & 0x01010101u; }

// The byte source of a column's weights: (0, alpha_lo, alpha_hi ^ 0x80,
// alpha_hi), so byte perm picks 0, -alpha or +alpha a half. `lo` takes the
// column in the low half of the bf16 pair v, else the high half.
__device__ __forceinline__ uint32_t source(uint32_t v, bool lo) {
  return __byte_perm(v, 0u, lo ? 0x1104u : 0x3324u) ^ 0x00800000u;
}

// The 4 bf16x2 weights of one column's byte row (sign byte s, mask byte m,
// source z): word h holds the weights of bits 2h (low half) and 2h + 1.
// Selector nibbles of a pair: low byte m_j, high byte 2 m_j + (s_j & m_j),
// the same for bit j + 1 (kernels/ternary_mm.py::fragment_plain mirrors it).
__device__ __forceinline__ void decode_byte(uint32_t s, uint32_t m, uint32_t z, uint32_t (&a)[4]) {
  const uint32_t sm = s & m;
  const uint32_t w0 = spread4(m & 0xfu) * 0x21u + (spread4(sm & 0xfu) << 4);
  const uint32_t w1 = spread4(m >> 4) * 0x21u + (spread4(sm >> 4) << 4);
  a[0] = __byte_perm(z, 0u, w0);
  a[1] = __byte_perm(z, 0u, w0 >> 16);
  a[2] = __byte_perm(z, 0u, w1);
  a[3] = __byte_perm(z, 0u, w1 >> 16);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
ternary_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                  const __nv_bfloat16* __restrict__ scales, float* __restrict__ out, float* __restrict__ scratch,
                  unsigned* __restrict__ tickets, int B, int k, int o, int g, Plan p) {
  constexpr int BT = 8 * NT;  // batch rows of the block
  extern __shared__ __align__(16) uint8_t smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  const int o0 = blockIdx.x * kCols, b0 = blockIdx.y * BT;
  const int kc = k / 8;
  const int c0 = blockIdx.z * p.chunk, c1 = min(kc, c0 + p.chunk);
  const int SR = p.stage_rows;
  const int nstage = (c1 - c0 + SR - 1) / SR;
  const int valid = min(kCols, o - o0);
  const bool full = valid == kCols;
  const bool vec_p = full && o % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool vec_s = full && o % 8 == 0 && reinterpret_cast<uintptr_t>(scales) % 16 == 0;

  // Stage t covers byte rows [r0, r1); the last 32-k tile of k may be short.
  auto rows_of = [&](int t, int& r0, int& r1) {
    r0 = c0 + t * SR;
    r1 = min(c1, r0 + SR);
  };
  auto ring = [&](int t) { return smem + (t % kRing) * p.stage_bytes; };

  // Stage t into its ring buffer: the planes' byte rows, zero up to a whole
  // tile, and alpha of the groups they touch.
  auto stage = [&](int t) {
    uint8_t* const buf = ring(t);
    int r0, r1;
    rows_of(t, r0, r1);
    const int nr = r1 - r0, nrp = (nr + 3) & ~3;
    for (int e = threadIdx.x; e < 2 * nrp * 4; e += kThreads) {
      const int line = e >> 2, piece = (e & 3) * 16;
      const int pl = line / nrp, rr = line % nrp;
      uint8_t* const d = buf + (pl * SR + rr) * kPlaneStride + piece;
      const uint8_t* const src = packed + (static_cast<size_t>(pl) * kc + r0 + rr) * o + o0 + piece;
      if (rr >= nr) {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      } else if (vec_p) {
        cp_async16(d, src, 16);
      } else {
        for (int u = 0; u < 16; ++u) d[u] = piece + u < valid ? src[u] : 0;
      }
    }
    const int ga = r0 * 8 / g, ngrp = (r1 * 8 - 1) / g - ga + 1;
    __nv_bfloat16* const sa = reinterpret_cast<__nv_bfloat16*>(buf + p.off_s);
    for (int e = threadIdx.x; e < ngrp * 8; e += kThreads) {
      const int line = e >> 3, piece = (e & 7) * 8;
      __nv_bfloat16* const d = sa + line * kCols + piece;
      const __nv_bfloat16* const src = scales + static_cast<size_t>(ga + line) * o + o0 + piece;
      if (vec_s) {
        cp_async16(d, src, 16);
      } else {
        for (int u = 0; u < 8; ++u) d[u] = piece + u < valid ? src[u] : __float2bfloat16(0.f);
      }
    }
  };

  float acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  stage(0);
  cp_async_commit();
  if (nstage > 1) stage(1);
  cp_async_commit();
  for (int t = 0; t < nstage; ++t) {
    cp_async_wait<1>();  // stage t has landed
    __syncthreads();      // ... for every thread; stage t - 1 is no longer read
    if (t + 2 < nstage) stage(t + 2);  // into the buffer of stage t - 1
    cp_async_commit();

    const uint8_t* const buf = ring(t);
    int r0, r1;
    rows_of(t, r0, r1);
    const int ntile = (r1 - r0 + 3) >> 2, ga = r0 * 8 / g;
    const int first = ((r0 - c0) >> 2) % kWarps;  // the chunk's tile index of this stage's tile 0, mod 8
    for (int jt = (warp - first + kWarps) % kWarps; jt < ntile; jt += kWarps) {
      const int rr = 4 * jt + t4;  // this lane's byte row of the stage
      const uint2 sw = *reinterpret_cast<const uint2*>(buf + rr * kPlaneStride + 8 * gid);
      const uint2 mw = *reinterpret_cast<const uint2*>(buf + (SR + rr) * kPlaneStride + 8 * gid);
      const int gl = (r0 + rr) * 8 / g - ga;
      const uint4 av = *reinterpret_cast<const uint4*>(buf + p.off_s + gl * kCols * 2 + 16 * gid);
      uint4 xr[NT];  // x[row][8 k of this lane's byte row], rows b0 + 8 nt + gid
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int row = b0 + 8 * nt + gid;
        xr[nt] = row < B && r0 + rr < kc
                     ? __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * k + (r0 + rr) * 8))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint32_t sword = mt < 2 ? sw.x : sw.y, mword = mt < 2 ? mw.x : mw.y;
        const int sh = 16 * (mt & 1);
        const uint32_t aw = mt == 0 ? av.x : mt == 1 ? av.y : mt == 2 ? av.z : av.w;
        uint32_t e[4], f[4];  // columns 8 gid + 2 mt (A row gid) and + 1 (A row gid + 8)
        decode_byte((sword >> sh) & 0xffu, (mword >> sh) & 0xffu, source(aw, true), e);
        decode_byte((sword >> (sh + 8)) & 0xffu, (mword >> (sh + 8)) & 0xffu, source(aw, false), f);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma16816(acc[mt][nt], e[0], f[0], e[1], f[1], xr[nt].x, xr[nt].y);
          mma16816(acc[mt][nt], e[2], f[2], e[3], f[3], xr[nt].z, xr[nt].w);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is no longer read

  // the warps' sums, then the k-chunks' partials, in order
  float* const red = reinterpret_cast<float*>(smem);  // [warp][BT][kCols]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(warp * BT + 8 * nt + 2 * t4 + (i & 1)) * kCols + 8 * gid + 2 * mt + (i >> 1)] = acc[mt][nt][i];
  __syncthreads();
  finish_split<kThreads, kWarps, BT, kCols>(red, out, scratch, tickets, B, o, b0, o0, valid);
}

// Batch rows a block owns: 8, 16 or 32 (kernels/ternary_mm.py::tc_rows).
inline int tc_rows(int B) { return B <= 8 ? 8 : B <= 16 ? 16 : kMaxRows; }

template <int NT>
cudaError_t launch(const void* x, const void* packed, const void* scales, float* out, float* scratch,
                   unsigned* tickets, int B, int k, int o, int g, const Plan& p, cudaStream_t stream) {
  auto kernel = ternary_tc_kernel<NT>;
  static int attr = 0;  // per instantiation: the largest opt-in made so far
  if (p.smem > attr) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    attr = p.smem;
  }
  const dim3 grid((o + kCols - 1) / kCols, (B + 8 * NT - 1) / (8 * NT), p.splits);
  kernel<<<grid, kThreads, p.smem, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const uint8_t*>(packed),
                                             static_cast<const __nv_bfloat16*>(scales), out, scratch, tickets,
                                             B, k, o, g, p);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace

REPRO_EXPORT_ERROR_STRING

// (b): f32 x or f32 alpha, on the group-table skeleton.
REPRO_GROUPTABLE_ENTRY(ternary_mm_launch, TernaryGroups)
REPRO_GROUPTABLE_GROUPED_ENTRY(ternary_mm_grouped_launch, TernaryGroups)

// (a): x (B, k) bf16, 16-byte aligned; packed (2, k/8, o) u8 (sign, mask);
// scales (1, k/g, o) bf16 (alpha); out (B, o) f32, all contiguous; scratch
// holds splits * B * o floats and tickets one zeroed counter per (column
// tile, batch tile) when splits > 1; the plan's fields
// (kernels/ternary_mm.py::tc_plan) after g.
extern "C" int ternary_tc_launch(const void* x, const void* packed, const void* scales, void* out, void* scratch,
                                 void* tickets, int B, int k, int o, int g, int splits, int chunk, int stage_rows,
                                 int stage_bytes, int off_s, int stage_groups, int smem, void* stream) {
  using namespace repro;
  cudaGetLastError();  // clear any stale error so the return is this launch's
  const tc::Plan p{splits, chunk, stage_rows, stage_bytes, off_s, stage_groups, smem};
  const int kc = k / 8;
  const long long sr = stage_rows;
  if (g <= 0 || g % 8 != 0 || k % g != 0 || splits < 1 || chunk < 4 || chunk % 4 != 0 || sr < 4 ||
      sr % 4 != 0 || static_cast<long long>(chunk) * splits < kc || chunk * (splits - 1) >= kc ||
      (splits > 1 && (scratch == nullptr || tickets == nullptr)) ||
      stage_groups < grouptable::stage_groups(kc, chunk, stage_rows, g) || stage_bytes % 16 || off_s % 16 ||
      off_s < 2 * sr * tc::kPlaneStride || stage_bytes < off_s + (stage_groups + 3LL) * tc::kCols * 2 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      smem < tc::kRing * static_cast<long long>(stage_bytes) ||
      smem < static_cast<long long>(tc::kWarps) * tc::kMaxRows * tc::kCols * 4)
    return cudaErrorInvalidValue;
  if (B <= 0 || o <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const y = static_cast<float*>(out);
  float* const sc = static_cast<float*>(scratch);
  unsigned* const tk = static_cast<unsigned*>(tickets);
  cudaError_t err;
  switch (tc::tc_rows(B)) {
    case 8: err = tc::launch<1>(x, packed, scales, y, sc, tk, B, k, o, g, p, st); break;
    case 16: err = tc::launch<2>(x, packed, scales, y, sc, tk, B, k, o, g, p, st); break;
    default: err = tc::launch<4>(x, packed, scales, y, sc, tk, B, k, o, g, p, st); break;
  }
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

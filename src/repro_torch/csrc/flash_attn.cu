// flash_attn: causal GQA softmax attention with an online softmax.
//   out (B, S, H, Dh) = softmax(q k^T / sqrt(Dh), causal) v, q's dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (_flash_kernel).
//
// What bounds it: q, k, v are read once and out written once, so a
// (B, S, H, Dh) prefill moves ~4 B S H Dh elements; the work is
// 4 H Dh S(S+1)/2 operations per batch row (q k^T and p v over the causal
// pairs). From S of a few hundred up, operations bound it: on the tensor
// cores at 989 TFLOP/s in bf16.
//
// Two kernels, chosen by dtype (a dispatch, not a fallback: a bf16 launch
// that fails is an error):
//
// bf16 -> flash_tc_kernel, on the tensor cores (wgmma). One block per
// (batch row, head, 128-query tile), three roles:
//  - one producer warp issues TMA copies of the q tile (once) and of
//    128-key K and V tiles into a 2-stage ring in shared memory, each
//    against an mbarrier, so the next K/V tile arrives while the current
//    one is multiplied; consumers free a stage through a third mbarrier;
//  - two consumer warpgroups own 64 query rows each: S = q K^T by wgmma
//    (q and K from shared memory, K-major), the online softmax in registers
//    in the accumulator's fragment layout (row max and row sum across a
//    quad by shuffles), then O += P V by wgmma with P from registers and V
//    from shared memory as an N-major operand (no transpose).
//  Tiles are 128-byte swizzled (TMA SWIZZLE_128B, the wgmma descriptors'
//  layout type 1): a 128-row tile is Dh/64 blocks of 128 x 64 columns. A
//  head dim below 64 is padded to 64 by the TMA's zero fill. Shared
//  memory: q + 2 x (K + V) = 160 KB at Dh 128, 80 KB at Dh <= 64. The
//  copies read (B, S, H, Dh) through a 4-d tensor map with the tensors'
//  strides, so v comes straight out of the fused QKV output; the TMA needs
//  16-byte aligned bases and strides (the wrapper checks, and copies what
//  fails), and its zero fill masks a ragged S.
// f32 -> flash_kernel, on the CUDA cores (the first kernel, unchanged): the tensor
//  cores have no f32 product that holds the 2e-4 f32 check. One block of 8
//  warps per (batch row, head, 64-query tile) stages q, K^T, V and p in
//  shared memory as f32 (115 KB at Dh 128); a lane computes the scores of
//  keys lane and lane + 32 for its warp's 8 rows; at most 67 TFLOP/s.
//
// Both keep the reference's arithmetic: scores in f32 times 1/sqrt(Dh),
// the mask value finfo(f32).min, p = exp(s - m_new) rounded to v's dtype
// only for p v while l sums the unrounded p, l clamped at 1e-30 (the bf16
// kernel takes exp as exp2 of (s - m) log2(e)). Tiles wholly in the future
// are never visited; the diagonal tile is masked. The q-tile index runs
// from the last tile down, so the longest rows of the causal triangle
// start first. No atomics: every sum runs in a fixed order, bitwise the
// same run to run.
#include <cuda.h>  // CUtensorMap (types only; cuTensorMapEncodeTiled is fetched at run time)

#include "common.cuh"

namespace {

using namespace repro;

constexpr int kBQ = 64;                // query rows a block owns
constexpr int kBK = 64;                // keys a tile holds
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsW = kBQ / kWarps;   // query rows a warp owns
constexpr int kKT = kBK + 1;           // padded row stride of the transposed K tile
constexpr float kNegInf = -3.402823466e+38f;  // finfo(float32).min, the reference's mask value

template <int DH>
constexpr int smem_floats() {
  return kBQ * DH + kBK * DH + kBQ * kBK + DH * kKT;  // q, v, p, k^T
}

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

__device__ __forceinline__ float round_as(float p, float) { return p; }

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int S, int H, int Hkv, int BH, int nqt, Strides sq,
             Strides sk, Strides sv, Strides so, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;              // [kBQ][DH]
  float* v_s = q_s + kBQ * DH;    // [kBK][DH]
  float* p_s = v_s + kBK * DH;    // [kBQ][kBK]
  float* kT = p_s + kBQ * kBK;    // [DH][kKT]

  // lanes of a warp across the head dim in the p v product
  constexpr int kLW = DH < 32 ? DH : 32;
  constexpr int kRS = 32 / kLW;     // row groups in a warp (2 at Dh 16)
  constexpr int kCPL = DH / kLW;    // output columns a lane owns
  constexpr int kRL = kRowsW / kRS; // output rows a lane owns

  const int bh = blockIdx.x % BH;
  const int iq = nqt - 1 - blockIdx.x / BH;  // the longest rows first
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int q0 = iq * kBQ;
  const int c0 = lane % kLW, rg = lane / kLW;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, pos = q0 + r;
    q_s[i] = pos < S ? to_f32(qb[pos * sq.s + d]) : 0.f;
  }

  float m[kRowsW], l[kRowsW], corr[kRowsW], acc[kRL][kCPL];
#pragma unroll
  for (int r = 0; r < kRowsW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRL; ++i)
#pragma unroll
    for (int c = 0; c < kCPL; ++c) acc[i][c] = 0.f;

  const int last = min(S, q0 + kBQ) - 1;  // the tile's last valid query row
  const int nkt = last / kBK + 1;         // key tiles up to the diagonal
  const float* qw = q_s + w * kRowsW * DH;
  float* pw = p_s + w * kRowsW * kBK;

  for (int ik = 0; ik < nkt; ++ik) {
    const int k0 = ik * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int j = i / DH, d = i % DH, pos = k0 + j;
      const bool ok = pos < S;
      kT[d * kKT + j] = ok ? to_f32(kb[pos * sk.s + d]) : 0.f;
      v_s[i] = ok ? to_f32(vb[pos * sv.s + d]) : 0.f;
    }
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 for the warp's rows
    float s[kRowsW][2];
#pragma unroll
    for (int r = 0; r < kRowsW; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float ka[4], kc[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        ka[t] = kT[(d + t) * kKT + lane];
        kc[t] = kT[(d + t) * kKT + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRowsW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * DH + d);
        s[r][0] = fmaf(qv.x, ka[0], s[r][0]);
        s[r][0] = fmaf(qv.y, ka[1], s[r][0]);
        s[r][0] = fmaf(qv.z, ka[2], s[r][0]);
        s[r][0] = fmaf(qv.w, ka[3], s[r][0]);
        s[r][1] = fmaf(qv.x, kc[0], s[r][1]);
        s[r][1] = fmaf(qv.y, kc[1], s[r][1]);
        s[r][1] = fmaf(qv.z, kc[2], s[r][1]);
        s[r][1] = fmaf(qv.w, kc[3], s[r][1]);
      }
    }

    // online softmax, one row at a time across the warp
    const int kp0 = k0 + lane, kp1 = kp0 + 32;
#pragma unroll
    for (int r = 0; r < kRowsW; ++r) {
      const int qpos = q0 + w * kRowsW + r;
      float s0 = s[r][0] * scale, s1 = s[r][1] * scale;
      if (kp0 > qpos || kp0 >= S) s0 = kNegInf;
      if (kp1 > qpos || kp1 >= S) s1 = kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      pw[r * kBK + lane] = round_as(p0, T());
      pw[r * kBK + lane + 32] = round_as(p1, T());
    }
    __syncwarp();

    // acc = acc * corr + p v over the tile's keys
#pragma unroll
    for (int i = 0; i < kRL; ++i) {
      float cr = corr[kRS * i];
#pragma unroll
      for (int gi = 1; gi < kRS; ++gi)
        if (rg == gi) cr = corr[kRS * i + gi];
#pragma unroll
      for (int c = 0; c < kCPL; ++c) acc[i][c] *= cr;
    }
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][kCPL];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < kCPL; ++c) vv[t][c] = v_s[(j + t) * DH + c0 + c * kLW];
#pragma unroll
      for (int i = 0; i < kRL; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(pw + (rg + kRS * i) * kBK + j);
#pragma unroll
        for (int c = 0; c < kCPL; ++c) {
          acc[i][c] = fmaf(pv.x, vv[0][c], acc[i][c]);
          acc[i][c] = fmaf(pv.y, vv[1][c], acc[i][c]);
          acc[i][c] = fmaf(pv.z, vv[2][c], acc[i][c]);
          acc[i][c] = fmaf(pv.w, vv[3][c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRL; ++i) {
    const int r = rg + kRS * i;
    const int pos = q0 + w * kRowsW + r;
    float li = l[kRS * i];
#pragma unroll
    for (int gi = 1; gi < kRS; ++gi)
      if (rg == gi) li = l[kRS * i + gi];
    li = fmaxf(li, 1e-30f);
    if (pos < S) {
      T* ob = out + b * so.b + h * so.h + pos * so.s;
#pragma unroll
      for (int c = 0; c < kCPL; ++c) store_as(ob + c0 + c * kLW, acc[i][c] / li);
    }
  }
}

template <typename T, int DH>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                     int Hkv, Strides sq, Strides sk, Strides sv, Strides so, cudaStream_t stream) {
  constexpr int smem = smem_floats<DH>() * static_cast<int>(sizeof(float));
  static bool attr_set = false;  // per instantiation; above 48 KB needs the opt-in
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int nqt = (S + kBQ - 1) / kBQ;
  const int BH = B * H;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));  // f32(1/sqrt(Dh))
  flash_kernel<T, DH><<<nqt * BH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, Hkv, BH, nqt, sq, sk, sv, so, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

namespace tc {

constexpr int kBQ = 128;                    // query rows a block owns
constexpr int kBK = 128;                    // keys a K / V tile holds
constexpr int kStages = 2;                  // K / V ring depth
constexpr int kConsumers = 256;             // two warpgroups of 64 query rows
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kColBlock = 64;               // head-dim columns of one 128-byte swizzled block
constexpr float kLog2e = 1.4426950408889634f;

template <int DHP>
__host__ __device__ constexpr int tile_bytes() {
  return kBQ * DHP * 2;  // kBQ == kBK: q, K and V tiles have one size
}
template <int DHP>
constexpr int smem_bytes() {
  return (1 + 2 * kStages) * tile_bytes<DHP>() + 8 * (1 + 3 * kStages) + 1024;  // + barriers, alignment
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
// K-major operands (q, K): sbo = 1024 (8 rows of 128 bytes), lbo unused.
// N-major operand (V): sbo = 1024 (8 keys), lbo = the stride between
// 64-column blocks.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : REPRO_D8(0), REPRO_D8(8), REPRO_D8(16), REPRO_D8(24), REPRO_D8(32), REPRO_D8(40), REPRO_D8(48),
        REPRO_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, registers) B (16 x 128, smem, N-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : REPRO_D8(0), REPRO_D8(8), REPRO_D8(16), REPRO_D8(24), REPRO_D8(32), REPRO_D8(40), REPRO_D8(48),
        REPRO_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, smem, N-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, "
      "1, 1, 1, 1;\n"
      : REPRO_D8(0), REPRO_D8(8), REPRO_D8(16), REPRO_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef REPRO_D8

template <int DHP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DHP / 2], const uint32_t* a, uint64_t db) {
  if constexpr (DHP == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n64(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Accumulator fragment of m64nN (per warpgroup thread t, warp w = t / 32,
// lane l): register i holds row 16 w + l / 4 + 8 ((i >> 1) & 1) and column
// 8 (i >> 2) + 2 (l % 4) + (i & 1). A thread thus holds two rows, r = 0, 1.
template <int DHP>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, int S, int H,
                int Hkv, int Dh, int BH, int nqt, Strides so, float scale) {
  constexpr int NB = DHP / kColBlock;  // 64-column blocks of a tile
  constexpr int kTile = tile_bytes<DHP>();
  constexpr int kBlock = kBQ * kColBlock * 2;  // bytes of one 128 x 64 block
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* const q_s = base;
  uint8_t* const k_s = base + kTile;                  // [kStages] tiles
  uint8_t* const v_s = base + (1 + kStages) * kTile;  // [kStages] tiles
  uint64_t* const bar = reinterpret_cast<uint64_t*>(base + (1 + 2 * kStages) * kTile);
  uint64_t* const bar_q = bar;
  uint64_t* const full_k = bar + 1;
  uint64_t* const full_v = bar + 1 + kStages;
  uint64_t* const empty = bar + 1 + 2 * kStages;

  const int bh = blockIdx.x % BH;
  const int iq = nqt - 1 - blockIdx.x / BH;  // the longest rows first
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = iq * kBQ;
  const int nkt = (min(S, q0 + kBQ) - 1) / kBK + 1;  // key tiles up to the diagonal
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full_k[st], 1);
      mbar_init(&full_v[st], 1);
      mbar_init(&empty[st], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(bar_q, kTile);
      for (int nb = 0; nb < NB; ++nb) tma_load_4d(q_s + nb * kBlock, &tq, bar_q, nb * kColBlock, q0, h, b);
      for (int it = 0; it < nkt; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
        mbar_expect_tx(&full_k[st], kTile);
        for (int nb = 0; nb < NB; ++nb)
          tma_load_4d(k_s + st * kTile + nb * kBlock, &tk, &full_k[st], nb * kColBlock, it * kBK, hk, b);
        mbar_expect_tx(&full_v[st], kTile);
        for (int nb = 0; nb < NB; ++nb)
          tma_load_4d(v_s + st * kTile + nb * kBlock, &tv, &full_v[st], nb * kColBlock, it * kBK, hk, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  const int wg = warp / 4, wq = warp % 4;
  const int row0 = q0 + 64 * wg + 16 * wq + lane / 4;  // and row0 + 8
  const int t2 = 2 * (lane % 4);
  float s[64], o[DHP / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < nkt; ++it) {
    const int st = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const int k0 = it * kBK;
    const uint8_t* const kt = k_s + st * kTile;
    const uint8_t* const vt = v_s + st * kTile;

    // S = q K^T over the head dim, 16 columns a step
    mbar_wait(&full_k[st], ph);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int kk = 0; kk < kColBlock / 16; ++kk)
        wgmma_ss_n128(s, desc_sw128(q_s + nb * kBlock + wg * 64 * 128 + kk * 32, 16, 1024),
                      desc_sw128(kt + nb * kBlock + kk * 32, 16, 1024), nb > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale, mask the diagonal tile, online softmax in the fragment layout
    const bool diag = k0 + kBK - 1 > q0 + 64 * wg;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float v = s[i] * scale;
      if (diag && k0 + 8 * (i >> 2) + t2 + (i & 1) > row0 + 8 * ((i >> 1) & 1)) v = kNegInf;
      s[i] = v;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f((s[i] - m[r]) * kLog2e);
      s[i] = p;
      sum[r] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // p rounded to bf16 as the A operand, 16 keys a step (the m64nNk16 A
    // fragment is the accumulator's columns 16 kk .. 16 kk + 15)
    uint32_t pa[32];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V over the tile's keys, 16 keys a step
    mbar_wait(&full_v[st], ph);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_pv<DHP>(o, pa + 4 * kk, desc_sw128(vt + kk * 16 * 128, kBlock, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&empty[st]);
  }

  // out = O / max(l, 1e-30), in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row0 + 8 * r;
    if (pos >= S) continue;
    const float li = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* ob = out + b * so.b + h * so.h + pos * so.s;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const int col = 8 * j + t2;
      if (col < Dh)
        *reinterpret_cast<__nv_bfloat162*>(ob + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / li, o[4 * j + 2 * r + 1] / li);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, heads, Dh) bf16 tensor at `ptr` with element strides st (head
// dim contiguous) as a 4-d tensor map of 64 x 128 x 1 x 1 boxes, 128-byte
// swizzle, zero fill past the edges. A dim of size 1 takes its contiguous
// stride (any stride reads the same elements there).
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int Dh, Strides st) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const long long cs = static_cast<long long>(heads) * Dh, cb = cs * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Dh), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * (S > 1 ? st.s : cs)),
                                 static_cast<cuuint64_t>(2 * (heads > 1 ? st.h : Dh)),
                                 static_cast<cuuint64_t>(2 * (B > 1 ? st.b : cb))};
  const cuuint32_t box[4] = {kColBlock, kBQ, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DHP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int Hkv,
                   int Dh, Strides sq, Strides sk, Strides sv, Strides so, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DHP>();
  static bool attr_set = false;  // per instantiation; above 48 KB needs the opt-in
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<DHP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, H, Dh, sq) || !make_map(&tk, k, B, S, Hkv, Dh, sk) ||
      !make_map(&tv, v, B, S, Hkv, Dh, sv))
    return cudaErrorInvalidValue;
  const int nqt = (S + kBQ - 1) / kBQ;
  const int BH = B * H;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));  // f32(1/sqrt(Dh))
  flash_tc_kernel<DHP><<<nqt * BH, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, H, Hkv, Dh, BH, nqt, so, scale);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T>
cudaError_t launch_dh(int Dh, const void* q, const void* k, const void* v, void* out, int B,
                      int S, int H, int Hkv, Strides sq, Strides sk, Strides sv, Strides so,
                      cudaStream_t st) {
  switch (Dh) {
    case 16: return launch_t<T, 16>(q, k, v, out, B, S, H, Hkv, sq, sk, sv, so, st);
    case 32: return launch_t<T, 32>(q, k, v, out, B, S, H, Hkv, sq, sk, sv, so, st);
    case 64: return launch_t<T, 64>(q, k, v, out, B, S, H, Hkv, sq, sk, sv, so, st);
    case 128: return launch_t<T, 128>(q, k, v, out, B, S, H, Hkv, sq, sk, sv, so, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q, out (B, S, H, Dh); k, v (B, S, Hkv, Dh); one dtype for all four (f32 or
// bf16), head dim contiguous, other dims at the element strides given.
// Dh in {16, 32, 64, 128}; H a multiple of Hkv. bf16 inputs also need
// 16-byte aligned bases and strides of q, k, v (dims of size 1 excepted),
// which the TMA copies require; out is written with 4-byte stores.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                                 int dtype, int B, int S, int H, int Hkv, int Dh,
                                 long long qsb, long long qss, long long qsh,
                                 long long ksb, long long kss, long long ksh,
                                 long long vsb, long long vss, long long vsh,
                                 long long osb, long long oss, long long osh, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv) {
    cudaGetLastError();
    return cudaErrorInvalidValue;
  }
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh}, so{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32)
    err = launch_dh<float>(Dh, q, k, v, out, B, S, H, Hkv, sq, sk, sv, so, st);
  else if (dtype == kBF16 && (Dh == 16 || Dh == 32 || Dh == 64))
    err = tc::launch<64>(q, k, v, out, B, S, H, Hkv, Dh, sq, sk, sv, so, st);
  else if (dtype == kBF16 && Dh == 128)
    err = tc::launch<128>(q, k, v, out, B, S, H, Hkv, Dh, sq, sk, sv, so, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) cudaGetLastError();  // clear a refusal so the next launch starts clean
  return err;
}

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
// cores at 989 TFLOP/s in bf16. This first kernel runs on the CUDA cores in
// f32 (67 TFLOP/s), so it can reach at most ~7% of that bound; tensor cores
// (mma.sync / wgmma) are a later change.
//
// Design: one block of 8 warps per (batch row, head, 64-query tile); heads
// read their kv head h / (H / Hkv). The block walks the 64-key tiles up to
// the diagonal (tiles wholly in the future are skipped, the diagonal and the
// ragged end are masked), staging K (transposed) and V tiles in shared
// memory as f32. Each warp owns 8 query rows: a lane computes the scores of
// keys lane and lane + 32 for its warp's rows, the row max and the sum of p
// go through warp shuffles, and the rounded p tile goes through shared
// memory into the p v product, where a lane owns Dh / 32 output columns.
// m (running max), l (running denominator) and the accumulator stay in
// registers in f32. The reference's arithmetic is kept: scores in f32 times
// 1/sqrt(Dh), the mask value finfo(f32).min, p = exp(s - m_new) rounded to
// v's dtype for p v while l sums the unrounded p, l clamped at 1e-30.
// Everything is staged as f32, so the tiles need 58 KB (Dh 64) to 115 KB
// (Dh 128) of shared memory: above 48 KB the entry opts in to dynamic shared
// memory (cudaFuncSetAttribute) on purpose. The q-tile index runs from the
// last tile down, so the longest rows of the causal triangle start first.
// No atomics: every sum runs in a fixed order, bitwise the same run to run.
// The (B, S, H, Dh) layouts are read through their strides (last dim
// contiguous), so no transpose precedes the kernel.
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
__device__ __forceinline__ float round_as(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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
// Dh in {16, 32, 64, 128}; H a multiple of Hkv.
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
  else if (dtype == kBF16)
    err = launch_dh<__nv_bfloat16>(Dh, q, k, v, out, B, S, H, Hkv, sq, sk, sv, so, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) cudaGetLastError();  // clear a refusal so the next launch starts clean
  return err;
}

// slstm_scan: the sLSTM cell's recurrence over a sequence, for every (batch
// row, head): four gate pre-activations plus the hidden-to-hidden products
// h_{t-1} R_g, exponential gating with a stabiliser m, and the state h, c, n.
//
// It has no pallas_call in the reference: it is the counterpart of the
// lax.scan at src/repro/models/recurrent.py:383-403 (slstm_block's step),
// which serves every prefill, decode step and verify of the xLSTM models,
// and which on the card would otherwise be S steps of ~20 launches a layer.
//
// Each step, following the reference's step op for op:
//   x_g = pre_g + h R_g                (g in z, i, f, o; R_g widened to f32)
//   z = tanh(x_z)   i = x_i   f = log sigmoid(x_f)   o = sigmoid(x_o)
//   m_new = max(f + m, i)   ig = exp(i - m_new)   fg = exp(f + m - m_new)
//   c = fg c + ig z   n = fg n + ig   h = (o c) / max(n, 1e-6)
//
// What bounds it: the sequential dependence. A step's sums are Dh dependent
// adds each (their order is fixed, below), then one exchange of h among all
// the head's columns. The first version (a block per (row, head), R read
// from L2 every step: 4 Dh^2 values, 295 KB in bf16 at Dh = 192) ran on 4
// SMs at B = 1, each paced by its own L2 reads (9.4 us a step on an NVIDIA
// H100 80GB HBM3 at 700 W).
//
// Design: a thread-block cluster of CL CTAs per (head, tile of up to RB
// rows) (kernels/slstm_scan.py::plan: CL = 8 at Dh = 192). CTA `rank` owns
// the CW = Dh / CL output columns rank CW .. rank CW + CW - 1 of all four
// gates and copies its slice of the four R_g into its shared memory once per
// launch (37.5 KB in bf16 at Dh = 192), transposed so that a column's R
// values are contiguous. Thread (gate g, row b, column c) sums h[b][d]
// R_g[d, e] over d in order from 0.f, 8 terms a pass from vector loads,
// products and sums rounded separately (__fmul_rn / __fadd_rn), as the
// first version did, so a row's bits depend on its own values alone and are
// that version's bits, and applies its gate's activation. After a barrier
// the gate-0 threads combine the gates, update c, n, m and h (each
// element owned by one thread for the whole scan, so the state may be
// updated in place) and store the new h into every CTA's copy of the full
// h (distributed shared memory, cluster.map_shared_rank); h is
// double-buffered by step parity, so one cluster barrier a step is enough:
// a CTA writes parity t + 1 while the others may still read parity t, and
// nobody writes parity t again before every CTA has passed the next barrier.
// The barrier is split (arrive with release, then wait with acquire) and the
// step's global stores and the next step's loads go between the halves, so
// the release does not wait for them.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_DH = 256;
constexpr int MAX_THREADS = 1024;  // 4 RB CW threads a CTA
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a CTA may opt in to

struct Args {
  const float* pre[4];  // z, i, f, o: (B, S, NH, Dh)
  const void* r[4];     // (NH, Dh, Dh) in the parameter dtype
  const float *h_in, *c_in, *n_in, *m_in;
  float* hs;
  float *h_out, *c_out, *n_out, *m_out;  // all null, or all set
  const int* sel;
  int n_sel;
  float *h_sel, *c_sel, *n_sel_out, *m_sel;  // (n_sel, B, NH, Dh)
  int B, S, NH, Dh, CL, RB;
};

// Shared memory of a CTA: its R slice transposed, [4][CW][DP] in RT, a
// column's Dh values contiguous (DP = Dh rounded up to 16 bytes, plus 16
// where that leaves an even count of 16-byte pieces, so the lanes of a warp
// reading 16 bytes each hit other banks); the full h of its rows [2][RB][HS]
// f32 (HS = Dh rounded up to 4, plus 4 where that is a multiple of 32); the
// gate values [4][RB][CW] f32.
__host__ __device__ inline int r_pitch(int Dh, int rt) {
  const int v = 16 / rt, dp = (Dh + v - 1) / v * v;
  return (dp / v) % 2 ? dp : dp + v;
}
__host__ __device__ inline int h_pitch(int Dh) {
  const int hs = (Dh + 3) / 4 * 4;
  return hs % 32 ? hs : hs + 4;
}
__host__ __device__ inline int r_bytes(int Dh, int CL, int rt) { return 4 * (Dh / CL) * r_pitch(Dh, rt) * rt; }
__host__ __device__ inline int smem_bytes(int Dh, int CL, int RB, int rt) {
  return r_bytes(Dh, CL, rt) + 2 * RB * h_pitch(Dh) * 4 + 4 * RB * (Dh / CL) * 4;
}

// Eight R values of a column as f32, from 16 (bf16) or 32 (f32) bytes at p.
__device__ __forceinline__ void load_r8(const __nv_bfloat16* p, float (&r)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[2 * i] = __uint_as_float(u[i] << 16);
    r[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_r8(const float* p, float (&r)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w; r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) { return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x))); }

// The cluster barrier in two halves: what a thread writes before arrive
// (release) is seen by every thread of the cluster after its wait (acquire);
// what it does between the two (global stores, loads) is not held up.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;" ::: "memory"); }

template <typename RT>
__global__ void __launch_bounds__(MAX_THREADS)
slstm_scan_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int Dh = a.Dh, NH = a.NH, S = a.S, CL = a.CL, RB = a.RB, CW = Dh / CL;
  const int DP = r_pitch(Dh, sizeof(RT)), HS = h_pitch(Dh);
  const int rank = static_cast<int>(cluster.block_rank());
  const int hd = blockIdx.x / CL;
  const int tid = threadIdx.x, c = tid % CW, g = tid / CW / RB, b = tid / CW % RB;
  const int e = rank * CW + c, row = blockIdx.y * RB + b;
  const bool active = row < a.B;
  RT* const rs = reinterpret_cast<RT*>(smem);                                     // [4][CW][DP]
  float* const hbuf = reinterpret_cast<float*>(smem + r_bytes(Dh, CL, sizeof(RT)));  // [2][RB][HS]
  float* const xs = hbuf + 2 * RB * HS;                                            // [4][RB][CW]

  // this CTA's slice of R, transposed: rs[g][c][d] = R_g[hd][d][rank CW + c],
  // 16-byte loads of 16 / sizeof(RT) columns where a slice row is whole ones
  constexpr int V = 16 / sizeof(RT);
  bool vec = CW % V == 0 && Dh % V == 0;
  for (int gi = 0; gi < 4; ++gi) vec = vec && reinterpret_cast<uintptr_t>(a.r[gi]) % 16 == 0;
  const int per = vec ? CW / V : CW;  // loads of a slice row
  for (int i = tid; i < 4 * Dh * per; i += blockDim.x) {
    const int gi = i / (Dh * per), d = i / per % Dh, pc = i % per;
    const RT* const src = static_cast<const RT*>(a.r[gi]) + (static_cast<size_t>(hd) * Dh + d) * Dh + rank * CW;
    RT* const dst = rs + gi * CW * DP + d;
    if (vec) {
      RT v[V];
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src + pc * V);
#pragma unroll
      for (int j = 0; j < V; ++j) dst[(pc * V + j) * DP] = v[j];
    } else {
      dst[pc * DP] = src[pc];
    }
  }
  const size_t bh = (static_cast<size_t>(active ? row : 0) * NH + hd) * Dh + e;
  const float* pre = a.pre[g];
  auto at = [&](int t) { return ((static_cast<size_t>(row) * S + t) * NH + hd) * Dh + e; };
  // the new h of this thread's (row, column) into every CTA's copy of parity `par`
  auto share = [&](int par, float v) {
    for (int r = 0; r < CL; ++r) cluster.map_shared_rank(hbuf, r)[(par * RB + b) * HS + e] = v;
  };

  float h = 0.f, cc = 0.f, n = 0.f, m = 0.f;
  if (g == 0 && active) {
    h = a.h_in[bh];
    cc = a.c_in[bh];
    n = a.n_in[bh];
    m = a.m_in[bh];
  }
  float p = S > 0 && active ? pre[at(0)] : 0.f;
  int next_sel = 0;
  int sel_t = a.n_sel > 0 ? a.sel[0] : -1;
  cluster.sync();  // every CTA of the cluster runs (its shared memory may be written) and has its R slice
  if (g == 0) share(0, h);
  cluster.sync();

  for (int t = 0; t < S; ++t) {
    const float* const hb = hbuf + ((t & 1) * RB + b) * HS;
    if (active) {
      const RT* const rc = rs + (g * CW + c) * DP;
      float acc = 0.f;
      if (Dh % 8 == 0) {  // 8 terms a pass from two float4 of h and 16 or 32 bytes of R, added in d order
        for (int d0 = 0; d0 < Dh; d0 += 8) {
          const float4 h0 = *reinterpret_cast<const float4*>(hb + d0), h1 = *reinterpret_cast<const float4*>(hb + d0 + 4);
          const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
          float rv[8];
          load_r8(rc + d0, rv);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, __fmul_rn(hv[j], rv[j]));
        }
      } else {
        for (int d = 0; d < Dh; ++d) acc = __fadd_rn(acc, __fmul_rn(hb[d], repro::to_f32(rc[d])));
      }
      // each gate's activation on its own threads: z = tanh, i as is, f = log sigmoid, o = sigmoid
      const float x = __fadd_rn(p, acc);
      xs[(g * RB + b) * CW + c] = g == 0 ? tanhf(x) : g == 1 ? x : g == 2 ? log_sigmoid(x) : sigmoid(x);
    }
    __syncthreads();

    float hn = 0.f;
    if (g == 0) {
      if (active) {
        const float* const x = xs + b * CW + c;
        const float z = x[0], i_log = x[RB * CW], f_log = x[2 * RB * CW], o = x[3 * RB * CW];
        const float fm = __fadd_rn(f_log, m);
        const float m_new = fmaxf(fm, i_log);
        const float ig = expf(__fsub_rn(i_log, m_new));
        const float fg = expf(__fsub_rn(fm, m_new));
        cc = __fadd_rn(__fmul_rn(fg, cc), __fmul_rn(ig, z));
        n = __fadd_rn(__fmul_rn(fg, n), ig);
        hn = __fdiv_rn(__fmul_rn(o, cc), fmaxf(n, 1e-6f));
        m = m_new;
      }
      share((t + 1) & 1, hn);
    }
    cluster_arrive();
    // while the cluster gathers: this step's outputs and the next step's input
    if (g == 0 && active) {
      h = hn;
      a.hs[at(t)] = h;
      if (t == sel_t) {
        const size_t sb = static_cast<size_t>(next_sel) * a.B * NH * Dh + bh;
        a.h_sel[sb] = h;
        a.c_sel[sb] = cc;
        a.n_sel_out[sb] = n;
        a.m_sel[sb] = m;
      }
    }
    if (t == sel_t) {
      ++next_sel;
      sel_t = next_sel < a.n_sel ? a.sel[next_sel] : -1;
    }
    if (active && t + 1 < S) p = pre[at(t + 1)];
    cluster_wait();
  }

  if (g == 0 && active && a.h_out != nullptr) {
    a.h_out[bh] = h;
    a.c_out[bh] = cc;
    a.n_out[bh] = n;
    a.m_out[bh] = m;
  }
}

template <typename RT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = slstm_scan_kernel<RT>;
  const int smem = smem_bytes(a.Dh, a.CL, a.RB, sizeof(RT));
  static int attr = 0;  // the largest opt-in made so far, per instantiation
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.NH * a.CL, (a.B + a.RB - 1) / a.RB);
  cfg.blockDim = dim3(4 * a.RB * (a.Dh / a.CL));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr_cl[1];
  attr_cl[0].id = cudaLaunchAttributeClusterDimension;
  attr_cl[0].val.clusterDim.x = a.CL;
  attr_cl[0].val.clusterDim.y = 1;
  attr_cl[0].val.clusterDim.z = 1;
  cfg.attrs = attr_cl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// pre_z, pre_i, pre_f, pre_o, hs (B, S, NH, Dh) f32; r_z .. r_o (NH, Dh, Dh)
// in r_dtype (repro::DTypeCode: f32 or bf16); h_in .. m_in and h_out ..
// m_out (B, NH, Dh) f32, the outputs all null (the final state is not kept)
// or all set (each may alias its input). All contiguous. sel: n_sel
// ascending step indices (device int32); the state after each goes to
// h_sel .. m_sel (n_sel, B, NH, Dh). cl: CTAs a cluster (divides Dh, at most
// 8); rb: rows a cluster (kernels/slstm_scan.py::plan).
extern "C" int slstm_scan_launch(const void* pre_z, const void* pre_i, const void* pre_f, const void* pre_o,
                                 const void* r_z, const void* r_i, const void* r_f, const void* r_o, int r_dtype,
                                 const void* h_in, const void* c_in, const void* n_in, const void* m_in, void* hs,
                                 void* h_out, void* c_out, void* n_out, void* m_out, const void* sel, int n_sel,
                                 void* h_sel, void* c_sel, void* n_sel_out, void* m_sel, int B, int S, int NH,
                                 int Dh, int cl, int rb, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (B < 0 || S < 0 || NH < 0 || Dh < 0 || n_sel < 0 || Dh > MAX_DH || cl < 1 || cl > MAX_CLUSTER || rb < 1 ||
      (r_dtype != repro::kF32 && r_dtype != repro::kBF16))
    return cudaErrorInvalidValue;
  if (B == 0 || NH == 0 || Dh == 0) return 0;
  const int rt = r_dtype == repro::kF32 ? 4 : 2;
  if (Dh % cl != 0 || 4LL * rb * (Dh / cl) > MAX_THREADS || smem_bytes(Dh, cl, rb, rt) > MAX_SMEM ||
      (B + rb - 1) / rb > 65535 || static_cast<long long>(NH) * cl > 0x7fffffff)
    return cudaErrorInvalidValue;
  Args a{{static_cast<const float*>(pre_z), static_cast<const float*>(pre_i), static_cast<const float*>(pre_f),
          static_cast<const float*>(pre_o)},
         {r_z, r_i, r_f, r_o},
         static_cast<const float*>(h_in), static_cast<const float*>(c_in), static_cast<const float*>(n_in),
         static_cast<const float*>(m_in), static_cast<float*>(hs), static_cast<float*>(h_out),
         static_cast<float*>(c_out), static_cast<float*>(n_out), static_cast<float*>(m_out),
         static_cast<const int*>(sel), n_sel, static_cast<float*>(h_sel), static_cast<float*>(c_sel),
         static_cast<float*>(n_sel_out), static_cast<float*>(m_sel), B, S, NH, Dh, cl, rb};
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = r_dtype == repro::kF32 ? launch<float>(a, s) : launch<__nv_bfloat16>(a, s);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

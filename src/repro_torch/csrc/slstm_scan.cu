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
// What bounds it: the sequential dependence. Each step reads the head's four
// R_g (4 Dh^2 values, 295 KB in bf16 at Dh = 192) from L2, which is where
// they stay (1.2 MB a layer); by device-memory bytes it reads pre and R once
// and writes hs once.
//
// Design: one block per (row, head), 4 Dh threads, one per (gate, output
// column e). h_{t-1} sits in shared memory; each thread sums h[d] R_g[d, e]
// over d in order (adjacent threads on adjacent e: each d is one coalesced
// line of R_g), products and sums rounded separately (__fmul_rn /
// __fadd_rn), so a row's bits depend on its own values alone. After one
// barrier the Dh threads of gate 0 apply the gates to the four sums, update
// c, n, m and h (each element owned by one thread for the whole scan, so the
// state may be updated in place) and write h back to shared memory.
#include "common.cuh"

namespace {

constexpr int MAX_DH = 256;  // 4 Dh threads a block

struct Args {
  const float* pre[4];  // z, i, f, o: (B, S, NH, Dh)
  const void* r[4];     // (NH, Dh, Dh) in the parameter dtype
  const float *h_in, *c_in, *n_in, *m_in;
  float* hs;
  float *h_out, *c_out, *n_out, *m_out;  // all null, or all set
  const int* sel;
  int n_sel;
  float *h_sel, *c_sel, *n_sel_out, *m_sel;  // (n_sel, B, NH, Dh)
  int B, S, NH, Dh;
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) { return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x))); }

template <typename RT>
__global__ void __launch_bounds__(4 * MAX_DH)
slstm_scan_kernel(Args a) {
  __shared__ float h_s[MAX_DH];
  __shared__ float x_s[4][MAX_DH];

  const int Dh = a.Dh, NH = a.NH, S = a.S;
  const int tid = threadIdx.x, g = tid / Dh, e = tid % Dh;
  const int hd = blockIdx.x, b = blockIdx.y;
  const size_t bh = static_cast<size_t>(b) * NH + hd;
  const RT* R = static_cast<const RT*>(a.r[g]) + static_cast<size_t>(hd) * Dh * Dh + e;
  const float* pre = a.pre[g];
  auto at = [&](int t) { return ((static_cast<size_t>(b) * S + t) * NH + hd) * Dh + e; };

  float h = 0.f, c = 0.f, n = 0.f, m = 0.f;
  if (g == 0) {
    h = a.h_in[bh * Dh + e];
    c = a.c_in[bh * Dh + e];
    n = a.n_in[bh * Dh + e];
    m = a.m_in[bh * Dh + e];
    h_s[e] = h;
  }
  float p = S > 0 ? pre[at(0)] : 0.f;
  int next_sel = 0;
  int sel_t = a.n_sel > 0 ? a.sel[0] : -1;
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < Dh; ++d) acc = __fadd_rn(acc, __fmul_rn(h_s[d], repro::to_f32(R[static_cast<size_t>(d) * Dh])));
    x_s[g][e] = __fadd_rn(p, acc);
    if (t + 1 < S) p = pre[at(t + 1)];
    __syncthreads();

    if (g == 0) {
      const float z = tanhf(x_s[0][e]);
      const float i_log = x_s[1][e];
      const float f_log = log_sigmoid(x_s[2][e]);
      const float o = sigmoid(x_s[3][e]);
      const float fm = __fadd_rn(f_log, m);
      const float m_new = fmaxf(fm, i_log);
      const float ig = expf(__fsub_rn(i_log, m_new));
      const float fg = expf(__fsub_rn(fm, m_new));
      c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, z));
      n = __fadd_rn(__fmul_rn(fg, n), ig);
      h = __fdiv_rn(__fmul_rn(o, c), fmaxf(n, 1e-6f));
      m = m_new;
      a.hs[at(t)] = h;
      h_s[e] = h;
      if (t == sel_t) {
        const size_t sb = (static_cast<size_t>(next_sel) * a.B * NH + bh) * Dh + e;
        a.h_sel[sb] = h;
        a.c_sel[sb] = c;
        a.n_sel_out[sb] = n;
        a.m_sel[sb] = m;
      }
    }
    if (t == sel_t) {
      ++next_sel;
      sel_t = next_sel < a.n_sel ? a.sel[next_sel] : -1;
    }
    __syncthreads();
  }

  if (g == 0 && a.h_out != nullptr) {
    a.h_out[bh * Dh + e] = h;
    a.c_out[bh * Dh + e] = c;
    a.n_out[bh * Dh + e] = n;
    a.m_out[bh * Dh + e] = m;
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// pre_z, pre_i, pre_f, pre_o, hs (B, S, NH, Dh) f32; r_z .. r_o (NH, Dh, Dh)
// in r_dtype (repro::DTypeCode: f32 or bf16); h_in .. m_in and h_out ..
// m_out (B, NH, Dh) f32, the outputs all null (the final state is not kept)
// or all set (each may alias its input). All contiguous. sel: n_sel
// ascending step indices (device int32); the state after each goes to
// h_sel .. m_sel (n_sel, B, NH, Dh).
extern "C" int slstm_scan_launch(const void* pre_z, const void* pre_i, const void* pre_f, const void* pre_o,
                                 const void* r_z, const void* r_i, const void* r_f, const void* r_o, int r_dtype,
                                 const void* h_in, const void* c_in, const void* n_in, const void* m_in, void* hs,
                                 void* h_out, void* c_out, void* n_out, void* m_out, const void* sel, int n_sel,
                                 void* h_sel, void* c_sel, void* n_sel_out, void* m_sel, int B, int S, int NH,
                                 int Dh, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (B < 0 || S < 0 || NH < 0 || Dh < 0 || n_sel < 0 || Dh > MAX_DH || B > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || NH == 0 || Dh == 0) return 0;
  Args a{{static_cast<const float*>(pre_z), static_cast<const float*>(pre_i), static_cast<const float*>(pre_f),
          static_cast<const float*>(pre_o)},
         {r_z, r_i, r_f, r_o},
         static_cast<const float*>(h_in), static_cast<const float*>(c_in), static_cast<const float*>(n_in),
         static_cast<const float*>(m_in), static_cast<float*>(hs), static_cast<float*>(h_out),
         static_cast<float*>(c_out), static_cast<float*>(n_out), static_cast<float*>(m_out),
         static_cast<const int*>(sel), n_sel, static_cast<float*>(h_sel), static_cast<float*>(c_sel),
         static_cast<float*>(n_sel_out), static_cast<float*>(m_sel), B, S, NH, Dh};
  const dim3 grid(NH, B);
  auto s = static_cast<cudaStream_t>(stream);
  if (r_dtype == repro::kF32) slstm_scan_kernel<float><<<grid, 4 * Dh, 0, s>>>(a);
  else if (r_dtype == repro::kBF16) slstm_scan_kernel<__nv_bfloat16><<<grid, 4 * Dh, 0, s>>>(a);
  else return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

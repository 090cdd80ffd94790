// mlstm_scan: the mLSTM cell's recurrence over a sequence, for every (batch
// row, head): a (Dh x Dh) matrix memory C, a normaliser n and a stabiliser m,
// with the output h_t = C_t^T q_t / max(|q_t^T n_t|, exp(-m_t)).
//
// It has no pallas_call in the reference: it is the counterpart of the
// lax.scan at src/repro/models/recurrent.py:293-317 (mlstm_block's step),
// which serves every prefill, decode step and verify of the xLSTM models,
// and which on the card would otherwise be S steps of 10-20 launches a layer.
//
// Each step, following the reference's step op for op (logf = log sigmoid(f)
// comes in precomputed):
//   m_new = max(logf + m, i)        fg = exp(logf + m - m_new)
//   ig = exp(i - m_new)             kk = (ig * k) * scale
//   C = fg * C + kk v^T             n = fg * n + kk
//   num = q^T C                     den = max(|q^T n|, exp(-m_new))
//   h = num / den
//
// What bounds it: bytes at decode (C is read and written once, 4 Dh^2 bytes
// a (row, head); q, k, v and h once), the sequential dependence at a long
// prompt (S steps, each a few hundred cycles of latency).
//
// Design: one block of 8 warps per (row, head, 32-column tile of C). Warp w
// keeps rows [w R, w R + R) of the tile in registers for all S steps
// (R = ceil(Dh / 8); 48 floats a thread at Dh = 384), lane l column
// tile * 32 + l, so every load and store of C is one coalesced line. Each
// step stages q, kk and the tile's v in shared memory (the next step's loads
// are issued before this step's arithmetic, into registers), updates n in
// shared memory (element i by thread i mod 256: every tile computes the same
// n, m and den bits from the same inputs), then sums q^T C and q^T n in a
// fixed order set by Dh alone: each thread over its warp's rows in order,
// then the 8 warp partials in order through shared memory (q^T n: a lane's
// rows r = l, l + 32, ... in order, then a butterfly over the warp). So a
// row's bits never depend on B, S or where a sequence was cut. Products and
// sums are rounded separately (__fmul_rn / __fadd_rn): no FMA contraction.
//
// In place: C is read at the start and written at the end by the thread that
// owns each element, so c_out may be c_in. n and m are read by every tile
// and written by tile 0, so n_out / m_out must not alias n_in / m_in.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;
constexpr int MAX_DH = 512;
constexpr int PER_THREAD = (MAX_DH + THREADS - 1) / THREADS;  // staged q / k elements a thread loads

struct Args {
  const float *q, *k, *v, *ig, *lf, *c_in, *n_in, *m_in;
  float *h, *c_out, *n_out, *m_out;
  const int* sel;  // ascending step indices whose state is kept
  int n_sel;
  float *c_sel, *n_sel_out, *m_sel;
  int B, S, NH, Dh;
  float scale;
};

template <int RMAX>
__global__ void __launch_bounds__(THREADS)
mlstm_scan_kernel(Args a) {
  __shared__ float q_s[MAX_DH], kk_s[MAX_DH], n_s[MAX_DH], v_s[TILE];
  __shared__ float num_p[WARPS][TILE], qn_p[WARPS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x, hd = blockIdx.y, b = blockIdx.z;
  const int Dh = a.Dh, NH = a.NH, S = a.S;
  const int R = (Dh + WARPS - 1) / WARPS;
  const int row0 = warp * R;
  const int col = tile * TILE + lane;
  const bool col_ok = col < Dh;
  const size_t bh = static_cast<size_t>(b) * NH + hd;
  const size_t cbase = bh * Dh * Dh;

  float C[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int row = row0 + r;
    C[r] = (r < R && row < Dh && col_ok) ? a.c_in[cbase + static_cast<size_t>(row) * Dh + col] : 0.f;
  }
  for (int i = tid; i < Dh; i += THREADS) n_s[i] = a.n_in[bh * Dh + i];
  float m = a.m_in[bh];

  // step t's inputs, loaded a step ahead into registers
  auto in_at = [&](int t, size_t i) { return ((static_cast<size_t>(b) * S + t) * NH + hd) * Dh + i; };
  auto gate_at = [&](int t) { return (static_cast<size_t>(b) * S + t) * NH + hd; };
  float pq[PER_THREAD], pk[PER_THREAD], pv = 0.f, pi = 0.f, pf = 0.f;
  auto prefetch = [&](int t) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int i = tid + j * THREADS;
      pq[j] = i < Dh ? a.q[in_at(t, i)] : 0.f;
      pk[j] = i < Dh ? a.k[in_at(t, i)] : 0.f;
    }
    if (tid < TILE) pv = col_ok ? a.v[in_at(t, col)] : 0.f;
    pi = a.ig[gate_at(t)];
    pf = a.lf[gate_at(t)];
  };
  if (S > 0) prefetch(0);
  int next_sel = 0;
  int sel_t = a.n_sel > 0 ? a.sel[0] : -1;

  for (int t = 0; t < S; ++t) {
    // gates: every thread computes the same bits from the same two values
    const float lm = __fadd_rn(pf, m);
    const float m_new = fmaxf(lm, pi);
    const float fg = expf(__fsub_rn(lm, m_new));
    const float ig = expf(__fsub_rn(pi, m_new));
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int i = tid + j * THREADS;
      if (i < Dh) {
        const float kk = __fmul_rn(__fmul_rn(ig, pk[j]), a.scale);
        q_s[i] = pq[j];
        kk_s[i] = kk;
        n_s[i] = __fadd_rn(__fmul_rn(fg, n_s[i]), kk);
      }
    }
    if (tid < TILE) v_s[tid] = pv;
    __syncthreads();
    if (t + 1 < S) prefetch(t + 1);

    const float vc = v_s[lane];
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const int row = row0 + r;
      if (r < R && row < Dh) {
        C[r] = __fadd_rn(__fmul_rn(fg, C[r]), __fmul_rn(kk_s[row], vc));
        acc = __fadd_rn(acc, __fmul_rn(q_s[row], C[r]));
      }
    }
    float qn = 0.f;
    for (int r = lane; r < R; r += 32) {
      const int row = row0 + r;
      if (row < Dh) qn = __fadd_rn(qn, __fmul_rn(q_s[row], n_s[row]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) qn = __fadd_rn(qn, __shfl_xor_sync(0xffffffffu, qn, off));
    num_p[warp][lane] = acc;
    if (lane == 0) qn_p[warp] = qn;
    __syncthreads();

    if (warp == 0) {
      float num = 0.f, qn_all = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        num = __fadd_rn(num, num_p[w][lane]);
        qn_all = __fadd_rn(qn_all, qn_p[w]);
      }
      const float den = fmaxf(fabsf(qn_all), expf(-m_new));
      if (col_ok) a.h[in_at(t, col)] = __fdiv_rn(num, den);
    }
    m = m_new;
    if (t == sel_t) {  // keep the state after this step
      const size_t sb = static_cast<size_t>(next_sel) * a.B * NH + bh;
      if (col_ok) {
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          const int row = row0 + r;
          if (r < R && row < Dh) a.c_sel[sb * Dh * Dh + static_cast<size_t>(row) * Dh + col] = C[r];
        }
      }
      if (tile == 0) {
        for (int i = tid; i < Dh; i += THREADS) a.n_sel_out[sb * Dh + i] = n_s[i];
        if (tid == 0) a.m_sel[sb] = m;
      }
      ++next_sel;
      sel_t = next_sel < a.n_sel ? a.sel[next_sel] : -1;
    }
  }

  if (a.c_out != nullptr && col_ok) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const int row = row0 + r;
      if (r < R && row < Dh) a.c_out[cbase + static_cast<size_t>(row) * Dh + col] = C[r];
    }
  }
  if (tile == 0) {
    for (int i = tid; i < Dh; i += THREADS) a.n_out[bh * Dh + i] = n_s[i];
    if (tid == 0) a.m_out[bh] = m;
  }
}

template <int RMAX>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Dh + TILE - 1) / TILE, a.NH, a.B);
  mlstm_scan_kernel<RMAX><<<grid, THREADS, 0, stream>>>(a);
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q, k, v, h (B, S, NH, Dh) f32; ig, lf (B, S, NH) f32; c_in / c_out
// (B, NH, Dh, Dh), n_in / n_out (B, NH, Dh), m_in / m_out (B, NH) f32. All
// contiguous. c_out may be c_in or null (the final C is not kept); n_out and
// m_out are always written and must not alias n_in / m_in. sel: n_sel
// ascending step indices (device int32); the state after each is written to
// c_sel (n_sel, B, NH, Dh, Dh), n_sel_out (n_sel, B, NH, Dh), m_sel (n_sel, B, NH).
extern "C" int mlstm_scan_launch(const void* q, const void* k, const void* v, const void* ig, const void* lf,
                                 const void* c_in, const void* n_in, const void* m_in, void* h, void* c_out,
                                 void* n_out, void* m_out, const void* sel, int n_sel, void* c_sel,
                                 void* n_sel_out, void* m_sel, int B, int S, int NH, int Dh, float scale,
                                 void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (B < 0 || S < 0 || NH < 0 || Dh < 0 || n_sel < 0 || Dh > MAX_DH || B > 65535 || NH > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || NH == 0 || Dh == 0) return 0;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
         static_cast<const float*>(ig), static_cast<const float*>(lf), static_cast<const float*>(c_in),
         static_cast<const float*>(n_in), static_cast<const float*>(m_in), static_cast<float*>(h),
         static_cast<float*>(c_out), static_cast<float*>(n_out), static_cast<float*>(m_out),
         static_cast<const int*>(sel), n_sel, static_cast<float*>(c_sel), static_cast<float*>(n_sel_out),
         static_cast<float*>(m_sel), B, S, NH, Dh, scale};
  const int R = (Dh + WARPS - 1) / WARPS;
  auto s = static_cast<cudaStream_t>(stream);
  if (R <= 4) launch<4>(a, s);
  else if (R <= 8) launch<8>(a, s);
  else if (R <= 16) launch<16>(a, s);
  else if (R <= 32) launch<32>(a, s);
  else if (R <= 48) launch<48>(a, s);
  else launch<64>(a, s);
  return static_cast<int>(cudaGetLastError());
}

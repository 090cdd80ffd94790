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
// a (row, head); q, k, v and h once); at a long prompt, the issue rate of
// the C update, 5 f32 instructions an element a step (products and sums are
// rounded apart, so no FMA), spread over as many SMs as there are blocks.
// Only C, n and m carry from one step to the next: the gates depend on m
// alone, n and q^T n on the gates and k, and h's sums on nothing later.
//
// Design (kernels/mlstm_scan.py::plan sets the tile, the ring's stages and
// the shared memory; the entry checks them): one block per (row, head,
// 16-column tile of C), so xlstm-125m (Dh 384, 4 heads) fills 96 SMs at
// B = 1. Thread (g, c) of the 128 compute threads keeps rows [g R, g R + R)
// of column 16 tile + c in registers for the whole sequence (R = ceil(Dh /
// 8): row group g, summed in order; warp w holds groups 2w and 2w + 1), one
// compute warp a scheduler. A producer warp keeps a ring of stages of 8
// steps in shared memory: q and k rows and the tile's v slice by TMA bulk
// copies when rows are 16-byte multiples (else per-element cp.async copies
// on the same mbarrier), and the gates, loaded a stage ahead and run through
// the m chain there (fg, ig, exp(-m_new) and m_new a step); its lane 0
// arrives twice, with the copies (expect_tx) and after writing the gates,
// so the copies' latency overlaps the gates'. A stage's work:
// - each compute thread computes kk and n for its (up to) 4 rows of n,
//   r = c + 16 i, and its two lane partials of q^T n (rows c, c + 32 and
//   c + 16, c + 48 of its group), then the group's 16 threads finish the
//   parent's butterfly (xor 16 is the thread's own pair, then 8, 4, 2, 1),
//   4 steps side by side;
// - the C update and num's partial over the thread's rows, 2 steps side by
//   side in blocks of 4 rows (float4 reads of q and kk), each partial into
//   the stage. Longer unrolled bodies are slower: a whole stage's steps
//   unrolled (~17 KB of code each) overflow the instruction cache;
// - a reducer warp adds the stage's 8 group partials in order 0..7 into h
//   and hands the stage back to the producer.
// So the compute warps never meet at a barrier: each waits for its stage
// to land and marks its partials written, one mbarrier phase each a stage
// of 8 steps. Every sum has the parent's order, set by Dh alone, and a
// row's bits never depend on B, S or where a sequence was cut. Products and
// sums are rounded separately (__fmul_rn / __fadd_rn): no FMA contraction.
//
// In place: C is read at the start and written at the end by the thread that
// owns each element, so c_out may be c_in. n and m are read by every tile
// and written by tile 0, so n_out / m_out must not alias n_in / m_in.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int kGroups = 8;                  // row groups of C
constexpr int kTile = 16;                   // columns of C a block
constexpr int kCompute = kGroups * kTile;   // compute threads: (group, column)
constexpr int kProducer = kCompute / 32;    // the warp that fills the ring
constexpr int kReducer = kProducer + 1;     // the warp that adds h's partials
constexpr int kThreads = kCompute + 64;
constexpr int kSteps = 8;                   // steps a ring stage holds: a multiple of kQuad and kPair
constexpr int kQuad = 4;                    // steps the prep of kk, n and q^T n takes side by side
constexpr int kPair = 2;                    // steps the C update takes side by side
constexpr int kMaxStages = 8;
constexpr int kNRows = 4;                   // rows of n a thread owns: r = c + 16 i, r < R <= 64
constexpr int MAX_DH = 512;

__host__ __device__ constexpr int rows_per_group(int Dh) { return (Dh + kGroups - 1) / kGroups; }
// a staged row's floats: every group's rows, 16-byte multiples
__host__ __device__ constexpr int row_stride(int Dh) { return (kGroups * rows_per_group(Dh) + 3) / 4 * 4; }
// floats of a stage: q, k [kSteps][RS]; v [kSteps][kTile]; fg, ig, em, m
// [kSteps]; h's partials, acc [kSteps][kGroups][kTile] and qn [kSteps][kGroups]
__host__ __device__ constexpr int stage_floats(int Dh) {
  return 2 * kSteps * row_stride(Dh) + kSteps * kTile + 4 * kSteps + kSteps * kGroups * kTile + kSteps * kGroups;
}
// the ring, kk [kSteps][RS], then three mbarriers a stage: its copies and
// gates landed (full), its partials written (done), its partials added
// (empty)
__host__ __device__ constexpr int smem_bytes(int Dh, int stages) {
  return 4 * (stages * stage_floats(Dh) + kSteps * row_stride(Dh)) + 24 * stages;
}

struct Args {
  const float *q, *k, *v, *ig, *lf, *c_in, *n_in, *m_in;
  float *h, *c_out, *n_out, *m_out;
  const int* sel;  // ascending step indices whose state is kept
  int n_sel;
  float *c_sel, *n_sel_out, *m_sel;
  int B, S, NH, Dh;
  float scale;
  int stages, bulk;
};

// NS steps of C over a thread's rows, a block of 4 rows at a time, each
// step's 4 row updates side by side: C = fg C + kk v, and each step's
// partial sum_r q[r] C[r] in row order, to acc_out (stride kGroups kTile).
// Each C[r] takes its steps in order and each partial its rows in order, so
// the bits are those of a step at a time, but the work between two dependent
// operations is independent; and the code stays small enough for the
// instruction cache, which a whole stage's steps unrolled is not. FULL: all
// RMAX rows valid; VEC: rows read as float4 (R a multiple of 4); else rows
// r < nvalid. fg, v: the steps' gates and v values (stride kTile).
template <int NS, int RMAX, bool FULL, bool VEC>
__device__ __forceinline__ void c_steps(float (&C)[RMAX], const float* q, const float* kk, int RS, const float* fg,
                                        const float* v, bool col_ok, int nvalid, float* acc_out) {
  float acc[NS], f[NS], vv[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    acc[j] = 0.f;
    f[j] = fg[j];
    vv[j] = col_ok ? v[j * kTile] : 0.f;
  }
  if (VEC) {
#pragma unroll
    for (int r0 = 0; r0 < RMAX; r0 += 4) {
      if (FULL || r0 < nvalid) {
        float qv[NS][4], kv[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float4 q4 = *reinterpret_cast<const float4*>(q + j * RS + r0);
          const float4 k4 = *reinterpret_cast<const float4*>(kk + j * RS + r0);
          qv[j][0] = q4.x, qv[j][1] = q4.y, qv[j][2] = q4.z, qv[j][3] = q4.w;
          kv[j][0] = k4.x, kv[j][1] = k4.y, kv[j][2] = k4.z, kv[j][3] = k4.w;
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {  // 4 rows' updates side by side, then their products in row order
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (FULL || r0 + u < nvalid) C[r0 + u] = __fadd_rn(__fmul_rn(f[j], C[r0 + u]), __fmul_rn(kv[j][u], vv[j]));
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (FULL || r0 + u < nvalid) acc[j] = __fadd_rn(acc[j], __fmul_rn(qv[j][u], C[r0 + u]));
        }
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (FULL || r < nvalid) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          C[r] = __fadd_rn(__fmul_rn(f[j], C[r]), __fmul_rn(kk[j * RS + r], vv[j]));
          acc[j] = __fadd_rn(acc[j], __fmul_rn(q[j * RS + r], C[r]));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) acc_out[j * kGroups * kTile] = acc[j];
}

// c_steps with the row path chosen at run time: every row valid, float4 rows, or neither.
template <int NS, int RMAX>
__device__ __forceinline__ void c_update(float (&C)[RMAX], const float* q, const float* kk, int RS, const float* fg,
                                         const float* v, bool col_ok, int nvalid, bool vec, float* acc_out) {
  if (nvalid == RMAX) c_steps<NS, RMAX, true, true>(C, q, kk, RS, fg, v, col_ok, nvalid, acc_out);
  else if (vec) c_steps<NS, RMAX, false, true>(C, q, kk, RS, fg, v, col_ok, nvalid, acc_out);
  else c_steps<NS, RMAX, false, false>(C, q, kk, RS, fg, v, col_ok, nvalid, acc_out);
}

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
mlstm_scan_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dh = a.Dh, NH = a.NH, S = a.S, stages = a.stages;
  const int R = rows_per_group(Dh), RS = row_stride(Dh), SF = stage_floats(Dh);
  float* const ring = reinterpret_cast<float*>(smem);
  float* const kk_s = ring + stages * SF;
  uint64_t* const full = reinterpret_cast<uint64_t*>(kk_s + kSteps * RS);
  uint64_t* const done = full + stages;
  uint64_t* const empty = done + stages;
  // a stage: q, k, v, the gates, then h's partials
  auto stage_at = [&](int s) { return ring + s * SF; };
  auto acc_at = [&](int s) { return stage_at(s) + 2 * kSteps * RS + kSteps * kTile + 4 * kSteps; };
  auto qn_at = [&](int s) { return acc_at(s) + kSteps * kGroups * kTile; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x, hd = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * NH + hd;
  const int col0 = tile * kTile;
  const int chunks = (S + kSteps - 1) / kSteps;
  auto in_at = [&](int t, int i) { return ((static_cast<size_t>(b) * S + t) * NH + hd) * Dh + i; };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 2);  // the producer's lane 0: with its copies (expect_tx), then after the gates
      mbar_init(&done[s], kCompute / 32);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kReducer) {  // h of each stage's steps: (step, column) adds the 8 group partials in order
    for (int k = 0; k < chunks; ++k) {
      const int s = k % stages, t0 = k * kSteps, nt = min(kSteps, S - t0);
      mbar_wait(&done[s], (k / stages) & 1);
      const float* const acc = acc_at(s);
      const float* const qn = qn_at(s);
      const float* const em = stage_at(s) + 2 * kSteps * RS + kSteps * kTile + 2 * kSteps;
      for (int e = lane; e < nt * kTile; e += 32) {
        const int j = e / kTile, cc = e % kTile;
        float num = 0.f, qa = 0.f;
#pragma unroll
        for (int w = 0; w < kGroups; ++w) {
          num = __fadd_rn(num, acc[(j * kGroups + w) * kTile + cc]);
          qa = __fadd_rn(qa, qn[j * kGroups + w]);
        }
        const float den = fmaxf(fabsf(qa), em[j]);
        if (col0 + cc < Dh) a.h[in_at(t0 + j, col0 + cc)] = __fdiv_rn(num, den);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    return;
  }

  if (warp == kProducer) {
    const int vcols = min(kTile, Dh - col0);
    float m = a.m_in[bh];
    // the gates of stage k + 1 are loaded while stage k's are computed: lane j holds step j
    auto load_gates = [&](int k, float& i_, float& f_) {
      const int t = k * kSteps + lane;
      if (lane < kSteps && t < S) {
        const size_t gi = (static_cast<size_t>(b) * S + t) * NH + hd;
        i_ = a.ig[gi];
        f_ = a.lf[gi];
      }
    };
    float li = 0.f, lf = 0.f;
    if (chunks > 0) load_gates(0, li, lf);
    for (int k = 0; k < chunks; ++k) {
      const int s = k % stages, t0 = k * kSteps, nt = min(kSteps, S - t0);
      if (k >= stages) mbar_wait(&empty[s], ((k / stages) - 1) & 1);
      float* const q_st = stage_at(s);
      float* const k_st = q_st + kSteps * RS;
      float* const v_st = k_st + kSteps * RS;
      float* const gt = v_st + kSteps * kTile;
      if (a.bulk) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], nt * (2 * Dh + vcols) * 4);
          for (int j = 0; j < nt; ++j) {
            bulk_load(q_st + j * RS, a.q + in_at(t0 + j, 0), Dh * 4, &full[s]);
            bulk_load(k_st + j * RS, a.k + in_at(t0 + j, 0), Dh * 4, &full[s]);
            bulk_load(v_st + j * kTile, a.v + in_at(t0 + j, col0), vcols * 4, &full[s]);
          }
        }
      } else {
        for (int e = lane; e < nt * Dh; e += 32) {
          const int j = e / Dh, i = e - j * Dh;
          cp_async4(q_st + j * RS + i, a.q + in_at(t0 + j, i));
          cp_async4(k_st + j * RS + i, a.k + in_at(t0 + j, i));
        }
        for (int e = lane; e < nt * vcols; e += 32) {
          const int j = e / vcols, c = e - j * vcols;
          cp_async4(v_st + j * kTile + c, a.v + in_at(t0 + j, col0 + c));
        }
        cp_async_mbar_arrive(&full[s]);  // the phase also waits for this lane's copies
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
      float nli = 0.f, nlf = 0.f;
      if (k + 1 < chunks) load_gates(k + 1, nli, nlf);
      // the m chain runs through the lanes in step order, then each lane
      // computes its step's values, and lane 0 writes them all and arrives
      float mp = m;  // m before this lane's step
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const float fj = __shfl_sync(0xffffffffu, lf, j), ij = __shfl_sync(0xffffffffu, li, j);
        if (j < nt) {
          if (lane == j) mp = m;
          m = fmaxf(__fadd_rn(fj, m), ij);
        }
      }
      const float lm = __fadd_rn(lf, mp);
      const float m_new = fmaxf(lm, li);
      const float vals[4] = {expf(__fsub_rn(lm, m_new)),  // fg
                             expf(__fsub_rn(li, m_new)),  // ig
                             expf(-m_new),                // den's floor
                             m_new};
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __shfl_sync(0xffffffffu, vals[e], j);
          if (lane == 0 && j < nt) gt[e * kSteps + j] = v;
        }
      if (lane == 0) mbar_arrive(&full[s]);
      li = nli;
      lf = nlf;
    }
    if (tile == 0 && lane == 0) a.m_out[bh] = m;
    return;
  }

  // compute thread (g, c): rows [g R, g R + R) of column col0 + c
  const int g = tid >> 4, c = tid & (kTile - 1);
  const int row0 = g * R;
  const int nvalid = max(0, min(R, Dh - row0));  // the group's rows below Dh
  const int col = col0 + c;
  const bool col_ok = col < Dh;
  const bool vec = (R & 3) == 0;
  const size_t cbase = bh * Dh * Dh;

  float C[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    C[r] = (r < nvalid && col_ok) ? a.c_in[cbase + static_cast<size_t>(row0 + r) * Dh + col] : 0.f;
  float nr[kNRows];  // n at rows row0 + c + 16 i
#pragma unroll
  for (int i = 0; i < kNRows; ++i) nr[i] = c + 16 * i < nvalid ? a.n_in[bh * Dh + row0 + c + 16 * i] : 0.f;

  int si = 0;  // the first kept step not yet reached
  for (int k = 0; k < chunks; ++k) {
    const int s = k % stages, t0 = k * kSteps, nt = min(kSteps, S - t0);
    const float* const q_st = stage_at(s);
    const float* const k_st = q_st + kSteps * RS;
    const float* const v_st = k_st + kSteps * RS;
    const float* const gt = v_st + kSteps * kTile;
    unsigned keep = 0;  // bit j: the state after step t0 + j is kept, at stack index si + (bits below j)
    int sj = si;
    for (; sj < a.n_sel && a.sel[sj] < t0 + nt; ++sj) keep |= 1u << (a.sel[sj] - t0);
    auto kept_at = [&](int j) { return static_cast<size_t>(si + __popc(keep & ((1u << j) - 1))) * a.B * NH + bh; };
    mbar_wait(&full[s], (k / stages) & 1);

    // kk and n at this thread's rows of n; q^T n of the group, the parent's
    // tree: the thread's two lane partials, then the butterfly's levels over
    // the group's 16 threads; a quad of steps at a time, side by side (every
    // read of the quad first, so one latency covers them: the stores of kk
    // below could otherwise alias them)
    float* const qn = qn_at(s) + g;  // step j's at j * kGroups
    float* const acc_out = acc_at(s) + g * kTile + c;  // step j's at j * kGroups * kTile
#pragma unroll 1
    for (int j0 = 0; j0 < nt; j0 += kQuad) {
      const int nq = min(kQuad, nt - j0);
      const bool whole = nq == kQuad && (keep >> j0 & ((1u << kQuad) - 1)) == 0;  // no step cut off or kept
      float x[kQuad], fgv[kQuad], igv[kQuad], kv[kQuad][kNRows], qv[kQuad][kNRows];
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        fgv[j] = gt[j0 + j];
        igv[j] = gt[kSteps + j0 + j];
#pragma unroll
        for (int i = 0; i < kNRows; ++i) {
          const int row = row0 + c + 16 * i;
          kv[j][i] = c + 16 * i < nvalid ? k_st[(j0 + j) * RS + row] : 0.f;
          qv[j][i] = c + 16 * i < nvalid ? q_st[(j0 + j) * RS + row] : 0.f;
        }
      }
      if (whole) {  // in phases: every kk, their stores, the n chain, then the products
        float kkv[kQuad][kNRows], pr[kQuad][kNRows];
#pragma unroll
        for (int j = 0; j < kQuad; ++j)
#pragma unroll
          for (int i = 0; i < kNRows; ++i) kkv[j][i] = __fmul_rn(__fmul_rn(igv[j], kv[j][i]), a.scale);
#pragma unroll
        for (int j = 0; j < kQuad; ++j)
#pragma unroll
          for (int i = 0; i < kNRows; ++i)
            if (c + 16 * i < nvalid) kk_s[(j0 + j) * RS + row0 + c + 16 * i] = kkv[j][i];
#pragma unroll
        for (int j = 0; j < kQuad; ++j)
#pragma unroll
          for (int i = 0; i < kNRows; ++i) {
            nr[i] = c + 16 * i < nvalid ? __fadd_rn(__fmul_rn(fgv[j], nr[i]), kkv[j][i]) : 0.f;
            pr[j][i] = __fmul_rn(qv[j][i], nr[i]);
          }
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          float p[2] = {0.f, 0.f};  // lane partials c (rows c, c + 32) and c + 16 (rows c + 16, c + 48)
#pragma unroll
          for (int i = 0; i < kNRows; ++i)
            if (c + 16 * i < nvalid) p[i & 1] = __fadd_rn(p[i & 1], pr[j][i]);
          x[j] = __fadd_rn(p[0], p[1]);
        }
      } else {  // the last steps of a sequence, or kept steps: a step at a time
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          x[j] = 0.f;
          if (j < nq) {
            float p[2] = {0.f, 0.f};
#pragma unroll
            for (int i = 0; i < kNRows; ++i) {
              if (c + 16 * i < nvalid) {
                const float kk = __fmul_rn(__fmul_rn(igv[j], kv[j][i]), a.scale);
                kk_s[(j0 + j) * RS + row0 + c + 16 * i] = kk;
                nr[i] = __fadd_rn(__fmul_rn(fgv[j], nr[i]), kk);
                p[i & 1] = __fadd_rn(p[i & 1], __fmul_rn(qv[j][i], nr[i]));
              }
            }
            x[j] = __fadd_rn(p[0], p[1]);
            if ((keep >> (j0 + j) & 1) && tile == 0) {
              const size_t sb = kept_at(j0 + j);
#pragma unroll
              for (int i = 0; i < kNRows; ++i)
                if (c + 16 * i < nvalid) a.n_sel_out[sb * Dh + row0 + c + 16 * i] = nr[i];
              if (tid == 0) a.m_sel[sb] = gt[3 * kSteps + j0 + j];
            }
          }
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kQuad; ++j) x[j] = __fadd_rn(x[j], __shfl_xor_sync(0xffffffffu, x[j], off));
      }
      if (c == 0) {
#pragma unroll
        for (int j = 0; j < kQuad; ++j)
          if (j < nq) qn[(j0 + j) * kGroups] = x[j];
      }
    }
    __syncwarp();  // kk of the warp's two groups

    const float* const qr = q_st + row0;
    const float* const kr = kk_s + row0;
    if (nt == kSteps && keep == 0) {  // a whole stage, nothing kept: a pair of steps at a time
#pragma unroll 1
      for (int j = 0; j < kSteps; j += kPair)
        c_update<kPair>(C, qr + j * RS, kr + j * RS, RS, gt + j, v_st + j * kTile + c, col_ok, nvalid, vec,
                        acc_out + j * kGroups * kTile);
    } else {  // the last stage of a sequence, or one with kept steps: a step at a time
      for (int j = 0; j < nt; ++j) {
        c_update<1>(C, qr + j * RS, kr + j * RS, RS, gt + j, v_st + j * kTile + c, col_ok, nvalid, vec,
                    acc_out + j * kGroups * kTile);
        if ((keep >> j & 1) && col_ok) {
          const size_t sb = kept_at(j);
#pragma unroll
          for (int r = 0; r < RMAX; ++r)
            if (r < nvalid) a.c_sel[sb * Dh * Dh + static_cast<size_t>(row0 + r) * Dh + col] = C[r];
        }
      }
    }
    si = sj;
    __syncwarp();  // the warp's partials written, its reads of kk done
    if (lane == 0) mbar_arrive(&done[s]);
  }

  if (a.c_out != nullptr && col_ok) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < nvalid) a.c_out[cbase + static_cast<size_t>(row0 + r) * Dh + col] = C[r];
  }
  if (tile == 0) {
#pragma unroll
    for (int i = 0; i < kNRows; ++i)
      if (c + 16 * i < nvalid) a.n_out[bh * Dh + row0 + c + 16 * i] = nr[i];
  }
}

template <int RMAX>
cudaError_t launch(const Args& a, int smem, cudaStream_t stream) {
  static int smem_set = 48 * 1024;  // per instantiation; above 48 KB needs the opt-in
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(mlstm_scan_kernel<RMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const dim3 grid((a.Dh + kTile - 1) / kTile, a.NH, a.B);
  mlstm_scan_kernel<RMAX><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q, k, v, h (B, S, NH, Dh) f32; ig, lf (B, S, NH) f32; c_in / c_out
// (B, NH, Dh, Dh), n_in / n_out (B, NH, Dh), m_in / m_out (B, NH) f32. All
// contiguous. c_out may be c_in or null (the final C is not kept); n_out and
// m_out are always written and must not alias n_in / m_in. sel: n_sel
// ascending step indices (device int32); the state after each is written to
// c_sel (n_sel, B, NH, Dh, Dh), n_sel_out (n_sel, B, NH, Dh), m_sel (n_sel, B, NH).
// The plan (kernels/mlstm_scan.py::plan, whose tile and steps are kTile and
// kSteps): `stages` stages in `smem` bytes (smem_bytes(Dh, stages)); `bulk`:
// TMA bulk copies (Dh a multiple of 4, q, k, v 16-byte aligned), else
// per-element cp.async.
extern "C" int mlstm_scan_launch(const void* q, const void* k, const void* v, const void* ig, const void* lf,
                                 const void* c_in, const void* n_in, const void* m_in, void* h, void* c_out,
                                 void* n_out, void* m_out, const void* sel, int n_sel, void* c_sel,
                                 void* n_sel_out, void* m_sel, int B, int S, int NH, int Dh, float scale,
                                 int stages, int bulk, int smem, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (B < 0 || S < 0 || NH < 0 || Dh < 0 || n_sel < 0 || Dh > MAX_DH || B > 65535 || NH > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || NH == 0 || Dh == 0) return 0;
  const bool aligned = Dh % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (stages < 2 || stages > kMaxStages || smem != smem_bytes(Dh, stages) || (bulk && !aligned))
    return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
         static_cast<const float*>(ig), static_cast<const float*>(lf), static_cast<const float*>(c_in),
         static_cast<const float*>(n_in), static_cast<const float*>(m_in), static_cast<float*>(h),
         static_cast<float*>(c_out), static_cast<float*>(n_out), static_cast<float*>(m_out),
         static_cast<const int*>(sel), n_sel, static_cast<float*>(c_sel), static_cast<float*>(n_sel_out),
         static_cast<float*>(m_sel), B, S, NH, Dh, scale, stages, bulk};
  const int R = rows_per_group(Dh);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (R <= 4) err = launch<4>(a, smem, s);
  else if (R <= 8) err = launch<8>(a, smem, s);
  else if (R <= 16) err = launch<16>(a, smem, s);
  else if (R <= 32) err = launch<32>(a, smem, s);
  else if (R <= 48) err = launch<48>(a, smem, s);
  else err = launch<64>(a, smem, s);
  return static_cast<int>(err);
}

// Flash-attention backward, dK/dV pass, for Hopper (sm_90a); plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel analytics_zoo_tpu/ops/attention.py:
// _flash_bwd_dkv_kernel (launched by _flash_bwd). It computes the same
// function, not the same blocks: with q2 = q * sm_scale * log2(e), L the
// forward's lse2 and delta = rowsum(g * o) (written by the dQ pass), it
// rebuilds P^T = exp2(k q2^T - L) and dP^T = v g^T tile by tile, takes
// dS^T = P^T (dP^T - delta), sums dv += P^T g and dk += dS^T q2 over the
// query tiles, and multiplies dk by 1/log2(e) at the end (q2 carried the
// log2 prescale). Causal masking is bottom-right aligned (q_offset = Sk -
// Sq): the query loop starts at the first query tile that sees this CTA's
// keys, and only diagonal and ragged tiles are masked. All arithmetic is
// f32, for f32 and bf16 inputs alike (the TPU kernel rounds P and dS to bf16
// for bf16 inputs; this one does not).
//
// Design: one CTA of 256 threads per (batch*head, 64 key rows). The CTA
// stages its k and v tiles once and loops over 64-row tiles of q2 and g in
// shared memory; the loop takes the place of the TPU grid's sequential query
// dimension, and dk and dv accumulate in registers in place of its VMEM
// scratch, so no atomics are needed and the result is deterministic.
// Thread (ty, tx) owns key rows 4ty..4ty+3: it computes a 4 x 4 block of
// P^T and dS^T (query columns tx + 16j) with scalar FMAs, writes both to
// shared memory, and accumulates 4 x D/16 blocks of dk and dv. Shared
// memory: k, v, q2, g tiles (64 x (D+1) f32 each), the P^T and dS^T tiles
// (64 x 65) and L, delta (64 each): 100 KB at D = 64, 166 KB at D = 128,
// above 48 KB so opted in.
//
// What bounds it on the H100: at the training shape (B=32, S=128, H=12,
// D=64, f32) the work is 4 matmuls, 8*B*H*S^2*D = 3.22 GFLOP, 48 us at the
// card's 67 TFLOP/s of f32 FMA outside the tensor cores, against 75 MB of
// q, k, v, g read and dk, dv written, 23 us at 3.35 TB/s: bound by
// operations on the CUDA cores, the unit this kernel uses. P and dS never
// reach device memory. Each FMA costs half a shared-memory load, so shared
// bandwidth is the kernel's own limit; mma.sync/wgmma tiles are later work.

#include "flash_common.cuh"

namespace {

using namespace zoo_flash;

template <int D>
constexpr int smem_floats() {
  return 2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * PS + 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(BwdParams p) {
  constexpr int DP = D + 1;    // padded row of the staged tiles
  constexpr int DJ = D / 16;   // dk/dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;            // k tile
  float* Vs = Ks + BK * DP;    // v tile
  float* Qs = Vs + BK * DP;    // q2 tile
  float* Gs = Qs + BQ * DP;    // g tile
  float* Ps = Gs + BQ * DP;    // P^T tile (key rows x query columns)
  float* Ss = Ps + BK * PS;    // dS^T tile
  float* Ls = Ss + BK * PS;    // L of the query tile
  float* Ds = Ls + BQ;         // delta of the query tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * BK;
  const int q_off = p.Sk - p.Sq;
  const long long row0 = static_cast<long long>(bh) * p.Sq;

  const T* qp = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kp = static_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* vp = static_cast<const T*>(p.v) + b * p.vb + h * p.vh;
  const T* gp = static_cast<const T*>(p.g) + b * p.gb + h * p.gh;
  T* dkp = static_cast<T*>(p.out0) + b * p.xb + h * p.xh;
  T* dvp = static_cast<T*>(p.out1) + b * p.xb + h * p.xh;

  load_tile<T, D>(Ks, kp, p.ks, k0, p.Sk, 1.f);
  load_tile<T, D>(Vs, vp, p.vs, k0, p.Sk, 1.f);

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // causal: the first query tile with a row that sees key k0 is the one
  // holding query q_off + q >= k0
  const int q_begin = p.causal ? (max(0, k0 - q_off) / BQ) * BQ : 0;
  const bool k_ragged = k0 + BK > p.Sk;
  for (int q0 = q_begin; q0 < p.Sq; q0 += BQ) {
    __syncthreads();   // the previous tile's q2, g, P^T, dS^T consumed
    load_tile<T, D>(Qs, qp, p.qs, q0, p.Sq, p.scale2);
    load_tile<T, D>(Gs, gp, p.gs, q0, p.Sq, 1.f);
    if (tid < BQ) {
      const int s = q0 + tid;
      Ls[tid] = s < p.Sq ? p.lse[row0 + s] : 0.f;
      Ds[tid] = s < p.Sq ? p.delta[row0 + s] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_block<D>(s, Ks, Qs, ty, tx);    // k q2^T
    dot_block<D>(dp, Vs, Gs, ty, tx);   // v g^T

    const bool diag = p.causal && (q_off + q0 < k0 + BK - 1);
    if (diag || k_ragged || q0 + BQ > p.Sq) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = q0 + tx + 16 * j;
          if (kr >= p.Sk || qc >= p.Sq || (p.causal && q_off + qc < kr))
            s[i][j] = NEG_INF;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pt = exp2f(s[i][j] - Ls[c]);
        Ps[(ty * 4 + i) * PS + c] = pt;
        Ss[(ty * 4 + i) * PS + c] = pt * (dp[i][j] - Ds[c]);
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BQ; ++kk) {
      float pt[4], ds[4], gv[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pt[i] = Ps[(ty * 4 + i) * PS + kk];
        ds[i] = Ss[(ty * 4 + i) * PS + kk];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        gv[j] = Gs[kk * DP + tx + 16 * j];
        qv[j] = Qs[kk * DP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] = fmaf(pt[i], gv[j], dv[i][j]);
          dk[i][j] = fmaf(ds[i], qv[j], dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r < p.Sk) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dkp[r * p.xs + tx + 16 * j] = from_f<T>(dk[i][j] * p.out_scale);
        dvp[r * p.xs + tx + 16 * j] = from_f<T>(dv[i][j]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.Sk + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const BwdParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted.
int zoo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dk, void* dv, int dtype, int B, int H, int Sq,
                      int Sk, int D,
                      long long qb, long long qs, long long qh,
                      long long kb, long long ks, long long kh,
                      long long vb, long long vs, long long vh,
                      long long gb, long long gs, long long gh,
                      long long xb, long long xs, long long xh,
                      float scale2, float out_scale, int causal,
                      void* stream) {
  if (!grid_ok(B, H, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{q, k, v, nullptr, g, static_cast<const float*>(lse),
              static_cast<float*>(const_cast<void*>(delta)), dk, dv,
              B, H, Sq, Sk, qb, qs, qh, kb, ks, kh, vb, vs, vh,
              0, 0, 0, gb, gs, gh, xb, xs, xh, scale2, out_scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case 0: e = launch_d<float>(p, D, st); break;
    case 1: e = launch_d<__nv_bfloat16>(p, D, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"

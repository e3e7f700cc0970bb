// Flash-attention backward, dQ pass, for Hopper (sm_90a); plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel analytics_zoo_tpu/ops/attention.py:
// _flash_bwd_dq_kernel (launched by _flash_bwd). It computes the same
// function, not the same blocks: with q2 = q * sm_scale * log2(e) and L the
// forward's lse2, it rebuilds P = exp2(q2 k^T - L) tile by tile, takes
// dP = g v^T and dS = P (dP - delta), sums dq += dS k over the key tiles and
// multiplies by sm_scale at the end. delta = rowsum(g * o), an XLA op
// outside the TPU kernels, is folded in here: the CTA has its g rows staged
// anyway, reads the o rows once, and writes delta for the dK/dV pass.
// Causal masking is bottom-right aligned (q_offset = Sk - Sq) like the
// forward: the key loop ends at the diagonal, and only diagonal and ragged
// tiles are masked. All arithmetic is f32, for f32 and bf16 inputs alike
// (the TPU kernel rounds P and dS to bf16 for bf16 inputs; this one does
// not).
//
// Design: one CTA of 256 threads per (batch*head, 64 query rows). The CTA
// stages its q2 and g tiles once and loops over 64-key tiles of k and v in
// shared memory; the loop takes the place of the TPU grid's sequential key
// dimension, and dq accumulates in registers in place of its VMEM scratch,
// so no atomics are needed and the result is deterministic. Thread (ty, tx)
// computes a 4 x 4 block of S and of dP with scalar FMAs, writes its dS
// block to shared memory, and accumulates a 4 x D/16 block of dq. Shared
// memory: q2, g, k, v tiles (64 x (D+1) f32 each) and the dS tile (64 x 65):
// 83 KB at D = 64, 149 KB at D = 128, above 48 KB so opted in.
//
// What bounds it on the H100: at the training shape (B=32, S=128, H=12,
// D=64, f32) the work is 3 matmuls, 6*B*H*S^2*D = 2.42 GFLOP, 36 us at the
// card's 67 TFLOP/s of f32 FMA outside the tensor cores, against 75 MB of
// q, k, v, o, g read and dq written, 23 us at 3.35 TB/s: bound by
// operations on the CUDA cores, the unit this kernel uses. P and dS never
// reach device memory. Each FMA costs half a shared-memory load, so shared
// bandwidth is the kernel's own limit; mma.sync/wgmma tiles are later work.

#include "flash_common.cuh"

namespace {

using namespace zoo_flash;

template <int D>
constexpr int smem_floats() {
  return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * PS;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int DP = D + 1;    // padded row of the staged tiles
  constexpr int DJ = D / 16;   // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // q2 tile
  float* Gs = Qs + BQ * DP;    // g tile
  float* Ks = Gs + BQ * DP;    // k tile (first the o tile, for delta)
  float* Vs = Ks + BK * DP;    // v tile
  float* Ss = Vs + BK * DP;    // dS tile (first the delta column)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * BQ;
  const int q_off = p.Sk - p.Sq;
  const long long row0 = static_cast<long long>(bh) * p.Sq;

  const T* qp = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kp = static_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* vp = static_cast<const T*>(p.v) + b * p.vb + h * p.vh;
  const T* op = static_cast<const T*>(p.o) + b * p.ob + h * p.oh;
  const T* gp = static_cast<const T*>(p.g) + b * p.gb + h * p.gh;
  T* dqp = static_cast<T*>(p.out0) + b * p.xb + h * p.xh;

  load_tile<T, D>(Qs, qp, p.qs, q0, p.Sq, p.scale2);
  load_tile<T, D>(Gs, gp, p.gs, q0, p.Sq, 1.f);
  load_tile<T, D>(Ks, op, p.os, q0, p.Sq, 1.f);
  __syncthreads();
  {  // delta = rowsum(g * o): four threads per row, then a 4-lane shuffle
    const int r = tid >> 2, part = tid & 3;
    float acc = 0.f;
#pragma unroll
    for (int c = part; c < D; c += 4)
      acc = fmaf(Gs[r * DP + c], Ks[r * DP + c], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      Ss[r] = acc;
      if (q0 + r < p.Sq) p.delta[row0 + q0 + r] = acc;
    }
  }
  __syncthreads();

  float L[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    L[i] = s < p.Sq ? p.lse[row0 + s] : 0.f;
    dl[i] = Ss[ty * 4 + i];
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // causal: the last query row of this tile sees keys <= q_off + q0 + BQ-1
  const int k_end = p.causal ? min(p.Sk, q_off + q0 + BQ) : p.Sk;
  const bool q_ragged = q0 + BQ > p.Sq;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's k, v and dS (and o) consumed
    load_tile<T, D>(Ks, kp, p.ks, k0, p.Sk, 1.f);
    load_tile<T, D>(Vs, vp, p.vs, k0, p.Sk, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_block<D>(s, Qs, Ks, ty, tx);    // q2 k^T
    dot_block<D>(dp, Gs, Vs, ty, tx);   // g v^T

    const bool diag = p.causal && (q_off + q0 < k0 + BK - 1);
    if (diag || q_ragged || k0 + BK > p.Sk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = q0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kc = k0 + tx + 16 * j;
          if (kc >= p.Sk || qr >= p.Sq || (p.causal && q_off + qr < kc))
            s[i][j] = NEG_INF;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty * 4 + i) * PS + tx + 16 * j] =
            exp2f(s[i][j] - L[i]) * (dp[i][j] - dl[i]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ss[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s < p.Sq) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        dqp[s * p.xs + tx + 16 * j] = from_f<T>(acc[i][j] * p.out_scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, D><<<grid, NT, bytes, stream>>>(p);
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
int zoo_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* o, const void* g, const void* lse,
                     void* delta, void* dq, int dtype, int B, int H, int Sq,
                     int Sk, int D,
                     long long qb, long long qs, long long qh,
                     long long kb, long long ks, long long kh,
                     long long vb, long long vs, long long vh,
                     long long ob, long long os, long long oh,
                     long long gb, long long gs, long long gh,
                     long long xb, long long xs, long long xh,
                     float scale2, float out_scale, int causal,
                     void* stream) {
  if (!grid_ok(B, H, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{q, k, v, o, g, static_cast<const float*>(lse),
              static_cast<float*>(delta), dq, nullptr, B, H, Sq, Sk,
              qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh,
              xb, xs, xh, scale2, out_scale, causal};
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

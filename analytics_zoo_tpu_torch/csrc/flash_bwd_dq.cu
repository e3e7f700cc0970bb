// Flash-attention backward, dQ pass, for Hopper (sm_90a); plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel analytics_zoo_tpu/ops/attention.py:
// _flash_bwd_dq_kernel (launched by _flash_bwd). It computes the same
// function, not the same blocks: with q2 = q * sm_scale * log2(e) and L the
// forward's lse2, it rebuilds P = exp2(q2 k^T - L) tile by tile, takes
// dP = g v^T and dS = P (dP - delta), sums dq += dS k over the key tiles and
// multiplies by sm_scale at the end (q is read as it is, and the product by
// sm_scale * log2(e) is folded into the scores). delta = rowsum(g * o), an
// XLA op outside the TPU kernels, is folded in here: the CTA stages its g
// rows anyway, reads the o rows once, and writes delta for the dK/dV pass.
// Causal masking is bottom-right aligned (q_offset = Sk - Sq) like the
// forward: the key loop ends at the diagonal, and only diagonal and ragged
// tiles are masked. P and dS are f32 for f32 and bf16 inputs alike (the TPU
// kernel rounds them to bf16 for bf16 inputs; this one does not).
//
// What bounds it on the H100: at the training shape (B=32, S=128, H=12,
// D=64, f32) it reads q, k, v, o, g and L and writes dq and delta, 75.9 MB,
// 22.7 us at 3.35 TB/s; its three products, 6*B*H*S^2*D = 2.42 GFLOP, take
// 14.7 us at f32 accuracy on the TF32 tensor cores (three passes at
// 495 TFLOP/s), so it is bound by bytes; on the CUDA cores (67 TFLOP/s) the
// products alone would take 36 us. P and dS never reach device memory.
//
// Design: the three products run on the tensor cores in 3xTF32
// (mma_tf32.cuh; bf16 operands are exact and skip their lo passes). One CTA
// of 4 warps per (batch*head, 64 query rows), looping over 64-key tiles;
// the loop takes the place of the TPU grid's sequential key dimension. Each
// warp owns 16 query rows and keeps their dq (16 x D f32, 32 registers per
// thread at D = 64) in registers for the whole loop, so there are no
// atomics and the result is deterministic. Q and G are staged once; their A
// fragments are re-read from shared memory per key tile (holding both
// split would cost 4 D registers). K and V stream through a two-stage
// cp.async ring (16 B per thread), so the next key tile loads while the
// current one is multiplied. S = Q K^T and dP = G V^T come out in the
// accumulator layout, become P and dS in place, and feed dQ += dS K straight
// from those registers, the key order of each k-step permuted as
// mma_tf32.cuh sets out (no shared-memory round trip). The o tile is needed
// only for delta: it is staged in the ring's second K slot, which the first
// prefetch overwrites once delta is taken. At D = 128 a key tile goes in
// four passes of 16 keys, which keeps S and dP at 16 registers beside dq
// and its pass accumulator (128).
//
// Accuracy: the tensor core's f32 accumulation truncates, so an
// accumulator fed by many mma passes drifts towards zero by up to an ulp a
// pass. dq sums over every key (24 passes per 64-key tile at D = 64), so
// each pass of keys sums its dS K from zero in an accumulator of its own,
// which is then added into dq in f32, rounded to nearest: the drift stays
// that of one tile's passes at any sequence length, for D/2 more
// registers.
//
// Shared memory per CTA: Q, G and two stages of K and V (six 64-row tiles,
// rows padded 16 bytes) and L and delta (512 B): 104,960 B at D = 64 and
// 203,264 B at D = 128 in f32 (2 and 1 CTAs per SM by shared memory),
// 55,808 B and 104,960 B in bf16.

#include "mma_tf32.cuh"

namespace {

using namespace zoo_mma;
using zoo_flash::BwdParams;
using zoo_flash::from_f;
using zoo_flash::NEG_INF;

template <typename T, int D>
constexpr size_t smem_bytes() {   // L, delta, Q, G, 2 x (K, V)
  return 2 * ROWS * sizeof(float) + 6 * tile_elems<T, D>() * sizeof(T);
}

// The explicit 1 lets ptxas take up to 255 registers (see flash_fwd.cu).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(BwdParams p) {
  constexpr bool EX = sizeof(T) == 2;   // bf16 is exact in tf32
  constexpr int TILE = tile_elems<T, D>();
  constexpr int P = pitch<T, D>();
  constexpr int KS = D / 8;             // k-steps over D, n-tiles of dq
  constexpr int KC = D <= 64 ? 64 : 16; // keys per pass
  constexpr int NJ = KC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ls = reinterpret_cast<float*>(smem_raw);
  float* Ds = Ls + ROWS;
  T* Qs = reinterpret_cast<T*>(smem_raw + 2 * ROWS * sizeof(float));
  T* Gs = Qs + TILE;
  T* KV = Gs + TILE;   // stage st: K at KV + 2 st TILE, V right after it
  T* Os = KV + 2 * TILE;   // the o tile, before the ring fills stage 1

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;   // this warp's rows of the query tile
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * ROWS;
  const int q_off = p.Sk - p.Sq;
  const long long row0 = static_cast<long long>(bh) * p.Sq;

  const T* qp = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kp = static_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* vp = static_cast<const T*>(p.v) + b * p.vb + h * p.vh;
  const T* op = static_cast<const T*>(p.o) + b * p.ob + h * p.oh;
  const T* gp = static_cast<const T*>(p.g) + b * p.gb + h * p.gh;
  T* dqp = static_cast<T*>(p.out0) + b * p.xb + h * p.xh;

  // causal: the last query row of this tile sees keys <= q_off + q0 + 63
  const int k_end = p.causal ? min(p.Sk, q_off + q0 + ROWS) : p.Sk;
  const int n_kt = (k_end + ROWS - 1) / ROWS;
  cp_tile<T, D>(Qs, qp, p.qs, q0, p.Sq);
  cp_tile<T, D>(Gs, gp, p.gs, q0, p.Sq);
  cp_tile<T, D>(Os, op, p.os, q0, p.Sq);
  if (threadIdx.x < ROWS) {
    const int s = q0 + threadIdx.x;
    const bool ok = s < p.Sq;
    cp_async4(Ls + threadIdx.x, p.lse + row0 + (ok ? s : 0), ok ? 4 : 0);
  }
  cp_async_commit();
  cp_tile<T, D>(KV, kp, p.ks, 0, p.Sk);
  cp_tile<T, D>(KV + TILE, vp, p.vs, 0, p.Sk);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  {  // delta = rowsum(g * o): two threads per row, then one shuffle
    const int r = threadIdx.x >> 1, part = threadIdx.x & 1;
    float acc = 0.f;
#pragma unroll
    for (int c = part; c < D; c += 2)
      acc = fmaf(to_f(Gs[r * P + c]), to_f(Os[r * P + c]), acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      Ds[r] = acc;
      if (q0 + r < p.Sq) p.delta[row0 + q0 + r] = acc;
    }
  }
  __syncthreads();   // delta is in Ds, and the o slot may be refilled

  // L and delta of rows g and g + 8 of the warp's 16 (rows past Sq: L = 0,
  // delta = 0 and zero q, g, so their dS is 0)
  float lr[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lr[i] = Ls[r0 + g + 8 * i];
    dl[i] = Ds[r0 + g + 8 * i];
  }
  float dq[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq[n][r] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * ROWS;
    if (it + 1 < n_kt) {   // the next K/V tile loads while this one runs
      T* nx = KV + ((it + 1) & 1) * 2 * TILE;
      cp_tile<T, D>(nx, kp, p.ks, k0 + ROWS, p.Sk);
      cp_tile<T, D>(nx + TILE, vp, p.vs, k0 + ROWS, p.Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Ks = KV + (it & 1) * 2 * TILE;
    const T* Vs = Ks + TILE;
    // mask only the diagonal (causal) and ragged key tiles
    const bool masked =
        (p.causal && (q_off + q0 < k0 + ROWS - 1)) || k0 + ROWS > p.Sk;

#pragma unroll 1
    for (int c0 = 0; c0 < ROWS; c0 += KC) {
      // S = Q K^T and dP = G V^T: 16 query rows x KC keys per warp
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[j][r] = dp[j][r] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const FragA qa = a_frag<EX, T, D>(Qs, r0, 8 * ks, g, t);
        const FragA ga = a_frag<EX, T, D>(Gs, r0, 8 * ks, g, t);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma3<EX, EX>(s[j], qa,
                       b_frag_t<EX, T, D>(Ks, c0 + 8 * j, 8 * ks, g, t));
          mma3<EX, EX>(dp[j], ga,
                       b_frag_t<EX, T, D>(Vs, c0 + 8 * j, 8 * ks, g, t));
        }
      }

      // P = exp2(S * scale2 - L) and dS = P (dP - delta), in place in dp
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float sv = s[j][r] * p.scale2;
          if (masked) {
            const int kc = k0 + c0 + 8 * j + 2 * t + (r & 1);
            const int qr = q_off + q0 + r0 + g + 8 * (r >> 1);
            if (kc >= p.Sk || (p.causal && qr < kc)) sv = NEG_INF;
          }
          dp[j][r] = exp2f(sv - lr[r >> 1]) * (dp[j][r] - dl[r >> 1]);
        }

      // this pass's dS K, A straight from the accumulators, summed from
      // zero and then added into dq in f32
      float part[KS][4];
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[n][r] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const FragA da = c_as_a<false>(dp[j]);
#pragma unroll
        for (int n = 0; n < KS; ++n)
          mma3<false, EX>(part[n], da,
                          b_frag_perm<EX, T, D>(Ks, c0 + 8 * j, 8 * n, g, t));
      }
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) dq[n][r] += part[n][r];
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row < p.Sq) {
      T* dqr = dqp + row * p.xs;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        dqr[8 * n + 2 * t] = from_f<T>(dq[n][2 * i] * p.out_scale);
        dqr[8 * n + 2 * t + 1] = from_f<T>(dq[n][2 * i + 1] * p.out_scale);
      }
    }
  }
}

// With info != nullptr nothing is launched: info[0] gets the dynamic shared
// memory of one CTA in bytes and info[1] the CTAs that fit on one SM.
template <typename T, int D>
cudaError_t launch(const BwdParams& p, cudaStream_t stream, int* info) {
  constexpr size_t bytes = smem_bytes<T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  if (info != nullptr) {
    info[0] = static_cast<int>(bytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        info + 1, flash_bwd_dq_kernel<T, D>, THREADS, bytes);
  }
  const dim3 grid(p.B * p.H, (p.Sq + ROWS - 1) / ROWS);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const BwdParams& p, int d, cudaStream_t stream,
                     int* info) {
  switch (d) {
    case 16: return launch<T, 16>(p, stream, info);
    case 32: return launch<T, 32>(p, stream, info);
    case 64: return launch<T, 64>(p, stream, info);
    case 128: return launch<T, 128>(p, stream, info);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_t(const BwdParams& p, int dtype, int d,
                     cudaStream_t stream, int* info) {
  switch (dtype) {
    case 0: return launch_d<float>(p, d, stream, info);
    case 1: return launch_d<__nv_bfloat16>(p, d, stream, info);
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
  if (!zoo_flash::grid_ok(B, H, Sq, Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{q, k, v, o, g, static_cast<const float*>(lse),
              static_cast<float*>(delta), dq, nullptr, B, H, Sq, Sk,
              qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh,
              xb, xs, xh, scale2, out_scale, causal};
  return static_cast<int>(
      launch_t(p, dtype, D, static_cast<cudaStream_t>(stream), nullptr));
}

// Shared memory per CTA and CTAs per SM of one instance (info[0], info[1]),
// on the current device. Returns a cudaError_t.
int zoo_flash_bwd_dq_occupancy(int dtype, int D, int* info) {
  return static_cast<int>(launch_t(BwdParams{}, dtype, D, nullptr, info));
}

}  // extern "C"

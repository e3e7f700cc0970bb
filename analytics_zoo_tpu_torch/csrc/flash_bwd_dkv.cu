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
// log2 prescale; here q is read as it is, and the product by
// sm_scale * log2(e) is folded into the scores and into dk's final scale).
// Causal masking is bottom-right aligned (q_offset = Sk - Sq): the query
// loop starts at the first query tile that sees this CTA's keys, and only
// diagonal and ragged tiles are masked. P and dS are f32 for f32 and bf16
// inputs alike (the TPU kernel rounds them to bf16 for bf16 inputs; this
// one does not).
//
// What bounds it on the H100: at the training shape (B=32, S=128, H=12,
// D=64, f32) it reads q, k, v, g, L and delta and writes dk and dv,
// 75.9 MB, 22.7 us at 3.35 TB/s; its four products, 8*B*H*S^2*D =
// 3.22 GFLOP, take 19.5 us at f32 accuracy on the TF32 tensor cores (three
// passes at 495 TFLOP/s), so it is bound by bytes; on the CUDA cores
// (67 TFLOP/s) the products alone would take 48 us. P and dS never reach
// device memory.
//
// Design: all four products run on the tensor cores in 3xTF32
// (mma_tf32.cuh; bf16 operands are exact and skip their lo passes). One CTA
// of 4 warps per (batch*head, 64 key rows), looping over 64-row query
// tiles; the loop takes the place of the TPU grid's sequential query
// dimension. Each warp owns 16 key rows and keeps their dk and dv (2 x 16 x
// D f32, 64 registers per thread at D = 64) in registers for the whole
// loop, so there are no atomics and the result is deterministic. K and V
// are staged once; their A fragments are re-read from shared memory per
// query tile (holding them split would cost 2 D registers). q, g, L and
// delta stream through a two-stage cp.async ring (16 B per thread for q
// and g, 4 B for L and delta), so the next query tile loads while the
// current one is multiplied. S^T = K Q^T and dP^T = V G^T come out in the
// accumulator layout, become P^T and dS^T in place, and feed dV += P^T G and
// dK += dS^T Q straight from those registers, the query order of each
// k-step permuted as mma_tf32.cuh sets out (no shared-memory round trip).
// A query tile goes in two passes of 32 columns, which keeps S^T and dP^T
// at 32 registers beside dk and dv (a pass of 64 took 40 more registers at
// D = 64 and ran a few per cent slower on the H100).
//
// Accuracy: the tensor core's f32 accumulation truncates, so dk and dv,
// fed 24 mma passes per query tile each, drift towards zero by up to an
// ulp a pass; over 32 query tiles (S = 2048) that drift reached 3.1e-5
// of the largest gradient on the H100. In f32 the accumulators are
// therefore added into the outputs (stored the first time) and zeroed
// after every second query tile that has a successor: no sum runs over
// more than two tiles, as at S <= 128, where nothing is flushed. The
// outputs belong to this CTA alone, so this stays deterministic. bf16
// outputs round far above the drift.
//
// Shared memory per CTA: K, V and two stages of q and g (six 64-row tiles,
// rows padded 16 bytes) and two stages of L and delta (1 KB): 105,472 B at
// D = 64 and 203,776 B at D = 128 in f32 (2 and 1 CTAs per SM by shared
// memory), 56,320 B and 105,472 B in bf16 (2 and 2 with the registers).

#include "mma_tf32.cuh"

namespace {

using namespace zoo_mma;
using zoo_flash::BwdParams;
using zoo_flash::from_f;
using zoo_flash::NEG_INF;

template <typename T, int D>
constexpr size_t smem_bytes() {   // L/delta x 2 stages, K, V, 2 x (q, g)
  return 2 * 2 * ROWS * sizeof(float) + 6 * tile_elems<T, D>() * sizeof(T);
}

// Start loading one query tile: q and g rows q0 .. q0+63 (zeros past sq)
// and L, delta of those rows (lse, delta: this head's rows) into
// LD[0..63], LD[64..127].
template <typename T, int D>
__device__ __forceinline__ void stage_q(T* Qs, T* Gs, float* LD,
                                        const T* qp, long long qs,
                                        const T* gp, long long gs,
                                        const float* lse, const float* delta,
                                        int sq, int q0) {
  cp_tile<T, D>(Qs, qp, qs, q0, sq);
  cp_tile<T, D>(Gs, gp, gs, q0, sq);
  const int s = q0 + (threadIdx.x & (ROWS - 1));
  const bool ok = s < sq;
  const float* src = threadIdx.x < ROWS ? lse : delta;
  cp_async4(LD + threadIdx.x, src + (ok ? s : 0), ok ? 4 : 0);
}

// Add this thread's accumulated elements of rows row and row + 8 into out
// (a store when !add), and zero the accumulators.
template <int KS>
__device__ __forceinline__ void flush(float (&acc)[KS][4], float* out,
                                      long long xs, int row, int n_rows,
                                      int t, bool add) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* o = out + (row + 8 * i) * xs + 2 * t;
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (row + 8 * i < n_rows)
          o[8 * n + c] = add ? o[8 * n + c] + acc[n][2 * i + c]
                             : acc[n][2 * i + c];
        acc[n][2 * i + c] = 0.f;
      }
  }
}

// The explicit 1 lets ptxas take up to 255 registers (see flash_fwd.cu).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(BwdParams p) {
  constexpr bool EX = sizeof(T) == 2;   // bf16 is exact in tf32
  constexpr int TILE = tile_elems<T, D>();
  constexpr int KS = D / 8;             // k-steps over D, n-tiles of dk/dv
  constexpr int QC = 32;                // query columns per pass
  constexpr int NJ = QC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* LD = reinterpret_cast<float*>(smem_raw);  // stage st at 2 st ROWS
  T* Ks = reinterpret_cast<T*>(smem_raw + 2 * 2 * ROWS * sizeof(float));
  T* Vs = Ks + TILE;
  T* QG = Vs + TILE;   // stage st: q at QG + 2 st TILE, g right after it

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;   // this warp's rows of the key tile
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * ROWS;
  const int q_off = p.Sk - p.Sq;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Sq;

  const T* qp = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kp = static_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* vp = static_cast<const T*>(p.v) + b * p.vb + h * p.vh;
  const T* gp = static_cast<const T*>(p.g) + b * p.gb + h * p.gh;
  T* dkp = static_cast<T*>(p.out0) + b * p.xb + h * p.xh;
  T* dvp = static_cast<T*>(p.out1) + b * p.xb + h * p.xh;

  // causal: the first query tile with a row that sees key k0 is the one
  // holding query q_off + q >= k0
  const int q_begin = p.causal ? (max(0, k0 - q_off) / ROWS) * ROWS : 0;
  const int n_qt = (p.Sq - q_begin + ROWS - 1) / ROWS;
  cp_tile<T, D>(Ks, kp, p.ks, k0, p.Sk);
  cp_tile<T, D>(Vs, vp, p.vs, k0, p.Sk);
  stage_q<T, D>(QG, QG + TILE, LD, qp, p.qs, gp, p.gs, lse, delta, p.Sq,
                q_begin);
  cp_async_commit();

  float dk[KS][4], dv[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk[n][r] = dv[n][r] = 0.f;

  const bool k_ragged = k0 + ROWS > p.Sk;
  bool flushed = false;   // f32: the outputs hold partial sums
  for (int it = 0; it < n_qt; ++it) {
    const int q0 = q_begin + it * ROWS;
    if (it + 1 < n_qt) {   // the next query tile loads while this one runs
      const int st = (it + 1) & 1;
      stage_q<T, D>(QG + 2 * st * TILE, QG + (2 * st + 1) * TILE,
                    LD + 2 * st * ROWS, qp, p.qs, gp, p.gs, lse, delta, p.Sq,
                    q0 + ROWS);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Qs = QG + (it & 1) * 2 * TILE;
    const T* Gs = Qs + TILE;
    const float* Ls = LD + (it & 1) * 2 * ROWS;
    const float* Ds = Ls + ROWS;
    const bool masked = (p.causal && (q_off + q0 < k0 + ROWS - 1)) ||
                        k_ragged || q0 + ROWS > p.Sq;

    for (int c0 = 0; c0 < ROWS; c0 += QC) {
      // S^T = K Q^T and dP^T = V G^T: 16 key rows x QC query columns
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[j][r] = dp[j][r] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const FragA ka = a_frag<EX, T, D>(Ks, r0, 8 * ks, g, t);
        const FragA va = a_frag<EX, T, D>(Vs, r0, 8 * ks, g, t);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma3<EX, EX>(s[j], ka,
                       b_frag_t<EX, T, D>(Qs, c0 + 8 * j, 8 * ks, g, t));
          mma3<EX, EX>(dp[j], va,
                       b_frag_t<EX, T, D>(Gs, c0 + 8 * j, 8 * ks, g, t));
        }
      }

      // P^T = exp2(S^T * scale2 - L) and dS^T = P^T (dP^T - delta), in place
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = c0 + 8 * j + 2 * t + (r & 1);   // query in the tile
          float sv = s[j][r] * p.scale2;
          if (masked) {
            const int kr = k0 + r0 + g + 8 * (r >> 1);
            const int qc = q0 + c;
            if (kr >= p.Sk || qc >= p.Sq || (p.causal && q_off + qc < kr))
              sv = NEG_INF;
          }
          const float pt = exp2f(sv - Ls[c]);
          s[j][r] = pt;
          dp[j][r] = pt * (dp[j][r] - Ds[c]);
        }

      // dV += P^T G and dK += dS^T Q, A straight from the accumulators
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const FragA pa = c_as_a<false>(s[j]);
        const FragA da = c_as_a<false>(dp[j]);
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          mma3<false, EX>(dv[n], pa,
                          b_frag_perm<EX, T, D>(Gs, c0 + 8 * j, 8 * n, g, t));
          mma3<false, EX>(dk[n], da,
                          b_frag_perm<EX, T, D>(Qs, c0 + 8 * j, 8 * n, g, t));
        }
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
    if constexpr (!EX) {
      if ((it & 1) && it + 1 < n_qt) {   // every second query tile
        flush(dk, dkp, p.xs, k0 + r0 + g, p.Sk, t, flushed);
        flush(dv, dvp, p.xs, k0 + r0 + g, p.Sk, t, flushed);
        flushed = true;
      }
    }
  }

  const float dk_scale = p.scale2 * p.out_scale;   // sm_scale
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = k0 + r0 + g + 8 * i;
    if (kr < p.Sk) {
      T* dkr = dkp + kr * p.xs;
      T* dvr = dvp + kr * p.xs;
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = 8 * n + 2 * t + c;
          float a = dk[n][2 * i + c], e = dv[n][2 * i + c];
          if (flushed) {   // f32 only
            a += to_f(dkr[x]);
            e += to_f(dvr[x]);
          }
          dkr[x] = from_f<T>(a * dk_scale);
          dvr[x] = from_f<T>(e);
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
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  if (info != nullptr) {
    info[0] = static_cast<int>(bytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        info + 1, flash_bwd_dkv_kernel<T, D>, THREADS, bytes);
  }
  const dim3 grid(p.B * p.H, (p.Sk + ROWS - 1) / ROWS);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
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
  if (!zoo_flash::grid_ok(B, H, Sq, Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{q, k, v, nullptr, g, static_cast<const float*>(lse),
              static_cast<float*>(const_cast<void*>(delta)), dk, dv,
              B, H, Sq, Sk, qb, qs, qh, kb, ks, kh, vb, vs, vh,
              0, 0, 0, gb, gs, gh, xb, xs, xh, scale2, out_scale, causal};
  return static_cast<int>(
      launch_t(p, dtype, D, static_cast<cudaStream_t>(stream), nullptr));
}

// Shared memory per CTA and CTAs per SM of one instance (info[0], info[1]),
// on the current device. Returns a cudaError_t.
int zoo_flash_bwd_dkv_occupancy(int dtype, int D, int* info) {
  return static_cast<int>(launch_t(BwdParams{}, dtype, D, nullptr, info));
}

}  // extern "C"

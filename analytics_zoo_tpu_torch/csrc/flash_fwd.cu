// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel analytics_zoo_tpu/ops/attention.py:
// _flash_kernel (launched by _flash_forward). It computes the same function,
// not the same blocks: FA-2 forward with q pre-scaled by sm_scale*log2(e),
// an exp2 online softmax in f32 with a running (acc, m, l) over key tiles,
// bottom-right aligned causal masking (q_offset = s_k - s_q) that skips the
// key tiles lying wholly above a query tile's diagonal and masks only the
// diagonal tiles, l floored at 1e-30, and optionally lse2 = m + log2(l) per
// query row for the backward. The TPU kernel's ones column appended to V
// (a trick to get l out of the matrix unit) is not carried over: l is a sum
// kept in registers.
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, H, D), o (B, Sq, H, D), read and
// written through their (batch, seq, head) strides with a unit head_dim
// stride, so no transposed copy is made. lse is (B*H, Sq) f32. Inputs are
// f32 or bf16; all arithmetic is f32; o is stored in the input type.
//
// Design: one CTA of 256 threads per (batch*head, 64 query rows). The CTA
// stages its Q tile once and loops over 64-key tiles of K and V in shared
// memory (f32, rows padded to avoid bank conflicts). Thread (ty, tx) of a
// 16x16 grid owns query rows 4ty..4ty+3 and, of each 64-wide tile, the
// columns tx + 16j: it computes a 4x4 block of scores with scalar FMAs,
// reduces the row max over the 16 threads of its row group with warp
// shuffles, writes P to shared memory, and accumulates its 4 x D/16 block
// of the output. l is kept as per-thread partial sums and reduced once at
// the end.
//
// What bounds it on the H100: at the serving shape (B=32, S=128, H=12,
// D=64) the work is 4*B*H*S^2*D = 1.61 GFLOP over 50 MB of q, k, v and o
// in f32. At the card's 67 TFLOP/s of f32 FMA outside the tensor cores the
// operations take 24 us and the bytes 15 us at 3.35 TB/s, so f32 is bound
// by operations on the CUDA cores, which is the unit this kernel uses; the
// scores never reach device memory. Each FMA here costs half a shared-memory
// load (4 Q + 4 K values feed 16 FMAs), so shared-memory bandwidth, not the
// FMA rate, is the kernel's own limit. In bf16 the bound moves to the bytes
// (7.5 us against 1.6 us of tensor-core work); this kernel does not use the
// tensor cores. mma.sync/wgmma tiles with TMA loads are later work.

#include "flash_common.cuh"

namespace {

using namespace zoo_flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, Sq, Sk;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
  float scale2;   // sm_scale * log2(e)
  int causal;
};

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  constexpr int DP = D + 1;    // padded row of the Q and K tiles
  constexpr int DJ = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * BQ;
  const int q_off = p.Sk - p.Sq;

  const T* qp = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kp = static_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* vp = static_cast<const T*>(p.v) + b * p.vb + h * p.vh;
  T* op = static_cast<T*>(p.o) + b * p.ob + h * p.oh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i - (i / D) * D;
    const int s = q0 + r;
    Qs[r * DP + c] = s < p.Sq ? to_f(qp[s * p.qs + c]) * p.scale2 : 0.f;
  }

  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // causal: the last query row of this tile sees keys <= q_off + q0 + BQ-1
  const int k_end = p.causal ? min(p.Sk, q_off + q0 + BQ) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i - (i / D) * D;
      const int s = k0 + r;
      const bool ok = s < p.Sk;
      Ks[r * DP + c] = ok ? to_f(kp[s * p.ks + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f(vp[s * p.vs + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * DP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ks[(tx + 16 * j) * DP + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bb[j], sc[i][j]);
    }

    // mask only the diagonal tiles (causal) and the ragged last tile
    const bool diag = p.causal && (q_off + q0 < k0 + BK - 1);
    const bool ragged = k0 + BK > p.Sk;
    if (diag || ragged) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q_off + q0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + tx + 16 * j;
          if (kpos >= p.Sk || (p.causal && qpos < kpos)) sc[i][j] = NEG_INF;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = exp2f(sc[i][j] - m_new);
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = pv;
        rs += pv;
      }
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ls = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      ls += __shfl_xor_sync(0xffffffffu, ls, off);
    ls = fmaxf(ls, 1e-30f);
    const int s = q0 + ty * 4 + i;
    if (s < p.Sq) {
      const float inv = 1.f / ls;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        op[s * p.os + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
      if (p.lse != nullptr && tx == 0)
        p.lse[static_cast<long long>(bh) * p.Sq + s] = m[i] + log2f(ls);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  // above 48 KB of dynamic shared memory the kernel must opt in, on the
  // current device; set on every launch so no device is missed
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream) {
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
int zoo_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int dtype, int B, int H, int Sq, int Sk, int D,
                  long long qb, long long qs, long long qh,
                  long long kb, long long ks, long long kh,
                  long long vb, long long vs, long long vh,
                  long long ob, long long os, long long oh,
                  float scale2, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 ||
      static_cast<long long>(B) * H > 2147483647LL ||
      (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, static_cast<float*>(lse), B, H, Sq, Sk,
           qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, scale2, causal};
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

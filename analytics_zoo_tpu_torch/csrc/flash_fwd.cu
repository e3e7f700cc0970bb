// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel analytics_zoo_tpu/ops/attention.py:
// _flash_kernel (launched by _flash_forward). It computes the same function,
// not the same blocks: FA-2 forward with scores in the log2 domain
// (q . k * sm_scale * log2(e)), an exp2 online softmax in f32 with a running
// (acc, m, l) over key tiles, bottom-right aligned causal masking (q_offset
// = s_k - s_q) that skips the key tiles lying wholly above a query tile's
// diagonal and masks only the diagonal tiles, l floored at 1e-30, and
// optionally lse2 = m + log2(l) per query row for the backward. The TPU
// kernel's ones column appended to V (a trick to get l out of the matrix
// unit) is not carried over: l is a sum kept in registers.
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, H, D), o (B, Sq, H, D), read and
// written through their (batch, seq, head) strides with a unit head_dim
// stride and 16-byte aligned rows (the wrapper copies an operand that is
// not), so the strided views of a fused qkv projection are read in place.
// lse is (B*H, Sq) f32. Inputs are f32 or bf16; o is stored in the input
// type.
//
// What bounds it on the H100: at the serving shape (B=32, S=128, H=12,
// D=64, f32) the function reads q, k, v and writes o, 50.3 MB, 15.0 us at
// 3.35 TB/s, and does 4*B*H*S^2*D = 1.61 GFLOP of products. At f32
// accuracy on the TF32 tensor cores (three passes, 495 TFLOP/s) those take
// 9.8 us, so the kernel is bound by bytes; on the CUDA cores (67 TFLOP/s)
// the products alone would take 24 us. In bf16 one pass per product.
//
// Design: the products run on the tensor cores in 3xTF32 (mma_tf32.cuh):
// mma.sync m16n8k8 with every f32 operand split once into tf32 hi and lo,
// three passes per product, f32 accumulators; bf16 operands are exact in
// tf32 and skip the passes on their lo. One CTA of 4 warps per
// (batch*head, 64 query rows), FA-2 style: each warp owns 16 query rows and
// keeps their output accumulator (16 x D), m and l in registers; the row
// max and sum reduce over the 4 lanes of a quad. S = Q K^T comes out in the
// accumulator layout, and P is fed to P V straight from those registers by
// taking each k-step's keys in the permuted order of mma_tf32.cuh (no
// shared-memory round trip, no shuffles). Q's fragments are split once and
// held in registers at D <= 64 (64 registers in f32 at D = 64); at D = 128
// they would not fit beside the 16 x 128 accumulator and are re-read from
// shared memory per key tile. K and V tiles stream through a two-stage
// cp.async ring (16 B per thread), so the next tile loads while the
// current one is multiplied. Tiles are padded 16 bytes a row, which keeps
// every fragment read conflict-free (mma_tf32.cuh).
//
// Accuracy: the tensor core's f32 accumulation truncates, so the output
// accumulator, fed 24 mma passes per key tile, drifts towards zero by up
// to an ulp a pass; over 32 key tiles (S = 2048) that drift reached
// 2.0e-5 on outputs of magnitude ~0.2 on the H100. In f32 the accumulator
// is therefore added into the output (stored the first time, rescaled to
// the running max as the accumulator is) and zeroed after every second
// key tile that has a successor: no sum runs over more than two tiles, as
// at S <= 128, where nothing is flushed. The output rows belong to this
// CTA alone, so this stays deterministic. bf16 outputs round far above
// the drift.
//
// Shared memory per CTA: the Q tile and two stages of K and V, five 64-row
// tiles: 87,040 B at D = 64 and 168,960 B at D = 128 in f32 (2 and 1 CTAs
// per SM), 46,080 B and 87,040 B in bf16 (2 and 2, registers bounding the
// first). Variants tried on the H100 at the main shape (Q re-read from
// shared memory, 32-key tiles at 3 or 4 CTAs per SM, one K/V stage) gained
// little, so the simplest stays.

#include "mma_tf32.cuh"

namespace {

using namespace zoo_mma;
using zoo_flash::from_f;
using zoo_flash::NEG_INF;

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

template <typename T, int D>
constexpr size_t smem_bytes() {
  return 5 * tile_elems<T, D>() * sizeof(T);   // Q, 2 stages of K and V
}

// The explicit 1 lets ptxas take up to 255 registers: without it ptxas
// settled on fewer and spilled at D = 64.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(Params p) {
  constexpr bool EX = sizeof(T) == 2;   // bf16 is exact in tf32
  constexpr int TILE = tile_elems<T, D>();
  constexpr int KS = D / 8;             // k-steps of Q K^T, n-tiles of O
  constexpr int NJ = ROWS / 8;          // n-tiles of S, k-steps of P V
  constexpr bool QREG = D <= 64;        // Q's fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* KV = Qs + TILE;   // stage st: K at KV + 2 st TILE, V right after it

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

  const T* qp = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kp = static_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* vp = static_cast<const T*>(p.v) + b * p.vb + h * p.vh;
  T* op = static_cast<T*>(p.o) + b * p.ob + h * p.oh;

  // causal: the last query row of this tile sees keys <= q_off + q0 + 63
  const int k_end = p.causal ? min(p.Sk, q_off + q0 + ROWS) : p.Sk;
  const int n_kt = (k_end + ROWS - 1) / ROWS;
  cp_tile<T, D>(Qs, qp, p.qs, q0, p.Sq);
  cp_tile<T, D>(KV, kp, p.ks, 0, p.Sk);
  cp_tile<T, D>(KV + TILE, vp, p.vs, 0, p.Sk);
  cp_async_commit();

  float o[KS][4];
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.f;
  FragA qf[QREG ? KS : 1];
  bool flushed = false;   // f32: o holds a partial sum, relative to mf
  float mf[2] = {0.f, 0.f};

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
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          qf[ks] = a_frag<EX, T, D>(Qs, r0, 8 * ks, g, t);
      }
    }

    // S = Q K^T: 16 rows x 64 keys per warp, eight 16 x 8 tiles
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      FragA a;
      if constexpr (QREG) a = qf[ks];
      else a = a_frag<EX, T, D>(Qs, r0, 8 * ks, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma3<EX, EX>(s[j], a, b_frag_t<EX, T, D>(Ks, 8 * j, 8 * ks, g, t));
    }

    // into the log2 domain; mask only the diagonal (causal) and ragged tiles
    const bool diag = p.causal && (q_off + q0 < k0 + ROWS - 1);
    const bool ragged = k0 + ROWS > p.Sk;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[j][r] *= p.scale2;
        if (diag || ragged) {
          const int kpos = k0 + 8 * j + 2 * t + (r & 1);
          const int qpos = q_off + q0 + r0 + g + 8 * (r >> 1);
          if (kpos >= p.Sk || (p.causal && qpos < kpos)) s[j][r] = NEG_INF;
        }
      }

    // online softmax: rows g (c0, c1) and g + 8 (c2, c3) of the warp's 16
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[j][r] = exp2f(s[j][r] - m[r >> 1]);
        rs[r >> 1] += s[j][r];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[n][r] *= corr[r >> 1];

    // O += P V, P straight from the S accumulators (permuted key order)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const FragA a = c_as_a<false>(s[j]);
#pragma unroll
      for (int n = 0; n < KS; ++n)
        mma3<false, EX>(o[n], a,
                        b_frag_perm<EX, T, D>(Vs, 8 * j, 8 * n, g, t));
    }
    __syncthreads();   // this stage is consumed before it is refilled
    if constexpr (!EX) {
      if ((it & 1) && it + 1 < n_kt) {   // every second key tile
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = q0 + r0 + g + 8 * i;
          const float c = exp2f(mf[i] - m[i]);
          float* orow = op + row * p.os + 2 * t;
#pragma unroll
          for (int n = 0; n < KS; ++n)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              float& x = o[n][2 * i + cc];
              if (row < p.Sq)
                orow[8 * n + cc] = flushed ? c * orow[8 * n + cc] + x : x;
              x = 0.f;
            }
          mf[i] = m[i];
        }
        flushed = true;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    const int row = q0 + r0 + g + 8 * i;
    if (row < p.Sq) {
      const float inv = 1.f / l[i];
      const float c = exp2f(mf[i] - m[i]);
      T* orow = op + row * p.os + 2 * t;
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          float x = o[n][2 * i + cc];
          if (flushed) x += c * to_f(orow[8 * n + cc]);   // f32 only
          orow[8 * n + cc] = from_f<T>(x * inv);
        }
      if (p.lse != nullptr && t == 0)
        p.lse[static_cast<long long>(bh) * p.Sq + row] = m[i] + log2f(l[i]);
    }
  }
}

// With info != nullptr nothing is launched: info[0] gets the dynamic shared
// memory of one CTA in bytes and info[1] the CTAs that fit on one SM.
template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream, int* info) {
  constexpr size_t bytes = smem_bytes<T, D>();
  // above 48 KB of dynamic shared memory the kernel must opt in, on the
  // current device; set on every launch so no device is missed
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  if (info != nullptr) {
    info[0] = static_cast<int>(bytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        info + 1, flash_fwd_kernel<T, D>, THREADS, bytes);
  }
  const dim3 grid(p.B * p.H, (p.Sq + ROWS - 1) / ROWS);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream,
                     int* info) {
  switch (d) {
    case 16: return launch<T, 16>(p, stream, info);
    case 32: return launch<T, 32>(p, stream, info);
    case 64: return launch<T, 64>(p, stream, info);
    case 128: return launch<T, 128>(p, stream, info);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_t(const Params& p, int dtype, int d, cudaStream_t stream,
                     int* info) {
  switch (dtype) {
    case 0: return launch_d<float>(p, d, stream, info);
    case 1: return launch_d<__nv_bfloat16>(p, d, stream, info);
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
      (Sq + ROWS - 1) / ROWS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, static_cast<float*>(lse), B, H, Sq, Sk,
           qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, scale2, causal};
  return static_cast<int>(
      launch_t(p, dtype, D, static_cast<cudaStream_t>(stream), nullptr));
}

// Shared memory per CTA and CTAs per SM of one instance (info[0], info[1]),
// on the current device. Returns a cudaError_t.
int zoo_flash_fwd_occupancy(int dtype, int D, int* info) {
  return static_cast<int>(launch_t(Params{}, dtype, D, nullptr, info));
}

}  // extern "C"

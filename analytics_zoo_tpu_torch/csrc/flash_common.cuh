// Pieces shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu). Each .cu is built into its own shared
// library, so every definition here lands once per library.
//
// Common layout: q (B, Sq, H, D), k/v (B, Sk, H, D) and the gradients of the
// same shapes, read and written through their (batch, seq, head) strides
// with a unit head_dim stride. The scalar tile pieces (load_tile,
// dot_block, NT, PS) are the dQ pass's, which still runs on the CUDA
// cores: tiles staged in shared memory as f32, rows padded to D + 1 floats
// so that threads reading down a column hit distinct banks, and a CTA of
// 256 threads as a 16 x 16 grid in which thread (ty, tx) owns rows
// 4ty..4ty+3 of a 64-row tile and, of the other operand's 64-row tile, rows
// tx + 16j (j < 4). The tensor-core kernels build on mma_tf32.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace zoo_flash {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // threads per CTA: a 16 x 16 grid
constexpr int PS = BK + 1;   // padded row of a 64 x 64 score tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage rows r0 .. r0+63 of one head's (seq, D) slice, row stride rs, into
// a shared f32 tile of row pitch D + 1, multiplied by `scale`; rows at or
// past n are zero. Neighbouring threads read neighbouring elements of a row.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int r0, int n,
                                          float scale) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i - (i / D) * D;
    const int s = r0 + r;
    dst[r * (D + 1) + c] = s < n ? to_f(src[s * rs + c]) * scale : 0.f;
  }
}

// acc[i][j] += A[4ty+i] . B[tx+16j] over D, for two padded 64-row tiles:
// one 4 x 4 block of A B^T per thread, 16 FMAs per 8 shared loads.
template <int D>
__device__ __forceinline__ void dot_block(float acc[4][4], const float* A,
                                          const float* B, int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll 8
  for (int kk = 0; kk < D; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * DP + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * DP + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Arguments of both backward kernels. The dQ kernel reads q k v o g lse and
// writes dq (through out0) and delta; the dK/dV kernel reads q k v g lse
// delta and writes dk (out0) and dv (out1). out0/out1 share the x* strides.
struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;
  const float* lse;   // (B*H, Sq): the forward's lse2 = m + log2(l)
  float* delta;       // (B*H, Sq): rowsum(g * o)
  void* out0;
  void* out1;
  int B, H, Sq, Sk;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh;
  long long xb, xs, xh;
  float scale2;      // sm_scale * log2(e): q is pre-scaled by it
  float out_scale;   // dq: sm_scale; dk: 1 / log2(e)
  int causal;
};

// Grid limits shared by every launcher: (B*H, ceil(S/64)) blocks.
inline bool grid_ok(int B, int H, int Sq, int Sk) {
  return B > 0 && H > 0 && Sq > 0 && Sk > 0 &&
         static_cast<long long>(B) * H <= 2147483647LL &&
         (Sq + BQ - 1) / BQ <= 65535 && (Sk + BK - 1) / BK <= 65535;
}

}  // namespace zoo_flash

extern "C" const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

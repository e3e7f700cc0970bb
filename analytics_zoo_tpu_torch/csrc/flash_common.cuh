// Pieces shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu). Each .cu is built into its own shared
// library, so every definition here lands once per library.
//
// Common layout: q (B, Sq, H, D), k/v (B, Sk, H, D) and the gradients of the
// same shapes, read and written through their (batch, seq, head) strides
// with a unit head_dim stride. The tensor-core pieces are in mma_tf32.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace zoo_flash {

constexpr int ROWS = 64;     // rows of a tile: query rows or keys
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
  float scale2;      // sm_scale * log2(e), applied to the scores q k^T
  float out_scale;   // dq: sm_scale; dk: 1 / log2(e)
  int causal;
};

// Grid limits of the backward launchers: (B*H, ceil(S/64)) blocks.
inline bool grid_ok(int B, int H, int Sq, int Sk) {
  return B > 0 && H > 0 && Sq > 0 && Sk > 0 &&
         static_cast<long long>(B) * H <= 2147483647LL &&
         (Sq + ROWS - 1) / ROWS <= 65535 && (Sk + ROWS - 1) / ROWS <= 65535;
}

}  // namespace zoo_flash

extern "C" const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

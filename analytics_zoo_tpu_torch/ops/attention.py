"""Attention ops (counterpart of ``analytics_zoo_tpu/ops/attention.py``):
reference multi-head attention, the blockwise online-softmax pieces, and
flash attention with a hand-written CUDA forward kernel.

Shapes follow (batch, seq, heads, head_dim) throughout, as in the JAX
package, so the port's public functions compare like with like.

``flash_fwd`` is the kernel's wrapper: on a CUDA tensor it launches
``csrc/flash_fwd.cu`` (which replaces the Pallas ``_flash_kernel``) or
raises; on a CPU tensor it runs ``flash_attention_plain``, the plain
PyTorch version that repeats the kernel's arithmetic. There is no fallback
from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
LOG2_E = 1.4426950408889634      # the flash kernel softmaxes in base 2

# The CUDA kernel's tiles: one CTA per (batch*head, BQ query rows), looping
# over BK-key tiles. The plain version walks the keys in the same tiles.
KERNEL_BLOCK_Q = 64
KERNEL_BLOCK_K = 64
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, sm_scale: Optional[float] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain materialised-scores attention. q,k,v: (B, S, H, D)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    if bias is not None:
        logits = logits + bias
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril(diagonal=s_k - s_q)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def blockwise_update(q, k_blk, v_blk, acc, m, l, *, sm_scale,
                     q_positions=None, k_positions=None, causal=False):
    """One online-softmax accumulation step against a K/V block.

    q: (B, Sq, H, D); k_blk/v_blk: (B, Sk, H, D); acc: (B, Sq, H, D) f32;
    m, l: (B, Sq, H) f32 running max / normaliser. Returns updated
    (acc, m, l)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * sm_scale
    if causal:
        if q_positions is None:
            q_positions = torch.arange(q.shape[1], device=q.device)
        if k_positions is None:
            k_positions = torch.arange(k_blk.shape[1], device=q.device)
        mask = q_positions[:, None] >= k_positions[None, :]
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    m_bhq = m.movedim(-1, 1)                             # (B, H, Sq)
    m_new = torch.maximum(m_bhq, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    correction = torch.exp(m_bhq - m_new)                # (B, H, Sq)
    l_new = l.movedim(-1, 1) * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
    acc_new = acc * correction.movedim(1, -1)[..., None] + pv
    return acc_new, m_new.movedim(1, -1), l_new.movedim(1, -1)


def blockwise_finalize(acc, l):
    """Normalise the accumulator once all K/V blocks are folded in."""
    return acc / torch.clamp(l, min=1e-30)[..., None]


def blockwise_attention(q, k, v, *, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        block_k: int = 512) -> torch.Tensor:
    """Exact attention as a loop over K/V blocks with the online softmax:
    the (Sq, Sk) score matrix never materialises. Causal masking is
    bottom-right aligned like ``mha_reference``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    bk = block_k
    while s_k % bk:
        bk //= 2
        if bk < 8:
            bk = s_k
            break
    q_pos = torch.arange(s_q, device=q.device) + (s_k - s_q)
    acc = torch.zeros((b, s_q, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, s_q, h), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, s_q, h), dtype=torch.float32, device=q.device)
    for k0 in range(0, s_k, bk):
        acc, m, l = blockwise_update(
            q, k[:, k0:k0 + bk], v[:, k0:k0 + bk], acc, m, l,
            sm_scale=sm_scale, causal=causal, q_positions=q_pos,
            k_positions=k0 + torch.arange(bk, device=q.device))
    return blockwise_finalize(acc, l).to(q.dtype)


# ---------------------------------------------------------------------------
# flash forward: the kernel's plain version, its wrapper, and the dispatcher
# ---------------------------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          sm_scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's arithmetic in plain PyTorch: f32 throughout,
    q pre-scaled by ``sm_scale*log2(e)``, exp2 online softmax over
    ``KERNEL_BLOCK_K``-key tiles, bottom-right causal mask, ``l`` floored at
    1e-30. Returns ``(out, lse2)``: out (B, Sq, H, D) in the input dtype and
    the log2-domain logsumexp ``m + log2 l`` as (B*H, Sq, 1) f32, the
    layout the JAX package's ``_flash_forward(..., with_lse=True)`` gives."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    q2 = q.float().permute(0, 2, 1, 3) * (sm_scale * LOG2_E)  # (B,H,Sq,D)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    acc = torch.zeros((b, h, s_q, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_q, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_q, 1), dtype=torch.float32, device=q.device)
    q_pos = (s_k - s_q) + torch.arange(s_q, device=q.device)[:, None]
    # The kernel skips the key tiles that lie wholly above its query tile's
    # diagonal. Folding such a tile in here changes nothing: its p is
    # exp2(NEG_INF - m) == 0 and its correction exp2(0) == 1, exactly.
    for k0 in range(0, s_k, KERNEL_BLOCK_K):
        k1 = min(k0 + KERNEL_BLOCK_K, s_k)
        s = q2 @ kf[:, :, k0:k1].transpose(-1, -2)
        if causal:
            k_pos = k0 + torch.arange(k1 - k0, device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        correction = torch.exp2(m - m_new)
        l = l * correction + p.sum(dim=-1, keepdim=True)
        acc = acc * correction + p @ vf[:, :, k0:k1]
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse2 = (m + torch.log2(l)).reshape(b * h, s_q, 1)
    return out, lse2


def _check_kernel_inputs(q, k, v, causal):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_fwd: q, k and v must all lie on the card")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_fwd: q, k and v lie on different devices")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_fwd: the kernel takes one of "
                        f"{sorted(map(str, _DTYPE_CODES))} for q, k and v, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_fwd: q, k, v must be (B, S, H, D)")
    b, s_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_fwd: shapes disagree: q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd: head_dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if causal and s_q > k.shape[1]:
        raise ValueError("flash_fwd: causal needs s_q <= s_k (a query row "
                         "would see no key)")
    if s_q == 0 or k.shape[1] == 0:
        raise ValueError("flash_fwd: empty sequence")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, sm_scale: Optional[float] = None,
              with_lse: bool = False):
    """Flash-attention forward over (B, S, H, D).

    On CUDA tensors: launches the hand-written kernel (``csrc/flash_fwd.cu``)
    on PyTorch's current stream and adds one to ``flash_fwd.launches``; a
    refused launch raises with the CUDA error string. On CPU tensors: the
    plain version. Returns ``out``, or ``(out, lse2)`` with ``with_lse``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        out, lse2 = flash_attention_plain(q, k, v, causal=causal,
                                          sm_scale=sm_scale)
        return (out, lse2) if with_lse else out
    from . import _kernels

    _check_kernel_inputs(q, k, v, causal)
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * h, s_q, 1), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    lib = _kernels.load("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.zoo_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, s_q, s_k, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            ctypes.c_float(sm_scale * LOG2_E), int(bool(causal)), stream)
    _kernels.check(lib, err, "flash_fwd")
    with _launch_lock:          # serving workers may launch concurrently
        flash_fwd.launches += 1
    return (out, lse) if with_lse else out


flash_fwd.launches = 0
_launch_lock = threading.Lock()


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the kernel forward. The backward kernels (the
    JAX package's ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``)
    are the next slice's work."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        return flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("flash backward: slice 2")


def _fit_block(s: int, want: int) -> Optional[int]:
    """Largest tile <= want that divides the sequence (the JAX package's
    routing rule, ``flash_attention``'s ``fit_block``)."""
    for cand in (want, 1024, 512, 256, 128, 64, 32, 16, 8):
        if cand <= want and s % cand == 0:
            return cand
    return None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    block_q: int = 1024, block_k: int = 1024) -> torch.Tensor:
    """Flash attention over (B, S, H, D). Takes the kernel when the
    sequences tile by the JAX package's ``fit_block`` ladder, else the
    reference path, as does causal with ``s_q > s_k`` (some query rows
    would see no key). ``block_q``/``block_k`` only route: the CUDA kernel
    picks its own tiles (``KERNEL_BLOCK_Q`` x ``KERNEL_BLOCK_K``)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s_q, s_k = q.shape[1], k.shape[1]
    bq = _fit_block(s_q, min(block_q, s_q))
    bk = _fit_block(s_k, min(block_k, s_k))
    if bq is None or bk is None or (causal and s_q > s_k):
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    return _FlashAttention.apply(q, k, v, causal, sm_scale)

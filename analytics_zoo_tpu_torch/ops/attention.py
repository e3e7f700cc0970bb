"""Attention ops (counterpart of ``analytics_zoo_tpu/ops/attention.py``):
reference multi-head attention, the blockwise online-softmax pieces, and
flash attention with hand-written CUDA kernels forward and backward.

Shapes follow (batch, seq, heads, head_dim) throughout, as in the JAX
package, so the port's public functions compare like with like.

Each kernel has a wrapper that, on CUDA tensors, launches it or raises,
and on CPU tensors runs its plain PyTorch version, which repeats the
kernel's arithmetic:

* ``flash_fwd`` -> ``csrc/flash_fwd.cu`` (the Pallas ``_flash_kernel``),
  plain version ``flash_attention_plain``;
* ``flash_bwd_dq`` -> ``csrc/flash_bwd_dq.cu`` (``_flash_bwd_dq_kernel``),
  plain version ``flash_bwd_dq_plain``;
* ``flash_bwd_dkv`` -> ``csrc/flash_bwd_dkv.cu`` (``_flash_bwd_dkv_kernel``),
  plain version ``flash_bwd_dkv_plain``. ``flash_bwd_plain`` runs both.

There is no fallback from the card to a plain version. The three kernels
run their products on the TF32 tensor cores in 3xTF32
(``csrc/mma_tf32.cuh``); ``tf32_split`` and ``mm_3xtf32`` emulate that
arithmetic on the CPU, for the tests, through the plain versions' ``mm``
argument.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Callable, Optional, Tuple

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
# the tensor-core kernels' arithmetic, emulated (tests only)
# ---------------------------------------------------------------------------

def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32 (10 mantissa bits) rounded to nearest, ties away from
    zero, on the bit pattern: add half a tf32 ulp to the magnitude, drop
    the low 13 bits (``cvt.rna.tf32.f32`` on finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split f32 ``x`` into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, as
    the kernels split every f32 operand before the tensor cores see it."""
    x = x.float()
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, *,
              passes: int = 3) -> torch.Tensor:
    """``a @ b`` as the kernels take it on the TF32 tensor cores:
    ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` (``passes=3``), or ``a_hi b_hi``
    alone (``passes=1``, plain TF32). A product of two tf32 values is exact
    in f32, and the sums are f32, as in the kernels' accumulators."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    if passes == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


# ---------------------------------------------------------------------------
# flash forward: the kernel's plain version, its wrapper, and the dispatcher
# ---------------------------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          sm_scale: Optional[float] = None,
                          mm: Callable = torch.matmul
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's arithmetic in plain PyTorch: f32 throughout,
    q pre-scaled by ``sm_scale*log2(e)``, exp2 online softmax over
    ``KERNEL_BLOCK_K``-key tiles, bottom-right causal mask, ``l`` floored at
    1e-30. Returns ``(out, lse2)``: out (B, Sq, H, D) in the input dtype and
    the log2-domain logsumexp ``m + log2 l`` as (B*H, Sq, 1) f32, the
    layout the JAX package's ``_flash_forward(..., with_lse=True)`` gives.
    ``mm`` takes the two products (``mm_3xtf32`` emulates the kernel's)."""
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
        s = mm(q2, kf[:, :, k0:k1].transpose(-1, -2))
        if causal:
            k_pos = k0 + torch.arange(k1 - k0, device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        correction = torch.exp2(m - m_new)
        l = l * correction + p.sum(dim=-1, keepdim=True)
        acc = acc * correction + mm(p, vf[:, :, k0:k1])
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse2 = (m + torch.log2(l)).reshape(b * h, s_q, 1)
    return out, lse2


def _check_kernel_inputs(q, k, v, causal, what="flash_fwd"):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what}: q, k and v must all lie on the card")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q, k and v lie on different devices")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{what}: the kernel takes one of "
                        f"{sorted(map(str, _DTYPE_CODES))} for q, k and v, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q, k, v must be (B, S, H, D)")
    b, s_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"{what}: shapes disagree: q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if causal and s_q > k.shape[1]:
        raise ValueError(f"{what}: causal needs s_q <= s_k (a query row "
                         "would see no key)")
    if s_q == 0 or k.shape[1] == 0:
        raise ValueError(f"{what}: empty sequence")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """The kernels copy rows into shared memory 16 bytes at a time, so each
    row of an operand must start on a 16-byte boundary: a unit head_dim
    stride, a 16-byte aligned base and batch, seq and head strides that are
    multiples of 16 bytes. The strided q/k/v views of a fused projection
    are; anything else is copied once into a fresh contiguous tensor."""
    st = t.stride()
    # element sizes are powers of two, so OR-ing the strides tests all three
    if (st[3] == 1 and t.data_ptr() % 16 == 0
            and (st[0] | st[1] | st[2]) * t.element_size() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(name: str, device: torch.device, *args) -> None:
    """Call ``csrc/<name>.cu``'s launcher with ``args`` and PyTorch's
    current stream on ``device`` (made the current device for the call if
    it is not); raise with the CUDA error string if the launch is
    refused. The raw stream handle and the skipped device switch keep the
    host's cost of a launch below the kernel's own time at the main
    shape."""
    from . import _kernels

    lib = _kernels.load(name)
    fn = getattr(lib, _kernels.entry_point(name))
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    _kernels.check(lib, err, name)


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
    _check_kernel_inputs(q, k, v, causal)
    q, k, v = _aligned16(q), _aligned16(k), _aligned16(v)
    b, s_q, h, d = q.shape
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * h, s_q, 1), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    _launch("flash_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, s_q, k.shape[1], d,
            *_strides(q, k, v, out),
            ctypes.c_float(sm_scale * LOG2_E), int(bool(causal)))
    with _launch_lock:          # serving workers may launch concurrently
        flash_fwd.launches += 1
    return (out, lse) if with_lse else out


flash_fwd.launches = 0
_launch_lock = threading.Lock()


# ---------------------------------------------------------------------------
# flash backward: the two kernels' plain versions and their wrappers
# ---------------------------------------------------------------------------

def _bwd_operands(q, k, v, g, lse2, sm_scale):
    """f32 (B, H, S, D) operands of the backward: q pre-scaled into the
    log2 domain as the forward had it, and L = lse2 as (B, H, Sq, 1)."""
    b, s_q, h, _ = q.shape
    q2 = q.float().permute(0, 2, 1, 3) * (sm_scale * LOG2_E)
    kf, vf, gf = (t.float().permute(0, 2, 1, 3) for t in (k, v, g))
    return q2, kf, vf, gf, lse2.reshape(b, h, s_q, 1)


def _bwd_delta(g, o):
    """delta = rowsum(g * o) in f32, as (B*H, Sq, 1) like lse2."""
    b, s_q, h, _ = g.shape
    delta = (g.float() * o.float()).sum(-1)                  # (B, Sq, H)
    return delta.permute(0, 2, 1).reshape(b * h, s_q, 1)


def _bwd_tile_plain(q2, k_t, v_t, g, L, delta, causal, q_pos, k0,
                    mm=torch.matmul):
    """One (query rows, key tile) block of the backward, as the kernels do
    it: rebuild P = exp2(q2 k^T - L), dP = g v^T, dS = P (dP - delta).
    Masked scores are NEG_INF, so their P is exactly 0."""
    s = mm(q2, k_t.transpose(-1, -2))
    if causal:
        k_pos = k0 + torch.arange(k_t.shape[-2], device=q2.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
    p = torch.exp2(s - L)
    ds = p * (mm(g, v_t.transpose(-1, -2)) - delta)
    return p, ds


def _to_bshd(t, dtype):
    """(B, H, S, D) f32 -> a fresh (B, S, H, D) tensor of ``dtype``."""
    return t.to(dtype).permute(0, 2, 1, 3).contiguous()


def flash_bwd_dq_plain(q, k, v, o, lse2, g, *, causal: bool = False,
                       sm_scale: Optional[float] = None,
                       mm: Callable = torch.matmul):
    """B2's arithmetic in plain PyTorch, in f32: delta = rowsum(g * o);
    walk the key tiles, dq += dS k; scale by sm_scale at the end. Returns
    (dq in the input dtype, delta as (B*H, Sq, 1) f32). ``mm`` takes the
    three products (``mm_3xtf32`` emulates the kernel's)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, s_q, h, _ = q.shape
    s_k = k.shape[1]
    q2, kf, vf, gf, L = _bwd_operands(q, k, v, g, lse2, sm_scale)
    delta = _bwd_delta(g, o)
    d4 = delta.reshape(b, h, s_q, 1)
    q_pos = (s_k - s_q) + torch.arange(s_q, device=q.device)[:, None]
    dq = torch.zeros_like(q2)
    for k0 in range(0, s_k, KERNEL_BLOCK_K):
        k1 = k0 + KERNEL_BLOCK_K
        k_t, v_t = kf[:, :, k0:k1], vf[:, :, k0:k1]
        _, ds = _bwd_tile_plain(q2, k_t, v_t, gf, L, d4, causal, q_pos, k0,
                                mm)
        dq = dq + mm(ds, k_t)
    return _to_bshd(dq * sm_scale, q.dtype), delta


def flash_bwd_dkv_plain(q, k, v, g, lse2, delta, *, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        mm: Callable = torch.matmul):
    """B3's arithmetic in plain PyTorch, in f32: walk the query tiles,
    dv += P^T g and dk += dS^T q2, then dk times 1/log2(e) (q2 carried the
    log2 prescale). Returns (dk, dv) in the input dtype. ``mm`` takes the
    four products (``mm_3xtf32`` emulates the kernel's)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, s_q, h, _ = q.shape
    s_k = k.shape[1]
    q2, kf, vf, gf, L = _bwd_operands(q, k, v, g, lse2, sm_scale)
    d4 = delta.reshape(b, h, s_q, 1)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, s_q, KERNEL_BLOCK_Q):
        q1 = min(q0 + KERNEL_BLOCK_Q, s_q)
        q_pos = (s_k - s_q) + torch.arange(q0, q1, device=q.device)[:, None]
        q_t, g_t = q2[:, :, q0:q1], gf[:, :, q0:q1]
        p, ds = _bwd_tile_plain(q_t, kf, vf, g_t, L[:, :, q0:q1],
                                d4[:, :, q0:q1], causal, q_pos, 0, mm)
        dv = dv + mm(p.transpose(-1, -2), g_t)
        dk = dk + mm(ds.transpose(-1, -2), q_t)
    return _to_bshd(dk * (1.0 / LOG2_E), k.dtype), _to_bshd(dv, v.dtype)


def flash_bwd_plain(q, k, v, o, lse2, g, *, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """B2 and B3 in plain PyTorch: the JAX package's ``_flash_bwd`` with
    every operand in f32 (the JAX kernel rounds P and dS to bf16 for bf16
    inputs; the CUDA kernels and this version keep them in f32). q, k, v,
    o, g are (B, S, H, D), lse2 is the forward's (B*H, Sq, 1) f32. Returns
    (dq, dk, dv) in the input dtype."""
    kw = dict(causal=causal, sm_scale=sm_scale)
    dq, delta = flash_bwd_dq_plain(q, k, v, o, lse2, g, **kw)
    dk, dv = flash_bwd_dkv_plain(q, k, v, g, lse2, delta, **kw)
    return dq, dk, dv


def _check_bwd_inputs(what, q, k, v, g, lse2, causal, *extra):
    _check_kernel_inputs(q, k, v, causal, what)
    b, s_q, h, _ = q.shape
    if not g.is_cuda or g.device != q.device or g.dtype != q.dtype:
        raise ValueError(f"{what}: g must lie on q's device with q's dtype")
    if g.shape != q.shape:
        raise ValueError(f"{what}: g {tuple(g.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    for name, t in (("lse2", lse2),) + extra:
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (b * h, s_q, 1)
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous f32 "
                             f"(B*H, Sq, 1) tensor on q's device")


def _strides(*ts):
    """The (batch, seq, head) strides of each tensor, in order."""
    out = []
    for t in ts:
        out += t.stride()[:3]
    return out


def flash_bwd_dq(q, k, v, o, lse2, g, *, causal: bool = False,
                 sm_scale: Optional[float] = None):
    """dQ pass of the flash backward over (B, S, H, D).

    On CUDA tensors: launches ``csrc/flash_bwd_dq.cu`` (replaces the
    Pallas ``_flash_bwd_dq_kernel``), which also writes ``delta =
    rowsum(g*o)`` for the dK/dV pass, and adds one to
    ``flash_bwd_dq.launches``. On CPU tensors: the plain version. Returns
    ``(dq, delta)``: dq (B, Sq, H, D) in the input dtype, delta (B*H, Sq,
    1) f32."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, o, lse2, g, causal=causal,
                                  sm_scale=sm_scale)
    _check_bwd_inputs("flash_bwd_dq", q, k, v, g, lse2, causal)
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device:
        raise ValueError("flash_bwd_dq: o must match q in shape, dtype "
                         "and device")
    q, k, v, o, g = (_aligned16(t) for t in (q, k, v, o, g))
    b, s_q, h, d = q.shape
    dq = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b * h, s_q, 1), dtype=torch.float32,
                        device=q.device)
    _launch("flash_bwd_dq", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            g.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, s_q, k.shape[1], d,
            *_strides(q, k, v, o, g, dq),
            ctypes.c_float(sm_scale * LOG2_E), ctypes.c_float(sm_scale),
            int(bool(causal)))
    with _launch_lock:
        flash_bwd_dq.launches += 1
    return dq, delta


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, g, lse2, delta, *, causal: bool = False,
                  sm_scale: Optional[float] = None):
    """dK/dV pass of the flash backward over (B, S, H, D), given the
    ``delta`` that ``flash_bwd_dq`` returned.

    On CUDA tensors: launches ``csrc/flash_bwd_dkv.cu`` (replaces the
    Pallas ``_flash_bwd_dkv_kernel``) and adds one to
    ``flash_bwd_dkv.launches``. On CPU tensors: the plain version. Returns
    ``(dk, dv)``, (B, Sk, H, D) in the input dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, g, lse2, delta, causal=causal,
                                   sm_scale=sm_scale)
    _check_bwd_inputs("flash_bwd_dkv", q, k, v, g, lse2, causal,
                      ("delta", delta))
    q, k, v, g = _aligned16(q), _aligned16(k), _aligned16(v), _aligned16(g)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    dk = torch.empty((b, s_k, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    _launch("flash_bwd_dkv", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, s_q, s_k, d,
            *_strides(q, k, v, g, dk),
            ctypes.c_float(sm_scale * LOG2_E), ctypes.c_float(1.0 / LOG2_E),
            int(bool(causal)))
    with _launch_lock:
        flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Flash attention: kernel B1 forward, kernels B2 and B3 backward.
    Without grad (serving) the forward skips lse2 and saves nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if not any(ctx.needs_input_grad[:3]):
            return flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        o, lse2 = flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse2)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse2 = ctx.saved_tensors
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        dq, delta = flash_bwd_dq(q, k, v, o, lse2, g, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse2, delta, **kw)
        return dq, dk, dv, None, None


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

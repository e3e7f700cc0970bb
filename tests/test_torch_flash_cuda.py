"""The flash-attention kernels (B1 ``csrc/flash_fwd.cu``, B2
``csrc/flash_bwd_dq.cu``, B3 ``csrc/flash_bwd_dkv.cu``) against their plain
PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so on a machine with the card it
runs without the JAX test fixtures:

    python -m pytest tests/test_torch_flash_cuda.py --noconftest -q

Tolerances of the backward are relative to each gradient's largest
magnitude: the gradients are sums over up to 2048 keys (or queries), so an
absolute bound would say little. f32 1e-5: kernel and plain version both
sum in f32, in a different order (the kernels take their products in
3xTF32, which keeps f32 accuracy). bf16 2e-2: both round the result to
bf16 (one ulp is 2^-8 relative) from f32 sums of the same bf16 inputs. The
forward's output is held absolutely (outputs are convex combinations of v
rows, |o| <= 4 here) at the same 1e-5 / 2e-2, and lse2, f32 on both
sides, at 1e-5.
"""

import math

import pytest
import torch

from analytics_zoo_tpu_torch.ops import attention as tattn

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
CASES = [  # (s_q, s_k, causal, head_dim)
    (128, 128, False, 64),
    (128, 128, True, 64),
    (128, 512, True, 64),       # causal decode-style, bottom-right mask
    (100, 130, False, 64),      # ragged tiles on both sides
    (72, 72, True, 32),
    (24, 72, True, 16),
    (128, 128, True, 128),
    (2048, 2048, False, 64),    # long sequences: 32 key (or query) tiles
    (2048, 2048, True, 64),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _views(b, s_q, s_k, h, d, dtype, gen):
    """q, k, v as strided views of one fused projection, as BERT has them."""
    qkv = torch.randn(b, s_k, 3 * h * d, device="cuda", generator=gen)
    qkv = qkv.to(dtype)
    k = qkv[..., h * d:2 * h * d].view(b, s_k, h, d)
    v = qkv[..., 2 * h * d:].view(b, s_k, h, d)
    q = (qkv[..., :h * d].view(b, s_q, h, d) if s_q == s_k else
         torch.randn(b, s_q, h, d, device="cuda", generator=gen).to(dtype))
    return q, k, v


def _rel_err(a, b):
    b = b.float()
    return ((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-30)
            ).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,s_k,causal,d", CASES)
def test_fwd_kernel_matches_plain(dtype, s_q, s_k, causal, d):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = _views(2, s_q, s_k, 12 if d < 128 else 4, d, dtype, gen)
    n = tattn.flash_fwd.launches
    out, lse2 = tattn.flash_fwd(q, k, v, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    assert tattn.flash_fwd.launches == n + 1
    want, want_lse = tattn.flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == want.shape
    assert bool(torch.isfinite(out).all())
    assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (lse2 - want_lse).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_views_give_the_contiguous_result(dtype):
    """The kernels copy 16-byte rows: a view whose rows are not 16-byte
    aligned is copied by the wrapper, and gives the same result as its
    contiguous copy."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, s, h, d = 2, 128, 12, 64
    buf = torch.randn(b, s, 3 * h * d + 1, device="cuda",
                      generator=gen).to(dtype)
    q, k, v = (buf[..., 1 + i * h * d:1 + (i + 1) * h * d].view(b, s, h, d)
               for i in range(3))
    g = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
    assert q.data_ptr() % 16 != 0
    runs = []
    for args in ((q, k, v), tuple(t.contiguous() for t in (q, k, v))):
        out, lse2 = tattn.flash_fwd(*args, causal=True, with_lse=True)
        _, delta = tattn.flash_bwd_dq(*args, out, lse2, g, causal=True)
        runs.append((out, lse2) + tattn.flash_bwd_dkv(
            *args, g, lse2, delta, causal=True))
    torch.cuda.synchronize()
    for got, want in zip(*runs):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,s_k,causal,d", CASES)
def test_bwd_kernels_match_plain(dtype, s_q, s_k, causal, d):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = _views(2, s_q, s_k, 12 if d < 128 else 4, d, dtype, gen)
    g = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
    sm = 1.0 / math.sqrt(d)
    o, lse2 = tattn.flash_fwd(q, k, v, causal=causal, with_lse=True)
    n_dq, n_dkv = tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches
    dq, delta = tattn.flash_bwd_dq(q, k, v, o, lse2, g, causal=causal,
                                   sm_scale=sm)
    dk, dv = tattn.flash_bwd_dkv(q, k, v, g, lse2, delta, causal=causal,
                                 sm_scale=sm)
    torch.cuda.synchronize()
    assert tattn.flash_bwd_dq.launches == n_dq + 1
    assert tattn.flash_bwd_dkv.launches == n_dkv + 1
    ref = tattn.flash_bwd_plain(q, k, v, o, lse2, g, causal=causal,
                                sm_scale=sm)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == dtype and got.shape == want.shape, name
        assert bool(torch.isfinite(got).all()), name
        assert _rel_err(got, want) <= TOL[dtype], name
    want_delta = tattn._bwd_delta(g, o)
    assert (delta - want_delta).abs().max().item() <= \
        1e-5 * want_delta.abs().max().item() + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grads_match_autograd_reference(causal):
    """f32 end to end: autograd through B1-B3 against autograd through the
    materialised-scores reference, with a strided (non-unit head stride)
    incoming gradient."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = _views(2, 128, 128, 12, 64, torch.float32, gen)
    g = torch.randn(2, 128, 64, 12, device="cuda", generator=gen)
    g = g.transpose(2, 3)                      # stride(-1) != 1
    grads = []
    for fn in (tattn.flash_attention, tattn.mha_reference):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves, causal=causal).backward(g)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert _rel_err(got, want) <= 1e-5


@pytest.mark.cuda
def test_bwd_wrappers_refuse_what_the_kernels_do_not_take():
    _card()
    q = torch.randn(1, 64, 2, 48, device="cuda")       # head_dim 48
    lse = torch.zeros(2, 64, 1, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_bwd_dq(q, q, q, q, lse, q)
    q = torch.randn(1, 64, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="lse2"):
        tattn.flash_bwd_dkv(q, q, q, q, lse[:, :32], lse)

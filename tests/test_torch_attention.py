"""The port's attention ops (analytics_zoo_tpu_torch/ops/attention.py)
against the JAX package's on the same numpy inputs.

On the CPU the port's ``flash_fwd`` wrapper runs ``flash_attention_plain``
(the CUDA kernel's plain version); the JAX flash kernel runs in Pallas
interpret mode exactly as tests/test_attention.py runs it. Tolerances:
f32 rtol/atol 2e-4, as in tests/test_attention.py. bf16 2e-2: both sides
round the output to bf16 (8 bits of mantissa, one ulp is 2^-8 relative),
and the JAX kernel also rounds q*scale and the probabilities to bf16
before its matmuls while the port keeps them in f32, so the two may differ
by a few bf16 ulps of outputs of magnitude up to ~2.

The 3xTF32 tests run the plain versions with every product emulated as
kernels B1-B3 take it on the tensor cores (``mm_3xtf32``) and hold them
against the JAX package at 1e-5 relative to each result's largest value,
the kernels' f32 parity on the card; with one TF32 pass the same runs miss
that tolerance (measured ~4e-4 against ~5e-7 with three), so the
tolerance tells the two designs apart.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as jattn
from analytics_zoo_tpu_torch.ops import attention as tattn

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _qkv(b=2, s_q=32, s_k=32, h=4, d=16, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s_q, h, d).astype(np.float32) * 0.5
    k = rng.randn(b, s_k, h, d).astype(np.float32) * 0.5
    v = rng.randn(b, s_k, h, d).astype(np.float32) * 0.5
    return q, k, v


def _both(arrs, dtype="float32"):
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


CASES = [  # (s_q, s_k, causal)
    (32, 32, False),
    (32, 32, True),
    (16, 48, True),      # causal decode-style s_q < s_k, bottom-right mask
    (16, 48, False),
    (24, 72, False),     # lengths that are not a multiple of the tiles
]


@pytest.mark.parametrize("s_q,s_k,causal", CASES)
@pytest.mark.parametrize("impl", ["flash_attention", "flash_attention_plain"])
def test_flash_matches_jax(s_q, s_k, causal, impl):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s_q=s_q, s_k=s_k))
    ref_flash = jattn.flash_attention(jq, jk, jv, causal=causal,
                                      block_q=8, block_k=8)
    ref_mha = jattn.mha_reference(jq, jk, jv, causal=causal)
    if impl == "flash_attention":
        out = tattn.flash_attention(tq, tk, tv, causal=causal)
    else:
        out, _ = tattn.flash_attention_plain(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref_flash), **F32_TOL)
    np.testing.assert_allclose(_np(out), _np(ref_mha), **F32_TOL)


@pytest.mark.parametrize("s_q,s_k,causal",
                         [(32, 32, False), (32, 32, True), (16, 48, True)])
def test_flash_bf16_matches_jax(s_q, s_k, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s_q=s_q, s_k=s_k), "bfloat16")
    ref = jattn.flash_attention(jq, jk, jv, causal=causal, block_q=8,
                                block_k=8)
    out = tattn.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), **BF16_TOL)


@pytest.mark.parametrize("s_q,s_k,causal",
                         [(32, 32, False), (32, 32, True), (16, 48, True)])
def test_lse2_matches_jax_kernel(s_q, s_k, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s_q=s_q, s_k=s_k))
    sm_scale = 1.0 / np.sqrt(16)
    jout, jlse = jattn._flash_forward(jq, jk, jv, causal, sm_scale, 8, 8,
                                      interpret=True, with_lse=True)
    out, lse = tattn.flash_fwd(tq, tk, tv, causal=causal, sm_scale=sm_scale,
                               with_lse=True)
    assert tuple(lse.shape) == tuple(jlse.shape) == (2 * 4, s_q, 1)
    np.testing.assert_allclose(_np(lse), _np(jlse), **F32_TOL)
    np.testing.assert_allclose(_np(out), _np(jout), **F32_TOL)


@pytest.mark.parametrize("s_q,s_k,causal,blocks,routed", [
    (32, 32, False, (1024, 1024), "kernel"),
    (16, 48, True, (1024, 1024), "kernel"),
    (12, 12, False, (8, 8), "reference"),     # 12 has no tile <= 8
    (48, 16, True, (1024, 1024), "reference"),  # causal s_q > s_k
])
def test_routing_matches_jax(monkeypatch, s_q, s_k, causal, blocks, routed):
    """The port sends the same shapes to the kernel as the JAX package:
    the fit_block ladder decides, and indivisible tiles or causal
    s_q > s_k take the reference route."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s_q=s_q, s_k=s_k))
    calls = []
    real = tattn._FlashAttention.apply
    monkeypatch.setattr(tattn._FlashAttention, "apply",
                        lambda *a: calls.append(a) or real(*a))
    out = tattn.flash_attention(tq, tk, tv, causal=causal, block_q=blocks[0],
                                block_k=blocks[1])
    assert ("kernel" if calls else "reference") == routed
    ref = jattn.flash_attention(jq, jk, jv, causal=causal,
                                block_q=blocks[0], block_k=blocks[1])
    np.testing.assert_allclose(_np(out), _np(ref), **F32_TOL)


@pytest.mark.parametrize("s_q,s_k,causal",
                         [(96, 96, False), (96, 96, True), (1, 96, True)])
def test_blockwise_attention_matches_jax(s_q, s_k, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s_q=s_q, s_k=s_k))
    ref = jattn.blockwise_attention(jq, jk, jv, causal=causal, block_k=32)
    out = tattn.blockwise_attention(tq, tk, tv, causal=causal, block_k=32)
    np.testing.assert_allclose(_np(out), _np(ref), **F32_TOL)


def test_mha_reference_bias_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv())
    mask = np.ones((2, 32), np.float32)
    mask[:, 20:] = 0
    jbias = (1.0 - jnp.asarray(mask)[:, None, None, :]) * -1e9
    tbias = (1.0 - torch.from_numpy(mask)[:, None, None, :]) * -1e9
    ref = jattn.mha_reference(jq, jk, jv, bias=jbias)
    out = tattn.mha_reference(tq, tk, tv, bias=tbias)
    np.testing.assert_allclose(_np(out), _np(ref), **F32_TOL)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    _, (tq, tk, tv) = _both(_qkv())
    before = tattn.flash_fwd.launches
    out, lse = tattn.flash_fwd(tq, tk, tv, causal=True, with_lse=True)
    pout, plse = tattn.flash_attention_plain(tq, tk, tv, causal=True)
    assert torch.equal(out, pout) and torch.equal(lse, plse)
    assert tattn.flash_fwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_on_card(dtype, tol):
    """Runs the CUDA kernel; needs the card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for s_q, s_k, causal in [(128, 128, False), (128, 128, True),
                             (128, 512, True), (100, 130, False)]:
        q, k, v = (torch.randn(2, s, 12, 64, device="cuda", generator=g)
                   .to(dtype) for s in (s_q, s_k, s_k))
        before = tattn.flash_fwd.launches
        out, lse = tattn.flash_fwd(q, k, v, causal=causal, with_lse=True)
        torch.cuda.synchronize()
        assert tattn.flash_fwd.launches == before + 1
        pout, plse = tattn.flash_attention_plain(q, k, v, causal=causal)
        assert (out.float() - pout.float()).abs().max().item() <= tol
        assert (lse - plse).abs().max().item() <= 1e-5


def test_tf32_split_rounds_to_nearest_away_like_cvt_rna():
    x = torch.tensor([1.0 + 2.0 ** -11,         # a tie: rounds away
                      -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23,   # below the tie
                      1.0 + 3 * 2.0 ** -11,      # a tie above an odd ulp
                      3.0, 0.0], dtype=torch.float32)
    hi, lo = tattn.tf32_split(x)
    want_hi = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
               1.0 + 2.0 ** -9, 3.0, 0.0]
    assert hi.tolist() == want_hi
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    rng = np.random.RandomState(0)
    r = torch.from_numpy(rng.randn(4096).astype(np.float32))
    hi, lo = tattn.tf32_split(r)
    # hi + lo carries x to 2^-21 of its magnitude (22 of f32's 24 bits)
    assert ((hi + lo - r).abs() <= r.abs() * 2.0 ** -21).all()
    assert ((hi - r).abs() <= r.abs() * 2.0 ** -11).all()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


TF32_TOL = 1e-5      # the kernels' f32 parity, relative to the largest value


def _check_tf32(passes, errs):
    if passes == 3:
        assert max(errs.values()) <= TF32_TOL, errs
    else:       # plain TF32 fails the same check
        assert max(errs.values()) > TF32_TOL, errs


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("s_q,s_k,causal", CASES)
def test_3xtf32_forward_matches_jax(s_q, s_k, causal, passes):
    """B1's recurrence with every product in 3xTF32 against the JAX flash
    kernel (Pallas interpret mode): output and lse2."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s_q=s_q, s_k=s_k))
    sm_scale = 1.0 / np.sqrt(16)
    jout, jlse = jattn._flash_forward(jq, jk, jv, causal, sm_scale, 8, 8,
                                      interpret=True, with_lse=True)
    mm = functools.partial(tattn.mm_3xtf32, passes=passes)
    out, lse = tattn.flash_attention_plain(tq, tk, tv, causal=causal,
                                           sm_scale=sm_scale, mm=mm)
    _check_tf32(passes, {"out": _rel(_np(out), _np(jout)),
                         "lse2": _rel(_np(lse), _np(jlse))})


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("s_q,s_k,causal", CASES)
def test_3xtf32_dkv_matches_jax_vjp(s_q, s_k, causal, passes):
    """The forward and B3's dK/dV recurrence with every product in 3xTF32
    against jax.grad through the JAX flash_attention (its Pallas backward
    in interpret mode)."""
    q, k, v = _qkv(s_q=s_q, s_k=s_k)
    g = np.random.RandomState(1).randn(*q.shape).astype(np.float32)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _both((q, k, v, g))

    def loss(q, k, v):
        out = jattn.flash_attention(q, k, v, causal=causal, block_q=8,
                                    block_k=8)
        return jnp.sum(out * jg)

    _, jdk, jdv = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    mm = functools.partial(tattn.mm_3xtf32, passes=passes)
    out, lse = tattn.flash_attention_plain(tq, tk, tv, causal=causal, mm=mm)
    delta = tattn._bwd_delta(tg, out)
    dk, dv = tattn.flash_bwd_dkv_plain(tq, tk, tv, tg, lse, delta,
                                       causal=causal, mm=mm)
    _check_tf32(passes, {"dk": _rel(_np(dk), _np(jdk)),
                         "dv": _rel(_np(dv), _np(jdv))})


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("s_q,s_k,causal", CASES)
def test_3xtf32_dq_matches_jax_vjp(s_q, s_k, causal, passes):
    """The forward and B2's dQ recurrence with every product in 3xTF32
    against jax.grad through the JAX flash_attention (its Pallas backward
    in interpret mode): dq, and the delta = rowsum(g * o) returned beside
    it against the same sum over the JAX forward's output."""
    q, k, v = _qkv(s_q=s_q, s_k=s_k)
    g = np.random.RandomState(1).randn(*q.shape).astype(np.float32)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _both((q, k, v, g))

    def flash(q, k, v):
        return jattn.flash_attention(q, k, v, causal=causal, block_q=8,
                                     block_k=8)

    jdq = jax.grad(lambda q: jnp.sum(flash(q, jk, jv) * jg))(jq)
    jdelta = jnp.sum(jg * flash(jq, jk, jv), -1).transpose(0, 2, 1)
    mm = functools.partial(tattn.mm_3xtf32, passes=passes)
    out, lse = tattn.flash_attention_plain(tq, tk, tv, causal=causal, mm=mm)
    dq, delta = tattn.flash_bwd_dq_plain(tq, tk, tv, out, lse, tg,
                                         causal=causal, mm=mm)
    _check_tf32(passes, {"dq": _rel(_np(dq), _np(jdq)),
                         "delta": _rel(_np(delta).reshape(-1),
                                       _np(jdelta).reshape(-1))})


def test_mm_3xtf32_refuses_other_pass_counts():
    with pytest.raises(ValueError, match="passes"):
        tattn.mm_3xtf32(torch.ones(2, 2), torch.ones(2, 2), passes=2)


def test_aligned16_copies_only_misaligned_operands():
    """The kernel wrappers hand the kernels 16-byte aligned
    rows: the strided q/k/v views of a fused projection pass through,
    a view off by one element or with an odd row stride is copied once."""
    b, s, h, d = 2, 8, 3, 16
    qkv = torch.randn(b, s, 3 * h * d)
    k = qkv[..., h * d:2 * h * d].view(b, s, h, d)
    assert tattn._aligned16(k) is k
    for bad in (torch.randn(b, s, 3 * h * d + 1)[..., 1:1 + h * d],
                torch.randn(b, s, h * d + 2)[..., :h * d],
                torch.randn(b, s, d, h).transpose(2, 3)):
        bad = bad.reshape(b, s, h, d) if bad.dim() == 3 else bad
        fixed = tattn._aligned16(bad)
        assert fixed is not bad and torch.equal(fixed, bad)
        assert fixed.is_contiguous() and fixed.data_ptr() % 16 == 0
        assert tattn._aligned16(fixed) is fixed


def test_ptxas_report_parses_each_kernel_instance(tmp_path, monkeypatch):
    """The build keeps ptxas's -v report beside each library; the smoke
    reads registers and spills per (kernel, dtype, head_dim) from it."""
    from analytics_zoo_tpu_torch.ops import _kernels
    log = tmp_path / "flash_fwd.ptxas.txt"
    log.write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvNS_6ParamsE' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvNS_6ParamsE\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 214 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_"
        "fwd_kernelI13__nv_bfloat16Li128EEEvNS_6ParamsE' for 'sm_90a'\n"
        "    16 bytes stack frame, 20 bytes spill stores, 32 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n")
    monkeypatch.setattr(_kernels, "_log_path", lambda name: str(log))
    assert _kernels.ptxas_report("flash_fwd") == [
        {"kernel": "flash_fwd", "dtype": "f32", "head_dim": 64,
         "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
         "registers": 214},
        {"kernel": "flash_fwd", "dtype": "bf16", "head_dim": 128,
         "stack_bytes": 16, "spill_store_bytes": 20, "spill_load_bytes": 32,
         "registers": 255}]

"""The port's flash-attention backward (kernels B2/B3 through their plain
version on the CPU) against the JAX package's, on the same numpy inputs.

On the JAX side ``jax.grad`` runs through ``flash_attention``'s custom VJP,
whose backward is the Pallas ``_flash_bwd`` in interpret mode, as
tests/test_attention.py runs it. Tolerances: f32 rtol/atol 2e-4 (that
file's). bf16 2e-2, relative to each gradient's largest magnitude (the
forward's bf16 tolerance): both sides round q, k, v, g and the result to
bf16, and the JAX kernels also round q*scale, P and dS to bf16 before
their matmuls while the port keeps them in f32, so the two differ by a few
bf16 ulps (2^-8 relative each) of the largest gradient; 6.8e-3 was the
most seen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as jattn
from analytics_zoo_tpu_torch.ops import attention as tattn

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_REL_TOL = 2e-2
CASES = [  # (s_q, s_k, causal): tests/test_torch_attention.py's
    (32, 32, False),
    (32, 32, True),
    (16, 48, True),      # causal decode-style s_q < s_k, bottom-right mask
    (16, 48, False),
    (24, 72, False),     # lengths that are not a multiple of the tiles
]


def _inputs(s_q, s_k, b=2, h=4, d=16, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) * 0.5
               for s in (s_q, s_k, s_k))
    g = rng.randn(b, s_q, h, d).astype(np.float32)
    return q, k, v, g


def _jax_grads(fn, q, k, v, g, dtype, causal):
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    gj = jnp.asarray(g).astype(dtype)

    def loss(q, k, v):
        out = fn(q, k, v, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * gj.astype(jnp.float32))

    return [np.asarray(t.astype(jnp.float32))
            for t in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _torch_grads(q, k, v, g, dtype, causal):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in (q, k, v)]
    out = tattn.flash_attention(*leaves, causal=causal)
    out.backward(torch.from_numpy(g).to(dtype))
    return [t.grad.float().numpy() for t in leaves]


def _jax_flash(q, k, v, causal):
    return jattn.flash_attention(q, k, v, causal=causal, block_q=8,
                                 block_k=8)


@pytest.mark.parametrize("s_q,s_k,causal", CASES)
def test_flash_grads_match_jax(s_q, s_k, causal):
    q, k, v, g = _inputs(s_q, s_k)
    got = _torch_grads(q, k, v, g, torch.float32, causal)
    for ref_fn in (_jax_flash, jattn.mha_reference):
        want = _jax_grads(ref_fn, q, k, v, g, jnp.float32, causal)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a, b, err_msg=name, **F32_TOL)


@pytest.mark.parametrize("s_q,s_k,causal",
                         [(32, 32, False), (32, 32, True), (16, 48, True)])
def test_flash_grads_bf16_match_jax(s_q, s_k, causal):
    q, k, v, g = _inputs(s_q, s_k)
    got = _torch_grads(q, k, v, g, torch.bfloat16, causal)
    want = _jax_grads(_jax_flash, q, k, v, g, jnp.bfloat16, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        rel = np.abs(a - b).max() / np.abs(b).max()
        assert rel <= BF16_REL_TOL, (name, rel)


@pytest.mark.parametrize("s_q,s_k,causal", CASES)
def test_flash_bwd_plain_matches_jax_flash_bwd(s_q, s_k, causal):
    """The kernels' plain version against the JAX backward given the same
    forward residuals (out and lse2 from the JAX forward)."""
    q, k, v, g = _inputs(s_q, s_k)
    sm = 1.0 / np.sqrt(q.shape[-1])
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, causal, sm, 8, 8,
                                    interpret=True, with_lse=True)
    want = jattn._flash_bwd(causal, sm, 8, 8, (jq, jk, jv, out, lse), jg)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse, g)]
    got = tattn.flash_bwd_plain(*t, causal=causal, sm_scale=sm)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **F32_TOL)


def test_cpu_bwd_wrappers_run_plain_and_count_no_launch():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(32, 48))
    out, lse = tattn.flash_fwd(q, k, v, causal=True, with_lse=True)
    before = (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches)
    dq, delta = tattn.flash_bwd_dq(q, k, v, out, lse, g, causal=True)
    dk, dv = tattn.flash_bwd_dkv(q, k, v, g, lse, delta, causal=True)
    ref = tattn.flash_bwd_plain(q, k, v, out, lse, g, causal=True)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)
    assert delta.shape == (2 * 4, 32, 1)
    assert torch.allclose(delta.reshape(2, 4, 32).transpose(1, 2),
                          (g * out).sum(-1))
    assert (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches) == \
        before


def test_lse_only_when_grads_are_needed(monkeypatch):
    """Serving (no grad) keeps the forward as it was: no lse2, nothing
    saved. Training asks the forward for lse2."""
    calls = []
    real = tattn.flash_fwd
    monkeypatch.setattr(tattn, "flash_fwd", lambda *a, **kw: calls.append(
        kw.get("with_lse", False)) or real(*a, **kw))
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(32, 32))
    with torch.no_grad():
        tattn.flash_attention(q, k, v)
    q.requires_grad_(True)
    tattn.flash_attention(q, k, v).sum().backward()
    assert calls == [False, True]
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())

"""The port's transformer/BERT layers and weight bridge against the JAX
package: the same numpy inputs and the same weights (flax-initialised,
perturbed with numpy noise so no bias or LayerNorm scale is trivial,
bridged with analytics_zoo_tpu_torch.interop) through both.

Tolerance f32 rtol/atol 2e-4 (tests/test_attention.py's). It covers the
summation-order differences of the two frameworks and flax's LayerNorm
variance E[x^2]-E[x]^2 against torch's E[(x-E[x])^2], which differ by
~1e-7 relative at these widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import embedding as jemb
from analytics_zoo_tpu.pipeline.api.keras.layers import self_attention as jsa
from analytics_zoo_tpu.tfpark.text import estimator as jest
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.ops import embedding as temb
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    self_attention as tsa
from analytics_zoo_tpu_torch.tfpark.text import estimator as test_

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(vocab=100, hidden_size=32, n_block=2, n_head=2, seq_len=32,
            intermediate_size=64)


def _init(module, *args, seed=0):
    """flax init, then every leaf perturbed with numpy noise."""
    params = module.init(jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), jax.device_get(params))


def _run_torch(module, params, *args):
    interop.load_flax_params(module, params).eval()
    with torch.no_grad():
        return module(*[torch.from_numpy(np.asarray(a)) for a in args])


def _x(b=2, s=16, hs=32, seed=3):
    return np.random.RandomState(seed).randn(b, s, hs).astype(np.float32)


def _ids(b=2, s=16, vocab=100, seed=4):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _mask(b=2, s=16):
    m = np.ones((b, s), np.int32)
    m[0, 11:] = 0
    m[1, 5:] = 0
    return m


@pytest.mark.parametrize("strategy", ["flash", "full"])
@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_parity(strategy, causal):
    x = _x()
    jm = jsa.MultiHeadAttention(n_head=4, hidden_size=32, causal=causal,
                                strategy=strategy)
    params = _init(jm, x)
    ref = jm.apply({"params": params}, x)
    out = _run_torch(tsa.MultiHeadAttention(
        n_head=4, hidden_size=32, causal=causal, strategy=strategy),
        params, x)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_transformer_block_parity(with_mask):
    x = _x()
    mask = _mask() if with_mask else None
    kw = dict(n_head=2, hidden_size=32, intermediate_size=64)
    jm = jsa.TransformerBlock(**kw)
    params = _init(jm, x, mask)
    ref = jm.apply({"params": params}, x, mask)
    tm = tsa.TransformerBlock(**kw)
    interop.load_flax_params(tm, params).eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(x),
                 None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_transformer_layer_causal_parity():
    ids = _ids(s=16)
    kw = dict(vocab=100, seq_len=16, n_block=2, n_head=2, hidden_size=32)
    jm = jsa.TransformerLayer(**kw)
    params = _init(jm, ids)
    ref = jm.apply({"params": params}, ids)
    out = _run_torch(tsa.TransformerLayer(**kw), params, ids)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_bert_parity(with_mask):
    ids = _ids(s=16)
    tt = (np.arange(16)[None, :] >= 8).astype(np.int32).repeat(2, 0)
    mask = _mask() if with_mask else None
    jm = jsa.BERT(**TINY)
    params = _init(jm, ids, tt, mask)
    ref_seq, ref_pooled = jm.apply({"params": params}, ids, tt, mask)
    tm = tsa.BERT(**TINY)
    interop.load_flax_params(tm, params).eval()
    with torch.no_grad():
        seq, pooled = tm(torch.from_numpy(ids), torch.from_numpy(tt),
                         None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(seq.numpy(), np.asarray(ref_seq), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled), **TOL)


@pytest.mark.parametrize("head,num_out", [("pooled", 3), ("tokens", 2)])
def test_bert_with_head_parity(head, num_out):
    ids = _ids(s=16)
    kwargs = tuple(sorted(TINY.items()))
    jm = jest._BertWithHead(bert_kwargs=kwargs, num_out=num_out, head=head)
    params = _init(jm, ids)
    ref = jm.apply({"params": params}, ids)
    out = _run_torch(test_._BertWithHead(kwargs, num_out=num_out, head=head),
                     params, ids)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bert_input_fn_matches_jax():
    feats = {"input_ids": _ids(), "input_mask": _mask()}
    labels = np.arange(2)
    ref = jest.bert_input_fn(feats, labels)
    out = test_.bert_input_fn(feats, labels)
    assert len(out["x"]) == len(ref["x"]) == 3
    for a, b in zip(out["x"], ref["x"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out["y"], ref["y"])


def test_embedding_lookup_matches_jnp_take():
    table = np.random.RandomState(0).randn(10, 4).astype(np.float32)
    ids = np.array([[0, 9, -1], [-10, 10, -11]], np.int32)
    ref = np.asarray(jemb.embedding_lookup(jnp.asarray(table),
                                           jnp.asarray(ids)))
    out = temb.embedding_lookup(torch.from_numpy(table),
                                torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_array_equal(np.nan_to_num(out), np.nan_to_num(ref))
    with pytest.raises(ValueError, match="grad_mode"):
        temb.embedding_lookup(torch.from_numpy(table),
                              torch.from_numpy(ids), grad_mode="bogus")


def test_interop_round_trip_is_byte_exact():
    ids = _ids()
    kwargs = tuple(sorted(TINY.items()))
    params = _init(jest._BertWithHead(bert_kwargs=kwargs, num_out=2), ids)
    tm = interop.load_flax_params(test_._BertWithHead(kwargs, num_out=2),
                                  params)
    back = interop.state_dict_to_flax(tm.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_interop_rejects_mismatch(fault):
    x = _x()
    params = _init(jsa.MultiHeadAttention(n_head=2, hidden_size=32), x)
    params = {k: dict(v) for k, v in params.items()}
    if fault == "missing":
        del params["proj"]["bias"]
    elif fault == "extra":
        params["proj"]["stray"] = np.zeros(3, np.float32)
    else:
        params["qkv"]["kernel"] = params["qkv"]["kernel"][:, :48]
    expect = {"missing": r"missing \['proj\.bias'\]",
              "extra": r"extra \['proj\.stray'\]",
              "shape": r"shape mismatch \['qkv\.weight: \(48, 32\)"}[fault]
    with pytest.raises(ValueError, match=expect):
        interop.load_flax_params(
            tsa.MultiHeadAttention(n_head=2, hidden_size=32), params)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sequence_parallel_strategies_not_ported(strategy):
    with pytest.raises(NotImplementedError, match="not ported"):
        tsa.MultiHeadAttention(n_head=2, hidden_size=32, strategy=strategy)

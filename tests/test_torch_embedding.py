"""The port's embedding backward (analytics_zoo_tpu_torch/ops/embedding.py)
against ``jax.grad`` of the JAX package's ``embedding_lookup``, for every
grad mode, for tables under and over the ``auto`` thresholds, and with
``ZOO_EMBED_GRAD_MODE`` overriding ``auto``.

Tolerances: the one-hot backward rounds the cotangents to bf16 on both
sides and sums exact products in f32, so the two agree to f32 rounding of
those sums (rtol/atol 1e-5, far inside bf16's 2^-8); the scatter backward
is exact f32 on both sides, but sums the rows of repeated ids (up to 48 of
them into each row of BERT's 2-row segment table) in another order, which
moves sums of magnitude ~10 by a few 1e-6 (rtol/atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import embedding as jemb
from analytics_zoo_tpu_torch.ops import embedding as temb

ONEHOT_TOL = dict(rtol=1e-5, atol=1e-5)
SCATTER_TOL = dict(rtol=1e-5, atol=1e-5)
TABLES = {  # name: (rows, cols)
    "small": (100, 32),                 # auto -> onehot
    "bert_segment": (2, 768),           # auto -> onehot at BERT-Base width
    "many_rows": (40000, 8),            # rows > 32768: auto -> scatter
    "many_elements": (30522, 300),      # rows*cols > 32768*256: scatter
}


def _grads(rows, cols, mode, seed=0):
    rng = np.random.RandomState(seed)
    table = rng.randn(rows, cols).astype(np.float32)
    ids = rng.randint(0, rows, (4, 24)).astype(np.int32)
    ids[0, :4] = ids[1, 0]                      # repeated ids sum
    g = rng.randn(4, 24, cols).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jemb.embedding_lookup(
        t, jnp.asarray(ids), grad_mode=mode) * g))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    (temb.embedding_lookup(t, torch.from_numpy(ids), grad_mode=mode)
     * torch.from_numpy(g)).sum().backward()
    return t.grad.numpy(), np.asarray(want), table, ids, g


def _onehot_expected(table, ids, g):
    """The one-hot backward's numbers: bf16-rounded cotangents summed per
    row."""
    g16 = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    out = np.zeros_like(table)
    np.add.at(out, ids.reshape(-1), g16.reshape(-1, g.shape[-1]))
    return out


def _scatter_expected(table, ids, g):
    out = np.zeros_like(table)
    np.add.at(out, ids.reshape(-1), g.reshape(-1, g.shape[-1]))
    return out


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("mode", ["auto", "onehot", "scatter"])
def test_table_grad_matches_jax(monkeypatch, table, mode):
    monkeypatch.delenv("ZOO_EMBED_GRAD_MODE", raising=False)
    rows, cols = TABLES[table]
    got, want, tab, ids, g = _grads(rows, cols, mode)
    onehot = mode == "onehot" or (
        mode == "auto" and rows <= temb.ONEHOT_ROWS_MAX
        and rows * cols <= temb.ONEHOT_ELEMENTS_MAX)
    tol = ONEHOT_TOL if onehot else SCATTER_TOL
    np.testing.assert_allclose(got, want, **tol)
    expected = (_onehot_expected if onehot else _scatter_expected)(tab, ids, g)
    np.testing.assert_allclose(got, expected, **tol)


@pytest.mark.parametrize("env", ["onehot", "scatter"])
def test_env_overrides_auto(monkeypatch, env):
    monkeypatch.setenv("ZOO_EMBED_GRAD_MODE", env)
    for rows, cols in (TABLES["small"], TABLES["many_rows"]):
        got, want, tab, ids, g = _grads(rows, cols, "auto", seed=1)
        tol = ONEHOT_TOL if env == "onehot" else SCATTER_TOL
        np.testing.assert_allclose(got, want, **tol)
        expected = (_onehot_expected if env == "onehot"
                    else _scatter_expected)(tab, ids, g)
        np.testing.assert_allclose(got, expected, **tol)


def test_onehot_rounds_where_scatter_does_not(monkeypatch):
    """The two modes really differ: the one-hot gradient carries bf16
    rounding, the scatter gradient does not."""
    monkeypatch.delenv("ZOO_EMBED_GRAD_MODE", raising=False)
    onehot, *_ = _grads(100, 32, "onehot", seed=2)
    scatter, *_ = _grads(100, 32, "scatter", seed=2)
    diff = np.abs(onehot - scatter).max()
    assert 0 < diff <= 2 ** -8 * np.abs(scatter).max()


def test_out_of_range_and_negative_ids_match_jax(monkeypatch):
    monkeypatch.delenv("ZOO_EMBED_GRAD_MODE", raising=False)
    table = np.random.RandomState(3).randn(10, 4).astype(np.float32)
    ids = np.array([[0, 9, -1], [-10, 10, -11]], np.int32)
    g = np.ones((2, 3, 4), np.float32)
    for mode in ("onehot", "scatter"):
        want = jax.grad(lambda t: jnp.nansum(jemb.embedding_lookup(
            t, jnp.asarray(ids), grad_mode=mode) * g))(jnp.asarray(table))
        t = torch.from_numpy(table).requires_grad_(True)
        out = temb.embedding_lookup(t, torch.from_numpy(ids), grad_mode=mode)
        torch.nansum(out * torch.from_numpy(g)).backward()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   err_msg=mode, **SCATTER_TOL)


def test_unknown_env_mode_raises(monkeypatch):
    monkeypatch.setenv("ZOO_EMBED_GRAD_MODE", "bogus")
    with pytest.raises(ValueError, match="grad_mode"):
        temb.embedding_lookup(torch.zeros(4, 2), torch.zeros(3, dtype=int))


# --- the one-hot backward without the one-hot ------------------------------
# onehot_sum_backward (the port's backward) against the one-hot matmul it
# replaces and against jax.grad through the JAX package's one-hot lookup:
# the bf16-rounded cotangents are summed in f32 on all three sides, in
# three orders, so they agree to f32 rounding: 1e-6 of the largest
# gradient.
R2_TOL = 1e-6


@pytest.mark.parametrize("rows,cols", [(6041, 8), (37, 128)])
def test_onehot_sum_backward_matches_matmul_and_jax(rows, cols):
    rng = np.random.RandomState(11)
    n = 512
    ids = rng.randint(0, rows, n).astype(np.int32)
    ids[:40] = ids[40]                          # one row shared by 41 ids
    ids[41:45] = [-1, -rows, rows, rows + 7]    # match no row
    g = rng.randn(n, cols).astype(np.float32)
    tids, tg = torch.from_numpy(ids), torch.from_numpy(g)
    got = temb.onehot_sum_backward(tids, tg, rows, torch.float32).numpy()
    plain = temb.onehot_matmul_backward(tids, tg, rows,
                                        torch.float32).numpy()
    table = jnp.zeros((rows, cols), jnp.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(jemb.embedding_lookup(
        t, jnp.asarray(ids), grad_mode="onehot") * g))(table))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=R2_TOL * scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=R2_TOL * scale)
    # the ids outside [0, rows) added nothing: the wrapped rows hold only
    # the in-range ids' cotangents
    for bad in (rows - 1, 0, 7):
        mine = ids == bad
        np.testing.assert_allclose(
            got[bad], torch.from_numpy(g[mine]).bfloat16().float()
            .sum(0).numpy(), rtol=0, atol=R2_TOL * scale)


def test_onehot_backward_allocates_no_one_hot(monkeypatch):
    """The autograd backward goes through onehot_sum_backward, never the
    (ids, rows) matmul."""
    calls = []
    monkeypatch.setattr(temb, "onehot_matmul_backward",
                        lambda *a: calls.append(a))
    table = torch.zeros(50, 4, requires_grad=True)
    ids = torch.tensor([1, 2, 2, 49])
    temb.embedding_lookup(table, ids, grad_mode="onehot").sum().backward()
    assert calls == []
    np.testing.assert_array_equal(table.grad.sum(1).numpy()[[1, 2, 49]],
                                  [4.0, 8.0, 4.0])


@pytest.mark.parametrize("rows,cols", [(1000, 16), (16, 1000)])
def test_mxuembed_init_std_matches_flax(rows, cols):
    """Fault R3: the port drew N(0, 1/num_embeddings); flax's
    ``variance_scaling(1, fan_in, normal, out_axis=0)`` takes fan_in =
    features on a 2-D table. Eight tables a side (128,000 draws): the
    port's std within 3 % of flax's, and the old formula misses."""
    from analytics_zoo_tpu.ops.embedding import MXUEmbed as JMXUEmbed
    module = JMXUEmbed(rows, cols)
    ids = jnp.zeros((1,), jnp.int32)
    want = np.concatenate([np.asarray(module.init(
        jax.random.PRNGKey(k), ids)["params"]["embedding"]).ravel()
        for k in range(8)])
    torch.manual_seed(0)
    got = np.concatenate([temb.MXUEmbed(rows, cols).embedding.detach()
                          .numpy().ravel() for _ in range(8)])
    assert got.size == want.size == 128_000
    assert abs(got.std() / want.std() - 1) <= 0.03
    assert abs(got.mean()) <= 0.03 * want.std()
    old = 1 / np.sqrt(rows)                     # the formula before R3
    assert abs(old / want.std() - 1) > 0.03

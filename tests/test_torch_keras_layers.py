"""The port's Keras recurrent, convolutional, pooling and embedding layers
(``analytics_zoo_tpu_torch/pipeline/api/keras/layers/{recurrent,
convolutional,pooling,embeddings}.py``) against the JAX package's, on the
CPU.

Every layer is built on both sides, flax's variables (after flax's init)
are bridged into the port's layer with ``interop`` (which also sizes its
lazy widths; the port's state maps back onto the same tree byte for
byte), and both take the same numpy-seeded input: the outputs, and
the gradients of ``sum(out * g)`` for a seeded ``g`` with respect to the
input and to every parameter, must agree within rtol/atol 1e-5 (f32, TF32
off on the port's side, JAX at ``highest`` precision). Named cases cover
what differs between the frameworks: flax's SAME padding at stride 2,
``Deconvolution2D`` (flax's ``ConvTranspose``) SAME and VALID at strides
1 and 2, the average pool's padded windows, and the recurrent layers'
fused branch (sigmoid gates: one torch RNN call) against their loop
branch (the Keras default ``hard_sigmoid``). The init tests hold the
port's draws to flax's initialisers, with torch's default init as the
control that must miss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline.api.keras import layers as JL
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.orca.learn.engine import has_lazy_params
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as TL
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    recurrent as trec

TOL = dict(rtol=1e-5, atol=1e-5)
RNGS = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}


def _x(shape, seed=0, ints=None):
    rng = np.random.RandomState(seed)
    if ints is not None:
        return rng.randint(0, ints, shape).astype(np.int32)
    return rng.randn(*shape).astype(np.float32)


def _check(jmod, tmod, x, tol=TOL):
    """Forward and gradients (input and parameters) of ``tmod`` against
    ``jmod`` from flax's init, bridged. The JAX side runs as one jitted
    program: init, output and the cotangent's pullback."""
    integer = np.issubdtype(x.dtype, np.integer)
    xj = jnp.asarray(x)
    shape = jax.eval_shape(lambda v: jmod.apply(jmod.init(RNGS, v), v),
                           xj).shape
    g = _x(shape, seed=7)

    @jax.jit
    def init_forward_pullback(xx):
        variables = jmod.init(RNGS, xx)
        params = variables.get("params", {})
        if integer:
            out, pull = jax.vjp(lambda p: jmod.apply({"params": p}, xx),
                                params)
            return variables, out, pull(g) + (None,)
        out, pull = jax.vjp(lambda p, v: jmod.apply({"params": p}, v),
                            params, xx)
        return variables, out, pull(g)
    variables, want, (jgrad_p, jgrad_x) = jax.device_get(
        init_forward_pullback(xj))
    interop.load_flax_params(tmod, dict(variables))
    assert not has_lazy_params(tmod)
    # and back onto the same flax tree, byte for byte
    back = interop.state_dict_to_flax(tmod.state_dict(), tmod)
    tree = jax.tree_util.tree_leaves_with_path(variables.get("params", {}))
    assert [p for p, _ in jax.tree_util.tree_leaves_with_path(back)] == \
        [p for p, _ in tree]
    for (_, a), (path, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 tree):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), path
    tx = torch.from_numpy(x)
    if not integer:
        tx.requires_grad_(True)
    tmod.train()
    got = tmod(tx)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)
    if got.requires_grad:
        (got * torch.from_numpy(g)).sum().backward()
    if not integer:
        np.testing.assert_allclose(tx.grad.numpy(), jgrad_x, **tol)
    want_grads = interop.flax_to_state_dict(jgrad_p)
    params = dict(tmod.named_parameters())
    assert set(want_grads) == set(params)
    for name, w in want_grads.items():
        p = params[name]
        grad = (p.grad if p.grad is not None else torch.zeros_like(p))
        np.testing.assert_allclose(grad.numpy(), w.numpy(), err_msg=name,
                                   **tol)


# name: (class, args, kwargs, input shape, integer ids up to)
SEQ, IMG, VOL = (3, 7, 4), (2, 3, 7, 6), (2, 2, 5, 4, 6)
LAYERS = {
    # convolutional.py
    "Convolution1D": ("Convolution1D", (4, 3), dict(activation="relu"), SEQ),
    "Convolution1D-same-stride2": ("Convolution1D", (4, 3),
                                   dict(border_mode="same",
                                        subsample_length=2), SEQ),
    "AtrousConvolution1D": ("AtrousConvolution1D", (4, 2),
                            dict(atrous_rate=2), SEQ),
    "Convolution2D": ("Convolution2D", (4, 3, 2), dict(activation="tanh"),
                      IMG),
    "Convolution2D-same-stride2": ("Convolution2D", (4, 3, 3),
                                   dict(border_mode="same",
                                        subsample=(2, 2)), IMG),
    "Convolution2D-tf-same-stride2": ("Convolution2D", (4, 2, 3),
                                      dict(border_mode="same",
                                           subsample=(2, 2),
                                           dim_ordering="tf"), IMG),
    "AtrousConvolution2D": ("AtrousConvolution2D", (3, 2, 2),
                            dict(atrous_rate=(2, 1)), IMG),
    "ShareConvolution2D": ("ShareConvolution2D", (3, 2, 2), {}, IMG),
    "Convolution3D": ("Convolution3D", (3, 2, 2, 3),
                      dict(border_mode="same"), VOL),
    "Deconvolution2D-valid-stride1": ("Deconvolution2D", (4, 3, 3), {}, IMG),
    "Deconvolution2D-valid-stride2": ("Deconvolution2D", (4, 3, 2),
                                      dict(subsample=(2, 2)), IMG),
    "Deconvolution2D-same-stride1": ("Deconvolution2D", (4, 3, 3),
                                     dict(border_mode="same"), IMG),
    "Deconvolution2D-same-stride2": ("Deconvolution2D", (4, 3, 2),
                                     dict(border_mode="same",
                                          subsample=(2, 2)), IMG),
    "Deconvolution2D-valid-stride3-tf": ("Deconvolution2D", (2, 2, 2),
                                         dict(subsample=(3, 3),
                                              dim_ordering="tf"), IMG),
    "SeparableConvolution2D": ("SeparableConvolution2D", (5, 3, 3),
                               dict(depth_multiplier=2, border_mode="same",
                                    subsample=(2, 2)), IMG),
    "LocallyConnected1D": ("LocallyConnected1D", (4, 3),
                           dict(subsample_length=2), SEQ),
    "LocallyConnected2D": ("LocallyConnected2D", (3, 3, 2),
                           dict(subsample=(2, 1)), IMG),
    "Cropping1D": ("Cropping1D", ((1, 2),), {}, SEQ),
    "Cropping2D": ("Cropping2D", (((1, 0), (2, 1)),), {}, IMG),
    "Cropping3D": ("Cropping3D", (((1, 1), (0, 1), (2, 1)),), {}, VOL),
    "UpSampling1D": ("UpSampling1D", (3,), {}, SEQ),
    "UpSampling2D": ("UpSampling2D", ((2, 3),), {}, IMG),
    "UpSampling3D": ("UpSampling3D", ((1, 2, 2),), dict(dim_ordering="tf"),
                     VOL),
    "ZeroPadding1D": ("ZeroPadding1D", ((1, 2),), {}, SEQ),
    "ZeroPadding2D": ("ZeroPadding2D", ((1, 2, 0, 3),), {}, IMG),
    "ZeroPadding3D": ("ZeroPadding3D", ((1, 0, 2),), {}, VOL),
    # pooling.py
    "MaxPooling1D": ("MaxPooling1D", (), dict(pool_length=3, stride=2,
                                              border_mode="same"), SEQ),
    "AveragePooling1D": ("AveragePooling1D", (), dict(pool_length=3,
                                                      border_mode="same"),
                         SEQ),
    "MaxPooling2D": ("MaxPooling2D", ((3, 2),), dict(border_mode="same"),
                     IMG),
    "AveragePooling2D-same-stride2": ("AveragePooling2D", ((3, 3),),
                                      dict(strides=(2, 2),
                                           border_mode="same"), IMG),
    "MaxPooling3D": ("MaxPooling3D", ((2, 2, 2),), {}, VOL),
    "AveragePooling3D": ("AveragePooling3D", ((2, 2, 2),),
                         dict(dim_ordering="tf"), VOL),
    "GlobalMaxPooling1D": ("GlobalMaxPooling1D", (), {}, SEQ),
    "GlobalAveragePooling1D": ("GlobalAveragePooling1D", (), {}, SEQ),
    "GlobalMaxPooling2D": ("GlobalMaxPooling2D", (), {}, IMG),
    "GlobalAveragePooling2D": ("GlobalAveragePooling2D", (),
                               dict(dim_ordering="tf"), IMG),
    "GlobalMaxPooling3D": ("GlobalMaxPooling3D", (), dict(dim_ordering="tf"),
                           VOL),
    "GlobalAveragePooling3D": ("GlobalAveragePooling3D", (), {}, VOL),
    # recurrent.py: the Keras defaults (hard_sigmoid) take the loop branch
    "SimpleRNN-fused-tanh": ("SimpleRNN", (5,), {}, SEQ),
    "SimpleRNN-fused-relu-seq": ("SimpleRNN", (5,),
                                 dict(activation="relu",
                                      return_sequences=True), SEQ),
    "SimpleRNN-loop-sigmoid-backwards": ("SimpleRNN", (5,),
                                         dict(activation="sigmoid",
                                              go_backwards=True), SEQ),
    "LSTM-loop-hard_sigmoid": ("LSTM", (5,), {}, SEQ),
    "LSTM-loop-backwards-seq": ("LSTM", (5,), dict(go_backwards=True,
                                                   return_sequences=True),
                                SEQ),
    "LSTM-fused-sigmoid": ("LSTM", (5,), dict(inner_activation="sigmoid"),
                           SEQ),
    "LSTM-fused-sigmoid-backwards": ("LSTM", (5,),
                                     dict(inner_activation="sigmoid",
                                          go_backwards=True), SEQ),
    "GRU-loop-hard_sigmoid-seq": ("GRU", (5,), dict(return_sequences=True),
                                  SEQ),
    "GRU-fused-sigmoid": ("GRU", (5,), dict(inner_activation="sigmoid"),
                          SEQ),
    "GRU-fused-sigmoid-backwards-seq": ("GRU", (5,),
                                        dict(inner_activation="sigmoid",
                                             go_backwards=True,
                                             return_sequences=True), SEQ),
    "ConvLSTM2D": ("ConvLSTM2D", (3, 3), {}, (2, 3, 2, 5, 4)),
    "ConvLSTM2D-tf-seq-backwards": ("ConvLSTM2D", (2, 2),
                                    dict(dim_ordering="tf",
                                         return_sequences=True,
                                         go_backwards=True),
                                    (2, 3, 5, 4, 2)),
    # embeddings.py
    "Embedding": ("Embedding", (12, 4), {}, (3, 5), 12),
    "Embedding-one-based-clipped": ("Embedding", (12, 4),
                                    dict(zero_based_id=False,
                                         init_method="normal"), (3, 5), 15),
    "Embedding-frozen": ("Embedding", (12, 4), dict(trainable=False), (3, 5),
                         12),
    "SparseEmbedding": ("SparseEmbedding", (12, 4), {}, (3, 5), 12),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_jax(case):
    cls, args, kwargs, shape, *ints = LAYERS[case]
    x = _x(shape, ints=ints[0] if ints else None)
    _check(getattr(JL, cls)(*args, **kwargs),
           getattr(TL, cls)(*args, **kwargs), x)


WRAPPED = {
    "Bidirectional-LSTM-concat": lambda L: L.Bidirectional(
        L.LSTM(5, inner_activation="sigmoid")),
    "Bidirectional-GRU-sum": lambda L: L.Bidirectional(L.GRU(4), "sum"),
    "Bidirectional-SimpleRNN-mul-seq": lambda L: L.Bidirectional(
        L.SimpleRNN(4, return_sequences=True), "mul"),
    "Bidirectional-GRU-ave": lambda L: L.Bidirectional(
        L.GRU(4, inner_activation="sigmoid"), "ave"),
    "TimeDistributed-Dense": lambda L: L.TimeDistributed(
        L.Dense(3, activation="tanh")),
}


@pytest.mark.parametrize("case", sorted(WRAPPED))
def test_wrapper_matches_jax(case):
    """``Bidirectional`` holds ``layer`` and ``layer_bwd`` as flax names
    them; ``TimeDistributed`` one set of weights over time."""
    _check(WRAPPED[case](JL), WRAPPED[case](TL), _x(SEQ))


def test_aliases_and_exports():
    assert TL.Conv1D is TL.Convolution1D and TL.Conv2D is TL.Convolution2D
    assert TL.Conv3D is TL.Convolution3D
    assert TL.Conv2DTranspose is TL.Deconvolution2D
    assert TL.SeparableConv2D is TL.SeparableConvolution2D
    # the pooling layers take Keras's positional order (the JAX 1-D ones
    # are dataclasses whose first field is pool_fn)
    assert TL.MaxPooling1D(3).pool_length == 3
    assert TL.MaxPooling2D((3, 2)).pool_size == (3, 2)
    jax_names = {n for n in dir(JL) if not n.startswith("_")
                 and isinstance(getattr(JL, n), type)}
    for mod in ("convolutional", "pooling", "recurrent", "embeddings"):
        jmod = __import__(f"analytics_zoo_tpu.pipeline.api.keras.layers.{mod}",
                          fromlist=["_"])
        names = {n for n in jax_names if getattr(JL, n).__module__
                 == jmod.__name__}
        assert names and names <= set(TL.__all__), sorted(names
                                                          - set(TL.__all__))


def test_word_embedding_from_glove_matches_jax(tmp_path):
    """The GloVe reader builds the same matrix and word index; the lookup
    is frozen (no gradient reaches the table) and reads NaN outside it, as
    ``jnp.take`` does."""
    rng = np.random.RandomState(3)
    words = [f"w{i}" for i in range(9)]
    path = tmp_path / "glove.txt"
    path.write_text("".join(
        w + " " + " ".join(f"{v:.5f}" for v in rng.randn(4)) + "\n"
        for w in words))
    index = {w: i + 2 for i, w in enumerate(words[:6])}
    index["missing"] = 1
    jw = JL.WordEmbedding.from_glove(str(path), index)
    tw = TL.WordEmbedding.from_glove(str(path), index)
    np.testing.assert_array_equal(tw.embedding_matrix,
                                  np.asarray(jw.embedding_matrix))
    assert TL.WordEmbedding.get_word_index(str(path)) == \
        JL.WordEmbedding.get_word_index(str(path))
    ids = np.array([[0, 1, 2, 7, 8]], np.int32)
    variables = jw.init(RNGS, jnp.asarray(ids))
    want = np.asarray(jw.apply(variables, jnp.asarray(ids)))
    got = tw(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    out_of_range = tw(torch.tensor([[7, 8]])).numpy()
    assert np.isnan(out_of_range[0, 1]).all() and not np.isnan(
        out_of_range[0, 0]).any()
    assert not got.requires_grad


# --- init statistics -------------------------------------------------------

def _rel_std(a, b):
    return abs(np.std(a) / np.std(b) - 1)


def test_embedding_uniform_init_draws_from_zero_to_scale():
    """flax's ``uniform(scale=0.05)`` draws from [0, 0.05): mean 0.025,
    std 0.05/sqrt(12). 64,000 draws a side; torch's ``nn.Embedding``
    default (N(0, 1)) is the control that misses."""
    jt = np.asarray(JL.Embedding(2000, 32).init(
        RNGS, jnp.zeros((1, 1), jnp.int32))["params"]["embedding"]).ravel()
    torch.manual_seed(0)
    tt = TL.Embedding(2000, 32).embedding.detach().numpy().ravel()
    for t in (jt, tt):
        assert t.min() >= 0.0 and t.max() < 0.05
    assert abs(tt.mean() / jt.mean() - 1) <= 0.02
    assert _rel_std(tt, jt) <= 0.02
    control = torch.nn.Embedding(2000, 32).weight.detach().numpy().ravel()
    assert control.min() < 0.0 and _rel_std(control, jt) > 0.02
    normal = TL.Embedding(2000, 32, init_method="normal").embedding
    assert abs(normal.std().item() / 0.05 - 1) <= 0.02


def test_conv_init_is_lecun_normal_not_glorot():
    """The layers say ``glorot_uniform`` but the JAX code builds ``nn.Conv``
    with flax's ``lecun_normal`` (std 1/sqrt(k * in), truncated at 2 std);
    the port draws that. torch's ``Conv1d`` default (kaiming uniform,
    a=sqrt(5)) is the control that misses."""
    x = jnp.zeros((1, 10, 64))
    jk = np.concatenate([np.asarray(JL.Convolution1D(128, 3).init(
        jax.random.PRNGKey(k), x)["params"]["Conv_0"]["kernel"]).ravel()
        for k in range(4)])
    torch.manual_seed(0)
    tk = []
    for _ in range(4):
        layer = TL.Convolution1D(128, 3)
        layer(torch.zeros(1, 10, 64))
        tk.append(layer.Conv_0.weight.detach().numpy().ravel())
        assert not layer.Conv_0.bias.detach().any()
    tk = np.concatenate(tk)
    std = 1.0 / np.sqrt(3 * 64)
    assert _rel_std(tk, jk) <= 0.02 and abs(tk.std() / std - 1) <= 0.02
    assert np.abs(tk).max() <= 2 * std / 0.87962566103423978 + 1e-6
    control = np.concatenate([torch.nn.Conv1d(64, 128, 3).weight.detach()
                              .numpy().ravel() for _ in range(4)])
    assert _rel_std(control, jk) > 0.02


def test_recurrent_kernels_are_orthogonal_inputs_lecun():
    """flax's cells draw each hidden kernel orthogonal ``(h, h)`` and each
    input kernel ``lecun_normal``; torch's ``nn.LSTM`` default (uniform
    +-1/sqrt(h)) is the control that misses."""
    h = 64
    torch.manual_seed(0)
    for cell in (trec.LSTMCell(32, h), trec.GRUCell(32, h),
                 trec.SimpleCell(32, h)):
        names = [n for n, _ in cell.named_children()]
        for name in names:
            w = getattr(cell, name).weight.detach().double().numpy()
            if name.startswith("h"):
                np.testing.assert_allclose(w @ w.T, np.eye(h), atol=1e-5)
            else:
                assert abs(w.std() * np.sqrt(32) - 1) <= 0.06
    jp = JL.LSTM(h).init(RNGS, jnp.zeros((1, 2, 32)))["params"]["LSTMCell_0"]
    jk = np.asarray(jp["hf"]["kernel"], np.float64)
    np.testing.assert_allclose(jk.T @ jk, np.eye(h), atol=1e-5)
    control = torch.nn.LSTM(32, h).weight_hh_l0.detach().double()[:h].numpy()
    assert np.abs(control @ control.T - np.eye(h)).max() > 0.1


def test_locally_connected_init_is_glorot_uniform():
    """``LocallyConnected1D`` draws flax's ``glorot_uniform`` over its
    ``(L, k * dim, out)`` kernel (both fans count the L positions); a
    Dense-style glorot over ``(k * dim, out)`` alone is the control."""
    x = jnp.zeros((1, 34, 16))
    jk = np.asarray(JL.LocallyConnected1D(32, 3).init(
        RNGS, x)["params"]["kernel"]).ravel()
    torch.manual_seed(0)
    layer = TL.LocallyConnected1D(32, 3)
    layer(torch.zeros(1, 34, 16))
    tk = layer.weight.detach().numpy().ravel()
    limit = np.sqrt(6.0 / (32 * 48 + 32 * 32))
    assert jk.size == tk.size == 32 * 48 * 32
    assert np.abs(tk).max() <= limit and _rel_std(tk, jk) <= 0.02
    control = np.random.RandomState(0).uniform(
        -np.sqrt(6.0 / 80), np.sqrt(6.0 / 80), tk.size)
    assert _rel_std(control, jk) > 0.02

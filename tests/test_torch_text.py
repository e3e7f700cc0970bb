"""The port's text input and text models against the JAX package's, on the
CPU: ``feature/text/text_set.py``, ``TextClassifier``, ``KNRM``,
``Seq2Seq`` and the tfpark taggers (``NER``, ``POSTagger``,
``IntentEntity``).

* TextSet: tokens, word index, index arrays, ``shape_sequence`` (both
  ``trunc_mode``s), ``random_split``, the relation builders, the readers
  and the word-index files equal the JAX package's, value for value.
* Models: flax's init is bridged into the port's module with ``interop``
  (and back onto the same flax tree, byte for byte); forwards agree within rtol/atol 1e-5 (f32, TF32 off on the port's side,
  JAX at ``highest`` precision). Fits run a few steps on both sides over
  the same unshuffled batches from the bridged weights: per-epoch losses,
  the trained parameters and predictions within rtol/atol 1e-4 (a few
  steps of f32 rounding on two frameworks). The models' fixed dropout
  (TextClassifier's 0.2) is set to 0 on both sides for the fits, since the
  two packages' generators draw different masks.
* ``Seq2Seq.infer``'s tokens equal JAX's; a frozen pretrained table is
  bit-equal after ``fit`` on both sides.
"""

import os
import pickle

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.feature.text import text_set as jts
from analytics_zoo_tpu.models.seq2seq import seq2seq as js2s
from analytics_zoo_tpu.models.textclassification import \
    text_classifier as jtc
from analytics_zoo_tpu.models.textmatching import knrm as jknrm
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu.tfpark.text import keras as jtag
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.feature.text import text_set as tts
from analytics_zoo_tpu_torch.models.seq2seq import seq2seq as ts2s
from analytics_zoo_tpu_torch.models.textclassification import \
    text_classifier as ttc
from analytics_zoo_tpu_torch.models.textmatching import knrm as tknrm
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt
from analytics_zoo_tpu_torch.tfpark.text import keras as ttag

TOL = dict(rtol=1e-5, atol=1e-5)
FIT_TOL = dict(rtol=1e-4, atol=1e-4)
# one step a dispatch: the fused path is the same trajectory (held in
# tests/test_torch_fused_dispatch.py), and its probe would compile more
ONE_STEP = {"steps_per_dispatch": 1}
RNGS = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}

WORDS = ["alpha", "Beta", "gamma's", "delta", "eps-ilon", "zeta", "eta!",
         "theta", "iota", "kappa", "lambda", "mu", "Nu", "xi", "o_mi"]


def _corpus(n=40, seed=0):
    rng = np.random.RandomState(seed)
    texts = []
    for _ in range(n):
        k = rng.randint(3, 15)
        toks = [WORDS[i] for i in rng.zipf(1.5, k) % len(WORDS)]
        texts.append(" ".join(toks) + rng.choice([".", "?!", " ,", ""]))
    return texts, list(rng.randint(0, 3, n))


def _both(fn):
    """fn(module) for the JAX and the port's text_set module."""
    return fn(jts), fn(tts)


def _indices(ts):
    return [f.indices.tolist() for f in ts.features]


# --- TextSet ------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(remove_topN=2, max_words_num=6), dict(min_freq=3),
    dict(existing_map={"alpha": 7, "mu": 1})],
    ids=["plain", "topN-max", "min_freq", "existing_map"])
def test_textset_pipeline_equals_jax(kw):
    """tokenize -> normalize -> word2idx -> shape_sequence: equal tokens,
    word index (ids and their order) and index arrays; both trunc modes."""
    texts, labels = _corpus()
    j, t = _both(lambda m: m.TextSet.from_texts(texts, labels)
                 .tokenize().normalize().word2idx(**kw))
    assert [f.tokens for f in t.features] == [f.tokens for f in j.features]
    assert list(t.get_word_index().items()) == \
        list(j.get_word_index().items())
    assert _indices(t) == _indices(j)
    for mode in ("pre", "post"):
        js_, ts_ = _both(lambda m: m.TextSet.from_texts(texts, labels)
                         .tokenize().normalize().word2idx(**kw)
                         .shape_sequence(6, trunc_mode=mode)
                         .generate_sample())
        (jx, jy), (tx, ty) = js_.to_arrays(), ts_.to_arrays()
        assert tx.dtype == jx.dtype and tx.tobytes() == jx.tobytes()
        assert ty.tolist() == jy.tolist()
        assert [s["x"].tolist() for s in ts_.get_samples()] == \
            [s["x"].tolist() for s in js_.get_samples()]


def test_textset_split_relations_and_accessors_equal_jax():
    texts, labels = _corpus(30)
    j, t = _both(lambda m: m.TextSet.from_texts(texts, labels).tokenize()
                 .normalize().word2idx())
    for a, b in zip(t.random_split([0.8, 0.2]), j.random_split([0.8, 0.2])):
        assert a.get_texts() == b.get_texts()
        assert a.get_word_index() == b.get_word_index()
    q = [f"q{i}" for i in range(5)]
    d = [f"d{i}" for i in range(12)]
    rng = np.random.RandomState(1)
    relations = [(qi, di, int(rng.rand() < 0.3)) for qi in q
                 for di in rng.choice(d, 5, replace=False)]

    def corpora(m):
        c1 = m.TextSet([m.TextFeature(texts[i], uri=u)
                        for i, u in enumerate(q)])
        c2 = m.TextSet([m.TextFeature(texts[10 + i], uri=u)
                        for i, u in enumerate(d)])
        for c, n in ((c1, 3), (c2, 5)):
            c.tokenize().normalize().word2idx(
                existing_map=j.get_word_index()).shape_sequence(n)
        return (m.TextSet.from_relation_pairs(relations, c1, c2),
                m.TextSet.from_relation_lists(relations, c1, c2))
    (jp, jl), (tp, tl) = _both(corpora)
    assert tp.get_uris() == jp.get_uris() and len(tp.features) > 0
    assert _indices(tp) == _indices(jp)
    assert tp.get_labels() == jp.get_labels()
    assert _indices(tl) == _indices(jl)
    assert [f.label.tolist() for f in tl.features] == \
        [f.label.tolist() for f in jl.features]
    local = tts.LocalTextSet(texts[:3], labels[:3])
    assert local.get_texts() == texts[:3] and local.is_local()
    assert not local.is_distributed() and local.to_local() is local
    assert sum(len(p) for p in local.to_distributed(2).collect()) == 3
    assert local.features[0].keys() == ["text", "label"]


def test_textset_readers_and_word_index_files_equal_jax(tmp_path):
    """``read`` over news20's layout, ``read_csv`` over uri,text rows,
    ``read_parquet`` over a uri/text table, and word-index pickles that
    each package's loader reads from the other."""
    texts, _ = _corpus(12)
    for c, cat in enumerate(["comp.graphics", "alt.atheism", "sci.med"]):
        os.makedirs(tmp_path / "news" / cat)
        for i in range(4):
            (tmp_path / "news" / cat / f"{5 - i}").write_text(
                texts[4 * c + i])
    (tmp_path / "news" / "README").write_text("not a category")
    j, t = _both(lambda m: m.TextSet.read(str(tmp_path / "news")))
    assert t.get_texts() == j.get_texts() and t.get_uris() == j.get_uris()
    assert t.get_labels() == j.get_labels()
    csv_path = tmp_path / "texts.csv"
    csv_path.write_text("".join(f'u{i},"{s}"\n' for i, s in
                                enumerate(texts)))
    j, t = _both(lambda m: m.TextSet.read_csv(str(csv_path)))
    assert t.get_texts() == j.get_texts() and t.get_uris() == j.get_uris()
    j.tokenize().normalize().word2idx()
    j.save_word_index(str(tmp_path / "jax.pkl"))
    t.load_word_index(str(tmp_path / "jax.pkl"))
    assert t.get_word_index() == j.get_word_index()
    t.save_word_index(str(tmp_path / "port.pkl"))
    with open(tmp_path / "port.pkl", "rb") as f:
        assert pickle.load(f) == j.get_word_index()
    import pandas as pd
    pq_path = str(tmp_path / "texts.parquet")
    pd.DataFrame({"uri": [f"u{i}" for i in range(len(texts))],
                  "text": texts}).to_parquet(pq_path)
    j, t = _both(lambda m: m.TextSet.read_parquet(pq_path))
    assert t.get_texts() == j.get_texts() == texts
    assert t.get_uris() == j.get_uris()


# --- shared helpers -------------------------------------------------------------

def _bridge(jmod, tmod, *xs):
    """flax's init of ``jmod`` into ``tmod``; the port's state maps back
    onto the same flax tree, byte for byte."""
    variables = jax.device_get(jax.jit(jmod.init)(
        RNGS, *map(jnp.asarray, xs)))
    interop.load_flax_params(tmod, dict(variables))
    _round_trip(variables["params"], tmod)
    return variables


def _round_trip(params, tmod):
    back = interop.state_dict_to_flax(tmod.state_dict(), tmod)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), path


def _forward_matches(jmod, tmod, *xs, tol=TOL):
    variables = _bridge(jmod, tmod, *xs)
    want = np.asarray(jax.jit(jmod.apply)(variables, *map(jnp.asarray, xs)))
    tmod.eval()
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, xs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)


def _carry(jzoo, tzoo, sample):
    """The JAX estimator's initial params into the port's module."""
    jzoo.estimator.engine.build(tuple(a[:1] for a in sample))
    interop.load_flax_params(tzoo.module,
                             jax.device_get(jzoo.estimator.engine.params))


def _params_match(jparams, tmodule, tol=FIT_TOL, frozen=()):
    want = interop.flax_to_state_dict(jax.device_get(jparams))
    got = tmodule.state_dict()
    assert set(want) == set(got)
    for name in want:
        if name in frozen:
            assert got[name].numpy().tobytes() == want[name].numpy().tobytes()
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


def _fits_match(jfit, tfit):
    js, ts = jfit(), tfit()
    np.testing.assert_allclose([s["train_loss"] for s in ts],
                               [s["train_loss"] for s in js], **FIT_TOL)


@pytest.fixture()
def no_dropout(monkeypatch):
    """flax's ``Dropout`` at rate 0 for the test (the JAX models fix their
    rates in the code)."""
    real = fnn.Dropout
    monkeypatch.setattr(fnn, "Dropout",
                        lambda rate, *a, **kw: real(0.0, *a, **kw))


# --- TextClassifier -------------------------------------------------------------

def _tc_kwargs(encoder, matrix):
    kw = dict(class_num=4, sequence_length=12, encoder=encoder,
              encoder_output_dim=6)
    if matrix:
        kw["embedding_matrix"] = np.random.RandomState(5).randn(
            30, 8).astype(np.float32)
    else:
        kw.update(vocab_size=30, embed_dim=8)
    return kw


@pytest.mark.parametrize("encoder,matrix", [
    ("cnn", False), ("cnn", True), ("lstm", False), ("gru", False),
    ("gru", True)])
def test_text_classifier_forward_matches_jax(encoder, matrix):
    """The three encoders, the MXUEmbed table and the frozen matrix (ids
    beyond it read its last row, as JAX's indexing clamps)."""
    ids = np.random.RandomState(0).randint(0, 34, (3, 12)).astype(np.int32)
    kw = _tc_kwargs(encoder, matrix)
    _forward_matches(jtc.TextClassifierNet(**kw), ttc.TextClassifierNet(**kw),
                     ids)


@pytest.mark.parametrize("encoder,matrix", [
    ("cnn", True), ("lstm", False), ("gru", False)])
def test_text_classifier_fit_matches_jax(orca_context, no_dropout, encoder,
                                         matrix):
    """news20's training setup (sparse categorical cross-entropy, Adagrad
    at lr 0.01) for 2 epochs of 2 steps; the frozen matrix stays bit-equal
    to what it was on both sides."""
    rng = np.random.RandomState(1)
    x = rng.randint(0, 30, (32, 12)).astype(np.int32)
    y = rng.randint(0, 4, 32).astype(np.int32)
    kw = _tc_kwargs(encoder, matrix)
    jm = jtc.TextClassifier(**kw)
    tm = ttc.TextClassifier(**kw, device="cpu")
    tm.module.dropout.p = 0.0
    jm.compile(loss="sparse_categorical_crossentropy",
               optimizer=jopt.Adagrad(learningrate=0.01),
               config=dict(ONE_STEP))
    tm.compile(loss="sparse_categorical_crossentropy",
               optimizer=topt.Adagrad(learningrate=0.01),
               config=dict(ONE_STEP))
    _carry(jm, tm, (x,))
    frozen = {"embedding"} if matrix else set()
    before = {k: v.clone() for k, v in tm.module.state_dict().items()}
    fit = dict(epochs=2, batch_size=16, shuffle=False, verbose=False)
    _fits_match(lambda: jm.fit({"x": x, "y": y}, **fit),
                lambda: tm.fit({"x": x, "y": y}, **fit))
    _params_match(jm.estimator.engine.params, tm.module, frozen=frozen)
    if matrix:
        assert tm.module.embedding.numpy().tobytes() == \
            before["embedding"].numpy().tobytes()
        assert np.asarray(jm.estimator.engine.params["embedding"]
                          ).tobytes() == before["embedding"].numpy().tobytes()
    np.testing.assert_allclose(tm.predict(x[:8]), np.asarray(jm.predict(
        x[:8])), **FIT_TOL)


def test_text_classifier_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tctx, "_current", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttc.TextClassifier(class_num=2, vocab_size=10, embed_dim=4,
                           encoder_output_dim=4).compile()
    ttc.TextClassifier(class_num=2, vocab_size=10, embed_dim=4,
                       encoder_output_dim=4, device="cpu").compile()


# --- KNRM -----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ranking", "classification"])
def test_knrm_forward_matches_jax(mode):
    """Ids beyond the table clamp to its last row, as JAX's indexing."""
    ids = np.random.RandomState(0).randint(0, 45, (3, 12)).astype(np.int32)
    kw = dict(text1_length=4, text2_length=8, vocab_size=40, embed_size=8,
              target_mode=mode, kernel_num=11)
    _forward_matches(jknrm.KNRMNet(**kw), tknrm.KNRMNet(**kw), ids)


def test_knrm_fit_and_ranking_metrics_match_jax(orca_context):
    rng = np.random.RandomState(2)
    x = rng.randint(1, 40, (32, 12)).astype(np.int32)
    y = (rng.rand(32, 1) > 0.5).astype(np.float32)
    kw = dict(text1_length=4, text2_length=8, vocab_size=40, embed_size=8,
              target_mode="classification")
    jm, tm = jknrm.KNRM(**kw), tknrm.KNRM(**kw, device="cpu")
    jm.compile(loss="binary_crossentropy",
               optimizer=jopt.SGD(learningrate=0.5), config=dict(ONE_STEP))
    tm.compile(loss="binary_crossentropy",
               optimizer=topt.SGD(learningrate=0.5), config=dict(ONE_STEP))
    _carry(jm, tm, (x,))
    fit = dict(epochs=2, batch_size=16, shuffle=False, verbose=False)
    _fits_match(lambda: jm.fit({"x": x, "y": y}, **fit),
                lambda: tm.fit({"x": x, "y": y}, **fit))
    _params_match(jm.estimator.engine.params, tm.module)
    for k in (3, 5):
        assert tm.evaluate_ndcg(x, y, k) == pytest.approx(
            jm.evaluate_ndcg(x, y, k), abs=1e-6)
    assert tm.evaluate_map(x, y) == pytest.approx(jm.evaluate_map(x, y),
                                                  abs=1e-6)


def test_knrm_init_draws_from_zero_to_scale():
    """flax's ``uniform(scale=0.1)``: [0, 0.1), mean 0.05; torch's
    ``nn.init.uniform_`` default (U[0, 1)) is the control that misses."""
    jt = np.asarray(jknrm.KNRMNet(text1_length=2, text2_length=2,
                                  vocab_size=2000, embed_size=32).init(
        RNGS, jnp.zeros((1, 4), jnp.int32))["params"]["embedding"]).ravel()
    torch.manual_seed(0)
    tt = tknrm.KNRMNet(2, 2, vocab_size=2000, embed_size=32).embedding
    tt = tt.detach().numpy().ravel()
    for t in (jt, tt):
        assert t.min() >= 0.0 and t.max() < 0.1
    assert abs(tt.mean() / jt.mean() - 1) <= 0.02
    assert abs(tt.std() / jt.std() - 1) <= 0.02
    control = torch.nn.init.uniform_(torch.empty(2000, 32)).numpy()
    assert abs(control.std() / jt.std() - 1) > 0.02


# --- Seq2Seq --------------------------------------------------------------------

S2S = {"lstm-2-dense": dict(rnn_type="lstm", nlayers=2, bridge="dense"),
       "gru-1": dict(rnn_type="gru", nlayers=1),
       "simplernn-1": dict(rnn_type="simplernn", nlayers=1)}


def _s2s_data(n=16, seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(1, 20, (n, 7)).astype(np.int32)
    tgt_in = rng.randint(1, 25, (n, 5)).astype(np.int32)
    tgt_out = rng.randint(0, 25, (n, 5)).astype(np.int32)
    return src, tgt_in, tgt_out


@pytest.mark.parametrize("case", sorted(S2S))
def test_seq2seq_forward_matches_jax(case):
    kw = dict(hidden_size=8, src_vocab=20, tgt_vocab=25, embed_dim=6,
              **S2S[case])
    src, tgt_in, _ = _s2s_data(3)
    _forward_matches(js2s.Seq2SeqNet(**kw), ts2s.Seq2SeqNet(**kw), src,
                     tgt_in)


@pytest.mark.parametrize("case", ["lstm-2-dense", "gru-1"])
def test_seq2seq_fit_and_infer_match_jax(orca_context, case):
    """Adam for 2 epochs of 2 steps, then ``infer``: tokens equal to JAX's
    (the trained weights agree to FIT_TOL; the greedy argmax sees the
    same order)."""
    kw = dict(hidden_size=16, src_vocab=20, tgt_vocab=25, embed_dim=8,
              **S2S[case])
    src, tgt_in, tgt_out = _s2s_data(32)
    jm, tm = js2s.Seq2Seq(**kw), ts2s.Seq2Seq(**kw, device="cpu")
    for m in (jm, tm):
        m.compile(loss="sparse_categorical_crossentropy", optimizer="adam",
                  config=dict(ONE_STEP))
    _carry(jm, tm, (src, tgt_in))
    fit = dict(epochs=2, batch_size=16, shuffle=False, verbose=False)
    data = {"x": (src, tgt_in), "y": tgt_out}
    _fits_match(lambda: jm.fit(data, **fit), lambda: tm.fit(data, **fit))
    _params_match(jm.estimator.engine.params, tm.module)
    want = jm.infer(src[:8], start_sign=1, max_seq_len=9)
    got = tm.infer(src[:8], start_sign=1, max_seq_len=9)
    assert got.dtype == np.int32 and got.tolist() == want.tolist()
    assert (got[:, 0] == 1).all()


# --- tfpark taggers -------------------------------------------------------------

def _tagger_data(n=16, seed=0, chars=True):
    rng = np.random.RandomState(seed)
    words = rng.randint(1, 30, (n, 7)).astype(np.int32)
    tags = (words % 4 + 1).astype(np.int32)
    tags[:, -2:] = 0                         # padded tokens
    xs = (words, rng.randint(1, 12, (n, 7, 5)).astype(np.int32)) \
        if chars else (words,)
    return xs, tags


@pytest.mark.parametrize("chars", [True, False], ids=["chars", "words"])
def test_tagger_forward_matches_jax(chars):
    kw = dict(vocab_size=30, num_tags=5, word_emb_dim=8,
              char_vocab_size=12 if chars else 0, char_emb_dim=4,
              lstm_units=6, dropout=0.0)
    xs, _ = _tagger_data(3, chars=chars)
    _forward_matches(jtag._TaggerNet(**kw), ttag._TaggerNet(**kw), *xs)


def test_intent_entity_forward_matches_jax():
    kw = dict(vocab_size=30, num_intents=3, num_entities=5, word_emb_dim=8,
              lstm_units=6, dropout=0.0)
    (words,), _ = _tagger_data(3, chars=False)
    _forward_matches(jtag._IntentEntityNet(**kw),
                     ttag._IntentEntityNet(**kw), words)


def test_ner_and_intent_entity_fits_match_jax(orca_context, tmp_path):
    """NER over words and characters (the token loss masks label 0) and
    IntentEntity's packed loss, 2 epochs of Adam each; a POSTagger saved
    by the port loads into a fresh one with equal predictions."""
    (words, chars), tags = _tagger_data(32, seed=1)
    kw = dict(num_tags=5, vocab_size=30, char_vocab_size=12,
              word_emb_dim=8, char_emb_dim=4, lstm_units=6, dropout=0.0)
    jn, tn = jtag.NER(**kw), ttag.NER(**kw, device="cpu")
    for est in (jn.estimator, tn.estimator):
        est.config.update(ONE_STEP)
    jn.estimator.engine.build((words[:1], chars[:1]))
    interop.load_flax_params(tn.module,
                             jax.device_get(jn.estimator.engine.params))
    fit = dict(batch_size=16, epochs=2, shuffle=False, verbose=False)
    _fits_match(lambda: jn.fit((words, chars), tags, **fit),
                lambda: tn.fit((words, chars), tags, **fit))
    _params_match(jn.estimator.engine.params, tn.module)
    intents = (words[:, 0] % 3).astype(np.int32)
    kw = dict(num_intents=3, num_entities=5, vocab_size=30, word_emb_dim=8,
              lstm_units=6, dropout=0.0)
    ji, ti = jtag.IntentEntity(**kw), ttag.IntentEntity(**kw, device="cpu")
    for est in (ji.estimator, ti.estimator):
        est.config.update(ONE_STEP)
    ji.estimator.engine.build((words[:1],))
    interop.load_flax_params(ti.module,
                             jax.device_get(ji.estimator.engine.params))
    _fits_match(lambda: ji.fit(words, intents, tags, **fit),
                lambda: ti.fit(words, intents, tags, **fit))
    _params_match(ji.estimator.engine.params, ti.module)
    for a, b in zip(ti.predict(words[:8], batch_size=8),
                    ji.predict(words[:8], batch_size=8)):
        assert a.tolist() == b.tolist()
    pos = ttag.POSTagger(num_tags=5, vocab_size=30, lstm_units=6,
                         dropout=0.0, device="cpu")
    pos.fit(words, tags, batch_size=16, epochs=1, verbose=False)
    path = pos.save_model(str(tmp_path / "pos.pt"))
    again = ttag.POSTagger(num_tags=5, vocab_size=30, lstm_units=6,
                           dropout=0.0, device="cpu")
    again.fit(words[:16], tags[:16], batch_size=16, epochs=1, verbose=False)
    again.load_model(path)
    assert again.predict(words[:8]).tolist() == pos.predict(words[:8]).tolist()

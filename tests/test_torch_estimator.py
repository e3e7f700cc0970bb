"""The port's training path (analytics_zoo_tpu_torch.orca.learn, the BERT
estimators) against the JAX package's, on the CPU.

The slice as a whole: a tiny BERT classifier with the flash strategy and
every dropout at 0 is built by the JAX ``TPUEstimator`` (flax init), its
parameters are bridged into the port's module with ``interop``, and both
estimators fit the same batches in the same order (``shuffle=False``,
``steps_per_epoch`` given so that the JAX estimator keeps its per-step
loop). On the JAX side the flash forward and backward are the Pallas
kernels in interpret mode; on the port's, the kernels' plain versions.

Tolerances. SGD: per-epoch losses, evaluate and predict at rtol/atol 2e-4
(tests/test_attention.py's f32 tolerance), and the final parameters at the
same 2e-4: both sides compute in f32 with full-precision matmuls, and the
embedding tables' one-hot backward rounds the cotangents to bf16 on both
sides alike. Adam: the losses only, at the same 2e-4. Adam divides by the
root of the second moment, so a parameter whose gradient is near 0 moves by
~lr whatever the gradient's last bits are: the two frameworks' rounding
differences in such gradients show in the parameters (1e-3 apart after 4
steps of lr 1e-3), while the losses stay within 1e-6.
"""

import json
import os
from functools import partial

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.orca.learn import losses as jlosses
from analytics_zoo_tpu.orca.learn.estimator import TPUEstimator as JEstimator
from analytics_zoo_tpu.orca.learn.optimizers import optimizers_impl as jopt
from analytics_zoo_tpu.tfpark.text import estimator as jtext
from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.orca.learn import losses as tlosses
from analytics_zoo_tpu_torch.orca.learn import utils as tutils
from analytics_zoo_tpu_torch.orca.learn.estimator import \
    TPUEstimator as TEstimator
from analytics_zoo_tpu_torch.orca.learn.optimizers import \
    optimizers_impl as topt
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
    self_attention as tattn
from analytics_zoo_tpu_torch.tfpark.text import estimator as ttext

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dict(vocab=100, hidden_size=32, n_block=2, n_head=2, seq_len=16,
            intermediate_size=64)


def _data(n=32, s=16, vocab=100, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (n, s)).astype(np.int32)
    return ids, (ids[:, 0] % 3).astype(np.int32)


def _pair(optimizer):
    """The JAX estimator (built, flax-initialised) and the port's, holding
    the same weights."""
    cfg = tuple(sorted(dict(TINY, hidden_p_drop=0.0, attn_p_drop=0.0,
                            strategy="flash").items()))
    jm = jtext._BertWithHead(bert_kwargs=cfg, num_out=3, head_drop=0.0)
    jest = JEstimator(
        jm, loss=partial(jlosses.sparse_categorical_crossentropy,
                         from_logits=True),
        optimizer=getattr(jopt, optimizer[0])(**optimizer[1]),
        metrics=["sparse_categorical_accuracy"])
    ids, _ = _data()
    jest.engine.build((ids[:1],))
    params = jax.device_get(jest.engine.params)
    tm = interop.load_flax_params(
        ttext._BertWithHead(cfg, num_out=3, head_drop=0.0), params)
    test = TEstimator(
        tm, loss=partial(tlosses.sparse_categorical_crossentropy,
                         from_logits=True),
        optimizer=getattr(topt, optimizer[0])(**optimizer[1]),
        metrics=["sparse_categorical_accuracy"], device="cpu")
    return jest, test


@pytest.mark.parametrize("optimizer,clip", [
    (("SGD", dict(learningrate=0.1, momentum=0.9)), False),
    (("SGD", dict(learningrate=0.1, momentum=0.9)), True),
    (("Adam", dict(lr=1e-3)), False),
])
def test_tiny_bert_fit_matches_jax(orca_context, optimizer, clip):
    jest, test = _pair(optimizer)
    if clip:        # global-norm clipping, then clipping by value
        for est in (jest, test):
            est.set_l2_norm_gradient_clipping(0.5)
            est.set_constant_gradient_clipping(-0.01, 0.01)
    ids, labels = _data()
    data = {"x": ids, "y": labels}
    kw = dict(epochs=2, batch_size=16, steps_per_epoch=2, shuffle=False,
              verbose=False)
    jstats = jest.fit(data, **kw)
    tstats = test.fit(data, **kw)
    assert [s["epoch"] for s in tstats] == [s["epoch"] for s in jstats]
    assert [s["num_samples"] for s in tstats] == [32, 32]
    jl = [s["train_loss"] for s in jstats]
    tl = [s["train_loss"] for s in tstats]
    np.testing.assert_allclose(tl, jl, **TOL)
    if optimizer[0] == "Adam":
        return
    # 24 rows: the second batch is padded and masked
    part = {"x": ids[:24], "y": labels[:24]}
    jev = jest.evaluate(part, batch_size=16, verbose=False)
    tev = test.evaluate(part, batch_size=16, verbose=False)
    assert tev["num_samples"] == 24
    assert set(tev) == set(jev)
    for key in jev:
        np.testing.assert_allclose(tev[key], jev[key], **TOL)
    np.testing.assert_allclose(test.predict(ids[:20], batch_size=16),
                               np.asarray(jest.predict(ids[:20],
                                                       batch_size=16)),
                               **TOL)
    want = interop.flax_to_state_dict(jax.device_get(jest.engine.params))
    got = test.get_model()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   err_msg=key, **TOL)


# --- CPU twins of tests/test_tfpark_text.py: API and shapes ---------------

TINY_BERT = dict(TINY, strategy="full")


def _token_batch(n=32, s=16, vocab=100, seed=0):
    return np.random.RandomState(seed).randint(1, vocab, (n, s)).astype(
        np.int32)


def test_bert_classifier_fit_predict():
    ids = _token_batch()
    labels = (ids[:, 0] % 3).astype(np.int32)
    est = ttext.BERTClassifier(num_classes=3, bert_config=TINY_BERT,
                               device="cpu")
    data = ttext.bert_input_fn({"input_ids": ids}, labels)
    stats = est.fit(data, epochs=2, batch_size=16, verbose=False)
    assert np.isfinite(stats[-1]["train_loss"])
    logits = est.predict(ids, batch_size=16)
    assert logits.shape == (32, 3)
    ev = est.evaluate(data, batch_size=16)
    assert "sparse_categorical_accuracy" in ev


def test_bert_ner_token_tagging():
    ids = _token_batch()
    tags = (ids % 5).astype(np.int32)
    est = ttext.BERTNER(num_entities=5, bert_config=TINY_BERT, device="cpu")
    stats = est.fit(ttext.bert_input_fn({"input_ids": ids}, tags),
                    epochs=2, batch_size=16, verbose=False)
    assert np.isfinite(stats[-1]["train_loss"])
    assert est.predict(ids, batch_size=16).shape == (32, 16, 5)


def test_bert_squad_span_head():
    ids = _token_batch()
    spans = np.stack([np.full(32, 2), np.full(32, 5)], -1).astype(np.int32)
    est = ttext.BERTSQuAD(bert_config=TINY_BERT, device="cpu")
    stats = est.fit(ttext.bert_input_fn({"input_ids": ids}, spans),
                    epochs=1, batch_size=16, verbose=False)
    assert np.isfinite(stats[-1]["train_loss"])
    assert est.predict(ids, batch_size=16).shape == (32, 16, 2)


def test_squad_loss_matches_jax():
    rng = np.random.RandomState(5)
    logits = rng.randn(4, 16, 2).astype(np.float32)
    spans = rng.randint(0, 16, (4, 2)).astype(np.int32)
    want = np.asarray(jtext._squad_loss(spans, logits))
    got = ttext._squad_loss(torch.from_numpy(spans), torch.from_numpy(logits))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bert_config_file_parsing(tmp_path):
    cfg = {"vocab_size": 64, "hidden_size": 16, "num_hidden_layers": 1,
           "num_attention_heads": 2, "max_position_embeddings": 8,
           "intermediate_size": 32}
    path = tmp_path / "bert_config.json"
    path.write_text(json.dumps(cfg))
    est = ttext.BERTClassifier(num_classes=2, bert_config_file=str(path),
                               strategy="full", device="cpu")
    bert = est.module.bert
    assert bert.token_embedding.embedding.shape == (64, 16)
    assert bert.position_embedding.shape == (8, 16)
    assert len(bert._blocks) == 1
    ids = _token_batch(n=8, s=8, vocab=64)
    assert est.predict(ids, batch_size=8).shape == (8, 2)


def test_save_load_round_trip(tmp_path):
    ids = _token_batch(n=16)
    labels = (ids[:, 0] % 2).astype(np.int32)
    est = ttext.BERTClassifier(num_classes=2, bert_config=TINY_BERT,
                               device="cpu")
    est.fit({"x": ids, "y": labels}, epochs=1, batch_size=8, verbose=False)
    path = est.save(str(tmp_path / "bert.pt"))
    again = ttext.BERTClassifier(num_classes=2, bert_config=TINY_BERT,
                                 init_checkpoint=path, device="cpu")
    np.testing.assert_array_equal(again.predict(ids), est.predict(ids))
    assert again.engine.step == est.engine.step == 2


class _JaxLinear(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(1)(x)


def _linear_pair(optimizer):
    """A one-layer regression on each side, with ``optimizer(module)`` (the
    JAX or the port's optimizers_impl) and the same 64 rows."""
    x = np.random.RandomState(0).randn(64, 4).astype(np.float32)
    data = {"x": x, "y": x.sum(1, keepdims=True)}
    jest = JEstimator(_JaxLinear(), loss="mse", optimizer=optimizer(jopt))
    test = TEstimator(torch.nn.Linear(4, 1), loss="mse",
                      optimizer=optimizer(topt), device="cpu")
    return jest, test, data


def test_planes_not_ported_raise(orca_context, tmp_path):
    """The planes that raised "not ported yet" behave as the JAX
    estimator's. ``profile=<dir>``: both packages add the per-epoch
    profile stats to every epoch and trace only the first epoch into the
    directory (JAX one xplane run, the port one torch chrome trace holding
    epoch 0's four optimizer steps of the eight). ``LBFGS`` constructs
    with the JAX class's fields and fails the first step of a fit in both
    packages with a ``TypeError``: optax's line search misses ``value``,
    ``grad`` and ``value_fn``, torch's LBFGS its ``closure``."""
    jest, test, data = _linear_pair(lambda m: "adam")
    kw = dict(epochs=2, batch_size=16, shuffle=False, verbose=False)
    jstats = jest.fit(data, profile=str(tmp_path / "jax"), **kw)
    tstats = test.fit(data, profile=str(tmp_path / "port"), **kw)
    for j, t in zip(jstats, tstats):
        assert set(j["profile"]) < set(t["profile"])
        assert t["profile"]["steps"] == j["profile"]["steps"] == 4
    runs = os.listdir(tmp_path / "jax" / "plugins" / "profile")
    assert len(runs) == 1
    traces = os.listdir(tmp_path / "port")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(tmp_path / "port" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("Optimizer.step#")]
    assert len(steps) == 4
    for kwargs in ({}, {"max_iter": 5}):
        j_lbfgs, t_lbfgs = jopt.LBFGS(**kwargs), topt.LBFGS(**kwargs)
        assert (t_lbfgs.max_iter, t_lbfgs.lr) == (j_lbfgs.max_iter,
                                                  j_lbfgs.lr)
        jest, test, data = _linear_pair(lambda m: m.LBFGS(**kwargs))
        with pytest.raises(TypeError, match="value_fn"):
            jest.fit(data, batch_size=16, verbose=False)
        with pytest.raises(TypeError, match="closure"):
            test.fit(data, batch_size=16, verbose=False)


def test_from_jax_is_from_keras(orca_context):
    """``Estimator.from_jax(module, **kw)`` is ``from_keras(model=module,
    **kw)`` in both packages: the same estimator, trained the same."""
    from analytics_zoo_tpu.orca.learn.estimator import Estimator as JEst
    from analytics_zoo_tpu_torch.orca.learn.estimator import Estimator
    x = np.random.RandomState(1).randn(32, 4).astype(np.float32)
    data = {"x": x, "y": x.sum(1, keepdims=True)}
    kw = dict(epochs=1, batch_size=8, shuffle=False, verbose=False)
    losses = []
    for make in (Estimator.from_jax, lambda m, **k: Estimator.from_keras(
            model=m, **k)):
        torch.manual_seed(0)
        est = make(torch.nn.Linear(4, 1), loss="mse", optimizer="sgd",
                   device="cpu")
        assert type(est) is TEstimator
        losses.append([s["train_loss"] for s in est.fit(data, **kw)])
    assert losses[0] == losses[1]
    jest = JEst.from_jax(_JaxLinear(), loss="mse", optimizer="sgd")
    assert type(jest) is JEstimator


def test_estimator_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttext.BERTClassifier(num_classes=2, bert_config=TINY_BERT)


def test_fit_profile_step_times():
    ids = _token_batch()
    labels = (ids[:, 0] % 3).astype(np.int32)
    est = ttext.BERTClassifier(num_classes=3, bert_config=TINY_BERT,
                               device="cpu")
    it = tutils.BatchIterator({"x": (ids,), "y": (labels,)}, 16,
                              shuffle=True)
    stats = est.fit(it, epochs=2, batch_size=16, verbose=False, profile=True)
    for s in stats:
        prof = s["profile"]
        assert prof["steps"] == len(prof["step_ms"]) == 2
        assert all(t > 0 for t in prof["step_ms"])
        np.testing.assert_allclose(prof["mean_step_s"],
                                   np.mean(prof["step_ms"]) / 1e3)
        assert prof["mean_data_s"] >= 0
    # one epoch counted for the JAX estimator's sample draw, then one each
    assert it._epoch == 3
    assert "profile" not in est.fit(it, epochs=1, batch_size=16,
                                    verbose=False)[0]


def test_dropout_masks_follow_seed_and_step():
    ids = _token_batch(n=16)
    data = {"x": ids, "y": (ids[:, 0] % 2).astype(np.int32)}
    cfg = dict(TINY_BERT, hidden_p_drop=0.5, attn_p_drop=0.5)
    losses = []
    for seed in (0, 0, 1):
        torch.manual_seed(7)            # the same initial weights each time
        est = ttext.BERTClassifier(num_classes=2, bert_config=cfg,
                                   device="cpu")
        est.engine.seed = seed
        torch.manual_seed(seed + 100)   # the global generator is not used
        stats = est.fit(data, epochs=2, batch_size=8, shuffle=False,
                        verbose=False)
        drops = [m for m in est.module.modules()
                 if isinstance(m, tattn.Dropout)]
        assert drops and all(m.generator is est.engine._gen for m in drops)
        losses.append([s["train_loss"] for s in stats])
    assert losses[0] == losses[1]
    assert losses[0] != losses[2]


# --- preemption (orca/learn/preemption.py) -------------------------------------

def _linear_data(n=256, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 4).astype(np.float32)
    y = x @ np.array([1.0, -2.0, 3.0, 0.5], np.float32) + 0.1
    return x, y[:, None].astype(np.float32)


def _linear_estimator(model_dir=None):
    torch.manual_seed(0)
    return TEstimator(torch.nn.Linear(4, 1), loss="mse", optimizer="adam",
                      model_dir=model_dir, device="cpu")


def test_preemption_sigterm_checkpoints_and_stops(tmp_path):
    """The JAX suite's test (tests/test_estimator.py): a SIGTERM mid-fit
    checkpoints at the current step and returns cleanly instead of killing
    the process; a fresh estimator restores the stopped one's weights bit
    for bit."""
    import os
    import signal

    from analytics_zoo_tpu_torch.orca.learn.trigger import SeveralIteration

    x, y = _linear_data()
    est = _linear_estimator(str(tmp_path))

    class _SigtermAt(SeveralIteration):
        """Deterministic preemption: raise SIGTERM from inside the hot
        loop at a known iteration (triggers run every step)."""

        fired = False

        def __call__(self, state):
            if state.iteration >= 10 and not self.fired:
                self.fired = True     # one shot: a second SIGTERM is the
                os.kill(os.getpid(), signal.SIGTERM)   # force-stop path
            return False

    before = signal.getsignal(signal.SIGTERM)
    stats = est.fit({"x": x, "y": y}, epochs=200, batch_size=32,
                    checkpoint_trigger=_SigtermAt(10_000), verbose=False)
    assert signal.getsignal(signal.SIGTERM) is before
    assert 0 < len(stats) < 200, "fit should stop early on preemption"
    assert stats[-1].get("preempted") is True
    assert stats[-1].get("partial_epoch") is True
    assert not any(s.get("preempted") for s in stats[:-1])
    step_at_stop = est.engine.step
    # the watcher is read at dispatch boundaries: the first after step 10
    # (or the next, if the signal lands late) at the fit's fuse factor
    k = est.fuse
    first = -(-10 // k) * k
    assert step_at_stop in (first, first + k), (step_at_stop, k)
    ckpts = [d for d in os.listdir(tmp_path) if d.startswith("ckpt-")]
    assert f"ckpt-{step_at_stop}" in ckpts, (ckpts, step_at_stop)

    est2 = _linear_estimator()
    est2.fit({"x": x, "y": y}, epochs=0, batch_size=32)   # build only
    est2.load_checkpoint(str(tmp_path))
    assert est2.engine.step == step_at_stop
    want = est.engine.get_state()
    got = est2.engine.get_state()
    for name, t in want["params"].items():
        assert torch.equal(got["params"][name], t), name


def test_nested_preemption_watchers_restore_handlers():
    """The JAX suite's regression (tests/test_resilience.py): nested
    watchers unwind to exactly the handler chain they found; the first
    signal latches the flag and calls ``on_signal`` once."""
    import signal
    import time

    from analytics_zoo_tpu_torch.orca.learn.preemption import \
        PreemptionWatcher

    orig = signal.getsignal(signal.SIGTERM)
    got = []
    outer = PreemptionWatcher(on_signal=got.append)
    with outer:
        outer_handler = signal.getsignal(signal.SIGTERM)
        assert outer_handler is not orig
        with PreemptionWatcher():
            assert signal.getsignal(signal.SIGTERM) is not outer_handler
        assert signal.getsignal(signal.SIGTERM) is outer_handler
        signal.raise_signal(signal.SIGTERM)
        deadline = time.time() + 2.0
        while not outer.triggered and time.time() < deadline:
            time.sleep(0.01)
        assert outer.triggered
    assert got == [signal.SIGTERM]
    assert signal.getsignal(signal.SIGTERM) is orig

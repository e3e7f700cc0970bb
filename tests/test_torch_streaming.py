"""The port's streaming plane (analytics_zoo_tpu_torch/streaming) on the
CPU: the JAX suite's cases (tests/test_streaming_plane.py) on the port,
then the port held against the JAX package on the same seeded records —
windows bit for bit under every close rule, three trained windows of the
linear model and of a narrow NCF within rtol 1e-5 / atol 1e-6 with equal
cursors, and a streaming checkpoint the JAX trainer committed resumed by
the port's trainer.
"""

import os
import signal
import tempfile
import threading
import time

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.orca.data.chunked import ChunkedArray
from analytics_zoo_tpu_torch.orca.learn.estimator import TPUEstimator
from analytics_zoo_tpu_torch.serving.queue_api import (InMemoryBroker,
                                                       RedisBroker)
from analytics_zoo_tpu_torch.serving.redis_protocol import MiniRedisServer
from analytics_zoo_tpu_torch.streaming import (StreamCursor,
                                               StreamingReloader,
                                               StreamingTrainer,
                                               StreamingXShards,
                                               decode_record, encode_record,
                                               seq_id)
from analytics_zoo_tpu_torch.streaming.fleet import _Linear

BS = 16
DIM = 8
W_TRUE = (np.arange(DIM).astype(np.float32) / DIM)
# port against JAX, same records and weights: parameters after 3 windows
TOL = dict(rtol=1e-5, atol=1e-6)
# the narrow NCF (tests/test_torch_ncf.py's scale)
NCF = dict(user_count=50, item_count=40, class_num=3, user_embed=8,
           item_embed=8, hidden_layers=(16, 8), mf_embed=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread beside the suite's other workers (see
    tests/test_torch_tcmf.py)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _record(rng, i, event_time=None, x=None):
    x = rng.rand(DIM).astype(np.float32) if x is None else x
    return seq_id(i), encode_record(
        x, np.float32(x @ W_TRUE),
        event_time=event_time if event_time is not None else 1e9 + i)


def _fill(broker, rng, lo, hi, **kw):
    for i in range(lo, hi):
        rid, payload = _record(rng, i, **kw)
        broker.enqueue(rid, payload)


def _estimator(model_dir, seed=0):
    return TPUEstimator(_Linear(DIM, seed), loss="mse", optimizer="adam",
                        seed=seed, model_dir=model_dir, device="cpu")


def _params(est):
    return {k: v.clone() for k, v in est.engine.get_state()["params"].items()}


def _equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# --- records -----------------------------------------------------------------

def test_record_codec_roundtrip():
    x = (np.arange(6, dtype=np.float32).reshape(2, 3),
         np.array([1, 2], np.int32))
    y = (np.float32(0.25),)
    raw = encode_record(x, y, event_time=123.5)
    dx, dy, et = decode_record(raw)
    assert et == 123.5
    assert all(np.array_equal(a, b) for a, b in zip(x, dx))
    assert np.array_equal(np.asarray(y[0]), dy[0])
    dx2, dy2, _ = decode_record(encode_record(np.ones(3, np.uint8)))
    assert dy2 is None and dx2[0].dtype == np.uint8
    assert seq_id(2) < seq_id(10) < seq_id(123456789)


# --- window semantics --------------------------------------------------------

def test_count_window_closes_and_chunks_per_batch():
    rng = np.random.RandomState(0)
    broker = InMemoryBroker()
    _fill(broker, rng, 0, 3 * BS)
    src = StreamingXShards(broker, batch_size=BS, window_records=2 * BS,
                           poll_timeout_s=0.01)
    w = src.next_window(StreamCursor())
    assert w.n == 2 * BS and w.ids[0] == seq_id(0)
    assert isinstance(w.x[0], ChunkedArray)
    assert w.x[0].num_chunks == 2 and w.x[0].shape == (2 * BS, DIM)
    assert w.to_xshards().num_partitions() == 2
    rng2 = np.random.RandomState(0)
    flat = np.stack([rng2.rand(DIM).astype(np.float32)
                     for _ in range(2 * BS)])
    assert np.array_equal(w.x[0].slice(0, w.n), flat)


def test_window_records_rounded_to_whole_batches():
    src = StreamingXShards(InMemoryBroker(), batch_size=BS,
                           window_records=BS + 3, poll_timeout_s=0.01)
    assert src.window_records == 2 * BS


def test_age_close_trains_whole_batch_prefix_and_carries_tail():
    rng = np.random.RandomState(1)
    broker = InMemoryBroker()
    _fill(broker, rng, 0, BS + 5)
    src = StreamingXShards(broker, batch_size=BS, window_records=4 * BS,
                           window_age_s=0.05, poll_timeout_s=0.01)
    w = src.next_window(StreamCursor())
    assert w.n == BS
    _fill(broker, rng, BS + 5, 2 * BS + 5)
    w2 = src.next_window(StreamCursor(last_id=w.last_id, window=1))
    assert w2.ids[0] == seq_id(BS) and w2.n == BS
    _fill(broker, rng, 2 * BS + 5, 2 * BS + 8)
    assert src.next_window(StreamCursor(last_id=w2.last_id, window=2),
                           idle_s=0.15) is None


def test_watermark_late_records_drop_and_include():
    rng = np.random.RandomState(2)
    for policy, dropped, included in (("drop", 1, 0), ("include", 0, 1)):
        broker = InMemoryBroker()
        for i in range(BS):
            rid, payload = _record(rng, i, event_time=1e9 + 100)
            broker.enqueue(rid, payload)
        rid, payload = _record(rng, BS, event_time=1e9 - 100)
        broker.enqueue(rid, payload)
        _fill(broker, rng, BS + 1, 2 * BS + 1, event_time=1e9 + 101)
        src = StreamingXShards(broker, batch_size=BS,
                               window_records=2 * BS, watermark_s=10.0,
                               late_policy=policy, poll_timeout_s=0.01)
        w = src.next_window(StreamCursor(), idle_s=2.0)
        snap = src.stats.snapshot()
        assert snap["late_dropped"] == dropped
        assert snap["late_included"] == included
        assert (seq_id(BS) in w.ids) == (policy == "include")


def test_backlog_shed_acks_unseen():
    rng = np.random.RandomState(3)
    broker = InMemoryBroker()
    _fill(broker, rng, 0, 4 * BS)
    src = StreamingXShards(broker, batch_size=BS, window_records=BS,
                           max_backlog=BS, claim_size=BS,
                           poll_timeout_s=0.01)
    w = src.next_window(StreamCursor())
    assert src.stats.snapshot()["records_shed"] > 0
    assert w.n == BS


# --- cursor + resume ---------------------------------------------------------

def test_cursor_rides_manifest_and_resume_restores_it(tmp_path):
    rng = np.random.RandomState(4)
    broker = InMemoryBroker()
    _fill(broker, rng, 0, 2 * BS)
    src = StreamingXShards(broker, batch_size=BS, window_records=2 * BS,
                           poll_timeout_s=0.01)
    est = _estimator(str(tmp_path))
    tr = StreamingTrainer(est, src, str(tmp_path))
    assert tr.resume() is False
    tr.run(max_windows=1, idle_timeout_s=2.0)
    assert tr.cursor.window == 1
    assert tr.cursor.last_id == seq_id(2 * BS - 1)
    est.shutdown()
    est2 = _estimator(str(tmp_path), seed=1)
    tr2 = StreamingTrainer(
        est2, StreamingXShards(broker, batch_size=BS,
                               window_records=2 * BS, poll_timeout_s=0.01),
        str(tmp_path))
    assert tr2.resume() is True
    assert tr2.cursor == tr.cursor
    assert _equal(_params(est2), _params(est))
    est2.shutdown()


def test_sigterm_mid_window_resumes_bit_exactly():
    """A real SIGTERM mid-window, a restart, and the fault-free run's final
    weights bit for bit (the CPU's steps are deterministic): replayed
    records ride the PEL/XAUTOCLAIM path and dedup against the cursor."""
    rng = np.random.RandomState(5)
    recs = [_record(rng, i) for i in range(4 * BS)]

    def run(fault: bool):
        srv = MiniRedisServer().start()
        prod = RedisBroker(srv.host, srv.port, stream="t", group="g")
        d = tempfile.mkdtemp()
        try:
            if not fault:
                for rid, p in recs:
                    prod.enqueue(rid, p)
                est = _estimator(d)
                src = StreamingXShards(
                    RedisBroker(srv.host, srv.port, stream="t", group="g"),
                    batch_size=BS, window_records=2 * BS,
                    poll_timeout_s=0.02)
                StreamingTrainer(est, src, d).run(max_windows=2,
                                                  idle_timeout_s=5.0)
                out = _params(est)
                est.shutdown()
                return out
            for rid, p in recs[:3 * BS]:
                prod.enqueue(rid, p)
            est = _estimator(d)
            src = StreamingXShards(
                RedisBroker(srv.host, srv.port, stream="t", group="g"),
                batch_size=BS, window_records=2 * BS, poll_timeout_s=0.02)
            tr = StreamingTrainer(est, src, d)
            killer = threading.Timer(
                1.0, lambda: os.kill(os.getpid(), signal.SIGTERM))
            killer.start()
            tr.run(max_windows=2, idle_timeout_s=15.0)
            killer.cancel()
            assert tr.stats.snapshot()["windows"] == 1
            est.shutdown()
            for rid, p in recs[3 * BS:]:
                prod.enqueue(rid, p)
            est2 = _estimator(d)
            src2 = StreamingXShards(
                RedisBroker(srv.host, srv.port, stream="t", group="g",
                            claim_idle_ms=0),
                batch_size=BS, window_records=2 * BS, poll_timeout_s=0.02)
            tr2 = StreamingTrainer(est2, src2, d)
            assert tr2.resume()
            assert tr2.cursor.window == 1
            tr2.run(max_windows=1, idle_timeout_s=5.0)
            out = _params(est2)
            est2.shutdown()
            return out
        finally:
            srv.stop()

    assert _equal(run(fault=False), run(fault=True))


def test_replay_dedup_via_pel_under_injected_broker_fault():
    """Crash between commit and ack: the replayed entries dedup against the
    cursor, with the replacement consumer's first connect hit by an
    injected ``broker.connect`` fault."""
    from analytics_zoo_tpu_torch.resilience import faults

    rng = np.random.RandomState(6)
    srv = MiniRedisServer().start()
    try:
        prod = RedisBroker(srv.host, srv.port, stream="t", group="g")
        _fill(prod, rng, 0, 2 * BS)
        d = tempfile.mkdtemp()
        est = _estimator(d)
        src = StreamingXShards(
            RedisBroker(srv.host, srv.port, stream="t", group="g"),
            batch_size=BS, window_records=2 * BS, poll_timeout_s=0.02)
        tr = StreamingTrainer(est, src, d)
        w = src.next_window(tr.cursor)
        tr._train_window(w)
        tr._commit(w)
        est.shutdown()
        _fill(prod, rng, 2 * BS, 3 * BS)
        with faults.inject("broker.connect", count=1, kind="connection"):
            est2 = _estimator(d)
            src2 = StreamingXShards(
                RedisBroker(srv.host, srv.port, stream="t", group="g",
                            claim_idle_ms=0),
                batch_size=BS, window_records=BS, poll_timeout_s=0.02)
            tr2 = StreamingTrainer(est2, src2, d)
            assert tr2.resume()
            tr2.run(max_windows=1, idle_timeout_s=5.0)
        snap = src2.stats.snapshot()
        assert snap["records_deduped"] >= 2 * BS
        assert snap["records_trained"] == BS
        assert tr2.cursor.last_id == seq_id(3 * BS - 1)
        assert int(prod._conn().execute("XLEN", b"t")) == 0
        est2.shutdown()
    finally:
        srv.stop()


# --- end-to-end: freshness, trace, zero recompiles ---------------------------

def test_e2e_freshness_trace_and_zero_recompiles(tmp_path):
    """An XADD'd record changes the served prediction within one window;
    ONE trace id spans ingest -> assemble -> train dispatch -> ckpt commit
    -> serving reload; no graph is captured after the first window and
    every reload swaps weights into the served module's structure."""
    import copy

    from analytics_zoo_tpu_torch.obs import trace
    from analytics_zoo_tpu_torch.orca.learn import graphs
    from analytics_zoo_tpu_torch.pipeline.inference.inference_model import \
        InferenceModel

    rng = np.random.RandomState(7)
    srv = MiniRedisServer().start()
    try:
        prod = RedisBroker(srv.host, srv.port, stream="t", group="g")
        d = str(tmp_path)
        est = _estimator(d)
        src = StreamingXShards(
            RedisBroker(srv.host, srv.port, stream="t", group="g"),
            batch_size=BS, window_records=BS, poll_timeout_s=0.02)
        tr = StreamingTrainer(est, src, d)
        model = InferenceModel(device="cpu").load_module(
            copy.deepcopy(est.module))
        probe = np.ones((1, DIM), np.float32)
        p0 = float(model.predict(probe)[0])
        rel = StreamingReloader(model, d, poll_s=60, start_at=-1,
                                stats=src.stats)
        with trace.tracing(capacity=4096) as ring:
            _fill(prod, rng, 0, BS, event_time=time.time())
            tr.run(max_windows=1, idle_timeout_s=5.0)
            captures = sum(graphs.CAPTURES.values())
            _fill(prod, rng, BS, 2 * BS, event_time=time.time())
            tr.run(max_windows=1, idle_timeout_s=5.0)
            assert rel.poll_now()
            p1 = float(model.predict(probe)[0])
        assert p1 != p0
        assert tr.recompiles_after_warm() == 0
        assert sum(graphs.CAPTURES.values()) == captures
        assert model.ckpt_stats().get("full_reloads", 0) == 0
        by_name = {}
        for s in ring.spans():
            by_name.setdefault(s.name, set()).add(s.trace_id)
        need = ("stream.ingest", "stream.assemble", "engine.dispatch",
                "ckpt.write", "stream.reload")
        chained = [t for t in by_name.get("stream.window", set())
                   if all(t in by_name.get(n, set()) for n in need)]
        assert chained, f"no complete chain; spans: {sorted(by_name)}"
        assert rel.freshness_samples and rel.freshness_samples[-1] < 60.0
        p50, p99 = rel.freshness_percentiles()
        assert p50 is not None and p99 >= p50
        est.shutdown()
    finally:
        srv.stop()


def test_streaming_stats_on_obs_registry():
    from analytics_zoo_tpu_torch.obs.registry import REGISTRY
    from analytics_zoo_tpu_torch.streaming import StreamingStats

    stats = StreamingStats()
    stats.add(records_in=3, windows=1, last_backlog=7)
    stats.observe_freshness(1.5)
    samples = {name: v for name, _labels, v in REGISTRY.collector_samples()
               if name.startswith("zoo_streaming_")}
    assert samples.get("zoo_streaming_records_in") == 3
    assert samples.get("zoo_streaming_last_backlog") == 7
    assert samples.get("zoo_streaming_last_freshness_lag_s") == 1.5


# --- the port against the JAX package ----------------------------------------

def _window_doc(w):
    if w is None:
        return None
    return {"index": w.index, "ids": list(w.ids),
            "x": [a.slice(0, w.n) for a in w.x],
            "y": None if w.y is None else [a.slice(0, w.n) for a in w.y],
            "chunks": [a.num_chunks for a in w.x],
            "et": (w.event_time_min, w.event_time_max)}


def _same_windows(a, b):
    assert len(a) == len(b)
    for wa, wb in zip(a, b):
        if wa is None or wb is None:
            assert wa is None and wb is None
            continue
        assert wa["index"] == wb["index"] and wa["ids"] == wb["ids"]
        assert wa["chunks"] == wb["chunks"] and wa["et"] == wb["et"]
        for xa, xb in zip(wa["x"] + (wa["y"] or []),
                          wb["x"] + (wb["y"] or [])):
            assert xa.dtype == xb.dtype and xa.tobytes() == xb.tobytes()


def _mode_records(mode):
    """(records, source kwargs, windows to draw) of one close rule; every
    record enqueued before the first claim, so composition is decided by
    the records alone."""
    rng = np.random.RandomState(11)
    recs = [_record(rng, i) for i in range(3 * BS + 5)]
    kw = dict(batch_size=BS, poll_timeout_s=0.01)
    if mode == "count":
        return recs, dict(kw, window_records=BS + 3), 2
    if mode == "age":
        # age 0: each claim closes its whole-batch prefix, the tail carried
        return recs, dict(kw, window_records=4 * BS, window_age_s=0.0,
                          claim_size=BS + 5), 3
    if mode in ("watermark_drop", "watermark_include"):
        late = [_record(rng, 100 + i, event_time=1e9 - 100)
                for i in range(3)]
        recs = recs[:BS] + late + recs[BS:]
        return recs, dict(kw, window_records=2 * BS, watermark_s=10.0,
                          late_policy=mode.split("_")[1]), 2
    # backlog shed: the first claims ack unseen until the backlog drops
    # to the bound, the rest train
    recs += [_record(rng, i) for i in range(len(recs), 5 * BS)]
    return recs, dict(kw, window_records=BS, max_backlog=BS,
                      claim_size=BS), 2


@pytest.mark.parametrize("mode", ["count", "age", "watermark_drop",
                                  "watermark_include", "backlog_shed"])
def test_windows_bit_identical_to_jax(mode):
    from analytics_zoo_tpu import streaming as jstreaming
    from analytics_zoo_tpu.serving.queue_api import \
        InMemoryBroker as JInMemoryBroker

    recs, kw, n_windows = _mode_records(mode)
    docs, stats = [], []
    for broker, pkg in ((InMemoryBroker(), None),
                        (JInMemoryBroker(), jstreaming)):
        for rid, payload in recs:
            broker.enqueue(rid, payload)
        if pkg is None:
            src, cursor = StreamingXShards(broker, **kw), StreamCursor()
        else:
            src, cursor = pkg.StreamingXShards(broker, **kw), \
                pkg.StreamCursor()
        got = []
        for k in range(n_windows):
            w = src.next_window(cursor, idle_s=0.3)
            got.append(_window_doc(w))
            if w is not None:
                cursor.last_id, cursor.window = w.last_id, k + 1
        docs.append(got)
        snap = src.stats.snapshot()
        stats.append({k: snap[k] for k in (
            "records_in", "records_deduped", "records_shed",
            "late_dropped", "late_included")})
    _same_windows(*docs)
    assert stats[0] == stats[1]
    assert any(d is not None for d in docs[0])


def _linear_pair(d_jax, d_port):
    """The JAX Dense(1) regressor and the port's, the same weights."""
    import flax.linen as nn

    from analytics_zoo_tpu.orca.learn.estimator import \
        TPUEstimator as JTPUEstimator

    class M(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(1)(x)[:, 0]

    jest = JTPUEstimator(M(), loss="mse", optimizer="adam", seed=0,
                         model_dir=d_jax)
    jest.engine.build((np.zeros((1, DIM), np.float32),))
    test = _estimator(d_port)
    interop.load_flax_params(test.module,
                             jax.device_get(jest.engine.params))
    return jest, test


def _ncf_pair(d_jax, d_port):
    """The narrow JAX NeuralCF and the port's, the same weights."""
    from analytics_zoo_tpu.models.recommendation import \
        NeuralCF as JNeuralCF
    from analytics_zoo_tpu.orca.learn.optimizers import Adam as JAdam
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.orca.learn.optimizers import Adam

    jm = JNeuralCF(**NCF)
    jm.compile(loss="sparse_categorical_crossentropy",
               optimizer=JAdam(lr=1e-3), model_dir=d_jax)
    jm.estimator.engine.build((np.ones((1, 2), np.int32),))
    tm = NeuralCF(device="cpu", **NCF)
    interop.load_flax_params(tm.module,
                             jax.device_get(jm.estimator.engine.params))
    tm.compile(loss="sparse_categorical_crossentropy",
               optimizer=Adam(lr=1e-3), model_dir=d_port)
    return jm.estimator, tm.estimator


def _ncf_records(n, seed=12):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        u, it = rng.randint(1, NCF["user_count"]), rng.randint(
            1, NCF["item_count"])
        out.append((seq_id(i), encode_record(
            np.array([u, it], np.int32), np.int32((u + it) % 3),
            event_time=1e9 + i)))
    return out


def _jax_params_as_torch(jest):
    return interop.flax_to_state_dict(jax.device_get(jest.engine.params))


def _assert_params_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("model", ["linear", "ncf"])
def test_trainer_matches_jax_three_windows(model, orca_context, tmp_path):
    """The JAX StreamingTrainer and the port's over the same records and
    weights: parameters within rtol 1e-5 / atol 1e-6 after 3 windows of 2
    batches, and the cursors equal."""
    from analytics_zoo_tpu import streaming as jstreaming
    from analytics_zoo_tpu.serving.queue_api import \
        InMemoryBroker as JInMemoryBroker

    d_jax, d_port = str(tmp_path / "jax"), str(tmp_path / "port")
    if model == "linear":
        rng = np.random.RandomState(13)
        recs = [_record(rng, i) for i in range(6 * BS)]
        jest, test = _linear_pair(d_jax, d_port)
    else:
        recs = _ncf_records(6 * BS)
        jest, test = _ncf_pair(d_jax, d_port)
    cursors = []
    for pkg, broker, est, d in ((jstreaming, JInMemoryBroker(), jest, d_jax),
                                (None, InMemoryBroker(), test, d_port)):
        for rid, payload in recs:
            broker.enqueue(rid, payload)
        mod = pkg if pkg is not None else __import__(
            "analytics_zoo_tpu_torch.streaming", fromlist=["x"])
        src = mod.StreamingXShards(broker, batch_size=BS,
                                   window_records=2 * BS,
                                   poll_timeout_s=0.01)
        tr = mod.StreamingTrainer(est, src, d)
        tr.run(max_windows=3, idle_timeout_s=2.0)
        assert tr.stats.snapshot()["windows"] == 3
        cursors.append(tr.cursor.to_dict())
        est.shutdown()
    assert cursors[0] == cursors[1]
    _assert_params_close(_params(test), _jax_params_as_torch(jest), **TOL)


def test_jax_streaming_checkpoint_resumes_in_port(orca_context, tmp_path):
    """The JAX trainer commits window 1 and dies before its ack; the port's
    trainer resumes from that checkpoint with its cursor, dedups the
    replayed window and trains window 2: weights within rtol 1e-5 / atol
    1e-6 of the JAX trainer's own uninterrupted two windows."""
    from analytics_zoo_tpu import streaming as jstreaming
    from analytics_zoo_tpu.serving.queue_api import \
        InMemoryBroker as JInMemoryBroker
    from analytics_zoo_tpu.serving.queue_api import \
        RedisBroker as JRedisBroker

    rng = np.random.RandomState(14)
    recs = [_record(rng, i) for i in range(4 * BS)]
    # the JAX reference: two windows, uninterrupted
    jref, _ = _linear_pair(str(tmp_path / "ref"), str(tmp_path / "unused"))
    ref_broker = JInMemoryBroker()
    for rid, payload in recs:
        ref_broker.enqueue(rid, payload)
    jstreaming.StreamingTrainer(jref, jstreaming.StreamingXShards(
        ref_broker, batch_size=BS, window_records=2 * BS,
        poll_timeout_s=0.01), str(tmp_path / "ref")).run(
        max_windows=2, idle_timeout_s=2.0)
    jref.shutdown()
    d = str(tmp_path / "shared")
    srv = MiniRedisServer().start()
    try:
        prod = RedisBroker(srv.host, srv.port, stream="t", group="g")
        for rid, payload in recs:
            prod.enqueue(rid, payload)
        jest, test = _linear_pair(d, d)
        jsrc = jstreaming.StreamingXShards(
            JRedisBroker(srv.host, srv.port, stream="t", group="g"),
            batch_size=BS, window_records=2 * BS, poll_timeout_s=0.02)
        jtr = jstreaming.StreamingTrainer(jest, jsrc, d)
        w = jsrc.next_window(jtr.cursor)
        jtr._train_window(w)
        jtr._commit(w)                  # no ack: the PEL keeps window 1
        jest.shutdown()
        src = StreamingXShards(
            RedisBroker(srv.host, srv.port, stream="t", group="g",
                        claim_idle_ms=0),
            batch_size=BS, window_records=2 * BS, poll_timeout_s=0.02)
        tr = StreamingTrainer(test, src, d)
        assert tr.resume()
        assert tr.cursor.to_dict() == jtr.cursor.to_dict()
        tr.run(max_windows=1, idle_timeout_s=5.0)
        snap = src.stats.snapshot()
        assert snap["records_deduped"] >= 2 * BS
        assert snap["records_trained"] == 2 * BS
        assert tr.cursor.last_id == seq_id(4 * BS - 1)
        assert tr.cursor.window == 2
        test.shutdown()
    finally:
        srv.stop()
    _assert_params_close(_params(test), _jax_params_as_torch(jref),
                         **TOL)

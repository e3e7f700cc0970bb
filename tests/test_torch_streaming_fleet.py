"""The port's fleet-scale streaming (analytics_zoo_tpu_torch/streaming/
{guardrail,serve,fleet}.py) on the CPU: the JAX suite's guardrail,
reloader and fleet cases (tests/test_streaming_fleet.py; its records and
broker cases are in tests/test_torch_redis.py), the guardrail's verdicts
and ``module_loss_scorer`` held against the JAX package's, and a
two-consumer fleet over Redis with a SIGKILLed, respawned consumer that
loses no record and trains none twice.
"""

import os
import time
from functools import partial

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import interop
from analytics_zoo_tpu_torch.ckpt import CheckpointPlane, CheckpointWatcher
from analytics_zoo_tpu_torch.obs import trace
from analytics_zoo_tpu_torch.obs.registry import REGISTRY
from analytics_zoo_tpu_torch.streaming import (FleetReloaders,
                                               GuardrailEvaluator,
                                               StreamingFleet,
                                               StreamingReloader,
                                               StreamingStats, encode_record,
                                               partition_for, seq_id)
from analytics_zoo_tpu_torch.streaming.fleet import (_Linear,
                                                     linear_estimator_factory)
from analytics_zoo_tpu_torch.streaming.guardrail import (ACCEPT,
                                                         INSUFFICIENT,
                                                         REJECT,
                                                         module_loss_scorer)

# module_loss_scorer against JAX's on the same weights and holdout
TOL_SCORE = 1e-6


# --- guardrail: pure verdict semantics ---------------------------------------

def test_guardrail_verdict_trace():
    g = GuardrailEvaluator(holdout_records=8, min_holdout=4,
                           regression=0.5, baseline_window=4)
    assert g.verdict(99.0, holdout_n=2) is INSUFFICIENT
    assert g.baseline() is None
    assert g.verdict(1.0, holdout_n=8) is ACCEPT
    assert g.baseline() == 1.0
    assert g.verdict(1.2, holdout_n=8) is ACCEPT
    assert g.baseline() == 1.0
    assert g.verdict(1.6, holdout_n=8) is REJECT
    assert g.baseline() == 1.0
    assert g.verdict(0.9, holdout_n=8) is ACCEPT
    assert g.baseline() == 0.9
    snap = g.stats.snapshot()
    assert snap["guard_accepted"] == 3
    assert snap["guard_rejected"] == 1
    assert snap["guard_insufficient"] == 1
    assert g.last_verdict is ACCEPT


def test_guardrail_baseline_window_slides():
    g = GuardrailEvaluator(holdout_records=4, min_holdout=1,
                           regression=0.5, baseline_window=2)
    for s in (1.0, 1.4, 1.4):
        assert g.verdict(s, holdout_n=4) is ACCEPT
    assert g.baseline() == 1.4
    assert g.verdict(1.9, holdout_n=4) is ACCEPT


def test_guardrail_sizes_validated():
    for kw in ({"holdout_records": 0}, {"min_holdout": 0},
               {"baseline_window": 0}):
        with pytest.raises(ValueError, match="guardrail sizes"):
            GuardrailEvaluator(**kw)


def test_guardrail_holdout_slides_and_skips_labelless():
    g = GuardrailEvaluator(holdout_records=4, min_holdout=2)
    for i in range(6):
        g.observe(np.full(3, float(i), np.float32), np.float32(i))
    assert g.holdout_size == 4
    xs, ys = g._stacked()
    assert float(xs[0][0][0]) == 2.0
    g.observe_record(encode_record(np.ones(3, np.float32)))
    assert g.holdout_size == 4
    g.observe_record(encode_record(np.ones(3, np.float32),
                                   np.float32(7.0)))
    assert float(ys[0][-1]) == 5.0 and g.holdout_size == 4


def test_guardrail_evaluate_paths():
    g = GuardrailEvaluator(holdout_records=4, min_holdout=2)
    with pytest.raises(ValueError, match="needs a scorer"):
        g.evaluate({"params": {}}, 1)
    g.scorer = lambda state, xs, ys: 0.5
    assert g.evaluate({"params": {}}, 1) == (INSUFFICIENT, None)
    g.observe(np.ones(3, np.float32), np.float32(1.0))
    g.observe(np.ones(3, np.float32), np.float32(2.0))
    verdict, score = g.evaluate({"params": {}}, 2)
    assert verdict is ACCEPT and score == 0.5


class _Stub(torch.nn.Module):
    """model = first weight times first feature column."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return x[:, 0] * self.w


def test_module_loss_scorer():
    stub = _Stub()
    score = module_loss_scorer(stub)
    xs = (np.array([[2.0], [4.0]], np.float32),)
    ys = (np.array([1.0, 2.0], np.float32),)
    assert score({"params": {"w": np.float32(0.5)}}, xs, ys) == 0.0
    assert score({"params": {"w": np.float32(1.0)}}, xs, ys) == \
        pytest.approx(2.5)
    assert float(stub.w.detach()) == 0.0 and stub.training  # untouched
    with pytest.raises(ValueError, match="mse"):
        module_loss_scorer(stub, loss="mae")


def test_guardrail_counters_reach_obs_registry():
    stats = StreamingStats()
    g = GuardrailEvaluator(holdout_records=4, min_holdout=1,
                           regression=0.5, stats=stats)
    assert g.verdict(1.0, holdout_n=4) is ACCEPT
    assert g.verdict(9.0, holdout_n=4) is REJECT
    samples = {name: v for name, _labels, v in REGISTRY.collector_samples()
               if name.startswith("zoo_streaming_guard")}
    assert samples.get("zoo_streaming_guard_accepted") == 1
    assert samples.get("zoo_streaming_guard_rejected") == 1


# --- the adoption contract: rejected commits never reach serving -------------

def _state(step):
    rng = np.random.RandomState(step)
    return {"params": {"w": rng.rand(4, 2).astype(np.float32)},
            "step": step}


class _Sink:
    def __init__(self):
        self.steps = []

    def apply_checkpoint(self, path, state, step):
        self.steps.append(int(step))


def test_reloader_guard_rejects_commit_and_recovers(tmp_path):
    plane = CheckpointPlane(str(tmp_path), async_save=False)
    scores = {1: 1.0, 2: 9.9, 3: 1.01}
    guard = GuardrailEvaluator(
        lambda state, xs, ys: scores[int(state["step"])],
        holdout_records=4, min_holdout=2, regression=0.5)
    for i in range(2):
        guard.observe(np.ones(3, np.float32), np.float32(i))
    sink = _Sink()
    rel = StreamingReloader(sink, str(tmp_path), poll_s=60, start_at=-1,
                            guard=guard)
    with trace.tracing(capacity=1024) as ring:
        plane.save(_state(1), 1)
        assert rel.poll_now()
        plane.save(_state(2), 2)
        assert not rel.poll_now()
        assert not rel.poll_now()
        plane.save(_state(3), 3)
        assert rel.poll_now()
    assert sink.steps == [1, 3]
    snap = rel.stats.snapshot()
    assert snap["guard_rejected"] == 1
    assert snap["guard_accepted"] == 2
    assert snap["reloads"] == 2 and snap["last_reload_step"] == 3
    by_name = {}
    for s in ring.spans():
        by_name.setdefault(s.name, []).append(s)
    assert [s.attrs["step"] for s in by_name["guard.reject"]] == [2]
    reload_steps = [s.attrs["step"] for s in by_name["stream.reload"]]
    assert 2 not in reload_steps and reload_steps == [1, 3]
    assert sorted(s.attrs["step"] for s in by_name["stream.guard"]) \
        == [1, 2, 3]
    plane.close()


def test_fleet_reloaders_per_partition_adoption(tmp_path):
    for k in (0, 1):
        plane = CheckpointPlane(str(tmp_path / f"p{k}"), async_save=False)
        plane.save(_state(k + 1), k + 1)
        plane.close()
    sinks = {0: _Sink(), 1: _Sink()}
    fr = FleetReloaders(sinks, str(tmp_path), poll_s=60, start_at=-1)
    try:
        assert fr.poll_now() == 2
        assert sinks[0].steps == [1] and sinks[1].steps == [2]
        assert fr.poll_now() == 0
        snap = fr.snapshot()
        assert snap[0]["last_reload_step"] == 1
        assert snap[1]["last_reload_step"] == 2
    finally:
        fr.stop()


def test_streaming_fleet_constructor_contracts(tmp_path):
    with pytest.raises(ValueError, match="memory://"):
        StreamingFleet(linear_estimator_factory, "memory://s",
                       str(tmp_path))
    with pytest.raises(ValueError, match="consumers"):
        StreamingFleet(linear_estimator_factory,
                       f"file://{tmp_path}/q", str(tmp_path), consumers=0)
    fleet = StreamingFleet(linear_estimator_factory,
                           f"file://{tmp_path}/q", str(tmp_path),
                           consumers=2)
    assert fleet.partition_root(1) == str(tmp_path / "p1")
    assert fleet.router.n_partitions == 2
    assert fleet.alive() == 0


def test_watcher_never_adopts_older_step_with_newer_mtime(tmp_path):
    plane = CheckpointPlane(str(tmp_path), async_save=False)
    seen = []
    w = CheckpointWatcher(str(tmp_path),
                          lambda p, st, step: seen.append(step), poll_s=60)
    plane.save(_state(3), 3)
    assert w.poll_now() and seen == [3]
    lagging = CheckpointPlane(str(tmp_path), async_save=False)
    lagging.save(_state(2), 2)
    future = 2 ** 31
    os.utime(tmp_path / "ckpt-2", (future, future))
    assert not w.poll_now() and seen == [3]
    assert w.last_step == 3
    plane.save(_state(4), 4)
    assert w.poll_now() and seen == [3, 4]
    plane.close()
    lagging.close()


# --- the port against the JAX package ----------------------------------------

def test_guardrail_verdicts_match_jax():
    """The same score trace through both evaluators: the same verdicts,
    baselines and counters."""
    from analytics_zoo_tpu.streaming import GuardrailEvaluator as JGuard

    rng = np.random.RandomState(21)
    trace_ = [(float(s), int(n)) for s, n in zip(
        np.exp(rng.randn(40) * 0.4), rng.randint(0, 12, 40))]
    kw = dict(holdout_records=12, min_holdout=4, regression=0.2,
              baseline_window=3)
    out = []
    for cls in (GuardrailEvaluator, JGuard):
        g = cls(**kw)
        out.append([(g.verdict(s, holdout_n=n), g.baseline())
                    for s, n in trace_])
        snap = g.stats.snapshot()
        out.append({k: snap[k] for k in ("guard_accepted", "guard_rejected",
                                         "guard_insufficient")})
    assert out[0] == out[2] and out[1] == out[3]
    assert {v for v, _ in out[0]} == {ACCEPT, REJECT, INSUFFICIENT}


def test_module_loss_scorer_matches_jax():
    """``module_loss_scorer`` on the port's linear model and on the JAX
    package's Dense(1), the same weights and holdout: within 1e-6, for a
    state the port wrote and one the JAX package wrote."""
    import flax.linen as nn

    from analytics_zoo_tpu.streaming.guardrail import \
        module_loss_scorer as jscorer

    class M(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(1)(x)[:, 0]

    rng = np.random.RandomState(22)
    xs = (rng.rand(64, 8).astype(np.float32),)
    ys = (rng.rand(64).astype(np.float32),)
    jm = M()
    params = jax.device_get(jm.init(jax.random.PRNGKey(3), xs[0][:1]))[
        "params"]
    want = jscorer(jm)({"params": params}, xs, ys)
    module = _Linear(8, 0)
    port_state = {"params": {k: v.numpy() for k, v in
                             interop.flax_to_state_dict(params).items()}}
    got = module_loss_scorer(module)(port_state, xs, ys)
    got_jax_state = module_loss_scorer(module)(
        {"params": params, "extra_vars": {}}, xs, ys)
    assert abs(got - want) <= TOL_SCORE
    assert abs(got_jax_state - want) <= TOL_SCORE
    # control: the untouched module's own weights score elsewhere
    own = module_loss_scorer(module)(
        {"params": {k: v.numpy() for k, v in module.state_dict().items()}},
        xs, ys)
    assert abs(own - want) > 1e-3


# --- a fleet on the CPU: SIGKILL loses nothing, trains nothing twice ---------

def _fleet_records(n_per, parts=2, dim=8, seed=23):
    """``n_per`` keyed records a partition, in one id order: (rid, payload,
    partition)."""
    rng = np.random.RandomState(seed)
    out, counts, i, key = [], [0] * parts, 0, 0
    while min(counts) < n_per:
        k = partition_for(f"user:{key}", parts)
        if counts[k] < n_per:
            x = rng.rand(dim).astype(np.float32)
            out.append((seq_id(i), encode_record(
                x, np.float32(x.sum() / dim), event_time=time.time(),
                key=f"user:{key}"), k))
            counts[k] += 1
            i += 1
        key += 1
    return out


def _committed_cursor(root):
    from analytics_zoo_tpu_torch.ckpt import format as fmt
    dirs = fmt.loadable_step_dirs(root)
    if not dirs:
        return None
    return fmt.manifest_meta(dirs[-1][1]).get("stream")


def test_fleet_sigkill_loses_no_record_and_trains_none_twice(tmp_path):
    from analytics_zoo_tpu_torch.serving.queue_api import make_broker
    from analytics_zoo_tpu_torch.serving.redis_protocol import \
        MiniRedisServer

    bs, n_per = 16, 64
    recs = _fleet_records(n_per)
    srv = MiniRedisServer().start()
    spec = f"redis://{srv.host}:{srv.port}/fleet?claim_idle_ms=200"
    fleet = StreamingFleet(
        partial(linear_estimator_factory, device="cpu"), spec,
        str(tmp_path), consumers=2, batch_size=bs, window_records=2 * bs,
        window_age_s=0.3, poll_timeout_s=0.05, idle_timeout_s=5.0,
        heartbeat_s=0.2, consumer_ttl_s=5.0, poll_s=0.1)
    try:
        producer = make_broker(spec + "&partitions=2")
        half = len(recs) // 2
        for rid, payload, _ in recs[:half]:
            producer.enqueue(rid, payload)
        fleet.start()
        assert fleet.wait_live(2, timeout_s=120)
        deadline = time.time() + 120
        while _committed_cursor(fleet.partition_root(0)) is None:
            assert time.time() < deadline, "consumer 0 never committed"
            time.sleep(0.05)
        assert fleet.kill_consumer(0)
        for rid, payload, _ in recs[half:]:
            producer.enqueue(rid, payload)
        deadline = time.time() + 120
        while fleet.restarts < 1:
            assert time.time() < deadline, "consumer 0 never respawned"
            time.sleep(0.05)
        assert fleet.join(timeout_s=180), fleet.metrics()
        snap = fleet.stop()
    finally:
        if fleet.alive():
            fleet.stop()
        srv.stop()
    assert snap["restarts"] == 1
    for k in (0, 1):
        mine = [rid for rid, _, p in recs if p == k]
        cur = _committed_cursor(fleet.partition_root(k))
        assert cur["records"] == len(mine) == n_per, (k, cur)
        assert cur["last_id"] == mine[-1]

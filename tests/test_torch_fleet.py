"""The port's scale-out serving tier (``serving/fleet.py``) against the
JAX package's: the autoscaler's control loop on the same synthetic
traces (targets and counters per tick equal), then ``ServingFleet``
worker processes on ``SleepModel`` over a ``file://`` spool: SIGKILL
reclaim and respawn, occupancy-driven scale up and down, and spans that
cross the process boundary. A spawned worker imports the port (about
3.5 s on a CPU host) before it heartbeats, so the process tests assert
on the fleet's events, never on wall-clock windows.
"""

import functools
import json
import os
import time

import numpy as np
import pytest

from analytics_zoo_tpu_torch.serving import fleet as port_fleet
from analytics_zoo_tpu_torch.serving.codecs import (decode_payload,
                                                    encode_payload)
from analytics_zoo_tpu_torch.serving.queue_api import make_broker


# --- the autoscaler against the JAX package's --------------------------------
def _scaler(mod, **kw):
    kw.setdefault("max_workers", 4)
    kw.setdefault("up_occupancy", 0.75)
    kw.setdefault("down_occupancy", 0.15)
    kw.setdefault("up_sustain_s", 1.0)
    kw.setdefault("down_sustain_s", 2.0)
    kw.setdefault("cooldown_s", 3.0)
    return mod.Autoscaler(**kw)


def _feedback(a, samples, w):
    """Feed ``(now, occupancy, depth)`` samples, the target fed back as the
    worker count; the target after each tick."""
    out = []
    for now, occ, depth in samples:
        w = a.observe(now, occ, depth, w)
        out.append(w)
    return out


def _open_loop(a, samples, w):
    """Feed samples at a fixed worker count."""
    return [a.observe(now, occ, depth, w) for now, occ, depth in samples]


# the six traces of tests/test_serving_fleet.py's autoscaler tests
TRACES = {
    "ramp_scales_up_after_sustain": (
        {}, _feedback, 1,
        [(0.0, 0.5, 0), (1.0, 0.9, 0), (1.5, 0.9, 0), (2.1, 0.9, 0)]),
    "spike_is_rejected_by_sustain": (
        {}, _open_loop, 1,
        [(0.0, 0.95, 0), (0.5, 0.3, 0), (1.2, 0.95, 0), (1.9, 0.95, 0)]),
    "cooldown_hysteresis_stops_flapping": (
        {}, _feedback, 1,
        [(0.0, 0.9, 0), (1.1, 0.9, 0), (1.5, 0.9, 0), (3.0, 0.9, 0),
         (4.2, 0.9, 0)]),
    "bounds_never_violated": (
        dict(max_workers=2, cooldown_s=0.0, up_sustain_s=0.1,
             down_sustain_s=0.1), _feedback, 1,
        [(t * 0.5, 0.99, 1000) for t in range(40)]
        + [(t * 0.5, 0.0, 0) for t in range(40, 160)]),
    "scale_down_needs_sustained_idle_and_empty_queue": (
        {}, _feedback, 2,
        [(0.0, 0.05, 0), (1.0, 0.05, 10), (2.0, 0.05, 0), (3.0, 0.05, 0),
         (4.1, 0.05, 0)]),
    "queue_depth_triggers_without_occupancy": (
        dict(depth_per_worker=8), _open_loop, 2,
        [(0.0, 0.0, 100), (1.1, 0.0, 100)]),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_autoscaler_matches_jax(name):
    from analytics_zoo_tpu.serving import fleet as jax_fleet
    kw, drive, w0, samples = TRACES[name]
    runs = {}
    for pkg, mod in (("jax", jax_fleet), ("port", port_fleet)):
        a = _scaler(mod, **kw)
        runs[pkg] = (drive(a, samples, w0), a.scale_ups, a.scale_downs)
    assert runs["port"] == runs["jax"]
    targets = runs["port"][0]
    assert min(targets) >= 1
    # every trace moves the count at least once, except the rejected spike
    assert (len(set(targets + [w0])) > 1) != (name == "spike_is_rejected_by_"
                                              "sustain")


# --- without processes -------------------------------------------------------
def test_fleet_rejects_memory_queue_and_pickles_sleep_model():
    import pickle
    with pytest.raises(ValueError, match="cross-process"):
        port_fleet.ServingFleet(port_fleet.sleep_model_factory,
                                "memory://nope")
    factory = pickle.loads(pickle.dumps(
        functools.partial(port_fleet.sleep_model_factory, 3.0, 1.0)))
    m = factory()
    assert isinstance(m, port_fleet.SleepModel)
    np.testing.assert_array_equal(m.predict(np.ones((2, 4), np.float32)),
                                  np.full((2, 4), 3.0, np.float32))


def test_model_loader_raises_for_tf_and_without_a_gpu(tmp_path,
                                                      monkeypatch):
    import torch
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    path = str(tmp_path / "model.pt")
    InferenceModel(device="cpu").load_module(torch.nn.Linear(3, 2)).save(
        None, path)
    for tf_path in (str(tmp_path / "frozen.pb"), str(tmp_path / "m.h5"),
                    str(tmp_path)):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            port_fleet._model_loader(tf_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_fleet._model_loader(path)


# --- worker processes --------------------------------------------------------
def test_fleet_sigkill_reclaim_and_respawn(tmp_path):
    """Two workers over one spool stream, one SIGKILLed mid-run: every
    request is answered (the dead consumer's pending entries re-deliver to
    the survivor: reclaimed > 0, none lost) and the supervisor respawns
    the dead slot. The victim is killed once its heartbeat shows it
    holding claimed requests, whatever the host's load."""
    spec = f"file://{tmp_path}/fleet?claim_idle_s=1.0"
    # 100 ms a batch of 4, a backlog of 96: two workers need at least
    # 1.2 s, so the victim still holds claims when it is killed
    fleet = port_fleet.ServingFleet(
        functools.partial(port_fleet.sleep_model_factory, 2.0, 100.0), spec,
        workers=2, autoscale=False, batch_size=4, max_inflight=8,
        heartbeat_s=0.1, worker_ttl_s=2.0, poll_s=0.05,
        drain_s=5.0).start()
    broker = make_broker(spec)
    try:
        assert fleet.wait_live(2, 60.0), fleet.metrics()
        n = 96
        for i in range(n):
            broker.enqueue(f"q{i}", encode_payload(np.ones(3, np.float32)))
        deadline = time.time() + 60.0
        while (fleet.metrics()["per_worker"].get("w0", {}).get(
                "inflight", 0) == 0 and time.time() < deadline):
            time.sleep(0.02)
        assert fleet.kill_worker("w0") == "w0"
        for i in range(n):
            raw = broker.get_result(f"q{i}", 60.0)
            assert raw is not None, f"request q{i} lost"
            out, meta = decode_payload(raw)
            assert not meta.get("error"), meta
            np.testing.assert_array_equal(out, np.full(3, 2.0, np.float32))
        deadline = time.time() + 60.0
        while fleet.metrics()["restarts"] < 1 and time.time() < deadline:
            time.sleep(0.2)
        assert fleet.metrics()["restarts"] >= 1, fleet.metrics()
    finally:
        snap = fleet.stop()
    assert snap["reclaimed_total"] > 0, snap
    assert snap["records_out_total"] >= 1


def test_fleet_autoscales_up_and_back_down(tmp_path):
    """Occupancy-driven 1 -> 2 -> 1: a saturated worker makes the control
    loop spawn a second; once the stream is empty and idle it retires one.
    Asserted on the fleet's events (spawned, scale_up, scale_down,
    retired), so a second worker still importing when the backlog drains
    cannot fail the test."""
    spec = f"file://{tmp_path}/auto?claim_idle_s=2.0"
    scaler = port_fleet.Autoscaler(
        min_workers=1, max_workers=2, up_occupancy=0.6, down_occupancy=0.1,
        up_sustain_s=0.6, down_sustain_s=1.0, cooldown_s=1.0,
        depth_per_worker=10_000)
    fleet = port_fleet.ServingFleet(
        functools.partial(port_fleet.sleep_model_factory, 2.0, 40.0), spec,
        workers=1, autoscaler=scaler, batch_size=2, max_inflight=4,
        heartbeat_s=0.15, worker_ttl_s=2.0, poll_s=0.1, drain_s=5.0).start()
    broker = make_broker(spec)
    try:
        assert fleet.wait_live(1, 60.0), fleet.metrics()
        # ~3 s of 40 ms batches of 2 keeps one worker's occupancy near 1
        for i in range(150):
            broker.enqueue(f"a{i}", encode_payload(
                np.ones(2, np.float32), meta={"uri": f"a{i}"}))
        deadline = time.time() + 60.0
        while fleet.metrics()["scale_ups"] < 1 and time.time() < deadline:
            time.sleep(0.1)
        m = fleet.metrics()
        assert m["scale_ups"] >= 1 and m["spawned"] >= 2, m
        for i in range(150):
            assert broker.get_result(f"a{i}", 60.0) is not None
        deadline = time.time() + 60.0
        while fleet.metrics()["scale_downs"] < 1 and time.time() < deadline:
            time.sleep(0.1)
        m = fleet.metrics()
        assert m["scale_downs"] >= 1 and m["retired"] >= 1, m
        assert m["workers_target"] == 1, m
    finally:
        fleet.stop()


def test_fleet_trace_spans_cross_process(tmp_path):
    """One trace id crosses enqueue -> broker -> worker dispatch ->
    respond: the worker dumps its spans on drain and the parent finds its
    own trace id in them; beside them, the worker's final engine
    metrics."""
    from analytics_zoo_tpu_torch.obs import trace as _trace
    trace_dir = str(tmp_path / "spans")
    spec = f"file://{tmp_path}/traced?claim_idle_s=2.0"
    fleet = port_fleet.ServingFleet(
        functools.partial(port_fleet.sleep_model_factory, 2.0, 2.0), spec,
        workers=1, autoscale=False, batch_size=4, max_inflight=8,
        heartbeat_s=0.2, worker_ttl_s=2.0, drain_s=5.0,
        worker_env={"ZOO_TRACE": "1"}, trace_dir=trace_dir).start()
    broker = make_broker(spec)
    try:
        assert fleet.wait_live(1, 60.0), fleet.metrics()
        with _trace.tracing(capacity=256):
            with _trace.span("serving.request"):
                tok = _trace.token()
                trace_id = tok.split(":")[0]
                for i in range(4):
                    broker.enqueue(f"t{i}", encode_payload(
                        np.ones(2, np.float32),
                        meta={"uri": f"t{i}", "trace": tok}))
            for i in range(4):
                assert broker.get_result(f"t{i}", 30.0) is not None
    finally:
        fleet.stop()        # SIGTERM -> drain -> span dump
    assert sorted(os.listdir(trace_dir)) == ["metrics-w0.json",
                                             "spans-w0.jsonl"]
    names = set()
    with open(os.path.join(trace_dir, "spans-w0.jsonl")) as f:
        for line in f:
            s = json.loads(line)
            if s["trace"] == trace_id:
                names.add(s["name"])
    assert {"serving.dispatch", "serving.respond"} <= names, names
    with open(os.path.join(trace_dir, "metrics-w0.json")) as f:
        metrics = json.load(f)
    assert metrics["records_out"] == 4
    assert metrics["stages"]["inference"]["count"] >= 1


# --- zoo-shm: the recovery path after a SIGKILLed fleet ---------------------
def _orphan_arena(root):
    from analytics_zoo_tpu_torch import shm
    a = shm.BlobArena(os.path.join(root, "abc123"))
    a.release(a.put(b"orphan"))     # unconsumed + unpinned = orphan
    a.put(b"kept")                  # still pinned by this process


def test_zoo_shm_cli_matches_jax(tmp_path, capsys):
    """``stats`` and ``gc`` print what the JAX package's CLI prints on the
    same arena roots (``gc`` on two roots made alike)."""
    from analytics_zoo_tpu.shm.cli import main as jmain

    from analytics_zoo_tpu_torch.shm.cli import main
    out = {}
    for pkg, cli in (("jax", jmain), ("port", main)):
        root = str(tmp_path / pkg)
        _orphan_arena(root)
        assert cli(["stats", "--root", root]) == 0
        stats = capsys.readouterr().out.replace(root, "<root>")
        assert cli(["gc", "--root", root, "--grace", "0",
                    "--purge-empty"]) == 0
        gc = capsys.readouterr().out.replace(root, "<root>")
        assert cli(["stats", "--root", str(tmp_path / "none")]) == 0
        empty = capsys.readouterr().out.replace(str(tmp_path), "<tmp>")
        out[pkg] = (stats, gc, empty)
    assert out["port"] == out["jax"]
    stats, gc, _ = out["port"]
    assert '"allocs_live": 2' in stats
    assert '"allocs_live": 1' in gc and '"purged": false' in gc

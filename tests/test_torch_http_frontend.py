"""The port's HTTP frontend (``serving/http_frontend.py``, HTTP/1.1 over
asyncio streams) against the JAX package's ``create_app`` on aiohttp.

Each side serves its own package's ``ClusterServing`` of its own
``SleepModel(k=2, batch_ms=0)`` over an in-memory broker; the same
requests go to both through ``http.client``. Status, body bytes and
``Retry-After`` must be equal, except where a body carries a reading
(a queue age, the ``/metrics`` timings): there the rest of the body must
be equal. ``/metrics`` keeps every key; ``"compile"`` is ``{}`` in the
port, the one stated difference of the body.

Then the two packages over one ``MiniRedisServer``: the port's frontend
in front of the JAX engine and the JAX frontend in front of the port's,
so the wire formats stay identical; and the port's transport alone:
keep-alive, the body bound, and ``run_frontend``'s SIGTERM exit.
"""

import asyncio
import contextlib
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from analytics_zoo_tpu_torch.serving import http_frontend as port_fe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "s3cret"


def _aiohttp_thread(app):
    """Run an aiohttp app on an ephemeral port in a daemon thread (the JAX
    bench's ``_frontend_thread``); returns ``(port, stop)``."""
    from aiohttp import web

    loop = asyncio.new_event_loop()
    started = threading.Event()
    holder = {}
    runner = web.AppRunner(app)

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        holder["port"] = site._server.sockets[0].getsockname()[1]
        started.set()
        loop.run_forever()

    t = threading.Thread(target=run, daemon=True, name="jax-frontend")
    t.start()
    assert started.wait(15), "aiohttp frontend did not start"

    def stop():
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=5)

    return holder["port"], stop


def _package(pkg):
    if pkg == "jax":
        from analytics_zoo_tpu.serving import ClusterServing, InMemoryBroker
        from analytics_zoo_tpu.serving.fleet import SleepModel
        from analytics_zoo_tpu.serving.http_frontend import create_app
    else:
        from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                     InMemoryBroker,
                                                     SleepModel)
        create_app = port_fe.create_app
    return SimpleNamespace(ClusterServing=ClusterServing,
                           InMemoryBroker=InMemoryBroker,
                           SleepModel=SleepModel, create_app=create_app)


@contextlib.contextmanager
def _served(pkg, engine=True, **app_kw):
    """One package's app (and engine) on an ephemeral port."""
    mods = _package(pkg)
    broker = mods.InMemoryBroker(claim_idle_s=30.0)
    serving = None
    if engine:
        serving = mods.ClusterServing(mods.SleepModel(k=2.0, batch_ms=0),
                                      queue=broker, batch_size=4).start()
    app_kw.setdefault("timeout_s", 5.0)
    app = mods.create_app(broker, serving=serving, **app_kw)
    if pkg == "jax":
        port, stop = _aiohttp_thread(app)
    else:
        port, stop = app.start(), app.stop
    try:
        yield SimpleNamespace(port=port, broker=broker, serving=serving)
    finally:
        stop()
        if serving is not None:
            serving.stop()


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body)
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return {"status": r.status, "body": r.read(),
                "retry_after": r.getheader("Retry-After"),
                "content_type": r.getheader("Content-Type")}
    finally:
        conn.close()


def _predict(ctx, body, headers=None):
    return _call(ctx.port, "POST", "/predict", body, headers)


# --- the cases: each drives one side and returns its responses ---------------
def _dense(ctx):
    return [_predict(ctx, {"instances": [[1.0, 2.0], [3.0, -4.5]]}),
            _predict(ctx, {"instances": [{"t": [[0.5, 1.5]]}]})]


def _named(ctx):
    return [_predict(ctx, {"instances": [{"a": [1.0, 2.0],
                                          "b": [3.0, 4.0]}]})]


def _sparse(ctx):
    good = {"t": {"shape": [2, 3], "data": [1.5, -2.0],
                  "indices": [[0, 1], [1, 2]]}}
    out_of_range = {"t": {"shape": [2, 3], "data": [1.5, -2.0],
                          "indices": [[0, 1], [2, 0]]}}
    return [_predict(ctx, {"instances": [good]}),
            _predict(ctx, {"instances": [good, out_of_range]})]


def _malformed(ctx):
    return [_predict(ctx, {"instances": [[1.0], [[1.0, 2.0], [3.0]]]}),
            _predict(ctx, {"instances": "nope"})]


def _bad_timeout(ctx):
    return [_predict(ctx, {"instances": [[1.0]]}, {"X-Timeout-S": "soon"}),
            _predict(ctx, {"instances": [[1.0]]}, {"X-Timeout-S": "2"})]


def _bad_model(ctx):
    return [_predict(ctx, {"instances": [[1.0]], "model": 5})]


def _unknown_model(ctx):
    return [_predict(ctx, {"instances": [[1.0]], "model": "nope"}),
            _predict(ctx, {"instances": [[1.0]]}, {"X-Model": "nope"})]


def _auth(ctx):
    good = {"Authorization": f"Bearer {TOKEN}"}
    return [_predict(ctx, {"instances": [[1.0]]}),
            _predict(ctx, {"instances": [[1.0]]},
                     {"Authorization": "Bearer wrong"}),
            _predict(ctx, {"instances": [[1.0]]},
                     {"Authorization": "Bearer sécret".encode("utf-8")
                      .decode("latin-1")}),
            _predict(ctx, {"instances": [[1.0]]}, good),
            _call(ctx.port, "GET", "/"),
            _call(ctx.port, "GET", "/healthz"),
            _call(ctx.port, "GET", "/readyz"),
            _call(ctx.port, "GET", "/metrics.prom"),
            _call(ctx.port, "GET", "/nope")]


def _health(ctx):
    return [_call(ctx.port, "GET", "/"), _call(ctx.port, "HEAD", "/"),
            _call(ctx.port, "GET", "/healthz"),
            _call(ctx.port, "GET", "/readyz")]


def _draining(ctx):
    ctx.serving.drain(timeout_s=5.0)
    return [_call(ctx.port, "GET", "/readyz"),
            _predict(ctx, {"instances": [[1.0]]})]


def _no_workers(ctx):
    out = [_call(ctx.port, "GET", "/readyz")]
    ctx.broker.heartbeat("w0", {"busy_s": 0.5})
    out.append(_call(ctx.port, "GET", "/readyz"))
    return out


def _max_pending(ctx):
    return [_predict(ctx, {"instances": [[1.0]]})]


def _queue_age(ctx):
    ctx.broker.enqueue("stale", b"x")
    time.sleep(0.1)
    depth = ctx.broker.pending()
    out = [_predict(ctx, {"instances": [[1.0, 2.0]]})]
    assert ctx.broker.pending() == depth, "shed must happen BEFORE enqueue"
    # the body carries the head's age: compared without it
    body = json.loads(out[0]["body"])
    assert body.pop("queue_age_ms") > 60.0
    out[0]["body"] = json.dumps(body, sort_keys=True).encode()
    return out


def _model_secure(ctx):
    form = {"Content-Type": "application/x-www-form-urlencoded"}
    return [_call(ctx.port, "POST", "/model-secure", "secret=a", form),
            _call(ctx.port, "POST", "/model-secure",
                  "secret=a%26b&salt=c", form),
            _call(ctx.port, "POST", "/model-secure", "secret=a&salt=c")]


def _wrong_method(ctx):
    return [_call(ctx.port, "GET", "/predict"),
            _call(ctx.port, "DELETE", "/predict"),
            _call(ctx.port, "POST", "/healthz"),
            _call(ctx.port, "GET", "/nope")]


CASES = {  # name: (case, app kwargs, embedded engine)
    "dense": (_dense, {}, True),
    "named": (_named, {}, True),
    "sparse": (_sparse, {}, True),
    "malformed": (_malformed, {}, True),
    "bad_timeout": (_bad_timeout, {}, True),
    "bad_model": (_bad_model, {}, True),
    "unknown_model": (_unknown_model, {}, True),
    "auth": (_auth, {"auth_token": TOKEN}, True),
    "health_ready": (_health, {}, True),
    "draining": (_draining, {}, True),
    "no_workers": (_no_workers, {"worker_ttl_s": 2.0}, False),
    "max_pending": (_max_pending, {"max_pending": 0}, False),
    "queue_age": (_queue_age, {"queue_age_shed_ms": 60.0}, False),
    "model_secure": (_model_secure, {}, True),
    "wrong_method": (_wrong_method, {}, True),
}


def _run_case(pkg, name):
    case, app_kw, engine = CASES[name]
    with _served(pkg, engine=engine, **app_kw) as ctx:
        out = case(ctx)
    for r in out:
        # the Prometheus text is each package's own registry
        if r["content_type"] and r["status"] == 200 and \
                r["body"].startswith(b"# "):
            r["body"] = b"<exposition>"
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_frontend_matches_jax(name):
    want = _run_case("jax", name)
    got = _run_case("port", name)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (name, i, g, w)


def test_metrics_keys_match_jax():
    """``/metrics`` over an engine that served one request: the same keys
    at the top and in each section; ``compile`` is ``{}`` in the port."""
    bodies = {}
    for pkg in ("jax", "port"):
        with _served(pkg, max_pending=100) as ctx:
            assert _predict(ctx, {"instances": [[1.0]]})["status"] == 200
            r = _call(ctx.port, "GET", "/metrics")
            assert r["status"] == 200
            assert r["content_type"] == "application/json; charset=utf-8"
            bodies[pkg] = json.loads(r["body"])
    want, got = bodies["jax"], bodies["port"]
    assert set(got) == set(want)
    assert got["compile"] == {} and want["compile"] != {}
    for key, section in want.items():
        if isinstance(section, dict) and key != "compile":
            assert set(got[key]) == set(section), key
    assert got["records_out"] == want["records_out"] == 1
    assert got["resilience"]["rejected_429"] == 0


def test_frontends_swap_engines_over_one_redis():
    """The port's frontend in front of the JAX engine, and the JAX
    frontend in front of the port's engine, over one MiniRedisServer."""
    from analytics_zoo_tpu.serving import ClusterServing as JServing
    from analytics_zoo_tpu.serving.fleet import SleepModel as JSleep
    from analytics_zoo_tpu.serving.http_frontend import create_app as jcreate

    from analytics_zoo_tpu_torch.serving import (ClusterServing,
                                                 MiniRedisServer, SleepModel)

    srv = MiniRedisServer(port=0).start()
    x = np.random.RandomState(0).rand(3, 5).astype(np.float32)
    try:
        pairs = (("port_front_jax_engine", port_fe.create_app, JServing,
                  JSleep),
                 ("jax_front_port_engine", jcreate, ClusterServing,
                  SleepModel))
        for stream, create, engine_cls, sleep_cls in pairs:
            spec = f"redis://{srv.host}:{srv.port}/{stream}"
            engine = engine_cls(sleep_cls(k=2.0, batch_ms=0), queue=spec,
                                batch_size=4).start()
            app = create(spec, timeout_s=10.0)
            if create is jcreate:
                port, stop = _aiohttp_thread(app)
            else:
                port, stop = app.start(), app.stop
            try:
                r = _call(port, "POST", "/predict",
                          {"instances": [{"t": row.tolist()} for row in x]})
            finally:
                stop()
                engine.stop()
            assert r["status"] == 200, (stream, r)
            got = np.array(json.loads(r["body"])["predictions"])
            np.testing.assert_array_equal(got, x * 2.0)
    finally:
        srv.stop()


def test_port_transport_keepalive_and_body_bound(monkeypatch):
    """Requests on one connection: by Content-Length, chunked, and with
    ``Expect: 100-continue``; a body over ``MAX_BODY_BYTES`` answers 413
    (aiohttp's text) and closes the connection."""
    monkeypatch.setattr(port_fe, "MAX_BODY_BYTES", 1024)
    body = json.dumps({"instances": [[1.0]]}).encode()
    with _served("port") as ctx:
        conn = http.client.HTTPConnection("127.0.0.1", ctx.port, timeout=30)
        try:
            for kw in ({"body": body},
                       {"body": iter([body[:5], body[5:]]),
                        "encode_chunked": True},
                       {"body": body,
                        "headers": {"Expect": "100-continue"}}):
                conn.request("POST", "/predict", **kw)
                r = conn.getresponse()
                assert r.status == 200 and r.getheader("Connection") is None
                assert json.loads(r.read()) == {"predictions": [[2.0]]}
            conn.request("POST", "/predict", body=b"x" * 2048)
            r = conn.getresponse()
            assert r.status == 413 and r.getheader("Connection") == "close"
            assert r.read() == (b"Maximum request body size 1024 exceeded, "
                                b"actual body size 2048")
        finally:
            conn.close()


def test_port_transport_rejects_bad_framing(monkeypatch):
    """A chunk not followed by CRLF answers 400 and closes; ``Expect:
    100-continue`` with a Content-Length over ``MAX_BODY_BYTES`` answers
    413 at once, with no ``100 Continue`` first."""
    monkeypatch.setattr(port_fe, "MAX_BODY_BYTES", 1024)

    def exchange(raw):
        with socket.create_connection(("127.0.0.1", ctx.port),
                                      timeout=30) as s:
            s.sendall(raw)
            got = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    return got
                got += chunk

    with _served("port") as ctx:
        bad_chunk = exchange(
            b"POST /predict HTTP/1.1\r\nHost: x\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n5\r\nabcdeXY0\r\n\r\n")
        assert bad_chunk.startswith(b"HTTP/1.1 400 Bad Request\r\n")
        assert b"Connection: close\r\n" in bad_chunk
        too_large = exchange(
            b"POST /predict HTTP/1.1\r\nHost: x\r\n"
            b"Expect: 100-continue\r\nContent-Length: 2048\r\n\r\n")
        assert too_large.startswith(
            b"HTTP/1.1 413 Request Entity Too Large\r\n")
        assert b"100 Continue" not in too_large
        assert too_large.endswith(b"Maximum request body size 1024 "
                                  b"exceeded, actual body size 2048")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_run_frontend_exits_on_sigterm():
    """``python -m ...serving.http_frontend`` serves until SIGTERM, then
    drains and exits 0."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.http_frontend",
         "--host", "127.0.0.1", "--port", str(port), "--queue",
         "memory://sigterm"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 60
        while True:
            try:
                r = _call(port, "GET", "/healthz")
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()
                assert time.time() < deadline, "frontend never answered"
                time.sleep(0.1)
        assert r["status"] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, proc.communicate()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

"""HTTP frontend for Cluster Serving (counterpart of
``analytics_zoo_tpu/serving/http_frontend.py``), mirroring the reference's
akka-http FrontEndApp (zoo/.../serving/http/FrontEndApp.scala:41: GET /,
PUT /predict with JSON instances; domain schema http/domains.scala).

POST/PUT /predict body: {"instances": [{"t": [[...]]}, ...]} — each instance's
tensors are enqueued onto the serving broker; the handler awaits results and
returns {"predictions": [...]}. A tensor value may also be a sparse triple
{"shape": [...], "data": [...], "indices": [[...]]} (reference:
http/domains.scala:100 SparseTensor).

Transport security (reference FrontEndApp.scala:230-235 httpsEnabled +
:145-157 model-secure): ``run_frontend(ssl_certfile=, ssl_keyfile=)`` serves
HTTPS, ``auth_token`` requires ``Authorization: Bearer <token>`` on every
route but GET /, /healthz and /readyz, and POST /model-secure stores the
secret/salt an encrypted model artifact needs (utils/crypto.py sealed
files).

The JAX package serves the app on aiohttp; this one speaks HTTP/1.1 over
the standard library's asyncio streams (:class:`HTTPApp`), with the same
routes, statuses, headers and JSON bodies (``json.dumps`` defaults,
``application/json; charset=utf-8``), aiohttp's 404/405/500 answers, and
keep-alive connections. Three differences are stated: ``GET /metrics``
reports ``"compile": {}`` (this package has no compile plane yet, ROADMAP
A12), a request body may hold up to ``MAX_BODY_BYTES`` (aiohttp's
default bound is 1 MiB, below one 300 px f32 image as JSON), and
``POST /model-secure`` reads url-encoded forms only (aiohttp also parses
``multipart/form-data``).

Run ``python -m analytics_zoo_tpu_torch.serving.http_frontend`` (the JAX
package's ``zoo-serving``).
"""

from __future__ import annotations

import asyncio
import hmac
import json
import logging
import threading
import time
import uuid
from email.utils import formatdate
from http import HTTPStatus
from typing import Awaitable, Callable, Dict, Optional
from urllib.parse import parse_qsl, urlsplit

import numpy as np

from ..common import knobs
from ..obs import trace as _trace
from ..obs.export import prometheus_text
from ..obs.registry import REGISTRY, InstancedEvents
from ..shm import arena_for_spec as _shm_arena_for_spec
from .codecs import (SparseTensor, decode_payload, encode_payload,
                     encode_payload_ref)
from .queue_api import Broker, make_broker

logger = logging.getLogger("analytics_zoo_tpu_torch")

# the largest request body read; larger ones answer 413 as aiohttp does
MAX_BODY_BYTES = 64 * 1024 * 1024
_MAX_HEADERS = 100
_TEXT = "text/plain; charset=utf-8"


# --- a minimal HTTP/1.1 server -----------------------------------------------
class Request:
    """One parsed request: ``method``, ``path``, ``headers`` (keys lower
    case; ``headers.get`` takes any case), the raw ``body`` and the
    ``app`` serving it."""

    def __init__(self, method: str, path: str, headers: "_Headers",
                 body: bytes, app: "HTTPApp"):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body
        self.app = app

    async def json(self):
        return json.loads(self.body.decode("utf-8"))

    async def post(self) -> Dict[str, str]:
        """A form body as a dict: ``application/x-www-form-urlencoded``
        decoded; any other content type gives an empty form, as aiohttp's
        ``post()`` does for a type it does not parse."""
        ctype = self.headers.get("Content-Type", "").split(";")[0].strip()
        if ctype != "application/x-www-form-urlencoded":
            return {}
        return dict(parse_qsl(self.body.decode("utf-8"),
                              keep_blank_values=True))


class _Headers(dict):
    def get(self, key, default=None):
        return super().get(key.lower(), default)


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = _TEXT,
                 headers: Optional[Dict[str, str]] = None):
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = dict(headers or {})


def json_response(data, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    """aiohttp's ``json_response`` bytes: ``json.dumps`` defaults."""
    return Response(json.dumps(data).encode("utf-8"), status,
                    "application/json; charset=utf-8", headers)


def text_response(text: str, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(text.encode("utf-8"), status, _TEXT, headers)


Handler = Callable[[Request], Awaitable[Response]]


class HTTPApp:
    """Routes, one middleware and teardown callbacks, served over asyncio
    streams. ``start(host, port)`` serves from a daemon thread and returns
    the bound port (port 0 picks a free one); ``stop()`` closes the
    server, ends open connections and runs the teardown callbacks.
    ``run(host, port)`` serves on the calling thread until ``stop()``.
    Item access (``app["model_secure"]``) is the app's state dict."""

    def __init__(self, middleware: Optional[Callable] = None):
        self._routes: Dict[str, Dict[str, Handler]] = {}
        self._middleware = middleware
        self.on_cleanup = []
        self._state: Dict[str, object] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop_ev: Optional[asyncio.Event] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def __getitem__(self, key):
        return self._state[key]

    def __setitem__(self, key, value):
        self._state[key] = value

    def add_route(self, method: str, path: str, handler: Handler):
        self._routes.setdefault(path, {})[method] = handler

    # --- dispatch -------------------------------------------------------
    async def _route(self, request: Request) -> Response:
        methods = self._routes.get(request.path)
        if methods is None:
            return text_response("404: Not Found", 404)
        method = "GET" if request.method == "HEAD" else request.method
        handler = methods.get(method)
        if handler is None:
            allow = set(methods) | ({"HEAD"} if "GET" in methods else set())
            return text_response("405: Method Not Allowed", 405,
                                 headers={"Allow": ",".join(sorted(allow))})
        return await handler(request)

    async def handle(self, request: Request) -> Response:
        """The response to one request; a handler's exception answers 500
        (aiohttp's body) and is logged."""
        try:
            if self._middleware is not None:
                return await self._middleware(request, self._route)
            return await self._route(request)
        except Exception:  # noqa: BLE001 — one request, the server lives on
            logger.exception("Error handling request %s %s",
                             request.method, request.path)
            return text_response(
                "500 Internal Server Error\n\nServer got itself in trouble",
                500, headers={"Connection": "close"})

    # --- the wire ---------------------------------------------------------
    @staticmethod
    async def _read_body(reader, headers) -> Optional[bytes]:
        """The body by Content-Length (or chunked); None when it is larger
        than ``MAX_BODY_BYTES``."""
        if "chunked" in headers.get("Transfer-Encoding", "").lower():
            parts, total = [], 0
            while True:
                size = int((await reader.readline()).split(b";")[0], 16)
                if size == 0:
                    while (await reader.readline()).strip():
                        pass        # trailers
                    return b"".join(parts)
                total += size
                if total > MAX_BODY_BYTES:
                    return None
                parts.append(await reader.readexactly(size))
                if await reader.readexactly(2) != b"\r\n":
                    raise ValueError("chunk not followed by CRLF")
        n = int(headers.get("Content-Length", "0") or 0)
        if n < 0:
            raise ValueError(f"bad Content-Length {n}")
        if n > MAX_BODY_BYTES:
            return None
        return await reader.readexactly(n) if n else b""

    @staticmethod
    def _declared_too_large(headers) -> bool:
        """Whether the Content-Length header alone exceeds
        ``MAX_BODY_BYTES`` (a malformed one is left to ``_read_body``)."""
        try:
            return int(headers.get("Content-Length", "0") or 0) \
                > MAX_BODY_BYTES
        except ValueError:
            return False

    @staticmethod
    async def _write(writer, method: str, resp: Response, close: bool):
        reason = HTTPStatus(resp.status).phrase
        head = [f"HTTP/1.1 {resp.status} {reason}",
                f"Content-Type: {resp.content_type}",
                f"Content-Length: {len(resp.body)}",
                f"Date: {formatdate(usegmt=True)}"]
        head += [f"{k}: {v}" for k, v in resp.headers.items()
                 if k.lower() != "connection"]
        if close:
            head.append("Connection: close")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        if method != "HEAD":
            writer.write(resp.body)
        await writer.drain()

    async def _serve_conn(self, reader, writer):
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    method, target, version = \
                        line.decode("latin-1").rstrip("\r\n").split(" ")
                    headers = _Headers()
                    while True:
                        h = await reader.readline()
                        if h in (b"\r\n", b"\n", b""):
                            break
                        if len(headers) >= _MAX_HEADERS:
                            raise ValueError("too many headers")
                        k, _, v = h.decode("latin-1").partition(":")
                        headers[k.strip().lower()] = v.strip()
                except ValueError:
                    await self._write(writer, "GET", text_response(
                        "400: Bad Request", 400), close=True)
                    break
                conn = headers.get("Connection", "").lower()
                keep = (conn != "close" if version == "HTTP/1.1"
                        else conn == "keep-alive")
                if (headers.get("Expect", "").lower() == "100-continue"
                        and not self._declared_too_large(headers)):
                    writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                try:
                    body = await self._read_body(reader, headers)
                except ValueError:
                    await self._write(writer, method, text_response(
                        "400: Bad Request", 400), close=True)
                    break
                if body is None:
                    size = headers.get("Content-Length", "chunked")
                    await self._write(writer, method, text_response(
                        f"Maximum request body size {MAX_BODY_BYTES} "
                        f"exceeded, actual body size {size}", 413),
                        close=True)
                    break
                request = Request(method, urlsplit(target).path, headers,
                                  body, self)
                resp = await self.handle(request)
                keep = keep and resp.headers.get("Connection") != "close"
                await self._write(writer, method, resp, close=not keep)
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass                        # the client went away
        finally:
            self._conns.discard(task)
            writer.close()

    # --- lifecycle ------------------------------------------------------
    async def _main(self, host, port, ssl_context, bound: threading.Event):
        self._loop = asyncio.get_running_loop()
        self._stop_ev = asyncio.Event()
        self._conns = set()
        try:
            server = await asyncio.start_server(self._serve_conn, host,
                                                port, ssl=ssl_context)
            self.port = server.sockets[0].getsockname()[1]
        finally:
            bound.set()         # start() reads self.port: None if not bound
        try:
            await self._stop_ev.wait()
        finally:
            server.close()
            for t in list(self._conns):
                t.cancel()
            await asyncio.gather(*self._conns, return_exceptions=True)
            for cb in self.on_cleanup:
                await cb(self)

    def run(self, host: str = "0.0.0.0", port: int = 10020,
            ssl_context=None, _bound: Optional[threading.Event] = None):
        """Serve on the calling thread until :meth:`stop`."""
        asyncio.run(self._main(host, port, ssl_context,
                               _bound or threading.Event()))

    def start(self, host: str = "127.0.0.1", port: int = 0,
              ssl_context=None, timeout_s: float = 30.0) -> int:
        """Serve from a daemon thread; returns the bound port."""
        bound = threading.Event()
        self._thread = threading.Thread(
            target=self.run, args=(host, port, ssl_context, bound),
            daemon=True, name="http-frontend")
        self._thread.start()
        if not bound.wait(timeout_s) or self.port is None:
            raise RuntimeError(f"frontend did not bind {host}:{port}")
        return self.port

    def stop(self, timeout_s: float = 10.0):
        """Stop serving (from any thread): closes the server and every
        connection, then runs the teardown callbacks."""
        loop, ev = self._loop, self._stop_ev
        if loop is not None and ev is not None:
            try:
                loop.call_soon_threadsafe(ev.set)
            except RuntimeError:        # loop already closed
                pass
        if (self._thread is not None
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout_s)


# --- the Cluster Serving app ------------------------------------------------
def _parse_tensor_value(v):
    """A JSON instance value: nested list (dense) or {shape,data,indices}
    (sparse, reference http/domains.scala:100)."""
    if isinstance(v, dict) and {"shape", "data", "indices"} <= set(v):
        return SparseTensor(shape=tuple(v["shape"]),
                            data=np.asarray(v["data"], np.float32),
                            indices=np.asarray(v["indices"]))
    return np.asarray(v, dtype=np.float32)


def create_app(queue="memory://serving_stream", timeout_s: float = 30.0,
               serving=None, auth_token: Optional[str] = None,
               max_pending: Optional[int] = None,
               worker_ttl_s: Optional[float] = None,
               queue_age_shed_ms: Optional[float] = None) -> HTTPApp:
    """``serving``: optional ClusterServing engine to expose under
    GET /metrics (the reference surfaces Flink numRecordsOutPerSecond +
    stage timers the same way, ClusterServingGuide:525). ``auth_token``:
    when set, every route but GET /, /healthz and /readyz requires
    ``Authorization: Bearer <auth_token>``.

    Overload safety (resilience plane): ``max_pending`` bounds the broker
    backlog — a predict that would push it past the bound is rejected with
    429 + ``Retry-After`` *before* anything is enqueued. Every admitted
    instance carries an absolute deadline (``timeout_s``, or the request's
    ``X-Timeout-S`` header if tighter) in its payload meta; the engine
    sheds expired requests before device dispatch. ``GET /healthz`` is
    process liveness, ``GET /readyz`` flips 503 while draining or while
    the serving circuit breaker is open.

    Fleet mode (scale-out tier): with ``worker_ttl_s`` set and no
    embedded engine, this frontend is one of N doors to a worker fleet —
    ``/readyz`` 503s when the broker is unreachable or ZERO workers have
    a fresh heartbeat (an orchestrator must not route traffic into a
    stream nobody consumes), and ``metrics()`` / ``/metrics.prom``
    surface the live-worker count. ``queue_age_shed_ms`` (default: the
    ``ZOO_FLEET_QUEUE_AGE_SHED_MS`` knob; 0 disables) sheds BEFORE
    enqueue when the broker's head-of-line entry is older than the
    bound: head age lower-bounds what a new arrival will wait, so a 429
    + ``Retry-After`` now beats an answer that expires later.

    Observability (obs plane): ``GET /metrics.prom`` serves the unified
    registry as Prometheus text exposition next to the JSON body; with
    tracing armed (``ZOO_TRACE=1``) each predict opens a
    ``serving.request`` span whose token rides the payload meta so the
    engine's decode/batch/dispatch spans chain to it.

    Returns an :class:`HTTPApp`: ``start(host, port)`` serves it from a
    thread, :func:`run_frontend` from the calling one."""
    broker: Broker = make_broker(queue) if isinstance(queue, str) else queue
    # shm object plane: on a local ZOO_SHM-enabled stream this door writes
    # each request's raw tensor bytes into arena slabs once and enqueues
    # descriptors — the engine maps them instead of re-decoding b64(arrow)
    arena = _shm_arena_for_spec(
        queue if isinstance(queue, str) else getattr(broker, "spec", None))
    shed_age_s = float(knobs.get("ZOO_FLEET_QUEUE_AGE_SHED_MS")
                       if queue_age_shed_ms is None
                       else queue_age_shed_ms) / 1e3
    # admission counters live in the unified metrics registry (obs plane),
    # labeled per app instance so this app's JSON /metrics body still
    # starts at 0 while /metrics.prom exposes the same series
    events = InstancedEvents(
        REGISTRY.counter(
            "zoo_serving_http_events_total",
            "HTTP-frontend admission events: 429 rejections (backlog "
            "bound and queue-age shed), expired results observed at "
            "fetch", labelnames=("inst", "event")),
        ("rejected_429", "expired_results", "shed_queue_age"))
    counters = events.children
    g_workers = REGISTRY.gauge(
        "zoo_serving_frontend_workers_live",
        "fleet workers with a fresh broker heartbeat, as seen from this "
        "frontend's readiness/metrics probes",
        labelnames=("inst",)).labels(inst=events.inst)

    def _live_worker_count() -> int:
        # executor-side probe (broker round trip / dir scan)
        n = len(broker.live_workers(worker_ttl_s))
        g_workers.set(n)
        return n

    async def _drop_counter_series(app):
        # app teardown drops this instance's series from the exposition so
        # rebuilt apps never leak dead-uuid series (cached children keep
        # serving the JSON view if anything still holds the app)
        events.close()
        REGISTRY.gauge("zoo_serving_frontend_workers_live",
                       labelnames=("inst",)).remove(inst=events.inst)

    async def auth_middleware(request, handler):
        # liveness/readiness probes run tokenless (orchestrator probes
        # cannot carry secrets), like GET /
        if auth_token and request.path not in ("/", "/healthz", "/readyz"):
            header = request.headers.get("Authorization", "")
            # compare as bytes: str compare_digest raises on non-ASCII
            # header values, which must 401, not 500
            ok = header.startswith("Bearer ") and hmac.compare_digest(
                header[len("Bearer "):].encode("utf-8", "surrogateescape"),
                auth_token.encode("utf-8"))
            if not ok:
                return json_response({"error": "unauthorized"}, status=401)
        return await handler(request)

    async def index(request):
        return text_response("welcome to analytics zoo tpu serving "
                             "frontend")

    async def healthz(request):
        # liveness: the process answers — orchestrators restart on failure
        return json_response({"status": "ok"})

    async def readyz(request):
        # readiness: stop routing traffic here while draining (SIGTERM
        # grace window) or while the breaker has the model circuit open
        if serving is not None:
            if serving.draining:
                return json_response({"status": "draining"}, status=503)
            if serving.breaker.snapshot()["state"] == "open":
                return json_response({"status": "circuit_open"}, status=503)
        # fleet health: ready means a predict can actually complete —
        # the broker answers AND someone is consuming the stream
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(None, broker.pending)
        except Exception as e:  # noqa: BLE001 — broker down = not ready
            return json_response(
                {"status": "broker_unreachable", "error": str(e)},
                status=503)
        body = {"status": "ready"}
        if worker_ttl_s is not None and serving is None:
            n = await loop.run_in_executor(None, _live_worker_count)
            if n == 0:
                return json_response({"status": "no_workers"}, status=503)
            body["workers_live"] = n
        return json_response(body)

    async def metrics(request):
        # pending() can block (Redis XLEN round-trip, spool-dir listing) —
        # keep it off the event loop like the predict handler's fetches
        loop = asyncio.get_running_loop()
        pending = await loop.run_in_executor(None, broker.pending)
        from ..resilience.stats import resilience_snapshot
        # no compile plane in this package yet (ROADMAP A12): the key
        # stays, empty; serving.metrics() adds the transfer-plane
        # snapshot ("transfer": h2d MB/s etc.)
        body = {"pending": pending, "compile": {}}
        if serving is not None:
            body.update(serving.metrics())
        # admission-layer overload counters (429 rejections, expired
        # results observed at fetch) merge into the engine's resilience
        # section; process-wide fault/retry/watchdog counters ride along
        res = dict(body.get("resilience") or {})
        res.update({k: int(c.value) for k, c in counters.items()})
        glob = resilience_snapshot()
        if glob:
            res["process"] = glob
        body["resilience"] = res
        if worker_ttl_s is not None:
            # fleet view from this door: who is consuming the stream
            try:
                live = await loop.run_in_executor(
                    None, broker.live_workers, worker_ttl_s)
            except Exception as e:  # noqa: BLE001 — broker blip
                live, body["fleet_error"] = {}, str(e)
            g_workers.set(len(live))
            body["fleet"] = {"workers_live": len(live),
                             "workers": sorted(live)}
        return json_response(body)

    async def metrics_prom(request):
        # Prometheus text exposition of the unified registry (obs plane).
        # Serialization walks in-process counters only (no broker
        # round-trip), so it stays on the event loop.
        return text_response(prometheus_text())

    async def predict(request):
        # root span of the serving trace: request → decode → batch →
        # device-dispatch → respond. Its token rides each instance's
        # payload meta so the engine's worker-thread spans chain to it.
        with _trace.span("serving.request", method=request.method):
            return await _predict(request)

    async def _predict(request):
        if serving is not None and serving.draining:
            # stop accepting during the SIGTERM grace window; admitted
            # requests are still drained to completion
            return json_response({"error": "draining"}, status=503,
                                 headers={"Retry-After": "5"})
        body = await request.json()
        instances = body.get("instances")
        if not isinstance(instances, list):
            return json_response({"error": "missing 'instances' list"},
                                 status=400)
        # multi-model multiplexing: a body-level "model" field (or the
        # X-Model header) routes every instance to one of the engine's
        # co-served models; unknown names 404 here, before anything is
        # enqueued, when an embedded engine can tell us
        model_name = body.get("model") or request.headers.get("X-Model")
        if model_name is not None and not isinstance(model_name, str):
            return json_response(
                {"error": f"bad 'model': {model_name!r}"}, status=400)
        if model_name and serving is not None and \
                model_name not in serving.mux:
            return json_response(
                {"error": f"unknown model {model_name!r}",
                 "models": sorted(serving.mux.names())}, status=404)
        loop = asyncio.get_running_loop()
        if shed_age_s > 0:
            # queue-age shed (fleet overload policy): when the stream's
            # head entry has waited longer than the bound, a new arrival
            # will wait at least that long — shed it BEFORE enqueue so
            # the backlog drains instead of compounding
            age_s = await loop.run_in_executor(None, broker.oldest_age_s)
            if age_s > shed_age_s:
                counters["shed_queue_age"].inc()
                return json_response(
                    {"error": "queue too old",
                     "queue_age_ms": round(age_s * 1e3, 1),
                     "shed_ms": round(shed_age_s * 1e3, 1)},
                    status=429, headers={"Retry-After": "1"})
        if max_pending is not None:
            # bounded admission: reject BEFORE enqueuing anything, so an
            # overloaded broker never grows past the bound from this door.
            # Retry-After is a coarse hint: one batch-drain interval.
            backlog = await loop.run_in_executor(None, broker.pending)
            if backlog + len(instances) > max_pending:
                counters["rejected_429"].inc()
                return json_response(
                    {"error": "queue full", "pending": backlog,
                     "max_pending": max_pending},
                    status=429, headers={"Retry-After": "1"})
        # parse + validate EVERY instance before enqueuing any: a malformed
        # instance mid-list must 400 without having orphaned earlier
        # instances' work/results on the broker
        parsed = []
        for inst in instances:
            try:
                if isinstance(inst, dict):
                    named = {k: _parse_tensor_value(v)
                             for k, v in inst.items()}
                    parsed.append(next(iter(named.values()))
                                  if len(named) == 1 else named)
                else:
                    parsed.append(np.asarray(inst, dtype=np.float32))
            except (ValueError, TypeError) as e:
                # malformed instance (bad sparse triple, ragged list):
                # client error, not a 500
                return json_response(
                    {"error": f"bad instance: {e}"}, status=400)
        # deadline propagation: the engine sheds any request still queued
        # past this instant. X-Timeout-S may only tighten the app-level
        # timeout — a client cannot hold a slot longer than the server
        # allows.
        eff_timeout = timeout_s
        hdr = request.headers.get("X-Timeout-S")
        if hdr:
            try:
                eff_timeout = min(timeout_s, max(float(hdr), 0.0))
            except ValueError:
                return json_response(
                    {"error": f"bad X-Timeout-S: {hdr!r}"}, status=400)
        deadline = time.time() + eff_timeout
        # trace handoff: the request span's token rides the payload meta so
        # the batcher thread's decode/dispatch spans chain to this request
        tok = _trace.token()
        uris = []
        items = []
        for data in parsed:
            uri = uuid.uuid4().hex
            meta = {"uri": uri, "deadline": deadline}
            if model_name:
                meta["model"] = model_name
            if tok:
                meta["trace"] = tok
            if arena is not None:
                payload, _refs = encode_payload_ref(data, meta=meta,
                                                    arena=arena)
            else:
                payload = encode_payload(data, meta=meta)
            items.append((uri, payload))
            uris.append(uri)
        # one broker batch for the whole request: the file transport pays
        # a single spool-dir fsync for N instances instead of N
        broker.publish_many(items)

        def fetch(uri):
            raw = broker.get_result(uri, eff_timeout)
            if raw is None:
                return None, False
            arr, meta = decode_payload(raw)
            if meta.get("error"):
                return ({"error": meta["error"]},
                        meta.get("shed") == "expired")
            if isinstance(arr, (list, tuple)):
                return [a.tolist() for a in arr], False
            return arr.tolist(), False

        fetched = await asyncio.gather(
            *[loop.run_in_executor(None, fetch, u) for u in uris])
        n_expired = sum(exp for _, exp in fetched)
        if n_expired:
            counters["expired_results"].inc(n_expired)
        return json_response({"predictions": [r for r, _ in fetched]})

    async def model_secure(request):
        """Store the secret/salt an encrypted model artifact is sealed with
        (reference FrontEndApp.scala:145-157 posts them to redis; here they
        land in app state for the embedded worker / operator to read).
        Body: ``secret=xxx&salt=yyy`` like the reference (form-decoded, so
        percent-encoded secrets survive)."""
        form = await request.post()
        if "secret" not in form or "salt" not in form:
            return json_response(
                {"error": "please post a content like secret=xxx&salt=yyy"},
                status=400)
        request.app["model_secure"].update(secret=form["secret"],
                                           salt=form["salt"])
        return text_response("model secured secret and salt succeed "
                             "to put in app state")

    app = HTTPApp(middleware=auth_middleware)
    app.on_cleanup.append(_drop_counter_series)
    app["model_secure"] = {}
    app.add_route("GET", "/", index)
    app.add_route("GET", "/healthz", healthz)
    app.add_route("GET", "/readyz", readyz)
    app.add_route("GET", "/metrics", metrics)
    app.add_route("GET", "/metrics.prom", metrics_prom)
    app.add_route("POST", "/predict", predict)
    app.add_route("PUT", "/predict", predict)
    app.add_route("POST", "/model-secure", model_secure)
    return app


def make_ssl_context(certfile: str, keyfile: str):
    """Server TLS context (reference: FrontEndApp defineServerContext over a
    PKCS12 keystore, FrontEndApp.scala:230-235; here a PEM cert/key pair)."""
    import ssl
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    return ctx


def run_frontend(queue="memory://serving_stream", host: str = "0.0.0.0",
                 port: int = 10020, serving=None,
                 auth_token: Optional[str] = None,
                 ssl_certfile: Optional[str] = None,
                 ssl_keyfile: Optional[str] = None,
                 max_pending: Optional[int] = None,
                 timeout_s: float = 30.0,
                 worker_ttl_s: Optional[float] = None,
                 queue_age_shed_ms: Optional[float] = None,
                 graceful_sigterm: bool = True):
    """Serve the app on the calling thread. With ``graceful_sigterm``
    (default), SIGTERM drains the embedded serving engine before the
    server exits — the one signal entry point shared with the training
    supervisor (``PreemptionWatcher(on_signal=...)``)."""
    from ..orca.learn.preemption import PreemptionWatcher

    ssl_ctx = (make_ssl_context(ssl_certfile, ssl_keyfile)
               if ssl_certfile and ssl_keyfile else None)
    app = create_app(queue, timeout_s=timeout_s, serving=serving,
                     auth_token=auth_token, max_pending=max_pending,
                     worker_ttl_s=worker_ttl_s,
                     queue_age_shed_ms=queue_age_shed_ms)
    if not graceful_sigterm:
        app.run(host, port, ssl_ctx)
        return

    def _on_sigterm(signum):
        def work():
            try:
                if serving is not None:
                    serving.drain()
            finally:
                app.stop()
        # drain off the signal context: finish the admitted backlog, then
        # stop the server
        threading.Thread(target=work, daemon=True,
                         name="serving-drain").start()

    with PreemptionWatcher(on_signal=_on_sigterm):
        app.run(host, port, ssl_ctx)


def main(argv=None):
    """``python -m analytics_zoo_tpu_torch.serving.http_frontend`` (the JAX
    package's ``zoo-serving``) — mirrors the reference's
    cluster-serving-start script (scripts/cluster-serving/)."""
    import argparse

    p = argparse.ArgumentParser(description="analytics-zoo-tpu-torch "
                                            "serving HTTP frontend")
    p.add_argument("--queue", default="memory://serving_stream",
                   help="broker URI (memory://<stream> or "
                        "redis://host:port/<stream>)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=10020)
    p.add_argument("--model", default=None,
                   help="also start an embedded ClusterServing worker on "
                        "the same broker, serving an InferenceModel.save "
                        "file (TensorFlow models need load_tf, not ported "
                        "yet: ROADMAP A9) — single-container serving")
    p.add_argument("--batch-size", type=int, default=None,
                   help="max records per dispatched batch (default: the "
                        "ZOO_SERVING_BATCH_SIZE knob)")
    p.add_argument("--batch-timeout-ms", type=float, default=None,
                   help="broker idle-claim poll / legacy fixed-policy "
                        "stall (default: the ZOO_SERVING_BATCH_TIMEOUT_MS "
                        "knob)")
    p.add_argument("--policy", choices=("continuous", "fixed"),
                   default="continuous",
                   help="batch former: continuous deadline-aware EDF "
                        "scheduler (default) or the legacy fixed "
                        "claim-up-to-batch-size loop")
    p.add_argument("--max-inflight", type=int, default=None,
                   help="bound on admitted in-flight requests (default: "
                        "the ZOO_SERVING_MAX_INFLIGHT knob)")
    p.add_argument("--slack-ms", type=float, default=None,
                   help="dispatch-now deadline-slack threshold (default: "
                        "the ZOO_SERVING_SLACK_MS knob)")
    p.add_argument("--max-pending", type=int, default=None,
                   help="bounded admission: reject predicts with 429 + "
                        "Retry-After once the broker backlog would exceed "
                        "this (default unbounded)")
    p.add_argument("--timeout-s", type=float, default=30.0,
                   help="per-request deadline: results are awaited this "
                        "long, and the engine sheds any request still "
                        "queued past it before device dispatch")
    p.add_argument("--worker-ttl-s", type=float, default=None,
                   help="fleet mode: /readyz 503s when no worker has a "
                        "broker heartbeat fresher than this (pair with "
                        "serving.fleet on the same --queue)")
    p.add_argument("--queue-age-shed-ms", type=float, default=None,
                   help="shed predicts with 429 before enqueue when the "
                        "broker's head-of-line entry is older than this "
                        "(default: the ZOO_FLEET_QUEUE_AGE_SHED_MS knob; "
                        "0 disables)")
    p.add_argument("--auth-token", default=None,
                   help="require 'Authorization: Bearer <token>' on every "
                        "route but GET /, /healthz and /readyz (reference "
                        "model-secure/secured serving, "
                        "FrontEndApp.scala:145)")
    p.add_argument("--https-cert", default=None,
                   help="PEM certificate: serve HTTPS (reference "
                        "httpsEnabled, FrontEndApp.scala:230)")
    p.add_argument("--https-key", default=None,
                   help="PEM private key for --https-cert")
    args = p.parse_args(argv)
    if bool(args.https_cert) != bool(args.https_key):
        p.error("--https-cert and --https-key must be given together")

    serving = None
    if args.model:
        from .engine import ClusterServing
        from .fleet import _model_loader

        serving = ClusterServing(
            _model_loader(args.model), queue=args.queue,
            batch_size=args.batch_size,
            batch_timeout_ms=args.batch_timeout_ms, policy=args.policy,
            max_inflight=args.max_inflight,
            slack_ms=args.slack_ms).start()

    # run_frontend owns graceful SIGTERM handling: stop accepting (readyz
    # flips 503, predict 503s), finish every admitted request, then exit.
    # A second SIGTERM falls through to the prior handler (force stop)
    # via the watcher's chaining.
    try:
        run_frontend(queue=args.queue, host=args.host, port=args.port,
                     serving=serving, auth_token=args.auth_token,
                     ssl_certfile=args.https_cert,
                     ssl_keyfile=args.https_key,
                     max_pending=args.max_pending,
                     timeout_s=args.timeout_s,
                     worker_ttl_s=args.worker_ttl_s,
                     queue_age_shed_ms=args.queue_age_shed_ms)
    finally:
        if serving is not None:
            if serving.draining:
                serving.drain()     # finish in-flight before exiting
            serving.stop()


if __name__ == "__main__":
    main()

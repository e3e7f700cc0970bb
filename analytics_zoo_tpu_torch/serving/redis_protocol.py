"""Minimal Redis wire protocol (RESP2) client + embeddable mini-server
(counterpart of ``analytics_zoo_tpu/serving/redis_protocol.py``).

The reference's Cluster Serving transport is Redis streams with consumer
groups: ingestion XADDs records onto a stream, the serving engine claims them
via XREADGROUP/XACK, and results land in per-item hashes via pipelined HSET
(reference: serving/engine/FlinkRedisSource.scala:78-104,
FlinkRedisSink.scala:29, pyzoo/zoo/serving/client.py:82-282).

This module supplies the same transport with zero external dependencies:

* ``RedisClient`` — a RESP2 socket client speaking exactly the command subset
  the broker needs (XADD/XREADGROUP/XACK/XGROUP/XLEN/HSET/HGETALL/DEL/PING).
  It talks to any real Redis server.
* ``MiniRedisServer`` — a pure-Python, threaded RESP2 server implementing the
  same subset, so multi-process serving works on hosts with no Redis
  installed (and tests exercise the real wire path).

Design note: the client is deliberately not a general Redis library — every
command is a list of byte-string arguments encoded as a RESP array, and
replies are parsed into bytes/int/list/None. That is all the broker contract
requires.
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..resilience import faults as _faults

_CRLF = b"\r\n"


# --------------------------------------------------------------------------
# RESP2 encoding / decoding
# --------------------------------------------------------------------------

def encode_command(*args) -> bytes:
    """Encode a command as a RESP array of bulk strings."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, str):
            a = a.encode()
        elif isinstance(a, (int, float)):
            a = str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


class _Reader:
    """Incremental RESP parser over a socket (blocking)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def _fill(self):
        chunk = self._sock.recv(65536)
        if not chunk:
            raise ConnectionError("redis connection closed")
        self._buf += chunk

    def _read_line(self) -> bytes:
        while True:
            i = self._buf.find(_CRLF)
            if i >= 0:
                line, self._buf = self._buf[:i], self._buf[i + 2:]
                return line
            self._fill()

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            self._fill()
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n < 0 else self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            return None if n < 0 else [self.read_reply() for _ in range(n)]
        raise RedisError(f"bad RESP type byte {kind!r}")


class RedisError(Exception):
    pass


class RedisClient:
    """Thread-safe RESP2 client (one socket, command lock)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout_s: float = 30.0):
        self.host, self.port = host, port
        self._timeout = timeout_s
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[_Reader] = None
        self._connect()

    def _connect(self):
        _faults.fire("broker.connect")  # chaos hook: model a dead broker
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self._timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader = _Reader(self._sock)

    def execute(self, *args, timeout_s: Optional[float] = None):
        """Send one command and return its reply.

        On a connection failure the socket is re-established for the NEXT
        call and the error re-raised — we never silently re-send, because a
        command like XADD may have executed server-side before the reply was
        lost, and a blind retry would duplicate it. Callers with idempotent
        commands (result polling loops) retry at their level.
        """
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                self._sock.settimeout(
                    timeout_s if timeout_s is not None else self._timeout)
                self._sock.sendall(encode_command(*args))
                return self._reader.read_reply()
            except (ConnectionError, OSError):
                try:
                    self._connect()
                except OSError:
                    self._sock = None  # reconnect again on next call
                raise

    def close(self):
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def ping(self) -> bool:
        return self.execute("PING") == b"PONG"


# --------------------------------------------------------------------------
# Embeddable mini Redis server (streams + hashes subset)
# --------------------------------------------------------------------------

class _Stream:
    def __init__(self):
        self.entries: List[Tuple[bytes, List[bytes]]] = []  # (id, fields)
        self.seq = 0
        self.groups: Dict[bytes, Dict] = {}  # name -> {"next": idx, "pel": {}}


class _State:
    def __init__(self):
        self.streams: Dict[bytes, _Stream] = {}
        self.hashes: Dict[bytes, Dict[bytes, bytes]] = {}
        self.cv = threading.Condition()


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        st: _State = self.server.state  # type: ignore[attr-defined]
        reader = _Reader(self.request)
        # a command's reply is gathered whole and sent with one sendall:
        # an XREADGROUP of 256 entries is one write, not ~1,800
        self._out: List[bytes] = []
        while True:
            try:
                cmd = reader.read_reply()
            except (ConnectionError, OSError):
                return
            if not isinstance(cmd, list) or not cmd:
                self._send(b"-ERR protocol error\r\n")
            else:
                name = cmd[0].upper()
                try:
                    fn = getattr(self, "_cmd_" + name.decode().lower(), None)
                    if fn is None:
                        self._send(b"-ERR unknown command '%s'\r\n" % name)
                    else:
                        fn(st, cmd[1:])
                except (ConnectionError, OSError):
                    return
                except Exception as e:  # command bug → error reply, keep
                    self._out.clear()   # serving (no partial reply)
                    self._send(b"-ERR %s\r\n" % str(e).encode())
            try:
                self.request.sendall(b"".join(self._out))
            except (ConnectionError, OSError):
                return
            self._out.clear()

    # --- reply helpers ---
    def _send(self, raw: bytes):
        self._out.append(raw)

    def _simple(self, s: bytes):
        self._send(b"+%s\r\n" % s)

    def _int(self, n: int):
        self._send(b":%d\r\n" % n)

    def _bulk(self, b: Optional[bytes]):
        if b is None:
            self._send(b"$-1\r\n")
        else:
            self._send(b"$%d\r\n%s\r\n" % (len(b), b))

    def _array(self, items):
        if items is None:
            self._send(b"*-1\r\n")
            return
        self._send(b"*%d\r\n" % len(items))
        for it in items:
            if isinstance(it, list):
                self._array(it)
            elif isinstance(it, int):
                self._int(it)
            else:
                self._bulk(it)

    # --- commands ---
    def _cmd_ping(self, st, args):
        self._simple(b"PONG")

    def _cmd_xadd(self, st, args):
        key, eid, fields = args[0], args[1], args[2:]
        with st.cv:
            s = st.streams.setdefault(key, _Stream())
            if eid == b"*":
                s.seq += 1
                eid = b"%d-%d" % (int(time.time() * 1000), s.seq)
            s.entries.append((eid, list(fields)))
            st.cv.notify_all()
        self._bulk(eid)

    @staticmethod
    def _id_key(eid: bytes):
        ms, _, seq = eid.partition(b"-")
        return (int(ms), int(seq or b"0"))

    def _cmd_xrange(self, st, args):
        # XRANGE key start end [COUNT n] — enough for the brokers'
        # head-of-line age probe (start '-', end '+', COUNT 1)
        key, start, end = args[0], args[1], args[2]
        count = None
        for i, a in enumerate(args[3:]):
            if a.upper() == b"COUNT":
                count = int(args[3 + i + 1])
        lo = None if start == b"-" else self._id_key(start)
        hi = None if end == b"+" else self._id_key(end)
        out = []
        with st.cv:
            s = st.streams.get(key)
            for e in (s.entries if s else []):
                if e is None:
                    continue
                k = self._id_key(e[0])
                if (lo is None or k >= lo) and (hi is None or k <= hi):
                    out.append([e[0], list(e[1])])
                    if count is not None and len(out) >= count:
                        break
        self._array(out)

    def _cmd_xlen(self, st, args):
        with st.cv:
            s = st.streams.get(args[0])
            n = sum(e is not None for e in s.entries) if s else 0
        self._int(n)

    def _cmd_xgroup(self, st, args):
        sub = args[0].upper()
        if sub != b"CREATE":
            raise ValueError("only XGROUP CREATE supported")
        key, group, start = args[1], args[2], args[3]
        mkstream = any(a.upper() == b"MKSTREAM" for a in args[4:])
        with st.cv:
            s = st.streams.get(key)
            if s is None:
                if not mkstream:
                    self._send(b"-ERR The XGROUP subcommand requires the key"
                               b" to exist\r\n")
                    return
                s = st.streams.setdefault(key, _Stream())
            if group in s.groups:
                self._send(b"-BUSYGROUP Consumer Group name already "
                           b"exists\r\n")
                return
            nxt = 0 if start == b"0" else len(s.entries)
            s.groups[group] = {"next": nxt, "pel": {}}
        self._simple(b"OK")

    def _cmd_xreadgroup(self, st, args):
        # XREADGROUP GROUP g c [COUNT n] [BLOCK ms] STREAMS key >
        it = iter(args)
        group = consumer = None
        count, block_ms, keys = 1, None, []
        tok = next(it)
        while True:
            u = tok.upper()
            if u == b"GROUP":
                group, consumer = next(it), next(it)
            elif u == b"COUNT":
                count = int(next(it))
            elif u == b"BLOCK":
                block_ms = int(next(it))
            elif u == b"STREAMS":
                keys = list(it)
                break
            try:
                tok = next(it)
            except StopIteration:
                break
        key = keys[0]  # single-stream use only
        # Redis semantics: no BLOCK → return immediately; BLOCK 0 → forever
        deadline = None
        if block_ms is None:
            deadline = time.time()
        elif block_ms > 0:
            deadline = time.time() + block_ms / 1000.0
        reply = error = None
        with st.cv:
            while True:
                s = st.streams.get(key)
                g = s.groups.get(group) if s else None
                if g is None:
                    error = b"-NOGROUP No such consumer group\r\n"
                    break
                avail = len(s.entries) - g["next"]
                if avail > 0:
                    take = min(avail, count)
                    window = s.entries[g["next"]:g["next"] + take]
                    ents = [e for e in window if e is not None]
                    g["next"] += take
                    now = time.time()
                    for eid, _ in ents:
                        g["pel"][eid] = (consumer, now)
                    reply = [[key, [[eid, f] for eid, f in ents]]]
                    break
                if deadline is not None and time.time() >= deadline:
                    break
                st.cv.wait(None if deadline is None
                           else max(0.0, deadline - time.time()))
        # send outside the state lock: a slow client draining a large reply
        # must not stall every other connection
        if error is not None:
            self._send(error)
        else:
            self._array(reply)

    def _cmd_xautoclaim(self, st, args):
        # XAUTOCLAIM key group consumer min-idle-time start [COUNT n]
        key, group, consumer, min_idle_ms = args[0], args[1], args[2], \
            int(args[3])
        count = 100
        rest = args[5:]
        for i, a in enumerate(rest):
            if a.upper() == b"COUNT":
                count = int(rest[i + 1])
        claimed = []
        with st.cv:
            s = st.streams.get(key)
            g = s.groups.get(group) if s else None
            if g is None:
                pass
            else:
                now = time.time()
                by_id = {e[0]: e[1] for e in s.entries if e is not None}
                for eid in list(g["pel"]):
                    owner, t = g["pel"][eid]
                    if (now - t) * 1000 < min_idle_ms:
                        continue
                    fields = by_id.get(eid)
                    if fields is None:      # XDELed while pending
                        del g["pel"][eid]
                        continue
                    g["pel"][eid] = (consumer, now)
                    claimed.append([eid, fields])
                    if len(claimed) >= count:
                        break
        self._array([b"0-0", claimed])

    def _cmd_xdel(self, st, args):
        """Tombstone entries, then drop the consumed prefix (the broker XDELs
        in claim order, so acked history compacts away and memory stays
        bounded)."""
        key, ids = args[0], set(args[1:])
        n = 0
        with st.cv:
            s = st.streams.get(key)
            if s:
                for i, e in enumerate(s.entries):
                    if e is not None and e[0] in ids:
                        s.entries[i] = None
                        n += 1
                drop = 0
                min_next = min((g["next"] for g in s.groups.values()),
                               default=len(s.entries))
                while drop < min_next and s.entries[drop] is None:
                    drop += 1
                if drop:
                    del s.entries[:drop]
                    for g in s.groups.values():
                        g["next"] -= drop
        self._int(n)

    def _cmd_xpending(self, st, args):
        # XPENDING key group — summary form: [count, min-id, max-id,
        # [[consumer, count-as-string], ...]]
        key, group = args[0], args[1]
        with st.cv:
            s = st.streams.get(key)
            g = s.groups.get(group) if s else None
            pel = dict(g["pel"]) if g else {}
        if not pel:
            self._array([0, None, None, None])
            return
        ids = sorted(pel)
        per: Dict[bytes, int] = {}
        for _eid, (consumer, _t) in pel.items():
            per[consumer] = per.get(consumer, 0) + 1
        self._array([len(pel), ids[0], ids[-1],
                     [[c, str(n).encode()] for c, n in sorted(per.items())]])

    def _cmd_xack(self, st, args):
        key, group, ids = args[0], args[1], args[2:]
        n = 0
        with st.cv:
            s = st.streams.get(key)
            g = s.groups.get(group) if s else None
            if g:
                for eid in ids:
                    if g["pel"].pop(eid, None) is not None:
                        n += 1
        self._int(n)

    def _cmd_hset(self, st, args):
        key, pairs = args[0], args[1:]
        with st.cv:
            h = st.hashes.setdefault(key, {})
            added = 0
            for i in range(0, len(pairs), 2):
                if pairs[i] not in h:
                    added += 1
                h[pairs[i]] = pairs[i + 1]
            st.cv.notify_all()
        self._int(added)

    def _cmd_hgetall(self, st, args):
        with st.cv:
            h = st.hashes.get(args[0], {})
            flat = []
            for k, v in h.items():
                flat += [k, v]
        self._array(flat)

    def _cmd_hget(self, st, args):
        with st.cv:
            h = st.hashes.get(args[0], {})
            self._bulk(h.get(args[1]))

    def _cmd_hdel(self, st, args):
        key, fields = args[0], args[1:]
        n = 0
        with st.cv:
            h = st.hashes.get(key)
            if h:
                for f in fields:
                    if h.pop(f, None) is not None:
                        n += 1
                if not h:
                    st.hashes.pop(key, None)
        self._int(n)

    def _cmd_del(self, st, args):
        n = 0
        with st.cv:
            for k in args:
                if st.hashes.pop(k, None) is not None:
                    n += 1
                if st.streams.pop(k, None) is not None:
                    n += 1
        self._int(n)


class MiniRedisServer:
    """Threaded RESP2 server for the streams/hashes subset.

    Start one per host to get cross-process serving without installing
    Redis: ``MiniRedisServer(port=6379).start()``; point brokers at
    ``redis://127.0.0.1:6379/stream``.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _Srv((host, port), _Handler)
        self._srv.state = _State()  # type: ignore[attr-defined]
        self.host, self.port = self._srv.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MiniRedisServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        name="mini-redis", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()

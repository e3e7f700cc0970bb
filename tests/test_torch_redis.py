"""The port's Redis transport and record routing (serving/redis_protocol.py,
streaming/records.py) against the JAX package's, on the CPU.

These modules were missing from the port while its ``queue_api`` imported
them: ``RedisBroker``, ``make_broker("redis://...")``, ``InputQueue(host,
port)`` and ``make_broker("...?partitions=N")`` died with
``ModuleNotFoundError``. Here each works, and talks to the JAX package's
side of the wire:

* the port's ``RedisClient`` against the JAX ``MiniRedisServer`` and the
  JAX client against the port's server;
* ``encode_record`` bytes identical, ``decode_record``/``record_key``
  read the JAX package's records;
* ``partition_for`` and ``PartitionedBroker`` (``?partitions=4``) route
  every record and id to the partition the JAX package picks;
* ``make_broker("redis://...")`` and the client queues round-trip a
  request through a served model.
"""

import numpy as np
import pytest

from analytics_zoo_tpu.serving import queue_api as jq
from analytics_zoo_tpu.serving import redis_protocol as jr
from analytics_zoo_tpu.streaming import records as jrec
from analytics_zoo_tpu_torch import streaming as trec
from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                             OutputQueue, PartitionedBroker,
                                             RedisBroker, RedisClient,
                                             make_broker, partitioned_spec)
from analytics_zoo_tpu_torch.serving import redis_protocol as tr


@pytest.fixture()
def servers():
    started = []

    def start(mod):
        srv = mod.MiniRedisServer(port=0).start()
        started.append(srv)
        return srv

    yield start
    for srv in started:
        srv.stop()


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("jax", "port"), ("port", "jax"),
                          ("port", "port")])
def test_client_and_server_interoperate(servers, server_pkg, client_pkg):
    srv = servers(jr if server_pkg == "jax" else tr)
    client = (jr if client_pkg == "jax" else tr).RedisClient(
        srv.host, srv.port)
    try:
        assert client.ping()
        client.execute("XGROUP", "CREATE", "s", "g", "$", "MKSTREAM")
        ids = [client.execute("XADD", "s", "*", "uri", f"u{i}", "data",
                              bytes([i]) * 3) for i in range(3)]
        assert client.execute("XLEN", "s") == 3
        got = client.execute("XREADGROUP", "GROUP", "g", "c", "COUNT", 10,
                             "STREAMS", "s", ">")
        entries = got[0][1]
        assert [e[0] for e in entries] == ids
        assert entries[1][1] == [b"uri", b"u1", b"data", b"\x01\x01\x01"]
        assert client.execute("XACK", "s", "g", *ids) == 3
        client.execute("HSET", "r", "value", b"x")
        assert client.execute("HGETALL", "r") == [b"value", b"x"]
        assert client.execute("DEL", "r") == 1
    finally:
        client.close()


def test_encode_record_bytes_and_keys_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.rand(3, 4).astype(np.float32), np.int32(7))
    y = rng.randint(0, 5, (2,)).astype(np.int64)
    for kw in ({}, {"key": "user-17", "event_time": 12.5}):
        raw = trec.encode_record(x, y, **kw)
        assert raw == jrec.encode_record(x, y, **kw)
        tx, ty, tt = trec.decode_record(jrec.encode_record(x, y, **kw))
        np.testing.assert_array_equal(tx[0], x[0])
        assert tx[1].shape == () and int(tx[1]) == 7
        np.testing.assert_array_equal(ty[0], y)
        assert tt == kw.get("event_time", 0.0)
        assert trec.record_key(raw) == kw.get("key")
    assert trec.seq_id(42) == jrec.seq_id(42)
    with pytest.raises(ValueError, match="magic"):
        trec.decode_record(b"nope" + b"\0" * 8)


def test_partition_routing_matches_jax():
    keys = [f"key-{i}" for i in range(200)] + ["", "ünïcode", "x" * 300]
    for n in (1, 3, 4, 16):
        assert [trec.partition_for(k, n) for k in keys] == \
            [jrec.partition_for(k, n) for k in keys]
    with pytest.raises(ValueError):
        trec.partition_for("a", 0)
    spec = "memory://route_test?partitions=4"
    tb, jb = make_broker(spec), jq.make_broker(spec)
    assert isinstance(tb, PartitionedBroker) and len(tb.parts) == 4
    assert partitioned_spec(spec, 2) == jq.partitioned_spec(spec, 2)
    rng = np.random.RandomState(1)
    for i in range(64):
        keyed = trec.encode_record(rng.rand(2).astype(np.float32),
                                   key=f"cohort-{i % 9}")
        for payload in (keyed, b"opaque-%d" % i):
            item = f"item-{i}"
            assert tb.partition_of(item, payload) == \
                jb.partition_of(item, payload)


def test_partitioned_broker_round_trip():
    b = make_broker("memory://part_rt?partitions=4")
    sent = {f"id-{i}": trec.encode_record(np.float32(i), key=f"k{i % 5}")
            for i in range(20)}
    for item, payload in sent.items():
        b.enqueue(item, payload)
    assert b.pending() == 20
    got = {}
    while len(got) < 20:
        for item, payload in b.claim_batch(8, 0.05):
            got[item] = payload
    assert {k: bytes(v) for k, v in got.items()} == sent
    b.ack_many(list(got))
    b.put_result("id-3", b"answer")
    assert b.get_result("id-3", timeout_s=1.0) == b"answer"


class _Double:
    """A served model: twice its input."""

    device_count = 1

    def predict(self, x):
        return np.asarray(x) * 2


def test_make_broker_redis_round_trip(servers):
    """The repaired fault: ``make_broker("redis://host:port/stream")`` and
    ``InputQueue(host=, port=)`` reach ``RedisBroker`` and serve."""
    srv = servers(tr)
    broker = make_broker(f"redis://{srv.host}:{srv.port}/od_stream")
    assert isinstance(broker, RedisBroker)
    serving = ClusterServing(_Double(), queue=broker, batch_size=4,
                             batch_timeout_ms=5).start()
    try:
        iq = InputQueue(host=srv.host, port=srv.port, name="od_stream")
        oq = OutputQueue(host=srv.host, port=srv.port, name="od_stream")
        assert isinstance(iq.broker, RedisBroker)
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        uris = [iq.enqueue(f"r-{i}", t=x + i) for i in range(6)]
        res = oq.dequeue(uris, timeout_s=30)
    finally:
        serving.stop()
    for i, u in enumerate(uris):
        np.testing.assert_array_equal(res[u], (x + i) * 2)
    client = RedisClient(srv.host, srv.port)
    assert client.execute("XLEN", "od_stream") == 0    # acked, deleted
    client.close()

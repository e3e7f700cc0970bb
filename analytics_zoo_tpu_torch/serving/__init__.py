"""Cluster Serving (counterpart of ``analytics_zoo_tpu/serving``): client
queues, codecs, the continuous scheduler, the engine and the brokers:
in-memory, file, Redis streams over RESP2 (``RedisBroker``, with the
bundled ``MiniRedisServer`` for hosts without a Redis) and the keyed
``PartitionedBroker`` (``make_broker("...?partitions=N")``); the
scale-out tier (``ServingFleet`` worker processes under an
``Autoscaler``, ``fleet.py``) and the HTTP frontend
(``http_frontend.py``, HTTP/1.1 over asyncio streams)."""

from .client import InputQueue, OutputQueue
from .codecs import SparseTensor
from .engine import ClusterServing, Timer
from .fleet import Autoscaler, ServingFleet, SleepModel, sleep_model_factory
from .queue_api import (FileBroker, InMemoryBroker, PartitionedBroker,
                        RedisBroker, make_broker, partitioned_spec)
from .redis_protocol import MiniRedisServer, RedisClient
from .scheduler import ContinuousScheduler, ModelMultiplexer

__all__ = ["InputQueue", "OutputQueue", "ClusterServing", "Timer",
           "InMemoryBroker", "FileBroker", "RedisBroker", "MiniRedisServer",
           "RedisClient", "make_broker", "partitioned_spec",
           "PartitionedBroker", "SparseTensor",
           "ContinuousScheduler", "ModelMultiplexer",
           "ServingFleet", "Autoscaler", "SleepModel",
           "sleep_model_factory"]

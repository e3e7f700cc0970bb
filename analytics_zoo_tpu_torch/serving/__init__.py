"""Cluster Serving (counterpart of ``analytics_zoo_tpu/serving``): client
queues, codecs, the continuous scheduler and the engine. The Redis,
partitioned and fleet transports are imported lazily by ``make_broker``
and raise until their modules are ported."""

from .client import InputQueue, OutputQueue
from .codecs import SparseTensor
from .engine import ClusterServing, Timer
from .queue_api import FileBroker, InMemoryBroker, make_broker
from .scheduler import ContinuousScheduler, ModelMultiplexer

__all__ = ["InputQueue", "OutputQueue", "ClusterServing", "Timer",
           "InMemoryBroker", "FileBroker", "make_broker", "SparseTensor",
           "ContinuousScheduler", "ModelMultiplexer"]

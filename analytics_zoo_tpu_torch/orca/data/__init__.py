"""Orca data (counterpart of ``analytics_zoo_tpu/orca/data``): XShards over
host-local partitions (``shard.py``), the chunked column views batches are
gathered from (``chunked.py``), the streaming ImageNet pipeline
(``image/imagenet.py``) and the parquet datasets
(``image/parquet_dataset.py``). The pandas readers ``read_csv``, ``read_json``
and ``read_parquet`` are in ``orca.data.pandas``.

``ImageNetPipeline`` is imported on first use: its module builds on
``orca/learn/utils.py``, which imports this package."""

from .shard import HostXShards, SharedValue, SparkXShards, XShards

__all__ = ["XShards", "HostXShards", "SparkXShards", "SharedValue",
           "ImageNetPipeline"]


def __getattr__(name):
    if name == "ImageNetPipeline":
        from .image import ImageNetPipeline
        return ImageNetPipeline
    raise AttributeError(name)

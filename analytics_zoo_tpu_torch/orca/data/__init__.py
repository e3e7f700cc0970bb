"""Orca data (counterpart of ``analytics_zoo_tpu/orca/data``): so far the
streaming ImageNet pipeline of ``image/imagenet.py``. XShards, chunked
arrays and the other readers are not ported yet."""

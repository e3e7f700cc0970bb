"""Typed configuration for the TPU cluster context.

The reference scatters configuration across `OrcaContextMeta` class properties
(reference: pyzoo/zoo/orca/common.py:21-121), Spark conf keys loaded at context
init (pyzoo/zoo/common/nncontext.py:415-470) and ad-hoc env vars. Here it is a
single typed object with env-var overrides (``AZT_<FIELD>``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get(f"AZT_{name.upper()}")
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


@dataclass
class OrcaConfig:
    """Cluster + runtime configuration.

    Mirrors the knobs of ``OrcaContextMeta`` (reference:
    pyzoo/zoo/orca/common.py:43-121) that still make sense without Spark/Ray:

    * ``pandas_read_backend`` -> kept (pandas vs pyarrow readers)
    * ``serialize_data_creator`` -> kept as ``lock_data_creators`` (file-lock
      around data creation per host)
    * ``train_data_store`` DRAM/PMEM/DISK_n -> ``data_store`` (DRAM | DISK)
    * ``_shard_size`` -> ``shard_size``
    """

    cluster_mode: str = "local"  # local | tpu | multihost | cpu-sim
    num_processes: int = 1       # multihost: number of host processes
    process_id: int = 0
    coordinator_address: Optional[str] = None

    # mesh shape requests; -1 means "all remaining devices"
    mesh_axes: Dict[str, int] = field(default_factory=lambda: {"dp": -1})

    # data plane
    pandas_read_backend: str = "pandas"
    shard_size: Optional[int] = None
    data_store: str = "DRAM"
    lock_data_creators: bool = False

    # numerics
    default_dtype: str = "bfloat16"  # matmul/activation dtype on TPU
    param_dtype: str = "float32"

    # observability
    log_level: str = "INFO"
    profile_dir: Optional[str] = None

    # misc knobs
    barrier_mode: bool = True
    extra: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name in ("mesh_axes", "extra"):
                continue
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))

    def replace(self, **kw) -> "OrcaConfig":
        return dataclasses.replace(self, **kw)


class OrcaContextMeta(type):
    """Class-property style global knobs, API-compatible with the reference's
    ``OrcaContext`` (pyzoo/zoo/orca/common.py:21-121)."""

    _pandas_read_backend = "pandas"
    _serialize_data_creator = False
    _shard_size: Optional[int] = None
    _train_data_store = "DRAM"
    _eager_mode = True
    _log_output = False

    @property
    def pandas_read_backend(cls):
        return cls._pandas_read_backend

    @pandas_read_backend.setter
    def pandas_read_backend(cls, value):
        value = value.lower()
        assert value in ("spark", "pandas", "pyarrow"), \
            "pandas_read_backend must be 'pandas' or 'pyarrow'"
        # "spark" accepted for source compatibility; maps to pyarrow
        cls._pandas_read_backend = "pyarrow" if value == "spark" else value

    @property
    def serialize_data_creator(cls):
        return cls._serialize_data_creator

    @serialize_data_creator.setter
    def serialize_data_creator(cls, value):
        assert isinstance(value, bool)
        cls._serialize_data_creator = value

    @property
    def _shard_size_(cls):
        return cls._shard_size

    @property
    def train_data_store(cls):
        return cls._train_data_store

    @train_data_store.setter
    def train_data_store(cls, value):
        value = value.upper()
        assert value in ("DRAM", "DISK") or value.startswith("DISK_"), \
            "train_data_store must be DRAM, DISK or DISK_n"
        cls._train_data_store = value

    @property
    def log_output(cls):
        return cls._log_output

    @log_output.setter
    def log_output(cls, value):
        assert isinstance(value, bool)
        cls._log_output = value


class OrcaContext(metaclass=OrcaContextMeta):
    pass

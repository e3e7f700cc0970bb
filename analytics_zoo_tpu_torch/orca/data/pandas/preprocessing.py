"""File readers producing XShards of pandas DataFrames (counterpart of
``analytics_zoo_tpu/orca/data/pandas/preprocessing.py``).

Files are globbed, striped across the processes of the cluster context
(process i of n reads every n-th file; one process today), and parsed on
the shard thread pool with pandas, or with pyarrow's CSV reader when
``OrcaContext.pandas_read_backend`` is ``"pyarrow"`` and pyarrow is
installed. A read of fewer files than the context has local devices is
repartitioned into one partition per device when it has that many rows.
pandas is imported inside the readers only.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import List, Optional

from ....common.config import OrcaContext
from ....common.context import current_context
from ..shard import HostXShards, _pmap


def _expand_paths(file_path: str, ext: Optional[str] = None) -> List[str]:
    paths: List[str] = []
    for piece in file_path.split(","):
        piece = piece.strip()
        if os.path.isdir(piece):
            found = sorted(
                p for p in _glob.glob(os.path.join(piece, "**", "*"),
                                      recursive=True)
                if os.path.isfile(p) and not os.path.basename(p).startswith(
                    ("_", ".")))
            if ext:
                found = [p for p in found if p.endswith(ext)]
            paths.extend(found)
        else:
            expanded = sorted(_glob.glob(piece)) if any(
                c in piece for c in "*?[") else [piece]
            paths.extend(expanded)
    if not paths:
        raise FileNotFoundError(f"no input files match {file_path}")
    # each process reads its own stripe of the file list
    ctx = current_context()
    pid, n = (ctx.process_id, ctx.num_processes) if ctx else (0, 1)
    return paths[pid::n] if n > 1 else paths


def read_csv(file_path: str, **kwargs) -> HostXShards:
    """Read csv file(s)/dir/glob into an XShards of pandas DataFrames."""
    return _read_files(file_path, "csv", **kwargs)


def read_json(file_path: str, **kwargs) -> HostXShards:
    return _read_files(file_path, "json", **kwargs)


def read_parquet(file_path: str, columns=None, **options) -> HostXShards:
    paths = _expand_paths(file_path, ext=None)
    paths = [p for p in paths if p.endswith(".parquet") or os.path.isfile(p)]

    def load(p):
        import pandas as pd
        return pd.read_parquet(p, columns=columns, **options)

    return HostXShards(_pmap(load, paths))


def _read_files(file_path: str, file_type: str, **kwargs) -> HostXShards:
    paths = _expand_paths(file_path)
    backend = OrcaContext.pandas_read_backend

    def load(p):
        import pandas as pd
        if file_type == "json":
            return pd.read_json(p, **kwargs)
        if backend == "pyarrow" and not kwargs:
            from pyarrow import csv as pacsv
            return pacsv.read_csv(p).to_pandas()
        return pd.read_csv(p, **kwargs)

    shards = HostXShards(_pmap(load, paths))
    ctx = current_context()
    target = max(len(ctx.local_devices), 1) if ctx else 1
    if shards.num_partitions() < target and len(shards) >= target:
        shards = shards.repartition(target)
    return shards

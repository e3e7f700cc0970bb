"""Friesian feature tables (counterpart of ``analytics_zoo_tpu/friesian/
feature/table.py``; parity: pyzoo/zoo/friesian/feature/table.py --
Table:34, FeatureTable:283, StringIndex:586; Scala friesian/feature/
Utils.scala).

A Table wraps a pandas DataFrame (arrow-backed IO) and every op returns a
new Table. This is the host-side feature-engineering layer: its output
feeds XShards and the estimators, which copy batches to the card. The ops
are the JAX package's, line for line, so both packages give equal frames
on one pandas: ``gen_string_idx`` orders by ``value_counts`` (ties are
pandas'), ``cross_columns`` hashes with ``zlib.crc32``, the negative
samplers draw from ``np.random.RandomState(0)``, ``to_shards`` cuts
``os.cpu_count() // 2`` parts (the port's ``HostXShards``), and
``add_hist_seq`` walks each user's rows in Python.

pandas is imported inside the functions that build frames, so importing
this module does not import it."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ...orca.data.shard import HostXShards


def _as_list(cols) -> List[str]:
    if cols is None:
        return []
    if isinstance(cols, str):
        return [cols]
    return list(cols)


class Table:
    def __init__(self, df: pd.DataFrame):
        self.df = df

    # --- IO -----------------------------------------------------------------
    @staticmethod
    def _read_parquet(paths) -> pd.DataFrame:
        import pandas as pd
        paths = _as_list(paths)
        frames = [pd.read_parquet(p) for p in paths]
        return pd.concat(frames, ignore_index=True) if len(frames) > 1 \
            else frames[0]

    @staticmethod
    def _read_json(paths, cols) -> pd.DataFrame:
        import pandas as pd
        frames = [pd.read_json(p, lines=p.endswith(".jsonl"))
                  for p in _as_list(paths)]
        df = pd.concat(frames, ignore_index=True) if len(frames) > 1 \
            else frames[0]
        return df[_as_list(cols)] if cols else df

    @staticmethod
    def _read_csv(paths, **kwargs) -> pd.DataFrame:
        import pandas as pd
        frames = [pd.read_csv(p, **kwargs) for p in _as_list(paths)]
        return pd.concat(frames, ignore_index=True) if len(frames) > 1 \
            else frames[0]

    def write_parquet(self, path: str, mode: str = "overwrite"):
        if mode == "overwrite" or not os.path.exists(path):
            self.df.to_parquet(path)
        else:
            raise FileExistsError(path)

    # --- basics -------------------------------------------------------------
    def _clone(self, df) -> "Table":
        return type(self)(df)

    def compute(self) -> "Table":
        return self

    def to_pandas(self) -> pd.DataFrame:
        return self.df.copy()

    def size(self) -> int:
        return len(self.df)

    def __len__(self) -> int:
        return len(self.df)

    @property
    def schema(self):
        return dict(self.df.dtypes)

    def col_names(self) -> List[str]:
        return list(self.df.columns)

    def drop(self, *cols) -> "Table":
        return self._clone(self.df.drop(columns=list(cols)))

    def distinct(self) -> "Table":
        return self._clone(self.df.drop_duplicates().reset_index(drop=True))

    def filter(self, condition) -> "Table":
        """condition: boolean Series/array or a df->mask callable."""
        mask = condition(self.df) if callable(condition) else condition
        return self._clone(self.df[mask].reset_index(drop=True))

    def show(self, n: int = 20, truncate: bool = True):
        print(self.df.head(n).to_string())

    def rename(self, columns: Dict[str, str]) -> "Table":
        return self._clone(self.df.rename(columns=columns))

    # --- cleaning -----------------------------------------------------------
    def fillna(self, value, columns) -> "Table":
        cols = _as_list(columns) or list(self.df.columns)
        df = self.df.copy()
        df[cols] = df[cols].fillna(value)
        return self._clone(df)

    def dropna(self, columns=None, how: str = "any",
               thresh: Optional[int] = None) -> "Table":
        cols = _as_list(columns) or None
        kwargs = dict(subset=cols)
        if thresh is not None:
            kwargs["thresh"] = thresh
        else:
            kwargs["how"] = how
        return self._clone(self.df.dropna(**kwargs).reset_index(drop=True))

    def clip(self, columns, min=None, max=None) -> "Table":
        cols = _as_list(columns)
        df = self.df.copy()
        df[cols] = df[cols].clip(lower=min, upper=max)
        return self._clone(df)

    def log(self, columns, clipping: bool = True) -> "Table":
        cols = _as_list(columns)
        df = self.df.copy()
        for c in cols:
            v = df[c].astype(float)
            if clipping:
                v = v.clip(lower=0)
            df[c] = np.log(v + 1.0)
        return self._clone(df)

    def median(self, columns) -> pd.DataFrame:
        import pandas as pd
        cols = _as_list(columns)
        return pd.DataFrame({"column": cols,
                             "median": [self.df[c].median() for c in cols]})

    def fill_median(self, columns) -> "Table":
        cols = _as_list(columns)
        df = self.df.copy()
        for c in cols:
            df[c] = df[c].fillna(df[c].median())
        return self._clone(df)

    def merge_cols(self, columns, target: str) -> "Table":
        cols = _as_list(columns)
        df = self.df.copy()
        df[target] = df[cols].values.tolist()
        return self._clone(df.drop(columns=cols))

    # --- joins --------------------------------------------------------------
    def join(self, table: "Table", on=None, how: str = "inner") -> "Table":
        return self._clone(self.df.merge(table.df, on=on, how=how or "inner"))


class FeatureTable(Table):
    """reference table.py:283 — categorical encode, crosses, normalization,
    negative sampling, history sequences, pad/mask."""

    @classmethod
    def read_parquet(cls, paths) -> "FeatureTable":
        return cls(Table._read_parquet(paths))

    @classmethod
    def read_json(cls, paths, cols=None) -> "FeatureTable":
        return cls(Table._read_json(paths, cols))

    @classmethod
    def read_csv(cls, paths, **kwargs) -> "FeatureTable":
        return cls(Table._read_csv(paths, **kwargs))

    @classmethod
    def from_pandas(cls, df: pd.DataFrame) -> "FeatureTable":
        return cls(df.copy())

    # --- categorical encoding ----------------------------------------------
    def gen_string_idx(self, columns, freq_limit: Optional[int] = None
                       ) -> List["StringIndex"]:
        """Build 1-based frequency-ordered string indices (reference
        gen_string_idx: id 1 = most frequent; freq_limit drops rare)."""
        import pandas as pd
        out = []
        for c in _as_list(columns):
            vc = self.df[c].value_counts()
            if freq_limit:
                vc = vc[vc >= int(freq_limit)]
            idx_df = pd.DataFrame({c: vc.index,
                                   "id": np.arange(1, len(vc) + 1)})
            out.append(StringIndex(idx_df, c))
        return out

    def encode_string(self, columns, indices) -> "FeatureTable":
        cols = _as_list(columns)
        if not isinstance(indices, (list, tuple)):
            indices = [indices]
        df = self.df.copy()
        for c, si in zip(cols, indices):
            mapping = si.to_mapping()
            df[c] = df[c].map(mapping).fillna(0).astype(np.int64)
        return FeatureTable(df)

    def gen_ind2ind(self, cols, indices) -> "FeatureTable":
        sub = self.encode_string(cols, indices)
        return FeatureTable(sub.df[_as_list(cols)].drop_duplicates()
                            .reset_index(drop=True))

    def cross_columns(self, crossed_columns, bucket_sizes) -> "FeatureTable":
        """Hash-cross column tuples into buckets (reference cross_columns).
        crc32 keeps bucket ids stable across processes — python's builtin
        hash() is salted per interpreter, which would scramble serving-time
        lookups against a model trained in another process."""
        import zlib
        df = self.df.copy()
        for cols, bucket in zip(crossed_columns, bucket_sizes):
            name = "_".join(cols)
            joined = df[cols[0]].astype(str)
            for c in cols[1:]:
                joined = joined + "_" + df[c].astype(str)
            df[name] = joined.map(
                lambda s: zlib.crc32(s.encode())).astype(np.int64) \
                % int(bucket)
        return FeatureTable(df)

    def normalize(self, columns) -> "FeatureTable":
        """Min-max scale to [0, 1] (reference normalize)."""
        df = self.df.copy()
        for c in _as_list(columns):
            v = df[c].astype(float)
            lo, hi = v.min(), v.max()
            df[c] = (v - lo) / (hi - lo) if hi > lo else 0.0
        return FeatureTable(df)

    # --- recsys-specific ----------------------------------------------------
    def add_negative_samples(self, item_size: int, item_col: str = "item",
                             label_col: str = "label", neg_num: int = 1
                             ) -> "FeatureTable":
        """Positive rows get label 1; each spawns neg_num rows with random
        other items and label 0 (reference add_negative_samples)."""
        import pandas as pd
        df = self.df.copy()
        df[label_col] = 1
        rng = np.random.RandomState(0)
        neg = df.loc[df.index.repeat(neg_num)].copy()
        rand_items = rng.randint(1, item_size, len(neg))
        # re-draw collisions with the positive item once (cheap, near-exact)
        coll = rand_items == neg[item_col].to_numpy()
        rand_items[coll] = (rand_items[coll] % (item_size - 1)) + 1
        neg[item_col] = rand_items
        neg[label_col] = 0
        return FeatureTable(pd.concat([df, neg], ignore_index=True))

    def add_hist_seq(self, user_col: str, cols, sort_col: str = "time",
                     min_len: int = 1, max_len: int = 100) -> "FeatureTable":
        """Per-user rolling history of `cols` (reference add_hist_seq)."""
        import pandas as pd
        cols = _as_list(cols)
        df = self.df.sort_values([user_col, sort_col])
        out_rows = []
        for _, grp in df.groupby(user_col, sort=False):
            recs = grp.to_dict("records")
            for i in range(len(recs)):
                hist = recs[max(0, i - max_len):i]
                if len(hist) < min_len:
                    continue
                row = dict(recs[i])
                for c in cols:
                    row[f"{c}_hist_seq"] = [h[c] for h in hist]
                out_rows.append(row)
        return FeatureTable(pd.DataFrame(out_rows))

    def add_neg_hist_seq(self, item_size: int, item_history_col: str,
                         neg_num: int) -> "FeatureTable":
        rng = np.random.RandomState(0)
        df = self.df.copy()

        def neg_of(seq):
            return [[int(x) for x in rng.randint(1, item_size, neg_num)]
                    for _ in seq]
        df["neg_" + item_history_col] = df[item_history_col].map(neg_of)
        return FeatureTable(df)

    def pad(self, padding_cols, seq_len: int = 100) -> "FeatureTable":
        df = self.df.copy()
        for c in _as_list(padding_cols):
            df[c] = df[c].map(
                lambda s: (list(s)[:seq_len] +
                           [0] * max(0, seq_len - len(s))))
        return FeatureTable(df)

    def mask(self, mask_cols, seq_len: int = 100) -> "FeatureTable":
        df = self.df.copy()
        for c in _as_list(mask_cols):
            df[c + "_mask"] = df[c].map(
                lambda s: ([1] * min(len(s), seq_len) +
                           [0] * max(0, seq_len - len(s))))
        return FeatureTable(df)

    def mask_pad(self, padding_cols, mask_cols, seq_len: int = 100
                 ) -> "FeatureTable":
        return self.mask(mask_cols, seq_len).pad(padding_cols, seq_len)

    def add_length(self, col_name: str) -> "FeatureTable":
        df = self.df.copy()
        df[col_name + "_length"] = df[col_name].map(len)
        return FeatureTable(df)

    def transform_python_udf(self, in_col: str, out_col: str,
                             udf_func) -> "FeatureTable":
        df = self.df.copy()
        df[out_col] = df[in_col].map(udf_func)
        return FeatureTable(df)

    def add_feature(self, item_cols, feature_tbl: "FeatureTable",
                    default_value) -> "FeatureTable":
        """Map item ids to a feature via lookup table (reference
        add_feature)."""
        key_col, val_col = feature_tbl.df.columns[:2]
        mapping = dict(zip(feature_tbl.df[key_col], feature_tbl.df[val_col]))
        df = self.df.copy()
        for c in _as_list(item_cols):
            df[c + "_" + str(val_col)] = df[c].map(
                lambda x: mapping.get(x, default_value))
        return FeatureTable(df)

    # --- bridge to training -------------------------------------------------
    def to_shards(self, num_shards: Optional[int] = None) -> HostXShards:
        n = num_shards or max(1, os.cpu_count() // 2)
        bounds = np.linspace(0, len(self.df), n + 1, dtype=int)
        parts = [self.df.iloc[a:b].reset_index(drop=True)
                 for a, b in zip(bounds[:-1], bounds[1:])]
        return HostXShards(parts)


class StringIndex(Table):
    """Category→1-based id table (reference table.py:586)."""

    def __init__(self, df: pd.DataFrame, col_name: str):
        super().__init__(df)
        self.col_name = col_name

    def _clone(self, df) -> "StringIndex":
        return StringIndex(df, self.col_name)

    @classmethod
    def read_parquet(cls, paths, col_name: Optional[str] = None
                     ) -> "StringIndex":
        df = Table._read_parquet(paths)
        if col_name is None:
            col_name = [c for c in df.columns if c != "id"][0]
        return cls(df, col_name)

    def write_parquet(self, path: str, mode: str = "overwrite"):
        super().write_parquet(path, mode)

    def to_mapping(self) -> Dict:
        return dict(zip(self.df[self.col_name], self.df["id"]))

    def size(self) -> int:
        return len(self.df)

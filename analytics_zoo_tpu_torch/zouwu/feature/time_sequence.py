"""Time-sequence feature engineering — rolling windows + datetime features
(a copy of ``analytics_zoo_tpu/zouwu/feature/time_sequence.py``, with
pandas imported inside the functions that take DataFrames).

Mirrors the reference's TimeSequenceFeatureTransformer
(pyzoo/zoo/zouwu/feature/time_sequence.py: fit_transform builds datetime
features, scales, and rolls (past_seq_len, horizon) windows;
transform/inverse for inference) on pandas/numpy, producing the (x, y)
arrays the forecasters consume."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:
    import pandas as pd

_DT_FEATURES = ("HOUR", "DAY", "WEEKDAY", "MONTH", "IS_WEEKEND")


def gen_dt_features(dt: "pd.Series", features: Sequence[str] = _DT_FEATURES
                    ) -> "pd.DataFrame":
    import pandas as pd
    dt = pd.to_datetime(dt)
    out = {}
    if "HOUR" in features:
        out["HOUR"] = dt.dt.hour
    if "DAY" in features:
        out["DAY"] = dt.dt.day
    if "WEEKDAY" in features:
        out["WEEKDAY"] = dt.dt.weekday
    if "MONTH" in features:
        out["MONTH"] = dt.dt.month
    if "IS_WEEKEND" in features:
        out["IS_WEEKEND"] = (dt.dt.weekday >= 5).astype(int)
    return pd.DataFrame(out, index=dt.index)


def roll_windows(arr: np.ndarray, past: int, horizon: int,
                 target_idx: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """arr (T, F) -> x (n, past, F), y (n, horizon) of column target_idx."""
    T = len(arr)
    n = T - past - horizon + 1
    if n <= 0:
        raise ValueError(
            f"series length {T} too short for past {past} + horizon {horizon}")
    idx = np.arange(past)[None, :] + np.arange(n)[:, None]
    x = arr[idx]
    yidx = np.arange(horizon)[None, :] + np.arange(n)[:, None] + past
    y = arr[yidx, target_idx]
    return x.astype(np.float32), y.astype(np.float32)


class TimeSequenceFeatureTransformer:
    def __init__(self, horizon: int = 1, dt_col: str = "datetime",
                 target_col: str = "value",
                 extra_features_col: Optional[List[str]] = None,
                 drop_missing: bool = True):
        self.horizon = horizon
        self.dt_col = dt_col
        self.target_col = target_col
        self.extra_features_col = list(extra_features_col or [])
        self.drop_missing = drop_missing
        self.past_seq_len: Optional[int] = None
        self._mean = None
        self._std = None

    # --- internals ----------------------------------------------------------
    def _feature_frame(self, df: "pd.DataFrame") -> "pd.DataFrame":
        import pandas as pd
        df = df.sort_values(self.dt_col).reset_index(drop=True)
        if self.drop_missing:
            df = df.dropna(subset=[self.target_col])
        feats = [df[[self.target_col]]]
        if self.extra_features_col:
            feats.append(df[self.extra_features_col])
        feats.append(gen_dt_features(df[self.dt_col]))
        return pd.concat(feats, axis=1)

    # --- public -------------------------------------------------------------
    def fit_transform(self, df: "pd.DataFrame", past_seq_len: int = 50
                      ) -> Tuple[np.ndarray, np.ndarray]:
        self.past_seq_len = past_seq_len
        ff = self._feature_frame(df)
        arr = ff.to_numpy(np.float32)
        self._mean = arr.mean(axis=0)
        self._std = arr.std(axis=0) + 1e-8
        arr = (arr - self._mean) / self._std
        return roll_windows(arr, past_seq_len, self.horizon)

    def transform(self, df: "pd.DataFrame", is_train: bool = False
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        assert self.past_seq_len is not None, "call fit_transform first"
        ff = self._feature_frame(df)
        arr = (ff.to_numpy(np.float32) - self._mean) / self._std
        if is_train or len(arr) >= self.past_seq_len + self.horizon:
            x, y = roll_windows(arr, self.past_seq_len, self.horizon)
            return x, y
        # inference tail: single window from the last past_seq_len rows
        x = arr[-self.past_seq_len:][None, ...]
        return x.astype(np.float32), None

    def inverse_transform_y(self, y: np.ndarray) -> np.ndarray:
        return y * self._std[0] + self._mean[0]

    def scale_y(self, y: np.ndarray) -> np.ndarray:
        return (y - self._mean[0]) / self._std[0]

    @property
    def feature_num(self) -> int:
        return 1 + len(self.extra_features_col) + len(_DT_FEATURES)

    # --- persistence (the port's pipeline file) -----------------------------
    def get_state(self) -> Dict[str, Any]:
        """The fitted transformer as plain values (lists, not arrays), for
        a file that ``torch.load(weights_only=True)`` reads back."""
        return {"horizon": self.horizon, "dt_col": self.dt_col,
                "target_col": self.target_col,
                "extra_features_col": list(self.extra_features_col),
                "drop_missing": self.drop_missing,
                "past_seq_len": self.past_seq_len,
                "mean": None if self._mean is None else self._mean.tolist(),
                "std": None if self._std is None else self._std.tolist()}

    @classmethod
    def from_state(cls, state: Dict[str, Any]
                   ) -> "TimeSequenceFeatureTransformer":
        t = cls(horizon=state["horizon"], dt_col=state["dt_col"],
                target_col=state["target_col"],
                extra_features_col=state["extra_features_col"],
                drop_missing=state["drop_missing"])
        t.past_seq_len = state["past_seq_len"]
        if state["mean"] is not None:
            t._mean = np.asarray(state["mean"], np.float32)
            t._std = np.asarray(state["std"], np.float32)
        return t

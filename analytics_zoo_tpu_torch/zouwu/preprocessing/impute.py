"""Time-series imputation (a copy of ``analytics_zoo_tpu/zouwu/
preprocessing/impute.py``, with pandas imported inside the functions that
take DataFrames; parity: pyzoo/zoo/zouwu/preprocessing/impute/ — LastFill,
LastFillImpute, FillZeroImpute, TimeMergeImputor)."""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import pandas as pd


class BaseImputation:
    def impute(self, input_df: "pd.DataFrame") -> "pd.DataFrame":
        raise NotImplementedError

    def evaluate(self, df: "pd.DataFrame", drop_rate: float = 0.1,
                 seed: int = 0) -> float:
        """Drop a fraction of known values, impute, return MSE against the
        dropped truth (reference abstract.py evaluate)."""
        num = df.select_dtypes(include=[np.number])
        rng = np.random.RandomState(seed)
        mask = rng.rand(*num.shape) < drop_rate
        corrupted = df.copy()
        vals = num.to_numpy(dtype=float).copy()
        truth = vals[mask]
        vals[mask] = np.nan
        corrupted[num.columns] = vals
        restored = self.impute(corrupted)[num.columns].to_numpy(dtype=float)
        return float(np.nanmean((restored[mask] - truth) ** 2))


class LastFillImpute(BaseImputation):
    """Forward-fill, then back-fill leading NaNs (reference LastFill)."""

    def impute(self, input_df: "pd.DataFrame") -> "pd.DataFrame":
        return input_df.ffill().bfill()


class FillZeroImpute(BaseImputation):
    def impute(self, input_df: "pd.DataFrame") -> "pd.DataFrame":
        return input_df.fillna(0)


class MeanImpute(BaseImputation):
    def impute(self, input_df: "pd.DataFrame") -> "pd.DataFrame":
        num = input_df.select_dtypes(include=[np.number]).columns
        out = input_df.copy()
        out[num] = out[num].fillna(out[num].mean())
        return out


class LinearImpute(BaseImputation):
    def impute(self, input_df: "pd.DataFrame") -> "pd.DataFrame":
        num = input_df.select_dtypes(include=[np.number]).columns
        out = input_df.copy()
        out[num] = out[num].interpolate(method="linear",
                                        limit_direction="both")
        return out


class TimeMergeImputor(BaseImputation):
    """Re-grid onto a regular time interval, merging duplicates and filling
    gaps (reference TimeMergeImputor(time_interval, timestamp_column_name,
    mode)). mode: 'max' | 'min' | 'mean' | 'sum' (merge agg)."""

    def __init__(self, time_interval, timestamp_column_name: str,
                 mode: str = "mean"):
        self.interval = time_interval
        self.ts_col = timestamp_column_name
        self.mode = mode or "mean"

    def impute(self, input_df: "pd.DataFrame") -> "pd.DataFrame":
        import pandas as pd
        df = input_df.copy()
        df[self.ts_col] = pd.to_datetime(df[self.ts_col])
        grouped = (df.set_index(self.ts_col)
                     .resample(pd.to_timedelta(self.interval, unit="s")
                               if isinstance(self.interval, (int, float))
                               else self.interval)
                     .agg(self.mode))
        grouped = grouped.ffill().bfill()
        return grouped.reset_index()


# reference aliases
LastFill = LastFillImpute

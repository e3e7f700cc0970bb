"""AutoTS — automated time-series pipeline (counterpart of
``analytics_zoo_tpu/zouwu/autots/forecast.py``; reference:
pyzoo/zoo/zouwu/autots/forecast.py AutoTSTrainer.fit -> TSPipeline).

Trials run on the device-leased ``TPUSearchEngine``: each trial builds a
``TimeSequenceFeatureTransformer`` and a forecaster on its leased device,
trains its recipe's epoch budget (under ``scheduler="asha"``, rung by rung
up to it) and is scored by validation MSE; the best trial's forecaster
comes back as a ``TSPipeline``. A paused trial's state holds its live
forecaster, which the checkpoint plane cannot pickle, so the rung
scheduler keeps it in memory, as the JAX package does. ``AutoTSTrainer``
runs on ``device`` (``None``: every visible card; without a GPU it raises
unless given ``device="cpu"``). pandas is imported inside the functions
that take DataFrames.

``TSPipeline.save`` writes the port's own file with ``torch.save`` (read
back with ``weights_only=True``): the config, the transformer's state, the
net's class name and arguments, and the engine state. The JAX package
pickles its flax module with cloudpickle instead; its pipeline files are
not read here (weights cross through ``interop``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np
import torch

from ...automl.search.search_engine import TPUSearchEngine
from ...common.context import resolve_device
from ..config.recipe import (LSTMGridRandomRecipe, Recipe,
                             convert_bayes_config)
from ..feature.time_sequence import TimeSequenceFeatureTransformer
from ..model.forecast import (Forecaster, LSTMForecaster, MTNetForecaster,
                              Seq2SeqForecaster, TCNForecaster)

if TYPE_CHECKING:
    import pandas as pd


class AutoTSTrainer:
    """(reference: zouwu/autots/forecast.py:22-93)"""

    def __init__(self, dt_col: str = "datetime", target_col: str = "value",
                 horizon: int = 1, extra_features_col: Optional[List] = None,
                 search_alg=None, search_alg_params=None, scheduler=None,
                 scheduler_params=None, name: str = "autots",
                 logs_dir: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.dt_col = dt_col
        self.target_col = target_col
        self.horizon = horizon
        self.extra_features_col = extra_features_col
        self.name = name
        # scheduler="asha" routes trials through the fault-tolerant rung
        # scheduler (pause/resume at rung boundaries, retry-with-backoff,
        # SIGTERM study checkpointing when logs_dir is set); the reference
        # forwarded the same kwargs to Ray Tune's scheduler slot
        self.scheduler = scheduler
        self.scheduler_params = scheduler_params
        self.logs_dir = logs_dir

    def fit(self, train_df: "pd.DataFrame",
            validation_df: Optional["pd.DataFrame"] = None,
            metric: str = "mse", recipe: Optional[Recipe] = None,
            mc: bool = False, resources_per_trial=None,
            upload_dir=None) -> "TSPipeline":
        recipe = recipe or LSTMGridRandomRecipe(num_rand_samples=1)
        space = recipe.search_space([])
        model_type = recipe.model_type()
        trainer = self

        class _TSTrialModel:
            def __init__(self, config, device):
                self.config = dict(config)
                self.device = device

            def fit_eval(self, data, validation_data, epochs, metric,
                         state=None):
                """``epochs`` is a CUMULATIVE budget and ``state`` the dict
                from a previous call (scheduler pause/resume protocol): a
                resumed trial keeps training its existing forecaster instead
                of rebuilding — legacy callers (state=None) see one
                fit-from-scratch to the full budget, as before."""
                cfg = convert_bayes_config(self.config)
                past = int(cfg.get("past_seq_len", 50))
                if state is not None:
                    tsft = state["tsft"]
                    forecaster = state["forecaster"]
                    epochs_done = int(state.get("epochs_done", 0))
                    x, y = tsft.transform(data, is_train=True)
                else:
                    tsft = TimeSequenceFeatureTransformer(
                        horizon=trainer.horizon, dt_col=trainer.dt_col,
                        target_col=trainer.target_col,
                        extra_features_col=trainer.extra_features_col)
                    x, y = tsft.fit_transform(data, past_seq_len=past)
                    forecaster = trainer._build_forecaster(
                        model_type, cfg, tsft.feature_num, self.device)
                    epochs_done = 0
                if validation_data is not None:
                    vx, vy = tsft.transform(validation_data, is_train=True)
                else:
                    vx, vy = x, y
                if model_type == "LSTM" and trainer.horizon == 1:
                    target_y, vtarget = y[:, 0:1], vy[:, 0:1]
                elif model_type == "MTNet":
                    target_y, vtarget = y, vy          # (n, horizon)
                else:
                    target_y, vtarget = y[..., None], vy[..., None]
                if int(epochs) > epochs_done:
                    forecaster.fit(x, target_y,
                                   epochs=int(epochs) - epochs_done,
                                   batch_size=int(cfg.get("batch_size", 32)))
                pred = forecaster.predict(vx)
                score = float(np.mean(
                    (pred.reshape(vtarget.shape) - vtarget) ** 2))
                state = {"forecaster": forecaster, "tsft": tsft,
                         "epochs_done": int(epochs)}
                return score, {metric: score}, state

        engine = TPUSearchEngine(name=self.name, logs_dir=self.logs_dir,
                                 scheduler=self.scheduler,
                                 scheduler_params=self.scheduler_params,
                                 device=self.device)
        self.engine = engine
        # reference recipes' reward_metric is a tune reward (maximized
        # negative loss): reward_metric=-0.05 stops once mse <= 0.05
        reward = getattr(recipe, "reward_metric", None)
        # the per-trial epoch budget: recipes carry it as `epochs` (LSTM) or
        # `training_iteration` (the tune-style recipes); under
        # scheduler="asha" this is max_t, the top-rung budget
        max_t = int(getattr(recipe, "epochs", None)
                    or getattr(recipe, "training_iteration", 5) or 5)
        engine.compile(train_df,
                       lambda cfg, device: _TSTrialModel(cfg, device),
                       space, n_sampling=recipe.num_samples,
                       epochs=max_t,
                       validation_data=validation_df, metric=metric,
                       metric_mode="min",
                       search_alg=getattr(recipe, "search_algorithm", None),
                       stop_score=None if reward is None else -reward)
        engine.run()
        best = engine.get_best_trial()
        # store the CONVERTED config: downstream consumers (incremental
        # TSPipeline.fit, save/load) read plain keys like batch_size
        return TSPipeline(best.model_state["forecaster"],
                          best.model_state["tsft"],
                          convert_bayes_config(best.config), self)

    def _build_forecaster(self, model_type: str, cfg: Dict, feature_num: int,
                          device):
        if model_type == "TCN":
            return TCNForecaster(
                past_seq_len=int(cfg.get("past_seq_len", 50)),
                future_seq_len=self.horizon,
                input_feature_num=feature_num, output_feature_num=1,
                num_channels=cfg.get("num_channels", (16,) * 3),
                kernel_size=int(cfg.get("kernel_size", 3)),
                dropout=float(cfg.get("dropout", 0.2)),
                lr=float(cfg.get("lr", 1e-3)),
                loss=cfg.get("loss", "mse"), device=device)
        if model_type == "Seq2Seq":
            return Seq2SeqForecaster(
                past_seq_len=int(cfg.get("past_seq_len", 50)),
                future_seq_len=self.horizon,
                input_feature_num=feature_num, output_feature_num=1,
                lstm_hidden_dim=int(cfg.get("latent_dim", 64)),
                lr=float(cfg.get("lr", 1e-3)), device=device)
        if model_type == "MTNet":
            return MTNetForecaster(
                target_dim=self.horizon, feature_dim=feature_num,
                ar_window_size=int(cfg.get("ar_size", 4)),
                cnn_height=int(cfg.get("cnn_height", 3)),
                cnn_hid_size=int(cfg.get("cnn_hid_size", 32)),
                lr=float(cfg.get("lr", 1e-3)),
                loss=cfg.get("loss", "mse"), device=device)
        if "lstm_1_units" in cfg:
            # BayesRecipe layout: per-layer units/dropout keys (the
            # reference's VanillaLSTM reads the same names)
            units = (int(cfg["lstm_1_units"]),
                     int(cfg.get("lstm_2_units", cfg["lstm_1_units"])))
            dropouts = (float(cfg.get("dropout_1", 0.2)),
                        float(cfg.get("dropout_2", 0.2)))
        else:
            units = cfg.get("lstm_units", (16, 8))
            dropouts = cfg.get("dropouts", 0.2)
        return LSTMForecaster(
            target_dim=self.horizon, feature_dim=feature_num,
            lstm_units=units, dropouts=dropouts,
            lr=float(cfg.get("lr", 1e-3)), loss=cfg.get("loss", "mse"),
            device=device)


class TSPipeline:
    """(reference: zouwu/autots/forecast.py:94-200: predict/evaluate/
    save/load + incremental fit)"""

    def __init__(self, forecaster, tsft: TimeSequenceFeatureTransformer,
                 config: Dict, trainer: AutoTSTrainer):
        self.forecaster = forecaster
        self.tsft = tsft
        self.config = config
        self.trainer = trainer

    def predict(self, input_df: "pd.DataFrame") -> "pd.DataFrame":
        import pandas as pd
        x, _ = self.tsft.transform(input_df, is_train=False)
        pred = self.forecaster.predict(x)
        pred = self.tsft.inverse_transform_y(
            pred.reshape(pred.shape[0], -1))
        dt = pd.to_datetime(input_df[self.trainer.dt_col])
        freq = dt.diff().mode().iloc[0] if len(dt) > 1 else pd.Timedelta("1h")
        rows = []
        for i in range(pred.shape[0]):
            base = dt.iloc[min(self.tsft.past_seq_len - 1 + i, len(dt) - 1)]
            rows.append([base + freq] + list(pred[i]))
        cols = [self.trainer.dt_col] + [
            f"{self.trainer.target_col}_{j}" if pred.shape[1] > 1 else
            self.trainer.target_col for j in range(pred.shape[1])]
        return pd.DataFrame(rows, columns=cols)

    def evaluate(self, input_df: "pd.DataFrame",
                 metrics: List[str] = ("mse",),
                 multioutput: str = "uniform_average") -> Dict[str, float]:
        from ..model.forecast import evaluate_metrics
        x, y = self.tsft.transform(input_df, is_train=True)
        pred = self.forecaster.predict(x)
        y2 = y if pred.ndim == 2 and pred.shape == y.shape else \
            y.reshape(pred.shape) if y.size == pred.size else y[:, :1]
        return evaluate_metrics(y2, pred.reshape(y2.shape), metrics)

    def fit(self, input_df, validation_df=None, mc=False, epochs: int = 1,
            **_):
        """Incremental fit on new data (reference: forecast.py:110)."""
        x, y = self.tsft.transform(input_df, is_train=True)
        target = y[:, 0:1] if getattr(self.forecaster.module, "target_dim",
                                      None) == 1 else y[..., None]
        if isinstance(self.forecaster, LSTMForecaster):
            target = y[:, :self.forecaster.module.target_dim]
        self.forecaster.fit(x, target, epochs=epochs,
                            batch_size=int(self.config.get("batch_size", 32)))
        return self

    def save(self, pipeline_file: str):
        """The pipeline as one ``torch.save`` file of plain values and
        tensors: config, transformer state, the net's spec, the engine
        state and the trainer's columns."""
        state = {"config": self.config,
                 "tsft": self.tsft.get_state(),
                 "net_spec": self.forecaster.net_spec,
                 "engine_state": self.forecaster.estimator.engine.get_state(),
                 "trainer": {"dt_col": self.trainer.dt_col,
                             "target_col": self.trainer.target_col,
                             "horizon": self.trainer.horizon,
                             "extra": self.trainer.extra_features_col}}
        torch.save(state, pipeline_file)
        return pipeline_file

    @staticmethod
    def load(pipeline_file: str, device=None) -> "TSPipeline":
        """Rebuild a saved pipeline on ``device`` (``None``: the card)."""
        device = resolve_device(device)
        state = torch.load(pipeline_file, map_location="cpu",
                           weights_only=True)
        t = state["trainer"]
        trainer = AutoTSTrainer(dt_col=t["dt_col"], target_col=t["target_col"],
                                horizon=t["horizon"],
                                extra_features_col=t["extra"], device=device)
        forecaster = Forecaster.from_spec(tuple(state["net_spec"]),
                                          device=trainer.device)
        forecaster.estimator.engine.set_state(state["engine_state"])
        forecaster._fitted = True
        return TSPipeline(forecaster,
                          TimeSequenceFeatureTransformer.from_state(
                              state["tsft"]),
                          state["config"], trainer)

"""AutoTS recipes — search-space presets (a copy of
``analytics_zoo_tpu/zouwu/config/recipe.py``; reference:
pyzoo/zoo/zouwu/config/recipe.py: SmokeRecipe, LSTMGridRandomRecipe,
Seq2SeqRandomRecipe, MTNetGridRandomRecipe, TCNGridRandomRecipe, ...)."""

from __future__ import annotations

from typing import Dict, List

from ...automl import hp


class Recipe:
    num_samples = 1
    training_iteration = 10
    search_algorithm = None        # None (grid+random) | "bayes"

    def search_space(self, all_available_features: List[str]) -> Dict:
        raise NotImplementedError

    def model_type(self) -> str:
        return "LSTM"


def convert_bayes_config(config: Dict) -> Dict:
    """``*_float`` keys -> ints under the stripped name (the reference's
    bayes convention, automl/common/util.py:207: bayes searchers model a
    continuous space, so integer hyperparameters are searched as floats
    and rounded when the model consumes them)."""
    out = {}
    for k, v in config.items():
        if k.endswith("_float"):
            out[k[:-len("_float")]] = int(v)
        else:
            out[k] = v
    return out


class SmokeRecipe(Recipe):
    """(reference: recipe.py SmokeRecipe — one tiny config for CI)"""
    num_samples = 1
    training_iteration = 1

    def search_space(self, all_available_features):
        return {"lstm_units": [8], "dropouts": 0.1, "lr": 0.01,
                "batch_size": 32, "past_seq_len": 12, "loss": "mse"}


class LSTMGridRandomRecipe(Recipe):
    """(reference: recipe.py LSTMGridRandomRecipe)"""

    def __init__(self, num_rand_samples: int = 1, epochs: int = 5,
                 training_iteration: int = 10,
                 lstm_1_units=(16, 32), lstm_2_units=(8, 16),
                 batch_size=(32, 64), past_seq_len=(50,)):
        self.num_samples = num_rand_samples
        self.training_iteration = training_iteration
        self.epochs = epochs
        self.lstm_1_units = list(lstm_1_units)
        self.lstm_2_units = list(lstm_2_units)
        self.batch_size = list(batch_size)
        self.past_seq_len = list(past_seq_len)

    def search_space(self, all_available_features):
        return {
            "lstm_units": hp.sample_from(
                lambda rng: [int(rng.choice(self.lstm_1_units)),
                             int(rng.choice(self.lstm_2_units))]),
            "dropouts": hp.uniform(0.1, 0.3),
            "lr": hp.loguniform(1e-4, 1e-1),
            "batch_size": hp.grid_search(self.batch_size),
            "past_seq_len": hp.choice(self.past_seq_len),
            "loss": "mse",
        }

    def model_type(self):
        return "LSTM"


class TCNGridRandomRecipe(Recipe):
    """(reference: recipe.py TCNGridRandomRecipe)"""

    def __init__(self, num_rand_samples: int = 1, training_iteration: int = 10,
                 num_channels=((16,) * 3,), kernel_size=(3, 5),
                 batch_size=(32, 64), past_seq_len=(50,)):
        self.num_samples = num_rand_samples
        self.training_iteration = training_iteration
        self.num_channels = [tuple(c) for c in num_channels]
        self.kernel_size = list(kernel_size)
        self.batch_size = list(batch_size)
        self.past_seq_len = list(past_seq_len)

    def search_space(self, all_available_features):
        return {
            "num_channels": hp.choice(self.num_channels),
            "kernel_size": hp.choice(self.kernel_size),
            "dropout": hp.uniform(0.0, 0.3),
            "lr": hp.loguniform(1e-4, 1e-2),
            "batch_size": hp.grid_search(self.batch_size),
            "past_seq_len": hp.choice(self.past_seq_len),
            "loss": "mse",
        }

    def model_type(self):
        return "TCN"


class TCNSmokeRecipe(Recipe):
    """(reference: recipe.py TCNSmokeRecipe)"""
    num_samples = 1
    training_iteration = 1

    def search_space(self, all_available_features):
        return {"num_channels": (8, 8), "kernel_size": 3, "dropout": 0.1,
                "lr": 0.01, "batch_size": 32, "past_seq_len": 12,
                "loss": "mse"}

    def model_type(self):
        return "TCN"


class MTNetSmokeRecipe(Recipe):
    """(reference: recipe.py MTNetSmokeRecipe)"""
    num_samples = 1
    training_iteration = 1

    def search_space(self, all_available_features):
        return {"ar_size": 2, "cnn_height": 2, "cnn_hid_size": 16,
                "lr": 0.01, "batch_size": 32, "past_seq_len": 12,
                "loss": "mse"}

    def model_type(self):
        return "MTNet"


class MTNetGridRandomRecipe(Recipe):
    """(reference: recipe.py MTNetGridRandomRecipe — grid over cnn/ar
    geometry, random over lr/dropout)"""

    def __init__(self, num_rand_samples: int = 1, training_iteration: int = 10,
                 time_step=(12,), cnn_height=(2, 3), ar_size=(2, 4),
                 cnn_hid_size=(16, 32), batch_size=(32, 64)):
        self.num_samples = num_rand_samples
        self.training_iteration = training_iteration
        self.time_step = list(time_step)
        self.cnn_height = list(cnn_height)
        self.ar_size = list(ar_size)
        self.cnn_hid_size = list(cnn_hid_size)
        self.batch_size = list(batch_size)

    def search_space(self, all_available_features):
        return {
            "past_seq_len": hp.grid_search(self.time_step),
            "cnn_height": hp.choice(self.cnn_height),
            "ar_size": hp.choice(self.ar_size),
            "cnn_hid_size": hp.choice(self.cnn_hid_size),
            "batch_size": hp.grid_search(self.batch_size),
            "lr": hp.loguniform(1e-4, 1e-2),
            "loss": "mse",
        }

    def model_type(self):
        return "MTNet"


class Seq2SeqRandomRecipe(Recipe):
    """(reference: recipe.py Seq2SeqRandomRecipe)"""

    def __init__(self, num_rand_samples: int = 1, training_iteration: int = 10,
                 latent_dim=(32, 64, 128), batch_size=(32, 64),
                 past_seq_len=(50,)):
        self.num_samples = num_rand_samples
        self.training_iteration = training_iteration
        self.latent_dim = list(latent_dim)
        self.batch_size = list(batch_size)
        self.past_seq_len = list(past_seq_len)

    def search_space(self, all_available_features):
        return {
            "latent_dim": hp.choice(self.latent_dim),
            "batch_size": hp.grid_search(self.batch_size),
            "past_seq_len": hp.choice(self.past_seq_len),
            "lr": hp.loguniform(1e-4, 1e-2),
            "loss": "mse",
        }

    def model_type(self):
        return "Seq2Seq"


class GridRandomRecipe(LSTMGridRandomRecipe):
    """(reference: recipe.py GridRandomRecipe — the historical name for the
    LSTM grid+random preset; kept as an alias surface)"""


class RandomRecipe(Recipe):
    """(reference: recipe.py RandomRecipe — pure random sampling, no grid
    axes, so trial count == num_rand_samples)"""

    def __init__(self, num_rand_samples: int = 1, training_iteration: int = 10,
                 past_seq_len=(50,)):
        self.num_samples = num_rand_samples
        self.training_iteration = training_iteration
        self.past_seq_len = list(past_seq_len)

    def search_space(self, all_available_features):
        return {
            "lstm_units": hp.sample_from(
                lambda rng: [int(rng.choice([8, 16, 32])),
                             int(rng.choice([8, 16]))]),
            "dropouts": hp.uniform(0.1, 0.4),
            "batch_size": hp.choice([32, 64]),
            "past_seq_len": hp.choice(self.past_seq_len),
            "lr": hp.loguniform(1e-4, 1e-1),
            "loss": "mse",
        }

    def model_type(self):
        return "LSTM"


class BayesRecipe(Recipe):
    """Bayes-search LSTM recipe (reference: recipe.py:568 BayesRecipe over
    ray-tune's bayesopt searcher). Integer hyperparameters are expressed
    as ``*_float`` uniforms (bayes models a continuous space) and rounded
    via :func:`convert_bayes_config` when consumed; trials run through
    TPUSearchEngine's sequential GP-EI loop (automl/search/bayes.py)."""

    search_algorithm = "bayes"

    def __init__(self, num_samples: int = 1, look_back=2, epochs: int = 5,
                 reward_metric: float = -0.05, training_iteration: int = 5):
        self.num_samples = num_samples
        self.reward_metric = reward_metric
        self.training_iteration = training_iteration
        self.epochs = epochs
        if (isinstance(look_back, tuple) and len(look_back) == 2
                and all(isinstance(v, int) for v in look_back)):
            if look_back[1] < 2:
                raise ValueError("The max look back value should be at "
                                 "least 2")
            if look_back[0] > look_back[1]:
                raise ValueError(
                    f"look back range is inverted: {look_back} — expected "
                    "(min_len, max_len) with min_len <= max_len")
            self.bayes_past_seq_config = {
                "past_seq_len_float": hp.uniform(max(look_back[0], 2),
                                                 look_back[1])}
        elif isinstance(look_back, int):
            if look_back < 2:
                raise ValueError("look back value should not be smaller "
                                 f"than 2. Current value is {look_back}")
            self.bayes_past_seq_config = {"past_seq_len": look_back}
        else:
            raise ValueError(
                f"look back is {look_back}. look_back should be either a "
                "tuple of 2 ints (min_len, max_len) or a single int")

    def search_space(self, all_available_features=None):
        space = {
            "model": "LSTM",
            "lstm_1_units_float": hp.uniform(8, 128),
            "dropout_1": hp.uniform(0.2, 0.5),
            "lstm_2_units_float": hp.uniform(8, 128),
            "dropout_2": hp.uniform(0.2, 0.5),
            "lr": hp.uniform(0.001, 0.1),
            "batch_size_float": hp.uniform(32, 128),
            "loss": "mse",
        }
        space.update(self.bayes_past_seq_config)
        return space

    def model_type(self):
        return "LSTM"


class XgbRegressorGridRandomRecipe(Recipe):
    """(reference: recipe.py XgbRegressorGridRandomRecipe — pairs with
    AutoXGBRegressor.fit(search_space=recipe.search_space([])))"""

    def __init__(self, num_rand_samples: int = 1,
                 n_estimators=(50, 100), max_depth=(3, 6),
                 lr_range=(1e-2, 3e-1)):
        self.num_samples = num_rand_samples
        self.n_estimators = list(n_estimators)
        self.max_depth = list(max_depth)
        self.lr_range = tuple(lr_range)

    def search_space(self, all_available_features):
        return {
            "n_estimators": hp.grid_search(self.n_estimators),
            "max_depth": hp.grid_search(self.max_depth),
            "learning_rate": hp.loguniform(*self.lr_range),
        }

    def model_type(self):
        return "XGBoost"

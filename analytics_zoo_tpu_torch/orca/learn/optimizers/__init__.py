from . import schedule
from .optimizers_impl import (SGD, Adadelta, Adagrad, Adam, Adamax,
                              AdamWeightDecay, Ftrl, LBFGS, Optimizer,
                              ParallelAdam, RMSprop, convert_optimizer)

__all__ = ["Optimizer", "SGD", "Adam", "ParallelAdam", "AdamWeightDecay",
           "Adagrad", "Adadelta", "Adamax", "RMSprop", "Ftrl", "LBFGS",
           "convert_optimizer", "schedule"]

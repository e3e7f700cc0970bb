from .engine.topology import Input, KerasNet, Model, Sequential
from . import activations
from . import layers

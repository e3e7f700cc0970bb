from .graph import Variable, keras_call, symbolic_apply
from .topology import Input, KerasNet, Model, Sequential

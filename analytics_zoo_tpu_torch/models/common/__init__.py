from .zoo_model import ZooModel

__all__ = ["ZooModel"]

from .table import FeatureTable, StringIndex, Table

__all__ = ["FeatureTable", "StringIndex", "Table"]

from .preprocessing import read_csv, read_json, read_parquet

__all__ = ["read_csv", "read_json", "read_parquet"]

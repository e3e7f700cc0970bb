from .search_engine import SearchEngine, TPUSearchEngine, Trial

__all__ = ["SearchEngine", "TPUSearchEngine", "Trial"]

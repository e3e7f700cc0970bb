from .forecast import AutoTSTrainer, TSPipeline

__all__ = ["AutoTSTrainer", "TSPipeline"]

from .imagenet import (IMAGENET_MEAN, IMAGENET_STD, ImageNetPipeline,
                       write_synthetic_imagenet)
from .parquet_dataset import (ParquetDataset, SchemaField,
                              write_from_directory, write_mnist,
                              write_ndarrays, write_voc)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "ImageNetPipeline",
           "ParquetDataset", "SchemaField", "write_from_directory",
           "write_mnist", "write_ndarrays", "write_synthetic_imagenet",
           "write_voc"]

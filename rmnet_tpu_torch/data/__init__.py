"""Host-side data pipeline of the port (counterpart of rmnet_tpu/data): IO,
the transforms (with the native flow-affine op), datasets, the loader, the
index builders and the synthetic tree."""

from rmnet_tpu_torch.data.datasets import DataLoader, DatasetCollector, DatasetSubset
from rmnet_tpu_torch.data.io import IO, read_flo, write_flo

__all__ = ["IO", "read_flo", "write_flo", "DatasetCollector", "DatasetSubset", "DataLoader"]

"""Host-side data pipeline of the port: paired transforms, list-file
dataset, loader (a copy of ``semseg_tpu/data``, without its native loader)."""

from semseg_torch.data import transform
from semseg_torch.data.dataset import SemData, Uint8Wire, make_dataset
from semseg_torch.data.loader import DataLoader

__all__ = ["transform", "SemData", "Uint8Wire", "make_dataset", "DataLoader"]

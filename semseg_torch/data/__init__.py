"""Host-side data pipeline of the port: paired transforms, list-file
dataset, loader (a copy of ``semseg_tpu/data``); the native pipeline is
``semseg_torch.data.native``, built at first use."""

from semseg_torch.data import transform
from semseg_torch.data.dataset import SemData, Uint8Wire, make_dataset
from semseg_torch.data.loader import DataLoader

__all__ = ["transform", "SemData", "Uint8Wire", "make_dataset", "DataLoader"]

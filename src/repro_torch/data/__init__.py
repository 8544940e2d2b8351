"""RawArray-backed data pipeline (the paper's contribution as the loader)."""

from .dataset import DatasetBuilder, RaDataset, RaDatasetWriter, dataset_manifest
from .loader import DataLoader, LoaderState
from .synth import make_image_dataset, make_token_dataset

__all__ = [
    "DatasetBuilder",
    "RaDataset",
    "RaDatasetWriter",
    "dataset_manifest",
    "DataLoader",
    "DeviceLoader",
    "LoaderState",
    "make_token_dataset",
    "make_image_dataset",
]


def __getattr__(name):
    # DeviceLoader pulls in torch; load it lazily so the numpy-only data plane
    # (datasets, host loader) stays importable and fast without it
    if name == "DeviceLoader":
        from .device_loader import DeviceLoader

        return DeviceLoader
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

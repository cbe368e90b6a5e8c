"""The Waymo data path (counterpart of ``partner_tpu/data``): datasets and
their wrappers, the pipeline stages in train and val mode (augmentation,
GT-AUG, center targets), collation and the loader."""

from .registry import DATASETS, PIPELINES, Compose, build_dataset  # noqa: F401
from . import collate, datasets, pipeline  # noqa: F401
from .loader import build_dataloader  # noqa: F401

"""The Waymo val data path (counterpart of ``partner_tpu/data``): datasets,
the pipeline stages of the flagship ``test_pipeline``, collation and the
loader. Train mode is not ported."""

from .registry import DATASETS, PIPELINES, Compose, build_dataset  # noqa: F401
from . import collate, datasets, pipeline  # noqa: F401
from .loader import build_dataloader  # noqa: F401

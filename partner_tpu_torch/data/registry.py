"""Dataset and pipeline registries and ``Compose`` (counterpart of
``partner_tpu/data/registry.py``, on the port's own
``models/registry.py``: the JAX file imports ``partner_tpu.models``, whose
package imports flax)."""

from ..models.registry import Registry, build_from_cfg

DATASETS = Registry("dataset")
PIPELINES = Registry("pipeline")


class Compose:
    def __init__(self, transforms):
        self.transforms = [
            t if callable(t) else build_from_cfg(t, PIPELINES)
            for t in transforms
        ]

    def __call__(self, res, info):
        for t in self.transforms:
            res, info = t(res, info)
            if res is None:
                return None, None
        return res, info


def build_dataset(cfg, default_args=None):
    return build_from_cfg(cfg, DATASETS, default_args)

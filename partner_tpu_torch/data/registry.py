"""Dataset and pipeline registries, ``Compose`` and ``build_dataset``
(counterpart of ``partner_tpu/data/registry.py``, on the port's own
``models/registry.py``: the JAX file imports ``partner_tpu.models``, whose
package imports flax)."""

from ..models.registry import Registry, build_from_cfg

DATASETS = Registry("dataset")
PIPELINES = Registry("pipeline")


class Compose:
    def __init__(self, transforms, default_args=None):
        self.transforms = [
            t if callable(t) else build_from_cfg(t, PIPELINES, default_args)
            for t in transforms
        ]

    def __call__(self, res, info):
        for t in self.transforms:
            res, info = t(res, info)
            if res is None:
                return None, None
        return res, info


def build_dataset(cfg, default_args=None):
    """A dataset from its config. A ``ConcatDataset`` / ``RepeatDataset``
    config naming dataset configs builds each inner dataset first with the
    same ``default_args`` (for example
    ``dict(rng=np.random.RandomState(seed))``)."""
    cfg = dict(cfg)
    if cfg.get("type") == "ConcatDataset":
        cfg["datasets"] = [d if not isinstance(d, dict)
                           else build_dataset(d, default_args)
                           for d in cfg["datasets"]]
        return build_from_cfg(cfg, DATASETS)
    if cfg.get("type") == "RepeatDataset" and isinstance(cfg["dataset"], dict):
        cfg["dataset"] = build_dataset(cfg["dataset"], default_args)
        return build_from_cfg(cfg, DATASETS)
    return build_from_cfg(cfg, DATASETS, default_args)

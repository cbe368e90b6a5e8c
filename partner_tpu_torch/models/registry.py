"""Component registries + build_from_cfg for the port.

Same contract as ``partner_tpu/models/registry.py`` (which cannot be
imported here: ``partner_tpu.models`` pulls in flax). Configs instantiate
components from ``dict(type="Name", ...)``, so the JAX package's config
files build the port unchanged.
"""

import inspect


class Registry:
    def __init__(self, name):
        self.name = name
        self._module_dict = {}

    def __repr__(self):
        return f"Registry(name={self.name}, items={list(self._module_dict)})"

    def get(self, key):
        return self._module_dict.get(key)

    def register_module(self, cls=None, *, name=None):
        def _register(c):
            key = name or c.__name__
            if key in self._module_dict:
                raise KeyError(f"{key} already registered in {self.name}")
            self._module_dict[key] = c
            return c

        if cls is None:
            return _register
        return _register(cls)


def build_from_cfg(cfg, registry, default_args=None):
    """Instantiate registry[cfg['type']](**cfg-without-type, **default_args),
    dropping keys the target's signature does not take."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with 'type', got {cfg!r}")
    args = dict(cfg)
    obj_type = args.pop("type")
    obj_cls = registry.get(obj_type)
    if obj_cls is None:
        raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    for k, v in (default_args or {}).items():
        args.setdefault(k, v)
    sig = inspect.signature(
        obj_cls.__init__ if inspect.isclass(obj_cls) else obj_cls)
    if not any(p.kind == inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values()):
        allowed = set(sig.parameters) - {"self"}
        args = {k: v for k, v in args.items() if k in allowed}
    return obj_cls(**args)


BACKBONES = Registry("backbone")
NECKS = Registry("neck")
BBOX_HEADS = Registry("bbox_head")
DETECTORS = Registry("detector")

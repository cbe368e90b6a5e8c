"""Python-module configs (the files under ``configs/``), read without jax.

A config is an executable Python module whose public globals form the
config. The JAX package reads the same files with
``partner_tpu.train.config.Config``; the port has this small reader of its
own so that nothing on its path imports the JAX package.
"""

import runpy
import types


def load_config(path):
    """The config module at ``path`` as a dict of its globals, without
    dunders, callables and modules (the selection ``Config.fromfile``
    makes)."""
    ns = runpy.run_path(str(path))
    return {k: v for k, v in ns.items()
            if not k.startswith("__") and not callable(v)
            and not isinstance(v, types.ModuleType)}

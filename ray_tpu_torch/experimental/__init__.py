"""Experimental utilities (reference: python/ray/experimental/ —
internal_kv.py, tqdm_ray.py).  The port's copy of
``ray_tpu/experimental``."""

from . import internal_kv, tqdm_ray

__all__ = ["internal_kv", "tqdm_ray"]

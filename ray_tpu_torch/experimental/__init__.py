"""Experimental utilities (reference: python/ray/experimental/ —
internal_kv.py, tqdm_ray.py).  The port's copy of ``ray_tpu/experimental``:
``internal_kv``; ``tqdm_ray`` comes with ROADMAP A.4d-ii."""

from . import internal_kv

__all__ = ["internal_kv"]

"""joblib backend running joblib tasks on the cluster.

Analog of the reference's ray.util.joblib (reference:
python/ray/util/joblib/__init__.py register_ray +
ray_backend.py RayBackend): `register_ray_tpu_torch()` then
``with joblib.parallel_backend("ray_tpu_torch"):`` routes scikit-learn / joblib
``Parallel`` workloads through ray_tpu_torch tasks.

The port's copy of ``ray_tpu/util/joblib.py``; the backend's name follows
the package, as the reference's does (``"ray_tpu"`` there).
"""

from __future__ import annotations


def register_ray_tpu_torch():
    from joblib import register_parallel_backend

    register_parallel_backend("ray_tpu_torch", _make_backend)


def _make_backend():
    """Build lazily so importing this module never requires joblib."""
    from joblib._parallel_backends import MultiprocessingBackend

    import ray_tpu_torch
    from .multiprocessing import Pool

    class RayTpuBackend(MultiprocessingBackend):
        """joblib backend on the ray_tpu_torch multiprocessing Pool (the
        reference subclasses MultiprocessingBackend the same way)."""

        supports_timeout = True

        def configure(self, n_jobs=1, parallel=None, prefer=None,
                      require=None, **kwargs):
            n_jobs = self.effective_n_jobs(n_jobs)
            self.parallel = parallel
            self._pool = Pool(processes=n_jobs)
            return n_jobs

        def effective_n_jobs(self, n_jobs):
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
            if n_jobs is None or n_jobs == -1:
                return cpus
            return max(1, min(n_jobs, cpus))

        def terminate(self):
            if getattr(self, "_pool", None) is not None:
                self._pool.terminate()
                self._pool = None

        def _get_pool(self):
            return self._pool

    return RayTpuBackend()

"""Native (C++) runtime components.

Built lazily with g++ on first use; cached under
``ray_tpu_torch/_build/native/``.  The sources are copies of
``ray_tpu/native``'s scheduler, shm arena, shared-memory ring channel
(``shm_channel.cc``, under the compiled DAGs) and sanitizer self-test
(``selftest.cc``, ``python -m ray_tpu_torch.native.build --sanitize``).  Each
component degrades gracefully to a pure-Python fallback when the toolchain
is unavailable (CI images always have g++).
"""

from .build import build_extension, load_library  # noqa: F401

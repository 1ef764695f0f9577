"""ASAN/UBSAN pass over the port's native components: the case of
tests/test_native_sanitize.py against ``ray_tpu_torch/native``.

Builds ray_tpu_torch/native/selftest.cc + the three production .cc files
(shm_arena, shm_channel, sched) with -fsanitize=address,undefined
(-fno-sanitize-recover, so ANY finding is a non-zero exit) into
``ray_tpu_torch/_build/native/`` and drives the arena / channel /
scheduler C ABIs end to end.  One g++ -O1 sanitized build (~5-20 s cold);
skips where the toolchain lacks the sanitizer runtimes."""

import os
import subprocess

import pytest

from ray_tpu_torch.native import build


def test_native_components_clean_under_asan_ubsan(tmp_path):
    try:
        binary = build.build_sanitized_selftest()
    except RuntimeError as e:
        if "sanitizer" in str(e) or "asan" in str(e).lower():
            pytest.skip(f"toolchain lacks sanitizer runtimes: {e}")
        raise
    assert os.path.dirname(binary) == build._BUILD_DIR
    proc = subprocess.run([binary, str(tmp_path)], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, \
        f"sanitized selftest failed (rc={proc.returncode}):\n" \
        f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}"
    assert "ALL OK" in proc.stdout

"""The PyTorch port stands alone: importing it loads neither JAX nor any
module of the JAX package, its entry points refuse to fall back to the
CPU silently, and its sources call no library attention and no
torch.compile."""

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ray_tpu_torch"

_PROBE = r"""
import sys
import ray_tpu_torch
import ray_tpu_torch.ops
import ray_tpu_torch.ops._kernels
import ray_tpu_torch.models.gpt as gpt
import ray_tpu_torch.models.convert
import ray_tpu_torch.models.training as training
import ray_tpu_torch.serve
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "ray_tpu" or m.startswith("ray_tpu."))
assert not bad, bad
cfg = gpt.GPTConfig.nano()
params = gpt.init(cfg, seed=0, device="cpu")
for call in (lambda: gpt.apply(params, [[1, 2, 3]], cfg),
             lambda: gpt.init(cfg),
             lambda: gpt.generate(params, cfg, [[1, 2]], 2),
             lambda: gpt.loss_fn(params, {"tokens": [[1, 2, 3]]}, cfg),
             lambda: training.make_train_step(cfg),
             lambda: training.make_eval_step(cfg)):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("ran without a device and without CUDA")
print("ok")
"""


def test_import_loads_no_jax_and_no_cpu_fallback():
    # hide any GPU so "no device given" must raise
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_sources_use_no_library_attention_or_jax():
    banned = re.compile(r"scaled_dot_product_attention|torch\.compile|"
                        r"flash_attn|^\s*(import|from)\s+(jax|ray_tpu)\b",
                        re.M)
    files = list(PORT.rglob("*.py")) + list(PORT.rglob("*.cu"))
    assert files
    for f in files:
        hits = banned.findall(f.read_text())
        assert not hits, (f, hits)
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|ray_tpu)\b", smoke,
                         re.M)

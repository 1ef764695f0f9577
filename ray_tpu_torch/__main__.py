"""``python -m ray_tpu_torch`` -> the CLI (reference: the `ray` console
script)."""

from ray_tpu_torch.scripts.cli import main

main()

"""Elastic pieces of the port's runtime: ``preemption`` (the raylet's
maintenance-event watcher, the copy of ``ray_tpu/elastic/preemption.py``).
Emergency checkpoints, resume and remediation come with the train side
(ROADMAP A.4c)."""

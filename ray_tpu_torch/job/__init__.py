"""Job submission (reference: python/ray/dashboard/modules/job/); the
port's copy of ``ray_tpu/job``."""

from .job_manager import JobStatus, JobSubmissionClient, JobSupervisor

__all__ = ["JobStatus", "JobSubmissionClient", "JobSupervisor"]

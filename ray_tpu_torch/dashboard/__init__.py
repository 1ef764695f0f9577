"""Dashboard backend (reference: python/ray/dashboard/)."""

from .head import DashboardHead

__all__ = ["DashboardHead"]

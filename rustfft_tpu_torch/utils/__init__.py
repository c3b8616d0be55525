"""Helpers for checking plans: the verification harness (testing.py)."""
from . import testing  # noqa: F401

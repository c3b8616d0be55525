"""Workloads built on the port's planner."""

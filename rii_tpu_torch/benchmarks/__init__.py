"""Microbenchmarks of the port's ops-level entry points."""

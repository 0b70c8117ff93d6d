"""Scans, decode, the IVF union scan and the Hopper kernels' wrappers."""

"""Seconds of the first query's cache build, the sum of the engine's
``last_cache_build_stats`` (norms, flat copies, replica, layout,
windows)."""


def read(t):
    s = t.stats.get("cache_build") or {}
    vals = [v for v in s.values() if isinstance(v, float)]
    return sum(vals) if vals else None

"""Seconds of the set-up's reconfigure, the sum of the engine's
``last_reconfigure_stats`` (consolidate, sample, PQk-means fit, predict)."""


def read(t):
    s = t.stats.get("reconfigure") or {}
    vals = [v for v in s.values() if isinstance(v, float)]
    return sum(vals) if vals else None

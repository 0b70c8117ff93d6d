"""Codecs and clustering: PQ, k-means, PQk-means and the IVF layout."""

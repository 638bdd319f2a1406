"""Serving: depth-compacted lane batching and the cascade serving engine."""

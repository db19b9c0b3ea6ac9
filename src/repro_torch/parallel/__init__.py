"""Parallelism: logical-axis sharding on DTensor and collective helpers."""

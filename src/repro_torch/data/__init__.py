"""Synthetic token streams and the cyclic coded shard allocation."""

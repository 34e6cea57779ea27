"""Coded training in sim mode: per-shard gradients, the fused combine,
the update and the barrier ``Trainer``."""

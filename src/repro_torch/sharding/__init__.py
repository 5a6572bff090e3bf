"""Sharding: the per-architecture policy of which mesh axes shard which dims."""

"""Serialization: a pure-Python msgpack codec for flax weight files."""

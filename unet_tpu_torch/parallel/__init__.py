"""Multi-process data parallelism (``mesh``)."""

"""Multi-process data parallelism and spatial partitioning (``mesh``,
``halo``)."""

"""Host helpers: sparse-matrix I/O and metrics, cluster tables, device selection."""

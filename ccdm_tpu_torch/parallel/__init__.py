"""Data parallelism of the port: one process per card (`parallel/mesh.py`)."""

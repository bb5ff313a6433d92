"""Parallelism of the port: one process per card, laid out as a
`data x model` grid (`parallel/mesh.py`), the model axis splitting the wide
layers (`parallel/tensor.py`)."""

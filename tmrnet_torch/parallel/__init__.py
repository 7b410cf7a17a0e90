"""Data parallelism across processes (`mesh.py`)."""

"""See ``ops.py``."""

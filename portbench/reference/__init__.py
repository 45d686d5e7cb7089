"""The plain reference of the benchmark's comparison (``heat.py``)."""

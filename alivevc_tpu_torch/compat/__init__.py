"""Interop: JAX parameter pytrees -> the port's modules (``weights.py``)."""

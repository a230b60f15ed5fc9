"""Interop: JAX parameter pytrees <-> the port's modules (``weights.py``), the
JAX package's training states <-> the port's trainers (``jax_train_state.py``)
and reference checkpoints into the modules (``torch_import.py``)."""

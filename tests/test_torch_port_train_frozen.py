"""Fine-tuning without the voice library (content self-matched) and with
the discriminator frozen, the port against the JAX package on the CPU; the
set-up and tolerances are tests/test_torch_port_train_finetune.py's (a file
of its own: each JAX variant compiles for ~20 s)."""

from test_torch_port_train_finetune import run_fine_tune


def test_fine_tune_step_without_library_frozen_discriminator_matches_jax(monkeypatch):
    run_fine_tune(monkeypatch, use_library=False, freeze_discriminator=True)

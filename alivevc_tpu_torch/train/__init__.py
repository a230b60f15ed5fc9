"""Training: the GAN decoder trainer, fine-tuning with the voice library,
the F0-estimator trainer and voice-library generation, each step with its
data-parallel form (``alivevc_tpu/train/``, distillation excepted)."""

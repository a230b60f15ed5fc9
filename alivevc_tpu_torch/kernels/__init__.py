"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version: STFT magnitude, cosine top-k, harmonic source, and one
filter U-Net up level.  ``LAUNCHES`` counts the launches on the card."""

from alivevc_tpu_torch.kernels._lib import LAUNCHES, build_all, reset_launches  # noqa: F401

"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version: STFT magnitude, cosine top-k (with row exclusion and the
packed extraction), the Chebyshev, full-formant and streaming harmonic
sources, one filter U-Net up level, and one ResBlock conv of kNN-VC's
HiFi-GAN vocoder.  ``LAUNCHES`` counts the launches on the card.

The kernel API mirrors ``alivevc_tpu/kernels/__init__.py``: ``knn_topk``,
``match_features``, ``stft_magnitude`` and ``harmonic_source_formants``.
"""

from alivevc_tpu_torch.kernels._lib import LAUNCHES, build_all, reset_launches  # noqa: F401
from alivevc_tpu_torch.kernels.knn import knn_topk, match_features  # noqa: F401
from alivevc_tpu_torch.kernels.oscillator import harmonic_source_formants  # noqa: F401
from alivevc_tpu_torch.kernels.stft import stft_magnitude  # noqa: F401

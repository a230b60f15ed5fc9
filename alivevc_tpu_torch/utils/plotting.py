"""Spectrogram plotting (reference: module/spectrogram.py:13-18,
inference.py:48-54): debugging artifact dumps for parity work.  A copy of
the JAX package's ``utils/plotting.py``; matplotlib is imported at the first
plot, under the ``Agg`` backend, and a host without it raises ImportError
there."""

from __future__ import annotations

import numpy as np


def plot_spectrogram(
    spec: np.ndarray, save_path: str = "./spectrogram.png", log: bool = True
) -> None:
    """spec [T, bins] (channels-last) or [bins, T] → PNG.

    Matches the reference's presentation: log power, low bins at the bottom.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.asarray(spec)
    if x.ndim == 3:
        x = x[0]
    if x.shape[0] > x.shape[1]:  # [T, bins] → [bins, T]
        x = x.T
    if log:
        x = np.log10(x ** 2 + 1e-6)
    plt.figure()
    plt.imshow(x[::-1], aspect="auto")
    plt.savefig(save_path, dpi=200)
    plt.close()

"""Host-side utilities: the program's profiler spans and traces, spectrogram
plots.  The JAX package's ``utils/cache.py`` (the XLA compile cache) has no
counterpart: the port's build cache is ``_build/``."""

from alivevc_tpu_torch.utils.plotting import plot_spectrogram  # noqa: F401
from alivevc_tpu_torch.utils.profiling import profile_trace, span  # noqa: F401

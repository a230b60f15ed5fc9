"""Host-side utilities: structured metrics and meters, profiling and device
timing, spectrogram plots.  The JAX package's ``utils/cache.py`` (the XLA
compile cache) has no counterpart: the port's build cache is ``_build/``."""

from alivevc_tpu_torch.utils.metrics import MetricsLogger, RealTimeFactorMeter, StepTimer  # noqa: F401
from alivevc_tpu_torch.utils.plotting import plot_spectrogram  # noqa: F401
from alivevc_tpu_torch.utils.profiling import device_time, profile_trace  # noqa: F401

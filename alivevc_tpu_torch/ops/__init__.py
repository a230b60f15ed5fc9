"""Signal and matching ops: STFT/mel, interpolation, pitch math, kNN."""

"""ContentEncoder, F0Estimator and the DDSP decoder."""

"""Host-side I/O of the port: audio files and checkpoints."""

"""Training data for the port: the bucketed loader and the synthetic
corpus, copied from ``fastspeech2_tpu/data`` (numpy only)."""

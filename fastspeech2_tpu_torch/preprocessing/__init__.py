"""Data preparation of the port: corpus adapters, the MFA command line, the
TextGrid reader and the feature preprocessor
(``fastspeech2_tpu/preprocessing/``)."""

"""Audio DSP of the port: the mel filterbank and the STFT, its inverse and
Griffin-Lim (``fastspeech2_tpu/audio/{mel,stft}.py``)."""

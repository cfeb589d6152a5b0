"""The port's flat-start forced aligner: MFCC features, the Viterbi /
hard-EM aligner and the TextGrid writer (``fastspeech2_tpu/align/``)."""

from fastspeech2_tpu_torch.evaluation.metrics import (  # noqa: F401
    f0_metrics,
    mcd,
    mel_cepstra,
)

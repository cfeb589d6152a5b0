from fastspeech2_tpu_torch.serving.server import (
    BatchingSynthesizer,
    PayloadTooLarge,
    ServerOverloaded,
    TTSServer,
)

__all__ = ["BatchingSynthesizer", "PayloadTooLarge", "ServerOverloaded",
           "TTSServer"]

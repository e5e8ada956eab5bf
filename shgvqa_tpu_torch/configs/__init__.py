from shgvqa_tpu_torch.configs.config import (  # noqa: F401
    Config,
    DataConfig,
    DecoderConfig,
    EncoderConfig,
    MeshConfig,
    OptimConfig,
)

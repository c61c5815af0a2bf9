"""Configuration of the port: the fields and defaults of the JAX package's
``utils/config.py`` that the port reads (its own copy; the fields of the
epoch loop, data feed, meshes and kernel routing come with the code that
reads them).

Defaults track the reference flags: hidden_dim=256, num_heads=8,
num_layers=6, lr=5e-6 (the reference's ``parseMain.py``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ModelConfig:
    hidden_dim: int = 256
    num_heads: int = 8
    num_layers: int = 6
    input_size: int = 108          # 54 keypoints x 2
    ff_dim: int = 2048             # torch nn.Transformer default
    variant: str = "plain"         # "plain" | "cycle" | "embedding"
    # the port computes in float32 only, matmuls at full float32
    matmul_precision: str = "highest"
    compute_dtype: str = "float32"


@dataclasses.dataclass
class DataConfig:
    dataset_name: str = "all"
    augmentations_prob: float = 0.5
    have_augmentation: bool = True
    is_random_missing: bool = False
    double_hand_rotation: bool = True   # the reference's double hand turn


@dataclasses.dataclass
class TrainConfig:
    regime: str = "a1"             # a1 | a2 | a3 | a4
    lr: float = 5e-6
    # per-step parameter and gradient global norms in the metrics
    watch_norms: bool = True
    # the fused masked-loss kernel is not ported yet
    fused_loss: bool = False


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

"""Configuration of the port: its own copy of the JAX package's
``utils/config.py``, every field under the same name and default, so that
a run config the JAX package snapshots loads here (``Config.from_dict``,
``from_json_file``).

Defaults track the reference flags: hidden_dim=256, num_heads=8,
num_layers=6, lr=5e-6, epochs=500, patience=50 (the reference's
``parseMain.py``).

Fields that only steer the TPU's dispatch are accepted and have no effect
here: ``scan_layers``, ``remat`` (the port runs its layers eagerly, one
after another) and ``chain_steps`` (the port launches each step from the
host; there is no ``lax.scan`` to chain into).  Fields that ask for what
the port does not do yet are refused by ``Config.check_supported``, never
ignored: see ``UNSUPPORTED``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class ModelConfig:
    hidden_dim: int = 256
    num_heads: int = 8
    num_layers: int = 6
    input_size: int = 108          # 54 keypoints x 2
    ff_dim: int = 2048             # torch nn.Transformer default
    variant: str = "plain"         # "plain" | "cycle" | "embedding"
    # "highest" (float32), "high" (bf16x3) or "default" (one bf16 pass),
    # and the JAX aliases (ops/kernels/precision.py): the mode of every
    # kernel's products, as the JAX package's ambient precision sets it
    # (norms, activations and biases stay float32)
    matmul_precision: str = "highest"
    compute_dtype: str = "float32"
    # kernel routing of the JAX package: the port takes "auto" only (its
    # kernels wherever the JAX package takes its own)
    attention_impl: str = "auto"
    ff_impl: str = "auto"
    # "auto" | "on": the attention-sublayer kernel wherever it applies;
    # "off": attention per op (train/steps.build_model)
    attn_sublayer_fusion: str = "auto"
    pointwise_impl: str = "auto"
    scan_layers: bool = False      # no effect in the port
    remat: bool = False            # no effect in the port
    sequence_parallel: bool = False


@dataclasses.dataclass
class DataConfig:
    dataset_name: str = "all"
    # optional dataset_config.json overlay (missingness stats / paths)
    registry_path: Optional[str] = None
    training_set_path: str = ""
    validation_set_path: str = ""
    batch_size: int = 8
    max_seq_len: int = 512
    bucket_multiple: int = 32      # pad lengths up to multiples of this
    augmentations_prob: float = 0.5
    have_augmentation: bool = True
    is_random_missing: bool = False
    double_hand_rotation: bool = True   # the reference's double hand turn
    # keep the padded buckets on the card and gather batches there
    device_resident_data: bool = True
    synthetic_num_videos: int = 0
    synthetic_min_len: int = 24
    synthetic_max_len: int = 96
    synthetic_motion: str = "smooth"   # "smooth" | "gestures"
    synthetic_vocab: int = 8
    seed: int = 42


@dataclasses.dataclass
class MeshConfig:
    data: int = 1
    model: int = 1
    dcn_data: int = 1
    coordinator: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0


@dataclasses.dataclass
class TrainConfig:
    regime: str = "a1"             # a1 | a2 | a3 | a4
    lr: float = 5e-6
    epochs: int = 500
    patience: int = 50
    # None: a1 / a2 / a4 stop on patience, a3 never does (the reference)
    early_stop: Optional[bool] = None
    seed: int = 42
    checkpoint_dir: str = "model_checkpoint"
    experiment_name: Optional[str] = None
    # a2: the frozen first model's .pth
    upload_model: Optional[str] = None
    # a4: warm start (a plain .pth) and embedding graft (an Embedding .pth)
    upload_general_model: Optional[str] = None
    upload_embedding_model: Optional[str] = None
    freeze_grafted: bool = True
    # a3 schedule: lr / 10 after this epoch
    a3_lr_drop_epoch: int = 80
    # a full_state.pt: restores parameters, optimizer, epoch counter,
    # schedule position and generator state
    resume_from: Optional[str] = None
    # stop after this many epochs of this run, the schedule still spanning
    # ``epochs``
    max_epochs_this_run: Optional[int] = None
    log_every: int = 1
    save_checkpoints: bool = True
    save_plots: bool = False
    results_dir: str = "results"
    # full_state.pt is written at most every N improving epochs (and at
    # epoch 0); the best parameters on every best
    full_state_every: int = 5
    epoch0_cubic_baseline: bool = True
    # per-step parameter and gradient global norms in the metrics
    watch_norms: bool = True
    # the masked-loss kernel for the train criterion
    fused_loss: bool = False
    chain_steps: bool = True       # no effect in the port

    def effective_early_stop(self) -> bool:
        if self.early_stop is None:
            return self.regime != "a3"
        return self.early_stop


# the JAX package's matmul precision names and their modes
# (ops/pallas/ffn.py ``_precision_mode``, attention.py ``_mxu_mode``):
# "f32" float32 products, "bf16x3" three bf16 passes over hi / lo splits,
# "bf16" one bf16 pass (ops/kernels/precision.py)
PRECISIONS = {"highest": "f32", "float32": "f32",
              "high": "bf16x3", "tensorfloat32": "bf16x3",
              "bfloat16_3x": "bf16x3",
              "default": "bf16", "bfloat16": "bf16", "fastest": "bf16"}


def resolve_precision(name: str) -> str:
    """The mode ("f32", "bf16x3" or "bf16") of a precision name, aliases
    included; raises ValueError on any other name."""
    try:
        return PRECISIONS[name]
    except (KeyError, TypeError):
        raise ValueError(f"unknown matmul_precision {name!r}; expected one "
                         f"of {sorted(PRECISIONS)}") from None


# (section, field, the value the port takes, why another one is refused)
UNSUPPORTED = (
    ("model", "attention_impl", "auto",
     "the port routes attention as the JAX package's 'auto' does"),
    ("model", "ff_impl", "auto",
     "the port routes the FF sublayer as the JAX package's 'auto' does"),
    ("model", "pointwise_impl", "auto",
     "the port routes the pointwise chains as the JAX package's 'auto' does"),
    ("model", "sequence_parallel", False,
     "meshes are not ported (one card)"),
    ("data", "training_set_path", "",
     "reading HDF5 splits waits for h5py on the card's machine; use "
     "synthetic_num_videos or pass the videos to train()"),
    ("data", "validation_set_path", "",
     "reading HDF5 splits waits for h5py on the card's machine"),
    ("mesh", "data", 1, "meshes are not ported (one card)"),
    ("mesh", "model", 1, "meshes are not ported (one card)"),
    ("mesh", "dcn_data", 1, "multi-process training is not ported"),
    ("mesh", "num_processes", 1, "multi-process training is not ported"),
    ("train", "save_plots", False, "plots are not ported"),
)


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """Top-level keys other than the four sections (a snapshot's
        provenance) are ignored; an unknown field of a section raises."""
        return cls(
            model=ModelConfig(**d.get("model", {})),
            data=DataConfig(**d.get("data", {})),
            mesh=MeshConfig(**d.get("mesh", {})),
            train=TrainConfig(**d.get("train", {})),
        )

    @classmethod
    def from_json_file(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def check_supported(self) -> None:
        """Raise ValueError on the first field that asks for what the port
        does not do yet (``UNSUPPORTED``), or on an unknown precision."""
        resolve_precision(self.model.matmul_precision)
        for section, name, ok, why in UNSUPPORTED:
            value = getattr(getattr(self, section), name)
            if value != ok:
                raise ValueError(f"{section}.{name}={value!r} is not "
                                 f"supported by the port: {why}")

"""Command-line interface of the PyTorch port: ``train`` and ``serve``.

Usage:
  python -m keypoints_interpolation_transformer_torch.cli train \
      --regime a1 --synthetic 64 --epochs 3 [--device cuda]
  python -m keypoints_interpolation_transformer_torch.cli train \
      --regime a2 --synthetic 64 --upload_model a1/best.pth
  python -m keypoints_interpolation_transformer_torch.cli serve \
      --checkpoint model.pth [--device cuda] [--port 8321]
  python -m keypoints_interpolation_transformer_torch.cli serve \
      --checkpoint cycle.pth --variant cycle --first_checkpoint first.pth
  python -m keypoints_interpolation_transformer_torch.cli serve \
      --checkpoint model.pth --quantize int8
  python -m keypoints_interpolation_transformer_torch.cli train \
      --regime a1 --synthetic 64 --precision high   # or serve --precision

``train`` takes the JAX package's ``train`` flags that the port honours,
under the same names and defaults, and prints the same JSON line when it
ends; it trains on synthetic videos (reading HDF5 splits waits for h5py on
the card's machine).  For ``serve`` the model configuration comes from the
reference ``.pth`` checkpoint's hyperparameters; ``--variant`` says what
it holds (plain: regimes A1 / A4, cycle: A2, which needs the frozen first
model's ``--first_checkpoint``, embedding: the A3 autoencoder).
``--device cuda`` (the default) runs the CUDA kernels, which build from
``csrc/`` at first use; ``--device cpu`` runs their plain PyTorch
versions.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_precision(p: argparse.ArgumentParser) -> None:
    p.add_argument("--precision", type=str, default="highest",
                   choices=["highest", "high", "default"],
                   help="the matmul precision of the kernels' products: "
                        "float32, bf16x3 or one bf16 pass on the tensor "
                        "cores (norms, activations and biases stay float32; "
                        "training keeps its pointwise chains float32)")


def _add_train(p: argparse.ArgumentParser) -> None:
    B = argparse.BooleanOptionalAction
    p.add_argument("--regime", choices=["a1", "a2", "a3", "a4"],
                   default="a1")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the run trains on")
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--num_layers", type=int, default=6)
    p.add_argument("--lr", type=float, default=5e-6)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--patience", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic videos")
    p.add_argument("--synthetic_motion", type=str, default="smooth",
                   choices=["smooth", "gestures"])
    p.add_argument("--synthetic_vocab", type=int, default=8)
    p.add_argument("--synthetic_min_len", type=int, default=24)
    p.add_argument("--synthetic_max_len", type=int, default=96)
    p.add_argument("--registry_path", type=str, default=None,
                   help="JSON overlay of per-dataset corruption stats "
                        "(dataset_config.json schema)")
    p.add_argument("--dataset_name", type=str, default=None,
                   help="the corruption statistics to use (default 'all')")
    _add_precision(p)
    p.add_argument("--is_random_missing", action="store_true",
                   help="60%% random-frame corruption mode")
    p.add_argument("--augmentation", action=B, default=True)
    p.add_argument("--augmentations_prob", type=float, default=0.5)
    p.add_argument("--double_hand_rotation", action=B, default=True)
    p.add_argument("--device_resident_data", action=B, default=True)
    p.add_argument("--attn_sublayer_fusion", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="the attention-sublayer kernel; off = per-op "
                        "attention kernels")
    p.add_argument("--upload_model", type=str, default=None,
                   help="a2: the frozen first model's .pth")
    p.add_argument("--upload_general_model", type=str, default=None)
    p.add_argument("--upload_embedding_model", type=str, default=None)
    p.add_argument("--early_stop", action=B, default=None,
                   help="default: per regime (a3 never stops on patience)")
    p.add_argument("--resume_from", type=str, default=None,
                   help="a full_state.pt: restores parameters, optimizer, "
                        "epoch counter, schedule position and generator")
    p.add_argument("--max_epochs_this_run", type=int, default=None)
    p.add_argument("--full_state_every", type=int, default=5,
                   help="write full_state.pt every Nth best-checkpoint save "
                        "(epoch 0 always)")
    p.add_argument("--save_checkpoints", action=B, default=True)
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--checkpoint_dir", type=str, default="model_checkpoint")
    p.add_argument("--fused_loss", action="store_true",
                   help="the fused masked-loss kernel for the criterion")


def config_from_args(a):
    from .utils.config import Config, DataConfig, ModelConfig, TrainConfig
    return Config(
        model=ModelConfig(hidden_dim=a.hidden_dim, num_heads=a.num_heads,
                          num_layers=a.num_layers,
                          matmul_precision=a.precision,
                          attn_sublayer_fusion=a.attn_sublayer_fusion),
        data=DataConfig(dataset_name=a.dataset_name or "all",
                        batch_size=a.batch_size, max_seq_len=a.max_seq_len,
                        synthetic_num_videos=a.synthetic, seed=a.seed,
                        synthetic_motion=a.synthetic_motion,
                        synthetic_vocab=a.synthetic_vocab,
                        synthetic_min_len=a.synthetic_min_len,
                        synthetic_max_len=a.synthetic_max_len,
                        is_random_missing=a.is_random_missing,
                        have_augmentation=a.augmentation,
                        augmentations_prob=a.augmentations_prob,
                        double_hand_rotation=a.double_hand_rotation,
                        device_resident_data=a.device_resident_data,
                        registry_path=a.registry_path),
        train=TrainConfig(regime=a.regime, lr=a.lr, epochs=a.epochs,
                          patience=a.patience, seed=a.seed,
                          experiment_name=a.experiment_name,
                          upload_model=a.upload_model,
                          upload_general_model=a.upload_general_model,
                          upload_embedding_model=a.upload_embedding_model,
                          early_stop=a.early_stop,
                          resume_from=a.resume_from,
                          max_epochs_this_run=a.max_epochs_this_run,
                          save_checkpoints=a.save_checkpoints,
                          results_dir=a.results_dir,
                          checkpoint_dir=a.checkpoint_dir,
                          fused_loss=a.fused_loss,
                          full_state_every=a.full_state_every))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="keypoints_interpolation_transformer_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_train(sub.add_parser("train",
                              help="unified trainer (regimes a1-a4)"))
    p = sub.add_parser("serve", help="HTTP inpainting endpoint")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="reference-schema .pth checkpoint")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--bucket_multiple", type=int, default=32)
    p.add_argument("--variant", type=str, default="plain",
                   choices=["plain", "cycle", "embedding"],
                   help="checkpoint type: plain=a1/a4, cycle=a2 (needs "
                        "--first_checkpoint), embedding=a3")
    p.add_argument("--first_checkpoint", type=str, default=None,
                   help="the frozen plain model feeding a cycle checkpoint")
    p.add_argument("--quantize", type=str, default=None, choices=["int8"],
                   help="int8 weight and activation matmuls (the int8 FF "
                        "and dense kernels; see eval/serving.Inpainter)")
    _add_precision(p)
    p.add_argument("--log_requests", action="store_true")
    return parser


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if a.cmd == "train":
        from .train.loop import train
        res = train(config_from_args(a), device=a.device)
        print(json.dumps({
            "best_val_loss": res.best_val_loss,
            "best_epoch": res.best_epoch,
            "epochs_run": res.epochs_run,
            "checkpoint": res.checkpoint_path,
        }))
        return 0
    if a.cmd == "serve":
        from .eval.serving import Inpainter, serve
        serve(Inpainter.from_checkpoint(a.checkpoint, device=a.device,
                                        max_seq_len=a.max_seq_len,
                                        bucket_multiple=a.bucket_multiple,
                                        variant=a.variant,
                                        first_checkpoint=a.first_checkpoint,
                                        quantize=a.quantize,
                                        precision=a.precision),
              host=a.host, port=a.port, log_requests=a.log_requests)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())

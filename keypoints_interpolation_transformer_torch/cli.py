"""Command-line interface of the PyTorch port: the ``serve`` subcommand.

Usage:
  python -m keypoints_interpolation_transformer_torch.cli serve \
      --checkpoint model.pth [--device cuda] [--port 8321]
  python -m keypoints_interpolation_transformer_torch.cli serve \
      --checkpoint cycle.pth --variant cycle --first_checkpoint first.pth

The model configuration comes from the reference ``.pth`` checkpoint's
hyperparameters; ``--variant`` says what it holds (plain: regimes A1 / A4,
cycle: A2, which needs the frozen first model's ``--first_checkpoint``,
embedding: the A3 autoencoder).  ``--device cuda`` (the default) runs the CUDA kernels,
which build from ``csrc/`` at first use; ``--device cpu`` runs their plain
PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="keypoints_interpolation_transformer_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
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
    p.add_argument("--log_requests", action="store_true")
    return parser


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if a.cmd == "serve":
        from .eval.serving import Inpainter, serve
        serve(Inpainter.from_checkpoint(a.checkpoint, device=a.device,
                                        max_seq_len=a.max_seq_len,
                                        bucket_multiple=a.bucket_multiple,
                                        variant=a.variant,
                                        first_checkpoint=a.first_checkpoint),
              host=a.host, port=a.port, log_requests=a.log_requests)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())

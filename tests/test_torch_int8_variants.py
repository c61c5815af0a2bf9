"""The port's int8 serving of the Cycle and Embedding variants and of a
per-op bucket against the JAX package's int8 Inpainter on its TPU route,
on the CPU (see ``test_torch_int8_serving.py``, whose helpers these tests
share)."""

import torch

from keypoints_interpolation_transformer_tpu.utils.config import (
    ModelConfig as JaxModelConfig)
from keypoints_interpolation_transformer_torch.models.completer import (
    Embedding, KeypointCompleter, keypoint_completer_cycle)
from keypoints_interpolation_transformer_torch.models.convert import (
    save_reference_pth)
from test_torch_int8_serving import _compare, _gen, _serve

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

HYPER = {"hidden_dim": 128, "num_layers": 1, "num_heads": 4}


def test_int8_cycle_matches_jax_tpu_route(rng, tmp_path):
    """Both models of a Cycle pair int8, one layer, D=128 (a bucket of 32
    frames: the pointwise kernels and the merged layers, so no ``nn.Dense``
    runs in the JAX package).  Where one does run (D not a multiple of
    128, a per-op bucket), the JAX Inpainter's int8 table, keyed by module
    path and built from the Cycle model alone, also feeds the first
    model's Dense calls the Cycle model's int8 weights; the port quantizes
    each model's own weights, so the two part there."""
    paths = {n: str(tmp_path / f"{n}.pth") for n in ("first", "cycle")}
    save_reference_pth(paths["first"], KeypointCompleter(
        128, 1, 4, ff_dim=256, generator=_gen(0)), HYPER)
    save_reference_pth(paths["cycle"], keypoint_completer_cycle(
        128, 1, 4, ff_dim=256, generator=_gen(1)), HYPER)
    cfg = JaxModelConfig(hidden_dim=128, num_layers=1, num_heads=4,
                         ff_dim=256)
    _compare("cycle", *_serve(paths["cycle"], cfg, (21, 32), rng,
                              first=paths["first"], variant="cycle",
                              bucket_multiple=32, max_seq_len=32))


def test_int8_embedding_matches_jax_tpu_route(rng, tmp_path):
    """The Embedding autoencoder: its two Linears through the int8 dense
    layer (the JAX package's interceptor on its ``nn.Dense``)."""
    path = str(tmp_path / "embedding.pth")
    save_reference_pth(path, Embedding(32, generator=_gen(2)),
                       {"hidden_dim": 32})
    cfg = JaxModelConfig(hidden_dim=32)
    _compare("embedding", *_serve(path, cfg, (12, 30), rng,
                                  variant="embedding", bucket_multiple=16,
                                  max_seq_len=32))


def test_int8_per_op_bucket_matches_jax_tpu_route(rng, tmp_path):
    """A bucket of 20 frames (no multiple of 8): attention per op, its
    q / k / v / out projections int8 (one int8 dense call over the packed
    q / k / v weight against three in the JAX package: the scales are per
    output column and per input row, so the two agree), the int8 FF
    sublayer, the pointwise chains' Linears int8."""
    path = str(tmp_path / "m.pth")
    save_reference_pth(path, KeypointCompleter(32, 1, 4, ff_dim=64,
                                               generator=_gen(5)),
                       {"hidden_dim": 32, "num_layers": 1, "num_heads": 4})
    cfg = JaxModelConfig(hidden_dim=32, num_layers=1, num_heads=4, ff_dim=64)
    _compare("per-op", *_serve(path, cfg, (13, 20), rng, bucket_multiple=20,
                               max_seq_len=20))

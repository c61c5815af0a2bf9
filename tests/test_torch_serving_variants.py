"""The PyTorch port's Cycle and Embedding serving variants against the JAX
package on the CPU: the Inpainter from the same reference ``.pth`` files,
the Embedding checkpoint schema and converter, the CLI flags, and that the
new entry points run on the card unless the caller asks for the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypoints_interpolation_transformer_tpu.eval import serving as jserving
from keypoints_interpolation_transformer_tpu.models.completer import (
    Embedding as JaxEmbedding)
from keypoints_interpolation_transformer_tpu.train.checkpoint import (
    load_reference_checkpoint)
from keypoints_interpolation_transformer_tpu.utils.config import ModelConfig
from keypoints_interpolation_transformer_torch import cli
from keypoints_interpolation_transformer_torch.eval import serving
from keypoints_interpolation_transformer_torch.models.completer import (
    Embedding, KeypointCompleter, keypoint_completer_cycle)
from keypoints_interpolation_transformer_torch.models.convert import (
    embedding_params_from_jax, is_embedding_state_dict, load_reference_pth,
    save_reference_pth)
from keypoints_interpolation_transformer_torch.train import steps

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

MC = ModelConfig(hidden_dim=32, num_layers=1, num_heads=4, ff_dim=64)
HYPER = {"hidden_dim": 32, "num_layers": 1, "num_heads": 4}
KW = dict(bucket_multiple=16, max_seq_len=64)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def pths(tmp_path_factory):
    """Reference .pth files of a Cycle pair (the frozen first plain model
    and the Cycle model) and of an Embedding autoencoder."""
    d = tmp_path_factory.mktemp("variants")
    paths = {n: str(d / f"{n}.pth") for n in ("first", "cycle", "embedding")}
    save_reference_pth(paths["first"], KeypointCompleter(
        32, 1, 4, ff_dim=64, generator=_gen(0)), HYPER)
    save_reference_pth(paths["cycle"], keypoint_completer_cycle(
        32, 1, 4, ff_dim=64, generator=_gen(1)), HYPER)
    save_reference_pth(paths["embedding"], Embedding(32, generator=_gen(2)),
                       {"hidden_dim": 32})
    return paths


def _videos(rng, lengths=(10, 25, 40)):
    videos = [rng.uniform(0.2, 0.8, (t, 54, 2)).astype(np.float32)
              for t in lengths]
    masks = [(rng.random(t) < 0.3).astype(np.float32) for t in lengths]
    return videos, masks


@pytest.mark.parametrize("variant", ["cycle", "embedding"])
def test_variant_inpainter_matches_jax_inpainter(rng, pths, variant):
    videos, masks = _videos(rng)
    first = pths["first"] if variant == "cycle" else None
    want = jserving.Inpainter.from_checkpoint(
        pths[variant], MC, first_checkpoint=first, variant=variant,
        **KW).inpaint(videos, masks)
    inp = serving.Inpainter.from_checkpoint(
        pths[variant], first_checkpoint=first, variant=variant,
        device="cpu", **KW)
    got = inp.inpaint(videos, masks)
    for v, m, g, w in zip(videos, masks, got, want):
        assert g.shape == v.shape
        np.testing.assert_array_equal(g[m == 0], v[m == 0])  # bit-exact
        np.testing.assert_allclose(g, w, atol=2e-5)
        assert not np.allclose(g[m == 1], v[m == 1])
    if variant == "cycle":
        assert inp.model.pe_residual and inp.model.use_tgt_key_padding
        assert not inp.first_model.pe_residual
    else:
        assert isinstance(inp.model, Embedding)


def test_cycle_forward_matches_jax(rng, pths):
    """``cycle_forward`` against the JAX one on a padded batch: the first
    model's prediction, detached, fills the Cycle model's stream."""
    from keypoints_interpolation_transformer_tpu.train import steps as jsteps
    B, T = 2, 24
    x = rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(np.float32)
    x_no = rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(np.float32)
    xm = (rng.random((B, T)) < 0.3).astype(np.float32)
    ym = (rng.random((B, T)) < 0.3).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[1, 17:] = 0.0
    jp = {n: load_reference_checkpoint(pths[n])[0] for n in ("first",
                                                            "cycle")}
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jsteps.cycle_forward(
            jsteps.build_model(MC, "plain"), jp["first"],
            jsteps.build_model(MC, "cycle"), jp["cycle"],
            *(jnp.asarray(a) for a in (x, x_no, xm, ym, valid))))
    models = {}
    for n, v in (("first", "plain"), ("cycle", "cycle")):
        models[n] = steps.build_model(MC, v, device="cpu").eval()
        models[n].load_state_dict(load_reference_pth(pths[n])[0])
    with torch.no_grad():
        got = steps.cycle_forward(
            models["first"], models["cycle"],
            *(torch.from_numpy(a) for a in (x, x_no, xm, ym, valid)))
    real = valid > 0
    np.testing.assert_allclose(got.numpy()[real], want[real], atol=2e-5)


def test_embedding_pth_round_trip_and_converter(pths, tmp_path):
    sd, hyper = load_reference_pth(pths["embedding"])
    assert is_embedding_state_dict(sd)
    assert not is_embedding_state_dict(load_reference_pth(pths["first"])[0])
    assert set(sd) == {"input_embedding.weight", "input_embedding.bias",
                       "output_embedding.weight", "output_embedding.bias"}
    assert hyper == {"input_size": 108, "hidden_dim": 32, "num_layers": 0,
                     "num_heads": 0}
    # written back by the port, read again: the same tensors
    emb = Embedding(32)
    emb.load_state_dict(sd)
    out = str(tmp_path / "again.pth")
    save_reference_pth(out, emb, hyper)
    sd2, hyper2 = load_reference_pth(out)
    assert hyper2 == hyper and all(torch.equal(sd[k], sd2[k]) for k in sd)
    # the JAX loader tells it apart the same way; the converters invert
    jparams, _ = load_reference_checkpoint(pths["embedding"])
    back = embedding_params_from_jax(jparams)
    assert back.keys() == sd.keys()
    for k, v in back.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, sd[k].numpy())


def test_embedding_params_from_jax_forward(rng):
    jm = JaxEmbedding(hidden_dim=32)
    x = rng.uniform(0.2, 0.8, (2, 9, 54, 2)).astype(np.float32)
    params = jm.init(jax.random.key(3), jnp.asarray(x))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
    emb = Embedding(32)
    emb.load_state_dict({k: torch.from_numpy(v) for k, v in
                         embedding_params_from_jax(params).items()})
    with torch.no_grad():
        got = emb(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_variant_arguments_are_checked(pths):
    sd = load_reference_pth(pths["cycle"])[0]
    with pytest.raises(ValueError, match="first_state_dict"):
        serving.Inpainter(sd, MC, variant="cycle", device="cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        serving.Inpainter(sd, MC, variant="int8", device="cpu")
    with pytest.raises(ValueError, match=".pth"):
        serving.Inpainter.from_checkpoint(
            pths["cycle"], variant="cycle", first_checkpoint="orbax_dir",
            device="cpu")
    with pytest.raises(ValueError, match="unknown model variant"):
        steps.build_model(MC, "nope", device="cpu")
    # an Embedding's configuration comes from its weights
    inp = serving.Inpainter.from_checkpoint(pths["embedding"],
                                            variant="embedding",
                                            device="cpu")
    assert inp.model.hidden_dim == 32 and inp.first_model is None


def test_new_entry_points_default_to_the_card(pths):
    """Without a device the Cycle Inpainter, the Embedding builder and
    ``cli serve`` run on the card, so on a machine without one they raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.Inpainter.from_checkpoint(pths["cycle"], variant="cycle",
                                          first_checkpoint=pths["first"])
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.build_model(MC, "embedding")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve", "--checkpoint", pths["embedding"], "--variant",
                  "embedding", "--port", "0"])


def test_cli_serve_variant_flags():
    a = cli.build_parser().parse_args(
        ["serve", "--checkpoint", "c.pth", "--variant", "cycle",
         "--first_checkpoint", "f.pth"])
    assert (a.variant, a.first_checkpoint) == ("cycle", "f.pth")
    a = cli.build_parser().parse_args(["serve", "--checkpoint", "m.pth"])
    assert (a.variant, a.first_checkpoint) == ("plain", None)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(
            ["serve", "--checkpoint", "m.pth", "--variant", "int8"])

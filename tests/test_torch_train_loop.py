"""The port's training loop and ``cli train`` on the CPU, at a tiny width:
losses fall, the a1 -> a3 -> a2 -> a4 chain runs through the .pth files it
writes, the A4 graft stays frozen, a resumed run equals the uninterrupted
one, the device-resident feed equals the host feed, the best .pth loads in
the JAX package and gives the port's forward, the CLI prints its JSON
line, and the fields the port does not honour are refused."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypoints_interpolation_transformer_tpu.models.completer import (
    KeypointCompleter as JaxCompleter)
from keypoints_interpolation_transformer_tpu.train import steps as jsteps
from keypoints_interpolation_transformer_tpu.train.checkpoint import (
    load_reference_checkpoint)
from keypoints_interpolation_transformer_tpu.utils import config as jconfig
from keypoints_interpolation_transformer_torch import cli
from keypoints_interpolation_transformer_torch.models.convert import (
    load_reference_pth)
from keypoints_interpolation_transformer_torch.train import loop, steps
from keypoints_interpolation_transformer_torch.train.checkpoint import (
    FULL_STATE)
from keypoints_interpolation_transformer_torch.utils.config import (
    UNSUPPORTED, Config, DataConfig, ModelConfig, TrainConfig)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

D, HEADS, LAYERS, FF = 32, 4, 1, 64


def _cfg(tmp, name, regime="a1", epochs=1, data=None, **train):
    """14 synthetic videos of 17-30 frames: one bucket of 32, 11 for
    training (3 batches of 4, the last filled), 3 for validation."""
    d = dict(batch_size=4, max_seq_len=32, bucket_multiple=16,
             synthetic_num_videos=14, synthetic_min_len=17,
             synthetic_max_len=30, seed=0)
    d.update(data or {})
    return Config(model=ModelConfig(hidden_dim=D, num_heads=HEADS,
                                    num_layers=LAYERS, ff_dim=FF),
                  data=DataConfig(**d),
                  train=TrainConfig(regime=regime, lr=1e-3, epochs=epochs,
                                    experiment_name=name,
                                    checkpoint_dir=str(tmp / "ckpt"),
                                    results_dir=str(tmp / "results"),
                                    **train))


def _run(cfg):
    return loop.train(cfg, device="cpu")


def test_a1_losses_decrease_and_records(tmp_path):
    res = _run(_cfg(tmp_path, "a1", epochs=3))
    assert res.epochs_run == 3 and len(res.train_losses) == 3
    assert res.train_losses[-1] < res.train_losses[0]
    assert res.val_losses[-1] < res.val_losses[0]
    assert res.best_val_loss == min(res.val_losses)
    assert len(res.baseline_losses) == 3  # one per validation video
    assert os.path.isfile(res.checkpoint_path)
    assert os.path.isfile(os.path.join(os.path.dirname(res.checkpoint_path),
                                       FULL_STATE))
    results = tmp_path / "results"
    records = [json.loads(line) for line in
               (results / "a1.metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in records if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [0, 1, 2]
    assert "cubic_val_loss" in epochs[0] and "grad_norm" in epochs[0]
    assert epochs[0]["train_frames"] == 3 * 4 * 32
    back = Config.from_json_file(str(results / "a1.config.json"))
    assert back == _cfg(tmp_path, "a1", epochs=3)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """a1, then a3, then a2 over a1's .pth, then a4 warm-started from a1
    and grafted from a3: one epoch each."""
    tmp = tmp_path_factory.mktemp("chain")
    a1 = _run(_cfg(tmp, "a1"))
    a3 = _run(_cfg(tmp, "a3", "a3"))
    a2 = _run(_cfg(tmp, "a2", "a2", upload_model=a1.checkpoint_path))
    a4 = _run(_cfg(tmp, "a4", "a4",
                   upload_general_model=a1.checkpoint_path,
                   upload_embedding_model=a3.checkpoint_path))
    return {"a1": a1, "a2": a2, "a3": a3, "a4": a4}


def test_regime_chain_through_pth_files(chain):
    for regime, res in chain.items():
        assert res.epochs_run == 1 and np.isfinite(res.best_val_loss), regime
        sd, hyper = load_reference_pth(res.checkpoint_path)
        assert hyper["hidden_dim"] == D
        embedding = regime == "a3"
        assert any(k.startswith("transformer.") for k in sd) != embedding
    # a3 scores a reconstruction: its freeze-frame baseline is 0
    assert set(chain["a3"].baseline_losses) == {0.0}
    assert chain["a2"].best_val_loss != chain["a1"].best_val_loss


def test_a4_graft_stays_frozen(chain):
    emb, _ = load_reference_pth(chain["a3"].checkpoint_path)
    a4, _ = load_reference_pth(chain["a4"].checkpoint_path)
    a1, _ = load_reference_pth(chain["a1"].checkpoint_path)
    for dst, src in (("input_embedding", "input_embedding"),
                     ("filled_embedding", "input_embedding"),
                     ("fc_final", "output_embedding")):
        for p in ("weight", "bias"):
            assert torch.equal(a4[f"{dst}.{p}"], emb[f"{src}.{p}"]), dst
    # the rest of the a1 warm start trained on
    name = "transformer.encoder.layers.0.linear1.weight"
    assert not torch.equal(a4[name], a1[name])


def test_a2_needs_the_first_model(tmp_path):
    with pytest.raises(ValueError, match="upload_model"):
        _run(_cfg(tmp_path, "a2", "a2"))


def test_resume_equals_uninterrupted(tmp_path):
    full = _run(_cfg(tmp_path, "full", epochs=2))
    cut = _run(_cfg(tmp_path, "cut", epochs=2, max_epochs_this_run=1))
    assert cut.epochs_run == 1
    state = os.path.join(os.path.dirname(cut.checkpoint_path), FULL_STATE)
    rest = _run(_cfg(tmp_path, "rest", epochs=2, resume_from=state))
    assert rest.epochs_run == 1
    np.testing.assert_allclose(rest.train_losses[0], full.train_losses[1],
                               rtol=1e-6)
    np.testing.assert_allclose(rest.val_losses[0], full.val_losses[1],
                               rtol=1e-6)


@pytest.mark.parametrize("fusion,fused_loss", [("auto", False),
                                               ("off", True)])
def test_device_resident_feed_equals_host_feed(tmp_path, fusion, fused_loss):
    """With one bucket the two feeds batch the videos alike (one
    permutation of the same generator), so the runs agree; the per-op
    route with the fused loss too."""
    runs = []
    for resident in (True, False):
        cfg = _cfg(tmp_path, f"r{resident}", epochs=2,
                   data={"device_resident_data": resident},
                   fused_loss=fused_loss)
        cfg.model.attn_sublayer_fusion = fusion
        runs.append(_run(cfg))
    np.testing.assert_allclose(runs[0].train_losses, runs[1].train_losses,
                               rtol=1e-6)
    np.testing.assert_allclose(runs[0].val_losses, runs[1].val_losses,
                               rtol=1e-6)


def test_best_pth_loads_in_jax_and_forwards_alike(chain):
    path = chain["a1"].checkpoint_path
    params, hyper = load_reference_checkpoint(path)
    assert (hyper["hidden_dim"], hyper["num_layers"], hyper["num_heads"]) \
        == (D, LAYERS, HEADS)
    jmodel = JaxCompleter(hidden_dim=D, num_layers=LAYERS, num_heads=HEADS,
                          ff_dim=FF)
    sd, _ = load_reference_pth(path)
    model = steps.build_model(ModelConfig(hidden_dim=D, num_heads=HEADS,
                                          num_layers=LAYERS, ff_dim=FF),
                              device="cpu")
    model.load_state_dict(sd)
    rng = np.random.default_rng(4)
    x = rng.uniform(0.2, 0.8, (2, 24, 54, 2)).astype(np.float32)
    m = (rng.random((2, 24)) < 0.3).astype(np.float32)
    valid = np.ones((2, 24), np.float32)
    valid[1, 20:] = 0.0
    with jax.default_matmul_precision("highest"):
        want = jsteps.completer_forward(jmodel, params, *map(
            jnp.asarray, (x, x, m, m, valid)))
    with torch.no_grad():
        got = steps.completer_forward(model, *map(torch.from_numpy,
                                                  (x, x, m, m, valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_cli_train_prints_its_json_line(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["train", "--device", "cpu", "--regime", "a1",
                   "--synthetic", "6", "--synthetic_min_len", "17",
                   "--synthetic_max_len", "30", "--max_seq_len", "32",
                   "--batch_size", "4", "--epochs", "1", "--hidden_dim",
                   "32", "--num_heads", "4", "--num_layers", "1",
                   "--experiment_name", "cli", "--attn_sublayer_fusion",
                   "off", "--fused_loss"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"best_val_loss", "best_epoch", "epochs_run",
                        "checkpoint"}
    assert out["epochs_run"] == 1 and out["best_epoch"] == 0
    assert os.path.isfile(out["checkpoint"])
    with pytest.raises(SystemExit):  # a flag the port does not honour
        cli.main(["train", "--device", "cpu", "--mesh_data", "2"])


@pytest.mark.parametrize("section,name,ok,why", UNSUPPORTED)
def test_unsupported_fields_raise(tmp_path, section, name, ok, why):
    cfg = _cfg(tmp_path, "x")
    cfg.check_supported()
    value = {str: "other", bool: True, int: 2}[type(ok)]
    setattr(getattr(cfg, section), name, value)
    with pytest.raises(ValueError, match=name):
        _run(cfg)


def test_jax_run_config_snapshot_loads():
    """A run config the JAX package snapshots (its every field, plus
    provenance keys) loads as the port's Config."""
    doc = json.loads(jconfig.Config().to_json())
    doc["framework_version"], doc["git_sha"] = "0", None
    cfg = Config.from_dict(doc)
    assert cfg.to_json() == jconfig.Config().to_json()
    cfg.check_supported()

"""The port stands alone at run time: with jax and the JAX package made
unimportable, a fresh interpreter imports every module of the port and
``chip_smoke``, takes a CPU train step (and one at the precision "high"),
serves a CPU Cycle request and an
int8 one (``Inpainter(quantize="int8")``) and runs ``cli train`` on the
CPU on the sublayer route and on the per-op route with the fused loss.
The training entry points default to the card and raise without one."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = r"""
import importlib
import importlib.abc
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "flax", "optax",
           "keypoints_interpolation_transformer_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)  # the suite's other workers share the cores
import keypoints_interpolation_transformer_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401

from keypoints_interpolation_transformer_torch.train import state, steps
from keypoints_interpolation_transformer_torch.utils.config import (
    Config, ModelConfig)

cfg = Config(model=ModelConfig(hidden_dim=32, num_heads=4, num_layers=1,
                               ff_dim=64))
model = steps.build_model(cfg.model, for_training=True, device="cpu",
                          generator=torch.Generator().manual_seed(0))
st = state.TrainState.create(model, 1e-3)
clean = torch.rand(2, 12, 54, 2, generator=torch.Generator().manual_seed(1))
st, m = steps.make_train_step(model, cfg, None)(
    st, clean, torch.tensor([12, 9]), torch.ones(2),
    torch.Generator().manual_seed(2), 1e-3)
assert torch.isfinite(m["loss"])
# and one step at "high": the FF sublayers bf16x3 (their plain versions)
hcfg = Config(model=ModelConfig(hidden_dim=32, num_heads=4, num_layers=1,
                                ff_dim=64, matmul_precision="high"))
hmodel = steps.build_model(hcfg.model, for_training=True, device="cpu",
                           generator=torch.Generator().manual_seed(0))
assert hmodel.mode == "bf16x3"
st, m = steps.make_train_step(hmodel, hcfg, None)(
    state.TrainState.create(hmodel, 1e-3), clean, torch.tensor([12, 9]),
    torch.ones(2), torch.Generator().manual_seed(2), 1e-3)
assert torch.isfinite(m["loss"])

from keypoints_interpolation_transformer_torch.eval.serving import Inpainter
first, cycle = (steps.build_model(cfg.model, v, device="cpu",
                                  generator=torch.Generator().manual_seed(s))
                for s, v in ((3, "plain"), (4, "cycle")))
inp = Inpainter(cycle.state_dict(), cfg.model, bucket_multiple=16,
                variant="cycle", first_state_dict=first.state_dict(),
                device="cpu")
v = torch.rand(20, 54, 2, generator=torch.Generator().manual_seed(5))
miss = (torch.arange(20) % 3 == 0).float()
out = inp.inpaint([v.numpy()], [miss.numpy()])[0]
assert out.shape == (20, 54, 2) and (out[miss.numpy() == 0]
                                     == v.numpy()[miss.numpy() == 0]).all()
# int8 serving: the int8 dense, FF and merged-layer modules' plain versions
from keypoints_interpolation_transformer_torch.eval import quantize  # noqa
q8 = Inpainter(first.state_dict(), cfg.model, bucket_multiple=16,
               device="cpu", quantize="int8")
out8 = q8.inpaint([v.numpy()], [miss.numpy()])[0]
assert q8.model.int8 and out8.shape == (20, 54, 2)
assert (out8[miss.numpy() == 0] == v.numpy()[miss.numpy() == 0]).all()
import contextlib
import io
import json
import os
import tempfile

from keypoints_interpolation_transformer_torch import cli

tiny = ["--device", "cpu", "--regime", "a1", "--synthetic", "12",
        "--epochs", "1", "--hidden_dim", "32", "--num_heads", "4",
        "--num_layers", "1", "--synthetic_max_len", "40", "--max_seq_len",
        "48"]
here = os.getcwd()
with tempfile.TemporaryDirectory() as tmp:
    os.chdir(tmp)
    for extra in ([], ["--attn_sublayer_fusion", "off", "--fused_loss"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["train", *tiny, *extra]) == 0
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert res["epochs_run"] == 1 and os.path.isfile(res["checkpoint"])
    os.chdir(here)
loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
print("IMPORTED", len(names), "LOADED", loaded)
"""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300,
                       stdin=subprocess.DEVNULL)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout
    n = int(r.stdout.split("IMPORTED")[1].split()[0])
    assert n >= 20  # every module of the port was walked


def test_training_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """Without a card, ``train()``, ``cli train`` and
    ``KeypointDataset.device_buckets`` refuse to run on the CPU unless
    asked to."""
    import pytest
    import torch

    from keypoints_interpolation_transformer_torch import cli
    from keypoints_interpolation_transformer_torch.data.pipeline import (
        KeypointDataset)
    from keypoints_interpolation_transformer_torch.data.synthetic import (
        synthetic_dataset)
    from keypoints_interpolation_transformer_torch.train.loop import train
    from keypoints_interpolation_transformer_torch.utils.config import (
        Config, DataConfig)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(Config(data=DataConfig(synthetic_num_videos=4)))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", "--synthetic", "4", "--epochs", "1"])
    ds = KeypointDataset(videos=synthetic_dataset(3, 12, 20))
    with pytest.raises(RuntimeError, match="CUDA"):
        ds.device_buckets()
    assert set(ds.device_buckets(device="cpu")) == {32}

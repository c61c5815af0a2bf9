"""The port stands alone at run time: with jax and the JAX package made
unimportable, a fresh interpreter imports every module of the port and
``chip_smoke``, takes a CPU train step and serves a CPU Cycle request."""

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

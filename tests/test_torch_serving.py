"""The PyTorch port's serving path against the JAX package on the CPU: the
Inpainter, the reference ``.pth`` route, the HTTP endpoint, the CLI, and
that the port runs without jax."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypoints_interpolation_transformer_tpu.eval import serving as jserving
from keypoints_interpolation_transformer_tpu.models.completer import (
    KeypointCompleter as JaxCompleter)
from keypoints_interpolation_transformer_tpu.train.checkpoint import (
    save_reference_checkpoint)
from keypoints_interpolation_transformer_tpu.utils.config import ModelConfig
from keypoints_interpolation_transformer_torch import cli
from keypoints_interpolation_transformer_torch.eval import serving
from keypoints_interpolation_transformer_torch.models.convert import (
    load_reference_pth, params_from_jax, save_reference_pth)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MC = ModelConfig(hidden_dim=32, num_layers=1, num_heads=4, ff_dim=64)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxCompleter(hidden_dim=32, num_layers=1, num_heads=4, ff_dim=64)
    x = jnp.zeros((1, 8, 54, 2))
    return model.init(jax.random.key(0), x, x)["params"]


def _videos(rng, lengths=(10, 25, 40)):
    videos = [rng.uniform(0.2, 0.8, (t, 54, 2)).astype(np.float32)
              for t in lengths]
    masks = [(rng.random(t) < 0.3).astype(np.float32) for t in lengths]
    return videos, masks


def test_inpainter_matches_jax_inpainter(rng, jax_params):
    videos, masks = _videos(rng)
    kw = dict(bucket_multiple=16, max_seq_len=64)
    want = jserving.Inpainter({"params": jax_params}, MC, **kw).inpaint(
        videos, masks)
    got = serving.Inpainter(params_from_jax(jax_params), MC, device="cpu",
                            **kw).inpaint(videos, masks)
    for v, m, g, w in zip(videos, masks, got, want):
        assert g.shape == v.shape
        np.testing.assert_array_equal(g[m == 0], v[m == 0])  # bit-exact
        np.testing.assert_allclose(g, w, atol=2e-5)
        assert not np.allclose(g[m == 1], v[m == 1])


def test_jax_written_pth_loads_into_port(rng, jax_params, tmp_path):
    path = str(tmp_path / "jax.pth")
    save_reference_checkpoint(path, jax_params, hidden_dim=32, num_layers=1,
                              num_heads=4)
    videos, masks = _videos(rng, (20,))
    want = jserving.Inpainter.from_checkpoint(
        path, MC, bucket_multiple=16).inpaint(videos, masks)
    inp = serving.Inpainter.from_checkpoint(path, bucket_multiple=16,
                                            device="cpu")
    assert inp.model.ff_dim == 64  # read from the checkpoint's shapes
    got = inp.inpaint(videos, masks)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5)

    # and the port writes the same schema back
    out = str(tmp_path / "port.pth")
    save_reference_pth(out, inp.model, {"hidden_dim": 32, "num_layers": 1,
                                        "num_heads": 4})
    sd_a, hyper = load_reference_pth(out)
    sd_b, _ = load_reference_pth(path)
    assert hyper == {"input_size": 108, "hidden_dim": 32, "num_layers": 1,
                     "num_heads": 4}
    assert sd_a.keys() == sd_b.keys()
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)


def test_inpainter_rejects_what_the_port_does_not_serve(jax_params):
    sd = params_from_jax(jax_params)
    with pytest.raises(ValueError):
        serving.Inpainter(sd, MC, variant="cycle", device="cpu")
    with pytest.raises(ValueError):
        serving.Inpainter(sd, ModelConfig(hidden_dim=32, num_layers=1,
                                          num_heads=4, ff_dim=64,
                                          matmul_precision="fp8"),
                          device="cpu")
    with pytest.raises(ValueError):
        serving.Inpainter.from_checkpoint("orbax_dir")


def _post(base, payload):
    return urllib.request.urlopen(urllib.request.Request(
        f"{base}/inpaint", json.dumps(payload).encode(),
        {"Content-Type": "application/json"}), timeout=120)


def test_http_serving_endpoint(rng, jax_params):
    inp = serving.Inpainter(params_from_jax(jax_params), MC,
                            bucket_multiple=16, max_seq_len=32, device="cpu")
    server, batcher = serving.make_server(inp, host="127.0.0.1", port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        ok = json.loads(urllib.request.urlopen(f"{base}/healthz",
                                               timeout=30).read())
        assert ok == {"ok": True}
        v = rng.uniform(0.2, 0.8, (8, 54, 2)).astype(np.float32)
        m = [0, 1, 1, 0, 0, 0, 1, 0]
        out = np.asarray(json.loads(_post(base, {
            "videos": [v.tolist()], "masks": [m]}).read())["videos"][0],
            np.float32)
        mm = np.array(m)
        np.testing.assert_array_equal(out[mm == 0], v[mm == 0])
        np.testing.assert_allclose(out, inp.inpaint([v], [mm])[0],
                                   atol=1e-6)
        for bad in ({"videos": [[[0.1, 0.2]] * 4], "masks": [[0] * 4]},
                    {"videos": [v.tolist()], "masks": [[0] * 3]},
                    {"videos": [v.tolist()]}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, bad)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert e.value.code == 404
        stats = json.loads(urllib.request.urlopen(f"{base}/statz",
                                                  timeout=30).read())
        assert stats["requests"] == 1 and stats["videos"] == 1
        assert stats["batches"] == 1
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_batcher_merges_concurrent_requests(rng, jax_params):
    inp = serving.Inpainter(params_from_jax(jax_params), MC,
                            bucket_multiple=16, max_seq_len=32, device="cpu")
    batcher = serving.RequestBatcher(inp, max_batch_videos=64,
                                     window_ms=200.0)
    try:
        videos, masks = _videos(rng, (9, 20, 31))
        futs = [batcher.submit([v], [m]) for v, m in zip(videos, masks)]
        res = [f.result(120)[0] for f in futs]
        want = inp.inpaint(videos, masks)
        for r, w in zip(res, want):
            np.testing.assert_allclose(r, w, atol=1e-6)
        assert batcher.stats["requests"] == 3
        assert batcher.stats["max_batch_videos"] >= 2
    finally:
        batcher.close()


def test_inpainter_defaults_to_the_card(jax_params):
    """Without a device the Inpainter runs on the card, so on a machine
    without one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.Inpainter(params_from_jax(jax_params), MC)


def test_cli_serve_parser():
    a = cli.build_parser().parse_args(
        ["serve", "--checkpoint", "m.pth", "--port", "0", "--device", "cpu"])
    assert (a.cmd, a.checkpoint, a.port, a.device) == ("serve", "m.pth", 0,
                                                       "cpu")
    assert cli.build_parser().parse_args(
        ["serve", "--checkpoint", "m.pth"]).device == "cuda"


_NO_JAX = r"""
import sys
import numpy as np
import torch
from keypoints_interpolation_transformer_torch import cli
from keypoints_interpolation_transformer_torch.eval.serving import Inpainter
from keypoints_interpolation_transformer_torch.models.completer import (
    KeypointCompleter)
from keypoints_interpolation_transformer_torch.utils.config import ModelConfig

m = KeypointCompleter(32, 1, 4, ff_dim=64,
                      generator=torch.Generator().manual_seed(0))
inp = Inpainter(m.state_dict(), ModelConfig(hidden_dim=32, num_layers=1,
                                            num_heads=4, ff_dim=64),
                bucket_multiple=16, device="cpu")
v = np.random.default_rng(0).uniform(size=(12, 54, 2)).astype(np.float32)
out = inp.inpaint([v], [np.eye(12, dtype=np.float32)[3]])[0]
assert out.shape == v.shape and np.isfinite(out).all()
cli.build_parser()
loaded = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "flax"))
print("LOADED", loaded)
assert not loaded, loaded
"""


def test_port_runs_without_jax():
    """A fresh interpreter imports the port's serving path and CLI, runs a
    CPU inpaint, and never loads jax (the pytest process has it already)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout

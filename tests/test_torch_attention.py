"""The per-op attention module of the PyTorch port against the JAX package
on the CPU: the plain forward against ``_xla_attention`` and the Pallas
``fused_attention`` in interpret mode, the plain backward against
``jax.vjp``, a float64 gradcheck of ``AttentionFunction``, the routing rule
against the JAX predicate, and the per-op-route model (forward, A1 loss
and gradients) against the JAX model built with sublayer fusion off.  The
CUDA kernels themselves run only on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``)."""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.models import layers as jlayers
from keypoints_interpolation_transformer_tpu.ops.pallas import (
    attention as jattn)
from keypoints_interpolation_transformer_tpu.train import steps as jsteps
from keypoints_interpolation_transformer_tpu.utils import config as jconfig
from keypoints_interpolation_transformer_torch.models import layers
from keypoints_interpolation_transformer_torch.models.convert import (
    params_from_jax, state_dict_tensors)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import (
    layer_fused as tlf)
from keypoints_interpolation_transformer_torch.train import steps
from keypoints_interpolation_transformer_torch.utils.config import (
    ModelConfig)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

TOL = 2e-5  # the JAX kernel tests' f32 forward and gradient tolerance
B, T, H, DH = 3, 24, 4, 8
CASES = [("repeat-inc", True), ("repeat-inc", False), ("all", True),
         ("all", False)]


@contextlib.contextmanager
def _interpret():
    """The Pallas kernels as the JAX kernel tests run them on the CPU."""
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        yield


def _inputs(seed, dtype=np.float32):
    """q, k, v, g (B, T, H, dh); a frame mask; valid with a padded video
    and a video whose keys are all padded (every query row blocked)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, T, H, DH)).astype(dtype)
                  for _ in range(4))
    mask = (rng.random((B, T)) < 0.3).astype(dtype)
    valid = np.ones((B, T), dtype)
    valid[1, 15:] = 0.0
    valid[2] = 0.0
    return q, k, v, g, mask, valid


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


@pytest.mark.parametrize("kind,keypad", CASES)
def test_plain_forward_matches_jax(kind, keypad):
    q, k, v, _, mask, valid = _inputs(0)
    got = kernels.attention_plain(*_t(q, k, v, mask, valid), kind,
                                  keypad).numpy()
    assert np.isfinite(got).all()
    want = np.asarray(jattn.xla_attention(*map(jnp.asarray, (q, k, v, mask,
                                                             valid)),
                                          kind, keypad))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    with _interpret():
        pallas = np.asarray(jattn.fused_attention(
            *map(jnp.asarray, (q, k, v, mask, valid)), kind, keypad))
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=0)
    # every key of video 2 is padded (NEG on all of them): each row
    # averages v uniformly over the keys repeat-inc leaves it (NaN-free)
    allowed = np.ones((T, T))
    if kind == "repeat-inc":
        allowed = ~((np.arange(T)[None] > np.arange(T)[:, None])
                    & (mask[2][None] > 0))
    uniform = allowed / allowed.sum(1, keepdims=True)
    np.testing.assert_allclose(got[2], np.einsum("qk,khd->qhd", uniform,
                                                 v[2]), atol=1e-5)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    kernels.reset_launches()
    same = kernels.fused_attention(*_t(q, k, v, mask, valid), kind, keypad)
    np.testing.assert_array_equal(same.numpy(), got)
    assert kernels.launch_counts()["attention"] == 0


@pytest.mark.parametrize("kind,keypad", CASES)
def test_plain_backward_matches_jax_vjp(kind, keypad):
    q, k, v, g, mask, valid = _inputs(1)
    got = kernels.attention_bwd_plain(*_t(q, k, v, g, mask, valid), kind,
                                      keypad)
    _, vjp = jax.vjp(lambda q_, k_, v_: jattn.xla_attention(
        q_, k_, v_, jnp.asarray(mask), jnp.asarray(valid), kind, keypad),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    scale = max(float(np.abs(w).max()) for w in want)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(w) / scale,
                                   atol=TOL, rtol=0, err_msg=f"d{name}")
    # and the autograd Function on the CPU returns the same gradients
    qt, kt, vt = (x.requires_grad_() for x in _t(q, k, v))
    out = kernels.AttentionFunction.apply(qt, kt, vt,
                                          *_t(mask, valid), kind, keypad)
    out.backward(torch.from_numpy(g))
    for a, b in zip((qt.grad, kt.grad, vt.grad), got):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind,keypad", CASES)
def test_attention_function_gradcheck(kind, keypad):
    # one video of 6 frames, 2 heads of 4, its last key padded: small
    # enough for a float64 gradcheck in well under a second
    q, k, v, _, _, _ = _inputs(2, np.float64)
    sl = (slice(1, 2), slice(None, 6), slice(None, 2), slice(None, 4))
    q, k, v = (torch.from_numpy(np.ascontiguousarray(x[sl]))
               .requires_grad_() for x in (q, k, v))
    mask = torch.tensor([[0.0, 1.0, 0.0, 1.0, 1.0, 0.0]],
                        dtype=torch.float64)
    valid = torch.tensor([[1.0, 1.0, 1.0, 1.0, 1.0, 0.0]],
                         dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: kernels.AttentionFunction.apply(
            q_, k_, v_, mask, valid, kind, keypad), (q, k, v),
        fast_mode=True)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("T_", [64, 512, 520, 608])
def test_routing_rule_matches_jax(fuse, T_):
    D = 256
    want = jlayers._use_sublayer_kernel({"sublayer": fuse}, T_, D)
    assert tlf.use_sublayer_kernel(fuse, T_, D) == want


def test_wrapper_checks_on_the_cpu_side():
    q, k, v, g, mask, valid = _t(*_inputs(3))
    with pytest.raises(ValueError, match="mask kind"):
        kernels.attention_plain(q, k, v, mask, valid, "triangle")
    # Tq != Tk is refused by the kernels; the shape check says so
    from keypoints_interpolation_transformer_torch.ops.kernels import _build
    with pytest.raises(ValueError, match="shape"):
        _build.check_shape("fused_attention", "k", k[:, :5], q.shape)


# ---------------------------------------------------------------------------
# the per-op route of the whole model
# ---------------------------------------------------------------------------

MB, MT, MD, LAYERS, MH, FF = 3, 16, 32, 1, 4, 64


@pytest.fixture(scope="module")
def jax_per_op():
    """The JAX model with sublayer fusion off on its Pallas attention path
    (interpret mode): parameters, one corrupted A1 batch, the forward on
    it, the A1 loss and its gradients."""
    mc = jconfig.ModelConfig(hidden_dim=MD, num_heads=MH, num_layers=LAYERS,
                             ff_dim=FF, attention_impl="pallas",
                             attn_sublayer_fusion="off")
    model = jsteps.build_model(mc, "plain", for_training=True)
    rng = np.random.default_rng(5)
    clean = jnp.asarray(rng.uniform(0.2, 0.8, (MB, MT, 54, 2)).astype(
        np.float32))
    length = jnp.asarray([MT, 11, 7], jnp.int32)
    weight = jnp.asarray([1.0, 1.0, 0.5], jnp.float32)
    with _interpret():
        params = model.init(jax.random.key(1), clean, clean)["params"]
    with torch.no_grad():  # the batch both packages are fed
        batch = [jnp.asarray(o.numpy()) for o in steps.corrupt_batch(
            torch.Generator().manual_seed(2), *_t(clean, length),
            augment=True, aug_prob=0.5, is_random_missing=False,
            dataset_name="all", stats=None)]
    criterion = jsteps.make_train_criterion("a1", False)

    def loss_fn(p):
        x, x_no, x_mask, y_mask, valid = jsteps.shift_streams(
            batch[1], batch[2], length)
        pred = jsteps.completer_forward(model, p, x, x_no, x_mask, y_mask,
                                        valid)
        per_video = criterion(pred, batch[0], valid)
        return jsteps._weighted_mean(per_video, weight), pred

    with _interpret():
        (loss, pred), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                         has_aux=True))(
            params)
    return dict(params=params, batch=[np.asarray(b) for b in batch],
                length=np.asarray(length), weight=np.asarray(weight),
                loss=float(loss), pred=np.asarray(pred), grads=grads)


def test_per_op_model_matches_jax(jax_per_op, monkeypatch):
    cfg = ModelConfig(hidden_dim=MD, num_heads=MH, num_layers=LAYERS,
                      ff_dim=FF, attn_sublayer_fusion="off")
    model = steps.build_model(cfg, for_training=True, device="cpu")
    assert not model.attn_sublayer_fusion and not model.merge_layers
    model.load_state_dict(state_dict_tensors(params_from_jax(
        jax_per_op["params"])))
    y, inputs, mask = _t(*jax_per_op["batch"])
    length, weight = _t(jax_per_op["length"], jax_per_op["weight"])
    # the route: per op everywhere, the sublayer kernel nowhere
    calls = {"attend": 0, "sublayer": 0}
    for name in calls:
        def counted(self, *a, _orig=getattr(layers.MultiHeadAttention, name),
                    _name=name, **kw):
            calls[_name] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(layers.MultiHeadAttention, name, counted)
    crit = steps.make_train_criterion("a1", False)
    loss, _ = steps.a1_loss(model, y, inputs, mask, length, weight, crit)
    x, x_no, x_mask, y_mask, valid = steps.shift_streams(inputs, mask,
                                                         length)
    with torch.no_grad():  # the serving route of the same model
        pred = steps.completer_forward(model, x, x_no, x_mask, y_mask, valid)
    assert calls == {"attend": 2 * 3 * LAYERS, "sublayer": 0}
    np.testing.assert_allclose(pred.numpy(), jax_per_op["pred"], atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(loss.item(), jax_per_op["loss"], rtol=1e-5)
    loss.backward()
    want = params_from_jax(jax_per_op["grads"])
    gscale = max(float(np.abs(w).max()) for w in want.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy() / gscale,
                                   want[name] / gscale, atol=TOL,
                                   err_msg=name)

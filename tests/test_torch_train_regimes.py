"""The port's A2, A3 and A4 train steps and the eval step of every regime
against the JAX package on the CPU, at "highest": on injected corrupted
batches (and A3's injected zero gate), the loss, every gradient and the
parameters after one Adam step against ``jax.value_and_grad`` of the JAX
regime losses (``steps.py:271-318``) and ``apply_gradients``; the A4
graft's frozen parameters unchanged exactly; ``make_eval_step``'s
per-video losses and freeze-frame baselines against the JAX
``make_eval_step`` on JAX's own precomputed validation corruption."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypoints_interpolation_transformer_tpu.data import pipeline as jpipe
from keypoints_interpolation_transformer_tpu.data import synthetic as jsyn
from keypoints_interpolation_transformer_tpu.train import state as jstate
from keypoints_interpolation_transformer_tpu.train import steps as jsteps
from keypoints_interpolation_transformer_tpu.transforms.corruption import (
    zero_missing_frames as jzero)
from keypoints_interpolation_transformer_tpu.utils import config as jconfig
from keypoints_interpolation_transformer_torch.models.convert import (
    embedding_params_from_jax, params_from_jax, state_dict_tensors)
from keypoints_interpolation_transformer_torch.train import state, steps
from keypoints_interpolation_transformer_torch.utils.config import (
    Config, ModelConfig, TrainConfig)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

B, T, D, LAYERS, HEADS, FF = 4, 16, 32, 1, 4, 64
LR = 1e-3
VARIANT = {"a1": "plain", "a2": "cycle", "a3": "embedding", "a4": "plain"}
GATE = np.array([True, False, True, True])  # A3: zero the missing frames?


def _jcfg(regime):
    mc = jconfig.ModelConfig(hidden_dim=D, num_heads=HEADS,
                             num_layers=LAYERS, ff_dim=FF)
    return mc, jconfig.Config(model=mc, data=jconfig.DataConfig(),
                              train=jconfig.TrainConfig(regime=regime))


def _cfg(regime):
    return Config(model=ModelConfig(hidden_dim=D, num_heads=HEADS,
                                    num_layers=LAYERS, ff_dim=FF),
                  train=TrainConfig(regime=regime))


def _sd(variant, params):
    convert = embedding_params_from_jax if variant == "embedding" \
        else params_from_jax
    return convert(params)


def _port_model(regime, params, variant=None):
    variant = variant or VARIANT[regime]
    model = steps.build_model(_cfg(regime).model, variant,
                              for_training=True, device="cpu")
    model.load_state_dict(state_dict_tensors(_sd(variant, params)))
    return model


def _t(a):
    return torch.from_numpy(np.array(a))


def _corrupted(clean, length):
    """The batch both packages are fed: augmented and corrupted by the
    port (its generator), as numpy."""
    with torch.no_grad():
        out = steps.corrupt_batch(
            torch.Generator().manual_seed(7), _t(clean), _t(length),
            augment=True, aug_prob=0.5, is_random_missing=False,
            dataset_name="all", stats=None)
    return [o.numpy() for o in out]


@pytest.fixture(scope="module", params=["a2", "a3", "a4"])
def jax_step(request):
    """One JAX step of the regime on an injected corrupted batch: the
    parameters before and after, the loss and the gradients."""
    regime = request.param
    mc, _ = _jcfg(regime)
    model = jsteps.build_model(mc, VARIANT[regime], for_training=True)
    rng = np.random.default_rng(0)
    clean = jnp.asarray(rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(
        np.float32))
    length = jnp.asarray([T, 12, 9, T], jnp.int32)
    weight = jnp.asarray([1.0, 1.0, 0.5, 1.0], jnp.float32)
    init_args = (clean,) if regime == "a3" else (clean, clean)
    params = model.init(jax.random.key(0), *init_args)["params"]
    y, inputs, mask = map(jnp.asarray, _corrupted(clean, length))
    criterion = jsteps.make_train_criterion(regime, False)
    first_model = first_params = freeze = None
    if regime == "a2":
        first_model = jsteps.build_model(mc, "plain", for_training=True)
        first_params = first_model.init(jax.random.key(1), clean,
                                        clean)["params"]
    if regime == "a4":
        freeze = jstate.freeze_mask_for_graft(params)

    def loss_fn(p):
        x, x_no, x_mask, y_mask, valid = jsteps.shift_streams(inputs, mask,
                                                              length)
        target = y
        if regime == "a2":
            pred = jsteps.cycle_forward(first_model, first_params, model, p,
                                        x, x_no, x_mask, y_mask, valid)
        elif regime == "a3":
            x = jnp.where(jnp.asarray(GATE)[:, None, None, None],
                          jzero(x, x_mask), x)
            target = x
            pred = model.apply({"params": p}, x)
        else:
            x = jzero(x, x_mask)
            pred = jsteps.completer_forward(model, p, x, x_no, x_mask,
                                            y_mask, valid)
        per_video = criterion(pred, target, valid)
        return jsteps._weighted_mean(per_video, weight)

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        after = jstate.apply_gradients(jstate.TrainState.create(params),
                                       grads, LR, freeze).params
    return dict(regime=regime, params=params, after=after, grads=grads,
                loss=float(loss), first_params=first_params,
                batch=[np.asarray(a) for a in (y, inputs, mask, length,
                                               weight)])


def _models(jax_step):
    regime = jax_step["regime"]
    model = _port_model(regime, jax_step["params"])
    first = None
    if regime == "a2":
        first = _port_model(regime, jax_step["first_params"], "plain")
    return regime, model, first


def test_regime_loss_and_gradients_match_jax(jax_step):
    regime, model, first = _models(jax_step)
    y, inputs, mask, length, weight = map(_t, jax_step["batch"])
    crit = steps.make_train_criterion(regime, False)
    loss, per_video = steps.regime_loss(regime, model, first, y, inputs,
                                        mask, length, weight, crit,
                                        zero_gate=_t(GATE))
    np.testing.assert_allclose(loss.item(), jax_step["loss"], rtol=1e-5)
    assert per_video.shape == (B,)
    loss.backward()
    want = _sd(VARIANT[regime], jax_step["grads"])
    gscale = max(float(np.abs(w).max()) for w in want.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy() / gscale,
                                   want[name] / gscale, atol=2e-5,
                                   err_msg=name)
    if first is not None:  # the frozen first model gets no gradient
        assert all(p.grad is None for p in first.parameters())


def test_one_step_matches_jax_adam(jax_step):
    """``on_corrupted`` takes one Adam step to where the JAX state went,
    within 1e-5, except entries whose gradient is float noise (below 1e-4
    of the global scale: the k-part of each in_proj_bias, exactly zero in
    exact arithmetic), which Adam moves by up to lr either way; A4's graft
    does not move at all."""
    regime, model, first = _models(jax_step)
    freeze = state.freeze_for_graft(model) if regime == "a4" else None
    st = state.TrainState.create(model, LR)
    step = steps.make_train_step(model, _cfg(regime), None, first, freeze)
    y, inputs, mask, length, weight = map(_t, jax_step["batch"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    st, metrics = step.on_corrupted(st, y, inputs, mask, length, weight, LR,
                                    _t(GATE) if regime == "a3" else None)
    np.testing.assert_allclose(float(metrics["loss"]), jax_step["loss"],
                               rtol=1e-5)
    variant = VARIANT[regime]
    want = _sd(variant, jax_step["after"])
    grads = _sd(variant, jax_step["grads"])
    gscale = max(float(np.abs(g).max()) for g in grads.values())
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        if freeze and name in freeze:
            assert torch.equal(p, before[name]), name
            continue
        real = np.abs(grads[name]) > 1e-4 * gscale
        np.testing.assert_allclose(got[real], want[name][real], atol=1e-5,
                                   err_msg=name)
        moved = np.abs(got[~real] - before[name].numpy()[~real])
        assert moved.size == 0 or moved.max() <= LR * 1.001, name
    if regime == "a4":
        assert sorted(freeze) == sorted(
            n for n in want if n.split(".")[0] in state.GRAFTED)
    with pytest.raises(ValueError, match="gate"):
        if regime != "a3":
            raise ValueError("only a3 needs the gate")
        step.on_corrupted(st, y, inputs, mask, length, weight, LR)


@pytest.fixture(scope="module")
def jax_val():
    """JAX's own validation batch: synthetic videos, its precomputed
    corruption, its first padded batch."""
    vids = jsyn.synthetic_dataset(6, 10, T, seed=3)
    ds = jpipe.KeypointDataset(videos=vids, max_seq_len=T,
                               bucket_multiple=8)
    batch = next(ds.batches(B, corrupted=ds.precompute_corruption(seed=5)))
    return batch


@pytest.mark.parametrize("regime", ["a1", "a2", "a3", "a4"])
def test_eval_step_matches_jax(jax_val, regime):
    mc, jcfg = _jcfg(regime)
    variant = VARIANT[regime]
    model = jsteps.build_model(mc, variant, for_training=True)
    x0 = jnp.zeros((1, 8, 54, 2))
    init_args = (x0,) if regime == "a3" else (x0, x0)
    params = model.init(jax.random.key(2), *init_args)["params"]
    first_model = first_params = None
    extra = ()
    if regime == "a2":
        first_model = jsteps.build_model(mc, "plain", for_training=True)
        first_params = first_model.init(jax.random.key(3), x0, x0)["params"]
        extra = (first_params,)
    b = jax_val
    args = (b.inputs, b.mask, b.clean, b.length)
    with jax.default_matmul_precision("highest"):
        want = jsteps.make_eval_step(model, jcfg, first_model)(
            params, *map(jnp.asarray, args), *extra)
    port = _port_model(regime, params)
    first = _port_model(regime, first_params, "plain") \
        if regime == "a2" else None
    got = steps.make_eval_step(port, _cfg(regime), first)(
        *(_t(a) for a in args))
    for g, w, what in zip(got, want, ("model", "freeze-frame baseline")):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{regime} {what}")

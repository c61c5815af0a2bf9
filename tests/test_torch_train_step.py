"""The port's A1 train step against the JAX package on the CPU: one step's
loss and every parameter gradient against ``jax.value_and_grad`` of the
JAX A1 loss at "highest", the parameters after one and two Adam steps (the
second from ``adam_state_from_jax``), on the same corrupted batches; the
losses, the optimizer pieces and the entry points' device rule."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from keypoints_interpolation_transformer_tpu.ops import losses as jlosses
from keypoints_interpolation_transformer_tpu.train import state as jstate
from keypoints_interpolation_transformer_tpu.train import steps as jsteps
from keypoints_interpolation_transformer_tpu.utils import config as jconfig
from keypoints_interpolation_transformer_torch.models.completer import (
    KeypointCompleter)
from keypoints_interpolation_transformer_torch.models.convert import (
    adam_state_from_jax, params_from_jax, state_dict_tensors)
from keypoints_interpolation_transformer_torch.ops import losses
from keypoints_interpolation_transformer_torch.train import state, steps
from keypoints_interpolation_transformer_torch.utils.config import (
    Config, ModelConfig)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

B, T, D, LAYERS, HEADS, FF = 4, 16, 32, 2, 4, 64
LR = 1e-3


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX A1 steps on a 2-layer model: the parameters before and
    after each, the first step's loss and gradients, and both batches."""
    mc = jconfig.ModelConfig(hidden_dim=D, num_heads=HEADS,
                             num_layers=LAYERS, ff_dim=FF)
    cfg = jconfig.Config(model=mc, data=jconfig.DataConfig(),
                         train=jconfig.TrainConfig(regime="a1"))
    model = jsteps.build_model(mc, "plain", for_training=True)
    rng = np.random.default_rng(0)
    clean = jnp.asarray(rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(
        np.float32))
    length = jnp.asarray([T, 12, 9, T], jnp.int32)
    weight = jnp.asarray([1.0, 1.0, 0.5, 1.0], jnp.float32)
    params = model.init(jax.random.key(0), clean, clean)["params"]
    criterion = jsteps.make_train_criterion("a1", False)

    def loss_fn(p, y, inputs, mask):
        x, x_no, x_mask, y_mask, valid = jsteps.shift_streams(inputs, mask,
                                                              length)
        pred = jsteps.completer_forward(model, p, x, x_no, x_mask, y_mask,
                                        valid)
        per_video = criterion(pred, y, valid)
        return jsteps._weighted_mean(per_video, weight), per_video

    out = {"clean": clean, "length": length, "weight": weight,
           "params": [params], "batches": [], "loss": [], "grads": []}
    st = jstate.TrainState.create(params)
    with jax.default_matmul_precision("highest"):
        # compiled once: the eager JAX ops are what takes the time here
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        corrupt = jax.jit(lambda key: jsteps.corrupt_batch(
            key, clean, length, augment=True, aug_prob=0.5,
            is_random_missing=False, dataset_name="all", stats=None))
        adam = jax.jit(lambda s, g: jstate.apply_gradients(s, g, LR))
        for k in (11, 12):
            batch = corrupt(jax.random.key(k))
            (loss, _), grads = grad_fn(st.params, *batch)
            st = adam(st, grads)
            out["batches"].append(batch)
            out["loss"].append(float(loss))
            out["grads"].append(grads)
            out["params"].append(st.params)
            out.setdefault("opt_states", []).append(st.opt_state)
    return out


def _port_model(params):
    m = KeypointCompleter(D, LAYERS, HEADS, ff_dim=FF)
    m.load_state_dict(state_dict_tensors(params_from_jax(params)))
    return m.train()


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg():
    return Config(model=ModelConfig(hidden_dim=D, num_heads=HEADS,
                                    num_layers=LAYERS, ff_dim=FF))


def _assert_params(model, jax_run, n_steps, start):
    """Parameters after ``n_steps`` JAX steps within 1e-5, except where a
    step's gradient was float noise (below 1e-4 of that step's global
    scale: the k-part of every in_proj_bias, whose gradient is exactly zero
    in exact arithmetic).  Adam divides such a gradient by its own
    magnitude, so the two packages' different noise moves those entries by
    up to lr either way; there each step may move them by at most lr."""
    want = params_from_jax(jax_run["params"][n_steps])
    first = params_from_jax(jax_run["params"][start])
    grads = [params_from_jax(g) for g in jax_run["grads"][start:n_steps]]
    scales = [max(float(np.abs(v).max()) for v in g.values()) for g in grads]
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        real = np.all([np.abs(g[name]) > 1e-4 * s
                       for g, s in zip(grads, scales)], axis=0)
        np.testing.assert_allclose(got[real], want[name][real], atol=1e-5,
                                   err_msg=f"after step {n_steps}: {name}")
        moved = np.abs(got[~real] - first[name][~real])
        assert moved.size == 0 or moved.max() <= (n_steps - start) * LR \
            * 1.001, name


def test_a1_loss_and_gradients_match_jax(jax_run):
    model = _port_model(jax_run["params"][0])
    y, inputs, mask = (_t(a) for a in jax_run["batches"][0])
    crit = steps.make_train_criterion("a1", False)
    loss, per_video = steps.a1_loss(model, y, inputs, mask,
                                    _t(jax_run["length"]),
                                    _t(jax_run["weight"]), crit)
    np.testing.assert_allclose(loss.item(), jax_run["loss"][0], rtol=1e-5)
    assert per_video.shape == (B,)
    loss.backward()
    want = params_from_jax(jax_run["grads"][0])
    gscale = max(float(np.abs(w).max()) for w in want.values())
    for name, p in model.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        np.testing.assert_allclose(p.grad.numpy() / gscale,
                                   want[name] / gscale, atol=2e-5,
                                   err_msg=name)
    # and the step's first Adam update lands where the JAX state's did
    st = state.TrainState.create(model, LR)
    state.apply_gradients(st, LR)
    _assert_params(model, jax_run, 1, 0)


def test_second_step_from_jax_adam_state_matches_jax(jax_run):
    model = _port_model(jax_run["params"][1])
    st = state.TrainState.create(model, LR)
    names = [n for n, _ in model.named_parameters()]
    st.optimizer.load_state_dict(adam_state_from_jax(
        jax_run["opt_states"][0], names, LR))
    step = steps.make_train_step(model, _cfg(), None)
    y, inputs, mask = (_t(a) for a in jax_run["batches"][1])
    st, metrics = step.on_corrupted(st, y, inputs, mask,
                                    _t(jax_run["length"]),
                                    _t(jax_run["weight"]), LR)
    np.testing.assert_allclose(float(metrics["loss"]), jax_run["loss"][1],
                               rtol=1e-5)
    assert st.step == 1 and {"grad_norm", "param_norm"} <= set(metrics)
    _assert_params(model, jax_run, 2, 1)


def test_adam_state_round_trip(jax_run):
    """Optax moments land on the port's parameters, transposed as the
    parameters are, and survive torch's load / save."""
    model = _port_model(jax_run["params"][1])
    names = [n for n, _ in model.named_parameters()]
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    sd = adam_state_from_jax(jax_run["opt_states"][0], names, LR)
    opt.load_state_dict(sd)
    mu = params_from_jax(jax_run["opt_states"][0].mu)
    back = opt.state_dict()
    for i, (name, p) in enumerate(model.named_parameters()):
        s = back["state"][i]
        assert s["exp_avg"].shape == p.shape, name
        np.testing.assert_array_equal(s["exp_avg"].numpy(), mu[name])
        assert float(s["step"]) == 1.0
    assert back["param_groups"][0]["lr"] == LR
    with pytest.raises(KeyError):
        adam_state_from_jax(jax_run["opt_states"][0], ["nope"])


def test_full_step_runs_and_every_parameter_learns():
    torch.manual_seed(0)
    cfg = _cfg()
    model = steps.build_model(cfg.model, for_training=True, device="cpu",
                              generator=torch.Generator().manual_seed(1))
    st = state.TrainState.create(model, LR)
    step = steps.make_train_step(model, cfg, None)
    rng = np.random.default_rng(3)
    clean = torch.from_numpy(rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(
        np.float32))
    length = torch.tensor([T, 12, 9, T])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    g = torch.Generator().manual_seed(5)
    st, m = step(st, clean, length, torch.ones(B), g, LR)
    assert np.isfinite(float(m["loss"])) and m["per_video"].shape == (B,)
    for n, p in model.named_parameters():
        assert not torch.equal(p, before[n]), f"{n} did not move"
    plain = steps.make_train_step(model, cfg, None, plain=True)
    st, m2 = plain(st, clean, length, torch.ones(B),
                   torch.Generator().manual_seed(5), LR)
    assert st.step == 2 and np.isfinite(float(m2["loss"]))
    with pytest.raises(ValueError, match="first_model"):
        steps.make_train_step(model, Config(model=cfg.model,
                                            train=type(cfg.train)(
                                                regime="a2")), None)


def test_losses_match_jax(rng):
    pred = rng.uniform(size=(3, 7, 54, 2)).astype(np.float32)
    tgt = rng.uniform(size=(3, 7, 54, 2)).astype(np.float32)
    w = (rng.random((3, 7)) < 0.7).astype(np.float32)
    for fn, jfn in ((losses.mse_loss, jlosses.mse_loss),
                    (losses.euclidean_loss, jlosses.euclidean_loss),
                    (losses.euclidean_distance_loss,
                     jlosses.euclidean_distance_loss)):
        for fw in (None, w):
            got = fn(_t(pred), _t(tgt), None if fw is None else _t(fw))
            want = jfn(jnp.asarray(pred), jnp.asarray(tgt),
                       None if fw is None else jnp.asarray(fw))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


def test_schedules_and_freeze():
    np.testing.assert_array_equal(state.linear_decay_lrs(1e-3, 5),
                                  jstate.linear_decay_lrs(1e-3, 5))
    np.testing.assert_array_equal(state.step_drop_lrs(1e-3, 100),
                                  jstate.step_drop_lrs(1e-3, 100))
    model = KeypointCompleter(D, 1, HEADS, ff_dim=FF,
                              generator=torch.Generator().manual_seed(2))
    # what the A4 graft freezes
    frozen = [n for n, _ in model.named_parameters()
              if n.split(".")[0] in ("input_embedding", "filled_embedding",
                                     "fc_final")]
    st = state.TrainState.create(model, LR)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    x = torch.rand(2, 8, 54, 2)
    model(x, x).square().mean().backward()
    state.apply_gradients(st, LR, frozen)
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == (n in frozen), n


def test_entry_points_default_to_the_card():
    """Without a card, the training entry points refuse to run on the CPU
    unless asked to (the serving one is tested beside the Inpainter)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.build_model(_cfg().model)

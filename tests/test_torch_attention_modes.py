"""The per-op attention pair in the precision modes "high" (bf16x3) and
"default" (one bf16 pass): the port's plain versions against the JAX
``_fused_fwd`` (``_attn_kernel``) and ``_fused_bwd_pallas``
(``_attn_bwd_kernel``) in interpret mode under the ambient precision; the
autograd Function in a mode, the per-op model (sublayer fusion off) at
"high" against the JAX model and its A1 step, the model's routing of the
mode, the wrappers' counters and table rows, the C signatures.  The CUDA
kernels themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_gpu.py``).

Both packages round the same operands to bf16 (nearest even) and sum exact
bf16 products in float32, so "default" agrees to float32 noise, and "high"
too but where a forward probability, rounded to ONE bf16 in both modes,
lies so near a rounding boundary that the two float32 orders put it on
either side (``FLIP_TOKENS``, as ``tests/test_torch_sublayer_modes.py``
allows it).  The backward rounds no probability to one bf16: at "high" it
splits them.
"""

import contextlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from jax_dense_modes import dense_in_mode
from keypoints_interpolation_transformer_tpu.models import completer as jc
from keypoints_interpolation_transformer_tpu.ops.pallas import (
    attention as jattn)
from keypoints_interpolation_transformer_tpu.train import steps as jsteps
from keypoints_interpolation_transformer_tpu.utils import config as jconfig
from keypoints_interpolation_transformer_torch.models import layers
from keypoints_interpolation_transformer_torch.models.completer import (
    KeypointCompleter)
from keypoints_interpolation_transformer_torch.models.convert import (
    params_from_jax, state_dict_tensors)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import _build
from keypoints_interpolation_transformer_torch.ops.kernels import (
    attention as tatt)
from keypoints_interpolation_transformer_torch.train import steps
from keypoints_interpolation_transformer_torch.utils.config import (
    Config, ModelConfig)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

B, T, H, DH = 3, 24, 4, 8
PREC = {"bf16x3": "high", "bf16": "default"}
# one mode down: what each mode's rounding must beat
WRONG = {"bf16x3": "bf16", "bf16": "f32"}
# each output against its own largest value: "high" the same exact bf16
# products summed in float32 in another order; "default" as "high", plus
# the values the sum order moves across a bf16 rounding boundary, each off
# by one bf16 step (2^-8) of its term
TOL = {"bf16x3": 2e-5, "bf16": 2e-3}
# the tokens a flipped forward probability may move (beyond TOL, within
# "default"'s)
FLIP_TOKENS = 0.1
# each mode's mean error at least this many times below the wrong mode's
MODE_SEPARATION = 4.0
# (mask kind, add_keypad): the encoder's keypad term, the Cycle model's
# "all" with its keypad, cross-attention's "all" alone; a padded key in the
# second video and every key of the third padded (its rows blocked) in all
CASES = [("repeat-inc", True), ("all", True), ("all", False)]


@contextlib.contextmanager
def _interpret(prec):
    """The Pallas kernels as the JAX kernel tests run them on the CPU,
    under the ambient precision ``prec``."""
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision(prec):
        yield


def _inputs(seed):
    """q, k, v, g (B, T, H, dh), a frame mask, valid with a padded key in
    video 1 and no real key in video 2."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, T, H, DH)).astype(np.float32)
                  for _ in range(4))
    mask = (rng.random((B, T)) < 0.3).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[1, 15:] = 0.0
    valid[2] = 0.0
    return q, k, v, g, mask, valid


def _close_mode(got, want, mode, what=""):
    """Each value within the mode's tolerance of the reference's largest,
    less the tokens a flipped probability moves at "high" (at most
    FLIP_TOKENS of them, within "default"'s tolerance)."""
    got, want = np.asarray(got), np.asarray(want)
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / s, want / s, atol=TOL["bf16"], rtol=0,
                               err_msg=what)
    err = np.abs(got - want).reshape(-1, got.shape[-1]) / s
    flipped = (err.max(-1) > TOL[mode]).mean()
    assert flipped <= (FLIP_TOKENS if mode == "bf16x3" else 0), (
        what, flipped, float(err.max()))


def _separated(got, want, wrong, what=""):
    own = np.abs(np.asarray(got) - np.asarray(want)).mean()
    off = np.abs(np.asarray(wrong) - np.asarray(want)).mean()
    assert own * MODE_SEPARATION < off, (what, own, off)


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("kind,keypad", CASES)
def test_plain_forward_matches_pallas_in_mode(mode, kind, keypad):
    q, k, v, _, mask, valid = _inputs(0)
    with _interpret(PREC[mode]):
        want = np.asarray(jattn._fused_fwd(
            *(jnp.asarray(a) for a in (q, k, v, mask, valid)), kind, keypad))
    args = [torch.from_numpy(a) for a in (q, k, v, mask, valid)]
    got = kernels.attention_plain(*args, kind, keypad, mode=mode).numpy()
    _close_mode(got, want, mode, "out")
    wrong = kernels.attention_plain(*args, kind, keypad,
                                    mode=WRONG[mode]).numpy()
    _separated(got, want, wrong, "out")
    # the blocked video's rows are finite; where every key weighs alike,
    # they average the values uniformly, as the JAX kernel's max-subtracted
    # softmax does
    assert np.isfinite(got[2]).all()
    if kind == "all" and not keypad:
        np.testing.assert_allclose(got[2], np.broadcast_to(
            got[2].mean(0, keepdims=True), got[2].shape), atol=1e-2)
    # the stats: the log2-domain (m, l) the output is the average by
    out, st = kernels.attention_plain(*args, kind, keypad, stats=True,
                                      mode=mode)
    assert torch.equal(out, torch.from_numpy(got))
    assert st.shape == (B, H, T, 2) and bool((st[..., 1] >= 1).all())


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("kind,keypad", CASES)
def test_plain_backward_matches_pallas_in_mode(mode, kind, keypad):
    """dq, dk, dv against ``_fused_bwd_pallas``: p split for dv at "high"
    (no probability rounded to one bf16), so every token holds the mode's
    tolerance; the wrong mode is further on average."""
    q, k, v, g, mask, valid = _inputs(1)
    with _interpret(PREC[mode]):
        want = [np.asarray(t) for t in jattn._fused_bwd_pallas(
            *(jnp.asarray(a) for a in (q, k, v, g, mask, valid)), kind,
            keypad)]
    args = [torch.from_numpy(a) for a in (q, k, v, g, mask, valid)]
    got = kernels.attention_bwd_plain(*args, kind, keypad, mode=mode)
    wrong = kernels.attention_bwd_plain(*args, kind, keypad,
                                        mode=WRONG[mode])
    for name, a, w, x in zip(("dq", "dk", "dv"), got, want, wrong):
        s = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(a.numpy() / s, w / s, atol=TOL[mode],
                                   rtol=0, err_msg=name)
        _separated(a.numpy(), w, x.numpy(), name)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_function_in_a_mode_saves_what_the_jax_vjp_saves(mode, plain):
    """``AttentionFunction`` in a mode: the forward is ``attention_plain``
    in the mode, the backward ``attention_bwd_plain`` in the mode from q,
    k, v and the masks alone (no out, no stats); bit for bit on the CPU,
    with and without ``plain``."""
    q, k, v, g, mask, valid = (torch.from_numpy(a) for a in _inputs(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = kernels.AttentionFunction.apply(*leaves, mask, valid, "repeat-inc",
                                          True, mode, plain)
    assert len(out.grad_fn.saved_tensors) == 5
    assert torch.equal(out.detach(), kernels.attention_plain(
        q, k, v, mask, valid, "repeat-inc", True, mode=mode))
    out.backward(g)
    want = kernels.attention_bwd_plain(q, k, v, g, mask, valid, "repeat-inc",
                                       True, mode=mode)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_mode_backward_takes_no_residuals():
    q, k, v, g, mask, valid = (torch.from_numpy(a) for a in _inputs(3))
    out, st = kernels.fused_attention(q, k, v, mask, valid, stats=True)
    for fn in (kernels.attention_bwd, kernels.attention_bwd_plain):
        with pytest.raises(ValueError, match="no out or stats"):
            fn(q, k, v, g, mask, valid, "repeat-inc", False, out, st,
               mode="bf16x3")
    with pytest.raises(ValueError, match="unknown precision mode"):
        kernels.fused_attention(q, k, v, mask, valid, mode="tf32")


def test_mode_rows_in_the_table():
    """Four rows name the per-op pair's mode kernels beside their "f32"
    rows, each naming the JAX body it replaces; the table counts per mode,
    and the plain versions count nothing."""
    table = {k.name: k for k in kernels.KERNELS}
    src = (_build.CSRC.parents[1] / "keypoints_interpolation_transformer_tpu"
           / "ops/pallas/attention.py").read_text().splitlines()
    for base, wrapper, line, body in (
            ("attention", kernels.fused_attention, 317, "_attn_kernel"),
            ("attention_bwd", kernels.attention_bwd, 409,
             "_attn_bwd_kernel")):
        assert src[line - 1].startswith(f"def {body}(")
        for tag, mode, cu in (("", "f32", "attention.cu"),
                              ("_high", "bf16x3", "attention_modes.cu"),
                              ("_default", "bf16", "attention_modes.cu")):
            k = table[base + tag]
            assert (k.wrapper, k.mode) == (wrapper, mode)
            assert k.replaces.endswith(f"ops/pallas/attention.py:{line}")
            assert k.source.endswith(f"csrc/{cu}")
    kernels.reset_launches()
    kernels.fused_attention.launches["bf16x3"] += 18
    kernels.attention_bwd.launches["bf16"] += 2
    counts = kernels.launch_counts()
    assert counts["attention_high"] == 18 and counts["attention"] == 0
    assert counts["attention_bwd_default"] == 2
    kernels.reset_launches()
    q, k, v, g, mask, valid = (torch.from_numpy(a) for a in _inputs(4))
    kernels.fused_attention(q, k, v, mask, valid, mode="bf16x3")
    kernels.attention_bwd(q, k, v, g, mask, valid, mode="bf16")
    assert set(kernels.launch_counts().values()) == {0}


def _c_params(entry):
    """The C parameter list of ``entry`` in ``csrc/attention_modes.cu``:
    one letter each, as ``_MODE_SIGS`` writes them (p pointer, i int)."""
    src = (_build.CSRC / "attention_modes.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    return "".join("i" if p.strip().startswith("int ") else "p"
                   for p in m.group(1).split(","))


@pytest.mark.parametrize("entry", ["kit_attention_tc",
                                   "kit_attention_tc_bwd"])
def test_signatures_match_the_c_entries(entry):
    assert tatt._MODE_SIGS[entry] == _c_params(entry)
    assert "attention_modes" in _build.SOURCES


def test_q_scale_is_the_jax_kernels():
    """The forward folds 1 / sqrt(dh) * log2(e) into q, rounded to float32
    from the double product, as ``_fused_fwd`` passes ``scale`` and the
    kernel multiplies by ``scale * LOG2E``: the port's ``mode_q_scale`` has
    that float32 value at every head width it takes, and the C side
    computes the same double product."""
    for dh in range(1, 513):
        want = np.float32((1.0 / np.sqrt(dh)) * jattn.LOG2E)
        assert np.float32(tatt.mode_q_scale(dh)) == want
    src = (_build.CSRC / "attention_modes.cu").read_text()
    assert "(1.0 / sqrt((double)dh)) * 1.4426950408889634" in src


# ---------------------------------------------------------------------------
# the per-op model at "high": serving forward and the A1 step
# ---------------------------------------------------------------------------

D_, FF_, LAYERS, HEADS = 32, 64, 1, 4


def test_per_op_model_at_high_matches_jax():
    """The model with sublayer fusion off at "high" (its per-op attention
    cores and FF sublayers bf16x3) against the JAX KeypointCompleter with
    ``attention_impl="pallas"``, ``attn_sublayer_fusion`` off and its FF
    on Pallas, in interpret mode under ambient "high", its ``nn.Dense``
    layers (q / k / v, out-projections, the XLA chains at D = 32) rounded
    as the TPU rounds them there (``jax_dense_modes``), as the port's
    ``mode_linear`` rounds them.  A flipped encoder
    probability reaches every decoder frame of its video through the
    cross-attention (here 2 of 27 frames beyond TOL, 2.3e-4 at most, the
    mean 4e-6), so frames are held as ``_close_mode`` holds tokens, and
    the mean error is MODE_SEPARATION times below the float32 port's (1.4e-4
    here)."""
    rng = np.random.default_rng(5)
    Bm, Tm = 2, 16
    x, f = (rng.uniform(0.2, 0.8, (Bm, Tm, 54, 2)).astype(np.float32)
            for _ in range(2))
    sm, tm = ((rng.random((Bm, Tm)) < 0.3).astype(np.float32)
              for _ in range(2))
    valid = np.ones((Bm, Tm), np.float32)
    valid[1, 11:] = 0.0
    dims = dict(hidden_dim=D_, num_layers=LAYERS, num_heads=HEADS,
                ff_dim=FF_)
    params = jax.jit(jc.KeypointCompleter(attention_impl="xla",
                                          ff_impl="xla", **dims).init)(
        jax.random.key(2), jnp.asarray(x[:1]), jnp.asarray(f[:1]))
    jm = jc.KeypointCompleter(attention_impl="pallas", ff_impl="pallas",
                              pointwise_impl="pallas",
                              attn_sublayer_fusion=False, **dims)
    run = jax.jit(lambda p, x, f: jm.apply(
        p, x, f, src_frame_mask=jnp.asarray(sm),
        tgt_frame_mask=jnp.asarray(tm), valid_mask=jnp.asarray(valid)))
    with _interpret("high"), dense_in_mode("bf16x3"):
        want = np.asarray(run(params, jnp.asarray(x), jnp.asarray(f)))
    real = valid > 0
    outs = {}
    for prec in ("high", "highest"):
        model = KeypointCompleter(D_, LAYERS, HEADS, ff_dim=FF_,
                                  precision=prec, attn_sublayer_fusion=False)
        model.load_state_dict(state_dict_tensors(params_from_jax(params)))
        with torch.no_grad():
            outs[prec] = model.eval()(*(torch.from_numpy(a) for a in
                                        (x, f, sm, tm, valid))).numpy()
    _close_mode(outs["high"][real].reshape(-1, 108),
                want[real].reshape(-1, 108), "bf16x3", "frames")
    mean = {k: np.abs(v[real] - want[real]).mean() for k, v in outs.items()}
    assert mean["high"] * MODE_SEPARATION < mean["highest"], mean


def test_per_op_a1_step_at_high_matches_jax():
    """One A1 step with sublayer fusion off at "high" against
    ``jax.value_and_grad`` of the JAX A1 loss with ``attention_impl`` and
    ``ff_impl`` "pallas" and fusion off, under ambient "high" in interpret
    mode, its ``nn.Dense`` products and their backward in the mode
    (``jax_dense_modes``; the port's ``mode_linear``): its attention
    backward is ``_attn_bwd_kernel`` in the mode, as the port's; on the CPU the JAX package differentiates its FF kernel
    through its float32 XLA reference (its native backward needs the TPU)
    while the port's runs bf16x3, so the gradients agree to that distance,
    about 2^-16 of the largest gradient, given a factor of 10 (as
    ``tests/test_torch_precision_model.py`` holds the fused route)."""
    Bq, Tq = 3, 16
    mc = jconfig.ModelConfig(hidden_dim=D_, num_heads=HEADS,
                             num_layers=LAYERS, ff_dim=FF_, ff_impl="pallas",
                             attention_impl="pallas",
                             attn_sublayer_fusion="off",
                             matmul_precision="high")
    model_j = jsteps.build_model(mc, "plain", for_training=True)
    rng = np.random.default_rng(6)
    clean = jnp.asarray(rng.uniform(0.2, 0.8, (Bq, Tq, 54, 2)).astype(
        np.float32))
    length = jnp.asarray([Tq, 12, 9], jnp.int32)
    weight = jnp.asarray([1.0, 0.5, 1.0], jnp.float32)
    params = jax.jit(jc.KeypointCompleter(
        hidden_dim=D_, num_layers=LAYERS, num_heads=HEADS, ff_dim=FF_,
        attention_impl="xla", ff_impl="xla").init)(
            jax.random.key(0), clean, clean)["params"]
    criterion = jsteps.make_train_criterion("a1", False)

    def loss_fn(p, y, inputs, mask):
        x, x_no, x_mask, y_mask, valid = jsteps.shift_streams(inputs, mask,
                                                              length)
        pred = jsteps.completer_forward(model_j, p, x, x_no, x_mask, y_mask,
                                        valid)
        return jsteps._weighted_mean(criterion(pred, y, valid), weight)

    with _interpret("high"), dense_in_mode("bf16x3"):
        batch = jax.jit(lambda key: jsteps.corrupt_batch(
            key, clean, length, augment=True, aug_prob=0.5,
            is_random_missing=False, dataset_name="all", stats=None))(
                jax.random.key(12))
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params,
                                                              *batch)
    cfg = Config(model=ModelConfig(hidden_dim=D_, num_heads=HEADS,
                                   num_layers=LAYERS, ff_dim=FF_,
                                   attn_sublayer_fusion="off",
                                   matmul_precision="high"))
    model = steps.build_model(cfg.model, for_training=True, device="cpu")
    assert not model.attn_sublayer_fusion and model.mode == "bf16x3"
    model.load_state_dict(state_dict_tensors(params_from_jax(params)))
    y, inputs, mask = (torch.from_numpy(np.array(a)) for a in batch)
    crit = steps.make_train_criterion("a1", False)
    loss, _ = steps.a1_loss(model, y, inputs, mask,
                            torch.from_numpy(np.array(length)),
                            torch.from_numpy(np.array(weight)), crit)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-5)
    loss.backward()
    want = params_from_jax(grads_j)
    gscale = max(float(np.abs(w).max()) for w in want.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy() / gscale,
                                   want[name] / gscale, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("prec,mode", [("high", "bf16x3"),
                                       ("default", "bf16"),
                                       ("highest", "f32")])
def test_per_op_route_takes_the_mode(monkeypatch, prec, mode):
    """Serving, the int8 route and training with fusion off hand the
    model's mode to every per-op core: ``fused_attention`` 3 per layer
    pair serving (int8 too), ``AttentionFunction`` 3 in training, each
    with the mode."""
    seen = []
    real_fwd, real_fn = layers.fused_attention, layers.AttentionFunction

    def fwd(*a, mode="f32", **k):
        seen.append(("serve", mode))
        return real_fwd(*a, mode=mode, **k)

    class Fn:
        @staticmethod
        def apply(*a):
            seen.append(("train", a[7]))
            return real_fn.apply(*a)

    monkeypatch.setattr(layers, "fused_attention", fwd)
    monkeypatch.setattr(layers, "AttentionFunction", Fn)
    model = KeypointCompleter(32, 1, 4, ff_dim=64, precision=prec,
                              attn_sublayer_fusion=False,
                              generator=torch.Generator().manual_seed(0))
    x = torch.rand(2, 16, 54, 2)
    m = (torch.rand(2, 16) < 0.3).float()
    with torch.no_grad():
        model.eval()(x, x, m, m)
        model.pack_weights("int8")
        model(x, x, m, m)
    model.pack_weights(None)
    model.train()(x, x, m, m).sum().backward()
    assert seen == [("serve", mode)] * 6 + [("train", mode)] * 3


def test_plain_backward_on_the_standing_draw_matches_pallas():
    """The standing draw of ``chip_smoke.py`` phase 2 (``flip_draw_calls``,
    its operands drawn on the CPU from ``FLIP_DRAW`` as on the card): the
    plain backward at "default" against ``_fused_bwd_pallas`` in interpret
    mode at the per-op mode tests' tolerance, each output against max(1,
    its largest value); and in both ``FLIP_ROWS`` the dl at ``FLIP_DL``
    lies so near a bf16 rounding midpoint that two float32 orders of the
    same arithmetic round it apart."""
    import chip_smoke
    chk, rows = chip_smoke.flip_draw_calls(torch, kernels, dev="cpu")
    for row in chip_smoke.FLIP_ROWS:
        assert row in [r[:2] for r in rows]
        args = chk.layer_args[" ".join(row)]
        q, k, v, g, mask, valid, kind, keypad = args
        assert q.shape == (3, 512, 8, 32) and kind == "all", row
        # cross-attention has no frame mask: "all" without the keypad
        # term reads none
        jmask = torch.zeros_like(valid) if mask is None else mask
        with _interpret("default"):
            want = [np.asarray(t) for t in jattn._fused_bwd_pallas(
                *(jnp.asarray(a.numpy()) for a in (q, k, v, g, jmask, valid)),
                kind, keypad)]
        got = kernels.attention_bwd_plain(*args, mode="bf16")
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            s = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(a.numpy() / s, w / s,
                                       atol=TOL["bf16"], rtol=0,
                                       err_msg=f"{row} {name}")
        orders = chip_smoke.flip_dl_orders(torch, kernels, args)
        x0, x1 = orders["torch's order"], orders["one term at a time"]
        assert x0["bf16"] != x1["bf16"], (row, orders)
        assert abs(x0["dl"] - x1["dl"]) <= \
            4 * np.spacing(np.float32(x0["dl"])), (row, orders)

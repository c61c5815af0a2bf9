"""The precision mode "high" through the model, the train step, the loop,
the CLI and the Inpainter, against the JAX package on the CPU: the model
forward at "high" against the JAX model whose FF and attention sublayers
run Pallas (in interpret mode under ambient "high"), one A1 step's loss and
gradients, and the entry points that take the precision (``cli train`` /
``serve --precision``, ``Inpainter``, every variant's ``build_model``).
The FF sublayer's arithmetic itself is held in ``test_torch_precision.py``,
the attention sublayer's in ``test_torch_sublayer_modes.py``."""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from jax_dense_modes import dense_in_mode
from keypoints_interpolation_transformer_tpu.eval import serving as jserving
from keypoints_interpolation_transformer_tpu.models import completer as jc
from keypoints_interpolation_transformer_tpu.train import steps as jsteps
from keypoints_interpolation_transformer_tpu.utils import config as jconfig
from keypoints_interpolation_transformer_torch import cli
from keypoints_interpolation_transformer_torch.models.completer import (
    Embedding, KeypointCompleter, keypoint_completer_cycle)
from keypoints_interpolation_transformer_torch.models.convert import (
    params_from_jax, state_dict_tensors)
from keypoints_interpolation_transformer_torch.train import steps
from keypoints_interpolation_transformer_torch.utils.config import (
    Config, ModelConfig)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

D_, FF_ = 32, 64
# the FF sublayer at "high" against JAX's (test_torch_precision.py): the
# same exact bf16 products summed in float32 in another order
HIGH_TOL = 2e-5
# "default" against "highest" through a whole model: the bf16 error itself
DEFAULT_TOL = 2e-3
# The attention at "high" rounds each probability to ONE bf16 (the JAX
# ``_prob_parts``), so a probability near a rounding boundary flips between
# any two float32 orders.  One sublayer holds HIGH_TOL on all but the few
# tokens a flip moves (test_torch_sublayer_modes.py); through a model,
# attention spreads each flipped token to every later query, and with
# three attentions a token per layer the flips no longer stay few: at
# 2 + 2 layers the JAX model itself moves its output by some 4e-4 when its
# inputs move by one ulp (at "highest" by 1e-6).  Two float32 orders of the
# same mode arithmetic then lie within that drift of each other, not within
# float32 noise: the model at "high" is held within MODE_DRIFT times the
# JAX model's own one-ulp drift (chip_smoke.py's bound for the merged route
# at "default"), and its mean error at least MODE_SEPARATION times below
# the float32 port's.
MODE_DRIFT = 2.0
MODE_SEPARATION = 4.0
# "high" served against "highest" (masked MPJPE): bench.py's gate, which
# chip_smoke.py's phase 11 holds on the card
MPJPE_TOL = 1e-4


@contextlib.contextmanager
def _interpret(prec):
    """The Pallas kernels as the JAX kernel tests run them on the CPU,
    under the ambient precision ``prec``."""
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision(prec):
        yield


# ---------------------------------------------------------------------------
# the model and the A1 step
# ---------------------------------------------------------------------------

B, T, LAYERS, HEADS = 3, 24, 2, 4


def _inputs(rng):
    x = rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(np.float32)
    f = rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(np.float32)
    sm = (rng.random((B, T)) < 0.3).astype(np.float32)
    tm = (rng.random((B, T)) < 0.3).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[1, 17:] = 0.0  # a padded row
    return x, f, sm, tm, valid


@pytest.mark.parametrize("cycle", [False, True])
def test_model_forward_at_high_matches_jax(rng, cycle):
    """The model at "high" per sublayer (its FF and attention sublayers
    bf16x3) against the JAX KeypointCompleter whose FF and attention
    sublayers run Pallas (``ff_impl="pallas"``, ``attention_impl="pallas"``
    with sublayer fusion, ``pointwise_impl="pallas"`` as on its TPU, no
    merged layers) in interpret mode under ambient "high": at D = 32 the
    pointwise kernels take neither width, so both packages run their plain
    (XLA) chains, in the mode (the JAX ``nn.Dense`` rounded as the TPU
    rounds it there, ``jax_dense_modes``; the port's ``mode_linear``), and
    split the work the same way.
    Within MODE_DRIFT times the JAX model's own drift on inputs one ulp
    away; a float32 port model is further away, MODE_SEPARATION times on
    average: the mode's rounding is what closes the gap."""
    x, f, sm, tm, valid = _inputs(rng)
    dims = dict(hidden_dim=D_, num_layers=LAYERS, num_heads=HEADS,
                ff_dim=FF_)
    jmake = jc.keypoint_completer_cycle if cycle else jc.KeypointCompleter
    jm = jmake(attention_impl="pallas", ff_impl="pallas",
               pointwise_impl="pallas", attn_sublayer_fusion=True,
               merge_layers=False, **dims)
    # the same parameter tree, initialized on XLA: the Pallas kernels in
    # interpret mode take seconds a call
    params = jax.jit(jmake(attention_impl="xla", ff_impl="xla",
                           **dims).init)(
        jax.random.key(1), jnp.asarray(x[:1]), jnp.asarray(f[:1]))
    run = jax.jit(lambda p, x, f: jm.apply(
        p, x, f, src_frame_mask=jnp.asarray(sm),
        tgt_frame_mask=jnp.asarray(tm), valid_mask=jnp.asarray(valid),
        src_mask_kind="repeat-inc", tgt_mask_kind="repeat-inc"))
    up = np.float32(2)
    with _interpret("high"), dense_in_mode("bf16x3"):
        want = np.asarray(run(params, jnp.asarray(x), jnp.asarray(f)))
        moved = np.asarray(run(params, jnp.asarray(np.nextafter(x, up)),
                               jnp.asarray(np.nextafter(f, up))))
    make = keypoint_completer_cycle if cycle else KeypointCompleter
    real = valid > 0
    outs = {}
    for prec in ("high", "highest"):
        model = make(D_, LAYERS, HEADS, ff_dim=FF_, precision=prec,
                     merge_layers=False)
        model.load_state_dict(state_dict_tensors(params_from_jax(params)))
        with torch.no_grad():
            outs[prec] = model.eval()(*(torch.from_numpy(a) for a in
                                        (x, f, sm, tm, valid))).numpy()
    assert model.mode == "f32"
    drift = np.abs(moved[real] - want[real]).max()
    np.testing.assert_allclose(outs["high"][real], want[real],
                               atol=MODE_DRIFT * drift)
    err = {k: np.abs(v[real] - want[real]).max() for k, v in outs.items()}
    assert err["high"] < err["highest"], err
    mean = {k: np.abs(v[real] - want[real]).mean() for k, v in outs.items()}
    assert mean["high"] * MODE_SEPARATION < mean["highest"], mean


def test_a1_step_at_high_matches_jax():
    """One A1 step at "high" against ``jax.value_and_grad`` of the JAX A1
    loss with its FF and attention sublayers on Pallas (``ff_impl`` and
    ``attention_impl`` "pallas", ``attn_sublayer_fusion`` "on", as its
    training route resolves them at a fast precision on the TPU) under
    ambient "high" in interpret mode, on the same corrupted batch.  The
    loss takes a bf16x3 forward on both sides (within float32 noise; the
    JAX sublayer runs its serving form there, q's scale folded before the
    split, the port its training form); on the CPU the JAX package
    differentiates its FF and sublayer kernels through their float32 XLA
    references (their native backwards need the TPU), while the port's
    backwards run bf16x3, so the gradients agree to the bf16x3-against-
    float32 distance, about 2^-16 of the largest gradient, given a factor
    of 10.  The pre-stream and post-head chains, which its training route
    leaves to XLA (``nn.Dense`` in the ambient precision), run in the mode
    on both sides: the JAX Dense layers rounded as the TPU rounds them
    (``jax_dense_modes``), the port's through ``mode_linear``."""
    Bq, Tq = 4, 16
    mc = jconfig.ModelConfig(hidden_dim=D_, num_heads=HEADS,
                             num_layers=LAYERS, ff_dim=FF_, ff_impl="pallas",
                             attention_impl="pallas",
                             attn_sublayer_fusion="on",
                             matmul_precision="high")
    model_j = jsteps.build_model(mc, "plain", for_training=True)
    rng = np.random.default_rng(0)
    clean = jnp.asarray(rng.uniform(0.2, 0.8, (Bq, Tq, 54, 2)).astype(
        np.float32))
    length = jnp.asarray([Tq, 12, 9, Tq], jnp.int32)
    weight = jnp.asarray([1.0, 1.0, 0.5, 1.0], jnp.float32)
    # the same parameter tree, initialized on XLA (see above)
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
                jax.random.key(11))
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params,
                                                              *batch)
    cfg = Config(model=ModelConfig(hidden_dim=D_, num_heads=HEADS,
                                   num_layers=LAYERS, ff_dim=FF_,
                                   matmul_precision="high"))
    model = steps.build_model(cfg.model, for_training=True, device="cpu")
    assert model.precision == "high"
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


def test_precision_reaches_every_model_and_the_cli(tmp_path):
    """``matmul_precision`` becomes each built model's ``precision``
    (plain, Cycle, the Embedding, which keeps it and has no FF), and the
    CLI takes the three names for ``train`` and ``serve``."""
    for prec in ("highest", "high", "default", "bfloat16_3x"):
        mc = ModelConfig(hidden_dim=32, num_heads=4, num_layers=1,
                         ff_dim=64, matmul_precision=prec)
        for variant in ("plain", "cycle", "embedding"):
            m = steps.build_model(mc, variant, device="cpu")
            assert m.precision == prec
    assert Embedding(32, precision="default").precision == "default"
    p = cli.build_parser()
    for cmd in (["train"], ["serve", "--checkpoint", "x.pth"]):
        for prec in ("highest", "high", "default"):
            assert p.parse_args(cmd + ["--precision", prec]).precision == \
                prec
        with pytest.raises(SystemExit):
            p.parse_args(cmd + ["--precision", "float32"])


def test_loop_cli_and_inpainter_take_the_modes(tmp_path, monkeypatch):
    """``cli train --precision high`` runs the loop on the CPU with its
    model at "high" (steps and eval forwards); ``Inpainter`` and ``cli
    serve`` take the precision (``from_checkpoint(precision=...)``), and a
    per-sublayer Inpainter serves its non-missing frames untouched, at
    "high" within HIGH_TOL of the JAX Inpainter at "high" on its Pallas
    kernels (interpret mode; its attention rounds p to one bf16 as the
    port's does; its XLA chains at D = 32 in the mode, ``jax_dense_modes``,
    as the port's), nearer it than the port at "highest" is, and within
    bench.py's masked-MPJPE gate of "highest", at "default" within the
    mode's distance of "highest"."""
    import json
    import contextlib
    import io

    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    from keypoints_interpolation_transformer_torch.models.convert import (
        save_reference_pth)
    from keypoints_interpolation_transformer_torch.train import loop

    monkeypatch.chdir(tmp_path)
    built = []
    real_build = loop.build_model

    def spy(*a, **k):
        built.append(real_build(*a, **k))
        return built[-1]

    monkeypatch.setattr(loop, "build_model", spy)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["train", "--device", "cpu", "--regime", "a1",
                         "--synthetic", "12", "--epochs", "1",
                         "--hidden_dim", "32", "--num_heads", "4",
                         "--num_layers", "1", "--synthetic_max_len", "40",
                         "--max_seq_len", "48", "--precision", "high"]) == 0
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert res["epochs_run"] == 1 and built[0].mode == "bf16x3"

    model = KeypointCompleter(32, 1, 4, ff_dim=64,
                              generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "m.pth")
    save_reference_pth(path, model, {"hidden_dim": 32, "num_layers": 1,
                                     "num_heads": 4})
    rng = np.random.default_rng(4)
    videos = [rng.uniform(0.2, 0.8, (t, 54, 2)).astype(np.float32)
              for t in (20, 29)]
    masks = [(rng.random(len(v)) < 0.3).astype(np.float32) for v in videos]
    outs = {}
    for prec in ("highest", "high", "default"):
        inp = Inpainter.from_checkpoint(path, device="cpu", precision=prec,
                                        bucket_multiple=16,
                                        merge_layers=False)
        assert inp.model.precision == prec
        outs[prec] = inp.inpaint(videos, masks)
        for v, m, o in zip(videos, masks, outs[prec]):
            np.testing.assert_array_equal(o[m == 0], v[m == 0])
    mc = jconfig.ModelConfig(hidden_dim=32, num_layers=1, num_heads=4,
                             ff_dim=64, attention_impl="pallas",
                             ff_impl="pallas", attn_sublayer_fusion="on",
                             pointwise_impl="pallas", matmul_precision="high")
    with _interpret("high"), dense_in_mode("bf16x3"):
        want = jserving.Inpainter.from_checkpoint(
            path, mc, bucket_multiple=16).inpaint(videos, masks)
    for a, b in zip(outs["high"], want):
        np.testing.assert_allclose(a, b, atol=HIGH_TOL, rtol=0)
    err = {k: max(float(np.abs(a - b).max()) for a, b in zip(outs[k], want))
           for k in ("high", "highest")}
    assert err["high"] < err["highest"], err
    for a, b, m in zip(outs["high"], outs["highest"], masks):
        mpjpe = np.linalg.norm(a - b, axis=-1)[m > 0].mean()
        assert mpjpe < MPJPE_TOL, mpjpe
    for a, b in zip(outs["default"], outs["highest"]):
        np.testing.assert_allclose(a, b, atol=20 * DEFAULT_TOL, rtol=0)
    args = cli.build_parser().parse_args(
        ["serve", "--checkpoint", path, "--precision", "default"])
    assert args.precision == "default"

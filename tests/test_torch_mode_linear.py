"""The products the JAX package leaves to XLA, in the precision modes "high"
(bf16x3) and "default" (one bf16 pass): the port's ``mode_linear`` (plain
version, autograd Function, the model's routes through it) against the
JAX ``nn.Dense`` rounded as the TPU rounds it under the ambient precision
(``jax_dense_modes.dense_in_mode``; XLA on the CPU ignores the ambient
precision, so the interceptor makes the TPU's rounding explicit).  The
CUDA kernels themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_gpu.py``).

Both sides round the same operands to bf16 (nearest even) and sum exact
bf16 products in float32, in another order: each value agrees within a
few float32 ulps of the largest it is summed with (``TOL`` of the output's
largest value), and the wrong mode is further on average."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from jax_dense_modes import PRECISION, dense_in_mode
from keypoints_interpolation_transformer_tpu.models import completer as jc
from keypoints_interpolation_transformer_tpu.models import layers as jlayers
from keypoints_interpolation_transformer_torch.models import layers
from keypoints_interpolation_transformer_torch.models.completer import (
    Embedding, KeypointCompleter)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import _build
from keypoints_interpolation_transformer_torch.ops.kernels import (
    linear as tlin)
from keypoints_interpolation_transformer_torch.ops.kernels.pointwise import (
    post_head_plain, pre_stream_embed_plain)
from keypoints_interpolation_transformer_torch.train import state, steps
from keypoints_interpolation_transformer_torch.utils.config import (
    Config, ModelConfig)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

MODES = ("bf16x3", "bf16")
# one mode down: what each mode's rounding must beat
WRONG = {"bf16x3": "bf16", "bf16": "f32"}
# each value against the largest of its output: the same exact bf16
# products summed in float32 in another order (a few ulps of sums of up to
# a few hundred terms), through one Dense layer
TOL = 2e-6
# through a chain of Dense layers, LayerNorms and gates (up to five
# products deep, forward and back): the same order differences compounded,
# and a value the two orders put on either side of a bf16 rounding
# boundary moves its product by one bf16 step of its lo part at "high"
# (2^-16) or of the term at "default" (2^-8, rare: the mean decides there)
CHAIN_TOL = {"bf16x3": 2e-5, "bf16": 4e-3}
CHAIN_MEAN_TOL = {"bf16x3": 2e-6, "bf16": 2e-5}
# each mode's mean error at least this many times below the wrong mode's
MODE_SEPARATION = 4.0


def _scaled_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    s = max(1.0, float(np.abs(want).max()))
    return np.abs(got - want) / s


def _close(got, want, tol, what="", mean_tol=None):
    err = _scaled_err(got, want)
    assert float(err.max()) <= tol, (what, float(err.max()))
    if mean_tol is not None:
        assert float(err.mean()) <= mean_tol, (what, float(err.mean()))


def _separated(got, want, wrong, what=""):
    own = np.abs(np.asarray(got) - np.asarray(want)).mean()
    off = np.abs(np.asarray(wrong) - np.asarray(want)).mean()
    assert own * MODE_SEPARATION < off, (what, own, off)


# ---------------------------------------------------------------------------
# one Dense layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,K,N", [("bf16x3", 108, 32), ("bf16x3", 32, 108),
                                      ("bf16", 108, 32), ("bf16", 32, 96)])
def test_plain_matches_jax_dense(mode, K, N):
    """``mode_linear_plain`` forward and its gradients (dx, dW, db) under
    autograd against ``jax.vjp`` of an ``nn.Dense`` in the mode, on the
    108-wide frames and the head back to them."""
    rng = np.random.default_rng(K + N)
    x = rng.normal(size=(3, 7, K)).astype(np.float32)
    g = rng.normal(size=(3, 7, N)).astype(np.float32)
    dense = nn.Dense(N)
    params = dense.init(jax.random.key(0), jnp.asarray(x))
    with dense_in_mode(mode):
        want, vjp = jax.vjp(dense.apply, params, jnp.asarray(x))
        gp, gx = vjp(jnp.asarray(g))
    w = np.array(params["params"]["kernel"])
    b = np.asarray(params["params"]["bias"]) + 0.1
    want = np.asarray(want) + 0.1  # the JAX bias is zero at init
    outs = {}
    for m in (mode, WRONG[mode]):
        xt, wt, bt = (torch.tensor(a, requires_grad=True)
                      for a in (x, w, b))
        y = kernels.mode_linear_plain(xt, wt, bt, m)
        y.backward(torch.from_numpy(g))
        outs[m] = (y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy(),
                   bt.grad.numpy())
    refs = (want, np.asarray(gx), np.asarray(gp["params"]["kernel"]),
            np.asarray(gp["params"]["bias"]))
    for name, got, ref, wrong in zip(("y", "dx", "dW", "db"), outs[mode],
                                     refs, outs[WRONG[mode]]):
        _close(got, ref, TOL if name != "db" else 1e-6, name)
        if name != "db":  # the bias gradient is float32 in every mode
            _separated(got, ref, wrong, name)
    # the gradient wrapper's plain version computes the same
    dx, dw, db = kernels.mode_linear_bwd(torch.from_numpy(g),
                                         torch.from_numpy(x),
                                         torch.from_numpy(w), mode)
    for got, ref in zip((dx, dw, db), outs[mode][1:]):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_function_on_the_cpu_is_the_plain_version(mode):
    """``ModeLinearFunction`` on CPU tensors: its forward is
    ``mode_linear_plain``'s bit for bit, its backward ``mode_linear_bwd``'s
    plain version (db a float32 sum, in another order than autograd's);
    with no gradient of x wanted it returns none."""
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(5, 6, 108, generator=g), torch.randn(108, 64,
                                                            generator=g)
    b, gy = torch.randn(64, generator=g), torch.randn(5, 6, 64, generator=g)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = kernels.ModeLinearFunction.apply(*leaves, mode)
    assert torch.equal(y.detach(), kernels.mode_linear_plain(x, w, b, mode))
    y.backward(gy)
    want = kernels.mode_linear_bwd_plain(gy, x, w, mode)
    for leaf, ref in zip(leaves, want):
        assert torch.equal(leaf.grad, ref)
    wl = w.clone().requires_grad_(True)
    kernels.ModeLinearFunction.apply(x, wl, None, mode).backward(gy)
    assert torch.equal(wl.grad, want[1])


def test_highest_is_f_linear_bit_for_bit():
    """At "highest" nothing moves: ``mode_linear`` is ``x @ w + b``, the
    per-op projections and out-projection are ``F.linear``, the Embedding is
    its two Linears and the model's forward and gradients are what those
    library calls give, bit for bit; no launch is counted."""
    g = torch.Generator().manual_seed(4)
    x, w, b = (torch.randn(4, 9, 32, generator=g),
               torch.randn(32, 48, generator=g), torch.randn(48, generator=g))
    kernels.reset_launches()
    assert torch.equal(kernels.mode_linear(x, w, b, "f32"), x @ w + b)
    model = KeypointCompleter(32, 1, 4, ff_dim=64,
                              attn_sublayer_fusion=False, generator=g)
    mha = model.transformer.encoder.layers[0].self_attn
    q, k, v = mha.project(x, x, mode="f32", train=True)
    wq, wk, wv = mha.in_proj_weight.chunk(3)
    bq, bk, bv = mha.in_proj_bias.chunk(3)
    for got, wt, bt in ((q, wq, bq), (k, wk, bk), (v, wv, bv)):
        assert torch.equal(got, F.linear(x, wt, bt).reshape(4, 9, 4, 8))
    emb = Embedding(32, generator=g)
    f = torch.rand(2, 8, 54, 2, generator=g)
    assert torch.equal(emb(f), emb.output_embedding(emb.input_embedding(
        f.reshape(2, 8, -1))).reshape(2, 8, 54, 2))
    # no product of the model, forward or backward, leaves F.linear /
    # x @ w + b there: nothing reaches mode_linear or its plain version
    def never(*a, **k):
        raise AssertionError("a product left the library call at highest")
    m = (torch.rand(2, 8, generator=g) < 0.3).float()
    with pytest.MonkeyPatch.context() as mp:
        for mod in (layers, kernels):
            mp.setattr(mod, "mode_linear", never)
            mp.setattr(mod, "mode_linear_plain", never)
        model.train()(f, f, m, m).square().sum().backward()
        with torch.no_grad():
            model.eval()(f, f, m, m)
        Embedding(32, generator=g).train()(f).sum().backward()
    assert set(kernels.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the training chains and the Embedding against the JAX Dense layers
# ---------------------------------------------------------------------------

class _Chains(nn.Module):
    """The JAX KeypointCompleter's XLA chains (``completer.py``'s
    ``else`` branches, as its training route runs them): the pre-stream
    chain with its embedding, and the post head."""
    D: int

    @nn.compact
    def __call__(self, x, pe, dec):
        e = nn.Dense(self.D, name="input_embedding")(x)
        s = jlayers.SwiGLU(self.D, name="swiglu_input_prev")(
            jlayers.token_norm(e) + pe)
        d = jlayers.SwiGLU(self.D, name="swiglu_decoded")(dec)
        z = jlayers.token_norm(d + e)
        z = z * jax.nn.sigmoid(z)
        return s, nn.Dense(108, name="fc_final")(z)


def _swiglu_weights(p):
    w12 = np.concatenate([p["fc1"]["kernel"], p["fc2"]["kernel"]], 1)
    b12 = np.concatenate([p["fc1"]["bias"], p["fc2"]["bias"]])
    return w12, b12, p["fc3"]["kernel"], p["fc3"]["bias"]


@pytest.mark.parametrize("mode", MODES)
def test_training_chains_match_jax(mode):
    """The plain chains under autograd with every product through
    ``mode_linear`` (the model's training route) against ``jax.vjp`` of the
    JAX XLA chains in the mode: both outputs and every parameter's
    gradient; one mode down is further on average."""
    D, B, T = 32, 3, 8
    rng = np.random.default_rng(7)
    x = rng.uniform(0.2, 0.8, (B, T, 108)).astype(np.float32)
    dec = rng.normal(size=(B, T, D)).astype(np.float32)
    pe = rng.normal(size=(T, D)).astype(np.float32)
    gs, go = (rng.normal(size=(B, T, n)).astype(np.float32) for n in (D, 108))
    chains = _Chains(D)
    params = chains.init(jax.random.key(1), *map(jnp.asarray, (x, pe, dec)))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.asarray(rng.normal(size=a.shape),
                                         jnp.float32), params)
    with dense_in_mode(mode):
        (js, jo), vjp = jax.vjp(
            lambda p: chains.apply(p, *map(jnp.asarray, (x, pe, dec))),
            params)
        (jg,) = vjp((jnp.asarray(gs), jnp.asarray(go)))
    p, jg = params["params"], jg["params"]

    def port(m):
        leaves = {
            "emb": [torch.tensor(np.asarray(a), requires_grad=True) for a in
                    (p["input_embedding"]["kernel"],
                     p["input_embedding"]["bias"])],
            "sw_in": [torch.tensor(np.asarray(a), requires_grad=True)
                      for a in _swiglu_weights(p["swiglu_input_prev"])],
            "sw_dec": [torch.tensor(np.asarray(a), requires_grad=True)
                       for a in _swiglu_weights(p["swiglu_decoded"])],
            "head": [torch.tensor(np.asarray(a), requires_grad=True) for a in
                     (p["fc_final"]["kernel"], p["fc_final"]["bias"])]}
        kw = {"mode": m, "linear": layers.dense_in_mode(m, False)} \
            if m != "f32" else {}
        s, e = pre_stream_embed_plain(torch.from_numpy(x), *leaves["emb"],
                                      torch.from_numpy(pe), *leaves["sw_in"],
                                      False, True, **kw)
        o = post_head_plain(torch.from_numpy(dec), e, *leaves["sw_dec"],
                            *leaves["head"], **kw)
        torch.autograd.backward((s, o), (torch.from_numpy(gs),
                                         torch.from_numpy(go)))
        return s.detach().numpy(), o.detach().numpy(), {
            k: [t.grad.numpy() for t in v] for k, v in leaves.items()}

    s, o, grads = port(mode)
    ws, wo, wgrads = port(WRONG[mode])
    want_grads = {
        "emb": (jg["input_embedding"]["kernel"],
                jg["input_embedding"]["bias"]),
        "sw_in": _swiglu_weights(jg["swiglu_input_prev"]),
        "sw_dec": _swiglu_weights(jg["swiglu_decoded"]),
        "head": (jg["fc_final"]["kernel"], jg["fc_final"]["bias"])}
    for name, got, want, wrong in (("s", s, js, ws), ("out", o, jo, wo)):
        _close(got, want, CHAIN_TOL[mode], name, CHAIN_MEAN_TOL[mode])
        _separated(got, want, wrong, name)
    for k, want in want_grads.items():
        for i, (got, ref, wrong) in enumerate(zip(grads[k], want,
                                                  wgrads[k])):
            _close(got, np.asarray(ref), CHAIN_TOL[mode], f"{k}[{i}]",
                   CHAIN_MEAN_TOL[mode])
            if i % 2 == 0:  # the weights; a bias gradient sums g alone
                _separated(got, np.asarray(ref), wrong, f"{k}[{i}]")


@pytest.mark.parametrize("mode", MODES)
def test_embedding_serving_and_a3_match_jax(mode):
    """The Embedding in the mode: its serving forward and, in ``train()``
    mode under autograd (regime A3), its forward and parameter gradients
    against the JAX ``Embedding`` with its Dense layers in the mode; then
    one A3 step through ``make_train_step`` takes the mode's route."""
    rng = np.random.default_rng(8)
    x = rng.uniform(0.2, 0.8, (2, 12, 54, 2)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jm = jc.Embedding(32)
    params = jm.init(jax.random.key(2), jnp.asarray(x))
    with dense_in_mode(mode):
        want, vjp = jax.vjp(lambda p: jm.apply(p, jnp.asarray(x)), params)
        (jg,) = vjp(jnp.asarray(g))
    sd = {f"{k}.{n}": torch.tensor(a.T if n == "weight" else a)
          for k, v in params["params"].items()
          for n, a in (("weight", np.asarray(v["kernel"])),
                       ("bias", np.asarray(v["bias"])))}
    model = Embedding(32, precision=PRECISION[mode])
    model.load_state_dict(sd)
    with torch.no_grad():
        served = model.eval()(torch.from_numpy(x)).numpy()
    _close(served, want, CHAIN_TOL[mode], "served")
    wrong = Embedding(32, precision="highest")
    wrong.load_state_dict(sd)
    with torch.no_grad():
        _separated(served, want, wrong(torch.from_numpy(x)).numpy(),
                   "served")
    out = model.train()(torch.from_numpy(x))
    _close(out.detach().numpy(), want, CHAIN_TOL[mode], "trained")
    out.backward(torch.from_numpy(g))
    for name, prm in model.named_parameters():
        k, n = name.split(".")
        want_g = np.asarray(jg["params"][k]["kernel" if n == "weight"
                                            else "bias"])
        _close(prm.grad.numpy(), want_g.T if n == "weight" else want_g,
               CHAIN_TOL[mode], name)
    # one A3 step through the step function, its products in the mode
    seen = []
    real = layers.mode_linear

    def spy(x, w, b, mode):
        seen.append((mode, torch.is_grad_enabled()))
        return real(x, w, b, mode)
    cfg = Config(model=ModelConfig(hidden_dim=32, variant="embedding",
                                   matmul_precision=PRECISION[mode]))
    cfg.train.regime = "a3"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "mode_linear", spy)
        st, metrics = steps.make_train_step(model, cfg, None)(
            state.TrainState.create(model, 1e-3),
            torch.from_numpy(x[:, :11]), torch.tensor([11, 9]),
            torch.ones(2), torch.Generator().manual_seed(1), 1e-3)
    assert torch.isfinite(metrics["loss"])
    assert seen == [(mode, True)] * 2


# ---------------------------------------------------------------------------
# routing, planes, the table and the C entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec,mode", [("high", "bf16x3"),
                                       ("default", "bf16")])
def test_routes_take_mode_linear(monkeypatch, prec, mode):
    """Which Dense products take ``mode_linear``, in the model's mode, on
    each route (counted at the wrapper, as the card counts its launches):
    an A1 step on the fused route 9 (the two pre-stream chains' embedding,
    [fc1 | fc2] and fc3, the head's three), on the per-op route 9 + 7 per
    layer pair (q / k / v and out-projection: 2 per self-attention, 3 for
    cross-attention), all under autograd; serving at a width the pointwise
    kernels take, the per-op route's 7 a layer pair and no chain; at one
    they do not take, 9 more; int8 serving none.  At "highest" none."""
    seen = []
    real = layers.mode_linear

    def spy(x, w, b, mode):
        seen.append((mode, torch.is_grad_enabled()))
        return real(x, w, b, mode)

    monkeypatch.setattr(layers, "mode_linear", spy)
    gen = torch.Generator().manual_seed(0)
    cfgs = {fuse: Config(model=ModelConfig(
        hidden_dim=32, num_heads=4, num_layers=2, ff_dim=64,
        attn_sublayer_fusion="on" if fuse else "off",
        matmul_precision=prec)) for fuse in (True, False)}
    # 16 frames a stream (the SOS frame in, the last out): the sublayer
    # kernel takes them
    clean = torch.rand(2, 16, 54, 2, generator=gen)
    for fuse, per_step in ((True, 9), (False, 9 + 7 * 2)):
        cfg = cfgs[fuse]
        model = steps.build_model(cfg.model, for_training=True, device="cpu",
                                  generator=gen)
        seen.clear()
        steps.make_train_step(model, cfg, None)(
            state.TrainState.create(model, 1e-3), clean,
            torch.tensor([16, 9]), torch.ones(2),
            torch.Generator().manual_seed(2), 1e-3)
        assert seen == [(mode, True)] * per_step, (fuse, seen)
    x = torch.rand(2, 16, 54, 2, generator=gen)
    m = (torch.rand(2, 16, generator=gen) < 0.3).float()
    for D, chains in ((128, 0), (32, 9)):
        model = KeypointCompleter(D, 2, 4, ff_dim=64, precision=prec,
                                  attn_sublayer_fusion=False, generator=gen)
        seen.clear()
        with torch.no_grad():
            model.eval()(x, x, m, m)
        assert seen == [(mode, False)] * (chains + 7 * 2), (D, seen)
        seen.clear()
        model.pack_weights("int8")
        with torch.no_grad():
            model(x, x, m, m)
        assert seen == []
    model = KeypointCompleter(32, 1, 4, ff_dim=64, generator=gen)
    model.train()(x, x, m, m).sum().backward()
    assert seen == []


def test_planes_splits_and_counters():
    """The planes the kernels read (columns zero-padded to 16: 108 -> 112,
    TMA's row rule; lo None at "default"), the backward's row ranges, and
    the wrappers counting nothing on CPU tensors."""
    w = torch.randn(32, 108)
    for mode in MODES:
        hi, lo = kernels.linear_planes(w, mode)
        assert hi.shape == (32, 112) and hi.dtype == torch.bfloat16
        assert not hi[:, 108:].any()
        assert (lo is None) == (mode == "bf16")
        if lo is not None:
            torch.testing.assert_close(hi.float() + lo.float(), torch.nn.
                                       functional.pad(w, (0, 4)), rtol=0,
                                       atol=2e-5 * float(w.abs().max()))
        xh, _ = kernels.row_planes(torch.randn(2, 5, 108), mode)
        assert xh.shape == (10, 112)
    assert tlin.padded(108) == 112 and tlin.padded(256) == 256
    # one wave of 132 SMs: 4 output tiles of a 256 x 256 weight take 33
    # row ranges of at least 256 rows each at the training batch's 8192
    assert tlin.weight_splits(8192, 256, 256) == 32
    assert tlin.weight_splits(100, 256, 256) == 1
    assert tlin.colsum_splits(8192) == 32 and tlin.colsum_splits(5) == 1
    kernels.reset_launches()
    x = torch.randn(3, 32, requires_grad=True)
    kernels.mode_linear(x, torch.randn(32, 8), None, "bf16x3").sum().backward()
    kernels.mode_linear_bwd(torch.randn(3, 8), x.detach(), torch.randn(32, 8),
                            "bf16")
    assert set(kernels.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="bf16 mode"):
        kernels.mode_linear_bwd(torch.randn(3, 8), x.detach(),
                                torch.randn(32, 8), "f32")


def _c_params(src, entry):
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    return "".join("i" if p.strip().startswith("int ") else "p"
                   for p in m.group(1).split(","))


def test_rows_and_signatures():
    """Four rows name ``mode_linear``'s kernels per mode, each with the
    JAX Dense call sites it replaces (``models/layers.py``'s q / k / v and
    out-projection; the chains and the Embedding are the same Dense); the C
    entries take what ``_SIGS`` passes."""
    table = {k.name: k for k in kernels.KERNELS}
    src = (_build.CSRC.parents[1] / "keypoints_interpolation_transformer_tpu"
           / "models/layers.py").read_text().splitlines()
    assert "nn.Dense(self.dim" in src[87] and 'name="out_proj"' in src[111]
    for base, wrapper in (("mode_linear", kernels.mode_linear),
                          ("mode_linear_bwd", kernels.mode_linear_bwd)):
        for tag, mode in (("_high", "bf16x3"), ("_default", "bf16")):
            k = table[base + tag]
            assert (k.wrapper, k.mode) == (wrapper, mode)
            assert k.source.endswith("csrc/mode_linear.cu")
            assert k.replaces.endswith("models/layers.py:88,112")
    assert len(kernels.KERNELS) == 47
    assert "mode_linear" in _build.SOURCES
    cu = (_build.CSRC / "mode_linear.cu").read_text()
    for entry, sig in tlin._SIGS.items():
        assert _c_params(cu, entry) == sig, entry


@pytest.mark.parametrize("mode", MODES)
def test_weight_planes_are_split_once_per_weight_version(mode):
    """``weight_planes`` (the cache of W's planes the forward kernel reads)
    on CPU tensors: the planes equal ``linear_planes``; a second call with
    the same weight splits nothing; an in-place change (``_version``) and
    ``load_state_dict``'s ``copy_`` split again; a view of a Linear's
    weight (``graph_linear``'s ``weight.t()``, made anew each call) hits
    the cache of its weight; a new tensor at a freed one's address, and
    with its id, never hits the freed one's entry."""
    splits = tlin.weight_planes.splits
    rng = np.random.default_rng(4)

    def check(w, hit):
        before = splits[mode]
        got = tlin.weight_planes(w, mode)
        assert splits[mode] == before + (0 if hit else 1)
        for a, b in zip(got.planes, tlin.linear_planes(w, mode)):
            assert (a is None and b is None) or torch.equal(a, b)
        assert got.maps is None  # the tensor maps exist on the card only
        return got

    w = torch.from_numpy(rng.standard_normal((12, 20)).astype(np.float32))
    first = check(w, False)
    assert check(w, True) is first
    with torch.no_grad():
        w.mul_(2.0)
    check(w, False)
    check(w, True)
    lin = torch.nn.Linear(20, 12)
    check(lin.weight.t(), False)
    check(lin.weight.t(), True)
    check(lin.weight, False)  # another view of the same storage
    lin.load_state_dict({"weight": torch.ones(12, 20),
                         "bias": torch.zeros(12)})
    assert bool((check(lin.weight.t(), False).planes[0][:, :12] == 1).all())
    # a new tensor over the same memory, once the first is freed: its
    # address (and often its id) is the freed tensor's; it misses
    arr = rng.standard_normal((8, 16)).astype(np.float32)
    old = torch.from_numpy(arr)
    ptr = old.data_ptr()
    check(old, False)
    del old
    arr *= 3.0
    new = torch.from_numpy(arr)
    assert new.data_ptr() == ptr
    check(new, False)
    check(new, True)
    # the cache keeps no entry of a freed weight
    key = tlin._cache_key(new, mode)[1]
    del new
    assert key not in tlin._CACHE

"""The attention sublayer kernels in the precision modes "high" (bf16x3) and
"default" (one bf16 pass): the port's plain versions against the JAX
``_fwd_pallas`` (serving and training forms) and ``_bwd_pallas`` (its
residual and its recompute branch) in interpret mode under the ambient
precision; the autograd Function, the model's routing, the wrappers'
counters and table rows, the C signatures and the scratch the C code
carves.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` and ``tests/test_torch_gpu.py``).

Both packages round the same operands to bf16 (nearest even) and sum exact
bf16 products in float32, so "default" agrees to float32 noise and "high"
too, but where a probability, rounded to ONE bf16 in both modes, lies so
near a bf16 rounding boundary that the two float32 orders put it on either
side: it then differs by one bf16 step and moves its query's token (the
merged layers' ``FLIP_TOKENS``, ``tests/test_torch_layer_modes.py``).
"""

import contextlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.ops.pallas import (
    attn_sublayer as jas)
from keypoints_interpolation_transformer_torch.models import layers
from keypoints_interpolation_transformer_torch.models.completer import (
    KeypointCompleter)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import _build
from keypoints_interpolation_transformer_torch.ops.kernels import (
    attn_sublayer as tas)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

B, T, D, H = 2, 24, 32, 4
PREC = {"bf16x3": "high", "bf16": "default"}
# one mode down: what each mode's rounding must beat
WRONG = {"bf16x3": "bf16", "bf16": "f32"}
# each output against its own largest value: "high" the same exact bf16
# products summed in float32 in another order; "default" as "high", plus
# the values the sum order moves across a bf16 rounding boundary, each off
# by one bf16 step (2^-8) of its term
TOL = {"bf16x3": 2e-5, "bf16": 2e-3}
# the tokens a flipped probability may move (beyond TOL, within "default"'s)
FLIP_TOKENS = 0.1
# (flags, cross-attention, LayerNorm, mask kind, add_keypad): the decoder's
# self-attention with its LN1 and the encoder's keypad term, and the
# cross-attention; a padded key in every case
CASES = [("self+LN repeat-inc keypad", False, True, "repeat-inc", True),
         ("cross all", True, False, "all", False)]


@contextlib.contextmanager
def _interpret(prec):
    """The Pallas kernels as the JAX kernel tests run them on the CPU,
    under the ambient precision ``prec``."""
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision(prec):
        yield


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _j(a):
    return None if a is None else jnp.asarray(a)


def _f32(a):
    return np.asarray(a, np.float32)


def _scale(want):
    return max(1.0, float(np.abs(want).max()))


def _close(got, want, tol, what=""):
    """Within ``tol`` of the larger of 1 and the reference's scale."""
    got, want = np.asarray(got), np.asarray(want)
    s = _scale(want)
    np.testing.assert_allclose(got / s, want / s, atol=tol, rtol=0,
                               err_msg=what)


def _close_mode(got, want, mode, what=""):
    """``_close`` at the mode's tolerance, less the tokens a flipped
    probability moves at "high" (at most FLIP_TOKENS of them, within
    "default"'s tolerance)."""
    _close(got, want, TOL["bf16"], what)
    if mode == "bf16":
        return
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).reshape(-1, got.shape[-1]) / _scale(want)
    flipped = (err.max(-1) > TOL[mode]).mean()
    assert flipped <= FLIP_TOKENS, (what, flipped, float(err.max()))


class Case:
    """One sublayer's inputs from a numpy seed: x, the memory (cross),
    q / k / v / o weights (JAX layout), the LayerNorm, the masks (a padded
    key in the second video) and dL/dy."""

    def __init__(self, rng, cross, ln, kind, add_keypad):
        self.x = _f32(rng.normal(size=(B, T, D)))
        self.mem = _f32(rng.normal(size=(B, T, D))) if cross else None
        self.attn = [(_f32(rng.normal(size=(D, D)) * 0.2),
                      _f32(rng.normal(size=(D,)) * 0.05)) for _ in range(4)]
        self.ln = ln
        self.g = _f32(1 + 0.1 * rng.normal(size=(D,))) if ln else None
        self.be = _f32(0.1 * rng.normal(size=(D,))) if ln else None
        self.mask = (rng.random((B, T)) < 0.3).astype(np.float32)
        self.valid = np.ones((B, T), np.float32)
        self.valid[1, T - 5:] = 0.0
        self.kind, self.add_keypad = kind, add_keypad
        self.dy = _f32(rng.normal(size=(B, T, D)))

    def jparams(self):
        ln = (self.g, self.be) if self.ln else (np.zeros(D, np.float32),) * 2
        return [jnp.asarray(a) for pair in self.attn for a in pair] + \
            [jnp.asarray(a) for a in ln]

    def jargs(self):
        return (jnp.asarray(self.x), _j(self.mem), self.jparams(),
                jnp.asarray(self.mask), jnp.asarray(self.valid), self.kind,
                self.add_keypad, self.ln, H)

    def targs(self):
        """The port's forward arguments: (x, memory, wqkv, bqkv, wo, bo,
        ln_w, ln_b, mask, valid, kind, add_keypad, heads)."""
        wqkv = np.concatenate([w for w, _ in self.attn[:3]], 1)
        bqkv = np.concatenate([b for _, b in self.attn[:3]])
        return (*_t(self.x, self.mem, wqkv, bqkv, *self.attn[3], self.g,
                    self.be, self.mask, self.valid), self.kind,
                self.add_keypad, H)

    def weights_torch(self):
        """(w_in (3D, D), w_out (D, D)) in torch's layout."""
        wqkv = np.concatenate([w for w, _ in self.attn[:3]], 1)
        return _t(wqkv.T.copy(), self.attn[3][0].T.copy())


def _case(rng, flags):
    cross, ln, kind, add_keypad = {c[0]: c[1:] for c in CASES}[flags]
    return Case(rng, cross, ln, kind, add_keypad)


def _mean_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).mean())


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("flags", [c[0] for c in CASES])
def test_serving_plain_matches_pallas_in_mode(rng, mode, flags):
    """``attn_sublayer_plain`` in the mode (q's scale folded into Wq before
    the split) against ``_fwd_pallas`` (``_sublayer_kernel``) in
    interpret mode under the ambient precision; the wrapper takes the same
    plain version for CPU tensors; one mode down is further away."""
    c = _case(rng, flags)
    with _interpret(PREC[mode]):
        want = np.asarray(jas._fwd_pallas(*c.jargs()))
    got = tas.attn_sublayer_plain(*c.targs(), mode).numpy()
    _close_mode(got, want, mode, f"{mode} {flags}")
    wrapped = kernels.fused_attn_sublayer(*c.targs(), mode=mode).numpy()
    np.testing.assert_array_equal(wrapped, got)
    down = tas.attn_sublayer_plain(*c.targs(), WRONG[mode]).numpy()
    assert _mean_err(down, want) > 4 * _mean_err(got, want)


def _jax_probs(w):
    """The JAX training forward's bf16 probabilities, (B, Tk, H Tq) key-major,
    as (B, H, Tq, Tk) float32."""
    return np.asarray(w, np.float32).reshape(B, T, H, T).transpose(0, 2, 3, 1)


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("flags", [c[0] for c in CASES])
def test_train_forward_plain_matches_pallas_in_mode(rng, mode, flags):
    """``attn_sublayer_train_plain`` in the mode against ``_fwd_pallas(
    want_residuals=True)`` (``_sublayer_train_kernel``): y, the unscaled
    q, k, v, a and r; the probabilities rebuilt from its statistics
    (``mode_probs``, as the backward rebuilds them) against the JAX kernel's
    bf16 probabilities: equal but for a few flips, each one bf16 step."""
    c = _case(rng, flags)
    with _interpret(PREC[mode]):
        y_j, (q_j, k_j, v_j, a_j, w_j, r_j) = jas._fwd_pallas(
            *c.jargs(), want_residuals=True)
    y, qkv, a, stats, r = tas.attn_sublayer_train_plain(*c.targs(), mode)
    _close_mode(y.numpy(), np.asarray(y_j), mode, "y")
    for got, want, name in zip(qkv.split(D, -1), (q_j, k_j, v_j), "qkv"):
        _close(got.numpy(), np.asarray(want), TOL[mode], name)
    _close_mode(a.numpy(), np.asarray(a_j), mode, "a")
    assert (r is None) == (not c.ln)
    if c.ln:
        _close_mode(r.numpy(), np.asarray(r_j), mode, "r")
    p = tas.mode_probs(qkv, stats, *c.targs()[8:], mode).numpy()
    w = _jax_probs(w_j)
    step = np.maximum(np.abs(p), np.abs(w)) * 2.0 ** -7
    assert (np.abs(p - w) <= step).all()
    flipped = (p != w).any(-1).mean()
    assert flipped <= FLIP_TOKENS, flipped
    wrapped = kernels.fused_attn_sublayer_train(*c.targs(), mode=mode)
    assert len(wrapped) == 6 and wrapped[5] is None  # no planes on the CPU
    for got, want in zip(wrapped, (y, qkv, a, stats, r)):
        assert (got is None and want is None) or torch.equal(got, want)


def _jax_grads(dx, dmem, dp, ln):
    """``_bwd_pallas``'s gradients in the port's order and torch's layout:
    (dx, dmem, dw_in, db_in, dw_out, db_out, dg, dbe)."""
    dw = [np.asarray(g) for g in dp]
    return (np.asarray(dx), None if dmem is None else np.asarray(dmem),
            np.concatenate([dw[0].T, dw[2].T, dw[4].T]),
            np.concatenate([dw[1], dw[3], dw[5]]), dw[6].T, dw[7],
            dw[8] if ln else None, dw[9] if ln else None)


def _plain_grads(c, mode):
    """The plain training forward and backward in ``mode``: (forward's
    outputs, gradients)."""
    fwd = tas.attn_sublayer_train_plain(*c.targs(), mode)
    _, qkv, a, stats, r = fwd
    args = c.targs()
    grads = tas.attn_sublayer_bwd_plain(
        *_t(c.dy), args[0], args[1], qkv, a, stats, r, *c.weights_torch(),
        args[6], *args[8:], mode)
    return fwd, grads


@pytest.mark.parametrize("save_probs", [True, False])
@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("flags", [c[0] for c in CASES])
def test_backward_plain_matches_pallas_in_mode(rng, mode, flags, save_probs):
    """``attn_sublayer_bwd_plain`` in the mode against ``_bwd_pallas``
    (``_sublayer_bwd_kernel``) fed from the plain training forward's
    residuals.  Its residual branch (``save_probs``) reads the plain
    forward's bf16 probabilities, the very p the plain backward rebuilds,
    so all eight gradients hold the mode's tolerance; its recompute branch
    rebuilds q and p itself, so a flipped probability may move a few
    tokens' dx and dmem (``_close_mode``) and every parameter gradient by
    up to "default"'s tolerance, and the mean decides.  One mode down is
    further away."""
    c = _case(rng, flags)
    (_, qkv, a, stats, r), grads = _plain_grads(c, mode)
    q, k, v = (t.numpy() for t in qkv.split(D, -1))
    if save_probs:
        p = tas.mode_probs(qkv, stats, *c.targs()[8:], mode).numpy()
        w = jnp.asarray(p.transpose(0, 3, 1, 2).reshape(B, T, H * T),
                        jnp.bfloat16)
        res = (_j(q), _j(k), _j(v), _j(a.numpy()), w,
               _j(None if r is None else r.numpy()))
    else:
        res = (None, _j(k), _j(v), None, None,
               _j(None if r is None else r.numpy()))
    x, mem, params, mask, valid, kind, add_keypad, ln, heads = c.jargs()
    with _interpret(PREC[mode]):
        dx, dmem, dp = jas._bwd_pallas(x, mem, params, res, jnp.asarray(c.dy),
                                       ln, heads, mask=mask, valid=valid,
                                       kind=kind, add_keypad=add_keypad)
    want = _jax_grads(dx, dmem, dp, ln)
    names = ("dx", "dmem", "dw_in", "db_in", "dw_out", "db_out", "dg", "dbe")
    _, down = _plain_grads(c, WRONG[mode])
    for name, got, w, d in zip(names, grads, want, down):
        assert (got is None) == (w is None), name
        if w is None:
            continue
        got = got.numpy()
        if save_probs:
            _close(got, w, TOL[mode], name)
        elif name in ("dx", "dmem"):
            _close_mode(got, w, mode, name)
        else:
            _close(got, w, TOL["bf16"], name)
        if name not in ("db_out", "dbe"):  # sums of dy or dr alone
            assert _mean_err(d.numpy(), w) > 4 * _mean_err(got, w), name


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("flags", [c[0] for c in CASES])
def test_function_backward_is_the_plain_backward(rng, mode, flags, plain):
    """``AttnSublayerFunction`` on CPU tensors in a mode (the kernel route's
    wrappers, or with ``plain`` the plain route's versions): its forward is
    the plain training forward and autograd's gradients are the plain
    backward's, bit for bit (no autograd through the casts)."""
    c = _case(rng, flags)
    args = c.targs()
    w_in, w_out = (t.requires_grad_() for t in c.weights_torch())
    b_in, b_out = (t.clone().requires_grad_() for t in (args[3], args[5]))
    x = args[0].clone().requires_grad_()
    mem = None if args[1] is None else args[1].clone().requires_grad_()
    ln = [None if t is None else t.clone().requires_grad_()
          for t in (args[6], args[7])]
    y = kernels.AttnSublayerFunction.apply(x, mem, w_in, b_in, w_out, b_out,
                                           *ln, *args[8:], mode, plain)
    y.backward(torch.from_numpy(c.dy))
    (y_p, _, _, _, _), grads = _plain_grads(c, mode)
    assert torch.equal(y.detach(), y_p)
    for got, want in zip((x, mem, w_in, b_in, w_out, b_out, *ln), grads):
        if want is None:
            assert got is None or got.grad is None
        else:
            assert torch.equal(got.grad, want)


def test_mode_rows_in_the_table():
    """Six rows name the mode kernels of the three sublayer wrappers,
    beside their "f32" rows, each naming the JAX kernel it replaces; the
    table counts per mode, and the plain versions count nothing."""
    table = {k.name: k for k in kernels.KERNELS}
    assert len(kernels.KERNELS) == 47
    src = (_build.CSRC.parents[1] / "keypoints_interpolation_transformer_tpu"
           / "ops/pallas/attn_sublayer.py").read_text().splitlines()
    for base, wrapper, line, body in (
            ("attn_sublayer", kernels.fused_attn_sublayer, 135,
             "_sublayer_kernel"),
            ("attn_sublayer_train", kernels.fused_attn_sublayer_train, 173,
             "_sublayer_train_kernel"),
            ("attn_sublayer_bwd", kernels.attn_sublayer_bwd, 410,
             "_sublayer_bwd_kernel")):
        assert src[line - 1].startswith(f"def {body}(")
        for tag, mode, cu in (("", "f32", "attn_sublayer.cu"),
                              ("_high", "bf16x3", "attn_sublayer_modes.cu"),
                              ("_default", "bf16", "attn_sublayer_modes.cu")):
            k = table[base + tag]
            assert (k.wrapper, k.mode) == (wrapper, mode)
            assert k.replaces.endswith(f"ops/pallas/attn_sublayer.py:{line}")
            assert k.source.endswith(f"csrc/{cu}")
    kernels.reset_launches()
    kernels.fused_attn_sublayer_train.launches["bf16x3"] += 1
    kernels.attn_sublayer_bwd.launches["bf16"] += 2
    counts = kernels.launch_counts()
    assert counts["attn_sublayer_train_high"] == 1
    assert counts["attn_sublayer_bwd_default"] == 2
    assert counts["attn_sublayer_train"] == counts["attn_sublayer_bwd"] == 0
    kernels.reset_launches()
    c = Case(np.random.default_rng(0), False, True, "repeat-inc", True)
    kernels.fused_attn_sublayer(*c.targs(), mode="bf16x3")
    assert set(kernels.launch_counts().values()) == {0}


def _c_params(entry):
    """The C parameter list of ``entry`` in ``csrc/attn_sublayer_modes.cu``:
    one letter each, as ``_MODE_SIGS`` writes them (p pointer, i int)."""
    src = (_build.CSRC / "attn_sublayer_modes.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    return "".join("i" if p.strip().startswith("int ") else "p"
                   for p in m.group(1).split(","))


@pytest.mark.parametrize("entry", ["kit_attn_sublayer_tc",
                                   "kit_attn_sublayer_tc_bwd",
                                   "kit_attn_bwd_fused"])
def test_signatures_match_the_c_entries(entry):
    assert tas._MODE_SIGS[entry] == _c_params(entry)
    assert "attn_sublayer_modes" in _build.SOURCES


def _body(src, head):
    body = src[src.index(head):]
    return body[:body.index("\n}\n")]


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_scratch_is_what_the_kernels_carve(cross, mode):
    """``mode_forward_scratch`` and ``mode_bwd_scratch_floats`` against
    the regions ``csrc/attn_sublayer_modes.cu`` lays out: the carve calls
    (M D a unit, the memory's only with cross-attention) times the planes,
    and the backward's float regions as its comments size them, with the
    fused core and with the two kernels.  Training keeps the planes of x,
    the memory and a apart (``mode_act_elems``), and the backward reads
    them from there: its scratch holds only dr's, dA's and [dq | dk |
    dv]'s."""
    src = (_build.CSRC / "attn_sublayer_modes.cu").read_text()
    planes = 2 if mode == "bf16x3" else 1
    Bq, Tq, Dq, heads, s_w = 3, 40, 128, 4, 5
    M = Bq * Tq
    s_vec = -(-M // tas.BIAS_ROWS)
    MD = M * Dq

    def units(body):
        found = re.findall(r"(self \? \w+ : )?carve<PASSES>\((?:cur|at), "
                           r"(\d*)\s*\*?\s*MD\)", body)
        return sum((int(u) if u else 1) for opt, u in found
                   if cross or not opt)

    fwd = units(_body(src, "int forward("))
    nb, nf = tas.mode_forward_scratch(Bq, Tq, Dq, cross, mode, True, False)
    assert fwd == (6 if cross else 5) and nb == fwd * planes * MD
    assert nf == MD
    nb, nf = tas.mode_forward_scratch(Bq, Tq, Dq, cross, mode, True, True)
    acts = tas.mode_act_elems(Bq, Tq, Dq, cross, mode)
    assert nf == 0 and nb == 3 * planes * MD
    assert nb + acts == fwd * planes * MD
    bwd = _body(src, "int backward(")
    regions = re.findall(r"float\* \w+ = [^;]+;\s*// ([^\n]+)", bwd)
    assert re.findall(r"carve<PASSES>\(kept, MD\)", bwd) and \
        "split_planes(x" not in bwd
    for T, fused in ((Tq, True), (300, False)):
        M = Bq * T
        MD = M * Dq
        sizes = {"M x 3D (two kernels)": 3 * MD,
                 "B x H x T (two kernels)": -(-Bq * heads * T // 4) * 4,
                 "blocks x 2D": -(-M // 32) * 2 * Dq,
                 "blocks x D": -(-M // 32) * Dq,
                 "s_w x 4 D^2": s_w * 4 * Dq * Dq,
                 "(B or s_vec) x 3D": (Bq if fused
                                       else -(-M // tas.BIAS_ROWS)) * 3 * Dq,
                 "M x D": MD}
        assert regions == list(sizes)
        used = sum(v for k, v in sizes.items()
                   if not (fused and "two kernels" in k))
        assert units(bwd) == 5
        assert tas.mode_bwd_scratch_floats(Bq, T, Dq, heads, mode, s_w,
                                           fused) == \
            used + -(-5 * planes * MD // 2)
    assert f"constexpr int BIAS_ROWS = {tas.BIAS_ROWS};" in src


class _Recorder:
    """Records the mode and planes the model hands the attention sublayer's
    serving wrapper and its training Function."""

    def __init__(self, monkeypatch):
        self.calls = []
        fn = layers.fused_attn_sublayer

        def rec(*a):
            self.calls.append(("fused_attn_sublayer", a[13], a[14]))
            return fn(*a)

        monkeypatch.setattr(layers, "fused_attn_sublayer", rec)
        real = layers.AttnSublayerFunction
        calls = self.calls

        class Fn:
            @staticmethod
            def apply(*a):
                calls.append(("AttnSublayerFunction", a[13], a[14]))
                return real.apply(*a)

        monkeypatch.setattr(layers, "AttnSublayerFunction", Fn)


def _model_inputs(rng, Tm):
    x = _f32(rng.uniform(0.2, 0.8, (B, Tm, 54, 2)))
    masks = [(rng.random((B, Tm)) < 0.3).astype(np.float32) for _ in "st"]
    return _t(x, x, *masks, np.ones((B, Tm), np.float32))


@pytest.mark.parametrize("prec,mode", [("high", "bf16x3"),
                                       ("default", "bf16"),
                                       ("highest", "f32")])
def test_sublayer_route_takes_the_mode_and_packed_planes(rng, monkeypatch,
                                                         prec, mode):
    """Per sublayer (``merge_layers=False``) every attention sublayer gets
    the model's mode and, outside "f32", the planes ``pack_weights`` built
    for it (the same tensors, so serving splits nothing); the training
    route's Function gets the mode and takes the kernel route (not plain);
    int8 serving's per-sublayer attention runs in the mode too."""
    rec = _Recorder(monkeypatch)
    model = KeypointCompleter(32, 1, 4, ff_dim=64, precision=prec,
                              merge_layers=False,
                              generator=torch.Generator().manual_seed(0))
    model.pack_weights()
    with torch.no_grad():
        model.eval()(*_model_inputs(rng, 16))
    mhas = [model.transformer.encoder.layers[0].self_attn,
            model.transformer.decoder.layers[0].self_attn,
            model.transformer.decoder.layers[0].multihead_attn]
    assert [(n, m) for n, m, _ in rec.calls] == \
        [("fused_attn_sublayer", mode)] * 3
    for (_, _, planes), mha in zip(rec.calls, mhas):
        if mode == "f32":
            assert planes is None
        else:
            assert planes is mha.__dict__[f"_planes_{mode}"][1]
    rec.calls.clear()
    model.train()(*_model_inputs(rng, 16))
    assert [(n, m, p) for n, m, p in rec.calls] == \
        [("AttnSublayerFunction", mode, False)] * 3
    rec.calls.clear()
    model.pack_weights("int8")
    with torch.no_grad():
        model.eval()(*_model_inputs(rng, 16))
    assert [m for _, m, _ in rec.calls] == [mode] * 3

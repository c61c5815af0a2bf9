"""The serving pointwise chains in the precision modes "high" (bf16x3) and
"default" (one bf16 pass): the port's plain versions against the JAX
``_pre_embed_pallas`` (``_pre_embed_kernel``) and ``_post_pallas``
(``_post_kernel``) in interpret mode under the ambient precision; the
weight planes the mode kernels read (the gate's interleaved columns, the
embedding's and the head's zero padding) as a float64 model of the launch
sequence of ``csrc/pointwise_modes.cu``; the model's routing of the chains
by mode and the planes a packed model keeps; the counters, the table rows
and the C signatures.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` and ``tests/test_torch_gpu.py``).

Both packages round the same operands to bf16 (nearest even) and sum exact
bf16 products in float32: "high" agrees to float32 noise; "default" too,
but where an activation the two compute in another float32 order (e, n,
the gate, z) lies at a bf16 rounding boundary and moves its products by
one bf16 step of the term.  No probability is rounded in these chains.
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
    pointwise as jpw)
from keypoints_interpolation_transformer_torch.models import completer
from keypoints_interpolation_transformer_torch.models.completer import (
    KeypointCompleter)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels import _build
from keypoints_interpolation_transformer_torch.ops.kernels import (
    pointwise as tpw)
from keypoints_interpolation_transformer_torch.ops.kernels.precision import (
    parts)
from keypoints_interpolation_transformer_torch.ops.kernels.widths import (
    KERNEL_WIDTHS)

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

# D = 128, the narrowest width the JAX pointwise kernels take (D % 128 ==
# 0, T % 8 == 0); the 108 frame features
B, T, D, F = 2, 8, 128, 108
PREC = {"bf16x3": "high", "bf16": "default"}
WRONG = {"bf16x3": "bf16", "bf16": "f32"}
# each output against its own largest value (see the module docstring)
TOL = {"bf16x3": 2e-5, "bf16": 2e-3}
# each mode's largest error at least this many times below the wrong mode's
MODE_SEPARATION = 4.0


@contextlib.contextmanager
def _interpret(prec):
    """The Pallas kernels as the JAX kernel tests run them on the CPU,
    under the ambient precision ``prec``."""
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision(prec):
        yield


class Chain:
    """One chain's inputs from a numpy seed: x (the 108 features of a
    frame), the embedding, the positional table plus the learned vector,
    fc1 / fc2 / fc3, the head, the decoder's output and the filled
    embedding."""

    def __init__(self, seed, D=D, F=F):
        rng = np.random.default_rng(seed)

        def w(i, o):
            return (rng.uniform(-1, 1, (i, o)) / np.sqrt(i)).astype(
                np.float32)

        def b(n):
            return (0.05 * rng.normal(size=n)).astype(np.float32)

        self.x = rng.uniform(0.2, 0.8, (B, T, F)).astype(np.float32)
        self.wemb, self.bemb = w(F, D), b(D)
        self.pe = rng.normal(size=(T, D)).astype(np.float32)
        self.w1, self.b1, self.w2, self.b2 = w(D, D), b(D), w(D, D), b(D)
        self.w3, self.b3 = w(D, D), b(D)
        self.wh, self.bh = w(D, F), b(F)
        self.dec = rng.normal(size=(B, T, D)).astype(np.float32)
        self.fe = rng.normal(size=(B, T, D)).astype(np.float32)

    def swiglu(self):
        """(w12, b12, w3, b3) as the port packs them."""
        return (np.concatenate([self.w1, self.w2], 1),
                np.concatenate([self.b1, self.b2]), self.w3, self.b3)

    def pre_args(self):
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in (
            self.x, self.wemb, self.bemb, self.pe, *self.swiglu())]

    def post_args(self):
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in (
            self.dec, self.fe, *self.swiglu(), self.wh, self.bh)]


def _held(got, want, wrong, mode, what):
    got, want, wrong = (np.asarray(a) for a in (got, want, wrong))
    s = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / s, want / s, atol=TOL[mode], rtol=0,
                               err_msg=what)
    own, off = (float(np.abs(a - want).max()) for a in (got, wrong))
    assert own * MODE_SEPARATION < off, (what, own, off)


@pytest.mark.parametrize("want_emb", [False, True])
@pytest.mark.parametrize("pe_residual", [False, True])
@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_pre_embed_plain_matches_pallas_in_mode(mode, pe_residual, want_emb):
    c = Chain(0)
    with _interpret(PREC[mode]):
        want = jpw._pre_embed_pallas(
            *(jnp.asarray(a) for a in (c.x, c.wemb, c.bemb, c.pe, c.w1, c.b1,
                                       c.w2, c.b2, c.w3, c.b3)),
            pe_residual, want_emb)
    args = c.pre_args()
    got = kernels.pre_stream_embed_plain(*args, pe_residual, want_emb, mode)
    wrong = kernels.pre_stream_embed_plain(*args, pe_residual, want_emb,
                                           WRONG[mode])
    if not want_emb:
        want, got, wrong = (want,), (got,), (wrong,)
    for name, g, w, x in zip(("s", "e"), got, want, wrong):
        _held(g.numpy(), w, x.numpy(), mode, name)


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_post_head_plain_matches_pallas_in_mode(mode):
    c = Chain(1)
    with _interpret(PREC[mode]):
        want = jpw._post_pallas(
            *(jnp.asarray(a) for a in (c.dec, c.fe, c.w1, c.b1, c.w2, c.b2,
                                       c.w3, c.b3, c.wh, c.bh)))
    args = c.post_args()
    _held(kernels.post_head_plain(*args, mode).numpy(), want,
          kernels.post_head_plain(*args, WRONG[mode]).numpy(), mode, "out")


def _tiles(D, FP, post):
    """The weight tiles of one chain in the order ``chain_tc_kernel``'s
    producer issues them (``csrc/pointwise_modes.cu``): (plane, k0, n0),
    the plane's rows n0 .. n0 + 127 and columns k0 .. k0 + 63 (TMA's zeros
    past its edge); the embedding's first (pre) or the head's last
    (post)."""
    KB, NH = D // 64, D // 128
    out = [] if post else [("wx", 64 * kb, 128 * h)
                           for kb in range(-(-FP // 64)) for h in range(NH)]
    for c in range(KB):
        out += [("w12", 64 * kb, 128 * c) for kb in range(KB)]
        out += [("w3", 64 * c, 128 * h) for h in range(NH)]
    if post:
        out += [("wx", 64 * kb, 0) for kb in range(KB)]
    return out


def _kernel_model(c, mode, pe_residual, planes_pre, planes_post, D):
    """A float64 model of ``chain_tc_kernel`` (``csrc/pointwise_modes.cu``)
    reading the K-major planes the wrappers hand it, one pass a chain: the
    tiles of ``_tiles`` in order, each a 128 x 64 block of a plane (zero
    past its edge) multiplied into the sums it feeds, every product a
    float64 sum of the bf16 parts (hi hi + hi lo + lo hi at "high"); the
    embedding's 112 columns read as two 64-deep tiles; [x1 | x2] of chunk
    c from the 128 interleaved rows 128 c .. of [W1 | W2]^T, gated in
    float32 and split before W3's rows 64 c ..; s starting at b3 (+ f in
    the post head); the plain chains' float32 row steps between.  Returns
    (s, e, out) and how often each plane element was read."""
    named = {"pre": dict(zip(("w12", "w3", "wx"), (planes_pre[0:2],
                                                   planes_pre[2:4],
                                                   planes_pre[4:6]))),
             "post": dict(zip(("w12", "w3", "wx"), (planes_post[0:2],
                                                    planes_post[2:4],
                                                    planes_post[4:6])))}
    reads = {k: {n: torch.zeros(p[0].shape, dtype=torch.int32)
                 for n, p in v.items()} for k, v in named.items()}

    def tile(chain, name, k0, n0):
        """The tile's parts as float64 (128, 64) blocks, zero past the
        plane, and its reads counted."""
        reads[chain][name][n0:n0 + 128, k0:k0 + 64] += 1
        out = []
        for p in named[chain][name]:
            if p is None:
                continue
            t = torch.zeros(128, 64, dtype=torch.float64)
            b = p[n0:n0 + 128, k0:k0 + 64].double()
            t[:b.shape[0], :b.shape[1]] = b
            out.append(t)
        return out

    def mult(a_parts, t_parts):  # (rows, 64) parts x a tile^T
        out = a_parts[0] @ t_parts[0].T
        if len(a_parts) == 2:
            out = out + a_parts[0] @ t_parts[1].T + a_parts[1] @ t_parts[0].T
        return out

    def split(a):  # float32 -> float64 parts, as the kernel splits
        return [q.double() for q in parts(a, mode)]

    def swiglu(chain, n, b12, acc):
        n_parts = split(n)
        for cc in range(D // 64):
            u = torch.zeros(n.shape[0], 128, dtype=torch.float64)
            for name, k0, n0 in _tiles(D, 112, chain == "post"):
                if name == "w12" and n0 == 128 * cc:
                    u += mult([q[:, k0:k0 + 64] for q in n_parts],
                              tile(chain, name, k0, n0))
            u = u.float()
            cols = slice(64 * cc, 64 * cc + 64)
            g = (u[:, :64] + b12[cols]) * torch.sigmoid(
                u[:, 64:] + b12[D:][cols])
            for name, k0, n0 in _tiles(D, 112, chain == "post"):
                if name == "w3" and k0 == 64 * cc:
                    acc[:, n0:n0 + 128] += mult(split(g),
                                                tile(chain, name, k0, n0))
        return acc.float()

    x, wemb, bemb, pe, w12, b12, w3, b3 = (a.reshape(-1, *a.shape[2:])
                                           if a.dim() == 3 else a
                                           for a in c.pre_args())
    rows = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, 128 - F))  # TMA's zeros past F
    e = torch.zeros(rows, D, dtype=torch.float64)
    for name, k0, n0 in _tiles(D, 112, False):
        if name == "wx":
            e[:, n0:n0 + 128] += mult(split(xp[:, k0:k0 + 64]),
                                      tile("pre", name, k0, n0))
    e = e.float() + bemb
    n = tpw.token_norm(e)
    pe_rows = pe.repeat(rows // T, 1)
    n = (n + n + pe_rows) if pe_residual else (n + pe_rows)
    s = swiglu("pre", n, b12, b3.double().expand(rows, D).clone())
    dec, fe, *_, wh, bh = (a.reshape(-1, a.shape[-1]) if a.dim() == 3
                           else a for a in c.post_args())
    z = tpw.token_norm(swiglu("post", dec, b12,
                              (b3 + fe).double()))
    z = z * torch.sigmoid(z)
    o = torch.zeros(rows, 128, dtype=torch.float64)
    for name, k0, n0 in _tiles(D, 112, True):
        if name == "wx":
            o += mult(split(z[:, k0:k0 + 64]), tile("post", name, k0, n0))
    out = o.float()[:, :F] + bh
    shape = (B, T)
    return (s.reshape(*shape, D), e.reshape(*shape, D),
            out.reshape(*shape, F)), reads


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_planes_and_launch_order_model_the_plain_chains(mode):
    """``chain_planes``' K-major layout (shapes, bf16, the transposes of
    the Flax-layout planes bit for bit, the interleaved [W1 | W2]^T rows,
    the zero padding) read as the one-launch mode kernel reads it, one pass
    a chain, computes the plain chains: the float64 model of its tile
    order against ``pre_stream_embed_plain`` / ``post_head_plain`` in the
    mode, at both of its widths (D = 128, 256)."""
    for d in (128, 256):
        c = Chain(2, d)
        x, wemb, bemb, pe, w12, b12, w3, b3 = c.pre_args()
        wh = torch.from_numpy(c.wh)
        pp = tpw.chain_planes(w12, w3, mode, wemb=wemb)
        ph = tpw.chain_planes(w12, w3, mode, wh=wh)
        shapes = [(2 * d, d)] * 2 + [(d, d)] * 2
        for planes, last in ((pp, (d, 112)), (ph, (112, d))):
            assert len(planes) == 6
            for t, shape in zip(planes, shapes + [last] * 2):
                if t is None:
                    assert mode == "bf16"
                    continue
                assert t.dtype == torch.bfloat16 and t.is_contiguous()
                assert tuple(t.shape) == shape
        assert not pp[4][:, F:].any() and not ph[4][F:].any()
        # the transposes of the Flax-layout planes, bit for bit
        w12i = w12.reshape(d, 2, d // 64, 64).transpose(1, 2).reshape(
            d, 2 * d)
        for got, w in ((pp[0:2], w12i), (pp[2:4], w3), (pp[4:6], wemb),
                       (ph[4:6], wh)):
            want = parts(w, mode)
            for g, wp in zip(got, want):
                g = g.t()[:w.shape[0], :w.shape[1]]
                assert torch.equal(g.float(), wp)
        assert tpw.chain_fused(d, F)
        for res in (False, True):
            (s, e, out), reads = _kernel_model(c, mode, res, pp, ph, d)
            for chain in reads.values():  # one pass: each element once
                for name, r in chain.items():
                    assert int(r.min()) == int(r.max()) == 1, name
            ws, we = kernels.pre_stream_embed_plain(x, wemb, bemb, pe, w12,
                                                    b12, w3, b3, res, True,
                                                    mode)
            wo = kernels.post_head_plain(*c.post_args(), mode)
            for name, g, w in (("s", s, ws), ("e", e, we),
                               ("out", out, wo)):
                sc = max(1.0, float(w.abs().max()))
                assert float((g - w).abs().max()) / sc < TOL[mode], \
                    (d, name)


def test_wrappers_count_per_mode_and_take_the_plain_on_the_cpu():
    c = Chain(3)
    table = {k.name: k for k in kernels.KERNELS}
    for base, wrapper, line, body in (
            ("pre_stream_embed", kernels.fused_pre_stream_embed, 230,
             "_pre_embed_kernel"),
            ("post_head", kernels.fused_post_head, 90, "_post_kernel")):
        src = (_build.CSRC.parents[1]
               / "keypoints_interpolation_transformer_tpu/ops/pallas"
               / "pointwise.py").read_text().splitlines()
        assert src[line - 1].startswith(f"def {body}(")
        for tag, mode, cu in (("", "f32", "pointwise.cu"),
                              ("_high", "bf16x3", "pointwise_modes.cu"),
                              ("_default", "bf16", "pointwise_modes.cu")):
            k = table[base + tag]
            assert (k.wrapper, k.mode) == (wrapper, mode)
            assert k.replaces.endswith(f"ops/pallas/pointwise.py:{line}")
            assert k.source.endswith(f"csrc/{cu}")
    kernels.reset_launches()
    for mode in ("bf16x3", "bf16"):
        got = kernels.fused_pre_stream_embed(*c.pre_args(), True, True,
                                             mode=mode)
        want = kernels.pre_stream_embed_plain(*c.pre_args(), True, True,
                                              mode)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(
            kernels.fused_post_head(*c.post_args(), mode=mode),
            kernels.post_head_plain(*c.post_args(), mode))
    assert set(kernels.launch_counts().values()) == {0}
    kernels.fused_post_head.launches["bf16x3"] += 1
    assert kernels.launch_counts()["post_head_high"] == 1
    assert kernels.launch_counts()["post_head"] == 0
    kernels.reset_launches()


def _c_params(entry):
    """The C parameter list of ``entry`` in ``csrc/pointwise_modes.cu``:
    one letter each, as ``_MODE_SIGS`` writes them (p pointer, i int)."""
    src = (_build.CSRC / "pointwise_modes.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    return "".join("i" if p.strip().startswith("int ") else "p"
                   for p in m.group(1).split(","))


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_chains_past_the_one_launch_frames_match_pallas(mode):
    """Frames wider than the one-launch kernel takes (F = 160 > 128 at D =
    256, a model's ``input_size`` the JAX kernels serve): ``chain_fused``
    sends them to the five-launch sequence on the card, the 108-wide frames
    at D <= 256 to the one launch; the plain chains at F = 160 against the
    JAX kernels in the mode."""
    assert [tpw.chain_fused(d, F) for d in KERNEL_WIDTHS] == [
        d <= 256 for d in KERNEL_WIDTHS]
    assert tpw.chain_fused(128, 128) and not tpw.chain_fused(256, 160)
    c = Chain(4, 256, 160)
    with _interpret(PREC[mode]):
        want = jpw._pre_embed_pallas(
            *(jnp.asarray(a) for a in (c.x, c.wemb, c.bemb, c.pe, c.w1, c.b1,
                                       c.w2, c.b2, c.w3, c.b3)), True, True)
        want_out = jpw._post_pallas(
            *(jnp.asarray(a) for a in (c.dec, c.fe, c.w1, c.b1, c.w2, c.b2,
                                       c.w3, c.b3, c.wh, c.bh)))
    args = c.pre_args()
    got = kernels.pre_stream_embed_plain(*args, True, True, mode)
    wrong = kernels.pre_stream_embed_plain(*args, True, True, WRONG[mode])
    for name, g, w, x in zip(("s", "e"), got, want, wrong):
        _held(g.numpy(), w, x.numpy(), mode, name)
    args = c.post_args()
    _held(kernels.post_head_plain(*args, mode).numpy(), want_out,
          kernels.post_head_plain(*args, WRONG[mode]).numpy(), mode, "out")


@pytest.mark.parametrize("entry", ["kit_pre_embed_tc", "kit_post_head_tc"])
def test_signatures_match_the_c_entries(entry):
    assert tpw._MODE_SIGS[entry] == _c_params(entry)
    assert "pointwise_modes" in _build.SOURCES


class _Spy:
    """Records the mode (and whether planes came) of each chain call the
    model makes, through the names ``models/completer.py`` calls."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("fused_pre_stream_embed", "fused_post_head",
                     "pre_stream_embed_plain", "post_head_plain"):
            monkeypatch.setattr(completer, name, self.wrap(name))

    def wrap(self, name):
        real = getattr(completer, name)

        def call(*a, mode="f32", planes=None, **k):
            self.calls.append((name.split("_")[0], mode, planes is not None))
            kw = {"planes": planes} if planes is not None else {}
            return real(*a, mode=mode, **kw, **k)
        return call

    def take(self):
        out, self.calls = self.calls, []
        return out


@pytest.mark.parametrize("prec,mode", [("high", "bf16x3"),
                                       ("default", "bf16")])
def test_model_routes_the_chains_by_mode(monkeypatch, prec, mode):
    """Serving at D = 128, T % 8 == 0 takes the chain kernels in the mode
    with the planes a packed model keeps (int8 serving too); the plain
    route the plain chains in the mode; a length the kernels do not take
    (T % 8 != 0) and the training route the plain chains in the mode with
    their products through ``mode_linear``, as the JAX package's XLA chains
    take the ambient precision there; "highest" the float32 kernels."""
    spy = _Spy(monkeypatch)
    model = KeypointCompleter(D, 1, 2, ff_dim=256, precision=prec,
                              generator=torch.Generator().manual_seed(0))
    model.pack_weights()
    for sw in (model.swiGlu_input_prev, model.swiGlu_filled_prev,
               model.swiGlu_decoded):
        assert f"_chain_planes_{mode}" in sw.__dict__
    x = torch.rand(2, 16, 54, 2)
    m = (torch.rand(2, 16) < 0.3).float()
    fused = [("fused", mode, True)] * 3
    with torch.no_grad():
        model.eval()(x, x, m, m)
        assert spy.take() == fused
        model(x, x, m, m, plain=True)
        assert spy.take() == [("pre", mode, False)] * 2 + [
            ("post", mode, False)]
        model(x[:, :13], x[:, :13], m[:, :13], m[:, :13])
        assert spy.take() == [("pre", mode, False)] * 2 + [
            ("post", mode, False)]
        model.pack_weights("int8")
        model(x, x, m, m)
        assert spy.take() == fused
        model.pack_weights()
    model.train()(x, x, m, m).sum().backward()
    assert spy.take() == [("pre", mode, False)] * 2 + [
        ("post", mode, False)]
    highest = KeypointCompleter(D, 1, 2, ff_dim=256,
                                generator=torch.Generator().manual_seed(0))
    highest.pack_weights()
    assert not any(k.startswith("_chain_planes")
                   for k in highest.swiGlu_decoded.__dict__)
    with torch.no_grad():
        highest.eval()(x, x, m, m)
    assert spy.take() == [("fused", "f32", False)] * 3

"""The port's int8 serving kernels' plain versions against the JAX
package's int8 kernels on the CPU: the int8 dense layer, the int8 FF
sublayer, the merged encoder layer in its int8-FF mode (the Pallas kernels
in interpret mode, as the JAX kernel tests run them), the weight
quantization in both of the JAX package's scale forms, and the Dense
table.  Inputs come from a numpy seed; every tolerance is stated where it
is checked."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from keypoints_interpolation_transformer_tpu.eval import quantize as jq
from keypoints_interpolation_transformer_tpu.models import completer as jc
from keypoints_interpolation_transformer_tpu.ops.pallas import ffn as jffn
from keypoints_interpolation_transformer_tpu.ops.pallas import (
    layer_fused as jlf)
from keypoints_interpolation_transformer_tpu.ops.pallas.int8_matmul import (
    fused_int8_dense as jax_int8_dense)
from keypoints_interpolation_transformer_torch.eval.quantize import (
    quantize_dense_table)
from keypoints_interpolation_transformer_torch.models.convert import (
    params_from_jax)
from keypoints_interpolation_transformer_torch.ops import kernels
from keypoints_interpolation_transformer_torch.ops.kernels.ffn import (
    ffn_supported)
from keypoints_interpolation_transformer_torch.ops.kernels.int8_matmul \
    import int8_product, quantize_weight

# one intra-op thread per test process: the suite runs in parallel
# workers, and more threads only contend for the cores
torch.set_num_threads(1)

# the JAX kernel test's bound on int8 against float (test_pallas_kernels.py)
INT8_VS_FLOAT = 0.05


@contextlib.contextmanager
def _interpret():
    """The Pallas kernels as the JAX kernel tests run them on the CPU."""
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        yield


def _f32(a):
    return np.asarray(a, np.float32)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _torch_q(w, form):
    """The port's quantization of a JAX-layout (in, out) weight."""
    return quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)), form)


@pytest.mark.parametrize("M,K,N,with_bias", [(40, 64, 128, True),
                                             (13, 108, 256, False)])
def test_int8_dense_plain_matches_jax_kernel(rng, M, K, N, with_bias):
    """``int8_dense_plain`` against the JAX ``fused_int8_dense`` in
    interpret mode at rtol = atol = 1e-6 (the JAX test's bound between its
    kernel and its XLA chain), on its shapes and on the Embedding's
    108-wide input."""
    x = _f32(rng.normal(size=(M, K)))
    w = _f32(rng.normal(size=(K, N)) * 0.1)
    b = _f32(rng.normal(size=(N,)) * 0.02) if with_bias else None
    wq, ws = jq._quantize_kernel(jnp.asarray(w))
    with _interpret():
        want = np.asarray(jax_int8_dense(jnp.asarray(x), wq, ws,
                                         None if b is None else
                                         jnp.asarray(b)))
    xla = np.asarray(jq._int8_dense_xla(jnp.asarray(x), wq, ws,
                                        None if b is None else jnp.asarray(b),
                                        jnp.float32))
    twq, tws = _torch_q(w, "dense")
    np.testing.assert_array_equal(twq.numpy(), np.asarray(wq).T)
    np.testing.assert_array_equal(tws.numpy(), np.asarray(ws))
    tx, tb = _t(x, b)
    got = kernels.int8_dense_plain(tx, twq, tws, tb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the XLA chain divides by the row scale where the kernels multiply by
    # its reciprocal: the port's plain version of each agrees with its own
    got_xla = kernels.int8_dense_plain(tx, twq, tws, tb, xla=True).numpy()
    np.testing.assert_allclose(got_xla, xla, rtol=1e-6, atol=1e-6)
    print(f"int8 dense {M}x{K}x{N}: port vs JAX kernel "
          f"{np.abs(got - want).max():.3e}, JAX kernel vs its XLA chain "
          f"{np.abs(want - xla).max():.3e}")
    # the wrapper takes the plain version on the CPU, launching nothing
    kernels.reset_launches()
    np.testing.assert_array_equal(
        kernels.fused_int8_dense(tx, twq, tws, tb).numpy(), got)
    assert kernels.launch_counts()["int8_dense"] == 0


def test_quantize_weight_forms_match_jax(rng):
    """Both scale forms bit for bit: "dense" as ``_quantize_kernel``, "ff"
    as the FF kernel's and the merged layer's (``layer_fused._quant_w``);
    each dequantizes to within half a scale step of the weight, as
    ``test_distributed_units.py`` holds the Dense table."""
    w = _f32(rng.standard_normal((48, 20)) * 3.0)
    w[:, 3] = 0.0  # an all-zero column takes the 1e-12 floor
    for form, (q, s) in (("dense", jq._quantize_kernel(jnp.asarray(w))),
                         ("ff", jlf._quant_w(jnp.asarray(w)))):
        tq, ts = _torch_q(w, form)
        assert tq.dtype == torch.int8 and tq.shape == (20, 48)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q).T)
        np.testing.assert_allclose(ts.numpy(), np.asarray(s).reshape(-1),
                                   rtol=1e-7, atol=0)
        deq = tq.numpy().astype(np.float32) * ts.numpy()[:, None]
        assert np.all(np.abs(deq - w.T) <= ts.numpy()[:, None] * 0.5 + 1e-7)
    with pytest.raises(ValueError, match="scale form"):
        quantize_weight(torch.zeros(2, 2), "int4")


def test_dense_table_matches_jax_table():
    """``quantize_dense_table`` of the converted state dict against the JAX
    ``quantize_dense_table`` of the same parameters: the JAX table's int8
    kernels and scales, carried through the same converter, are the port's
    weights and scales (to 1e-7), for every 2-D Linear weight."""
    model = jc.KeypointCompleter(hidden_dim=32, num_layers=1, num_heads=4,
                                 ff_dim=64)
    x = jnp.zeros((1, 8, 54, 2))
    params = jax.device_get(model.init(jax.random.key(3), x, x))["params"]
    table = jq.quantize_dense_table({"params": params})

    def swap(tree, path):
        if isinstance(tree, dict):
            if "/".join(path) in table:
                q, s = table["/".join(path)]
                return {"kernel": np.asarray(q, np.float32),
                        "bias": np.asarray(s)}
            return {k: swap(v, path + (k,)) for k, v in tree.items()}
        return tree

    want = params_from_jax(swap(params, ()))
    got = quantize_dense_table(params_from_jax(params))
    assert set(got) == {n for n, w in want.items()
                        if n.endswith("weight") and w.ndim == 2}
    # q / k / v share one weight in each of the three attention blocks
    assert len(got) == len(table) - 2 * 3
    for name, (q, s) in got.items():
        np.testing.assert_array_equal(q.numpy().astype(np.float32),
                                      want[name])
        np.testing.assert_allclose(s.numpy(),
                                   want[name[:-len("weight")] + "bias"],
                                   rtol=1e-7, atol=0)


def _ff_operands(rng, D, FF, rows=64):
    r = _f32(rng.normal(size=(rows, D)))
    w1 = _f32(rng.normal(size=(D, FF)) * 0.05)
    b1 = _f32(rng.normal(size=(FF,)) * 0.01)
    w2 = _f32(rng.normal(size=(FF, D)) * 0.05)
    b2 = _f32(rng.normal(size=(D,)) * 0.01)
    norms = [_f32(s + 0.1 * rng.normal(size=(D,))) for s in (1, 0, 1, 0)]
    return r, (w1, b1, w2, b2), norms


def _port_ff_int8(w1, b1, w2, b2, form):
    q1, s1 = _torch_q(w1, form)
    q2, s2 = _torch_q(w2, form)
    return q1, s1, torch.from_numpy(b1), q2, s2, torch.from_numpy(b2)


@pytest.mark.parametrize("pre_ln", [True, False])
def test_ffn_int8_plain_matches_jax_kernel(rng, pre_ln):
    """``ffn_int8_plain`` against ``fused_ffn(..., pre_ln, True)`` in
    interpret mode on the JAX kernel test's shapes (D=128, FF=256, 64
    rows), within 1e-4 of the output's scale; both within 0.05 of the float
    FF sublayer, as that test asserts.  The Pallas kernel's GELU is a
    rational erf (< 4e-7 off erf), so a value of h at a rounding boundary
    may quantize one step the other way; the 1e-4 covers one such step
    (a step of h moves y by about |w2| / 127 of the row's scale)."""
    D, FF = 128, 256
    r, (w1, b1, w2, b2), norms = _ff_operands(rng, D, FF)
    j = [jnp.asarray(a) for a in (r, w1, b1, w2, b2, *norms)]
    with _interpret():
        want = np.asarray(jffn.fused_ffn(*j, pre_ln, True))
    ref = np.asarray(jffn.ffn_reference(*j, pre_ln))
    w = _port_ff_int8(w1, b1, w2, b2, "ff")
    got = kernels.ffn_int8_plain(torch.from_numpy(r), *w,
                                 *_t(*norms), pre_ln).numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    print(f"ffn int8 pre_ln={pre_ln}: port vs JAX kernel {err:.3e} (scale "
          f"{scale:.3f}), int8 vs float {np.abs(got - ref).max():.3e}")
    assert err <= 1e-4 * scale
    assert np.abs(got - ref).max() < INT8_VS_FLOAT
    kernels.reset_launches()
    np.testing.assert_array_equal(
        kernels.fused_ffn_int8(torch.from_numpy(r), *w, *_t(*norms),
                               pre_ln).numpy(), got)
    assert kernels.launch_counts()["ffn_int8"] == 0


def test_ffn_int8_over_budget_takes_the_xla_chain(rng):
    """Above the FF kernel's weight budget (2.5 bytes per D x FF weight
    over 8 MiB) the JAX ``fused_ffn`` leaves its kernel for the XLA int8
    chain (the Dense table's scale form, ``_int8_dense_xla``); the port's
    FF sublayer copies that route, within 1e-4 of the output's scale."""
    from keypoints_interpolation_transformer_torch.models.layers import (
        EncoderLayer)
    D, FF = 128, 26240
    assert ffn_supported(D, 26208, True) and not ffn_supported(D, FF, True)
    assert ffn_supported(512, 2048) and not ffn_supported(512, 2049)
    r, (w1, b1, w2, b2), norms = _ff_operands(rng, D, FF, rows=16)
    j = [jnp.asarray(a) for a in (r, w1, b1, w2, b2, *norms)]
    want = np.asarray(jffn.fused_ffn(*j, True, True))  # no kernel: XLA
    layer = EncoderLayer(D, 4, FF)
    with torch.no_grad():
        layer.linear1.weight.copy_(torch.from_numpy(w1.T))
        layer.linear1.bias.copy_(torch.from_numpy(b1))
        layer.linear2.weight.copy_(torch.from_numpy(w2.T))
        layer.linear2.bias.copy_(torch.from_numpy(b2))
        for p, v in zip((layer.norm1.weight, layer.norm1.bias,
                         layer.norm2.weight, layer.norm2.bias), norms):
            p.copy_(torch.from_numpy(v))
        got = layer.ff_sublayer(torch.from_numpy(r), layer.norm1,
                                layer.norm2, int8=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


B, T, D, H, FF = 2, 16, 32, 4, 64


@pytest.mark.parametrize("flags,kind", [("plain", "repeat-inc"),
                                        ("cycle", "all")])
def test_encoder_layer_int8_plain_matches_jax(rng, flags, kind):
    """``encoder_layer_int8_plain`` against the JAX ``fused_encoder_layer(
    ..., ff_int8=True, attn_int8=False)`` in interpret mode at B=2, T=16,
    H=4, dh=8, FF=64, with a padded row, within 1e-4 (one quantization
    step of h, as above)."""
    x = _f32(rng.normal(size=(B, T, D)))
    attn = [(_f32(rng.normal(size=(D, D)) * 0.1),
             _f32(rng.normal(size=(D,)) * 0.05)) for _ in range(4)]
    _, (w1, b1, w2, b2), norms = _ff_operands(rng, D, FF)
    mask = np.ones((B, T), np.float32) if flags == "cycle" else \
        (rng.random((B, T)) < 0.3).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[1, T - 5:] = 0.0
    jparams = tuple(jnp.asarray(a) for a in
                    (*[a for pair in attn for a in pair], w1, b1, w2, b2,
                     *norms))
    with _interpret():
        want = np.asarray(jlf.fused_encoder_layer(
            jnp.asarray(x), jparams, (jnp.asarray(mask), jnp.asarray(valid)),
            kind, True, H, True, False))
        ref = np.asarray(jlf.fused_encoder_layer(
            jnp.asarray(x), jparams, (jnp.asarray(mask), jnp.asarray(valid)),
            kind, True, H))
    wqkv = np.concatenate([w for w, _ in attn[:3]], 1)
    bqkv = np.concatenate([b for _, b in attn[:3]])
    args = (*_t(x, wqkv, bqkv, *attn[3]), *_port_ff_int8(w1, b1, w2, b2, "ff"),
            *_t(*norms, mask, valid), kind, True, H)
    got = kernels.encoder_layer_int8_plain(*args).numpy()
    err = float(np.abs(got - want).max())
    print(f"enc_layer int8 {flags}: port vs JAX kernel {err:.3e}, int8 vs "
          f"float {np.abs(got - ref).max():.3e}")
    assert err <= 1e-4
    assert np.abs(got - ref).max() < INT8_VS_FLOAT
    kernels.reset_launches()
    np.testing.assert_array_equal(
        kernels.fused_encoder_layer_int8(*args).numpy(), got)
    assert kernels.launch_counts()["enc_layer_int8"] == 0


def test_int8_sums_are_exact_beyond_float32():
    """The plain versions' int8 products: 2048 * 127^2 is above 2^24, where
    a float32 sum of the int8 values stops being exact; the float64 sum is
    the int32 accumulator's value."""
    K = 2048
    xq = torch.full((3, K), 127.0)
    xq[1, ::2] = -127.0
    xq[2, 0] = 1.0
    wq = torch.full((2, K), 127, dtype=torch.int8)
    wq[1, 1] = -1
    want = (xq.to(torch.int64) @ wq.to(torch.int64).t()).to(torch.float32)
    assert int(want.abs().max()) > 2 ** 24
    torch.testing.assert_close(int8_product(xq, wq), want, rtol=0, atol=0)

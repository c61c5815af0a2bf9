"""Whole transformer layers in one wrapper call each (one kernel launch in
float32): the encoder layer and the decoder layer, for serving.

Kernels (``csrc/layer_fused.cu`` in float32, ``csrc/layer_modes.cu`` in
the precision modes), replacing
``keypoints_interpolation_transformer_tpu/ops/pallas/layer_fused.py``:

  * ``fused_encoder_layer`` <- ``_enc_kernel``: one post-LN torch encoder
    layer,

        r = x + MHA(x);  x1 = LN1(r);  y = LN2(x1 + gelu(x1 W1 + b1) W2 + b2)

  * ``fused_encoder_layer_int8`` <- ``_enc_kernel`` with ``ff_int8``: the
    same layer with its FF products int8 x int8 (per-row activation
    scales, "ff"-form weight scales), its attention in the mode;
  * ``fused_decoder_layer`` <- ``_dec_kernel``: self-attention + LN1,
    cross-attention and, with ``ff``, the FF tail,

        x1 = LN1(x + SA(x));  r = x1 + CA(x1, memory)
        y = LN3(x2 + FF(x2)), x2 = LN2(r)      (ff given; else y = r)

The attention biases are built in-kernel from the 1-D (B, T) masks, as the
sublayer kernels build them (``attn_sublayer.bias_from_masks``).  One
thread-block cluster of 1 to 8 blocks per video (``cluster_size``) walks
the phases of the layer in row tiles (``row_tile``), the FF chunks of a
tile split over several blocks where the cluster has them to spare
(``ff_parts``); the intermediates live in scratch the wrapper allocates
(``scratch_floats``) and never return to PyTorch between the sublayers.
Bound on an H100 by float32 FFMA work (90 GFLOP per encoder layer at
B = 256, T = 128, D = 256, FF = 2048); see the source notes in
``csrc/layer_fused.cu`` and ``csrc/sgemm.cuh``.

In the modes "bf16x3" ("high") and "bf16" (``mode``; ``precision.py``) both
wrappers compute what the TPU kernels compute there: log2(e) / sqrt(dh)
folded into Wq and bq before the split, every product on the bf16 parts,
the softmax normalized before its probabilities are rounded to one bf16
(``attn_sublayer._sublayer_mode_plain``, ``ffn.ffn_plain``).  Their kernels
run on the bf16 tensor cores (``csrc/layer_modes.cu``: the projections on
``csrc/tc_gemm.cuh``'s wgmma product, the attention core on mma.sync, the
FF tail on the FF sublayer's own mode kernel, ``csrc/ffn_tc.cuh``), a
short sequence of launches a call whose grids spread a video over the
card themselves, so ``cluster`` is not read there; the weights arrive as
bf16 planes (``attn_weight_planes`` and ``ffn.ff_weight_planes``), built
once per packed model, or here from the float32 weights.  The int8 encoder
layer in a mode runs the same attention launches, then the int8 FF
sublayer's own kernel (``csrc/int8.cuh``'s ``ffn_int8_kernel``: LN1, the
``__dp4a`` products with their GELU, LN2), as ``_enc_kernel`` keeps its
``ff_int8`` tail whatever the ambient mode.

The routing predicates are the port's copies of the JAX package's rules
(``fused_layer_supported``, ``decoder_full_supported``, the sublayer
kernel's ``fused_attn_sublayer_supported`` and the model's
``_use_sublayer_kernel``), so a configuration runs the counterparts of the
same TPU kernels in both packages.

Weights in the Flax layout, as ``MultiHeadAttention.packed()`` and
``packed_linear`` build them.  A wrapper takes its plain version for CPU
tensors and launches its kernel for CUDA tensors (or raises);
``launches`` counts the calls that launched, per mode for the two float
wrappers (``launches[mode]``).
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .attn_sublayer import (_check_config, _mode_attn, attn_sublayer_plain,
                            attn_weight_planes)
from .ffn import (_FF_STEP_TC, _PASSES, _check_planes, check_int8_ff,
                  ff_kernel_width, ff_weight_planes, ffn_int8_plain, ffn_plain,
                  pad_int8_ff, tc_parts)
from .precision import MODES, check_mode
from .widths import cut, kernel_width, pad, pad_blocks, row_tile

# one letter per C argument, the stream last: p pointer, i int
_SIGS = {"kit_enc_layer": "p" + "i" * 8 + "p" * 14 + "ii" + "p" * 3,
         "kit_enc_layer_int8": "p" + "i" * 8 + "p" * 16 + "ii" + "p" * 4,
         "kit_dec_layer": "pp" + "i" * 8 + "p" * 20 + "ii" + "pp" + "ii"
                          + "p" * 3}
_MODE_SIGS = {"kit_enc_layer_tc": "ip" + "i" * 7 + "p" * 18 + "ii" + "p" * 5,
              "kit_enc_layer_int8_tc": "ip" + "i" * 6 + "p" * 18 + "ii"
                                       + "p" * 5,
              "kit_dec_layer_tc": "ipp" + "i" * 7 + "p" * 26 + "ii" + "pp"
                                  + "ii" + "p" * 5}
_MAX_CLUSTER = 8  # the portable thread-block cluster size

_MERGED_MAX_T = 256   # the JAX package's full-T residency cap
_SUBLAYER_MAX_T = 512


def sublayer_supported(T: int, D: int) -> bool:
    """The JAX ``fused_attn_sublayer_supported``: T <= 512, T % 8 == 0,
    D <= 512."""
    return T <= _SUBLAYER_MAX_T and T % 8 == 0 and D <= 512


def use_sublayer_kernel(fuse: bool, T: int, D: int) -> bool:
    """The JAX ``_use_sublayer_kernel``: the attention-sublayer kernel (and
    the merged kernels built on it) with sublayer fusion on and a length
    it takes; per-op attention otherwise."""
    return fuse and sublayer_supported(T, D)


def fused_layer_supported(T: int, D: int, ff_dim: int) -> bool:
    """The JAX ``fused_layer_supported``: T <= 256, T % 8 == 0 and the
    encoder layer's weights (bf16x3-stacked, 6 bytes each) within 8 MB."""
    wbytes = 6 * (4 * D * D + 2 * D * ff_dim)
    return T <= _MERGED_MAX_T and T % 8 == 0 and wbytes <= (8 << 20)


def decoder_full_supported(T: int, D: int, ff_dim: int) -> bool:
    """The JAX ``decoder_full_supported``: the decoder layer with its FF
    tail, T <= 256, T % 8 == 0 and its weights within 10 MB."""
    wbytes = 6 * (8 * D * D + 2 * D * ff_dim)
    return T <= _MERGED_MAX_T and T % 8 == 0 and wbytes <= (10 << 20)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cluster_size(B: int, device: torch.device) -> int:
    """Blocks per video (the kernel's thread-block cluster): about one
    block per SM of the card over the batch, from 1 to 8.  On an H100 (132
    SMs) that is 1 at B = 256, 2 at B = 64 and 8 at B <= 16, each the
    fastest of 1, 2, 4 and 8 that `chip_smoke.py --sweep` measures at
    T = 128; batches between take every size from 2 to 7, and
    `chip_smoke.py` holds each size against the plain versions."""
    return max(1, min(_MAX_CLUSTER, _sm_count(device.index or 0) // B))


def ff_parts(T: int, D: int, FF: int, cluster: int) -> int:
    """Blocks that share one row tile's FF chunks (``csrc/layer_fused.cu``,
    the FF split): as many as the cluster has for each of the video's row
    tiles, at most one per D-wide chunk of the FF width; 1 (no split) when
    a tile has fewer than two blocks or there is no FF tail (FF = 0).  The
    int8 encoder layer takes 1: its tail works on whole tiles."""
    if FF == 0:
        return 1
    tiles = -(-T // row_tile(D))
    return max(1, min(cluster // tiles, -(-FF // D)))


def scratch_floats(B: int, T: int, D: int, decoder: bool, parts: int) -> int:
    """The layer kernels' per-call scratch (``scratch_per_video`` of
    ``csrc/layer_fused.cu``, times B): q / k / v and the attention output
    (4 T D a video; the decoder's 8 T D add the memory's k / v, x1 and the
    cross q), and with the FF split one T x D partial sum per part."""
    base = 8 if decoder else 4
    return B * T * D * (base + (parts if parts > 1 else 0))


def mode_scratch(B: int, T: int, D: int, decoder: bool, mode: str,
                 parts: int):
    """The mode kernels' per-call scratch (``csrc/layer_modes.cu``): bf16
    planes (x, q / k / v and the attention output, 5 B T D a plane; the
    decoder's 10 add the memory, its cross k / v, x1 and the cross q; two
    planes in "bf16x3"), floats (the out-projection's sum; the decoder's 3
    B T D add x1 and the pre-FF sum) and the FF split's parts x B T x D
    floats (none with one part): (bf16 elements, floats, split floats)."""
    planes = 2 if mode == "bf16x3" else 1
    MD = B * T * D
    return ((10 if decoder else 5) * planes * MD, (3 if decoder else 1) * MD,
            parts * MD if parts > 1 else 0)


def encoder_layer_plain(x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, g1, be1, g2,
                        be2, mask, valid, kind: str, add_keypad: bool,
                        heads: int, mode: str = "f32"):
    """Plain PyTorch version of ``fused_encoder_layer``: the attention
    sublayer (no LayerNorm) then the FF sublayer with LN1 before it, both
    in ``mode``."""
    r = attn_sublayer_plain(x, None, wqkv, bqkv, wo, bo, None, None, mask,
                            valid, kind, add_keypad, heads, mode)
    return ffn_plain(r, w1, b1, w2, b2, g1, be1, g2, be2, pre_ln=True,
                     mode=mode)


def encoder_layer_int8_plain(x, wqkv, bqkv, wo, bo, w1q, w1s, b1, w2q, w2s,
                             b2, g1, be1, g2, be2, mask, valid, kind: str,
                             add_keypad: bool, heads: int, mode: str = "f32"):
    """Plain PyTorch version of ``fused_encoder_layer_int8``: the attention
    sublayer in ``mode`` (the TPU kernel's ``_prep_w`` weights, q's scale
    folded before the split), then the int8 FF sublayer with LN1 before it,
    in every mode as ``_enc_kernel``'s ``ff_int8`` tail computes it."""
    r = attn_sublayer_plain(x, None, wqkv, bqkv, wo, bo, None, None, mask,
                            valid, kind, add_keypad, heads, mode)
    return ffn_int8_plain(r, w1q, w1s, b1, w2q, w2s, b2, g1, be1, g2, be2)


def decoder_layer_plain(x, memory, swqkv, sbqkv, swo, sbo, cwqkv, cbqkv, cwo,
                        cbo, g1, be1, ff, smask, svalid, cmask, cvalid,
                        skind: str, sadd_keypad: bool, ckind: str,
                        cadd_keypad: bool, heads: int, mode: str = "f32"):
    """Plain PyTorch version of ``fused_decoder_layer``, every sublayer in
    ``mode``."""
    x1 = attn_sublayer_plain(x, None, swqkv, sbqkv, swo, sbo, g1, be1, smask,
                             svalid, skind, sadd_keypad, heads, mode)
    r = attn_sublayer_plain(x1, memory, cwqkv, cbqkv, cwo, cbo, None, None,
                            cmask, cvalid, ckind, cadd_keypad, heads, mode)
    if ff is None:
        return r
    return ffn_plain(r, *ff, pre_ln=True, mode=mode)


_ATTN = ("wqkv", "bqkv", "wo", "bo")
_FF = ("w1", "b1", "w2", "b2", "g_in", "be_in", "g_out", "be_out")


def _check_weights(where, x, prefix, names, tensors):
    """dtype, device, contiguity, shapes and alignment of one sublayer's
    weights (attention: ``_ATTN``; FF: ``_FF``); returns the FF width."""
    D = x.shape[-1]
    named = {prefix + n: t for n, t in zip(names, tensors)}
    _build.check_tensors(where, x.device, **named)
    FF = tensors[0].shape[1] if names is _FF else 0
    shapes = ((D, 3 * D), (3 * D,), (D, D), (D,)) if names is _ATTN else \
        ((D, FF), (FF,), (FF, D), (D,)) + ((D,),) * 4
    for (name, t), shape in zip(named.items(), shapes):
        _build.check_shape(where, name, t, shape)
    _build.check_aligned(where, **{prefix + k: named[prefix + k]
                                  for k in ("wqkv", "wo", "w1", "w2")
                                  if prefix + k in named})
    return FF


def _check_masks(where, x, mask, valid, kind, add_keypad, heads):
    """The mask operands as ``attn_sublayer`` checks them; returns ``mask``
    (None where the kind does not read it)."""
    mask = _check_config(where, x, mask, kind, add_keypad, heads)
    B, T, _ = x.shape
    _build.check_tensors(where, x.device, mask=mask, valid=valid)
    _build.check_shape(where, "mask", mask, (B, T))
    _build.check_shape(where, "valid", valid, (B, T))
    return mask


def fused_encoder_layer(x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, g1, be1, g2,
                        be2, mask, valid, kind: str = "repeat-inc",
                        add_keypad: bool = False, heads: int = 8,
                        cluster: int | None = None, mode: str = "f32",
                        planes=None):
    """x (B, T, D) -> y (B, T, D): one encoder layer.  ``mask`` is read
    only for "repeat-inc" or ``add_keypad``; ``valid`` None means every key
    is real.  ``cluster``, blocks per video from 1 to 8, defaults to
    ``cluster_size``; it changes the result only through the order in
    which the FF split (``ff_parts``) adds the FF sums.  In the modes
    "bf16x3" and "bf16" the kernel reads the weights as bf16 planes:
    ``planes`` = (``attn_weight_planes``, ``ffn.ff_weight_planes``), or
    split here from the float32 weights."""
    check_mode(mode)
    if x.device.type == "cpu":
        return encoder_layer_plain(x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, g1,
                                   be1, g2, be2, mask, valid, kind,
                                   add_keypad, heads, mode)
    attn, ff = (wqkv, bqkv, wo, bo), (w1, b1, w2, b2, g1, be1, g2, be2)
    if mode == "f32":
        y = _launch_encoder(x, attn, ff, mask, valid, kind, add_keypad, heads,
                            cluster)
    else:
        y = _launch_encoder_mode(x, attn, ff, mask, valid, kind, add_keypad,
                                 heads, cluster, mode, planes)
    fused_encoder_layer.launches[mode] += 1
    return y


fused_encoder_layer.launches = dict.fromkeys(MODES, 0)


def _cluster(where, B, device, cluster):
    """The blocks per video: ``cluster`` if given (1 to 8), else
    ``cluster_size``."""
    if cluster is None:
        return cluster_size(B, device)
    if not 1 <= cluster <= _MAX_CLUSTER:
        raise ValueError(f"{where}: cluster must be 1 to {_MAX_CLUSTER}, "
                         f"got {cluster}")
    return cluster


def _pad_attn(attn, n, D):
    """One attention sublayer's weights (``_ATTN``) zero-padded from the
    model's width n to the kernel width D (``widths``)."""
    wqkv, bqkv, wo, bo = attn
    return (pad(pad_blocks(wqkv, n, D, 1), D, 3 * D),
            pad_blocks(bqkv, n, D, 0), pad(wo, D, D), pad(bo, D))


def _pad_ff(ff, n, D):
    """The FF tail's weights (``_FF``) zero-padded to the kernel width D and
    FF to a multiple of 4."""
    w1, b1, w2, b2, *norms = ff
    F4 = ff_kernel_width(w1.shape[1])
    return (pad(w1, D, F4), pad(b1, F4), pad(w2, F4, D), pad(b2, D),
            *(pad(t, D) for t in norms))


def _scratch(floats, n, D, device):
    """The layer kernels' scratch; zero where n < D, since the padded
    columns of the attention output are not written and the padded out-
    projection reads them as 0 * a."""
    return (torch.empty if n == D else torch.zeros)(floats, device=device)


def _int8_ff(where, x, ff, D):
    """The int8 FF tail's operands (``fused_encoder_layer_int8``'s w1q ..
    be2), checked and zero-padded to the kernel width D and FF to a
    multiple of 4: (F4, operands)."""
    n = x.shape[-1]
    w1q, w1s, b1, w2q, w2s, b2, *norms = ff
    _build.check_tensors(where, x.device, w1s=w1s, b1=b1, w2s=w2s, b2=b2,
                         **dict(zip(_FF[4:], norms)))
    FF = check_int8_ff(where, n, w1q, w1s, b1, w2q, w2s, b2)
    for name, t in zip(_FF[4:], norms):
        _build.check_shape(where, name, t, (n,))
    F4 = ff_kernel_width(FF)
    return F4, (*pad_int8_ff(w1q, w1s, b1, w2q, w2s, b2, D, F4),
                *(pad(t, D) for t in norms))


def _launch_encoder(x, attn, ff, mask, valid, kind, add_keypad, heads,
                    cluster, int8=False):
    """The merged encoder layer at the kernel width, the operands
    zero-padded from the model's width (``widths``); with ``int8`` the FF
    weights are ``fused_encoder_layer_int8``'s."""
    where = "fused_encoder_layer_int8" if int8 else "fused_encoder_layer"
    _build.check_tensors(where, x.device, x=x)
    _check_weights(where, x, "", _ATTN, attn)
    mask = _check_masks(where, x, mask, valid, kind, add_keypad, heads)
    B, T, n = x.shape
    D = kernel_width(where, n)
    cl = _cluster(where, B, x.device, cluster)
    attn = _pad_attn(attn, n, D)
    if int8:
        F4, ff = _int8_ff(where, x, ff, D)
    else:
        FF = _check_weights(where, x, "", _FF, ff)
        F4 = ff_kernel_width(FF)
        ff = _pad_ff(ff, n, D)
    x = pad(x, D)
    y = torch.empty_like(x)
    parts = 1 if int8 else ff_parts(T, D, F4, cl)
    scratch = _scratch(scratch_floats(B, T, D, False, parts), n, D, x.device)
    lib = _build.bind("layer_fused", _SIGS)
    if int8:  # each row's GELU output over the whole FF width
        h = torch.empty(B * T * F4, device=x.device)
        _build.call(lib, "kit_enc_layer_int8", x.device, x, B, T, D, n,
                    heads, F4, cl, parts, *attn, *ff, mask, valid,
                    int(kind == "repeat-inc"), int(add_keypad), y, scratch, h)
    else:
        _build.call(lib, "kit_enc_layer", x.device, x, B, T, D, n, heads, F4,
                    cl, parts, *attn, *ff, mask, valid,
                    int(kind == "repeat-inc"), int(add_keypad), y, scratch)
    return cut(y, n)


def fused_encoder_layer_int8(x, wqkv, bqkv, wo, bo, w1q, w1s, b1, w2q, w2s,
                             b2, g1, be1, g2, be2, mask, valid,
                             kind: str = "repeat-inc",
                             add_keypad: bool = False, heads: int = 8,
                             cluster: int | None = None, mode: str = "f32",
                             planes=None):
    """``fused_encoder_layer`` with its FF tail int8 (``_enc_kernel`` in its
    ``ff_int8`` mode): w1q (FF, D) and w2q (D, FF) int8 in torch's layout
    with their "ff"-form scales (``int8_matmul.quantize_weight``).  The
    attention runs in ``mode``: float32, or in "bf16x3" / "bf16" on
    ``csrc/layer_modes.cu`` from the attention's bf16 planes (``planes``,
    ``attn_weight_planes``, or split here from the float32 weights), as the
    TPU kernel takes the ambient mode whatever the FF does."""
    check_mode(mode)
    if x.device.type == "cpu":
        return encoder_layer_int8_plain(x, wqkv, bqkv, wo, bo, w1q, w1s, b1,
                                        w2q, w2s, b2, g1, be1, g2, be2, mask,
                                        valid, kind, add_keypad, heads, mode)
    ff = (w1q, w1s, b1, w2q, w2s, b2, g1, be1, g2, be2)
    if mode == "f32":
        y = _launch_encoder(x, (wqkv, bqkv, wo, bo), ff, mask, valid, kind,
                            add_keypad, heads, cluster, int8=True)
    else:
        y = _launch_encoder_int8_mode(x, (wqkv, bqkv, wo, bo), ff, mask,
                                      valid, kind, add_keypad, heads,
                                      cluster, mode, planes)
    fused_encoder_layer_int8.launches[mode] += 1
    return y


fused_encoder_layer_int8.launches = dict.fromkeys(MODES, 0)


def fused_decoder_layer(x, memory, swqkv, sbqkv, swo, sbo, cwqkv, cbqkv, cwo,
                        cbo, g1, be1, ff, smask, svalid, cmask, cvalid,
                        skind: str = "repeat-inc", sadd_keypad: bool = False,
                        ckind: str = "all", cadd_keypad: bool = False,
                        heads: int = 8, cluster: int | None = None,
                        mode: str = "f32", planes=None):
    """x, memory (B, T, D) -> y (B, T, D): one decoder layer.  ``ff`` is
    None (no FF tail: y = x1 + CA(x1, memory)) or (w1, b1, w2, b2, g2, be2,
    g3, be3).  smask/svalid build the self-attention bias, cmask/cvalid the
    cross-attention one, as ``fused_encoder_layer``'s masks do; ``cluster``
    as there.  ``mode`` as ``fused_encoder_layer`` takes it, ``planes`` =
    (the self and the cross ``attn_weight_planes``, the FF tail's
    ``ffn.ff_weight_planes`` or None)."""
    check_mode(mode)
    if x.device.type == "cpu":
        return decoder_layer_plain(x, memory, swqkv, sbqkv, swo, sbo, cwqkv,
                                   cbqkv, cwo, cbo, g1, be1, ff, smask,
                                   svalid, cmask, cvalid, skind, sadd_keypad,
                                   ckind, cadd_keypad, heads, mode)
    launch = _launch_decoder if mode == "f32" else functools.partial(
        _launch_decoder_mode, mode=mode, planes=planes)
    y = launch(x, memory, (swqkv, sbqkv, swo, sbo), (cwqkv, cbqkv, cwo, cbo),
               g1, be1, ff, smask, svalid, cmask, cvalid, skind, sadd_keypad,
               ckind, cadd_keypad, heads, cluster)
    fused_decoder_layer.launches[mode] += 1
    return y


fused_decoder_layer.launches = dict.fromkeys(MODES, 0)


def _launch_decoder(x, memory, sattn, cattn, g1, be1, ff, smask, svalid,
                    cmask, cvalid, skind, sadd_keypad, ckind, cadd_keypad,
                    heads, cluster):
    where = "fused_decoder_layer"
    B, T, D = x.shape
    _build.check_tensors(where, x.device, x=x, memory=memory, g1=g1, be1=be1)
    _build.check_shape(where, "memory", memory, (B, T, D))
    _build.check_shape(where, "g1", g1, (D,))
    _build.check_shape(where, "be1", be1, (D,))
    _build.check_aligned(where, memory=memory)
    _check_weights(where, x, "self ", _ATTN, sattn)
    _check_weights(where, x, "cross ", _ATTN, cattn)
    FF = 0 if ff is None else _check_weights(where, x, "", _FF, ff)
    smask = _check_masks(where, x, smask, svalid, skind, sadd_keypad, heads)
    cmask = _check_masks(where, x, cmask, cvalid, ckind, cadd_keypad, heads)
    cl = _cluster(where, B, x.device, cluster)
    # at the kernel width, the operands zero-padded (``widths``)
    n, D = D, kernel_width(where, D)
    sattn, cattn = _pad_attn(sattn, n, D), _pad_attn(cattn, n, D)
    ff = (None,) * 8 if ff is None else _pad_ff(ff, n, D)
    FF = 0 if ff[0] is None else ff[0].shape[1]
    x, memory, g1, be1 = (pad(t, D) for t in (x, memory, g1, be1))
    y = torch.empty_like(x)
    parts = ff_parts(T, D, FF, cl)
    scratch = _scratch(scratch_floats(B, T, D, True, parts), n, D, x.device)
    lib = _build.bind("layer_fused", _SIGS)
    _build.call(lib, "kit_dec_layer", x.device, x, memory, B, T, D, n, heads,
                FF, cl, parts, *sattn, *cattn, g1, be1, *ff, smask, svalid,
                int(skind == "repeat-inc"), int(sadd_keypad), cmask, cvalid,
                int(ckind == "repeat-inc"), int(cadd_keypad), y, scratch)
    return cut(y, n)


# ---- the precision modes "bf16x3" and "bf16" (csrc/layer_modes.cu) --------


def _pad_ff_planes(planes, D, F16):
    """``ffn.ff_weight_planes`` (W1^T (FF, n), W2^T (n, FF)) zero-padded to
    the kernel width D and FF to F16."""
    w1h, w1l, w2h, w2l = planes
    return (*(None if t is None else pad(t, F16, D) for t in (w1h, w1l)),
            *(None if t is None else pad(t, D, F16) for t in (w2h, w2l)))


def _mode_ff(where, x, ff, ff_planes, mode, D):
    """The FF tail's operands in a mode at the kernel width D: its planes,
    checked and padded, and the vectors padded; (FF16, (w1h, w1l, b1, w2h,
    w2l, b2, g_in, be_in, g_out, be_out)) or (0, None) without a tail."""
    if ff is None:
        return 0, None
    w1, b1, w2, b2, *norms = ff
    n, FF = w1.shape
    _build.check_tensors(where, x.device, b1=b1, b2=b2,
                         **dict(zip(_FF[4:], norms)))
    for name, t, shape in (("w1", w1, (n, FF)), ("b1", b1, (FF,)),
                           ("w2", w2, (FF, n)), ("b2", b2, (n,)),
                           *((k, t, (n,)) for k, t in zip(_FF[4:], norms))):
        _build.check_shape(where, name, t, shape)
    if ff_planes is None:
        ff_planes = ff_weight_planes(w1.t(), w2.t(), mode)
    _check_planes(where, x.device, mode, ff_planes, n, FF)
    F16 = ff_kernel_width(FF, _FF_STEP_TC)
    w1h, w1l, w2h, w2l = _pad_ff_planes(ff_planes, D, F16)
    return F16, (w1h, w1l, pad(b1, F16), w2h, w2l,
                 *(pad(t, D) for t in (b2, *norms)))


def _mode_buffers(B, T, D, decoder, mode, parts, device):
    """The mode kernels' scratch (``mode_scratch``): bf16 planes, floats
    and the FF split's parts (None without it)."""
    nb, nf, ns = mode_scratch(B, T, D, decoder, mode, parts)
    return (torch.empty(nb, dtype=torch.bfloat16, device=device),
            torch.empty(nf, device=device),
            torch.empty(ns, device=device) if ns else None)


def _launch_encoder_mode(x, attn, ff, mask, valid, kind, add_keypad, heads,
                         cluster, mode, planes):
    """The merged encoder layer in ``mode`` at the kernel width, the
    operands zero-padded from the model's width (``widths``)."""
    where = "fused_encoder_layer"
    _build.check_tensors(where, x.device, x=x)
    _build.check_aligned(where, x=x, bo=attn[3])
    mask = _check_masks(where, x, mask, valid, kind, add_keypad, heads)
    _cluster(where, x.shape[0], x.device, cluster)  # checked, not read
    B, T, n = x.shape
    D = kernel_width(where, n)
    aplanes, fplanes = (None, None) if planes is None else planes
    at = _mode_attn(where, x, attn, aplanes, heads, mode, D)
    F16, ffw = _mode_ff(where, x, ff, fplanes, mode, D)
    x = pad(x, D)
    y = torch.empty_like(x)
    parts = tc_parts(B * T, D, F16)
    buf, fs, partial = _mode_buffers(B, T, D, False, mode, parts, x.device)
    lib = _build.bind("layer_modes", _MODE_SIGS)
    _build.call(lib, "kit_enc_layer_tc", x.device, _PASSES[mode], x, B, T, D,
                n, heads, F16, parts, *at, *ffw, mask, valid,
                int(kind == "repeat-inc"), int(add_keypad), y, buf, fs,
                partial)
    return cut(y, n)


def _launch_encoder_int8_mode(x, attn, ff, mask, valid, kind, add_keypad,
                              heads, cluster, mode, planes):
    """The int8 route's merged encoder layer in ``mode`` at the kernel
    width: the attention half of ``_launch_encoder_mode``'s layer, then the
    int8 FF tail of ``kit_ffn_int8``."""
    where = "fused_encoder_layer_int8"
    _build.check_tensors(where, x.device, x=x)
    _build.check_aligned(where, x=x, bo=attn[3])
    mask = _check_masks(where, x, mask, valid, kind, add_keypad, heads)
    _cluster(where, x.shape[0], x.device, cluster)  # checked, not read
    B, T, n = x.shape
    D = kernel_width(where, n)
    at = _mode_attn(where, x, attn, planes, heads, mode, D)
    F4, ffw = _int8_ff(where, x, ff, D)
    x = pad(x, D)
    y = torch.empty_like(x)
    buf, fs, _ = _mode_buffers(B, T, D, False, mode, 1, x.device)
    h = torch.empty(B * T * F4, device=x.device)  # each row's GELU output
    lib = _build.bind("layer_modes", _MODE_SIGS)
    _build.call(lib, "kit_enc_layer_int8_tc", x.device, _PASSES[mode], x, B,
                T, D, n, heads, F4, *at, *ffw, mask, valid,
                int(kind == "repeat-inc"), int(add_keypad), y, buf, fs, h)
    return cut(y, n)


def _launch_decoder_mode(x, memory, sattn, cattn, g1, be1, ff, smask, svalid,
                         cmask, cvalid, skind, sadd_keypad, ckind,
                         cadd_keypad, heads, cluster, mode, planes):
    """The merged decoder layer in ``mode``, as ``_launch_encoder_mode``."""
    where = "fused_decoder_layer"
    B, T, n = x.shape
    _build.check_tensors(where, x.device, x=x, memory=memory, g1=g1, be1=be1)
    _build.check_shape(where, "memory", memory, (B, T, n))
    _build.check_shape(where, "g1", g1, (n,))
    _build.check_shape(where, "be1", be1, (n,))
    _build.check_aligned(where, x=x, memory=memory, self_bo=sattn[3],
                         cross_bo=cattn[3])
    smask = _check_masks(where, x, smask, svalid, skind, sadd_keypad, heads)
    cmask = _check_masks(where, x, cmask, cvalid, ckind, cadd_keypad, heads)
    _cluster(where, B, x.device, cluster)  # checked, not read
    D = kernel_width(where, n)
    splanes, cplanes, fplanes = (None,) * 3 if planes is None else planes
    sa = _mode_attn(where, x, sattn, splanes, heads, mode, D, "self ")
    ca = _mode_attn(where, x, cattn, cplanes, heads, mode, D, "cross ")
    F16, ffw = _mode_ff(where, x, ff, fplanes, mode, D)
    if ffw is None:
        ffw = (None,) * 10
    x, memory, g1, be1 = (pad(t, D) for t in (x, memory, g1, be1))
    y = torch.empty_like(x)
    parts = tc_parts(B * T, D, F16) if F16 else 1
    buf, fs, partial = _mode_buffers(B, T, D, True, mode, parts, x.device)
    lib = _build.bind("layer_modes", _MODE_SIGS)
    _build.call(lib, "kit_dec_layer_tc", x.device, _PASSES[mode], x, memory,
                B, T, D, n, heads, F16, parts, *sa, *ca, g1, be1, *ffw, smask,
                svalid, int(skind == "repeat-inc"), int(sadd_keypad), cmask,
                cvalid, int(ckind == "repeat-inc"), int(cadd_keypad), y, buf,
                fs, partial)
    return cut(y, n)

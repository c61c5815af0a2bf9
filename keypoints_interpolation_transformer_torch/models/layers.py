"""Transformer building blocks under the reference ``.pth`` parameter names
(port of the JAX ``models/layers.py``).

The modules hold their parameters in torch's layout (Linear weights are
(out, in); attention keeps the packed ``in_proj_weight``).  The serving
kernels take them in the Flax layout (in, out) with q/k/v and fc1/fc2
packed side by side; each module builds that form once and keeps it until
one of its parameters changes (``packed()``), outside the autograd graph.

Every sublayer runs through the kernel wrappers of ``ops/kernels``: the
plain PyTorch versions for CPU tensors (or when ``plain=True``, the oracle
path), the CUDA kernels for CUDA tensors.  With ``train=True`` (the
gradient route) a sublayer goes through its ``autograd.Function``
(training forward plus backward kernel), which takes the parameters
themselves, so every gradient reaches them; with ``plain=True`` as well,
autograd differentiates the plain version.

The FF sublayer runs in the model's precision mode ``mode`` ("f32",
"bf16x3" or "bf16"; ``ops/kernels/precision.py``): its kernels in that
mode (the training route's backward through ``ffn_bwd_split`` outside
"f32"), its plain chain with the products in that mode.  So do the merged
whole-layer kernels, every product of the layer (attention included) in
the mode as the JAX ``_enc_kernel`` / ``_dec_kernel`` take them, their
weights split once into bf16 planes (``attn_planes``, ``ff_planes``); int8
serving keeps its merged layers float32 around the int8 FF.  So does the
attention sublayer kernel on the per-sublayer route, serving (the folded
``attn_planes`` of the merged layers) and training (its forward with q
scaled after the bias and its backward, in the mode as the JAX
``_sublayer_train_kernel`` / ``_sublayer_bwd_kernel`` take it), on the
int8 route too, as the JAX package runs its per-sublayer attention in the
ambient mode whatever the FF does.  So does the per-op attention core
(``fused_attention`` / ``AttentionFunction`` in the mode, as the JAX
``_attn_kernel`` / ``_attn_bwd_kernel`` take it) on the serving, training
and int8 routes; its projections stay ``F.linear`` (or int8), as the XLA
products they replace.

Serving with ``merge=True`` (the JAX package's default, ``merge_layers``)
takes the merged whole-layer kernels where the JAX package takes them
(``ops/kernels/layer_fused.py`` holds the port's copies of its rules): an
encoder layer with T <= 256 is one ``fused_encoder_layer``; a decoder layer
with T <= 512 is one ``fused_decoder_layer``, with its FF tail inside when
T <= 256 (``decoder_full_supported``) and as the FF sublayer kernel after
it otherwise.  Everything else, and the training route, runs per sublayer.

The attention sublayer kernel runs where the JAX ``_use_sublayer_kernel``
takes it (``use_sublayer_kernel``): with ``fuse`` (``attn_sublayer_fusion``)
on and ``sublayer_supported(T, D)`` (T <= 512, T % 8 == 0); so do the
merged kernels.  Elsewhere attention goes per op, as the JAX
``MultiHeadAttention`` does with a fused spec: q / k / v projections and
the out-projection as library matmuls (XLA products there), the core
through ``fused_attention`` (``AttentionFunction`` under ``train``), the
residual and the decoder's self-attention LN1 as plain ops; the FF sublayer
still goes through its kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import (AttentionFunction, AttnSublayerFunction,
                           FFNFunction, attention_plain, attn_sublayer_plain,
                           decoder_layer_plain, encoder_layer_int8_plain,
                           encoder_layer_plain, ffn_int8_plain, ffn_plain,
                           fused_attention, fused_attn_sublayer,
                           fused_decoder_layer, fused_encoder_layer,
                           fused_encoder_layer_int8, fused_ffn,
                           fused_ffn_int8, fused_int8_dense, int8_dense_plain)
from ..ops.kernels.ffn import LN_EPS, ff_weight_planes, ffn_supported
from ..ops.kernels.int8_matmul import quantize_weight
from ..ops.kernels.layer_fused import (attn_weight_planes,
                                       decoder_full_supported,
                                       fused_layer_supported,
                                       use_sublayer_kernel)
from ..ops.kernels.pointwise import chain_planes, token_norm

__all__ = ["LN_EPS", "token_norm", "sinusoidal_positional_encoding",
           "SwiGLU", "MultiHeadAttention", "FeedForward", "EncoderLayer",
           "DecoderLayer", "TransformerCore", "AttnSpec", "packed_linear",
           "graph_linear", "chain_planes_of"]


def sinusoidal_positional_encoding(max_len: int, dim: int,
                                   device=None) -> torch.Tensor:
    """(max_len, dim) sin/cos table, even columns sin, odd columns cos."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros(max_len, dim, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _cached(module: nn.Module, name: str, params, build):
    """``build()`` once per state of ``params`` (their storage and in-place
    version), kept on ``module`` outside its state dict."""
    key = tuple((p.data_ptr(), p._version) for p in params)
    hit = module.__dict__.get(name)
    if hit is None or hit[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            hit = (key, build())
        module.__dict__[name] = hit
    return hit[1]


def packed_linear(lin: nn.Linear):
    """(weight^T contiguous (in, out), bias) of a Linear."""
    return _cached(lin, "_packed", (lin.weight, lin.bias),
                   lambda: (lin.weight.t().contiguous(), lin.bias.detach()))


def graph_linear(lin: nn.Linear):
    """(weight^T (in, out), bias) of a Linear inside the autograd graph."""
    return lin.weight.t(), lin.bias


def ff_planes(ff: "FeedForward", mode: str):
    """The FF weights as the tensor-core kernels read them in ``mode``
    (``ffn.ff_weight_planes``), built once per state of the weights."""
    return _cached(ff, f"_planes_{mode}", (ff.linear1.weight,
                                           ff.linear2.weight),
                   lambda: ff_weight_planes(ff.linear1.weight.detach(),
                                            ff.linear2.weight.detach(), mode))


def attn_planes(mha: "MultiHeadAttention", mode: str):
    """An attention sublayer's weights as the serving mode kernels (the
    merged layers' and the sublayer's) read them
    (``attn_sublayer.attn_weight_planes``: q's scale folded in, bf16 planes),
    built once per state of the weights."""
    return _cached(mha, f"_planes_{mode}", list(mha.parameters()),
                   lambda: attn_weight_planes(*mha.packed()[:3],
                                              mha.num_heads, mode))


def chain_planes_of(sw: "SwiGLU", lin: nn.Linear, mode: str, head: bool):
    """A pointwise chain's weights as its mode kernels read them
    (``pointwise.chain_planes``): the SwiGLU's and its Linear's, the
    embedding before it or (``head``) the head after it, built once per
    state of those weights."""
    def build():
        w12, _, w3, _ = sw.packed()
        w = packed_linear(lin)[0]
        return chain_planes(w12, w3, mode,
                            **({"wh": w} if head else {"wemb": w}))
    return _cached(sw, f"_chain_planes_{mode}", [*sw.parameters(),
                                                 lin.weight], build)


def int8_linear(lin: nn.Linear, form: str = "dense"):
    """(wq (out, in) int8, scale (out,), bias) of a Linear, its weight
    quantized in ``form`` (``int8_matmul.quantize_weight``)."""
    return _cached(lin, f"_int8_{form}", (lin.weight, lin.bias),
                   lambda: (*quantize_weight(lin.weight, form),
                            lin.bias.detach()))


def int8_dense(plain: bool):
    """The int8 dense layer: its kernel, or its plain version."""
    return int8_dense_plain if plain else fused_int8_dense


class AttnSpec(NamedTuple):
    """What an attention sublayer's bias is built from: the (B, T) frame
    mask (1 = missing) and valid mask (1 = real frame), both optional."""
    mask: Optional[torch.Tensor]
    valid: Optional[torch.Tensor]
    kind: str
    add_keypad: bool


class SwiGLU(nn.Module):
    """fc3(fc1(x) * sigmoid(fc2(x))), hidden width == input width."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim, device=device)
        self.fc2 = nn.Linear(dim, dim, device=device)
        self.fc3 = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        return self.fc3(self.fc1(x) * torch.sigmoid(self.fc2(x)))

    def packed(self):
        """(w12 = [W1 | W2] (D, 2D), b12, w3 (D, D), b3) for the kernels."""
        def build():
            return (torch.cat([self.fc1.weight.t(), self.fc2.weight.t()],
                              1).contiguous(),
                    torch.cat([self.fc1.bias, self.fc2.bias]),
                    self.fc3.weight.t().contiguous(), self.fc3.bias.detach())
        return _cached(self, "_packed", list(self.parameters()), build)

    def int8_packed(self):
        """(w12q = [W1; W2] int8 (2D, D), its scales, b12, w3q int8 (D, D),
        its scales, b3): the weights in torch's layout, quantized in the
        Dense table's form, for the int8 dense layer."""
        def build():
            w12q, s12 = quantize_weight(torch.cat([self.fc1.weight,
                                                   self.fc2.weight]))
            return (w12q, s12, torch.cat([self.fc1.bias, self.fc2.bias]),
                    *quantize_weight(self.fc3.weight), self.fc3.bias.detach())
        return _cached(self, "_int8", list(self.parameters()), build)

    def graph_packed(self):
        """``packed()`` built inside the autograd graph, for training."""
        return (torch.cat([self.fc1.weight.t(), self.fc2.weight.t()], 1),
                torch.cat([self.fc1.bias, self.fc2.bias]),
                self.fc3.weight.t(), self.fc3.bias)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with additive-bias masking, under torch
    ``nn.MultiheadAttention``'s parameter names.  ``forward`` adds a float
    ``bias`` broadcasting against (B, H, Tq, Tk) to the logits, as torch
    does with float masks."""

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not divisible by {num_heads}")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim,
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, device=device))
        self.out_proj = nn.Linear(dim, dim, device=device)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def project(self, q_in, kv_in, int8: bool = False, plain: bool = False):
        """q = q_in Wq + bq, k and v from kv_in, each (B, T, H, dh); with
        ``int8`` through the int8 dense layer (``int8_packed``), as the JAX
        package's int8 interceptor runs the q/k/v ``nn.Dense``: one call over
        the packed weight equals three, its scales being per output column
        and x's per row."""
        B, D = q_in.shape[0], q_in.shape[-1]
        H = self.num_heads

        def heads(t):
            return t.reshape(B, -1, H, D // H).contiguous()

        if int8:
            dense = int8_dense(plain)
            wq, ws, b = self.int8_packed()[:3]
            if q_in is kv_in:
                return tuple(heads(t) for t in
                             dense(q_in, wq, ws, b).split(D, -1))
            q = dense(q_in, wq[:D], ws[:D], b[:D])
            k, v = dense(kv_in, wq[D:], ws[D:], b[D:]).split(D, -1)
            return heads(q), heads(k), heads(v)
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        return heads(F.linear(q_in, wq, bq)), heads(F.linear(kv_in, wk, bk)), \
            heads(F.linear(kv_in, wv, bv))

    def int8_packed(self):
        """(in_proj int8 (3D, D), its scales, in_proj_bias, out_proj int8
        (D, D), its scales, out_proj bias), the "dense" scale form."""
        def build():
            return (*quantize_weight(self.in_proj_weight),
                    self.in_proj_bias.detach(),
                    *quantize_weight(self.out_proj.weight),
                    self.out_proj.bias.detach())
        return _cached(self, "_int8", list(self.parameters()), build)

    def forward(self, q_in, kv_in, bias=None):
        B, Tq, D = q_in.shape
        q, k, v = (t.transpose(1, 2) for t in self.project(q_in, kv_in))
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(D // self.num_heads)
        if bias is not None:
            logits = logits + bias
        out = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(B, Tq, D)
        return self.out_proj(out)

    def attend(self, x, memory, spec: AttnSpec, plain: bool = False,
               train: bool = False, int8: bool = False, mode: str = "f32"):
        """attention(x, memory or x) on the per-op route (no residual):
        the projections by ``F.linear`` (with ``int8``, serving only, by the
        int8 dense layer), the core in precision ``mode`` through
        ``fused_attention`` (``AttentionFunction`` under ``train``, which
        outside "f32" takes the plain versions with ``plain``) or its plain
        version."""
        B, T, D = x.shape
        q, k, v = self.project(x, x if memory is None else memory, int8,
                               plain)
        masks = (spec.mask, spec.valid, spec.kind, spec.add_keypad)
        if train and not (plain and mode == "f32"):
            a = AttentionFunction.apply(q, k, v, *masks, mode, plain)
        elif plain:
            a = attention_plain(q, k, v, *masks, mode=mode)
        else:
            a = fused_attention(q, k, v, *masks, mode=mode)
        a = a.reshape(B, T, D)
        if int8:
            return int8_dense(plain)(a, *self.int8_packed()[3:])
        return self.out_proj(a)

    def packed(self):
        """(wqkv = [Wq | Wk | Wv] (D, 3D), bqkv, wo (D, D), bo)."""
        def build():
            return (self.in_proj_weight.t().contiguous(),
                    self.in_proj_bias.detach(),
                    self.out_proj.weight.t().contiguous(),
                    self.out_proj.bias.detach())
        return _cached(self, "_packed", list(self.parameters()), build)

    def sublayer(self, x, memory, norm: Optional[nn.LayerNorm],
                 spec: AttnSpec, plain: bool = False, train: bool = False,
                 mode: str = "f32"):
        """[norm](x + attention(x, memory or x)) through the sublayer
        kernel (or its plain version) in precision ``mode``; ``train``
        takes the gradient route (outside "f32" through
        ``AttnSublayerFunction``'s backward in the mode, plain or not)."""
        ln_w, ln_b = (None, None) if norm is None else (norm.weight,
                                                        norm.bias)
        masks = (spec.mask, spec.valid, spec.kind, spec.add_keypad,
                 self.num_heads)
        if not train:
            if plain:
                return attn_sublayer_plain(x, memory, *self.packed(), ln_w,
                                           ln_b, *masks, mode)
            planes = None if mode == "f32" else attn_planes(self, mode)
            return fused_attn_sublayer(x, memory, *self.packed(), ln_w, ln_b,
                                       *masks, mode, planes)
        if plain and mode == "f32":
            return attn_sublayer_plain(
                x, memory, self.in_proj_weight.t(), self.in_proj_bias,
                self.out_proj.weight.t(), self.out_proj.bias, ln_w, ln_b,
                *masks)
        return AttnSublayerFunction.apply(
            x, memory, self.in_proj_weight, self.in_proj_bias,
            self.out_proj.weight, self.out_proj.bias, ln_w, ln_b, *masks,
            mode, plain)


class FeedForward(nn.Module):
    """linear2(gelu(linear1(x))) with exact-erf GELU.  The transformer
    layers derive from it so that linear1/linear2 sit directly under the
    layer, as in torch's TransformerEncoderLayer."""

    def __init__(self, dim: int, ff_dim: int, device=None):
        super().__init__()
        self.linear1 = nn.Linear(dim, ff_dim, device=device)
        self.linear2 = nn.Linear(ff_dim, dim, device=device)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))

    def ff_packed(self, norm_in: nn.LayerNorm, norm_out: nn.LayerNorm):
        """(w1, b1, w2, b2, g_in, be_in, g_out, be_out) for the serving
        kernels, the FF weights in the Flax layout."""
        return (*packed_linear(self.linear1), *packed_linear(self.linear2),
                norm_in.weight, norm_in.bias, norm_out.weight, norm_out.bias)

    def ff_int8_packed(self, norm_in: nn.LayerNorm, norm_out: nn.LayerNorm,
                       form: str = "ff"):
        """(w1q, w1s, b1, w2q, w2s, b2, g_in, be_in, g_out, be_out): the FF
        weights int8 in torch's layout, their scales in ``form``."""
        return (*int8_linear(self.linear1, form),
                *int8_linear(self.linear2, form), norm_in.weight,
                norm_in.bias, norm_out.weight, norm_out.bias)

    def ff_sublayer(self, r, norm_in: nn.LayerNorm, norm_out: nn.LayerNorm,
                    plain: bool = False, train: bool = False,
                    int8: bool = False, mode: str = "f32"):
        """norm_out(x1 + FF(x1)) with x1 = norm_in(r), through the FF
        kernel (or its plain version) in precision ``mode``; ``train``
        takes the gradient route, ``int8`` (serving) the int8 FF kernel,
        whatever the mode.  Where the JAX package's FF kernel refuses the
        weights (``ffn_supported``), its plain chain runs, as the JAX
        package runs XLA ops there (int8: its chain of
        ``_int8_dense_xla``)."""
        D, FF = self.linear1.in_features, self.linear1.out_features
        kernel = ffn_supported(D, FF, int8, mode)
        if int8:
            if not kernel:
                return ffn_int8_plain(
                    r, *self.ff_int8_packed(norm_in, norm_out, "dense"),
                    xla=True)
            fn = ffn_int8_plain if plain else fused_ffn_int8
            return fn(r, *self.ff_int8_packed(norm_in, norm_out))
        norms = (norm_in.weight, norm_in.bias, norm_out.weight,
                 norm_out.bias, True)
        if not train:
            if plain or not kernel:
                return ffn_plain(r, *self.ff_packed(norm_in, norm_out), True,
                                 mode)
            planes = None if mode == "f32" else ff_planes(self, mode)
            return fused_ffn(r, *self.ff_packed(norm_in, norm_out), True,
                             mode, planes)
        if plain or not kernel:
            return ffn_plain(r, *graph_linear(self.linear1),
                             *graph_linear(self.linear2), *norms, mode)
        return FFNFunction.apply(r, self.linear1.weight, self.linear1.bias,
                                 self.linear2.weight, self.linear2.bias,
                                 *norms, mode)


class EncoderLayer(FeedForward):
    """Post-LN: x = LN1(x + SA(x)); x = LN2(x + FF(x))."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int, device=None):
        super().__init__(dim, ff_dim, device)
        self.self_attn = MultiHeadAttention(dim, num_heads, device)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)

    def forward(self, x, spec: AttnSpec, plain: bool = False,
                train: bool = False, merge: bool = False, fuse: bool = True,
                int8: bool = False, mode: str = "f32"):
        D, FF = self.linear1.in_features, self.linear1.out_features
        T = x.shape[1]
        sub = use_sublayer_kernel(fuse, T, D)
        if sub and merge and not train and fused_layer_supported(T, D, FF):
            args = (*self.self_attn.packed(), *spec, self.self_attn.num_heads)
            if int8:
                fn = encoder_layer_int8_plain if plain else \
                    fused_encoder_layer_int8
                ff = self.ff_int8_packed(self.norm1, self.norm2)
                return fn(x, *args[:4], *ff, *args[4:])
            ff = self.ff_packed(self.norm1, self.norm2)
            if plain:
                return encoder_layer_plain(x, *args[:4], *ff, *args[4:],
                                           mode)
            planes = None if mode == "f32" else (
                attn_planes(self.self_attn, mode), ff_planes(self, mode))
            return fused_encoder_layer(x, *args[:4], *ff, *args[4:],
                                       mode=mode, planes=planes)
        if sub:
            r = self.self_attn.sublayer(x, None, None, spec, plain, train,
                                        mode)
        else:
            r = x + self.self_attn.attend(x, None, spec, plain, train, int8,
                                          mode)
        return self.ff_sublayer(r, self.norm1, self.norm2, plain, train, int8,
                                mode)


class DecoderLayer(FeedForward):
    """Post-LN: y = LN1(y + SA(y)); r = y + CA(y, memory);
    y = LN3(LN2(r) + FF(LN2(r)))."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int, device=None):
        super().__init__(dim, ff_dim, device)
        self.self_attn = MultiHeadAttention(dim, num_heads, device)
        self.multihead_attn = MultiHeadAttention(dim, num_heads, device)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS, device=device)

    def forward(self, y, memory, self_spec: AttnSpec, cross_spec: AttnSpec,
                plain: bool = False, train: bool = False,
                merge: bool = False, fuse: bool = True, int8: bool = False,
                mode: str = "f32"):
        D, FF = self.linear1.in_features, self.linear1.out_features
        T = y.shape[1]
        sub = use_sublayer_kernel(fuse, T, D)
        if sub and merge and not train and memory.shape[1] == T:
            # the FF tail stays out of the merged kernel under int8, as
            # the JAX package's ``full`` holds for its float kernel only
            full = decoder_full_supported(T, D, FF) and not int8
            # int8 serving keeps its decoder layers float32 (its outputs
            # stay as they were; the int8 route at a mode is not ported)
            lmode = "f32" if int8 else mode
            args = (y, memory, *self.self_attn.packed(),
                    *self.multihead_attn.packed(), self.norm1.weight,
                    self.norm1.bias,
                    self.ff_packed(self.norm2, self.norm3) if full else None,
                    self_spec.mask, self_spec.valid, cross_spec.mask,
                    cross_spec.valid, self_spec.kind, self_spec.add_keypad,
                    cross_spec.kind, cross_spec.add_keypad,
                    self.self_attn.num_heads)
            if plain:
                r = decoder_layer_plain(*args, lmode)
            else:
                planes = None if lmode == "f32" else (
                    attn_planes(self.self_attn, lmode),
                    attn_planes(self.multihead_attn, lmode),
                    ff_planes(self, lmode) if full else None)
                r = fused_decoder_layer(*args, mode=lmode, planes=planes)
            if full:
                return r
            return self.ff_sublayer(r, self.norm2, self.norm3, plain,
                                    int8=int8, mode=mode)
        if sub:
            y = self.self_attn.sublayer(y, None, self.norm1, self_spec,
                                        plain, train, mode)
            r = self.multihead_attn.sublayer(y, memory, None, cross_spec,
                                             plain, train, mode)
        else:
            y = self.norm1(y + self.self_attn.attend(y, None, self_spec,
                                                     plain, train, int8,
                                                     mode))
            r = y + self.multihead_attn.attend(y, memory, cross_spec, plain,
                                               train, int8, mode)
        return self.ff_sublayer(r, self.norm2, self.norm3, plain, train,
                                int8, mode)


class _Stack(nn.Module):
    def __init__(self, layers, dim: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)


class TransformerCore(nn.Module):
    """Encoder-decoder stack with final LayerNorms, as torch
    ``nn.Transformer`` builds it (``encoder.layers.{i}``, ``encoder.norm``,
    ``decoder.layers.{i}``, ``decoder.norm``)."""

    def __init__(self, dim: int, num_heads: int, num_layers: int,
                 ff_dim: int = 2048, device=None):
        super().__init__()
        self.encoder = _Stack([EncoderLayer(dim, num_heads, ff_dim, device)
                               for _ in range(num_layers)], dim, device)
        self.decoder = _Stack([DecoderLayer(dim, num_heads, ff_dim, device)
                               for _ in range(num_layers)], dim, device)

    def forward(self, src, tgt, src_spec: AttnSpec, tgt_spec: AttnSpec,
                cross_spec: AttnSpec, plain: bool = False,
                train: bool = False, merge: bool = False, fuse: bool = True,
                int8: bool = False, mode: str = "f32"):
        x = src
        for layer in self.encoder.layers:
            x = layer(x, src_spec, plain, train, merge, fuse, int8, mode)
        memory = self.encoder.norm(x)  # F.layer_norm, also under autograd
        y = tgt
        for layer in self.decoder.layers:
            y = layer(y, memory, tgt_spec, cross_spec, plain, train, merge,
                      fuse, int8, mode)
        return self.decoder.norm(y)

"""The flagship KeypointCompleter, its Cycle flags and the linear
autoencoder Embedding (port of the JAX ``models/completer.py``), under the
reference ``.pth`` state-dict names.

Pipeline: flatten frame -> pre-stream kernel per stream (Linear(108 -> D),
token_norm [+ token_norm for Cycle], + sinusoidal + learned PE, SwiGLU)
-> post-LN transformer (src = masked stream, tgt = shifted filled stream)
-> post-head kernel (SwiGLU, token_norm(decoded + filled embedding),
swish, Linear(D -> 108)) -> (B, T, K, 2).

The attention biases are built inside the sublayer kernels from the 1-D
(B, T) masks:

  encoder self-attention   repeat-inc on the source mask, the raw mask
                           added (torch float key padding), padded keys
                           blocked;
  decoder self-attention   repeat-inc on the target mask, the raw mask
                           added only with ``use_tgt_key_padding`` (Cycle);
  cross-attention          "all" plus the padding bias.

A stream whose frame mask is not given attends with kind "all"; otherwise
``src_mask_kind`` / ``tgt_mask_kind`` name the kind ("repeat-inc", or
"all" for the Cycle model's second pass, which adds its all-ones pad masks
as a uniform +1).

Two routes, as the JAX package's ``build_model`` has them:

  serving   (``eval()`` mode or no gradient): every kernel, with weights
            packed once outside the autograd graph; with ``merge_layers``
            (the default, as in the JAX package) the merged whole-layer
            kernels where the JAX package's rules take them (see
            ``models/layers.py``), else per sublayer;
  training  (``train()`` mode with gradients on): the attention and FF
            sublayers through their ``autograd.Function``s (training
            forward and backward kernels); the pre- and post-stream chains
            through their plain versions under autograd, as the JAX
            training path keeps those chains in XLA (``build_model`` with
            ``for_training``), not as a fallback.  ``merge_layers`` is not
            read there, as the JAX training path sets it off.

``precision`` (the JAX ``matmul_precision`` names: "highest", "high",
"default" and their aliases; ``utils/config.resolve_precision``) is set at
construction and read by every forward: the FF sublayers run in its mode
on both routes, and so do the merged whole-layer kernels on the serving
route (every product of the layer, attention included, as the JAX
``_enc_kernel`` / ``_dec_kernel`` take the mode) and the attention
sublayer kernel on both routes (``_sublayer_kernel`` serving,
``_sublayer_train_kernel`` and ``_sublayer_bwd_kernel`` training), the
per-op attention core on both routes (``_attn_kernel``,
``_attn_bwd_kernel``), and on the serving route the pointwise chains where
their kernels run (``pointwise_supported``; ``_pre_embed_kernel`` and
``_post_kernel`` in the mode, their weights split once into planes,
``chain_planes_of``), int8 serving included, as the JAX Inpainter runs its
Pallas chains under the ambient precision whatever its int8 interceptor
does to the Dense layers.  The training route keeps the plain chains in
float32, as the JAX training path keeps its XLA chains (``pw_impl =
"xla"``); so do the XLA chains elsewhere (see ``models/layers.py``).

On both routes ``attn_sublayer_fusion`` off, or a length the sublayer
kernel does not take (T > 512 or T % 8 != 0), sends attention per op
(``fused_attention``; see ``models/layers.py``), as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.keypoints import FRAME_FEATURES, NUM_COORDS, NUM_KEYPOINTS
from ..ops.kernels import (fused_post_head, fused_pre_stream_embed,
                           post_head_plain, pre_stream_embed_plain)
from ..ops.kernels.ffn import ffn_supported
from ..ops.kernels.pointwise import pointwise_supported, token_norm
from ..utils.config import resolve_precision
from .layers import (AttnSpec, FeedForward, MultiHeadAttention, SwiGLU,
                     TransformerCore, attn_planes, chain_planes_of, ff_planes,
                     graph_linear, int8_dense, int8_linear, packed_linear,
                     sinusoidal_positional_encoding)

QUANTIZE = (None, "int8")


def check_quantize(quantize):
    """``quantize`` as the JAX ``Inpainter`` takes it (None, "none" or
    "int8"); returns None or "int8"."""
    if quantize in (None, "none"):
        return None
    if quantize != "int8":
        raise ValueError(f"unknown quantize mode {quantize!r}")
    return quantize


class KeypointCompleter(nn.Module):
    """Encoder-decoder keypoint-sequence inpainter.

    ``generator`` (a CPU ``torch.Generator``) initializes every parameter
    deterministically (see ``reset_parameters``); without it the modules
    keep torch's default initialization.
    """

    def __init__(self, hidden_dim: int, num_layers: int, num_heads: int,
                 input_size: int = FRAME_FEATURES, ff_dim: int = 2048,
                 pe_max_len: int = 2048, pe_residual: bool = False,
                 use_tgt_key_padding: bool = False, merge_layers: bool = True,
                 attn_sublayer_fusion: bool = True, device=None,
                 generator: Optional[torch.Generator] = None,
                 precision: str = "highest"):
        super().__init__()
        resolve_precision(precision)  # raises on an unknown name
        self.precision = precision
        D = hidden_dim
        self.hidden_dim, self.num_layers, self.num_heads = D, num_layers, \
            num_heads
        self.input_size, self.ff_dim, self.pe_max_len = input_size, ff_dim, \
            pe_max_len
        self.pe_residual = pe_residual
        self.use_tgt_key_padding = use_tgt_key_padding
        self.merge_layers = merge_layers
        self.attn_sublayer_fusion = attn_sublayer_fusion
        self.int8 = False  # int8 serving: see pack_weights
        self.input_embedding = nn.Linear(input_size, D, device=device)
        self.filled_embedding = nn.Linear(input_size, D, device=device)
        self.learned_input_positional_encoder = nn.Parameter(
            torch.rand(1, 1, D, device=device))
        self.learned_filled_positional_encoder = nn.Parameter(
            torch.rand(1, 1, D, device=device))
        self.swiGlu_input_prev = SwiGLU(D, device)
        self.swiGlu_filled_prev = SwiGLU(D, device)
        self.transformer = TransformerCore(D, num_heads, num_layers, ff_dim,
                                           device)
        self.swiGlu_decoded = SwiGLU(D, device)
        self.fc_final = nn.Linear(D, input_size, device=device)
        self.register_buffer(
            "pe", sinusoidal_positional_encoding(pe_max_len, D, device),
            persistent=False)
        if generator is not None:
            self.reset_parameters(generator)

    @property
    def mode(self) -> str:
        """The precision mode of the FF and attention sublayers and the
        merged layers: "f32", "bf16x3" or "bf16"."""
        return resolve_precision(self.precision)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` (on the CPU) the way
        torch initializes these modules: Linear weight and bias
        U(-1/sqrt(in), 1/sqrt(in)); attention in_proj Xavier-uniform with
        zero biases; LayerNorm ones and zeros; learned positions U(0, 1)."""
        uniform = _uniform(generator)
        for name, m in self.named_modules():
            if isinstance(m, nn.Linear):
                _reset_linear(m, uniform, zero_bias=name.endswith("out_proj"))
            elif isinstance(m, MultiHeadAttention):
                fan_out, fan_in = m.in_proj_weight.shape
                uniform(m.in_proj_weight, (6.0 / (fan_in + fan_out)) ** 0.5)
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for p in (self.learned_input_positional_encoder,
                  self.learned_filled_positional_encoder):
            p.copy_(torch.rand(p.shape, generator=generator))

    def pack_weights(self, quantize: Optional[str] = None) -> None:
        """Build every sublayer's kernel-layout weights now (they are built
        on first use otherwise, and again after a parameter changes).

        ``quantize="int8"`` makes the serving forwards int8 (see
        ``forward``) and quantizes, once, every weight an int8 route reads:
        the FF weights in the FF kernels' scale form (or the Dense one
        where ``ffn_supported`` sends them to the plain chain), the
        attention projections, embeddings, SwiGLUs and head in the Dense
        table's form (``int8_matmul.quantize_weight``).  In the precision
        modes "high" and "default" every attention sublayer's weights are
        split into the bf16 planes the serving mode kernels read
        (``attn_planes``: the merged layers' and the attention sublayer's,
        int8 serving's per-sublayer route too) and, without int8, the FF
        weights into the FF kernels' (``ff_planes``), so that the first
        request splits nothing; so are the pointwise chains' where their
        kernels run (``chain_planes_of``)."""
        self.int8 = check_quantize(quantize) == "int8"
        mode = self.mode
        if mode != "f32" and pointwise_supported(self.hidden_dim, 8):
            for sw, lin, head in self._chains():
                chain_planes_of(sw, lin, mode, head)
        for m in self.modules():
            if isinstance(m, (SwiGLU, MultiHeadAttention)):
                m.packed()
                if self.int8:
                    m.int8_packed()
                if mode != "f32" and isinstance(m, MultiHeadAttention):
                    attn_planes(m, mode)
            elif isinstance(m, nn.Linear):
                packed_linear(m)
                if self.int8:
                    int8_linear(m)
            if isinstance(m, FeedForward) and mode != "f32" and \
                    not self.int8 and ffn_supported(m.linear1.in_features,
                                  m.linear1.out_features, mode=mode):
                ff_planes(m, mode)
            if self.int8 and isinstance(m, FeedForward):
                D, FF = m.linear1.in_features, m.linear1.out_features
                if ffn_supported(D, FF, int8=True):
                    int8_linear(m.linear1, "ff")
                    int8_linear(m.linear2, "ff")

    def _chains(self):
        """(SwiGLU, Linear, is the head) of the three pointwise chains:
        the two pre-stream chains with their embeddings, the post head."""
        return ((self.swiGlu_input_prev, self.input_embedding, False),
                (self.swiGlu_filled_prev, self.filled_embedding, False),
                (self.swiGlu_decoded, self.fc_final, True))

    def forward(self, inputs: torch.Tensor, filled: torch.Tensor,
                src_frame_mask: Optional[torch.Tensor] = None,
                tgt_frame_mask: Optional[torch.Tensor] = None,
                valid_mask: Optional[torch.Tensor] = None,
                plain: bool = False, src_mask_kind: str = "repeat-inc",
                tgt_mask_kind: str = "repeat-inc") -> torch.Tensor:
        """inputs, filled (B, T, K, 2); masks (B, T): frame masks 1 =
        missing, ``valid_mask`` 1 = real frame; the mask kinds as the JAX
        ``KeypointCompleter`` takes them.  ``plain=True`` runs the plain
        PyTorch version of every kernel (the oracle path) whatever the
        device.  The training route is taken in ``train()`` mode when
        gradients are on (see the module docstring); int8 serving after
        ``pack_weights("int8")`` otherwise."""
        B, T = inputs.shape[0], inputs.shape[1]
        if T > self.pe_max_len:
            raise ValueError(
                f"sequence length {T} exceeds pe_max_len={self.pe_max_len}; "
                "raise pe_max_len or chunk the sequence")

        def f32(t):
            return None if t is None else t.to(torch.float32).contiguous()

        x = f32(inputs.reshape(B, T, -1))
        f = f32(filled.reshape(B, T, -1))
        src_frame_mask, tgt_frame_mask, valid_mask = (
            f32(src_frame_mask), f32(tgt_frame_mask), f32(valid_mask))
        train = self.training and torch.is_grad_enabled()
        int8 = self.int8 and not train
        # the pointwise kernels where the JAX package takes its own
        # (``pointwise_supported``), in the model's mode on the serving
        # route; its XLA chains, here the plain ones, elsewhere, their
        # Linears int8 under int8 serving
        supported = pointwise_supported(self.hidden_dim, T)
        kernel = supported and not plain
        int8_chains = int8 and not supported
        chain_mode = self.mode if supported and not train else "f32"
        if train:
            pre, post = pre_stream_embed_plain, post_head_plain
            linear = graph_linear
            swiglu = SwiGLU.graph_packed
        elif int8_chains:
            dense = int8_dense(plain)
            pre, post = _int8_chains(dense)
            linear = int8_linear
            swiglu = SwiGLU.int8_packed
        else:
            pre = fused_pre_stream_embed if kernel else pre_stream_embed_plain
            post = fused_post_head if kernel else post_head_plain
            linear = packed_linear
            swiglu = SwiGLU.packed

        pe = self.pe[:T]
        learned_in = self.learned_input_positional_encoder[0]
        learned_fill = self.learned_filled_positional_encoder[0]
        if int8_chains:  # added in the JAX XLA chain's order (_int8_chains)
            pe_in, pe_fill = (pe, learned_in), (pe, learned_fill)
        else:
            pe_in = (pe + learned_in).contiguous()
            pe_fill = (pe + learned_fill).contiguous()

        def chain_kw(sw, lin, head):
            """The chain's mode (and the planes its kernels read)."""
            if chain_mode == "f32":
                return {}
            return {"mode": chain_mode, **({"planes": chain_planes_of(
                sw, lin, chain_mode, head)} if kernel else {})}

        kw_in, kw_fill, kw_post = (chain_kw(*c) for c in self._chains())
        src = pre(x, *linear(self.input_embedding), pe_in,
                  *swiglu(self.swiGlu_input_prev), self.pe_residual, False,
                  **kw_in)
        tgt, filled_emb = pre(f, *linear(self.filled_embedding),
                              pe_fill, *swiglu(self.swiGlu_filled_prev),
                              self.pe_residual, True, **kw_fill)

        has_src, has_tgt = src_frame_mask is not None, \
            tgt_frame_mask is not None
        src_spec = AttnSpec(src_frame_mask, valid_mask,
                            src_mask_kind if has_src else "all", has_src)
        tgt_spec = AttnSpec(tgt_frame_mask, valid_mask,
                            tgt_mask_kind if has_tgt else "all",
                            self.use_tgt_key_padding and has_tgt)
        cross_spec = AttnSpec(None, valid_mask, "all", False)
        decoded = self.transformer(src, tgt, src_spec, tgt_spec, cross_spec,
                                   plain, train, self.merge_layers,
                                   self.attn_sublayer_fusion, int8,
                                   self.mode)
        out = post(decoded, filled_emb, *swiglu(self.swiGlu_decoded),
                   *linear(self.fc_final), **kw_post)
        return out.reshape(B, T, NUM_KEYPOINTS, NUM_COORDS)


def _int8_chains(dense):
    """(pre, post): the pre-stream and post-head chains with every Linear
    through the int8 dense layer ``dense`` (kernel or plain version), the
    JAX XLA chains under its int8 interceptor, in the order of
    ``pre_stream_embed_plain`` and ``post_head_plain``; the weights as
    ``int8_linear`` and ``SwiGLU.int8_packed`` give them."""
    def swiglu(n, w12q, s12, b12, w3q, s3, b3):
        x1, x2 = dense(n, w12q, s12, b12).chunk(2, dim=-1)
        return dense(x1 * torch.sigmoid(x2), w3q, s3, b3)

    def pre(x, wq, ws, b, pe_learned, w12q, s12, b12, w3q, s3, b3,
            pe_residual, want_emb):
        # (pe, learned): added as the JAX XLA chain adds them, since the
        # int8 quantization that follows can turn an ulp into a step
        pe, learned = pe_learned
        e = dense(x, wq, ws, b)
        n = token_norm(e)
        n = ((n + (n + pe)) if pe_residual else (n + pe)) + learned
        s = swiglu(n, w12q, s12, b12, w3q, s3, b3)
        return (s, e) if want_emb else s

    def post(decoded, filled_emb, w12q, s12, b12, w3q, s3, b3, whq, whs, bh):
        z = token_norm(swiglu(decoded, w12q, s12, b12, w3q, s3, b3)
                       + filled_emb)
        return dense(z * torch.sigmoid(z), whq, whs, bh)

    return pre, post


def keypoint_completer_cycle(hidden_dim: int, num_layers: int,
                             num_heads: int, **kw) -> KeypointCompleter:
    """The Cycle variant: PE table of 512, the extra pre-PE residual, and
    target key padding."""
    return KeypointCompleter(hidden_dim, num_layers, num_heads,
                             pe_max_len=512, pe_residual=True,
                             use_tgt_key_padding=True, **kw)


class Embedding(nn.Module):
    """The linear autoencoder over flattened frames (the JAX ``Embedding``,
    pre-trained by regime A3): output_embedding(input_embedding(x)).  Two
    plain Linears, no kernel: the JAX package runs them as ``nn.Dense``
    outside any Pallas kernel too.  It has no FF sublayer, so ``precision``
    (checked and kept, as every model of the port carries one) changes
    nothing."""

    def __init__(self, hidden_dim: int, input_size: int = FRAME_FEATURES,
                 device=None, generator: Optional[torch.Generator] = None,
                 precision: str = "highest"):
        super().__init__()
        resolve_precision(precision)
        self.precision = precision
        self.hidden_dim, self.input_size = hidden_dim, input_size
        self.input_embedding = nn.Linear(input_size, hidden_dim,
                                         device=device)
        self.output_embedding = nn.Linear(hidden_dim, input_size,
                                          device=device)
        if generator is not None:
            uniform = _uniform(generator)
            with torch.no_grad():
                for m in (self.input_embedding, self.output_embedding):
                    _reset_linear(m, uniform)

    int8 = False

    def pack_weights(self, quantize: Optional[str] = None) -> None:
        """With ``quantize="int8"``, quantize both Linears once (the Dense
        table's form) and serve them through the int8 dense layer, as the
        JAX package's int8 interceptor does."""
        self.int8 = check_quantize(quantize) == "int8"
        if self.int8:
            for m in (self.input_embedding, self.output_embedding):
                int8_linear(m)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x (B, T, K, 2) -> its reconstruction (B, T, K, 2); int8 after
        ``pack_weights("int8")`` unless gradients are taken in ``train()``
        mode (``plain`` then selects the int8 layer's plain version)."""
        B, T = x.shape[0], x.shape[1]
        h = x.reshape(B, T, -1).to(torch.float32)
        if self.int8 and not (self.training and torch.is_grad_enabled()):
            dense = int8_dense(plain)
            for m in (self.input_embedding, self.output_embedding):
                h = dense(h, *int8_linear(m))
        else:
            h = self.output_embedding(self.input_embedding(h))
        return h.reshape(B, T, NUM_KEYPOINTS, NUM_COORDS)


def _uniform(generator: torch.Generator):
    """p <- U(-bound, bound) drawn on the CPU from ``generator``."""
    def uniform(p, bound):
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                              generator=generator))
    return uniform


def _reset_linear(m: nn.Linear, uniform, zero_bias: bool = False) -> None:
    """torch's Linear initialization, U(-1/sqrt(in), 1/sqrt(in)), weight
    then bias (a zero bias for attention out-projections, as torch's
    MultiheadAttention sets it)."""
    bound = 1.0 / m.in_features ** 0.5
    uniform(m.weight, bound)
    if zero_bias:
        m.bias.zero_()
    else:
        uniform(m.bias, bound)

"""Hand-written CUDA kernels of the serving (float32 and int8) and training
paths, each beside its plain PyTorch version, and the table that names
them.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, counting those calls in ``wrapper.launches``; a
wrapper that takes a precision mode counts per mode
(``wrapper.launches[mode]``), and the table names each mode's kernel
apart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from .attention import (AttentionFunction, attention_bwd,
                        attention_bwd_plain, attention_plain,
                        fused_attention)
from .attn_sublayer import (AttnSublayerFunction, attn_sublayer_bwd,
                            attn_sublayer_bwd_plain, attn_sublayer_plain,
                            attn_sublayer_train_plain, attn_train_planes,
                            fused_attn_sublayer, fused_attn_sublayer_train)
from .ffn import (FFNFunction, ff_weight_planes, ffn_bwd, ffn_bwd_plain,
                  ffn_bwd_split, ffn_bwd_split_plain, ffn_int8_plain,
                  ffn_plain, ffn_train_plain, fused_ffn, fused_ffn_int8,
                  fused_ffn_train)
from .int8_matmul import fused_int8_dense, int8_dense_plain
from .layer_fused import (attn_weight_planes, decoder_layer_plain,
                          encoder_layer_int8_plain, encoder_layer_plain,
                          fused_decoder_layer, fused_encoder_layer,
                          fused_encoder_layer_int8)
from .linear import (ModeLinearFunction, linear_planes, mode_linear,
                     mode_linear_bwd, row_planes)
from .masked_loss import (FusedEuclideanLoss, fused_euclidean_loss,
                          fused_masked_loss, masked_loss_plain)
from .pointwise import (chain_planes, fused_post_head, fused_pre_stream,
                        fused_pre_stream_embed, post_head_plain,
                        pre_stream_embed_plain, pre_stream_plain)
from .precision import mode_linear_bwd_plain, mode_linear_plain


class Kernel(NamedTuple):
    name: str
    wrapper: object
    source: str    # path in the repository
    replaces: str  # the TPU kernel, file:line
    mode: Optional[str] = None  # the precision mode counted, if it takes one


_TPU = "keypoints_interpolation_transformer_tpu/ops/pallas"
_SRC = "keypoints_interpolation_transformer_torch/csrc"
_XLA = "keypoints_interpolation_transformer_tpu/models"

KERNELS = (
    Kernel("pre_stream_embed", fused_pre_stream_embed,
           f"{_SRC}/pointwise.cu", f"{_TPU}/pointwise.py:230", "f32"),
    Kernel("attn_sublayer", fused_attn_sublayer,
           f"{_SRC}/attn_sublayer.cu", f"{_TPU}/attn_sublayer.py:135",
           "f32"),
    Kernel("ffn", fused_ffn,
           f"{_SRC}/ffn.cu", f"{_TPU}/ffn.py:215", "f32"),
    Kernel("post_head", fused_post_head,
           f"{_SRC}/pointwise.cu", f"{_TPU}/pointwise.py:90", "f32"),
    Kernel("attn_sublayer_train", fused_attn_sublayer_train,
           f"{_SRC}/attn_sublayer.cu", f"{_TPU}/attn_sublayer.py:173",
           "f32"),
    Kernel("attn_sublayer_bwd", attn_sublayer_bwd,
           f"{_SRC}/attn_sublayer.cu", f"{_TPU}/attn_sublayer.py:410",
           "f32"),
    Kernel("ffn_train", fused_ffn_train,
           f"{_SRC}/ffn.cu", f"{_TPU}/ffn.py:215", "f32"),
    Kernel("ffn_bwd", ffn_bwd,
           f"{_SRC}/ffn.cu", f"{_TPU}/ffn.py:450"),
    Kernel("enc_layer", fused_encoder_layer,
           f"{_SRC}/layer_fused.cu", f"{_TPU}/layer_fused.py:77", "f32"),
    Kernel("dec_layer", fused_decoder_layer,
           f"{_SRC}/layer_fused.cu", f"{_TPU}/layer_fused.py:239", "f32"),
    Kernel("attention", fused_attention,
           f"{_SRC}/attention.cu", f"{_TPU}/attention.py:317", "f32"),
    Kernel("attention_bwd", attention_bwd,
           f"{_SRC}/attention.cu", f"{_TPU}/attention.py:409", "f32"),
    Kernel("masked_loss", fused_masked_loss,
           f"{_SRC}/masked_loss.cu", f"{_TPU}/masked_loss.py:28"),
    Kernel("int8_dense", fused_int8_dense,
           f"{_SRC}/int8_matmul.cu", f"{_TPU}/int8_matmul.py:34"),
    Kernel("ffn_int8", fused_ffn_int8,
           f"{_SRC}/ffn.cu", f"{_TPU}/ffn.py:248"),
    Kernel("enc_layer_int8", fused_encoder_layer_int8,
           f"{_SRC}/layer_fused.cu", f"{_TPU}/layer_fused.py:77", "f32"),
    # the precision modes: "high" (bf16x3) and "default" (one bf16 pass)
    Kernel("ffn_high", fused_ffn,
           f"{_SRC}/ffn.cu", f"{_TPU}/ffn.py:200", "bf16x3"),
    Kernel("ffn_default", fused_ffn,
           f"{_SRC}/ffn.cu", f"{_TPU}/ffn.py:215", "bf16"),
    Kernel("ffn_train_high", fused_ffn_train,
           f"{_SRC}/ffn.cu", f"{_TPU}/ffn.py:200", "bf16x3"),
    Kernel("ffn_train_default", fused_ffn_train,
           f"{_SRC}/ffn.cu", f"{_TPU}/ffn.py:215", "bf16"),
    Kernel("ffn_bwd_split_high", ffn_bwd_split,
           f"{_SRC}/ffn.cu", f"{_TPU}/ffn.py:646,679", "bf16x3"),
    Kernel("ffn_bwd_split_default", ffn_bwd_split,
           f"{_SRC}/ffn.cu", f"{_TPU}/ffn.py:646,679", "bf16"),
    Kernel("pre_stream", fused_pre_stream,
           f"{_SRC}/pointwise.cu", f"{_TPU}/pointwise.py:77"),
    Kernel("enc_layer_high", fused_encoder_layer,
           f"{_SRC}/layer_modes.cu", f"{_TPU}/layer_fused.py:77", "bf16x3"),
    Kernel("enc_layer_default", fused_encoder_layer,
           f"{_SRC}/layer_modes.cu", f"{_TPU}/layer_fused.py:77", "bf16"),
    Kernel("dec_layer_high", fused_decoder_layer,
           f"{_SRC}/layer_modes.cu", f"{_TPU}/layer_fused.py:239", "bf16x3"),
    Kernel("dec_layer_default", fused_decoder_layer,
           f"{_SRC}/layer_modes.cu", f"{_TPU}/layer_fused.py:239", "bf16"),
    Kernel("attn_sublayer_high", fused_attn_sublayer,
           f"{_SRC}/attn_sublayer_modes.cu", f"{_TPU}/attn_sublayer.py:135",
           "bf16x3"),
    Kernel("attn_sublayer_default", fused_attn_sublayer,
           f"{_SRC}/attn_sublayer_modes.cu", f"{_TPU}/attn_sublayer.py:135",
           "bf16"),
    Kernel("attn_sublayer_train_high", fused_attn_sublayer_train,
           f"{_SRC}/attn_sublayer_modes.cu", f"{_TPU}/attn_sublayer.py:173",
           "bf16x3"),
    Kernel("attn_sublayer_train_default", fused_attn_sublayer_train,
           f"{_SRC}/attn_sublayer_modes.cu", f"{_TPU}/attn_sublayer.py:173",
           "bf16"),
    Kernel("attn_sublayer_bwd_high", attn_sublayer_bwd,
           f"{_SRC}/attn_sublayer_modes.cu", f"{_TPU}/attn_sublayer.py:410",
           "bf16x3"),
    Kernel("attn_sublayer_bwd_default", attn_sublayer_bwd,
           f"{_SRC}/attn_sublayer_modes.cu", f"{_TPU}/attn_sublayer.py:410",
           "bf16"),
    Kernel("attention_high", fused_attention,
           f"{_SRC}/attention_modes.cu", f"{_TPU}/attention.py:317",
           "bf16x3"),
    Kernel("attention_default", fused_attention,
           f"{_SRC}/attention_modes.cu", f"{_TPU}/attention.py:317", "bf16"),
    Kernel("attention_bwd_high", attention_bwd,
           f"{_SRC}/attention_modes.cu", f"{_TPU}/attention.py:409",
           "bf16x3"),
    Kernel("attention_bwd_default", attention_bwd,
           f"{_SRC}/attention_modes.cu", f"{_TPU}/attention.py:409", "bf16"),
    Kernel("pre_stream_embed_high", fused_pre_stream_embed,
           f"{_SRC}/pointwise_modes.cu", f"{_TPU}/pointwise.py:230",
           "bf16x3"),
    Kernel("pre_stream_embed_default", fused_pre_stream_embed,
           f"{_SRC}/pointwise_modes.cu", f"{_TPU}/pointwise.py:230", "bf16"),
    Kernel("post_head_high", fused_post_head,
           f"{_SRC}/pointwise_modes.cu", f"{_TPU}/pointwise.py:90",
           "bf16x3"),
    Kernel("post_head_default", fused_post_head,
           f"{_SRC}/pointwise_modes.cu", f"{_TPU}/pointwise.py:90", "bf16"),
    # the products the JAX package leaves to XLA (its nn.Dense layers: the
    # per-op projections, the training chains, the Embedding), which run
    # in the ambient mode there: no Pallas body, the Dense call sites
    Kernel("mode_linear_high", mode_linear,
           f"{_SRC}/mode_linear.cu", f"{_XLA}/layers.py:88,112", "bf16x3"),
    Kernel("mode_linear_default", mode_linear,
           f"{_SRC}/mode_linear.cu", f"{_XLA}/layers.py:88,112", "bf16"),
    Kernel("mode_linear_bwd_high", mode_linear_bwd,
           f"{_SRC}/mode_linear.cu", f"{_XLA}/layers.py:88,112", "bf16x3"),
    Kernel("mode_linear_bwd_default", mode_linear_bwd,
           f"{_SRC}/mode_linear.cu", f"{_XLA}/layers.py:88,112", "bf16"),
    # the int8 route's merged encoder layer in a mode (``ff_int8``)
    Kernel("enc_layer_int8_high", fused_encoder_layer_int8,
           f"{_SRC}/layer_modes.cu", f"{_TPU}/layer_fused.py:77", "bf16x3"),
    Kernel("enc_layer_int8_default", fused_encoder_layer_int8,
           f"{_SRC}/layer_modes.cu", f"{_TPU}/layer_fused.py:77", "bf16"),
)


def reset_launches() -> None:
    for k in KERNELS:
        if k.mode is None:
            k.wrapper.launches = 0
        else:
            k.wrapper.launches[k.mode] = 0


def launch_counts() -> dict:
    return {k.name: k.wrapper.launches if k.mode is None
            else k.wrapper.launches[k.mode] for k in KERNELS}

#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card
and hold every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # build, then torch.profiler
                                       # breakdowns (see below)
    python3 chip_smoke.py --sweep      # build, then cluster sizes and
                                       # small-batch latency
    python3 chip_smoke.py --ab DIR     # build, then this tree against the
                                       # tree unpacked in DIR, in turns

Phases (each prints its own lines; any failed check exits non-zero):
  1. device and build: the card's name and power limit, then the nvcc build
     of ``keypoints_interpolation_transformer_torch/csrc/*.cu``;
  2. kernels: every variant of both paths against its plain version at the
     flagship widths (D=256, 8 heads, FF=2048), B=3, T in {128, 40, 256,
     300} with a padded row (the whole-layer kernels with the plain
     model's masks and the Cycle model's, the decoder with and without its
     FF tail, and again at T in {128, 40, 256, 300} with every
     thread-block cluster size from 1 to 8, the int8 encoder layer too:
     padded row tiles and the FF split over 2 to 8 blocks a tile), and the
     training kernels again at T=512 (four key tiles of the backward's
     attention core) with a video whose keys are all padded; then at
     the shapes of the paths (serving B=256, training B=64, T=128), with
     CUDA-event times of kernel and plain version, the bound of each (the
     least time the card could take) and the kernel's share of it, and,
     for the whole layers, their rate of work and the time of the one
     PyTorch call that computes the same layer
     (``torch.nn.TransformerEncoderLayer`` / ``TransformerDecoderLayer``,
     first held against the plain version);
  3. model: the flagship KeypointCompleter (random weights from a seeded
     torch.Generator) at B=256, T=128 on the merged route (the default:
     launches per forward pre_stream_embed 2, enc_layer 6, dec_layer 6,
     post_head 1) and on the per-sublayer route (``merge_layers`` off:
     2 / 18 / 12 / 1), each against the plain path by the bench's rule
     (masked-frame MPJPE delta < 1e-4);
  4. serving: the model saved as a reference .pth, loaded by
     ``Inpainter.from_checkpoint`` and served over HTTP on 127.0.0.1;
     three concurrent /inpaint requests (one longer than 256 frames, so
     both routes run) against the plain-path Inpainter; the launch counts
     of this run;
  5. variants: a Cycle model (over the flagship as its frozen first model)
     and an Embedding autoencoder saved as reference .pth files and served
     by ``Inpainter.from_checkpoint(..., variant=...)`` against the
     plain-path Inpainter;
  6. throughput: Inpainter frames/s at B=256, T=128 on the merged route,
     the per-sublayer route and the plain path, in turns, and the latency
     of one request of one 128-frame video on each;
  7. training: the flagship A1 train step (``train.steps.build_model`` and
     ``make_train_step``) at B=64, T=128 from the same seeded parameters
     and the same on-device corruption, three steps on the kernel path,
     three on the per-op attention route (``attn_sublayer_fusion`` off,
     the JAX package's training route at "highest") and three on the
     plain path: losses within 1e-4 relative, parameters after step 1
     within 1e-4 of their scale, launch counts per step 18 / 18 / 12 / 12
     (serving kernels 0; per op attention 18, attention_bwd 18, ffn_train
     12, ffn_bwd 12); then the step time and frames/s of the three;
  8. the training loop (``train.loop.train``) at the flagship width on
     synthetic videos of 97-128 frames (one bucket of 128), batch 64: a1
     for 2 epochs on the kernel and the plain route from one seed (epoch
     losses within 1e-4 relative; launches 18 / 18 / 12 / 12 per step and
     the per-sublayer serving kernels per eval batch); a1 for 1 epoch with
     sublayer fusion off and the fused loss (attention 18, attention_bwd
     18, ffn_train 12, ffn_bwd 12, masked_loss 1 per step); a3, then a4
     grafted from a3's .pth (the graft bit for bit unchanged); a2 over
     a1's .pth; a 2-epoch run cut after one epoch and resumed from its
     full_state.pt (epoch-2 losses within 1e-5 relative of the whole
     run's); the frames/s of one a1 epoch;
  9. int8 serving (run after phase 5, from its .pth files):
     ``Inpainter(quantize="int8")`` at B=256, T=128 on the merged route
     (launches per forward pre_stream_embed 2, enc_layer_int8 6, dec_layer
     6 without its FF tail, ffn_int8 6, post_head 1) and the per-sublayer
     route (2 / attn_sublayer 18 / ffn_int8 12 / 1), each against the
     plain int8 path (masked MPJPE within twice the plain int8 path's own
     drift on inputs one ulp away, and at least 1e-3: see INT8_DRIFT), int8
     against float32 (masked MPJPE < 0.1, also by
     ``eval.quantize.quantization_error``), frames/s
     and one-video latency beside the float32 merged route; one 600-frame
     request on the per-op route (int8_dense 42, attention 18, ffn_int8
     12); the Cycle pair and the Embedding int8; an HTTP round trip through
     a ``cli serve --quantize int8`` child process; since slice 15 the
     merged route at "high" and "default" (the int8 merged encoder layer
     and the decoder layer in the mode: enc_layer_int8_<mode> 6,
     dec_layer_<mode> 6, ffn_int8 6, the chains' mode rows 2 / 1), each
     against the plain int8 route in the mode on 32 videos (within twice
     that route's spread over float32 summation orders, the plain route on
     the CPU against it on the card, and at least 1e-3; its distance from
     int8 "highest" within 2 x of the plain route's), frames/s in turns
     beside int8 "highest";
 10. widths: every kernel at D in {32, 128, 384, 512} with head widths 8,
     16, 64 and 128, and at D in {384, 512} with one and two heads (head widths
     192 to 512, the attention cores' wide build), against its plain
     version (B=3, T in {40, 128}), then a two-layer model at each serving
     float32 and int8 and taking an A1 train step, each against its plain
     path, with its launch counts;
 11. precision modes (run after phase 8): the per-sublayer Inpainter at
     B=256, T=128 at "highest", "high" (bf16x3) and "default" (one bf16
     pass): launches (ffn_high / ffn_default 12 in place of ffn,
     attn_sublayer_high / _default 18 in place of attn_sublayer), masked
     MPJPE against "highest" (< 1e-4 for "high", the run fails otherwise;
     "default" printed), frames/s in turns; the merged route (the serving
     default) at B=256 in the three precisions: launches (enc_layer_high /
     dec_layer_high 6, pre_stream_embed_high 2 and post_head_high 1 at
     "high", the _default ones at "default"), the
     kernel route against the plain route in the same precision (within
     SERVE_TOL; "default" within MODE_DRIFT times the plain route's spread
     over float32 summation orders, the plain route on the CPU against it
     on the card, and as far from "highest" as the plain route within
     MODE_SEPARATION), masked MPJPE against "highest" beside
     bench.py's 1e-4
     gate and the plain route's figure (the run fails where the kernels
     miss the gate and their plain version does not), frames/s in turns;
     the flagship A1
     step at "high" and "default", kernel route against the plain route in
     the same mode (loss and gradient norm within 1e-4 relative; each
     parameter's gradient of the first step within HIGH_MODE_TOL /
     DEFAULT_MODE_TOL of its own largest value and MODE_SEPARATION times
     nearer than the route one mode down), its
     launches (attn_sublayer_train_high 18, attn_sublayer_bwd_high 18,
     ffn_train_high 12, ffn_bwd_split_high 12, mode_linear_high and
     mode_linear_bwd_high 9 for the chains' Dense products, each weight
     split once a step, ``weight_planes.splits`` as many as mode_linear's
     launches, the float32 ones 0; the chain parameters' gradients
     printed apart), two
     "high" runs from one seed equal bit for bit, step time beside the
     float32 step, loss against it; one A1 step with sublayer fusion off
     at "high" and at "default" (attention_<mode> 18, attention_bwd_<mode>
     18, the FF modes 12 each, mode_linear_<mode> and its backward 51:
     the chains' 9 and the projections' 7 a layer pair) against its plain
     route in the mode, the
     same way; one epoch of ``cli train --precision
     high`` (the mode's sublayer and FF kernels, no float32 one); an HTTP
     request through a ``cli serve --precision high`` child process (a
     300-frame video, so the encoder runs per sublayer in the mode:
     attn_sublayer_high 6, ffn_high 12) against the plain path in the
     mode.

Phase 2 also holds the precision modes' kernels (``ffn`` and
``ffn_train`` in "high" and "default" at B=256 and B=64, ``ffn_bwd_split``
in "high" and "default", ``pre_stream`` with and without the Cycle
residual) against their plain
versions in the same mode, each output against its own largest value and
each mode kernel nearer its own mode than the one below it (see
HIGH_MODE_TOL), each bound at its mode's peak (bf16 tensor
cores, three passes for "high"), each FF mode row timed beside a
products-only yardstick (its matrix products as ``torch.matmul`` on bf16
planes, labelled as not the same function), the merged layers' mode
kernels (``enc_layer`` / ``dec_layer`` in "high" and "default", the
decoder with and without its FF tail, both models' masks, at B=3 and T in
{40, 128, 256, 300}, the decoder without its tail at T=512, timed at
B=256 beside a yardstick of their products with their launches, held to
CALL_LAUNCHES (3 a layer for the encoder, 5 for the decoder, on the
two-kernel attention halves that ``layer_fused.mode_layer_fused`` takes
at kernel width 256, 32-wide heads and T <= 128; T 256 and 300 run the
longer launch chain), also at n = 224 with 7 heads (a padded head
slice); held by LAYER_MODE_TOL, and in phase 10 at every width), the
attention sublayer's mode kernels
(``attn_sublayer``, ``attn_sublayer_train`` and ``attn_sublayer_bwd`` in
"high" and "default", the model's three sublayers, B=3 at T in {40, 128,
256, 300, 512} with a training video whose keys are all padded, the
serving row timed at B=256 and the training rows at B=64 beside a
yardstick of their products and their launches; held like the merged
layers, and in phase 10 at every width), and the int8 kernels (int8_dense at the Embedding's
Linear, 108 -> 256, and at a q / k / v projection, 256 -> 768, also at the
600-frame request's 608 rows; ffn_int8 with LN1; enc_layer_int8 with both
models' masks) against their plain versions and against ``torch._int_mm``
with the plain quantize and dequantize steps (their library time), the
per-op attention kernels at T in {40, 512, 608,
2048} (repeat-inc with and without the key padding, "all" with all-ones
masks, cross-attention, padded keys, a video whose keys are all padded;
``attention_bwd`` standalone, which runs the forward first as
``scaled_dot_product_attention``'s autograd call does, and given the
forward's out and stats, as the training route calls it: that form's
time is printed beside the standalone row; the pair in "high" and
"default" at the same lengths and masks, against its plain version in the
mode and one mode down, timed at B=64), the masked loss with padded
frames, and the pointwise chains in "high" and "default" (with and
without the Cycle residual and the embedding out, timed at B=256);
``mode_linear`` and ``mode_linear_bwd`` in "high" and "default" at a q /
k / v projection (256 -> 768, timed at B=64), the 108-wide embedding and
the head (their widths padded to 112), beside ``torch.mm`` on bf16
operands with a float32 output at "default" (its library call) and a
products-only yardstick; the launches a call of the timed rows read from
the profiler and held to ``CALL_LAUNCHES`` (``mode_linear`` one, the
sublayer's backward in a mode seven at T=128, given the forward's planes
of x and a, each pointwise chain in a mode one at D=256); the int8
merged encoder layer in "high" and
"default" with both models' masks (timed at B=256); a
forward's statistics are held over the videos with a real key (a video
whose keys are all padded holds a -1e9 sentinel); phase 5 also serves one
600-frame video (bucket 608, above the sublayer kernel's 512) on the
per-op route: attention 18, ffn 12, pre_stream_embed 2, post_head 1; and
again at "high" (attention_high 18, ffn_high 12, pre_stream_embed_high 2,
post_head_high 1, mode_linear_high 42 for its projections; a warm
request splits no weight: ``weight_planes.splits`` 0), masked MPJPE
against "highest" beside bench.py's gate
and the plain route's figure in the mode (the run fails where the kernels
miss the gate and their plain version does not).

``--profile`` prints, after the build, the device time by kernel of one
train step (float32, per op, and at "high" and "default", fused and per
op), of one merged-route and one
per-sublayer "high" Inpainter call and of one a1 epoch of the loop (with
its device idle share and the host work in it).  ``--sweep`` prints the
whole-layer kernels' times at T=128 for B in {256, 64, 8, 1} with clusters
of 1, 2, 4 and 8 blocks per video (and the size the wrapper picks), then
the latency of one Inpainter call per route (the int8 merged route too)
at small batches and the merged and per-sublayer frames/s at B=256.
``--ab DIR`` builds this tree's and DIR's kernels at once, then measures
each tree in a fresh process in turns (DIR, this, this, DIR): the merged
Inpainter's frames/s at B=256, the merged and per-sublayer latency at 1 /
4 / 16 / 64 videos, the latency of phase 5's 600-frame request (per op)
in float32 and int8, the A1 step time on the default route and with
sublayer fusion off, and at "high" and "default" (fused and per op, each
beside one profiled step's device busy and wall time), the int8 merged
Inpainter's frames/s in the three precisions, the per-sublayer
Inpainter's frames/s in the three precisions and its one-video latency
at "high", with the routes' output sums and the steps' first
losses, which equal bit for bit where the kernels they run are
unchanged, every kernel row's output sums on phase 2's seeded operands
(float32, int8 and mode kernels; ``mode_linear_bwd`` given the same
planes), and the merged outputs' difference between the trees.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card it exits 1 and prints
no result.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

# the batch and widths of the flagship serving cell and training step
B_MAIN, T_MAIN = 256, 128
B_TRAIN = 64
D, HEADS, FF, LAYERS, F_IN = 256, 8, 2048, 6, 108
# the card's peaks (NVIDIA H100 SXM data sheet, dense): float32 FFMA, int8
# tensor-core operations, HBM3, bf16 tensor cores
PEAK_FLOPS, PEAK_INT8, PEAK_BYTES = 67e12, 1979e12, 3.35e12
PEAK_BF16 = 989e12
# f32 FFMA kernels against cuBLAS f32: the same products summed in another
# order (over contraction depths up to 2048) differ by a few ulp of the
# partial sums; 1e-4 of the output's scale leaves an order of magnitude of
# room above that
REL_TOL = 1e-4
# gradients: the same, over sums of up to 8192 rows; compared against the
# largest gradient of the call, since some (the k-bias) are exactly zero in
# exact arithmetic and only noise in float32
GRAD_TOL = 1e-4
# the train step: three steps through 6+6 layers forward and backward, the
# differences above compounded (float32 noise in the loss is ~1e-6)
LOSS_RTOL = 1e-4
MPJPE_TOL = 1e-4  # bench.py's gate
# the FF kernels of the precision modes against their plain versions in the
# same mode, each output against its own largest value (no output of the FF
# sublayer or of its backward is zero in exact arithmetic).  Each limit lies
# between the sound reading (the kernel against its own mode) and the
# reading of the wrong mode (the kernel against the plain version one mode
# down: one bf16 pass for "high", float32 for "default"); on an H100 the
# worst over phase 2's shapes (PERF.md §6):
# - "high" (bf16x3): its lo parts carry what a hi rounded the other way
#   loses, so what is left is float32 summation order plus the dropped
#   lo*lo term, some 2^-16 of a product.  Largest error 6.5e-6 sound, at
#   least 5.6e-4 in the wrong mode on every output the mode moves;
# - "default" (one bf16 pass): an operand the kernel and its plain version
#   compute in another float32 order (a LayerNorm output, u summed over D,
#   GELU of it) can fall on the other side of a bf16 rounding boundary and
#   move its product by one bf16 step (2^-8 of the term).  Largest error
#   4.2e-4 sound against 5.6e-4 wrong, too close for a limit, so the
#   largest is held under a cap and the mean decides: such flips are rare,
#   while a kernel off its mode misses every output.  Mean error 3.4e-6
#   sound, at least 8.7e-5 wrong.
HIGH_MODE_TOL = 1e-4
DEFAULT_MODE_TOL = 2e-3
DEFAULT_MEAN_TOL = 1.5e-5
# and each mode kernel is nearer its own mode's plain version than the
# wrong mode's by this factor, over the worst output of the call: a kernel
# that runs the wrong number of passes, or skips the bf16 rounding, fails
MODE_SEPARATION = 2.0
WRONG_MODE = {"bf16x3": "bf16", "bf16": "f32"}
# the FF kernels held per output as above
FF_MODE_TOL = {"ffn_high": HIGH_MODE_TOL, "ffn_train_high": HIGH_MODE_TOL,
               "ffn_bwd_split_high": HIGH_MODE_TOL,
               "ffn_default": DEFAULT_MODE_TOL,
               "ffn_train_default": DEFAULT_MODE_TOL,
               "ffn_bwd_split_default": DEFAULT_MODE_TOL}
# the Dense products the JAX package leaves to XLA, in a mode: one product
# (its backward two), held per output as the FF kernels are
LINEAR_MODE_KERNELS = ("mode_linear_high", "mode_linear_default",
                       "mode_linear_bwd_high", "mode_linear_bwd_default")
# the int8 route's merged encoder layer in a mode
INT8_MODE_KERNELS = ("enc_layer_int8_high", "enc_layer_int8_default")
# the per-op attention's backward and the pointwise chains in a mode: no
# probability rounded to one bf16 in their products ("high" splits the
# backward's float32 p for dv), so each output is held per output as the FF
# kernels are, "default" by its mean too
OP_MODE_TOL = {"attention_bwd_high": HIGH_MODE_TOL,
               "attention_bwd_default": DEFAULT_MODE_TOL,
               "pre_stream_embed_high": HIGH_MODE_TOL,
               "pre_stream_embed_default": DEFAULT_MODE_TOL,
               "post_head_high": HIGH_MODE_TOL,
               "post_head_default": DEFAULT_MODE_TOL,
               **{k: HIGH_MODE_TOL if k.endswith("_high") else
                  DEFAULT_MODE_TOL for k in LINEAR_MODE_KERNELS}}
# The per-op backward at "default" rounds dl = p (gw - delta) / sqrt(dh) to
# ONE bf16 before dq = dl k and dk = dl^T q, so a dl whose float32 value two
# summation orders put on either side of a bf16 rounding midpoint moves its
# key's dk by one bf16 step of dl times q.  On the standing draw
# (``flip_draw_calls``) one dl lies 3 float32 ulps from a midpoint
# (``FLIP_DL``, ``flip_dl_orders``), and the kernel and the plain version
# round it apart, 2.075e-03 of dk's max, in the two rows whose softmax is
# the same (``FLIP_ROWS``).  Those rows alone take "default"'s flip cap, as
# the sublayer and merged-layer mode rows do, and the mean decides: within
# DEFAULT_MEAN_TOL, and MODE_SEPARATION times nearer its own mode than the
# wrong one.  Every other row keeps its max-error limit.
FLIP_TOL = 4e-3
ATTN_MODE_KERNELS = ("attention_high", "attention_default",
                     "attention_bwd_high", "attention_bwd_default")
CHAIN_MODE_KERNELS = ("pre_stream_embed_high", "pre_stream_embed_default",
                      "post_head_high", "post_head_default")
# the attention sublayer's six mode rows, beside whose times phase 2 prints
# a products-only yardstick too
SUBLAYER_MODE_SERVE = ("attn_sublayer_high", "attn_sublayer_default")
SUBLAYER_MODE_TRAIN = ("attn_sublayer_train_high",
                       "attn_sublayer_train_default", "attn_sublayer_bwd_high",
                       "attn_sublayer_bwd_default")
SUBLAYER_MODE_KERNELS = SUBLAYER_MODE_SERVE + SUBLAYER_MODE_TRAIN
# the merged layers in a mode against their plain versions in that mode.
# Both modes round the softmax probabilities to ONE bf16 (the TPU kernels'
# _prob_parts), so a probability whose float32 value the two sum orders
# put on either side of a bf16 rounding boundary moves by one bf16 step,
# and its query's token by up to 2^-8 of that probability's share of v.
# The largest error is such a flip (worst over phases 2 and 10, PERF.md
# §6: 6.1e-5 of the output's max at "high", 5.0e-4 at "default", where
# the wrong mode's can be as low as 1.2e-4), too close to the wrong mode
# for a limit, so the mean decides: flips are rare, while a kernel off
# its mode misses every output (mean at most 5.4e-7 at "high" and 1.1e-5
# at "default", the wrong mode's at least 125 and 8.8 times further).
# Each output within LAYER_MODE_TOL of its own max, the
# mean at "high" within LAYER_HIGH_MEAN_TOL, and the mean error
# MODE_SEPARATION times nearer the plain version in its own mode than in
# the wrong one.
# The attention sublayer's mode kernels are held the same way: they round
# p to one bf16 as the merged layers do, and their backward rebuilds it, so
# a flip moves a few tokens' outputs and gradients.
LAYER_MODE_TOL = {"enc_layer_high": 1e-3, "dec_layer_high": 1e-3,
                  "enc_layer_default": 4e-3, "dec_layer_default": 4e-3,
                  **{k: 1e-3 if k.endswith("_high") else 4e-3
                     for k in SUBLAYER_MODE_KERNELS}}
# The per-op attention forward in a mode rounds p to one bf16 too, and its
# output is the raw a, a flip undiluted: held as RAW_A_TOL holds a, the
# mean deciding.
LAYER_MODE_TOL.update({"attention_high": 4e-3, "attention_default": 4e-3})
# The training forward also returns the raw attention output a (its third
# output), where a flipped probability is not diluted by the out-projection
# and the LayerNorm: it moves an element by one bf16 step of that
# probability times a value of v, the same step in both modes (worst seen at
# B=64: 1.59e-3 of a's max at "high", 1.27e-3 at "default", the means 9e-7
# and the wrong mode's 5e-4; PERF.md §6).  That one output takes the flip
# cap of "default" in both modes, and the mean decides.
RAW_A_TOL = {"attn_sublayer_train_high": (2, 4e-3),
             "attn_sublayer_train_default": (2, 4e-3)}
LAYER_HIGH_MEAN_TOL = 2e-5
# A whole model at "default" rounds every activation to one bf16, so the
# flips above cascade through 6 + 6 layers and the pointwise chains: served
# at B=256, any two float32 summation orders of the same arithmetic land
# about 1.06e-3 masked MPJPE apart (the plain route on the card against the
# plain route on the CPU; kernel layers or chains in either's place the
# same), while "default" lies 1.84e-3 from "highest" (PERF.md §7).  So the
# merged route at "default" is held within MODE_DRIFT times the plain
# route's own spread over summation orders (``order_drift``: the plain
# route on the card against the plain route on the CPU), and, since that
# limit reaches as far as "highest" lies, its distance from "highest"
# within MODE_SEPARATION of its plain route's either way (a float32 route
# lies about 0 from it, a "high" one 3e-5); "high" stays within SERVE_TOL.
MODE_DRIFT = 2.0
# int8 kernels against their plain versions: the same int8 values and exact
# int32 sums on both sides, except where the float32 value being quantized
# (a LayerNorm or GELU output, summed in another order by the two) lies
# within an ulp of a rounding boundary: it then quantizes one step the other
# way (some 3e-6 of the values; a row of 2048 GELU outputs holds one in
# about 0.6 % of rows), moving the outputs that read it by about 1/127 of
# its row's absmax times a weight, some 1e-3.  So no output may move by
# more than INT8_TOL of max(1, scale), and the mean by no more than
# INT8_MEAN_TOL: a wrong kernel misses both by orders of magnitude.
INT8_TOL = 1e-2
INT8_MEAN_TOL = 1e-5
# served int8 predictions against the plain int8 path (masked MPJPE).
# Through 6 + 6 layers the flips above cascade: a value moved by a step
# moves the next layer's inputs by about 1e-3 of their scale, which flips
# more of its quantizations, so two int8 routes whose float32 arithmetic
# differs in the last bit drift apart by about the int8 error itself.  The
# plain int8 path on inputs moved by one ulp measures that drift (its
# floor) in each run; a route passes within INT8_DRIFT times the floor, or
# within INT8_MPJPE_TOL where the floor is below half of it.
INT8_MPJPE_TOL = 1e-3
INT8_DRIFT = 2.0
# the int8 route's merged encoder layer in a mode: its attention half flips
# a bf16 probability as the merged mode layers do (LAYER_MODE_TOL), and its
# int8 tail quantizes LN1's output, which a flip or the sum order moves one
# step the other way (INT8_TOL): each output within INT8_TOL of its own
# max, the mean within the int8 kernels' mean cap plus the merged mode
# layer's own (at most 5.4e-7 at "high" and 1.1e-5 at "default" above),
# and the mean MODE_SEPARATION times nearer its own mode
LAYER_MODE_TOL.update(dict.fromkeys(INT8_MODE_KERNELS, INT8_TOL))
INT8_LAYER_MEAN_TOL = {"enc_layer_int8_high": INT8_MEAN_TOL + 2e-5,
                       "enc_layer_int8_default": INT8_MEAN_TOL + 4e-5}
# int8 against float32 served predictions (masked MPJPE): the JAX serving
# test's bound (tests/test_eval.py)
INT8_VS_F32 = 0.1
# served predictions through 6+6 layers: the per-kernel differences above,
# compounded; no coordinate may move by more than this
SERVE_TOL = 1e-3
DEV = "cuda"


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def timed_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def real_stats(fn, i, valid):
    """``fn`` with its output i, statistics (B, H, T, 2), kept only for
    the videos that have a real key: a video whose keys are all padded
    holds the -1e9 sentinel as its rows' maximum, which would set the
    output's scale and so its tolerance."""
    idx = valid.any(1).nonzero().squeeze(1)

    def call():
        out = list(fn())
        out[i] = out[i].index_select(0, idx)
        return tuple(out)
    return call


TRAIN_KERNELS = ("attn_sublayer_train", "attn_sublayer_bwd", "ffn_train",
                 "ffn_bwd")
SERVING_KERNELS = ("pre_stream_embed", "attn_sublayer", "ffn", "post_head",
                   "enc_layer", "dec_layer")
# the per-op attention kernels and the masked loss: timed at the training
# batch, like the training kernels
PER_OP_KERNELS = ("attention", "attention_bwd", "masked_loss")
# the whole-layer kernels: phase 2 prints their rate of work beside their
# bound and library time
LAYER_KERNELS = ("enc_layer", "dec_layer", "enc_layer_int8")
ATTN_T = (40, 512, 608, 2048)  # the per-op kernels' lengths in phase 2
# the variant of attention_bwd given the forward's out and stats (the
# training route's form); the standalone form runs the forward first
RESIDUAL_FORM = "given out and stats"
# the int8 serving kernels: timed at the serving batch
INT8_KERNELS = ("int8_dense", "ffn_int8", "enc_layer_int8")
# the precision modes' kernels ("high": bf16x3, "default": one bf16 pass)
# and the pre-stream chain on an embedding: serving ones timed at the
# serving batch, training ones at the training batch
MODE_SERVE_KERNELS = ("ffn_high", "ffn_default", "pre_stream",
                      *SUBLAYER_MODE_SERVE, *CHAIN_MODE_KERNELS)
MODE_TRAIN_KERNELS = ("ffn_train_high", "ffn_train_default",
                      "ffn_bwd_split_high", "ffn_bwd_split_default",
                      *SUBLAYER_MODE_TRAIN, *ATTN_MODE_KERNELS)
# the six rows of the precision modes' FF kernels, beside whose times phase
# 2 prints a products-only yardstick (``products_yardstick``)
MODE_FF_KERNELS = ("ffn_high", "ffn_default", "ffn_train_high",
                   "ffn_train_default", "ffn_bwd_split_high",
                   "ffn_bwd_split_default")
# the merged layers' mode kernels: held and timed in phase 2 like the FF
# mode kernels (LAYER_MODE_TOL), served in phase 11 on the merged route
LAYER_MODE_KERNELS = ("enc_layer_high", "enc_layer_default",
                      "dec_layer_high", "dec_layer_default")
# every kernel of ops/kernels.KERNELS, launched no time
NO_LAUNCHES = dict.fromkeys(
    ("pre_stream_embed", "attn_sublayer", "ffn", "post_head",
     "attn_sublayer_train", "attn_sublayer_bwd", "ffn_train", "ffn_bwd",
     "enc_layer", "dec_layer", "attention", "attention_bwd", "masked_loss",
     *INT8_KERNELS, *MODE_SERVE_KERNELS, *MODE_TRAIN_KERNELS,
     *LAYER_MODE_KERNELS, *LINEAR_MODE_KERNELS, *INT8_MODE_KERNELS), 0)
# the training step's launches of each kernel: 18 attention sublayers, 12
# FF sublayers, forward and backward; none of the serving kernels
TRAIN_COUNTS = {**NO_LAUNCHES, "attn_sublayer_train": 18,
                "attn_sublayer_bwd": 18,
                "ffn_train": 12, "ffn_bwd": 12}
# one flagship forward at T=128: the merged route (whole layers) and the
# per-sublayer route (merge_layers off)
MERGED_COUNTS = {**NO_LAUNCHES, "pre_stream_embed": 2, "enc_layer": LAYERS,
                 "dec_layer": LAYERS, "post_head": 1}
SUBLAYER_COUNTS = {**NO_LAUNCHES, "pre_stream_embed": 2,
                   "attn_sublayer": 3 * LAYERS, "ffn": 2 * LAYERS,
                   "post_head": 1}
# one forward above the sublayer kernel's 512 frames: attention per op
PER_OP_COUNTS = {**NO_LAUNCHES, "pre_stream_embed": 2,
                 "attention": 3 * LAYERS, "ffn": 2 * LAYERS, "post_head": 1}
# int8 serving (``Inpainter(quantize="int8")``), one flagship forward: the
# merged route at T=128 (the encoder layer with its FF int8; the decoder
# layer without its FF tail, then the int8 FF sublayer; the pointwise
# kernels float, as on the TPU), the per-sublayer route, and the per-op
# route above 512 frames (q / k / v, out projections int8: 2 per
# self-attention, 3 for cross-attention, whose q and k / v inputs differ)
INT8_MERGED_COUNTS = {**NO_LAUNCHES, "pre_stream_embed": 2,
                      "enc_layer_int8": LAYERS, "dec_layer": LAYERS,
                      "ffn_int8": LAYERS, "post_head": 1}
INT8_SUBLAYER_COUNTS = {**NO_LAUNCHES, "pre_stream_embed": 2,
                        "attn_sublayer": 3 * LAYERS, "ffn_int8": 2 * LAYERS,
                        "post_head": 1}
INT8_PER_OP_COUNTS = {**NO_LAUNCHES, "pre_stream_embed": 2,
                      "attention": 3 * LAYERS, "int8_dense": 7 * LAYERS,
                      "ffn_int8": 2 * LAYERS, "post_head": 1}
# the per-op route's Dense products a layer pair in a mode (``mode_linear``):
# q / k / v and the out-projection, 2 per self-attention, 3 for
# cross-attention; and an A1 step's chains under autograd: the two
# pre-stream chains' embedding, [fc1 | fc2] and fc3, the head's three
PER_OP_DENSE, CHAIN_DENSE = 7, 9
# the 600-frame request at "high": its per-op cores, FF sublayers and
# pointwise chains in the mode, its projections through mode_linear
PER_OP_HIGH_COUNTS = {**NO_LAUNCHES, "pre_stream_embed_high": 2,
                      "attention_high": 3 * LAYERS, "ffn_high": 2 * LAYERS,
                      "post_head_high": 1,
                      "mode_linear_high": PER_OP_DENSE * LAYERS}
# the per-op training step with the fused loss
PER_OP_TRAIN_COUNTS = {**NO_LAUNCHES, "attention": 3 * LAYERS,
                       "attention_bwd": 3 * LAYERS, "ffn_train": 2 * LAYERS,
                       "ffn_bwd": 2 * LAYERS, "masked_loss": 1}
# (variant, cross-attention, post-LN, mask kind, add_keypad): the three
# attention sublayers of the model
ATTN_VARIANTS = (("enc self repeat-inc+keypad", False, False, "repeat-inc",
                  True),
                 ("dec self repeat-inc+post-LN", False, True, "repeat-inc",
                  False),
                 ("cross all", True, False, "all", False))


class KernelCheck:
    """Runs every kernel variant against its plain version on the card."""

    def __init__(self, torch, kmod, d=D, heads=HEADS, ff=FF, dev=DEV):
        self.torch, self.k = torch, kmod
        self.d, self.heads, self.ff, self.dev = d, heads, ff, dev
        self.g = torch.Generator().manual_seed(1234)
        self.max_err = {}
        self.layer_args = {}

    def rand(self, *shape, scale=1.0, lo=None, hi=None):
        t = self.torch
        if lo is not None:
            x = t.rand(*shape, generator=self.g) * (hi - lo) + lo
        else:
            x = t.randn(*shape, generator=self.g) * scale
        return x.to(self.dev).contiguous()

    def weight(self, fan_in, fan_out):
        b = 1.0 / fan_in ** 0.5
        return self.rand(fan_in, fan_out, lo=-b, hi=b)

    def masks(self, B, T):
        t = self.torch
        mask = (t.rand(B, T, generator=self.g) < 0.3).float()
        valid = t.ones(B, T)
        valid[min(1, B - 1), T - max(T // 5, 1):] = 0.0  # a padded row
        return mask.to(self.dev).contiguous(), valid.to(self.dev).contiguous()

    def compare(self, name, variant, got, want, grad=False, wrong=None,
                flip=False):
        """Each output within REL_TOL of max(1, its scale), or, for
        gradients (``grad``), within GRAD_TOL of the largest gradient of
        the call; an int8 kernel's (``name`` in INT8_KERNELS) within
        INT8_TOL of max(1, its scale) and INT8_MEAN_TOL of it on average;
        an FF kernel of the precision modes (``name`` in FF_MODE_TOL, and
        the per-op backward and the chains in OP_MODE_TOL) within its
        mode's limit of each output's own largest value and,
        given ``wrong`` (the plain version's outputs in the wrong mode),
        MODE_SEPARATION times nearer ``want`` than ``wrong``; a row on a
        draw whose bf16 rounding flips between float32 orders (``flip``)
        within FLIP_TOL, the mean deciding."""
        t = self.torch
        t.cuda.synchronize()
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        if len(gots) != len(wants):
            fail(f"{name} {variant}: {len(gots)} outputs != {len(wants)}")
        wrongs = ((wrong if isinstance(wrong, tuple) else (wrong,))
                  if wrong is not None else (None,) * len(wants))
        pairs = [(i, g_, w_, x_) for i, (g_, w_, x_) in enumerate(
            zip(gots, wants, wrongs)) if not (g_ is None and w_ is None)]
        gscale = max(float(w_.abs().max()) for _, _, w_, _ in pairs)
        base = name.split()[0]
        layer_mode = base in LAYER_MODE_TOL
        by_mean = layer_mode or flip  # the mean decides the mode
        mode_tol = LAYER_MODE_TOL[base] if layer_mode else \
            FF_MODE_TOL.get(base, OP_MODE_TOL.get(base))
        # normalized: own mode, wrong mode (the largest errors; the mean
        # errors for the merged layers)
        worst = [0.0, 0.0]
        for i, g_, w_, x_ in pairs:
            if g_ is None or w_ is None or g_.shape != w_.shape:
                shapes = [None if t_ is None else tuple(t_.shape)
                          for t_ in (g_, w_)]
                fail(f"{name} {variant}: output {shapes[0]} != {shapes[1]}")
            if not bool(t.isfinite(g_).all()):
                fail(f"{name} {variant}: non-finite output")
            err = float((g_ - w_).abs().max())
            scale = max(1.0, float(w_.abs().max()))
            tol = GRAD_TOL * gscale if grad else REL_TOL * scale
            mean = ""
            if mode_tol is not None:
                own = float(w_.abs().max()) or 1.0
                raw = RAW_A_TOL.get(base)
                tol = (raw[1] if raw and raw[0] == i else
                       FLIP_TOL if flip else mode_tol) * own
                avg = float((g_ - w_).abs().mean()) / own
                worst[0] = max(worst[0], avg if by_mean else err / own)
                mean = (f" = {err / own:.3e} of its max {own:.3e}, mean "
                        f"{avg:.3e}")
                if x_ is not None:
                    werr = float((g_ - x_).abs().max()) / own
                    wavg = float((g_ - x_).abs().mean()) / own
                    worst[1] = max(worst[1], wavg if by_mean else werr)
                    mean += f"; wrong mode {werr:.3e}, mean {wavg:.3e}"
                if (base in FF_MODE_TOL or base in OP_MODE_TOL) and \
                        base.endswith("_default") and avg > DEFAULT_MEAN_TOL:
                    fail(f"{name} {variant}: mean abs err {avg:.3e} of its "
                         f"max > {DEFAULT_MEAN_TOL:.1e}")
                if layer_mode and base.endswith("_high") and \
                        base not in INT8_MODE_KERNELS and \
                        avg > LAYER_HIGH_MEAN_TOL:
                    fail(f"{name} {variant}: mean abs err {avg:.3e} of its "
                         f"max > {LAYER_HIGH_MEAN_TOL:.1e}")
                if base in INT8_MODE_KERNELS and \
                        avg > INT8_LAYER_MEAN_TOL[base]:
                    fail(f"{name} {variant}: mean abs err {avg:.3e} of its "
                         f"max > {INT8_LAYER_MEAN_TOL[base]:.1e}")
            if name.split()[0] in INT8_KERNELS:
                tol = INT8_TOL * scale
                avg = float((g_ - w_).abs().mean())
                mean = (f" mean {avg:.3e} (tol {INT8_MEAN_TOL * scale:.2e}; "
                        f"{int(((g_ - w_).abs() > REL_TOL * scale).sum())} "
                        f"of {g_.numel()} beyond {REL_TOL * scale:.2e})")
                if avg > INT8_MEAN_TOL * scale:
                    fail(f"{name} {variant}: mean abs err {avg:.3e}")
            self.max_err[name] = max(self.max_err.get(name, 0.0), err)
            print(f"  {name:16s} {variant:34s} max_abs_err {err:.3e} "
                  f"(tol {tol:.2e}){mean}", flush=True)
            if err > tol:
                fail(f"{name} {variant}: max_abs_err {err:.3e} > {tol:.2e}")
        if wrong is not None:
            what = "mean" if by_mean else "worst"
            print(f"  {name:16s} {variant:34s} {what} of the call: own mode "
                  f"{worst[0]:.3e}, wrong mode {worst[1]:.3e} (at least "
                  f"{MODE_SEPARATION:g} x further)", flush=True)
            if not worst[0] * MODE_SEPARATION < worst[1]:
                fail(f"{name} {variant}: no nearer its own mode's plain "
                     f"version ({worst[0]:.3e}) than the wrong mode's "
                     f"({worst[1]:.3e})")

    def operands(self, B, T):
        w, D, FF = self.weight, self.d, self.ff
        return {
            "x_in": self.rand(B, T, F_IN, lo=0.2, hi=0.8),
            "wemb": w(F_IN, D), "bemb": self.rand(D, scale=0.05),
            "pe": self.rand(T, D),
            "w12": w(D, 2 * D), "b12": self.rand(2 * D, scale=0.05),
            "w3": w(D, D), "b3": self.rand(D, scale=0.05),
            "wh": w(D, F_IN), "bh": self.rand(F_IN, scale=0.05),
            "x": self.rand(B, T, D), "mem": self.rand(B, T, D),
            "wqkv": w(D, 3 * D), "bqkv": self.rand(3 * D, scale=0.05),
            "wo": w(D, D), "bo": self.rand(D, scale=0.05),
            "g": 1.0 + self.rand(D, scale=0.1), "be": self.rand(D, scale=0.1),
            "w1": w(D, FF), "b1": self.rand(FF, scale=0.05),
            "w2": w(FF, D), "b2": self.rand(D, scale=0.05),
            "cwqkv": w(D, 3 * D), "cbqkv": self.rand(3 * D, scale=0.05),
            "cwo": w(D, D), "cbo": self.rand(D, scale=0.05),
            "g2": 1.0 + self.rand(D, scale=0.1),
            "be2": self.rand(D, scale=0.1),
        }

    def calls(self, B, T):
        """(kernel name, variant, wrapper call, plain call) at (B, T)."""
        k, o = self.k, self.operands(B, T)
        mask, valid = self.masks(B, T)
        out = []
        # the pointwise kernels take D % 128 == 0 (narrower models take the
        # plain chains, as the JAX package's XLA chains)
        for pe_res in (False, True) if self.d % 128 == 0 else ():
            for want_emb in (False, True):
                args = (o["x_in"], o["wemb"], o["bemb"], o["pe"], o["w12"],
                        o["b12"], o["w3"], o["b3"], pe_res, want_emb)
                out.append(("pre_stream_embed",
                            f"pe_residual={pe_res} want_emb={want_emb}",
                            lambda a=args: k.fused_pre_stream_embed(*a),
                            lambda a=args: k.pre_stream_embed_plain(*a)))
        w = (o["wqkv"], o["bqkv"], o["wo"], o["bo"])
        for variant, mem, ln, kind, keypad in ATTN_VARIANTS:
            mem = o["mem"] if mem else None
            ln = (o["g"], o["be"]) if ln else (None, None)
            args = (o["x"], mem, *w, *ln, mask, valid, kind, keypad,
                    self.heads)
            out.append(("attn_sublayer", variant,
                        lambda a=args: k.fused_attn_sublayer(*a),
                        lambda a=args: k.attn_sublayer_plain(*a)))
        args = (o["x"], o["w1"], o["b1"], o["w2"], o["b2"], o["g"], o["be"],
                o["g"], o["be"], True)
        out.append(("ffn", "pre_ln", lambda a=args: k.fused_ffn(*a),
                    lambda a=args: k.ffn_plain(*a)))
        args = (o["x"], o["mem"], o["w12"], o["b12"], o["w3"], o["b3"],
                o["wh"], o["bh"])
        if self.d % 128 == 0:
            out.append(("post_head", "", lambda a=args: k.fused_post_head(*a),
                        lambda a=args: k.post_head_plain(*a)))
        return out + self.layer_calls(o, mask, valid)

    def forward_calls(self, B, T, every=False):
        """(kernel name, variant, wrapper call, plain call) of the four
        float32 sublayer forwards at (B, T): the FF sublayer with LN1 (and
        without it, with ``every``) and the encoder's self-attention (every
        attention sublayer of the model, with ``every``); the attention
        sublayers only up to 512 frames, their route's limit."""
        k, o = self.k, self.operands(B, T)
        mask, valid = self.masks(B, T)
        out = []
        for pre_ln in (True, False) if every else (True,):
            args = (o["x"], o["w1"], o["b1"], o["w2"], o["b2"], o["g"],
                    o["be"], o["g2"], o["be2"], pre_ln)
            variant = "pre_ln" if pre_ln else "post-LN only"
            out += [("ffn", variant, lambda a=args: k.fused_ffn(*a),
                     lambda a=args: k.ffn_plain(*a)),
                    ("ffn_train", variant,
                     lambda a=args: k.fused_ffn_train(*a),
                     lambda a=args: k.ffn_train_plain(*a))]
        if T > 512:
            return out
        for variant, mem, ln, kind, keypad in (ATTN_VARIANTS if every
                                               else ATTN_VARIANTS[:1]):
            mem = o["mem"] if mem else None
            ln = (o["g"], o["be"]) if ln else (None, None)
            args = (o["x"], mem, o["wqkv"], o["bqkv"], o["wo"], o["bo"], *ln,
                    mask, valid, kind, keypad, self.heads)
            out += [("attn_sublayer", variant,
                     lambda a=args: k.fused_attn_sublayer(*a),
                     lambda a=args: k.attn_sublayer_plain(*a)),
                    ("attn_sublayer_train", variant,
                     lambda a=args: k.fused_attn_sublayer_train(*a)[:5],
                     lambda a=args: k.attn_sublayer_train_plain(*a))]
        return out

    def int8_calls(self, B, T):
        """(kernel name, variant, wrapper call, plain call) of the int8
        serving kernels at (B, T), their weights quantized as the model
        packs them (``int8_matmul.quantize_weight``): the int8 dense layer
        at the Embedding variant's first Linear (B T rows, 108 -> D) and at
        a per-op route's q / k / v projection (B T rows, D -> 3D); the int8
        FF sublayer with LN1; the merged encoder
        layer with its FF tail int8, with the plain model's and the Cycle
        model's masks.  The first of each is timed in phase 2;
        ``layer_args`` keeps its arguments."""
        from keypoints_interpolation_transformer_torch.ops.kernels \
            .int8_matmul import quantize_weight
        k, o = self.k, self.operands(B, T)
        mask, valid = self.masks(B, T)

        def q(w, form):  # an (in, out) weight in torch's Linear layout
            return quantize_weight(w.t().contiguous(), form)

        out = []
        for variant, x, w, b in (
                ("embedding", o["x_in"], o["wemb"], o["bemb"]),
                ("qkv projection", o["x"], o["wqkv"], o["bqkv"])):
            args = (x, *q(w, "dense"), b)
            self.layer_args.setdefault("int8_dense", args)
            out.append(("int8_dense", f"{variant} {x.shape[-1]}->"
                        f"{w.shape[1]}", lambda a=args: k.fused_int8_dense(*a),
                        lambda a=args: k.int8_dense_plain(*a)))
        ff8 = (*q(o["w1"], "ff"), o["b1"], *q(o["w2"], "ff"), o["b2"])
        args = (o["x"], *ff8, o["g"], o["be"], o["g2"], o["be2"], True)
        self.layer_args["ffn_int8"] = args
        out.append(("ffn_int8", "pre_ln", lambda a=args: k.fused_ffn_int8(*a),
                    lambda a=args: k.ffn_int8_plain(*a)))
        return out + self.int8_layer_calls(o, mask, valid)

    def int8_layer_calls(self, o, mask, valid, cluster=None):
        """The merged encoder layer with its FF tail int8, with the plain
        model's and the Cycle model's masks; ``cluster`` as in
        ``layer_calls``."""
        from keypoints_interpolation_transformer_torch.ops.kernels \
            .int8_matmul import quantize_weight
        k = self.k

        def q(w):  # an (in, out) weight in torch's Linear layout
            return quantize_weight(w.t().contiguous(), "ff")

        ff8 = (*q(o["w1"]), o["b1"], *q(o["w2"]), o["b2"])
        attn = (o["wqkv"], o["bqkv"], o["wo"], o["bo"])
        tag = "" if cluster is None else f" cluster={cluster}"
        out = []
        for flags, m, kind in (("plain", mask, "repeat-inc"),
                               ("cycle", self.torch.ones_like(mask), "all")):
            args = (o["x"], *attn, *ff8, o["g"], o["be"], o["g2"], o["be2"],
                    m, valid, kind, True, self.heads)
            self.layer_args.setdefault("enc_layer_int8", args)
            out.append(("enc_layer_int8", f"{flags} {kind}+keypad{tag}",
                        lambda a=args: k.fused_encoder_layer_int8(
                            *a, cluster=cluster),
                        lambda a=args: k.encoder_layer_int8_plain(*a)))
        return out

    def layer_calls(self, o, mask, valid, cluster=None):
        """The whole-layer kernels: the plain model's masks (the encoder
        repeat-inc with the key padding added, the decoder self-attention
        repeat-inc) and the Cycle model's (kind "all", all-ones masks
        added); the decoder with its FF tail and without; cross-attention
        "all" with the padding bias.  ``cluster`` forces the blocks per
        video (None: the wrapper's choice).  The plain model's come first
        (they are timed); ``layer_args`` keeps their arguments."""
        k = self.k
        ones = self.torch.ones_like(mask)
        attn = (o["wqkv"], o["bqkv"], o["wo"], o["bo"])
        ff = (o["w1"], o["b1"], o["w2"], o["b2"], o["g"], o["be"], o["g2"],
              o["be2"])
        tag = "" if cluster is None else f" cluster={cluster}"
        self.layer_args = {}
        out = []
        for flags, m, kind in (("plain", mask, "repeat-inc"),
                               ("cycle", ones, "all")):
            args = (o["x"], *attn, *ff, m, valid, kind, True, self.heads)
            self.layer_args.setdefault("enc_layer", args)
            out.append(("enc_layer", f"{flags} {kind}+keypad{tag}",
                        lambda a=args: k.fused_encoder_layer(
                            *a, cluster=cluster),
                        lambda a=args: k.encoder_layer_plain(*a)))
        for with_ff in (True, False):
            for flags, m, kind, keypad in (
                    ("plain", mask, "repeat-inc", False),
                    ("cycle", ones, "all", True)):
                args = (o["x"], o["mem"], *attn, o["cwqkv"], o["cbqkv"],
                        o["cwo"], o["cbo"], o["g"], o["be"],
                        ff if with_ff else None, m, valid, None, valid, kind,
                        keypad, "all", False, self.heads)
                self.layer_args.setdefault("dec_layer", args)
                out.append(("dec_layer", f"{flags} self {kind}"
                            f"{'+keypad' if keypad else ''} ff={with_ff}{tag}",
                            lambda a=args: k.fused_decoder_layer(
                                *a, cluster=cluster),
                            lambda a=args: k.decoder_layer_plain(*a)))
        return out

    def layer_mode_calls(self, o, mask, valid, encoder=True,
                         tails=(True, False)):
        """(kernel name, variant, wrapper call, plain call, False, plain
        call in the wrong mode) of the merged layers' mode kernels, with
        ``layer_calls``' masks: the encoder layer (with ``encoder``) and the
        decoder layer with and without its FF tail (``tails``), in "high"
        and "default", their weights split into planes once, as a packed
        model keeps them.  The plain model's come first (they are
        timed)."""
        from keypoints_interpolation_transformer_torch.ops.kernels.ffn \
            import ff_weight_planes
        from keypoints_interpolation_transformer_torch.ops.kernels \
            .layer_fused import attn_weight_planes
        k, out = self.k, []
        self.layer_mode_args = {}  # (name, variant) -> (args, keywords)
        ones = self.torch.ones_like(mask)
        attn = (o["wqkv"], o["bqkv"], o["wo"], o["bo"])
        cattn = (o["cwqkv"], o["cbqkv"], o["cwo"], o["cbo"])
        ff = (o["w1"], o["b1"], o["w2"], o["b2"], o["g"], o["be"], o["g2"],
              o["be2"])
        for mode, tag in (("bf16x3", "high"), ("bf16", "default")):
            wrong = WRONG_MODE[mode]
            ap = attn_weight_planes(*attn[:3], self.heads, mode)
            cp = attn_weight_planes(*cattn[:3], self.heads, mode)
            fp = ff_weight_planes(o["w1"].t(), o["w2"].t(), mode)
            for flags, m, kind in (("plain", mask, "repeat-inc"),
                                   ("cycle", ones, "all")) if encoder else ():
                args = (o["x"], *attn, *ff, m, valid, kind, True, self.heads)
                self.layer_mode_args[(f"enc_layer_{tag}",
                                      f"{flags} {kind}+keypad")] = (
                    args, {"mode": mode, "planes": (ap, fp)})
                out.append((
                    f"enc_layer_{tag}", f"{flags} {kind}+keypad",
                    lambda a=args, md=mode, p=(ap, fp):
                    k.fused_encoder_layer(*a, mode=md, planes=p),
                    lambda a=args, md=mode: k.encoder_layer_plain(*a, md),
                    False,
                    lambda a=args, md=wrong: k.encoder_layer_plain(*a, md)))
            for with_ff in tails:
                for flags, m, kind, keypad in (
                        ("plain", mask, "repeat-inc", False),
                        ("cycle", ones, "all", True)):
                    args = (o["x"], o["mem"], *attn, *cattn, o["g"], o["be"],
                            ff if with_ff else None, m, valid, None, valid,
                            kind, keypad, "all", False, self.heads)
                    p = (ap, cp, fp if with_ff else None)
                    variant = (f"{flags} self {kind}"
                               f"{'+keypad' if keypad else ''} ff={with_ff}")
                    self.layer_mode_args[(f"dec_layer_{tag}", variant)] = (
                        args, {"mode": mode, "planes": p})
                    out.append((
                        f"dec_layer_{tag}", variant,
                        lambda a=args, md=mode, p=p: k.fused_decoder_layer(
                            *a, mode=md, planes=p),
                        lambda a=args, md=mode: k.decoder_layer_plain(*a, md),
                        False,
                        lambda a=args, md=wrong: k.decoder_layer_plain(*a,
                                                                       md)))
        return out

    def train_calls(self, B, T, blocked=False):
        """(kernel name, variant, wrapper call, plain call, is a gradient)
        of the training kernels at (B, T), the FF sublayer with and without
        LN1; each backward gets the plain training forward's residuals on
        both sides.  Keys padded in the second video and, with ``blocked``
        and B > 2, every key of the third."""
        k, o = self.k, self.operands(B, T)
        mask, valid = self.masks(B, T)
        if blocked and B > 2:
            valid[2] = 0.0
        dy = self.rand(B, T, self.d)
        out = []
        w_in = o["wqkv"].t().contiguous()
        w_out = o["wo"].t().contiguous()
        for variant, mem, ln, kind, keypad in ATTN_VARIANTS:
            mem = o["mem"] if mem else None
            ln = (o["g"], o["be"]) if ln else (None, None)
            args = (o["x"], mem, o["wqkv"], o["bqkv"], o["wo"], o["bo"], *ln,
                    mask, valid, kind, keypad, self.heads)
            kern = lambda a=args: k.fused_attn_sublayer_train(*a)[:5]  # noqa
            plain = lambda a=args: k.attn_sublayer_train_plain(*a)  # noqa
            if blocked and B > 2:  # the stats of the videos with a real key
                kern, plain = (real_stats(f, 3, valid) for f in (kern, plain))
            out.append(("attn_sublayer_train", variant, kern, plain, False))
            _, qkv, a, stats, r = k.attn_sublayer_train_plain(*args)
            bargs = (dy, o["x"], mem, qkv, a, stats, r, w_in, w_out, ln[0],
                     mask, valid, kind, keypad, self.heads)
            out.append(("attn_sublayer_bwd", variant,
                        lambda a=bargs: k.attn_sublayer_bwd(*a),
                        lambda a=bargs: k.attn_sublayer_bwd_plain(*a), True))
        for pre_ln in (True, False):
            variant = "pre_ln" if pre_ln else "post-LN only"
            args = (o["x"], o["w1"], o["b1"], o["w2"], o["b2"], o["g"],
                    o["be"], o["g"], o["be"], pre_ln)
            out.append(("ffn_train", variant,
                        lambda a=args: k.fused_ffn_train(*a),
                        lambda a=args: k.ffn_train_plain(*a), False))
            _, u, z = k.ffn_train_plain(*args)
            bargs = (dy, o["x"], u, z, o["w1"].t().contiguous(),
                     o["w2"].t().contiguous(), o["g"], o["be"], o["g"],
                     pre_ln)
            out.append(("ffn_bwd", variant, lambda a=bargs: k.ffn_bwd(*a),
                        lambda a=bargs: k.ffn_bwd_plain(*a), True))
        return out


    def sublayer_mode_calls(self, B, b_train, T, blocked=False):
        """(kernel name, variant, wrapper call, plain call, is a gradient,
        plain call in the wrong mode) of the attention sublayer's mode
        kernels for the model's three sublayers (ATTN_VARIANTS), in "high"
        and "default": the serving forward at (B, T) with the folded planes
        a packed model keeps (``attn_weight_planes``), the training forward
        and the backward at (b_train, T) with the planes
        ``AttnSublayerFunction`` splits once a step (``attn_train_planes``);
        each backward gets the plain training forward's residuals in its
        mode on both sides, the wrong mode's plain backward those of the
        wrong mode (a mode's statistics are log2-domain).  Keys padded in
        the second video and, with ``blocked`` and b_train > 2, every key of
        the third in training."""
        from keypoints_interpolation_transformer_torch.ops.kernels import \
            attn_sublayer as tas
        from keypoints_interpolation_transformer_torch.ops.kernels \
            .attn_sublayer import attn_train_planes, attn_weight_planes
        # the backward given the planes of x, the memory and a as the
        # training forward keeps them (an older tree, which splits them in
        # the call, has no such planes)
        act_planes = getattr(tas, "attn_act_planes", None)
        k, out = self.k, []
        o, (mask, valid) = self.operands(B, T), self.masks(B, T)
        ot, (tmask, tvalid) = self.operands(b_train, T), self.masks(b_train,
                                                                    T)
        if blocked and b_train > 2:
            tvalid[2] = 0.0
        dy = self.rand(b_train, T, self.d)
        w_in, w_out = ot["wqkv"].t().contiguous(), ot["wo"].t().contiguous()
        for mode, tag in (("bf16x3", "high"), ("bf16", "default")):
            wrong = WRONG_MODE[mode]
            sp = attn_weight_planes(o["wqkv"], o["bqkv"], o["wo"],
                                    self.heads, mode)
            tp = attn_train_planes(w_in, w_out, mode)
            for variant, cross, ln, kind, keypad in ATTN_VARIANTS:
                mem = o["mem"] if cross else None
                norm = (o["g"], o["be"]) if ln else (None, None)
                args = (o["x"], mem, o["wqkv"], o["bqkv"], o["wo"], o["bo"],
                        *norm, mask, valid, kind, keypad, self.heads)
                out.append((
                    f"attn_sublayer_{tag}", variant,
                    lambda a=args, m=mode, p=sp: k.fused_attn_sublayer(
                        *a, m, p),
                    lambda a=args, m=mode: k.attn_sublayer_plain(*a, m),
                    False,
                    lambda a=args, m=wrong: k.attn_sublayer_plain(*a, m)))
                mem = ot["mem"] if cross else None
                norm = (ot["g"], ot["be"]) if ln else (None, None)
                targs = (ot["x"], mem, ot["wqkv"], ot["bqkv"], ot["wo"],
                         ot["bo"], *norm, tmask, tvalid, kind, keypad,
                         self.heads)
                calls = (lambda a=targs, m=mode, p=tp:
                         k.fused_attn_sublayer_train(*a, m, p)[:5],
                         lambda a=targs, m=mode:
                         k.attn_sublayer_train_plain(*a, m),
                         lambda a=targs, m=wrong:
                         k.attn_sublayer_train_plain(*a, m))
                if blocked and b_train > 2:  # the stats of real videos
                    calls = tuple(real_stats(f, 3, tvalid) for f in calls)
                out.append((f"attn_sublayer_train_{tag}", variant, calls[0],
                            calls[1], False, calls[2]))

                def bargs(md, a=targs, mem=mem, g=norm[0], kind=kind,
                          keypad=keypad):
                    _, qkv, att, stats, r = k.attn_sublayer_train_plain(*a, md)
                    return (dy, a[0], mem, qkv, att, stats, r, w_in, w_out, g,
                            tmask, tvalid, kind, keypad, self.heads, md)

                own, other = bargs(mode), bargs(wrong)
                extra = () if act_planes is None else (
                    act_planes(own[1], own[2], own[4], mode),)
                out.append((
                    f"attn_sublayer_bwd_{tag}", variant,
                    lambda a=own, p=tp, e=extra: k.attn_sublayer_bwd(*a, p,
                                                                     *e),
                    lambda a=own: k.attn_sublayer_bwd_plain(*a), True,
                    lambda a=other: k.attn_sublayer_bwd_plain(*a)))
        return out

    def precision_calls(self, B, b_train, T):
        """(kernel name, variant, wrapper call, plain call, is a gradient,
        plain call in the wrong mode or None) of the precision modes'
        kernels, each against its plain version in the same mode: the FF
        forward at (B, T) and the training forward at (b_train, T) in
        "high" and "default" (their weights split into bf16 planes once,
        as a packed model keeps them); the split backward at (b_train, T)
        in both modes, per call as the training route runs it; the
        pre-stream chain on an embedding at (B, T) without and with the
        Cycle residual.  The wrong mode of "high" is one bf16 pass, that of
        "default" float32 (WRONG_MODE)."""
        from keypoints_interpolation_transformer_torch.ops.kernels.ffn \
            import ff_weight_planes
        k, out = self.k, []
        modes = (("bf16x3", "high"), ("bf16", "default"))
        o = self.operands(B, T)
        args = (o["x"], o["w1"], o["b1"], o["w2"], o["b2"], o["g"], o["be"],
                o["g2"], o["be2"], True)
        for mode, tag in modes:
            p = ff_weight_planes(o["w1"].t(), o["w2"].t(), mode)
            out.append((f"ffn_{tag}", "pre_ln",
                        lambda a=args, m=mode, p=p: k.fused_ffn(*a, m, p),
                        lambda a=args, m=mode: k.ffn_plain(*a, m), False,
                        lambda a=args, m=WRONG_MODE[mode]: k.ffn_plain(
                            *a, m)))
        ot = self.operands(b_train, T)
        targs = (ot["x"], ot["w1"], ot["b1"], ot["w2"], ot["b2"], ot["g"],
                 ot["be"], ot["g2"], ot["be2"], True)
        for mode, tag in modes:
            p = ff_weight_planes(ot["w1"].t(), ot["w2"].t(), mode)
            out.append((f"ffn_train_{tag}", "pre_ln",
                        lambda a=targs, m=mode, p=p: k.fused_ffn_train(
                            *a, m, p),
                        lambda a=targs, m=mode: k.ffn_train_plain(*a, m),
                        False,
                        lambda a=targs, m=WRONG_MODE[mode]: k.ffn_train_plain(
                            *a, m)))
        _, u, z = k.ffn_train_plain(*targs)
        bargs = (self.rand(b_train, T, self.d), ot["x"], u, z,
                 ot["w1"].t().contiguous(), ot["w2"].t().contiguous(),
                 ot["g"], ot["be"], ot["g2"], True)
        for mode, name in (("bf16x3", "ffn_bwd_split_high"),
                           ("bf16", "ffn_bwd_split_default")):
            out.append((name, "pre_ln",
                        lambda a=bargs, m=mode: k.ffn_bwd_split(*a, m),
                        lambda a=bargs, m=mode: k.ffn_bwd_split_plain(*a, m),
                        True,
                        lambda a=bargs, m=WRONG_MODE[mode]:
                        k.ffn_bwd_split_plain(*a, m)))
        for res in (False, True) if self.d % 128 == 0 else ():
            args = (o["x"], o["pe"], o["w12"], o["b12"], o["w3"], o["b3"],
                    res)
            out.append(("pre_stream", f"pe_residual={res}",
                        lambda a=args: k.fused_pre_stream(*a),
                        lambda a=args: k.pre_stream_plain(*a), False, None))
        return out

    def per_op_calls(self, B, T, blocked=True, residuals=True):
        """(kernel name, variant, wrapper call, plain call, is a gradient)
        of the per-op attention kernels and the masked loss at (B, T): the
        encoder's masks (repeat-inc with the key padding added), the
        decoder's (repeat-inc), the Cycle model's (kind "all", all-ones
        masks added) and cross-attention ("all", padding only); keys padded
        in the second video and, with ``blocked`` and B > 2, every key of
        the third (its rows average uniformly).  ``attention_bwd`` comes
        in two forms: standalone, and (with ``residuals``) given the
        forward's out and stats, the kernel's from ``fused_attention(...,
        stats=True)`` and the plain version's from ``attention_plain``'s.
        The library calls are timed on a batch without a blocked row: in
        float32, the backward of ``scaled_dot_product_attention`` scales its
        gradients by the row's key count there, as its log-sum-exp m +
        log(l) rounds log(l) away at m = -1e9."""
        t, k = self.torch, self.k
        dh = self.d // self.heads
        q, kk, v, g = (self.rand(B, T, self.heads, dh) for _ in range(4))
        mask, valid = self.masks(B, T)
        if blocked and B > 2:
            valid[2] = 0.0
        ones = t.ones_like(mask)
        out = []
        for variant, m, kind, keypad in (
                ("enc repeat-inc+keypad", mask, "repeat-inc", True),
                ("dec repeat-inc", mask, "repeat-inc", False),
                ("cycle all+keypad", ones, "all", True),
                ("cross all", None, "all", False)):
            args = (q, kk, v, m, valid, kind, keypad)
            if not blocked:
                self.layer_args.setdefault("attention", args)
                self.layer_args.setdefault(
                    "attention_bwd", (q, kk, v, g, m, valid, kind, keypad))
            out.append(("attention", variant,
                        lambda a=args: k.fused_attention(*a),
                        lambda a=args: k.attention_plain(*a), False))
            bargs = (q, kk, v, g, m, valid, kind, keypad)
            out.append(("attention_bwd", variant,
                        lambda a=bargs: k.attention_bwd(*a),
                        lambda a=bargs: k.attention_bwd_plain(*a), True))
            if residuals:
                res = k.fused_attention(*args, stats=True)
                res_plain = k.attention_plain(*args, stats=True)
                calls = (lambda a=args: k.fused_attention(*a, stats=True),
                         lambda a=args: k.attention_plain(*a, stats=True))
                if blocked and B > 2:  # the stats of real videos
                    calls = tuple(real_stats(f, 1, valid) for f in calls)
                out.append(("attention", f"{variant}, out and stats",
                            *calls, False))
                out.append(("attention_bwd", f"{variant}, {RESIDUAL_FORM}",
                            lambda a=bargs, r=res: k.attention_bwd(*a, *r),
                            lambda a=bargs, r=res_plain:
                            k.attention_bwd_plain(*a, *r), True))
        pred = self.rand(B, T, 54, 2, lo=0.2, hi=0.8)
        tgt = self.rand(B, T, 54, 2, lo=0.2, hi=0.8)
        w = valid.clone()
        w[0, T // 2:] = 0.5
        args = (pred, tgt, w)
        out.append(("masked_loss", "padded frames, a video of weight 0"
                    if blocked and B > 2 else "padded frames",
                    lambda a=args: k.fused_masked_loss(*a),
                    lambda a=args: k.masked_loss_plain(*a), False))
        return out

    def op_mode_calls(self, B, T, blocked=True):
        """(kernel name, variant, wrapper call, plain call, is a gradient,
        plain call in the wrong mode) of the per-op attention pair in
        "high" and "default" at (B, T), with ``per_op_calls``' masks (keys
        padded in the second video and, with ``blocked`` and B > 2, every
        key of the third); a mode's backward takes no out or stats.  The
        encoder's masks come first (they are timed)."""
        t, k = self.torch, self.k
        dh = self.d // self.heads
        q, kk, v, g = (self.rand(B, T, self.heads, dh) for _ in range(4))
        mask, valid = self.masks(B, T)
        if blocked and B > 2:
            valid[2] = 0.0
        ones = t.ones_like(mask)
        out = []
        for mode, tag in (("bf16x3", "high"), ("bf16", "default")):
            wrong = WRONG_MODE[mode]
            for variant, m, kind, keypad in (
                    ("enc repeat-inc+keypad", mask, "repeat-inc", True),
                    ("dec repeat-inc", mask, "repeat-inc", False),
                    ("cycle all+keypad", ones, "all", True),
                    ("cross all", None, "all", False)):
                args = (q, kk, v, m, valid, kind, keypad)
                out.append((f"attention_{tag}", variant,
                            lambda a=args, md=mode: k.fused_attention(
                                *a, mode=md),
                            lambda a=args, md=mode: k.attention_plain(
                                *a, mode=md), False,
                            lambda a=args, md=wrong: k.attention_plain(
                                *a, mode=md)))
                if kind == "repeat-inc" and keypad:
                    # out and the log2-domain stats of the videos with a
                    # real key
                    calls = tuple(real_stats(
                        lambda a=args, md=md, f=f: f(*a, stats=True,
                                                     mode=md), 1, valid)
                        for f, md in ((k.fused_attention, mode),
                                      (k.attention_plain, mode),
                                      (k.attention_plain, wrong)))
                    out.append((f"attention_{tag}", f"{variant}, stats",
                                calls[0], calls[1], False, calls[2]))
                bargs = (q, kk, v, g, m, valid, kind, keypad)
                self.layer_args[f"attention_bwd_{tag} {variant}"] = bargs
                out.append((f"attention_bwd_{tag}", variant,
                            lambda a=bargs, md=mode: k.attention_bwd(
                                *a, mode=md),
                            lambda a=bargs, md=mode: k.attention_bwd_plain(
                                *a, mode=md), True,
                            lambda a=bargs, md=wrong: k.attention_bwd_plain(
                                *a, mode=md)))
        return out

    def chain_mode_calls(self, B, T, f=F_IN):
        """(kernel name, variant, wrapper call, plain call, False, plain
        call in the wrong mode) of the pointwise chains in "high" and
        "default" at (B, T), their weights split into planes once as a
        packed model keeps them (``chain_planes``): the pre-stream chain
        with its embedding out (first: timed) and without, with and without
        the Cycle residual; the post head.  ``f``: the frames' features
        (the 108 of F_IN unless given)."""
        from keypoints_interpolation_transformer_torch.ops.kernels \
            .pointwise import chain_planes
        k, o = self.k, self.operands(B, T)
        if f != F_IN:
            o.update(x_in=self.rand(B, T, f, lo=0.2, hi=0.8),
                     wemb=self.weight(f, self.d), wh=self.weight(self.d, f),
                     bh=self.rand(f, scale=0.05))
        out = []
        for mode, tag in (("bf16x3", "high"), ("bf16", "default")):
            wrong = WRONG_MODE[mode]
            pp = chain_planes(o["w12"], o["w3"], mode, wemb=o["wemb"])
            ph = chain_planes(o["w12"], o["w3"], mode, wh=o["wh"])
            for pe_res, want_emb in ((False, True), (False, False),
                                     (True, True), (True, False)):
                args = (o["x_in"], o["wemb"], o["bemb"], o["pe"], o["w12"],
                        o["b12"], o["w3"], o["b3"], pe_res, want_emb)
                out.append((f"pre_stream_embed_{tag}",
                            f"pe_residual={pe_res} want_emb={want_emb}",
                            lambda a=args, md=mode, p=pp:
                            k.fused_pre_stream_embed(*a, mode=md, planes=p),
                            lambda a=args, md=mode:
                            k.pre_stream_embed_plain(*a, md), False,
                            lambda a=args, md=wrong:
                            k.pre_stream_embed_plain(*a, md)))
            args = (o["x"], o["mem"], o["w12"], o["b12"], o["w3"], o["b3"],
                    o["wh"], o["bh"])
            out.append((f"post_head_{tag}", "",
                        lambda a=args, md=mode, p=ph: k.fused_post_head(
                            *a, mode=md, planes=p),
                        lambda a=args, md=mode: k.post_head_plain(*a, md),
                        False,
                        lambda a=args, md=wrong: k.post_head_plain(*a, md)))
        return out


    def linear_mode_calls(self, B, T):
        """(kernel name, variant, wrapper call, plain call, is a gradient,
        plain call in the wrong mode) of ``mode_linear`` and its backward in
        "high" and "default" over B T rows: a per-op route's q / k / v
        projection (D -> 3D, first: timed), the embedding of the 108-wide
        frames (108 -> D, K padded to 112) and the head back to them (D ->
        108, N padded to 112); the backward reads the planes of x and W
        as the forward's call leaves them (``row_planes``,
        ``weight_planes``)."""
        k, o = self.k, self.operands(B, T)
        out = []
        for mode, tag in (("bf16x3", "high"), ("bf16", "default")):
            wrong = WRONG_MODE[mode]
            for variant, x, w, b in (
                    ("qkv projection", o["x"], o["wqkv"], o["bqkv"]),
                    ("embedding", o["x_in"], o["wemb"], o["bemb"]),
                    ("head", o["x"], o["wh"], o["bh"])):
                v = f"{variant} {w.shape[0]}->{w.shape[1]}"
                args = (x, w, b)
                self.layer_args.setdefault(f"mode_linear_{tag}", args)
                out.append((f"mode_linear_{tag}", v,
                            lambda a=args, md=mode: k.mode_linear(*a, md),
                            lambda a=args, md=mode: k.mode_linear_plain(
                                *a, md), False,
                            lambda a=args, md=wrong: k.mode_linear_plain(
                                *a, md)))
                bargs = (self.rand(*x.shape[:-1], w.shape[1]), x, w)
                planes = (k.row_planes(x, mode), k.weight_planes(w, mode))
                out.append((f"mode_linear_bwd_{tag}", v,
                            lambda a=bargs, md=mode, p=planes:
                            k.mode_linear_bwd(*a, md, p),
                            lambda a=bargs, md=mode: k.mode_linear_bwd_plain(
                                *a, md), True,
                            lambda a=bargs, md=wrong:
                            k.mode_linear_bwd_plain(*a, md)))
        return out

    def int8_layer_mode_calls(self, o, mask, valid):
        """(kernel name, variant, wrapper call, plain call, False, plain
        call in the wrong mode) of the merged encoder layer with its FF
        tail int8 in "high" and "default" (``_enc_kernel``'s ``ff_int8``
        under those modes), the attention's planes split once as a packed
        model keeps them, with the plain model's masks (first: timed) and
        the Cycle model's."""
        from keypoints_interpolation_transformer_torch.ops.kernels \
            .int8_matmul import quantize_weight
        k = self.k

        def q(w):  # an (in, out) weight in torch's Linear layout
            return quantize_weight(w.t().contiguous(), "ff")

        ff8 = (*q(o["w1"]), o["b1"], *q(o["w2"]), o["b2"])
        attn = (o["wqkv"], o["bqkv"], o["wo"], o["bo"])
        out = []
        for mode, tag in (("bf16x3", "high"), ("bf16", "default")):
            planes = k.attn_weight_planes(*attn[:3], self.heads, mode)
            for flags, m, kind in (("plain", mask, "repeat-inc"),
                                   ("cycle", self.torch.ones_like(mask),
                                    "all")):
                args = (o["x"], *attn, *ff8, o["g"], o["be"], o["g2"],
                        o["be2"], m, valid, kind, True, self.heads)
                out.append((f"enc_layer_int8_{tag}", f"{flags} {kind}+keypad",
                            lambda a=args, md=mode, p=planes:
                            k.fused_encoder_layer_int8(*a, mode=md, planes=p),
                            lambda a=args, md=mode:
                            k.encoder_layer_int8_plain(*a, md), False,
                            lambda a=args, md=WRONG_MODE[mode]:
                            k.encoder_layer_int8_plain(*a, md)))
        return out


# the standing draw: the state of ``KernelCheck``'s generator (the CPU
# generator's 5056 bytes) just before the draw of ``op_mode_calls(3, 512)``
# as an earlier phase 2 reached it, after its rows at B=3 and T 128, 40, 256
# and 300, the sublayer's mode rows at T 144 and 240 and the per-op rows at
# T 40 and 512
FLIP_DRAW = os.path.join("tests", "data", "flip_draw.state")


def flip_draw_calls(torch, kmod, dev=DEV):
    """The per-op attention pair's mode rows (``op_mode_calls``) at B=3,
    T=512 on the standing draw (see FLIP_TOL): a ``KernelCheck`` whose
    generator starts from ``FLIP_DRAW``.  Its ``FLIP_ROWS`` hold one dl
    (``FLIP_DL``) 3 float32 ulps from a bf16 rounding midpoint."""
    chk = KernelCheck(torch, kmod, dev=dev)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, FLIP_DRAW), "rb") as f:
        chk.g.set_state(torch.frombuffer(bytearray(f.read()),
                                         dtype=torch.uint8))
    return chk, chk.op_mode_calls(3, 512)


def new_path_checks(torch, kmod):
    """The attention sublayer's mode rows and the merged layers' mode rows
    (the int8 encoder's too) at n = 224 with 7 heads (the kernel width 256:
    the two-kernel forward's padded head slice) at T 128 and 40; the merged
    layers' launches at the shapes either side of the two-kernel path's
    edge (T 128 / 136, 32- / 64-wide heads); the training forward's kept
    planes (``acts``) against
    ``attn_act_planes`` of its x, memory and a, bit for bit, at B_TRAIN x
    T_MAIN, at B=3 T=40 with a memory and at T=144 (the five-launch path);
    ``mode_linear_bwd`` twice on the same operands at the A1 step's q / k /
    v projection, the embedding (K = 108) and 8200 rows: the same bits."""
    from keypoints_interpolation_transformer_torch.ops.kernels \
        .attn_sublayer import attn_act_planes, attn_train_planes
    narrow = KernelCheck(torch, kmod, d=224, heads=7)
    for T in (128, 40):
        o, (mask, valid) = narrow.operands(3, T), narrow.masks(3, T)
        for name, variant, kern, plain, grad, wrong in \
                narrow.sublayer_mode_calls(3, 3, T, True) \
                + narrow.layer_mode_calls(o, mask, valid) \
                + narrow.int8_layer_mode_calls(o, mask, valid):
            narrow.compare(name, f"n=224 B=3 T={T} {variant}", kern(), plain(),
                           grad, wrong())
    merged_launch_checks(torch, kmod)
    chk = KernelCheck(torch, kmod)
    for mode in ("bf16x3", "bf16"):
        for B, T, cross in ((B_TRAIN, T_MAIN, False), (3, 40, True),
                            (3, 144, False)):
            o, (mask, valid) = chk.operands(B, T), chk.masks(B, T)
            mem = o["mem"] if cross else None
            tp = attn_train_planes(o["wqkv"].t().contiguous(),
                                   o["wo"].t().contiguous(), mode)
            out = kmod.fused_attn_sublayer_train(
                o["x"], mem, o["wqkv"], o["bqkv"], o["wo"], o["bo"], o["g"],
                o["be"], mask, valid, "all" if cross else "repeat-inc",
                not cross, HEADS, mode, tp)
            want = attn_act_planes(o["x"], mem, out[2], mode)
            torch.cuda.synchronize()
            same = out[5] is not None and torch.equal(out[5], want)
            print(f"  attn_sublayer_train {mode} B={B} T={T} "
                  f"{'cross' if cross else 'self'}: kept planes of x"
                  f"{', the memory' if cross else ''} and a equal "
                  f"attn_act_planes' bit for bit: {same}", flush=True)
            if not same:
                fail(f"attn_sublayer_train {mode} B={B} T={T}: the kept "
                     "planes differ from attn_act_planes'")
        for rows, K, N in ((B_TRAIN * T_MAIN, D, 3 * D),
                           (B_TRAIN * T_MAIN, F_IN, D), (8200, D, D)):
            x, g = chk.rand(rows, K), chk.rand(rows, N)
            w = chk.weight(K, N)
            planes = (kmod.row_planes(x, mode), kmod.weight_planes(w, mode))
            one = kmod.mode_linear_bwd(g, x, w, mode, planes)
            two = kmod.mode_linear_bwd(g, x, w, mode, planes)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(one, two))
            print(f"  mode_linear_bwd {mode} M={rows} K={K} N={N}: dx, dW "
                  f"and db the same bits on two runs: {same}", flush=True)
            if not same:
                fail(f"mode_linear_bwd {mode} M={rows} K={K} N={N}: two runs "
                     "differ")


# the merged mode layers' device activities a call: on the two-kernel
# attention halves, and on the longer launch chain (a memset more there
# where n < D), then one more for the FF split (``ffn.tc_parts``) but in
# the int8 tail
MERGED_LAUNCHES = {True: {"enc_layer": 3, "dec_layer": 5,
                          "enc_layer_int8": 3},
                   False: {"enc_layer": 5, "dec_layer": 11,
                           "enc_layer_int8": 5}}


def merged_launch_checks(torch, kmod):
    """The merged layers' mode kernels either side of the two-kernel
    attention halves' edge (``layer_fused.mode_layer_fused``): T 128 and
    136 at 32-wide heads, and T 128 at 64-wide heads (4 heads), each call's
    device activities by the profiler against MERGED_LAUNCHES, in both
    modes (the outputs are held in phase 2 and above)."""
    from keypoints_interpolation_transformer_torch.ops.kernels.ffn import \
        tc_parts
    from keypoints_interpolation_transformer_torch.ops.kernels.layer_fused \
        import mode_layer_fused
    for heads, T in ((HEADS, 128), (HEADS, 136), (4, 128)):
        chk = KernelCheck(torch, kmod, heads=heads)
        o, (mask, valid) = chk.operands(3, T), chk.masks(3, T)
        fused = mode_layer_fused(T, D, D // heads)
        seen = set()
        for name, variant, kern, *_ in (
                chk.layer_mode_calls(o, mask, valid, tails=(True,))
                + chk.int8_layer_mode_calls(o, mask, valid)):
            if name in seen:
                continue
            seen.add(name)
            base = name.rsplit("_", 1)[0]
            want = MERGED_LAUNCHES[fused][base] + (
                base != "enc_layer_int8" and tc_parts(3 * T, D, FF) > 1)
            text, n = launch_ms(torch, kern, count=True)
            for _ in range(2):  # an empty trace is the profiler's
                if n >= want:
                    break
                text, n = launch_ms(torch, kern, count=True)
            print(f"  launches {name} B=3 T={T} dh={D // heads} "
                  f"({'two-kernel halves' if fused else 'launch chain'}): "
                  f"{text} ms; {n} device activities a call", flush=True)
            if n != want:
                fail(f"{name} B=3 T={T} dh={D // heads}: {n} device "
                     f"activities a call, not {want}")


# the standing draw's rows whose dl flips: the Cycle model's "all" mask
# with its keypad term adds the same 1 to every key's score, which the
# softmax takes out, so "cross all" has the same p and dl; and (video,
# head, key, query) of that dl
FLIP_ROWS = (("attention_bwd_default", "cycle all+keypad"),
             ("attention_bwd_default", "cross all"))
FLIP_DL = (1, 0, 178, 182)


def flip_dl_orders(torch, kmod, args):
    """{order: {s, p, gw, l, delta, dl, bf16}} at the standing draw's
    FLIP_DL (video, head, key j, query i) as the plain version computes it
    at "default" (s = k q / sqrt(dh) + bias from the bf16 parts, p =
    exp(s - max) (1 / l), delta = sum of gw p, dl = p (gw - delta) /
    sqrt(dh), bf16 its rounding), in three float32 orders: torch's; the
    kernel's sums (delta = (sum of gw exp(s - max)) (1 / l), as
    ``attn_op_dq_kernel`` takes it), in torch's order; and one term at a
    time (the dot products over the head's columns in order, l and delta
    over the keys from the last)."""
    from keypoints_interpolation_transformer_torch.ops.kernels.attn_sublayer \
        import bias_from_masks
    q, k, v, g, mask, valid, kind, keypad = args
    b, h, j, i = FLIP_DL
    T, dh = q.shape[1], q.shape[3]
    hq, hk, hv, hg = (t[b, :, h, :].to(torch.bfloat16).float()
                      for t in (q, k, v, g))
    sc = torch.tensor(1.0 / dh ** 0.5, device=q.device)
    bias = bias_from_masks(mask, valid, T, kind, keypad)[b]
    bias = bias[min(i, bias.shape[0] - 1)]
    zero = torch.zeros((), device=q.device)
    out = {}
    for order in ("torch's order", "the kernel's sums",
                  "one term at a time"):
        if order == "one term at a time":
            s, gw = torch.zeros(T, device=q.device), torch.zeros(
                T, device=q.device)
            for d in range(dh):
                s = s + hk[:, d] * hq[i, d]
                gw = gw + hv[:, d] * hg[i, d]
            s = s * sc + bias
        else:
            s, gw = (hk @ hq[i]) * sc + bias, hv @ hg[i]
        e = torch.exp(s - s.max())
        if order == "one term at a time":
            l = zero
            for jj in range(T - 1, -1, -1):
                l = l + e[jj]
            p = e * (1.0 / l)
            delta = zero
            for jj in range(T - 1, -1, -1):
                delta = delta + gw[jj] * p[jj]
        else:
            l = e.sum()
            p = e * (1.0 / l)
            delta = (gw * p).sum() if order == "torch's order" else \
                (gw * e).sum() * (1.0 / l)
        x = (p[j] * (gw[j] - delta)) * sc
        out[order] = {"s": float(s[j]), "p": float(p[j]),
                      "gw": float(gw[j]), "l": float(l),
                      "delta": float(delta), "dl": float(x),
                      "bf16": float(x.to(torch.bfloat16).float())}
    return out


def library_mode_linear(torch, x, w, b):
    """One bf16 pass as one PyTorch call: ``torch.mm`` on the bf16 operands
    with a float32 output (``aten::mm.dtype``), plus the bias: the function
    of ``mode_linear`` at "default"; None where the card's torch lacks
    ``out_dtype``."""
    try:
        torch.mm(x.reshape(-1, x.shape[-1])[:1].to(torch.bfloat16),
                 w.to(torch.bfloat16), out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        print(f"  mode_linear_default library: torch.mm(..., out_dtype) "
              f"unavailable ({str(e).splitlines()[0][:80]})", flush=True)
        return None

    def call():
        y = torch.mm(x.reshape(-1, x.shape[-1]).to(torch.bfloat16),
                     w.to(torch.bfloat16), out_dtype=torch.float32)
        return (y + b).reshape(*x.shape[:-1], w.shape[1])
    return call


def int8_work(name, B, T):
    """(float32 FLOP, int8 operations, bytes) of the int8 kernels' timed
    variants at (B, T): float32 activations in and out, int8 weights (one
    byte each) with float32 scales and biases; an M x K by K x N product is
    2 M K N int8 operations (the quantization, dequantization, LayerNorms
    and GELU are not counted).  ``int8_dense`` is timed at the Embedding's
    Linear (108 -> D); ``enc_layer_int8`` adds its float32 attention."""
    N = B * T
    if name == "int8_dense":
        return 0, 2 * N * F_IN * D, 4 * N * F_IN + F_IN * D + 8 * D \
            + 4 * N * D
    # the FF weights, their scales and biases, four LayerNorm vectors
    ff = 2 * D * FF + 8 * (FF + D) + 16 * D
    if name == "ffn_int8":
        return 0, 4 * N * D * FF, 8 * N * D + ff
    return (8 * N * D * D + 4 * B * HEADS * T * T * (D // HEADS),
            4 * N * D * FF,
            4 * (2 * N * D + 2 * B * T + 4 * D * D + 4 * D) + ff)


def work(name, B, T):
    """(float32 FLOP, int8 operations, bytes) the timed variant of kernel
    ``name`` must do and move at (B, T) and the model's widths: every input
    read once, every output written once (``int8_work`` for the int8
    kernels).  The attention variant timed is the encoder's
    self-attention (repeat-inc, key padding, no LayerNorm); the FF one has
    LN1.  The backward's attention core counts the scores it must rebuild
    (5 products of B H T^2 dh, against the forward's 2); so does the
    per-op attention backward.  The masked loss counts its 108 values per
    frame."""
    N, f, dh = B * T, 4, D // HEADS
    core = 4 * B * HEADS * T * T * dh
    attn_in = N * D + 2 * B * T + 4 * D * D + 4 * D
    ffn_in = N * D + 2 * D * FF + FF + 5 * D
    # the whole layers, timed with the plain model's masks and the
    # decoder's FF tail: x (and memory), the mask and valid rows (the
    # decoder's cross-attention reads the same valid row), the weights
    enc_in = attn_in + 2 * D * FF + FF + 5 * D
    # per-op attention: 4 B H T^2 dh FLOP forward (q k^T, p v); the least
    # backward is 10 (the scores, g v^T, and the products of dq, dk, dv)
    head_core = 4 * B * HEADS * T * T * dh
    dec_in = 2 * N * D + 2 * B * T + 8 * D * D + 8 * D + 2 * D + 2 * D * FF \
        + FF + 5 * D
    table = {
        "pre_stream_embed": (2 * N * (F_IN * D + 3 * D * D),
                             N * F_IN + T * D + F_IN * D + 3 * D * D + 4 * D
                             + N * D),
        "post_head": (2 * N * (3 * D * D + D * F_IN),
                      2 * N * D + 3 * D * D + D * F_IN + 3 * D + F_IN
                      + N * F_IN),
        "attn_sublayer": (8 * N * D * D + core, attn_in + N * D),
        "ffn": (4 * N * D * FF, ffn_in + N * D),
        "attn_sublayer_train": (8 * N * D * D + core,
                                attn_in + N * D + 4 * N * D
                                + 2 * B * HEADS * T),
        "attn_sublayer_bwd": (16 * N * D * D + core * 5 // 2,
                              N * D + attn_in + 4 * N * D + 2 * B * HEADS * T
                              + N * D + 4 * D * D + 4 * D),
        "ffn_train": (4 * N * D * FF, ffn_in + N * D + N * FF + N * D),
        "ffn_bwd": (8 * N * D * FF,
                    2 * N * D + N * FF + N * D + 2 * D * FF + 3 * D
                    + N * D + 2 * D * FF + FF + 5 * D),
        "enc_layer": (2 * N * D * (4 * D + 2 * FF) + core, enc_in + N * D),
        "dec_layer": (2 * N * D * (8 * D + 2 * FF) + 2 * core,
                      dec_in + N * D),
        "attention": (head_core, 4 * N * D + 2 * B * T),
        "attention_bwd": (head_core * 5 // 2, 7 * N * D + 2 * B * T),
        # given the forward's out and stats: reads them too
        "attention_bwd_given": (head_core * 5 // 2,
                                8 * N * D + 2 * B * HEADS * T + 2 * B * T),
        # the difference, its square and the weighted sum per value
        "masked_loss": (3 * N * F_IN + 2 * N, 2 * N * F_IN + N + B),
    }
    # the precision modes do the float32 kernels' work; the split backward
    # moves what ffn_bwd moves (du is its own hand-off, not an input
    # or an output); the pre-stream chain is the embed kernel's second half
    table["pre_stream"] = (2 * N * 3 * D * D,
                           2 * N * D + T * D + 3 * D * D + 3 * D)
    # mode_linear's timed variant, the q / k / v projection (D -> 3D): x,
    # W and b in, y out; its backward g, x and W in, dx, dW and db out
    table["mode_linear"] = (2 * N * D * 3 * D,
                            N * D + 3 * D * D + 3 * D + 3 * N * D)
    # (x's and W's bf16 planes at "high": hi and lo, a float's worth)
    table["mode_linear_bwd"] = (4 * N * D * 3 * D,
                                3 * N * D + N * D + 3 * D * D + N * D
                                + 3 * D * D + 3 * D)
    base = name.replace("_high", "").replace("_default", "")
    if base in INT8_KERNELS:
        return int8_work(base, B, T)
    flop, elems = table["ffn_bwd" if base == "ffn_bwd_split" else base]
    if name in CHAIN_MODE_KERNELS[:2]:  # timed with its embedding out
        elems += N * D
    if name in SUBLAYER_MODE_TRAIN[:2]:
        # the kept planes of x and a (bf16; two planes each at "high"),
        # which the backward in a mode reads; the timed variant has no
        # LayerNorm, so no r
        elems += (2 if name.endswith("_high") else 1) * N * D
    if name == "mode_linear_bwd_default":
        # x's and W's planes are one bf16 plane each, half a float
        elems -= (N * D + 3 * D * D) // 2
    return flop, 0, elems * f


def _layer_mask(torch, mask, valid, T, kind, add_keypad, heads):
    """The additive bias the kernels build from the 1-D masks, as
    ``nn.MultiheadAttention``'s float attention mask: (B * heads, T, T),
    video-major."""
    from keypoints_interpolation_transformer_torch.ops.kernels.attn_sublayer \
        import bias_from_masks
    bias = bias_from_masks(mask, valid, T, kind, add_keypad)
    return bias.expand(valid.shape[0], T, T).repeat_interleave(
        heads, dim=0).contiguous()


def _load_attention(mha, wqkv, bqkv, wo, bo):
    mha.in_proj_weight.copy_(wqkv.t())
    mha.in_proj_bias.copy_(bqkv)
    mha.out_proj.weight.copy_(wo.t())
    mha.out_proj.bias.copy_(bo)


def _load_ff(layer, w1, b1, w2, b2):
    layer.linear1.weight.copy_(w1.t())
    layer.linear1.bias.copy_(b1)
    layer.linear2.weight.copy_(w2.t())
    layer.linear2.bias.copy_(b2)


def _load_norm(norm, g, be):
    norm.weight.copy_(g)
    norm.bias.copy_(be)


def _without_fastpath(torch, fn):
    """``fn`` with the MultiheadAttention fast path off: the encoder layer's
    fast path does not add a float (B * heads, T, T) mask as the kernels
    do (with this mask it is 0.24 off the plain version on the CPU), so
    neither layer takes it."""
    def call():
        was = torch.backends.mha.get_fastpath_enabled()
        torch.backends.mha.set_fastpath_enabled(False)
        try:
            return fn()
        finally:
            torch.backends.mha.set_fastpath_enabled(was)
    return call


def library_encoder_layer(torch, x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, g1,
                          be1, g2, be2, mask, valid, kind, add_keypad, heads):
    """The one PyTorch call that computes ``fused_encoder_layer`` on these
    arguments: a post-LN ``nn.TransformerEncoderLayer`` (exact GELU, no
    dropout) loaded with the same weights, its float mask built once from
    the same masks, the fast path off.  Returns the call."""
    from keypoints_interpolation_transformer_torch.ops.kernels.ffn import (
        LN_EPS)
    T, D = x.shape[1:]
    layer = torch.nn.TransformerEncoderLayer(
        D, heads, w1.shape[1], dropout=0.0, activation="gelu",
        layer_norm_eps=LN_EPS, batch_first=True, norm_first=False,
        device=x.device)
    with torch.no_grad():
        _load_attention(layer.self_attn, wqkv, bqkv, wo, bo)
        _load_ff(layer, w1, b1, w2, b2)
        _load_norm(layer.norm1, g1, be1)
        _load_norm(layer.norm2, g2, be2)
    layer.eval().requires_grad_(False)
    m = _layer_mask(torch, mask, valid, T, kind, add_keypad, heads)
    return _without_fastpath(torch, lambda: layer(x, src_mask=m))


def library_decoder_layer(torch, x, memory, swqkv, sbqkv, swo, sbo, cwqkv,
                          cbqkv, cwo, cbo, g1, be1, ff, smask, svalid, cmask,
                          cvalid, skind, sadd_keypad, ckind, cadd_keypad,
                          heads):
    """The one PyTorch call that computes ``fused_decoder_layer`` with its
    FF tail: a post-LN ``nn.TransformerDecoderLayer``, as above."""
    from keypoints_interpolation_transformer_torch.ops.kernels.ffn import (
        LN_EPS)
    T, D = x.shape[1:]
    w1, b1, w2, b2, g2, be2, g3, be3 = ff
    layer = torch.nn.TransformerDecoderLayer(
        D, heads, w1.shape[1], dropout=0.0, activation="gelu",
        layer_norm_eps=LN_EPS, batch_first=True, norm_first=False,
        device=x.device)
    with torch.no_grad():
        _load_attention(layer.self_attn, swqkv, sbqkv, swo, sbo)
        _load_attention(layer.multihead_attn, cwqkv, cbqkv, cwo, cbo)
        _load_ff(layer, w1, b1, w2, b2)
        _load_norm(layer.norm1, g1, be1)
        _load_norm(layer.norm2, g2, be2)
        _load_norm(layer.norm3, g3, be3)
    layer.eval().requires_grad_(False)
    sm = _layer_mask(torch, smask, svalid, T, skind, sadd_keypad, heads)
    cm = _layer_mask(torch, cmask, cvalid, T, ckind, cadd_keypad, heads)
    return _without_fastpath(
        torch, lambda: layer(x, memory, tgt_mask=sm, memory_mask=cm))


def _sdpa_operands(torch, q, k, v, mask, valid, kind, add_keypad):
    """q, k, v in ``scaled_dot_product_attention``'s (B, H, T, dh) layout
    and the bias the kernels build, as its float mask (B, 1, T, T)."""
    from keypoints_interpolation_transformer_torch.ops.kernels.attn_sublayer \
        import bias_from_masks
    B, T = q.shape[:2]
    bias = bias_from_masks(mask, valid, T, kind, add_keypad)
    if bias is not None:
        bias = bias.expand(B, T, T)[:, None].contiguous()
    return [x.transpose(1, 2).contiguous() for x in (q, k, v)], bias


def library_attention(torch, q, k, v, mask, valid, kind, add_keypad):
    """The one PyTorch call that computes ``fused_attention``:
    ``F.scaled_dot_product_attention`` with the bias as a float mask, built
    outside the timing; its output viewed back as (B, T, H, dh)."""
    F = torch.nn.functional
    (qh, kh, vh), bias = _sdpa_operands(torch, q, k, v, mask, valid, kind,
                                        add_keypad)
    return lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=bias).transpose(1, 2)


def library_attention_bwd(torch, q, k, v, g, mask, valid, kind, add_keypad):
    """``torch.autograd.grad`` through the same call: (dq, dk, dv)."""
    F = torch.nn.functional
    (qh, kh, vh), bias = _sdpa_operands(torch, q, k, v, mask, valid, kind,
                                        add_keypad)
    gh = g.transpose(1, 2).contiguous()
    for x in (qh, kh, vh):
        x.requires_grad_(True)

    def call():
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
        return tuple(d.transpose(1, 2) for d in torch.autograd.grad(
            out, (qh, kh, vh), gh))
    return call


def _library_int8_matmul(torch, wq, w_scale):
    """x -> float(int8(x) Wq^T) * s * w_scale with ``torch._int_mm``
    (cuBLASLt's int8 x int8 -> int32 product) on the int8 operands: the
    weight quantized once, as the model packs it, padded with zeros to a
    multiple of 8 along K (the call's rule; the sums do not change); the
    rows quantized by the plain steps (``int8_matmul.quantize_rows``)."""
    from keypoints_interpolation_transformer_torch.ops.kernels.int8_matmul \
        import quantize_rows
    F = torch.nn.functional
    K = wq.shape[1]
    pad = (-K) % 8
    wt = F.pad(wq, (0, pad)).t()  # (K, N), column-major

    def mm(x):
        xq, s = quantize_rows(x.reshape(-1, K))
        acc = torch._int_mm(F.pad(xq.to(torch.int8), (0, pad)), wt)
        return (acc.to(torch.float32) * s * w_scale).reshape(
            *x.shape[:-1], wq.shape[0])
    return mm


def library_int8_dense(torch, x, wq, w_scale, bias):
    """The int8 dense layer with ``torch._int_mm`` for its product and the
    plain quantize and dequantize steps around it."""
    mm = _library_int8_matmul(torch, wq, w_scale)
    return lambda: mm(x) + bias


def _library_ff_int8(torch, w1q, w1s, b1, w2q, w2s, b2, g1, be1, g2, be2,
                     pre_ln):
    """r -> the int8 FF sublayer with ``torch._int_mm`` for both products,
    the float steps between them as the plain version takes them."""
    from keypoints_interpolation_transformer_torch.ops.kernels.ffn import (
        LN_EPS)
    F = torch.nn.functional
    mm1 = _library_int8_matmul(torch, w1q, w1s)
    mm2 = _library_int8_matmul(torch, w2q, w2s)

    def ff(r):
        D = r.shape[-1]
        x1 = F.layer_norm(r, (D,), g1, be1, LN_EPS) if pre_ln else r
        h = F.gelu(mm1(x1) + b1)
        return F.layer_norm((x1 + mm2(h)) + b2, (D,), g2, be2, LN_EPS)
    return ff


def library_ffn_int8(torch, r, *weights):
    ff = _library_ff_int8(torch, *weights)
    return lambda: ff(r)


def library_encoder_layer_int8(torch, x, wqkv, bqkv, wo, bo, w1q, w1s, b1,
                               w2q, w2s, b2, g1, be1, g2, be2, mask, valid,
                               kind, add_keypad, heads):
    """``nn.MultiheadAttention`` (float32, its float mask built once, the
    fast path off) plus the residual, then the int8 FF sublayer with
    ``torch._int_mm`` (``_library_ff_int8``)."""
    T, D = x.shape[1:]
    mha = torch.nn.MultiheadAttention(D, heads, batch_first=True,
                                      device=x.device)
    with torch.no_grad():
        _load_attention(mha, wqkv, bqkv, wo, bo)
    mha.eval().requires_grad_(False)
    m = _layer_mask(torch, mask, valid, T, kind, add_keypad, heads)
    ff = _library_ff_int8(torch, w1q, w1s, b1, w2q, w2s, b2, g1, be1, g2,
                          be2, True)
    return _without_fastpath(torch, lambda: ff(
        x + mha(x, x, x, attn_mask=m, need_weights=False)[0]))


# the kernels whose function one PyTorch call computes; the masked loss has
# none (it takes a weighted squared difference and two reductions: no one
# call of torch.nn.functional weights frames and divides per video).  The
# int8 kernels have none either: their library time is ``torch._int_mm``
# (cuBLASLt) on the int8 operands plus the plain quantize and dequantize
# steps and the float ops around them, labelled so where it is printed.
LIBRARY = {"mode_linear_default": library_mode_linear,
           "enc_layer": library_encoder_layer,
           "dec_layer": library_decoder_layer,
           "attention": library_attention,
           "attention_bwd": library_attention_bwd,
           "int8_dense": library_int8_dense,
           "ffn_int8": library_ffn_int8,
           "enc_layer_int8": library_encoder_layer_int8}


def bound(name, B, T):
    """(bound_ms, bound_by): the larger of the operations over the peak for
    their type (float32 FLOP over the FFMA peak, or in the precision modes
    over the bf16 tensor-core peak, three times for "high", twice for a
    merged layer's p v; int8
    operations over the int8 tensor-core peak) and the bytes over the
    memory rate."""
    flop, int8, byts = work(name, B, T)
    peak = PEAK_FLOPS
    if name.endswith("_high"):
        # three passes a product; a product of the probabilities (a merged
        # layer's p v, half its attention core's FLOP; the sublayer's p v,
        # or its backward's p^T dA) two, its probabilities being one bf16
        pv = 2 * B * HEADS * T * T * (D // HEADS)
        pv = (2 if name.startswith("dec") else 1) * pv \
            if name in LAYER_MODE_KERNELS + INT8_MODE_KERNELS else \
            pv if name in SUBLAYER_MODE_KERNELS + ("attention_high",) else 0
        flop, peak = 3 * flop - pv, PEAK_BF16
    elif name.endswith("_default"):
        peak = PEAK_BF16
    t_op, t_mem = flop / peak + int8 / PEAK_INT8, byts / PEAK_BYTES
    return max(t_op, t_mem) * 1e3, "operations" if t_op >= t_mem else "bytes"


def products_yardstick(torch, name, B, T):
    """(call, count): the matrix products of mode kernel ``name`` at (B, T)
    alone, as ``torch.matmul`` calls on bf16 planes of random operands:
    three a product at "high" (hi hi, hi lo, lo hi; p v two), one at
    "default"; the FF forward's two products (x1 W1, gelu(u) W2), the
    backward's four (dz W2^T, dz^T gelu(u), du^T x1, du W1^T), a merged
    layer's projections, FF pair and per-head scores and p v; the attention
    sublayer's projections, scores and p v, its backward's dA, dW_out,
    dW_in and dx and per head the scores, gw, dv, dq and dk; the per-op
    pair's per-head products alone; a chain's three products.  A yardstick
    of the products' cost, not the kernel's function: no LayerNorm, GELU,
    softmax, bias or residual, bf16 outputs, and the planes are made
    outside the call."""
    N = B * T
    gen = torch.Generator(device=DEV).manual_seed(9)

    def planes(*shape):
        x = torch.randn(*shape, device=DEV, generator=gen)
        hi = x.to(torch.bfloat16)
        return hi, (x - hi.float()).to(torch.bfloat16)

    def t(p):
        return p[0].t(), p[1].t()

    three = name.endswith("_high")
    # (A's planes, B's planes, terms): three at "high" but for p v's two
    # (one bf16 p against v's hi and lo), one at "default"
    if name.startswith("ffn_bwd_split"):
        dz, x1, du, h = planes(N, D), planes(N, D), planes(N, FF), planes(N,
                                                                       FF)
        w1t, w2t = planes(FF, D), planes(D, FF)
        prods = [(dz, w2t, 3), (t(dz), h, 3), (t(du), x1, 3), (du, w1t, 3)]
    elif name.startswith("attn_sublayer"):
        dh, BH = D // HEADS, B * HEADS
        scores = (planes(BH, T, dh), planes(BH, dh, T), 3)
        if "bwd" in name:  # dA, dW_out, dW_in, dx; scores, gw, dv, dq, dk
            prods = [(planes(N, D), planes(D, D), 3),
                     (t(planes(N, D)), planes(N, D), 3),
                     (t(planes(N, 3 * D)), planes(N, D), 3),
                     (planes(N, 3 * D), planes(3 * D, D), 3),
                     scores, scores, (planes(BH, T, T), planes(BH, T, dh), 2),
                     (planes(BH, T, T), planes(BH, T, dh), 3),
                     (planes(BH, T, T), planes(BH, T, dh), 3)]
        else:
            prods = [(planes(N, D), planes(D, 3 * D), 3),
                     (planes(N, D), planes(D, D), 3), scores,
                     (planes(BH, T, T), planes(BH, T, dh), 2)]
    elif name.startswith("attention"):
        # per head (batched) the scores and p v; the backward's scores, gw,
        # dv (p split), dq and dk
        dh, BH = D // HEADS, B * HEADS
        scores = (planes(BH, T, dh), planes(BH, dh, T), 3)
        by_p = (planes(BH, T, T), planes(BH, T, dh), 3)
        prods = [scores, scores, by_p, by_p, by_p] if "bwd" in name else \
            [scores, (planes(BH, T, T), planes(BH, T, dh), 2)]
    elif name.startswith("mode_linear"):
        # y = x W (D -> 3D); the backward's dx = g W^T and dW = x^T g
        prods = [(planes(N, 3 * D), planes(3 * D, D), 3),
                 (t(planes(N, D)), planes(N, 3 * D), 3)] \
            if "bwd" in name else [(planes(N, D), planes(D, 3 * D), 3)]
    elif name.startswith(("pre_stream_embed", "post_head")):
        # the embedding (108 -> D, K padded to 112), [W1 | W2] and W3, or
        # [W1 | W2], W3 and the head (D -> 108, N padded to 112)
        swiglu = [(planes(N, D), planes(D, 2 * D), 3),
                  (planes(N, D), planes(D, D), 3)]
        prods = [(planes(N, 112), planes(112, D), 3)] + swiglu \
            if name.startswith("pre") else \
            swiglu + [(planes(N, D), planes(D, 112), 3)]
    elif name.startswith(("enc_layer", "dec_layer")):
        # the projections, the FF pair and per head (batched) the scores
        # and p v; the decoder adds the cross q, the memory's k / v, a
        # second out-projection and attention
        dec = name.startswith("dec")
        dh, BH = D // HEADS, B * HEADS
        prods = [(planes(N, D), planes(D, 3 * D), 3),
                 (planes(N, D), planes(D, D), 3),
                 (planes(N, D), planes(D, FF), 3),
                 (planes(N, FF), planes(FF, D), 3)]
        attn = [(planes(BH, T, dh), planes(BH, dh, T), 3),
                (planes(BH, T, T), planes(BH, T, dh), 2)]
        prods += attn
        if dec:
            prods += [(planes(N, D), planes(D, D), 3),
                      (planes(N, D), planes(D, 2 * D), 3),
                      (planes(N, D), planes(D, D), 3)] + attn
    else:
        prods = [(planes(N, D), planes(D, FF), 3),
                 (planes(N, FF), planes(FF, D), 3)]

    def call():
        for (ah, al), (bh, bl), terms in prods:
            torch.matmul(ah, bh)
            if three:
                torch.matmul(ah, bl)
                if terms == 3:
                    torch.matmul(al, bh)

    return call, sum(terms if three else 1 for _, _, terms in prods)


# the kernels a call of which makes a known number of launches, which
# phase 2 reads from the profiler at its timed row: mode_linear's forward
# one (x split in the kernel, W's planes cached), its backward two (dx with
# g's planes and db's parts, then dW with the ordered sums), the attention
# sublayer's training forward in a mode two for self-attention at T=128
# (q / k / v and the core per head, then the out-projection with the
# LayerNorm), its backward seven (the fused core; the forward's planes of
# x and a)
CALL_LAUNCHES = {"mode_linear_high": 1, "mode_linear_default": 1,
                 "mode_linear_bwd_high": 2, "mode_linear_bwd_default": 2,
                 "attn_sublayer_train_high": 2,
                 "attn_sublayer_train_default": 2,
                 "attn_sublayer_bwd_high": 7, "attn_sublayer_bwd_default": 7,
                 # the merged layers' two-kernel attention halves at B=256,
                 # T=128 (the decoder with its FF tail)
                 "enc_layer_high": 3, "enc_layer_default": 3,
                 "dec_layer_high": 5, "dec_layer_default": 5,
                 "enc_layer_int8_high": 3, "enc_layer_int8_default": 3,
                 # the pointwise chains in a mode at the flagship width: one
                 # launch a chain (chain_tc_kernel)
                 "pre_stream_embed_high": 1, "pre_stream_embed_default": 1,
                 "post_head_high": 1, "post_head_default": 1}
# the sublayer forwards, whose launches phase 2 prints apart
FORWARD_KERNELS = ("ffn", "ffn_train", "attn_sublayer", "attn_sublayer_train")
# one 128-frame video and the 600-frame request's bucket: the FF split and
# the projections' narrow tiles (attention runs per op at 608)
SMALL_SHAPES = ((1, T_MAIN), (1, 608))


def kernel_key(name):
    """A profiler kernel name without its return type, namespace and
    arguments: ``ffn_kernel<8, 64, 256>``."""
    name = re.sub(r"^void |\(anonymous namespace\)::|kit::", "", name)
    return name.split("(")[0][:48]


def launch_ms(torch, fn, count=False):
    """One call's device time by CUDA kernel (torch.profiler), in launch
    order, then their sum: "name ms, ...; device sum ms"; with ``count``
    also the number of device activities (kernels and memsets) the call
    made."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append((kernel_key(e.name), us / 1e3))
    text = (", ".join(f"{k} {ms:.4f}" for k, ms in rows)
            + f"; device sum {sum(ms for _, ms in rows):.4f}")
    return (text, len(rows)) if count else text


def host_ms(torch, fn, iters=20):
    """One call's host time, from the call to its return with the card
    idle at the start: the wrapper's checks, allocations and launches (the
    kernels run after it returns unless the host waits for them)."""
    fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / iters * 1e3


def phase_kernels(torch, kmod):
    print("phase 2: kernels against their plain versions", flush=True)
    print(f"  tolerance {REL_TOL:.0e} x max(1, max |plain|): float32 FFMA "
          "kernels against cuBLAS float32, the same products summed in "
          "another order", flush=True)
    print(f"  gradients: {GRAD_TOL:.0e} x the call's largest plain "
          "gradient: the same, summed over up to 8192 rows; some gradients "
          "(the k-bias) are exactly zero in exact arithmetic, so no "
          "per-tensor scale", flush=True)
    print(f"  attention sublayer's and merged layers' mode kernels: each "
          "output within LAYER_MODE_TOL of its own max |plain| (the "
          "training forward's raw a within RAW_A_TOL), the mean at "
          f"'high' within {LAYER_HIGH_MEAN_TOL:.0e}, and the mean "
          f"{MODE_SEPARATION:g} x nearer its own mode (a flipped bf16 "
          "probability moves a few tokens)", flush=True)
    print(f"  precision modes' FF kernels: each output within "
          f"{HIGH_MODE_TOL:.0e} ('high') / {DEFAULT_MODE_TOL:.0e} "
          f"('default') of its own max "
          f"|plain|, and {MODE_SEPARATION:g} x nearer the plain version in "
          "its mode than in the wrong one (one bf16 pass for 'high', "
          "float32 for 'default')", flush=True)
    chk = KernelCheck(torch, kmod)

    def all_calls(B, T, b_train, blocked=True):
        return ([(*c, False, None) for c in chk.calls(B, T)]
                + [(*c, None) for c in chk.train_calls(b_train, T)
                   + chk.per_op_calls(b_train, T, blocked)]
                + [(*c, False, None) for c in chk.int8_calls(B, T)]
                + chk.precision_calls(B, b_train, T)
                + chk.layer_mode_calls(chk.operands(B, T), *chk.masks(B, T))
                + chk.sublayer_mode_calls(B, b_train, T, blocked)
                + chk.op_mode_calls(b_train, T, blocked)
                + chk.chain_mode_calls(B, T)
                + chk.linear_mode_calls(b_train, T)
                + chk.int8_layer_mode_calls(chk.operands(B, T),
                                            *chk.masks(B, T)))

    def held(fn):
        return None if fn is None else fn()

    for T in (128, 40, 256, 300):
        for name, variant, kern, plain, grad, wrong in all_calls(3, T, 3):
            chk.compare(name, f"B=3 T={T} {variant}", kern(), plain(), grad,
                        held(wrong))
    # the attention sublayer's mode kernels where the fused backward core
    # takes two tiles of 128 rows: T=144 (the last fused length at "high")
    # and T=240 (at "default"; the two-kernel core at "high"); on operands
    # of their own, so that every other check keeps the operands it had
    two = KernelCheck(torch, kmod)
    for T in (144, 240):
        for name, variant, kern, plain, grad, wrong in \
                two.sublayer_mode_calls(3, 3, T, True):
            two.compare(name, f"B=3 T={T} {variant}", kern(), plain(), grad,
                        wrong())
    # the training forward's two-kernel path (csrc/attn_sublayer_modes.cu
    # fused_fwd: kernel width 256, 32-wide heads, T <= 128) for a narrower
    # model (n = 224, 7 heads: one padded head slice), its kept planes and
    # mode_linear's backward run twice
    new_path_checks(torch, kmod)
    # the per-op kernels at the lengths they carry: above the sublayer
    # kernel's 512 frames up to the positional table's 2048
    for T in ATTN_T:
        B = 2 if T == 2048 else 3
        for name, variant, kern, plain, grad in chk.per_op_calls(B, T):
            chk.compare(name, f"B={B} T={T} {variant}", kern(), plain(),
                        grad)
        for name, variant, kern, plain, grad, wrong in chk.op_mode_calls(B,
                                                                         T):
            chk.compare(name, f"B={B} T={T} {variant}", kern(), plain(),
                        grad, wrong())
    # the standing draw on which a dl's bf16 rounding flips between float32
    # orders (FLIP_TOL), every time
    flip, rows = flip_draw_calls(torch, kmod)
    for name, variant, kern, plain, grad, wrong in rows:
        flip.compare(name, f"B=3 T=512 {variant}, standing draw", kern(),
                     plain(), grad, wrong(),
                     flip=(name, variant) in FLIP_ROWS)
    # the flipped dl itself, on the card: the plain version's float32 value
    # in three orders, each with its bf16 rounding
    for name, variant in FLIP_ROWS:
        args = flip.layer_args[f"{name} {variant}"]
        for order, x in flip_dl_orders(torch, kmod, args).items():
            print(f"  {name} {variant}, standing draw: dl of video "
                  f"{FLIP_DL[0]}, head {FLIP_DL[1]}, key {FLIP_DL[2]}, query "
                  f"{FLIP_DL[3]} in {order}: {x['dl']:.9e} -> bf16 "
                  f"{x['bf16']:.9e}", flush=True)
    # the merged decoder layer in a mode at its longest length, without
    # its FF tail (T 257-512), the keys in one stage of its attention core
    o, (mask, valid) = chk.operands(2, 512), chk.masks(2, 512)
    for name, variant, kern, plain, grad, wrong in chk.layer_mode_calls(
            o, mask, valid, encoder=False, tails=(False,)):
        chk.compare(name, f"B=2 T=512 {variant}", kern(), plain(), grad,
                    wrong())
    # the training kernels at the sublayer kernel's longest length: four
    # key tiles of the backward's attention core, their dq parts added in
    # order, and a video whose keys are all padded
    for name, variant, kern, plain, grad in chk.train_calls(3, 512, True):
        chk.compare(name, f"B=3 T=512 {variant}, video 3 all padded", kern(),
                    plain(), grad)
    # the attention sublayer's mode kernels there too (more keys than one
    # stage of the backward's cores holds at the widest heads)
    for name, variant, kern, plain, grad, wrong in chk.sublayer_mode_calls(
            3, 3, 512, True):
        chk.compare(name, f"B=3 T=512 {variant}, training video 3 all "
                    "padded", kern(), plain(), grad, wrong())
    # the batch picks the whole-layer kernels' cluster size; serving
    # batches take every size, so each is held here, at lengths that fill
    # the row tiles, leave a padded tail (40, 300) and split the FF chunks
    # over 2 to 8 blocks a tile (ff_parts)
    for T in (128, 40, 256, 300):
        o, (mask, valid) = chk.operands(3, T), chk.masks(3, T)
        for cl in range(1, 9):
            for name, variant, kern, plain in (
                    chk.layer_calls(o, mask, valid, cl)
                    + chk.int8_layer_calls(o, mask, valid, cl)):
                chk.compare(name, f"B=3 T={T} {variant}", kern(), plain())
    times, first, given = {}, {}, {}
    for name, variant, kern, plain, grad, wrong in all_calls(
            B_MAIN, T_MAIN, B_TRAIN, False):
        B = B_TRAIN if name in TRAIN_KERNELS + PER_OP_KERNELS \
            + MODE_TRAIN_KERNELS + LINEAR_MODE_KERNELS else B_MAIN
        chk.compare(name, f"B={B} T={T_MAIN} {variant}", kern(), plain(),
                    grad, held(wrong))
        if RESIDUAL_FORM in variant:
            given.setdefault(name, (variant, kern, plain))
        else:
            first.setdefault(name, (variant, kern, plain, B, grad))
    for name, (variant, kern, plain, B, grad) in first.items():
        lib = (LIBRARY[name](torch, *chk.layer_args[name])
               if name in LIBRARY else None)
        if lib is not None:
            chk.compare(f"{name} library", f"B={B} T={T_MAIN} {variant}",
                        lib(), plain(), grad)
        if name == "masked_loss":
            print("  masked_loss library: none; no one PyTorch call weights "
                  "frames and divides per video", flush=True)
        if name in INT8_KERNELS:
            print(f"  {name} library: torch._int_mm (cuBLASLt int8) on the "
                  "int8 operands with the plain quantize and dequantize "
                  "steps and float ops around it", flush=True)
        if name in MODE_SERVE_KERNELS + MODE_TRAIN_KERNELS:
            print(f"  {name} library: none; no one PyTorch call computes "
                  "the fused sublayer, and none rounds float32 operands "
                  "to bf16 hi / lo parts", flush=True)
        if name in LAYER_MODE_KERNELS + INT8_MODE_KERNELS:
            print(f"  {name} library: none; no PyTorch call rounds the "
                  "operands of a layer's products, or its softmax "
                  "probabilities, to bf16 in-chain", flush=True)
        if name in LINEAR_MODE_KERNELS and lib is None:
            print(f"  {name} library: none; no one PyTorch call sums the "
                  "three products of bf16 hi / lo parts (\"high\") or "
                  "takes a product's two transposed products at once (the "
                  "backward); the products-only yardstick below",
                  flush=True)
        p0 = timed_ms(plain)
        k0 = timed_ms(kern)
        lib_ms = min(timed_ms(lib), timed_ms(lib)) if lib else None
        k1 = timed_ms(kern)
        p1 = timed_ms(plain)
        b_ms, b_by = bound(name, B, T_MAIN)
        times[name] = (min(k0, k1), min(p0, p1), b_ms, b_by, lib_ms)
        rate = ""
        if name in LAYER_KERNELS + LAYER_MODE_KERNELS + INT8_MODE_KERNELS:
            flop, int8, _ = work(name, B, T_MAIN)  # the work, over its time
            rate = f"  {flop / times[name][0] / 1e9:.1f} TFLOP/s" + (
                f" + {int8 / times[name][0] / 1e9:.1f} int8 TOP/s"
                if int8 else "")
        print(f"  time {name:19s} {variant:28s} kernel {times[name][0]:.4f} "
              f"ms  plain {times[name][1]:.4f} ms  bound {b_ms:.4f} ms "
              f"({b_by}; the kernel at {b_ms / times[name][0]:.1%} of it)"
              + (f"  library {lib_ms:.4f} ms" if lib else "") + rate
              + f"  (B={B} T={T_MAIN})", flush=True)
        if name in MODE_FF_KERNELS + LAYER_MODE_KERNELS \
                + SUBLAYER_MODE_KERNELS + ATTN_MODE_KERNELS \
                + CHAIN_MODE_KERNELS + LINEAR_MODE_KERNELS:
            call, count = products_yardstick(torch, name, B, T_MAIN)
            y_ms = min(timed_ms(call), timed_ms(call))
            print(f"  yardstick {name:14s} products only: {y_ms:.4f} ms "
                  f"({count} torch.matmul calls on bf16 planes, bf16 "
                  "outputs; not the kernel's function: no LayerNorm, GELU, "
                  f"bias or float32 output; B={B} T={T_MAIN}); the kernel "
                  f"at {y_ms / times[name][0]:.1%} of it", flush=True)
        if name in FORWARD_KERNELS + SUBLAYER_MODE_KERNELS + (
                "attn_sublayer_bwd",) + ATTN_MODE_KERNELS \
                + CHAIN_MODE_KERNELS + LINEAR_MODE_KERNELS \
                + LAYER_MODE_KERNELS + INT8_MODE_KERNELS:
            text, n = launch_ms(torch, kern, count=True)
            # an empty trace is the profiler's, not a call's (every row
            # launches): three traces in a row once came back empty
            for _ in range(5):
                if n:
                    break
                text, n = launch_ms(torch, kern, count=True)
            print(f"  launches {name}: {text} ms; host "
                  f"{host_ms(torch, kern):.4f} ms a call; {n} device "
                  "activities a call", flush=True)
            if name in CALL_LAUNCHES and n != CALL_LAUNCHES[name]:
                fail(f"{name} {variant}: {n} device activities a call, not "
                     f"{CALL_LAUNCHES[name]}")
        if name in given:  # the training route's form, beside the row
            gvariant, gkern, gplain = given[name]
            g_ms = min(timed_ms(gkern), timed_ms(gkern))
            gp_ms = min(timed_ms(gplain), timed_ms(gplain))
            gb_ms, gb_by = bound(f"{name}_given", B, T_MAIN)
            print(f"  time {name:19s} {gvariant:28s} kernel {g_ms:.4f} ms  "
                  f"plain {gp_ms:.4f} ms  bound {gb_ms:.4f} ms ({gb_by}; the "
                  f"kernel at {gb_ms / g_ms:.1%} of it)  (B={B} T={T_MAIN}; "
                  "the row above runs the forward first, as the library "
                  "call does)", flush=True)
    # the forwards at one 128-frame video and at the 600-frame request's
    # bucket: the FF split (ff_parts) and the projections' narrow tiles
    for B, T in SMALL_SHAPES:
        for name, variant, kern, plain in chk.forward_calls(B, T):
            chk.compare(name, f"B={B} T={T} {variant}", kern(), plain())
            k_ms = min(timed_ms(kern), timed_ms(kern))
            p_ms = min(timed_ms(plain), timed_ms(plain))
            b_ms, b_by = bound(name, B, T)
            print(f"  time {name:19s} {variant:28s} kernel {k_ms:.4f} ms  "
                  f"plain {p_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}; the "
                  f"kernel at {b_ms / k_ms:.1%} of it)  (B={B} T={T}); "
                  f"launches {launch_ms(torch, kern)} ms", flush=True)
    # the int8 dense layer at the q / k / v projection of the 600-frame
    # request's per-op route (608 rows, D -> 3D), timed beside its plain
    # version and the library call (printed; the JSON line keeps the
    # Embedding's shape above)
    # the decoder layer without its FF tail, as the int8 route runs it
    # (then ffn_int8): timed for the route's breakdown (PERF.md §5)
    args = list(chk.layer_args["dec_layer"])
    args[12] = None  # ff
    ms = [min(timed_ms(f), timed_ms(f)) for f in (
        lambda: kmod.fused_decoder_layer(*args),
        lambda: kmod.decoder_layer_plain(*args))]
    print(f"  time {'dec_layer':19s} {'plain self repeat-inc ff=False':28s} "
          f"kernel {ms[0]:.4f} ms  plain {ms[1]:.4f} ms  (B={B_MAIN} "
          f"T={T_MAIN})", flush=True)
    from keypoints_interpolation_transformer_torch.ops.kernels.int8_matmul \
        import quantize_weight
    o = chk.operands(1, 608)
    args = (o["x"], *quantize_weight(o["wqkv"].t().contiguous(), "dense"),
            o["bqkv"])
    variant = f"qkv projection {D}->{3 * D}"
    kern = lambda: kmod.fused_int8_dense(*args)  # noqa: E731
    plain = lambda: kmod.int8_dense_plain(*args)  # noqa: E731
    lib = library_int8_dense(torch, *args)
    chk.compare("int8_dense", f"B=1 T=608 {variant}", kern(), plain())
    chk.compare("int8_dense library", f"B=1 T=608 {variant}", lib(), plain())
    ms = [min(timed_ms(f), timed_ms(f)) for f in (kern, plain, lib)]
    print(f"  time {'int8_dense':19s} {variant:28s} kernel {ms[0]:.4f} ms  "
          f"plain {ms[1]:.4f} ms  library {ms[2]:.4f} ms  (608 rows)",
          flush=True)
    return chk.max_err, times


def model_inputs(B, T, seed):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(np.float32)
    miss = (rng.uniform(size=(B, T)) < 0.3).astype(np.float32)
    return clean, miss


def masked_mpjpe_delta(out, ref, miss):
    d = np.sqrt(((out - ref) ** 2).sum(-1))  # (B, T, K)
    w = miss[..., None]
    return float((d * w).sum() / max(w.sum() * d.shape[-1], 1.0))


def phase_model(torch, kmod, model):
    from keypoints_interpolation_transformer_torch.ops.losses import (
        composite_prediction)
    from keypoints_interpolation_transformer_torch.transforms.corruption \
        import add_sos
    print("phase 3: flagship KeypointCompleter, merged and per-sublayer "
          "route vs plain path", flush=True)
    clean, miss = model_inputs(B_MAIN, T_MAIN, 0)
    clean_t = torch.from_numpy(clean).to(DEV)
    inputs, mask = add_sos(clean_t, torch.from_numpy(miss).to(DEV))
    x, x_no, x_mask, y_mask = inputs[:, :-1], inputs[:, 1:], mask[:, :-1], \
        mask[:, 1:]
    valid = torch.ones(B_MAIN, T_MAIN, device=DEV)
    outs, counts = {}, {}
    with torch.inference_mode():
        for route in ("plain", "merged", "sublayer"):
            model.merge_layers = route != "sublayer"
            kmod.reset_launches()
            pred = model(x, x_no, x_mask, y_mask, valid,
                         plain=route == "plain")
            outs[route] = composite_prediction(pred, clean_t,
                                               y_mask).cpu().numpy()
            torch.cuda.synchronize()
            counts[route] = kmod.launch_counts()
    model.merge_layers = True
    if any(counts["plain"].values()):
        fail(f"plain path launched kernels: {counts['plain']}")
    out_p = outs["plain"]
    for route, want in (("merged", MERGED_COUNTS),
                        ("sublayer", SUBLAYER_COUNTS)):
        got = outs[route]
        print(f"  {route} route: launches in one forward {counts[route]}",
              flush=True)
        if counts[route] != want:
            fail(f"{route} route launch counts {counts[route]} != {want}")
        if got.shape != (B_MAIN, T_MAIN, 54, 2) or \
                not np.isfinite(got).all():
            fail(f"{route} route: output shape {got.shape} or non-finite "
                 "values")
        delta = masked_mpjpe_delta(got, out_p, miss)
        print(f"  {route} route: masked MPJPE delta vs plain {delta:.3e} "
              f"(gate {MPJPE_TOL:.0e}); max abs {np.abs(got - out_p).max():.3e}",
              flush=True)
        if not delta < MPJPE_TOL:
            fail(f"{route} route: masked MPJPE delta {delta:.3e} >= "
                 f"{MPJPE_TOL}")
        if not np.array_equal(got[miss == 0], clean[miss == 0]):
            fail(f"{route} route: composite changed a non-missing frame")


def request_videos(seed):
    """Three videos, one longer than 256 frames (its bucket of 320 takes
    the per-sublayer encoder and the decoder without its FF tail), with
    30 % of the frames missing."""
    rng = np.random.default_rng(seed)
    lengths = (300, 77, 128)
    videos = [rng.uniform(0.2, 0.8, (t, 54, 2)).astype(np.float32)
              for t in lengths]
    masks = [(rng.random(t) < 0.3).astype(np.float32) for t in lengths]
    return videos, masks


def check_served(tag, videos, masks, got, want):
    """Each served video: its shape, finite, non-missing frames bit-exact,
    missing ones within SERVE_TOL of the plain-path Inpainter's."""
    worst = 0.0
    for i, (v, m, g, w) in enumerate(zip(videos, masks, got, want)):
        g = np.asarray(g, np.float32)
        if g.shape != v.shape or not np.isfinite(g).all():
            fail(f"{tag} {i}: shape {g.shape} or non-finite values")
        if not np.array_equal(g[m == 0], v[m == 0]):
            fail(f"{tag} {i}: a non-missing frame changed")
        err = float(np.abs(g[m == 1] - w[m == 1]).max())
        worst = max(worst, err)
        print(f"  {tag} {i}: T={len(v)} missing={int(m.sum())} "
              f"max_abs_err vs plain-path Inpainter {err:.3e} "
              f"(tol {SERVE_TOL:.0e})", flush=True)
    if worst > SERVE_TOL:
        fail(f"{tag}: predictions differ from the plain path by {worst}")


def post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def phase_serving(torch, kmod, model, tmp):
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter, make_server)
    from keypoints_interpolation_transformer_torch.models.convert import (
        save_reference_pth)
    print("phase 4: HTTP serving from a reference .pth", flush=True)
    path = os.path.join(tmp, "flagship.pth")
    save_reference_pth(path, model, {"hidden_dim": D, "num_layers": LAYERS,
                                     "num_heads": HEADS, "input_size": F_IN})
    inp = Inpainter.from_checkpoint(path, device=DEV)
    oracle = Inpainter.from_checkpoint(path, device=DEV, plain=True)
    videos, masks = request_videos(7)
    want = oracle.inpaint(videos, masks)

    server, batcher = make_server(inp, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        if get(f"{base}/healthz") != {"ok": True}:
            fail("/healthz")
        results = [None] * 3
        errors = []

        def one(i):
            try:
                results[i] = post(f"{base}/inpaint",
                                  {"videos": [videos[i].tolist()],
                                   "masks": [masks[i].tolist()]})
            except Exception as e:  # reported below, the run fails
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        kmod.reset_launches()
        clients = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        torch.cuda.synchronize()
        launches = kmod.launch_counts()
        if errors or any(c.is_alive() for c in clients):
            fail(f"requests did not complete: {errors}")
        stats = get(f"{base}/statz")
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=30)
    print(f"  launches during the three requests (the merged route at T <= "
          f"256, the per-sublayer one above): {launches}", flush=True)
    if not all(launches[n] for n in SERVING_KERNELS):
        fail(f"a kernel of the path was not launched: {launches}")
    check_served("request", videos, masks,
                 [r["videos"][0] for r in results], want)
    print(f"  /statz {stats}", flush=True)
    if stats["requests"] != 3 or stats["videos"] != 3:
        fail(f"/statz counted {stats}, expected 3 requests and 3 videos")
    return launches, path, inp, oracle


def phase_variants(torch, kmod, tmp, first_path):
    """The Cycle model over the flagship (its frozen first model) and an
    Embedding autoencoder, each from a reference .pth, served on the card
    against the plain-path Inpainter."""
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    from keypoints_interpolation_transformer_torch.models.completer import (
        Embedding, keypoint_completer_cycle)
    from keypoints_interpolation_transformer_torch.models.convert import (
        save_reference_pth)
    print("phase 5: Cycle and Embedding variants from reference .pth files",
          flush=True)
    hyper = {"hidden_dim": D, "num_layers": LAYERS, "num_heads": HEADS,
             "input_size": F_IN}
    paths = {v: os.path.join(tmp, f"{v}.pth") for v in ("cycle",
                                                        "embedding")}
    save_reference_pth(paths["cycle"], keypoint_completer_cycle(
        D, LAYERS, HEADS, ff_dim=FF, device=DEV,
        generator=torch.Generator().manual_seed(1)), hyper)
    save_reference_pth(paths["embedding"], Embedding(
        D, F_IN, device=DEV, generator=torch.Generator().manual_seed(2)),
        hyper)
    videos, masks = request_videos(8)
    for variant in ("cycle", "embedding"):
        kw = dict(variant=variant, device=DEV,
                  first_checkpoint=first_path if variant == "cycle" else None)
        want = Inpainter.from_checkpoint(paths[variant], plain=True,
                                         **kw).inpaint(videos, masks)
        inp = Inpainter.from_checkpoint(paths[variant], **kw)
        kmod.reset_launches()
        got = inp.inpaint(videos, masks)
        torch.cuda.synchronize()
        launches = {n: c for n, c in kmod.launch_counts().items() if c}
        print(f"  {variant}: launches {launches}", flush=True)
        if variant == "cycle" and not (launches.get("enc_layer")
                                       and launches.get("dec_layer")):
            fail(f"cycle: the merged kernels were not launched: {launches}")
        check_served(variant, videos, masks, got, want)
    return paths


def phase_long_request(torch, kmod, path, gpu):
    """One request of one 600-frame video with ``max_seq_len=640``: its
    bucket of 608 frames is above the sublayer kernel's 512, so attention
    goes per op (``fused_attention``), as the JAX package routes it; held
    against the plain-path Inpainter and timed beside it; then at "high"
    (the per-op cores, FF sublayers and chains in the mode) against
    "highest" by bench.py's gate."""
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    print("phase 5: one 600-frame request on the per-op route", flush=True)
    rng = np.random.default_rng(12)
    video = [rng.uniform(0.2, 0.8, (600, 54, 2)).astype(np.float32)]
    miss = [(rng.random(600) < 0.3).astype(np.float32)]
    engines = {plain: Inpainter.from_checkpoint(path, device=DEV,
                                                max_seq_len=640, plain=plain)
               for plain in (False, True)}
    want = engines[True].inpaint(video, miss)
    kmod.reset_launches()
    got = engines[False].inpaint(video, miss)
    torch.cuda.synchronize()
    launches = kmod.launch_counts()
    print(f"  600-frame request (bucket 608): launches {launches}",
          flush=True)
    if launches != PER_OP_COUNTS:
        fail(f"600-frame request launches {launches} != {PER_OP_COUNTS}")
    check_served("608 bucket", video, miss, got, want)
    delta = masked_mpjpe_delta(np.asarray(got), np.asarray(want),
                               miss[0][None])
    print(f"  608 bucket: masked MPJPE delta vs plain {delta:.3e} (gate "
          f"{MPJPE_TOL:.0e})", flush=True)
    if not delta < MPJPE_TOL:
        fail(f"608 bucket: masked MPJPE delta {delta:.3e} >= {MPJPE_TOL}")
    # the same request at "high": masked MPJPE against "highest" beside
    # bench.py's gate and beside the plain route's in the mode (the run
    # fails where the kernels miss the gate and their plain version does
    # not); the kernel route against the plain route printed
    high = {plain: Inpainter.from_checkpoint(
        path, device=DEV, max_seq_len=640, plain=plain, precision="high")
        for plain in (False, True)}
    want_h = high[True].inpaint(video, miss)
    kmod.reset_launches()
    got_h = high[False].inpaint(video, miss)
    torch.cuda.synchronize()
    counts = kmod.launch_counts()
    print(f"  600-frame request at \"high\": launches {nonzero(counts)}",
          flush=True)
    if counts != PER_OP_HIGH_COUNTS:
        fail(f"600-frame request at high: launches {counts} != "
             f"{PER_OP_HIGH_COUNTS}")
    # a warm request splits no weight: W's planes are kept per weight
    # version (``weight_planes``)
    kmod.weight_planes.splits["bf16x3"] = 0
    high[False].inpaint(video, miss)
    torch.cuda.synchronize()
    splits = kmod.weight_planes.splits["bf16x3"]
    print(f"  600-frame request at \"high\", warm: {splits} weight splits "
          "(mode_linear's W planes kept)", flush=True)
    if splits != 0:
        fail(f"a warm 600-frame request at high split {splits} weights")
    err, _ = pooled_mpjpe("608 bucket at high", video, miss, got_h, want_h)
    delta = masked_mpjpe_delta(np.asarray(got_h), np.asarray(got),
                               miss[0][None])
    pdelta = masked_mpjpe_delta(np.asarray(want_h), np.asarray(want),
                                miss[0][None])
    verdict = "within" if delta < MPJPE_TOL else "at or above"
    print(f"  608 bucket at \"high\": masked MPJPE against \"highest\" "
          f"{delta:.3e} ({verdict} bench.py's gate {MPJPE_TOL:.0e}); the "
          f"plain route in the mode {pdelta:.3e}; kernel route against the "
          f"plain route in the mode {err:.3e}", flush=True)
    if delta >= MPJPE_TOL > pdelta:
        fail(f"608 bucket at high: the kernels miss the gate ({delta:.3e}) "
             f"where their plain version meets it ({pdelta:.3e})")
    lat = {}
    for plain in (True, False, False, True):
        engines[plain].inpaint(video, miss)  # warm
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            engines[plain].inpaint(video, miss)
            ms.append((time.perf_counter() - t0) * 1e3)
        lat[plain] = min(lat.get(plain, float("inf")), float(np.median(ms)))
    print(f"  one 600-frame request: per-op route {lat[False]:.3f} ms, plain "
          f"path {lat[True]:.3f} ms (median of 5, best of 2 turns) on {gpu}",
          flush=True)
    return launches


def phase_throughput(torch, engines, gpu):
    print("phase 6: Inpainter throughput", flush=True)
    clean, miss = model_inputs(B_MAIN, T_MAIN, 3)
    videos, masks = list(clean), list(miss)
    fps = {}
    for name in ("plain", "merged", "sublayer", "sublayer", "merged",
                 "plain"):
        fps[name] = max(fps.get(name, 0.0),
                        frames_per_s(engines[name], videos, masks))
    print(f"  Inpainter B={B_MAIN} T={T_MAIN}: merged route "
          f"{fps['merged']:.1f} frames/s, per-sublayer route "
          f"{fps['sublayer']:.1f} frames/s, plain path {fps['plain']:.1f} "
          f"frames/s on {gpu}", flush=True)
    # one request of one video: what a lone client waits for
    one_v, one_m = [videos[0]], [masks[0]]
    lat = {}
    for name in ("plain", "merged", "sublayer", "sublayer", "merged",
                 "plain"):
        engine = engines[name]
        engine.inpaint(one_v, one_m)  # warm
        ms = []
        for _ in range(7):
            t0 = time.perf_counter()
            engine.inpaint(one_v, one_m)
            ms.append((time.perf_counter() - t0) * 1e3)
        lat[name] = min(lat.get(name, float("inf")), float(np.median(ms)))
    print(f"  one video of {T_MAIN} frames: merged route {lat['merged']:.3f} "
          f"ms, per-sublayer route {lat['sublayer']:.3f} ms, plain path "
          f"{lat['plain']:.3f} ms (median of 7, best of 2 turns) on {gpu}",
          flush=True)
    return fps


def pooled_mpjpe(tag, videos, masks, got, want):
    """(masked MPJPE over all the missing frames of the videos, the worst
    video's); each served video's shape, finite values and non-missing
    frames (bit for bit the input) checked on the way."""
    err = weight = worst = 0.0
    for i, (v, m, g, w) in enumerate(zip(videos, masks, got, want)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        if g.shape != v.shape or not np.isfinite(g).all():
            fail(f"{tag} {i}: shape {g.shape} or non-finite values")
        if not np.array_equal(g[m == 0], v[m == 0]):
            fail(f"{tag} {i}: a non-missing frame changed")
        d = np.sqrt(((g - w) ** 2).sum(-1))  # (T, K)
        err += float((d * m[:, None]).sum())
        weight += float(m.sum()) * d.shape[-1]
        worst = max(worst, masked_mpjpe_delta(g[None], w[None], m[None]))
    return err / max(weight, 1.0), worst


def int8_tolerance(tag, plain_engine, videos, masks, want):
    """The tolerance of an int8 route against the plain int8 path's
    predictions ``want`` on these videos: INT8_DRIFT times the drift of
    the plain int8 path itself when its inputs move by one ulp, and at
    least INT8_MPJPE_TOL."""
    nudged = [np.nextafter(v, np.float32(2.0)) for v in videos]
    floor, _ = pooled_mpjpe(f"{tag} nudged", nudged, masks,
                            plain_engine.inpaint(nudged, masks), want)
    tol = max(INT8_MPJPE_TOL, INT8_DRIFT * floor)
    print(f"  {tag}: the plain int8 path on inputs one ulp away drifts by "
          f"masked MPJPE {floor:.3e}; tolerance {tol:.3e}", flush=True)
    return tol


def check_int8_served(tag, videos, masks, got, want, tol=INT8_MPJPE_TOL):
    """Videos served int8 against the plain int8 path's ``want``: the
    masked MPJPE over all their missing frames within ``tol`` (see
    ``int8_tolerance``), the worst video's printed beside it."""
    delta, worst = pooled_mpjpe(tag, videos, masks, got, want)
    print(f"  {tag}: {len(videos)} videos, masked MPJPE vs the plain int8 "
          f"path {delta:.3e} (tol {tol:.3e}; worst video {worst:.3e})",
          flush=True)
    if not delta < tol:
        fail(f"{tag}: masked MPJPE {delta:.3e} >= {tol:.3e}")


def serve_over_cli(args, videos, masks):
    """Start ``cli serve`` with ``args`` in a child process on a free port
    of 127.0.0.1, post one /inpaint request, stop the child; returns the
    served videos."""
    import select
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "keypoints_interpolation_transformer_torch.cli",
         "serve", *args, "--port", "0"], cwd=repo, env=env,
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline, url, lines = time.time() + 300, None, []
        while url is None and time.time() < deadline:
            if not select.select([proc.stdout], [], [], 5)[0]:
                if proc.poll() is not None:
                    break
                continue
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving on "):
                url = line.split()[-1]
        if url is None:
            fail(f"cli serve {args} did not start: {''.join(lines)[-2000:]}")
        if get(f"{url}/healthz") != {"ok": True}:
            fail("cli serve: /healthz")
        res = post(f"{url}/inpaint", {"videos": [v.tolist() for v in videos],
                                      "masks": [m.tolist() for m in masks]})
        return [np.asarray(v, np.float32) for v in res["videos"]]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)


# int8 serving in a mode: the videos its gate compares on (the plain route
# on the CPU, the spread's other summation order, takes them in seconds)
INT8_MODE_VIDEOS = 32


def int8_merged_counts(prec):
    """One int8 forward on the merged route in a mode: the pointwise
    kernels, the int8 merged encoder layer and the decoder layer (without
    its FF tail) in the mode, then the int8 FF sublayer."""
    tag = MODE_TAG[prec]
    return {**NO_LAUNCHES, f"pre_stream_embed{tag}": 2,
            f"enc_layer_int8{tag}": LAYERS, f"dec_layer{tag}": LAYERS,
            "ffn_int8": LAYERS, f"post_head{tag}": 1}


def int8_precision(torch, kmod, path, videos, masks, miss, highest, gpu):
    """Int8 serving on the merged route at "high" and "default": the
    launches of one call (``int8_merged_counts``); on the first
    INT8_MODE_VIDEOS videos, the kernel route against the plain int8 route
    in the same precision, within MODE_DRIFT times the plain route's spread
    over float32 summation orders (the plain route on the CPU against it on
    the card; at least INT8_MPJPE_TOL, as ``int8_tolerance`` floors the
    int8 routes), and its distance from the int8 plain route at "highest"
    (``highest``) within MODE_SEPARATION of the plain route's either way;
    frames/s at B=256 beside int8 "highest" in turns.  Returns the int8
    merged encoder's launches per mode."""
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    n = INT8_MODE_VIDEOS
    sub, smask, smiss = videos[:n], masks[:n], miss[:n]
    base = np.stack(highest[:n])
    launches, engines = {}, {}
    for prec in ("high", "default"):
        tag = MODE_TAG[prec]
        eng = {plain: Inpainter.from_checkpoint(
            path, device=DEV, quantize="int8", precision=prec, plain=plain)
            for plain in (False, True)}
        kmod.reset_launches()
        got = eng[False].inpaint(videos, masks)
        torch.cuda.synchronize()
        counts, want = kmod.launch_counts(), int8_merged_counts(prec)
        if counts != want:
            fail(f"int8 merged at {prec}: launches {counts} != {want}")
        launches[f"enc_layer_int8{tag}"] = counts[f"enc_layer_int8{tag}"]
        got = np.stack(got[:n])
        plain = np.stack(eng[True].inpaint(sub, smask))
        t0 = time.perf_counter()
        cpu = np.stack(Inpainter.from_checkpoint(
            path, device="cpu", quantize="int8", precision=prec,
            plain=True).inpaint(sub, smask))
        secs = time.perf_counter() - t0
        if not np.isfinite(got).all() or got.shape != plain.shape:
            fail(f"int8 merged at {prec}: shape {got.shape} or non-finite")
        if not np.array_equal(got[smiss == 0], plain[smiss == 0]):
            fail(f"int8 merged at {prec} changed a non-missing frame")
        delta = masked_mpjpe_delta(got, plain, smiss)
        spread = masked_mpjpe_delta(cpu, plain, smiss)
        tol = max(MODE_DRIFT * spread, INT8_MPJPE_TOL)
        own, pown = (masked_mpjpe_delta(o, base, smiss) for o in (got, plain))
        print(f"  int8 merged at \"{prec}\" ({n} videos): kernel route "
              f"against the plain int8 route in the mode masked MPJPE "
              f"{delta:.3e} (tol {tol:.3e}: {MODE_DRIFT:g} x the plain "
              f"route's spread over summation orders, {spread:.3e} from it "
              f"on the CPU in {secs:.1f} s, at least {INT8_MPJPE_TOL:.0e}); "
              f"against int8 \"highest\" the kernel route {own:.3e}, the "
              f"plain route {pown:.3e} (within {MODE_SEPARATION:g} x of each "
              f"other); launches {nonzero(counts)}", flush=True)
        if not delta < tol:
            fail(f"int8 merged at {prec}: {delta:.3e} from the plain route "
                 f">= {tol:.3e}")
        if not (pown < own * MODE_SEPARATION and own < pown * MODE_SEPARATION):
            fail(f"int8 merged at {prec}: the kernel route lies {own:.3e} "
                 f"from int8 \"highest\", its plain route {pown:.3e}: not "
                 "the mode's arithmetic")
        engines[prec] = eng[False]
        del eng
    engines["highest"] = Inpainter.from_checkpoint(path, device=DEV,
                                                   quantize="int8")
    fps = {}
    for prec in PRECISIONS + PRECISIONS[::-1]:
        fps[prec] = max(fps.get(prec, 0.0),
                        frames_per_s(engines[prec], videos, masks))
    print(f"  Inpainter int8 merged B={B_MAIN} T={T_MAIN}: " + ", ".join(
        f"{p} {fps[p]:.1f} frames/s" for p in PRECISIONS)
        + f" (best of 2 turns) on {gpu}", flush=True)
    return launches


def phase_int8(torch, kmod, path, variant_paths, gpu):
    """Int8 serving (``Inpainter(quantize="int8")``) from the flagship's
    reference .pth, against the plain int8 path and the float32 route."""
    from keypoints_interpolation_transformer_torch.eval.quantize import (
        quantization_error)
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    from keypoints_interpolation_transformer_torch.transforms.corruption \
        import add_sos
    print(f"phase 9: int8 serving from a reference .pth, B={B_MAIN} "
          f"T={T_MAIN}", flush=True)
    clean, miss = model_inputs(B_MAIN, T_MAIN, 4)
    videos, masks = list(clean), list(miss)
    engines = {name: Inpainter.from_checkpoint(
        path, device=DEV, quantize=q, plain=plain, merge_layers=merge)
        for name, q, plain, merge in (
            ("int8 plain", "int8", True, True),
            ("int8 merged", "int8", False, True),
            ("int8 sublayer", "int8", False, False),
            ("float merged", None, False, True))}
    outs, route_counts = {}, {}
    for name, want in (("int8 plain", NO_LAUNCHES),
                       ("int8 merged", INT8_MERGED_COUNTS),
                       ("int8 sublayer", INT8_SUBLAYER_COUNTS),
                       ("float merged", MERGED_COUNTS)):
        kmod.reset_launches()
        out = engines[name].inpaint(videos, masks)
        torch.cuda.synchronize()
        counts = kmod.launch_counts()
        print(f"  {name}: launches in one forward {nonzero(counts)}",
              flush=True)
        if counts != want:
            fail(f"{name}: launch counts {counts} != {want}")
        outs[name], route_counts[name] = out, counts
    tol = int8_tolerance("flagship int8", engines["int8 plain"], videos,
                         masks, outs["int8 plain"])
    for name in ("int8 merged", "int8 sublayer"):
        check_int8_served(name, videos, masks, outs[name],
                          outs["int8 plain"], tol)
    delta = masked_mpjpe_delta(np.stack(outs["int8 merged"]),
                               np.stack(outs["float merged"]), miss)
    print(f"  int8 vs float32 (merged routes): masked MPJPE {delta:.3e} "
          f"(gate {INT8_VS_F32})", flush=True)
    if not 0.0 < delta < INT8_VS_F32:
        fail(f"int8 vs float32 masked MPJPE {delta:.3e}")
    # eval.quantize.quantization_error on the float model, as a deployment
    # gates on it
    model = engines["float merged"].model
    x = torch.from_numpy(clean[:16]).to(DEV)
    inputs, mask = add_sos(x, torch.from_numpy(miss[:16]).to(DEV))
    err = quantization_error(
        model, (inputs[:, :-1], inputs[:, 1:], mask[:, :-1], mask[:, 1:]),
        frame_mask=mask[:, 1:])
    print(f"  quantization_error (16 videos, model forward, masked frames) "
          f"{err:.3e} (gate {INT8_VS_F32})", flush=True)
    if not 0.0 < err < INT8_VS_F32:
        fail(f"quantization_error {err}")

    fps = {}
    for name in ("int8 plain", "float merged", "int8 merged", "int8 merged",
                 "float merged", "int8 plain"):
        fps[name] = max(fps.get(name, 0.0),
                        frames_per_s(engines[name], videos, masks))
    print(f"  Inpainter B={B_MAIN} T={T_MAIN}: int8 merged route "
          f"{fps['int8 merged']:.1f} frames/s, float32 merged route "
          f"{fps['float merged']:.1f} frames/s, int8 plain path "
          f"{fps['int8 plain']:.1f} frames/s on {gpu}", flush=True)
    lat = {}
    for name in ("float merged", "int8 merged", "int8 merged",
                 "float merged"):
        engines[name].inpaint(videos[:1], masks[:1])  # warm
        ms = []
        for _ in range(7):
            t0 = time.perf_counter()
            engines[name].inpaint(videos[:1], masks[:1])
            ms.append((time.perf_counter() - t0) * 1e3)
        lat[name] = min(lat.get(name, float("inf")), float(np.median(ms)))
    print(f"  one video of {T_MAIN} frames: int8 merged route "
          f"{lat['int8 merged']:.3f} ms, float32 merged route "
          f"{lat['float merged']:.3f} ms (median of 7, best of 2 turns) on "
          f"{gpu}", flush=True)
    del engines
    mode_launches = int8_precision(torch, kmod, path, videos, masks, miss,
                                   outs["int8 plain"], gpu)

    # one 600-frame request: bucket 608, attention per op
    rng = np.random.default_rng(13)
    video = [rng.uniform(0.2, 0.8, (600, 54, 2)).astype(np.float32)]
    vmiss = [(rng.random(600) < 0.3).astype(np.float32)]
    long = {plain: Inpainter.from_checkpoint(path, device=DEV,
                                             max_seq_len=640, quantize="int8",
                                             plain=plain)
            for plain in (True, False)}
    want = long[True].inpaint(video, vmiss)
    kmod.reset_launches()
    got = long[False].inpaint(video, vmiss)
    torch.cuda.synchronize()
    launches = kmod.launch_counts()
    print(f"  600-frame request (bucket 608, per-op route): launches "
          f"{nonzero(launches)}", flush=True)
    if launches != INT8_PER_OP_COUNTS:
        fail(f"600-frame int8 launches {launches} != {INT8_PER_OP_COUNTS}")
    check_int8_served("608 bucket", video, vmiss, got, want,
                      int8_tolerance("608 bucket", long[True], video, vmiss,
                                     want))
    del long

    # the Cycle pair and the Embedding autoencoder, int8
    vids, vmasks = request_videos(9)
    for variant in ("cycle", "embedding"):
        kw = dict(variant=variant, device=DEV, quantize="int8",
                  first_checkpoint=path if variant == "cycle" else None)
        oracle = Inpainter.from_checkpoint(variant_paths[variant],
                                           plain=True, **kw)
        want = oracle.inpaint(vids, vmasks)
        inp = Inpainter.from_checkpoint(variant_paths[variant], **kw)
        kmod.reset_launches()
        got = inp.inpaint(vids, vmasks)
        torch.cuda.synchronize()
        counts = nonzero(kmod.launch_counts())
        print(f"  {variant} int8: launches {counts}", flush=True)
        need = ("enc_layer_int8", "ffn_int8") if variant == "cycle" \
            else ("int8_dense",)
        if not all(counts.get(n) for n in need) or (
                variant == "embedding" and set(counts) != {"int8_dense"}):
            fail(f"{variant} int8: launches {counts}")
        check_int8_served(f"{variant} int8", vids, vmasks, got, want,
                          int8_tolerance(f"{variant} int8", oracle, vids,
                                         vmasks, want))

    # an HTTP round trip through ``cli serve --quantize int8``
    oracle = Inpainter.from_checkpoint(path, device=DEV, quantize="int8",
                                       plain=True)
    want = oracle.inpaint(vids, vmasks)
    got = serve_over_cli(["--checkpoint", path, "--quantize", "int8",
                          "--device", DEV], vids, vmasks)
    check_int8_served("cli serve --quantize int8 over HTTP", vids, vmasks,
                      got, want, int8_tolerance("cli serve", oracle, vids,
                                                vmasks, want))
    # each int8 kernel's launches on its route: the merged route's encoder
    # layers and FF sublayers, the per-op route's projections
    merged = route_counts["int8 merged"]
    return {"enc_layer_int8": merged["enc_layer_int8"],
            "ffn_int8": merged["ffn_int8"],
            "int8_dense": launches["int8_dense"], **mode_launches}


def train_setup(torch):
    """Three flagship models from one seed, their train states, the step
    functions of the kernel path, the plain path and the per-op attention
    route (sublayer fusion off), and a batch."""
    from keypoints_interpolation_transformer_torch.train import state, steps
    from keypoints_interpolation_transformer_torch.utils.config import Config
    cfg = Config(model=model_config())
    runs = {}
    for name, plain, fusion in (("kernel", False, "auto"),
                                ("plain", True, "auto"),
                                ("per-op", False, "off")):
        cfg.model.attn_sublayer_fusion = fusion
        model = steps.build_model(cfg.model, for_training=True, device=DEV,
                                  generator=torch.Generator().manual_seed(0))
        runs[name] = (model, state.TrainState.create(model, cfg.train.lr),
                      steps.make_train_step(model, cfg, None, plain=plain))
    rng = np.random.default_rng(11)
    clean = torch.from_numpy(rng.uniform(0.2, 0.8, (B_TRAIN, T_MAIN, 54, 2))
                             .astype(np.float32)).to(DEV)
    length = torch.full((B_TRAIN,), T_MAIN, device=DEV)  # the JAX bench's
    weight = torch.ones(B_TRAIN, device=DEV)
    return runs, clean, length, weight, cfg.train.lr


def phase_train(torch, kmod, gpu):
    print(f"phase 7: flagship A1 train step, B={B_TRAIN} T={T_MAIN}, kernel "
          "path vs plain path", flush=True)
    runs, clean, length, weight, lr = train_setup(torch)
    losses = {}
    totals = {n: 0 for n in TRAIN_COUNTS}
    # the per-op route's launches a step (no fused loss here)
    per_op = {**PER_OP_TRAIN_COUNTS, "masked_loss": 0}
    for i in range(3):
        for name in ("plain", "kernel", "per-op"):
            model, st, step = runs[name]
            gen = torch.Generator(device=DEV).manual_seed(100 + i)
            kmod.reset_launches()
            _, m = step(st, clean, length, weight, gen, lr)
            torch.cuda.synchronize()
            counts = kmod.launch_counts()
            loss = float(m["loss"])
            if not np.isfinite(loss):
                fail(f"{name} path step {i}: loss {loss}")
            losses[name, i] = (loss, float(m["grad_norm"]))
            want = {"plain": NO_LAUNCHES, "kernel": TRAIN_COUNTS,
                    "per-op": per_op}[name]
            if counts != want:
                fail(f"{name} step {i} launch counts {counts} != {want}")
            if name == "kernel":
                for n, c in counts.items():
                    totals[n] += c
        if i == 0:
            # one scale for all parameters: the moment-normalized Adam step
            # moves a parameter whose gradient is float noise (the k-bias)
            # by up to lr either way on either path
            with torch.no_grad():
                pp = [p for p in runs["plain"][0].parameters()]
                scale = max(float(p.abs().max()) for p in pp)
                for name in ("kernel", "per-op"):
                    pk = [p for p in runs[name][0].parameters()]
                    worst = max(float((a - b).abs().max())
                                for a, b in zip(pk, pp)) / scale
                    print(f"  parameters after step 1: max |{name} - plain|"
                          f" / max |plain| {worst:.3e} (tol {REL_TOL:.0e})",
                          flush=True)
                    if worst > REL_TOL:
                        fail(f"{name} parameters after step 1 differ by "
                             f"{worst:.3e}")
        lp, gp = losses["plain", i]
        for name in ("kernel", "per-op"):
            lk, gk = losses[name, i]
            rel = abs(lk - lp) / abs(lp)
            print(f"  step {i}: loss {name} {lk:.7f} plain {lp:.7f} rel "
                  f"{rel:.3e}; grad norm {name} {gk:.6e} plain {gp:.6e} rel "
                  f"{abs(gk - gp) / gp:.3e} (tol {LOSS_RTOL:.0e})",
                  flush=True)
            if rel > LOSS_RTOL or abs(gk - gp) > LOSS_RTOL * gp:
                fail(f"step {i}: {name} loss or gradient norm differ beyond "
                     f"{LOSS_RTOL:.0e} relative")

    step_ms = {}
    for name in ("plain", "kernel", "per-op", "per-op", "kernel", "plain"):
        model, st, step = runs[name]
        gen = torch.Generator(device=DEV).manual_seed(7)
        kmod.reset_launches()
        step(st, clean, length, weight, gen, lr)  # warm
        torch.cuda.synchronize()
        counts = kmod.launch_counts()
        want = {"plain": NO_LAUNCHES, "kernel": TRAIN_COUNTS,
                "per-op": per_op}[name]
        if counts != want:
            fail(f"{name} step launch counts {counts} != {want}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        reps = 5
        for _ in range(reps):
            step(st, clean, length, weight, gen, lr)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        step_ms[name] = min(step_ms.get(name, ms), ms)
    flop = sum(work(n, B_TRAIN, T_MAIN)[0] * c
               for n, c in TRAIN_COUNTS.items() if c)
    for name in ("kernel", "per-op", "plain"):
        print(f"  train step {name} path: {step_ms[name]:.3f} ms, "
              f"{B_TRAIN * T_MAIN / step_ms[name] * 1e3:.1f} frames/s "
              f"(mean of 5 warm steps, best of 2 turns) on {gpu}",
              flush=True)
    print(f"  sublayer FLOP per step {flop / 1e12:.4f} TFLOP: bound "
          f"{flop / PEAK_FLOPS * 1e3:.3f} ms at the float32 FFMA peak",
          flush=True)
    return totals, step_ms


# the loop phase: 400 synthetic videos of 97-128 frames, one bucket of 128:
# 320 for training (5 batches of 64), 80 for validation (2 batches)
LOOP_VIDEOS, LOOP_LR = 400, 1e-4
# epoch losses of the kernel and the plain route from one seed: the train
# step's tolerance, over the steps of one or two epochs
LOOP_RTOL = 1e-4
# a resumed run against the uninterrupted one: the same kernels on the same
# state (no atomics), float32 noise only
RESUME_RTOL = 1e-5


def nonzero(counts):
    return {k: c for k, c in counts.items() if c}


def loop_config(tmp, name, regime="a1", epochs=1, fusion="auto", **train):
    """The loop phase's configuration: the flagship model, batch 64, lr
    1e-4, checkpoints and metrics under ``tmp``."""
    from keypoints_interpolation_transformer_torch.utils.config import (
        Config, DataConfig, TrainConfig)
    mc = model_config()
    mc.attn_sublayer_fusion = fusion
    return Config(
        model=mc,
        data=DataConfig(batch_size=B_TRAIN, max_seq_len=T_MAIN,
                        bucket_multiple=32, synthetic_num_videos=LOOP_VIDEOS,
                        synthetic_min_len=T_MAIN - 31,
                        synthetic_max_len=T_MAIN,
                        seed=0),
        train=TrainConfig(regime=regime, lr=LOOP_LR, epochs=epochs,
                          experiment_name=name, log_every=0,
                          checkpoint_dir=os.path.join(tmp, "ckpt"),
                          results_dir=os.path.join(tmp, "results"), **train))


def epoch_records(cfg):
    """The per-epoch lines of a run's metrics JSONL."""
    path = os.path.join(cfg.train.results_dir,
                        f"{cfg.train.experiment_name}.metrics.jsonl")
    with open(path) as f:
        return [r for r in map(json.loads, f) if "epoch" in r]


def phase_loop(torch, kmod, gpu, tmp):
    from keypoints_interpolation_transformer_torch.models.convert import (
        load_reference_pth)
    from keypoints_interpolation_transformer_torch.train.checkpoint import (
        FULL_STATE)
    from keypoints_interpolation_transformer_torch.train.loop import (
        build_datasets, train)
    print(f"phase 8: the training loop, {LOOP_VIDEOS} synthetic videos of "
          f"{T_MAIN - 31}-{T_MAIN} frames, batch {B_TRAIN}, flagship width",
          flush=True)
    train_ds, val_ds = build_datasets(loop_config(tmp, "data"))
    n_train, n_val = (ds.num_batches(B_TRAIN) for ds in (train_ds, val_ds))
    print(f"  {len(train_ds)} training videos ({n_train} batches), "
          f"{len(val_ds)} validation videos ({n_val} batches)", flush=True)

    def run(cfg, plain=False):
        kmod.reset_launches()
        res = train(cfg, train_ds, val_ds, device=DEV, plain=plain)
        torch.cuda.synchronize()
        counts = kmod.launch_counts()
        if not all(np.isfinite(res.train_losses + res.val_losses)):
            fail(f"{cfg.train.experiment_name}: non-finite losses {res}")
        print(f"  {cfg.train.experiment_name}: train {res.train_losses} val "
              f"{res.val_losses}", flush=True)
        return res, counts

    def expect(tag, counts, epochs, per_step, per_eval):
        want = dict(NO_LAUNCHES)
        for table, n in ((per_step, n_train), (per_eval, n_val)):
            for k, c in table.items():
                want[k] += c * n * epochs
        print(f"  {tag}: launches {counts} (per step {per_step}, per eval "
              f"batch {per_eval})", flush=True)
        if counts != want:
            fail(f"{tag}: launches {counts} != {want}")

    def agree(tag, got, want, rtol, skip=0):
        """Epoch losses of ``got`` against those of ``want`` from its epoch
        ``skip`` on."""
        for what, a, b in (("train", got.train_losses,
                            want.train_losses[skip:]),
                           ("val", got.val_losses, want.val_losses[skip:])):
            rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
            print(f"  {tag}: {what} losses rel {rel:.3e} (tol {rtol:.0e})",
                  flush=True)
            if len(a) != len(b) or rel > rtol:
                fail(f"{tag}: {what} losses {a} vs {b}")

    # the loop's eval forwards take the per-sublayer serving route (or the
    # per-op one with sublayer fusion off)
    step, evals = nonzero(TRAIN_COUNTS), nonzero(SUBLAYER_COUNTS)
    a1, counts = run(loop_config(tmp, "a1", epochs=2))
    expect("a1 kernel route", counts, 2, step, evals)
    a1_plain, counts = run(loop_config(tmp, "a1-plain", epochs=2,
                                       save_checkpoints=False), plain=True)
    if any(counts.values()):
        fail(f"the plain route launched kernels: {counts}")
    agree("a1 kernel vs plain route", a1, a1_plain, LOOP_RTOL)

    off_cfg = loop_config(tmp, "a1-per-op", fusion="off", fused_loss=True,
                          save_checkpoints=False)
    off, per_op_counts = run(off_cfg)
    expect("a1 per-op route + fused loss", per_op_counts, 1,
           nonzero(PER_OP_TRAIN_COUNTS), nonzero(PER_OP_COUNTS))
    off_plain, _ = run(loop_config(tmp, "a1-per-op-plain", fusion="off",
                                   fused_loss=True, save_checkpoints=False),
                       plain=True)
    agree("a1 per-op kernel vs plain route", off, off_plain, LOOP_RTOL)

    a3, _ = run(loop_config(tmp, "a3", "a3"))
    a4, counts = run(loop_config(tmp, "a4", "a4",
                                 upload_general_model=a1.checkpoint_path,
                                 upload_embedding_model=a3.checkpoint_path))
    expect("a4", counts, 1, step, evals)
    emb, _ = load_reference_pth(a3.checkpoint_path)
    got, _ = load_reference_pth(a4.checkpoint_path)
    for dst, src in (("input_embedding", "input_embedding"),
                     ("filled_embedding", "input_embedding"),
                     ("fc_final", "output_embedding")):
        for p in ("weight", "bias"):
            if not torch.equal(got[f"{dst}.{p}"], emb[f"{src}.{p}"]):
                fail(f"a4 moved the grafted {dst}.{p}")
    print("  a4: the grafted embeddings and head are bit for bit a3's",
          flush=True)
    a2, counts = run(loop_config(tmp, "a2", "a2",
                                 upload_model=a1.checkpoint_path,
                                 save_checkpoints=False))
    print(f"  a2 over a1's .pth: launches {counts}", flush=True)
    if counts["attn_sublayer_train"] != 3 * LAYERS * n_train:
        fail(f"a2 launches {counts}")

    cut, _ = run(loop_config(tmp, "a1-cut", epochs=2, max_epochs_this_run=1))
    state = os.path.join(os.path.dirname(cut.checkpoint_path), FULL_STATE)
    rest, _ = run(loop_config(tmp, "a1-resumed", epochs=2,
                              resume_from=state, save_checkpoints=False))
    agree("resumed epoch 2 vs the uninterrupted run", rest, a1, RESUME_RTOL,
          skip=1)

    for name, cfg in (("kernel", loop_config(tmp, "a1")),
                      ("plain", loop_config(tmp, "a1-plain")),
                      ("per-op", off_cfg)):
        rec = epoch_records(cfg)[-1]
        print(f"  one a1 epoch ({name} route, epoch {rec['epoch']}): "
              f"{rec['train_frames'] / rec['train_seconds']:.1f} frames/s "
              f"({rec['train_frames']} frames, padding included, in "
              f"{rec['train_seconds']:.3f} s) on {gpu}", flush=True)
    return per_op_counts


def kernel_name(ptxas_line):
    """``name<N>`` of the function a ptxas "Compiling entry function" or
    "Function properties for" line names (a kernel, or a device function
    that is not inlined), read from its mangled name's length-prefixed
    identifiers: the first one that ends in ``_kernel`` or is followed by
    template arguments."""
    if "'" in ptxas_line:
        mangled = ptxas_line.split("'")[1]
    else:
        mangled = ptxas_line.split("Function properties for", 1)[1].strip()
    digits = re.compile(r"\d+")
    pos = 0
    while (m := digits.search(mangled, pos)) is not None:
        ident = mangled[m.end():m.end() + int(m.group())]
        pos = m.end() + len(ident)
        t = re.match(r"I((?:L[a-z]+-?\d+E)+)E", mangled[pos:])
        if ident.endswith("_kernel") or t:
            args = re.findall(r"L[a-z]+(-?\d+)E", t.group(1)) if t else []
            return ident + (f"<{', '.join(args)}>" if args else "")
    return mangled


def profiled(torch, fn):
    """(rows, wall ms) of one call of ``fn`` (warmed twice before) under
    torch.profiler (CUPTI): rows (name, self device ms, count) of the
    kernels and copies only (an autograd node also reports the device time
    of the kernels it launched, and a span, record_function or the
    optimizer's step, the device time between its first and last kernel);
    the wall time with the profiler on."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def self_device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    rows = [(e.key, self_device_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)
            and self_device_us(e) > 0]
    return rows, wall


def device_profile(torch, label, fn, gpu):
    """Device time by kernel of one call of ``fn`` (``profiled``), and the
    device's busy share of its wall time."""
    rows, wall = profiled(torch, fn)
    busy = sum(r[1] for r in rows)
    print(f"profile: {label}, {gpu}: wall {wall:.3f} ms (profiler on), "
          f"device busy {busy:.3f} ms ({100 * busy / wall:.1f} %)",
          flush=True)
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:25]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {key[:100]}", flush=True)


def profile_paths(torch, gpu):
    """One warm train step on the kernel path, on the per-op attention
    route, at "high" and at "high" per op (sublayer fusion off), then one
    merged-route Inpainter call at "highest",
    "high" and "default" and one per-sublayer call at "highest" and "high"
    at B=256, T=128 (host arrays in and out, as phase 6 times it)."""
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    from keypoints_interpolation_transformer_torch.models.completer import (
        KeypointCompleter)
    runs, clean, length, weight, lr = train_setup(torch)
    for name in ("kernel", "per-op"):
        _, st, step = runs[name]
        gen = torch.Generator(device=DEV).manual_seed(7)
        device_profile(torch, f"one {name}-path train step, B={B_TRAIN} "
                       f"T={T_MAIN}", lambda: step(st, clean, length,
                                                   weight, gen, lr), gpu)
    del runs, st, step
    import dataclasses
    from keypoints_interpolation_transformer_torch.train import state, steps
    from keypoints_interpolation_transformer_torch.utils.config import Config
    cfg = Config(model=dataclasses.replace(model_config(),
                                           matmul_precision="high"))
    for label, mc in (
            (" \"high\"", cfg.model),
            (" per-op \"high\"", dataclasses.replace(
                cfg.model, attn_sublayer_fusion="off")),
            (" \"default\"", dataclasses.replace(
                cfg.model, matmul_precision="default")),
            (" per-op \"default\"", dataclasses.replace(
                cfg.model, matmul_precision="default",
                attn_sublayer_fusion="off"))):
        model = steps.build_model(mc, for_training=True, device=DEV,
                                  generator=torch.Generator().manual_seed(0))
        st = state.TrainState.create(model, lr)
        step = steps.make_train_step(model, Config(model=mc), None)
        gen = torch.Generator(device=DEV).manual_seed(7)
        device_profile(torch, f"one{label} train step, "
                       f"B={B_TRAIN} T={T_MAIN}", lambda: step(
                           st, clean, length, weight, gen, lr), gpu)
        del model, st, step
    model = KeypointCompleter(D, LAYERS, HEADS, ff_dim=FF,
                              generator=torch.Generator().manual_seed(0))
    videos, masks = model_inputs(B_MAIN, T_MAIN, 3)
    for label, mc, merge in (
            ("merged-route", model_config(), True),
            ("merged-route \"high\"", cfg.model, True),
            ("merged-route \"default\"", dataclasses.replace(
                model_config(), matmul_precision="default"), True),
            ("per-sublayer", model_config(), False),
            ("per-sublayer \"high\"", cfg.model, False)):
        inp = Inpainter(model.state_dict(), mc, device=DEV,
                        merge_layers=merge)
        device_profile(torch, f"one {label} Inpainter call, B={B_MAIN} "
                       f"T={T_MAIN}", lambda: inp.inpaint(list(videos),
                                                          list(masks)), gpu)


# the spans train/loop.py marks for the profiler
LOOP_SPANS = ("train_step", "eval_step", "cubic_baseline", "checkpoint")


def profile_loop_epoch(torch, gpu):
    """One a1 epoch of the loop at the loop phase's shapes (after a warm
    run), without the cubic baseline and checkpoints: the device's busy
    share from the first train step to the last device work of the eval,
    and the host work inside that window by name (the spans the loop
    marks: train_step, eval_step)."""
    from torch.profiler import ProfilerActivity, profile
    from keypoints_interpolation_transformer_torch.train.loop import (
        build_datasets, train)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = loop_config(tmp, "profile", save_checkpoints=False,
                          epoch0_cubic_baseline=False)
        data = build_datasets(cfg)
        train(cfg, *data, device=DEV)  # warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train(cfg, *data, device=DEV)
            torch.cuda.synchronize()
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    spans = [e for e in events if e.device_type == cpu
             and e.name in LOOP_SPANS[:2]]
    # kernels and copies; the spans also appear on the device's timeline
    # (as annotations covering their kernels), which are not device work
    device = [e for e in events if e.device_type != cpu
              and not getattr(e, "is_user_annotation", False)
              and e.name not in LOOP_SPANS
              and not e.name.startswith("Optimizer.")]
    if not spans or not device:
        fail(f"profile: {len(spans)} loop spans, {len(device)} device "
             "events; the trace shows no device work")
    lo = min(e.time_range.start for e in spans)
    hi = max(max(e.time_range.end for e in spans),
             max(e.time_range.end for e in device))
    busy, end = 0.0, lo
    for a, b in sorted((max(e.time_range.start, lo), e.time_range.end)
                       for e in device if e.time_range.end > lo):
        if b > end:
            busy += b - max(a, end)
            end = b
    window = hi - lo
    print(f"profile: one a1 epoch of the loop (B={B_TRAIN}, T={T_MAIN}, "
          f"{sum(e.name == 'train_step' for e in spans)} train steps, "
          f"{sum(e.name == 'eval_step' for e in spans)} eval batches), "
          f"{gpu}: window {window / 1e3:.3f} ms (profiler on), device busy "
          f"{busy / 1e3:.3f} ms, idle {100 * (1 - busy / window):.1f} %",
          flush=True)
    host = {}
    for e in events:
        if e.device_type == cpu and lo <= e.time_range.start <= hi:
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
    print("  host self time in the window by name:", flush=True)
    for name, us in sorted(host.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3:9.3f} ms  {name[:90]}", flush=True)


def sweep(torch, kmod, gpu):
    """Cluster sizes of the whole-layer kernels, then small-batch latency
    of the three routes."""
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    from keypoints_interpolation_transformer_torch.models.completer import (
        KeypointCompleter)
    from keypoints_interpolation_transformer_torch.ops.kernels.layer_fused \
        import cluster_size
    chk = KernelCheck(torch, kmod)
    o = chk.operands(B_MAIN, T_MAIN)
    mask, valid = chk.masks(B_MAIN, T_MAIN)
    attn = (o["wqkv"], o["bqkv"], o["wo"], o["bo"])
    cattn = (o["cwqkv"], o["cbqkv"], o["cwo"], o["cbo"])
    ff = (o["w1"], o["b1"], o["w2"], o["b2"], o["g"], o["be"], o["g2"],
          o["be2"])
    print(f"sweep: blocks per video of the whole-layer kernels, T={T_MAIN}, "
          f"{gpu}", flush=True)
    for B in (256, 64, 8, 1):
        x, mem = o["x"][:B].contiguous(), o["mem"][:B].contiguous()
        m, v = mask[:B].contiguous(), valid[:B].contiguous()
        for cl in (1, 2, 4, 8):
            enc = timed_ms(lambda: kmod.fused_encoder_layer(
                x, *attn, *ff, m, v, "repeat-inc", True, HEADS, cluster=cl))
            dec = timed_ms(lambda: kmod.fused_decoder_layer(
                x, mem, *attn, *cattn, o["g"], o["be"], ff, m, v, None, v,
                "repeat-inc", False, "all", False, HEADS, cluster=cl))
            print(f"  B={B} cluster {cl} (the wrapper picks "
                  f"{cluster_size(B, x.device)}): enc_layer {enc:.4f} ms "
                  f"dec_layer {dec:.4f} ms", flush=True)
    model = KeypointCompleter(D, LAYERS, HEADS, ff_dim=FF,
                              generator=torch.Generator().manual_seed(0))
    engines = {name: Inpainter(model.state_dict(), model_config(),
                               device=DEV, merge_layers=merge, plain=plain,
                               quantize=q)
               for name, merge, plain, q in (
                   ("merged", True, False, None),
                   ("sublayer", False, False, None),
                   ("plain", True, True, None),
                   ("int8 merged", True, False, "int8"))}
    print(f"sweep: latency of one Inpainter call (median of 7, best of 2 "
          f"turns), {gpu}", flush=True)
    for B, T in ((1, 128), (1, 256), (4, 128), (16, 128), (64, 128)):
        clean, miss = model_inputs(B, T, 5)
        videos, masks = list(clean), list(miss)
        lat = {}
        for name in ("plain", "merged", "sublayer", "int8 merged",
                     "int8 merged", "sublayer", "merged", "plain"):
            engines[name].inpaint(videos, masks)  # warm
            ms = []
            for _ in range(7):
                t0 = time.perf_counter()
                engines[name].inpaint(videos, masks)
                ms.append((time.perf_counter() - t0) * 1e3)
            lat[name] = min(lat.get(name, float("inf")),
                            float(np.median(ms)))
        print(f"  B={B} T={T}: " + ", ".join(
            f"{n} {lat[n]:.3f} ms" for n in ("merged", "sublayer", "plain",
                                             "int8 merged")), flush=True)
    clean, miss = model_inputs(B_MAIN, T_MAIN, 3)
    fps = {}
    for name in ("merged", "sublayer", "sublayer", "merged"):
        fps[name] = max(fps.get(name, 0.0), frames_per_s(
            engines[name], list(clean), list(miss)))
    print(f"sweep: Inpainter B={B_MAIN} T={T_MAIN}: merged "
          f"{fps['merged']:.1f} frames/s, per-sublayer {fps['sublayer']:.1f} "
          f"frames/s (best of 2 turns), {gpu}", flush=True)


def frames_per_s(engine, videos, masks, reps=3):
    """Inpainter frames/s on ``videos``: the mean of ``reps`` calls after a
    warm one (phase 6's method)."""
    engine.inpaint(videos, masks)  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.inpaint(videos, masks)
    dt = (time.perf_counter() - t0) / reps
    return sum(len(v) for v in videos) / dt


# the precision phase: per-sublayer serving and the A1 step at "high" and
# "default" (their FF sublayers on the bf16 tensor cores, the rest float32)
PRECISIONS = ("highest", "high", "default")
MODE_TAG = {"high": "_high", "default": "_default"}
# one mode down, by the precision's name
WRONG_PREC = {"high": "default", "default": "highest"}


def mode_counts(counts, prec):
    """``counts`` with each FF, attention-sublayer, per-op attention and
    pointwise-chain kernel's launches moved to the precision's own kernel
    (the float32 FF forward and backward of "highest" become the mode's
    forward and split backward)."""
    if prec == "highest":
        return dict(counts)
    tag, out = MODE_TAG[prec], dict(counts)
    for name, mode_name in (("ffn", f"ffn{tag}"),
                            ("ffn_train", f"ffn_train{tag}"),
                            ("ffn_bwd", f"ffn_bwd_split{tag}"),
                            ("attn_sublayer", f"attn_sublayer{tag}"),
                            ("attn_sublayer_train",
                             f"attn_sublayer_train{tag}"),
                            ("attn_sublayer_bwd", f"attn_sublayer_bwd{tag}"),
                            ("attention", f"attention{tag}"),
                            ("attention_bwd", f"attention_bwd{tag}"),
                            ("pre_stream_embed", f"pre_stream_embed{tag}"),
                            ("post_head", f"post_head{tag}")):
        out[mode_name], out[name] = out[name], 0
    return out


def order_drift(plain, sd, cfg, videos, masks, miss):
    """The masked MPJPE between ``plain`` (the plain route's predictions on
    the card) and the same plain route on the CPU: one arithmetic in two
    float32 summation orders, the spread a kernel route's own order is
    held to."""
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    t0 = time.perf_counter()
    cpu = np.stack(Inpainter(sd, cfg, device="cpu", plain=True).inpaint(
        videos, masks))
    drift = masked_mpjpe_delta(cpu, plain, miss)
    print(f"  the plain route on the CPU (another float32 summation order) "
          f"lies {drift:.3e} masked MPJPE from it on the card "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return drift


def steps_ms(torch, runs, names, x, length, weight, lr):
    """Each of ``runs`` (name -> (train state, step)) timed by CUDA events
    over 5 steps after a warm one, in turns (``names``, then reversed):
    name -> the best of the two means, ms."""
    out = {}
    for name in names + names[::-1]:
        st, step = runs[name]
        gen = torch.Generator(device=DEV).manual_seed(7)
        step(st, x, length, weight, gen, lr)  # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            step(st, x, length, weight, gen, lr)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5
        out[name] = min(out.get(name, ms), ms)
    return out


PREC_MODE = {"high": "bf16x3", "default": "bf16"}


def check_splits(kmod, what, prec, counts, kernel):
    """A training step splits each weight its ``mode_linear`` calls read
    once (a new weight version every step): as many splits as forward
    launches on the kernel route, none on the plain one."""
    got = kmod.weight_planes.splits[PREC_MODE[prec]]
    want = counts[f"mode_linear{MODE_TAG[prec]}"] if kernel else 0
    print(f"  {what}: {got} weight splits (mode_linear's W planes; "
          f"{want} expected)", flush=True)
    if got != want:
        fail(f"{what}: {got} weight splits, not {want}")


def train_mode_counts(counts, prec, per_op=False):
    """``mode_counts`` of a training step's launches, with the Dense
    products of its chains (and, per op, its projections) through
    ``mode_linear`` and its backward in the mode."""
    out = mode_counts(counts, prec)
    if prec != "highest":
        dense = CHAIN_DENSE + (PER_OP_DENSE * LAYERS if per_op else 0)
        for name in ("mode_linear", "mode_linear_bwd"):
            out[f"{name}{MODE_TAG[prec]}"] = dense
    return out


def merged_mode_counts(prec):
    """MERGED_COUNTS with the whole layers and the pointwise chains moved
    to the precision's own kernels."""
    if prec == "highest":
        return dict(MERGED_COUNTS)
    tag, out = MODE_TAG[prec], dict(MERGED_COUNTS)
    for name in ("enc_layer", "dec_layer", "pre_stream_embed", "post_head"):
        out[f"{name}{tag}"], out[name] = out[name], 0
    return out


def merged_precision(torch, kmod, gpu, sd, videos, masks, miss):
    """The merged route (the JAX package's serving default) at B=256 in
    the three precisions: the launches of one call (the mode's whole-layer
    kernels at "high" and "default"), the kernel route against the plain
    route in the same precision (the largest coordinate difference within
    SERVE_TOL; at "default" the masked MPJPE within MODE_DRIFT times the
    plain route's spread over summation orders, and its distance from
    "highest" within MODE_SEPARATION of the plain route's), the masked
    MPJPE against "highest"
    beside bench.py's 1e-4 gate (the plain route's figure beside it: the
    gate judges the mode's own arithmetic, which the JAX package shares;
    the run fails where the kernels miss the gate and their plain version
    does not), and frames/s in turns.  Returns the mode layers' launches."""
    import dataclasses
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    launches, outs, engines, engines_plain = {}, {}, {}, {}
    for prec in PRECISIONS:
        cfg = dataclasses.replace(model_config(), matmul_precision=prec)
        engines[prec] = Inpainter(sd, cfg, device=DEV)
        kmod.reset_launches()
        got = np.stack(engines[prec].inpaint(videos, masks))
        torch.cuda.synchronize()
        counts, want = kmod.launch_counts(), merged_mode_counts(prec)
        if counts != want:
            fail(f"{prec} merged serving launches {counts} != {want}")
        for name in LAYER_MODE_KERNELS + CHAIN_MODE_KERNELS:
            launches[name] = launches.get(name, 0) + counts[name]
        engines_plain[prec] = Inpainter(sd, cfg, device=DEV, plain=True)
        plain = np.stack(engines_plain[prec].inpaint(videos, masks))
        if got.shape != plain.shape or not np.isfinite(got).all():
            fail(f"{prec} merged serving: shape {got.shape} or non-finite")
        if not np.array_equal(got[miss == 0], plain[miss == 0]):
            fail(f"{prec} merged serving changed a non-missing frame")
        err = float(np.abs(got - plain).max())
        delta = masked_mpjpe_delta(got, plain, miss)
        print(f"  {prec}: merged serving B={B_MAIN} T={T_MAIN}, kernel "
              f"route against the plain route in the same precision: "
              f"largest coordinate difference {err:.3e}, masked MPJPE "
              f"{delta:.3e}; launches {nonzero(counts)}", flush=True)
        if prec == "default":
            tol = MODE_DRIFT * order_drift(plain, sd, cfg, videos, masks,
                                           miss)
            print(f"  default: held by masked MPJPE within {tol:.3e} "
                  f"({MODE_DRIFT:g} x the plain route's spread over "
                  "summation orders)", flush=True)
            own, pown = (masked_mpjpe_delta(o, outs["highest"][1], miss)
                         for o in (got, plain))
            print(f"  default: against the plain route at \"highest\" the "
                  f"kernel route {own:.3e}, the plain route {pown:.3e} (the "
                  f"mode's own error; within {MODE_SEPARATION:g} x of each "
                  "other)", flush=True)
            if not delta < tol:
                fail(f"default merged serving: kernel route {delta:.3e} "
                     f"masked MPJPE from the plain route >= {tol:.3e}")
            if not (pown < own * MODE_SEPARATION
                    and own < pown * MODE_SEPARATION):
                fail(f"default merged serving: the kernel route lies "
                     f"{own:.3e} from \"highest\", its plain route "
                     f"{pown:.3e}: not the mode's arithmetic")
        elif err > SERVE_TOL:
            fail(f"{prec} merged serving: kernel route {err:.3e} from the "
                 f"plain route > {SERVE_TOL:.0e}")
        outs[prec] = (got, plain)
    for prec in ("high", "default"):
        got, plain = outs[prec]
        delta = masked_mpjpe_delta(got, outs["highest"][0], miss)
        pdelta = masked_mpjpe_delta(plain, outs["highest"][1], miss)
        verdict = "within" if delta < MPJPE_TOL else "at or above"
        print(f"  {prec}: merged serving masked MPJPE against \"highest\" "
              f"{delta:.3e} ({verdict} bench.py's gate {MPJPE_TOL:.0e}); "
              f"the plain route in the mode {pdelta:.3e}", flush=True)
        if delta >= MPJPE_TOL > pdelta:
            fail(f"{prec}: the merged kernels miss the gate ({delta:.3e}) "
                 f"where their plain version meets it ({pdelta:.3e})")
    fps = {}
    for prec in PRECISIONS + PRECISIONS[::-1]:
        fps[prec] = max(fps.get(prec, 0.0),
                        frames_per_s(engines[prec], videos, masks))
    print(f"  Inpainter merged B={B_MAIN} T={T_MAIN}: " + ", ".join(
        f"{p} {fps[p]:.1f} frames/s" for p in PRECISIONS)
        + f" (best of 2 turns) on {gpu}", flush=True)
    return launches


# the parameters of the pointwise chains, whose products the training
# route takes through mode_linear (the JAX package's XLA chains)
CHAIN_PARAMS = ("input_embedding", "filled_embedding", "swiGlu_input_prev",
                "swiGlu_filled_prev", "swiGlu_decoded", "fc_final")


def chain_gaps(label, kernel, plain, wrong):
    """Print the chain parameters' worst gradient gap, the kernel route
    against the plain route in the mode and against one mode down (each
    against its own largest value), already held with every parameter's
    above."""
    gaps = [max(float((kernel[n] - w[n]).abs().max())
                / (float(w[n].abs().max()) or 1.0)
                for n in kernel if n.startswith(CHAIN_PARAMS))
            for w in (plain, wrong)]
    print(f"  {label}: the chain parameters' gradients (mode_linear's "
          f"backward) worst {gaps[0]:.3e} of their own max against the plain "
          f"route in the mode, {gaps[1]:.3e} one mode down", flush=True)


def phase_precision(torch, kmod, gpu, tmp):
    """Serving per sublayer at B=256 in the three precisions (launches,
    masked MPJPE against "highest": "high" gated at bench.py's 1e-4,
    "default" printed; frames/s in turns); the merged route in the three
    precisions (``merged_precision``); the flagship A1 step at
    "high" and "default", kernel route against the plain route in the same
    mode, its launches, step time and loss against the float32 step; the
    A1 step per op (fusion off) in both modes against its plain route, and
    its time beside the float32 per-op step's; one epoch of ``cli train
    --precision high``.  Returns the mode kernels' launches on these
    paths."""
    import contextlib
    import dataclasses
    import io
    from keypoints_interpolation_transformer_torch import cli
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    from keypoints_interpolation_transformer_torch.models.completer import (
        KeypointCompleter)
    from keypoints_interpolation_transformer_torch.train import state, steps
    from keypoints_interpolation_transformer_torch.utils.config import Config
    print("phase 11: precision modes: per-sublayer serving and the A1 step "
          "at \"high\" (bf16x3) and \"default\" (one bf16 pass)",
          flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the plain mode versions would round twice")
    launches = dict.fromkeys(MODE_SERVE_KERNELS + MODE_TRAIN_KERNELS
                             + LAYER_MODE_KERNELS + LINEAR_MODE_KERNELS, 0)
    net = KeypointCompleter(D, LAYERS, HEADS, ff_dim=FF,
                            generator=torch.Generator().manual_seed(0))
    sd = net.state_dict()
    engines = {prec: Inpainter(sd, dataclasses.replace(
        model_config(), matmul_precision=prec), device=DEV,
        merge_layers=False) for prec in PRECISIONS}
    clean, miss = model_inputs(B_MAIN, T_MAIN, 3)
    videos, masks = list(clean), list(miss)
    outs = {}
    for prec in PRECISIONS:
        kmod.reset_launches()
        outs[prec] = np.stack(engines[prec].inpaint(videos, masks))
        torch.cuda.synchronize()
        counts, want = kmod.launch_counts(), mode_counts(SUBLAYER_COUNTS,
                                                         prec)
        if counts != want:
            fail(f"{prec} per-sublayer serving launches {counts} != {want}")
        got = outs[prec]
        if got.shape != (B_MAIN, T_MAIN, 54, 2) or not np.isfinite(got).all():
            fail(f"{prec} serving: shape {got.shape} or non-finite values")
        if not np.array_equal(got[miss == 0], clean[miss == 0]):
            fail(f"{prec} serving changed a non-missing frame")
        if prec != "highest":
            for n in ("ffn", "attn_sublayer", "pre_stream_embed",
                      "post_head"):
                launches[f"{n}{MODE_TAG[prec]}"] = counts[
                    f"{n}{MODE_TAG[prec]}"]
            delta = masked_mpjpe_delta(got, outs["highest"], miss)
            gate = prec == "high"
            print(f"  {prec}: per-sublayer serving B={B_MAIN} T={T_MAIN}, "
                  f"masked MPJPE against \"highest\" {delta:.3e}"
                  + (f" (gate {MPJPE_TOL:.0e})" if gate else " (not gated)")
                  + f"; max abs {np.abs(got - outs['highest']).max():.3e}; "
                  f"launches {nonzero(counts)}", flush=True)
            if gate and not delta < MPJPE_TOL:
                fail(f"{prec}: masked MPJPE {delta:.3e} >= {MPJPE_TOL}")
    launches.update(merged_precision(torch, kmod, gpu, sd, videos, masks,
                                     miss))
    fps = {}
    for prec in PRECISIONS + PRECISIONS[::-1]:
        engines[prec].inpaint(videos, masks)  # warm
        t0 = time.perf_counter()
        for _ in range(3):
            engines[prec].inpaint(videos, masks)
        dt = (time.perf_counter() - t0) / 3
        fps[prec] = max(fps.get(prec, 0.0), B_MAIN * T_MAIN / dt)
    print(f"  Inpainter per sublayer B={B_MAIN} T={T_MAIN}: " + ", ".join(
        f"{p} {fps[p]:.1f} frames/s" for p in PRECISIONS)
        + f" (mean of 3, best of 2 turns) on {gpu}", flush=True)
    del engines

    rng = np.random.default_rng(11)  # phase 7's batch and seeds
    x = torch.from_numpy(rng.uniform(0.2, 0.8, (B_TRAIN, T_MAIN, 54, 2))
                         .astype(np.float32)).to(DEV)
    length = torch.full((B_TRAIN,), T_MAIN, device=DEV)
    weight = torch.ones(B_TRAIN, device=DEV)
    first_grads = {}  # (precision, route) -> the first step's gradients

    def keep_first_grads(st, key):
        adam = st.optimizer.step

        def step(*a, **k):
            first_grads.setdefault(key, {
                n: p.grad.clone() for n, p in st.model.named_parameters()})
            return adam(*a, **k)
        st.optimizer.step = step

    for prec in ("high", "default"):
        cfg = Config(model=dataclasses.replace(model_config(),
                                               matmul_precision=prec))
        runs = {}
        # "high" twice from the same seed: its steps' losses agree bit for
        # bit (every sum in a fixed order)
        again = (("again", cfg.model, False),) if prec == "high" else ()
        for name, mc, plain in (("kernel", cfg.model, False),
                                ("plain", cfg.model, True),
                                ("highest", model_config(), False), *again):
            c = Config(model=mc)
            model = steps.build_model(mc, for_training=True, device=DEV,
                                      generator=torch.Generator().manual_seed(
                                          0))
            st = state.TrainState.create(model, c.train.lr)
            keep_first_grads(st, (prec, name))
            runs[name] = (model, st,
                          steps.make_train_step(model, c, None, plain=plain))
        lr = cfg.train.lr
        want = train_mode_counts(TRAIN_COUNTS, prec)
        for i in range(2):
            res = {}
            for name in ("plain", "kernel", "highest", *(n for n, *_ in
                                                        again)):
                _, st, step = runs[name]
                gen = torch.Generator(device=DEV).manual_seed(100 + i)
                kmod.reset_launches()
                kmod.weight_planes.splits[PREC_MODE[prec]] = 0
                _, m = step(st, x, length, weight, gen, lr)
                torch.cuda.synchronize()
                counts = kmod.launch_counts()
                check_splits(kmod, f"{prec} {name} step {i}", prec, counts,
                             name != "plain")
                res[name] = (float(m["loss"]), float(m["grad_norm"]))
                if not np.isfinite(res[name][0]):
                    fail(f"{prec} {name} step {i}: loss {res[name][0]}")
                if name == "plain" and any(counts.values()):
                    fail(f"{prec} plain step launched kernels: {counts}")
                if name in ("kernel", "again"):
                    if counts != want:
                        fail(f"{prec} step {i} launches {counts} != {want}")
                    for n in MODE_TRAIN_KERNELS + LINEAR_MODE_KERNELS:
                        launches[n] = max(launches[n], counts[n])
                    kernel_counts = nonzero(counts)
            (lk, gk), (lp, gp), (lf, _) = (res[n] for n in
                                           ("kernel", "plain", "highest"))
            rel, grel = abs(lk - lp) / abs(lp), abs(gk - gp) / gp
            print(f"  {prec} A1 step {i}: loss kernel {lk:.7f} plain "
                  f"{lp:.7f} rel {rel:.3e}; grad norm rel {grel:.3e} (tol "
                  f"{LOSS_RTOL:.0e}); against the float32 step's loss "
                  f"{lf:.7f}: rel {abs(lk - lf) / abs(lf):.3e}; kernel route "
                  f"launches {kernel_counts}", flush=True)
            if rel > LOSS_RTOL or grel > LOSS_RTOL:
                fail(f"{prec} step {i}: kernel and plain route differ")
            if again:
                print(f"  {prec} A1 step {i} again from the same seed: loss "
                      f"{res['again'][0]!r}, grad norm {res['again'][1]!r} "
                      f"(first run {lk!r}, {gk!r})", flush=True)
                if res["again"] != res["kernel"]:
                    fail(f"{prec} step {i}: two runs from one seed differ")
        step_ms = steps_ms(torch, {n: r[1:] for n, r in runs.items()},
                           ("plain", "kernel", "highest"), x, length, weight,
                           lr)
        print(f"  {prec} A1 step B={B_TRAIN} T={T_MAIN}: kernel route "
              f"{step_ms['kernel']:.3f} ms, plain route "
              f"{step_ms['plain']:.3f} ms, \"highest\" kernel route "
              f"{step_ms['highest']:.3f} ms (mean of 5 warm steps, best of "
              f"2 turns) on {gpu}", flush=True)
        del runs
    # each parameter's gradient of the first step (the same parameters and
    # batch on every route), kernel route against the plain route in its
    # mode and against the route one mode down (float32 for "default"),
    # each against its own largest value, at the mode's limit and
    # MODE_SEPARATION
    wrong = {"high": ("default", "plain"), "default": ("default", "highest")}
    tols = {"high": HIGH_MODE_TOL, "default": DEFAULT_MODE_TOL}
    for prec in ("high", "default"):
        k = first_grads[(prec, "kernel")]
        gap = [max(float((k[n] - w[n]).abs().max())
                   / (float(w[n].abs().max()) or 1.0) for n in k)
               for w in (first_grads[(prec, "plain")],
                         first_grads[wrong[prec]])]
        print(f"  {prec} A1 step 0: each parameter's gradient, kernel route "
              f"against the plain route in its mode, worst {gap[0]:.3e} of "
              f"its own max; against the route one mode down "
              f"{gap[1]:.3e} (tol {tols[prec]:.0e}, at least "
              f"{MODE_SEPARATION:g} x further)", flush=True)
        if not (gap[0] <= tols[prec] and gap[0] * MODE_SEPARATION < gap[1]):
            fail(f"{prec} step gradients: {gap[0]:.3e} from the plain route "
                 f"in the mode, {gap[1]:.3e} from one mode down")
        chain_gaps(f"{prec} A1 step", k, first_grads[(prec, "plain")],
                   first_grads[wrong[prec]])

    # the per-op route (sublayer fusion off, the JAX package's training
    # route where its sublayer kernel is off) at "high" and "default": one
    # A1 step, kernel route against the plain route in the mode (loss and
    # grad norm within LOSS_RTOL, each parameter's gradient within the
    # mode's limit of its own max and MODE_SEPARATION times nearer than one
    # mode down), launches attention_<mode> 18, attention_bwd_<mode> 18
    # and the FF modes' 12 each, the float32 rows 0
    per_op = {**PER_OP_TRAIN_COUNTS, "masked_loss": 0}
    per_op_runs = {}  # the kernel routes, timed after the checks
    for prec in ("high", "default"):
        res, grads = {}, {}
        for name, p_, plain in (("kernel", prec, False), ("plain", prec,
                                                          True),
                                ("wrong", WRONG_PREC[prec], True)):
            mc = dataclasses.replace(model_config(), matmul_precision=p_,
                                     attn_sublayer_fusion="off")
            c = Config(model=mc)
            model = steps.build_model(mc, for_training=True, device=DEV,
                                      generator=torch.Generator().manual_seed(
                                          0))
            st = state.TrainState.create(model, c.train.lr)
            keep_first_grads(st, (prec, f"per-op {name}"))
            step = steps.make_train_step(model, c, None, plain=plain)
            kmod.reset_launches()
            kmod.weight_planes.splits[PREC_MODE[prec]] = 0
            _, m = step(st, x, length, weight, torch.Generator(
                device=DEV).manual_seed(100), c.train.lr)
            torch.cuda.synchronize()
            counts = kmod.launch_counts()
            check_splits(kmod, f"{prec} per-op {name} step", prec, counts,
                         name == "kernel")
            res[name] = (float(m["loss"]), float(m["grad_norm"]))
            if not np.isfinite(res[name][0]):
                fail(f"{prec} per-op {name} step: loss {res[name][0]}")
            if name == "kernel":
                want = train_mode_counts(per_op, prec, per_op=True)
                if counts != want:
                    fail(f"{prec} per-op step launches {counts} != {want}")
                for n in ATTN_MODE_KERNELS + LINEAR_MODE_KERNELS:
                    launches[n] = max(launches[n], counts[n])
                per_op_runs[prec] = (st, step)
            elif any(counts.values()):
                fail(f"{prec} per-op plain step launched {counts}")
            del model, st, step
        (lk, gk), (lp, gp) = res["kernel"], res["plain"]
        rel, grel = abs(lk - lp) / abs(lp), abs(gk - gp) / gp
        k_ = first_grads[(prec, "per-op kernel")]
        gap = [max(float((k_[n] - w[n]).abs().max())
                   / (float(w[n].abs().max()) or 1.0) for n in k_)
               for w in (first_grads[(prec, "per-op plain")],
                         first_grads[(prec, "per-op wrong")])]
        print(f"  {prec} A1 step per op (fusion off): loss kernel {lk:.7f} "
              f"plain {lp:.7f} rel {rel:.3e}; grad norm rel {grel:.3e} (tol "
              f"{LOSS_RTOL:.0e}); each parameter's gradient against the "
              f"plain route in the mode, worst {gap[0]:.3e} of its own max, "
              f"one mode down {gap[1]:.3e} (tol {tols[prec]:.0e}, at least "
              f"{MODE_SEPARATION:g} x further); launches "
              f"{nonzero(train_mode_counts(per_op, prec, True))}",
              flush=True)
        chain_gaps(f"{prec} A1 step per op", k_,
                   first_grads[(prec, "per-op plain")],
                   first_grads[(prec, "per-op wrong")])
        if rel > LOSS_RTOL or grel > LOSS_RTOL:
            fail(f"{prec} per-op step: kernel and plain route differ")
        if not (gap[0] <= tols[prec] and gap[0] * MODE_SEPARATION < gap[1]):
            fail(f"{prec} per-op step gradients: {gap[0]:.3e} from the plain "
                 f"route in the mode, {gap[1]:.3e} from one mode down")
    mc = dataclasses.replace(model_config(), attn_sublayer_fusion="off")
    c = Config(model=mc)
    model = steps.build_model(mc, for_training=True, device=DEV,
                              generator=torch.Generator().manual_seed(0))
    st = state.TrainState.create(model, c.train.lr)
    per_op_runs["highest"] = (st, steps.make_train_step(model, c, None))
    step_ms = steps_ms(torch, per_op_runs, ("highest", "high", "default"), x,
                       length, weight, c.train.lr)
    print(f"  A1 step per op (fusion off) B={B_TRAIN} T={T_MAIN}: kernel "
          "route " + ", ".join(f"\"{p}\" {step_ms[p]:.3f} ms"
                               for p in ("highest", "high", "default"))
          + f" (mean of 5 warm steps, best of 2 turns) on {gpu}", flush=True)
    del per_op_runs, model, st

    args = ["train", "--device", DEV, "--precision", "high", "--regime",
            "a1", "--synthetic", "160", "--synthetic_min_len", "97",
            "--synthetic_max_len", "128", "--max_seq_len", "128",
            "--batch_size", str(B_TRAIN), "--epochs", "1", "--num_layers",
            "2", "--lr", str(LOOP_LR), "--experiment_name", "high",
            "--results_dir", os.path.join(tmp, "results"),
            "--checkpoint_dir", os.path.join(tmp, "ckpt")]
    kmod.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = nonzero(kmod.launch_counts())
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"  cli train --precision high (2 layers, 1 epoch of 160 synthetic "
          f"videos): rc {rc}, {res}, {secs:.1f} s; launches {counts}",
          flush=True)
    if rc != 0 or res["epochs_run"] != 1 or not np.isfinite(
            res["best_val_loss"]):
        fail("cli train --precision high did not run its epoch")
    if not all(counts.get(n) for n in (
            "ffn_train_high", "ffn_bwd_split_high", "ffn_high",
            "attn_sublayer_train_high", "attn_sublayer_bwd_high",
            "attn_sublayer_high")) or \
            any(counts.get(n) for n in ("ffn", "ffn_train", "ffn_bwd",
                                        "attn_sublayer",
                                        "attn_sublayer_train",
                                        "attn_sublayer_bwd")):
        fail(f"cli train --precision high launched {counts}")

    # ``cli serve --precision high`` over HTTP: a 300-frame video's bucket
    # of 320 runs the encoder per sublayer and the decoder's FF sublayers
    # on their own (in the mode) on the default route, against the plain
    # path in the same mode
    from keypoints_interpolation_transformer_torch.models.convert import (
        save_reference_pth)
    path = os.path.join(tmp, "precision.pth")
    save_reference_pth(path, net, {"hidden_dim": D, "num_layers": LAYERS,
                                   "num_heads": HEADS, "input_size": F_IN})
    videos, masks = request_videos(9)
    want = Inpainter.from_checkpoint(path, device=DEV, plain=True,
                                     precision="high").inpaint(videos, masks)
    kmod.reset_launches()
    Inpainter.from_checkpoint(path, device=DEV, precision="high").inpaint(
        videos, masks)
    torch.cuda.synchronize()
    counts = nonzero(kmod.launch_counts())
    if counts.get("ffn_high") != 2 * LAYERS or counts.get("ffn") or \
            counts.get("attn_sublayer_high") != LAYERS or \
            counts.get("attn_sublayer"):
        fail(f"serving at \"high\": launches {counts}")
    got = serve_over_cli(["--checkpoint", path, "--precision", "high"],
                         videos, masks)
    check_served("cli serve --precision high", videos, masks, got, want)
    print(f"  cli serve --precision high: 3 videos (300, 77, 128 frames) "
          f"over HTTP; in process the same request launches {counts}",
          flush=True)
    return launches


# the widths phase: (D, heads) at D in {32, 128, 384, 512} and head widths
# 8, 64 and 128, then the heads above 128 (dh 384, 192, 512, 256: the
# cores' wide build), FF = 4 D, two layers
WIDTH_CASES = ((32, 4), (128, 2), (128, 8), (384, 3), (512, 8), (384, 1),
               (384, 2), (512, 1), (512, 2))
WIDTH_LAYERS = 2


def phase_widths(torch, kmod):
    """Every kernel at the widths the JAX package's kernels take besides the
    flagship's, against its plain version; then a two-layer model at each
    width serves (float32 and int8, kernel route against plain) and takes
    an A1 train step (kernel path against plain path)."""
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    from keypoints_interpolation_transformer_torch.train import state, steps
    from keypoints_interpolation_transformer_torch.utils.config import (
        Config, ModelConfig)
    print("phase 10: widths D in {32, 128, 384, 512}, head widths 8, 16, "
          "64, 128, 192, 256, 384, 512", flush=True)
    for d, heads in WIDTH_CASES:
        ff = 4 * d
        tag = f"D={d} H={heads} dh={d // heads} FF={ff}"
        chk = KernelCheck(torch, kmod, d, heads, ff)
        for T in (40, 128):
            calls = ([(*c, False) for c in chk.calls(3, T)]
                     + chk.train_calls(3, T) + chk.per_op_calls(3, T)
                     + [(*c, False) for c in chk.int8_calls(3, T)])
            for name, variant, kern, plain, grad in calls:
                chk.compare(name, f"{tag} T={T} {variant}", kern(), plain(),
                            grad)
            for name, variant, kern, plain, grad, wrong in (
                    chk.layer_mode_calls(chk.operands(3, T), *chk.masks(3, T))
                    + chk.sublayer_mode_calls(3, 3, T)
                    + chk.linear_mode_calls(3, T)
                    + chk.int8_layer_mode_calls(chk.operands(3, T),
                                                *chk.masks(3, T))):
                chk.compare(name, f"{tag} T={T} {variant}", kern(), plain(),
                            grad, wrong())
        # B=40 (5120 rows) fills half the card with row tiles at every
        # width: the forwards' row-tile builds (B=3 above takes the narrow
        # ones and the FF split)
        for name, variant, kern, plain in chk.forward_calls(40, T_MAIN, True):
            chk.compare(name, f"{tag} B=40 T={T_MAIN} {variant}", kern(),
                        plain())
        cfg = Config(model=ModelConfig(hidden_dim=d, num_heads=heads,
                                       num_layers=WIDTH_LAYERS, ff_dim=ff))
        model = steps.build_model(cfg.model, device=DEV,
                                  generator=torch.Generator().manual_seed(d))
        clean, miss = model_inputs(4, T_MAIN, d)
        videos, masks = list(clean), list(miss)
        videos[1], masks[1] = videos[1][:97], masks[1][:97]
        for q in (None, "int8"):
            engines = [Inpainter(model.state_dict(), cfg.model, device=DEV,
                                 quantize=q, plain=plain)
                       for plain in (True, False)]
            want = engines[0].inpaint(videos, masks)
            kmod.reset_launches()
            got = engines[1].inpaint(videos, masks)
            torch.cuda.synchronize()
            counts = nonzero(kmod.launch_counts())
            print(f"  {tag} serving {q or 'float32'}: launches {counts}",
                  flush=True)
            if not counts:
                fail(f"{tag}: serving launched no kernel")
            if q is None:
                check_served(f"{tag} float32", videos, masks, got, want)
            else:
                check_int8_served(f"{tag} int8", videos, masks, got, want,
                                  int8_tolerance(f"{tag} int8", engines[0],
                                                 videos, masks, want))
        rng = np.random.default_rng(d)
        x = torch.from_numpy(rng.uniform(0.2, 0.8, (4, T_MAIN, 54, 2))
                             .astype(np.float32)).to(DEV)
        length = torch.tensor([T_MAIN, 97, T_MAIN, 60], device=DEV)
        losses = {}
        for plain in (True, False):
            net = steps.build_model(cfg.model, for_training=True, device=DEV,
                                    generator=torch.Generator().manual_seed(0))
            kmod.reset_launches()
            _, m = steps.make_train_step(net, cfg, None, plain=plain)(
                state.TrainState.create(net, 1e-3), x, length,
                torch.ones(4, device=DEV),
                torch.Generator(device=DEV).manual_seed(1), 1e-3)
            torch.cuda.synchronize()
            losses[plain] = float(m["loss"])
            counts = nonzero(kmod.launch_counts())
            if plain and counts:
                fail(f"{tag}: the plain train step launched {counts}")
        rel = abs(losses[False] - losses[True]) / abs(losses[True])
        print(f"  {tag} train step: loss kernel {losses[False]:.7f} plain "
              f"{losses[True]:.7f} rel {rel:.3e} (tol {LOSS_RTOL:.0e}); "
              f"launches {counts}", flush=True)
        if not counts or rel > LOSS_RTOL:
            fail(f"{tag}: train step rel {rel:.3e}, launches {counts}")


def ab_measure(torch, gpu, out_path):
    """One tree's numbers for ``--ab``, from the public entry points
    that every tree of the port has: the merged-route Inpainter's frames/s
    at B=256 (phase 6's method), the merged and the per-sublayer route's
    latency at 1 / 4 / 16 / 64 videos (``--sweep``'s), one 600-frame
    request's latency in float32 and int8 (phase 5's, per op), the A1 step
    time of the default route and of the per-op route (phase 7's), the
    A1 step at "high" and "default", the per-sublayer Inpainter's frames/s
    at B=256 in the three precisions and its one-video latency at "high",
    and each route's output sum and each step's first loss, which equal bit
    for bit where the kernels they run are unchanged; so do the int8 merged
    route's outputs and those of every int8 and precision-mode kernel on
    phase 2's seeded operands.  The merged route's B=256
    outputs go to ``out_path`` (.npy) for ``ab`` to compare across the
    trees."""
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    from keypoints_interpolation_transformer_torch.models.completer import (
        KeypointCompleter)
    from keypoints_interpolation_transformer_torch.train import state, steps
    from keypoints_interpolation_transformer_torch.utils.config import Config
    sd = KeypointCompleter(D, LAYERS, HEADS, ff_dim=FF,
                           generator=torch.Generator().manual_seed(0)
                           ).state_dict()
    routes = {"merged": Inpainter(sd, model_config(), device=DEV),
              "sublayer": Inpainter(sd, model_config(), device=DEV,
                                    merge_layers=False)}
    clean, miss = model_inputs(B_MAIN, T_MAIN, 3)
    videos, masks = list(clean), list(miss)
    out = {"gpu": gpu}
    for name, inp in routes.items():
        pred = np.stack(inp.inpaint(videos, masks))
        if name == "merged":
            np.save(out_path, pred)
        out[f"{name}_sum"] = float(pred.astype(np.float64).sum())
    fps, lat = 0.0, {name: {} for name in routes}
    for _ in range(2):
        fps = max(fps, frames_per_s(routes["merged"], videos, masks))
        for name, inp in routes.items():
            for B in (1, 4, 16, 64):
                v, m = list(clean[:B]), list(miss[:B])
                inp.inpaint(v, m)  # warm
                ms = []
                for _ in range(7):
                    t0 = time.perf_counter()
                    inp.inpaint(v, m)
                    ms.append((time.perf_counter() - t0) * 1e3)
                lat[name][B] = min(lat[name].get(B, float("inf")),
                                   float(np.median(ms)))
    out.update(fps=fps, latency_ms=lat)
    del routes
    # phase 5's 600-frame request (bucket 608, attention per op), float32
    # and int8: its output sum and latency, median of 7, best of 2 rounds
    rng = np.random.default_rng(12)
    video = [rng.uniform(0.2, 0.8, (600, 54, 2)).astype(np.float32)]
    vmiss = [(rng.random(600) < 0.3).astype(np.float32)]
    out["long_ms"] = {}
    for quant in (None, "int8"):
        tag = quant or "float32"
        inp = Inpainter(sd, model_config(), device=DEV, max_seq_len=640,
                        quantize=quant)
        pred = inp.inpaint(video, vmiss)[0]
        out[f"long_{tag}_sum"] = float(pred.astype(np.float64).sum())
        best = float("inf")
        for _ in range(2):
            ms = []
            for _ in range(7):
                t0 = time.perf_counter()
                inp.inpaint(video, vmiss)
                ms.append((time.perf_counter() - t0) * 1e3)
            best = min(best, float(np.median(ms)))
        out["long_ms"][tag] = best
        del inp
    # the int8 merged route (16 videos) and, on seeded operands, every
    # int8 and precision-mode kernel: output sums, which a change to the
    # float32 kernels must not move
    inp = Inpainter(sd, model_config(), device=DEV, quantize="int8")
    out["int8_merged_sum"] = float(np.stack(inp.inpaint(
        videos[:16], masks[:16])).astype(np.float64).sum())
    del inp
    from keypoints_interpolation_transformer_torch.ops import kernels as kmod
    chk = KernelCheck(torch, kmod)
    sums = {}
    for name, variant, kern, *_ in (
            chk.calls(3, T_MAIN) + chk.train_calls(3, T_MAIN)
            + chk.per_op_calls(3, T_MAIN)
            + chk.int8_calls(3, T_MAIN) + chk.precision_calls(3, 3, T_MAIN)
            + chk.layer_mode_calls(chk.operands(3, T_MAIN),
                                   *chk.masks(3, T_MAIN))
            + chk.sublayer_mode_calls(3, 3, T_MAIN)
            + chk.op_mode_calls(3, T_MAIN) + chk.chain_mode_calls(3, T_MAIN)
            + chk.linear_mode_calls(3, T_MAIN)
            + chk.int8_layer_mode_calls(chk.operands(3, T_MAIN),
                                        *chk.masks(3, T_MAIN))):
        got = kern()
        sums[f"{name} {variant}"] = sum(
            float(t.double().sum()) for t in
            (got if isinstance(got, tuple) else (got,)) if t is not None)
    out["kernel_sums"] = sums
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(0.2, 0.8, (B_TRAIN, T_MAIN, 54, 2))
                         .astype(np.float32)).to(DEV)
    length = torch.full((B_TRAIN,), T_MAIN, device=DEV)
    weight = torch.ones(B_TRAIN, device=DEV)
    # the A1 step on the default route and on the per-op attention route
    # (sublayer fusion off): the first step's loss, then the step time
    for key, fusion in (("", "auto"), ("per_op_", "off")):
        cfg = Config(model=model_config())
        cfg.model.attn_sublayer_fusion = fusion
        model = steps.build_model(cfg.model, for_training=True, device=DEV,
                                  generator=torch.Generator().manual_seed(0))
        st = state.TrainState.create(model, cfg.train.lr)
        step = steps.make_train_step(model, cfg, None)
        _, m = step(st, x, length, weight, torch.Generator(
            device=DEV).manual_seed(100), cfg.train.lr)
        out[f"{key}loss"] = float(m["loss"])
        step_ms = float("inf")
        for _ in range(2):
            gen = torch.Generator(device=DEV).manual_seed(7)
            step(st, x, length, weight, gen, cfg.train.lr)  # warm
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(5):
                step(st, x, length, weight, gen, cfg.train.lr)
            end.record()
            torch.cuda.synchronize()
            step_ms = min(step_ms, start.elapsed_time(end) / 5)
        out[f"{key}step_ms"] = step_ms
        del model, st, step
    # the precision modes: the A1 step at "high" and "default", on the
    # default route and per op (fusion off): its first loss, its time as
    # above, and one warm step's device time (the kernels' and copies'
    # self time under torch.profiler) beside its wall time there
    import dataclasses
    out["mode_step_ms"], out["mode_loss"] = {}, {}
    out["per_op_mode_step_ms"], out["mode_step_device_ms"] = {}, {}
    for prec in ("high", "default"):
        for key, fusion in (("", "auto"), ("per_op_", "off")):
            cfg = Config(model=dataclasses.replace(
                model_config(), matmul_precision=prec,
                attn_sublayer_fusion=fusion))
            model = steps.build_model(cfg.model, for_training=True,
                                      device=DEV, generator=torch.Generator()
                                      .manual_seed(0))
            st = state.TrainState.create(model, cfg.train.lr)
            step = steps.make_train_step(model, cfg, None)
            _, m = step(st, x, length, weight, torch.Generator(
                device=DEV).manual_seed(100), cfg.train.lr)
            if not key:
                out["mode_loss"][prec] = float(m["loss"])
            step_ms = float("inf")
            for _ in range(2):
                gen = torch.Generator(device=DEV).manual_seed(7)
                step(st, x, length, weight, gen, cfg.train.lr)  # warm
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(5):
                    step(st, x, length, weight, gen, cfg.train.lr)
                end.record()
                torch.cuda.synchronize()
                step_ms = min(step_ms, start.elapsed_time(end) / 5)
            out[f"{key}mode_step_ms"][prec] = step_ms
            gen = torch.Generator(device=DEV).manual_seed(7)
            rows, wall = profiled(torch, lambda: step(
                st, x, length, weight, gen, cfg.train.lr))
            out["mode_step_device_ms"][f"{key}{prec}"] = (
                sum(r[1] for r in rows), wall)
            del model, st, step
    # the int8 merged route at B=256 in the three precisions (frames/s,
    # best of 2): "high" and "default" run the int8 mode layers where a
    # tree has them
    out["int8_mode_fps"] = {}
    for prec in ("highest", "high", "default"):
        inp = Inpainter(sd, dataclasses.replace(
            model_config(), matmul_precision=prec), device=DEV,
            quantize="int8")
        out["int8_mode_fps"][prec] = max(frames_per_s(inp, videos, masks)
                                         for _ in range(2))
        del inp
    # the merged route at B=256 in the three precisions (frames/s, best
    # of 2): "high" and "default" run the mode layers where a tree has them
    out["merged_mode_fps"], out["merged_mode_sum"] = {}, {}
    for prec in ("highest", "high", "default"):
        inp = Inpainter(sd, dataclasses.replace(
            model_config(), matmul_precision=prec), device=DEV)
        out["merged_mode_sum"][prec] = float(np.stack(inp.inpaint(
            videos, masks)).astype(np.float64).sum())
        out["merged_mode_fps"][prec] = max(frames_per_s(inp, videos, masks)
                                           for _ in range(2))
        del inp
    out["mode_fps"], out["high_one_video_ms"] = {}, None
    for prec in ("highest", "high", "default"):
        inp = Inpainter(sd, dataclasses.replace(
            model_config(), matmul_precision=prec), device=DEV,
            merge_layers=False)
        out["mode_fps"][prec] = max(frames_per_s(inp, videos, masks)
                                    for _ in range(2))
        if prec == "high":
            v, m = videos[:1], masks[:1]
            inp.inpaint(v, m)  # warm
            best = float("inf")
            for _ in range(2):
                ms = []
                for _ in range(7):
                    t0 = time.perf_counter()
                    inp.inpaint(v, m)
                    ms.append((time.perf_counter() - t0) * 1e3)
                best = min(best, float(np.median(ms)))
            out["high_one_video_ms"] = best
        del inp
    print(json.dumps(out), flush=True)
    return 0


def ab(other, gpu):
    """``--ab DIR``: this tree against the tree unpacked in DIR (the
    parent), in turns: parent, this, this, parent; each turn a fresh
    process that imports its tree's package and measures
    ``ab_measure``'s numbers.  Both trees' kernels are built first, at
    once.  Then the merged route's outputs of the two trees are compared:
    the largest coordinate difference and the masked MPJPE between them."""
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(other), "change": here}
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from keypoints_interpolation_transformer_torch.ops.kernels "
         "import _build; _build.build()", t], cwd=t) for t in trees.values()]
    if any(b.wait() != 0 for b in builds):
        fail("a tree's kernels did not build")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for turn, name in enumerate(("parent", "change", "change", "parent")):
            npy = os.path.join(tmp, f"{turn}_{name}.npy")
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--ab-measure", trees[name], npy],
                               cwd=trees[name], capture_output=True, text=True,
                               timeout=900)
            if r.returncode != 0:
                fail(f"{name}: {r.stdout[-2000:]} {r.stderr[-4000:]}")
            row = json.loads(r.stdout.strip().splitlines()[-1])
            rows.append((name, row))
            lat = row["latency_ms"]
            print(f"  ab {name}: Inpainter merged {row['fps']:.1f} frames/s; "
                  "latency merged " + " / ".join(
                      f"{v:.3f}" for v in lat["merged"].values())
                  + " ms, per-sublayer " + " / ".join(
                      f"{v:.3f}" for v in lat["sublayer"].values())
                  + f" ms at 1 / 4 / 16 / 64 videos; A1 step "
                  f"{row['step_ms']:.3f} ms, per op (fusion off) "
                  f"{row['per_op_step_ms']:.3f} ms; one 600-frame request "
                  f"{row['long_ms']['float32']:.3f} ms float32, "
                  f"{row['long_ms']['int8']:.3f} ms int8; output sum merged "
                  f"{row['merged_sum']!r}, per-sublayer "
                  f"{row['sublayer_sum']!r}, 600 frames "
                  f"{row['long_float32_sum']!r} / {row['long_int8_sum']!r}; "
                  f"step loss {row['loss']!r}, per op "
                  f"{row['per_op_loss']!r} on {row['gpu']}", flush=True)
            print(f"  ab {name} modes: A1 step \"high\" "
                  f"{row['mode_step_ms']['high']:.3f} ms, \"default\" "
                  f"{row['mode_step_ms']['default']:.3f} ms (losses "
                  f"{row['mode_loss']['high']!r} / "
                  f"{row['mode_loss']['default']!r}); per-sublayer Inpainter "
                  f"B={B_MAIN} " + " / ".join(
                      f"{p} {v:.1f}" for p, v in row["mode_fps"].items())
                  + " frames/s; one video at \"high\" "
                  f"{row['high_one_video_ms']:.3f} ms; merged Inpainter "
                  f"B={B_MAIN} " + " / ".join(
                      f"{p} {v:.1f}" for p, v in
                      row["merged_mode_fps"].items()) + " frames/s",
                  flush=True)
            print(f"  ab {name} mode steps B={B_TRAIN} T={T_MAIN}: per op "
                  "(fusion off) " + " / ".join(
                      f"\"{p}\" {v:.3f}" for p, v in
                      row["per_op_mode_step_ms"].items())
                  + " ms; one warm step under the profiler, device busy / "
                  "wall: " + ", ".join(
                      f"{k} {d:.3f} / {w:.3f} ms" for k, (d, w) in
                      row["mode_step_device_ms"].items())
                  + f"; int8 merged Inpainter B={B_MAIN} " + " / ".join(
                      f"{p} {v:.1f}" for p, v in
                      row["int8_mode_fps"].items()) + " frames/s",
                  flush=True)
        parent, change = (np.load(os.path.join(tmp, f)) for f in
                          ("0_parent.npy", "1_change.npy"))
    _, miss = model_inputs(B_MAIN, T_MAIN, 3)
    delta = masked_mpjpe_delta(change, parent, miss)
    print(f"  ab: merged outputs, change against parent: largest coordinate "
          f"difference {float(np.abs(change - parent).max()):.3e}, masked "
          f"MPJPE {delta:.3e} (the route's gate against the plain path: "
          f"{MPJPE_TOL:.0e})", flush=True)
    same = {k: len({json.dumps(r[k]) for _, r in rows}) == 1
            for k in ("merged_sum", "sublayer_sum", "loss", "per_op_loss",
                      "long_float32_sum", "long_int8_sum", "int8_merged_sum",
                      "merged_mode_sum", "kernel_sums")}
    print(f"  ab: bit for bit equal across the trees: {same}", flush=True)
    moved = sorted(k for k in rows[0][1]["kernel_sums"]
                   if len({r["kernel_sums"].get(k) for _, r in rows}) > 1)
    print(f"  ab: kernel rows (every float32, int8 and mode kernel on "
          f"phase 2's seeded operands; mode_linear_bwd given the same "
          f"planes) whose outputs moved: {moved}", flush=True)
    return 0


def model_config():
    from keypoints_interpolation_transformer_torch.utils.config import (
        ModelConfig)
    return ModelConfig(hidden_dim=D, num_heads=HEADS, num_layers=LAYERS,
                       ff_dim=FF)


def main():
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs the port on the card")
    if "--ab-measure" in sys.argv[1:]:  # the tree under test goes first
        tree = sys.argv[sys.argv.index("--ab-measure") + 1]
        sys.path.insert(0, os.path.abspath(tree))
        return ab_measure(torch, gpu_line(), sys.argv[-1])
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    from keypoints_interpolation_transformer_torch.models.completer import (
        KeypointCompleter)
    from keypoints_interpolation_transformer_torch.ops import kernels as kmod
    from keypoints_interpolation_transformer_torch.ops.kernels import _build

    print("phase 1: device and build", flush=True)
    gpu = gpu_line()
    print(gpu, flush=True)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 is on: the plain versions would not be f32 oracles")
    secs = _build.build()
    print(f"  nvcc build {max(secs.values()):.1f} s, the sources in parallel "
          f"({', '.join(f'{n} {t:.1f} s' for n, t in secs.items())})",
          flush=True)
    for name in _build.SOURCES:
        log = _build.BUILD_DIR / f"{name}.log"
        if log.is_file():
            entry = ""
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line or \
                        "Function properties for" in line:
                    entry = kernel_name(line)
                elif "registers" in line or "spill" in line:
                    print(f"  {name} {entry}: {line.split(':', 1)[-1].strip()}",
                          flush=True)

    if "--profile" in sys.argv[1:]:
        profile_paths(torch, gpu)
        profile_loop_epoch(torch, gpu)
        return 0
    if "--sweep" in sys.argv[1:]:
        sweep(torch, kmod, gpu)
        return 0
    if "--ab" in sys.argv[1:]:
        return ab(sys.argv[sys.argv.index("--ab") + 1], gpu)
    max_err, times = phase_kernels(torch, kmod)

    model = KeypointCompleter(D, LAYERS, HEADS, ff_dim=FF, device=DEV,
                              generator=torch.Generator().manual_seed(0))
    model.eval()
    phase_model(torch, kmod, model)

    with tempfile.TemporaryDirectory() as tmp:
        launches, path, inp, oracle = phase_serving(torch, kmod, model, tmp)
        variant_paths = phase_variants(torch, kmod, tmp, path)
        phase_long_request(torch, kmod, path, gpu)
        int8_launches = phase_int8(torch, kmod, path, variant_paths, gpu)
        sublayer = Inpainter.from_checkpoint(path, device=DEV,
                                             merge_layers=False)
    phase_throughput(torch, {"merged": inp, "sublayer": sublayer,
                             "plain": oracle}, gpu)
    del model, inp, sublayer, oracle
    train_launches, _ = phase_train(torch, kmod, gpu)
    launches.update({n: train_launches[n] for n in TRAIN_KERNELS})
    with tempfile.TemporaryDirectory() as tmp:
        loop_launches = phase_loop(torch, kmod, gpu, tmp)
        launches.update(phase_precision(torch, kmod, gpu, tmp))
    launches.update({n: loop_launches[n] for n in PER_OP_KERNELS})
    launches.update(int8_launches)
    phase_widths(torch, kmod)

    summary = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": max_err[k.name], "ms": times[k.name][0],
         "plain_ms": times[k.name][1], "bound_ms": times[k.name][2],
         "bound_by": times[k.name][3], "library_ms": times[k.name][4]}
        for k in kmod.KERNELS]}
    print(f"run: {time.perf_counter() - t_start:.1f} s, the build included",
          flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's CUDA kernels on a CUDA card (marker ``gpu``; each test skips
without a card).  This file imports no JAX, so it also runs where JAX is
not installed; ``tests/conftest.py`` does import it, so there run

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card(cuda):
    """Every kernel variant of the serving path against its plain version
    at the flagship widths, on an aligned and a ragged length."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels)
    for T in (40, 128):
        for name, variant, kern, plain in chk.calls(3, T):
            chk.compare(name, variant, kern(), plain())


@pytest.mark.gpu
def test_model_kernel_path_on_the_card(cuda):
    """A two-layer model: the kernel path (the merged route at T=40)
    agrees with the plain path and launches each kernel as often as the
    TPU kernel it replaces."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.models.completer import (
        KeypointCompleter)
    from keypoints_interpolation_transformer_torch.ops import kernels
    B, T, layers = 2, 40, 2
    model = KeypointCompleter(128, layers, 4, ff_dim=256, device=cuda,
                              generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(
        np.float32)).to(cuda)
    m = torch.from_numpy((rng.random((B, T)) < 0.3).astype(np.float32)).to(
        cuda)
    valid = torch.ones(B, T, device=cuda)
    valid[1, T - 7:] = 0.0
    with torch.inference_mode():
        want = model(x, x, m, m, valid, plain=True)
        kernels.reset_launches()
        got = model(x, x, m, m, valid)
        torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        **chip_smoke.NO_LAUNCHES, "pre_stream_embed": 2, "post_head": 1,
        "enc_layer": layers, "dec_layer": layers}
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_wrapper_raises_rather_than_falls_back(cuda):
    from keypoints_interpolation_transformer_torch.ops import kernels
    r = torch.zeros(4, 128, device=cuda)
    w = torch.zeros(128, 256, device=cuda)
    args = (w, torch.zeros(256, device=cuda), w.t().contiguous(),
            torch.zeros(128, device=cuda), None, None,
            torch.ones(128, device=cuda), torch.zeros(128, device=cuda))
    with pytest.raises(TypeError):
        kernels.fused_ffn(r.double(), *args)
    with pytest.raises(ValueError):
        kernels.fused_ffn(r, *args[:4], None, None, torch.ones(128),
                          torch.zeros(128))
    kernels.reset_launches()
    kernels.fused_ffn(r, *args)
    assert kernels.launch_counts()["ffn"] == 1


@pytest.mark.gpu
def test_training_kernels_match_plain_on_the_card(cuda):
    """The training forwards and backwards against their plain versions on
    an aligned and a ragged length, with a padded row."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels)
    for T in (40, 128):
        for name, variant, kern, plain, grad in chk.train_calls(3, T):
            chk.compare(name, variant, kern(), plain(), grad)


@pytest.mark.gpu
def test_train_step_kernel_path_on_the_card(cuda):
    """Two layers, one A1 step on each path from the same parameters and
    corruption: the same loss, and each training kernel launched once per
    sublayer."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.train import state, steps
    from keypoints_interpolation_transformer_torch.utils.config import (
        Config, ModelConfig)
    cfg = Config(model=ModelConfig(hidden_dim=128, num_heads=4, num_layers=2,
                                   ff_dim=256))
    rng = np.random.default_rng(0)
    clean = torch.from_numpy(rng.uniform(0.2, 0.8, (4, 40, 54, 2)).astype(
        np.float32)).to(cuda)
    length = torch.tensor([40, 33, 40, 21], device=cuda)
    losses = {}
    for plain in (True, False):
        model = steps.build_model(cfg.model, for_training=True,
                                  generator=torch.Generator().manual_seed(0))
        st = state.TrainState.create(model, 1e-3)
        kernels.reset_launches()
        _, m = steps.make_train_step(model, cfg, None, plain=plain)(
            st, clean, length, torch.ones(4, device=cuda),
            torch.Generator(device=cuda).manual_seed(1), 1e-3)
        torch.cuda.synchronize()
        losses[plain] = float(m["loss"])
    assert kernels.launch_counts() == {
        **chip_smoke.NO_LAUNCHES, "attn_sublayer_train": 6,
        "attn_sublayer_bwd": 6, "ffn_train": 4, "ffn_bwd": 4}
    assert abs(losses[False] - losses[True]) <= 1e-4 * abs(losses[True])


@pytest.mark.gpu
def test_merged_layer_kernels_match_plain_on_the_card(cuda):
    """The whole-layer kernels with the plain model's and the Cycle model's
    masks, the decoder with and without its FF tail, at the largest merged
    bucket and a length that is no multiple of 32, with a padded row."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels)
    for T in (40, 256):
        mask, valid = chk.masks(3, T)
        for name, variant, kern, plain in chk.layer_calls(
                chk.operands(3, T), mask, valid):
            chk.compare(name, variant, kern(), plain())


@pytest.mark.gpu
def test_merged_layer_kernels_at_every_cluster_size(cuda):
    """Each thread-block cluster size the batch can pick, 1 to 8 blocks
    per video, against the plain versions, the int8 encoder layer too: one
    64-row tile and a padded tail (T = 40, the FF split over up to 8
    blocks), two full tiles (128) and five with a padded tail (300)."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels)
    for T in (40, 128, 300):
        o, (mask, valid) = chk.operands(3, T), chk.masks(3, T)
        for cl in range(1, 9):
            for name, variant, kern, plain in (
                    chk.layer_calls(o, mask, valid, cl)
                    + chk.int8_layer_calls(o, mask, valid, cl)):
                chk.compare(name, variant, kern(), plain())


@pytest.mark.gpu
def test_merged_wrappers_raise_rather_than_fall_back(cuda, monkeypatch):
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.ops.kernels import (
        layer_fused)
    B, T, D, FF = 2, 16, 128, 256
    z = lambda *s: torch.zeros(*s, device=cuda)  # noqa: E731
    attn = (z(D, 3 * D), z(3 * D), z(D, D), z(D))
    ff = (z(D, FF), z(FF), z(FF, D), z(D), z(D) + 1, z(D), z(D) + 1, z(D))
    x = z(B, T, D)
    with pytest.raises(TypeError):
        kernels.fused_encoder_layer(x.double(), *attn, *ff, None, None,
                                    "all", False, 4)
    with pytest.raises(ValueError):  # a wrong weight shape
        kernels.fused_encoder_layer(x, z(D, 2 * D), *attn[1:], *ff, None,
                                    None, "all", False, 4)
    with pytest.raises(ValueError):  # a width the kernels do not take
        w = 640
        kernels.fused_encoder_layer(
            z(B, T, w), z(w, 3 * w), z(3 * w), z(w, w), z(w), z(w, FF), z(FF),
            z(FF, w), z(w), z(w) + 1, z(w), z(w) + 1, z(w), None, None, "all",
            False, 4)
    with pytest.raises(ValueError):  # weights left on the CPU
        kernels.fused_decoder_layer(x, x, *attn, *(t.cpu() for t in attn),
                                    z(D), z(D), None, None, None, None, None,
                                    "all", False, "all", False, 4)
    with pytest.raises(ValueError):  # more blocks per video than 8
        kernels.fused_encoder_layer(x, *attn, *ff, None, None, "all", False,
                                    4, cluster=9)
    with monkeypatch.context() as m:  # an FF split the cluster cannot hold
        m.setattr(layer_fused, "ff_parts", lambda T, D, FF, cl: cl + 1)
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernels.fused_encoder_layer(x, *attn, *ff, None, None, "all",
                                        False, 4, cluster=2)
    kernels.reset_launches()
    kernels.fused_encoder_layer(x, *attn, *ff, None, None, "all", False, 4)
    kernels.fused_decoder_layer(x, x, *attn, *attn, z(D), z(D), None, None,
                                None, None, None, "all", False, "all",
                                False, 4)
    counts = kernels.launch_counts()
    assert (counts["enc_layer"], counts["dec_layer"]) == (1, 1)


@pytest.mark.gpu
def test_flagship_forward_launches_the_merged_route(cuda):
    """One flagship forward (6 + 6 layers, D=256, FF=2048) at T=128: the
    merged route launches 2 / 6 / 6 / 1, the per-sublayer route 2 / 18 /
    12 / 1, and both agree with the plain path."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.models.completer import (
        KeypointCompleter)
    from keypoints_interpolation_transformer_torch.ops import kernels
    B, T = 2, 128
    model = KeypointCompleter(256, 6, 8, ff_dim=2048, device=cuda,
                              generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(
        np.float32)).to(cuda)
    m = torch.from_numpy((rng.random((B, T)) < 0.3).astype(np.float32)).to(
        cuda)
    valid = torch.ones(B, T, device=cuda)
    with torch.inference_mode():
        want = model(x, x, m, m, valid, plain=True)
        for merge, counts in ((True, chip_smoke.MERGED_COUNTS),
                              (False, chip_smoke.SUBLAYER_COUNTS)):
            model.merge_layers = merge
            kernels.reset_launches()
            got = model(x, x, m, m, valid)
            torch.cuda.synchronize()
            assert kernels.launch_counts() == counts
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_per_op_kernels_match_plain_on_the_card(cuda):
    """The per-op attention forward and backward (every mask kind, padded
    keys, a video whose keys are all padded) and the masked loss against
    their plain versions, at a ragged length and above 512."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels)
    for T in (40, 608):
        for name, variant, kern, plain, grad in chk.per_op_calls(3, T):
            chk.compare(name, variant, kern(), plain(), grad)


@pytest.mark.gpu
def test_per_op_wrappers_raise_rather_than_fall_back(cuda):
    from keypoints_interpolation_transformer_torch.ops import kernels
    q = torch.zeros(2, 16, 4, 32, device=cuda)
    m = torch.zeros(2, 16, device=cuda)
    with pytest.raises(ValueError):  # Tq != Tk
        kernels.fused_attention(q, q[:, :8].contiguous(), q, m, None)
    with pytest.raises(ValueError):  # a head width the kernels do not take
        wide = torch.zeros(2, 16, 1, 513, device=cuda)
        kernels.fused_attention(wide, wide, wide, m, None)
    with pytest.raises(TypeError):
        kernels.fused_masked_loss(torch.zeros(2, 4, 54, 2, device=cuda,
                                              dtype=torch.float64),
                                  torch.zeros(2, 4, 54, 2, device=cuda),
                                  torch.ones(2, 4, device=cuda))
    # the forward's residuals: both or neither, of the queries' shape,
    # float32, contiguous, on the card, 16-byte aligned at head width 32
    out, st = kernels.fused_attention(q, q, q, m, None, stats=True)
    assert tuple(st.shape) == (2, 4, 16, 2)
    with pytest.raises(ValueError, match="together"):
        kernels.attention_bwd(q, q, q, q, m, None, out=out)
    with pytest.raises(ValueError, match="shape"):
        kernels.attention_bwd(q, q, q, q, m, None, out=out,
                              stats=st[:, :2].contiguous())
    with pytest.raises(ValueError, match="shape"):
        kernels.attention_bwd(q, q, q, q, m, None, out=out[:, :8].contiguous(),
                              stats=st)
    with pytest.raises(ValueError, match="is on"):
        kernels.attention_bwd(q, q, q, q, m, None, out=out, stats=st.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.attention_bwd(q, q, q, q, m, None, out=out, stats=st.transpose(
            2, 3).contiguous().transpose(2, 3))
    with pytest.raises(TypeError):
        kernels.attention_bwd(q, q, q, q, m, None, out=out.double(), stats=st)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.attention_bwd(q, q, q, q, m, None, out=torch.zeros(
            out.numel() + 1, device=cuda)[1:].view(out.shape), stats=st)
    kernels.reset_launches()
    kernels.fused_attention(q, q, q, m, None)
    kernels.attention_bwd(q, q, q, q, m, None)
    kernels.fused_masked_loss(torch.zeros(2, 4, 54, 2, device=cuda),
                              torch.zeros(2, 4, 54, 2, device=cuda),
                              torch.ones(2, 4, device=cuda))
    counts = kernels.launch_counts()
    assert (counts["attention"], counts["attention_bwd"],
            counts["masked_loss"]) == (1, 1, 1)


# the per-op kernels' head widths on the card: 32 (the flagship), 16 and
# 64 (the register-tiled forward and the one-pass backward), and 48, a
# width of attention.cuh's general build (one query a thread, two passes)
PER_OP_WIDTHS = ((256, 8), (256, 16), (256, 4), (96, 2))


@pytest.mark.gpu
def test_per_op_kernels_at_every_length_and_head_width(cuda):
    """``attention`` and both forms of ``attention_bwd`` (standalone, and
    given the forward's out and stats) against their plain versions at
    T = 128 (one key tile), 129 (two), and every length of
    ``chip_smoke.ATTN_T``, at each of ``PER_OP_WIDTHS``: every mask
    variant, keys padded in one video and, at B = 3, every key of
    another."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d, heads in PER_OP_WIDTHS:
        chk = chip_smoke.KernelCheck(torch, kernels, d, heads, 4 * d)
        for T in (128, 129) + chip_smoke.ATTN_T:
            B = 2 if T == 2048 else 3
            for name, variant, kern, plain, grad in chk.per_op_calls(B, T):
                if name != "masked_loss":
                    chk.compare(name, f"D={d} H={heads} B={B} T={T} "
                                f"{variant}", kern(), plain(), grad)


@pytest.mark.gpu
def test_attention_bwd_forms_give_the_same_bits(cuda):
    """The standalone backward runs the same forward into scratch that
    ``fused_attention(..., stats=True)`` runs, then the same backward: its
    gradients equal the residual form's bit for bit."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d, heads in PER_OP_WIDTHS:
        chk = chip_smoke.KernelCheck(torch, kernels, d, heads, 4 * d)
        for T in (128, 608):
            calls = [c for c in chk.per_op_calls(3, T)
                     if c[0] == "attention_bwd"]
            alone = [c for c in calls if chip_smoke.RESIDUAL_FORM not in c[1]]
            given = [c for c in calls if chip_smoke.RESIDUAL_FORM in c[1]]
            assert len(alone) == len(given) == 4
            for a, b in zip(alone, given):
                first, second = a[2](), b[2]()
                torch.cuda.synchronize()
                for x, y in zip(first, second):
                    assert torch.equal(x, y), (d, heads, T, a[1])


@pytest.mark.gpu
def test_long_bucket_takes_the_per_op_route(cuda):
    """A two-layer model at T=520 (above the sublayer kernel's 512): one
    forward launches attention per op and agrees with the plain path; so
    does a training step with sublayer fusion off at T=40."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.models.completer import (
        KeypointCompleter)
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.train import state, steps
    from keypoints_interpolation_transformer_torch.utils.config import (
        Config, ModelConfig, TrainConfig)
    B, T, layers = 2, 520, 2
    model = KeypointCompleter(128, layers, 4, ff_dim=256, device=cuda,
                              generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(
        np.float32)).to(cuda)
    m = torch.from_numpy((rng.random((B, T)) < 0.3).astype(np.float32)).to(
        cuda)
    valid = torch.ones(B, T, device=cuda)
    valid[1, 400:] = 0.0
    with torch.inference_mode():
        want = model(x, x, m, m, valid, plain=True)
        kernels.reset_launches()
        got = model(x, x, m, m, valid)
        torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        **chip_smoke.NO_LAUNCHES, "pre_stream_embed": 2,
        "attention": 3 * layers, "ffn": 2 * layers, "post_head": 1}
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    cfg = Config(model=ModelConfig(hidden_dim=128, num_heads=4,
                                   num_layers=layers, ff_dim=256,
                                   attn_sublayer_fusion="off"),
                 train=TrainConfig(fused_loss=True))
    clean = x[:, :40].contiguous()
    length = torch.tensor([40, 33], device=cuda)
    losses = {}
    for plain in (True, False):
        net = steps.build_model(cfg.model, for_training=True,
                                generator=torch.Generator().manual_seed(0))
        kernels.reset_launches()
        _, out = steps.make_train_step(net, cfg, None, plain=plain)(
            state.TrainState.create(net, 1e-3), clean, length,
            torch.ones(B, device=cuda),
            torch.Generator(device=cuda).manual_seed(1), 1e-3)
        torch.cuda.synchronize()
        losses[plain] = float(out["loss"])
    assert kernels.launch_counts() == {
        **chip_smoke.NO_LAUNCHES, "attention": 3 * layers,
        "attention_bwd": 3 * layers, "ffn_train": 2 * layers,
        "ffn_bwd": 2 * layers, "masked_loss": 1}
    assert abs(losses[False] - losses[True]) <= 1e-4 * abs(losses[True])


@pytest.mark.gpu
def test_int8_kernels_match_plain_on_the_card(cuda):
    """The int8 dense layer, the int8 FF sublayer and the merged encoder
    layer with its FF int8 against their plain versions (chip_smoke's
    int8 tolerance: a value at a rounding boundary may quantize one step
    the other way), on an aligned and a ragged length."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels)
    for T in (40, 128):
        for name, variant, kern, plain in chk.int8_calls(3, T):
            chk.compare(name, variant, kern(), plain())


@pytest.mark.gpu
def test_int8_inpainter_routes_on_the_card(cuda):
    """A two-layer int8 model at D=128: the merged route launches the int8
    encoder layer, the decoder layer without its FF tail and the int8 FF
    sublayer once per layer, and agrees with the plain int8 path."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.models.completer import (
        KeypointCompleter)
    from keypoints_interpolation_transformer_torch.ops import kernels
    layers = 2
    model = KeypointCompleter(128, layers, 4, ff_dim=256, device=cuda,
                              generator=torch.Generator().manual_seed(0))
    model.eval().pack_weights("int8")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0.2, 0.8, (2, 40, 54, 2)).astype(
        np.float32)).to(cuda)
    m = torch.from_numpy((rng.random((2, 40)) < 0.3).astype(np.float32)).to(
        cuda)
    with torch.inference_mode():
        want = model(x, x, m, m, plain=True)
        kernels.reset_launches()
        got = model(x, x, m, m)
        torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        **chip_smoke.NO_LAUNCHES, "pre_stream_embed": 2, "post_head": 1,
        "enc_layer_int8": layers, "dec_layer": layers, "ffn_int8": layers}
    d = torch.linalg.vector_norm(got - want, dim=-1).mean()
    assert float(d) < chip_smoke.INT8_MPJPE_TOL


@pytest.mark.gpu
def test_int8_wrappers_raise_rather_than_fall_back(cuda):
    from keypoints_interpolation_transformer_torch.ops import kernels
    x = torch.zeros(4, 64, device=cuda)
    wq = torch.zeros(32, 64, dtype=torch.int8, device=cuda)
    ws, b = torch.ones(32, device=cuda), torch.zeros(32, device=cuda)
    with pytest.raises(ValueError):  # a float weight
        kernels.fused_int8_dense(x, wq.float(), ws, b)
    with pytest.raises(ValueError):  # the weight left on the CPU
        kernels.fused_int8_dense(x, wq.cpu(), ws, b)
    with pytest.raises(ValueError):  # a wrong weight shape
        kernels.fused_int8_dense(x, wq[:, :32].contiguous(), ws, b)
    kernels.reset_launches()
    kernels.fused_int8_dense(x, wq, ws, b)
    assert kernels.launch_counts()["int8_dense"] == 1


@pytest.mark.gpu
def test_kernels_at_every_width_on_the_card(cuda):
    """Every kernel (the pointwise ones where D % 128 == 0) at D = 32, 128,
    384 and 512 with head widths 8, 16, 64 and 128, and at D = 384 and 512
    with one and two heads (head widths 192 to 512, the attention cores'
    wide build), against its plain version."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d, heads in chip_smoke.WIDTH_CASES:
        chk = chip_smoke.KernelCheck(torch, kernels, d, heads, 4 * d)
        calls = ([(*c, False) for c in chk.calls(3, 40)]
                 + chk.train_calls(3, 40) + chk.per_op_calls(3, 40)
                 + [(*c, False) for c in chk.int8_calls(3, 40)])
        for name, variant, kern, plain, grad in calls:
            chk.compare(name, f"D={d} {variant}", kern(), plain(), grad)


@pytest.mark.gpu
def test_precision_kernels_match_plain_on_the_card(cuda):
    """The FF forward and training forward in "high" and "default", the
    split backward in both modes and the pre-stream chain, each against
    its plain version in the same mode, on an aligned and a ragged length;
    each mode kernel also nearer its own mode's plain version than the
    wrong mode's."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels)
    for T in (40, 128):
        for name, variant, kern, plain, grad, wrong in chk.precision_calls(
                3, 3, T):
            chk.compare(name, variant, kern(), plain(), grad,
                        None if wrong is None else wrong())


@pytest.mark.gpu
def test_train_step_at_high_on_the_card(cuda):
    """Two layers at "high": one A1 step on the kernel and the plain route
    in that mode from the same parameters and corruption, the same loss
    and the same gradients (each parameter's within HIGH_MODE_TOL of its
    own largest value, as the optimizer receives them), the FF and
    attention sublayers through the "high" kernels (the bf16x3 forwards and
    backwards, not the float32 ffn_bwd or attn_sublayer_train / _bwd), and
    the chains' Dense products through ``mode_linear`` and its backward."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.train import state, steps
    from keypoints_interpolation_transformer_torch.utils.config import (
        Config, ModelConfig)
    cfg = Config(model=ModelConfig(hidden_dim=128, num_heads=4, num_layers=2,
                                   ff_dim=256, matmul_precision="high"))
    rng = np.random.default_rng(0)
    clean = torch.from_numpy(rng.uniform(0.2, 0.8, (4, 40, 54, 2)).astype(
        np.float32)).to(cuda)
    length = torch.tensor([40, 33, 40, 21], device=cuda)
    losses, grads = {}, {}
    for plain in (True, False):
        model = steps.build_model(cfg.model, for_training=True,
                                  generator=torch.Generator().manual_seed(0))
        st = state.TrainState.create(model, 1e-3)
        adam = st.optimizer.step

        def keep_grads(*a, plain=plain, model=model, adam=adam, **k):
            grads[plain] = {n: p.grad.clone()
                            for n, p in model.named_parameters()}
            return adam(*a, **k)

        st.optimizer.step = keep_grads
        kernels.reset_launches()
        _, m = steps.make_train_step(model, cfg, None, plain=plain)(
            st, clean, length, torch.ones(4, device=cuda),
            torch.Generator(device=cuda).manual_seed(1), 1e-3)
        torch.cuda.synchronize()
        losses[plain] = float(m["loss"])
    assert kernels.launch_counts() == {
        **chip_smoke.NO_LAUNCHES, "attn_sublayer_train_high": 6,
        "attn_sublayer_bwd_high": 6, "ffn_train_high": 4,
        "ffn_bwd_split_high": 4,
        "mode_linear_high": chip_smoke.CHAIN_DENSE,
        "mode_linear_bwd_high": chip_smoke.CHAIN_DENSE}
    assert abs(losses[False] - losses[True]) <= 1e-4 * abs(losses[True])
    assert grads[True].keys() == grads[False].keys()
    for n, want in grads[True].items():
        scale = float(want.abs().max())
        err = float((grads[False][n] - want).abs().max())
        assert err <= chip_smoke.HIGH_MODE_TOL * scale, (n, err, scale)


@pytest.mark.gpu
def test_precision_wrappers_raise_rather_than_fall_back(cuda):
    from keypoints_interpolation_transformer_torch.ops import kernels
    r = torch.zeros(4, 128, device=cuda)
    w1 = torch.zeros(128, 256, device=cuda)
    args = (w1, torch.zeros(256, device=cuda), w1.t().contiguous(),
            torch.zeros(128, device=cuda), None, None,
            torch.ones(128, device=cuda), torch.zeros(128, device=cuda))
    planes = kernels.ff_weight_planes(w1.t(), w1, "bf16x3")
    with pytest.raises(ValueError, match="lo planes"):
        kernels.fused_ffn(r, *args, False, "bf16", planes)
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.fused_ffn(r, *args, False, "bf16x3",
                          tuple(p.float() for p in planes))
    with pytest.raises(ValueError, match="precision mode"):
        kernels.fused_ffn(r, *args, False, "high")
    kernels.reset_launches()
    kernels.fused_ffn(r, *args, False, "bf16x3", planes)
    assert kernels.launch_counts()["ffn_high"] == 1
    assert kernels.launch_counts()["ffn"] == 0


@pytest.mark.gpu
def test_training_backwards_match_plain_at_every_length(cuda):
    """``ffn_bwd`` and ``attn_sublayer_bwd`` against their plain versions
    at T = 40, 128, 300 and 512 (one to four key tiles of the backward's
    attention core): self-attention with and without its LayerNorm,
    cross-attention, the FF sublayer with and without LN1, keys padded in
    one video and every key of another; then at head widths 16 and 64, the
    core's other builds."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d, heads, lengths in ((256, 8, (40, 128, 300, 512)),
                              (256, 16, (40, 300)), (128, 2, (128, 300))):
        chk = chip_smoke.KernelCheck(torch, kernels, d, heads, 4 * d)
        for T in lengths:
            for name, variant, kern, plain, grad in chk.train_calls(
                    3, T, blocked=True):
                if name in ("attn_sublayer_bwd", "ffn_bwd"):
                    chk.compare(name, f"D={d} H={heads} T={T} {variant}",
                                kern(), plain(), grad)


@pytest.mark.gpu
def test_training_backwards_are_deterministic(cuda):
    """The same inputs twice give the same bits: the weight gradients'
    row ranges and the dq parts of the key tiles are added in a fixed
    order, with no atomics; so for the per-op ``attention_bwd`` in both of
    its forms."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels)
    for T in (128, 300):
        B = 64 if T == 128 else 8
        for name, variant, kern, _, _ in (chk.train_calls(B, T)
                                          + chk.per_op_calls(B, T)):
            if name not in ("attn_sublayer_bwd", "ffn_bwd", "attention_bwd"):
                continue
            first, second = kern(), kern()
            torch.cuda.synchronize()
            for a, b in zip(first, second):
                assert (a is None) == (b is None)
                assert a is None or torch.equal(a, b), (name, variant, T)


@pytest.mark.gpu
def test_training_backward_wrappers_raise_rather_than_fall_back(cuda):
    """On a CUDA tensor the backward wrappers launch their kernels or
    raise: on type, device, shape, contiguity and alignment."""
    from keypoints_interpolation_transformer_torch.ops import kernels
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g).to(cuda)
    N, D, F = 40, 128, 256
    x, u, z = r(2, N // 2, D), r(N, F), r(N, D)
    w1t, w2t, v = r(F, D), r(D, F), r(D)
    args = (r(2, N // 2, D), x, u, z, w1t, w2t, v, v, v, True)
    with pytest.raises(TypeError):
        kernels.ffn_bwd(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="is on"):
        kernels.ffn_bwd(*args[:2], u.cpu(), *args[3:])
    with pytest.raises(ValueError, match="shape"):
        kernels.ffn_bwd(*args[:2], u[:, :F - 4].contiguous(), *args[3:])
    with pytest.raises(ValueError, match="16-byte"):
        kernels.ffn_bwd(*args[:4], torch.zeros(F * D + 1, device=cuda)[1:]
                        .view(F, D), *args[5:])
    B, T, H = 2, 20, 4
    mask, valid = torch.zeros(B, T, device=cuda), torch.ones(B, T,
                                                             device=cuda)
    xa = r(B, T, D)
    _, qkv, a, stats, _ = kernels.attn_sublayer_train_plain(
        xa, None, r(D, 3 * D), r(3 * D), r(D, D), r(D), None, None, mask,
        valid, "repeat-inc", True, H)
    bargs = [r(B, T, D), xa, None, qkv.contiguous(), a.contiguous(),
             stats.contiguous(), None, r(3 * D, D), r(D, D), None, mask,
             valid, "repeat-inc", True, H]
    with pytest.raises(TypeError):
        kernels.attn_sublayer_bwd(bargs[0].double(), *bargs[1:])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.attn_sublayer_bwd(*bargs[:3], qkv.transpose(0, 1)
                                  .contiguous().transpose(0, 1), *bargs[4:])
    with pytest.raises(ValueError, match="head width"):
        kernels.attn_sublayer_bwd(*bargs[:-1], 3)
    kernels.reset_launches()
    kernels.ffn_bwd(*args)
    kernels.attn_sublayer_bwd(*bargs)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["ffn_bwd"] == 1 and counts["attn_sublayer_bwd"] == 1


@pytest.mark.gpu
def test_forwards_match_plain_at_every_batch(cuda):
    """``ffn``, ``ffn_train``, ``attn_sublayer`` and
    ``attn_sublayer_train`` against their plain versions at one 128-frame
    video and the 600-frame request's bucket (the FF split, the narrow
    projections), B=3 and B=40 at T = 128 (the row-tile builds from 5120
    rows), with every variant, at the flagship widths and at D = 128 and
    512."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d, heads in ((256, 8), (128, 8), (512, 8)):
        chk = chip_smoke.KernelCheck(torch, kernels, d, heads, 4 * d)
        for B, T in ((1, 128), (1, 608), (3, 128), (40, 128)):
            for name, variant, kern, plain in chk.forward_calls(B, T, True):
                chk.compare(name, f"D={d} B={B} T={T} {variant}", kern(),
                            plain())


@pytest.mark.gpu
def test_sublayer_forward_takes_the_per_op_core(cuda):
    """The training sublayer forward's attention output and statistics
    equal, bit for bit, the per-op ``fused_attention(..., stats=True)`` on
    its own q, k, v: both run ``csrc/attention_fwd.cuh``'s core (head
    widths 32, 16, 64 and 48, the last on ``attention.cuh``'s), so the
    backward rebuilds p from the score the forward used."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d, heads, T in ((256, 8, 300), (256, 16, 128), (256, 4, 40),
                        (96, 2, 129)):
        chk = chip_smoke.KernelCheck(torch, kernels, d, heads, 4 * d)
        o, (mask, valid) = chk.operands(3, T), chk.masks(3, T)
        valid[2] = 0.0
        for variant, mem, ln, kind, keypad in chip_smoke.ATTN_VARIANTS:
            mem = o["mem"] if mem else None
            ln = (o["g"], o["be"]) if ln else (None, None)
            _, qkv, a, stats, _, _ = kernels.fused_attn_sublayer_train(
                o["x"], mem, o["wqkv"], o["bqkv"], o["wo"], o["bo"], *ln,
                mask, valid, kind, keypad, heads)
            q, k, v = (t.reshape(3, T, heads, d // heads).contiguous()
                       for t in qkv.split(d, -1))
            out, pstats = kernels.fused_attention(q, k, v, mask, valid, kind,
                                                  keypad, stats=True)
            torch.cuda.synchronize()
            assert torch.equal(out.reshape(3, T, d), a), (d, heads, variant)
            assert torch.equal(pstats, stats), (d, heads, variant)


@pytest.mark.gpu
def test_forwards_are_deterministic(cuda):
    """The same inputs twice give the same bits, on the FF split too (its
    parts added in a fixed order by the second pass, no atomics)."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.ops.kernels.ffn import (
        ff_parts)
    assert ff_parts(128, 256, 2048) > 1 and ff_parts(608, 256, 2048) > 1
    chk = chip_smoke.KernelCheck(torch, kernels)
    for B, T in ((1, 128), (1, 608), (64, 128)):
        for name, variant, kern, _ in chk.forward_calls(B, T, True):
            first, second = kern(), kern()
            torch.cuda.synchronize()
            first = first if isinstance(first, tuple) else (first,)
            second = second if isinstance(second, tuple) else (second,)
            for a, b in zip(first, second):
                assert (a is None) == (b is None)
                assert a is None or torch.equal(a, b), (name, variant, B, T)


@pytest.mark.gpu
def test_mode_kernels_match_plain_at_every_width(cuda):
    """The tensor-core FF forward (``ffn`` and ``ffn_train`` in "high" and
    "default") and the split backward against their plain versions in the
    same mode at D = 128, 256, 384 and 512 (384 and 512: the groups split
    z's columns), at ragged rows (B=3 at T=40 and 300), at one 128-frame
    video and the 600-frame request's 608 rows (the FF split over parts),
    and at D = 256 at the training and serving batches: each output within
    ``FF_MODE_TOL`` of its own largest value, "default"'s mean within
    ``DEFAULT_MEAN_TOL``, and ``MODE_SEPARATION`` times nearer its own
    mode's plain version than the wrong mode's."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d in (128, 256, 384, 512):
        chk = chip_smoke.KernelCheck(torch, kernels, d, max(1, d // 32),
                                     8 * d)
        shapes = [(3, 3, 40), (3, 3, 300), (1, 1, 128), (1, 1, 608)]
        if d == 256:
            shapes += [(chip_smoke.B_MAIN, chip_smoke.B_TRAIN, 128)]
        for B, b_train, T in shapes:
            for name, variant, kern, plain, grad, wrong in \
                    chk.precision_calls(B, b_train, T):
                if name == "pre_stream":
                    continue
                chk.compare(name, f"D={d} B={B} T={T} {variant}", kern(),
                            plain(), grad, wrong())


@pytest.mark.gpu
def test_mode_kernels_at_ragged_widths(cuda):
    """The mode kernels where the last FF chunk is partial (FF 1000 and
    200, zero-padded to 1008 and 208: no multiple of the 64-wide chunk)
    and where the model width pads to the kernel width (200 -> 256), also
    at D = 512 (the groups splitting z's columns); ragged rows and one
    video; the limits of the test above."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d, ff in ((200, 1000), (256, 1000), (512, 200)):
        chk = chip_smoke.KernelCheck(torch, kernels, d, 8, ff)
        for B, b_train, T in ((3, 3, 40), (1, 1, 128)):
            for name, variant, kern, plain, grad, wrong in \
                    chk.precision_calls(B, b_train, T):
                if name == "pre_stream":
                    continue
                chk.compare(name, f"D={d} FF={ff} B={B} T={T} {variant}",
                            kern(), plain(), grad, wrong())


@pytest.mark.gpu
def test_split_backward_is_deterministic(cuda):
    """``ffn_bwd_split`` in both modes twice on the same inputs gives the
    same bits: the weight gradients' row ranges are added in a fixed order,
    with no atomics."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels)
    for B, T in ((chip_smoke.B_TRAIN, 128), (3, 300)):
        for name, variant, kern, *_ in chk.precision_calls(B, B, T):
            if not name.startswith("ffn_bwd_split"):
                continue
            first, second = kern(), kern()
            torch.cuda.synchronize()
            for a, b in zip(first, second):
                assert (a is None and b is None) or torch.equal(a, b), \
                    (name, variant, B, T)


@pytest.mark.gpu
def test_ffn_function_backward_reads_the_forward_planes(cuda, monkeypatch):
    """A "high" ``FFNFunction`` step splits the weights once: its backward
    takes the planes its forward split and gives, bit for bit, the
    gradients of ``ffn_bwd_split`` splitting them itself from the same
    residuals (the same planes, read in the same order of sums)."""
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.ops.kernels import ffn
    gen = torch.Generator().manual_seed(5)
    N, D, FF = 8 * 128, 256, 2048
    rnd = lambda *s, scale=1.0: (torch.randn(  # noqa: E731
        *s, generator=gen) * scale).to(cuda)
    r = rnd(N, D)
    w1t, w2t = rnd(FF, D, scale=D ** -0.5), rnd(D, FF, scale=FF ** -0.5)
    b1, b2 = rnd(FF, scale=0.05), rnd(D, scale=0.05)
    g1, be1, g2, be2 = (1 + rnd(D, scale=0.1), rnd(D, scale=0.1),
                        1 + rnd(D, scale=0.1), rnd(D, scale=0.1))
    gy = rnd(N, D)
    leaves = [t.clone().requires_grad_() for t in (r, w1t, b1, w2t, b2, g1,
                                                    be1, g2, be2)]
    splits = []
    real = ffn.ff_weight_planes
    monkeypatch.setattr(ffn, "ff_weight_planes",
                        lambda *a: splits.append(a[-1]) or real(*a))
    kernels.reset_launches()
    y = ffn.FFNFunction.apply(*leaves, True, "bf16x3")
    y.backward(gy)
    torch.cuda.synchronize()
    assert splits == ["bf16x3"]
    counts = kernels.launch_counts()
    assert counts["ffn_train_high"] == 1 and counts["ffn_bwd_split_high"] == 1
    planes = real(w1t, w2t, "bf16x3")
    _, u, z = kernels.fused_ffn_train(r, w1t.t(), b1, w2t.t(), b2, g1, be1,
                                      g2, be2, True, "bf16x3", planes)
    want = kernels.ffn_bwd_split(gy, r, u, z, w1t, w2t, g1, be1, g2, True,
                                 "bf16x3")
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.gpu
def test_layer_mode_kernels_match_plain_at_every_width(cuda):
    """The merged layers' mode kernels (``enc_layer`` / ``dec_layer`` in
    "high" and "default") against their plain versions in the same mode at
    D = 128, 256, 384 and 512 (head width 32), at T 40, 128 and 256 (the
    merged encoder's cap), with both models' masks and the decoder with and
    without its FF tail, and the decoder without it at T = 512 (its cap):
    ``LAYER_MODE_TOL`` and the mean ``MODE_SEPARATION`` times nearer its own
    mode's plain version than the wrong mode's."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d in (128, 256, 384, 512):
        chk = chip_smoke.KernelCheck(torch, kernels, d, d // 32, 4 * d)
        for B, T in ((3, 40), (3, 128), (2, 256)):
            for name, variant, kern, plain, grad, wrong in \
                    chk.layer_mode_calls(chk.operands(B, T), *chk.masks(B, T)):
                chk.compare(name, f"D={d} B={B} T={T} {variant}", kern(),
                            plain(), grad, wrong())
        for name, variant, kern, plain, grad, wrong in chk.layer_mode_calls(
                chk.operands(1, 512), *chk.masks(1, 512), encoder=False,
                tails=(False,)):
            chk.compare(name, f"D={d} B=1 T=512 {variant}", kern(), plain(),
                        grad, wrong())


@pytest.mark.gpu
def test_layer_mode_kernels_ignore_the_cluster(cuda):
    """The mode kernels take no thread-block cluster (their launches' grids
    spread a video themselves): every cluster size 1 to 8 gives the same
    bits, and the wrapper still refuses a size above 8."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels)
    o, (mask, valid) = chk.operands(2, 128), chk.masks(2, 128)
    calls = chk.layer_mode_calls(o, mask, valid)
    first = [kern() for _, _, kern, *_ in calls]
    for cl in range(1, 9):
        for (name, variant, *_), want in zip(calls, first):
            args = chk.layer_mode_args[(name, variant)]
            fn = kernels.fused_encoder_layer if name.startswith("enc") else \
                kernels.fused_decoder_layer
            got = fn(*args[0], cluster=cl, **args[1])
            assert torch.equal(got, want), (name, variant, cl)
    name, variant, *_ = calls[0]
    args = chk.layer_mode_args[(name, variant)]
    with pytest.raises(ValueError):
        kernels.fused_encoder_layer(*args[0], cluster=9, **args[1])


@pytest.mark.gpu
def test_layer_mode_wrappers_raise_rather_than_fall_back(cuda):
    """Planes of the wrong type, shape or mode and weights off the card
    raise; nothing runs another route in their place."""
    from keypoints_interpolation_transformer_torch.ops import kernels
    B, T, D, FF, H = 2, 16, 128, 256, 4
    z = lambda *s: torch.zeros(*s, device=cuda)  # noqa: E731
    attn = (z(D, 3 * D), z(3 * D), z(D, D), z(D))
    ff = (z(D, FF), z(FF), z(FF, D), z(D), z(D) + 1, z(D), z(D) + 1, z(D))
    x = z(B, T, D)
    ap = kernels.attn_weight_planes(*attn[:3], H, "bf16x3")
    fp = kernels.ff_weight_planes(ff[0].t(), ff[2].t(), "bf16x3")
    with pytest.raises(ValueError):  # "high" without the lo planes
        kernels.fused_encoder_layer(x, *attn, *ff, None, None, "all", False,
                                    H, mode="bf16x3",
                                    planes=((*ap[:1], None, *ap[2:]), fp))
    with pytest.raises(ValueError):  # float32 planes
        kernels.fused_encoder_layer(
            x, *attn, *ff, None, None, "all", False, H, mode="bf16x3",
            planes=(tuple(None if t is None else t.float() for t in ap), fp))
    with pytest.raises(ValueError):  # planes of another width
        kernels.fused_encoder_layer(
            x, *attn, *ff, None, None, "all", False, H, mode="bf16",
            planes=(kernels.attn_weight_planes(z(2 * D, 6 * D), z(6 * D),
                                               z(2 * D, 2 * D), H, "bf16"),
                    kernels.ff_weight_planes(ff[0].t(), ff[2].t(), "bf16")))
    with pytest.raises(ValueError):  # weights left on the CPU
        kernels.fused_decoder_layer(x, x, *attn, *(t.cpu() for t in attn),
                                    z(D), z(D), None, None, None, None, None,
                                    "all", False, "all", False, H,
                                    mode="bf16")
    with pytest.raises(ValueError):  # an unknown mode
        kernels.fused_encoder_layer(x, *attn, *ff, None, None, "all", False,
                                    H, mode="tf32")
    kernels.reset_launches()
    kernels.fused_encoder_layer(x, *attn, *ff, None, None, "all", False, H,
                                mode="bf16x3", planes=(ap, fp))
    kernels.fused_decoder_layer(x, x, *attn, *attn, z(D), z(D), None, None,
                                None, None, None, "all", False, "all",
                                False, H, mode="bf16")
    counts = kernels.launch_counts()
    assert (counts["enc_layer_high"], counts["dec_layer_default"],
            counts["enc_layer"], counts["dec_layer"]) == (1, 1, 0, 0)


@pytest.mark.gpu
def test_flagship_forward_at_high_launches_the_mode_layers(cuda):
    """One flagship forward (6 + 6 layers, D=256, FF=2048) at T=128 at
    "high" and "default": the merged route launches the mode's
    pre_stream_embed 2, enc_layer 6, dec_layer 6 and post_head 1 and no
    float32 layer or chain, and agrees with the plain path in the same
    mode: at "high" within SERVE_TOL; at "default" (whose bf16 flips
    cascade through the chains and the layers) within MODE_DRIFT times the
    plain path's own spread over float32 summation orders (the plain path
    on the CPU against it on the card, as ``chip_smoke.order_drift``), and
    as far from the plain path at "highest" as the plain path in the mode
    within MODE_SEPARATION either way (a float32 or "high" route lies
    about 0 from it); the mean keypoint distance over every frame."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.models.completer import (
        KeypointCompleter)
    from keypoints_interpolation_transformer_torch.ops import kernels
    B, T = 2, 128
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0.2, 0.8, (B, T, 54, 2)).astype(
        np.float32)).to(cuda)
    m = torch.from_numpy((rng.random((B, T)) < 0.3).astype(np.float32)).to(
        cuda)
    valid = torch.ones(B, T, device=cuda)
    args = (x, x, m, m, valid)

    def flagship(prec, device):
        return KeypointCompleter(256, 6, 8, ff_dim=2048, device=device,
                                 precision=prec,
                                 generator=torch.Generator().manual_seed(0))

    def dist(a, b):
        return float((a - b).norm(dim=-1).mean())

    top = flagship("highest", cuda)
    with torch.inference_mode():
        highest = top(*args, plain=True)
    for prec in ("high", "default"):
        model, on_cpu = flagship(prec, cuda), flagship(prec, "cpu")
        on_cpu.load_state_dict(model.state_dict())
        model.pack_weights()
        with torch.inference_mode():
            want = model(*args, plain=True)
            kernels.reset_launches()
            got = model(*args)
            torch.cuda.synchronize()
            assert kernels.launch_counts() == \
                chip_smoke.merged_mode_counts(prec)
            if prec == "high":
                torch.testing.assert_close(got, want,
                                           atol=chip_smoke.SERVE_TOL, rtol=0)
                continue
            other = on_cpu(*(t.cpu() for t in args), plain=True).to(cuda)
        drift = dist(other, want)
        assert dist(got, want) < chip_smoke.MODE_DRIFT * drift, (
            dist(got, want), drift)
        own, pown = dist(got, highest), dist(want, highest)
        sep = chip_smoke.MODE_SEPARATION
        assert pown < own * sep and own < pown * sep, (own, pown)


@pytest.mark.gpu
def test_sublayer_mode_kernels_match_plain_at_every_width(cuda):
    """The attention sublayer's mode kernels (``fused_attn_sublayer``,
    ``fused_attn_sublayer_train`` and ``attn_sublayer_bwd`` in "high" and
    "default") against their plain versions in the same mode, the model's
    three sublayers, at D 32 (padded to 128), 128, 384 and 512 with head
    widths 8 to 512, ragged and long lengths (T 40, 300, 512, a training
    video whose keys are all padded), and at one 128-frame video: each
    output within ``LAYER_MODE_TOL`` of its own largest value (the training
    forward's raw a within ``RAW_A_TOL``), the mean at
    "high" within ``LAYER_HIGH_MEAN_TOL``, and the mean
    ``MODE_SEPARATION`` times nearer its own mode's plain version than the
    wrong mode's."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d, heads in ((256, 8), (32, 4), (128, 2), (384, 6), (512, 1)):
        chk = chip_smoke.KernelCheck(torch, kernels, d, heads, 4 * d)
        shapes = [(3, 3, 40), (1, 1, 128)]
        if d == 256:
            shapes += [(3, 3, 300), (3, 3, 512)]
        for B, b_train, T in shapes:
            for name, variant, kern, plain, grad, wrong in \
                    chk.sublayer_mode_calls(B, b_train, T, blocked=True):
                chk.compare(name, f"D={d} H={heads} B={B} T={T} {variant}",
                            kern(), plain(), grad, wrong())


@pytest.mark.gpu
def test_sublayer_mode_kernels_are_deterministic(cuda):
    """The training forward and the backward in both modes twice on the
    same inputs give the same bits: no atomics, every sum in a fixed
    order."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels)
    for name, variant, kern, *_ in chk.sublayer_mode_calls(
            3, chip_smoke.B_TRAIN, 128):
        if name.startswith(("attn_sublayer_train", "attn_sublayer_bwd")):
            first, second = kern(), kern()
            torch.cuda.synchronize()
            for a, b in zip(first, second):
                assert (a is None and b is None) or torch.equal(a, b), \
                    (name, variant)


@pytest.mark.gpu
def test_attn_sublayer_function_reads_the_forward_planes(cuda, monkeypatch):
    """A "high" ``AttnSublayerFunction`` step splits the weights once: its
    backward takes the planes its forward split and gives, bit for bit, the
    gradients of ``attn_sublayer_bwd`` given planes split anew from the same
    weights and the same residuals; one launch of each mode kernel, none of
    the float32 ones."""
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.ops.kernels import (
        attn_sublayer)
    gen = torch.Generator().manual_seed(6)
    B, T, D, H = 8, 128, 256, 8
    rnd = lambda *s, scale=1.0: (torch.randn(  # noqa: E731
        *s, generator=gen) * scale).to(cuda)
    x = rnd(B, T, D)
    w_in, w_out = rnd(3 * D, D, scale=D ** -0.5), rnd(D, D, scale=D ** -0.5)
    b_in, b_out = rnd(3 * D, scale=0.05), rnd(D, scale=0.05)
    g, be = 1 + rnd(D, scale=0.1), rnd(D, scale=0.1)
    mask = (torch.rand(B, T, generator=gen) < 0.3).float().to(cuda)
    valid = torch.ones(B, T, device=cuda)
    valid[1, T - 20:] = 0.0
    gy = rnd(B, T, D)
    leaves = [t.clone().requires_grad_() for t in (x, w_in, b_in, w_out,
                                                    b_out, g, be)]
    splits = []
    real = attn_sublayer.attn_train_planes
    monkeypatch.setattr(attn_sublayer, "attn_train_planes",
                        lambda *a: splits.append(a[-1]) or real(*a))
    kernels.reset_launches()
    y = attn_sublayer.AttnSublayerFunction.apply(
        leaves[0], None, *leaves[1:], mask, valid, "repeat-inc", False, H,
        "bf16x3")
    y.backward(gy)
    torch.cuda.synchronize()
    assert splits == ["bf16x3"]
    counts = kernels.launch_counts()
    assert (counts["attn_sublayer_train_high"], counts["attn_sublayer_bwd_high"],
            counts["attn_sublayer_train"], counts["attn_sublayer_bwd"]) == \
        (1, 1, 0, 0)
    _, qkv, a, stats, r, acts = kernels.fused_attn_sublayer_train(
        x, None, w_in.t(), b_in, w_out.t(), b_out, g, be, mask, valid,
        "repeat-inc", False, H, "bf16x3", real(w_in, w_out, "bf16x3"))
    want = kernels.attn_sublayer_bwd(gy, x, None, qkv, a, stats, r, w_in,
                                     w_out, g, mask, valid, "repeat-inc",
                                     False, H, "bf16x3",
                                     real(w_in, w_out, "bf16x3"), acts)
    got = [leaves[0].grad, None, *(t.grad for t in leaves[1:])]
    for grad, w in zip(got, want):
        assert (grad is None and w is None) or torch.equal(grad, w)


@pytest.mark.gpu
def test_sublayer_mode_wrappers_raise_rather_than_fall_back(cuda):
    """The mode wrappers check their planes (given on the card to the
    training forward and the backward; dtype, shape, the lo planes the mode
    takes) and raise; they count only the calls that launched."""
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.ops.kernels.attn_sublayer \
        import attn_train_planes, attn_weight_planes
    B, T, D, H = 2, 40, 128, 4
    x = torch.randn(B, T, D, device=cuda)
    wqkv, bqkv = torch.randn(D, 3 * D, device=cuda), torch.zeros(3 * D,
                                                                 device=cuda)
    wo, bo = torch.randn(D, D, device=cuda), torch.zeros(D, device=cuda)
    args = (x, None, wqkv, bqkv, wo, bo, None, None, None, None, "all",
            False, H)
    sp = attn_weight_planes(wqkv, bqkv, wo, H, "bf16x3")
    tp = attn_train_planes(wqkv.t(), wo.t(), "bf16x3")
    with pytest.raises(ValueError):  # "default" takes no lo planes
        kernels.fused_attn_sublayer(*args, "bf16", sp)
    with pytest.raises(ValueError):  # float32 planes
        kernels.fused_attn_sublayer_train(*args, "bf16x3",
                                          tuple(p.float() for p in tp))
    with pytest.raises(ValueError):  # the serving planes in training
        kernels.fused_attn_sublayer_train(*args, "bf16x3", sp)
    with pytest.raises(ValueError):  # no planes in training
        kernels.fused_attn_sublayer_train(*args, "bf16", None)
    kernels.reset_launches()
    kernels.fused_attn_sublayer(*args, "bf16x3", sp)
    dp = attn_train_planes(wqkv.t(), wo.t(), "bf16")
    y, qkv, a, stats, r, acts = kernels.fused_attn_sublayer_train(
        *args, "bf16", dp)
    bargs = (x, x, None, qkv, a, stats, r, wqkv.t().contiguous(),
             wo.t().contiguous(), None, None, None, "all", False, H, "bf16")
    with pytest.raises(ValueError):  # no planes in the backward
        kernels.attn_sublayer_bwd(*bargs)
    with pytest.raises(ValueError):  # no planes of x and a
        kernels.attn_sublayer_bwd(*bargs, dp)
    with pytest.raises(ValueError):  # the planes of another mode
        kernels.attn_sublayer_bwd(*bargs, dp, torch.cat([acts, acts]))
    kernels.attn_sublayer_bwd(*bargs, dp, acts)
    counts = kernels.launch_counts()
    assert (counts["attn_sublayer_high"], counts["attn_sublayer_train_default"],
            counts["attn_sublayer_bwd_default"], counts["attn_sublayer"]) == \
        (1, 1, 1, 0)


@pytest.mark.gpu
def test_a1_step_at_high_launches_the_sublayer_mode_kernels(cuda):
    """A two-layer A1 step at "high" and at "default" runs every attention
    sublayer through the mode's training forward and backward (6 each: 2
    encoder, 4 decoder sublayers) and no float32 sublayer kernel, and
    agrees with the plain route in the same mode."""
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.train import state, steps
    from keypoints_interpolation_transformer_torch.utils.config import (
        Config, ModelConfig)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0.2, 0.8, (4, 128, 54, 2)).astype(
        np.float32)).to(cuda)
    length = torch.tensor([128, 97, 128, 60], device=cuda)
    for prec, tag in (("high", "_high"), ("default", "_default")):
        cfg = Config(model=ModelConfig(hidden_dim=128, num_heads=4,
                                       num_layers=2, ff_dim=512,
                                       matmul_precision=prec))
        losses = {}
        for plain in (True, False):
            net = steps.build_model(cfg.model, for_training=True,
                                    device=cuda,
                                    generator=torch.Generator().manual_seed(0))
            kernels.reset_launches()
            _, m = steps.make_train_step(net, cfg, None, plain=plain)(
                state.TrainState.create(net, 1e-3), x, length,
                torch.ones(4, device=cuda),
                torch.Generator(device=cuda).manual_seed(1), 1e-3)
            torch.cuda.synchronize()
            losses[plain] = float(m["loss"])
            counts = kernels.launch_counts()
            if plain:
                assert not any(counts.values()), counts
            else:
                assert counts[f"attn_sublayer_train{tag}"] == 6
                assert counts[f"attn_sublayer_bwd{tag}"] == 6
                assert counts["attn_sublayer_train"] == \
                    counts["attn_sublayer_bwd"] == 0
        assert abs(losses[False] - losses[True]) <= 1e-4 * abs(losses[True])


@pytest.mark.gpu
def test_per_op_mode_pair_matches_plain_at_every_width(cuda):
    """The per-op attention pair in "high" and "default" (``fused_attention``
    and ``attention_bwd`` with ``mode``) against their plain versions in
    the same mode, the model's four mask kinds, a video whose keys are all
    padded, at head widths 8 to 512 and lengths 40 to 608: held as
    ``chip_smoke.py``'s phase 2 holds them (LAYER_MODE_TOL for the
    forward, OP_MODE_TOL for the backward, and nearer its own mode than
    one mode down)."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d, heads, shapes in ((256, 8, ((3, 40), (3, 128), (1, 608))),
                             (32, 4, ((3, 40),)), (384, 6, ((3, 100),)),
                             (512, 1, ((2, 40),)), (96, 4, ((3, 37),))):
        chk = chip_smoke.KernelCheck(torch, kernels, d, heads, 4 * d)
        for B, T in shapes:
            for name, variant, kern, plain, grad, wrong in \
                    chk.op_mode_calls(B, T):
                chk.compare(name, f"D={d} H={heads} B={B} T={T} {variant}",
                            kern(), plain(), grad, wrong())


@pytest.mark.gpu
def test_chain_mode_kernels_match_plain_at_every_width(cuda):
    """The pointwise chains in "high" and "default" against their plain
    versions in the same mode at the four kernel widths, a ragged batch of
    one 608-frame video and a short one, with and without the Cycle
    residual and the embedding out."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d in (128, 256, 384, 512):
        chk = chip_smoke.KernelCheck(torch, kernels, d, 8 if d < 384 else 4,
                                     4 * d)
        for B, T in ((3, 40), (1, 608)):
            for name, variant, kern, plain, grad, wrong in \
                    chk.chain_mode_calls(B, T):
                chk.compare(name, f"D={d} B={B} T={T} {variant}", kern(),
                            plain(), grad, wrong())


@pytest.mark.gpu
def test_per_op_mode_pair_is_deterministic(cuda):
    """Both modes' forward and backward twice on the same inputs give the
    same bits: no atomics, every sum in a fixed order."""
    from keypoints_interpolation_transformer_torch.ops import kernels
    g = torch.Generator().manual_seed(5)
    q, k, v, dy = (torch.randn(4, 200, 8, 32, generator=g).to(cuda)
                   for _ in range(4))
    mask = (torch.rand(4, 200, generator=g) < 0.3).float().to(cuda)
    valid = torch.ones(4, 200, device=cuda)
    valid[1, 150:] = 0.0
    for mode in ("bf16x3", "bf16"):
        outs = [(kernels.fused_attention(q, k, v, mask, valid, mode=mode),
                 *kernels.attention_bwd(q, k, v, dy, mask, valid,
                                        mode=mode)) for _ in range(2)]
        for a, b in zip(*outs):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_mode_pair_and_chain_wrappers_raise_rather_than_fall_back(cuda):
    """The new mode wrappers on the card take no residuals in a mode,
    demand and check their planes, and count the launches they make."""
    from keypoints_interpolation_transformer_torch.ops import kernels
    q = torch.randn(2, 16, 4, 8, device=cuda)
    m, valid = torch.zeros(2, 16, device=cuda), torch.ones(2, 16,
                                                          device=cuda)
    out, st = kernels.fused_attention(q, q, q, m, valid, stats=True)
    with pytest.raises(ValueError, match="no out or stats"):
        kernels.attention_bwd(q, q, q, q, m, valid, "repeat-inc", False, out,
                              st, mode="bf16x3")
    with pytest.raises(TypeError):
        kernels.fused_attention(q.double(), q, q, m, valid, mode="bf16")
    D, F = 128, 108
    x = torch.rand(1, 8, F, device=cuda)
    w12, w3 = torch.randn(D, 2 * D, device=cuda), torch.randn(D, D,
                                                              device=cuda)
    wemb = torch.randn(F, D, device=cuda)
    b = torch.zeros(2 * D, device=cuda)
    args = (x, wemb, b[:D].clone(), torch.zeros(8, D, device=cuda), w12, b,
            w3, b[:D].clone())
    planes = kernels.chain_planes(w12, w3, "bf16", wemb=wemb)
    with pytest.raises(ValueError, match="takes the weights' planes"):
        kernels.fused_pre_stream_embed(*args, mode="bf16")
    with pytest.raises(ValueError, match="does not fit mode"):
        kernels.fused_pre_stream_embed(*args, mode="bf16x3", planes=planes)
    kernels.reset_launches()
    kernels.fused_pre_stream_embed(*args, mode="bf16", planes=planes)
    kernels.fused_attention(q, q, q, m, valid, mode="bf16x3")
    counts = kernels.launch_counts()
    assert (counts["pre_stream_embed_default"], counts["attention_high"],
            counts["pre_stream_embed"], counts["attention"]) == (1, 1, 0, 0)


@pytest.mark.gpu
def test_per_op_a1_step_in_a_mode_launches_the_mode_pair(cuda):
    """A two-layer A1 step with sublayer fusion off at "high" and at
    "default" runs every attention core through the mode's pair (6 each: 2
    encoder, 4 decoder) and no float32 attention kernel, its Dense products
    through ``mode_linear`` and its backward (the chains' 9, the
    projections' 7 a layer pair), and agrees with the plain route in the
    same mode."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.train import state, steps
    from keypoints_interpolation_transformer_torch.utils.config import (
        Config, ModelConfig)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0.2, 0.8, (4, 128, 54, 2)).astype(
        np.float32)).to(cuda)
    length = torch.tensor([128, 97, 128, 60], device=cuda)
    for prec, tag in (("high", "_high"), ("default", "_default")):
        cfg = Config(model=ModelConfig(hidden_dim=128, num_heads=4,
                                       num_layers=2, ff_dim=512,
                                       attn_sublayer_fusion="off",
                                       matmul_precision=prec))
        losses = {}
        for plain in (True, False):
            net = steps.build_model(cfg.model, for_training=True,
                                    device=cuda,
                                    generator=torch.Generator().manual_seed(0))
            kernels.reset_launches()
            _, m = steps.make_train_step(net, cfg, None, plain=plain)(
                state.TrainState.create(net, 1e-3), x, length,
                torch.ones(4, device=cuda),
                torch.Generator(device=cuda).manual_seed(1), 1e-3)
            torch.cuda.synchronize()
            losses[plain] = float(m["loss"])
            counts = kernels.launch_counts()
            if plain:
                assert not any(counts.values()), counts
            else:
                assert counts[f"attention{tag}"] == 6
                assert counts[f"attention_bwd{tag}"] == 6
                assert counts["attention"] == counts["attention_bwd"] == 0
                # the chains' and the projections' Dense products
                dense = chip_smoke.CHAIN_DENSE + chip_smoke.PER_OP_DENSE * 2
                assert counts[f"mode_linear{tag}"] == dense
                assert counts[f"mode_linear_bwd{tag}"] == dense
        assert abs(losses[False] - losses[True]) <= 1e-4 * abs(losses[True])


@pytest.mark.gpu
def test_mode_linear_matches_plain_on_the_card(cuda):
    """``mode_linear`` and its backward in "high" and "default" against
    their plain versions at a q / k / v projection, the 108-wide embedding
    and the head (chip_smoke's ``linear_mode_calls``: each output within
    its mode's limit of its own largest value, nearer its own mode than one
    mode down), at T 40 and 128; through autograd the Function's forward
    hands its planes to the backward, one launch each; a width that is no
    multiple of 4 raises."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels, 128, 4, 256)
    for T in (40, 128):
        for name, variant, kern, plain, grad, wrong in \
                chk.linear_mode_calls(3, T):
            chk.compare(name, f"T={T} {variant}", kern(), plain(), grad,
                        wrong())
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(3, 40, 108, device=cuda, generator=gen)
    w = torch.randn(108, 128, device=cuda, generator=gen).requires_grad_()
    b = torch.randn(128, device=cuda, generator=gen).requires_grad_()
    g = torch.randn(3, 40, 128, device=cuda, generator=gen)
    for mode in ("bf16x3", "bf16"):
        kernels.reset_launches()
        w.grad = b.grad = None
        kernels.mode_linear(x, w, b, mode).backward(g)
        counts = kernels.launch_counts()
        tag = "_high" if mode == "bf16x3" else "_default"
        assert counts[f"mode_linear{tag}"] == 1
        assert counts[f"mode_linear_bwd{tag}"] == 1
        _, dw, db = kernels.mode_linear_bwd_plain(g, x, w.detach(), mode)
        for got, want in ((w.grad, dw), (b.grad, db)):
            err = float((got - want).abs().max())
            assert err <= chip_smoke.OP_MODE_TOL[f"mode_linear_bwd{tag}"] \
                * float(want.abs().max())
    with pytest.raises(ValueError, match="multiples of 4"):
        kernels.mode_linear(torch.randn(2, 6, device=cuda),
                            torch.randn(6, 8, device=cuda), None, "bf16")


@pytest.mark.gpu
def test_int8_layer_mode_kernels_match_plain_on_the_card(cuda):
    """The int8 merged encoder layer in "high" and "default" against its
    plain version in the mode (chip_smoke's ``int8_layer_mode_calls``) at
    D 128 and 256, T 40 and 128, both models' masks; after the int8 FF
    sublayer has run in the same process (``ffn.cu``'s copy of the int8
    tail's kernel: each library sets its own copy's shared memory)."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    for d, heads in ((128, 4), (256, 8)):
        chk = chip_smoke.KernelCheck(torch, kernels, d, heads, 4 * d)
        for name, variant, kern, plain in chk.int8_calls(3, 40):
            if name == "ffn_int8":
                chk.compare(name, f"D={d} T=40 {variant}", kern(), plain())
        for T in (40, 128):
            for name, variant, kern, plain, grad, wrong in \
                    chk.int8_layer_mode_calls(chk.operands(3, T),
                                              *chk.masks(3, T)):
                chk.compare(name, f"D={d} T={T} {variant}", kern(), plain(),
                            grad, wrong())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_mode_linear_forward_is_one_launch_at_every_shape(cuda, mode):
    """``mode_linear``'s forward (x split in the kernel, W's planes kept)
    against its plain version at K 108 / 256 / 2048, N 108 / 256 / 768 and
    M 1, 7 and 300 (no multiple of 128), with and without a gradient
    wanted: one kernel launch a call (profiler), each output within its
    mode's limit and nearer its own mode than one mode down; under
    autograd the planes of x the kernel writes equal ``row_planes`` bit for
    bit and the backward's gradients equal ``mode_linear_bwd``'s from
    those planes."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.ops.kernels import linear
    chk = chip_smoke.KernelCheck(torch, kernels)
    tag = "_high" if mode == "bf16x3" else "_default"
    wrong = chip_smoke.WRONG_MODE[mode]
    calls = []
    for K in (108, 256, 2048):
        for N in (108, 256, 768):
            w, b = chk.weight(K, N), chk.rand(N, scale=0.05)
            for M in (1, 7, 300):
                x = chk.rand(M, K)
                v = f"M={M} K={K} N={N}"
                kernels.mode_linear(x, w, b, mode)  # W's planes split
                calls.append((x, w, b))
                y = kernels.mode_linear(x, w, b, mode)
                chk.compare(f"mode_linear{tag}", v, y,
                            kernels.mode_linear_plain(x, w, b, mode), False,
                            kernels.mode_linear_plain(x, w, b, wrong))
                xg = x.clone().requires_grad_()
                wg = w.clone().requires_grad_()
                kept = []
                real = linear._launch
                try:
                    linear._launch = lambda *a: kept.append(real(*a)) or \
                        kept[-1]
                    yg = kernels.mode_linear(xg, wg, b, mode)
                finally:
                    linear._launch = real
                g = chk.rand(M, N)
                yg.backward(g)
                assert torch.equal(yg.detach(), y), v
                xh, xl = kept[0][1]
                rh, rl = kernels.row_planes(x, mode)
                assert torch.equal(xh, rh) and (
                    (xl is None and rl is None) or torch.equal(xl, rl)), v
                dx, dw, _ = kernels.mode_linear_bwd(
                    g, x, w, mode, (kernels.row_planes(x, mode),
                                    kernels.weight_planes(w, mode)))
                assert torch.equal(xg.grad, dx) and torch.equal(wg.grad, dw)
    # warm calls: one kernel launch each (the counter), and no other device
    # work (the profiler: a trace that lost events, fewer than the calls
    # launched, is the profiler's and taken again)
    names = []
    for _ in range(3):
        torch.cuda.synchronize()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for x, w, b in calls:
                kernels.mode_linear(x, w, b, mode)
            torch.cuda.synchronize()
        assert kernels.launch_counts()[f"mode_linear{tag}"] == len(calls)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= len(calls):
            break
    assert len(names) == len(calls) and all(
        "mode_linear_kernel" in n for n in names), names


@pytest.mark.gpu
def test_mode_linear_weight_planes_follow_the_weights(cuda):
    """W's planes are split once per weight version on the card: a warm
    call splits nothing, an optimizer step and ``load_state_dict`` split
    again, and each output then matches the plain version of the new
    weights (a stale plane would be a silent wrong result)."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    torch.manual_seed(3)
    lin = torch.nn.Linear(256, 768, device=cuda)
    x = torch.randn(300, 256, device=cuda)
    chk = chip_smoke.KernelCheck(torch, kernels)
    for mode, tag in (("bf16x3", "_high"), ("bf16", "_default")):
        splits = kernels.weight_planes.splits
        opt = torch.optim.SGD(lin.parameters(), lr=0.5)

        def run(what, expect_split):
            before = splits[mode]
            y = kernels.mode_linear(x, lin.weight.t(), lin.bias, mode)
            assert splits[mode] == before + expect_split, what
            with torch.no_grad():
                want = kernels.mode_linear_plain(x, lin.weight.t(), lin.bias,
                                                 mode)
            chk.compare(f"mode_linear{tag}", what, y.detach(), want)

        run("first call", 1)
        run("warm call", 0)
        loss = kernels.mode_linear(x, lin.weight.t(), lin.bias, mode).sum()
        loss.backward()
        opt.step()
        opt.zero_grad()
        run("after an optimizer step", 1)
        run("warm again", 0)
        lin.load_state_dict({"weight": torch.randn(768, 256),
                             "bias": torch.randn(768)})
        run("after load_state_dict", 1)


@pytest.mark.gpu
def test_fused_sublayer_backward_matches_plain(cuda):
    """The attention sublayer's backward in "high" and "default" against
    its plain version in the mode (``_bwd_mode_plain``) and one mode down,
    self- and cross-attention, with and without the LayerNorm, given the
    forward's planes of x, the memory and a (the same bits as
    ``attn_sublayer_train``'s split), at T 40 and 128 (one tile of the
    fused core), 144 (two at "high", the last fused length there) and 240
    (two at "default", the last fused length there; the two-kernel core at
    "high"), 256 and 320 (the two-kernel core in both modes); the main
    path's T=128 with 32-wide heads on the fused core; the launches a call
    from the profiler: 7 for self-attention and 9 for cross-attention on
    the fused core."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.ops.kernels import (
        _build, attn_sublayer as tas)
    lib = _build.bind("attn_sublayer_modes", tas._MODE_SIGS)
    chk = chip_smoke.KernelCheck(torch, kernels)
    D, H = chk.d, chk.heads
    fused_at = {(T, p): bool(lib.kit_attn_bwd_fused(p, T, D // H))
                for T in (40, 128, 144, 240, 256, 320) for p in (3, 1)}
    assert fused_at == {(T, p): T <= (144 if p == 3 else 240)
                        for T, p in fused_at}, fused_at
    for T in (40, 128, 144, 240, 256, 320):
        o, (mask, valid) = chk.operands(3, T), chk.masks(3, T)
        dy = chk.rand(3, T, D)
        w_in, w_out = o["wqkv"].t().contiguous(), o["wo"].t().contiguous()
        for mode, tag in (("bf16x3", "_high"), ("bf16", "_default")):
            wrong = chip_smoke.WRONG_MODE[mode]
            tp = tas.attn_train_planes(w_in, w_out, mode)
            for cross in (False, True):
                for ln in (False, True):
                    mem = o["mem"] if cross else None
                    norm = (o["g"], o["be"]) if ln else (None, None)
                    fargs = (o["x"], mem, o["wqkv"], o["bqkv"], o["wo"],
                             o["bo"], *norm, mask, valid, "repeat-inc", True,
                             H)
                    y, qkv, a, stats, r, acts = \
                        kernels.fused_attn_sublayer_train(*fargs, mode, tp)
                    assert torch.equal(acts, tas.attn_act_planes(
                        o["x"], mem, a, mode))
                    v = f"T={T} cross={cross} ln={ln}"

                    def bargs(md, qkv=qkv, a=a, stats=stats, r=r, mem=mem,
                              g=norm[0]):
                        return (dy, o["x"], mem, qkv, a, stats, r, w_in,
                                w_out, g, mask, valid, "repeat-inc", True, H,
                                md)

                    got = kernels.attn_sublayer_bwd(*bargs(mode), tp, acts)
                    _, qw, aw, sw, rw = kernels.attn_sublayer_train_plain(
                        *fargs, wrong)
                    chk.compare(f"attn_sublayer_bwd{tag}", v, got,
                                kernels.attn_sublayer_bwd_plain(*bargs(mode)),
                                True, kernels.attn_sublayer_bwd_plain(
                                    *bargs(wrong, qw, aw, sw, rw)))
                    if fused_at[T, 3 if mode == "bf16x3" else 1]:
                        want = 9 if cross else 7
                        n = len(_device_launches(
                            lambda: kernels.attn_sublayer_bwd(
                                *bargs(mode), tp, acts), want))
                        assert n == want, (v, n)


def _device_launches(fn, least=1):
    """The kernels one call of ``fn`` launches (the profiler; a trace of
    fewer than ``least`` kernels, one that lost events, is taken again, up
    to five times)."""
    from torch.profiler import ProfilerActivity, profile
    names = []
    for _ in range(5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= least:
            break
    return names


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_sublayer_training_forward_takes_two_kernels(cuda, mode):
    """The attention sublayer's training forward in a mode where its
    two-kernel path takes the shape (kernel width 256, 32-wide heads, T <=
    128): self-attention in two launches, cross-attention in three, at T
    128 / 100 / 40 and a narrower model (n = 224, 7 heads); its outputs
    against the plain version by the mode rows' rule; its kept planes the
    same bits as ``attn_act_planes``; above T = 128 the five-launch path."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    from keypoints_interpolation_transformer_torch.ops.kernels import (
        attn_sublayer as tas)
    tag = "high" if mode == "bf16x3" else "default"
    for d, heads in ((256, 8), (224, 7)):
        chk = chip_smoke.KernelCheck(torch, kernels, d=d, heads=heads)
        for T, want_self in ((128, 2), (100, 2), (40, 2), (144, 5)):
            o, (mask, valid) = chk.operands(3, T), chk.masks(3, T)
            tp = tas.attn_train_planes(o["wqkv"].t().contiguous(),
                                       o["wo"].t().contiguous(), mode)
            for cross in (False, True):
                mem = o["mem"] if cross else None
                args = (o["x"], mem, o["wqkv"], o["bqkv"], o["wo"], o["bo"],
                        o["g"], o["be"], mask, valid,
                        "all" if cross else "repeat-inc", not cross, heads)
                out = kernels.fused_attn_sublayer_train(*args, mode, tp)
                chk.compare(f"attn_sublayer_train_{tag}",
                            f"n={d} T={T} cross={cross}", out[:5],
                            kernels.attn_sublayer_train_plain(*args, mode),
                            False, kernels.attn_sublayer_train_plain(
                                *args, chip_smoke.WRONG_MODE[mode]))
                assert torch.equal(out[5], tas.attn_act_planes(
                    o["x"], mem, out[2], mode)), (d, T, cross)
                if d == 256:
                    fused = tas.mode_forward_fused(mode, T, d, d // heads)
                    assert fused == (want_self == 2)
                    # a memory adds its k / v projection on the two-kernel
                    # path, its split and projection on the five-launch one
                    want = want_self + ((1 if fused else 2) if cross else 0)
                    names = _device_launches(
                        lambda: kernels.fused_attn_sublayer_train(
                            *args, mode, tp), want)
                    assert len(names) == want, (T, cross, names)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_mode_linear_backward_is_two_launches(cuda, mode):
    """``mode_linear_bwd`` at the A1 step's products (M = 8192: a q / k / v
    projection, the 108-wide embedding and head), at M = 300 (no multiple
    of 128) and M = 40 (one row range): dx, dW and db against the plain
    version in the mode's limits and nearer it than one mode down, the
    same bits on two runs, two launches (one without dW and db), no
    memset."""
    import chip_smoke
    from keypoints_interpolation_transformer_torch.ops import kernels
    chk = chip_smoke.KernelCheck(torch, kernels)
    tag = "_high" if mode == "bf16x3" else "_default"
    for M, K, N in ((8192, 256, 768), (8192, 108, 256), (8192, 256, 108),
                    (300, 256, 256), (40, 256, 768)):
        x, w, g = chk.rand(M, K), chk.weight(K, N), chk.rand(M, N)
        planes = (kernels.row_planes(x, mode), kernels.weight_planes(w, mode))
        got = kernels.mode_linear_bwd(g, x, w, mode, planes)
        chk.compare(f"mode_linear_bwd{tag}", f"M={M} K={K} N={N}", got,
                    kernels.mode_linear_bwd_plain(g, x, w, mode), True,
                    kernels.mode_linear_bwd_plain(
                        g, x, w, chip_smoke.WRONG_MODE[mode]))
        again = kernels.mode_linear_bwd(g, x, w, mode, planes)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        names = _device_launches(
            lambda: kernels.mode_linear_bwd(g, x, w, mode, planes), 2)
        assert len(names) == 2 and "mode_linear_kernel" in names[0] and \
            "tc_gemm_kernel" in names[1], names
        names = _device_launches(lambda: kernels.mode_linear_bwd(
            g, x, w, mode, planes, need_dw=False, need_db=False))
        assert len(names) == 1, names
    # W's planes must be weight_planes' on g's card
    with pytest.raises(ValueError, match="weight_planes"):
        kernels.mode_linear_bwd(g, x, w, mode, (
            planes[0], kernels.weight_planes(w.cpu(), mode)))

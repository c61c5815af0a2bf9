#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card
and hold every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # build, then a torch.profiler
                                       # breakdown of one train step

Phases (each prints its own lines; any failed check exits non-zero):
  1. device and build: the card's name and power limit, then the nvcc build
     of ``keypoints_interpolation_transformer_torch/csrc/*.cu``;
  2. kernels: every variant of both paths against its plain version at the
     flagship widths (D=256, 8 heads, FF=2048), B=3, T in {128, 40, 300}
     with a padded row; then at the shapes of the paths (serving B=256,
     training B=64, T=128), with CUDA-event times of kernel and plain
     version and the bound of each (the least time the card could take);
  3. model: the flagship KeypointCompleter (random weights from a seeded
     torch.Generator) at B=256, T=128, kernel path against plain path by
     the bench's rule (masked-frame MPJPE delta < 1e-4), and the launch
     counts of one forward (2 / 18 / 12 / 1);
  4. serving: the model saved as a reference .pth, loaded by
     ``Inpainter.from_checkpoint`` and served over HTTP on 127.0.0.1;
     three concurrent /inpaint requests (one longer than 256 frames)
     against the plain-path Inpainter; the launch counts of this run;
  5. throughput: Inpainter frames/s at B=256, T=128, kernel and plain path;
  6. training: the flagship A1 train step (``train.steps.build_model`` and
     ``make_train_step``) at B=64, T=128 from the same seeded parameters
     and the same on-device corruption, three steps on the kernel path and
     three on the plain path: losses within 1e-4 relative, parameters
     after step 1 within 1e-4 of their scale, launch counts per step
     18 / 18 / 12 / 12 (serving kernels 0); then the step time and
     frames/s of both paths.

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
# the card's peaks (NVIDIA H100 SXM data sheet): float32 FFMA, HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
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


TRAIN_KERNELS = ("attn_sublayer_train", "attn_sublayer_bwd", "ffn_train",
                 "ffn_bwd")
# the training step's launches of each kernel: 18 attention sublayers, 12
# FF sublayers, forward and backward; none of the serving kernels
TRAIN_COUNTS = {"pre_stream_embed": 0, "attn_sublayer": 0, "ffn": 0,
                "post_head": 0, "attn_sublayer_train": 18,
                "attn_sublayer_bwd": 18, "ffn_train": 12, "ffn_bwd": 12}
# (variant, cross-attention, post-LN, mask kind, add_keypad): the three
# attention sublayers of the model
ATTN_VARIANTS = (("enc self repeat-inc+keypad", False, False, "repeat-inc",
                  True),
                 ("dec self repeat-inc+post-LN", False, True, "repeat-inc",
                  False),
                 ("cross all", True, False, "all", False))


class KernelCheck:
    """Runs every kernel variant against its plain version on the card."""

    def __init__(self, torch, kmod):
        self.torch, self.k = torch, kmod
        self.g = torch.Generator().manual_seed(1234)
        self.max_err = {}

    def rand(self, *shape, scale=1.0, lo=None, hi=None):
        t = self.torch
        if lo is not None:
            x = t.rand(*shape, generator=self.g) * (hi - lo) + lo
        else:
            x = t.randn(*shape, generator=self.g) * scale
        return x.to(DEV).contiguous()

    def weight(self, fan_in, fan_out):
        b = 1.0 / fan_in ** 0.5
        return self.rand(fan_in, fan_out, lo=-b, hi=b)

    def masks(self, B, T):
        t = self.torch
        mask = (t.rand(B, T, generator=self.g) < 0.3).float()
        valid = t.ones(B, T)
        valid[1, T - max(T // 5, 1):] = 0.0  # a padded row
        return mask.to(DEV).contiguous(), valid.to(DEV).contiguous()

    def compare(self, name, variant, got, want, grad=False):
        """Each output within REL_TOL of max(1, its scale), or, for
        gradients (``grad``), within GRAD_TOL of the largest gradient of
        the call."""
        t = self.torch
        t.cuda.synchronize()
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        if len(gots) != len(wants):
            fail(f"{name} {variant}: {len(gots)} outputs != {len(wants)}")
        pairs = [(g_, w_) for g_, w_ in zip(gots, wants)
                 if not (g_ is None and w_ is None)]
        gscale = max(float(w_.abs().max()) for _, w_ in pairs)
        for g_, w_ in pairs:
            if g_ is None or w_ is None or g_.shape != w_.shape:
                shapes = [None if t_ is None else tuple(t_.shape)
                          for t_ in (g_, w_)]
                fail(f"{name} {variant}: output {shapes[0]} != {shapes[1]}")
            if not bool(t.isfinite(g_).all()):
                fail(f"{name} {variant}: non-finite output")
            err = float((g_ - w_).abs().max())
            tol = (GRAD_TOL * gscale if grad
                   else REL_TOL * max(1.0, float(w_.abs().max())))
            self.max_err[name] = max(self.max_err.get(name, 0.0), err)
            print(f"  {name:16s} {variant:34s} max_abs_err {err:.3e} "
                  f"(tol {tol:.2e})", flush=True)
            if err > tol:
                fail(f"{name} {variant}: max_abs_err {err:.3e} > {tol:.2e}")

    def operands(self, B, T):
        w = self.weight
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
        }

    def calls(self, B, T):
        """(kernel name, variant, wrapper call, plain call) at (B, T)."""
        k, o = self.k, self.operands(B, T)
        mask, valid = self.masks(B, T)
        out = []
        for pe_res in (False, True):
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
            args = (o["x"], mem, *w, *ln, mask, valid, kind, keypad, HEADS)
            out.append(("attn_sublayer", variant,
                        lambda a=args: k.fused_attn_sublayer(*a),
                        lambda a=args: k.attn_sublayer_plain(*a)))
        args = (o["x"], o["w1"], o["b1"], o["w2"], o["b2"], o["g"], o["be"],
                o["g"], o["be"], True)
        out.append(("ffn", "pre_ln", lambda a=args: k.fused_ffn(*a),
                    lambda a=args: k.ffn_plain(*a)))
        args = (o["x"], o["mem"], o["w12"], o["b12"], o["w3"], o["b3"],
                o["wh"], o["bh"])
        out.append(("post_head", "", lambda a=args: k.fused_post_head(*a),
                    lambda a=args: k.post_head_plain(*a)))
        return out

    def train_calls(self, B, T):
        """(kernel name, variant, wrapper call, plain call, is a gradient)
        of the training kernels at (B, T); each backward gets the plain
        training forward's residuals on both sides."""
        k, o = self.k, self.operands(B, T)
        mask, valid = self.masks(B, T)
        dy = self.rand(B, T, D)
        out = []
        w_in = o["wqkv"].t().contiguous()
        w_out = o["wo"].t().contiguous()
        for variant, mem, ln, kind, keypad in ATTN_VARIANTS:
            mem = o["mem"] if mem else None
            ln = (o["g"], o["be"]) if ln else (None, None)
            args = (o["x"], mem, o["wqkv"], o["bqkv"], o["wo"], o["bo"], *ln,
                    mask, valid, kind, keypad, HEADS)
            out.append(("attn_sublayer_train", variant,
                        lambda a=args: k.fused_attn_sublayer_train(*a),
                        lambda a=args: k.attn_sublayer_train_plain(*a),
                        False))
            _, qkv, a, stats, r = k.attn_sublayer_train_plain(*args)
            bargs = (dy, o["x"], mem, qkv, a, stats, r, w_in, w_out, ln[0],
                     mask, valid, kind, keypad, HEADS)
            out.append(("attn_sublayer_bwd", variant,
                        lambda a=bargs: k.attn_sublayer_bwd(*a),
                        lambda a=bargs: k.attn_sublayer_bwd_plain(*a), True))
        args = (o["x"], o["w1"], o["b1"], o["w2"], o["b2"], o["g"], o["be"],
                o["g"], o["be"], True)
        out.append(("ffn_train", "pre_ln", lambda a=args: k.fused_ffn_train(*a),
                    lambda a=args: k.ffn_train_plain(*a), False))
        _, u, z = k.ffn_train_plain(*args)
        bargs = (dy, o["x"], u, z, o["w1"].t().contiguous(),
                 o["w2"].t().contiguous(), o["g"], o["be"], o["g"], True)
        out.append(("ffn_bwd", "pre_ln", lambda a=bargs: k.ffn_bwd(*a),
                    lambda a=bargs: k.ffn_bwd_plain(*a), True))
        return out


def work(name, B, T):
    """(FLOP, bytes) the timed variant of kernel ``name`` must do and move
    at (B, T) and the model's widths: every input read once, every output
    written once.  The attention variant timed is the encoder's
    self-attention (repeat-inc, key padding, no LayerNorm); the FF one has
    LN1.  The backward's attention core counts the scores it must rebuild
    (5 products of B H T^2 dh, against the forward's 2)."""
    N, f, dh = B * T, 4, D // HEADS
    core = 4 * B * HEADS * T * T * dh
    attn_in = N * D + 2 * B * T + 4 * D * D + 4 * D
    ffn_in = N * D + 2 * D * FF + FF + 5 * D
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
    }
    flop, elems = table[name]
    return flop, elems * f


def bound(name, B, T):
    """(bound_ms, bound_by): the larger of the FLOP over the float32 FFMA
    peak and the bytes over the memory rate."""
    flop, byts = work(name, B, T)
    t_op, t_mem = flop / PEAK_FLOPS, byts / PEAK_BYTES
    return max(t_op, t_mem) * 1e3, "operations" if t_op >= t_mem else "bytes"


def phase_kernels(torch, kmod):
    print("phase 2: kernels against their plain versions", flush=True)
    print(f"  tolerance {REL_TOL:.0e} x max(1, max |plain|): float32 FFMA "
          "kernels against cuBLAS float32, the same products summed in "
          "another order", flush=True)
    print(f"  gradients: {GRAD_TOL:.0e} x the call's largest plain "
          "gradient: the same, summed over up to 8192 rows; some gradients "
          "(the k-bias) are exactly zero in exact arithmetic, so no "
          "per-tensor scale", flush=True)
    chk = KernelCheck(torch, kmod)

    def all_calls(B, T, b_train):
        return ([(*c, False) for c in chk.calls(B, T)]
                + chk.train_calls(b_train, T))

    for T in (128, 40, 300):
        for name, variant, kern, plain, grad in all_calls(3, T, 3):
            chk.compare(name, f"B=3 T={T} {variant}", kern(), plain(), grad)
    times, first = {}, {}
    for name, variant, kern, plain, grad in all_calls(B_MAIN, T_MAIN,
                                                      B_TRAIN):
        B = B_TRAIN if name in TRAIN_KERNELS else B_MAIN
        chk.compare(name, f"B={B} T={T_MAIN} {variant}", kern(), plain(),
                    grad)
        first.setdefault(name, (variant, kern, plain, B))
    for name, (variant, kern, plain, B) in first.items():
        p0 = timed_ms(plain)
        k0 = timed_ms(kern)
        k1 = timed_ms(kern)
        p1 = timed_ms(plain)
        b_ms, b_by = bound(name, B, T_MAIN)
        times[name] = (min(k0, k1), min(p0, p1), b_ms, b_by)
        print(f"  time {name:19s} {variant:28s} kernel {times[name][0]:.4f} "
              f"ms  plain {times[name][1]:.4f} ms  bound {b_ms:.4f} ms "
              f"({b_by})  (B={B} T={T_MAIN})", flush=True)
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
    print("phase 3: flagship KeypointCompleter, kernel path vs plain path",
          flush=True)
    clean, miss = model_inputs(B_MAIN, T_MAIN, 0)
    clean_t = torch.from_numpy(clean).to(DEV)
    inputs, mask = add_sos(clean_t, torch.from_numpy(miss).to(DEV))
    x, x_no, x_mask, y_mask = inputs[:, :-1], inputs[:, 1:], mask[:, :-1], \
        mask[:, 1:]
    valid = torch.ones(B_MAIN, T_MAIN, device=DEV)
    outs = {}
    with torch.inference_mode():
        for plain in (True, False):
            kmod.reset_launches()
            pred = model(x, x_no, x_mask, y_mask, valid, plain=plain)
            outs[plain] = composite_prediction(pred, clean_t, y_mask)
            torch.cuda.synchronize()
            counts = kmod.launch_counts()
            if plain and any(counts.values()):
                fail(f"plain path launched kernels: {counts}")
    print(f"  launches in one forward: {counts}", flush=True)
    if counts != {"pre_stream_embed": 2, "attn_sublayer": 18, "ffn": 12,
                  "post_head": 1, **{n: 0 for n in TRAIN_KERNELS}}:
        fail(f"launch counts {counts} != 2 / 18 / 12 / 1 (training 0)")
    out_k, out_p = outs[False].cpu().numpy(), outs[True].cpu().numpy()
    if out_k.shape != (B_MAIN, T_MAIN, 54, 2) or not np.isfinite(out_k).all():
        fail(f"model output shape {out_k.shape} or non-finite values")
    delta = masked_mpjpe_delta(out_k, out_p, miss)
    print(f"  masked MPJPE delta kernel vs plain {delta:.3e} "
          f"(gate {MPJPE_TOL:.0e}); max abs {np.abs(out_k - out_p).max():.3e}",
          flush=True)
    if not delta < MPJPE_TOL:
        fail(f"masked MPJPE delta {delta:.3e} >= {MPJPE_TOL}")
    if not np.array_equal(out_k[miss == 0], clean[miss == 0]):
        fail("composite changed a non-missing frame")


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
    rng = np.random.default_rng(7)
    lengths = (300, 77, 128)
    videos = [rng.uniform(0.2, 0.8, (t, 54, 2)).astype(np.float32)
              for t in lengths]
    masks = [(rng.random(t) < 0.3).astype(np.float32) for t in lengths]
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
    print(f"  launches during the three requests: {launches}", flush=True)
    if not all(v for n, v in launches.items() if n not in TRAIN_KERNELS):
        fail(f"a kernel of the path was not launched: {launches}")
    worst = 0.0
    for i, (v, m, w) in enumerate(zip(videos, masks, want)):
        got = np.asarray(results[i]["videos"][0], np.float32)
        if got.shape != v.shape or not np.isfinite(got).all():
            fail(f"request {i}: shape {got.shape} or non-finite values")
        if not np.array_equal(got[m == 0], v[m == 0]):
            fail(f"request {i}: a non-missing frame changed")
        err = float(np.abs(got[m == 1] - w[m == 1]).max())
        worst = max(worst, err)
        print(f"  request {i}: T={len(v)} missing={int(m.sum())} "
              f"max_abs_err vs plain-path Inpainter {err:.3e} "
              f"(tol {SERVE_TOL:.0e})", flush=True)
    if worst > SERVE_TOL:
        fail(f"served predictions differ from the plain path by {worst}")
    print(f"  /statz {stats}", flush=True)
    if stats["requests"] != 3 or stats["videos"] != 3:
        fail(f"/statz counted {stats}, expected 3 requests and 3 videos")
    return launches, inp, oracle


def phase_throughput(torch, inp, oracle, gpu):
    print("phase 5: Inpainter throughput", flush=True)
    clean, miss = model_inputs(B_MAIN, T_MAIN, 3)
    videos, masks = list(clean), list(miss)
    fps = {}
    for name, engine in (("plain", oracle), ("kernel", inp),
                         ("kernel", inp), ("plain", oracle)):
        engine.inpaint(videos, masks)  # warm
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            engine.inpaint(videos, masks)
        dt = (time.perf_counter() - t0) / reps
        fps[name] = max(fps.get(name, 0.0), B_MAIN * T_MAIN / dt)
    print(f"  Inpainter B={B_MAIN} T={T_MAIN}: kernel path "
          f"{fps['kernel']:.1f} frames/s, plain path {fps['plain']:.1f} "
          f"frames/s on {gpu}", flush=True)


def train_setup(torch):
    """Two flagship models from one seed, their train states, the step
    functions of the kernel and the plain path, and a batch."""
    from keypoints_interpolation_transformer_torch.train import state, steps
    from keypoints_interpolation_transformer_torch.utils.config import (
        Config, ModelConfig)
    cfg = Config(model=ModelConfig(hidden_dim=D, num_heads=HEADS,
                                   num_layers=LAYERS, ff_dim=FF))
    runs = {}
    for name, plain in (("kernel", False), ("plain", True)):
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
    print(f"phase 6: flagship A1 train step, B={B_TRAIN} T={T_MAIN}, kernel "
          "path vs plain path", flush=True)
    runs, clean, length, weight, lr = train_setup(torch)
    losses = {}
    totals = {n: 0 for n in TRAIN_COUNTS}
    for i in range(3):
        for name in ("plain", "kernel"):
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
            if name == "plain" and any(counts.values()):
                fail(f"plain path launched kernels: {counts}")
            if name == "kernel":
                if counts != TRAIN_COUNTS:
                    fail(f"step {i} launch counts {counts} != {TRAIN_COUNTS}")
                for n, c in counts.items():
                    totals[n] += c
        if i == 0:
            # one scale for all parameters: the moment-normalized Adam step
            # moves a parameter whose gradient is float noise (the k-bias)
            # by up to lr either way on either path
            with torch.no_grad():
                pk = [p for p in runs["kernel"][0].parameters()]
                pp = [p for p in runs["plain"][0].parameters()]
                scale = max(float(p.abs().max()) for p in pp)
                worst = max(float((a - b).abs().max())
                            for a, b in zip(pk, pp)) / scale
            print(f"  parameters after step 1: max |kernel - plain| / "
                  f"max |plain| {worst:.3e} (tol {REL_TOL:.0e})", flush=True)
            if worst > REL_TOL:
                fail(f"parameters after step 1 differ by {worst:.3e}")
        (lk, gk), (lp, gp) = losses["kernel", i], losses["plain", i]
        rel = abs(lk - lp) / abs(lp)
        print(f"  step {i}: loss kernel {lk:.7f} plain {lp:.7f} rel "
              f"{rel:.3e}; grad norm kernel {gk:.6e} plain {gp:.6e} rel "
              f"{abs(gk - gp) / gp:.3e} (tol {LOSS_RTOL:.0e}); launches "
              f"{counts}", flush=True)
        if rel > LOSS_RTOL or abs(gk - gp) > LOSS_RTOL * gp:
            fail(f"step {i}: loss or gradient norm differ beyond "
                 f"{LOSS_RTOL:.0e} relative")

    step_ms = {}
    for name in ("plain", "kernel", "kernel", "plain"):
        model, st, step = runs[name]
        gen = torch.Generator(device=DEV).manual_seed(7)
        step(st, clean, length, weight, gen, lr)  # warm
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
    for name in ("kernel", "plain"):
        print(f"  train step {name} path: {step_ms[name]:.3f} ms, "
              f"{B_TRAIN * T_MAIN / step_ms[name] * 1e3:.1f} frames/s "
              f"(mean of 5 warm steps, best of 2 turns) on {gpu}",
              flush=True)
    print(f"  sublayer FLOP per step {flop / 1e12:.4f} TFLOP: bound "
          f"{flop / PEAK_FLOPS * 1e3:.3f} ms at the float32 FFMA peak",
          flush=True)
    return totals, step_ms


def kernel_name(ptxas_line):
    """``name<N>`` of the kernel a ptxas "Compiling entry function" line
    names, read from its mangled name's length-prefixed identifiers."""
    mangled = ptxas_line.split("'")[1]
    digits = re.compile(r"\d+")
    pos = 0
    while (m := digits.search(mangled, pos)) is not None:
        ident = mangled[m.end():m.end() + int(m.group())]
        pos = m.end() + len(ident)
        if ident.endswith("_kernel"):
            t = re.match(r"ILi(\d+)E", mangled[pos:])
            return ident + (f"<{t.group(1)}>" if t else "")
    return mangled


def profile_train(torch, kmod, gpu):
    """Device time of one warm kernel-path train step by kernel, from
    torch.profiler (CUPTI), and the device's busy share of the step."""
    from torch.profiler import ProfilerActivity, profile
    runs, clean, length, weight, lr = train_setup(torch)
    _, st, step = runs["kernel"]
    gen = torch.Generator(device=DEV).manual_seed(7)
    for _ in range(2):
        step(st, clean, length, weight, gen, lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(st, clean, length, weight, gen, lr)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def self_device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    # kernels and copies only: an autograd node also reports the device
    # time of the kernels it launched
    rows = [(e.key, self_device_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and self_device_us(e) > 0]
    busy = sum(r[1] for r in rows)
    print(f"profile: one kernel-path train step, B={B_TRAIN} T={T_MAIN}, "
          f"{gpu}: wall {wall:.3f} ms (profiler on), device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f} %)", flush=True)
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:25]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {key[:100]}", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs the port on the card")
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
    print(f"  nvcc build {max(secs.values()):.1f} s "
          f"({', '.join(_build.SOURCES)})", flush=True)
    for name in _build.SOURCES:
        log = _build.BUILD_DIR / f"{name}.log"
        if log.is_file():
            entry = ""
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    entry = kernel_name(line)
                elif "registers" in line or "spill" in line:
                    print(f"  {name} {entry}: {line.split(':', 1)[-1].strip()}",
                          flush=True)

    if "--profile" in sys.argv[1:]:
        profile_train(torch, kmod, gpu)
        return 0
    max_err, times = phase_kernels(torch, kmod)

    model = KeypointCompleter(D, LAYERS, HEADS, ff_dim=FF, device=DEV,
                              generator=torch.Generator().manual_seed(0))
    model.eval()
    phase_model(torch, kmod, model)

    with tempfile.TemporaryDirectory() as tmp:
        launches, inp, oracle = phase_serving(torch, kmod, model, tmp)
    phase_throughput(torch, inp, oracle, gpu)
    del model, inp, oracle
    train_launches, _ = phase_train(torch, kmod, gpu)
    launches.update({n: train_launches[n] for n in TRAIN_KERNELS})

    summary = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": max_err[k.name], "ms": times[k.name][0],
         "plain_ms": times[k.name][1], "bound_ms": times[k.name][2],
         "bound_by": times[k.name][3], "library_ms": None}
        for k in kmod.KERNELS]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases (each prints its own lines; any failed check exits non-zero):
  1. device and build: the card's name and power limit, then the nvcc build
     of ``keypoints_interpolation_transformer_torch/csrc/*.cu``;
  2. kernels: every variant on the serving path against its plain version
     at the flagship widths (D=256, 8 heads, FF=2048), B=3, T in
     {128, 40, 300}; then CUDA-event times of kernel and plain version at
     B=256, T=128;
  3. model: the flagship KeypointCompleter (random weights from a seeded
     torch.Generator) at B=256, T=128, kernel path against plain path by
     the bench's rule (masked-frame MPJPE delta < 1e-4), and the launch
     counts of one forward (2 / 18 / 12 / 1);
  4. serving: the model saved as a reference .pth, loaded by
     ``Inpainter.from_checkpoint`` and served over HTTP on 127.0.0.1;
     three concurrent /inpaint requests (one longer than 256 frames)
     against the plain-path Inpainter; the launch counts of this run;
  5. throughput: Inpainter frames/s at B=256, T=128, kernel and plain path.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card it exits 1 and prints
no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

# the batch and widths of the flagship serving cell
B_MAIN, T_MAIN = 256, 128
D, HEADS, FF, LAYERS, F_IN = 256, 8, 2048, 6, 108
# f32 FFMA kernels against cuBLAS f32: the same products summed in another
# order (over contraction depths up to 2048) differ by a few ulp of the
# partial sums; 1e-4 of the output's scale leaves an order of magnitude of
# room above that
REL_TOL = 1e-4
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

    def compare(self, name, variant, got, want):
        t = self.torch
        t.cuda.synchronize()
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        for g_, w_ in zip(gots, wants):
            if g_.shape != w_.shape:
                fail(f"{name} {variant}: shape {tuple(g_.shape)} != "
                     f"{tuple(w_.shape)}")
            if not bool(t.isfinite(g_).all()):
                fail(f"{name} {variant}: non-finite output")
            err = float((g_ - w_).abs().max())
            tol = REL_TOL * max(1.0, float(w_.abs().max()))
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
        for variant, mem, ln, kind, keypad in (
                ("enc self repeat-inc+keypad", None, (None, None),
                 "repeat-inc", True),
                ("dec self repeat-inc+post-LN", None, (o["g"], o["be"]),
                 "repeat-inc", False),
                ("cross all", o["mem"], (None, None), "all", False)):
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


def phase_kernels(torch, kmod):
    print("phase 2: kernels against their plain versions", flush=True)
    print(f"  tolerance {REL_TOL:.0e} x max(1, max |plain|): float32 FFMA "
          "kernels against cuBLAS float32, the same products summed in "
          "another order", flush=True)
    chk = KernelCheck(torch, kmod)
    for T in (128, 40, 300):
        for name, variant, kern, plain in chk.calls(3, T):
            chk.compare(name, f"B=3 T={T} {variant}", kern(), plain())
    times = {}
    first = {}
    for name, variant, kern, plain in chk.calls(B_MAIN, T_MAIN):
        chk.compare(name, f"B={B_MAIN} T={T_MAIN} {variant}", kern(),
                    plain())
        first.setdefault(name, (variant, kern, plain))
    for name, (variant, kern, plain) in first.items():
        p0 = timed_ms(plain)
        k0 = timed_ms(kern)
        k1 = timed_ms(kern)
        p1 = timed_ms(plain)
        times[name] = (min(k0, k1), min(p0, p1))
        print(f"  time {name:16s} {variant:30s} kernel {times[name][0]:.4f} "
              f"ms  plain {times[name][1]:.4f} ms  (B={B_MAIN} T={T_MAIN})",
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
                  "post_head": 1}:
        fail(f"launch counts {counts} != 2 / 18 / 12 / 1")
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
    if not all(launches.values()):
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
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)

    max_err, times = phase_kernels(torch, kmod)

    model = KeypointCompleter(D, LAYERS, HEADS, ff_dim=FF, device=DEV,
                              generator=torch.Generator().manual_seed(0))
    model.eval()
    phase_model(torch, kmod, model)

    with tempfile.TemporaryDirectory() as tmp:
        launches, inp, oracle = phase_serving(torch, kmod, model, tmp)
    phase_throughput(torch, inp, oracle, gpu)

    summary = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": max_err[k.name], "ms": times[k.name][0],
         "plain_ms": times[k.name][1]} for k in kmod.KERNELS]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

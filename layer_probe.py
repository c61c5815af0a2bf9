#!/usr/bin/env python3
"""Where the merged layer kernels', the training backwards' and the
precision-mode kernels' time goes, on one CUDA card.

    python3 layer_probe.py phases [DIR]     # cycles per phase of a block
    python3 layer_probe.py bwdphases [DIR]  # the same, fused backward core
    python3 layer_probe.py times TREE...    # layer kernel times, in turns
    python3 layer_probe.py backward TREE... # backward kernel times, in turns
    python3 layer_probe.py attention TREE...  # per-op attention, in turns
    python3 layer_probe.py forwards TREE...  # sublayer forwards, in turns
    python3 layer_probe.py modes TREE...    # precision-mode kernels, in turns
    python3 layer_probe.py spread           # "default" routes' spread
    python3 layer_probe.py host             # host time of two mode wrappers
    python3 layer_probe.py flipdl [DIR]     # the standing draw's dl, kernel

``phases`` copies ``keypoints_interpolation_transformer_torch`` into DIR
(default ``scratch_tree/layer_probe``, git-ignored), adds ``clock64()``
counters to its ``csrc/layer_fused.cu`` (thread 0 of every block adds the
cycles of each phase into a ``__device__`` array; each phase ends in a
barrier, so thread 0's time is the block's), builds that source alone and
runs ``enc_layer``, ``dec_layer`` (with and without its FF tail) and
``enc_layer_int8`` at B = 256 and 16, T = 128, the flagship widths,
printing the time of each call (counters on) and its cycles per block by
phase.  The counters change the code the compiler schedules, so the times
differ from ``chip_smoke.py``'s by a few per cent either way; the split
between the phases is what this is for.

``host`` builds ``mode_linear.cu`` and ``attn_sublayer_modes.cu`` and
splits the host time a call of two mode wrappers at the A1 step's shapes
(``fused_attn_sublayer_train`` at B = 64, T = 128, self-attention, with
the planes ``attn_train_planes`` makes, and ``mode_linear_bwd`` at the q /
k / v projection from the planes a ``ModeLinearFunction`` keeps) into the
whole call, the call with the C entry stubbed out (the Python: checks,
allocations, argument packing), and two of its pieces, each the mean of
200 back-to-back calls with the card idle at the start.

``bwdphases`` does the same for the attention sublayer's fused backward
core in the modes (``csrc/attn_modes.cuh`` ``attn_mode_bwd_kernel``, its
counters thread 0's of each block: the load and split, delta, the
key-major pass as warp 0 runs it, the sums, the query-major pass) in
``scratch_tree/bwd_phases``, only ``attn_sublayer_modes.cu`` built: the
A1 step's self-attention backward at B = 64, T = 128 in "high" and
"default", each call's time (counters on), cycles a block by phase and
device time by launch.

``flipdl`` copies the package into DIR (default ``scratch_tree/flip_dl``)
with ``csrc/attention_modes.cu`` made to record, at the standing draw's
``chip_smoke.FLIP_DL`` (video, head, key j, query i), what the per-op
backward at "default" computes there in float32: the key-major kernel's s,
the query's (m, 1 / l, delta), p, gw and dl before its bf16 rounding, and
the query-major kernel's sums l and sum of gw exp(s - m) for that row.  It
builds that source alone, runs ``attention_bwd`` at "default" on the
standing draw's ``FLIP_ROWS`` (``chip_smoke.flip_draw_calls``) and prints those values
beside the plain version's in its three float32 orders
(``chip_smoke.flip_dl_orders``) on the card and on the CPU, and the
kernel's and the plain version's dk at that key.

``times`` takes trees that each hold a copy of the package (a git
checkout, ``git archive`` of another commit, or an edited copy under
``scratch_tree/``), builds their ``layer_fused.cu`` at once and times the
layer kernels of each (B = 256 and 16, T = 128, each held against its
plain version first) and the library layers at B = 256, in turns: the
trees in order, then in reverse, each turn in a fresh process.

``attention`` does the same for the per-op attention kernels
(``attention.cu``): ``attention`` and the standalone ``attention_bwd`` at
the A1 step's B = 64, T = 128 and at the 600-frame request's B = 1, T =
608, each held against its plain version, then its CUDA-event time, the
library call's (``F.scaled_dot_product_attention``, and its autograd
forward and backward), ``attention_bwd`` given the forward's out and stats
where the tree has that form, and one call's device time by kernel.

``forwards`` does the same for the per-sublayer float32 forwards
(``ffn.cu`` and ``attn_sublayer.cu``): ``ffn`` with LN1 at the serving
batch B = 256, ``ffn_train`` at the A1 step's B = 64, both also at B = 1,
T = 128 (one 128-frame video) and B = 1, T = 608 (the 600-frame
request's bucket); ``attn_sublayer`` and ``attn_sublayer_train`` (the
encoder's self-attention, repeat-inc with the key padding) at B = 256 and
B = 64 and at B = 1, T = 128; each held against its plain version, then
its CUDA-event time, the plain version's and one call's device time by
kernel.

``modes`` does the same for the precision modes' kernels (``ffn.cu``,
``layer_modes.cu`` and ``attn_sublayer_modes.cu`` where a tree has them,
``layer_fused.cu`` and ``attn_sublayer.cu``): the six FF mode rows
(``ffn_high`` and ``ffn_default`` at the serving batch B = 256,
``ffn_train_*`` and ``ffn_bwd_split_*`` at the A1 step's B = 64, T = 128),
the four merged-layer mode rows (``enc_layer_high`` / ``_default``,
``dec_layer_high`` / ``_default`` with its FF tail, B = 256) and the six
attention-sublayer mode rows (``attn_sublayer_high`` / ``_default`` at B =
256, ``attn_sublayer_train_*`` and ``attn_sublayer_bwd_*`` at B = 64: the
encoder's self-attention) and, where a tree has ``mode_linear.cu``, the
four Dense rows (``mode_linear_*`` and ``mode_linear_bwd_*`` at the q / k
/ v projection, B = 64), each held against its plain version in its own
mode and the wrong one (``chip_smoke.py``'s limits), and their float32
counterparts ``ffn``, ``ffn_train``, ``ffn_bwd``, ``enc_layer``,
``dec_layer``, ``attn_sublayer``, ``attn_sublayer_train`` and
``attn_sublayer_bwd`` (what an older tree runs at every precision):
CUDA-event time, host time a call and one call's device time by kernel,
and for the attention sublayer's and the Dense rows by launch, in order.

``spread`` serves ``chip_smoke.py``'s phase 11 batch (B = 256, T = 128,
the flagship widths) at "default" on the merged route through the kernel
route, the plain route, the plain route on the CPU (another float32
summation order), the plain route with its frames one ulp up, kernel
layers with plain chains and the reverse, and both routes with float32
chains, and prints the masked MPJPE of each against the kernel route, the
plain route, the plain route at "highest" and the CPU's; then the chains
alone, kernel against plain, on the model's own inputs (largest and mean
difference, its mean signed toward larger magnitudes, the share of
elements that differ).

``backward`` does the same for the training backwards (``ffn.cu`` and
``attn_sublayer.cu``): ``ffn_bwd``, ``ffn_bwd_split`` in "f32" (a tree's
own float32 split where it has one, else the same C path as ``ffn_bwd``)
and ``attn_sublayer_bwd`` at the A1 step's B = 64, T = 128, each held
against its plain version, then its CUDA-event time and one call's
device time by kernel (``torch.profiler``).
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "keypoints_interpolation_transformer_torch"

# (counter, phase) in the order the kernels run them
PHASES = {0: "project", 1: "attend", 2: "tails", 3: "out-proj",
          4: "LN_in", 5: "W1", 6: "GELU", 7: "W2", 8: "LN_out",
          9: "int8 tail", 12: "dec projects", 13: "dec attend self",
          14: "dec self tail", 15: "dec attend cross", 16: "dec tails"}

# (text of csrc/layer_fused.cu, the same with counters): PROF0 starts a
# clock, PROF(i) adds the cycles since to counter i and restarts it
PATCHES = (
    ("using namespace kit;\n",
     "using namespace kit;\n"
     "__device__ unsigned long long kit_prof[32];\n"
     "#define PROF0 long long _t = clock64();\n"
     "#define PROF(i) do { if (threadIdx.x == 0) atomicAdd(&kit_prof[i], "
     "(unsigned long long)(clock64() - _t)); _t = clock64(); } while (0)\n"),
    ("  project<TN>(smem, x, T, p.self.wqkv, 3 * D, p.self.bqkv, 3, qkv, "
     "3 * D, rank, p.cl);\n  phase_sync(p.cl);\n",
     "  PROF0\n  project<TN>(smem, x, T, p.self.wqkv, 3 * D, p.self.bqkv, 3, "
     "qkv, 3 * D, rank, p.cl);\n  phase_sync(p.cl);\n  PROF(0);\n"),
    ("                        p.n / p.H, a, rank, p.cl);\n  phase_sync(p.cl);\n"
     "  tails<TN>(smem, p, a, x, p.self, a + (size_t)T * D, h, p.y + vid, "
     "rank);\n",
     "                        p.n / p.H, a, rank, p.cl);\n  phase_sync(p.cl);\n"
     "  PROF(1);\n  tails<TN>(smem, p, a, x, p.self, a + (size_t)T * D, h, "
     "p.y + vid, rank);\n  PROF(2);\n"),
    ("  project<TN>(smem, x, T, p.self.wqkv, 3 * D, p.self.bqkv, 3, sqkv, "
     "3 * D, rank, p.cl);\n",
     "  PROF0\n  project<TN>(smem, x, T, p.self.wqkv, 3 * D, p.self.bqkv, 3, "
     "sqkv, 3 * D, rank, p.cl);\n"),
    ("              rank, p.cl);\n  phase_sync(p.cl);\n",
     "              rank, p.cl);\n  phase_sync(p.cl);\n  PROF(12);\n"),
    ("  dec_self_tail<TN>(", "  PROF(13);\n  dec_self_tail<TN>("),
    ("  phase_sync(p.cl);  // q2 and x1 are complete, a is read\n",
     "  phase_sync(p.cl);  // q2 and x1 are complete, a is read\n  PROF(14);\n"),
    ("  tails<TN>(smem, p, a, x1, p.cross, q2 + (size_t)T * D, nullptr, "
     "p.y + vid, rank);\n",
     "  PROF(15);\n  tails<TN>(smem, p, a, x1, p.cross, q2 + (size_t)T * D, "
     "nullptr, p.y + vid, rank);\n  PROF(16);\n"),
    ("  __syncthreads();  // Xs, Hs and the ring are free\n  typename G::Acc r;\n"
     "  bool primed = out_proj<TN>(r, Xs, ring, a, res, row0, T, wo, bo, "
     "w1(c_lo));\n",
     "  __syncthreads();  // Xs, Hs and the ring are free\n  PROF0\n"
     "  typename G::Acc r;\n  bool primed = out_proj<TN>(r, Xs, ring, a, "
     "res, row0, T, wo, bo, w1(c_lo));\n  PROF(3);\n"),
    ("    ff_int8_tile<TN>(smem, r, ff, n, T, row0, h, y);\n",
     "    ff_int8_tile<TN>(smem, r, ff, n, T, row0, h, y);\n    PROF(9);\n"),
    ("    put_rows<TN, G::LDA>(Xs, v);\n  }\n  __syncthreads();\n",
     "    put_rows<TN, G::LDA>(Xs, v);\n  }\n  __syncthreads();\n  PROF(4);\n"),
    ("    primed = mma<TN>(r, Xs, w1(c), w2(c), ring, primed);\n",
     "    primed = mma<TN>(r, Xs, w1(c), w2(c), ring, primed);\n    PROF(5);\n"),
    ("    gelu_tile<TN>(Hs);\n", "    gelu_tile<TN>(Hs);\n    PROF(6);\n"),
    ("    primed = mma<TN>(z, Hs, w2(c), w1(c + 1), ring, primed);\n  }\n",
     "    primed = mma<TN>(z, Hs, w2(c), w1(c + 1), ring, primed);\n"
     "    PROF(7);\n  }\n"),
    ("  layer_norm<TN>(v, ff.g_out, ff.be_out, n);\n  store_rows<TN>(y, D, D, "
     "row0, T, v);\n}\n\n// The FF split's end",
     "  layer_norm<TN>(v, ff.g_out, ff.be_out, n);\n  store_rows<TN>(y, D, D, "
     "row0, T, v);\n  PROF(8);\n}\n\n// The FF split's end"),
)

READ_COUNTERS = """
extern "C" int kit_prof_get(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, kit_prof, sizeof(kit_prof));
  static const unsigned long long zero[32] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(kit_prof, zero, sizeof(kit_prof));
  return (int)e;
}
"""


def load_smoke():
    """chip_smoke.py of this tree, for its kernel operands and checks."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def use_tree(tree, sources=("layer_fused",)):
    """Import the package from ``tree`` and let it build only ``sources``
    (all these calls need)."""
    sys.path.insert(0, os.path.abspath(tree))
    from keypoints_interpolation_transformer_torch.ops.kernels import _build
    if not str(_build.CSRC).startswith(os.path.abspath(tree)):
        sys.exit(f"{PKG} imported from {_build.CSRC}, not from {tree}")
    _build.SOURCES = tuple(sources)
    return _build


def layer_calls(cs, torch, kmod, B):
    """The first (plain-mask) variant of each layer kernel at (B, 128),
    the decoder with and without its FF tail."""
    chk = cs.KernelCheck(torch, kmod)
    o, (mask, valid) = chk.operands(B, cs.T_MAIN), chk.masks(B, cs.T_MAIN)
    seen, out = set(), []
    for name, variant, kern, plain in (chk.layer_calls(o, mask, valid)
                                       + chk.int8_layer_calls(o, mask,
                                                              valid)):
        key = (name, "ff=False" in variant)
        if key not in seen and "cycle" not in variant:
            seen.add(key)
            out.append((name, variant, kern, plain))
    return chk, out


def phases(out_dir):
    import ctypes

    import numpy as np
    import torch
    tree = os.path.abspath(out_dir)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(tree, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = os.path.join(tree, PKG, "csrc", "layer_fused.cu")
    with open(cu) as f:
        src = f.read()
    for old, new in PATCHES:
        if old not in src:
            sys.exit(f"layer_probe: no longer in layer_fused.cu: {old!r}")
        src = src.replace(old, new, 1)
    with open(cu, "w") as f:
        f.write(src + READ_COUNTERS)
    cs = load_smoke()
    _build = use_tree(tree)
    from keypoints_interpolation_transformer_torch.ops import kernels as kmod
    from keypoints_interpolation_transformer_torch.ops.kernels.layer_fused \
        import cluster_size
    print(cs.gpu_line(), flush=True)
    print(f"  nvcc layer_fused.cu (counters on) "
          f"{_build.build(['layer_fused'])['layer_fused']:.1f} s", flush=True)
    lib = _build.bind("layer_fused", {})
    lib.kit_prof_get.argtypes = [ctypes.c_void_p]
    buf = np.zeros(32, dtype=np.uint64)
    for B in (256, 16):
        blocks = B * cluster_size(B, torch.device(cs.DEV))
        chk, calls = layer_calls(cs, torch, kmod, B)
        for name, variant, kern, plain in calls:
            chk.compare(name, f"B={B} {variant}", kern(), plain())
            ms = min(cs.timed_ms(kern) for _ in range(2))
            lib.kit_prof_get(buf.ctypes.data)  # reset
            kern()
            torch.cuda.synchronize()
            lib.kit_prof_get(buf.ctypes.data)
            cyc = {PHASES[i]: int(buf[i]) // blocks for i in PHASES if buf[i]}
            print(f"  B={B} {name} {variant}: {ms:.4f} ms (counters on); "
                  f"cycles a block {json.dumps(cyc)}", flush=True)


# the fused backward core's phases (csrc/attn_modes.cuh
# attn_mode_bwd_kernel), counted as PHASES are (thread 0 of each block)
BWD_PHASES = {0: "load + split", 1: "delta", 2: "key-major (dv, dk, dl)",
              3: "dk / dv sums", 4: "query-major (dq)", 5: "dq sums"}
BWD_PATCHES = (
    ('#include "tc_gemm.cuh"\n\nnamespace kit {\n',
     '#include "tc_gemm.cuh"\n\n'
     "__device__ unsigned long long kit_prof[32];\n"
     "#define PROF0 long long _t = clock64();\n"
     "#define PROF(i) do { if (threadIdx.x == 0) atomicAdd(&kit_prof[i], "
     "(unsigned long long)(clock64() - _t)); _t = clock64(); } while (0)\n"
     "\nnamespace kit {\n"),
    ("  // 1. the head's rows: q, k, v and a in float32",
     "  PROF0\n  // 1. the head's rows: q, k, v and a in float32"),
    ("  // each query's delta: its chunks' parts added in order",
     "  PROF(0);\n  // each query's delta: its chunks' parts added in order"),
    ("  __syncthreads();  // the planes are built: dl^T may take the float32 "
     "rows' room\n",
     "  __syncthreads();  // the planes are built: dl^T may take the float32 "
     "rows' room\n  PROF(1);\n"),
    ("  warps_colsum<NO>(csk, red, DP, dh, cs_out + p.D + hc);\n",
     "  PROF(2);\n  warps_colsum<NO>(csk, red, DP, dh, cs_out + p.D + hc);\n"),
    ("  // 3. query-major: dq = dl k\n",
     "  PROF(3);\n  // 3. query-major: dq = dl k\n"),
    ("  warps_colsum<NO>(csq, red, DP, dh, cs_out + hc);\n",
     "  PROF(4);\n  warps_colsum<NO>(csq, red, DP, dh, cs_out + hc);\n"
     "  PROF(5);\n"),
)


def bwd_phases(out_dir):
    """``bwdphases``: the fused backward core's cycles a block by phase
    (a copy of the package under ``out_dir`` with counters, only
    ``attn_sublayer_modes.cu`` built), the A1 step's self-attention
    backward at B = 64, T = 128 in "high" and "default"."""
    import ctypes

    import numpy as np
    import torch
    tree = os.path.abspath(out_dir)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(tree, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(tree, PKG, "csrc")
    with open(os.path.join(csrc, "attn_modes.cuh")) as f:
        src = f.read()
    for old, new in BWD_PATCHES:
        if old not in src:
            sys.exit(f"layer_probe: no longer in attn_modes.cuh: {old!r}")
        src = src.replace(old, new, 1)
    with open(os.path.join(csrc, "attn_modes.cuh"), "w") as f:
        f.write(src)
    with open(os.path.join(csrc, "attn_sublayer_modes.cu"), "a") as f:
        f.write(READ_COUNTERS)
    cs = load_smoke()
    _build = use_tree(tree, ("attn_sublayer_modes",))
    from keypoints_interpolation_transformer_torch.ops import kernels as kmod
    print(cs.gpu_line(), flush=True)
    print(f"  nvcc attn_sublayer_modes.cu (counters on) "
          f"{_build.build()['attn_sublayer_modes']:.1f} s", flush=True)
    lib = _build.bind("attn_sublayer_modes", {})
    lib.kit_prof_get.argtypes = [ctypes.c_void_p]
    buf = np.zeros(32, dtype=np.uint64)
    chk = cs.KernelCheck(torch, kmod)
    blocks = cs.B_TRAIN * cs.HEADS
    for name, variant, kern, plain, grad, wrong in chk.sublayer_mode_calls(
            3, cs.B_TRAIN, cs.T_MAIN):
        if not name.startswith("attn_sublayer_bwd") or \
                variant != cs.ATTN_VARIANTS[0][0]:
            continue
        chk.compare(name, variant, kern(), plain(), grad, wrong())
        ms = min(cs.timed_ms(kern) for _ in range(2))
        lib.kit_prof_get(buf.ctypes.data)  # reset
        kern()
        torch.cuda.synchronize()
        lib.kit_prof_get(buf.ctypes.data)
        cyc = {BWD_PHASES[i]: int(buf[i]) // blocks for i in BWD_PHASES}
        print(f"  {name} {variant} B={cs.B_TRAIN} T={cs.T_MAIN}: {ms:.4f} "
              f"ms (counters on); cycles a block {json.dumps(cyc)}; "
              f"{cs.launch_ms(torch, kern)} ms", flush=True)


# (anchor in attention_modes.cu, text put after it): the key-major kernel's
# s, (m, 1 / l, delta) and p at FLIP_DL, then its gw and dl before the bf16
# rounding; the query-major kernel's l and sum of gw exp(s - m) of the row
FLIP_PATCHES = (
    ("            pf[nt][e] = expf(s - qv.x) * qv.y;\n",
     "            if (FLIP_AT(key, q0 + qi)) {\n"
     "              kit_flip[0] = s; kit_flip[1] = qv.x; kit_flip[2] = qv.y;\n"
     "              kit_flip[3] = qv.z; kit_flip[4] = pf[nt][e];\n"
     "            }\n"),
    ("            dl_pair(pf[nt][2 * r], gw[0], dlt[0], pf[nt][2 * r + 1], "
     "gw[1], dlt[1], p.scale,\n"
     "                    dh_[2 * nt + r], dl_[2 * nt + r]);\n",
     "            for (int c = 0; c < 2; ++c)\n"
     "              if (FLIP_AT(r == 0 ? ka : kb, q0 + j0 + 8 * nt + 2 * t + c))"
     " {\n"
     "                kit_flip[5] = gw[c];\n"
     "                kit_flip[6] = __fmul_rn(__fmul_rn(pf[nt][2 * r + c], "
     "gw[c] - dlt[c]), p.scale);\n"
     "              }\n"),
    ("    delta[i] = ds[i] * inv[i];\n",
     "    if (t == 0 && FLIP_AT(FLIP_J, row)) {\n"
     "      kit_flip[7] = l[i];\n"
     "      kit_flip[8] = ds[i];\n"
     "    }\n"),
)
FLIP_NAMES = ("s", "m", "1/l", "delta", "p", "gw", "dl", "l", "sum gw e")


def flip_dl(out_dir):
    """``flipdl``: the per-op backward's float32 values at the standing
    draw's FLIP_DL on the card (a copy of the package under ``out_dir``
    with ``attention_modes.cu`` recording them, only that source built)
    beside the plain version's."""
    import ctypes

    import numpy as np
    import torch
    cs = load_smoke()
    tree = os.path.abspath(out_dir)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(tree, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(tree, PKG, "csrc", "attention_modes.cu")
    with open(path) as f:
        src = f.read()
    for old, new in FLIP_PATCHES:
        if src.count(old) != 1:
            sys.exit(f"layer_probe: not once in attention_modes.cu: {old!r}")
        src = src.replace(old, old + new)
    b, h, j, i = cs.FLIP_DL
    head = ("namespace kit {\n__device__ float kit_flip[16];\n"
            f"#define FLIP_J {j}\n#define FLIP_AT(key, q) (blockIdx.z == {b}"
            f" && blockIdx.y == {h} && (key) == {j} && (q) == {i})\n")
    src = src.replace("namespace kit {\n", head, 1)
    src += ('extern "C" int kit_flip_get(void* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, kit::kit_flip, "
            "sizeof(kit::kit_flip));\n}\n")
    with open(path, "w") as f:
        f.write(src)
    _build = use_tree(tree, ("attention_modes",))
    from keypoints_interpolation_transformer_torch.ops import kernels as kmod
    print(cs.gpu_line(), flush=True)
    print(f"  nvcc attention_modes.cu (recording on) "
          f"{_build.build()['attention_modes']:.1f} s", flush=True)
    lib = _build.bind("attention_modes", {})
    lib.kit_flip_get.argtypes = [ctypes.c_void_p]
    chk, _ = cs.flip_draw_calls(torch, kmod)
    for name, variant in cs.FLIP_ROWS:
        args = chk.layer_args[f"{name} {variant}"]
        got = kmod.attention_bwd(*args, mode="bf16")
        want = kmod.attention_bwd_plain(*args, mode="bf16")
        torch.cuda.synchronize()
        buf = np.zeros(16, dtype=np.float32)
        if lib.kit_flip_get(buf.ctypes.data):
            sys.exit("layer_probe: kit_flip_get failed")
        kern = {n: float(buf[k]) for k, n in enumerate(FLIP_NAMES)}
        kern["bf16"] = float(torch.tensor(kern["dl"]).to(torch.bfloat16)
                             .float())
        print(f"  {variant}: kernel (attn_op_dkv_kernel / attn_op_dq_kernel)"
              f": {json.dumps({k: f'{v:.9e}' for k, v in kern.items()})}",
              flush=True)
        cpu = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
        for where, a in (("card", args), ("CPU", cpu)):
            for order, x in cs.flip_dl_orders(torch, kmod, a).items():
                print(f"  {variant}: plain on the {where}, {order}: "
                      f"{json.dumps({k: f'{v:.9e}' for k, v in x.items()})}",
                      flush=True)
        dk, dkw = got[1][b, j, h].cpu(), want[1][b, j, h].cpu()
        own = float(want[1].abs().max())
        step = float(q_step(torch, kern["bf16"], args, cs.FLIP_DL)) / own
        print(f"  {variant}: dk of key {j}: largest |kernel - plain| "
              f"{float((dk - dkw).abs().max()) / own:.4e} of dk's max; one "
              f"bf16 step of dl times q there {step:.4e}", flush=True)


def q_step(torch, dl, args, at):
    """One bf16 step of dl at ``dl`` times the query's largest |q| of the
    head, the most a flip of that dl moves its key's dk."""
    b, h, _, i = at
    step = abs(dl) * 2.0 ** -7
    return step * args[0][b, i, h].to(torch.bfloat16).float().abs().max()


def times_one(tree):
    import torch
    cs = load_smoke()
    use_tree(tree)
    from keypoints_interpolation_transformer_torch.ops import kernels as kmod
    out = {}
    for B in (256, 16):
        chk, calls = layer_calls(cs, torch, kmod, B)
        for name, variant, kern, plain in calls:
            if "ff=False" in variant:
                continue
            chk.compare(name, f"B={B} {variant}", kern(), plain())
            out[f"{name} B={B}"] = min(cs.timed_ms(kern) for _ in range(3))
            if B == cs.B_MAIN and name in ("enc_layer", "dec_layer"):
                lib = cs.LIBRARY[name](torch, *chk.layer_args[name])
                out[f"{name} library"] = min(cs.timed_ms(lib)
                                             for _ in range(3))
    print(json.dumps(out), flush=True)


BACKWARD_SOURCES = ("ffn", "attn_sublayer")


def backward_one(tree):
    import torch
    cs = load_smoke()
    use_tree(tree, BACKWARD_SOURCES)
    from keypoints_interpolation_transformer_torch.ops import kernels as kmod
    chk = cs.KernelCheck(torch, kmod)
    calls = {}
    for name, variant, kern, plain, grad in chk.train_calls(cs.B_TRAIN,
                                                            cs.T_MAIN):
        if name in ("ffn_bwd", "attn_sublayer_bwd") and name not in calls:
            calls[name] = (variant, kern, plain)
    # the same arguments (bound as the lambda's default) through the split
    args = calls["ffn_bwd"][1].__defaults__[0]
    calls["ffn_bwd_split f32"] = (
        calls["ffn_bwd"][0], lambda: kmod.ffn_bwd_split(*args, "f32"),
        calls["ffn_bwd"][2])
    out = {}
    for key, (variant, kern, plain) in calls.items():
        chk.compare(key, f"B={cs.B_TRAIN} T={cs.T_MAIN} {variant}", kern(),
                    plain(), True)
        ms = min(cs.timed_ms(kern) for _ in range(3))
        plain_ms = min(cs.timed_ms(plain) for _ in range(2))
        out[key] = {"ms": ms, "plain_ms": plain_ms,
                    "kernels": by_kernel(cs, torch, kern)}
    print(json.dumps(out), flush=True)


def by_kernel(cs, torch, fn):
    """One call's device time by kernel: (name, count, ms), longest
    first."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((cs.kernel_key(e.key), e.count, round(getattr(
        e, "self_device_time_total", 0) / 1e3, 4))
        for e in prof.key_averages()
        if getattr(e, "self_device_time_total", 0) > 0),
        key=lambda r: -r[2])[:8]


FORWARD_SOURCES = ("ffn", "attn_sublayer")
# (kernel, B, T): the path shapes, one 128-frame video, the 600-frame
# request's bucket (the FF only: attention runs per op there)
FORWARD_SHAPES = (("ffn", 256, 128), ("ffn", 1, 128), ("ffn", 1, 608),
                  ("ffn_train", 64, 128), ("ffn_train", 1, 128),
                  ("ffn_train", 1, 608), ("attn_sublayer", 256, 128),
                  ("attn_sublayer", 1, 128), ("attn_sublayer_train", 64, 128),
                  ("attn_sublayer_train", 1, 128))


def forwards_one(tree):
    import torch
    cs = load_smoke()
    use_tree(tree, FORWARD_SOURCES)
    from keypoints_interpolation_transformer_torch.ops import kernels as kmod
    out = {}
    for name, B, T in FORWARD_SHAPES:
        chk = cs.KernelCheck(torch, kmod)
        (variant, kern, plain), = [c[1:] for c in chk.forward_calls(B, T)
                                   if c[0] == name]
        chk.compare(name, f"B={B} T={T} {variant}", kern(), plain())
        out[f"{name} B={B} T={T}"] = {
            "ms": min(cs.timed_ms(kern) for _ in range(3)),
            "plain_ms": min(cs.timed_ms(plain) for _ in range(2)),
            "kernels": by_kernel(cs, torch, kern)}
    print(json.dumps(out), flush=True)


MODE_SOURCES = ("ffn", "layer_modes", "layer_fused", "attn_sublayer",
                "attn_sublayer_modes", "mode_linear")


def tree_sources(tree, sources):
    """``sources`` that ``tree`` has (an older tree lacks the newer ones)."""
    csrc = os.path.join(os.path.abspath(tree), PKG, "csrc")
    return [s for s in sources if os.path.isfile(os.path.join(csrc,
                                                              f"{s}.cu"))]


def modes_one(tree):
    import torch
    cs = load_smoke()
    use_tree(tree, tree_sources(tree, MODE_SOURCES))
    from keypoints_interpolation_transformer_torch.ops import kernels as kmod
    from keypoints_interpolation_transformer_torch.ops.kernels import (
        attn_sublayer, layer_fused)
    chk = cs.KernelCheck(torch, kmod)
    B, bt, T = cs.B_MAIN, cs.B_TRAIN, cs.T_MAIN
    calls = {}
    for name, variant, kern, plain, grad, wrong in chk.precision_calls(B, bt,
                                                                       T):
        if name in cs.MODE_FF_KERNELS and name not in calls:
            chk.compare(name, f"{variant}", kern(), plain(), grad, wrong())
            calls[name] = (kern, plain)
    for b, name in ((B, "ffn"), (bt, "ffn_train")):
        for fname, variant, kern, plain in chk.forward_calls(b, T):
            if fname == name:
                chk.compare(name, variant, kern(), plain())
                calls[name] = (kern, plain)
                break
    for name, variant, kern, plain, grad in chk.train_calls(bt, T):
        if name == "ffn_bwd":
            chk.compare(name, variant, kern(), plain(), grad)
            calls[name] = (kern, plain)
            break
    # the merged layers at the serving batch: float32 (what an older tree
    # runs at every precision) and, where the tree has them, the four mode
    # kernels, each with the plain model's masks and the decoder's FF tail
    o, (mask, valid) = chk.operands(B, T), chk.masks(B, T)
    for name, variant, kern, plain in chk.layer_calls(o, mask, valid):
        if name not in calls:
            chk.compare(name, variant, kern(), plain())
            calls[name] = (kern, plain)
    if hasattr(layer_fused, "attn_weight_planes"):
        for name, variant, kern, plain, grad, wrong in \
                chk.layer_mode_calls(o, mask, valid, tails=(True,)):
            if name not in calls:
                chk.compare(name, variant, kern(), plain(), grad, wrong())
                calls[name] = (kern, plain)
    # the attention sublayer (the encoder's self-attention): float32 (what
    # an older tree runs at every precision) at the serving batch and the A1
    # step's, and where the tree has them the six mode rows, each call's
    # device time by launch (projections, core, LayerNorm, sums)
    for b, (name, variant, kern, plain, *_) in (
            [(B, c) for c in chk.forward_calls(B, T)]
            + [(bt, c) for c in chk.forward_calls(bt, T)]
            + [(bt, (*c, False)) for c in chk.train_calls(bt, T)]):
        wanted = {B: ("attn_sublayer",),
                  bt: ("attn_sublayer_train", "attn_sublayer_bwd")}[b]
        if name in wanted and name not in calls:
            chk.compare(name, variant, kern(), plain(),
                        name.endswith("bwd"))
            calls[name] = (kern, plain)
    if hasattr(attn_sublayer, "attn_train_planes"):
        for name, variant, kern, plain, grad, wrong in \
                chk.sublayer_mode_calls(B, bt, T):
            if name not in calls:
                chk.compare(name, variant, kern(), plain(), grad, wrong())
                calls[name] = (kern, plain)
    # the Dense products in a mode where the tree has them: the q / k / v
    # projection at the A1 step's rows, forward and backward
    if hasattr(kmod, "mode_linear"):
        for name, variant, kern, plain, grad, wrong in \
                chk.linear_mode_calls(bt, T):
            if name not in calls:
                chk.compare(name, variant, kern(), plain(), grad, wrong())
                calls[name] = (kern, plain)
    out = {}
    for name, (kern, plain) in calls.items():
        out[name] = {"ms": min(cs.timed_ms(kern) for _ in range(3)),
                     "plain_ms": min(cs.timed_ms(plain) for _ in range(2)),
                     "host_ms": min(cs.host_ms(torch, kern) for _ in range(2)),
                     "kernels": by_kernel(cs, torch, kern)}
        if name.startswith(("attn_sublayer", "mode_linear")):
            out[name]["launches"] = cs.launch_ms(torch, kern)
    print(json.dumps(out), flush=True)


ATTENTION_SOURCES = ("attention",)


def attention_one(tree):
    import inspect

    import torch
    cs = load_smoke()
    use_tree(tree, ATTENTION_SOURCES)
    from keypoints_interpolation_transformer_torch.ops import kernels as kmod
    residuals = "stats" in inspect.signature(kmod.fused_attention).parameters
    out = {}
    for B, T in ((cs.B_TRAIN, cs.T_MAIN), (1, 608)):
        chk = cs.KernelCheck(torch, kmod)
        calls = {}
        for name, variant, kern, plain, grad in chk.per_op_calls(
                B, T, blocked=False, residuals=residuals):
            key = name + (" given" if cs.RESIDUAL_FORM in variant else "")
            if name != "masked_loss" and key not in calls:
                calls[key] = (name, variant, kern, plain, grad)
        for key, (name, variant, kern, plain, grad) in calls.items():
            chk.compare(key, f"B={B} T={T} {variant}", kern(), plain(), grad)
            row = {"ms": min(cs.timed_ms(kern) for _ in range(3)),
                   "kernels": by_kernel(cs, torch, kern)}
            if key in cs.LIBRARY:
                lib = cs.LIBRARY[name](torch, *chk.layer_args[name])
                row["library_ms"] = min(cs.timed_ms(lib) for _ in range(3))
            out[f"{key} B={B} T={T}"] = row
    print(json.dumps(out), flush=True)


def in_turns(trees, sources, mode):
    """Build ``sources`` of every tree at once, then run ``mode`` on each
    tree in a fresh process: the trees in order, then in reverse."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from "
            f"{PKG}.ops.kernels import _build; print(_build.build("
            "sys.argv[2:]))")
    builds = [subprocess.Popen([sys.executable, "-c", code, t,
                                *tree_sources(t, sources)])
              for t in trees]
    if any(b.wait() != 0 for b in builds):
        sys.exit("layer_probe: a tree did not build")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for tree in list(trees) + list(reversed(trees)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            mode, tree], capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            sys.exit(f"{tree}: {r.stdout[-2000:]} {r.stderr[-3000:]}")
        print(f"  {tree}: {r.stdout.strip().splitlines()[-1]}", flush=True)


def spread():
    """The ``spread`` mode (see the module docstring)."""
    import dataclasses
    import numpy as np
    import torch
    cs = load_smoke()
    from keypoints_interpolation_transformer_torch.eval.serving import (
        Inpainter)
    from keypoints_interpolation_transformer_torch.models import completer
    from keypoints_interpolation_transformer_torch.models.completer import (
        KeypointCompleter)
    from keypoints_interpolation_transformer_torch.ops import kernels as kmod
    from keypoints_interpolation_transformer_torch.ops.kernels import _build
    print(cs.gpu_line(), flush=True)
    _build.SOURCES = ("pointwise", "pointwise_modes", "layer_modes")
    _build.build(_build.SOURCES)
    sd = KeypointCompleter(cs.D, cs.LAYERS, cs.HEADS, ff_dim=cs.FF,
                           generator=torch.Generator().manual_seed(0)
                           ).state_dict()
    clean, miss = cs.model_inputs(cs.B_MAIN, cs.T_MAIN, 3)
    videos, masks = list(clean), list(miss)

    def engine(prec, **kw):
        return Inpainter(sd, dataclasses.replace(
            cs.model_config(), matmul_precision=prec), **kw)

    def run(eng, v=videos):
        out = np.stack(eng.inpaint(v, masks))
        torch.cuda.synchronize()
        return out

    def no_planes(fn, f32=False):
        def call(*a, planes=None, mode="f32", **kw):
            return fn(*a, **kw) if f32 else fn(*a, mode=mode, **kw)
        return call

    K, P = engine("default", device="cuda"), engine("default", device="cuda",
                                                    plain=True)
    outs = {"kernel": run(K), "plain": run(P),
            "highest": run(engine("highest", device="cuda", plain=True)),
            "plain, CPU": run(engine("default", device="cpu", plain=True)),
            "plain, frames +1 ulp": run(P, [np.nextafter(v, np.float32(2))
                                            for v in videos])}
    names = ("fused_pre_stream_embed", "fused_post_head",
             "pre_stream_embed_plain", "post_head_plain")
    kept = {n: getattr(completer, n) for n in names}
    completer.fused_pre_stream_embed = no_planes(kmod.pre_stream_embed_plain)
    completer.fused_post_head = no_planes(kmod.post_head_plain)
    outs["kernel layers, plain chains"] = run(K)
    for n in names:
        setattr(completer, n, no_planes(kept[n], f32=True))
    outs["kernel, f32 chains"] = run(K)
    outs["plain, f32 chains"] = run(P)
    for n in names:
        setattr(completer, n, kept[n])
    tr = K.model.transformer
    tr.forward = (lambda fwd: lambda *a: fwd(*a[:5], True, *a[6:]))(
        tr.forward)
    outs["plain layers, kernel chains"] = run(K)
    del tr.forward
    cols = ("kernel", "plain", "highest", "plain, CPU")
    print("\"default\" merged route, B=256 T=128, masked MPJPE against "
          + ", ".join(cols), flush=True)
    for a, out in outs.items():
        print(f"  {a:28s} " + " ".join(
            f"{cs.masked_mpjpe_delta(out, outs[b], miss):.3e}" for b in cols),
            flush=True)

    calls = []
    for n in ("fused_pre_stream_embed", "fused_post_head"):
        setattr(completer, n, (lambda n_, fn: lambda *a, **kw: (
            calls.append((n_, fn, a, kw)), fn(*a, **kw))[1])(n, kept[n]))
    run(K)
    for n in names[:2]:
        setattr(completer, n, kept[n])
    for n, fn, a, kw in calls:
        plain = kmod.pre_stream_embed_plain if "pre" in n else \
            kmod.post_head_plain
        got, want = fn(*a, **kw), plain(*a, mode=kw["mode"])
        for j, (g, w) in enumerate(zip(*(x if isinstance(x, tuple) else (x,)
                                         for x in (got, want)))):
            d = (g - w).double()
            print(f"  {n} output {j}: largest difference "
                  f"{d.abs().max().item():.3e} (of {w.abs().max().item():.3e}"
                  f"), mean {d.abs().mean().item():.3e}, mean signed toward "
                  f"larger |plain| {(d * w.double().sign()).mean().item():.3e}"
                  f", share differing {(d != 0).double().mean().item():.3f}",
                  flush=True)


def host_parts():
    """The ``host`` mode (see the module docstring)."""
    import torch
    from keypoints_interpolation_transformer_torch.ops.kernels import _build
    _build.SOURCES = ("mode_linear", "attn_sublayer_modes")
    from keypoints_interpolation_transformer_torch.ops import kernels as k
    from keypoints_interpolation_transformer_torch.ops.kernels import (
        attn_sublayer as tas, linear as tlin)
    dev = torch.device("cuda", 0)

    def us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        el = time.perf_counter() - t0
        torch.cuda.synchronize()
        return round(el / n * 1e6, 1)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(1)
    B, T, D = 64, 128, 256
    x = torch.randn(B, T, D, generator=gen).to(dev)
    wqkv = (torch.randn(D, 3 * D, generator=gen) / 16).to(dev)
    wo = (torch.randn(D, D, generator=gen) / 16).to(dev)
    b3, b1 = torch.zeros(3 * D, device=dev), torch.zeros(D, device=dev)
    mask = torch.zeros(B, T, device=dev)
    valid = torch.ones(B, T, device=dev)
    M, K, N = B * T, D, 3 * D
    xx = torch.randn(M, K, generator=gen).to(dev)
    g = torch.randn(M, N, generator=gen).to(dev)
    w = (torch.randn(K, N, generator=gen) / 16).to(dev)
    for mode in ("bf16x3", "bf16"):
        planes = tas.attn_train_planes(wqkv.t().contiguous(),
                                       wo.t().contiguous(), mode)
        fwd = lambda: k.fused_attn_sublayer_train(  # noqa: E731
            x, None, wqkv, b3, wo, b1, None, None, mask, valid,
            "repeat-inc", True, 8, mode, planes)
        xp, wp = tlin.row_planes(xx, mode), tlin.weight_planes(w, mode)
        bwd = lambda: tlin._launch_bwd(  # noqa: E731
            g, xp, wp, K, mode, True, True, True)
        out = {"attn_sublayer_train": us(fwd), "mode_linear_bwd": us(bwd)}
        real = _build.call
        _build.call = lambda *a: None
        try:
            out["attn_sublayer_train Python"] = us(fwd)
            out["mode_linear_bwd Python"] = us(bwd)
        finally:
            _build.call = real
        out["attn_sublayer_train checks"] = us(
            lambda: tas._check_forward("probe", x, None, wqkv, b3, wo, b1,
                                       None, None, mask, valid, "repeat-inc",
                                       True, 8, dense=False)) + us(
            lambda: tas._train_planes("probe", dev, planes, mode, D, D))
        out["torch.empty of 2M floats"] = us(
            lambda: torch.empty(M * D, device=dev))
        print(f"  {mode}: host us a call {json.dumps(out)}", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("layer_probe: no CUDA device")
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "phases":
        phases(args[0] if args else os.path.join(ROOT, "scratch_tree",
                                                 "layer_probe"))
    elif mode == "bwdphases":
        bwd_phases(args[0] if args else os.path.join(ROOT, "scratch_tree",
                                                     "bwd_phases"))
    elif mode == "flipdl":
        flip_dl(args[0] if args else os.path.join(ROOT, "scratch_tree",
                                                  "flip_dl"))
    elif mode == "times":
        in_turns(args, ("layer_fused",), "times-one")
    elif mode == "times-one":
        times_one(args[0])
    elif mode == "attention":
        in_turns(args, ATTENTION_SOURCES, "attention-one")
    elif mode == "attention-one":
        attention_one(args[0])
    elif mode == "forwards":
        in_turns(args, FORWARD_SOURCES, "forwards-one")
    elif mode == "forwards-one":
        forwards_one(args[0])
    elif mode == "modes":
        in_turns(args, MODE_SOURCES, "modes-one")
    elif mode == "modes-one":
        modes_one(args[0])
    elif mode == "spread":
        spread()
    elif mode == "host":
        host_parts()
    elif mode == "backward":
        in_turns(args, BACKWARD_SOURCES, "backward-one")
    elif mode == "backward-one":
        backward_one(args[0])
    else:
        sys.exit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Int8 inference quantization of the serving path (port of the JAX
``eval/quantize.py``).

Weights are quantized once, symmetric per output channel; activations
per row (per token) as each product runs.  The int8 x int8 -> int32
products run in the int8 kernels (``ops/kernels/int8_matmul.py`` for a
Linear, the int8 FF and merged-layer kernels for the FF sublayers); the
bias, and everything between the products, stays float32.  The JAX package
swaps its ``nn.Dense`` calls for int8 ones through a Flax interceptor; the
port's modules take the int8 route themselves once their weights are
packed with ``pack_weights("int8")`` (``eval/serving.Inpainter(quantize=
"int8")``), so the table below is for inspection and tests, not a route.

``quantization_error`` reports the masked-frame MPJPE delta of the int8
forward against the float32 one, so that a deployment can gate on it.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Tuple

import torch

from ..ops.kernels.int8_matmul import (int8_dense_plain,  # noqa: F401
                                       quantize_weight)


def quantize_dense_table(state_dict: Mapping) -> Dict[str, Tuple]:
    """{name: (wq int8 (out, in), scale (out,))} for every 2-D Linear weight
    of a state dict (the Dense table's scale form), as the JAX
    ``quantize_dense_table`` covers every 2-D Dense kernel: the attention
    projections (q / k / v packed as ``in_proj_weight``), the FF Linears,
    the SwiGLUs, the embeddings and the head."""
    return {name: quantize_weight(torch.as_tensor(w))
            for name, w in state_dict.items()
            if name.endswith("weight") and torch.as_tensor(w).dim() == 2}


def quantization_error(model, example_inputs, frame_mask=None,
                       **forward_kwargs) -> float:
    """MPJPE delta of the int8 forward against the float32 forward on the
    example batch: the mean over keypoints of the per-point Euclidean
    distance between the two (B, T, K, 2) outputs.  ``frame_mask`` (B, T),
    1 = missing, restricts the mean to the masked frames, the frames the
    model fills.  ``model`` is left as it was; an int8 copy of it runs
    beside it."""
    was_int8 = getattr(model, "int8", False)
    model.pack_weights(None)
    q8 = copy.deepcopy(model)
    q8.pack_weights("int8")
    with torch.no_grad():
        ref = model(*example_inputs, **forward_kwargs)
        got = q8(*example_inputs, **forward_kwargs)
    model.pack_weights("int8" if was_int8 else None)
    d = torch.linalg.vector_norm(got.float() - ref.float(), dim=-1)
    if frame_mask is not None:
        w = torch.as_tensor(frame_mask, dtype=torch.float32,
                            device=d.device)[:, :, None]
        return float((d * w).sum() / torch.clamp(w.sum() * d.shape[-1],
                                                  min=1.0))
    return float(d.mean())


__all__ = ["quantize_dense_table", "quantization_error", "quantize_weight",
           "int8_dense_plain"]

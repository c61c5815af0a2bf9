"""Checkpoint conversion for the port (numpy and torch only).

``params_from_jax`` mirrors ``train/checkpoint.completer_params_to_torch``
of the JAX package: a Flax KeypointCompleter parameter tree (numpy or any
array with ``__array__``) becomes a state dict under the reference
``.pth`` names, which ``KeypointCompleter.load_state_dict`` takes as it
is; ``embedding_params_from_jax`` does the same for the Embedding
autoencoder.  ``adam_state_from_jax`` does the same for the Adam moments
of a JAX train state, so a JAX run continues in the port.
``load_reference_pth`` / ``save_reference_pth`` read and write the
reference checkpoint schema
``{model_state_dict, optimizer_state_dict, input_size, hidden_dim,
num_layers, num_heads, loss}``; a state dict with no ``transformer.`` key
is an Embedding's, as the JAX ``load_reference_checkpoint`` tells them
apart (``is_embedding_state_dict``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

HYPER_KEYS = ("input_size", "hidden_dim", "num_layers", "num_heads")


def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float32, copy=True)


def _linear(sd: Dict, prefix: str, leaf: Mapping) -> None:
    sd[f"{prefix}.weight"] = _np(leaf["kernel"]).T.copy()
    sd[f"{prefix}.bias"] = _np(leaf["bias"])


def params_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax KeypointCompleter params (unrolled layers, with or without the
    outer ``{"params": ...}``) -> reference-named numpy state dict."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, np.ndarray] = {}
    _linear(sd, "input_embedding", params["input_embedding"])
    _linear(sd, "filled_embedding", params["filled_embedding"])
    sd["learned_input_positional_encoder"] = _np(params["learned_input_pos"])
    sd["learned_filled_positional_encoder"] = _np(
        params["learned_filled_pos"])
    for ours, theirs in (("swiglu_input_prev", "swiGlu_input_prev"),
                         ("swiglu_filled_prev", "swiGlu_filled_prev"),
                         ("swiglu_decoded", "swiGlu_decoded")):
        for i in (1, 2, 3):
            _linear(sd, f"{theirs}.fc{i}", params[ours][f"fc{i}"])
    core = params["transformer"]
    layer_ids = sorted(int(k.split("_")[1]) for k in core
                       if k.startswith("encoder_")
                       and k.split("_")[1].isdigit())
    for i in layer_ids:
        for side, attns, norms in (
                ("encoder", (("self_attn", "self_attn"),),
                 ("norm1", "norm2")),
                ("decoder", (("self_attn", "self_attn"),
                             ("cross_attn", "multihead_attn")),
                 ("norm1", "norm2", "norm3"))):
            lp = core[f"{side}_{i}"]
            base = f"transformer.{side}.layers.{i}"
            for ours, theirs in attns:
                at = lp[ours]
                names = ("q_proj", "k_proj", "v_proj")
                sd[f"{base}.{theirs}.in_proj_weight"] = np.concatenate(
                    [_np(at[n]["kernel"]).T for n in names])
                sd[f"{base}.{theirs}.in_proj_bias"] = np.concatenate(
                    [_np(at[n]["bias"]) for n in names])
                _linear(sd, f"{base}.{theirs}.out_proj", at["out_proj"])
            _linear(sd, f"{base}.linear1", lp["ff"]["linear1"])
            _linear(sd, f"{base}.linear2", lp["ff"]["linear2"])
            for nm in norms:
                sd[f"{base}.{nm}.weight"] = _np(lp[nm]["scale"])
                sd[f"{base}.{nm}.bias"] = _np(lp[nm]["bias"])
    for ours, theirs in (("encoder_norm", "transformer.encoder.norm"),
                         ("decoder_norm", "transformer.decoder.norm")):
        sd[f"{theirs}.weight"] = _np(core[ours]["scale"])
        sd[f"{theirs}.bias"] = _np(core[ours]["bias"])
    _linear(sd, "fc_final", params["fc_final"])
    return sd


def embedding_params_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """Flax Embedding params (with or without the outer ``{"params":
    ...}``) -> reference-named numpy state dict (the inverse of the JAX
    ``embedding_params_from_torch``)."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, np.ndarray] = {}
    for name in ("input_embedding", "output_embedding"):
        _linear(sd, name, params[name])
    return sd


def is_embedding_state_dict(sd: Mapping) -> bool:
    """True for the Embedding autoencoder's state dict (no
    ``transformer.`` key), False for a KeypointCompleter's."""
    return not any(k.startswith("transformer.") for k in sd)


def adam_state_from_jax(opt_state, names: Sequence[str],
                        lr: float = 0.0) -> Dict:
    """Optax ``ScaleByAdamState(count, mu, nu)`` over a Flax
    KeypointCompleter tree -> the state dict of a ``torch.optim.Adam``
    whose parameters are ``names`` in that order (the port's
    ``named_parameters()`` order), each moment laid out as
    ``params_from_jax`` lays out its parameter."""
    from ..train.state import BETAS, EPS
    count, mu, nu = opt_state[0], opt_state[1], opt_state[2]
    mu_sd, nu_sd = params_from_jax(mu), params_from_jax(nu)
    missing = [n for n in names if n not in mu_sd]
    if missing:
        raise KeyError(f"no Adam moments for {missing[:3]} ...")
    step = torch.tensor(float(np.asarray(count)))
    state = {i: {"step": step.clone(),
                 "exp_avg": torch.from_numpy(mu_sd[n]),
                 "exp_avg_sq": torch.from_numpy(nu_sd[n])}
             for i, n in enumerate(names)}
    group = torch.optim.Adam([torch.zeros(1)], lr=lr, betas=BETAS,
                             eps=EPS).state_dict()["param_groups"][0]
    group["params"] = list(range(len(names)))
    return {"state": state, "param_groups": [group]}


def state_dict_tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    """numpy or tensor values -> contiguous float32 CPU tensors."""
    return {k: torch.as_tensor(np.ascontiguousarray(v, dtype=np.float32))
            if not isinstance(v, torch.Tensor) else v.float().contiguous()
            for k, v in sd.items()}


def load_reference_pth(path: str) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(state dict on the CPU, hyperparameters) of a reference ``.pth``,
    a KeypointCompleter's or an Embedding's (``is_embedding_state_dict``
    tells them apart)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    hyper = {k: ckpt[k] for k in HYPER_KEYS if k in ckpt}
    return state_dict_tensors(ckpt["model_state_dict"]), hyper


def save_reference_pth(path: str, module, hyper: Mapping,
                       loss: float = float("nan")) -> None:
    """Write ``module``'s state dict (or ``module`` itself when it is a
    state dict) in the reference ``.pth`` schema; ``hyper`` gives
    hidden_dim, num_layers, num_heads (and input_size).  An Embedding has
    no layers or heads: for its state dict they default to 0, which the JAX
    loader reads and its Embedding ignores."""
    sd = module if isinstance(module, Mapping) else module.state_dict()
    sd = {k: v.detach().cpu().contiguous() for k, v in sd.items()}
    embedding = is_embedding_state_dict(sd)

    def depth(key):
        return int(hyper.get(key, 0) if embedding else hyper[key])

    torch.save({
        "model_state_dict": sd,
        "optimizer_state_dict": {},
        "input_size": int(hyper.get("input_size", 108)),
        "hidden_dim": int(hyper["hidden_dim"]),
        "num_layers": depth("num_layers"),
        "num_heads": depth("num_heads"),
        "loss": loss,
    }, path)

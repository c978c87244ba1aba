"""Bridge from the JAX package's flax parameter tree to this port's
``state_dict``, so the parity tests feed identical weights to both.

Takes the tree as nested mappings of numpy arrays (``jax.tree.map(
np.asarray, params)`` on the JAX side) and understands every layout the
reference writes:

- unrolled layers: ``Block_<i>/Attention_0/wq`` ...;
- ``scan_layers``: ``blocks/Block_0/...`` with a leading ``n_layers`` axis;
- the flax norm ``Norm_<k>/RMSNorm_0/scale`` and the ``use_pallas_norm``
  norm ``Norm_<k>/scale``;
- a MoE block's ``MoeMlp_0/{wg,w1,w2}`` in place of ``Mlp_0/{w1,w2}``.

A pipelined JAX config has ``scan_layers`` and so the stacked layout.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .model import ModelConfig

# JAX sub-path inside a block -> this port's name inside ``blocks.<i>``.
_BLOCK_PARAMS = {
    "Attention_0/wq": "attn.wq",
    "Attention_0/wk": "attn.wk",
    "Attention_0/wv": "attn.wv",
    "Attention_0/wo": "attn.wo",
    "Norm_0/scale": "norm1.scale",
    "Norm_1/scale": "norm2.scale",
}
_MLP_PARAMS = {"Mlp_0/w1": "mlp.w1", "Mlp_0/w2": "mlp.w2"}
_MOE_PARAMS = {"MoeMlp_0/wg": "moe.wg", "MoeMlp_0/w1": "moe.w1", "MoeMlp_0/w2": "moe.w2"}


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _canonical(path: str) -> str:
    """Drop flax's ``RMSNorm_0`` level so both norm layouts read the same."""
    return path.replace("/RMSNorm_0/", "/")


def from_jax_params(tree: Mapping, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for ``TransformerLM(cfg)`` holding the same values
    as the flax parameter ``tree`` (f32 CPU tensors)."""
    flat = {_canonical(k): v for k, v in _flatten(tree).items()}
    sd: dict[str, torch.Tensor] = {}

    def put(name: str, value: np.ndarray) -> None:
        sd[name] = torch.from_numpy(np.array(value, dtype=np.float32))

    put("embed", flat.pop("embed"))
    put("pos", flat.pop("pos"))
    put("norm.scale", flat.pop("Norm_0/scale"))
    stacked = any(k.startswith("blocks/") for k in flat)
    block_params = {**_BLOCK_PARAMS, **(_MOE_PARAMS if cfg.n_experts > 0 else _MLP_PARAMS)}
    for sub, name in block_params.items():
        if stacked:
            value = flat.pop(f"blocks/Block_0/{sub}")
            if value.shape[0] != cfg.n_layers:
                raise ValueError(
                    f"stacked {sub} has {value.shape[0]} layers, config has "
                    f"{cfg.n_layers}"
                )
            for i in range(cfg.n_layers):
                put(f"blocks.{i}.{name}", value[i])
        else:
            for i in range(cfg.n_layers):
                put(f"blocks.{i}.{name}", flat.pop(f"Block_{i}/{sub}"))
    if flat:
        raise ValueError(f"unmapped JAX parameters: {sorted(flat)}")
    return sd

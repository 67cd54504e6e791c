"""Weight bridge between the JAX parameter tree and the port's state_dict.

The port's modules carry the flax names and layouts, so the bridge is a
renaming: the flax path joined with dots is the state_dict key
(`ft/WaveNetLayer_3/DilatedConv3_0/kernel` ->
`ft.WaveNetLayer_3.DilatedConv3_0.kernel`) and every array keeps its
layout — DilatedConv3 [3, Cin, Cout], Conv1x1/TorchDense [in, out], LSTM
w_ih [I, 4H], w_hh [H, 4H], b_ih, b_hh (gates i, f, g, o), nn.Embed
[M+2, H], GroupNorm scale/bias, attention_V [H], fs_decoder_attention_W1
[2H, H] and the unused fs_decoder_attention_l3_* parameters.

Pure numpy and torch: the tree is nested dicts of array-likes
(`np.asarray` is applied to each leaf, so jax arrays convert without
this module importing jax).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """Nested dict tree -> {dotted key: float32 CPU tensor} (copies)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if hasattr(v, "items"):  # dict or flax FrozenDict
                walk(v, key)
            else:
                out[key] = torch.from_numpy(np.array(v, dtype=np.float32))

    walk(params, "")
    return out


def state_dict_to_params(state_dict) -> dict:
    """{dotted key: tensor} -> nested dicts of float32 numpy arrays."""
    tree: dict = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy().astype(np.float32, copy=True)
    return tree

"""Parameters across frameworks, as numpy arrays.

``params_from_numpy`` takes the JAX package's dense-LM parameter tree,
with every leaf converted to a numpy array, and returns the port's
``Transformer``.  That tree stacks the layers on a leading axis
(``params["blocks"][...][i]`` is layer i); it is sliced into per-layer
modules here.  The embedding table stays tied: it is the one tensor both
the input embedding and the output head read.  ``params_to_numpy`` is the
inverse.  Only numpy crosses the boundary, so this module imports nothing
of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchCfg
from repro_torch.models.blocks import dtype_of
from repro_torch.models.transformer import Transformer

# (path in the reference tree, attribute path in a DecoderBlock)
_BLOCK_LEAVES = (
    (("ln1", "scale"), "ln1.scale"),
    (("attn", "wq"), "attn.wq"),
    (("attn", "wk"), "attn.wk"),
    (("attn", "wv"), "attn.wv"),
    (("attn", "wo"), "attn.wo"),
    (("ln2", "scale"), "ln2.scale"),
    (("mlp", "w_gate"), "mlp.w_gate"),
    (("mlp", "w_up"), "mlp.w_up"),
    (("mlp", "w_down"), "mlp.w_down"),
)


def _to_torch(arr, dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)    # bf16 -> fp32 is exact
    return torch.tensor(arr).to(device=device, dtype=dtype)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def params_from_numpy(tree, cfg: ArchCfg, device="cuda",
                      dtype: torch.dtype | None = None) -> Transformer:
    """The reference's parameter tree (numpy leaves) as a ``Transformer``.

    ``dtype`` defaults to ``cfg.dtype``; every leaf is cast to it."""
    model = Transformer(cfg, device=device)
    dtype = dtype or dtype_of(cfg)
    model.to(dtype=dtype)
    dev = model.device
    with torch.no_grad():
        model.embed.table.copy_(_to_torch(tree["embed"]["table"], dtype, dev))
        model.final_ln.scale.copy_(
            _to_torch(tree["final_ln"]["scale"], dtype, dev))
        for path, attr in _BLOCK_LEAVES:
            stacked = np.asarray(_leaf(tree["blocks"], path))
            if stacked.shape[0] != cfg.n_layers:
                raise ValueError(f"blocks/{'/'.join(path)} stacks "
                                 f"{stacked.shape[0]} layers, config has "
                                 f"{cfg.n_layers}")
            for i, block in enumerate(model.blocks):
                block.get_parameter(attr).copy_(
                    _to_torch(stacked[i], dtype, dev))
    return model


def params_to_numpy(model: Transformer) -> dict:
    """The reference's tree layout (layers stacked) with fp32 numpy leaves."""
    def np32(t):
        return t.detach().float().cpu().numpy()

    blocks: dict = {}
    for path, attr in _BLOCK_LEAVES:
        node = blocks
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(
            [np32(b.get_parameter(attr)) for b in model.blocks])
    return {"embed": {"table": np32(model.embed.table)},
            "final_ln": {"scale": np32(model.final_ln.scale)},
            "blocks": blocks}

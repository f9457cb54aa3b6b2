"""Parameters across frameworks, as numpy arrays.

``params_from_numpy`` takes the JAX package's dense-LM parameter tree,
with every leaf converted to a numpy array, and returns the port's
``Transformer``.  That tree stacks the layers on a leading axis
(``params["blocks"][...][i]`` is layer i); it is sliced into per-layer
modules here.  The embedding table stays tied: it is the one tensor both
the input embedding and the output head read.  ``params_to_numpy`` is the
inverse.  ``opt_state_from_numpy`` and ``opt_state_to_numpy`` carry the
AdamW state (step, m, v, master) across the same way: the port keeps it
by parameter name, the reference as trees shaped like the parameters.
``resnet_params_from_numpy`` and ``resnet_params_to_numpy`` carry
ResNet-50's parameters, a tree of the same layout in both packages, and
``lstm_params_from_numpy`` (one LSTM layer), ``lstm_lm_params_from_numpy``
and ``lstm_lm_params_to_numpy`` the LSTM language model's alike.  An
untied head (``head.w``), an ungated MLP (no ``w_gate``) and a VLM's
patch projection (``vision_proj``: ``w1``, ``b1``, ``w2``, ``b2``) carry
across as the tree holds them.
A calibrated reference tree (``repro.quant.calibrate_params``, then numpy
leaves) carries across too: each stacked ``QuantizedTensor`` leaf (``q``
(L, k, n), ``scale`` (L, n) or (L,)) is sliced per layer into the port's
``QuantizedTensor``, its storage bits unchanged and laid out K-major, as
the port's own calibration stores them (``core/quantize.py``).
Only numpy crosses the boundary, so this module imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchCfg
from repro_torch.core.dispatch import check_device
from repro_torch.core.quantize import (TORCH_DTYPES, QuantizedTensor,
                                       install)
from repro_torch.models import lstm_lm, resnet
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


_VISION_LEAVES = ("w1", "b1", "w2", "b2")    # a VLM's patch projection


def _to_torch(arr, dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)    # bf16 -> fp32 is exact
    return torch.tensor(arr).to(device=device, dtype=dtype)


def _storage_to_torch(arr, device) -> torch.Tensor:
    """Quantized storage (int8, or ml_dtypes' fp8, which ``from_numpy``
    refuses) as the same bits in a torch tensor."""
    arr = np.array(arr)                  # a writable, contiguous copy
    dtype = TORCH_DTYPES[arr.dtype.name]
    if dtype == torch.int8:
        return torch.from_numpy(arr).to(device)
    return torch.from_numpy(arr.view(np.uint8)).view(dtype).to(device)


def _is_quantized(leaf) -> bool:
    """A calibrated leaf of the reference (``q`` and ``scale`` children)."""
    return hasattr(leaf, "q") and hasattr(leaf, "scale")


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _block_leaves(cfg: ArchCfg):
    """_BLOCK_LEAVES of ``cfg``'s blocks: no ``w_gate`` in a plain MLP."""
    return [(path, attr) for path, attr in _BLOCK_LEAVES
            if cfg.gated_mlp or path != ("mlp", "w_gate")]


def _one(leaf):
    """A leaf, or a calibrated one's (q, scale)."""
    if _is_quantized(leaf):
        return np.asarray(leaf.q), np.asarray(leaf.scale)
    return leaf


def named_leaves(tree, cfg: ArchCfg):
    """(parameter name, numpy array) for every leaf of a reference tree,
    the stacked layers sliced per layer."""
    yield "embed.table", tree["embed"]["table"]
    yield "final_ln.scale", tree["final_ln"]["scale"]
    if not cfg.tie_embeddings:
        yield "head.w", _one(tree["head"]["w"])
    if cfg.n_patches:
        for key in _VISION_LEAVES:
            yield f"vision_proj.{key}", tree["vision_proj"][key]
    for path, attr in _block_leaves(cfg):
        leaf = _leaf(tree["blocks"], path)
        stacked = (np.asarray(leaf.q) if _is_quantized(leaf)
                   else np.asarray(leaf))
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks/{'/'.join(path)} stacks "
                             f"{stacked.shape[0]} layers, config has "
                             f"{cfg.n_layers}")
        for i in range(cfg.n_layers):
            if _is_quantized(leaf):   # (q, scale) of layer i
                yield (f"blocks.{i}.{attr}",
                       (stacked[i], np.asarray(leaf.scale)[i]))
            else:
                yield f"blocks.{i}.{attr}", stacked[i]


def _tree_of(named) -> dict:
    """The reference's tree layout (layers stacked) with fp32 numpy leaves,
    from tensors by parameter name."""
    def np32(t):
        return t.detach().float().cpu().numpy()

    n_layers = len({n.split(".")[1] for n in named if n.startswith("blocks.")})
    blocks: dict = {}
    for path, attr in _BLOCK_LEAVES:
        if f"blocks.0.{attr}" not in named:      # w_gate of a plain MLP
            continue
        node = blocks
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(
            [np32(named[f"blocks.{i}.{attr}"]) for i in range(n_layers)])
    tree = {"embed": {"table": np32(named["embed.table"])},
            "final_ln": {"scale": np32(named["final_ln.scale"])},
            "blocks": blocks}
    if "head.w" in named:
        tree["head"] = {"w": np32(named["head.w"])}
    if "vision_proj.w1" in named:
        tree["vision_proj"] = {key: np32(named[f"vision_proj.{key}"])
                               for key in _VISION_LEAVES}
    return tree


def params_from_numpy(tree, cfg: ArchCfg, device="cuda",
                      dtype: torch.dtype | None = None) -> Transformer:
    """The reference's parameter tree (numpy leaves) as a ``Transformer``.

    ``dtype`` defaults to ``cfg.dtype``; every leaf is cast to it but the
    calibrated ones, which keep their storage and fp32 scales."""
    model = Transformer(cfg, device=device)
    dtype = dtype or dtype_of(cfg)
    model.to(dtype=dtype)
    named = dict(model.named_parameters())
    with torch.no_grad():
        for name, arr in named_leaves(tree, cfg):
            if isinstance(arr, tuple):
                q, scale = arr
                # K-major, as quantize_weight stores it (a copy)
                install(model, name, QuantizedTensor(
                    _storage_to_torch(q, model.device).mT.contiguous().mT,
                    _to_torch(scale, torch.float32, model.device)))
            else:
                named[name].copy_(_to_torch(arr, dtype, model.device))
    return model


def params_to_numpy(model: Transformer) -> dict:
    """The reference's tree layout (layers stacked) with fp32 numpy leaves."""
    return _tree_of(dict(model.named_parameters()))


def opt_state_from_numpy(tree, cfg: ArchCfg, device="cuda") -> dict:
    """The reference's AdamW state ``{"step", "m", "v", "master"}`` (numpy
    leaves) as the port's: a Python int step and fp32 tensors by parameter
    name on ``device``."""
    device = check_device(device)
    return {"step": int(np.asarray(tree["step"])),
            **{key: {name: _to_torch(arr, torch.float32, device)
                     for name, arr in named_leaves(tree[key], cfg)}
               for key in ("m", "v", "master")}}


def opt_state_to_numpy(state) -> dict:
    """The port's AdamW state in the reference's layout: an int32 step and
    fp32 numpy trees."""
    return {"step": np.asarray(state["step"], np.int32),
            **{key: _tree_of(state[key]) for key in ("m", "v", "master")}}


def resnet_params_from_numpy(tree, cfg: resnet.ResNetCfg, device="cuda"):
    """The reference's ResNet parameter tree (numpy leaves) as the port's,
    fp32 tensors on ``device``; raises where the tree's keys, block counts
    or leaf shapes differ from ``cfg``'s."""
    device = check_device(device)

    def convert(want, got, path):
        if isinstance(want, dict):
            if set(got) != set(want):
                raise ValueError(f"{path or 'params'}: keys {sorted(got)}, "
                                 f"config has {sorted(want)}")
            return {k: convert(want[k], got[k], f"{path}/{k}") for k in want}
        if isinstance(want, list):
            if len(got) != len(want):
                raise ValueError(f"{path}: {len(got)} entries, config has "
                                 f"{len(want)}")
            return [convert(a, b, f"{path}/{i}")
                    for i, (a, b) in enumerate(zip(want, got))]
        arr = np.asarray(got)
        if arr.shape != tuple(want.shape):
            raise ValueError(f"{path}: shape {arr.shape}, config has "
                             f"{tuple(want.shape)}")
        return _to_torch(arr, torch.float32, device)

    return convert(resnet.init_params(cfg, device="meta"), tree, "")


def _numpy_tree(params):
    """A nested dict / list of tensors as the same tree of fp32 numpy."""
    return resnet.map_params(lambda t: t.detach().float().cpu().numpy(),
                             params)


def resnet_params_to_numpy(params):
    """The port's ResNet parameters as the reference's tree, fp32 numpy."""
    return _numpy_tree(params)


def lstm_params_from_numpy(tree, device="cuda", dtype=torch.float32):
    """One reference LSTM layer ``{"w", "r", "b"}`` (numpy leaves) as the
    port's, tensors of ``dtype`` on ``device``."""
    device = check_device(device)
    return {k: _to_torch(tree[k], dtype, device) for k in ("w", "r", "b")}


def lstm_lm_params_from_numpy(tree, cfg: lstm_lm.LSTMLMCfg, device="cuda"):
    """The reference's LSTM-LM tree (numpy leaves) as the port's, in
    ``cfg.dtype`` on ``device``; raises where its layer count differs."""
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"layers: {len(tree['layers'])} entries, config "
                         f"has {cfg.n_layers}")
    device = check_device(device)
    dt = getattr(torch, cfg.dtype)
    return {"embed": {"table": _to_torch(tree["embed"]["table"], dt,
                                         device)},
            "layers": [lstm_params_from_numpy(lp, device, dt)
                       for lp in tree["layers"]]}


def lstm_lm_params_to_numpy(params):
    """The port's LSTM-LM parameters (or gradients) as the reference's
    tree, fp32 numpy."""
    return _numpy_tree(params)

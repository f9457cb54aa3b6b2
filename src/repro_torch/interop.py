"""Parameters across frameworks, as numpy arrays.

``params_from_numpy`` takes the JAX package's decoder-LM parameter tree,
with every leaf converted to a numpy array, and returns the port's
``Transformer``.  That tree stacks the layers on a leading axis
(``params["blocks"][...][i]`` is layer i); it is sliced into per-layer
modules here.  The mla_moe family's two stacks, ``dense_blocks`` then
``moe_blocks``, are the port's ``blocks.0 ..`` in that order, and its
``mtp_block`` (one block, not stacked) the port's ``mtp_block``.  A leaf's
path in a block is its parameter name split at the dots (``attn.wq``,
``attn.q_norm.scale``, ``moe.router``, ``moe.shared.w_up``, ...): the two
packages nest a block's parameters alike.  The embedding table stays
tied: it is the one tensor both the input embedding and the output head
read.  ``params_to_numpy`` is the inverse.  ``opt_state_from_numpy``
and ``opt_state_to_numpy`` carry the AdamW state (step, m, v, master)
across the same way: the port keeps it by parameter name, the reference
as trees shaped like the parameters.
``resnet_params_from_numpy`` and ``resnet_params_to_numpy`` carry
ResNet-50's parameters, a tree of the same layout in both packages, and
``lstm_params_from_numpy`` (one LSTM layer), ``lstm_lm_params_from_numpy``
and ``lstm_lm_params_to_numpy`` the LSTM language model's alike.  An
untied head (``head.w``), an ungated MLP (no ``w_gate``) and a VLM's
patch projection (``vision_proj``: ``w1``, ``b1``, ``w2``, ``b2``) carry
across as the tree holds them.  The encoder-decoder's tree stacks its
``enc_blocks`` (``ln1``, ``attn.*``, ``ln2``, ``mlp.*``) and
``dec_blocks`` (``ln1``, ``self_attn.*``, ``ln_x``, ``cross_attn.*``,
``ln2``, ``mlp.*``) apart, beside ``enc_ln``, ``final_ln`` and ``head.w``:
the port's ``EncDec`` (``enc_blocks.0 ..``, ``dec_blocks.0 ..``).
A calibrated reference tree (``repro.quant.calibrate_params``, then numpy
leaves) carries across too, the recurrent configs' nested stacks among
them: each stacked ``QuantizedTensor`` leaf (``q`` (L, ..., k, n),
``scale`` (L, ..., n) or (L, ...)) is sliced per layer into the port's
``QuantizedTensor``, its storage bits unchanged and laid out K-major, as
the port's own calibration stores them (``core/quantize.py``).
Only numpy crosses the boundary, so this module imports nothing of JAX.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import ArchCfg
from repro_torch.core.dispatch import check_device
from repro_torch.core.quantize import (TORCH_DTYPES, QuantizedTensor,
                                       install)
from repro_torch.models import encdec, lstm_lm, resnet
from repro_torch.models.blocks import (RECURRENT, RECURRENT_BLOCKS,
                                       DecoderBlock, dtype_of,
                                       recurrent_layout)
from repro_torch.models.transformer import Transformer


_VISION_LEAVES = ("w1", "b1", "w2", "b2")    # a VLM's patch projection
# the port's stacks of layers: the decoder LMs' and the encoder-decoder's
# two
_STACKS = ("blocks", "enc_blocks", "dec_blocks")


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


def _leaf(tree, attr):
    for key in attr.split("."):
        tree = tree[key]
    return tree


@functools.lru_cache(maxsize=None)
def _block_attrs(cfg: ArchCfg, use_moe: bool) -> tuple[str, ...]:
    """The parameter names of one of ``cfg``'s decoder blocks, each the
    path of its leaf in the reference's tree (no ``w_gate`` in a plain
    MLP; ``moe.*`` for an MoE block, MLA's projections for an MLA one)."""
    block = DecoderBlock(cfg, use_moe=use_moe, device="meta")
    return tuple(name for name, _ in block.named_parameters())


@functools.lru_cache(maxsize=None)
def _kind_attrs(cfg: ArchCfg, kind: str) -> tuple[str, ...]:
    """The parameter names of a recurrent config's block of ``kind``, each
    the path of its leaf in the reference's tree (``mlstm.wq``,
    ``rglru.lam``, ``attn.wq``, ``mlp.w_gate``, ...)."""
    block = RECURRENT_BLOCKS[kind](cfg, device="meta")
    return tuple(name for name, _ in block.named_parameters())


def _recurrent_leaves(tree, cfg: ArchCfg):
    """(parameter name, numpy array) of every layer of a recurrent
    config: layer i's leaves sliced from its stack at its index
    (``blocks.recurrent_layout``: ``mlstm_groups`` (g, per, ...),
    ``slstm_groups`` (g, ...), ``groups.rec`` (g, n_rec, ...),
    ``groups.attn`` (g, ...), ``tail_rec`` (tail, ...)); a calibrated
    leaf's (q, scale) alike."""
    for i, (kind, stack, idx) in enumerate(recurrent_layout(cfg)):
        for attr in _kind_attrs(cfg, kind):
            leaf = _leaf(_leaf(tree, stack), attr)
            yield f"blocks.{i}.{attr}", (
                (np.asarray(leaf.q)[idx], np.asarray(leaf.scale)[idx])
                if _is_quantized(leaf) else np.asarray(leaf)[idx])


def _recurrent_tree(named, cfg: ArchCfg) -> dict:
    """The reference's nested stacks of a recurrent config's layers, from
    tensors by parameter name (fp32 numpy leaves)."""
    tree: dict = {}
    at: dict[str, list] = {}
    for i, (kind, stack, idx) in enumerate(recurrent_layout(cfg)):
        at.setdefault(stack, []).append((i, kind, idx))
    for stack, layers in at.items():
        kind = layers[0][1]
        dims = tuple(max(idx[d] for _, _, idx in layers) + 1
                     for d in range(len(layers[0][2])))
        for attr in _kind_attrs(cfg, kind):
            first = named[f"blocks.{layers[0][0]}.{attr}"]
            arr = np.empty(dims + tuple(first.shape), np.float32)
            for i, _, idx in layers:
                arr[idx] = named[f"blocks.{i}.{attr}"].detach().float() \
                    .cpu().numpy()
            _put(tree, f"{stack}.{attr}", arr)
    return tree


@functools.lru_cache(maxsize=None)
def _encdec_attrs(cfg: ArchCfg, stack: str) -> tuple[str, ...]:
    """The parameter names of an encoder (``enc_blocks``) or decoder
    (``dec_blocks``) layer of the encoder-decoder."""
    cls = encdec.EncoderBlock if stack == "enc_blocks" else \
        encdec.DecoderBlock
    return tuple(name for name, _ in cls(cfg, device="meta")
                 .named_parameters())


def _stacks(cfg: ArchCfg):
    """(key in the reference's tree, first layer, layers, attrs of a
    layer, the port's name of the stack) of each stack of layers: MLA's
    dense and MoE layers are the port's ``blocks`` in that order."""
    if cfg.block == "encdec":
        return tuple((key, 0, n, _encdec_attrs(cfg, key), key)
                     for key, n in (("enc_blocks", cfg.n_enc_layers),
                                    ("dec_blocks", cfg.n_layers)))
    if cfg.block == "mla_moe":
        nd = cfg.n_dense_layers
        return (("dense_blocks", 0, nd, _block_attrs(cfg, False), "blocks"),
                ("moe_blocks", nd, cfg.n_layers - nd,
                 _block_attrs(cfg, True), "blocks"))
    return (("blocks", 0, cfg.n_layers,
             _block_attrs(cfg, cfg.block == "moe"), "blocks"),)


@functools.lru_cache(maxsize=None)
def stacked_leaves(cfg: ArchCfg) -> dict[str, str]:
    """Each layer parameter's leaf in the reference's tree, by the port's
    name: ``"blocks.3.attn.wq"`` -> ``"blocks.attn.wq"``, MLA's dense and
    MoE layers into ``dense_blocks`` / ``moe_blocks``, a recurrent
    config's into its nested stacks.  The layers one stacked leaf holds
    share its name; a parameter outside the stacks (the embedding, the
    final norm, an untied head, MTP's block) is not listed."""
    if cfg.block in RECURRENT:
        return {f"blocks.{i}.{attr}": f"{stack}.{attr}"
                for i, (kind, stack, _) in enumerate(recurrent_layout(cfg))
                for attr in _kind_attrs(cfg, kind)}
    return {f"{port}.{first + i}.{attr}": f"{key}.{attr}"
            for key, first, count, attrs, port in _stacks(cfg)
            for attr in attrs for i in range(count)}


@functools.lru_cache(maxsize=None)
def stack_dims(cfg: ArchCfg) -> dict[str, tuple[int, ...]]:
    """The leading stack dims of each layer parameter's leaf in the
    reference's tree, by the port's name (``"blocks.3.attn.wq"`` ->
    ``(n_layers,)``; a recurrent config's nested stacks two, as
    ``groups.rec`` (g, n_rec)); the names of ``stacked_leaves``."""
    if cfg.block in RECURRENT:
        dims: dict[str, list[int]] = {}
        for kind, stack, idx in recurrent_layout(cfg):
            top = dims.setdefault(stack, [0] * len(idx))
            dims[stack] = [max(a, b + 1) for a, b in zip(top, idx)]
        return {f"blocks.{i}.{attr}": tuple(dims[stack])
                for i, (kind, stack, _) in enumerate(recurrent_layout(cfg))
                for attr in _kind_attrs(cfg, kind)}
    return {f"{port}.{first + i}.{attr}": (count,)
            for key, first, count, attrs, port in _stacks(cfg)
            for attr in attrs for i in range(count)}


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
    if cfg.block == "encdec":
        yield "enc_ln.scale", tree["enc_ln"]["scale"]
    if not cfg.tie_embeddings:
        yield "head.w", _one(tree["head"]["w"])
    if cfg.n_patches:
        for key in _VISION_LEAVES:
            yield f"vision_proj.{key}", tree["vision_proj"][key]
    if cfg.block in RECURRENT:
        yield from _recurrent_leaves(tree, cfg)
        return
    for key, first, count, attrs, port in _stacks(cfg):
        for attr in attrs:
            leaf = _leaf(tree[key], attr)
            stacked = (np.asarray(leaf.q) if _is_quantized(leaf)
                       else np.asarray(leaf))
            if stacked.shape[0] != count:
                raise ValueError(f"{key}/{attr.replace('.', '/')} stacks "
                                 f"{stacked.shape[0]} layers, config has "
                                 f"{count}")
            for i in range(count):
                name = f"{port}.{first + i}.{attr}"
                if _is_quantized(leaf):   # (q, scale) of layer i
                    yield name, (stacked[i], np.asarray(leaf.scale)[i])
                else:
                    yield name, stacked[i]
    if cfg.block == "mla_moe" and cfg.mtp:
        for attr in _block_attrs(cfg, False):
            yield f"mtp_block.{attr}", _one(_leaf(tree["mtp_block"], attr))


def _put(tree: dict, attr: str, value) -> None:
    *path, last = attr.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[last] = value


def _tree_of(named, cfg: ArchCfg | None = None) -> dict:
    """The reference's tree layout (layers stacked: mla_moe's dense and MoE
    layers apart) with fp32 numpy leaves, from tensors by parameter
    name.  The family is ``cfg.block``'s; without a ``cfg``, a tree is
    mla_moe's where its MLA layers hold MoE layers among them (a dense
    MLA tree is ``blocks``, as the reference's)."""
    def np32(t):
        return t.detach().float().cpu().numpy()

    attrs: dict[str, dict[int, list[str]]] = {}
    for name in named:
        port, _, rest = name.partition(".")
        if port in _STACKS:
            i, attr = rest.split(".", 1)
            attrs.setdefault(port, {}).setdefault(int(i), []).append(attr)
    stacks = {}      # key in the reference's tree -> (port's stack, layers)
    for port, by_layer in attrs.items():
        layers = sorted(by_layer)
        mla_moe = (cfg.block == "mla_moe" if cfg is not None else
                   "attn.wq_a" in by_layer[layers[0]] and any(
                       "moe.router" in by_layer[i] for i in layers))
        if mla_moe:                                   # two stacks
            moe = [i for i in layers if "moe.router" in by_layer[i]]
            stacks["dense_blocks"] = (port, [i for i in layers
                                             if i not in moe])
            stacks["moe_blocks"] = (port, moe)
        else:
            stacks[port] = (port, layers)
    tree = {"embed": {"table": np32(named["embed.table"])},
            "final_ln": {"scale": np32(named["final_ln.scale"])}}
    if "enc_ln.scale" in named:
        tree["enc_ln"] = {"scale": np32(named["enc_ln.scale"])}
    for key, (port, ids) in stacks.items():
        node = tree.setdefault(key, {})
        for attr in attrs[port][ids[0]] if ids else ():
            _put(node, attr, np.stack(
                [np32(named[f"{port}.{i}.{attr}"]) for i in ids]))
    for name, t in named.items():
        if name.startswith("mtp_block."):
            _put(tree.setdefault("mtp_block", {}), name[len("mtp_block."):],
                 np32(t))
    if "head.w" in named:
        tree["head"] = {"w": np32(named["head.w"])}
    if "vision_proj.w1" in named:
        tree["vision_proj"] = {key: np32(named[f"vision_proj.{key}"])
                               for key in _VISION_LEAVES}
    return tree


def params_from_numpy(tree, cfg: ArchCfg, device="cuda",
                      dtype: torch.dtype | None = None):
    """The reference's parameter tree (numpy leaves) as a ``Transformer``,
    or an encoder-decoder's as an ``EncDec``.

    ``dtype`` defaults to ``cfg.dtype``; every leaf is cast to it but the
    calibrated ones, which keep their storage and fp32 scales."""
    model = (encdec.EncDec if cfg.block == "encdec" else Transformer)(
        cfg, device=device)
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


def params_to_numpy(model) -> dict:
    """The reference's tree layout (layers stacked; a recurrent config's
    in its nested stacks) with fp32 numpy leaves."""
    named = dict(model.named_parameters())
    if model.cfg.block not in RECURRENT:
        return _tree_of(named, model.cfg)
    tree = _tree_of({k: v for k, v in named.items()
                     if not k.startswith("blocks.")}, model.cfg)
    tree.update(_recurrent_tree(named, model.cfg))
    return tree


def opt_state_from_numpy(tree, cfg: ArchCfg, device="cuda") -> dict:
    """The reference's AdamW state ``{"step", "m", "v", "master"}`` (numpy
    leaves) as the port's: a Python int step and fp32 tensors by parameter
    name on ``device``."""
    device = check_device(device)
    return {"step": int(np.asarray(tree["step"])),
            **{key: {name: _to_torch(arr, torch.float32, device)
                     for name, arr in named_leaves(tree[key], cfg)}
               for key in ("m", "v", "master")}}


def opt_state_to_numpy(state, cfg: ArchCfg | None = None) -> dict:
    """The port's AdamW state in the reference's layout: an int32 step and
    fp32 numpy trees (``cfg``'s stacks; see :func:`_tree_of` without)."""
    return {"step": np.asarray(state["step"], np.int32),
            **{key: _tree_of(state[key], cfg)
               for key in ("m", "v", "master")}}


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

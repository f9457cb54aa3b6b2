"""ResNet-50 (the paper's Sec. 4.2.2 workload) on the direct convolution.

As the reference's ``repro/models/resnet.py``: NHWC images, bottleneck
blocks with the stride on the 3x3 convolution, a projection where the
shape changes, a ``width`` factor that scales every channel count (64 is
ResNet-50), batch normalisation with the batch's own statistics.  Every
convolution runs through ``kernels.conv2d`` and the head through
``matmul``; the rest (normalisation, ReLU, pooling, the loss) is plain
PyTorch.  Parameters are a nested dict with the reference's tree:
``stem``, ``bn_stem``, ``stages[s][b]`` with ``conv1..3``, ``bn1..3`` and,
where the block projects, ``proj`` / ``bn_proj``, and ``head``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.dispatch import check_device
from repro_torch.layers import conv as conv_layer
from repro_torch.layers import linear


@dataclasses.dataclass(frozen=True)
class ResNetCfg:
    n_classes: int = 1000
    width: int = 64               # 64 = full ResNet-50
    stage_blocks: tuple = (3, 4, 6, 3)


def block_stride(si: int, bi: int) -> int:
    return 2 if (bi == 0 and si > 0) else 1


def _bn_init(c, device):
    return {"scale": torch.ones(c, device=device),
            "bias": torch.zeros(c, device=device)}


def batch_norm(params, x):
    """Normalise over (N, H, W) with the batch's mean and population
    variance (eps 1e-5), in fp32; the result in x's dtype."""
    x32 = x.float()
    mean = x32.mean((0, 1, 2), keepdim=True)
    var = x32.var((0, 1, 2), keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


def max_pool(x):
    """NHWC 3x3 max pool, stride 2, with ``"SAME"`` padding as
    ``jax.lax.reduce_window`` pads it: the total pad split low-half first,
    so 112 -> 56 pads (0, 1), not ``F.max_pool2d(padding=1)``'s (1, 1)."""
    pads = []
    for size in (x.shape[2], x.shape[1]):      # F.pad's order: W, then H
        total = max((-(-size // 2) - 1) * 2 + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    xc = F.pad(x.permute(0, 3, 1, 2), pads, value=float("-inf"))
    return F.max_pool2d(xc, 3, 2).permute(0, 2, 3, 1).contiguous()


def _bottleneck_init(cin, cmid, cout, stride, gen, device):
    def conv(c, k, r):
        return conv_layer.init(c, k, r, r, use_bias=False, generator=gen,
                               device=device)

    p = {"conv1": conv(cin, cmid, 1), "bn1": _bn_init(cmid, device),
         "conv2": conv(cmid, cmid, 3), "bn2": _bn_init(cmid, device),
         "conv3": conv(cmid, cout, 1), "bn3": _bn_init(cout, device)}
    if stride != 1 or cin != cout:
        p["proj"] = conv(cin, cout, 1)
        p["bn_proj"] = _bn_init(cout, device)
    return p


def _bottleneck(p, x, stride, backend):
    h = F.relu(batch_norm(p["bn1"], conv_layer.apply(
        p["conv1"], x, backend=backend)))
    h = F.relu(batch_norm(p["bn2"], conv_layer.apply(
        p["conv2"], h, stride=stride, padding=1, backend=backend)))
    h = batch_norm(p["bn3"], conv_layer.apply(p["conv3"], h,
                                              backend=backend))
    if "proj" in p:
        x = batch_norm(p["bn_proj"], conv_layer.apply(
            p["proj"], x, stride=stride, backend=backend))
    return F.relu(x + h)


def init_params(cfg: ResNetCfg, generator: torch.Generator | None = None,
                device="cuda"):
    """Random fp32 weights with the reference's distributions: He-normal
    convolutions, a ``C ** -0.5`` normal head with a zero bias, unit
    normalisation scales and zero shifts.  Draws come from ``generator``
    (default: a CPU generator seeded 0)."""
    device = check_device(device)
    w = cfg.width
    p = {"stem": conv_layer.init(3, w, 7, 7, use_bias=False,
                                 generator=generator, device=device),
         "bn_stem": _bn_init(w, device), "stages": []}
    cin = w
    for si, n_blocks in enumerate(cfg.stage_blocks):
        cmid = w * 2 ** si
        cout = cmid * 4
        stage = []
        for bi in range(n_blocks):
            stage.append(_bottleneck_init(cin, cmid, cout,
                                          block_stride(si, bi), generator,
                                          device))
            cin = cout
        p["stages"].append(stage)
    p["head"] = linear.init(cin, cfg.n_classes, generator=generator,
                            device=device)
    return p


def map_params(fn, tree):
    """The tree with ``fn`` applied to every tensor (e.g. a dtype cast)."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_params(fn, v) for v in tree]
    return fn(tree)


def named_leaves(tree, prefix: str = ""):
    """``[(name, tensor)]`` in the tree's order, names like
    ``stages.1.0.conv2.w``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return [(prefix, tree)]
    return [leaf for k, v in items
            for leaf in named_leaves(v, f"{prefix}.{k}" if prefix else k)]


def forward(params, x, cfg: ResNetCfg, *, backend: str | None = None):
    """x: (N, H, W, 3) -> logits (N, n_classes), in the parameters'
    dtype."""
    h = conv_layer.apply(params["stem"], x, stride=2, padding=3,
                         backend=backend)
    h = max_pool(F.relu(batch_norm(params["bn_stem"], h)))
    for si, stage in enumerate(params["stages"]):
        for bi, block in enumerate(stage):
            h = _bottleneck(block, h, block_stride(si, bi), backend)
    return linear.apply(params["head"], h.mean((1, 2)), backend=backend)


def loss_fn(params, x, labels, cfg: ResNetCfg, *,
            backend: str | None = None):
    """Mean cross-entropy of the logits against integer ``labels``, in
    fp32."""
    logits = forward(params, x, cfg, backend=backend).float()
    return F.cross_entropy(logits, labels.long())


def loss_and_grads(params, x, labels, cfg: ResNetCfg, *,
                   backend: str | None = None):
    """(loss, gradient tree shaped like ``params``); the images take no
    gradient."""
    leaves = [t.detach().requires_grad_() for _, t in named_leaves(params)]
    it = iter(leaves)
    loss = loss_fn(map_params(lambda _: next(it), params), x, labels, cfg,
                   backend=backend)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), map_params(lambda _: next(grads), params)

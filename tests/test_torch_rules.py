"""Rules of the port: no JAX, no reference package, no silent fallback, no
quiet CPU run, and a chip smoke script that fails where it cannot run."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import dispatch
from repro_torch.kernels.brgemm import (batched_matmul, batched_matmul_cuda,
                                        brgemm, brgemm_stacked_cuda, matmul,
                                        matmul_cuda)
from repro_torch.kernels.conv2d import conv2d, conv2d_cuda
from repro_torch.kernels.flash_attention import (delta_rowsum_cuda,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_cuda)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_reference(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):"
        "\n    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_defaults_raise_without_cuda(monkeypatch):
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.interop import (opt_state_from_numpy,
                                     opt_state_to_numpy,
                                     resnet_params_from_numpy,
                                     resnet_params_to_numpy)
    from repro_torch.launch.train import run
    from repro_torch.layers import conv as conv_layer
    from repro_torch.layers import linear
    from repro_torch.models import api, resnet
    from repro_torch.serve import (ContinuousEngine, Engine, PagedKVCache,
                                   PoolConfig, ServeConfig, SlotKVCache)
    from repro_torch.train.optimizer import AdamWCfg
    from repro_torch.train.train_step import init_state
    cfg = configs.get("smollm-135m").reduced()
    params = api.init_params(cfg, device="cpu")
    rcfg = resnet.ResNetCfg(n_classes=10, width=4, stage_blocks=(1, 1, 1, 1))
    rtree = resnet_params_to_numpy(resnet.init_params(rcfg, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet.init_params(rcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet_params_from_numpy(rtree, rcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conv_layer.init(3, 8, 3, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linear.init(8, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params, ServeConfig(max_len=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(cfg, params, PoolConfig(n_slots=2, max_len=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotKVCache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(cfg, 2, 8, page_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(cfg, AdamWCfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(cfg, ShapeCfg("t", "train", 8, 2), steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt_state_from_numpy(opt_state_to_numpy(
            init_state(cfg, AdamWCfg(), device="cpu")["opt"]), cfg)


def test_explicit_cuda_backend_on_cpu_tensors_raises():
    x, w = torch.ones(4, 8), torch.ones(8, 3)
    q = torch.ones(1, 2, 4, 32)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        matmul(x, w, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention(q, q, q, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention_bwd(q, q, q, q, lse, q, backend="cuda")
    img, kern = torch.ones(1, 5, 5, 3), torch.ones(3, 3, 3, 4)
    a, b = torch.ones(2, 4, 8), torch.ones(2, 8, 3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        conv2d(img, kern, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        brgemm(a, b, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        batched_matmul(a, b, backend="cuda")
    with dispatch.use(backend="cuda"), pytest.raises(ValueError):
        matmul(x, w)
    with dispatch.use(backend="cuda"), pytest.raises(ValueError):
        conv2d(img, kern)
    # The wrappers themselves refuse CPU tensors before building anything.
    counters = (matmul_cuda, flash_attention_cuda, flash_attention_bwd_cuda,
                delta_rowsum_cuda, conv2d_cuda, brgemm_stacked_cuda,
                batched_matmul_cuda)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError):
        matmul_cuda(x, w)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, q, q, q, lse, q)
    with pytest.raises(ValueError):
        delta_rowsum_cuda(q, q)
    with pytest.raises(ValueError):
        conv2d_cuda(img, kern)
    with pytest.raises(ValueError):
        brgemm_stacked_cuda(a, b)
    with pytest.raises(ValueError):
        batched_matmul_cuda(a, b)
    assert [c.launches for c in counters] == before


def test_dispatch_precedence(monkeypatch):
    x = torch.ones(2, 2)
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    assert dispatch.resolve("matmul", None, x) == "torch"
    with dispatch.use(backend="torch"):
        assert dispatch.resolve("matmul", None, x) == "torch"
        with dispatch.use():
            assert dispatch.resolve("matmul", None, x) == "torch"
        with pytest.raises(ValueError):   # the argument beats the context
            dispatch.resolve("matmul", "cuda", x)
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.resolve("matmul", "xla", x)
    with pytest.raises(KeyError):
        dispatch.resolve("no_such_op", None, x)
    # The env tier: below the context and the argument, above the hardware.
    monkeypatch.setenv(dispatch.ENV_VAR, "cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.resolve("matmul", None, x)      # no fallback to torch
    with dispatch.use(backend="torch"):
        assert dispatch.resolve("matmul", None, x) == "torch"
    assert dispatch.resolve("matmul", "torch", x) == "torch"
    monkeypatch.setenv(dispatch.ENV_VAR, "torch")
    assert dispatch.resolve("matmul", None, x) == "torch"
    monkeypatch.setenv(dispatch.ENV_VAR, "")     # empty: unset
    assert dispatch.resolve("matmul", None, x) == "torch"


@pytest.mark.parametrize("value", ["xla", "pallas", "CUDA", "gpu"])
def test_dispatch_env_tier_refuses_an_unknown_backend(monkeypatch, value):
    monkeypatch.setenv(dispatch.ENV_VAR, value)
    with pytest.raises(ValueError, match=dispatch.ENV_VAR):
        dispatch.resolve("matmul", None, torch.ones(2, 2))
    # a higher tier is not overruled, and the bad value is never read
    assert dispatch.resolve("matmul", "torch", torch.ones(2, 2)) == "torch"
    with dispatch.use(backend="torch"):
        assert dispatch.resolve("matmul", None, torch.ones(2, 2)) == "torch"


class _FakeCudaTensor:
    """What ``resolve`` reads of a tensor on card 0, without a card."""
    is_cuda = True
    device = torch.device("cuda", 0)


@pytest.fixture
def capability(monkeypatch):
    """Sets the compute capability that card 0 reports."""
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    dispatch._is_hopper.cache_clear()

    def set_to(cap):
        dispatch._is_hopper.cache_clear()
        monkeypatch.setattr(torch.cuda, "get_device_capability",
                            lambda index=None: cap)
    yield set_to
    dispatch._is_hopper.cache_clear()


@pytest.mark.parametrize("cap,want", [((9, 0), "cuda"), ((8, 0), "torch"),
                                      ((8, 9), "torch"), ((10, 0), "torch")])
def test_dispatch_hardware_default_follows_the_capability(capability, cap,
                                                          want):
    capability(cap)
    t = _FakeCudaTensor()
    for op in ("matmul", "flash_attention", "batched_matmul", "conv2d"):
        assert dispatch.resolve(op, None, t) == want
    assert dispatch.resolve("matmul", None, torch.ones(2)) == "torch"
    assert dispatch.resolve("matmul", "torch", t) == "torch"


def test_dispatch_cuda_named_on_another_card_raises(capability,
                                                    monkeypatch):
    capability((8, 0))
    t = _FakeCudaTensor()
    with pytest.raises(ValueError, match="compute capability"):
        dispatch.resolve("matmul", "cuda", t)
    with dispatch.use(backend="cuda"), pytest.raises(ValueError,
                                                     match="capability"):
        dispatch.resolve("matmul", None, t)
    monkeypatch.setenv(dispatch.ENV_VAR, "cuda")
    with pytest.raises(ValueError, match="compute capability"):
        dispatch.resolve("matmul", None, t)
    capability((9, 0))
    assert dispatch.resolve("matmul", None, t) == "cuda"


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(SMOKE)], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

"""Both engines under the quant tiers on the MoE, MLA and recurrent
families against the JAX package on the CPU: grok-1, DeepSeek-V3, xLSTM and
RecurrentGemma (``ArchCfg.reduced()``, fp32) under ``decode_quant="int8"``
and on calibrated int8 and fp8 weights, greedy tokens equal to the
reference's token for token.

Weights are made by the reference from a fixed key and handed over as
numpy arrays (``interop``).  The reference runs with its expert GEMMs on
its kernel path (``batched_matmul`` pinned to Pallas, interpreted; the
rest on XLA, whose quantized GEMMs are the kernels' exact oracles): its
XLA branch computes the experts in full precision whatever the tier, which
the port does not follow (``test_torch_quant_families.py`` says more).
The calibration, the layers, MLA's int8 pages and gradient compression are
held in ``test_torch_quant_families.py``.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import configs as jconfigs
from repro.core import quantize as JQ
from repro.models import api as japi
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch import interop, quant
from repro_torch.serve import (ContinuousEngine, Engine, PoolConfig, Request,
                               ServeConfig)

FAMILIES = ("grok-1-314b", "deepseek-v3-671b", "xlstm-1.3b",
            "recurrentgemma-9b")
TIERS = ("decode_int8", "calibrated_int8", "calibrated_fp8")
MAX_LEN = 32
PIN = {"batched_matmul": {"backend": "pallas"}}


@contextlib.contextmanager
def kernel_path():
    """The reference with its expert GEMMs on its kernel path."""
    with repro.use(axis_specs=PIN, interpret=True):
        yield


@pytest.fixture(scope="module")
def families():
    out = {}
    for name in FAMILIES:
        jcfg, tcfg = jconfigs.get(name).reduced(), tconfigs.get(name).reduced()
        jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (jcfg, tcfg, jparams, interop.params_from_numpy(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    return out


# ==========================================================================
# both engines, every family, every tier
# ==========================================================================

N_TOKENS = 6
PROMPTS = ([5, 9, 2, 7, 1, 3, 8, 4], [11, 6, 13, 2, 9, 10, 1, 5])


def _engine(pkg, cfg, params, tier, cls):
    """An engine of ``pkg`` ("ref" or "port") serving ``tier`` (calibrated
    params already calibrated)."""
    kw = {"decode_quant": "int8"} if tier == "decode_int8" else {}
    if pkg == "port":
        kw["device"] = "cpu"
    if cls == "static":
        scfg = (JServeConfig if pkg == "ref" else ServeConfig)(
            max_len=MAX_LEN)
        return (JEngine if pkg == "ref" else Engine)(cfg, params, scfg, **kw)
    return ContinuousEngine(cfg, params, PoolConfig(n_slots=2,
                                                    max_len=MAX_LEN), **kw)


@pytest.fixture(scope="module")
def reference_tokens(families):
    """The reference's static engine's greedy tokens, each (family, tier)
    made once when first asked for."""
    made = {}

    def get(name, tier):
        if (name, tier) not in made:
            jcfg, _, jparams, _ = families[name]
            if tier != "decode_int8":
                jparams = JQ.calibrate_params(jparams, tier.split("_")[1])
            with kernel_path():
                made[name, tier] = np.asarray(_engine(
                    "ref", jcfg, jparams, tier, "static").generate(
                        {"tokens": jnp.asarray(PROMPTS, jnp.int32)},
                        n_tokens=N_TOKENS, stop_tokens=())).tolist()
        return made[name, tier]
    return get


@pytest.mark.parametrize("cls", ["static", "continuous"])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", FAMILIES)
def test_engine_tiers_match_reference(families, reference_tokens, name,
                                      tier, cls):
    """Greedy tokens equal the reference's, token for token, each engine:
    the static engine's decode routes the batch as one group, the
    continuous engine's slot decode each slot alone (two requests, two
    slots; with the top-2 of 4 or 8 experts a decode group's capacity of
    4 binds nowhere, so both routings give the reference's static tokens,
    as its own continuous engine does); xLSTM's four-column gates and
    sLSTM's fp32 gate GEMM, RG-LRU's gates, MLA's projections quantized
    (its absorbed decode reads wkv_b in full precision, as the
    reference's)."""
    _, tcfg, _, model = families[name]
    if tier != "decode_int8":
        model = quant.calibrate_params(model, tier.split("_")[1])
    engine = _engine("port", tcfg, model, tier, cls)
    assert (engine.decode_quant is not None) == (tier == "decode_int8")
    if cls == "static":
        got = engine.generate({"tokens": torch.tensor(PROMPTS)},
                              n_tokens=N_TOKENS, stop_tokens=()).tolist()
    else:
        out = engine.serve([Request(prompt=list(p), max_tokens=N_TOKENS,
                                    stop_tokens=()) for p in PROMPTS])
        got = [out[i] for i in range(len(PROMPTS))]
        assert engine.pool.n_free == engine.pool.n_slots
    assert got == reference_tokens(name, tier)

"""The static-batch serving engine: prefill one batch, then decode on a host
loop.

``Engine.generate`` keeps the reference's signature and semantics: stop
tokens, the position bookkeeping, and the order of draws.  Greedy is
``argmax``; sampling is Gumbel-max over ``logits / temperature`` with
uniforms drawn from the caller's ``torch.Generator`` (the reference uses
``jax.random.categorical``, which is the same draw rule on other bits).
The engine runs under ``torch.inference_mode()``; its backend, when given,
scopes every op through ``dispatch.use``.  Its quant tiers are the
reference's: prefill runs under ``use(quant=quant)``, decode under
``use(quant=decode_quant)``, which defaults to ``quant`` (the canonical
production mix is ``quant=None`` with ``decode_quant="int8"``: prefill is
compute-bound, decode streams the weights).  A calibrated model
(``quant.calibrate_params``) runs its GEMMs quantized in both phases
without any tier.  ``ContinuousEngine`` and the paged cache come in a later
slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchCfg
from repro_torch.core import dispatch
from repro_torch.core.quantize import as_quant_config
from repro_torch.models import api


@dataclasses.dataclass
class ServeConfig:
    max_len: int
    temperature: float = 0.0   # 0 => greedy


class Engine:
    def __init__(self, cfg: ArchCfg, params, scfg: ServeConfig, *,
                 backend: str | None = None, device="cuda", quant=None,
                 decode_quant=None):
        self.device = dispatch.check_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.backend = backend
        # Normalized (so validated) here, not at the first call.
        self.quant = as_quant_config(quant) if quant is not None else None
        self.decode_quant = (as_quant_config(decode_quant)
                             if decode_quant is not None else self.quant)

    def _sample(self, logits, generator):
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=generator,
                       device=generator.device).to(logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return torch.argmax(logits / self.scfg.temperature + gumbel,
                            dim=-1).to(torch.int32)

    def generate(self, batch, *, n_tokens: int,
                 generator: torch.Generator | None = None,
                 stop_tokens=None):
        """batch: ``{"tokens": (B, T) ints}``.  Returns (B, T') int32 ids on
        the engine's device, T' <= n_tokens.

        ``stop_tokens=None`` defaults to ``(cfg.eos_token,)`` when the config
        has one (pass ``()`` to disable).  With stop tokens the loop ends as
        soon as every row has emitted one; rows that finish early keep
        decoding until the slowest row is done.  ``generator`` (default: a
        CPU generator seeded 0) feeds sampling and is unused when greedy.
        """
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if stop_tokens is None:
            stop_tokens = ((self.cfg.eos_token,)
                           if self.cfg.eos_token is not None else ())
        stops = tuple(stop_tokens)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        b, prompt_len = tokens.shape
        with torch.inference_mode(), dispatch.use(backend=self.backend):
            cache = api.init_cache(self.cfg, b, self.scfg.max_len,
                                   device=self.device)
            with dispatch.use(quant=self.quant):
                logits, cache = api.prefill(self.params, {"tokens": tokens},
                                            self.cfg, cache)
            tok = self._sample(logits, generator)
            out = [tok]
            finished = (np.isin(tok.cpu().numpy(), stops) if stops
                        else None)
            pos = prompt_len
            for _ in range(n_tokens - 1):
                if stops and finished.all():
                    break
                with dispatch.use(quant=self.decode_quant):
                    logits, cache = api.decode_step(
                        self.params, tok[:, None], self.cfg, cache, pos)
                tok = self._sample(logits, generator)
                out.append(tok)
                if stops:
                    finished |= np.isin(tok.cpu().numpy(), stops)
                pos += 1
            return torch.stack(out, dim=1)

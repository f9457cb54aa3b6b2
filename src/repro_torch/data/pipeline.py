"""Deterministic synthetic token stream: sharded, resumable, prefetched.

The same numpy stream as the reference's ``data/pipeline``: batch ``step``
of host ``host_id`` is drawn from ``default_rng((seed, step, host_id))`` as
zipf(1.3) tokens clipped to the vocabulary, labels the tokens shifted by
one, so the two packages train on identical batches.  A background thread
prefetches ahead of the loop; ``start_step`` resumes the stream exactly.
Batches are numpy arrays until the train step moves them to the device.
A batch holds ``tokens`` and ``labels``, a VLM's ``patch_embeds`` and an
encoder-decoder's ``src_embeds`` (``api.encdec_src_len`` frames), each
drawn after the tokens in the reference's order, so that every family's
batch is the reference's bit for bit.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.configs.base import ArchCfg
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.models.api import encdec_src_len, is_encdec, token_len


class TokenPipeline:
    def __init__(self, cfg: ArchCfg, shape: ShapeCfg, *, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1, start_step: int = 0,
                 prefetch: int = 2):
        if shape.global_batch % n_hosts:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = shape.global_batch // n_hosts
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _batch_at(self, step: int) -> dict:
        tl = token_len(self.cfg, self.shape)
        rng = np.random.default_rng((self.seed, step, self.host_id))
        toks = rng.zipf(1.3, size=(self.local_batch, tl + 1))
        toks = np.minimum(toks - 1, self.cfg.vocab - 1).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.n_patches:
            batch["patch_embeds"] = rng.standard_normal(
                (self.local_batch, self.cfg.n_patches, self.cfg.d_model),
                dtype=np.float32)
        if is_encdec(self.cfg):
            batch["src_embeds"] = rng.standard_normal(
                (self.local_batch, encdec_src_len(self.cfg, self.shape),
                 self.cfg.d_model), dtype=np.float32)
        return batch

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self._q.get()
        self._step = step + 1
        return batch

    def __iter__(self):
        return self

    @property
    def step(self) -> int:
        return self._step

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)

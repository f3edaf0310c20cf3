"""Prefill worker: bucketed prompt prefill only, producing KV handoffs
(counterpart of ray_tpu/llm/disagg/prefill.py).

One half of the disaggregated topology.  A prefill worker owns NO paged
cache and NO decode slots: it runs the length-bucketed prefill
(``_model.prefill``, through the flash forward kernel on the card), samples
the first token on the host, and packages the prompt's K/V as a
:class:`KVHandoff` for a decode engine to import.  Long prompts therefore
never stall a decode batch: they burn compute on the prefill tier instead.

On one card the JAX package's "own chips" become the worker's own CUDA
stream: its prefills run there, beside the decode engines' streams, and
each handoff carries an event recorded after its prefill.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from ..._device import DeviceLike, on_stream, resolve_device
from ...models.llama import check_device_supported, check_supported
from ...util import telemetry
from .. import _model
from ..engine import SamplingParams, _to_device, sample_logits
from .handoff import KVHandoff


class PrefillWorker:
    """Runs prefill only, on its own stream; stateless between requests.

    ``params`` already on ``device`` are used, not copied (a prefill tier
    and its decode engines share one set of weights on the card)."""

    def __init__(self, params, cfg, *, device: DeviceLike = None,
                 prefill_buckets: tuple = (64, 256, 1024),
                 page_size: int = 16, seed: int = 0):
        check_supported(cfg)
        self.device = resolve_device(device)
        check_device_supported(cfg, self.device)
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.page_size = page_size
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            # The weights are ready before the worker's stream reads them.
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self._rng = np.random.default_rng(seed)

    def _bucket_for(self, n: int) -> Optional[int]:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return None

    def prefill(self, prompt_tokens: List[int],
                params: Optional[SamplingParams] = None,
                t_submit: float = 0.0) -> KVHandoff:
        """Prefill one prompt and package the handoff (raises ValueError
        for prompts beyond every bucket: the router rejects those at
        admission, before prefill compute is spent)."""
        params = params or SamplingParams()
        n = len(prompt_tokens)
        bucket = self._bucket_for(n)
        if bucket is None:
            raise ValueError(
                f"prompt of {n} tokens exceeds the largest prefill "
                f"bucket ({self.prefill_buckets[-1]})")
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = prompt_tokens
        # Trim the handoff to the prompt's pages rounded UP to a power of
        # two: its bytes stay within 2x the prompt's (not the bucket's),
        # while the decode side's scatter sees at most log2(pages per
        # bucket) distinct shapes instead of one per prompt length.
        need = max(1, math.ceil(n / self.page_size))
        keep = min(bucket, (1 << (need - 1).bit_length()) * self.page_size)
        ready = None
        with on_stream(self.stream), telemetry.profile_span(
                "engine_prefill", "llm",
                extra={"prompt_len": n, "disagg": True}):
            t = torch.from_numpy(toks)
            if self.stream is not None:
                t = t.pin_memory().to(self.device, non_blocking=True)
            logits, ks, vs = _model.prefill(self.params, t, n, self.cfg)
            # Own copies of the kept rows: the bucket's K/V can go.
            ks = ks[:, :keep].contiguous()
            vs = vs[:, :keep].contiguous()
            if self.stream is not None:
                ready = torch.cuda.Event()
                ready.record(self.stream)
            logits = logits.cpu().numpy()
        telemetry.inc("ray_tpu_llm_tokens_total", n,
                      tags={"kind": "prompt"})
        first = sample_logits(logits, params, self._rng)
        return KVHandoff(
            prompt_tokens=list(prompt_tokens), first_token=int(first),
            ks=ks, vs=vs, params=params, t_submit=t_submit,
            t_first=time.perf_counter(), ready=ready)

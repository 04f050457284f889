"""Batched serving engine: prefill + decode with a shared cache pool.

Single-host serving loop over the port's :class:`~repro_torch.models.LM`:
fixed batch slots, greedy / temperature sampling, per-slot stop handling,
and a continuous-batching admission queue (new requests fill freed slots at
step boundaries).  Each slot's cache is a view of the pool, so prefill and
decode write its K/V and recurrent states in place.  A slot's view is
taken on the cache's known axes (block leaves (G, B, ...): axis 1; rest
leaves (B, ...): axis 0); the reference guesses the axis from a leaf's
shape, which picks the wrong one for rest layers when ``batch_slots``
equals the number of groups (ROADMAP.md queue C).

Admission zeroes the slot's recurrent states (Mamba ``h`` / ``conv``,
mLSTM ``C`` / ``n`` / ``m``) before the prefill.  The reference hands the
prefill the slot's old state, which its recurrent layers start from, so a
request served in a reused slot continues the previous request's state
(ROADMAP.md queue C); attention K/V need no reset, as positions past the
prompt are masked until written.
"""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.launch.serve import make_prefill_step, make_serve_step
from repro_torch.models import LM
from .errors import AdmissionError, DeadlineExceededError, QueueFullError

__all__ = ["AdmissionError", "DeadlineExceededError", "QueueFullError",
           "Engine", "Request"]

#: the cache leaves that hold recurrent state (Mamba, mLSTM)
RECURRENT_LEAVES = ("h", "conv", "C", "n", "m")


@dataclass
class Request:
    prompt: np.ndarray               # (P,) int32
    max_new: int = 16
    temperature: float = 0.0
    out: list = field(default_factory=list)
    done: bool = False
    #: per-request deadline (seconds from submit; None: engine default).
    #: An expired request finishes with ``done=True`` and ``error`` set
    #: to DeadlineExceededError instead of silently decoding forever.
    deadline_s: Optional[float] = None
    error: Optional[Exception] = None
    _deadline_at: Optional[float] = field(default=None, repr=False)


class Engine:
    """Serves ``model`` (an :class:`~repro_torch.models.LM` with its
    weights) on the model's device.  Temperature sampling draws from the
    engine's own ``torch.Generator``, seeded by ``seed``.  ``mesh`` /
    ``layout`` (sharded serving) raise NotImplementedError: they need the
    layout planner and the parameter specs, not ported yet (ROADMAP.md
    queue A item 7)."""

    def __init__(self, model: LM, *, batch_slots: int = 4,
                 max_len: int = 512, seed: int = 0, mesh=None,
                 layout: str = "fixed", max_queue: int = 0,
                 default_deadline_s: Optional[float] = None):
        if mesh is not None or layout != "fixed":
            raise NotImplementedError(
                "sharded serving (mesh=, layout=) needs dist/planner.py and "
                "the parameter specs of dist/sharding.py, not ported yet "
                "(ROADMAP.md queue A item 7)")
        self.model = model
        self.max_queue = max(0, int(max_queue))
        self.default_deadline_s = default_deadline_s
        self.max_len = max_len
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, np.int32)
        self.cache = model.init_cache(batch_slots, max_len)
        self._prefill = make_prefill_step(model)
        self._decode = make_serve_step(model)
        self._queue: "queue.Queue[Request]" = queue.Queue(
            maxsize=self.max_queue)
        self._gen = torch.Generator(device=model.device).manual_seed(seed)

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue ``req`` for the next free slot.  Rejects impossible
        requests with :class:`AdmissionError` *here* — the decode loop
        assumes every admitted request fits (``pos < max_len - 1`` must
        hold after prefill for at least one decode step).  A full
        bounded queue (``max_queue`` > 0) rejects with
        :class:`QueueFullError`; the request's deadline (``deadline_s``
        or the engine default) starts counting at submit."""
        if req.max_new <= 0:
            raise AdmissionError(
                f"max_new must be >= 1, got {req.max_new}")
        P = len(req.prompt)
        if P == 0:
            raise AdmissionError("empty prompt")
        if P > self.max_len - 1:
            raise AdmissionError(
                f"prompt length {P} exceeds the cache budget: max_len="
                f"{self.max_len} leaves room for at most {self.max_len - 1} "
                "prompt tokens plus one decode step")
        deadline = req.deadline_s if req.deadline_s is not None \
            else self.default_deadline_s
        if deadline is not None:
            req._deadline_at = time.perf_counter() + float(deadline)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise QueueFullError(
                f"admission queue is full ({self.max_queue} requests); "
                "shed load or retry with backoff") from None

    @staticmethod
    def _expired(req: Request) -> bool:
        return req._deadline_at is not None and \
            time.perf_counter() > req._deadline_at

    def _fail_deadline(self, req: Request) -> None:
        req.error = DeadlineExceededError(
            f"deadline passed after {len(req.out)} of {req.max_new} "
            "tokens")
        req.done = True

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is not None:
                continue
            while not self._queue.empty():
                req = self._queue.get()
                if self._expired(req):   # expired while queued: no slot
                    self._fail_deadline(req)
                    continue
                self.slots[i] = req
                # batch-1 prefill into slot i's cache rows, its recurrent
                # states from zero
                cache = self._slot_cache(i)
                for layer in cache["blocks"] + cache["rest"]:
                    for k in RECURRENT_LEAVES:
                        if k in layer:
                            layer[k].zero_()
                toks = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                       device=self.model.device)[None]
                self._prefill(toks, cache)
                self.pos[i] = len(req.prompt)
                break

    def _slot_cache(self, i: int) -> dict:
        """Slot ``i``'s cache: views of the pool's block leaves (G, B, ...)
        at axis 1 and of its rest leaves (B, ...) at axis 0."""
        return {"blocks": [{k: v[:, i:i + 1] for k, v in c.items()}
                           for c in self.cache["blocks"]],
                "rest": [{k: v[i:i + 1] for k, v in c.items()}
                         for c in self.cache["rest"]]}

    # -- stepping ------------------------------------------------------------
    def step(self) -> None:
        """One decode step for every occupied slot (continuous batching:
        admission happens between steps).  A slot's first decode feeds
        the prompt's last token again at position P, as the reference
        does (a recurrent layer's state so takes that token twice)."""
        self._admit()
        # decode advances every slot at its own position: step per slot
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if self._expired(req):       # deadline: evict at the boundary
                self._fail_deadline(req)
                self.slots[i] = None
                continue
            prev = req.out[-1] if req.out else int(req.prompt[-1])
            tok = torch.full((1, 1), prev, dtype=torch.int64,
                             device=self.model.device)
            nxt, logits, _ = self._decode(self._slot_cache(i), tok,
                                          int(self.pos[i]))
            if req.temperature > 0:
                probs = torch.softmax(logits[:, -1].float()
                                      / req.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=self._gen)
            req.out.append(int(nxt.reshape(-1)[0]))
            self.pos[i] += 1
            if len(req.out) >= req.max_new or self.pos[i] >= self.max_len - 1:
                req.done = True
                self.slots[i] = None

    def run_until_done(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self._queue.empty() and all(s is None for s in self.slots):
                return
            self.step()

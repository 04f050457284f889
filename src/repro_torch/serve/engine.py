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

``mesh=`` serves over the ranks of a :class:`~repro_torch.dist.Mesh`
(the reference's ``_shard``): the parameters and the cache are placed by
the layout rules (``layout="fixed"``: tensor-parallel parameters, the
cache's slots over the data axes and its heads / channels over ``model``;
``"auto"``: the layout planner's choice for this engine's decode cell),
each rank keeping only its blocks on ``mesh.device`` and running the
layers on them (:mod:`repro_torch.models.sharded`).  Every rank runs the
same admission loop on the same requests; a rank prefills and decodes the
slots its cache block holds, and the sampled tokens of all slots are
shared after each step, so every rank's loop sees the same state.
"""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.dist import Mesh
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
    engine's own ``torch.Generator``, seeded by ``seed``, one draw a
    sampled slot in slot order (under a mesh every rank advances it for
    every slot, so the samples are one device's).

    ``mesh`` (a :class:`~repro_torch.dist.Mesh`) shards the model in place
    (see the module docstring): ``layout="fixed"`` takes the serving rule
    (``param_specs(..., serve=True)``, ``cache_specs``), ``"auto"`` asks
    :func:`repro_torch.dist.planner.plan_layout` for this engine's decode
    cell, with the fixed serving layout as its fallback, and records the
    layout in :attr:`layout`.  ``weights(key, index)`` gives the rank's
    block of parameter ``key`` (``index``: a slice a dim) for a model
    built on the ``meta`` device, drawn or loaded block by block; without
    it the model's own parameters are cut.  A model already placed by
    the same layout on the same mesh is served as it is."""

    def __init__(self, model: LM, *, batch_slots: int = 4,
                 max_len: int = 512, seed: int = 0, mesh=None,
                 layout: str = "fixed", max_queue: int = 0,
                 default_deadline_s: Optional[float] = None,
                 weights: Optional[Callable[[str, tuple],
                                            torch.Tensor]] = None):
        if layout not in ("fixed", "auto"):
            raise ValueError(f"layout {layout!r}: 'fixed' or 'auto'")
        if mesh is None and (layout != "fixed" or weights is not None):
            raise ValueError("layout= and weights= place a model on a mesh: "
                             "pass mesh=")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh= takes a repro_torch.dist.Mesh of ranks, "
                            f"not {type(mesh).__name__} (a LogicalMesh only "
                            f"costs layouts: dist.planner)")
        self.model = model
        self.max_queue = max(0, int(max_queue))
        self.default_deadline_s = default_deadline_s
        self.max_len = max_len
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, np.int32)
        self.mesh = mesh
        #: the planner's layout (``layout="auto"`` only)
        self.layout = None
        #: this rank's slots: [slot0, slot0 + n_local)
        self.slot0, self.n_local = 0, batch_slots
        if mesh is None:
            self.cache = model.init_cache(batch_slots, max_len)
        else:
            self._shard(mesh, layout, batch_slots, weights)
        self._prefill = make_prefill_step(model)
        self._decode = make_serve_step(model)
        self._queue: "queue.Queue[Request]" = queue.Queue(
            maxsize=self.max_queue)
        self._gen = torch.Generator(device=model.device).manual_seed(seed)

    def _shard(self, mesh, layout: str, batch_slots: int, weights) -> None:
        """Place the model's parameters and a zeroed cache by the layout
        (the reference's ``Engine._shard``)."""
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.dist import planner, sharding as sh
        from repro_torch.models.sharded import local_shape
        cfg = self.model.cfg
        shape = ShapeConfig("engine_decode", self.max_len, batch_slots,
                            "decode")
        serve = True                      # the fixed serving rule
        if layout == "auto":
            sig = planner.signature_of(mesh)
            fb = replace(planner.fixed_layout(cfg, shape, sig),
                         serve_params=True)   # failure → TP-only serving
            self.layout = planner.plan_layout(mesh, cfg, shape, fallback=fb)
            serve = self.layout.serve_params
        whole_params, _ = planner._abstract_state(cfg)   # meta: shapes
        self.param_specs = sh.param_specs(mesh, cfg, whole_params,
                                          serve=serve)
        self.model.shard_(mesh, self.param_specs, weights)
        whole = self.model.init_cache(batch_slots, self.max_len,
                                      device="meta")
        self.cache_specs = sh.cache_specs(mesh, cfg, shape, whole)
        self.cache = {part: [
            {k: torch.zeros(local_shape(mesh, spec[k], v.shape),
                            dtype=v.dtype, device=mesh.device)
             for k, v in layer.items()}
            for layer, spec in zip(whole[part], self.cache_specs[part])]
            for part in whole}
        (entry,) = sh.batch_spec(mesh, cfg, batch_slots) or (None,)
        i, n = sh.block_index(mesh, entry, mesh.coords)
        self.n_local = batch_slots // n
        self.slot0 = i * self.n_local
        # data blocks of the slots gather FSDP leaves as a row group, so
        # each forward one of them runs, all of them run
        self._lockstep = self.model.shard.fsdp and n > 1

    def stored_bytes(self) -> dict:
        """The bytes this rank holds: its parameters and its cache."""
        nbytes = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                                for t in ts)
        return {"params": nbytes(self.model.parameters()),
                "cache": nbytes(v for part in self.cache.values()
                                for layer in part for v in layer.values())}

    def _owns(self, i: int) -> bool:
        return self.slot0 <= i < self.slot0 + self.n_local

    def _peer_forward(self) -> None:
        """A slot another data block holds runs a forward: under the
        lockstep this rank runs one too (one token, no cache), so that
        its row group gathers the same leaves in the same order."""
        if self.mesh is not None and self._lockstep:
            self._prefill(torch.zeros((1, 1), dtype=torch.int64,
                                      device=self.model.device), None)

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

    def _late(self) -> set:
        """The ids of the queued and occupied requests whose deadline has
        passed; under a mesh, on any rank's clock, agreed by one
        all-reduce for all of them (every rank then decides alike)."""
        with self._queue.mutex:
            reqs = list(self._queue.queue)
        timed = [r for r in reqs + self.slots
                 if r is not None and r._deadline_at is not None]
        if not timed:
            return set()
        now = time.perf_counter()
        late = [int(now > r._deadline_at) for r in timed]
        if self.mesh is not None:
            late = self.mesh.all_reduce(torch.tensor(late, dtype=torch.int32),
                                        "pmax", over="all").tolist()
        return {id(r) for r, x in zip(timed, late) if x}

    def _fail_deadline(self, req: Request) -> None:
        req.error = DeadlineExceededError(
            f"deadline passed after {len(req.out)} of {req.max_new} "
            "tokens")
        req.done = True

    def _admit(self, late: set) -> None:
        for i, slot in enumerate(self.slots):
            if slot is not None:
                continue
            while not self._queue.empty():
                req = self._queue.get()
                if id(req) in late:      # expired while queued: no slot
                    self._fail_deadline(req)
                    continue
                self.slots[i] = req
                if not self._owns(i):
                    self._peer_forward()
                    self.pos[i] = len(req.prompt)
                    break
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
        at axis 1 and of its rest leaves (B, ...) at axis 0 (under a mesh,
        of this rank's block of the slots)."""
        i -= self.slot0
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
        late = self._late()
        self._admit(late)
        # decode advances every slot at its own position: step per slot
        new = {}
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if id(req) in late:          # deadline: evict at the boundary
                self._fail_deadline(req)
                self.slots[i] = None
                continue
            if not self._owns(i):
                self._peer_forward()
                if req.temperature > 0:  # the owner's draw, on every rank
                    self._sample(None, req.temperature)
                new[i] = -1
                continue
            prev = req.out[-1] if req.out else int(req.prompt[-1])
            tok = torch.full((1, 1), prev, dtype=torch.int64,
                             device=self.model.device)
            nxt, logits, _ = self._decode(self._slot_cache(i), tok,
                                          int(self.pos[i]))
            if req.temperature > 0:
                nxt = self._sample(logits, req.temperature)
            new[i] = int(nxt.reshape(-1)[0])
        if self.n_local < len(self.slots) and new:
            # every slot's token from the data block that holds it
            vec = torch.full((len(self.slots),), -1, dtype=torch.int64)
            for i, t in new.items():
                vec[i] = t
            vec = self.mesh.all_reduce(vec, "pmax", over="row")
            new = {i: int(vec[i]) for i in new}
        for i, t in new.items():
            req = self.slots[i]
            req.out.append(t)
            self.pos[i] += 1
            if len(req.out) >= req.max_new or self.pos[i] >= self.max_len - 1:
                req.done = True
                self.slots[i] = None

    def _sample(self, logits, temperature: float) -> torch.Tensor:
        """One token drawn from ``softmax(logits[:, -1] / temperature)``;
        ``logits`` None (a slot another data block holds) draws from a
        uniform of the same shape and drops the token.  The generator
        advances by the shape alone (``multinomial`` of one sample draws
        one exponential per entry), so every rank stays in step with the
        rank that samples."""
        if logits is None:
            cfg = self.model.cfg
            shape = (1,) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1
                            else ()) + (cfg.vocab,)
            probs = torch.ones(shape, device=self.model.device)
        else:
            probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)

    def run_until_done(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self._queue.empty() and all(s is None for s in self.slots):
                return
            self.step()

"""Continuous-batching serving over the paged KV cache
(``repro.serve.serve``: ``ServeConfig``, ``PageAllocator``,
``BatchScheduler``).

What this slice keeps of the JAX scheduler, with its semantics:

* every slot carries its own position; one decode dispatch per tick runs
  all decoding slots, then at most one ``prefill_chunk``-token chunk of
  the oldest in-flight prefill (``overlap=True``), or every pending prefill
  to completion before the decode (``overlap=False``, the stop-the-world
  baseline). Tokens are identical either way;
* pages are allocated one at a time just before a chunk or a decode step
  writes them and released when the request retires; exhausting the pool
  unwinds the failing request (its pages freed, neighbours untouched) and
  raises ``RuntimeError``, as the JAX scheduler does under
  ``preempt_policy="never"``;
* next-token seeds are applied in one scatter per tick, and readback is
  deferred and batched: one ``.cpu()`` of the stacked pending tokens per
  flush, when a request reaches its budget, every ``eos_check_every``
  ticks when ``eos_id`` is set, or on ``flush()``/``drain()``;
* greedy sampling: an argmax over the padded vocabulary, unmasked.

Not ported yet (see ROADMAP.md): prefix cache, preemption and resume,
sampled decoding, speculative decoding, fault injection and recovery,
traffic replay, the dense layout and the monitored session.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    batch: int
    # prefill token budget (= chunk size) per tick
    prefill_chunk: int = 32
    # chunked prefill dispatched between decode dispatches; False completes
    # every pending prefill before the tick's decode (the baseline)
    overlap: bool = True
    # retire a request when it emits eos_id; pending readbacks are flushed
    # every eos_check_every ticks so EOS is seen with bounded delay
    eos_id: int | None = None
    eos_check_every: int = 8
    page_size: int = 16
    # pool size in pages; None = dense-equivalent batch*max_len/page_size
    num_pages: int | None = None

    def __post_init__(self):
        if self.max_len % self.page_size:
            raise ValueError(
                f"max_len ({self.max_len}) must be divisible by page_size "
                f"({self.page_size})"
            )
        if min(self.batch, self.prefill_chunk, self.eos_check_every,
               self.page_size) < 1:
            raise ValueError("batch, prefill_chunk, eos_check_every and "
                             "page_size must be >= 1")


class PageAllocator:
    """Free-list allocator over the shared KV page pool. ``alloc`` raises
    before handing out any page when the pool cannot serve the request, so
    a full pool never remaps a neighbour's pages."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))  # pop() -> page 0 first
        self.peak_used = 0

    @property
    def used(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int, *, owner=None) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"paged KV pool exhausted: request {owner!r} needs {n} more "
                f"page(s) but only {len(self._free)} of {self.num_pages} are "
                f"free; raise ServeConfig.num_pages (--num-pages) or retire "
                f"requests sooner"
            )
        pages = [self._free.pop() for _ in range(n)]
        self.peak_used = max(self.peak_used, self.used)
        return pages

    def release(self, pages: list[int]) -> None:
        self._free.extend(pages)


def _sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy: argmax over the padded vocabulary, no mask. (N,V) -> (N,) int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """Host numpy -> device tensor that never aliases ``arr``.

    ``torch.from_numpy`` shares memory, and on the CPU ``.to(device)`` is a
    no-op, so without the copy a dispatch would read later mutations of the
    scheduler's host arrays (positions, block tables). The copy also makes
    the asynchronous host-to-device transfer safe."""
    return torch.from_numpy(arr.copy()).to(device, non_blocking=True)


class BatchScheduler:
    """Slot-based continuous batching with chunked prefill overlapped with
    decode, over the model's paged KV pool. Tokens are greedy and identical
    with overlap on or off.

    Request records are dicts: ``id``, ``prompt``, ``max_new``,
    ``generated`` (host tokens), ``status`` (queued | prefilling | decoding
    | done | failed), and ``t_submit``/``t_first_token`` (host clock: submit,
    and the flush that first put a token on the host)."""

    def __init__(self, model, scfg: ServeConfig):
        self.model, self.cfg, self.scfg = model, model.cfg, scfg
        self.device = model.device
        self._max_pages = scfg.max_len // scfg.page_size
        n_pages = scfg.num_pages
        if n_pages is None:
            n_pages = scfg.batch * self._max_pages
        self._alloc = PageAllocator(n_pages)
        self._tables = np.full((scfg.batch, self._max_pages), -1, np.int32)
        self._slot_pages: list[list[int]] = [[] for _ in range(scfg.batch)]
        self._tables_dirty = True
        self._tables_dev = None
        self.caches = model.init_cache(scfg.batch, scfg.max_len,
                                       page_size=scfg.page_size, num_pages=n_pages)
        self.tokens = torch.zeros((scfg.batch, 1), dtype=torch.int32,
                                  device=self.device)
        self.queue: list[dict] = []
        self.active: list[dict | None] = [None] * scfg.batch
        self.pos = np.zeros(scfg.batch, np.int32)
        self.completed: list[dict] = []
        self.failed: list[dict] = []
        self._prefills: list[dict] = []
        self._prefilling: list[dict | None] = [None] * scfg.batch
        # next-token seeds {slot: device scalar}, one scatter per tick
        self._seeds: dict[int, torch.Tensor | int] = {}
        # pending readbacks: (device tokens (n,1), row -> request map)
        self._pending: list[tuple[torch.Tensor, list[dict | None]]] = []
        self.stats = {
            "ticks": 0, "decode_steps": 0, "prefill_chunks": 0, "readbacks": 0,
            # ticks with a prefill in flight beside >= 1 decoding slot, and
            # ticks whose decode dispatch waited on prefill work
            "overlap_ticks": 0, "decode_after_prefill_ticks": 0,
        }

    # -- admission ---------------------------------------------------------

    def submit(self, prompt_tokens, request_id, max_new: int = 32) -> dict:
        """Queue a request (FIFO). Raises ValueError for a request that can
        never fit: the last decode writes position prompt+max_new-2."""
        prompt = [int(t) for t in prompt_tokens]
        if max_new < 1:
            raise ValueError(f"request {request_id!r}: max_new must be >= 1")
        need = len(prompt) + max_new - 1 if prompt else max_new
        if need > self.scfg.max_len:
            raise ValueError(
                f"request {request_id!r} needs {need} cache positions "
                f"(prompt {len(prompt)}, max_new {max_new}) but "
                f"max_len={self.scfg.max_len}"
            )
        pages = -(-need // self.scfg.page_size)
        if pages > self._alloc.num_pages:
            raise ValueError(
                f"request {request_id!r} needs {pages} page(s) but the pool "
                f"only holds {self._alloc.num_pages}; raise ServeConfig.num_pages"
            )
        req = {"id": request_id, "prompt": prompt, "max_new": max_new,
               "generated": [], "pending": 0, "status": "queued",
               "t_submit": time.perf_counter(), "t_first_token": None}
        self.queue.append(req)
        return req

    def _free(self, slot: int) -> bool:
        return self.active[slot] is None and self._prefilling[slot] is None

    def _attach(self) -> None:
        for slot in range(self.scfg.batch):
            if not self.queue:
                return
            if not self._free(slot):
                continue
            req = self.queue.pop(0)
            self.pos[slot] = 0
            self._seeds.pop(slot, None)  # a retired request's stale seed
            if not req["prompt"]:
                # nothing to prefill: decode from an empty cache off seed 0
                self._seeds[slot] = 0
                self.active[slot] = req
                req["status"] = "decoding"
                continue
            task = {"req": req, "slot": slot, "done": 0,
                    "prompt": np.asarray(req["prompt"], np.int32)}
            req["status"] = "prefilling"
            self._prefilling[slot] = task
            self._prefills.append(task)

    # -- paged-pool bookkeeping ---------------------------------------------

    def _ensure_pages(self, slot: int, last_pos: int, req: dict) -> None:
        """Back position ``last_pos`` of ``slot`` with a page, one page at a
        time. On exhaustion, unwind the request (all its pages freed, its
        table row cleared), mark it failed and raise RuntimeError."""
        need = last_pos // self.scfg.page_size + 1
        while len(self._slot_pages[slot]) < need:
            try:
                page = self._alloc.alloc(1, owner=req["id"])[0]
            except RuntimeError as e:
                self._fail(slot, req)
                raise RuntimeError(
                    f"{e} [kv_cache_stats: {self.kv_cache_stats()}]"
                ) from None
            self._tables[slot, len(self._slot_pages[slot])] = page
            self._slot_pages[slot].append(page)
            self._tables_dirty = True

    def _fail(self, slot: int, req: dict) -> None:
        task = self._prefilling[slot]
        if task is not None:
            self._prefills.remove(task)
            self._prefilling[slot] = None
        self.active[slot] = None
        self._seeds.pop(slot, None)
        self._release_slot_pages(slot)
        req["status"] = "failed"
        self.failed.append(req)

    def _release_slot_pages(self, slot: int) -> None:
        if not self._slot_pages[slot]:
            return
        self._alloc.release(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._tables[slot, :] = -1
        self._tables_dirty = True

    def _tables_device(self) -> torch.Tensor:
        """Device mirror of the block tables, uploaded only after a change.
        ``-1`` entries go up intact: readers stop at cache_len and writers
        drop them."""
        if self._tables_dirty:
            self._tables_dev = _upload(self._tables, self.device)
            self._tables_dirty = False
        return self._tables_dev

    def kv_cache_stats(self) -> dict:
        """Pool bytes as allocated (including each layer's spare page),
        pages, and the live-page peak."""
        kv_bytes = sum(
            t.numel() * t.element_size()
            for slot in self.caches.values() for t in slot["attn"].values()
        )
        per_page = kv_bytes / (self._alloc.num_pages + 1)
        return {
            "layout": "paged", "kv_bytes": int(kv_bytes),
            "page_size": self.scfg.page_size,
            "num_pages": self._alloc.num_pages,
            "pages_in_use": self._alloc.used,
            "peak_used_pages": self._alloc.peak_used,
            "peak_live_kv_bytes": int(self._alloc.peak_used * per_page),
            "pool_utilization": round(
                self._alloc.peak_used / max(self._alloc.num_pages, 1), 4),
        }

    # -- dispatch ------------------------------------------------------------

    def _dispatch_prefill_chunk(self) -> None:
        """One chunk of the oldest in-flight prefill (no host sync)."""
        task = self._prefills[0]
        C = self.scfg.prefill_chunk
        prompt, start, slot, req = task["prompt"], task["done"], task["slot"], task["req"]
        L = min(C, len(prompt) - start)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :L] = prompt[start:start + L]
        self._ensure_pages(slot, start + L - 1, req)
        tables = self._tables_device()
        logits = self.model.prefill_chunk(
            _upload(chunk, self.device), self.caches, start, L,
            tables[slot:slot + 1],
        )
        next_tok = _sample_tokens(logits)  # (1,)
        task["done"] = start + L
        self.stats["prefill_chunks"] += 1
        if task["done"] >= len(prompt):
            # the prompt's last chunk: next_tok is the first generated token;
            # it joins the deferred readback and seeds the slot's decode input
            self._prefills.remove(task)
            self._prefilling[slot] = None
            self.active[slot] = req
            req["status"] = "decoding"
            self.pos[slot] = len(prompt)
            req["pending"] += 1
            self._pending.append((next_tok.reshape(1, 1), [req]))
            self._seeds[slot] = next_tok[0]

    def _apply_seeds(self) -> None:
        """All new seeds in one scatter, out of place: ``self.tokens`` may
        still be referenced by a pending readback."""
        if not self._seeds:
            return
        seeds, self._seeds = self._seeds, {}
        slots = _upload(np.asarray(list(seeds), np.int64), self.device)
        toks = torch.stack([
            t.reshape(()) if isinstance(t, torch.Tensor)
            else _upload(np.asarray(t, np.int32), self.device)
            for t in seeds.values()
        ])
        self.tokens = self.tokens.index_put(
            (slots, torch.zeros_like(slots)), toks
        )

    def _decode(self, decoding: list[dict | None]) -> None:
        active = np.asarray([r is not None for r in decoding])
        logits = self.model.decode_step(
            self.tokens, _upload(self.pos, self.device), self.caches,
            active=_upload(active, self.device),
            block_tables=self._tables_device(),
        )
        self.tokens = _sample_tokens(logits)[:, None]
        self.stats["decode_steps"] += 1
        self.pos[active] += 1
        self._pending.append((self.tokens, decoding))
        for req in decoding:
            if req is not None:
                req["pending"] += 1

    # -- readback ---------------------------------------------------------------

    def _flush(self) -> None:
        """Bring every pending token to the host in one transfer; retire
        requests at their budget or at EOS (tokens past EOS are dropped)."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        host = torch.cat([t.reshape(-1) for t, _ in pending]).cpu().numpy()
        self.stats["readbacks"] += 1
        now = time.perf_counter()
        i = 0
        for toks, reqmap in pending:
            for row, req in enumerate(reqmap):
                if req is not None:
                    req["pending"] -= 1
                    req["generated"].append(int(host[i + row]))
                    if req["t_first_token"] is None:
                        req["t_first_token"] = now
            i += len(reqmap)
        eos = self.scfg.eos_id
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            gen = req["generated"]
            done = len(gen) >= req["max_new"]
            if eos is not None and eos in gen:
                del gen[gen.index(eos) + 1:]
                done = True
            if done:
                del gen[req["max_new"]:]
                req["status"] = "done"
                self.completed.append(req)
                self.active[slot] = None
                self._release_slot_pages(slot)

    def flush(self) -> None:
        """Materialize pending tokens now (streaming callers)."""
        self._flush()

    # -- the tick -------------------------------------------------------------

    def step(self) -> int:
        """One tick: attach, decode dispatch for every decoding slot, then at
        most one prefill chunk. Returns the number of busy slots."""
        self.stats["ticks"] += 1
        self._attach()
        chunks_at_tick_start = self.stats["prefill_chunks"]
        if not self.scfg.overlap:
            while self._prefills:
                self._dispatch_prefill_chunk()
        self._apply_seeds()
        # this step writes each decoding slot's K/V at pos[slot]: back any
        # page boundary being crossed before the dispatch
        for slot in range(self.scfg.batch):
            req = self.active[slot]
            if req is not None:
                self._ensure_pages(slot, int(self.pos[slot]), req)
        decoding = list(self.active)
        if any(r is not None for r in decoding):
            if self._prefills:
                self.stats["overlap_ticks"] += 1
            if self.stats["prefill_chunks"] > chunks_at_tick_start:
                self.stats["decode_after_prefill_ticks"] += 1
            self._decode(decoding)
        if self.scfg.overlap and self._prefills:
            self._dispatch_prefill_chunk()
        flush_due = any(
            req is not None and len(req["generated"]) + req["pending"] >= req["max_new"]
            for req in self.active
        )
        if (self.scfg.eos_id is not None and self._pending
                and self.stats["ticks"] % self.scfg.eos_check_every == 0):
            flush_due = True
        if flush_due:
            self._flush()
        return sum(1 for slot in range(self.scfg.batch) if not self._free(slot))

    def drain(self) -> None:
        """Step until every queued, prefilling and decoding request is done,
        then flush. Raises if that takes more ticks than the work can need."""
        live = (self.queue + [r for r in self.active if r is not None]
                + [t["req"] for t in self._prefills])
        budget = 64 + len(live) * sum(
            r["max_new"] + len(r["prompt"]) // self.scfg.prefill_chunk + 2
            for r in live
        )
        ticks = 0
        while self.queue or self._prefills or any(r is not None for r in self.active):
            self.step()
            ticks += 1
            if ticks > budget:
                raise RuntimeError(
                    f"drain() reached no quiescence after {ticks} ticks: "
                    f"queued={len(self.queue)} prefilling={len(self._prefills)} "
                    f"[kv_cache_stats: {self.kv_cache_stats()}]"
                )
        self._flush()

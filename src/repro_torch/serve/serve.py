"""Continuous-batching serving over the paged KV cache
(``repro.serve.serve``: ``ServeConfig``, ``PageAllocator``,
``PrefixCache``, ``RequestHandle``, ``BatchScheduler``).

What the port keeps of the JAX scheduler, with its semantics:

* every slot carries its own position; one decode dispatch per tick runs
  all decoding slots, then at most one ``prefill_chunk``-token chunk of
  the oldest in-flight prefill (``overlap=True``), or every pending prefill
  to completion before the decode (``overlap=False``, the stop-the-world
  baseline). Tokens are identical either way;
* admission: ``submit`` returns a ``RequestHandle`` at once; a priority
  queue (highest first, FIFO within a class) feeds free slots, and a
  strictly-higher-priority waiter behind a full batch preempts the
  lowest-priority occupant. ``cancel``, ``stream`` and ``stream_async``
  work mid-stream;
* pages are refcounted and allocated one at a time just before a chunk or
  a decode step writes them. When the pool runs dry the scheduler evicts
  prefix-trie pages nobody reads, then preempts a victim chosen by
  ``preempt_policy`` (never an older request of the same or a higher
  priority), then parks the requester; a preempted request
  recompute-resumes: its prompt re-prefills on the same chunk grid and its
  generated tokens replay through ordinary decode dispatches at their
  original positions, inputs forced and outputs discarded, so its stream
  is identical to an ample-pool run. Under ``"never"`` exhaustion unwinds
  the failing request (its pages freed, neighbours untouched) and raises;
* the prefix cache (``prefix_cache=True``): completed prefills insert
  their prompts' full pages into a radix trie; an attach maps the longest
  cached prefix read-only (refcount bump, that part of the prefill
  skipped) and copies a partly matched page into a fresh one on the device
  (copy-on-write). Shared pages are never written: every write lands at or
  past the fast-forwarded start;
* next-token seeds are applied in one scatter per tick, and readback is
  deferred and batched: one ``.cpu()`` of the stacked pending tokens per
  flush, when a request reaches its budget, every ``eos_check_every``
  ticks when ``eos_id`` is set, before a preemption, or on
  ``flush()``/``drain()``;
* monitoring through ``repro_torch.session``: every decode dispatch (and
  every speculative verify) is a visit of the session's ``decode`` region,
  every prefill chunk one of ``prefill``, every preemption one of
  ``preempt``;
* sampling: greedy (an argmax over the padded vocabulary, unmasked) by
  default; with ``greedy=False`` temperature and top-k sampling on the
  device from the request's key ``fold_in(PRNGKey(sample_seed), tag)``
  folded with the sampled position (``repro_torch/prng.py``: the ``jax.random``
  functions in torch integer ops, so the draws are JAX's). A request's
  stream is then a function of its prompt, id and seed alone, never of
  its slot, its neighbours, the overlap schedule or a preemption;
* speculative decoding (``spec_decode=True``): each tick the prompt-lookup
  drafter (``serve/spec.py``) proposes up to ``spec_k`` tokens a slot and
  one batched verify dispatch (``prefill_chunk`` with every position's
  logits) scores them all; the longest prefix where draft == output is
  kept, so tokens equal those of plain decode, greedy or sampled;
* resilience: every decode, prefill-chunk and verify dispatch computes a
  NaN/Inf sentinel on the device (``bad``), which comes to the host in the
  same copy as the tokens. A flagged request retries through the
  preemption's park/recompute-resume path after a capped exponential
  backoff, so its stream equals a fault-free run's; past ``max_retries``
  it is quarantined (terminal ``failed``, pages freed, neighbours
  untouched). A watchdog (``watchdog_deadline_s``) times each decode and
  verify dispatch call and retries the hung slot's request; per-page
  checksums (``checksum_pages``) are recorded at trie insert and checked
  before a shared page is mapped, a mismatch evicting its subtree; and
  ``shed_queue_depth`` sheds the lowest-priority youngest waiter (terminal
  ``shed``). Each action is one visit of the session's ``recovery``
  region. A seeded ``serve.faults.FaultInjector`` (``fault_injector=``)
  drives chaos schedules through these paths;
* the dense layout (``paged=False``): one ``(B+1, max_len)`` cache row a
  slot (row B takes dropped writes), attended through the flash-attention
  kernel, the A/B baseline of the paged pool. Tokens equal the paged
  layout's in fp32; in bf16 the two layouts' attention kernels round
  differently, and greedy tokens can part where the top two logits are a
  few ulps apart;
* recurrent state (mamba2, mLSTM, sLSTM: zamba2-2.7b, xlstm-350m) lives in
  one dense row a slot in both layouts. A prefill chunk, and the verify
  chunk ``spec_k+1``, must be at most the recurrent chunk or a multiple of
  it. A reused slot's rows are restored to their initial values before its
  new request runs (``_reset_slots``); the prefix cache shares a hybrid
  arch's matched pages but skips no prefill (the state must advance over
  every prompt token); preemption and retry resume over every token; and
  the speculative verify runs in two passes, the scoring pass leaving the
  state as it was and a commit pass over the accepted tokens advancing it;
* a mesh of ranks (``BatchScheduler(..., mesh=)``, the paged layout):
  every rank runs the same scheduler and takes the same host decisions;
  the caches are each rank's blocks under ``cache_pspec_tree``; the
  decode and verify rows split over the batch axes (each layer's K/V
  all-gathered for the pool, which is replicated there), a chunk runs on
  every rank, and each step runs its ``"model"`` share
  (``serve_constraints``); tokens and sentinels come back to every rank.

The KV caches are written in place (``layers.attention.paged_write`` and
``dense_write``), not returned anew as in the JAX package. Everything runs
on one stream, so a page released on the host and handed to another
request is written by the new owner only after every earlier dispatch
that named it.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import zlib

import numpy as np
import torch

from repro_torch.serve import faults as F
from repro_torch import prng
from repro_torch.distributed.shard import (
    any_over,
    row_broadcast,
    rows_gather,
    vocab_argmax,
    vocab_gather,
)
from repro_torch.distributed.sharding import cache_pspec_tree  # noqa: F401  (re-exported)
from repro_torch.layers.common import NULL_CONSTRAINTS
from repro_torch.models.transformer import init_cache
from repro_torch.serve.spec import draft_tokens
from repro_torch.session import PerfSession, SessionConfig

PREEMPT_POLICIES = ("priority", "pages", "progress", "never")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    batch: int
    # sampling: greedy argmax by default; greedy=False samples on the device
    # with temperature (and top_k) from the request's key, folded with the
    # sampled position (see the module docstring)
    temperature: float = 1.0
    greedy: bool = True
    top_k: int | None = None
    sample_seed: int = 0
    # prefill token budget (= chunk size) per tick
    prefill_chunk: int = 32
    # chunked prefill dispatched between decode dispatches; False completes
    # every pending prefill before the tick's decode (the baseline)
    overlap: bool = True
    # retire a request when it emits eos_id; pending readbacks are flushed
    # every eos_check_every ticks so EOS is seen with bounded delay
    eos_id: int | None = None
    eos_check_every: int = 8
    # paged KV cache (the default): a shared pool of page_size-token pages
    # through per-slot block tables; paged=False keeps one dense (max_len)
    # cache row a slot, the A/B baseline
    paged: bool = True
    page_size: int = 16
    # pool size in pages; None = dense-equivalent batch*max_len/page_size
    num_pages: int | None = None
    # cross-request prefix cache (paged only): a radix trie over
    # prompt-token pages maps cached prefixes read-only into a new request's
    # block table and copy-on-writes the first partly shared page; the trie
    # pins at most prefix_trie_capacity pages (LRU-trimmed on insert; None =
    # unbounded, pool pressure still evicts pages no request reads)
    prefix_cache: bool = False
    prefix_trie_capacity: int | None = None
    # victim order when the pool runs dry: "priority" (lowest class, then
    # most pages, then least progress), "pages" (most pages), "progress"
    # (least generated), or "never" (exhaustion unwinds and raises)
    preempt_policy: str = "priority"
    # resilience: a request whose dispatch is found bad (non-finite logits,
    # a watchdog trip) retries through park/recompute-resume after
    # min(cap, base << (retries-1)) ticks; past max_retries it is
    # quarantined (terminal "failed")
    max_retries: int = 3
    retry_backoff_base: int = 1
    retry_backoff_cap: int = 8
    # a decode or verify dispatch call longer than this many seconds trips
    # the watchdog: its tokens are kept and the hung slot's request retries.
    # None = off
    watchdog_deadline_s: float | None = None
    # per-page fingerprints (paged + prefix_cache): recorded at trie insert,
    # checked before a shared page is mapped; a mismatch evicts the subtree
    checksum_pages: bool = False
    # with more than this many requests queued, submit sheds the
    # lowest-priority youngest waiter (terminal "shed"). None = never
    shed_queue_depth: int | None = None
    # speculative decoding (paged only): up to spec_k drafted tokens a slot
    # and one batched verify a tick; spec_min_match is the shortest history
    # n-gram the drafter may match on
    spec_decode: bool = False
    spec_k: int = 4
    spec_min_match: int = 2

    def __post_init__(self):
        # the JAX package's checks, in its order (max_len % page_size is
        # the scheduler's, as there)
        if self.checksum_pages and not (self.paged and self.prefix_cache):
            raise ValueError(
                "checksum_pages=True requires paged=True and "
                "prefix_cache=True: checksums guard pages shared across "
                "requests through the prefix trie"
            )
        if self.max_retries < 0 or self.retry_backoff_base < 1 \
                or self.retry_backoff_cap < 1:
            raise ValueError(
                "max_retries must be >= 0 and retry backoff base/cap >= 1"
            )
        if self.prefix_cache and not self.paged:
            raise ValueError(
                "prefix_cache=True requires paged=True: prefix sharing maps "
                "pool pages into multiple slots' block tables, which the "
                "dense (batch, max_len) layout cannot express"
            )
        if self.preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(
                f"preempt_policy must be one of priority|pages|progress|never,"
                f" got {self.preempt_policy!r}"
            )
        if self.spec_decode and not self.paged:
            raise ValueError(
                "spec_decode=True requires paged=True: the batched verify "
                "step scores K+1 positions through the paged pool's "
                "block-table reads, and rollback of rejected positions "
                "relies on the pool's masked scatter writes"
            )
        if self.spec_decode and (self.spec_k < 1 or self.spec_min_match < 1):
            raise ValueError(
                f"spec_k ({self.spec_k}) and spec_min_match "
                f"({self.spec_min_match}) must be >= 1"
            )
        if min(self.batch, self.prefill_chunk, self.eos_check_every,
               self.page_size) < 1:
            raise ValueError("batch, prefill_chunk, eos_check_every and "
                             "page_size must be >= 1")


class PageAllocator:
    """Refcounted free-list allocator over the shared KV page pool.
    ``alloc`` hands pages out at refcount 1 and raises before handing out
    any page when the pool cannot serve the request, so a full pool never
    remaps a neighbour's pages; ``share`` adds a reference (a second block
    table row, or the prefix trie's pin), and ``release`` returns a page to
    the free list only when its count drops to zero."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))  # pop() -> page 0 first
        self.refs: dict[int, int] = {}  # allocated page -> reference count
        self.peak_used = 0

    @property
    def used(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages currently held by more than one reference."""
        return sum(1 for c in self.refs.values() if c > 1)

    def alloc(self, n: int, *, owner=None) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"paged KV pool exhausted: request {owner!r} needs {n} more "
                f"page(s) but only {len(self._free)} of {self.num_pages} are "
                f"free; raise ServeConfig.num_pages (--num-pages) or retire "
                f"requests sooner"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self.refs[p] = 1
        self.peak_used = max(self.peak_used, self.used)
        return pages

    def share(self, pages: list[int]) -> None:
        """Add one reference to each (already allocated) page."""
        for p in pages:
            self.refs[p] += 1

    def release(self, pages: list[int]) -> None:
        for p in pages:
            c = self.refs[p] = self.refs[p] - 1
            if c == 0:
                del self.refs[p]
                self._free.append(p)


class _TrieNode:
    __slots__ = ("tokens", "page", "children", "parent", "last_used", "checksum")

    def __init__(self, tokens, page, parent):
        self.tokens = tokens      # the page_size-token tuple keying this node
        self.page = page          # physical pool page holding their K/V
        self.children: dict[tuple, _TrieNode] = {}
        self.parent = parent
        self.last_used = 0
        self.checksum = None      # page fingerprint (checksum_pages)


class PrefixCache:
    """Radix trie over prompt-token pages for cross-request KV sharing.

    A node is keyed by the exact ``page_size``-token tuple it covers (exact
    compare: two different prefixes never alias), and a root-to-node path
    spells a prompt prefix in whole pages mapped to resident pool pages.
    The trie holds its own reference on every inserted page, so cached
    pages outlive the request that inserted them; they are reclaimed by
    LRU eviction under pool pressure (``evict_for``: only leaves no
    request reads) or by the LRU trim when ``capacity`` pages would be
    exceeded on insert."""

    def __init__(self, page_size: int, allocator: PageAllocator,
                 capacity: int | None = None):
        self.page_size = page_size
        self.allocator = allocator
        self.capacity = capacity
        self.root = _TrieNode((), -1, None)
        self.size = 0       # nodes == pages currently pinned
        self._clock = 0     # monotonic LRU clock
        self.stats = {
            "hits": 0, "misses": 0, "hit_tokens": 0,
            "prefill_tokens_skipped": 0, "pages_shared": 0, "cow_copies": 0,
            "inserted_pages": 0, "evicted_pages": 0,
        }

    def _touch(self, node: _TrieNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    def match(self, prompt):
        """Longest cached prefix of ``prompt``: the chain of fully matched
        page nodes, plus the best partly matching child of the last one
        (the copy-on-write donor) with its matching row count."""
        psize = self.page_size
        node, chain, i = self.root, [], 0
        while len(prompt) - i >= psize:
            child = node.children.get(tuple(int(t) for t in prompt[i:i + psize]))
            if child is None:
                break
            chain.append(child)
            node, i = child, i + psize
        tail = tuple(int(t) for t in prompt[i:i + psize])
        donor, donor_rows = None, 0
        for key, child in node.children.items():
            n = 0
            for a, b in zip(key, tail):
                if a != b:
                    break
                n += 1
            if n > donor_rows:
                donor, donor_rows = child, n
        return chain, donor, donor_rows

    def insert(self, prompt, pages, checksums=None) -> None:
        """Record a prefilled prompt's full pages (called when a request's
        prefill completes). Existing nodes are LRU-touched; new nodes pin
        their page with a trie-owned reference. The page straddling the
        prompt's end is never inserted: decode writes its tail.
        ``checksums`` (one fingerprint a full page, with checksum_pages) are
        stored on the nodes and checked before a later attach maps them."""
        psize = self.page_size
        node = self.root
        for j in range(len(prompt) // psize):
            key = tuple(int(t) for t in prompt[j * psize:(j + 1) * psize])
            child = node.children.get(key)
            if child is None:
                if self.capacity is not None and self.size >= self.capacity:
                    # at capacity: trim the LRU leaf off some other path;
                    # if the whole trie is this insertion, stop growing
                    if not self._evict_lru(exclude=self._path_ids(node)):
                        return
                child = _TrieNode(key, pages[j], node)
                node.children[key] = child
                self.allocator.share([pages[j]])
                self.size += 1
                self.stats["inserted_pages"] += 1
            if checksums is not None:
                child.checksum = checksums[j]
            self._touch(child)
            node = child

    # -- eviction ----------------------------------------------------------

    def _path_ids(self, node: _TrieNode) -> set:
        out = set()
        while node is not None:
            out.add(id(node))
            node = node.parent
        return out

    def _leaves(self) -> list[_TrieNode]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def _evict(self, node: _TrieNode) -> None:
        del node.parent.children[node.tokens]
        self.allocator.release([node.page])
        self.size -= 1
        self.stats["evicted_pages"] += 1

    def _evict_lru(self, *, exclude=frozenset(),
                   only_unreferenced: bool = False) -> bool:
        """Evict the least-recently-used leaf; True if one was evicted."""
        cand = [
            n for n in self._leaves()
            if id(n) not in exclude
            and (not only_unreferenced
                 or self.allocator.refs.get(n.page, 0) == 1)
        ]
        if not cand:
            return False
        self._evict(min(cand, key=lambda n: n.last_used))
        return True

    def evict_subtree(self, node: _TrieNode) -> int:
        """Evict ``node`` and every descendant, children first (a checksum
        mismatch: the page can no longer be trusted, and its descendants
        are unreachable without it); returns the number of nodes evicted."""
        stack, order = [node], []
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        for n in reversed(order):
            self._evict(n)
        return len(order)

    def evict_for(self, n_pages: int) -> int:
        """Pool pressure: free >= ``n_pages`` by evicting LRU leaves whose
        page has no reader besides the trie. Inner nodes become evictable
        as their children go. Returns the pages actually freed (may fall
        short)."""
        freed = 0
        while freed < n_pages:
            before = self.allocator.free_pages
            if not self._evict_lru(only_unreferenced=True):
                break
            freed += self.allocator.free_pages - before
        return freed

    def reclaimable(self) -> int:
        """Pages the trie could free under pressure: every node whose page
        has no reader besides the trie."""
        count = 0
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if self.allocator.refs.get(n.page, 0) == 1:
                count += 1
        return count

    def clear(self) -> None:
        """Drop every cached page (teardown, tests)."""
        while self._evict_lru():
            pass


class _PoolPressure(Exception):
    """An allocation could not be satisfied even after trie eviction and
    victim preemption. ``fatal=False``: park the requester (pressure drops
    as older or higher-priority work retires); ``fatal=True``: waiting
    cannot help (policy "never", or nobody else holds anything), so the
    caller unwinds the request and raises RuntimeError."""

    def __init__(self, fatal: bool, msg: str):
        super().__init__(msg)
        self.fatal = fatal
        self.msg = msg


def _request_tag(request_id) -> int:
    """Stable 31-bit tag of a request id, the seed of its sampling key: an
    int maps to itself, anything else to the crc32 of its ``repr``."""
    if isinstance(request_id, (int, np.integer)):
        return int(request_id) & 0x7FFFFFFF
    return zlib.crc32(repr(request_id).encode()) & 0x7FFFFFFF


# terminal request statuses: the stream is closed, no more tokens can come
_TERMINAL = ("done", "cancelled", "failed", "shed")
# kv_cache_stats()["recovery"]: what the recovery layer did
_RECOVERY_KEYS = ("retries", "backoff_total_ticks", "quarantined", "shed",
                  "checksum_failures", "watchdog_trips")


class RequestHandle:
    """Caller-facing view of a submitted request: its lifecycle
    (``queued -> prefilling -> decoding -> done``, with ``preempted`` and
    ``retrying`` parking and the ``cancelled``/``failed``/``shed`` exits),
    the tokens flushed so far, and ``cancel``/``stream``/``result``.
    ``failed`` is also the quarantine exit (``max_retries`` recoveries
    spent, pages freed); ``shed`` the load-shedding one."""

    __slots__ = ("_sched", "_req")

    def __init__(self, sched: "BatchScheduler", req: dict):
        self._sched = sched
        self._req = req

    @property
    def request_id(self):
        return self._req["id"]

    @property
    def status(self) -> str:
        return self._req["_status"]

    @property
    def tokens(self) -> list[int]:
        """Tokens generated (and flushed to the host) so far."""
        return list(self._req["generated"])

    @property
    def done(self) -> bool:
        return self._req["_status"] in _TERMINAL

    def cancel(self) -> bool:
        return self._sched.cancel(self._req["id"])

    def stream(self, *, timeout: int | None = None):
        """Synchronous token stream that drives the scheduler; ``timeout``
        bounds the ticks spent waiting for the next token (TimeoutError)."""
        return self._sched.stream(self._req["id"], timeout=timeout)

    def result(self, *, timeout: int | None = None) -> list[int]:
        """Drive the scheduler until this request finishes; its tokens."""
        for _ in self.stream(timeout=timeout):
            pass
        return self.tokens


def _sample_tokens(logits, keys, positions, *, greedy: bool, temperature: float,
                   top_k: int | None, vocab: int) -> torch.Tensor:
    """Next tokens of N rows: logits (N,V), keys (N,2) base keys, positions
    (N,) (or one int) the positions whose logits these are. Greedy: the
    argmax over the padded vocabulary, unmasked; keys and positions are
    not read. Sampled: logits in fp32 over ``max(temperature, 1e-6)``,
    padded ids masked, the top-k threshold at the k-th largest value
    (every value >= it kept), then ``categorical`` with the key
    ``fold_in(keys[i], positions[i])``. Returns (N,) int32."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    dev = logits.device
    if not isinstance(positions, torch.Tensor):
        positions = torch.full(logits.shape[:1], int(positions), dtype=torch.int64, device=dev)
    use = prng.fold_in(keys, positions)
    # a device scalar: a host float would be a reciprocal and a product on
    # the card, one rounding off the quotient
    t = torch.full((), max(float(temperature), 1e-6), dtype=torch.float32, device=dev)
    lg = logits.float() / t
    V = lg.shape[-1]
    if vocab < V:
        lg = lg.masked_fill(torch.arange(V, device=dev) >= vocab, float("-inf"))
    if top_k:
        kth = torch.topk(lg, min(int(top_k), V), dim=-1).values[:, -1:]
        lg = torch.where(lg >= kth, lg, float("-inf"))
    return prng.categorical(use, lg).to(torch.int32)


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """Host numpy -> device tensor that never aliases ``arr``.

    ``torch.from_numpy`` shares memory, and on the CPU ``.to(device)`` is a
    no-op, so without the copy a dispatch would read later mutations of the
    scheduler's host arrays (positions, block tables). The copy also makes
    the asynchronous host-to-device transfer safe."""
    return torch.from_numpy(arr.copy()).to(device, non_blocking=True)


class BatchScheduler:
    """Slot-based continuous batching with chunked prefill overlapped with
    decode, over the model's paged KV pool (or, with ``paged=False``, its
    dense cache), with priority admission, preemption and
    recompute-resume, the prefix cache, sampling, speculative decoding and
    fault recovery. Tokens are identical with overlap on or off, sharing
    on or off, speculation on or off, under any pool pressure and through
    any recovered fault, greedy or sampled, and paged or dense up to the
    two layouts' attention kernels' rounding (see the module docstring).

    Request records are dicts: ``id``, ``prompt``, ``max_new``,
    ``priority``, ``generated`` (host tokens), ``_status`` (queued |
    prefilling | decoding | preempted | retrying | done | cancelled |
    failed | shed), ``_retries``, and ``t_submit``/``t_first_token`` (host
    clock: submit, and the flush that first put a token on the host).

    ``session``: a ``PerfSession`` whose ``decode`` (decode dispatches or
    verify dispatches), ``prefill``, ``preempt`` and ``recovery`` regions
    this scheduler visits; None builds a null session (``TALP_ENABLE``
    can still turn it on). The caller owns ``finalize``.
    ``fault_injector``: a ``serve.faults.FaultInjector`` polled once a
    tick, or None.

    ``mesh``: the mesh of ranks the scheduler runs on (``launch.mesh
    .make_host_mesh``); by default the model's (``Transformer(...,
    mesh=)``, each rank holding its blocks of the weights). A model with
    whole weights on every rank (no mesh of its own, as JAX's serve
    launcher's unplaced parameters) takes a mesh whose ``"model"`` axis is
    1. Every rank runs the same scheduler and takes the same host
    decisions (admission, pages, the trie, preemption, drafts: they read
    only tokens that every rank holds); the steps split as
    ``serve_constraints`` says (decode and verify rows over the batch
    axes, their pool writes reaching every rank; a chunk on every rank;
    the ``"model"`` share of each), on the paged layout: the dense
    layout's scheduler on a mesh is not ported and raises."""

    def __init__(self, model, scfg: ServeConfig, session=None, fault_injector=None,
                 mesh=None):
        self.model, self.cfg, self.scfg = model, model.cfg, scfg
        self.device = model.device
        if mesh is None:
            mesh = model.mesh
        elif model.mesh is not mesh and (model.mesh is not None
                                         or mesh.sizes.get("model", 1) > 1):
            raise ValueError(
                "the scheduler's mesh is the model's: a model with whole weights "
                "runs on a mesh whose 'model' axis is 1")
        self.mesh = mesh
        cfg = self.cfg
        if self.mesh is not None and self.mesh.distributed and self.mesh.devices.size > 1 \
                and not scfg.paged:
            raise ValueError(
                "the dense layout's scheduler on a mesh of ranks is not ported "
                "(ROADMAP item 8b-iv): serve a mesh on the paged layout")
        # the chunked recurrences re-chunk internally at the ssm/xlstm chunk:
        # a prefill chunk, and the verify chunk, larger than that must tile it
        inners = [c.chunk for c in (cfg.ssm, cfg.xlstm) if c is not None]
        for inner in inners:
            if scfg.prefill_chunk > inner and scfg.prefill_chunk % inner:
                raise ValueError(
                    f"prefill_chunk={scfg.prefill_chunk} must be <= the "
                    f"recurrent chunk {inner} or a multiple of it"
                )
        if scfg.paged and scfg.max_len % scfg.page_size:
            raise ValueError(
                f"paged serving needs max_len ({scfg.max_len}) divisible by "
                f"page_size ({scfg.page_size}) so the paged and dense layouts "
                f"stay interchangeable"
            )
        self.session = session if session is not None else PerfSession(
            SessionConfig(app_name="serve", backend="null")
        )
        if scfg.spec_decode:
            for inner in inners:
                verify_c = scfg.spec_k + 1
                if verify_c > inner and verify_c % inner:
                    raise ValueError(
                        f"spec_k+1={verify_c} (the verify chunk) must be <= "
                        f"the recurrent chunk {inner} or a multiple of it"
                    )
        # recurrent state carries unconditionally (no positional mask): a
        # reattached slot's rows are reset to their initial values; the
        # verify runs in two passes so it advances over accepted tokens only
        self._has_recurrent = any(k in ("mamba2", "mlstm", "slstm") for k in cfg.pattern)
        self._dirty: set[int] = set()     # slots whose state may be non-fresh
        # each step's split over the mesh, built once (as JAX builds its
        # constraints once a step function); NULL_CONSTRAINTS without one
        self._lc = {
            "decode": serve_constraints(model, self.mesh, scfg.batch, "decode"),
            "chunk": serve_constraints(model, self.mesh, 1, "chunk", scfg.prefill_chunk),
            "verify": serve_constraints(model, self.mesh, scfg.batch, "chunk",
                                        scfg.spec_k + 1),
        }
        kv = self._lc["decode"].kv
        self._kv_heads = kv if kv is not None and kv.heads else None
        n_dev = 1 if self.mesh is None else self.mesh.devices.size
        # observe the sampled tokens only: the caches are written in place
        # and never leave the card
        self.decode = self.session.wrap_step(
            self._decode_step, region="decode", derive=True, num_devices=n_dev,
            observe=lambda out: {"outputs": out[0]})
        self.prefill = self.session.wrap_step(
            self._prefill_step, region="prefill", derive=True, num_devices=n_dev,
            observe=lambda out: {"outputs": out[0]})
        # the batched verify shares the decode region: a speculative tick is
        # the decode tick, spec_k+1 tokens wide
        self.verify = None
        if scfg.spec_decode:
            self.verify = self.session.wrap_step(
                self._verify_step, region="decode", derive=True, num_devices=n_dev,
                observe=lambda out: {"outputs": out[0]})
        self._sample = functools.partial(
            _sample_tokens, greedy=scfg.greedy, temperature=scfg.temperature,
            top_k=scfg.top_k, vocab=self.cfg.vocab)
        # slot -> physical pages (empty on the dense layout)
        self._slot_pages: list[list[int]] = [[] for _ in range(scfg.batch)]
        if scfg.paged:
            self._max_pages = scfg.max_len // scfg.page_size
            n_pages = scfg.num_pages
            if n_pages is None:
                n_pages = scfg.batch * self._max_pages
            self._alloc: PageAllocator | None = PageAllocator(n_pages)
            self._prefix = (
                PrefixCache(scfg.page_size, self._alloc,
                            capacity=scfg.prefix_trie_capacity)
                if scfg.prefix_cache else None
            )
            self._tables = np.full((scfg.batch, self._max_pages), -1, np.int32)
            self._tables_dirty = True
            self._tables_dev = None
            # this rank's blocks on the scheduler's mesh (the model's, or
            # the one given beside a model with whole weights)
            model._no_cache("init_cache")
            self.caches = init_cache(model.cfg, scfg.batch, scfg.max_len,
                                     page_size=scfg.page_size, num_pages=n_pages,
                                     device=self.device, mesh=self.mesh)
        else:
            self._alloc = None
            self._prefix = None
            self.caches = model.init_cache(scfg.batch, scfg.max_len, paged=False)
        self.tokens = torch.zeros((scfg.batch, 1), dtype=torch.int32,
                                  device=self.device)
        # per-slot sampling key rows on the device; in sampled mode an attach
        # overwrites the slot's row with the request's own key, so the key
        # follows the request, not the slot (greedy never reads them)
        self._base_key = prng.prng_key(scfg.sample_seed)
        self.rng_keys = prng.split(self._base_key, scfg.batch).to(self.device)
        self.queue: list[dict] = []    # admission queue: priority, FIFO within
        self.active: list[dict | None] = [None] * scfg.batch   # decoding slots
        self.pos = np.zeros(scfg.batch, np.int32)              # per-slot position
        self.completed: list[dict] = []
        self.cancelled: list[dict] = []
        self.failed: list[dict] = []      # fatal pool pressure or quarantine
        self._parked: list[dict] = []     # preempted or retrying, to resume
        self._by_id: dict = {}            # request_id -> req (handles, cancel)
        self._seq = 0                     # admission order: FIFO within a class
        # recompute-resume: slot -> generated tokens still to re-feed through
        # decode at their original positions (outputs discarded)
        self._replay: dict[int, list[int]] = {}
        self._prefills: list[dict] = []
        self._prefilling: list[dict | None] = [None] * scfg.batch
        # next-token seeds {slot: device scalar or int}, one scatter per tick
        self._seeds: dict[int, torch.Tensor | int] = {}
        # pending readbacks: (device tokens (n,1), device sentinel (n,),
        # row -> request map)
        self._pending: list[tuple[torch.Tensor, torch.Tensor, list[dict | None]]] = []
        # speculative decode: each slot's next input token, on the host (the
        # accept counts come back every tick anyway)
        self._last_tok = np.zeros(scfg.batch, np.int32)
        # -- fault injection and recovery ---------------------------------
        self.faults = fault_injector
        self.shed: list[dict] = []        # load-shed at admission
        self._fault_nan_slots: set[int] = set()   # poison the next dispatch
        # ids with a poisoned row dispatched but not flushed: not targeted
        # again until the poison reaches the host
        self._fault_nan_inflight: set = set()
        self._fault_mask_zero = torch.zeros(scfg.batch, dtype=torch.bool, device=self.device)
        # allocator spikes: (release tick, pages), released even after the
        # injector drains and by drain(), so chaos never leaks pool pages
        self._spike_holds: list[tuple[int, list[int]]] = []
        self._hang_pending = 0.0          # injected dispatch delay (s)
        self._hang_slot: int | None = None
        # pages the injector filled with NaN: zeroed before they return to
        # the free list (a recycled NaN page would poison its next owner)
        self._corrupted_pages: set[int] = set()
        self._corrupted_rows: set[int] = set()   # dense rows to zero on release
        self.stats = {
            "ticks": 0, "decode_steps": 0, "prefill_chunks": 0, "readbacks": 0,
            # ticks with a prefill in flight beside >= 1 decoding slot, and
            # ticks whose decode dispatch waited on prefill work
            "overlap_ticks": 0, "decode_after_prefill_ticks": 0,
            # pressure accounting (kv_cache_stats()["pressure"])
            "preemptions": 0, "resumes": 0, "cancellations": 0,
            "pages_freed_by_preempt": 0, "evictions_for_preempt": 0,
            "peak_queue_depth": 0,
            # recovery accounting (kv_cache_stats()["recovery"])
            "retries": 0, "backoff_total_ticks": 0, "quarantined": 0,
            "shed": 0, "checksum_failures": 0, "watchdog_trips": 0,
            # speculation (kv_cache_stats()["speculation"]): drafted, accepted
            # and rejected count draft tokens only; spec_emitted new tokens
            # (replayed history excluded)
            "spec_dispatches": 0, "spec_drafted": 0, "spec_accepted": 0,
            "spec_rejected": 0, "spec_emitted": 0,
        }

    # -- the dispatched steps (wrapped by the session) ----------------------

    def _pick(self, logits, keys, pos, lc=NULL_CONSTRAINTS):
        """The next tokens of the rank's rows from their logits (under
        ``lc.tp`` the rank's vocabulary columns): greedy, the argmax across
        the vocabulary's ranks (``vocab_argmax``); sampled, the whole rows
        gathered (``vocab_gather``) and the same draw on every rank, from
        the same keys."""
        if self.scfg.greedy:
            return vocab_argmax(logits, lc.tp).to(torch.int32)
        return self._sample(vocab_gather(logits, lc.tp), keys, pos)

    def _poison_and_sample(self, logits, fault_mask, keys, pos, lc=NULL_CONSTRAINTS):
        """NaN into the masked rows' logits (a select: an all-False mask
        changes nothing), the sentinel ``bad`` (N,) = any non-finite logit
        in the row (on any of the vocabulary's ranks), computed on the
        device, and the sampled tokens."""
        logits = torch.where(fault_mask[:, None], torch.full((), float("nan"),
                             dtype=logits.dtype, device=logits.device), logits)
        bad = any_over(~torch.isfinite(logits).all(dim=-1), lc.tp)
        return self._pick(logits, keys, pos, lc), bad

    def _decode_step(self, tokens, pos, active, tables, keys, fault_mask):
        """One token a slot; returns (tokens (B,1), bad (B,)). On a mesh of
        ranks each rank runs its rows (``_lc["decode"]``), writes every
        rank's K/V into its pool block and gathers every row's token."""
        lc = self._lc["decode"]
        r = _rows(lc, self.scfg.batch)
        logits = self.model.decode_step(tokens[r], pos[r], self.caches, active=active[r],
                                        block_tables=tables, lc=lc)
        tok, bad = self._poison_and_sample(logits, fault_mask[r], keys[r], pos[r], lc)
        return _all_rows(tok[:, None], lc), _all_rows(bad, lc)

    def _prefill_step(self, chunk, start, length, tables, keys, slot):
        """One chunk at ``start`` into ``slot`` (its table row when paged,
        its cache row when dense); samples at its last valid position.
        Returns (token (1,), bad (1,)). On a mesh every rank runs the chunk
        (one row does not split over the batch axes), split over
        ``"model"`` as ``_lc["chunk"]`` says, on the slot's recurrent rows
        lent by the rank that holds them (``_chunk_caches``)."""
        lc = self._lc["chunk"]
        caches, row, lent = self._chunk_caches(slot)
        logits = self.model.prefill_chunk(chunk, caches, start, length, tables,
                                          slot=row, lc=lc)
        if lent is not None:
            self._take_back(*lent)
        bad = any_over(~torch.isfinite(logits).all(dim=-1), lc.tp)
        return self._pick(logits, keys, start + length - 1, lc), bad

    def _chunk_caches(self, slot: int):
        """(caches, row, lent) for a chunk of ``slot``: the scheduler's
        caches and ``slot`` itself, unless the rows split over the batch
        axes and the arch carries recurrent state. Then a rank holds its
        rows' state alone (``cache_pspec_tree``) while every rank runs the
        chunk: the holder lends the slot's rows to every rank
        (``row_broadcast``), the chunk runs on them as row 0, and the holder
        gets ``lent`` (``_take_back``'s arguments) to keep the new state."""
        rk = self._lc["decode"].ranks
        if not self._has_recurrent or rk is None or rk.group is None:
            return self.caches, slot, None
        owner, row = divmod(slot, self.scfg.batch // rk.shards)
        caches, rows = {}, {}
        for name, c in self.caches.items():
            if "attn" in c:
                caches[name] = c
                continue
            (key, leaves), = c.items()
            rows[name] = {k: row_broadcast(v[:, row:row + 1], rk, owner)
                          for k, v in leaves.items()}
            caches[name] = {key: rows[name]}
        return caches, 0, ((rows, row) if rk.index == owner else None)

    def _take_back(self, rows: dict, row: int) -> None:
        for name, leaves in rows.items():
            (_, held), = self.caches[name].items()
            for k, v in leaves.items():
                held[k][:, row:row + 1].copy_(v)

    def _held_rows(self, slots: list[int]) -> list[int]:
        """The rows of this rank's recurrent state that hold ``slots``
        (those of them it holds): the slots themselves unless the rows
        split over the batch axes."""
        rk = self._lc["decode"].ranks
        if rk is None or rk.group is None:
            return list(slots)
        per = self.scfg.batch // rk.shards
        return [s - rk.index * per for s in slots if s // per == rk.index]

    def _verify_step(self, tokens, start, length, tables, keys, fault_mask):
        """The batched speculative verify: row b is ``[last token, drafts..]``
        (B,C) at ``start[b]``, ``length[b]`` valid tokens (0: an idle slot,
        nothing written). One ``prefill_chunk`` with every position's
        logits; each position sampled as a decode step there would be.
        Returns (out (B,C) int32, the verified token at each position;
        accept (B,) int32, the accepted drafts: the longest prefix with
        ``out[:, i] == tokens[:, i+1]`` within ``length - 1``; bad (B,), a
        non-finite logit at a valid position of the row, after the
        ``fault_mask`` rows are poisoned).

        With recurrent state (JAX's ``two_pass``) the scoring pass leaves
        the state as it was, and a second ``prefill_chunk`` over the same
        tokens, clamped to ``min(accept + 1, length)``, writes it: the state
        advances over exactly the accepted tokens, and the attention K/V of
        those positions is rewritten with the same values.

        On a mesh each rank runs its rows (``_lc["verify"]``) and gathers
        every row's outputs, accept counts and sentinels."""
        lc = self._lc["verify"]
        r = _rows(lc, tokens.shape[0])
        tokens, start, length, keys = tokens[r], start[r], length[r], keys[r]
        B, C = tokens.shape
        logits = self.model.prefill_chunk(tokens, self.caches, start, length, tables,
                                          all_logits=True,
                                          commit_state=not self._has_recurrent,
                                          lc=lc)  # (B,C,V)
        logits = torch.where(fault_mask[r][:, None, None], torch.full(
            (), float("nan"), dtype=logits.dtype, device=logits.device), logits)
        offs = torch.arange(C, dtype=torch.int32, device=tokens.device)[None, :]
        valid = offs < length[:, None]
        bad = any_over((~torch.isfinite(logits).all(dim=-1) & valid).any(dim=1), lc.tp)
        positions = start[:, None] + offs
        if not self.scfg.greedy:
            keys = keys.repeat_interleave(C, dim=0)
        out = self._pick(logits.reshape(B * C, -1), keys, positions.reshape(-1),
                         lc).reshape(B, C)
        match = (out[:, :-1] == tokens[:, 1:]) & (offs[:, :C - 1] < (length - 1)[:, None])
        accept = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
        if self._has_recurrent:
            commit = torch.where(length > 0, torch.minimum(accept + 1, length), 0)
            self.model.prefill_chunk(tokens, self.caches, start, commit, tables, lc=lc)
        return _all_rows(out, lc), _all_rows(accept, lc), _all_rows(bad, lc)

    # -- admission ---------------------------------------------------------

    def submit(self, prompt_tokens, request_id, max_new: int = 32,
               priority: int = 0) -> RequestHandle:
        """Queue a request; returns its ``RequestHandle`` at once. Higher
        ``priority`` is admitted first (FIFO within a class) and may preempt
        strictly lower-priority work. Raises ValueError for a request that
        can never fit: the last decode writes position prompt+max_new-2.
        With more than ``shed_queue_depth`` requests queued, the
        lowest-priority youngest waiter (maybe this one) is shed: its handle
        reads ``shed`` at once, nothing raises."""
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
        if self._alloc is not None and pages > self._alloc.num_pages:
            raise ValueError(
                f"request {request_id!r} needs {pages} page(s) (prompt "
                f"{len(prompt)}, max_new {max_new}, page_size "
                f"{self.scfg.page_size}) but the pool only holds "
                f"{self._alloc.num_pages}; raise ServeConfig.num_pages "
                f"(--num-pages)"
            )
        req = {"id": request_id, "prompt": prompt, "max_new": max_new,
               "generated": [], "_pending": 0, "priority": int(priority),
               "_seq": self._seq, "_tag": _request_tag(request_id),
               "_status": "queued", "_cancelled": False,
               "_retries": 0, "_not_before": 0,
               "t_submit": time.perf_counter(), "t_first_token": None}
        self._seq += 1
        self.queue.append(req)
        self._by_id[request_id] = req
        if (self.scfg.shed_queue_depth is not None
                and len(self.queue) > self.scfg.shed_queue_depth):
            victim = min(self.queue, key=lambda r: (r["priority"], -r["_seq"]))
            self.queue.remove(victim)
            victim["_status"] = "shed"
            self.shed.append(victim)
            self.stats["shed"] += 1
            self.session.event("recovery")
        self.stats["peak_queue_depth"] = max(
            self.stats["peak_queue_depth"], len(self.queue) + len(self._parked))
        return RequestHandle(self, req)

    def cancel(self, request_id) -> bool:
        """Cancel mid-stream: take the request out of whichever pool holds
        it (queue, parked, in-flight prefill or a decoding slot), release
        its pages and close its stream. Trie pins and co-resident slots are
        untouched; rows dispatched but not flushed are dropped at the next
        flush. True if the request was still live."""
        req = self._by_id.get(request_id)
        if req is None or req["_status"] in _TERMINAL:
            return False
        req["_cancelled"] = True
        if req in self.queue:
            self.queue.remove(req)
        elif req in self._parked:
            self._parked.remove(req)
        else:
            slot = self._slot_of(req)
            if slot is not None:
                self._detach(slot)
        req["_status"] = "cancelled"
        self.cancelled.append(req)
        self.stats["cancellations"] += 1
        return True

    def flush(self) -> None:
        """Materialize pending tokens now (streaming callers)."""
        self._flush()

    def stream(self, request_id, *, timeout: int | None = None):
        """Generator of ``request_id``'s tokens that drives the scheduler
        (step, flush) until new tokens land; ends when the request reaches
        a terminal status. ``timeout`` bounds the ticks without progress
        (TimeoutError); without it a stall raises RuntimeError after
        100,000 ticks."""
        req = self._by_id.get(request_id)
        if req is None:
            raise KeyError(f"unknown request {request_id!r}")
        limit = timeout if timeout is not None else 100_000
        sent, idle = 0, 0
        while True:
            while sent < len(req["generated"]):
                idle = 0
                yield req["generated"][sent]
                sent += 1
            if req["_status"] in _TERMINAL:
                return
            if idle >= limit:
                if timeout is not None:
                    raise TimeoutError(
                        f"request {request_id!r} made no progress in {idle} "
                        f"scheduler ticks (status {req['_status']!r})"
                    )
                raise RuntimeError(
                    f"request {request_id!r} stalled in stream() "
                    f"(status {req['_status']!r})"
                )
            self.step()
            self._flush()
            idle += 1

    async def stream_async(self, request_id):
        """Async ``stream``: yields to the event loop between ticks, so
        several consumers interleave over one scheduler."""
        import asyncio

        req = self._by_id.get(request_id)
        if req is None:
            raise KeyError(f"unknown request {request_id!r}")
        sent = 0
        while True:
            while sent < len(req["generated"]):
                yield req["generated"][sent]
                sent += 1
            if req["_status"] in _TERMINAL:
                return
            self.step()
            self._flush()
            await asyncio.sleep(0)

    # -- attach ------------------------------------------------------------

    def _free(self, slot: int) -> bool:
        return self.active[slot] is None and self._prefilling[slot] is None

    def _attach(self) -> None:
        if self.scfg.preempt_policy != "never":
            self._preempt_for_priority()
        if not (self.queue or self._parked):
            return
        order = lambda r: (-r["priority"], r["_seq"])
        self.queue.sort(key=order)    # stable: FIFO within a priority class
        self._parked.sort(key=order)
        reused: list[int] = []
        for slot in range(self.scfg.batch):
            if not self._free(slot):
                continue
            req = self._next_admittable()
            if req is None:
                break
            if slot in self._dirty:
                reused.append(slot)
            self._dirty.add(slot)
            if not self._attach_one(slot, req):
                break  # attach-time pool pressure: try again next tick
        if reused:
            self._reset_slots(reused)

    def _reset_slots(self, slots: list[int]) -> None:
        """Restore reused slots' recurrent rows (SSM, conv, xLSTM carries)
        to their initial values, which are not all zero (xLSTM's ``m``
        starts at -1e30), before the new request's first prefill chunk or
        decode step. Attention K/V needs no reset: stale lines never enter
        the visible window."""
        if self._has_recurrent:
            rows = self._held_rows(slots)
            if rows:
                self.model.reset_state(self.caches, rows)

    def _next_admittable(self) -> dict | None:
        """Best waiter across the queue and the parked set on (priority
        desc, arrival asc); a parked request keeps its seq, and must pass
        ``_ready`` and the resume gate (``_resume_fits``) so a resume cannot
        thrash straight back out."""
        order = lambda r: (-r["priority"], r["_seq"])
        parked = next(
            (r for r in self._parked if self._ready(r) and self._resume_fits(r)),
            None,
        )
        queued = self.queue[0] if self.queue else None
        if parked is not None and (queued is None or order(parked) <= order(queued)):
            self._parked.remove(parked)
            return parked
        if queued is not None:
            return self.queue.pop(0)
        return None

    def _ready(self, req: dict) -> bool:
        """Retry backoff gate: a retrying request stays parked until its
        ``_not_before`` tick (set by ``_fault_retry``)."""
        return req["_not_before"] <= self.stats["ticks"]

    def _resume_fits(self, req) -> bool:
        if self._alloc is None:
            return True
        need = len(req["prompt"]) + max(len(req["generated"]), 1)
        need = -(-need // self.scfg.page_size)
        avail = self._alloc.free_pages
        if self._prefix is not None:
            avail += self._prefix.reclaimable()
        return avail >= need

    def _attach_one(self, slot: int, req: dict) -> bool:
        """Attach ``req`` to the free ``slot``; False on attach-time pool
        pressure (the request goes back where it came from, unwound). A
        request with generated history is a recompute-resume: the prompt
        re-prefills on the normal chunk grid and the history is scheduled
        for decode replay. A retrying request (fault recovery) takes the
        same path: its clean history replays, the faulted suffix
        recomputes."""
        resume = req["_status"] in ("preempted", "retrying")
        self.pos[slot] = 0
        if not self.scfg.greedy:
            # the slot's key row becomes the request's key, so a resumed
            # request keeps its stream in any slot
            row = prng.fold_in(self._base_key, req["_tag"])
            self.rng_keys[slot] = _upload(row.numpy(), self.device)
        if not req["prompt"]:
            # nothing to prefill: decode from an empty cache off seed 0; on
            # resume replay the whole history (the seed regenerates
            # generated[0], which is discarded)
            if self.scfg.spec_decode:
                self._last_tok[slot] = 0
            else:
                self._seeds[slot] = 0
            if req["generated"]:
                self._replay[slot] = list(req["generated"])
            self.active[slot] = req
            req["_status"] = "decoding"
            if resume:
                self.stats["resumes"] += 1
            return True
        self._seeds.pop(slot, None)  # a retired request's stale seed
        task = {"req": req, "slot": slot, "done": 0,
                "prompt": np.asarray(req["prompt"], np.int32)}
        if self._prefix is not None:
            try:
                task["done"] = self._attach_prefix(slot, req)
            except _PoolPressure as e:
                self._release_slot_pages(slot)
                if e.fatal:
                    req["_status"] = "failed"
                    self.failed.append(req)
                    raise RuntimeError(
                        f"{e.msg} [kv_cache_stats: {self.kv_cache_stats()}]"
                    ) from None
                if resume:
                    self._parked.append(req)
                else:
                    req["_status"] = "queued"
                    self.queue.append(req)
                return False
        req["_status"] = "prefilling"
        if resume:
            self.stats["resumes"] += 1
        self._prefilling[slot] = task
        self._prefills.append(task)
        return True

    def _attach_prefix(self, slot: int, req) -> int:
        """Map the trie's longest cached prefix of the prompt into
        ``slot``'s block table: fully matched pages read-only (refcount
        bump, their prefill skipped), a partly matched page copied on the
        device into a fresh page whose tail the prefill then writes. At
        least one prompt token is left to prefill: the last chunk's logits
        give the first generated token. Returns the prefill fast-forward
        ``use``; every later write lands at or past it, so no shared page
        is ever written."""
        prompt = req["prompt"]
        psize = self.scfg.page_size
        chain, donor, donor_rows = self._prefix.match(prompt)
        if self.scfg.checksum_pages:
            chain, donor, donor_rows = self._verify_chain(chain, donor, donor_rows)
        st = self._prefix.stats
        if self._has_recurrent:
            # a hybrid arch shares the matched pages (the memory win) but
            # skips no prefill: the recurrent state has no positional mask to
            # fast-forward through, so every prompt token runs. The rerun
            # writes the shared pages' K/V again with the same values (same
            # tokens, positions and chunk grid)
            for node in chain:
                self._alloc.share([node.page])
                self._tables[slot, len(self._slot_pages[slot])] = node.page
                self._slot_pages[slot].append(node.page)
                self._prefix._touch(node)
            if chain:
                self._tables_dirty = True
                st["hits"] += 1
                st["hit_tokens"] += len(chain) * psize
                st["pages_shared"] += len(chain)
            else:
                st["misses"] += 1
            return 0
        use = min(len(chain) * psize + donor_rows, len(prompt) - 1)
        if use <= 0:
            st["misses"] += 1
            return 0
        n_full, cow_rows = divmod(use, psize)
        # the leave-one-token clamp can demote the last fully matched page
        # to the copy-on-write donor (prompt ends on its boundary)
        cow_donor = None
        if cow_rows:
            cow_donor = chain[n_full] if n_full < len(chain) else donor
        for node in chain[:n_full]:
            self._alloc.share([node.page])
            self._tables[slot, len(self._slot_pages[slot])] = node.page
            self._slot_pages[slot].append(node.page)
            self._prefix._touch(node)
        if cow_donor is not None:
            new = self._alloc_pages(1, req)[0]
            self._tables[slot, len(self._slot_pages[slot])] = new
            self._slot_pages[slot].append(new)
            self._prefix._touch(cow_donor)
            self._cow_copy(cow_donor.page, new)
            st["cow_copies"] += 1
        self._tables_dirty = True
        st["hits"] += 1
        st["hit_tokens"] += use
        st["prefill_tokens_skipped"] += use
        st["pages_shared"] += n_full
        return use

    def _verify_chain(self, chain, donor, donor_rows):
        """Per-page checksums at sharing time: recompute each matched page's
        fingerprint and compare it with the one recorded at insert. A
        mismatch (a flipped bit stays finite, so the sentinel cannot see
        it) evicts the node's subtree and cuts the match before it: the
        request prefills those tokens afresh and nobody matches them
        again."""
        for j, node in enumerate(chain):
            if node.checksum is None:
                continue
            if F.page_fingerprint(self.caches, node.page, self._kv_heads) != node.checksum:
                self.stats["checksum_failures"] += 1
                self._prefix.evict_subtree(node)
                self.session.event("recovery")
                return chain[:j], None, 0
        if donor is not None and donor.checksum is not None:
            if F.page_fingerprint(self.caches, donor.page, self._kv_heads) != donor.checksum:
                self.stats["checksum_failures"] += 1
                self._prefix.evict_subtree(donor)
                self.session.event("recovery")
                donor, donor_rows = None, 0
        return chain, donor, donor_rows

    def _cow_copy(self, src: int, dst: int) -> None:
        """Copy physical page ``src`` to ``dst`` in every attention slot's K
        and V pool, all repeats, in place on the device (no host sync); on
        a mesh within the rank's pool block."""
        for slot in self.caches.values():
            for pool in slot.get("attn", {}).values():
                pool[:, dst].copy_(pool[:, src])

    # -- preemption --------------------------------------------------------

    def _occupant(self, slot: int) -> dict | None:
        task = self._prefilling[slot]
        return self.active[slot] or (task["req"] if task else None)

    def _slot_of(self, req: dict) -> int | None:
        for slot in range(self.scfg.batch):
            if self._occupant(slot) is req:
                return slot
        return None

    def _detach(self, slot: int) -> None:
        """Take whatever occupies ``slot`` off the batch: its in-flight
        prefill, its pages, its seed and replay. The request itself is left
        for the caller to place (parked, cancelled, failed)."""
        task = self._prefilling[slot]
        if task is not None:
            self._prefills.remove(task)
            self._prefilling[slot] = None
        self.active[slot] = None
        self._release_slot_pages(slot)
        self._seeds.pop(slot, None)
        self._replay.pop(slot, None)

    def _preempt_for_priority(self) -> None:
        """A strictly-higher-priority waiter behind a fully busy batch
        evicts the lowest-priority occupant (youngest on a tie), one per
        tick."""
        waiters = [r["priority"] for r in self.queue]
        waiters += [r["priority"] for r in self._parked
                    if self._ready(r) and self._resume_fits(r)]
        if not waiters or any(self._free(s) for s in range(self.scfg.batch)):
            return
        top = max(waiters)
        occ = [
            (r["priority"], -r["_seq"], slot)
            for slot in range(self.scfg.batch)
            if (r := self._occupant(slot)) is not None and r["priority"] < top
        ]
        if occ:
            self._preempt(min(occ)[2])

    def _pick_victim(self, requester: dict) -> int | None:
        """Pool-pressure victim for ``requester`` by ``preempt_policy``:
        only strictly lower-priority, or equal-priority strictly younger,
        occupants holding pages are eligible, so preemption never
        ping-pongs."""
        rp, rs = requester["priority"], requester["_seq"]
        cand = []
        for slot in range(self.scfg.batch):
            occ = self._occupant(slot)
            if occ is None or occ is requester or not self._slot_pages[slot]:
                continue
            if occ["priority"] < rp or (occ["priority"] == rp and occ["_seq"] > rs):
                cand.append((slot, occ))
        if not cand:
            return None
        policy = self.scfg.preempt_policy
        if policy == "pages":        # free the most memory per eviction
            key = lambda c: -len(self._slot_pages[c[0]])
        elif policy == "progress":   # least work lost to recompute
            key = lambda c: len(c[1]["generated"]) + c[1]["_pending"]
        else:                        # "priority": cheapest class first, then
            key = lambda c: (        # most pages, then least progress
                c[1]["priority"],
                -len(self._slot_pages[c[0]]),
                len(c[1]["generated"]) + c[1]["_pending"],
            )
        return min(cand, key=key)[0]

    def _preempt(self, slot: int) -> None:
        """Evict ``slot``'s request for recompute-resume: flush first (replay
        re-feeds its history, which must be on the host), release its pages
        and park it. The trie keeps its own pins."""
        self._flush()
        req = self._occupant(slot)
        if req is None:
            return  # the flush retired it
        with self.session.region("preempt"):
            freed = len(self._slot_pages[slot])  # 0 on the dense layout
            self._detach(slot)
            req["_status"] = "preempted"
            self._parked.append(req)
            self.stats["preemptions"] += 1
            self.stats["pages_freed_by_preempt"] += freed

    def _handle_pressure(self, slot: int, e: _PoolPressure) -> None:
        """Non-fatal: park the requester itself. Fatal: unwind everything
        the request holds (nothing leaks) and raise RuntimeError."""
        if not e.fatal:
            self._preempt(slot)
            return
        req = self._occupant(slot)
        self._detach(slot)
        if req is not None:
            req["_status"] = "failed"
            self.failed.append(req)
        raise RuntimeError(
            f"{e.msg} [kv_cache_stats: {self.kv_cache_stats()}]"
        ) from None

    # -- fault recovery (retry, quarantine, injection) -----------------------

    def _fault_retry(self, req: dict, poisoned: bool = False) -> None:
        """Flush (the history must be on the host: resume replays it),
        detach the request (pages freed, NaN storage scrubbed on the way)
        and park it until ``min(cap, base << (retries-1))`` ticks from now.
        The re-attach is a recompute-resume, so the stream equals a
        fault-free run's; past ``max_retries`` the request is quarantined.
        ``poisoned``: the sentinel flagged it (see ``_mark_poisoned``)."""
        if poisoned:
            self._mark_poisoned(req)
        self._flush()
        if req["_status"] in _TERMINAL or (
            req["_status"] == "retrying" and req in self._parked
        ):
            return  # already resolved, or already parked for a retry
        if req["_retries"] >= self.scfg.max_retries:
            self._quarantine(req)
            return
        self._unplace(req)
        req["_retries"] += 1
        backoff = min(self.scfg.retry_backoff_cap,
                      self.scfg.retry_backoff_base << (req["_retries"] - 1))
        req["_not_before"] = self.stats["ticks"] + backoff
        req["_status"] = "retrying"
        self._parked.append(req)
        self.stats["retries"] += 1
        self.stats["backoff_total_ticks"] += backoff
        self.session.event("recovery")

    def _quarantine(self, req: dict) -> None:
        """Retries spent: terminal ``failed``, pages freed, neighbours
        untouched."""
        self._unplace(req)
        req["_status"] = "failed"
        self.failed.append(req)
        self.stats["quarantined"] += 1
        self.session.event("recovery")

    def _unplace(self, req: dict) -> None:
        """Take ``req`` out of its slot, the queue or the parked set."""
        slot = self._slot_of(req)
        if slot is not None:
            self._detach(slot)
        elif req in self.queue:
            self.queue.remove(req)
        elif req in self._parked:
            self._parked.remove(req)

    def _mark_poisoned(self, req: dict) -> None:
        """A request the sentinel flagged may have read a NaN, and then
        wrote NaN K/V at every position since, in its own pages (or dense
        row), not only in the page the injector hit. Its private storage
        (pages no one else holds) is marked for the scrub on release: a
        recycled page's unwritten tail is read masked, and 0 * NaN would
        poison the next owner, who would poison the next (the JAX package
        scrubs only the injected pages; ROADMAP.md Queue 3)."""
        slot = self._slot_of(req)
        if slot is None:
            return
        if self._alloc is None:
            self._corrupted_rows.add(slot)
        else:
            self._corrupted_pages.update(
                p for p in self._slot_pages[slot] if self._alloc.refs.get(p) == 1)

    def _scrub_slot(self, slot: int) -> None:
        """Zero, on the device, every NaN page ``slot`` still maps (or its
        dense row), before its storage is reused: the free list recycles
        pages as they are, and masked attention products carry a NaN even
        from a masked key (0 * NaN), in the plain versions and in a kernel
        tile that holds a visible key."""
        if slot in self._corrupted_rows:
            self._corrupted_rows.discard(slot)
            for cache in self.caches.values():
                for rows in cache.get("attn", {}).values():
                    rows[:, slot].zero_()
        dirty = [p for p in self._slot_pages[slot] if p in self._corrupted_pages]
        if dirty:
            F.page_edit(self.caches, dirty, "zero")
            self._corrupted_pages.difference_update(dirty)

    def _apply_faults(self) -> None:
        """Release expired allocator spikes and apply the injector's due
        events. An event without a target this tick is deferred; targets
        come from the event's seeded picks, so a rerun hits the same
        victims."""
        tick = self.stats["ticks"]
        if self._spike_holds:
            expired = [h for h in self._spike_holds if h[0] <= tick]
            if expired:
                self._spike_holds = [h for h in self._spike_holds if h[0] > tick]
                for _, pages in expired:
                    self._alloc.release(pages)
        if self.faults is None:
            return
        for e in self.faults.due(tick):
            if e.kind == "nan":
                cand = self._fault_decode_slots(e.request_id)
                if not cand:
                    self.faults.defer(e, tick)
                    continue
                victim = cand[e.pick % len(cand)]
                if victim in self._fault_nan_slots:
                    # two NaNs in one dispatch read as one: every injection
                    # poisons a dispatch of its own
                    self.faults.defer(e, tick)
                    continue
                self._fault_nan_slots.add(victim)
                self.faults.record(e.kind)
            elif e.kind == "hang":
                cand = self._fault_decode_slots(e.request_id)
                if not cand:
                    self.faults.defer(e, tick)
                    continue
                self._hang_slot = cand[e.pick % len(cand)]
                self._hang_pending = self.faults.fcfg.hang_s
                self.faults.record(e.kind)
            elif e.kind == "alloc_spike":
                if self._alloc is None or self._alloc.free_pages == 0:
                    self.faults.defer(e, tick)
                    continue
                n = min(self.faults.fcfg.spike_pages, self._alloc.free_pages)
                pages = self._alloc.alloc(n, owner="fault-injector")
                self._spike_holds.append((tick + self.faults.fcfg.spike_ticks, pages))
                self.faults.record(e.kind)
            elif e.kind == "page_corrupt":
                if self._alloc is None:
                    continue  # the dense layout has no pages: dropped
                mode = self.faults.fcfg.corrupt_mode
                cand = self._fault_page_candidates(mode, e.request_id)
                if not cand:
                    self.faults.defer(e, tick)
                    continue
                page = cand[e.pick2 % len(cand)]
                F.page_edit(self.caches, page, mode)
                if mode == "nan":
                    # flipped bits stay finite and are overwritten or masked
                    # for the next owner; a NaN page needs a scrub
                    self._corrupted_pages.add(page)
                self.faults.record(e.kind)

    def _fault_decode_slots(self, request_id) -> list[int]:
        """Slots a nan or hang fault can target: decoding, not replaying (a
        replayed row's output is discarded), not already poisoned in
        flight, and the pinned request's if ``request_id`` is set."""
        return [
            s for s in range(self.scfg.batch)
            if (r := self.active[s]) is not None
            and r["_status"] == "decoding"
            and s not in self._replay
            and r["id"] not in self._fault_nan_inflight
            and (request_id is None or r["id"] == request_id)
        ]

    def _fault_page_candidates(self, mode: str, request_id) -> list[int]:
        """Pages a corruption can hit. ``nan``: an unshared page of a
        decoding slot (its partly written last page included), which the
        victim's own sentinel reads next. ``bitflip``: a trie page no slot
        maps (the trie's pin only), which only a checksum catches."""
        if mode == "nan":
            return [
                p
                for s in self._fault_decode_slots(request_id)
                for p in self._slot_pages[s]
                if self._alloc.refs.get(p) == 1
            ]
        if self._prefix is None:
            return []
        mapped = {p for pages in self._slot_pages for p in pages}
        cand = []
        stack = list(self._prefix.root.children.values())
        while stack:
            node = stack.pop()
            if node.page not in mapped and self._alloc.refs.get(node.page) == 1:
                cand.append(node.page)
            stack.extend(node.children.values())
        return sorted(cand)

    # -- paged-pool bookkeeping ----------------------------------------------

    def _alloc_pages(self, n: int, req: dict) -> list[int]:
        """Allocate for ``req``, escalating under pool pressure: evict LRU
        trie pages no request reads, then preempt a victim and repeat. Still
        short: raise ``_PoolPressure`` (fatal under "never" or when nobody
        else holds anything reclaimable)."""
        while True:
            if self._prefix is not None and n > self._alloc.free_pages:
                freed = self._prefix.evict_for(n - self._alloc.free_pages)
                self.stats["evictions_for_preempt"] += freed
            if n <= self._alloc.free_pages:
                return self._alloc.alloc(n, owner=req["id"])
            victim = (self._pick_victim(req)
                      if self.scfg.preempt_policy != "never" else None)
            if victim is not None:
                self._preempt(victim)
                continue
            others_hold = any(
                self._slot_pages[s]
                for s in range(self.scfg.batch)
                if (occ := self._occupant(s)) is not None and occ is not req
            )
            reclaim = self._prefix.reclaimable() if self._prefix is not None else 0
            # pages an allocator spike holds come back in a few ticks: park
            # and wait, never fatal
            fatal = not self._spike_holds and (
                self.scfg.preempt_policy == "never"
                or (not others_hold and reclaim == 0))
            raise _PoolPressure(
                fatal,
                f"paged KV pool exhausted: request {req['id']!r} needs {n} "
                f"more page(s) but only {self._alloc.free_pages} of "
                f"{self._alloc.num_pages} are free and no victim is "
                f"eligible (preempt_policy={self.scfg.preempt_policy!r}); "
                f"raise ServeConfig.num_pages (--num-pages) or retire "
                f"requests sooner",
            )

    def _ensure_pages(self, slot: int, last_pos: int, req: dict) -> None:
        """Back position ``last_pos`` of ``slot`` with a page, one page at a
        time (each with the full escalation). Under pressure the pages
        already taken are unwound before ``_PoolPressure`` propagates. A
        no-op on the dense layout."""
        if self._alloc is None:
            return
        need = last_pos // self.scfg.page_size + 1
        have = len(self._slot_pages[slot])
        if need <= have:
            return
        added: list[int] = []
        try:
            for j in range(have, need):
                page = self._alloc_pages(1, req)[0]
                self._tables[slot, j] = page
                self._slot_pages[slot].append(page)
                added.append(page)
                self._tables_dirty = True
        except _PoolPressure:
            for page in reversed(added):
                self._slot_pages[slot].pop()
                self._tables[slot, len(self._slot_pages[slot])] = -1
                self._alloc.release([page])
                self._tables_dirty = True
            raise

    def _release_slot_pages(self, slot: int) -> None:
        if self._corrupted_pages or self._corrupted_rows:
            self._scrub_slot(slot)
        if not self._slot_pages[slot]:
            return
        self._alloc.release(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._tables[slot, :] = -1
        self._tables_dirty = True

    def _tables_device(self) -> torch.Tensor | None:
        """Device mirror of the block tables, uploaded only after a change
        (None on the dense layout). ``-1`` entries go up intact: readers
        stop at cache_len and writers send them to the spare page."""
        if self._alloc is None:
            return None
        if self._tables_dirty:
            self._tables_dev = _upload(self._tables, self.device)
            self._tables_dirty = False
        return self._tables_dev

    def kv_cache_stats(self) -> dict:
        """KV bytes as allocated (each layer's spare page or spare row
        included; on a mesh the whole pool's, a rank holding ``1/n`` of it
        where the KV heads split over ``"model"``); on the paged layout
        pages, the live-page peak and sharing; the prefix cache, pressure,
        the recovery counters (and the injector's, when one is attached)
        and speculation."""
        kv_bytes = sum(
            t.numel() * t.element_size()
            for slot in self.caches.values() for t in slot.get("attn", {}).values()
        ) * (1 if self._kv_heads is None else self._kv_heads.size)
        out = {"layout": "paged" if self.scfg.paged else "dense",
               "kv_bytes": int(kv_bytes)}
        alloc = self._alloc
        if alloc is not None:
            per_page = kv_bytes / (alloc.num_pages + 1)
            out.update({
                "page_size": self.scfg.page_size,
                "num_pages": alloc.num_pages,
                "pages_in_use": alloc.used,
                "peak_used_pages": alloc.peak_used,
                "peak_live_kv_bytes": int(alloc.peak_used * per_page),
                "pool_utilization": round(alloc.peak_used / max(alloc.num_pages, 1), 4),
                "refcounted_pages": len(alloc.refs),
                "shared_pages": alloc.shared_pages,
            })
        if self._prefix is not None:
            st = self._prefix.stats
            lookups = st["hits"] + st["misses"]
            out["prefix_cache"] = {
                "trie_pages": self._prefix.size,
                "hits": st["hits"],
                "misses": st["misses"],
                "hit_rate": round(st["hits"] / lookups, 4) if lookups else 0.0,
                "hit_tokens": st["hit_tokens"],
                "prefill_tokens_skipped": st["prefill_tokens_skipped"],
                "pages_saved_by_sharing": st["pages_shared"],
                "cow_copies": st["cow_copies"],
                "inserted_pages": st["inserted_pages"],
                "evicted_pages": st["evicted_pages"],
            }
        out["pressure"] = {
            k: self.stats[k]
            for k in ("preemptions", "resumes", "cancellations",
                      "pages_freed_by_preempt", "evictions_for_preempt",
                      "peak_queue_depth")
        }
        out["pressure"]["queued"] = len(self.queue)
        out["pressure"]["parked"] = len(self._parked)
        out["recovery"] = {k: self.stats[k] for k in _RECOVERY_KEYS}
        if self.faults is not None:
            out["recovery"]["injected"] = dict(self.faults.counters)
        # speculation (present whether or not it ran): acceptance_rate is the
        # share of drafts kept, tokens_per_dispatch the end-to-end gain
        drafted = self.stats["spec_drafted"]
        dispatches = self.stats["spec_dispatches"]
        accepted = self.stats["spec_accepted"]
        out["speculation"] = {
            "enabled": self.scfg.spec_decode,
            "drafted": drafted,
            "accepted": accepted,
            "rejected": self.stats["spec_rejected"],
            "acceptance_rate": round(accepted / drafted, 4) if drafted else 0.0,
            "mean_accepted_len": round(accepted / dispatches, 4) if dispatches else 0.0,
            "verify_dispatches": dispatches,
            "tokens_per_dispatch": (round(self.stats["spec_emitted"] / dispatches, 4)
                                    if dispatches else 0.0),
        }
        return out

    # -- dispatch ------------------------------------------------------------

    def _dispatch_prefill_chunk(self) -> None:
        """One chunk of the oldest in-flight prefill (no host sync, unless
        pool pressure preempts, checksums are recorded, or speculation
        reads the first token back)."""
        task = self._prefills[0]
        C = self.scfg.prefill_chunk
        prompt, start, slot, req = task["prompt"], task["done"], task["slot"], task["req"]
        L = min(C, len(prompt) - start)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :L] = prompt[start:start + L]
        try:
            self._ensure_pages(slot, start + L - 1, req)
        except _PoolPressure as e:
            self._handle_pressure(slot, e)
            return
        tables = self._tables_device()
        next_tok, bad = self.prefill(
            _upload(chunk, self.device), start, L,
            None if tables is None else tables[slot:slot + 1],
            self.rng_keys[slot:slot + 1], slot)  # (1,), (1,)
        task["done"] = start + L
        self.stats["prefill_chunks"] += 1
        if task["done"] < len(prompt):
            return
        # the prompt's last chunk: next_tok is the first generated token
        if self._prefix is not None:
            # the prompt's full pages enter the trie; with checksum_pages
            # each is fingerprinted now (decode writes land past the prompt)
            pages = self._slot_pages[slot]
            if self.scfg.checksum_pages:
                n_full = len(req["prompt"]) // self.scfg.page_size
                self._prefix.insert(req["prompt"], pages, checksums=[
                    F.page_fingerprint(self.caches, p, self._kv_heads)
                    for p in pages[:n_full]])
            else:
                self._prefix.insert(req["prompt"], pages)
        self._prefills.remove(task)
        self._prefilling[slot] = None
        self.active[slot] = req
        req["_status"] = "decoding"
        self.pos[slot] = len(prompt)
        if req["generated"]:
            # recompute-resume: the same chunk grid rebuilt the prompt's KV;
            # the re-sampled first token is generated[0], already on the
            # host. Discard it and replay the rest of the history
            if self.scfg.spec_decode:
                self._last_tok[slot] = req["generated"][0]
            else:
                self._seeds[slot] = req["generated"][0]
            if len(req["generated"]) > 1:
                self._replay[slot] = list(req["generated"][1:])
        elif self.scfg.spec_decode:
            # speculation reads back every tick anyway: the first token comes
            # to the host now (the TTFT point) and is the next verify's input
            tok, is_bad = torch.cat([next_tok, bad.to(torch.int32)]).cpu().tolist()
            self.stats["readbacks"] += 1
            if is_bad:
                # a poisoned prefill emitted nothing: retry from the empty
                # clean history
                self._fault_nan_inflight.discard(req["id"])
                self._fault_retry(req, poisoned=True)
                return
            req["generated"].append(tok)
            req["t_first_token"] = time.perf_counter()
            self._last_tok[slot] = tok
            eos = self.scfg.eos_id
            if req["max_new"] <= 1 or (eos is not None and tok == eos):
                self._retire(slot, req)
        else:
            req["_pending"] += 1
            self._pending.append((next_tok.reshape(1, 1), bad.reshape(1), [req]))
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

    def _fault_mask(self, decoding: list[dict | None]) -> torch.Tensor:
        """This dispatch's injected poison: the masked slots' logits become
        NaN ahead of the sentinel (all False on every other tick)."""
        if not self._fault_nan_slots:
            return self._fault_mask_zero
        m = np.zeros(self.scfg.batch, bool)
        m[list(self._fault_nan_slots)] = True
        for s in self._fault_nan_slots:
            if decoding[s] is not None:
                self._fault_nan_inflight.add(decoding[s]["id"])
        self._fault_nan_slots.clear()
        return _upload(m, self.device)

    def _hang(self) -> None:
        """An injected dispatch hang (a wedged host thread): burn wall time
        where the watchdog measures it."""
        if self._hang_pending:
            time.sleep(self._hang_pending)
            self._hang_pending = 0.0

    def _watchdog(self, dispatch_s: float) -> None:
        """A dispatch call past ``watchdog_deadline_s``: count the trip and
        retry the hung slot's request (its late tokens are kept). On a mesh
        of ranks the slowest rank's time decides, so every rank decides
        alike."""
        if self.scfg.watchdog_deadline_s is None:
            return
        if self.mesh is not None and self.mesh.distributed and self.mesh.devices.size > 1:
            import torch.distributed as dist

            t = torch.tensor([dispatch_s], dtype=torch.float64, device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            dispatch_s = float(t[0])
        if dispatch_s <= self.scfg.watchdog_deadline_s:
            return
        self.stats["watchdog_trips"] += 1
        self.session.event("recovery")
        victim, self._hang_slot = self._hang_slot, None
        req = self.active[victim] if victim is not None else None
        if req is not None and req["_status"] not in _TERMINAL:
            self._fault_retry(req)

    def _decode(self, decoding: list[dict | None], chunks_at_tick_start: int) -> None:
        active = np.asarray([r is not None for r in decoding])
        fault_mask = self._fault_mask(decoding)
        t0 = time.perf_counter()
        self._hang()
        self.tokens, bad = self.decode(
            self.tokens, _upload(self.pos, self.device),
            _upload(active, self.device), self._tables_device(), self.rng_keys,
            fault_mask)
        dispatch_s = time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        if self.stats["prefill_chunks"] > chunks_at_tick_start:
            self.stats["decode_after_prefill_ticks"] += 1
        self.pos[active] += 1
        # a replaying slot's output is a token already in its history:
        # discard it (None row, no _pending) instead of counting it twice
        reqmap = [None if (r is not None and s in self._replay) else r
                  for s, r in enumerate(decoding)]
        self._pending.append((self.tokens, bad, reqmap))
        for req in reqmap:
            if req is not None:
                req["_pending"] += 1
        self._watchdog(dispatch_s)
        # the popped history token overrides the sampled output as the next
        # input; once the list empties, the next output is new and kept
        for slot in list(self._replay):
            if decoding[slot] is not None:
                hist = self._replay[slot]
                self._seeds[slot] = hist.pop(0)
                if not hist:
                    del self._replay[slot]

    # -- readback ---------------------------------------------------------------

    def _flush(self) -> None:
        """Bring every pending token, and the sentinel beside it, to the
        host in one transfer; retire requests at their budget or at EOS
        (tokens past EOS are dropped). Rows of cancelled requests are
        dropped. A flagged row's token is garbage: it is dropped, with every
        later row of its request in this flush, and the request retries."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        host = torch.cat([t for toks, bad, _ in pending
                          for t in (toks.reshape(-1), bad.reshape(-1).to(torch.int32))]
                         ).cpu().numpy()
        self.stats["readbacks"] += 1
        now = time.perf_counter()
        poisoned: list[dict] = []
        poisoned_ids: set = set()
        i = 0
        for _, _, reqmap in pending:
            n = len(reqmap)
            toks, bad = host[i:i + n], host[i + n:i + 2 * n]
            i += 2 * n
            for row, req in enumerate(reqmap):
                if req is None:
                    continue
                req["_pending"] -= 1
                if bad[row]:
                    # the poison reached the host: targetable again
                    self._fault_nan_inflight.discard(req["id"])
                if req["_cancelled"]:
                    continue
                if bad[row] or req["id"] in poisoned_ids:
                    if req["id"] not in poisoned_ids:
                        poisoned_ids.add(req["id"])
                        poisoned.append(req)
                    continue
                req["generated"].append(int(toks[row]))
                if req["t_first_token"] is None:
                    req["t_first_token"] = now
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
                self._retire(slot, req)
        # a poisoned request cannot be done (its bad rows were not kept)
        for req in poisoned:
            if req["_status"] not in _TERMINAL:
                self._fault_retry(req, poisoned=True)

    def _retire(self, slot: int, req: dict) -> None:
        req["_status"] = "done"
        self.completed.append(req)
        self.active[slot] = None
        self._release_slot_pages(slot)
        self._replay.pop(slot, None)

    # -- speculative decode (draft + batched verify) ---------------------------

    def _plan_drafts(self) -> dict[int, dict]:
        """Each decoding slot's draft window for this tick's verify. Replay
        tokens of a recompute-resume come first (true history, so the verify
        accepts them); the drafter's proposals follow once the whole replay
        queue fits in the window, with a budget that keeps the emitted
        tokens within ``max_new`` (at most n_draft + 1 a dispatch) and the
        deepest write at ``max_len - 1``."""
        K = self.scfg.spec_k
        plans: dict[int, dict] = {}
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            replay = self._replay.get(slot, [])
            drafts = [int(t) for t in replay[:K]]
            n_replay = len(drafts)
            n_draft = 0
            if n_replay == len(replay):
                remaining = req["max_new"] - len(req["generated"])
                budget = min(K - n_replay, max(remaining - 1, 0),
                             max(self.scfg.max_len - 1 - int(self.pos[slot]) - n_replay, 0))
                if budget > 0:
                    drafts += draft_tokens(req["prompt"] + req["generated"], budget,
                                           min_match=self.scfg.spec_min_match)
                    n_draft = len(drafts) - n_replay
            plans[slot] = {"drafts": drafts, "n_replay": n_replay, "n_draft": n_draft}
        return plans

    def _spec_tick(self, chunks_at_tick_start: int) -> None:
        """The speculative replacement of the one-token decode dispatch: plan
        each slot's window, back its deepest write with pages (pressure may
        preempt), score every window in one verify dispatch, read back the
        outputs and accept counts at once, and commit each slot's accepted
        prefix plus the verified token. Rejected positions roll back by not
        advancing ``pos``: their writes are overwritten before any read."""
        plans = self._plan_drafts()
        for slot, plan in plans.items():
            req = self.active[slot]
            if req is None:
                continue  # a pressure round below evicted this slot
            try:
                self._ensure_pages(slot, int(self.pos[slot]) + len(plan["drafts"]), req)
            except _PoolPressure as e:
                self._handle_pressure(slot, e)
        decoding = list(self.active)
        plans = {s: p for s, p in plans.items() if decoding[s] is not None}
        if self._prefills and plans:
            self.stats["overlap_ticks"] += 1
        if not plans:
            return
        B, C = self.scfg.batch, self.scfg.spec_k + 1
        chunk = np.zeros((B, C), np.int32)
        length = np.zeros(B, np.int32)
        for slot, plan in plans.items():
            drafts = plan["drafts"]
            chunk[slot, 0] = self._last_tok[slot]
            chunk[slot, 1:1 + len(drafts)] = drafts
            length[slot] = 1 + len(drafts)
        fault_mask = self._fault_mask(decoding)
        t0 = time.perf_counter()
        self._hang()
        out_dev, acc_dev, bad_dev = self.verify(
            _upload(chunk, self.device), _upload(self.pos, self.device),
            _upload(length, self.device), self._tables_device(), self.rng_keys,
            fault_mask)
        dispatch_s = time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["spec_dispatches"] += 1
        if self.stats["prefill_chunks"] > chunks_at_tick_start:
            self.stats["decode_after_prefill_ticks"] += 1
        host = torch.cat([out_dev.reshape(-1), acc_dev,
                          bad_dev.to(torch.int32)]).cpu().numpy()
        self.stats["readbacks"] += 1
        out, acc, bad = host[:B * C].reshape(B, C), host[B * C:B * C + B], host[B * C + B:]
        poisoned: list[dict] = []
        eos = self.scfg.eos_id
        for slot, plan in plans.items():
            req = decoding[slot]
            if bad[slot]:
                # a poisoned verify commits nothing for the slot (pos and
                # replay untouched): the whole window recomputes on retry
                self._fault_nan_inflight.discard(req["id"])
                if not req["_cancelled"]:
                    poisoned.append(req)
                continue
            n_acc = int(acc[slot])
            emitted = [int(t) for t in out[slot, :n_acc + 1]]
            self.pos[slot] += n_acc + 1
            self._last_tok[slot] = emitted[-1]
            acc_draft = max(0, n_acc - plan["n_replay"])
            self.stats["spec_drafted"] += plan["n_draft"]
            self.stats["spec_accepted"] += acc_draft
            self.stats["spec_rejected"] += plan["n_draft"] - acc_draft
            # replay outputs are tokens already in the history: pop them
            new_toks = emitted
            if slot in self._replay:
                hist = self._replay[slot]
                n_hist = min(len(hist), len(emitted))
                del hist[:n_hist]
                if not hist:
                    del self._replay[slot]
                new_toks = emitted[n_hist:]
            if req["_cancelled"]:
                continue
            gen = req["generated"]
            gen.extend(new_toks)
            self.stats["spec_emitted"] += len(new_toks)
            done = len(gen) >= req["max_new"]
            if eos is not None and eos in gen:
                del gen[gen.index(eos) + 1:]  # EOS inside the accepted window
                done = True
            if done:
                self._retire(slot, req)
        self._watchdog(dispatch_s)
        for req in poisoned:
            if req["_status"] not in _TERMINAL:
                self._fault_retry(req, poisoned=True)

    # -- the tick -------------------------------------------------------------

    def step(self) -> int:
        """One tick: attach, decode dispatch for every decoding slot (or,
        with speculation, the batched verify), then at most one prefill
        chunk. Returns the number of busy slots."""
        self.stats["ticks"] += 1
        self._attach()
        if self.faults is not None or self._spike_holds:
            self._apply_faults()
        chunks_at_tick_start = self.stats["prefill_chunks"]
        if not self.scfg.overlap:
            while self._prefills:
                self._dispatch_prefill_chunk()
        self._apply_seeds()
        if self.scfg.spec_decode:
            # drafts and one batched verify take the place of the one-token
            # decode dispatch (pages are backed inside, per window)
            self._spec_tick(chunks_at_tick_start)
        else:
            # this step writes each decoding slot's K/V at pos[slot]: back
            # any page boundary being crossed before snapshotting the active
            # set. Pressure here may preempt a victim or park this slot's
            # request
            for slot in range(self.scfg.batch):
                req = self.active[slot]
                if req is not None:
                    try:
                        self._ensure_pages(slot, int(self.pos[slot]), req)
                    except _PoolPressure as e:
                        self._handle_pressure(slot, e)
            decoding = list(self.active)
            if any(r is not None for r in decoding):
                if self._prefills:
                    self.stats["overlap_ticks"] += 1
                self._decode(decoding, chunks_at_tick_start)
        if self.scfg.overlap and self._prefills:
            self._dispatch_prefill_chunk()
        flush_due = any(
            req is not None and len(req["generated"]) + req["_pending"] >= req["max_new"]
            for req in self.active
        )
        if (self.scfg.eos_id is not None and self._pending
                and self.stats["ticks"] % self.scfg.eos_check_every == 0):
            flush_due = True
        if flush_due:
            self._flush()
        return sum(1 for slot in range(self.scfg.batch) if not self._free(slot))

    def drain(self) -> None:
        """Step until every queued, parked, prefilling and decoding request
        is done, then flush. Raises, with the stats, if that takes more
        ticks than the work can need."""
        live = (self.queue + self._parked
                + [r for r in self.active if r is not None]
                + [t["req"] for t in self._prefills])
        # prefill chunks + decode budget per request, with headroom for
        # preemption and replay rounds (bounded: the oldest highest-priority
        # request always makes progress), every request's retries with
        # their backoff, and the injector's spikes
        rounds = len(live) + 2 + self.scfg.max_retries
        budget = 64 + rounds * sum(
            r["max_new"] + len(r["prompt"]) // self.scfg.prefill_chunk
            + len(r["prompt"]) + 1
            for r in live
        )
        budget += len(live) * self.scfg.max_retries * (self.scfg.retry_backoff_cap + 1)
        if self.faults is not None:
            budget += 64 + self.faults.fcfg.spike_ticks * (self.faults.fcfg.n_alloc_spike + 1)
        ticks = 0
        while (self.queue or self._parked or self._prefills
               or any(r is not None for r in self.active)):
            self.step()
            ticks += 1
            if ticks > budget:
                raise RuntimeError(
                    f"drain() reached no quiescence after {ticks} ticks: "
                    f"queued={len(self.queue)} parked={len(self._parked)} "
                    f"active={sum(r is not None for r in self.active)} "
                    f"prefilling={len(self._prefills)} "
                    f"[kv_cache_stats: {self.kv_cache_stats()}]"
                )
        self._flush()
        if self._spike_holds:
            # the work ended while a spike still held pages: give them back,
            # so a chaos run ends with no page in use like any other
            for _, pages in self._spike_holds:
                self._alloc.release(pages)
            self._spike_holds = []


# ---------------------------------------------------------------------------
# the one-shot serving steps (JAX ``make_prefill_step``, ``make_decode_step``,
# ``make_encoder_step``) and the caches' placement on a mesh
# ---------------------------------------------------------------------------


def serve_cache_pspecs(cfg, mesh, batch: int, max_len: int, *, paged: bool = False,
                       page_size: int = 16, num_pages: int | None = None) -> dict:
    """``cache_pspec_tree`` of the caches ``init_cache`` would build (dense by
    default, as in JAX), read off meta tensors: nothing is allocated."""
    from repro_torch.models.transformer import init_cache

    caches = init_cache(cfg, batch, max_len, paged=paged, page_size=page_size,
                        num_pages=num_pages, device="meta")
    return cache_pspec_tree(cfg, mesh, caches)


def serve_constraints(model, mesh, batch: int, mode: str, width: int = 1):
    """How a rank runs a serving step of ``batch`` rows (``mode`` prefill,
    decode, encoder, or chunk: the scheduler's prefill chunk and verify,
    ``width`` tokens a row against the cache) on ``mesh``: a
    ``LogicalConstraints`` with its rows
    (``ranks``: the rows the caches' batch placement gives it,
    ``divisible_batch_axes``, so that a rank's rows and its cache blocks'
    rows agree), its cache blocks (``kv``: ``CacheSplit``) and, where the
    ``"model"`` axis is above 1, the split of the compute over it: on a
    megatron mesh ``TensorParallel`` (prefill and encoder: the sequence-
    parallel residual, JAX's activation rules) or ``RowParallel`` (decode:
    one token, the residual whole; a chunk ``TensorParallel`` where its
    width divides the axis, else ``RowParallel``); on an fsdp mesh
    ``ContextParallel`` for a prefill or an encoder step (each rank's part
    of the sequence; the rows do not split over ``"model"``, since the
    caches hold every row's KV heads or sequence block there) and, for a
    decode step or a chunk (attention over a cache is not context-
    parallel), the rows with attention alone split: over the rank's KV
    heads (``attn_tp``, a ``RowParallel`` over whole leaves) or its
    sequence block (a paged pool is then whole on every rank). A mesh
    without a process group (the production mesh, a 1 x 1 mesh) computes
    the whole step on one rank: ``NULL_CONSTRAINTS``."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.shard import (
        BatchRanks,
        CacheSplit,
        ContextParallel,
        RowParallel,
        TensorParallel,
    )
    from repro_torch.layers.common import LogicalConstraints

    if mesh is None or not mesh.distributed:
        return NULL_CONSTRAINTS
    cfg = model.cfg
    ax = SH.divisible_batch_axes(mesh, batch)
    ranks = BatchRanks(mesh, () if ax is None else ((ax,) if isinstance(ax, str) else ax))
    kv = CacheSplit.of(cfg, mesh)
    tp = cp = attn_tp = None
    one_shot = mode in ("prefill", "encoder")
    if kv is not None:
        if SH.effective_strategy(cfg, mesh) == "megatron":
            seq = one_shot or (mode == "chunk" and width % kv.size == 0)
            tp = TensorParallel(mesh) if seq else RowParallel(mesh)
        elif one_shot:
            cp = ContextParallel(mesh)
        elif kv.heads:
            attn_tp = RowParallel(mesh)
    return LogicalConstraints(mesh, SH.activation_rules(cfg, mesh), ranks, tp, cp, kv,
                              attn_tp)


def _step_constraints(model, mesh, mode: str):
    """``serve_constraints`` for ``mode``, built once per batch size (as
    JAX's ``make_*_step`` builds its constraints once)."""
    return functools.lru_cache(maxsize=None)(
        lambda batch: serve_constraints(model, mesh, batch, mode))


def _rows(lc, n: int) -> slice:
    return slice(0, n) if lc.ranks is None else lc.ranks.rows(n)


def _all_rows(x: torch.Tensor, lc) -> torch.Tensor:
    """Every rank's rows of ``x`` (a step's tokens or sentinels), on every
    rank; ``x`` itself where the rows do not split."""
    if lc.ranks is None or lc.ranks.group is None:
        return x
    if x.dtype == torch.bool:
        return rows_gather(x.to(torch.int32), lc.ranks).bool()
    return rows_gather(x, lc.ranks)


def _tokens_out(logits, lc):
    """The argmax over the whole vocabulary, int32, every rank holding the
    global batch's."""
    from repro_torch.distributed.shard import rows_gather, vocab_argmax

    tok = vocab_argmax(logits, lc.tp).to(torch.int32)
    return tok if lc.ranks is None else rows_gather(tok, lc.ranks)


def make_prefill_step(model, mesh=None):
    """``prefill_step(batch, caches) -> (next_tok (B,) int32, caches)``: the
    one-shot prefill (``Transformer.prefill``) and the argmax of its last
    logits (JAX ``make_prefill_step``; the model holds the weights).
    ``batch`` is the global batch; on a mesh of ranks each rank runs its
    share (``serve_constraints``) into its cache blocks (``init_cache`` on
    the model's mesh), takes the argmax across the vocabulary's ranks, and
    returns every row's token. The caches are written in place and
    returned."""
    model._no_cache("prefill")
    constraints = _step_constraints(model, mesh, "prefill")

    def prefill_step(batch: dict, caches: dict):
        B = next(iter(batch.values())).shape[0]
        lc = constraints(B)
        rows = _rows(lc, B)
        logits = model.prefill({k: v[rows] for k, v in batch.items()}, caches, lc)
        return _tokens_out(logits, lc), caches

    return prefill_step


def make_decode_step(model, mesh=None):
    """``decode_step(tokens (B,1), pos () or (B,), caches) -> (next (B,1)
    int32, caches)`` over the dense cache (JAX ``make_decode_step``); on a
    mesh of ranks as ``make_prefill_step``, the residual whole on every
    rank (``RowParallel``)."""
    model._no_cache("decode_step")
    constraints = _step_constraints(model, mesh, "decode")

    def decode_step(tokens, pos, caches: dict):
        B = tokens.shape[0]
        lc = constraints(B)
        rows = _rows(lc, B)
        p = torch.as_tensor(pos)
        if p.dim() and p.numel() == B:
            p = p.reshape(B)[rows]
        logits = model.decode_step(tokens[rows], p, caches, lc=lc)
        return _tokens_out(logits, lc)[:, None], caches

    return decode_step


def make_encoder_step(model, mesh=None):
    """``encoder_step(batch) -> tokens (B,S) int32``: the argmax of
    ``apply_logits`` at every position (JAX ``make_encoder_step``: an
    encoder-only arch's "prefill"). On a mesh of ranks each rank runs its
    rows and its part of the sequence (``serve_constraints``)."""
    constraints = _step_constraints(model, mesh, "encoder")

    @torch.inference_mode()
    def encoder_step(batch: dict):
        B = next(iter(batch.values())).shape[0]
        lc = constraints(B)
        rows = _rows(lc, B)
        logits, _ = model.apply_logits({k: v[rows] for k, v in batch.items()}, lc)
        return _tokens_out(logits, lc)

    return encoder_step

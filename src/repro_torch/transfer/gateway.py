"""In-process gateway data plane moving REAL bytes (paper §3.3/§6).

The fluid simulator (flowsim) models timing; this module implements the
actual mechanics on real data — chunking, bounded relay queues (hop-by-hop
flow control), parallel workers per hop, dynamic chunk dispatch, per-chunk
checksum verification at the destination — and is what checkpoint
replication (repro_torch.ckpt.replicate) runs on. Object stores are pluggable
(in-memory dict or a directory), mirroring S3/Blob/GCS semantics: immutable
puts, no rename.

Fault tolerance: every chunk carries a source-side checksum, the
destination verifies and commits chunks independently, and failed chunks —
a killed hop worker, a corrupted payload, a chunk stranded in a dead
path's queues — are re-dispatched to surviving workers. Verified bytes are
never re-sent (chunk-level checksummed resume), duplicate deliveries are
discarded, and a ``FaultInjector`` scripts the same failure scenarios the
fluid simulator runs (events.VMFailure / LinkDegrade analogues) against
the real-bytes path.

Multicast: ``transfer_objects_multicast`` executes a
``MulticastPlan``'s distribution trees — relay workers fan each chunk out
to multiple downstream chains (shared segments carry it once), every
destination verifies independently, and a chunk lost on one branch is
re-dispatched only toward the destinations still missing it. For
multicast stages the FaultInjector key is (tree id, global stage id)
instead of (path id, hop).
"""

from __future__ import annotations

import dataclasses
import heapq
import queue
import random
import threading
import time
from pathlib import Path

from repro_torch.core.plan import MulticastPlan, TransferPlan
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import get_tracer

from .chunk import Chunk, checksum, chunk_manifest, chunk_object
from .reports import Report, per_edge_dict

# registered gateway counters — leaked workers used to be a RuntimeWarning;
# a counter survives in long-lived processes where warnings are one-shot
_workers_leaked = REGISTRY.counter("gateway.workers_leaked")
_retries = REGISTRY.counter("gateway.retries")
_checksum_failures = REGISTRY.counter("gateway.checksum_failures")
_stall_rounds = REGISTRY.counter("gateway.stall_rounds")


def _retry_delay(attempt: int, base_s: float, cap_s: float,
                 rng: random.Random) -> float:
    """Exponential backoff with seeded jitter for chunk re-dispatch.

    ``base_s * 2**(attempt-1)`` capped at ``cap_s``, scaled by a uniform
    jitter in [0.5, 1.5) so simultaneous failures (a killed worker drops
    its whole queue) do not re-dispatch as one synchronized thundering
    herd onto the next path. Deterministic given the rng's seed; attempt
    0 (first dispatch) never waits."""
    if attempt <= 0 or base_s <= 0.0:
        return 0.0
    delay = min(base_s * (2.0 ** (attempt - 1)), cap_s)
    return delay * (0.5 + rng.random())


class ObjectStore:
    """Interface of an object store (S3/Blob/GCS-like semantics)."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def keys(self) -> list[str]:
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError


class BlobStore(ObjectStore):
    """In-memory object store."""

    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(data)

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._data[key]

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        with self._lock:
            return self._data[key][offset : offset + length]

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._data)

    def size(self, key: str) -> int:
        with self._lock:
            return len(self._data[key])


class DirStore(ObjectStore):
    """Directory-backed store (used by the checkpoint replicator).

    The directory is authoritative: every read is served from disk and no
    in-memory copy of object payloads is kept, so replicating a large
    checkpoint costs one resident copy, not two."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.root / key.replace("/", "__")

    def put(self, key: str, data: bytes) -> None:
        p = self._path(key)
        tmp = p.with_name(p.name + ".tmp")
        tmp.write_bytes(data)
        tmp.rename(p)  # atomic within the fs

    def get(self, key: str) -> bytes:
        return self._path(key).read_bytes()

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        with open(self._path(key), "rb") as f:
            f.seek(offset)
            return f.read(length)

    def exists(self, key: str) -> bool:
        return self._path(key).exists()

    def keys(self) -> list[str]:
        return sorted(p.name.replace("__", "/") for p in self.root.iterdir()
                      if not p.name.endswith(".tmp"))

    def size(self, key: str) -> int:
        return self._path(key).stat().st_size


class FaultInjector:
    """Scripted faults for the real-bytes path.

    * ``kill_worker_after={(path_id, hop): n}`` — one worker on that hop
      dies when it picks up its (n+1)-th chunk; the chunk it carried is
      lost and re-dispatched (the gateway-kill scenario of
      ``events.VMFailure``). With ``workers_per_hop >= 2`` the hop
      survives on its remaining workers.
    * ``corrupt_chunks={chunk_id, ...}`` — the payload is corrupted once in
      flight; the destination's per-chunk checksum catches it and the
      chunk retries (a flaky link, ``events.LinkDegrade``'s ugly cousin).

    ``faults_injected`` counts every fault actually fired.
    """

    def __init__(self, *, kill_worker_after=None, corrupt_chunks=None):
        self.kill_worker_after: dict[tuple[int, int], int] = dict(
            kill_worker_after or {}
        )
        self.corrupt_chunks: set[str] = set(corrupt_chunks or ())
        self.faults_injected = 0
        self._lock = threading.Lock()
        self._pickups: dict[tuple[int, int], int] = {}
        self._killed: set[tuple[int, int]] = set()

    def on_pickup(self, path_id: int, hop: int, ch: Chunk, data: bytes,
                  attempt: int) -> tuple[str, bytes | None]:
        """Called by a hop worker for every chunk it picks up.

        Returns ("ok", data), ("kill", None) — the worker must requeue the
        chunk and die — or ("corrupt", mangled_payload)."""
        with self._lock:
            key = (path_id, hop)
            if key in self.kill_worker_after and key not in self._killed:
                n = self._pickups.get(key, 0)
                self._pickups[key] = n + 1
                if n >= self.kill_worker_after[key]:
                    self._killed.add(key)
                    self.faults_injected += 1
                    return "kill", None
            if data is not None and ch.id in self.corrupt_chunks:
                self.corrupt_chunks.discard(ch.id)
                self.faults_injected += 1
                return "corrupt", bytes([data[0] ^ 0xFF]) + data[1:]
        return "ok", data


@dataclasses.dataclass
class GatewayReport(Report):
    objects: int
    chunks: int
    bytes_moved: int
    checksum_failures: int  # objects whose final assembly failed to verify
    per_path_chunks: dict
    retried_chunks: int = 0  # chunk re-dispatches (kills, corruption, stalls)
    duplicate_chunks: int = 0  # deliveries discarded as already-verified
    faults_injected: int = 0
    objects_skipped: int = 0  # already present + verified at the destination
    chunks_missing: int = 0  # gave up after max_attempts (0 == zero loss)
    workers_leaked: int = 0  # threads still alive after the shutdown join
    # passive telemetry for the calibration plane: per region-pair edge,
    # bytes that crossed the hop and the wall-clock window they crossed in
    per_edge_bytes: dict | None = None  # (a, b) -> bytes
    per_edge_seconds: dict | None = None  # (a, b) -> active seconds

    def link_gbps(self) -> dict:
        """Observed per-edge delivered rate (Gbit/s) — the gateway-side
        feed for ``calibrate.BeliefGrid`` passive updates."""
        out = {}
        for e, nbytes in (self.per_edge_bytes or {}).items():
            secs = (self.per_edge_seconds or {}).get(e, 0.0)
            if secs > 1e-9:
                out[e] = nbytes * 8.0 / 1e9 / secs
        return out

    kind = "gateway"
    _summary_keys = ("objects", "chunks", "delivered_gb", "retried_chunks",
                     "chunks_missing")
    _metrics_prefixes = ("gateway.",)

    def _payload(self) -> dict:
        return {
            "objects": self.objects,
            "chunks": self.chunks,
            "delivered_gb": self.bytes_moved / 1e9,
            "checksum_failures": self.checksum_failures,
            "retried_chunks": self.retried_chunks,
            "duplicate_chunks": self.duplicate_chunks,
            "chunks_missing": self.chunks_missing,
            "objects_skipped": self.objects_skipped,
            "faults_injected": self.faults_injected,
            "workers_leaked": self.workers_leaked,
            "per_edge": per_edge_dict(self.per_edge_bytes,
                                      self.per_edge_seconds),
        }


def _same_object(src_store: ObjectStore, dst_store: ObjectStore, key: str,
                 window: int) -> bool:
    """Streamed equality check for the resume pre-pass: size short-circuit,
    then windowed get_range comparison — no whole-object materialization,
    early exit on the first differing window."""
    size = src_store.size(key)
    if dst_store.size(key) != size:
        return False
    off = 0
    while off < size:
        n = min(window, size - off)
        if src_store.get_range(key, off, n) != dst_store.get_range(key, off, n):
            return False
        off += n
    return True


def transfer_objects(
    plan: TransferPlan,
    src_store: ObjectStore,
    dst_store: ObjectStore,
    object_keys: list[str],
    *,
    chunk_bytes: int = 4 << 20,
    workers_per_hop: int = 4,
    relay_buffer_chunks: int = 32,
    verify: bool = True,
    fault_injector: FaultInjector | None = None,
    max_attempts: int = 5,
    stall_timeout_s: float = 1.0,
    resume: bool = True,
    retry_backoff_s: float = 0.01,
    retry_backoff_cap_s: float = 0.25,
    seed: int = 0,
) -> GatewayReport:
    """Move objects src->dst along the plan's decomposed paths.

    Every path becomes a chain of bounded queues with ``workers_per_hop``
    threads per hop — a faithful miniature of the gateway chain: bounded
    queues ARE the hop-by-hop flow control; idle workers pulling from the
    shared source queue ARE dynamic dispatch. The destination verifies and
    commits chunks independently; anything lost in flight is re-dispatched
    to a surviving path (``max_attempts`` per chunk), so a mid-transfer
    gateway kill completes with zero data loss and no verified byte is
    ever sent twice. ``resume=True`` additionally skips whole objects the
    destination already holds with a matching checksum.

    A ``MulticastPlan`` delegates to ``transfer_objects_multicast`` —
    ``dst_store`` must then be a dict mapping destination region keys to
    stores.
    """
    if isinstance(plan, MulticastPlan):
        return transfer_objects_multicast(
            plan, src_store, dst_store, object_keys,
            chunk_bytes=chunk_bytes, workers_per_hop=workers_per_hop,
            relay_buffer_chunks=relay_buffer_chunks, verify=verify,
            fault_injector=fault_injector, max_attempts=max_attempts,
            stall_timeout_s=stall_timeout_s, resume=resume,
            retry_backoff_s=retry_backoff_s,
            retry_backoff_cap_s=retry_backoff_cap_s, seed=seed,
        )
    paths = plan.paths()
    if not paths:
        raise ValueError("plan has no flow")
    tr = get_tracer()
    w0 = tr.now_wall() if tr.enabled else 0.0

    skipped = 0
    keys_to_move = []
    for key in object_keys:
        if (
            resume and verify and dst_store.exists(key)
            and _same_object(src_store, dst_store, key, chunk_bytes)
        ):
            skipped += 1
            continue
        keys_to_move.append(key)

    all_chunks, chunk_sums, object_sums = chunk_manifest(
        src_store, keys_to_move, chunk_bytes, with_sums=verify
    )
    # zero-byte objects produce no chunks: commit them directly so they are
    # not silently dropped by the chunk-delivery loop
    chunked = {ch.object_key for ch in all_chunks}
    for key in keys_to_move:
        if key not in chunked:
            dst_store.put(key, b"")
    keys_to_move = [k for k in keys_to_move if k in chunked]

    # weighted round-robin pre-binning of chunks to paths
    weights = [f for _, f in paths]
    total_w = sum(weights)
    bins: list[list[Chunk]] = [[] for _ in paths]
    cum = [w / total_w for w in weights]
    acc = [0.0] * len(paths)
    for ch in all_chunks:
        i = max(range(len(paths)), key=lambda j: cum[j] - acc[j])
        bins[i].append(ch)
        acc[i] += 1.0 / max(len(all_chunks), 1)
    per_path_count = {i: len(b) for i, b in enumerate(bins)}

    done_event = threading.Event()
    done_q: "queue.Queue" = queue.Queue()
    retry_q: "queue.Queue" = queue.Queue()
    lock = threading.Lock()
    bytes_moved = [0]
    retried = [0]
    live = {(pid, h): workers_per_hop
            for pid, (path, _) in enumerate(paths)
            for h in range(len(path) - 1)}
    # per region-pair telemetry: bytes across the hop + first/last activity
    edge_of_hop = {(pid, h): (path[h], path[h + 1])
                   for pid, (path, _) in enumerate(paths)
                   for h in range(len(path) - 1)}
    edge_bytes: dict[tuple[int, int], int] = {}
    edge_t0: dict[tuple[int, int], float] = {}
    edge_t1: dict[tuple[int, int], float] = {}

    def _put(q: queue.Queue, item) -> None:
        while not done_event.is_set():
            try:
                q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    first_qs: list[queue.Queue] = []
    threads: list[threading.Thread] = []
    for pid, (path, _flow) in enumerate(paths):
        hops = len(path) - 1
        qs: list[queue.Queue] = [queue.Queue()]
        for _ in range(hops - 1):
            qs.append(queue.Queue(maxsize=relay_buffer_chunks))  # flow ctrl
        qs.append(done_q)
        first_qs.append(qs[0])
        for ch in bins[pid]:
            qs[0].put((ch, 0))

        def hop_worker(pid: int, h: int, q_in: queue.Queue,
                       q_out: queue.Queue, first: bool):
            while not done_event.is_set():
                try:
                    item = q_in.get(timeout=0.05)
                except queue.Empty:
                    continue
                t0w = tr.now_wall() if tr.enabled else 0.0
                # the telemetry window opens when the FIRST transfer on the
                # edge begins — stamping at first completion would shave one
                # chunk's time off the window and overstate the link rate
                with lock:
                    edge_t0.setdefault(edge_of_hop[(pid, h)],
                                       time.monotonic())
                if first:
                    ch, attempt = item
                    data = src_store.get_range(ch.object_key, ch.offset,
                                               ch.length)
                else:
                    ch, data, attempt = item
                if fault_injector is not None:
                    action, data = fault_injector.on_pickup(
                        pid, h, ch, data, attempt
                    )
                    if action == "kill":
                        with lock:
                            live[(pid, h)] -= 1
                        retry_q.put((ch, attempt + 1))
                        if tr.enabled:
                            tr.instant("gateway.worker_killed",
                                       tr.now_wall(), track="gateway",
                                       path=pid, hop=h)
                        return  # the worker thread dies with its chunk
                with lock:
                    bytes_moved[0] += len(data)
                    e = edge_of_hop[(pid, h)]
                    edge_bytes[e] = edge_bytes.get(e, 0) + len(data)
                    edge_t1[e] = time.monotonic()
                _put(q_out, (ch, data, attempt))
                if tr.enabled:
                    tr.span("gateway.hop", t0w, tr.now_wall() - t0w,
                            track="gateway", path=pid, hop=h, chunk=ch.id)

        for h in range(hops):
            for _ in range(workers_per_hop):
                t = threading.Thread(
                    target=hop_worker, args=(pid, h, qs[h], qs[h + 1], h == 0),
                    daemon=True,
                )
                threads.append(t)
                t.start()

    # retry feeder: re-dispatch lost chunks onto any path whose every hop
    # still has a live worker (dynamic dispatch across surviving gateways)
    attempts: dict[str, int] = {}
    dead: set[str] = set()
    verified: set[str] = set()
    rr = [0]

    def alive_paths() -> list[int]:
        with lock:
            return [
                pid for pid, (path, _) in enumerate(paths)
                if all(live[(pid, h)] > 0 for h in range(len(path) - 1))
            ]

    def dispatch(ch: Chunk, attempt: int) -> None:
        if ch.id in verified:
            return  # a duplicate copy already landed: nothing to do
        if attempt > max_attempts:
            dead.add(ch.id)
            return
        targets = alive_paths()
        if not targets:
            dead.add(ch.id)
            return
        with lock:
            retried[0] += 1
        _retries.inc()
        pid = targets[rr[0] % len(targets)]
        rr[0] += 1
        attempts[ch.id] = max(attempts.get(ch.id, 0), attempt)
        if tr.enabled:
            tr.instant("gateway.retry", tr.now_wall(), track="gateway",
                       chunk=ch.id, attempt=attempt, path=pid)
        first_qs[pid].put((ch, attempt))

    def feeder():
        # exponential backoff with seeded jitter: re-dispatches wait on a
        # due-time heap instead of sleeping inline, so one backed-off chunk
        # never delays another's (shorter) retry
        rng = random.Random(seed)
        pending: list = []  # (due monotonic time, tiebreak, chunk, attempt)
        tick = 0
        while not done_event.is_set():
            timeout = 0.05
            if pending:
                timeout = max(min(timeout, pending[0][0] - time.monotonic()),
                              0.0)
            try:
                ch, attempt = retry_q.get(timeout=timeout)
                delay = _retry_delay(attempt, retry_backoff_s,
                                     retry_backoff_cap_s, rng)
                tick += 1
                heapq.heappush(
                    pending, (time.monotonic() + delay, tick, ch, attempt)
                )
            except queue.Empty:
                pass
            while pending and pending[0][0] <= time.monotonic():
                _, _, ch, attempt = heapq.heappop(pending)
                dispatch(ch, attempt)

    feeder_t = threading.Thread(target=feeder, daemon=True)
    feeder_t.start()

    # destination: verify + commit chunks independently, reassemble objects
    buffers: dict[str, dict[int, bytes]] = {k: {} for k in keys_to_move}
    expect = {
        k: len(chunk_object(k, src_store.size(k), chunk_bytes))
        for k in keys_to_move
    }
    duplicates = 0
    failures = 0
    stall_rounds = 0
    # adaptive stall detection: a pipeline is only declared stuck once the
    # quiet period exceeds both the configured window and twice the worst
    # inter-delivery gap seen so far, so a slow-but-healthy transfer (cold
    # disk, big chunks) is not flooded with wholesale re-dispatches
    max_gap = stall_timeout_s
    last_delivery = time.monotonic()
    while len(verified) + len(dead - verified) < len(all_chunks):
        try:
            ch, data, attempt = done_q.get(timeout=stall_timeout_s)
        except queue.Empty:
            quiet = time.monotonic() - last_delivery
            if quiet < max(stall_timeout_s, 2.0 * max_gap):
                continue  # plausibly just slow: keep waiting
            # Stuck: every in-flight copy died or sits behind a dead hop.
            # Re-dispatch the missing chunks — the checksummed-resume path:
            # verified chunks are never re-sent. Stall re-sends are bounded
            # by their own round counter (reset on progress), NOT by
            # per-chunk attempts, so timeouts alone never fail a transfer.
            stall_rounds += 1
            _stall_rounds.inc()
            missing = [c for c in all_chunks
                       if c.id not in verified and c.id not in dead]
            if not missing or stall_rounds > max_attempts:
                break
            if tr.enabled:
                tr.instant("gateway.stall", tr.now_wall(), track="gateway",
                           missing=len(missing), round=stall_rounds)
            for c in missing:
                retry_q.put((c, attempts.get(c.id, 0)))
            last_delivery = time.monotonic()  # re-arm for the next round
            continue
        now_t = time.monotonic()
        max_gap = max(max_gap, now_t - last_delivery)
        last_delivery = now_t
        stall_rounds = 0
        if ch.id in verified:
            duplicates += 1
            continue
        if verify and checksum(data) != chunk_sums[ch.id]:
            _checksum_failures.inc()
            if tr.enabled:
                tr.instant("gateway.checksum_fail", tr.now_wall(),
                           track="gateway", chunk=ch.id, attempt=attempt)
            retry_q.put((ch, attempt + 1))
            continue
        verified.add(ch.id)
        dead.discard(ch.id)
        buffers[ch.object_key][ch.index] = data
        if len(buffers[ch.object_key]) == expect[ch.object_key]:
            parts = buffers[ch.object_key]
            blob = b"".join(parts[i] for i in range(len(parts)))
            if verify and checksum(blob) != object_sums[ch.object_key]:
                failures += 1
            dst_store.put(ch.object_key, blob)
            if tr.enabled:
                tr.instant("gateway.commit", tr.now_wall(),
                           track="gateway", key=ch.object_key)

    done_event.set()
    feeder_t.join(timeout=2.0)
    for t in threads:
        t.join(timeout=2.0)
    # a worker blocked inside a store call (hung disk/network read) survives
    # the bounded join: it is a real leak until its syscall returns. Count
    # and surface it — silent thread leaks poison long-lived processes.
    leaked = sum(1 for t in threads if t.is_alive()) + (
        1 if feeder_t.is_alive() else 0
    )
    if leaked:
        _workers_leaked.inc(leaked)
        if tr.enabled:
            tr.instant("gateway.workers_leaked", tr.now_wall(),
                       track="gateway", leaked=leaked)

    missing = len(all_chunks) - len(verified)
    if tr.enabled:
        tr.span("gateway.transfer", w0, tr.now_wall() - w0,
                track="gateway", chunks=len(all_chunks),
                retried=retried[0], leaked=leaked)
    return GatewayReport(
        objects=len(object_keys),
        chunks=len(all_chunks),
        bytes_moved=bytes_moved[0],
        checksum_failures=failures,
        per_path_chunks=per_path_count,
        retried_chunks=retried[0],
        duplicate_chunks=duplicates,
        faults_injected=0 if fault_injector is None
        else fault_injector.faults_injected,
        objects_skipped=skipped,
        chunks_missing=missing,
        workers_leaked=leaked,
        per_edge_bytes=dict(edge_bytes),
        per_edge_seconds={
            e: max(edge_t1[e] - edge_t0[e], 1e-9) for e in edge_bytes
        },
    )


# ------------------------------------------------------------------ multicast
@dataclasses.dataclass
class MulticastGatewayReport(Report):
    """Aggregate + per-destination outcome of a one-to-many transfer."""

    per_dest: dict  # destination region key -> GatewayReport
    chunks: int  # distinct source chunks
    bytes_moved: int  # bytes that crossed ANY hop (envelope accounting)
    retried_chunks: int
    faults_injected: int
    per_tree_chunks: dict  # tree id -> chunks initially binned to it
    workers_leaked: int = 0  # threads still alive after the shutdown join
    # passive telemetry, same shape as the unicast report: per tree-edge
    # region pair, envelope bytes that crossed it (each chunk once, however
    # many destinations it serves downstream) and the active window
    per_edge_bytes: dict | None = None  # (a, b) -> bytes
    per_edge_seconds: dict | None = None  # (a, b) -> active seconds

    def link_gbps(self) -> dict:
        """Observed per-edge delivered rate (Gbit/s) — the fan-out path's
        feed for ``calibrate.BeliefGrid.observe_link_rates``, mirroring
        ``GatewayReport.link_gbps``."""
        out = {}
        for e, nbytes in (self.per_edge_bytes or {}).items():
            secs = (self.per_edge_seconds or {}).get(e, 0.0)
            if secs > 1e-9:
                out[e] = nbytes * 8.0 / 1e9 / secs
        return out

    @property
    def checksum_failures(self) -> int:
        return sum(r.checksum_failures for r in self.per_dest.values())

    @property
    def chunks_missing(self) -> int:
        return sum(r.chunks_missing for r in self.per_dest.values())

    @property
    def duplicate_chunks(self) -> int:
        return sum(r.duplicate_chunks for r in self.per_dest.values())

    kind = "multicast_gateway"
    _summary_keys = ("chunks", "delivered_gb", "retried_chunks",
                     "chunks_missing")
    _metrics_prefixes = ("gateway.",)

    def _payload(self) -> dict:
        return {
            "chunks": self.chunks,
            "delivered_gb": self.bytes_moved / 1e9,
            "checksum_failures": self.checksum_failures,
            "retried_chunks": self.retried_chunks,
            "duplicate_chunks": self.duplicate_chunks,
            "chunks_missing": self.chunks_missing,
            "faults_injected": self.faults_injected,
            "workers_leaked": self.workers_leaked,
            "per_dst": {
                dst: rep.to_dict() for dst, rep in self.per_dest.items()
            },
            "per_edge": per_edge_dict(self.per_edge_bytes,
                                      self.per_edge_seconds),
        }


def transfer_objects_multicast(
    plan: MulticastPlan,
    src_store: ObjectStore,
    dst_stores: dict,
    object_keys: list[str],
    *,
    chunk_bytes: int = 4 << 20,
    workers_per_hop: int = 4,
    relay_buffer_chunks: int = 32,
    verify: bool = True,
    fault_injector: FaultInjector | None = None,
    max_attempts: int = 5,
    stall_timeout_s: float = 1.0,
    resume: bool = True,
    retry_backoff_s: float = 0.01,
    retry_backoff_cap_s: float = 0.25,
    seed: int = 0,
) -> MulticastGatewayReport:
    """Replicate objects to every destination of a multicast plan.

    The plan's distribution trees become a forwarding mesh of bounded
    queues: each tree edge is a stage with ``workers_per_hop`` threads, and
    a worker finishing a chunk fans it out to EVERY downstream stage of the
    tree (deduplicated, so a segment shared by several destinations carries
    each chunk exactly once — the data-plane realization of envelope
    billing) and, where the edge terminates at a destination, hands it to
    that destination's verifier. Each destination verifies and commits
    chunks independently against the source-side checksums; a chunk lost on
    one branch (killed worker, corruption) is re-dispatched for the
    destinations that still miss it, along a surviving tree path to each —
    chunk-level retry per branch, without re-sending to destinations that
    already verified it. ``dst_stores`` maps destination region keys (or
    region indices) to stores; zero-byte objects are committed everywhere.
    """
    keys_of_top = plan.top.keys()
    stores: dict[int, ObjectStore] = {}
    for d in plan.active_dsts:
        store = dst_stores.get(keys_of_top[d], dst_stores.get(d))
        if store is None:
            raise ValueError(f"no destination store for {keys_of_top[d]}")
        stores[d] = store
    trees = plan.trees()
    if not trees or not stores:
        raise ValueError("plan has no flow")
    dests = sorted(stores)
    tr = get_tracer()
    w0 = tr.now_wall() if tr.enabled else 0.0

    # ---- per-destination resume pre-pass
    skipped = {d: 0 for d in dests}
    keys_by_dest: dict[int, set] = {}
    for d in dests:
        need = set()
        for key in object_keys:
            if (
                resume and verify and stores[d].exists(key)
                and _same_object(src_store, stores[d], key, chunk_bytes)
            ):
                skipped[d] += 1
                continue
            need.add(key)
        keys_by_dest[d] = need
    keys_to_move = sorted(set().union(*keys_by_dest.values()))

    all_chunks, chunk_sums, object_sums = chunk_manifest(
        src_store, keys_to_move, chunk_bytes, with_sums=verify
    )
    chunked = {ch.object_key for ch in all_chunks}
    for d in dests:  # zero-byte objects commit directly, everywhere needed
        for key in keys_by_dest[d]:
            if key not in chunked:
                stores[d].put(key, b"")
        keys_by_dest[d] &= chunked
    keys_to_move = [k for k in keys_to_move if k in chunked]
    chunk_by_id = {ch.id: ch for ch in all_chunks}

    # ---- stages: one per (tree, edge)
    class _Stage:
        __slots__ = ("sid", "tid", "edge", "hop", "q", "children",
                     "serves", "deliver")

    stages: list[_Stage] = []
    stage_of: list[dict] = []  # per tree: edge -> stage
    path_stages: dict[tuple[int, int], list[int]] = {}  # (tree, dest) -> sids
    for tid, t in enumerate(trees):
        s_of = {}
        kids = t.children()
        serves = t.dests_of_edge()
        delivers = t.delivers()
        for e in t.edges():
            st = _Stage()
            st.sid = len(stages)
            st.tid = tid
            st.edge = e
            st.hop = 0 if e[0] == plan.src else 1
            st.q = (
                queue.Queue()
                if st.hop == 0
                else queue.Queue(maxsize=relay_buffer_chunks)
            )
            st.serves = serves[e] & set(dests)
            st.deliver = delivers.get(e)
            if st.deliver is not None and st.deliver not in stores:
                st.deliver = None
            s_of[e] = st
            stages.append(st)
        for e in t.edges():
            s_of[e].children = [s_of[c].sid for c in kids[e]]
        stage_of.append(s_of)
        for d, p in t.paths.items():
            if d in stores:
                path_stages[(tid, d)] = [
                    s_of[e].sid for e in zip(p[:-1], p[1:])
                ]

    # ---- chunk -> tree pre-binning by rate share
    weights = [t.rate for t in trees]
    total_w = sum(weights)
    bins: list[list[Chunk]] = [[] for _ in trees]
    cum = [w / total_w for w in weights]
    acc = [0.0] * len(trees)
    for ch in all_chunks:
        i = max(range(len(trees)), key=lambda j: cum[j] - acc[j])
        bins[i].append(ch)
        acc[i] += 1.0 / max(len(all_chunks), 1)
    per_tree_count = {i: len(b) for i, b in enumerate(bins)}

    done_event = threading.Event()
    done_q: "queue.Queue" = queue.Queue()
    retry_q: "queue.Queue" = queue.Queue()  # (chunk, attempt, target dest)
    lock = threading.Lock()
    bytes_moved = [0]
    retried = [0]
    live = {st.sid: workers_per_hop for st in stages}
    # per region-pair telemetry (several stages may share one region pair
    # across trees — the counters aggregate the pair): envelope bytes that
    # crossed the hop and first-pickup/last-completion stamps
    edge_bytes: dict[tuple[int, int], int] = {}
    edge_t0: dict[tuple[int, int], float] = {}
    edge_t1: dict[tuple[int, int], float] = {}
    forwarded: set[tuple[int, str]] = set()  # (sid, chunk id) fan-in dedup
    verified: set[tuple[int, str]] = set()  # (dest, chunk id)
    # every (dest, chunk) pair the transfer owes — fixed up front so retry
    # targeting (and the exit predicate it feeds) ignores destinations that
    # resume-skipped the object
    needed = {
        (d, ch.id) for d in dests for ch in all_chunks
        if ch.object_key in keys_by_dest[d]
    }

    def _put(q: queue.Queue, item) -> None:
        while not done_event.is_set():
            try:
                q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def _fan_out(st: _Stage, ch: Chunk, data: bytes, attempt: int, target):
        """Deliver + forward a chunk that finished traversing ``st``."""
        if st.deliver is not None and (target is None or target == st.deliver):
            done_q.put((st.deliver, ch, data, attempt))
        for csid in st.children:
            child = stages[csid]
            if target is None:
                with lock:
                    if (csid, ch.id) in forwarded:
                        continue
                    forwarded.add((csid, ch.id))
                _put(child.q, (ch, data, attempt, None))
            elif target in child.serves:
                _put(child.q, (ch, data, attempt, target))

    def hop_worker(st: _Stage):
        while not done_event.is_set():
            try:
                item = st.q.get(timeout=0.05)
            except queue.Empty:
                continue
            ch, data, attempt, target = item
            t0w = tr.now_wall() if tr.enabled else 0.0
            # open the edge's telemetry window at FIRST pickup — stamping at
            # first completion would shave one chunk's time off the window
            # and overstate the link rate (same discipline as the unicast
            # path)
            with lock:
                edge_t0.setdefault(st.edge, time.monotonic())
            if data is None:  # root stage: read from the source store once
                data = src_store.get_range(ch.object_key, ch.offset, ch.length)
            if fault_injector is not None:
                action, data = fault_injector.on_pickup(
                    st.tid, st.sid, ch, data, attempt
                )
                if action == "kill":
                    with lock:
                        live[st.sid] -= 1
                    # the chunk retries per branch: one targeted re-dispatch
                    # for every destination downstream of this edge that
                    # still misses it
                    wants = st.serves if target is None else {target}
                    for d in sorted(wants):
                        retry_q.put((ch, attempt + 1, d))
                    if tr.enabled:
                        tr.instant("gateway.worker_killed", tr.now_wall(),
                                   track="gateway", tree=st.tid,
                                   stage=st.sid)
                    return  # the worker dies with its chunk
            with lock:
                bytes_moved[0] += len(data)
                edge_bytes[st.edge] = edge_bytes.get(st.edge, 0) + len(data)
                edge_t1[st.edge] = time.monotonic()
            _fan_out(st, ch, data, attempt, target)
            if tr.enabled:
                tr.span("gateway.hop", t0w, tr.now_wall() - t0w,
                        track="gateway", tree=st.tid, stage=st.sid,
                        chunk=ch.id)

    threads: list[threading.Thread] = []
    for st in stages:
        for _ in range(workers_per_hop):
            t = threading.Thread(target=hop_worker, args=(st,), daemon=True)
            threads.append(t)
            t.start()
    for tid, t in enumerate(trees):
        roots = [stage_of[tid][e] for e in t.roots()]
        for ch in bins[tid]:
            for st in roots:
                st.q.put((ch, None, 0, None))

    # ---- retry feeder: targeted re-dispatch down a surviving branch
    attempts: dict[tuple[int, str], int] = {}
    dead: set[tuple[int, str]] = set()

    def alive_routes(d: int) -> list[tuple[int, int]]:
        with lock:
            return [
                (tid, d) for tid in range(len(trees))
                if (tid, d) in path_stages
                and all(live[s] > 0 for s in path_stages[(tid, d)])
            ]

    rr = [0]

    def dispatch(ch: Chunk, attempt: int, d: int) -> None:
        if (d, ch.id) not in needed or (d, ch.id) in verified:
            return  # not owed / already landed: nothing to do
        if attempt > max_attempts:
            dead.add((d, ch.id))
            return
        routes = alive_routes(d)
        if not routes:
            dead.add((d, ch.id))
            return
        with lock:
            retried[0] += 1
        _retries.inc()
        tid, _ = routes[rr[0] % len(routes)]
        rr[0] += 1
        attempts[(d, ch.id)] = max(attempts.get((d, ch.id), 0), attempt)
        if tr.enabled:
            tr.instant("gateway.retry", tr.now_wall(), track="gateway",
                       chunk=ch.id, attempt=attempt, dest=d, tree=tid)
        stages[path_stages[(tid, d)][0]].q.put((ch, None, attempt, d))

    def feeder():
        # same heap-scheduled exponential backoff as the unicast feeder —
        # per-(dest, chunk) re-dispatches jittered off a shared seeded rng
        rng = random.Random(seed)
        pending: list = []  # (due time, tiebreak, chunk, attempt, dest)
        tick = 0
        while not done_event.is_set():
            timeout = 0.05
            if pending:
                timeout = max(min(timeout, pending[0][0] - time.monotonic()),
                              0.0)
            try:
                ch, attempt, d = retry_q.get(timeout=timeout)
                delay = _retry_delay(attempt, retry_backoff_s,
                                     retry_backoff_cap_s, rng)
                tick += 1
                heapq.heappush(
                    pending, (time.monotonic() + delay, tick, ch, attempt, d)
                )
            except queue.Empty:
                pass
            while pending and pending[0][0] <= time.monotonic():
                _, _, ch, attempt, d = heapq.heappop(pending)
                dispatch(ch, attempt, d)

    feeder_t = threading.Thread(target=feeder, daemon=True)
    feeder_t.start()

    # ---- destinations: verify + commit per (dest, chunk), reassemble
    buffers = {d: {k: {} for k in keys_by_dest[d]} for d in dests}
    expect = {
        k: len(chunk_object(k, src_store.size(k), chunk_bytes))
        for k in keys_to_move
    }
    duplicates = {d: 0 for d in dests}
    failures = {d: 0 for d in dests}
    stall_rounds = 0
    max_gap = stall_timeout_s
    last_delivery = time.monotonic()
    while len(verified) + len(dead - verified) < len(needed):
        try:
            d, ch, data, attempt = done_q.get(timeout=stall_timeout_s)
        except queue.Empty:
            quiet = time.monotonic() - last_delivery
            if quiet < max(stall_timeout_s, 2.0 * max_gap):
                continue  # plausibly just slow: keep waiting
            stall_rounds += 1
            _stall_rounds.inc()
            missing = [p for p in needed if p not in verified and p not in dead]
            if not missing or stall_rounds > max_attempts:
                break
            if tr.enabled:
                tr.instant("gateway.stall", tr.now_wall(), track="gateway",
                           missing=len(missing), round=stall_rounds)
            for dm, cid in missing:
                retry_q.put((chunk_by_id[cid], attempts.get((dm, cid), 0), dm))
            last_delivery = time.monotonic()
            continue
        now_t = time.monotonic()
        max_gap = max(max_gap, now_t - last_delivery)
        last_delivery = now_t
        stall_rounds = 0
        if (d, ch.id) not in needed or (d, ch.id) in verified:
            duplicates[d] = duplicates.get(d, 0) + 1
            continue
        if verify and checksum(data) != chunk_sums[ch.id]:
            _checksum_failures.inc()
            if tr.enabled:
                tr.instant("gateway.checksum_fail", tr.now_wall(),
                           track="gateway", chunk=ch.id, attempt=attempt,
                           dest=d)
            retry_q.put((ch, attempt + 1, d))
            continue
        verified.add((d, ch.id))
        dead.discard((d, ch.id))
        parts = buffers[d][ch.object_key]
        parts[ch.index] = data
        if len(parts) == expect[ch.object_key]:
            blob = b"".join(parts[i] for i in range(len(parts)))
            if verify and checksum(blob) != object_sums[ch.object_key]:
                failures[d] += 1
            stores[d].put(ch.object_key, blob)
            if tr.enabled:
                tr.instant("gateway.commit", tr.now_wall(),
                           track="gateway", key=ch.object_key, dest=d)

    done_event.set()
    feeder_t.join(timeout=2.0)
    for t in threads:
        t.join(timeout=2.0)
    leaked = sum(1 for t in threads if t.is_alive()) + (
        1 if feeder_t.is_alive() else 0
    )
    if leaked:
        _workers_leaked.inc(leaked)
        if tr.enabled:
            tr.instant("gateway.workers_leaked", tr.now_wall(),
                       track="gateway", leaked=leaked)

    per_dest = {}
    for d in dests:
        need_d = {cid for (dd, cid) in needed if dd == d}
        got_d = {cid for (dd, cid) in verified if dd == d}
        per_dest[keys_of_top[d]] = GatewayReport(
            objects=len(object_keys),
            chunks=len(need_d),
            bytes_moved=0,  # envelope bytes are aggregate, see the report
            checksum_failures=failures[d],
            per_path_chunks={},
            duplicate_chunks=duplicates[d],
            objects_skipped=skipped[d],
            chunks_missing=len(need_d - got_d),
        )
    if tr.enabled:
        tr.span("gateway.transfer_multicast", w0, tr.now_wall() - w0,
                track="gateway", chunks=len(all_chunks),
                retried=retried[0], leaked=leaked)
    return MulticastGatewayReport(
        per_dest=per_dest,
        chunks=len(all_chunks),
        bytes_moved=bytes_moved[0],
        retried_chunks=retried[0],
        faults_injected=0 if fault_injector is None
        else fault_injector.faults_injected,
        per_tree_chunks=per_tree_count,
        workers_leaked=leaked,
        per_edge_bytes=dict(edge_bytes),
        per_edge_seconds={
            e: max(edge_t1[e] - edge_t0[e], 1e-9) for e in edge_bytes
        },
    )

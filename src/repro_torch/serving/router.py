"""SLO-aware front-end router over per-replica serving engines.

The service layer the replica planner (:mod:`repro_torch.core.replica`) plans
for: N :class:`~repro_torch.serving.engine.ServingEngine` replicas, each owning a
disjoint device subset, behind one router that

* owns **priority-tiered admission queues** — tier 0 drains strictly before
  tier 1 before tier 2 (interactive > standard > batch); within a tier,
  FIFO.  Dispatch only hands a request to a replica with free capacity, so
  under contention the tiers are meaningful: a batch request never takes
  the slot an interactive one is waiting for;
* **dispatches** by ``least_loaded`` (fewest in-flight + queued requests
  per unit of replica capacity) or ``shortest_prefill`` (fewest pending
  prompt tokens ahead of the new arrival — the better policy under mixed
  prompt lengths, since a short question should not queue behind a
  book-length context on the loaded replica);
* **streams tokens back**: each submitted request may carry an
  ``on_token(req, tok)`` callback, invoked for every newly generated token
  at the router step that observed it;
* keeps **per-replica adaptation** running (each engine's own observe →
  derate → replan loop is untouched) and watches each replica's
  :meth:`~repro_torch.serving.engine.ServingEngine.health`: a replica derated or
  failure-shrunk below ``RouterConfig.health_floor`` is **drained** —
  admission stops, never-started queued work returns to the front of its
  tiers for re-dispatch, in-flight requests finish — and once idle its
  surviving devices (in ORIGINAL cluster indices) re-enter the router's
  device pool, triggering a **service-level replan**: if the pool's healthy
  devices can host a replica, ``engine_factory`` spawns one and it joins
  the active set.

Replica lifecycle::

    active ──(health < floor)──► draining ──(idle)──► retired
      ▲                                                  │ devices → pool
      └────────── engine_factory(healthy pool) ◄─────────┘

Graceful degradation (the robustness layer):

* **per-tier token-bucket rate limiting** (``RouterConfig.tier_rates``):
  a submit finding its tier's bucket empty is shed at the door;
* **request deadlines**: a queued request whose ``Request.deadline``
  passes is expired instead of served late;
* **SLO-aware load shedding** (``RouterConfig.slo_p99_steps``): when the
  interactive tier's p99 (or its head-of-queue wait) breaches the SLO,
  queued batch-tier work is shed — newest first, lowest priority first —
  so tier 0 stays inside its SLO at the cost of the tiers that opted out
  of latency guarantees;
* **crash retries with exponential backoff**: requests lost to a crashed
  replica re-enter the front of their tier (their generated tokens ride
  along, so the re-prefill path resumes the decode token-identically)
  until their ``max_retries`` budget is spent — then they reach the typed
  ``failed`` state.

Every submission therefore ends in exactly one typed terminal state
(``finished | shed | expired | failed``) and every non-served outcome
increments a counter in :meth:`Router.stats` — zero silent losses.
Scheduled chaos (:mod:`repro_torch.serving.faults`) enters through
:meth:`Router.apply_fault`, which routes each event to the replica owning
the targeted device/link.

Every transition lands in :attr:`Router.events` (bounded; evictions are
counted in ``stats()["counters"]["events_dropped"]``), the operator view
surfaced by ``launch/serve.py --replicas``.

The port's router differs from the reference's in three places:

* **Only a typed loss retires a replica.**  The router turns a failure into
  a ``replica_crash``, or logs a spawn ``replan_failed``, only when the
  planner finds no placement that fits
  (:class:`~repro_torch.core.placement.NoFeasiblePlacement`: the survivors
  or the pool cannot hold the model, or no device of the replica survived,
  :class:`~repro_torch.core.placement.NoSurvivingDevices`).  Anything else a
  step, a fault or a spawn raises — a CUDA error,
  ``torch.cuda.OutOfMemoryError``, a failed kernel build or launch, a kernel
  refusing its inputs — propagates: on the card it is a fault of the
  program, not a device the service can route around.
* **A retired replica frees its KV caches** (:meth:`ServingEngine.release_caches`),
  so a replacement spawned on the same card finds the memory; its host
  state stays for the reports.
* **One stream.**  Replicas are stepped one after another on the current
  CUDA stream of their devices; the router adds none.  That is what lets
  replicas mapped onto one card share its weights and the grouped GEMM's
  per-card scratch (``kernels/grouped_gemm.py``), which no two launches may
  use at once.  :meth:`from_service_plan` maps modeled devices onto the
  visible cards modulo their count, so on one card every replica shares
  the device and its stream, and a ``device_crash`` is a modeled fault: it
  re-plans and rebuilds stages, and nothing on the card fails.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, replace
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.placement import NoFeasiblePlacement
from repro_torch.device import cuda_devices
from repro_torch.serving.engine import Request, ServingEngine


@dataclass
class RouterConfig:
    """Router knobs: tier count, dispatch policy, replica health floor,
    whether a finished drain triggers a pool replan, per-replica backlog
    (queued-beyond-slots) allowance, drain step budget, the event-log
    bound — plus the graceful-degradation knobs: per-tier token-bucket
    rates, the interactive SLO that triggers load shedding, and the retry
    backoff base for requests lost to replica crashes."""

    tiers: int = 3
    dispatch: str = "least_loaded"       # least_loaded | shortest_prefill
    health_floor: float = 0.5
    replan_on_drain: bool = True
    # requests a replica may hold QUEUED beyond its free slots; 0 = hand a
    # replica work only when it has a slot open (strictest priority: the
    # router's tiers stay authoritative, not the replicas' FIFO queues)
    backlog: int = 0
    drain_max_steps: int = 10_000
    event_log_keep: int = 4096
    # per-tier admission rate (requests per router step); None = unlimited.
    # A tier whose bucket is empty sheds AT SUBMIT (state="shed") — the
    # cheap first line of graceful degradation, before queues even build
    tier_rates: Optional[Sequence[Optional[float]]] = None
    # bucket capacity = max(rate * burst, 1): short bursts ride through
    burst: float = 4.0
    # interactive (tier-0) p99 SLO in router steps; None disables
    # SLO-triggered load shedding.  On breach the router sheds QUEUED
    # lower-tier work (batch first, newest first) down to what the free
    # capacity left after the interactive queue can absorb
    slo_p99_steps: Optional[int] = None
    # recent tier-0 latencies consulted by the SLO check
    slo_window: int = 64
    # base (steps) of the exponential retry backoff after a replica crash:
    # a request's n-th retry waits retry_backoff * 2**(n-1) steps
    retry_backoff: int = 2

    def __post_init__(self):
        if self.dispatch not in ("least_loaded", "shortest_prefill"):
            raise ValueError(
                f"dispatch must be least_loaded|shortest_prefill, got {self.dispatch!r}"
            )
        if self.tiers < 1:
            raise ValueError(f"tiers must be >= 1, got {self.tiers}")
        if self.tier_rates is not None:
            if len(self.tier_rates) != self.tiers:
                raise ValueError(
                    f"tier_rates needs one entry per tier "
                    f"({len(self.tier_rates)} != {self.tiers})"
                )
            for r in self.tier_rates:
                if r is not None and r < 0:
                    raise ValueError(f"tier rate must be >= 0, got {r}")
        if self.burst <= 0:
            raise ValueError(f"burst must be > 0, got {self.burst}")
        if self.slo_p99_steps is not None and self.slo_p99_steps < 1:
            raise ValueError(
                f"slo_p99_steps must be >= 1, got {self.slo_p99_steps}"
            )
        if self.slo_window < 1:
            raise ValueError(f"slo_window must be >= 1, got {self.slo_window}")
        if self.retry_backoff < 0:
            raise ValueError(
                f"retry_backoff must be >= 0, got {self.retry_backoff}"
            )


class _TokenBucket:
    """Per-tier admission rate limiter: ``rate`` tokens per router step,
    bucket capacity ``max(rate * burst, 1)`` (so rate < 1 still admits)."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.capacity = max(self.rate * burst, 1.0)
        self.tokens = self.capacity

    def refill(self):
        self.tokens = min(self.tokens + self.rate, self.capacity)

    def take(self) -> bool:
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclass
class Replica:
    """One serving engine behind the router: its name, the ORIGINAL cluster
    device indices it owns, lifecycle state, and its dispatch weight
    (planned steady req/s, used to normalize load scores so a half-speed
    replica is not handed half the traffic of a full-speed one)."""

    name: str
    devices: List[int]
    engine: ServingEngine
    state: str = "active"                # active | draining | retired
    weight: float = 1.0

    def in_flight(self) -> int:
        return sum(r is not None for r in self.engine.active) + len(
            self.engine.queue
        )

    def capacity(self, backlog: int) -> int:
        return (self.engine.slots + backlog) - self.in_flight()

    def idle(self) -> bool:
        return self.in_flight() == 0


@dataclass
class _Record:
    """Router-side bookkeeping for one submitted request."""

    req: Request
    tier: int
    on_token: Optional[Callable[[Request, int], None]] = None
    streamed: int = 0
    submitted_step: int = 0
    dispatched_step: Optional[int] = None
    done_step: Optional[int] = None
    replica: Optional[str] = None
    # earliest router step a crash-retried request may re-dispatch at
    # (exponential backoff); 0 = immediately
    not_before: int = 0


class Router:
    """Front-end over per-replica engines — see module docstring.

    Args:
        replicas: :class:`Replica` instances, or ``(engine, devices)``
            pairs (devices = ORIGINAL cluster indices the engine owns).
        config: :class:`RouterConfig` (default: 3 tiers, least-loaded).
        engine_factory: ``f(devices: List[int]) -> ServingEngine`` used to
            spawn a replacement replica from pooled devices after a drain;
            ``None`` disables service-level replanning (drained devices
            just accumulate in :attr:`device_pool`).
    """

    def __init__(
        self,
        replicas: Sequence[Any],
        *,
        config: Optional[RouterConfig] = None,
        engine_factory: Optional[Callable[[List[int]], ServingEngine]] = None,
    ):
        self.config = config or RouterConfig()
        self.engine_factory = engine_factory
        self.replicas: List[Replica] = []
        for i, r in enumerate(replicas):
            if isinstance(r, Replica):
                self.replicas.append(r)
            else:
                eng, devs = r
                self.replicas.append(
                    Replica(name=f"replica{i}", devices=list(devs), engine=eng)
                )
        if not self.replicas:
            raise ValueError("router needs at least one replica")
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self._next_replica_id = len(self.replicas)
        self.tiers: List[Deque[_Record]] = [
            deque() for _ in range(self.config.tiers)
        ]
        self._records: Dict[int, _Record] = {}          # id(req) -> record
        self._replica_recs: Dict[str, List[_Record]] = {
            r.name: [] for r in self.replicas
        }
        self.device_pool: List[int] = []
        self.pool_derate: Dict[int, float] = {}
        self.events: List[Dict[str, Any]] = []
        self.finished: List[Request] = []
        self.step_count = 0
        # graceful-degradation state: per-tier token buckets, the recent
        # interactive latencies the SLO check consults, robustness counters
        # (surfaced by stats()), and the optional fault injector
        self._buckets: List[Optional[_TokenBucket]] = [
            None if self.config.tier_rates is None
            or self.config.tier_rates[t] is None
            else _TokenBucket(self.config.tier_rates[t], self.config.burst)
            for t in range(self.config.tiers)
        ]
        self._tier0_lat: Deque[int] = deque(maxlen=self.config.slo_window)
        self.counters: Dict[str, int] = {
            "shed": 0, "expired": 0, "retried": 0, "failed": 0,
            "crashed_replicas": 0, "events_dropped": 0,
        }
        self._injector = None

    # ------------------------------------------------------------------
    def _log(self, kind: str, **kw):
        if len(self.events) >= self.config.event_log_keep:
            drop = self.config.event_log_keep // 2
            # the ring must stay bounded, but the loss must not be silent:
            # stats()["counters"]["events_dropped"] records every eviction
            self.counters["events_dropped"] += drop
            del self.events[:drop]
        self.events.append({"step": self.step_count, "kind": kind, **kw})

    # ------------------------------------------------------------------
    def submit(
        self,
        req: Request,
        *,
        tier: Optional[int] = None,
        on_token: Optional[Callable[[Request, int], None]] = None,
    ):
        """Enqueue ``req`` into a priority tier (default: the LOWEST tier —
        callers opt IN to priority with ``tier=0``).  ``on_token`` streams
        each newly generated token back as the router observes it.

        With ``RouterConfig.tier_rates`` set, admission is rate-limited per
        tier: a submit that finds its tier's token bucket empty is SHED
        immediately (``state="shed"``, ``rejected=True``, delivered through
        :attr:`finished`) — typed and counted, never silently dropped."""
        t = self.config.tiers - 1 if tier is None else int(tier)
        if not 0 <= t < self.config.tiers:
            raise ValueError(f"tier {t} outside 0..{self.config.tiers - 1}")
        # stamp the class onto the request itself: engine-side per-class
        # accounting (e.g. speculative acceptance rates) keys on it
        req.tier = t
        rec = _Record(
            req=req, tier=t, on_token=on_token, submitted_step=self.step_count
        )
        self._records[id(req)] = rec
        bucket = self._buckets[t]
        if bucket is not None and not bucket.take():
            self._terminate(rec, "shed", reason="rate_limit")
            return
        self.tiers[t].append(rec)
        self._log("submit", rid=req.rid, tier=t)

    # ------------------------------------------------------------------
    # graceful degradation: typed terminal states, deadlines, SLO shedding
    # ------------------------------------------------------------------
    def _terminate(self, rec: _Record, state: str, *, reason: str):
        """Move a request to a typed terminal state (``shed`` / ``expired``
        / ``failed``) without serving it: flagged, counted, logged, and
        delivered through :attr:`finished` — the zero-silent-loss
        contract."""
        rec.req.state = state
        rec.req.done = True
        if state == "shed":
            rec.req.rejected = True
        rec.done_step = self.step_count
        self.finished.append(rec.req)
        self.counters[state] += 1
        self._log(state, rid=rec.req.rid, tier=rec.tier, reason=reason)

    def _expire_deadlines(self):
        """Expire QUEUED requests whose ``deadline`` (router steps since
        submission) has passed — serving them now would deliver a useless
        result while holding a slot someone inside deadline could use.
        In-flight requests are left to finish: their slot is already spent."""
        for q in self.tiers:
            for rec in [
                r for r in q
                if r.req.deadline is not None
                and self.step_count - r.submitted_step > r.req.deadline
            ]:
                q.remove(rec)
                self._terminate(rec, "expired", reason="deadline")

    def slo_ok(self) -> bool:
        """Is the interactive tier inside its SLO?  Breached when the p99
        of recent tier-0 latencies exceeds ``slo_p99_steps``, or when the
        OLDEST queued tier-0 request has already waited past it (the
        head-wait proxy catches a breach before any slow completion can) —
        ``True`` when no SLO is configured."""
        slo = self.config.slo_p99_steps
        if slo is None:
            return True
        if self.tiers[0]:
            head = self.tiers[0][0]
            if self.step_count - head.submitted_step > slo:
                return False
        if self._tier0_lat:
            lat = sorted(self._tier0_lat)
            p99 = lat[min(int(0.99 * len(lat)), len(lat) - 1)]
            if p99 > slo:
                return False
        return True

    def _shed_for_slo(self):
        """Load shedding on SLO breach: keep at most the lower-tier queue
        the free capacity can absorb AFTER reserving room for every queued
        interactive request; shed the excess batch-tier-first, newest-first.
        Interactive work is never shed here — the whole point is to keep
        tier 0 inside its SLO by sacrificing the tiers that opted out of
        latency guarantees."""
        if self.config.slo_p99_steps is None or self.slo_ok():
            return
        free = sum(
            max(r.capacity(self.config.backlog), 0)
            for r in self.replicas
            if r.state == "active"
        )
        budget = max(free - len(self.tiers[0]), 0)
        excess = sum(len(q) for q in self.tiers[1:]) - budget
        for t in range(self.config.tiers - 1, 0, -1):
            while excess > 0 and self.tiers[t]:
                rec = self.tiers[t].pop()        # newest batch work first
                self._terminate(rec, "shed", reason="slo_breach")
                excess -= 1

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _score(self, rep: Replica) -> Tuple[float, str]:
        w = max(rep.weight, 1e-12)
        if self.config.dispatch == "shortest_prefill":
            load = rep.engine.pending_prefill_tokens() / w
        else:
            load = rep.in_flight() / w
        return (load, rep.name)           # name tie-break: deterministic

    def _dispatch(self):
        """Strict-priority dispatch: drain tier 0 first, FIFO within a
        tier, and only into replicas with free capacity — when every
        replica is full, NOBODY dispatches, so a lower tier can never
        overtake a starved higher one.  Crash-retried requests whose
        exponential backoff has not elapsed (``_Record.not_before``) are
        skipped in place: they keep their FIFO position without blocking
        the requests behind them."""
        active = [r for r in self.replicas if r.state == "active"]
        for tier, q in enumerate(self.tiers):
            while q:
                ready = [
                    r for r in active if r.capacity(self.config.backlog) > 0
                ]
                if not ready:
                    return                # saturated: preserve tier order
                i = next(
                    (
                        j for j, r in enumerate(q)
                        if r.not_before <= self.step_count
                    ),
                    None,
                )
                if i is None:
                    break                 # whole tier backed off: next tier
                rec = q[i]
                del q[i]
                best = min(ready, key=self._score)
                rec.dispatched_step = self.step_count
                rec.replica = best.name
                self._replica_recs[best.name].append(rec)
                best.engine.submit(rec.req)
                self._log(
                    "dispatch", rid=rec.req.rid, tier=tier,
                    replica=best.name, policy=self.config.dispatch,
                )

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _begin_drain(self, rep: Replica, reason: str):
        rep.state = "draining"
        handed = rep.engine.begin_drain()
        # handed-back work was ACCEPTED by the service: it re-enters the
        # FRONT of its tier (before never-dispatched peers), keeping order
        for req in reversed(handed):
            rec = self._records.get(id(req))
            if rec is None:               # submitted directly to the engine
                rec = _Record(req=req, tier=self.config.tiers - 1)
                self._records[id(req)] = rec
            rec.replica = None
            rec.dispatched_step = None
            self.tiers[rec.tier].appendleft(rec)
        handed_ids = {id(q) for q in handed}
        if self._replica_recs.get(rep.name):
            self._replica_recs[rep.name] = [
                r for r in self._replica_recs[rep.name]
                if id(r.req) not in handed_ids
            ]
        self._log(
            "drain_begin", replica=rep.name, reason=reason,
            handed_back=len(handed), health=rep.engine.health(),
        )

    def _finish_drain(self, rep: Replica):
        rep.state = "retired"
        eng = rep.engine
        eng.release_caches()
        # map the engine's subcluster-local indices back to ORIGINAL ids
        failed = {rep.devices[i] for i in eng.failed_devices}
        freed = [d for d in rep.devices if d not in failed]
        for local, factor in eng.derate.items():
            self.pool_derate[rep.devices[local]] = factor
        self.device_pool.extend(freed)
        self._log(
            "drain_complete", replica=rep.name, freed_devices=freed,
            lost_devices=sorted(failed), pool=list(self.device_pool),
        )
        if self.config.replan_on_drain:
            self._replan_pool()

    def _crash_replica(self, rep: Replica, reason: str):
        """Hard replica loss (a fault that left the engine unable to serve
        — e.g. its last device crashed): retire it IMMEDIATELY, no drain.
        Every request that was queued or in flight on it is re-admitted to
        the front of its tier with an exponential backoff
        (``retry_backoff * 2**(retries-1)`` steps) — the re-prefill path
        resumes its greedy decode token-identically on another replica —
        unless its ``max_retries`` budget is spent, in which case it
        reaches the typed ``failed`` terminal state.  Surviving devices go
        to the pool for a service-level replan."""
        rep.state = "retired"
        self.counters["crashed_replicas"] += 1
        recs = self._replica_recs.get(rep.name, [])
        self._replica_recs[rep.name] = []
        lost = [r for r in recs if not r.req.done]
        # oldest-first via appendleft(reversed): lost work re-enters the
        # FRONT of its tier in original order, ahead of never-started peers
        for rec in reversed(lost):
            req = rec.req
            rec.replica = None
            rec.dispatched_step = None
            req.retries += 1
            if req.retries > req.max_retries:
                self._terminate(
                    rec, "failed",
                    reason=f"retry budget exhausted ({req.max_retries})",
                )
                continue
            rec.not_before = self.step_count + self.config.retry_backoff * (
                2 ** (req.retries - 1)
            )
            self.counters["retried"] += 1
            self.tiers[rec.tier].appendleft(rec)
            self._log(
                "retry", rid=req.rid, tier=rec.tier, attempt=req.retries,
                not_before=rec.not_before,
            )
        eng = rep.engine
        eng.release_caches()
        failed = {rep.devices[i] for i in eng.failed_devices}
        freed = [d for d in rep.devices if d not in failed]
        for local, factor in eng.derate.items():
            self.pool_derate[rep.devices[local]] = factor
        self.device_pool.extend(freed)
        self._log(
            "replica_crash", replica=rep.name, reason=reason,
            lost_requests=len(lost), freed_devices=freed,
            lost_devices=sorted(failed),
        )
        if self.config.replan_on_drain:
            self._replan_pool()

    # ------------------------------------------------------------------
    # chaos harness: scheduled fault injection (see serving.faults)
    # ------------------------------------------------------------------
    def attach_fault_injector(self, injector) -> None:
        """Attach a :class:`~repro_torch.serving.faults.FaultInjector`; polled at
        the top of every :meth:`step`.  Schedule device/link indices are
        ORIGINAL cluster indices — the router routes each event to the
        replica owning the device(s) and translates to its local indices."""
        self._injector = injector

    def apply_fault(self, ev) -> str:
        """Route one :class:`~repro_torch.serving.faults.FaultEvent` (ORIGINAL
        cluster indices) to the owning live replica.  An engine whose replan
        finds no placement (:class:`NoFeasiblePlacement`) is treated as a
        replica crash: :meth:`_crash_replica` re-admits its
        lost requests with backoff and pools the survivors.  Any other error
        propagates."""
        if ev.link is not None:
            a, b = int(ev.link[0]), int(ev.link[1])
            rep = next(
                (
                    r for r in self.replicas
                    if r.state != "retired"
                    and a in r.devices and b in r.devices
                ),
                None,
            )
            if rep is None:
                return f"ignored: no live replica owns link ({a}, {b})"
            local = replace(
                ev, link=(rep.devices.index(a), rep.devices.index(b))
            )
            target = f"link ({a}, {b})"
        else:
            dev = int(ev.device)
            rep = next(
                (
                    r for r in self.replicas
                    if r.state != "retired" and dev in r.devices
                ),
                None,
            )
            if rep is None:
                return f"ignored: no live replica owns device {dev}"
            local = replace(ev, device=rep.devices.index(dev))
            target = f"device {dev}"
        try:
            status = rep.engine.apply_fault(local)
        # the fault killed the replica outright: a crash of its last device
        # (NoSurvivingDevices, the loss the reference's router and fault
        # tests reach) or survivors that cannot hold the model
        except NoFeasiblePlacement as e:
            self._crash_replica(rep, reason=f"{ev.kind} on {target}: {e}")
            return f"{rep.name}: crashed ({e})"
        self._log(
            "fault", replica=rep.name, fault=ev.kind, target=target,
            status=status,
        )
        return f"{rep.name}: {status}"

    def _replan_pool(self):
        """Service-level replan: if the pool's healthy devices can host a
        replica, spawn one via ``engine_factory`` and put it in rotation.  A
        pool the planner finds no placement on (:class:`NoFeasiblePlacement`)
        is logged ``replan_failed``; anything else (CUDA, out of memory, a
        kernel build) propagates."""
        healthy = [
            d for d in self.device_pool
            if self.pool_derate.get(d, 1.0) >= self.config.health_floor
        ]
        if not healthy or self.engine_factory is None:
            self._log(
                "replan_skipped",
                healthy_pool=healthy,
                has_factory=self.engine_factory is not None,
            )
            return
        try:
            engine = self.engine_factory(sorted(healthy))
        except NoFeasiblePlacement as e:  # pool can't host a replica (memory)
            self._log("replan_failed", error=str(e), pool=healthy)
            return
        name = f"replica{self._next_replica_id}"
        self._next_replica_id += 1
        weight = sum(
            engine.cluster.devices[j].peak_flops
            * self.pool_derate.get(d, 1.0)
            for j, d in enumerate(sorted(healthy))
        )
        rep = Replica(
            name=name, devices=sorted(healthy), engine=engine, weight=weight
        )
        self.replicas.append(rep)
        self._replica_recs[name] = []
        self.device_pool = [d for d in self.device_pool if d not in healthy]
        self._log("replica_spawn", replica=name, devices=rep.devices)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def _stream(self, rep: Replica):
        recs = self._replica_recs.get(rep.name, [])
        still: List[_Record] = []
        for rec in recs:
            out = rec.req.out_tokens
            while rec.streamed < len(out):
                tok = out[rec.streamed]
                rec.streamed += 1
                if rec.on_token is not None:
                    rec.on_token(rec.req, tok)
            if rec.req.done:
                rec.done_step = self.step_count
                self.finished.append(rec.req)
                if rec.req.state == "shed":
                    # engine-side admission/oversize rejection: same typed
                    # terminal state, same counter as router-side shedding
                    self.counters["shed"] += 1
                elif rec.tier == 0:
                    # served interactive completion: feeds the SLO check
                    self._tier0_lat.append(rec.done_step - rec.submitted_step)
                self._log(
                    "finish", rid=rec.req.rid, tier=rec.tier,
                    replica=rep.name, rejected=rec.req.rejected,
                    state=rec.req.state,
                    steps=rec.done_step - rec.submitted_step,
                )
            else:
                still.append(rec)
        self._replica_recs[rep.name] = still

    def step(self) -> int:
        """One router tick: inject scheduled faults, refill rate buckets,
        expire deadlines, shed for SLO, dispatch, step every live replica,
        stream new tokens, finish drains (devices → pool → replan),
        health-check.  Returns the number of requests still in flight or
        queued."""
        self.step_count += 1
        if self._injector is not None:
            self._injector.on_step(self)
        for bucket in self._buckets:
            if bucket is not None:
                bucket.refill()
        self._expire_deadlines()
        self._shed_for_slo()
        self._dispatch()
        for rep in self.replicas:
            if rep.state == "retired":
                continue
            try:
                rep.engine.step()
            # a mid-step loss the engine can't absorb: its own injector
            # crashed its last device, or left survivors too small
            except NoFeasiblePlacement as e:
                self._crash_replica(rep, reason=f"engine step failed: {e}")
                continue
            self._stream(rep)
        for rep in self.replicas:
            if rep.state == "draining" and rep.idle():
                self._finish_drain(rep)
        for rep in self.replicas:
            if rep.state == "active":
                h = rep.engine.health()
                if h < self.config.health_floor:
                    self._begin_drain(
                        rep, reason=f"health {h:.3f} < floor "
                        f"{self.config.health_floor}",
                    )
        return self.pending()

    def pending(self) -> int:
        """Requests queued at the router or in flight on any replica."""
        return sum(len(q) for q in self.tiers) + sum(
            len(recs) for recs in self._replica_recs.values()
        )

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        """Step until no request is queued or in flight (or ``max_steps``);
        returns every request finished during this call."""
        n0 = len(self.finished)
        for _ in range(max_steps):
            if self.step() == 0:
                break
        return self.finished[n0:]

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def latency_report(self) -> Dict[int, Dict[str, float]]:
        """Per-tier router-step latency (submit → done) of finished
        requests: count, mean, max — the contention view that shows tier 0
        skipping ahead of tier 2.  Only SERVED requests count: a shed or
        expired request's short lifetime is not a latency win."""
        by_tier: Dict[int, List[int]] = {}
        for rec in self._records.values():
            if rec.done_step is not None and rec.req.state == "finished":
                by_tier.setdefault(rec.tier, []).append(
                    rec.done_step - rec.submitted_step
                )
        return {
            t: {
                "count": float(len(v)),
                "mean_steps": sum(v) / len(v),
                "max_steps": float(max(v)),
            }
            for t, v in sorted(by_tier.items())
        }

    def stats(self) -> Dict[str, Any]:
        """Operator snapshot: the robustness counters (shed / expired /
        retried / failed / crashed_replicas / events_dropped — every
        non-served outcome is counted, never silent), per-tier queue
        depths, per-replica state+health, SLO status, the terminal
        tally by :class:`Request.state`, and ``kv`` — the paged-KV pool
        counters summed across replicas (``None`` when every replica
        serves dense rows)."""
        by_state: Dict[str, int] = {}
        for req in self.finished:
            by_state[req.state] = by_state.get(req.state, 0) + 1
        # service-wide paged-KV view: one counter sum over the replicas
        # that run a pool (residency gauges and sharing counters alike)
        kv: Dict[str, int] = {}
        for r in self.replicas:
            pool = getattr(r.engine, "_kv_pool", None)
            if pool is not None:
                for key, val in pool.stats().items():
                    kv[key] = kv.get(key, 0) + int(val)
        return {
            "counters": dict(self.counters),
            "queued": [len(q) for q in self.tiers],
            "kv": kv or None,
            "replicas": [
                {
                    "name": r.name,
                    "state": r.state,
                    "health": r.engine.health(),
                    "in_flight": r.in_flight(),
                }
                for r in self.replicas
            ],
            "slo_ok": self.slo_ok(),
            "finished_by_state": by_state,
            "device_pool": list(self.device_pool),
        }

    # ------------------------------------------------------------------
    @classmethod
    def from_service_plan(
        cls,
        cfg,
        params,
        cluster,
        service_plan,
        *,
        slots: int = 4,
        max_len: int = 256,
        plan_cfg=None,
        config: Optional[RouterConfig] = None,
        devices: Optional[List[Any]] = None,
        **engine_kwargs,
    ) -> "Router":
        """Build one engine per :class:`~repro_torch.core.replica.ReplicaSpec`.

        Each replica engine runs on ``cluster.subcluster(spec.devices)``
        with the service plan's pre-solved placement (mapped back to
        subcluster-local indices) — no re-planning at engine startup.  A
        single-replica plan over the full device set uses the ORIGINAL
        cluster object and placement result, so the engine is bit-identical
        to constructing ``ServingEngine`` directly.  The returned router's
        ``engine_factory`` re-plans from scratch on pooled devices (their
        pre-solved plan died with the drained replica).

        ``devices`` are the torch devices the modeled cluster's indices map
        onto, modulo their count (default: every visible card; without one
        this raises, as the engine does)."""
        jdev = devices if devices is not None else cuda_devices()
        full_set = list(range(cluster.k))
        replicas: List[Replica] = []
        for i, spec in enumerate(service_plan.replicas):
            g = list(spec.devices)
            if g == full_set:
                sub, local = cluster, spec.result
            else:
                sub = cluster.subcluster(g)
                pos = {d: j for j, d in enumerate(g)}
                local = replace(
                    spec.result,
                    placement={
                        nid: pos[k] for nid, k in spec.result.placement.items()
                    },
                    channels={
                        q: (pos[a], pos[b])
                        for q, (a, b) in spec.result.channels.items()
                    },
                )
            engine = ServingEngine(
                cfg, params, sub,
                devices=[jdev[d % len(jdev)] for d in g],
                slots=slots, max_len=max_len, plan_cfg=plan_cfg,
                placement_result=local, **engine_kwargs,
            )
            replicas.append(
                Replica(
                    name=f"replica{i}", devices=g, engine=engine,
                    weight=spec.throughput_rps
                    if spec.throughput_rps > 0
                    else 1.0,
                )
            )

        def factory(devs: List[int]) -> ServingEngine:
            return ServingEngine(
                cfg, params, cluster.subcluster(devs),
                devices=[jdev[d % len(jdev)] for d in devs],
                slots=slots, max_len=max_len, plan_cfg=plan_cfg,
                **engine_kwargs,
            )

        return cls(replicas, config=config, engine_factory=factory)

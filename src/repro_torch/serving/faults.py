"""Deterministic chaos harness: replayable fault schedules + injection.

Moirai's recovery machinery (derate → replan, health → drain → respawn,
prompt+generated re-prefill) existed before this module, but every failure
was triggered by hand.  A :class:`FaultSchedule` makes failure a
first-class INPUT: a seedable, JSON-round-trippable list of
:class:`FaultEvent`\\ s — device crashes, transient device stalls, channel
bandwidth degradations, channel partitions, and recoveries — that a
:class:`FaultInjector` replays into a serving engine or router one step at
a time.  The same schedule object drives unit tests, ``serve.py
--fault-schedule``, and ``benchmarks/fault_recovery.py``, so every chaos
scenario is a replayable artifact rather than a one-off.

Fault taxonomy
--------------
``device_crash``
    Permanent: the device leaves the cluster (``on_device_failure`` —
    replan on the survivors, in-flight work re-queued and resumed via
    re-prefill).  No recovery event can undo a crash.
``device_stall``
    Transient: the device runs at ``factor``× its nominal speed (thermal
    throttling, a co-tenant burst).  Applied as a direct model derate +
    replan; undone by a matching ``recover`` event or after ``duration``
    steps.
``link_degrade``
    The direct channel ``link=(a, b)`` drops to ``factor``× its nominal
    bandwidth in BOTH directions (one cable).  Applied as a link derate
    (``ClusterSpec.with_derate(links=...)``) + replan, so the new placement
    routes tensor flows around the slow interconnect.
``link_partition``
    ``link_degrade`` with factor 0: the channel disappears; the widest-path
    closure reroutes over surviving links if any path exists.
``recover``
    Restores the named device (after a stall) or link (after a
    degrade/partition) to nominal and replans.

Targets implement ``apply_fault(event) -> str`` (a human-readable status);
the injector never imports the engine or router, so there is no cycle.
"""

from __future__ import annotations

import heapq
import json
import os
import random
import tempfile
from dataclasses import asdict, dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

FAULT_KINDS = (
    "device_crash",
    "device_stall",
    "link_degrade",
    "link_partition",
    "recover",
)


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``step`` is the injection clock tick (engine/router step index) the
    event fires at.  ``device`` names a device fault's target, ``link`` a
    channel fault's ``(src, dst)`` pair — exactly one of the two must be
    set, except for ``recover`` which restores whichever is named.
    ``factor`` is the stall speed factor / degraded-link bandwidth factor
    (ignored for crash and partition).  ``duration``, when set on a
    transient fault, auto-schedules the matching ``recover`` that many
    steps later.
    """

    step: int
    kind: str
    device: Optional[int] = None
    link: Optional[Tuple[int, int]] = None
    factor: float = 1.0
    duration: Optional[int] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.link is not None:
            object.__setattr__(self, "link", (int(self.link[0]), int(self.link[1])))
        has_dev, has_link = self.device is not None, self.link is not None
        if self.kind in ("device_crash", "device_stall") and not has_dev:
            raise ValueError(f"{self.kind} needs a device")
        if self.kind in ("link_degrade", "link_partition") and not has_link:
            raise ValueError(f"{self.kind} needs a link=(src, dst)")
        if self.kind == "recover" and has_dev == has_link:
            raise ValueError("recover needs exactly one of device / link")
        if self.kind == "device_stall" and not 0.0 < self.factor < 1.0:
            raise ValueError(
                f"device_stall factor must be in (0, 1), got {self.factor}"
            )
        if self.kind == "link_degrade" and not 0.0 <= self.factor < 1.0:
            raise ValueError(
                f"link_degrade factor must be in [0, 1), got {self.factor}"
            )
        if self.kind == "device_crash" and self.duration is not None:
            raise ValueError("device_crash is permanent: no duration")
        if self.duration is not None and self.duration < 1:
            raise ValueError(f"duration must be >= 1 step, got {self.duration}")

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["link"] = list(self.link) if self.link is not None else None
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultEvent":
        link = d.get("link")
        return cls(
            step=int(d["step"]),
            kind=str(d["kind"]),
            device=None if d.get("device") is None else int(d["device"]),
            link=None if link is None else (int(link[0]), int(link[1])),
            factor=float(d.get("factor", 1.0)),
            duration=None if d.get("duration") is None else int(d["duration"]),
        )


class FaultSchedule:
    """An ordered, replayable chaos scenario.

    Construct from explicit events (scripted scenarios: tests, benchmarks)
    or with :meth:`random` (seeded fuzzing).  Serialize with
    :meth:`to_json`/:meth:`save`; a reloaded schedule replays identically —
    the artifact IS the scenario.
    """

    def __init__(
        self,
        events: Iterable[FaultEvent] = (),
        *,
        name: str = "chaos",
        seed: Optional[int] = None,
    ):
        self.events: List[FaultEvent] = sorted(events, key=lambda e: e.step)
        self.name = name
        self.seed = seed

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, FaultSchedule)
            and self.events == other.events
            and self.name == other.name
            and self.seed == other.seed
        )

    @property
    def horizon(self) -> int:
        """Last step any event (including auto-recoveries) fires at."""
        h = 0
        for e in self.events:
            h = max(h, e.step + (e.duration or 0))
        return h

    # ------------------------------------------------------------ authoring
    @classmethod
    def random(
        cls,
        seed: int,
        *,
        horizon: int,
        n_devices: int,
        links: Sequence[Tuple[int, int]] = (),
        n_events: int = 4,
        crash_weight: float = 1.0,
        stall_weight: float = 2.0,
        degrade_weight: float = 2.0,
        partition_weight: float = 0.5,
    ) -> "FaultSchedule":
        """A seeded random scenario — identical for identical arguments.

        Draws ``n_events`` faults over ``horizon`` steps from the weighted
        kind distribution; at most one crash per device (a dead device
        stays dead), transient faults carry bounded durations so the
        scenario always ends in a recoverable state.
        """
        rng = random.Random(seed)
        kinds, weights = ["device_stall"], [stall_weight]
        if n_devices > 1:
            kinds.append("device_crash")
            weights.append(crash_weight)
        if links:
            kinds += ["link_degrade", "link_partition"]
            weights += [degrade_weight, partition_weight]
        crashed: set = set()
        events: List[FaultEvent] = []
        for _ in range(n_events):
            kind = rng.choices(kinds, weights)[0]
            step = rng.randrange(max(horizon, 1))
            if kind == "device_crash":
                alive = [d for d in range(n_devices) if d not in crashed]
                if len(alive) <= 1:
                    continue  # never crash the last device
                dev = rng.choice(alive)
                crashed.add(dev)
                events.append(FaultEvent(step=step, kind=kind, device=dev))
            elif kind == "device_stall":
                events.append(FaultEvent(
                    step=step, kind=kind, device=rng.randrange(n_devices),
                    factor=rng.uniform(0.1, 0.6),
                    duration=rng.randrange(1, max(horizon // 2, 2)),
                ))
            else:
                link = rng.choice(list(links))
                events.append(FaultEvent(
                    step=step, kind=kind, link=link,
                    factor=rng.uniform(0.05, 0.5) if kind == "link_degrade" else 0.0,
                    duration=rng.randrange(1, max(horizon // 2, 2)),
                ))
        return cls(events, name=f"random-{seed}", seed=seed)

    # ---------------------------------------------------------- persistence
    def to_json(self) -> str:
        return json.dumps({
            "version": 1,
            "name": self.name,
            "seed": self.seed,
            "events": [e.to_dict() for e in self.events],
        }, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "FaultSchedule":
        data = json.loads(payload)
        if not isinstance(data, dict) or data.get("version") != 1:
            raise ValueError(
                f"unsupported FaultSchedule payload: {payload[:80]!r}"
            )
        return cls(
            [FaultEvent.from_dict(e) for e in data.get("events", [])],
            name=str(data.get("name", "chaos")),
            seed=data.get("seed"),
        )

    def save(self, path: str) -> None:
        """Atomic write (tmp + rename) of :meth:`to_json` to ``path``."""
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".fault-schedule-")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(self.to_json())
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def load(cls, path: str) -> "FaultSchedule":
        with open(path) as f:
            return cls.from_json(f.read())


@dataclass
class _Pending:
    """Auto-recovery bookkeeping (heap entry)."""

    step: int
    order: int
    event: FaultEvent

    def __lt__(self, other) -> bool:
        return (self.step, self.order) < (other.step, other.order)


class FaultInjector:
    """Replays a :class:`FaultSchedule` into a target, one clock tick per
    :meth:`on_step` call.

    The target is anything with ``apply_fault(event) -> str`` — the serving
    engine (device/link indices are ITS cluster indices) or the router
    (ORIGINAL cluster indices, routed to the owning replica).  Events whose
    ``duration`` is set enqueue their own ``recover`` that many ticks
    later.  Every application (and its status string) lands in :attr:`log`,
    so a chaos run leaves an audit trail next to the schedule that produced
    it.
    """

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.clock = 0
        self._cursor = 0
        self._auto: List[_Pending] = []
        self._order = 0
        self.log: List[Dict[str, Any]] = []

    @property
    def exhausted(self) -> bool:
        """True when no scheduled or pending event remains."""
        return self._cursor >= len(self.schedule.events) and not self._auto

    def _due(self) -> List[FaultEvent]:
        due: List[FaultEvent] = []
        evs = self.schedule.events
        while self._cursor < len(evs) and evs[self._cursor].step <= self.clock:
            due.append(evs[self._cursor])
            self._cursor += 1
        while self._auto and self._auto[0].step <= self.clock:
            due.append(heapq.heappop(self._auto).event)
        return due

    def on_step(self, target) -> List[FaultEvent]:
        """Fire every event due at the current tick into ``target``, then
        advance the clock.  Returns the events applied this tick."""
        applied: List[FaultEvent] = []
        for ev in self._due():
            status = target.apply_fault(ev)
            self.log.append({
                "clock": self.clock,
                "event": ev.to_dict(),
                "status": status,
            })
            applied.append(ev)
            if ev.duration is not None and ev.kind != "recover":
                rec = FaultEvent(
                    step=self.clock + ev.duration, kind="recover",
                    device=ev.device, link=ev.link,
                )
                heapq.heappush(self._auto, _Pending(rec.step, self._order, rec))
                self._order += 1
        self.clock += 1
        return applied

"""Adaptive-serving derate policy: observe → derate → replan, closed.

Moirai's placements come from a static cost model, but the premise of the
paper — heterogeneous devices with divergent effective speeds — means the
cluster the engine *observes* drifts from the cluster it *planned* for
(thermal throttling, co-tenant contention, a slow NIC…).  RL placers
(Placeto, Mirhoseini et al.) absorb drift by re-measuring real step times
every episode; MILP placers assume profiled costs hold.  This module lets
the repo keep the MILP's optimality while tracking reality: the serving
engine feeds per-device observed/predicted time ratios into a
:class:`DeratePolicy`, which decides when the evidence justifies cloning the
cluster with scaled device speeds (``ClusterSpec.with_derate``) and
re-planning under the configured objective.

The control loop, per observation window::

      executor stage times ──► straggler ratios ──► DerateCalibrator
                                                         │ per-device ratio
          replan(derate) ◄── new factor map ◄──── DeratePolicy.observe()

Stability comes from three mechanisms:

* **confirmation streaks** — a device must run out-of-band for
  ``confirm_windows`` (derate) / ``recover_windows`` (un-derate)
  *consecutive* windows before any action; transient noise resets the
  streak;
* **log-space EMA smoothing** — the applied factor divides by the smoothed
  ratio, not the latest sample, so a single spiky window cannot swing the
  model; successive derates converge geometrically onto the true speed;
* **a hysteresis deadband** — a proposed factor within ``hysteresis``
  (relative) of the current one is recorded as a ``hold`` and NOT applied,
  so ratios oscillating around the operating point never trigger replan
  churn.

Because the engine rebuilds its cost model from the derated cluster after
every replan, a correctly derated device's subsequent ratios return to ~1.0
— which is exactly the policy's fixed point.  Recovery is the same rule run
backwards: a derated device observed *faster* than its derated model
(ratio < ``recover_ratio``) for ``recover_windows`` windows gets its factor
raised (capped at 1.0), un-derating it.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

# decision/replan logs keep only this many recent entries (long-lived
# engines must not grow memory with uptime)
EVENT_LOG_KEEP = 4096


@dataclass(frozen=True)
class AdaptationConfig:
    """Knobs of the adaptive derate loop.

    Fields
    ------
    window_steps:
        Engine decode steps per observation window; every ``window_steps``
        steps the engine closes a window and runs the policy.  ``0`` (the
        default) disables automatic windows — observation happens only when
        ``ServingEngine.observe_window`` is called explicitly.
    trigger_ratio:
        A device whose fleet-normalized observed/predicted ratio is at or
        above this counts toward its derate confirmation streak (1.5 =
        "50% slower than the model says").
    confirm_windows:
        Consecutive out-of-band windows required before a derate is applied
        (the hysteresis count K).
    recover_ratio:
        A *derated* device observed at or below this ratio (faster than its
        derated model predicts) counts toward its recovery streak.
    recover_windows:
        Consecutive in-recovery windows required before the factor is
        raised back toward 1.0.
    hysteresis:
        Relative deadband: a proposed factor within ``hysteresis`` of the
        current factor is held, not applied — oscillating derates converge
        instead of thrashing replans.
    smoothing:
        EMA weight (in log space) on the newest window's ratio; 1.0 trusts
        each window fully, smaller values average over the streak.
    min_derate:
        Floor on any device's speed factor (a device is never modeled
        slower than ``min_derate``× nominal; below that, fail it instead).
    min_samples:
        Minimum observed stage samples inside a window for that stage to
        contribute evidence.
    state_path:
        Optional filesystem path for **derate-state persistence**: when set,
        the serving engine loads the policy's state (factors, EMAs, streaks,
        window counter) from this file at startup — so a restarted engine
        plans on the derated cluster it had already learned instead of
        rediscovering the drift from scratch — and rewrites the file after
        every observation window.  ``None`` (default) keeps state in-memory
        only.
    """

    window_steps: int = 0
    trigger_ratio: float = 1.5
    confirm_windows: int = 2
    recover_ratio: float = 0.8
    recover_windows: int = 2
    hysteresis: float = 0.15
    smoothing: float = 0.7
    min_derate: float = 0.05
    min_samples: int = 4
    state_path: Optional[str] = None

    def __post_init__(self):
        if self.trigger_ratio <= 1.0:
            raise ValueError("trigger_ratio must be > 1")
        if not 0.0 < self.recover_ratio < 1.0:
            raise ValueError("recover_ratio must be in (0, 1)")
        if self.confirm_windows < 1 or self.recover_windows < 1:
            raise ValueError("confirmation windows must be >= 1")
        if not 0.0 < self.smoothing <= 1.0:
            raise ValueError("smoothing must be in (0, 1]")
        if not 0.0 < self.min_derate <= 1.0:
            raise ValueError("min_derate must be in (0, 1]")
        if self.hysteresis < 0.0:
            raise ValueError("hysteresis must be >= 0")
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        if self.window_steps < 0:
            raise ValueError("window_steps must be >= 0 (0 disables auto windows)")
        if 0 < self.window_steps < self.min_samples:
            # every auto-closed window would drain fewer than min_samples
            # stage samples, so the evidence filter would silently discard
            # every window — adaptation would look on but never act
            raise ValueError(
                f"window_steps={self.window_steps} < min_samples="
                f"{self.min_samples}: automatic windows would never carry "
                "enough samples to act on; raise window_steps or lower "
                "min_samples"
            )


@dataclass
class AdaptationEvent:
    """One entry of the adaptation decision log.

    ``action`` is one of ``"derate"`` (factor lowered), ``"underate"``
    (factor raised toward 1.0 on recovery), ``"hold"`` (streak confirmed
    but the proposed factor fell inside the hysteresis deadband), or
    ``"replan"`` (a window's accepted factor changes were committed and a
    re-placement was requested).  ``device`` is a device index, a
    ``(src, dst)`` tuple for CHANNEL decisions (a degraded link's bandwidth
    factor moving), or -1 for cluster-wide events (replan).  ``ratio`` is
    the fleet-normalized observed/predicted ratio that drove the decision.
    """

    window: int
    device: object
    action: str
    ratio: float = float("nan")
    old_factor: float = 1.0
    new_factor: float = 1.0
    reason: str = ""


def _key_sort(k: object):
    """Deterministic ordering over mixed device (int) / channel (tuple)
    keys: devices first, then channels, each ascending."""
    return (1, tuple(k)) if isinstance(k, tuple) else (0, (k,))


def _key_to_str(k: object) -> str:
    """JSON-safe key: ``"3"`` for device 3, ``"1-4"`` for channel (1, 4)."""
    return f"{k[0]}-{k[1]}" if isinstance(k, tuple) else str(k)


def _key_from_str(s: str) -> object:
    if "-" in s:
        a, b = s.split("-", 1)
        return (int(a), int(b))
    return int(s)


class DeratePolicy:
    """Streak/hysteresis controller mapping window ratios to derate maps.

    Feed one :meth:`observe` call per observation window with the
    fleet-normalized observed/predicted ratio of every device seen that
    window.  The return value is ``None`` ("keep serving, no replan") or a
    complete device → speed-factor map to re-plan with.  Every decision —
    including holds — is appended to :attr:`events` (bounded to the most
    recent :data:`EVENT_LOG_KEEP` entries so a long-lived engine cannot
    accumulate an unbounded log).

    Keys are device indices (ints) OR ``(src, dst)`` channel tuples: the
    same streak/EMA/hysteresis machinery governs per-device speed factors
    and per-link bandwidth factors — a comm-heavy stage boundary running
    consistently slow derates the connecting CHANNEL, and the replan routes
    tensor flows around the degraded interconnect
    (``ClusterSpec.with_derate(links=...)``) instead of slowing both
    endpoint devices in the model.
    """

    def __init__(self, config: Optional[AdaptationConfig] = None):
        self.config = config or AdaptationConfig()
        # device (int) or channel (tuple) -> current speed/bandwidth factor
        self.factors: Dict[object, float] = {}
        self.events: List[AdaptationEvent] = []
        self.windows = 0
        # devices confirmed DEAD (hard failures) — persisted alongside the
        # derate state so a restarted engine plans without them instead of
        # replanning on the full cluster (the caller syncs this list)
        self.failed_devices: List[int] = []
        self._ema: Dict[object, float] = {}   # key -> log-space EMA of ratio
        self._hi: Dict[object, int] = {}      # consecutive slow windows
        self._lo: Dict[object, int] = {}      # consecutive recovered windows

    # ------------------------------------------------------------------
    def _log(self, event: AdaptationEvent) -> None:
        self.events.append(event)
        if len(self.events) > EVENT_LOG_KEEP:
            del self.events[: len(self.events) - EVENT_LOG_KEEP]

    # ------------------------------------------------------------------
    def factor(self, device: int) -> float:
        """Current modeled speed factor of ``device`` (1.0 = nominal)."""
        return self.factors.get(device, 1.0)

    def derate_map(self) -> Dict[int, float]:
        """DEVICES currently modeled below nominal speed ({} when none)."""
        return {
            d: f
            for d, f in self.factors.items()
            if f < 1.0 and not isinstance(d, tuple)
        }

    def link_derate_map(self) -> Dict[tuple, float]:
        """CHANNELS currently modeled below nominal bandwidth: ``(src,
        dst)`` → factor, for ``ClusterSpec.with_derate(links=...)``."""
        return {
            c: f
            for c, f in self.factors.items()
            if f < 1.0 and isinstance(c, tuple)
        }

    def forget(self, device: int) -> None:
        """Drop all state for ``device`` (factor, EMA, streaks) — called
        when the device leaves the cluster (hard failure), so later commits
        cannot resurrect its derate.  Channels touching the device go with
        it: a link to a dead endpoint no longer exists to derate."""
        keys = [device] + [
            c
            for c in set(self.factors) | set(self._ema) | set(self._hi) | set(self._lo)
            if isinstance(c, tuple) and device in c
        ]
        for k in keys:
            self.factors.pop(k, None)
            self._ema.pop(k, None)
            self._hi.pop(k, None)
            self._lo.pop(k, None)

    # ------------------------------------------------- persistence
    def to_json(self) -> str:
        """Serialize the policy's RESUMABLE state — factors, log-space EMAs,
        confirmation streaks, and the window counter — as a JSON string.

        The decision log (:attr:`events`) is deliberately excluded: it is
        observability, not control state, and can grow to thousands of
        entries.  Round trip with :meth:`from_json`.

        Version 2 adds channel keys (``"src-dst"``) and the
        ``failed_devices`` list — hard failures persist WITH the derates,
        so an engine restarted from this state excludes dead devices from
        its first plan instead of replanning on the full cluster."""
        return json.dumps({
            "version": 2,
            "windows": self.windows,
            "failed_devices": sorted(int(d) for d in self.failed_devices),
            "factors": {_key_to_str(d): f for d, f in self.factors.items()},
            "ema": {_key_to_str(d): e for d, e in self._ema.items()},
            "hi": {_key_to_str(d): n for d, n in self._hi.items()},
            "lo": {_key_to_str(d): n for d, n in self._lo.items()},
        })

    @classmethod
    def from_json(
        cls, payload: str, config: Optional[AdaptationConfig] = None
    ) -> "DeratePolicy":
        """Rebuild a policy from :meth:`to_json` output.

        ``config`` supplies the (non-serialized) knobs — the persisted state
        is control state only, so a restarted engine may resume the learned
        derates under different thresholds.  Reads version 1 (device-only)
        and version 2 (channel keys + failed devices) payloads; raises
        ``ValueError`` on anything else."""
        data = json.loads(payload)
        if not isinstance(data, dict) or data.get("version") not in (1, 2):
            raise ValueError(
                f"unsupported DeratePolicy state payload: {payload[:80]!r}"
            )
        pol = cls(config)
        pol.windows = int(data.get("windows", 0))
        pol.failed_devices = [int(d) for d in data.get("failed_devices", [])]
        pol.factors = {
            _key_from_str(d): float(f) for d, f in data.get("factors", {}).items()
        }
        pol._ema = {
            _key_from_str(d): float(e) for d, e in data.get("ema", {}).items()
        }
        pol._hi = {
            _key_from_str(d): int(n) for d, n in data.get("hi", {}).items()
        }
        pol._lo = {
            _key_from_str(d): int(n) for d, n in data.get("lo", {}).items()
        }
        return pol

    def save(self, path: str) -> None:
        """Atomically write :meth:`to_json` to ``path`` (tmp file + rename,
        so a crash mid-write can never leave a truncated state file)."""
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".derate-state-")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(self.to_json())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def load(
        cls, path: str, config: Optional[AdaptationConfig] = None
    ) -> "DeratePolicy":
        """Read a policy back from :meth:`save` output."""
        with open(path) as f:
            return cls.from_json(f.read(), config)

    # ------------------------------------------------------------------
    def observe(self, ratios: Mapping[int, float]) -> Optional[Dict[int, float]]:
        """Close one observation window.

        Args:
            ratios: device index (int) or channel ``(src, dst)`` tuple →
                fleet-normalized observed/predicted time ratio for this
                window (1.0 = the resource behaves exactly as the *current*
                — possibly already derated — cost model predicts).
                Non-finite / non-positive entries are ignored; keys absent
                from the map keep their streaks (no evidence ≠
                counter-evidence).

        Returns:
            ``None`` when no model change is warranted, else the complete
            factor map (devices AND channels below nominal) to re-plan the
            cluster with — split it with :meth:`derate_map` /
            :meth:`link_derate_map`.  Callers must treat a non-``None``
            return as "the cost model changed": re-plan, rebuild
            predictions, and keep feeding windows.
        """
        cfg = self.config
        self.windows += 1
        changed: Dict[object, float] = {}
        for dev, ratio in sorted(ratios.items(), key=lambda kv: _key_sort(kv[0])):
            if not (ratio > 0.0 and math.isfinite(ratio)):
                continue
            cur = self.factors.get(dev, 1.0)
            ema_prev = self._ema.get(dev)
            log_r = math.log(ratio)
            ema = (
                log_r
                if ema_prev is None
                else cfg.smoothing * log_r + (1.0 - cfg.smoothing) * ema_prev
            )
            self._ema[dev] = ema

            if ratio >= cfg.trigger_ratio:
                self._hi[dev] = self._hi.get(dev, 0) + 1
                self._lo[dev] = 0
            elif cur < 1.0 and ratio <= cfg.recover_ratio:
                self._lo[dev] = self._lo.get(dev, 0) + 1
                self._hi[dev] = 0
            else:
                self._hi[dev] = 0
                self._lo[dev] = 0
                continue

            slow = self._hi.get(dev, 0) >= cfg.confirm_windows
            recovered = self._lo.get(dev, 0) >= cfg.recover_windows
            if not (slow or recovered):
                continue
            proposed = min(1.0, max(cfg.min_derate, cur / math.exp(ema)))
            # direction clamp: the EMA may carry samples from before the
            # streak flipped (e.g. one unconfirmed spike right before a
            # genuine recovery) — a confirmed-slow commit must never RAISE
            # the factor, a confirmed-recovery commit must never LOWER it
            proposed = min(proposed, cur) if slow else max(proposed, cur)
            if proposed * (1.0 + cfg.hysteresis) >= 1.0:
                # within the deadband of nominal: fully un-derate rather
                # than carrying a ~1.0 factor (and its replans) forever
                proposed = 1.0
            if abs(math.log(max(proposed, 1e-12) / cur)) < math.log1p(cfg.hysteresis):
                self._log(AdaptationEvent(
                    window=self.windows, device=dev, action="hold",
                    ratio=ratio, old_factor=cur, new_factor=cur,
                    reason="proposed factor inside hysteresis deadband",
                ))
                self._hi[dev] = 0
                self._lo[dev] = 0
                continue
            self._log(AdaptationEvent(
                window=self.windows, device=dev,
                action="derate" if slow else "underate",
                ratio=ratio, old_factor=cur, new_factor=proposed,
                reason=(
                    f"{self._hi.get(dev, 0)} consecutive windows >= "
                    f"{cfg.trigger_ratio}x"
                    if slow
                    else f"{self._lo.get(dev, 0)} consecutive windows <= "
                         f"{cfg.recover_ratio}x"
                ),
            ))
            changed[dev] = proposed

        if not changed:
            return None
        for dev, f in changed.items():
            self.factors[dev] = f
            # the model just moved under this resource: stale evidence is void
            self._ema.pop(dev, None)
            self._hi[dev] = 0
            self._lo[dev] = 0
        new_map = {**self.derate_map(), **self.link_derate_map()}
        self._log(AdaptationEvent(
            window=self.windows, device=-1, action="replan",
            reason="committed factors for "
                   f"{sorted(changed, key=_key_sort)}; "
                   f"derate map now {new_map}",
        ))
        return new_map

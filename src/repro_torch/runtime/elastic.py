"""Fault tolerance at 1000+-node scale: heartbeats, stragglers, re-meshing.

SAKURAONE operates 100 nodes under Slurm with shared-Lustre checkpoints;
the recovery contract this module provides is the same one scaled up:

  - ``HeartbeatMonitor``: miss a deadline -> the node is dead.
  - ``StragglerDetector``: per-host step-time EWMA; hosts slower than
    k× the cluster median get their shards re-assigned (backup workers).
  - ``plan_remesh``: given survivors, the largest valid (pod, data, model)
    mesh — model groups must stay whole (TP members are not substitutable),
    so capacity drops in units of whole model groups; training restores
    from the last committed checkpoint onto the new mesh (elastic restore).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple


class HeartbeatMonitor:
    def __init__(self, timeout_s: float = 30.0):
        self.timeout = timeout_s
        self._last: Dict[str, float] = {}

    def register(self, host: str, now: Optional[float] = None):
        self._last[host] = time.monotonic() if now is None else now

    def beat(self, host: str, now: Optional[float] = None):
        if host not in self._last:
            raise KeyError(f"unregistered host {host}")
        self._last[host] = time.monotonic() if now is None else now

    def dead(self, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout)

    def alive(self, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t <= self.timeout)

    def evict(self, host: str):
        self._last.pop(host, None)


class StragglerDetector:
    """EWMA of per-host step times; flag hosts beyond `ratio`× the median."""

    def __init__(self, alpha: float = 0.3, ratio: float = 1.5,
                 min_samples: int = 3):
        self.alpha = alpha
        self.ratio = ratio
        self.min_samples = min_samples
        self._ewma: Dict[str, float] = {}
        self._n: Dict[str, int] = {}

    def record(self, host: str, step_time_s: float):
        prev = self._ewma.get(host)
        self._ewma[host] = (step_time_s if prev is None
                            else self.alpha * step_time_s + (1 - self.alpha) * prev)
        self._n[host] = self._n.get(host, 0) + 1

    def stragglers(self) -> List[str]:
        ready = {h: v for h, v in self._ewma.items()
                 if self._n[h] >= self.min_samples}
        if len(ready) < 2:
            return []
        vals = sorted(ready.values())
        median = vals[len(vals) // 2]
        return sorted(h for h, v in ready.items() if v > self.ratio * median)


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    hosts_used: Tuple[str, ...]
    hosts_idle: Tuple[str, ...]
    dropped_capacity_frac: float


def plan_remesh(survivors: Sequence[str], devices_per_host: int,
                model_parallel: int, *, num_pods: int = 2,
                multi_pod: bool = True) -> RemeshPlan:
    """Largest (pod, data, model) mesh from surviving hosts.

    Model-parallel groups must be whole; the data axis shrinks to what the
    survivors support.  If fewer than one whole model group per pod
    survives, the pod axis collapses to single-pod.
    """
    survivors = sorted(survivors)
    total = len(survivors) * devices_per_host
    if total < model_parallel:
        raise RuntimeError(
            f"{total} surviving devices < model_parallel={model_parallel}; "
            "cannot form even one model group")
    groups = total // model_parallel
    pods = num_pods if (multi_pod and groups >= num_pods) else 1
    data = groups // pods
    used_devices = pods * data * model_parallel
    used_hosts = used_devices // devices_per_host
    shape = (pods, data, model_parallel) if pods > 1 else (data, model_parallel)
    names = ("pod", "data", "model") if pods > 1 else ("data", "model")
    return RemeshPlan(
        mesh_shape=shape, axis_names=names,
        hosts_used=tuple(survivors[:used_hosts]),
        hosts_idle=tuple(survivors[used_hosts:]),
        dropped_capacity_frac=1.0 - used_devices / max(total, 1),
    )


@dataclasses.dataclass
class FailureEvent:
    step: int
    kind: str          # 'dead' | 'straggler'
    hosts: Tuple[str, ...]
    action: str        # 'remesh' | 'reassign_shards'


class ElasticCoordinator:
    """Glue: monitors -> events -> remesh/reassign decisions.

    Drives the recovery loop in launch/train.py: on death, training stops,
    a new mesh is planned from survivors, state restores from the last
    committed checkpoint, and the data pipeline resumes at the restored
    step (determinism makes the replay exact).
    """

    def __init__(self, hosts: Sequence[str], devices_per_host: int,
                 model_parallel: int, *, timeout_s: float = 30.0,
                 num_pods: int = 2):
        self.hb = HeartbeatMonitor(timeout_s)
        self.straggle = StragglerDetector()
        self.devices_per_host = devices_per_host
        self.model_parallel = model_parallel
        self.num_pods = num_pods
        self.events: List[FailureEvent] = []
        for h in hosts:
            self.hb.register(h)

    def check(self, step: int, now: Optional[float] = None) -> Optional[RemeshPlan]:
        dead = self.hb.dead(now)
        if dead:
            for h in dead:
                self.hb.evict(h)
            plan = plan_remesh(self.hb.alive(now), self.devices_per_host,
                               self.model_parallel, num_pods=self.num_pods)
            self.events.append(FailureEvent(step, "dead", tuple(dead), "remesh"))
            return plan
        lag = self.straggle.stragglers()
        if lag:
            self.events.append(
                FailureEvent(step, "straggler", tuple(lag), "reassign_shards"))
        return None

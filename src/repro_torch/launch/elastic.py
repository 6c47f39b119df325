"""Elastic mesh planning and straggler detection.

The port's copy of `repro.launch.elastic` without ``build_mesh`` (a device
mesh is the multi-card slice's).  ``plan_mesh`` shrinks the data/pod axes
to the largest supported configuration on the surviving devices, keeping
the model axis.  ``StragglerWatchdog`` tracks an EMA of step time; a
sustained regression beyond ``threshold`` x flags a straggler event (the
deployment policy is checkpoint -> evict -> elastic restart).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

SUPPORTED_DP = (32, 16, 8, 4, 2, 1)  # data-axis sizes we can shrink to


@dataclasses.dataclass
class ElasticPlan:
    mesh_shape: tuple
    axis_names: tuple
    n_devices: int
    dropped: int


def plan_mesh(available_devices: int, *, model: int = 16,
              multi_pod: bool = False) -> ElasticPlan:
    """Largest supported mesh from the surviving device count.

    The model axis is preserved (TP degree is baked into layer shardings);
    elasticity happens on the data/pod axes.
    """
    per_pod = available_devices if not multi_pod else available_devices // 2
    usable_dp = 0
    for dp in SUPPORTED_DP:
        if dp * model <= per_pod:
            usable_dp = dp
            break
    if usable_dp == 0:
        raise RuntimeError(
            f"{available_devices} devices cannot host model axis {model}"
        )
    if multi_pod:
        shape = (2, usable_dp, model)
        names = ("pod", "data", "model")
        used = 2 * usable_dp * model
    else:
        shape = (usable_dp, model)
        names = ("data", "model")
        used = usable_dp * model
    return ElasticPlan(shape, names, used, available_devices - used)


@dataclasses.dataclass
class StragglerWatchdog:
    """EMA step-time monitor; flags sustained slowdowns."""

    alpha: float = 0.1
    threshold: float = 1.8
    patience: int = 5
    warmup: int = 10

    _ema: Optional[float] = None
    _strikes: int = 0
    _steps: int = 0
    events: List[dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, step_time_s: float) -> bool:
        """Returns True if a straggler event fires at this step."""
        self._steps += 1
        if self._ema is None:
            self._ema = step_time_s
            return False
        fired = False
        if (self._steps > self.warmup
                and step_time_s > self.threshold * self._ema):
            self._strikes += 1
            if self._strikes >= self.patience:
                fired = True
                self.events.append({
                    "step": step, "step_time": step_time_s,
                    "ema": self._ema, "action": "checkpoint+evict+restart",
                })
                self._strikes = 0
        else:
            self._strikes = 0
            # only fold healthy steps into the EMA
            self._ema = (1 - self.alpha) * self._ema + self.alpha * step_time_s
        return fired

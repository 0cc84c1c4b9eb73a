"""Averager factory.  Counterpart of ``repro/core/baselines.py``, of which
only the paper's own averager, ``"wagma"``, is ported; the comparison set
(allreduce, local SGD, D-PSGD, SGP, AD-PSGD, Eager-SGD) belongs to the
baselines slice."""

from __future__ import annotations

from repro_torch.core.replica import REPLICATED

BASELINES = ("allreduce", "local_sgd", "dpsgd", "sgp", "adpsgd", "eager_sgd")
BASELINES_SLICE = "the baselines slice of the port (ROADMAP.md, slice 5)"


def make_averager(name: str, dp_axis_names, dp_axis_sizes, **kw):
    from repro_torch.core.wagma import WagmaAverager, WagmaConfig
    name = name.lower()
    if name == "wagma":
        topology = kw.pop("topology", None)
        sharding = kw.pop("sharding", REPLICATED)
        cfg = WagmaConfig(**kw) if kw else WagmaConfig()
        return WagmaAverager(dp_axis_names, dp_axis_sizes, cfg,
                             topology=topology, sharding=sharding)
    if name in BASELINES:
        raise NotImplementedError(
            f"averager {name!r} is not ported yet; it belongs to "
            f"{BASELINES_SLICE}")
    raise ValueError(f"unknown averager {name!r}; options: "
                     f"{['wagma'] + sorted(BASELINES)}")

"""Plug-in scheduling-algorithm API (paper §4.3 "Plug-in Algorithm API").

Copy of ``repro/core/plugin.py``: the same re-export, of the port's
autoscaler registry.

Re-exported from the autoscaler: register a custom cluster-level scaler by
name and select it via ``ClusterBrain(scaler=<name>)``.

    from repro_torch.core.plugin import register_scaler

    @register_scaler("my_scaler")
    def my_scaler(jobs, capacity):
        return {job.job_id: job.current for job in jobs}
"""
from repro_torch.core.autoscaler import (  # noqa: F401
    ScalerFn, get_scaler, list_scalers, register_scaler,
)

"""repro_torch.obs — the observation law on the port (the counterpart of
``repro.obs``).

Four pieces:

* :mod:`repro_torch.obs.trace` — host-side span tracer over the drive entry
  points; Chrome/Perfetto ``trace_event`` export; ``RAFI_TRACE`` toggle.
* :mod:`repro_torch.obs.metrics` — typed counter/gauge snapshots per burst
  from the telemetry the drive already returns; Prometheus text and JSON.
* :mod:`repro_torch.obs.phases` — per-stage timing of one forwarding round,
  each stage a standalone call over the production primitives.
* :mod:`repro_torch.obs.report` — the flight-data analyzer
  (``python -m repro_torch.obs.report capture.json``).

``trace`` and ``metrics`` import eagerly (the core hooks the tracer);
``phases`` and ``report`` pull in ``repro_torch.core`` /
``repro_torch.roofline`` and load lazily on first attribute access.
"""
from repro_torch.obs import metrics, trace

__all__ = ["metrics", "phases", "report", "trace"]


def __getattr__(name):
    if name in ("phases", "report"):
        import importlib

        mod = importlib.import_module(f"repro_torch.obs.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")

"""repro_torch.obs — the observation law on the port.

Only :mod:`repro_torch.obs.trace` is ported so far: the host-side span
tracer that ``RafiContext.run_until_done`` and ``tune.autotune_forward``
open their spans through, with the reference's Perfetto export and
``RAFI_TRACE`` toggle.  ``metrics``, ``report`` and ``phases`` are queued
(ROADMAP.md Queue 1 item 14).
"""
from repro_torch.obs import trace

__all__ = ["trace"]

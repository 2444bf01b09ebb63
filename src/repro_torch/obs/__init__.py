"""Observability and measurement tools of the PyTorch port.

* :mod:`repro_torch.obs.trace`: the span tracer, Chrome/Perfetto export
  (``aam-trace/v1``) and ``validate_trace``;
* :mod:`repro_torch.obs.metrics`: counters, gauges and log-bucket
  histograms with Prometheus text and ``aam-metrics/v1`` snapshots;
* :mod:`repro_torch.obs.wavetap`: the per-commit and per-round taps,
  installed only when ``REPRO_TRACE=1`` or ``CommitSpec(trace=True)``;
* ``python -m repro_torch.obs.dump``: the mixed-tenant serving trace
  demo (:mod:`repro_torch.obs.dump`);
* device-time breakdowns on the card: ``round_profile``,
  ``serve_profile``, ``commit_profile``, ``ssd_profile`` and their timer
  ``timing``.

Importing this package loads no CUDA code.
"""
from repro_torch.obs.trace import (Tracer, get_tracer, set_tracer,  # noqa: F401
                                   trace_enabled, validate_trace)
from repro_torch.obs.metrics import (Registry, validate_metrics_json,  # noqa: F401
                                     METRICS_SCHEMA)
from repro_torch.obs import wavetap  # noqa: F401

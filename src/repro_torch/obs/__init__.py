"""Observability of the port (counterpart of ``repro.obs``): host-side
tracing and metrics, both off by default and free when off.

* :mod:`repro_torch.obs.trace` — span/event recorder writing Chrome
  trace JSON (Perfetto) on the profiler's clock; each span is also a
  ``torch.profiler`` range, so device activity nests under the protocol
  spans and the LM path's (``prefill_step``, ``decode_step``,
  ``attention``, ``mlp``, ``moe_ffn``);
* :mod:`repro_torch.obs.metrics` — counters, gauges and fixed-bucket
  latency histograms the scheduler and the checkpointer publish into;
* :mod:`repro_torch.obs.roundtrace` — an engine driven one wire round
  at a time, each round's wire bits from state-counter deltas, held to
  the Theorem 4.1 ledger bit for bit.

``roundtrace`` imports ``repro_torch.core.ledger``; import it as
``from repro_torch.obs import roundtrace`` where it is used, so the
engines' own import of ``obs.trace`` never cycles.
"""

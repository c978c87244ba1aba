"""tpu-lint over the port: the project's own static analysis.

The node daemon and the scheduler extender run a dozen long-lived threads
whose invariants (every long-lived loop supervised and heartbeated, every
metric family, flight kind, ledger kind, span and ``/debug`` surface
documented, no blocking work under a hot lock, every API-server hop through
the resilience wrapper) would otherwise rest on review alone. This package
checks them on the port's tree, with the JAX package's rule ids, so that
``docs/analysis.md`` describes both:

* :mod:`registry_scan`: the one source of truth for what the code
  registers, records and serves, and what the docs document. AST
  inventories of flight and ledger kinds, span names, metric families,
  heartbeat loop names and ``/debug`` endpoints, each with its file and
  line, and the doc-side parsers. The docs are the shared operator docs
  (``docs/<name>``: the port keeps the JAX family, kind and endpoint names,
  so they describe both planes) followed by the port's addendum
  (``docs/torch/<name>``), which holds only what the port alone has.
* :mod:`rules`: the rule engine behind ``python -m
  k8s_device_plugin_tpu_torch.tools.lint``: eleven rules (TPL001-TPL011),
  the port's checked-in baseline (``baseline.json``, every entry with its
  justification) and ``# tpu-lint: disable=<RULE>`` inline suppressions.

The runtime half, the lock-order graph of ``utils/profiling`` and the
``lock_order`` and ``loop_inventory`` audit invariants, lives in
``utils/profiling.py`` and ``audit.py``.

Nothing here imports ``torch`` or ``jax``: the audit loads it inside the
node daemon and the extender.
"""

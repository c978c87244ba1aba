"""The environment names of the JAX package's ``api/constants.py`` that the
node layers of the port read. The rest of that module comes with the
plugin server."""

# Understood as the reference's DP_DISABLE_HEALTHCHECKS: a comma-separated
# list of check classes to disable. Classes: "all", "events" (the XID
# event wait; "xids", the reference's spelling, is an alias), "interval"
# (periodic sweeps). See health/watcher.py.
ENV_DISABLE_HEALTHCHECKS = "DP_DISABLE_HEALTHCHECKS"

# Override of the app-level fault-reason skip list (the reference's XID
# 31/43/45 skip). Comma-separated reason tokens; see health/watcher.py
# DEFAULT_APP_FAULT_REASONS for the default.
ENV_APP_FAULT_REASONS = "DP_APP_FAULT_REASONS"

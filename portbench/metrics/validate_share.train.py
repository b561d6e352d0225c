"""Share (%) of the training window's wall time spent inside
``CplMixVAE.validate`` (the orchestrator's validation), from the
benchmark's own host-clock spans around those calls."""


def read(r):
    if "validate_s" not in r.host or r.host.get("window_s", 0) <= 0:
        return None
    return 100.0 * r.host["validate_s"] / r.host["window_s"]

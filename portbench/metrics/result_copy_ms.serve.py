"""Device time (ms) of the device-to-host copies of ``eval_model``'s
results per 1,000 cells served, over the profiled requests."""


def read(r):
    cells = r.host.get("slice_served_cells", 0)
    if r.slice is None or cells <= 0:
        return None
    copies = [d for d in r.slice.events_in("request", ("gpu_memcpy",))
              if "DtoH" in d["name"] or "Device -> " in d["name"]]
    if not copies:
        return None
    return sum(d["dur"] for d in copies) / 1e3 / (cells / 1e3)

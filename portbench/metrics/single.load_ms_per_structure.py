"""ms of load_file + system_to_molecule a request, over the span window."""


def read(r):
    d = r.get("driver", {})
    done = r.get("span_units", {}).get("structures")
    return 1e3 * d["load_s"] / done if done and "load_s" in d else None

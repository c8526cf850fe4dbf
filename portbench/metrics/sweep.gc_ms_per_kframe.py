"""ms the cyclic garbage collector ran a thousand frames, over the span window."""


def read(r):
    done = r.get("span_units", {}).get("frames")
    if not done or "spans" not in r:
        return None
    return r["gc"].get("seconds", 0.0) * 1e6 / done

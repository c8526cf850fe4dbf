"""ms the device was busy in the traced requests, a request."""


def read(r):
    t = r.get("trace")
    done = t and t["units"].get("structures")
    return 1e3 * t["busy_s"] / done if done and t["busy_s"] > 0 else None

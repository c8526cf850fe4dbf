"""Device kernels in the traced requests, a request."""


def read(r):
    t = r.get("trace")
    done = t and t["units"].get("structures")
    return t["kernels"] / done if done and t["kernels"] else None

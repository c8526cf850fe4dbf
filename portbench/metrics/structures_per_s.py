"""Single structures loaded and analysed over the window's seconds."""


def read(r):
    n = r["units"].get("structures")
    return n / r["window_s"] if n else None

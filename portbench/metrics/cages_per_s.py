"""Cages rebuilt and analysed over the window's seconds."""


def read(r):
    n = r["units"].get("cages")
    return n / r["window_s"] if n else None

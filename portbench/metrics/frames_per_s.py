"""Frames analysed, file to dicts, over the window's seconds."""


def read(r):
    n = r["units"].get("frames")
    return n / r["window_s"] if n else None

"""A seeded DL_POLY HISTORY (keytrj 0, imcon 0) of moved fixture frames,
formatted with torch in fixed-size frames, and a plain reader of its
frames by position."""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from portbench.inputs import fixtures, seeded

#: frames formatted at once (a block of ~14 MB for the CC3 fixture)
BLOCK = 1024
_TIMESTEP = "timestep{:10d}{:10d}{:10d}{:10d}{:12.6f}\n"
_DIGITS = torch.tensor([10**4, 10**3, 10**2, 10, 1], dtype=torch.int64)


@dataclasses.dataclass(frozen=True)
class History:
    """A written HISTORY: its path, the atom keys, the byte layout (header
    bytes, bytes a frame) and the coordinates as written (frames, atoms,
    3), float64 values of the printed digits."""

    path: pathlib.Path
    keys: np.ndarray
    header_bytes: int
    frame_bytes: int
    coords: np.ndarray
    source: np.ndarray

    @property
    def n_frames(self) -> int:
        return self.coords.shape[0]


def e12_4(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``%12.4E`` of float64 ``values`` (n,) as (n, 12) ASCII bytes (uint8),
    and the values those digits print (mantissa x 10^exponent, float64),
    on the values' device."""
    a = values.abs()
    e = torch.floor(torch.log10(torch.where(a > 0, a, 1.0))).to(torch.int64)
    m = torch.round(a * torch.pow(10.0, (4 - e).to(a.dtype)))
    for fix in (m >= 1e5, (m < 1e4) & (a > 0)):
        e = torch.where(fix, e + torch.where(m >= 1e5, 1, -1), e)
        m = torch.where(fix, torch.round(a * torch.pow(10.0, (4 - e).to(a.dtype))), m)
    m = m.to(torch.int64)
    e = torch.where(m == 0, 0, e)
    if int(e.abs().max()) > 99:
        msg = "a coordinate needs a three-digit exponent"
        raise ValueError(msg)
    digits = (m[:, None] // _DIGITS.to(m.device)) % 10
    ae = e.abs()
    zero = ord("0")
    cols = [
        torch.full_like(m, ord(" ")),
        torch.where(values < 0, ord("-"), ord(" ")),
        zero + digits[:, 0],
        torch.full_like(m, ord(".")),
        zero + digits[:, 1],
        zero + digits[:, 2],
        zero + digits[:, 3],
        zero + digits[:, 4],
        torch.full_like(m, ord("E")),
        torch.where(e < 0, ord("-"), ord("+")),
        zero + ae // 10,
        zero + ae % 10,
    ]
    out = torch.stack(cols, -1).to(torch.uint8)
    sign = torch.where(values < 0, -1.0, 1.0).to(values.dtype)
    return out, sign * m.to(values.dtype) * torch.pow(10.0, (e - 4).to(values.dtype))


def _int10(values: np.ndarray) -> np.ndarray:
    """``%10d`` of non-negative int64 ``values`` (n,) as (n, 10) bytes."""
    s = np.char.rjust(values.astype(str), 10)
    return np.frombuffer(s.astype("S10").tobytes(), dtype=np.uint8).reshape(-1, 10)


def write(
    path: pathlib.Path, n_frames: int, seed: int, fixture: str, shift: float,
    device: torch.device | str,
) -> History:
    """Write ``n_frames`` frames of ``fixture`` (moved as
    :func:`seeded.moved_frames` says) to ``path``, formatted on
    ``device``; every frame has the same byte size, so frame k starts at
    ``header_bytes + k * frame_bytes``."""
    header, atom_lines, source = fixtures.history(fixture)
    natms = len(atom_lines)
    frames, which = seeded.moved_frames(
        seeded.rng(seed, 1), torch.as_tensor(source, device=device), n_frames, shift
    )
    head = ("\n".join(header) + "\n").encode()
    ts = _TIMESTEP.format(0, natms, 0, 0, 0.0007).encode()
    parts, cols, at = [ts], [], len(ts)
    for line in atom_lines:
        rec = (line + "\n").encode()
        parts.append(rec)
        at += len(rec)
        cols.append(np.arange(at, at + 36))
        parts.append(b" " * 36 + b"\n")
        at += 37
    template = torch.frombuffer(bytearray(b"".join(parts)), dtype=torch.uint8).to(device)
    cols = torch.as_tensor(np.concatenate(cols), device=device)
    step_cols = slice(len("timestep"), len("timestep") + 10)
    printed = torch.empty_like(frames)
    with path.open("wb") as fh:
        fh.write(head)
        for lo in range(0, n_frames, BLOCK):
            hi = min(lo + BLOCK, n_frames)
            buf = template.repeat(hi - lo, 1)
            chars, vals = e12_4(frames[lo:hi].reshape(-1))
            buf[:, cols] = chars.reshape(hi - lo, -1)
            host = buf.cpu().numpy()
            host[:, step_cols] = _int10(25 * np.arange(lo + 1, hi + 1))
            printed[lo:hi] = vals.reshape(hi - lo, natms, 3)
            fh.write(host.tobytes())
    return History(
        path=path, keys=fixtures.atom_keys(atom_lines), header_bytes=len(head),
        frame_bytes=template.numel(), coords=printed.cpu().numpy(), source=which,
    )


def read_frames(hist: History, idxs) -> list[np.ndarray]:
    """The coordinates (atoms, 3) float64 of frames ``idxs``, parsed from
    the file's text."""
    out = []
    with hist.path.open("rb") as fh:
        for k in idxs:
            fh.seek(hist.header_bytes + int(k) * hist.frame_bytes)
            lines = fh.read(hist.frame_bytes).decode().splitlines()
            out.append(np.array([[float(v) for v in ln.split()] for ln in lines[2::2]]))
    return out

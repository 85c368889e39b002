"""deal.II `Vector<double>::block_write` / `block_read` binary compatibility.

The reference checkpoints every state vector in this format (restart
`source/bem_stokes.cc:5264-5327`, composer `:5985-6009`, squirmer input
velocities `:2124-2133`).  The on-disk layout written by deal.II is:

    <size as ASCII decimal> '\n' '[' <size * 8 bytes of little-endian f64> ']'

so the files are self-describing and cheap to parse with numpy.
"""

from __future__ import annotations

import numpy as np


def block_write(path: str, values: np.ndarray) -> None:
    """Write a 1-D float64 vector in deal.II block_write format."""
    v = np.ascontiguousarray(np.asarray(values, dtype=np.float64).reshape(-1))
    with open(path, "wb") as f:
        f.write(f"{v.size}\n[".encode("ascii"))
        f.write(v.tobytes())
        f.write(b"]")


def block_read(path: str) -> np.ndarray:
    """Read a deal.II block_write file -> float64 [size] array."""
    with open(path, "rb") as f:
        header = b""
        while True:
            c = f.read(1)
            if not c:
                raise ValueError(f"{path}: truncated block_write header")
            if c == b"[":
                break
            header += c
        size = int(header.strip())
        data = np.frombuffer(f.read(8 * size), dtype="<f8")
        if data.size != size:
            raise ValueError(
                f"{path}: expected {size} doubles, found {data.size}"
            )
        if f.read(1) != b"]":
            raise ValueError(f"{path}: missing closing ']'")
    return data.copy()

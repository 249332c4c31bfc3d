"""The reference's tagged binary output format (a copy of the JAX
package's dynearthsol_tpu/io/tagged.py: the same bytes for the same
arrays).

File layout (binaryio.cxx:20-131): a 4096-byte text header whose first line
is ``# DynEarthSol ndims=<N> revision=3``, followed by one ``name\\t<pos>``
line per array (pos = absolute byte offset of the raw little-endian data),
zero-padded to 4096 bytes; then the concatenated raw arrays.  Files written
here are read back by the reference's own Dynearthsol.py/2vtk.py and by the
benchmarks-cores compare harness unchanged.
"""

from __future__ import annotations

import os

import numpy as np

HEADERLEN = 4096


def _revision_line(ndims: int) -> bytes:
    return f"# DynEarthSol ndims={ndims} revision=3\n".encode("ascii")


def rename_to_old_backup(path: str):
    """Back up an existing file to .old / .old2 / ... (binaryio.cxx:43-61)."""
    if not os.path.exists(path):
        return
    n = 1
    while True:
        cand = path + ".old" + ("" if n == 1 else str(n))
        if not os.path.exists(cand):
            break
        n += 1
    os.rename(path, cand)


class TaggedWriter:
    """Write one tagged binary file (BinaryOutput, binaryio.cxx:64-188)."""

    def __init__(self, path: str, ndims: int, rename_if_exists: bool = False):
        if rename_if_exists:
            rename_to_old_backup(path)
        self.f = open(path, "wb")
        self.header = bytearray(_revision_line(ndims))
        self.eof_pos = HEADERLEN
        self.f.seek(HEADERLEN)

    def write_array(self, arr: np.ndarray, name: str):
        data = np.ascontiguousarray(arr)
        self.header += f"{name}\t{self.eof_pos}\n".encode("ascii")
        if len(self.header) > HEADERLEN:
            raise ValueError(f"tagged header overflow at array {name!r}")
        raw = data.tobytes()
        self.f.write(raw)
        self.eof_pos += len(raw)

    def close(self):
        if self.f is None:
            return
        self.f.seek(0)
        self.f.write(self.header.ljust(HEADERLEN, b"\x00"))
        self.f.close()
        self.f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TaggedReader:
    """Read one tagged binary file (BinaryInput, binaryio.cxx:190-270)."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        header = self.f.read(HEADERLEN)
        lines = header.split(b"\n")
        first = lines[0].split(b" ")
        if first[0] != b"#" or first[1] != b"DynEarthSol":
            raise ValueError(f"{path}: not a DynEarthSol output file")
        self.ndims = int(first[2].split(b"=")[1])
        self.revision = int(first[3].split(b"=")[1])
        self.offset = {}
        for line in lines[1:]:
            if not line or line[0] == 0:
                break
            name, pos = line.split(b"\t")
            self.offset[name.decode("ascii")] = int(pos)

    def has_array(self, name: str) -> bool:
        return name in self.offset

    def read_array(self, name: str, dtype, count: int) -> np.ndarray:
        self.f.seek(self.offset[name])
        return np.fromfile(self.f, dtype=dtype, count=count)

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

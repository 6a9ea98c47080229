"""Feature store: extracted CNN features + the name<->index contract (port
of ``data/features.py``).

On disk a store is ``{prefix}.npy`` (``noatt`` (N, 2048)) or
``{prefix}.{dataset}.npy`` (e.g. ``att`` maps (N, 14, 14, 2048)) with a
sidecar ``{prefix}.txt`` listing the image names in row order.  ``load``
memory-maps the matrix and reads it in for ``noatt``; att maps stay on disk
and their rows stream through ``gather_rows``.  ``to_device`` pins the
whole matrix on the device once, so steps gather rows by index there.
Only f32 matrices are read: the reference's HDF5 files (no ``h5py`` here)
and bf16 matrices raise ``NotImplementedError``.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _npy_header(path: str):
    """(offset of the data, shape) of a C-order f32 ``.npy``."""
    fmt = np.lib.format
    with open(path, "rb") as f:
        version = fmt.read_magic(f)
        read = (fmt.read_array_header_1_0 if version == (1, 0)
                else fmt.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        if fortran:
            raise ValueError("%s: need a C-order npy" % path)
        if dtype != np.dtype(np.float32):
            raise NotImplementedError(
                "%s holds %s features: the port reads f32 only (ROADMAP.md, "
                "Queue 1)" % (path, dtype))
        return f.tell(), shape


class FeatureStore:
    def __init__(self, features: np.ndarray, names: list[str]):
        if features.shape[0] != len(names):
            raise ValueError("%d feature rows vs %d names"
                             % (features.shape[0], len(names)))
        self.features = features
        self.names = list(names)
        self.name_to_index = {name: i for i, name in enumerate(self.names)}

    @classmethod
    def load(cls, path_prefix: str, dataset: str = "noatt"
             ) -> "FeatureStore":
        """Load ``{prefix}.npy`` (``noatt``, read in) or
        ``{prefix}.{dataset}.npy`` (att maps, kept memory-mapped) and the
        ``{prefix}.txt`` names."""
        with open(path_prefix + ".txt") as f:
            names = [line.strip() for line in f if line.strip()]
        npy = path_prefix + (".npy" if dataset == "noatt"
                             else ".%s.npy" % dataset)
        if not os.path.exists(npy):
            raise NotImplementedError(
                "%s not found: reading the reference's HDF5 feature files is "
                "not ported (ROADMAP.md, Queue 1)" % npy)
        offset, shape = _npy_header(npy)
        feats = np.memmap(npy, dtype=np.float32, mode="r", offset=offset,
                          shape=shape)
        if dataset == "noatt":
            feats = np.array(feats)
        return cls(feats, names)

    def save(self, path_prefix: str) -> None:
        """``{prefix}.npy`` and ``{prefix}.txt``; the matrix is replaced
        atomically (a live memory map of the old file keeps its inode)."""
        tmp = path_prefix + ".tmp.npy"
        np.save(tmp, np.asarray(self.features, np.float32))
        os.replace(tmp, path_prefix + ".npy")
        with open(path_prefix + ".txt", "w") as f:
            for name in self.names:
                f.write(name + "\n")

    @property
    def row_shape(self) -> tuple:
        return tuple(self.features.shape[1:])

    def gather_rows(self, rows: np.ndarray,
                    out: np.ndarray | None = None) -> np.ndarray:
        """Rows ``rows`` on the host, into ``out`` (len(rows), *row_shape)
        when given."""
        if out is None:
            return self.features[rows]
        # mode "raise" would copy through a buffer; the rows are in range
        np.take(self.features, rows, axis=0, out=out, mode="clip")
        return out

    def to_device(self, device) -> torch.Tensor:
        """The feature matrix as a tensor on ``device``."""
        return torch.from_numpy(np.ascontiguousarray(self.features)).to(device)

    def __len__(self) -> int:
        return self.features.shape[0]

"""Feature store: extracted CNN features + the name<->index contract (port
of ``data/features.py``).

On disk a store is ``{prefix}.npy`` (``noatt`` (N, 2048)) or
``{prefix}.{dataset}.npy`` (e.g. ``att`` maps (N, 14, 14, 2048)), or the
reference's ``{prefix}.hdf5`` with a dataset of that name, with a sidecar
``{prefix}.txt`` listing the image names in row order.  Elements are f32,
or bf16 in an ``.npy`` written as a uint16 bit-view (``cli/extract.py
--feat-dtype bfloat16``): rows then come out as ``ml_dtypes.bfloat16`` and
``to_device`` gives ``torch.bfloat16``.

``load`` keeps the matrix on disk (``lazy``, the default for att maps: an
``.npy`` memory map or an open HDF5 dataset) or reads it in (the default
for ``noatt``).  Rows of an ``.npy`` are gathered by the native C++ store
(``data/native_store.py``: mmap, a thread pool, async prefetch tickets for
``prefetch_rows`` / ``wait_rows``); numpy gathers where the library cannot
be built, and for in-memory and HDF5 matrices (``gather_path`` says
which).  Reading HDF5 needs ``h5py``; where it does not import, ``load``
raises ``ImportError`` naming it and the ``.npy`` route.  ``to_device``
puts the whole matrix on the device once, so steps gather rows there by
index.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .native_store import NativeFeatureStore, load_library, npy_header_bytes


def _import_h5py():
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "reading an .hdf5 feature store needs h5py, which does not "
            "import here; extract the features as .npy instead "
            "(cli/extract.py --att_store npy)") from exc
    return h5py


class _H5Rows:
    """Lazy row view over an open HDF5 dataset (the reference's per-item
    read pattern), with duplicate-tolerant fancy indexing: h5py itself
    requires sorted unique index lists."""

    def __init__(self, path: str, dataset: str):
        self._file = _import_h5py().File(path, "r")
        self._ds = self._file[dataset]
        self.shape = self._ds.shape
        self.dtype = self._ds.dtype

    def __getitem__(self, rows):
        if isinstance(rows, (int, np.integer)):
            return np.asarray(self._ds[int(rows)])
        rows = np.asarray(rows)
        uniq, inverse = np.unique(rows, return_inverse=True)
        data = (self._ds[uniq] if len(uniq) > 1
                else self._ds[int(uniq[0])][None])
        return data[inverse.reshape(rows.shape)]


def _flat(out: np.ndarray, n: int) -> np.ndarray:
    """``out`` as (n, cols), a view: the native store writes through it."""
    if not out.flags.c_contiguous:
        raise ValueError("the rows' buffer must be C-contiguous")
    return out.reshape(n, -1)


def to_tensor(array: np.ndarray) -> torch.Tensor:
    """A host tensor over the f32 or bf16 rows of ``array`` (bf16 bits are
    reinterpreted, not converted)."""
    array = np.ascontiguousarray(array)
    if array.dtype.itemsize == 2:
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(array)


class FeatureStore:
    def __init__(self, features, names: list[str],
                 npy_path: str | None = None):
        if features.shape[0] != len(names):
            raise ValueError("%d feature rows vs %d names"
                             % (features.shape[0], len(names)))
        self.features = features
        self.names = list(names)
        self.name_to_index = {name: i for i, name in enumerate(self.names)}
        self._npy_path = npy_path
        self._native = None

    @classmethod
    def load(cls, path_prefix: str, dataset: str = "noatt",
             lazy: bool | None = None) -> "FeatureStore":
        """Load ``{prefix}.npy`` (``noatt``) or ``{prefix}.{dataset}.npy``,
        else ``{prefix}.hdf5``'s dataset ``dataset``, and the
        ``{prefix}.txt`` names.  ``lazy`` (default: for every dataset but
        ``noatt``) keeps the matrix on disk and streams rows through
        ``gather_rows``."""
        if lazy is None:
            lazy = dataset != "noatt"
        with open(path_prefix + ".txt") as f:
            names = [line.strip() for line in f if line.strip()]
        npy = path_prefix + (".npy" if dataset == "noatt"
                             else ".%s.npy" % dataset)
        if os.path.exists(npy):
            offset, shape, dtype = npy_header_bytes(npy)
            feats = np.memmap(npy, dtype=dtype, mode="r", offset=offset,
                              shape=shape)
            if not lazy:
                feats = np.array(feats)
            return cls(feats, names, npy_path=npy)
        h5_path = path_prefix + ".hdf5"
        if not os.path.exists(h5_path):
            raise FileNotFoundError("no feature store %s or %s"
                                    % (npy, h5_path))
        if lazy:
            return cls(_H5Rows(h5_path, dataset), names)
        with _import_h5py().File(h5_path, "r") as f:
            feats = np.asarray(f[dataset])
        return cls(feats, names)

    def save(self, path_prefix: str) -> None:
        """``{prefix}.npy`` (f32, or bf16 as its uint16 bit-view) and
        ``{prefix}.txt``; the matrix is replaced atomically (a live memory
        map of the old file keeps its inode)."""
        tmp = path_prefix + ".tmp.npy"
        arr = np.asarray(self.features)
        if arr.dtype.itemsize == 2:
            arr = arr.view(np.uint16)
        np.save(tmp, arr)
        os.replace(tmp, path_prefix + ".npy")
        with open(path_prefix + ".txt", "w") as f:
            for name in self.names:
                f.write(name + "\n")

    def _native_store(self) -> NativeFeatureStore | None:
        """The native store over the backing ``.npy``, opened on first use;
        None for in-memory and HDF5 matrices and where the library is
        unavailable (``load_library`` says why, once)."""
        if self._native is None and self._npy_path is not None:
            if load_library() is None:
                self._npy_path = None
            else:
                self._native = NativeFeatureStore.open_npy(self._npy_path)
        return self._native

    @property
    def gather_path(self) -> str:
        """``"native"`` where the C++ store gathers the rows, else
        ``"numpy"``."""
        return "native" if self._native_store() is not None else "numpy"

    @property
    def row_shape(self) -> tuple:
        return tuple(self.features.shape[1:])

    @property
    def dtype(self) -> np.dtype:
        """Element dtype the rows come out as: f32, or ``ml_dtypes``'
        bfloat16 for a bf16 ``.npy``."""
        return np.dtype(self.features.dtype)

    def gather_rows(self, rows: np.ndarray,
                    out: np.ndarray | None = None) -> np.ndarray:
        """Rows ``rows`` on the host, (len(rows), *row_shape), into ``out``
        when given."""
        native = self._native_store()
        if native is not None:
            if out is None:
                out = np.empty((len(rows),) + self.row_shape, self.dtype)
            native.gather(rows, _flat(out, len(rows)))
            return out
        if out is None:
            return self.features[rows]
        if isinstance(self.features, _H5Rows):
            out[...] = self.features[rows]
            return out
        # mode "raise" would copy through a buffer; the rows are in range
        np.take(self.features, rows, axis=0, out=out, mode="clip")
        return out

    def prefetch_rows(self, rows: np.ndarray, out: np.ndarray):
        """Start an async native gather of ``rows`` into ``out`` (C-order,
        ``len(rows) * prod(row_shape)`` elements of ``self.dtype``) ->
        a ticket for :meth:`wait_rows`, or None where no native store
        backs the matrix (the caller gathers another way)."""
        native = self._native_store()
        if native is None:
            return None
        return native.prefetch(rows, _flat(out, len(rows)))

    def wait_rows(self, ticket) -> None:
        self._native.wait(ticket)

    @property
    def outstanding(self) -> int:
        """Native prefetch tickets not waited for yet."""
        return 0 if self._native is None else self._native.outstanding

    def to_device(self, device) -> torch.Tensor:
        """The feature matrix as a tensor on ``device`` (f32, or
        ``torch.bfloat16`` for bf16 rows); an HDF5 matrix is read in
        first."""
        feats = self.features
        if isinstance(feats, _H5Rows):
            feats = feats[np.arange(feats.shape[0])]
        return to_tensor(feats).to(device)

    def get_by_name(self, name: str) -> np.ndarray:
        return self.features[self.name_to_index[name]]

    def __len__(self) -> int:
        return self.features.shape[0]

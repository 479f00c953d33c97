"""Minimal zarr-v2-compatible array storage.

The reference caches image embeddings in zarr (micro_sam/util.py:684-706,
1177-1191) with attribute-based cache signatures. The ``zarr`` package is not a
baked-in dependency here, so this module implements the subset of the zarr v2
on-disk format the framework needs, in pure Python + numpy:

- directory stores and in-memory dict stores,
- groups (``.zgroup``), arrays (``.zarray``), attributes (``.zattrs``),
- C-order chunks, raw or zlib compression (zlib chunks carry the standard
  numcodecs ``{"id": "zlib", "level": n}`` metadata, so real zarr-python can
  read caches written by this module and vice versa for uncompressed/zlib data),
- basic orthogonal slicing for reads and writes.

Thread safety follows the reference's contract: dataset *creation* is not
thread-safe, chunk-aligned writes from multiple threads are.
"""
from __future__ import annotations

import io
import json
import os
import threading
import zlib
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["open", "open_group", "MemoryStore", "DirectoryStore", "Group", "Array"]


# ---------------------------------------------------------------------------
# Stores
# ---------------------------------------------------------------------------

class MemoryStore:
    """In-memory dict store (equivalent of the reference's in-memory zarr cache)."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def __getitem__(self, key: str) -> bytes:
        return self._data[key]

    def __setitem__(self, key: str, value: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __delitem__(self, key: str) -> None:
        with self._lock:
            del self._data[key]

    def keys(self):
        return list(self._data.keys())


class DirectoryStore:
    def __init__(self, path: str):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)

    def _fn(self, key: str) -> str:
        return os.path.join(self.path, *key.split("/"))

    def __getitem__(self, key: str) -> bytes:
        fn = self._fn(key)
        if not os.path.exists(fn):
            raise KeyError(key)
        with io.open(fn, "rb") as f:
            return f.read()

    def __setitem__(self, key: str, value: bytes) -> None:
        fn = self._fn(key)
        os.makedirs(os.path.dirname(fn), exist_ok=True)
        tmp = fn + f".tmp{os.getpid()}.{threading.get_ident()}"
        with io.open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, fn)

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._fn(key))

    def __delitem__(self, key: str) -> None:
        fn = self._fn(key)
        if not os.path.exists(fn):
            raise KeyError(key)
        os.remove(fn)

    def keys(self):
        out = []
        for root, _, files in os.walk(self.path):
            rel = os.path.relpath(root, self.path)
            for f in files:
                out.append(f if rel == "." else f"{rel.replace(os.sep, '/')}/{f}")
        return out


Store = Union[MemoryStore, DirectoryStore]


# ---------------------------------------------------------------------------
# Attributes
# ---------------------------------------------------------------------------

class Attributes:
    def __init__(self, store: Store, prefix: str, zarr_format: int = 2):
        self._store = store
        self._format = zarr_format
        if zarr_format == 3:
            self._key = f"{prefix}zarr.json" if prefix else "zarr.json"
        else:
            self._key = f"{prefix}.zattrs" if prefix else ".zattrs"

    def _read(self) -> Dict[str, Any]:
        try:
            doc = json.loads(self._store[self._key].decode())
        except KeyError:
            return {}
        return doc.get("attributes", {}) if self._format == 3 else doc

    def _write(self, attrs: Dict[str, Any]) -> None:
        if self._format == 3:
            doc = json.loads(self._store[self._key].decode())
            doc["attributes"] = attrs
            self._store[self._key] = json.dumps(doc, indent=1).encode()
        else:
            self._store[self._key] = json.dumps(attrs, indent=1).encode()

    def __getitem__(self, name: str) -> Any:
        return self._read()[name]

    def __setitem__(self, name: str, value: Any) -> None:
        attrs = self._read()
        attrs[name] = value
        self._write(attrs)

    def __contains__(self, name: str) -> bool:
        return name in self._read()

    def get(self, name: str, default: Any = None) -> Any:
        return self._read().get(name, default)

    def update(self, other: Dict[str, Any]) -> None:
        attrs = self._read()
        attrs.update(other)
        self._write(attrs)

    def asdict(self) -> Dict[str, Any]:
        return self._read()

    def keys(self):
        return self._read().keys()


# ---------------------------------------------------------------------------
# Array
# ---------------------------------------------------------------------------

def _normalize_dtype_str(dtype: np.dtype) -> str:
    dtype = np.dtype(dtype)
    if dtype.byteorder == "=":
        return ("<" if np.little_endian else ">") + dtype.str[1:]
    return dtype.str


_V3_DTYPES = {
    "float32": "<f4", "float64": "<f8", "float16": "<f2",
    "uint8": "|u1", "uint16": "<u2", "uint32": "<u4", "uint64": "<u8",
    "int8": "|i1", "int16": "<i2", "int32": "<i4", "int64": "<i8", "bool": "|b1",
}
_V3_DTYPES_INV = {
    np.dtype(v).name: k for k, v in _V3_DTYPES.items()
}


class Array:
    def __init__(self, store: Store, prefix: str, zarr_format: Optional[int] = None):
        self._store = store
        self._prefix = prefix
        if zarr_format is None:
            zarr_format = 3 if (f"{prefix}zarr.json" if prefix else "zarr.json") in store else 2
        self._format = zarr_format
        if zarr_format == 3:
            meta = json.loads(store[f"{prefix}zarr.json" if prefix else "zarr.json"].decode())
            assert meta.get("node_type") == "array", f"not an array at {prefix}"
            self.shape = tuple(meta["shape"])
            self.chunks = tuple(meta["chunk_grid"]["configuration"]["chunk_shape"])
            self.dtype = np.dtype(_V3_DTYPES.get(meta["data_type"], meta["data_type"]))
            codecs = [c["name"] for c in meta.get("codecs", [])]
            self._compressor = {"id": "gzip", "level": 1} if "gzip" in codecs else None
            self._fill_value = meta.get("fill_value", 0)
            sep = meta.get("chunk_key_encoding", {}).get("configuration", {}).get("separator", "/")
            self._v3_sep = sep
        else:
            meta = json.loads(store[f"{prefix}.zarray" if prefix else ".zarray"].decode())
            self.shape = tuple(meta["shape"])
            self.chunks = tuple(meta["chunks"])
            self.dtype = np.dtype(meta["dtype"])
            self._compressor = meta.get("compressor")
            self._fill_value = meta.get("fill_value", 0)
        self.attrs = Attributes(store, prefix, zarr_format)

    # -- metadata ----------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @staticmethod
    def create(
        store: Store,
        prefix: str,
        shape: Sequence[int],
        chunks: Optional[Sequence[int]],
        dtype,
        compressor: Optional[str] = "zlib",
        fill_value: Any = 0,
        zarr_format: int = 2,
    ) -> "Array":
        shape = tuple(int(s) for s in shape)
        if chunks is None:
            chunks = shape if shape else (1,)
        chunks = tuple(min(int(c), s) if s > 0 else int(c) for c, s in zip(chunks, shape))
        if zarr_format == 3:
            codecs = [{"name": "bytes", "configuration": {"endian": "little"}}]
            if compressor not in (None, "none", "raw"):
                codecs.append({"name": "gzip", "configuration": {"level": 1}})
            meta = {
                "zarr_format": 3,
                "node_type": "array",
                "shape": list(shape),
                "data_type": _V3_DTYPES_INV.get(np.dtype(dtype).name, np.dtype(dtype).name),
                "chunk_grid": {"name": "regular",
                               "configuration": {"chunk_shape": list(chunks)}},
                "chunk_key_encoding": {"name": "default",
                                       "configuration": {"separator": "/"}},
                "fill_value": fill_value,
                "codecs": codecs,
                "attributes": {},
            }
            store[f"{prefix}zarr.json" if prefix else "zarr.json"] = \
                json.dumps(meta, indent=1).encode()
            return Array(store, prefix, zarr_format=3)
        if compressor == "zlib":
            comp_meta = {"id": "zlib", "level": 1}
        elif compressor in (None, "none", "raw"):
            comp_meta = None
        else:
            raise ValueError(f"Unsupported compressor: {compressor}")
        meta = {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": list(chunks),
            "dtype": _normalize_dtype_str(np.dtype(dtype)),
            "compressor": comp_meta,
            "fill_value": fill_value,
            "order": "C",
            "filters": None,
        }
        store[f"{prefix}.zarray" if prefix else ".zarray"] = json.dumps(meta, indent=1).encode()
        return Array(store, prefix, zarr_format=2)

    # -- chunk io ----------------------------------------------------------
    def _chunk_key(self, idx: Tuple[int, ...]) -> str:
        if self._format == 3:
            name = "c" + "".join(f"{self._v3_sep}{i}" for i in idx) if idx else "c"
            return f"{self._prefix}{name}"
        name = ".".join(str(i) for i in idx) if idx else "0"
        return f"{self._prefix}{name}"

    def _decode(self, raw: bytes) -> np.ndarray:
        if self._compressor is not None:
            cid = self._compressor.get("id")
            if cid == "gzip":
                raw = zlib.decompress(raw, wbits=47)  # gzip or zlib framing
            elif cid == "zlib":
                raw = zlib.decompress(raw)
            elif cid == "blosc":
                # real zarr-python's default compressor; decode via numcodecs
                # when present (not baked into this environment)
                try:
                    import numcodecs
                except ImportError as e:
                    raise ValueError(
                        "This zarr array uses the 'blosc' compressor, which "
                        "needs numcodecs. Re-write the cache with a gzip/zlib "
                        "compressor, or install numcodecs."
                    ) from e
                raw = numcodecs.get_codec(self._compressor).decode(raw)
            else:
                raise ValueError(
                    f"Unsupported zarr compressor {cid!r}; zarr_lite decodes "
                    "raw, zlib and gzip chunks (and blosc via numcodecs)."
                )
        return np.frombuffer(raw, dtype=self.dtype).reshape(self.chunks).copy()

    def _encode(self, chunk: np.ndarray) -> bytes:
        raw = np.ascontiguousarray(chunk, dtype=self.dtype).tobytes()
        if self._compressor is not None:
            if self._compressor.get("id") == "gzip":
                co = zlib.compressobj(self._compressor.get("level", 1), wbits=31)
                raw = co.compress(raw) + co.flush()
            else:
                raw = zlib.compress(raw, self._compressor.get("level", 1))
        return raw

    def _read_chunk(self, idx: Tuple[int, ...]) -> np.ndarray:
        key = self._chunk_key(idx)
        try:
            return self._decode(self._store[key])
        except KeyError:
            return np.full(self.chunks, self._fill_value, dtype=self.dtype)

    # -- slicing -----------------------------------------------------------
    def _normalize_selection(self, selection) -> Tuple[Tuple[slice, ...], Tuple[int, ...]]:
        if selection is Ellipsis:
            selection = ()
        if not isinstance(selection, tuple):
            selection = (selection,)
        if Ellipsis in selection:
            i = selection.index(Ellipsis)
            n_missing = self.ndim - (len(selection) - 1)
            selection = selection[:i] + (slice(None),) * n_missing + selection[i + 1:]
        selection = selection + (slice(None),) * (self.ndim - len(selection))
        slices, squeeze_axes = [], []
        for ax, (sel, size) in enumerate(zip(selection, self.shape)):
            if isinstance(sel, (int, np.integer)):
                s = int(sel)
                if s < 0:
                    s += size
                slices.append(slice(s, s + 1))
                squeeze_axes.append(ax)
            elif isinstance(sel, slice):
                start, stop, step = sel.indices(size)
                if step != 1:
                    raise NotImplementedError("Strided slicing is not supported.")
                slices.append(slice(start, stop))
            else:
                raise NotImplementedError(f"Unsupported selection: {sel!r}")
        return tuple(slices), tuple(squeeze_axes)

    def __getitem__(self, selection) -> np.ndarray:
        slices, squeeze_axes = self._normalize_selection(selection)
        out_shape = tuple(s.stop - s.start for s in slices)
        out = np.empty(out_shape, dtype=self.dtype)
        for idx in self._chunks_in_selection(slices):
            chunk = self._read_chunk(idx)
            c_sl, o_sl = self._overlap(idx, slices)
            out[o_sl] = chunk[c_sl]
        if squeeze_axes:
            out = np.squeeze(out, axis=squeeze_axes)
        return out

    def __setitem__(self, selection, value) -> None:
        slices, squeeze_axes = self._normalize_selection(selection)
        out_shape = tuple(s.stop - s.start for s in slices)
        value = np.asarray(value, dtype=self.dtype)
        value = np.broadcast_to(value, out_shape)
        for idx in self._chunks_in_selection(slices):
            c_sl, o_sl = self._overlap(idx, slices)
            full_chunk = all(
                sl.start == 0 and sl.stop == c
                for sl, c in zip(c_sl, self.chunks)
            )
            if full_chunk:
                chunk = np.ascontiguousarray(value[o_sl], dtype=self.dtype)
            else:
                chunk = self._read_chunk(idx)
                chunk[c_sl] = value[o_sl]
            self._store[self._chunk_key(idx)] = self._encode(chunk)

    def _chunks_in_selection(self, slices):
        import itertools
        ranges = []
        for sl, c in zip(slices, self.chunks):
            if sl.stop <= sl.start:
                return
            ranges.append(range(sl.start // c, (sl.stop - 1) // c + 1))
        yield from itertools.product(*ranges)

    def _overlap(self, idx, slices):
        c_sl, o_sl = [], []
        for i, sl, c in zip(idx, slices, self.chunks):
            c_begin, c_end = i * c, (i + 1) * c
            lo, hi = max(sl.start, c_begin), min(sl.stop, c_end)
            c_sl.append(slice(lo - c_begin, hi - c_begin))
            o_sl.append(slice(lo - sl.start, hi - sl.start))
        return tuple(c_sl), tuple(o_sl)

    def __array__(self, dtype=None):
        out = self[...]
        return out.astype(dtype) if dtype is not None else out


# ---------------------------------------------------------------------------
# Group
# ---------------------------------------------------------------------------

class Group:
    def __init__(self, store: Store, prefix: str = "", zarr_format: Optional[int] = None):
        self._store = store
        self._prefix = prefix
        v3_key = f"{prefix}zarr.json" if prefix else "zarr.json"
        v2_key = f"{prefix}.zgroup" if prefix else ".zgroup"
        if zarr_format is None:
            if v3_key in store:
                zarr_format = 3
            elif v2_key in store:
                zarr_format = 2
            else:
                zarr_format = 2
        self._format = zarr_format
        if zarr_format == 3:
            if v3_key not in store:
                store[v3_key] = json.dumps(
                    {"zarr_format": 3, "node_type": "group", "attributes": {}}, indent=1
                ).encode()
        else:
            if v2_key not in store:
                store[v2_key] = json.dumps({"zarr_format": 2}).encode()
        self.attrs = Attributes(store, prefix, zarr_format)

    @property
    def store(self) -> Store:
        return self._store

    def _child_prefix(self, name: str) -> str:
        name = name.strip("/")
        return f"{self._prefix}{name}/"

    def __contains__(self, name: str) -> bool:
        p = self._child_prefix(name)
        return (f"{p}.zarray" in self._store or f"{p}.zgroup" in self._store
                or f"{p}zarr.json" in self._store)

    def __getitem__(self, name: str) -> Union["Group", Array]:
        p = self._child_prefix(name)
        if f"{p}.zarray" in self._store:
            return Array(self._store, p, zarr_format=2)
        if f"{p}.zgroup" in self._store:
            return Group(self._store, p, zarr_format=2)
        if f"{p}zarr.json" in self._store:
            meta = json.loads(self._store[f"{p}zarr.json"].decode())
            if meta.get("node_type") == "array":
                return Array(self._store, p, zarr_format=3)
            return Group(self._store, p, zarr_format=3)
        raise KeyError(name)

    def __delitem__(self, name: str) -> None:
        p = self._child_prefix(name)
        for key in list(self._store.keys()):
            if key.startswith(p):
                del self._store[key]

    def keys(self):
        seen = set()
        for key in self._store.keys():
            if not key.startswith(self._prefix):
                continue
            rest = key[len(self._prefix):]
            head = rest.split("/", 1)[0]
            if head.startswith("."):
                continue
            if "/" in rest and head not in seen:
                p = f"{self._prefix}{head}/"
                if (f"{p}.zarray" in self._store or f"{p}.zgroup" in self._store
                        or f"{p}zarr.json" in self._store):
                    seen.add(head)
        return sorted(seen)

    def create_group(self, name: str) -> "Group":
        return Group(self._store, self._child_prefix(name), zarr_format=self._format)

    def require_group(self, name: str) -> "Group":
        return self.create_group(name)

    def create_dataset(
        self,
        name: str,
        shape: Optional[Sequence[int]] = None,
        chunks: Optional[Sequence[int]] = None,
        dtype=None,
        data: Optional[np.ndarray] = None,
        compressor: Optional[str] = "zlib",
        overwrite: bool = False,
        **_ignored,
    ) -> Array:
        if name in self and not overwrite:
            if data is None and shape is not None:
                existing = self[name]
                if isinstance(existing, Array) and existing.shape == tuple(shape):
                    return existing
            raise ValueError(f"Dataset {name} already exists.")
        if name in self:
            del self[name]
        if data is not None:
            data = np.asarray(data)
            shape = data.shape if shape is None else shape
            dtype = data.dtype if dtype is None else dtype
        if shape is None or dtype is None:
            raise ValueError("shape and dtype (or data) are required")
        arr = Array.create(
            self._store, self._child_prefix(name), shape, chunks, dtype,
            compressor=compressor, zarr_format=self._format,
        )
        if data is not None:
            arr[...] = data
        return arr

    def require_dataset(
        self, name: str, shape: Sequence[int], chunks=None, dtype=None, **kwargs
    ) -> Array:
        if name in self:
            arr = self[name]
            if isinstance(arr, Array) and arr.shape == tuple(shape):
                return arr
            del self[name]
        return self.create_dataset(name, shape=shape, chunks=chunks, dtype=dtype, **kwargs)


def open(path_or_store: Union[str, Store], mode: str = "a",
         zarr_format: Optional[int] = None) -> Group:
    """Open a zarr group on a directory path or a store object.

    zarr_format: 2 (default) or 3, applied to NEW stores only — an existing
    store's format is always auto-detected from the presence of ``zarr.json``
    vs ``.zgroup``, so a format request can never split a store across specs
    (the reference picks v2/v3 by the installed zarr version,
    micro_sam/util.py:684-706; here the caller/env picks for fresh caches).
    """
    if isinstance(path_or_store, str):
        if mode == "r" and not os.path.exists(path_or_store):
            raise FileNotFoundError(path_or_store)
        store = DirectoryStore(path_or_store)
    else:
        store = path_or_store
    if "zarr.json" in store:
        zarr_format = 3
    elif ".zgroup" in store:
        zarr_format = 2
    return Group(store, zarr_format=zarr_format)


open_group = open

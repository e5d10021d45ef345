"""Native storage container (ctypes bindings + pure-Python fallback).

The container format and its C++ implementation belong to the JAX
package (`arroy_tpu/native/container.cc`); both packages read and write
the identical file format.  The port compiles that source, read by path
(never imported), with g++ into its own git-ignored build directory
`arroy_tpu_torch/_build/`.  When no compiler or source is available, a
pure-Python implementation of the identical file format takes over, so
containers are always readable.
"""

from __future__ import annotations

import ctypes
import json
import mmap as _mmap
import os
import subprocess
import tempfile
import threading
import zlib

import numpy as np

_ALIGN = 64
_MAGIC = b"ARROYTPC"

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX package's container source, compiled by path
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "arroy_tpu", "native", "container.cc")


def _so_path() -> str:
    return os.path.join(_PKG_DIR, "_build", "_container.so")


def _load_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = _so_path()
        try:
            os.makedirs(os.path.dirname(so), exist_ok=True)
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(_SRC):
                with tempfile.TemporaryDirectory(dir=os.path.dirname(so)) as td:
                    tmp_so = os.path.join(td, "_container.so")
                    subprocess.run(
                        [
                            "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                            "-pthread", _SRC, "-o", tmp_so,
                        ],
                        check=True,
                        capture_output=True,
                    )
                    os.replace(tmp_so, so)
            lib = ctypes.CDLL(so)
            lib.atc_crc32.restype = ctypes.c_uint32
            lib.atc_crc32.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.atc_write.restype = ctypes.c_int
            lib.atc_write.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_uint64, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int,
            ]
            lib.atc_open.restype = ctypes.c_void_p
            lib.atc_open.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int
            ]
            lib.atc_close.restype = None
            lib.atc_close.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            _lib = lib
        except Exception:
            _lib_failed = True
            _lib = None
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


def _layout(arrays: dict[str, np.ndarray]):
    """Compute the aligned blob layout + header JSON skeleton."""
    blobs = []
    entries = []
    # header gets finalized after we know its length; iterate to fixpoint on
    # the first blob offset (header length depends on offsets — use two passes
    # with a generous pad instead)
    names = sorted(arrays)
    payloads = [np.ascontiguousarray(arrays[n]) for n in names]
    for n, arr in zip(names, payloads):
        if arr.dtype.hasobject or arr.dtype.str.startswith("|O"):
            raise TypeError(f"blob {n!r} has non-serializable dtype {arr.dtype}")

    #: big blobs get their CRC computed later (natively, without tobytes
    #: copies); the layout reserves the max uint32 width for them so the
    #: final header can only SHRINK when the real value is substituted —
    #: it must never outgrow the first blob offset
    big = [arr.nbytes >= (1 << 20) for arr in payloads]

    def build(offset0):
        off = offset0
        es = []
        for name, arr, is_big in zip(names, payloads, big):
            off = (off + _ALIGN - 1) // _ALIGN * _ALIGN
            es.append(
                {
                    "name": name,
                    "dtype": arr.dtype.str,
                    "shape": list(arr.shape),
                    "offset": off,
                    "nbytes": int(arr.nbytes),
                    "crc32": 0xFFFFFFFF
                    if is_big
                    else int(zlib.crc32(arr.tobytes()) & 0xFFFFFFFF),
                }
            )
            off += arr.nbytes
        return es, off

    # pass 1: guess header size, pass 2: fix
    es, _ = build(16)
    hdr = json.dumps({"blobs": es}).encode()
    es, total = build(16 + len(hdr) + _ALIGN)
    hdr = json.dumps({"blobs": es}).encode()
    while 16 + len(hdr) > es[0]["offset"] if es else False:
        es, total = build(es[0]["offset"] + _ALIGN)
        hdr = json.dumps({"blobs": es}).encode()
    return names, payloads, es, big, hdr, total


def write_container(path: str, arrays: dict[str, np.ndarray]) -> None:
    """Write all arrays into one container file, atomically."""
    names, payloads, entries, big, hdr, total = _layout(arrays)
    lib = _load_lib()
    tmp = path + ".tmp"
    first_off = entries[0]["offset"] if entries else 1 << 62
    if lib is not None:
        # fill big-blob CRCs natively
        for e, arr, is_big in zip(entries, payloads, big):
            if is_big:
                e["crc32"] = int(
                    lib.atc_crc32(
                        arr.ctypes.data_as(ctypes.c_void_p), ctypes.c_uint64(arr.nbytes)
                    )
                )
        hdr = json.dumps({"blobs": entries}).encode()
        # real CRCs are at most as wide as the 0xFFFFFFFF placeholder, so
        # the finalized header always fits ahead of the first blob
        assert 16 + len(hdr) <= first_off, "container header outgrew its slot"
        n = len(payloads)
        ptrs = (ctypes.c_void_p * n)(
            *[arr.ctypes.data_as(ctypes.c_void_p).value for arr in payloads]
        )
        sizes = (ctypes.c_uint64 * n)(*[arr.nbytes for arr in payloads])
        offs = (ctypes.c_uint64 * n)(*[e["offset"] for e in entries])
        rc = lib.atc_write(
            path.encode(), tmp.encode(), hdr, len(hdr), n, ptrs, sizes, offs, 0
        )
        if rc != 0:
            raise OSError(f"atc_write failed with code {rc}")
        return
    # pure-python fallback (same format)
    for e, arr, is_big in zip(entries, payloads, big):
        if is_big:
            e["crc32"] = int(zlib.crc32(arr.tobytes()) & 0xFFFFFFFF)
    hdr = json.dumps({"blobs": entries}).encode()
    assert 16 + len(hdr) <= first_off, "container header outgrew its slot"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        for e, arr in zip(entries, payloads):
            f.seek(e["offset"])
            f.write(arr.tobytes())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class Container:
    """Zero-copy reader over a container file (mmap-backed)."""

    def __init__(self, path: str, willneed: bool = False, verify: bool = False):
        self.path = path
        self._lib = _load_lib()
        if self._lib is not None:
            size = ctypes.c_uint64()
            base = self._lib.atc_open(path.encode(), ctypes.byref(size), int(willneed))
            if not base:
                raise OSError(f"cannot open container {path}")
            self._base = base
            self._size = size.value
            self._buf = (ctypes.c_char * self._size).from_address(base)
            self._mm = None
        else:
            self._f = open(path, "rb")
            self._mm = _mmap.mmap(self._f.fileno(), 0, access=_mmap.ACCESS_READ)
            if self._mm[:8] != _MAGIC:
                raise OSError(f"bad magic in {path}")
            self._buf = self._mm
            self._size = len(self._mm)
            self._base = None
        hlen = int.from_bytes(bytes(self._buf[8:16]), "little")
        self.header = json.loads(bytes(self._buf[16 : 16 + hlen]).decode())
        self._entries = {e["name"]: e for e in self.header["blobs"]}
        if verify:
            self.verify()

    def names(self) -> list[str]:
        return sorted(self._entries)

    def array(self, name: str) -> np.ndarray:
        """Zero-copy numpy view into the mapped file (read-only)."""
        self._vended = True
        e = self._entries[name]
        out = np.frombuffer(
            self._buf, dtype=np.dtype(e["dtype"]), count=int(np.prod(e["shape"], dtype=np.int64)) if e["shape"] else 1, offset=e["offset"]
        )
        if e["shape"]:
            out = out.reshape(e["shape"])
        else:
            out = out.reshape(())
        out.flags.writeable = False
        return out

    def verify(self) -> None:
        for name, e in self._entries.items():
            raw = bytes(self._buf[e["offset"] : e["offset"] + e["nbytes"]])
            crc = zlib.crc32(raw) & 0xFFFFFFFF
            if crc != e["crc32"]:
                raise OSError(f"crc mismatch for blob {name!r} in {self.path}")

    def close(self, force: bool = False) -> None:
        """`force=True` asserts no `array()` views outlive the container
        (callers that copied everything, e.g. persist.load)."""
        if self._base is not None and self._lib is not None:
            if getattr(self, "_vended", False) and not force:
                # numpy views from array() alias the mapping through a raw
                # ctypes buffer (no buffer-protocol refcount), so munmap
                # would be a use-after-free; keep the map for the process
                # lifetime — the same semantics as the fallback's
                # BufferError branch below
                return
            self._lib.atc_close(self._base, self._size)
            self._base = None
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # numpy views into the map are still alive; the map stays
                # open until they are collected (same as LMDB read txns)
                pass
            else:
                self._f.close()
                self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

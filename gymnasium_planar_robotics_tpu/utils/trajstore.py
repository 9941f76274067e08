"""Trajectory store: background-threaded native writer + random-access reader.

Python surface over the C++ runtime in ``native/trajstore`` (ctypes, no
pybind11).  Rollout batches (pytrees of arrays) are packed into framed binary
shards by a background thread so the device loop never blocks on disk; the
reader serves random access by frame id for shuffled offline-RL batches.

The shared library is built from ``native/trajstore`` with its Makefile at
first use (or ahead of time with ``make -C native/trajstore``); where no C++
toolchain is available the pure-Python implementation (same on-disk format)
takes over.
"""

from __future__ import annotations

import ctypes
import io
import os
import struct
import subprocess
import warnings
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).parent.parent.parent / 'native' / 'trajstore' / 'libtrajstore.so'

_MAGIC = 0x54524A31


def _build(target: Path) -> None:
    """Compile the library with its Makefile into a private file name, then
    rename it into place atomically, so processes that build at the same
    time never load a half-written library."""
    tmp = target.with_name(f'{target.name}.{os.getpid()}.tmp')
    try:
        subprocess.run(
            ['make', '-s', '-C', str(target.parent), f'TARGET={tmp.name}'],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, target)
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        warnings.warn(f'building {target} failed ({e}); using the Python trajectory writer', stacklevel=3)
    finally:
        tmp.unlink(missing_ok=True)


def _load_lib():
    p = _LIB_PATH
    if not p.exists() and (p.parent / 'Makefile').exists():
        _build(p)
    if not p.exists():
        return None
    lib = ctypes.CDLL(str(p))
    lib.ts_writer_open.restype = ctypes.c_void_p
    lib.ts_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.ts_writer_append.restype = ctypes.c_int
    lib.ts_writer_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.ts_writer_frames_written.restype = ctypes.c_uint64
    lib.ts_writer_frames_written.argtypes = [ctypes.c_void_p]
    lib.ts_writer_queue_bytes.restype = ctypes.c_uint64
    lib.ts_writer_queue_bytes.argtypes = [ctypes.c_void_p]
    lib.ts_writer_close.restype = ctypes.c_int
    lib.ts_writer_close.argtypes = [ctypes.c_void_p]
    lib.ts_reader_open.restype = ctypes.c_void_p
    lib.ts_reader_open.argtypes = [ctypes.c_char_p]
    lib.ts_reader_count.restype = ctypes.c_uint64
    lib.ts_reader_count.argtypes = [ctypes.c_void_p]
    lib.ts_reader_length.restype = ctypes.c_uint64
    lib.ts_reader_length.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ts_reader_get.restype = ctypes.c_int64
    lib.ts_reader_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64]
    lib.ts_reader_close.restype = None
    lib.ts_reader_close.argtypes = [ctypes.c_void_p]
    return lib


_UNLOADED = object()
_LIB = _UNLOADED  # the ctypes library once loaded; None: Python fallback


def _lib():
    """The native library, built and loaded on first use (None if unavailable)."""
    global _LIB
    if _LIB is _UNLOADED:
        _LIB = _load_lib()
    return _LIB


def native_available() -> bool:
    """True if the C++ trajstore library was built (or found) and loaded."""
    return _lib() is not None


def pack_pytree(tree) -> bytes:
    """Serialize a pytree of arrays to bytes (npz container)."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    buf = io.BytesIO()
    np.savez(buf, treedef=np.frombuffer(str(treedef).encode(), dtype=np.uint8),
             **{f'leaf_{i}': np.asarray(leaf) for i, leaf in enumerate(leaves)})
    return buf.getvalue()


def unpack_arrays(data: bytes) -> list[np.ndarray]:
    """Deserialize the leaf arrays (structure restoration is the caller's —
    treedefs aren't safely eval-able, so we return leaves in order)."""
    with np.load(io.BytesIO(data)) as z:
        n = sum(1 for k in z.files if k.startswith('leaf_'))
        return [z[f'leaf_{i}'] for i in range(n)]


class TrajWriter:
    """Append-only frame sink; native background thread when available."""

    def __init__(self, directory: str | Path, shard_bytes: int = 64 << 20, max_queue_bytes: int = 256 << 20):
        self._dir = Path(directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._native = None
        if _lib() is not None:
            self._native = _LIB.ts_writer_open(str(self._dir).encode(), shard_bytes, max_queue_bytes)
        else:
            self._shard_bytes = shard_bytes
            # resume from an existing index: shards open in append mode, so
            # offsets must continue from the last indexed frame
            self._shard_id = 0
            self._shard_used = 0
            self._count = 0
            idx = self._dir / 'index.bin'
            if idx.exists():
                raw = idx.read_bytes()
                for i in range(0, len(raw), 20):
                    shard, off, length = struct.unpack_from('<IQQ', raw, i)
                    self._shard_id = shard
                    self._shard_used = off + 12 + length
                    self._count += 1
            self._shard = open(self._dir / f'shard_{self._shard_id:06d}.bin', 'ab')
            self._index = open(idx, 'ab')

    def append(self, frame: bytes) -> None:
        """Append one opaque frame; native path enqueues to the background
        writer thread, Python fallback writes+flushes synchronously."""
        if self._native is not None:
            rc = _LIB.ts_writer_append(self._native, frame, len(frame))
            if rc != 0:
                raise IOError(f'trajstore writer error {rc}')
            return
        if self._shard_used > 0 and self._shard_used + len(frame) > self._shard_bytes:
            self._shard.close()
            self._shard_id += 1
            self._shard = open(self._dir / f'shard_{self._shard_id:06d}.bin', 'ab')
            self._shard_used = 0
        off = self._shard_used
        self._shard.write(struct.pack('<IQ', _MAGIC, len(frame)))
        self._shard.write(frame)
        self._shard.flush()
        self._index.write(struct.pack('<IQQ', self._shard_id, off, len(frame)))
        self._index.flush()
        self._shard_used += 12 + len(frame)
        self._count += 1

    def append_pytree(self, tree) -> None:
        """Serialize a pytree of arrays (npz container) and append it."""
        self.append(pack_pytree(tree))

    @property
    def frames_written(self) -> int:
        if self._native is not None:
            return int(_LIB.ts_writer_frames_written(self._native))
        return getattr(self, '_count', getattr(self, '_final_count', 0))

    def close(self) -> None:
        """Drain the background writer (native path) and close all files."""
        if self._native is not None:
            import time

            # wait for the background thread to drain so the final count is
            # complete, then close (the worker pops before writing, so also
            # wait for the counter to go quiescent after the queue empties)
            while int(_LIB.ts_writer_queue_bytes(self._native)) > 0:
                time.sleep(0.001)
            prev, cur = -1, int(_LIB.ts_writer_frames_written(self._native))
            while cur != prev:
                time.sleep(0.002)
                prev, cur = cur, int(_LIB.ts_writer_frames_written(self._native))
            self._final_count = cur
            rc = _LIB.ts_writer_close(self._native)
            self._native = None
            if rc != 0:
                raise IOError(f'trajstore writer close error {rc}')
        elif getattr(self, '_shard', None):
            self._shard.close()
            self._index.close()
            self._shard = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TrajReader:
    """Random access by frame id over a written directory."""

    def __init__(self, directory: str | Path):
        self._dir = Path(directory)
        self._native = None
        if _lib() is not None:
            self._native = _LIB.ts_reader_open(str(self._dir).encode())
        else:
            raw = (self._dir / 'index.bin').read_bytes()
            self._index = [struct.unpack_from('<IQQ', raw, i) for i in range(0, len(raw), 20)]

    def __len__(self) -> int:
        if self._native is not None:
            return int(_LIB.ts_reader_count(self._native))
        return len(self._index)

    def get(self, i: int) -> bytes:
        """Read frame ``i`` verbatim (raises IndexError if unreadable)."""
        if self._native is not None:
            n = int(_LIB.ts_reader_length(self._native, i))
            buf = ctypes.create_string_buffer(n)
            got = _LIB.ts_reader_get(self._native, i, buf, n)
            if got < 0:
                raise IndexError(f'frame {i} unreadable')
            return buf.raw[:got]
        shard, off, length = self._index[i]
        with open(self._dir / f'shard_{shard:06d}.bin', 'rb') as f:
            f.seek(off)
            magic, ln = struct.unpack('<IQ', f.read(12))
            assert magic == _MAGIC and ln == length, 'corrupt frame'
            return f.read(ln)

    def get_arrays(self, i: int) -> list[np.ndarray]:
        """Read frame ``i`` and decode it as a list of arrays."""
        return unpack_arrays(self.get(i))

    def close(self) -> None:
        """Release the native reader handle (no-op for the Python path)."""
        if self._native is not None:
            _LIB.ts_reader_close(self._native)
            self._native = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

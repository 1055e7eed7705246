"""Native host runtime bindings (csrc/sss_host.cpp via ctypes).

The device runs the scan tiers; this module is the *host* side of the
framework — the role the reference's C++ library plays on CPU (reference:
src/simd_scan.hpp:46-120 public API).  Uses:

- **Fast ingest**: pack a column on the host (OpenMP, memory-bound) before
  device upload, instead of burning device time on packing.
- **Independent verification**: a C++ oracle with no JAX in the loop, used
  by the conformance tests to cross-check the jnp oracle and the device
  tiers (three independent implementations must agree byte-for-byte).
- **Host fallback**: scans without any accelerator present.

The library is compiled on first use with ``make`` (g++, -O3 -fopenmp).
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import threading

import numpy as np

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_LIB_PATH = _CSRC / "libsss_host.so"
_lock = threading.Lock()
_lib = None


class HostLibraryUnavailable(RuntimeError):
    pass


def _build() -> None:
    try:
        subprocess.run(
            ["make", "-s"], cwd=_CSRC, check=True, capture_output=True, text=True
        )
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise HostLibraryUnavailable(f"building libsss_host.so failed: {detail}")


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _LIB_PATH.exists() or (
            _LIB_PATH.stat().st_mtime < (_CSRC / "sss_host.cpp").stat().st_mtime
        ):
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.sss_pack.argtypes = [u32p, ctypes.c_uint64, ctypes.c_int, u8p]
        lib.sss_unpack.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int, u32p]
        lib.sss_scan.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int,
                                 ctypes.c_uint32, u8p]
        lib.sss_scan.restype = ctypes.c_uint64
        lib.sss_shared_scan.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int,
                                        u32p, ctypes.c_int, u8p, u64p]
        lib.sss_interleave.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int,
                                       ctypes.c_uint64, u8p]
        lib.sss_version.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except HostLibraryUnavailable:
        return False


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def pack_bytes(values: np.ndarray, width: int) -> bytes:
    """Pack a uint32 column into the canonical LSB-first payload bytes."""
    lib = _load()
    values = np.ascontiguousarray(values, dtype=np.uint32)
    n = values.shape[0]
    nbytes = (n * width + 7) // 8
    out = np.zeros(nbytes + 8, dtype=np.uint8)  # small slack for chunk tails
    lib.sss_pack(_u32(values), n, width, _u8(out))
    return out[:nbytes].tobytes()


def unpack_bytes(data: bytes, n: int, width: int) -> np.ndarray:
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    need = (n * width + 7) // 8
    if buf.shape[0] < need + 8:  # decoder may read up to 8 slack bytes
        buf = np.concatenate([buf, np.zeros(need + 8 - buf.shape[0], np.uint8)])
    buf = np.ascontiguousarray(buf)
    out = np.empty(n, dtype=np.uint32)
    lib.sss_unpack(_u8(buf), n, width, _u32(out))
    return out


def scan_bytes(data: bytes, n: int, width: int, key: int) -> tuple[bytes, int]:
    """-> (LSB-first match bitvector payload bytes, hit count)."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    need = (n * width + 7) // 8
    if buf.shape[0] < need + 8:
        buf = np.concatenate([buf, np.zeros(need + 8 - buf.shape[0], np.uint8)])
    buf = np.ascontiguousarray(buf)
    bits = np.zeros((n + 7) // 8, dtype=np.uint8)
    hits = lib.sss_scan(_u8(buf), n, width, key, _u8(bits))
    return bits.tobytes(), int(hits)


def shared_scan_bytes(
    data: bytes, n: int, width: int, keys
) -> tuple[list[bytes], list[int]]:
    """k-predicate shared scan -> (k bitvector payloads, k hit counts)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    k = keys.shape[0]
    buf = np.frombuffer(data, dtype=np.uint8)
    need = (n * width + 7) // 8
    if buf.shape[0] < need + 8:
        buf = np.concatenate([buf, np.zeros(need + 8 - buf.shape[0], np.uint8)])
    buf = np.ascontiguousarray(buf)
    stride = (n + 7) // 8
    bits = np.zeros(k * stride, dtype=np.uint8)
    counts = np.zeros(k, dtype=np.uint64)
    lib.sss_shared_scan(
        _u8(buf), n, width, _u32(keys), k, _u8(bits),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return (
        [bits[j * stride : (j + 1) * stride].tobytes() for j in range(k)],
        [int(c) for c in counts],
    )


def interleave_bytes(bitvectors: np.ndarray, nbytes: int | None = None) -> np.ndarray:
    """(k, stride) uint8 bitvector payload rows -> linear layout bytes
    ``out[g*k + j]`` = byte g of row j (AVX2 byte transpose, OpenMP).

    The host half of the linear-export path (reference byte order,
    simd_scan_shared_linear.cpp:57): fetch the device-native (k, W) match
    words, view them as (k, stride) bytes, and interleave here instead of
    paying the device relayout — see ops.scan.interleave_linear for the
    device-side alternative."""
    lib = _load()
    bitvectors = np.ascontiguousarray(bitvectors, dtype=np.uint8)
    if bitvectors.ndim != 2:
        raise ValueError("bitvectors must be (k, stride) uint8")
    k, stride = bitvectors.shape
    if nbytes is None:
        nbytes = stride
    if not (0 <= nbytes <= stride):
        raise ValueError(f"nbytes {nbytes} out of range for stride {stride}")
    out = np.empty(nbytes * k, dtype=np.uint8)
    lib.sss_interleave(_u8(bitvectors), stride, k, nbytes, _u8(out))
    return out


def pack_column(values: np.ndarray, width: int):
    """Pack on host -> PackedColumn (ready for layout.to_device upload)."""
    from shared_simd_scan_tpu.layout import PackedColumn

    values = np.ascontiguousarray(values, dtype=np.uint32)
    return PackedColumn.from_bytes(pack_bytes(values, width), width,
                                   int(values.shape[0]))

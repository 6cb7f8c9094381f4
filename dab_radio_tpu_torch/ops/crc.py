"""Table-driven CRC engines (host-side NumPy, byte-at-a-time).

Generic MSB-first CRC with configurable width/poly/init/final-xor, matching
the reference's CRC_Calculator (src/dab/algorithms/crc.h:11-69). Instances
used across DAB:
  - FIB CRC16:        poly 0x1021, init 0xFFFF, final xor 0xFFFF (EN 300 401 5.2.1)
  - firecode CRC16:   poly 0x782F, init 0x0000  (ETSI TS 102 563, DAB+ superframe)
  - AU / data-group / packet CRC16: poly 0x1021, init 0xFFFF, xor 0xFFFF
"""

import ctypes
import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _crc16_table(poly: int) -> np.ndarray:
    lut = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i << 8
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if (crc & 0x8000) else (crc << 1)
            crc &= 0xFFFF
        lut[i] = crc
    return lut


@functools.lru_cache(maxsize=None)
def _crc16_table_u16(poly: int) -> np.ndarray:
    return np.ascontiguousarray(_crc16_table(poly).astype(np.uint16))


@functools.lru_cache(maxsize=None)
def _crc16_table_address(poly: int) -> int:
    return _crc16_table_u16(poly).ctypes.data


@functools.lru_cache(maxsize=1)
def _native_crc():
    from ..host.native import io_lib
    lib = io_lib()
    return lib if lib is not None and hasattr(lib, "crc16_block") else None


@functools.lru_cache(maxsize=1)
def _native_crc_blocks():
    from ..host.native import io_lib
    lib = io_lib()
    return lib if lib is not None and hasattr(lib, "crc16_blocks") else None


def crc16_bounds(buf: np.ndarray, bounds: np.ndarray, poly: int = 0x1021,
                 init: int = 0xFFFF, final_xor: int = 0xFFFF) -> np.ndarray:
    """CRC16 of each block buf[bounds[i]:bounds[i + 1]] of a uint8 array,
    read in place in one native call -> (len(bounds) - 1,) uint16. A block
    whose bounds go back is empty; every bound lies inside buf."""
    buf = np.ascontiguousarray(buf, np.uint8)
    bounds = np.ascontiguousarray(bounds, np.int64)
    m = max(len(bounds) - 1, 0)
    out = np.empty(m, np.uint16)
    if not m:
        return out
    lib = _native_crc_blocks()
    if lib is None:
        edges = bounds.tolist()
        for i in range(m):
            out[i] = crc16(buf[edges[i]:max(edges[i], edges[i + 1])],
                           poly, init, final_xor)
        return out
    lib.crc16_blocks(_pointer(buf), _pointer(bounds), m,
                     _crc16_table_address(poly), init, final_xor,
                     _pointer(out))
    return out


def _pointer(a: np.ndarray):
    """A contiguous array's data as a pointer argument: a reference to a
    ctypes view of it where it is writable (a few times cheaper than
    a.ctypes.data, which a read-only array takes)."""
    try:
        return ctypes.byref(ctypes.c_char.from_buffer(a))
    except TypeError:
        return a.ctypes.data


def crc16(data, poly: int = 0x1021, init: int = 0xFFFF, final_xor: int = 0xFFFF) -> int:
    """CRC16 over a byte buffer (bytes | np.uint8 array)."""
    buf = np.frombuffer(data, dtype=np.uint8) \
        if isinstance(data, (bytes, bytearray)) \
        else np.ascontiguousarray(data, dtype=np.uint8)
    lib = _native_crc()
    if lib is not None:
        lut = _crc16_table_u16(poly)
        return int(lib.crc16_block(buf.ctypes.data, buf.shape[0],
                                   lut.ctypes.data, init, final_xor))
    lut = _crc16_table(poly)
    crc = init
    for b in buf.tolist():
        crc = ((crc << 8) & 0xFFFF) ^ int(lut[((crc >> 8) ^ b) & 0xFF])
    return crc ^ final_xor


def crc16_check(data_with_crc) -> bool:
    """Validate a buffer whose last two bytes are the big-endian CRC16
    (FIB / access-unit / MSC data-group convention)."""
    buf = np.asarray(bytearray(data_with_crc)
                     if isinstance(data_with_crc, (bytes, bytearray))
                     else data_with_crc, dtype=np.uint8)
    if buf.shape[-1] < 2:
        return False
    rx = (int(buf[-2]) << 8) | int(buf[-1])
    return crc16(buf[:-2]) == rx


def crc16_batch(data: np.ndarray, poly: int = 0x1021, init: int = 0xFFFF,
                final_xor: int = 0xFFFF) -> np.ndarray:
    """Vectorized CRC16 over rows: (B, L) uint8 -> (B,) uint16. The byte
    loop runs L numpy steps over all rows at once (the serving fleet checks
    thousands of FIBs per round; scalar crc16 was the host hot spot)."""
    d = np.asarray(data, dtype=np.uint8)
    lut = _crc16_table(poly)
    crc = np.full(d.shape[0], init, np.uint32)
    for i in range(d.shape[1]):
        crc = ((crc << 8) & 0xFFFF) ^ lut[((crc >> 8) ^ d[:, i]) & 0xFF]
    return (crc ^ final_xor).astype(np.uint16)


def crc16_check_batch(data_with_crc: np.ndarray) -> np.ndarray:
    """(B, L) rows whose last two bytes are the big-endian CRC16 ->
    (B,) bool validity mask."""
    d = np.asarray(data_with_crc, dtype=np.uint8)
    rx = (d[:, -2].astype(np.uint32) << 8) | d[:, -1]
    return crc16_batch(d[:, :-2]) == rx


def firecode_crc16(data) -> int:
    """DAB+ firecode (ETSI TS 102 563): poly 0x782F, init 0, no final xor."""
    return crc16(data, poly=0x782F, init=0x0000, final_xor=0x0000)

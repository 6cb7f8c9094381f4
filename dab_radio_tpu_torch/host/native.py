"""ctypes bindings for the native host components (native/*.cpp).

Builds the shared libraries on first use (g++ is in the image); every entry
point has a NumPy fallback so the framework degrades gracefully without a
toolchain; ``native_status`` says which of the two is in use. A copy of
``dab_radio_tpu/host/native.py``: it loads the same ``native/`` sources and
``native/build/*.so`` at the root of the checkout.
"""

import ctypes
import functools
import os
import subprocess
import sys

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")


def _build(target: str):
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, target],
                       check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:
        print(f"# native build failed for {target}: {e}", file=sys.stderr)
        return False


def _stale(so_path: str, *sources: str) -> bool:
    """True when the .so is missing or older than its sources — the only
    cases worth spawning make for (hosts with the prebuilt .so and no
    toolchain must stay silent and fast)."""
    if not os.path.exists(so_path):
        return True
    t = os.path.getmtime(so_path)
    return any(os.path.exists(s) and os.path.getmtime(s) > t
               for s in (*sources, os.path.join(_NATIVE_DIR, "Makefile")))


@functools.lru_cache(maxsize=1)
def io_lib():
    path = os.path.join(_BUILD_DIR, "libdabio.so")
    if _stale(path, os.path.join(_NATIVE_DIR, "io_kernels.cpp")) \
            and not _build("build/libdabio.so") and not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.iq_convert.restype = ctypes.c_int64
    lib.iq_convert.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int, ctypes.c_void_p]
    lib.iq_quantize_u8.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p]
    lib.soft_to_hard.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_void_p]
    lib.hard_to_soft.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int8, ctypes.c_void_p]
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_int64]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_close.argtypes = [ctypes.c_void_p]
    lib.ring_write.restype = ctypes.c_int64
    lib.ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.ring_read.restype = ctypes.c_int64
    lib.ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.ring_size.restype = ctypes.c_int64
    lib.ring_size.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "ps_allpass"):      # absent only in a stale pre-built .so
        lib.ps_ducker.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_double, ctypes.c_double,
                                  ctypes.c_double, ctypes.c_void_p]
        lib.ps_allpass.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_void_p]
    if hasattr(lib, "crc16_block"):     # absent only in a stale pre-built .so
        lib.crc16_block.restype = ctypes.c_uint32
        lib.crc16_block.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_uint32,
                                    ctypes.c_uint32]
    if hasattr(lib, "crc16_blocks"):
        lib.crc16_blocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_void_p,
                                     ctypes.c_uint32, ctypes.c_uint32,
                                     ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=1)
def codecs_lib():
    path = os.path.join(_BUILD_DIR, "libdabcodecs.so")
    if not os.path.exists(path) and not _build("build/libdabcodecs.so"):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.dec_open.restype = ctypes.c_void_p
    lib.dec_open.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.dec_close.argtypes = [ctypes.c_void_p]
    lib.dec_decode.restype = ctypes.c_int64
    lib.dec_decode.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                               ctypes.c_void_p, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.POINTER(ctypes.c_int32)]
    lib.dec_decode_f32.restype = ctypes.c_int64
    lib.dec_decode_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int32, ctypes.c_void_p,
                                   ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int32),
                                   ctypes.POINTER(ctypes.c_int32)]
    lib.enc_open.restype = ctypes.c_void_p
    lib.enc_open.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int]
    lib.enc_close.argtypes = [ctypes.c_void_p]
    lib.enc_frame_size.restype = ctypes.c_int32
    lib.enc_frame_size.argtypes = [ctypes.c_void_p]
    lib.enc_extradata.restype = ctypes.c_int32
    lib.enc_extradata.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int32]
    lib.enc_encode.restype = ctypes.c_int32
    lib.enc_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int32, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_void_p,
                               ctypes.c_int32]
    return lib


# ---------------- IQ conversion ----------------

IQ_FORMATS = {
    "u8": 0, "s8": 1, "u16le": 2, "s16le": 3, "u16be": 4, "s16be": 5,
    "u32le": 6, "s32le": 7, "u32be": 8, "s32be": 9,
    "f32le": 10, "f32be": 11, "f64le": 12, "f64be": 13,
}
_FORMAT_ITEMSIZE = {0: 1, 1: 1, 2: 2, 3: 2, 4: 2, 5: 2, 6: 4, 7: 4, 8: 4,
                    9: 4, 10: 4, 11: 4, 12: 8, 13: 8}


def iq_convert(raw: bytes, fmt: str = "u8") -> np.ndarray:
    """Raw interleaved IQ bytes -> complex64 normalised to ~[-1,1]."""
    code = IQ_FORMATS[fmt]
    item = _FORMAT_ITEMSIZE[code]
    nb_floats = (len(raw) // item)
    nb_samples = nb_floats // 2
    lib = io_lib()
    if lib is not None:
        buf = np.frombuffer(raw, dtype=np.uint8)
        out = np.empty(nb_samples * 2, dtype=np.float32)
        n = lib.iq_convert(buf.ctypes.data, buf.shape[0], code,
                           out.ctypes.data)
        assert n == nb_samples
        return out.view(np.complex64)
    # numpy fallback
    dt = {0: np.uint8, 1: np.int8, 2: "<u2", 3: "<i2", 4: ">u2", 5: ">i2",
          6: "<u4", 7: "<i4", 8: ">u4", 9: ">i4", 10: "<f4", 11: ">f4",
          12: "<f8", 13: ">f8"}[code]
    x = np.frombuffer(raw, dtype=dt)[: nb_samples * 2].astype(np.float32)
    if code in (0, 2, 4, 6, 8):
        bias = {1: 127.5, 2: 32767.5, 4: 2147483647.5}[item]
        x = (x - np.float32(bias)) / np.float32(bias)
    elif code in (1, 3, 5, 7, 9):
        scale = {1: 127.0, 2: 32767.0, 4: 2147483647.0}[item]
        x = x / np.float32(scale)
    return x.view(np.complex64) if x.dtype == np.float32 else \
        x.astype(np.float32).view(np.complex64)


def iq_quantize_u8(iq: np.ndarray) -> bytes:
    x = np.ascontiguousarray(iq, dtype=np.complex64).view(np.float32)
    lib = io_lib()
    if lib is not None:
        out = np.empty(x.shape[0], dtype=np.uint8)
        lib.iq_quantize_u8(x.ctypes.data, x.shape[0], out.ctypes.data)
        return out.tobytes()
    return np.clip(x * 127.5 + 127.5, 0, 255).astype(np.uint8).tobytes()


def soft_to_hard(soft: np.ndarray) -> bytes:
    soft = np.ascontiguousarray(soft, dtype=np.int8)
    lib = io_lib()
    if lib is not None:
        out = np.empty(soft.shape[0] // 8, dtype=np.uint8)
        lib.soft_to_hard(soft.ctypes.data, soft.shape[0], out.ctypes.data)
        return out.tobytes()
    return np.packbits((soft > 0).astype(np.uint8)).tobytes()


def hard_to_soft(packed: bytes, nb_bits: int, high: int = 127) -> np.ndarray:
    lib = io_lib()
    if lib is not None:
        buf = np.frombuffer(packed, dtype=np.uint8)
        out = np.empty(nb_bits, dtype=np.int8)
        lib.hard_to_soft(buf.ctypes.data, nb_bits, high, out.ctypes.data)
        return out
    bits = np.unpackbits(np.frombuffer(packed, dtype=np.uint8))[:nb_bits]
    return np.where(bits > 0, high, -high).astype(np.int8)


class NativeRingBuffer:
    """Blocking SPSC byte ring for host ingest pipelines."""

    def __init__(self, capacity: int):
        lib = io_lib()
        if lib is None:
            raise RuntimeError("native io library unavailable")
        self._lib = lib
        self._h = lib.ring_create(capacity)

    def write(self, data: bytes) -> int:
        buf = np.frombuffer(data, dtype=np.uint8)
        return self._lib.ring_write(self._h, buf.ctypes.data, buf.shape[0])

    def read(self, n: int) -> bytes:
        out = np.empty(n, dtype=np.uint8)
        got = self._lib.ring_read(self._h, out.ctypes.data, n)
        return out[:got].tobytes()

    def close(self):
        self._lib.ring_close(self._h)

    def __len__(self):
        return int(self._lib.ring_size(self._h))

    def __del__(self):
        try:
            self._lib.ring_destroy(self._h)
        except Exception:
            pass


@functools.lru_cache(maxsize=1)
def fig_lib():
    """Native FIG parser (native/fig_parser.cpp); None if unavailable."""
    path = os.path.join(_BUILD_DIR, "libdabfig.so")
    if not os.path.exists(path) and not _build("build/libdabfig.so"):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.fig_parse.restype = ctypes.c_int64
    lib.fig_parse.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_void_p, ctypes.c_int64]
    return lib


def native_status() -> dict:
    """Which implementation each native host library runs as: ``"shared
    library"`` when its ``.so`` loaded, ``"numpy"`` when the NumPy fallback
    is in use (for ``dabcodecs``, which has none: ``"unavailable"``)."""
    return {
        "dabio": "shared library" if io_lib() is not None else "numpy",
        "dabfig": "shared library" if fig_lib() is not None else "numpy",
        "dabcodecs": ("shared library" if codecs_lib() is not None
                      else "unavailable"),
    }

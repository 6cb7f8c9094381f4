"""Tuner device layer.

Parity surface: reference examples/device/ (rtlsdr wrapper with gain
search, center frequency, async reader thread + data callback) and
examples/block_frequencies.h (DAB channel table). librtlsdr is bound via
ctypes when present; FileDevice replays captures at real-time rate for
hardware-free operation.
"""

import ctypes
import ctypes.util
import threading
import time
from typing import Callable, List, Optional

import numpy as np

SAMPLE_RATE = 2_048_000

# DAB channel table (ETSI blocks; reference examples/block_frequencies.h)
BLOCK_FREQUENCIES = {}
# Band I and Band III: irregular grids, listed explicitly
BLOCK_FREQUENCIES.update({
    "2A": 47936000, "2B": 49648000, "2C": 51360000, "2D": 53072000,
    "3A": 54928000, "3B": 56640000, "3C": 58352000, "3D": 60064000,
    "4A": 61936000, "4B": 63648000, "4C": 65360000, "4D": 67072000,
    "5A": 174928000, "5B": 176640000, "5C": 178352000, "5D": 180064000,
    "6A": 181936000, "6B": 183648000, "6C": 185360000, "6D": 187072000,
    "7A": 188928000, "7B": 190640000, "7C": 192352000, "7D": 194064000,
    "8A": 195936000, "8B": 197648000, "8C": 199360000, "8D": 201072000,
    "9A": 202928000, "9B": 204640000, "9C": 206352000, "9D": 208064000,
    "10A": 209936000, "10N": 210096000, "10B": 211648000, "10C": 213360000,
    "10D": 215072000,
    "11A": 216928000, "11N": 217088000, "11B": 218640000, "11C": 220352000,
    "11D": 222064000,
    "12A": 223936000, "12N": 224096000, "12B": 225648000, "12C": 227360000,
    "12D": 229072000,
    "13A": 230784000, "13B": 232496000, "13C": 234208000, "13D": 235776000,
    "13E": 237488000, "13F": 239200000,
})
# L-Band
for j in range(23):
    BLOCK_FREQUENCIES[f"L{chr(ord('A') + j)}"] = 1452960000 + j * 1712000


def list_devices():
    """Enumerate connected RTL-SDR tuners (reference
    examples/device/device_list.cpp:refresh): returns a list of dicts
    {index, vendor, product, serial, name}. Empty when librtlsdr is not
    installed or no tuner is plugged in — callers can render a device
    picker without special-casing hardware-free hosts."""
    path = ctypes.util.find_library("rtlsdr")
    if path is None:
        return []
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return []
    out = []
    n = lib.rtlsdr_get_device_count()
    for i in range(n):
        vendor = ctypes.create_string_buffer(256)
        product = ctypes.create_string_buffer(256)
        serial = ctypes.create_string_buffer(256)
        ok = lib.rtlsdr_get_device_usb_strings(i, vendor, product, serial)
        lib.rtlsdr_get_device_name.restype = ctypes.c_char_p
        name = lib.rtlsdr_get_device_name(i) or b""
        out.append({
            "index": i,
            "vendor": vendor.value.decode(errors="replace") if ok == 0 else "",
            "product": product.value.decode(errors="replace") if ok == 0 else "",
            "serial": serial.value.decode(errors="replace") if ok == 0 else "",
            "name": name.decode(errors="replace"),
        })
    return out


class Device:
    """Abstract tuner: subclasses push u8-IQ-derived complex64 blocks into
    the registered callbacks from a reader thread."""

    def __init__(self):
        self.on_data: List[Callable[[np.ndarray], None]] = []
        self.on_frequency_change: List[Callable[[str, int], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def set_center_frequency(self, label: str, freq_hz: int):
        for cb in self.on_frequency_change:
            cb(label, freq_hz)

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return               # double-start would fork a second reader
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self):
        raise NotImplementedError


class FileDevice(Device):
    """Replays a raw u8 IQ capture, optionally paced to real time."""

    def __init__(self, path: str, fmt: str = "u8", realtime: bool = True,
                 block_samples: int = 65536, loop: bool = False):
        super().__init__()
        self.path, self.fmt = path, fmt
        self.realtime = realtime
        self.block_samples = block_samples
        self.loop = loop

    def _run(self):
        from .native import iq_convert, _FORMAT_ITEMSIZE, IQ_FORMATS
        item = _FORMAT_ITEMSIZE[IQ_FORMATS[self.fmt]]
        blk = self.block_samples * 2 * item
        while self._running:
            with open(self.path, "rb") as f:
                while self._running:
                    raw = f.read(blk)
                    if not raw:
                        break
                    iq = iq_convert(raw, self.fmt)
                    for cb in self.on_data:
                        cb(iq)
                    if self.realtime:
                        time.sleep(iq.shape[0] / SAMPLE_RATE)
            if not self.loop:
                break
        self._running = False


class RTLSDRDevice(Device):
    """librtlsdr tuner (reference examples/device/device.cpp). Available only
    when the shared library is installed; raises otherwise."""

    def __init__(self, index: int = 0):
        super().__init__()
        path = ctypes.util.find_library("rtlsdr")
        if path is None:
            raise RuntimeError("librtlsdr not available on this system")
        self._lib = lib = ctypes.CDLL(path)
        dev = ctypes.c_void_p()
        if lib.rtlsdr_open(ctypes.byref(dev), index) != 0:
            raise RuntimeError("rtlsdr_open failed")
        self._dev = dev
        lib.rtlsdr_set_sample_rate(dev, SAMPLE_RATE)
        lib.rtlsdr_set_tuner_gain_mode(dev, 1)
        self.gains = self._search_gains()
        if self.gains:
            self.set_gain(self.gains[len(self.gains) * 3 // 4])
        lib.rtlsdr_reset_buffer(dev)

    def _search_gains(self):
        n = self._lib.rtlsdr_get_tuner_gains(self._dev, None)
        if n <= 0:
            return []
        buf = (ctypes.c_int * n)()
        self._lib.rtlsdr_get_tuner_gains(self._dev, buf)
        return [g / 10.0 for g in buf]

    def set_gain(self, gain_db: float):
        self._lib.rtlsdr_set_tuner_gain_mode(self._dev, 1)
        self._lib.rtlsdr_set_tuner_gain(self._dev, int(gain_db * 10))

    def set_auto_gain(self):
        """Hardware AGC (reference rtl_sdr.cpp verbose_auto_gain)."""
        self._lib.rtlsdr_set_tuner_gain_mode(self._dev, 0)

    def set_ppm(self, ppm: int):
        """Frequency-correction in parts-per-million (rtl_sdr.cpp --ppm)."""
        if ppm:
            self._lib.rtlsdr_set_freq_correction(self._dev, int(ppm))

    def set_bias_tee(self, enable: bool):
        """DC supply for active antennas (rtl_sdr.cpp --enable-bias-tee);
        older librtlsdr builds lack the symbol — reported, not fatal."""
        fn = getattr(self._lib, "rtlsdr_set_bias_tee", None)
        if fn is None:
            raise RuntimeError("librtlsdr too old for bias tee control")
        fn(self._dev, 1 if enable else 0)

    def set_offset_tuning(self, enable: bool):
        self._lib.rtlsdr_set_offset_tuning(self._dev, 1 if enable else 0)

    def set_direct_sampling(self, mode: int):
        """0 = IQ (default), 1 = I-branch, 2 = Q-branch
        (rtl_sdr.cpp --sampling-mode)."""
        self._lib.rtlsdr_set_direct_sampling(self._dev, int(mode))

    def set_sample_rate(self, rate_hz: int):
        self._lib.rtlsdr_set_sample_rate(self._dev, int(rate_hz))

    def set_center_frequency(self, label: str, freq_hz: int):
        self._lib.rtlsdr_set_center_freq(self._dev, int(freq_hz))
        super().set_center_frequency(label, freq_hz)

    def _run(self):
        from .native import iq_convert
        READ = 65536
        buf = (ctypes.c_uint8 * READ)()
        nread = ctypes.c_int(0)
        while self._running:
            r = self._lib.rtlsdr_read_sync(self._dev, buf, READ,
                                           ctypes.byref(nread))
            if r != 0:
                break
            raw = bytes(bytearray(buf)[: nread.value])
            iq = iq_convert(raw, "u8")
            for cb in self.on_data:
                cb(iq)

"""Native-backed FIG parser: drop-in for fig.FIGParser.

Decodes the packed record stream emitted by native/fig_parser.cpp into the
same event dataclasses as fig.py (differential-fuzzed equal in
tests/test_fig_native.py). Label charset decoding stays here — it is
table-driven and cold. Falls back to the pure-Python parser when the shared
library is unavailable.
"""

import struct

import numpy as np

from ..host.native import fig_lib
from .charsets import decode_label, abbreviated_label
from .fig import (
    FIGParser, EnsembleInfo, SubchannelShort, SubchannelLong, StreamComponent,
    PacketComponentRef, PacketComponent, StreamCA, ComponentLanguage,
    ServiceLinkage, ConfigurationInfo, ComponentGlobalDefinition,
    EnsembleCountry, DateTime, UserApplication, SubchannelFEC, ProgrammeType,
    FrequencyInfo, OtherEnsembleService, Label,
)

_LABEL_KINDS = ("ensemble", "service", "component")


class NativeFIGParser:
    """parse_fib via the C++ parser; identical event stream to FIGParser.

    FIBs repeat on the FIG carousel (labels/config re-broadcast every ~1 s),
    so parses are memoized on the FIB bytes; consumers treat the event
    objects as immutable (the database updater only reads them)."""

    def __init__(self, cache_size: int = 4096):
        self._lib = fig_lib()
        self._fallback = FIGParser() if self._lib is None else None
        self._out = np.empty(4096, dtype=np.uint8)
        self._cache = {}
        self._cache_size = cache_size

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    # ctypes handles and the memo cache don't checkpoint; rebuild on load
    def __getstate__(self):
        return {"cache_size": self._cache_size}

    def __setstate__(self, state):
        self.__init__(cache_size=state.get("cache_size", 4096))

    def parse_fib(self, fib: bytes) -> list:
        key = bytes(fib)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        events = self._parse_uncached(key)
        if len(self._cache) >= self._cache_size:
            self._cache.clear()
        self._cache[key] = events
        return events

    def _parse_uncached(self, fib: bytes) -> list:
        if self._fallback is not None:
            return self._fallback.parse_fib(fib)
        buf = np.frombuffer(bytes(fib), dtype=np.uint8)
        n = self._lib.fig_parse(buf.ctypes.data, buf.shape[0],
                                self._out.ctypes.data, self._out.shape[0])
        if n < 0:
            self._out = np.empty(self._out.shape[0] * 4, dtype=np.uint8)
            n = self._lib.fig_parse(buf.ctypes.data, buf.shape[0],
                                    self._out.ctypes.data, self._out.shape[0])
        return self._decode(self._out.tobytes()[:max(n, 0)])

    def _decode(self, rec: bytes) -> list:
        events = []
        i, n = 0, len(rec)
        u16 = lambda o: rec[o] | (rec[o + 1] << 8)
        u32 = lambda o: struct.unpack_from("<I", rec, o)[0]
        while i + 3 <= n:
            tag = rec[i]
            ln = u16(i + 1)
            p = i + 3
            i = p + ln
            if tag == 1:
                events.append(EnsembleInfo(u16(p), rec[p + 2], rec[p + 3],
                                           rec[p + 4], rec[p + 5]))
            elif tag == 2:
                events.append(SubchannelShort(rec[p], u16(p + 1), rec[p + 3],
                                              rec[p + 4]))
            elif tag == 3:
                events.append(SubchannelLong(rec[p], u16(p + 1), rec[p + 3],
                                             rec[p + 4], u16(p + 5)))
            elif tag == 4:
                events.append(StreamComponent(u32(p), rec[p + 4],
                                              bool(rec[p + 5]), rec[p + 6],
                                              bool(rec[p + 7])))
            elif tag == 5:
                events.append(PacketComponentRef(u32(p), u16(p + 4),
                                                 bool(rec[p + 6])))
            elif tag == 6:
                events.append(PacketComponent(u16(p), rec[p + 2], rec[p + 3],
                                              u16(p + 4), rec[p + 6]))
            elif tag == 7:
                events.append(StreamCA(rec[p], u16(p + 1)))
            elif tag == 8:
                if rec[p + 1]:
                    events.append(ComponentLanguage(rec[p],
                                                    subchannel_id=rec[p + 2]))
                else:
                    events.append(ComponentLanguage(rec[p], scid=u16(p + 3)))
            elif tag == 9:
                f = rec[p]
                ev = ServiceLinkage(bool(f & 1), bool(f & 2), bool(f & 4),
                                    u16(p + 1))
                ev.has_id_list = bool(rec[p + 3])
                n_sid, n_rds, n_drm = rec[p + 4], rec[p + 5], rec[p + 6]
                q = p + 7
                for _ in range(n_sid):
                    ev.service_ids.append(u32(q)); q += 4
                for _ in range(n_rds):
                    ev.rds_pi_ids.append(u16(q)); q += 2
                for _ in range(n_drm):
                    ev.drm_ids.append(u32(q)); q += 4
                events.append(ev)
            elif tag == 10:
                events.append(ConfigurationInfo(rec[p], u16(p + 1)))
            elif tag == 11:
                if rec[p + 5]:
                    events.append(ComponentGlobalDefinition(
                        u32(p), rec[p + 4], scid=u16(p + 6)))
                else:
                    events.append(ComponentGlobalDefinition(
                        u32(p), rec[p + 4], subchannel_id=u16(p + 6)))
            elif tag == 12:
                ev = EnsembleCountry(rec[p], rec[p + 1], rec[p + 2])
                ev.has_extension = bool(rec[p + 3])
                q = p + 5
                for _ in range(rec[p + 4]):
                    ev.service_ids.append(u32(q)); q += 4
                events.append(ev)
            elif tag == 13:
                events.append(DateTime(u32(p), rec[p + 4], rec[p + 5],
                                       rec[p + 6], u16(p + 7), rec[p + 9],
                                       rec[p + 10]))
            elif tag == 14:
                nb = rec[p + 7]
                events.append(UserApplication(u32(p), rec[p + 4], u16(p + 5),
                                              rec[p + 8: p + 8 + nb]))
            elif tag == 15:
                events.append(SubchannelFEC(rec[p], rec[p + 1]))
            elif tag == 16:
                events.append(ProgrammeType(u32(p), rec[p + 4], rec[p + 5],
                                            rec[p + 6]))
            elif tag == 17:
                events.append(FrequencyInfo(rec[p], u32(p + 1), u32(p + 5),
                                            bool(rec[p + 9]),
                                            geo_adjacent=bool(rec[p + 10] & 1),
                                            mode_one=bool(rec[p + 10] & 2)))
            elif tag == 18:
                events.append(OtherEnsembleService(u32(p), u16(p + 4),
                                                   bool(rec[p + 6])))
            elif tag == 19:
                kind = _LABEL_KINDS[rec[p]]
                idv = u32(p + 1)
                scids = rec[p + 6] if rec[p + 5] else None
                charset = rec[p + 7]
                flags = u16(p + 8)
                body = rec[p + 10: p + 26]
                events.append(Label(
                    kind, idv,
                    decode_label(body, charset).rstrip(),
                    abbreviated_label(body, flags, charset).rstrip(),
                    scids, charset))
        return events

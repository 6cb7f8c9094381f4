"""MOT (Multimedia Object Transfer, ETSI EN 301 234) entity reconstruction.

Parity surface: reference src/dab/mot/MOT_processor.{h,cpp} + MOT_assembler:
segmentation-header parse, per-transport-id segment assemblers in LRU caches
(20 transports / 200 headers), header mode and directory mode, header
extension parameters (content name, trigger/expire UTC time, user-app
params). Completed entities fire on_entity callbacks.
"""

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

# MOT data group types (EN 301 234)
ECM_EMM, HEADER, UNSCRAMBLED_BODY, SCRAMBLED_BODY = 0, 3, 4, 5
UNCOMPRESSED_DIRECTORY, COMPRESSED_DIRECTORY = 6, 7
_VALID_TYPES = {ECM_EMM, HEADER, UNSCRAMBLED_BODY, SCRAMBLED_BODY,
                UNCOMPRESSED_DIRECTORY, COMPRESSED_DIRECTORY}


def mjd_to_ymd(mjd: int):
    """Modified Julian Date -> (year, month, day) (reference
    modified_julian_date.h)."""
    jd = mjd + 2400001
    a = jd + 32044
    b = (4 * a + 3) // 146097
    c = a - 146097 * b // 4
    d = (4 * c + 3) // 1461
    e = c - 1461 * d // 4
    m = (5 * e + 2) // 153
    day = e - (153 * m + 2) // 5 + 1
    month = m + 3 - 12 * (m // 10)
    year = 100 * b + d - 4800 + m // 10
    return year, month, day


@dataclass
class MOTTime:
    exists: bool = False
    year: int = 0
    month: int = 0
    day: int = 0
    hours: int = 0
    minutes: int = 0
    seconds: int = 0
    milliseconds: int = 0


@dataclass
class MOTHeader:
    body_size: int = 0
    header_size: int = 0
    content_type: int = 0
    content_sub_type: int = 0
    content_name: Optional[str] = None
    trigger_time: MOTTime = field(default_factory=MOTTime)
    expire_time: MOTTime = field(default_factory=MOTTime)
    user_app_params: List[tuple] = field(default_factory=list)  # (id, bytes)


@dataclass
class MOTEntity:
    transport_id: int
    header: MOTHeader
    body: bytes


@dataclass
class DataGroupHeader:
    """Subset of the MSC data-group header MOT needs."""
    data_group_type: int
    continuity_index: int
    repetition_index: int
    is_last_segment: bool
    segment_number: int
    transport_id: int


class _LRU(OrderedDict):
    def __init__(self, max_size):
        super().__init__()
        self.max_size = max_size

    def __reduce__(self):
        # OrderedDict's default reduce calls __init__() argless; checkpoints
        # need the max_size + items round trip
        return (_LRU, (self.max_size,), None, None, iter(self.items()))

    def put(self, key, value):
        if key in self:
            self.move_to_end(key)
        self[key] = value
        while len(self) > self.max_size:
            self.popitem(last=False)


class SegmentAssembler:
    """Out-of-order segment collector (reference MOT_Assembler)."""

    def __init__(self):
        self.segments: Dict[int, bytes] = {}
        self.total: Optional[int] = None

    def set_total(self, n: int):
        self.total = n

    def add(self, index: int, data: bytes) -> bool:
        if self.total is not None and index >= self.total:
            return False
        if index in self.segments:
            return False
        self.segments[index] = bytes(data)
        return True

    def complete(self) -> bool:
        return (self.total is not None
                and all(i in self.segments for i in range(self.total)))

    def data(self) -> bytes:
        return b"".join(self.segments[i] for i in range(self.total))


class MOTProcessor:
    def __init__(self, max_transports: int = 20, max_headers: int = 200):
        self.assemblers = _LRU(max_transports)   # tid -> {type: SegmentAssembler}
        self.headers = _LRU(max_headers)         # tid -> MOTHeader
        self.on_entity: List[Callable[[MOTEntity], None]] = []

    def __getstate__(self):
        """Checkpoint contract (SURVEY §5.4): assembly state pickles,
        external observers (scraper/slideshow hooks, possibly holding
        file handles) don't — re-attach on_entity after restore."""
        d = dict(self.__dict__)
        d["on_entity"] = []
        return d

    def process_data_group(self, hdr: DataGroupHeader, buf: bytes):
        if len(buf) < 2 or hdr.data_group_type not in _VALID_TYPES:
            return
        segment_size = ((buf[0] & 0b11111) << 8) | buf[1]
        data = buf[2:]
        if len(data) != segment_size:
            return

        table = self.assemblers.get(hdr.transport_id)
        if table is None:
            table = {}
            self.assemblers.put(hdr.transport_id, table)
        asm = table.setdefault(hdr.data_group_type, SegmentAssembler())
        if hdr.is_last_segment:
            asm.set_total(hdr.segment_number + 1)
        if not asm.add(hdr.segment_number, data) or not asm.complete():
            return

        if hdr.data_group_type == UNCOMPRESSED_DIRECTORY:
            self._process_directory(asm.data())
        elif hdr.data_group_type == HEADER:
            header = MOTHeader()
            if self._parse_header(header, asm.data()) is not None:
                self.headers.put(hdr.transport_id, header)
                self._check_body(hdr.transport_id)
        elif hdr.data_group_type == UNSCRAMBLED_BODY:
            self._check_body(hdr.transport_id)

    def _check_body(self, tid: int):
        table = self.assemblers.get(tid)
        header = self.headers.get(tid)
        if table is None or header is None:
            return
        asm = table.get(UNSCRAMBLED_BODY)
        if asm is None or not asm.complete():
            return
        body = asm.data()
        if header.body_size != len(body):
            return
        entity = MOTEntity(tid, header, body)
        for cb in self.on_entity:
            cb(entity)

    def _process_directory(self, buf: bytes):
        """MOT directory mode (figure 30): directory extension + a list of
        (transport_id, header) entries."""
        if len(buf) < 13:
            return
        total_objects = (buf[4] << 8) | buf[5]
        dir_ext_len = (buf[11] << 8) | buf[12]
        buf = buf[13:]
        if len(buf) < dir_ext_len:
            return
        buf = buf[dir_ext_len:]
        for _ in range(total_objects):
            if len(buf) < 2:
                break
            tid = (buf[0] << 8) | buf[1]
            buf = buf[2:]
            header = MOTHeader()
            read = self._parse_header(header, buf)
            if read is None:
                break
            self.headers.put(tid, header)
            if tid in self.assemblers:
                self._check_body(tid)
            buf = buf[read:]

    def _parse_header(self, entity: MOTHeader, buf: bytes) -> Optional[int]:
        """Header core + extension parameters; returns header_size."""
        if len(buf) < 7:
            return None
        entity.body_size = (buf[0] << 20) | (buf[1] << 12) | (buf[2] << 4) \
            | (buf[3] >> 4)
        entity.header_size = ((buf[3] & 0xF) << 9) | (buf[4] << 1) | (buf[5] >> 7)
        entity.content_type = (buf[5] >> 1) & 0b111111
        entity.content_sub_type = ((buf[5] & 1) << 8) | buf[6]
        if entity.header_size < 7 or len(buf) < entity.header_size:
            return None
        data = buf[7:entity.header_size]

        while data:
            pli = (data[0] >> 6) & 0b11
            pid = data[0] & 0b111111
            data = data[1:]
            nb = {0b00: 0, 0b01: 1, 0b10: 4}.get(pli)
            if nb is None:                          # length indicator
                if not data:
                    break
                if data[0] & 0x80:
                    if len(data) < 2:
                        break
                    nb = ((data[0] & 0x7F) << 8) | data[1]
                    data = data[2:]
                else:
                    nb = data[0] & 0x7F
                    data = data[1:]
            if len(data) < nb:
                break
            fieldb = data[:nb]
            data = data[nb:]
            self._apply_param(entity, pid, fieldb)
        return entity.header_size

    def _apply_param(self, entity: MOTHeader, pid: int, buf: bytes):
        from .charsets import decode_label
        if 0b100101 <= pid <= 0b111111:             # user application params
            entity.user_app_params.append((pid, bytes(buf)))
        elif pid == 0b001100 and len(buf) >= 2:     # content name
            entity.content_name = decode_label(buf[1:], (buf[0] >> 4) & 0xF)
        elif pid in (0b000100, 0b000101) and len(buf) >= 4:
            t = self._parse_utc(buf)
            if t is not None:
                if pid == 0b000100:
                    entity.expire_time = t
                else:
                    entity.trigger_time = t

    @staticmethod
    def _parse_utc(buf: bytes) -> Optional[MOTTime]:
        t = MOTTime(exists=True)
        if not (buf[0] & 0x80):                      # zeroed = "now"
            return t
        mjd = ((buf[0] & 0x7F) << 10) | (buf[1] << 2) | (buf[2] >> 6)
        utc_flag = (buf[2] >> 3) & 1
        t.hours = ((buf[2] & 0b111) << 2) | (buf[3] >> 6)
        t.minutes = buf[3] & 0b111111
        if utc_flag:
            if len(buf) < 6:
                return None
            t.seconds = buf[4] >> 2
            t.milliseconds = ((buf[4] & 0b11) << 8) | buf[5]
        t.year, t.month, t.day = mjd_to_ymd(mjd)
        return t

"""Programme-associated data (PAD): F-PAD/X-PAD parse, dynamic labels,
data-group length indicators, and MOT over X-PAD.

Parity surface: reference src/dab/pad/ (pad_processor.cpp, pad_dynamic_label*
.cpp, pad_data_group.cpp, pad_data_length_indicator.cpp, pad_MOT_processor
.cpp): contents-indicator list persisted across frames for lenient
broadcasters, X-PAD byte-order un-reversal, CI length table {4,6,8,12,16,24,
32,48}, app-type routing per EN 300 401 table 11 with start->continuation CI
rewriting, label segment assembly with toggle-flag change detection, and
length-indicator-gated MOT data groups.
"""

from dataclasses import dataclass
from typing import Callable, List, Optional

from ..ops.crc import crc16
from .charsets import decode_label
from .mot import MOTProcessor, DataGroupHeader
from .packets import parse_data_group

CI_LENGTH_TABLE = [4, 6, 8, 12, 16, 24, 32, 48]
MAX_XPAD_BYTES = 196
MAX_CI = 4


class PADDataGroup:
    """Fixed-required-length byte accumulator with trailing CRC16."""

    def __init__(self):
        self.buf = bytearray()
        self.required = 0

    def reset(self, required: int = 0):
        self.buf.clear()
        self.required = required

    def consume(self, data: bytes) -> int:
        take = min(self.required - len(self.buf), len(data))
        self.buf.extend(data[:take])
        return take

    @property
    def complete(self) -> bool:
        return self.required > 0 and len(self.buf) >= self.required

    def check_crc(self) -> bool:
        if self.required < 2:
            return False
        b = bytes(self.buf[:self.required])
        return crc16(b[:-2]) == ((b[-2] << 8) | b[-1])

    def data(self) -> bytes:
        return bytes(self.buf[:self.required])


class DataLengthIndicator:
    """X-PAD app type 1: 4-byte (length + CRC) data group."""

    def __init__(self):
        self.group = PADDataGroup()
        self.group.reset(4)
        self.length: Optional[int] = None

    def reset(self):
        self.group.reset(4)
        self.length = None

    def process(self, buf: bytes):
        i = 0
        while i < len(buf):
            i += self.group.consume(buf[i:])
            if not self.group.complete:
                return
            if self.group.check_crc():
                d = self.group.data()
                self.length = ((d[0] & 0b111111) << 8) | d[1]
            self.group.reset(4)


class DynamicLabelAssembler:
    MAX_SEGMENTS = 8
    MAX_SEGMENT_BYTES = 16

    def __init__(self):
        self.reset()

    def reset(self):
        self.segments = {}
        self.total: Optional[int] = None
        self.charset = 0
        self.changed = True

    def set_total(self, n: int):
        if self.total != n:
            self.changed = True
        self.total = n

    def set_charset(self, cs: int):
        if self.charset != cs:
            self.changed = True
        self.charset = cs

    def update(self, seg_num: int, data: bytes) -> Optional[str]:
        if seg_num >= self.MAX_SEGMENTS or not (1 <= len(data) <= self.MAX_SEGMENT_BYTES):
            return None
        if self.segments.get(seg_num) != data:
            self.changed = True
        self.segments[seg_num] = bytes(data)
        if not self.changed or self.total is None:
            return None
        if not all(i in self.segments for i in range(self.total)):
            return None
        self.changed = False
        label = b"".join(self.segments[i] for i in range(self.total))
        return decode_label(label, self.charset)


class DynamicLabel:
    """X-PAD app types 2/3 (EN 300 401 clause 7.4.5.2)."""

    CLEAR = 0

    def __init__(self):
        self.group = PADDataGroup()
        self.state = "WAIT_START"
        self.group_type = "LABEL"
        self.assembler = DynamicLabelAssembler()
        self.prev_toggle = 0
        self.on_label: List[Callable[[str], None]] = []
        self.on_command: List[Callable[[int], None]] = []

    def process(self, is_start: bool, buf: bytes):
        i = 0
        while i < len(buf):
            i += self._consume(is_start, buf[i:])
            is_start = False

    def _consume(self, is_start: bool, buf: bytes) -> int:
        if self.state == "WAIT_START" and not is_start:
            return len(buf)
        if is_start:
            self.group.reset(4)
            self.state = "READ_LENGTH"
        read = 0
        if self.state == "READ_LENGTH":
            need_hdr = 2 - len(self.group.buf)
            if need_hdr > 0:
                take = min(need_hdr, len(buf))
                self.group.buf.extend(buf[:take])
                read += take
            if len(self.group.buf) >= 2:
                self._read_header()
                self.state = "READ_DATA"
        if self.state != "READ_DATA":
            return read
        read += self.group.consume(buf[read:])
        if not self.group.complete:
            return read
        if self.group.check_crc():
            if self.group_type == "LABEL":
                self._interpret_label()
            else:
                self._interpret_command()
        self.state = "WAIT_START"
        self.group.reset(4)
        return read

    def _read_header(self):
        b = self.group.buf
        toggle = (b[0] >> 7) & 1
        control = (b[0] >> 4) & 1
        if control:
            self.group.required = 4
            self.group_type = "COMMAND"
        else:
            length = b[0] & 0b1111
            self.group.required = 2 + 2 + length + 1
            self.group_type = "LABEL"
            if toggle != self.prev_toggle:
                self.prev_toggle = toggle
                self.assembler.reset()

    def _interpret_label(self):
        d = self.group.data()
        first_last = (d[0] >> 5) & 0b11
        field2 = (d[1] >> 4) & 0b1111
        is_first = bool(first_last & 0b10)
        is_last = bool(first_last & 0b01)
        seg_num = 0 if is_first else (field2 & 0b0111)
        if is_last:
            self.assembler.set_total(seg_num + 1)
        if is_first:
            self.assembler.set_charset(field2)
        label = self.assembler.update(seg_num, d[2:-2])
        if label is not None:
            for cb in self.on_label:
                cb(label)

    def _interpret_command(self):
        d = self.group.data()
        command = d[0] & 0b1111
        if command == 0:
            for cb in self.on_command:
                cb(self.CLEAR)


class PADMOTProcessor:
    """X-PAD app types 12/13 (+14/15 CA): length-gated MSC data groups
    feeding the MOT reconstructor."""

    def __init__(self, mot: Optional[MOTProcessor] = None):
        self.group = PADDataGroup()
        self.state = "WAIT_LENGTH"
        self.mot = mot or MOTProcessor()

    def set_group_length(self, length: int):
        if length == 0 or length < 4:
            self.group.reset()
            self.state = "WAIT_LENGTH"
            return
        self.group.reset(length)
        self.state = "WAIT_START"

    def process(self, is_start: bool, buf: bytes):
        i = 0
        while i < len(buf):
            i += self._consume(is_start, buf[i:])
            is_start = False

    def _consume(self, is_start: bool, buf: bytes) -> int:
        if self.state == "WAIT_LENGTH":
            return len(buf)
        if self.state == "WAIT_START" and not is_start:
            return len(buf)
        if is_start:
            self.state = "READ_DATA"
        read = self.group.consume(buf)
        if not self.group.complete:
            return read
        self._interpret()
        self.state = "WAIT_LENGTH"
        self.group.reset()
        return read

    def _interpret(self):
        res = parse_data_group(self.group.data())
        if not res.ok or not res.has_segment or not res.has_transport_id:
            return
        hdr = DataGroupHeader(res.data_group_type, res.continuity_index,
                              res.repetition_index, res.is_last_segment,
                              res.segment_number, res.transport_id)
        self.mot.process_data_group(hdr, res.data)


@dataclass
class _CI:
    length: int
    app_type: int


class PADProcessor:
    """F-PAD + X-PAD dispatcher (EN 300 401 clause 7.4)."""

    def __init__(self):
        self.ci_list: List[_CI] = []
        self.dynamic_label = DynamicLabel()
        self.data_length = DataLengthIndicator()
        self.mot = PADMOTProcessor()
        self._previous_mot_length = 0

    @property
    def on_label(self):
        return self.dynamic_label.on_label

    @property
    def on_mot_entity(self):
        return self.mot.mot.on_entity

    def process(self, fpad: bytes, xpad_reversed: bytes):
        if not xpad_reversed or len(xpad_reversed) > MAX_XPAD_BYTES:
            return
        if len(fpad) != 2:
            return
        fpad_type = (fpad[0] >> 6) & 0b11
        if fpad_type != 0:
            return
        ci_flag = (fpad[1] >> 1) & 1
        xpad_indicator = (fpad[0] >> 4) & 0b11

        xpad = bytes(reversed(xpad_reversed))
        if xpad_indicator == 0b01:
            self._short_xpad(xpad, bool(ci_flag))
        elif xpad_indicator == 0b10:
            self._variable_xpad(xpad, bool(ci_flag))

    def _short_xpad(self, xpad: bytes, has_ci: bool):
        i = 0
        if has_ci:
            if not xpad:
                return
            app_type = xpad[0] & 0b11111
            self.ci_list = [_CI(3, app_type)]
            i = 1
        if len(self.ci_list) != 1:
            self.ci_list = []
            return
        self._data_field(xpad[i:])
        self.ci_list[0].length = 4

    def _variable_xpad(self, xpad: bytes, has_ci: bool):
        i = 0
        if has_ci:
            self.ci_list = []
            for _ in range(MAX_CI):
                if i >= len(xpad):
                    break
                ci = xpad[i]
                i += 1
                app_type = ci & 0b11111
                if app_type == 0:
                    break
                self.ci_list.append(_CI(CI_LENGTH_TABLE[(ci >> 5) & 0b111],
                                        app_type))
        self._data_field(xpad[i:])

    def _data_field(self, data: bytes):
        i = 0
        for ci in self.ci_list:
            if ci.length > len(data) - i:
                return
            sub = data[i:i + ci.length]
            mot_length = self._previous_mot_length
            self._previous_mot_length = 0
            if ci.app_type != 1:
                self.data_length.reset()

            if ci.app_type == 1:
                self.data_length.process(sub)
                if self.data_length.length is not None:
                    self._previous_mot_length = self.data_length.length
                    self.data_length.reset()
            elif ci.app_type == 2:
                ci.app_type = 3
                self.dynamic_label.process(True, sub)
            elif ci.app_type == 3:
                self.dynamic_label.process(False, sub)
            elif ci.app_type in (12, 14):
                ca = ci.app_type == 14
                ci.app_type = 13 if not ca else 15
                self.mot.set_group_length(mot_length)
                self.mot.process(True, sub)
            elif ci.app_type in (13, 15):
                self.mot.process(False, sub)
            i += ci.length

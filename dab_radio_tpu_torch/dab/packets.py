"""MSC packet mode: network level, data-group level, and the optional
RS(204,188) FEC layer.

Parity surface: reference src/dab/msc/msc_data_packet_processor.cpp (24/48/
72/96-byte packets, mod-4 continuity, first/last assembly into data groups,
address filter), msc_data_group_processor.cpp (header + CRC16 + session/user
access fields), and msc_reed_solomon_data_packet_processor.cpp (2256-byte
application data table + 9 FEC packets carrying RS parity rows, counter
validation, correction, re-emission).
"""

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from ..ops.crc import crc16
from ..ops.rs import packet_rs
from .mot import MOTProcessor, DataGroupHeader

PACKET_LENGTH = [24, 48, 72, 96]
FEC_ADDRESS = 0x3FE

# FEC frame geometry (EN 300 401 clause 5.3.5)
APP_DATA_TABLE = 2256
RS_ROWS = 12
RS_DATA, RS_PARITY = 188, 16
FEC_PACKET_LEN, TOTAL_FEC_PACKETS, FEC_HDR = 24, 9, 2
RS_DATA_TABLE = 192


@dataclass
class DataGroupResult:
    ok: bool = False
    data_group_type: int = 0
    continuity_index: int = 0
    repetition_index: int = 0
    has_segment: bool = False
    is_last_segment: bool = False
    segment_number: int = 0
    has_transport_id: bool = False
    transport_id: int = 0
    data: bytes = b""


def parse_data_group(buf: bytes) -> DataGroupResult:
    """MSC data group header + CRC + session header (clause 5.3.3)."""
    res = DataGroupResult()
    if len(buf) < 2:
        return res
    extension_flag = (buf[0] >> 7) & 1
    crc_flag = (buf[0] >> 6) & 1
    segment_flag = (buf[0] >> 5) & 1
    user_access_flag = (buf[0] >> 4) & 1
    res.data_group_type = buf[0] & 0xF
    res.continuity_index = (buf[1] >> 4) & 0xF
    res.repetition_index = buf[1] & 0xF
    b = buf[2:]

    if crc_flag:
        if len(b) < 2:
            return res
        rx = (buf[-2] << 8) | buf[-1]
        if crc16(buf[:-2]) != rx:
            return res
        b = b[:-2]
    if extension_flag:
        if len(b) < 2:
            return res
        b = b[2:]
    if segment_flag:
        if len(b) < 2:
            return res
        res.has_segment = True
        res.is_last_segment = bool(b[0] >> 7)
        res.segment_number = ((b[0] & 0x7F) << 8) | b[1]
        b = b[2:]
    if user_access_flag:
        if len(b) < 1:
            return res
        tid_flag = (b[0] >> 4) & 1
        length = b[0] & 0xF
        b = b[1:]
        if length > len(b):
            return res
        fields = b[:length]
        b = b[length:]
        if tid_flag:
            if len(fields) < 2:
                return res
            res.has_transport_id = True
            res.transport_id = (fields[0] << 8) | fields[1]
    if len(b) >= 8191:
        return res
    res.ok = True
    res.data = bytes(b)
    return res


class PacketProcessor:
    """Network-level packet parse -> data-group assembly -> MOT, with an
    optional RS FEC layer in front."""

    def __init__(self, packet_address: int, use_fec: bool = False):
        self.packet_address = packet_address
        self.mot = MOTProcessor()
        self.on_data_group: List[Callable[[DataGroupResult], None]] = []
        self._assembly = bytearray()
        self._last_ci: Optional[int] = None
        self._fec = RSPacketFEC(self._read_packet) if use_fec else None
        self.stats = {"packets": 0, "crc_errors": 0, "data_groups": 0,
                      "address_filtered": 0}

    def __getstate__(self):
        """Checkpoint contract (SURVEY §5.4): decode state pickles,
        external observers don't — re-attach on_data_group after restore
        (FusedFleet.from_snapshot re-creates its relay automatically)."""
        d = dict(self.__dict__)
        d["on_data_group"] = []
        return d

    def process(self, buf: bytes):
        """One MSC logical frame worth of packet-mode bytes."""
        i = 0
        while i + 3 <= len(buf):
            if self._fec is not None:
                i += self._fec.read_packet(buf[i:])
            else:
                i += self._read_packet(buf[i:], True)

    # ---- network level ----

    def _read_packet(self, buf: bytes, _corrected: bool = True) -> int:
        if len(buf) < 3:
            return len(buf)
        length_id = (buf[0] >> 6) & 0b11
        continuity = (buf[0] >> 4) & 0b11
        location = (buf[0] >> 2) & 0b11
        address = ((buf[0] & 0b11) << 8) | buf[1]
        useful_len = buf[2] & 0x7F
        plen = PACKET_LENGTH[length_id]
        if len(buf) < plen:
            return len(buf)
        self.stats["packets"] += 1
        if address != self.packet_address:
            self.stats["address_filtered"] += 1
            return plen
        packet = buf[:plen]
        if 3 + useful_len > plen - 2:
            return plen
        rx = (packet[-2] << 8) | packet[-1]
        if crc16(packet[:-2]) != rx:
            self.stats["crc_errors"] += 1
            return plen
        data = packet[3:3 + useful_len]

        expected = None if self._last_ci is None else (self._last_ci + 1) % 4
        contiguous = expected is None or expected == continuity
        self._last_ci = continuity

        if location == 0b11:                       # single
            self._handle_group(bytes(data))
        elif location == 0b10:                     # first
            self._assembly = bytearray(data)
        elif location == 0b00:                     # intermediate
            if contiguous and self._assembly is not None:
                self._assembly.extend(data)
            else:
                self._assembly = bytearray()
        else:                                      # last
            if contiguous and self._assembly is not None:
                self._assembly.extend(data)
                self._handle_group(bytes(self._assembly))
            self._assembly = bytearray()
        return plen

    def _handle_group(self, group: bytes):
        res = parse_data_group(group)
        if not res.ok:
            return
        self.stats["data_groups"] += 1
        for cb in self.on_data_group:
            cb(res)
        if res.has_segment and res.has_transport_id:
            hdr = DataGroupHeader(res.data_group_type, res.continuity_index,
                                  res.repetition_index, res.is_last_segment,
                                  res.segment_number, res.transport_id)
            self.mot.process_data_group(hdr, res.data)


class RSPacketFEC:
    """FEC frame reassembly + RS(204,188) correction, re-emitting corrected
    packets through `emit(packet_bytes, was_corrected)`."""

    def __init__(self, emit: Callable[[bytes, bool], int]):
        self.emit = emit
        self.ring: List[bytes] = []       # whole packets, bounded by table size
        self.ring_bytes = 0
        self.last_counter: Optional[int] = None
        self.stats = {"fec_frames": 0, "rs_failures": 0, "corrected": 0}

    def read_packet(self, buf: bytes) -> int:
        if len(buf) < FEC_HDR:
            return len(buf)
        length_id = (buf[0] >> 6) & 0b11
        counter = (buf[0] >> 2) & 0xF
        address = ((buf[0] & 0b11) << 8) | buf[1]
        is_fec = address == FEC_ADDRESS
        if is_fec:
            length_id = 0
        plen = PACKET_LENGTH[length_id]
        if len(buf) < plen:
            return len(buf)
        packet = bytes([(buf[0] & 0b00111111) | (length_id << 6)]) + bytes(buf[1:plen])
        self._push(packet)
        if not is_fec:
            return plen

        ok = (counter == 0) if self.last_counter is None \
            else (counter == self.last_counter + 1)
        if not ok:
            self.last_counter = None
            self._flush(False)
            return plen
        self.last_counter = counter
        if counter != TOTAL_FEC_PACKETS - 1:
            return plen

        total = APP_DATA_TABLE + FEC_PACKET_LEN * TOTAL_FEC_PACKETS
        if self.ring_bytes != total:
            self._flush(False)
        else:
            self._correct_and_flush()
        self.last_counter = None
        return plen

    def _push(self, packet: bytes):
        total = APP_DATA_TABLE + FEC_PACKET_LEN * TOTAL_FEC_PACKETS
        while self.ring_bytes + len(packet) > total:
            old = self.ring.pop(0)
            self.ring_bytes -= len(old)
        self.ring.append(packet)
        self.ring_bytes += len(packet)

    def _flush(self, corrected: bool):
        for p in self.ring:
            self.emit(p, corrected)
        self.ring.clear()
        self.ring_bytes = 0

    def _correct_and_flush(self):
        raw = bytearray(b"".join(self.ring))
        app = np.frombuffer(bytes(raw[:APP_DATA_TABLE]), dtype=np.uint8)
        fec_area = raw[APP_DATA_TABLE:]
        # strip per-FEC-packet headers; last packet has 6 padding bytes
        rs_table = bytearray()
        for i in range(TOTAL_FEC_PACKETS):
            fld = fec_area[i * FEC_PACKET_LEN + FEC_HDR:(i + 1) * FEC_PACKET_LEN]
            rs_table.extend(fld)
        rs_table = bytes(rs_table)[:RS_DATA_TABLE]
        parity = np.frombuffer(rs_table, dtype=np.uint8)

        # rows: codeword y = app[i*12 + y] for i<188, parity[i*12 + y] for i<16
        cw = np.zeros((RS_ROWS, RS_DATA + RS_PARITY), dtype=np.uint8)
        cw[:, :RS_DATA] = app.reshape(RS_DATA, RS_ROWS).T
        cw[:, RS_DATA:] = parity.reshape(RS_PARITY, RS_ROWS).T
        corrected, nerr = packet_rs().decode(cw)
        self.stats["fec_frames"] += 1
        if (nerr < 0).any():
            self.stats["rs_failures"] += 1
        self.stats["corrected"] += int(np.maximum(nerr, 0).sum())
        app_fixed = corrected[:, :RS_DATA].T.reshape(-1)

        # rebuild the application packets from the corrected table
        data = app_fixed.tobytes()
        out, i = [], 0
        while i < len(data):
            lid = (data[i] >> 6) & 0b11
            plen = PACKET_LENGTH[lid]
            out.append(data[i:i + plen])
            i += plen
        self.ring.clear()
        self.ring_bytes = 0
        for p in out:
            self.emit(p, True)


# ---------------- TX side (tests / ensemble transmitter) ----------------

def build_packet(piece: bytes, address: int, continuity: int, location: int) -> bytes:
    """One network-level packet (first/intermediate/last/single)."""
    plen = next(L for L in PACKET_LENGTH if L - 5 >= len(piece))
    lid = PACKET_LENGTH.index(plen)
    p = bytearray(plen)
    p[0] = (lid << 6) | ((continuity & 0b11) << 4) | ((location & 0b11) << 2) \
        | ((address >> 8) & 0b11)
    p[1] = address & 0xFF
    p[2] = len(piece)
    p[3:3 + len(piece)] = piece
    c = crc16(bytes(p[:-2]))
    p[-2], p[-1] = c >> 8, c & 0xFF
    return bytes(p)


def idle_packet(address: int = 0x3FF) -> bytes:
    """24-byte single packet with no useful data (capacity filler)."""
    return build_packet(b"", address, 0, 0b11)


def packetize_data_group(data_group: bytes, address: int, start_ci: int = 0):
    """Split one data group into packets; returns (packets, next_ci)."""
    pieces = [data_group[i:i + 91] for i in range(0, len(data_group), 91)] or [b""]
    out = []
    ci = start_ci
    for k, piece in enumerate(pieces):
        if len(pieces) == 1:
            loc = 0b11
        elif k == 0:
            loc = 0b10
        elif k == len(pieces) - 1:
            loc = 0b01
        else:
            loc = 0b00
        out.append(build_packet(piece, address, ci, loc))
        ci = (ci + 1) % 4
    return out, ci


class PacketStreamEncoder:
    """Queues data groups and emits fixed-size packet-stream chunks padded
    with idle packets (for the ensemble transmitter's packet services)."""

    def __init__(self, address: int):
        self.address = address
        self._ci = 0
        self._bytes = bytearray()

    def push_data_group(self, group: bytes):
        pkts, self._ci = packetize_data_group(group, self.address, self._ci)
        for p in pkts:
            self._bytes.extend(p)

    def emit(self, nb_bytes: int) -> bytes:
        assert nb_bytes % 24 == 0, "chunk must hold whole packets"
        while len(self._bytes) < nb_bytes:
            self._bytes.extend(idle_packet())
        out = bytes(self._bytes[:nb_bytes])
        del self._bytes[:nb_bytes]
        return out
